"""MOT-style detection traffic, made on the device from a seed.

The motion and detector model of `similari_tpu_torch/eval/synthetic.py::
generate_sequence`, rewritten as tensor code over scenes and objects at
once: random-walk centres (drift noise, velocity noise, clipped velocity,
wall bounce), detector noise on centres and sizes, misses, Poisson false
positives, and identity-plus-noise ReID features (random ones for false
positives).  Two things differ, both set by the mix file: each scene keeps
a steady population (an object that reaches the end of its life is
replaced at once by a new identity somewhere else), and the arena is a
camera frame.

The scenes' motion, detections and false positives come from a
`torch.Generator` on the device seeded by the mix's `traffic_seed`, so
every `--seed` runs the same set of scenes, of the same sizes and
churn, like a fixed recorded data set: the work, and so the time, is the
same for every seed.  `--seed` seeds a second generator that orders the
scenes in the batch (a permutation) and draws the identities and the
feature noise.  The same seed gives the same frames.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class Frame:
    """One frame of S scenes, rows padded to `dpad`: box f32 [S, D, 5]
    (xc, yc, angle 0, aspect, height), conf [S, D], valid bool [S, D],
    qual [S, D] (the detector's confidence), and for visual traffic
    feat f32 [S, D, F] and fvalid bool [S, D].  `src` int64 [S, D] is the
    row's object slot, -1 for a false positive and -2 for padding."""

    box: torch.Tensor
    conf: torch.Tensor
    valid: torch.Tensor
    qual: torch.Tensor
    src: torch.Tensor
    feat: Optional[torch.Tensor] = None
    fvalid: Optional[torch.Tensor] = None


def _uniform(g, shape, lo, hi, dev):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)


class Scenes:
    """S independent scenes of up to P object slots, stepped one frame at a
    time.  `mix` is the traffic file's dict; `feature_dim` 0 makes box-only
    traffic.  `versions` > 0 keeps every identity an object slot takes
    (up to that many), so features can be made again from `src` and
    `version` (`features_of`); 0 replaces an identity in place."""

    def __init__(self, mix: Dict, n_scenes: int, seed: int,
                 device: torch.device, feature_dim: int = 0,
                 versions: int = 0):
        self.mix, self.dev = mix, device
        self.g = torch.Generator(device=device)  # the scenes
        self.g.manual_seed(int(mix["traffic_seed"]))
        self.gs = torch.Generator(device=device)  # order, identities, noise
        self.gs.manual_seed(int(seed))
        g, dev, s = self.g, device, n_scenes
        # output scene j is scene perm[j] of the fixed set
        self.perm = torch.randperm(s, generator=self.gs, device=dev)
        pmin, pmax = mix["population"]
        self.p = pmax
        self.dpad = mix["dpad"]
        self.max_fp = self.dpad - pmax
        if self.max_fp < 0:
            raise ValueError("dpad is below the largest population")
        self.w, self.h = mix["arena"]
        pop = torch.randint(pmin, pmax + 1, (s,), generator=g, device=dev)
        self.present = torch.arange(pmax, device=dev)[None] < pop[:, None]
        self.xy = self._positions((s, pmax))
        self.vel = _uniform(g, (s, pmax, 2), -mix["velocity"],
                            mix["velocity"], dev)
        self.wh = _uniform(g, (s, pmax, 2), *mix["size"], dev)
        lmin, lmax = mix["lifetime"]
        self.life = torch.randint(lmin, lmax + 1, (s, pmax), generator=g,
                                  device=dev)
        # a steady state from the first frame: every object is part-way
        # through its life
        self.age = (torch.rand((s, pmax), generator=g, device=dev)
                    * self.life).long()
        self.f = feature_dim
        self.std = mix.get("identity_std", 0.0)
        self.versions = versions
        self.version = torch.zeros((s, pmax), dtype=torch.long, device=dev)
        # identities in output order
        if feature_dim and versions:
            self.identity = self.std * torch.randn(
                (s, pmax, versions, feature_dim), generator=self.gs,
                device=dev)
        elif feature_dim:
            self.identity = self.std * torch.randn(
                (s, pmax, feature_dim), generator=self.gs, device=dev)
        self.scene_ix = torch.arange(s, device=dev)[:, None]

    def _positions(self, shape):
        x = _uniform(self.g, shape, 50.0, self.w - 50.0, self.dev)
        y = _uniform(self.g, shape, 50.0, self.h - 50.0, self.dev)
        return torch.stack([x, y], dim=-1)

    def _rebirth(self):
        g, dev, mix = self.g, self.dev, self.mix
        shape = self.age.shape
        self.age += 1
        dead = (self.age >= self.life)[..., None]
        self.xy = torch.where(dead, self._positions(shape), self.xy)
        self.vel = torch.where(dead, _uniform(g, shape + (2,),
                                              -mix["velocity"],
                                              mix["velocity"], dev), self.vel)
        self.wh = torch.where(dead, _uniform(g, shape + (2,), *mix["size"],
                                             dev), self.wh)
        lmin, lmax = mix["lifetime"]
        life = torch.randint(lmin, lmax + 1, shape, generator=g, device=dev)
        self.life = torch.where(dead[..., 0], life, self.life)
        self.age = torch.where(dead[..., 0], 0, self.age)
        self.version = self.version + dead[..., 0].long()
        if self.f and not self.versions:
            fresh = self.std * torch.randn(self.identity.shape,
                                           generator=self.gs, device=dev)
            self.identity = torch.where(dead[self.perm], fresh,
                                        self.identity)

    def _move(self):
        g, dev, mix = self.g, self.dev, self.mix
        shape = self.xy.shape
        self.xy = self.xy + self.vel + mix["drift_noise"] * torch.randn(
            shape, generator=g, device=dev)
        self.vel = torch.clamp(
            self.vel + mix["velocity_noise"] * torch.randn(
                shape, generator=g, device=dev),
            -mix["velocity_clip"], mix["velocity_clip"])
        lo = torch.tensor([30.0, 30.0], device=dev)
        hi = torch.tensor([self.w - 30.0, self.h - 30.0], device=dev)
        self.vel = torch.where(self.xy < lo, self.vel.abs(),
                               torch.where(self.xy > hi, -self.vel.abs(),
                                           self.vel))

    def step(self) -> Frame:
        """The next frame of every scene."""
        g, dev, mix = self.g, self.dev, self.mix
        self._rebirth()
        self._move()
        s, p = self.age.shape
        det = self.present & (torch.rand((s, p), generator=g, device=dev)
                              >= mix["p_miss"])
        xy = self.xy + mix["pos_noise"] * torch.randn(
            (s, p, 2), generator=g, device=dev)
        wh = torch.clamp(self.wh + mix["wh_noise"] * torch.randn(
            (s, p, 2), generator=g, device=dev), min=5.0)
        conf = torch.clamp(0.9 + 0.05 * torch.randn(
            (s, p), generator=g, device=dev), 0.1, 1.0)
        # false positives: Poisson count per scene, uniform anywhere
        n_fp = torch.clamp(torch.poisson(
            torch.full((s,), float(mix["fp_per_frame"]), device=dev),
            generator=g).long(), max=self.max_fp)
        m = max(self.max_fp, 1)
        fp_xy = torch.stack([_uniform(g, (s, m), 0.0, self.w, dev),
                             _uniform(g, (s, m), 0.0, self.h, dev)], -1)
        fp_wh = _uniform(g, (s, m, 2), 20.0, 50.0, dev)
        fp_conf = torch.clamp(0.5 + 0.2 * torch.randn(
            (s, m), generator=g, device=dev), 0.1, 1.0)
        fp_on = torch.arange(m, device=dev)[None] < n_fp[:, None]

        # rows: the detected objects in slot order, then the false positives
        rank = torch.cumsum(det.long(), -1) - 1
        n_det = det.sum(-1)
        col = torch.where(det, rank, self.dpad)
        fp_col = torch.where(fp_on, n_det[:, None]
                             + torch.arange(m, device=dev)[None], self.dpad)
        cols = torch.cat([col, fp_col], 1)  # [S, P + m]
        box_src = torch.cat([
            torch.stack([xy[..., 0], xy[..., 1], torch.zeros_like(conf),
                         wh[..., 0] / wh[..., 1], wh[..., 1]], -1),
            torch.stack([fp_xy[..., 0], fp_xy[..., 1],
                         torch.zeros_like(fp_conf),
                         fp_wh[..., 0] / fp_wh[..., 1], fp_wh[..., 1]], -1)],
            1)
        slot_src = torch.cat([
            torch.arange(p, device=dev).expand(s, p),
            torch.full((s, m), -1, dtype=torch.long, device=dev)], 1)

        def place(values, fill):
            out = torch.full((s, self.dpad + 1) + values.shape[2:], fill,
                             dtype=values.dtype, device=dev)
            idx = cols.reshape(cols.shape + (1,) * (values.dim() - 2))
            out.scatter_(1, idx.expand(values.shape), values)
            return out[:, :self.dpad]

        perm = self.perm
        box = place(box_src, 0.0)[perm]
        conf_rows = place(torch.cat([conf, fp_conf], 1), 0.0)[perm]
        src = place(slot_src, -2)[perm]
        valid = src > -2
        frame = Frame(box=box, conf=conf_rows, valid=valid, qual=conf_rows,
                      src=src)
        if self.f:
            frame.feat = self.features_of(src, None)
            frame.fvalid = valid
        return frame

    def features_of(self, src: torch.Tensor,
                    version: Optional[torch.Tensor]) -> torch.Tensor:
        """Features f32 [S, D, F] of rows whose object slots are `src`
        [S, D] (-1 false positive, -2 padding, zero): the identity plus
        noise; a false positive draws a random identity.  `version` [S, D]
        picks the identity of a kept table (None: the current one)."""
        return self._features(src, version, None)

    def _features(self, src, version, scene):
        g, dev = self.gs, self.dev
        noise = self.mix["feature_noise"]
        real = src >= 0
        p = torch.clamp(src, min=0)
        if self.versions:
            sc = (self.scene_ix.expand_as(src) if scene is None
                  else torch.full_like(src, scene))
            v = (self.version[self.perm].gather(1, p) if version is None
                 else version)
            ident = self.identity[sc, p, torch.clamp(v, 0,
                                                     self.versions - 1)]
        else:
            ident = self.identity.gather(
                1, p[..., None].expand(p.shape + (self.f,)))
        rnd = torch.randn(src.shape + (self.f,), generator=g, device=dev)
        feat = torch.where(real[..., None], ident + noise * rnd,
                           self.std * rnd)
        return torch.where((src > -2)[..., None], feat, 0.0)

    def sequence_features(self, scene: int, src: torch.Tensor,
                          version: torch.Tensor) -> torch.Tensor:
        """Features [L, D, F] of a recorded sequence of scene `scene`:
        `src` and `version` [L, D] as `record` kept them."""
        return self._features(src, version, scene)


def record(scenes: Scenes, frames: int):
    """`frames` frames of every scene, kept on the device: (box [L, S, D,
    5], conf, valid, qual, src, version [L, S, D]) with no features, which
    `Scenes.sequence_features` makes when a sequence is replayed."""
    keep = {k: [] for k in ("box", "conf", "valid", "qual", "src",
                            "version")}
    f = scenes.f
    scenes.f = 0  # features are made at replay time
    try:
        for _ in range(frames):
            fr = scenes.step()
            for k in ("box", "conf", "valid", "qual", "src"):
                keep[k].append(getattr(fr, k))
            keep["version"].append(scenes.version[scenes.perm].gather(
                1, torch.clamp(fr.src, min=0)))
    finally:
        scenes.f = f
    return {k: torch.stack(v) for k, v in keep.items()}
