"""Rotated-box detection traffic: `traffic.Scenes` with a heading and a
vehicle's shape for each object, as drone and top-down cameras see
vehicles.

Each object draws a height (the mix's `height`, px) and an aspect, length
over width (`aspect`), when it is born, and a heading uniform in
`heading` (rad), fixed for its life: a box is (xc, yc, heading, aspect,
height), its long side aspect x height along the heading.  The detector
adds N(0, `angle_noise`^2) rad to the heading, besides the centre and
size noise of `traffic.Scenes`; a false positive takes a heading drawn
from the same range and the size `traffic.Scenes` gives it.  The heading
range stays inside (-pi/2, pi/2), so the noise never wraps an angle.

Every draw comes from the scenes' generator, after those of
`traffic.Scenes`, so the same `traffic_seed` gives the same scenes and
`--seed` orders them, as there.
"""

from __future__ import annotations

from typing import Dict

import torch

from perfbench.traffic import Frame, Scenes, _uniform


class OrientedScenes(Scenes):
    def __init__(self, mix: Dict, n_scenes: int, seed: int,
                 device: torch.device, feature_dim: int = 0,
                 versions: int = 0):
        # `traffic.Scenes` draws square-range sizes from "size"; they are
        # drawn again below from the height and aspect
        super().__init__(dict(mix, size=mix["height"]), n_scenes, seed,
                         device, feature_dim, versions)
        shape = self.age.shape
        self.heading = _uniform(self.g, shape, *mix["heading"], device)
        self.wh = self._sizes(shape)

    def _sizes(self, shape):
        """(width, height) [*shape, 2]: width = aspect x height."""
        h = _uniform(self.g, shape, *self.mix["height"], self.dev)
        a = _uniform(self.g, shape, *self.mix["aspect"], self.dev)
        return torch.stack([a * h, h], -1)

    def _rebirth(self):
        super()._rebirth()
        born = self.age == 0  # an object that died this frame starts at 0
        self.heading = torch.where(
            born, _uniform(self.g, born.shape, *self.mix["heading"],
                           self.dev), self.heading)
        self.wh = torch.where(born[..., None], self._sizes(born.shape),
                              self.wh)

    def step(self) -> Frame:
        fr = super().step()
        g, dev = self.g, self.dev
        shape = fr.src.shape
        own = self.heading[self.perm].gather(1, fr.src.clamp(min=0))
        # drawn in the fixed set's order, then put in the batch's, as
        # every draw of the scenes: a scene's frames do not depend on
        # `--seed`
        noise = self.mix["angle_noise"] * torch.randn(
            shape, generator=g, device=dev)[self.perm]
        fp = _uniform(g, shape, *self.mix["heading"], dev)[self.perm]
        fr.box[..., 2] = torch.where(fr.src >= 0, own + noise,
                                     torch.where(fr.src == -1, fp, 0.0))
        return fr
