"""The comparison that decides `correct`: a scene's frames as the program
answered them, held against `tracker.Tracker` run over the same inputs.

Per frame and valid row: the id, slot, voting type and new-track flag must
equal the reference's, and the Kalman-updated box is held to a relative
error.  After the last frame: the state's integer fields and copied inputs
must equal the reference's, its Kalman state is held to the same relative
error, and its gallery and feature history to their own.  A scene whose
frame disagrees is compared no further (its state has left the
reference's): the rows that disagree count, and the frames after it do not.

The numbers, each compared with its limit from the cell's mix file:
  mismatches  rows and state entries that differ (exact: limit 0)
  kf_err      worst |program - reference| over the largest |reference|
              of the same field: the updated boxes of every frame, the
              state's five Kalman parts
  gallery_err the same over the gallery lanes and feature history
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
from typing import Dict, List, Optional

import numpy as np

from .tracker import Settings, Tracker

KF_FIELDS = ("mean_pos", "mean_vel", "cpp", "cpv", "cvv")
EXACT_FIELDS = ("active", "last_epoch", "length", "track_id", "obs_box",
                "conf")
EXACT_VISUAL = ("feat_valid", "collected", "voting_type", "hist_feat_valid")
_TINY = 1e-30


@dataclasses.dataclass
class Readings:
    mismatches: int = 0
    frames: int = 0  # frames compared
    rows: int = 0  # valid rows compared
    ties: int = 0  # frames where the program took another optimum
    kf_diff: Dict[str, float] = dataclasses.field(default_factory=dict)
    kf_scale: Dict[str, float] = dataclasses.field(default_factory=dict)
    gal_diff: float = 0.0
    gal_scale: float = 0.0
    detail: str = ""  # the first frame that disagrees, for the log

    def _kf(self, key, prog, ref):
        if ref.size:
            d = float(np.abs(np.asarray(prog, np.float64) - ref).max())
            self.kf_diff[key] = max(self.kf_diff.get(key, 0.0), d)
            self.kf_scale[key] = max(self.kf_scale.get(key, 0.0),
                                     float(np.abs(ref).max()))

    def _gallery(self, prog, ref):
        if ref.size:
            self.gal_diff = max(self.gal_diff, float(np.abs(
                np.asarray(prog, np.float64) - ref).max()))
            self.gal_scale = max(self.gal_scale, float(np.abs(ref).max()))

    @property
    def kf_err(self) -> float:
        return max((d / max(self.kf_scale[k], _TINY)
                    for k, d in self.kf_diff.items()), default=0.0)

    @property
    def gallery_err(self) -> float:
        return self.gal_diff / max(self.gal_scale, _TINY)

    def merge(self, other: "Readings") -> None:
        self.mismatches += other.mismatches
        self.frames += other.frames
        self.rows += other.rows
        self.ties += other.ties
        for k in other.kf_diff:
            self.kf_diff[k] = max(self.kf_diff.get(k, 0.0), other.kf_diff[k])
            self.kf_scale[k] = max(self.kf_scale.get(k, 0.0),
                                   other.kf_scale[k])
        self.gal_diff = max(self.gal_diff, other.gal_diff)
        self.gal_scale = max(self.gal_scale, other.gal_scale)
        self.detail = self.detail or other.detail


def compare_scene(config: Dict, dpad: int, frames: List[Dict[str, np.ndarray]],
                  prog: Dict[str, np.ndarray],
                  prog_state: Optional[Dict[str, np.ndarray]]) -> Readings:
    """`frames[i]` the inputs of frame i (epoch i + 1); `prog` the
    program's outputs stacked over frames: ids, slots, is_new [N, D],
    pred [N, D, 5], and vt [N, D] for VisualSORT; `prog_state` its state
    after the last frame, by the program's field names."""
    settings = Settings.from_config(config)
    ref = Tracker(settings, config["capacity"], dpad,
                  config.get("gallery", 0), config.get("feature_dim", 0))
    visual = ref.visual
    out = Readings()
    for i, inp in enumerate(frames):
        valid = inp["valid"].astype(bool)
        p = {"slots": prog["slots"][i], "is_new": prog["is_new"][i].astype(bool),
             "vt": prog["vt"][i] if visual else np.zeros_like(prog["slots"][i])}
        r = ref.step(inp, i + 1, p)
        out.frames += 1
        out.rows += int(valid.sum())
        out.ties += int(r.tie)
        bad = (prog["ids"][i] != r.ids) | (p["slots"] != r.slots) | \
            (p["is_new"] != r.is_new)
        if visual:
            bad |= p["vt"] != r.vt
        n_bad = int((bad & valid).sum())
        out._kf("pred_box", prog["pred"][i][valid], r.pred[valid])
        if n_bad or r.refused:
            out.mismatches += max(n_bad, r.refused)
            out.detail = _detail(ref, i, bad & valid, prog, r)
            return out
    if prog_state is not None:
        _compare_state(out, ref.state(), prog_state, visual)
    return out


def _detail(ref: Tracker, i: int, bad, prog, r) -> str:
    """The disagreeing rows of frame i: both sides' decisions, the
    reference's BestFit weights and positional weights on those rows."""
    dg = getattr(ref, "diag", {})
    rows = sorted(set(np.flatnonzero(bad).tolist())
                  | {k for k in dg.get("optimum", {})
                     if dg["optimum"].get(k) != dg["program"].get(k)}
                  | {k for k in dg.get("program", {})
                     if dg["optimum"].get(k) != dg["program"].get(k)}
                  | {k for k in dg.get("wins", {})
                     if dg["wins"].get(k) != dg["program_wins"].get(k)}
                  | {k for k in dg.get("program_wins", {})
                     if dg["wins"].get(k) != dg["program_wins"].get(k)})
    parts = [f"frame {i} (epoch {i + 1})"]
    for row in rows[:6]:
        part = (f"row {row}: program id {prog['ids'][i][row]} slot "
                f"{prog['slots'][i][row]} new {bool(prog['is_new'][i][row])}"
                + (f" vt {prog['vt'][i][row]}" if "vt" in prog else "")
                + f"; reference id {r.ids[row]} slot {r.slots[row]} new "
                f"{bool(r.is_new[row])} vt {r.vt[row]}")
        for name in ("P", "weight"):
            m = dg.get(name)
            if m is not None:
                top = np.argsort(-m[row])[:3]
                part += f"; {name} " + ", ".join(
                    f"{c}:{m[row, c]:.9g}" for c in top if m[row, c] != 0)
        parts.append(part)
    return " | ".join(parts)


def _compare_state(out: Readings, ref: Dict, prog: Dict, visual: bool):
    act = ref["active"] | np.asarray(prog["active"]).astype(bool)
    if (np.asarray(prog["active"]).astype(bool) != ref["active"]).any():
        out.mismatches += int((np.asarray(prog["active"]).astype(bool)
                               != ref["active"]).sum())
        return
    for f in EXACT_FIELDS + (EXACT_VISUAL if visual else ()):
        pv = np.asarray(prog[f])[act]
        rv = ref[f][act]
        if f in ("active", "feat_valid", "hist_feat_valid"):
            pv = pv.astype(bool)
        out.mismatches += int((pv.reshape(len(pv), -1).astype(np.float64)
                               != rv.reshape(len(rv), -1)).any(1).sum())
    for f in KF_FIELDS:
        out._kf(f, np.asarray(prog[f])[act], ref[f][act])
    if visual:
        lanes = ref["feat_valid"] & act[:, None]
        out._gallery(np.asarray(prog["feats"])[lanes], ref["feats"][lanes])
        hist = ref["hist_feat_valid"] & act
        out._gallery(np.asarray(prog["hist_feat"])[hist], ref["hist_feat"][hist])


def control_outputs(config: Dict, dpad: int,
                    frames: List[Dict[str, np.ndarray]]):
    """The reference kept in bfloat16, put in the program's place: its
    outputs and final state, shaped as `compare_scene` takes them."""
    settings = Settings.from_config(config)
    low = Tracker(settings, config["capacity"], dpad,
                  config.get("gallery", 0), config.get("feature_dim", 0),
                  bf16=True)
    rs = [low.step(inp, i + 1) for i, inp in enumerate(frames)]
    prog = {k: np.stack([getattr(r, a) for r in rs])
            for k, a in (("ids", "ids"), ("slots", "slots"),
                         ("is_new", "is_new"), ("pred", "pred"), ("vt", "vt"))}
    return prog, low.state()


def _task(config, dpad, frames, prog, state) -> Readings:
    if prog is None:  # the control: the reference in bfloat16
        prog, state = control_outputs(config, dpad, frames)
    return compare_scene(config, dpad, frames, prog, state)


def _worker(conn, task) -> None:
    conn.send(_task(*task))
    conn.close()


def compare_all(tasks: List[tuple]) -> Readings:
    """`compare_scene` over (config, dpad, frames, prog, state) tasks, one
    spawned process each (scenes are independent), results over pipes;
    prog None puts the bfloat16 reference in the program's place."""
    total = Readings()
    if len(tasks) == 1:
        total.merge(_task(*tasks[0]))
        return total
    cpus = os.cpu_count() or 1
    keep = os.environ.get("OPENBLAS_NUM_THREADS")
    os.environ["OPENBLAS_NUM_THREADS"] = str(max(1, cpus // len(tasks)))
    ctx = multiprocessing.get_context("spawn")
    procs = []
    try:
        for task in tasks:
            here, there = ctx.Pipe(duplex=False)
            proc = ctx.Process(target=_worker, args=(there, task))
            proc.start()
            there.close()
            procs.append((proc, here))
    finally:
        if keep is None:
            os.environ.pop("OPENBLAS_NUM_THREADS")
        else:
            os.environ["OPENBLAS_NUM_THREADS"] = keep
    try:
        for proc, here in procs:
            total.merge(here.recv())
    finally:
        for proc, here in procs:
            here.close()
            proc.join()
    return total


def numbers(readings: Readings, visual: bool) -> Dict[str, float]:
    """The numbers compared, by name."""
    out = {"mismatches": float(readings.mismatches),
           "kf_err": readings.kf_err}
    if visual:
        out["gallery_err"] = readings.gallery_err
    return out
