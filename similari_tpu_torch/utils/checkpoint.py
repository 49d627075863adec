"""Tracker checkpoint and resume (mirrors `similari_tpu/utils/checkpoint.py`).

A `Sort` or `VisualSort` (every scene: state, custom ids, counters, the
sticky rotated-box flag) round-trips through one compressed npz in the
JAX package's format, so a file either package writes loads in the other:
each scene's state leaves in dataclass field order (the Kalman state's
five first), `scene_<id>_leaf_<i>`, its `custom_ids` and `has_custom`,
and a `meta` JSON blob.  bfloat16 leaves (the port's bf16 galleries)
are written as float32, which holds them exactly: numpy has no bfloat16
without `ml_dtypes`, and the JAX package's trackers store float32.  On
load every leaf takes the dtype of the tracker's own store, and each
scene's state the store's engine form: tensors on the tracker's device,
or numpy leaves for `engine="host"`.  A host store's native step
session points at the leaves it replaces, so the load drops it.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List

import numpy as np
import torch

from ..trackers.host_sort import state_to_device
from ..trackers.state import map_tensors


def _leaves(state) -> List:
    """The state's leaves in dataclass field order, nested ones inline."""
    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        out.extend(_leaves(v) if dataclasses.is_dataclass(v) else [v])
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.numpy()
    return np.asarray(leaf)


def _read(blob: np.ndarray, like) -> np.ndarray:
    """A stored leaf as a C-contiguous numpy array of the dtype of `like`
    (a store leaf; float32 for a bfloat16 one)."""
    if isinstance(like, torch.Tensor):
        like = _to_numpy(like.reshape(-1)[:0])
    return np.array(blob, dtype=np.asarray(like).dtype, order="C")


def _rebuild(template, leaves: List):
    """`template`'s dataclass tree with its leaves replaced in order."""
    it = iter(leaves)
    return map_tensors(lambda _: next(it), template)


def save_tracker(tracker, path):
    """Save a `Sort` or `VisualSort` (all scenes) to `path` (.npz)."""
    blobs = {}
    meta = {
        "epochs": tracker._epochs,
        "next_track_id": tracker._next_track_id,
        "scenes": [],
        "kind": type(tracker).__name__,
    }
    for scene_id, store in tracker._scenes.items():
        prefix = f"scene_{scene_id}"
        leaves = [_to_numpy(leaf) for leaf in _leaves(store.state)]
        for i, leaf in enumerate(leaves):
            blobs[f"{prefix}_leaf_{i}"] = leaf
        blobs[f"{prefix}_custom_ids"] = store.custom_ids
        blobs[f"{prefix}_has_custom"] = store.has_custom
        meta["scenes"].append({
            "scene_id": scene_id,
            "n_leaves": len(leaves),
            "active_count": store.active_count,
            "oriented": bool(store.oriented),
        })
    blobs["meta"] = np.frombuffer(json.dumps(meta).encode(),
                                  dtype=np.uint8).copy()
    np.savez_compressed(Path(path), **blobs)


def load_tracker(tracker, path):
    """Restore what `save_tracker` (of either package) wrote into a freshly
    built tracker of the same configuration; returns the tracker.  The
    stored capacity and feature width win over the tracker's."""
    with np.load(Path(path)) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        tracker._epochs = {int(k): int(v) for k, v in meta["epochs"].items()}
        tracker._next_track_id = int(meta["next_track_id"])
        for scene in meta["scenes"]:
            scene_id = int(scene["scene_id"])
            prefix = f"scene_{scene_id}"
            store = tracker._get_store(scene_id)
            like = _leaves(store.state)
            if len(like) != scene["n_leaves"]:
                raise ValueError(f"scene {scene_id}: {scene['n_leaves']} "
                                 f"leaves stored, the tracker's state has "
                                 f"{len(like)}")
            host = _rebuild(store.state, [
                _read(data[f"{prefix}_leaf_{i}"], leaf)
                for i, leaf in enumerate(like)])
            if store.host:
                store.state = host
            else:
                state = state_to_device(host, tracker.device)
                store.state = _rebuild(state, [
                    a.to(b.dtype) for a, b in zip(_leaves(state), like)])
            store.custom_ids = data[f"{prefix}_custom_ids"].copy()
            store.has_custom = data[f"{prefix}_has_custom"].copy()
            store.active_count = int(scene["active_count"])
            # the sticky rotated-box flag: without it restored rotated
            # tracks would be matched as axis-aligned boxes
            store.oriented = bool(scene.get("oriented", False))
            store.session = None  # it points at the replaced leaves
            if hasattr(store.state, "feats") and hasattr(tracker,
                                                         "_feature_dim"):
                tracker._feature_dim = int(store.state.feats.shape[-1])
    return tracker
