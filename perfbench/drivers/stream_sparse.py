"""Closed-loop VisualSORT streams whose ReID features come every few
frames: the `stream` driver with scene j's rows carrying features
(`fvalid`) only on the frames whose epoch e has (e + j) % `feature_every`
== 0, as pipelines that run their ReID model on one frame in n do.  The
phases are staggered over the scenes, so every step holds about 1 / n of
the feature rows and the steps stay even; the other rows take the
positional fallback.  The features are still made for every row and
ignored where `fvalid` is false, by the port and by the reference alike.
"""

from __future__ import annotations

import torch

from perfbench.drivers import stream
from perfbench.swap import swapped
from perfbench.traffic import Frame, Scenes


class SparseScenes(Scenes):
    """`traffic.Scenes` with features valid on one frame in
    `feature_every` a scene; its n-th `step` is epoch n."""

    def __init__(self, mix, n_scenes, seed, device, feature_dim=0,
                 versions=0):
        super().__init__(mix, n_scenes, seed, device, feature_dim, versions)
        self.every = mix["feature_every"]
        self.epoch = 0
        self.phase = torch.arange(n_scenes, device=device)

    def step(self) -> Frame:
        fr = super().step()
        self.epoch += 1
        on = (self.epoch + self.phase) % self.every == 0
        fr.fvalid = fr.fvalid & on[:, None]
        return fr


class Driver(stream.Driver):
    def setup(self) -> None:
        with swapped(stream, Scenes=SparseScenes):
            super().setup()
