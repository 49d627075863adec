#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`similari_tpu_torch`) on one NVIDIA GPU.

Phases:
  1. the device, and `nvidia-smi` name and power limit;
  2. the nvcc build of the CUDA kernels, timed, and the count of tensor-core
     instructions (HGMMA/HMMA) in each kernel of `csrc/gallery_dots.cu`
     (`cuobjdump -sass`): the bf16 product, `gallery_dots_wgmma_kernel`,
     must have HGMMA;
  3. each fused kernel against its plain PyTorch version on the card at
     the main path's launch shape (D=128 rows for 100 objects, T=512, the
     runners' chunk of C=16 frames; K=3, F=512 for the visual kernel):
     ids, slots, voting types, is_new, lengths, overflow flags and
     auction statistics equal, floats within tests/torch_parity.py's
     RTOL/ATOL; CUDA-event times of both (for VisualSORT the chunk's two
     launches: the gallery product, then the scan).  Two streams:
     random-walk objects, as on the main path, and a crowded scene whose
     auction must run several rounds per frame; on both, one extra
     profiled run of the main-path config gives the scan kernel's phase
     split.  Then the gallery product against `gallery_dots_plain` at
     the main path's launch shape, bf16 and f32: the CUDA-event time of a
     wrapper call and the profiler's device time per call, beside the
     one PyTorch call of the same function (bf16: `torch.mm` of the bf16
     operands with `out_dtype=torch.float32`; f32: `x @ cols.T`, TF32
     off);
  4. the main path: `run_sequence_device_visual`, then `run_sequence_device`,
     on a synthetic 1024-frame sequence of 100 random-walk objects with
     512-d identities, the launch counters zeroed before and read after;
     then `torch.profiler` over both paths' first 256 frames for each of
     their kernels' device time per launch (the `kernels` line's
     `device_ms` of the two fused kernels and of `gallery_dots`, its
     staging and product kernels together; their `ms` is phase 3's
     CUDA-event time of a wrapper call);
  5. the rotated-box clip kernel against its plain version
     (`pair_block_plain`): IoU at D=500, T=2000 on the x-sorted views of
     one frame of the oriented SORT stream (most tiles skip) and on the
     same boxes unsorted (few skip), the intersection area at n=1000 on
     the NMS stream; masks equal, floats within RTOL/ATOL, tiles run equal
     to the plain count; identical rotated boxes give exactly 1.0; the
     CUDA-event time of a wrapper call and the profiler's device time per
     launch (the sorted case's is the entry's `device_ms`);
  6. the oriented SORT path: `sort_scan` at D=500 detections, T=2000 slots
     (bench.py's `sort_iou_oriented_500`) over --oriented-frames frames,
     the clip launches counted (one per frame), then its first 64 frames
     again with the plain version patched in place of the kernel: ids,
     slots, is_new, lengths, overflow and state equal, floats within
     tolerance;
  7. oriented NMS at n=1000 (bench.py's `nms_oriented_1000`) over
     --nms-frames frames: the block-skip route (the kernel) keeps the same
     boxes as the dense route;
  8. Mahalanobis SORT: `run_sequence_device(engine="step", method="maha")`
     on phase 4's sequence;
  9. the in-place merge kernel against its plain version
     (`lane_merge_plain`) at S=256 scenes x D=100 rows into R=600 gallery
     lanes and R=200 history rows, F=512 in bf16, f32 and int32, and at
     odd widths (F=3 bf16, F=129 f32): rows unique per scene, ~90% valid,
     rows outside [0, R) with valid 0; bit-equal results written in place;
     CUDA-event ms of the kernel, the plain version and `index_put_` in a
     loop of repeats;
 10. batched VisualSORT at bench.py's `batch_visual_256x100x512` (S=256,
     D=100, T=200, K=3, H=1, F=512, bf16): `batched_visual_step_inplace`
     and `batched_visual_step` from copies of one state over
     --batch-frames frames, equal every frame and at the end, the merge
     kernel launched twice per frame, visual matches present; scene-frames/s
     of both forms and, from `torch.profiler` over a whole run of each, the
     device's idle share and the merge kernel's device time per launch on
     this path (the `kernels` line's `ms`), beside the kernel, its plain
     version and `index_put_` timed in a loop on one frame's launch inputs;
 11. the general single-scene step: `run_sequence_device_visual(engine=
     "step")` on phase 4's whole sequence (--main-frames frames) gives the
     fused engine's ids; then an oriented, own-area-gated, history-3 config at
     D=100, T=400, K=3, F=512 over 64 frames;
 12. batched SORT at bench.py's `batch_sort_256x100` (S=256 scenes of 100
     objects, T=200, aligned IoU) over --batch-frames frames;
 13. the public `Sort` on phase 6's stream from 128 slots (the first 8
     frames through `predict` on Universal2DBox objects, the rest through
     `predict_arrays`): ids, slots and lengths equal to phase 6's scan
     every frame, one clip launch per call; ms per call and the device's
     idle share; then `wasted()` after `skip_epochs` returns every track
     once;
 14. the public `nms()` on phase 7's frames: the kept boxes equal phase
     7's keeps; ms per call;
 15. the public `VisualSort` on phase 4's stream (--step-frames frames):
     ids equal to phase 11's general step; then phase 11's own-area
     config with device shares (ids equal to the same config's scan
     without in-step recycling) and with the f64 clipping oracle's (the
     share of frames whose ids differ); frames/s;
 16. the public `BatchVisualSort` and `BatchSort` on phase 10's and 12's
     streams: lengths, is_new, voting types and the per-slot state equal
     to the bare steps every frame, ids one fixed map of theirs per
     scene, two merge launches per predict; scene-frames/s beside the
     bare steps'.  Each of phases 13-16 zeroes every launch counter
     before its run and reads them after;
 17. the host engines (engine="host": the C++ steps of `csrc/sortstep.cpp`
     and `csrc/visualstep.cpp` with the LAP solver, one host library built
     with the system C++ compiler) beside the device engines on the same
     calls, at bench.py::bench_interactive_host's per-call widths, with the
     host's CPU model and BLAS threads: `Sort` IoU 0.3 aligned at n = 10,
     100, 500, 1000 and oriented at n = 10, 100, 500; `VisualSort` 512-d
     f32 euclidean(10) at n = 10, 50, 100, and a bf16 `VisualSort` under
     "host" (the device step); `BatchSort` one scene x n = 10, 100, 500
     with constraint (1, 1.0), and phase 16's S=256 x 100; each with ids
     equal call for call (or the two solutions' voting LP totals tied
     within 1e-5 relative, counted) and wall-clock ms per call of both
     engines, the host engine launching no kernel; at each width the same
     calls again through the NumPy twins (`host_sort_step_numpy`,
     `host_visual_step_numpy`: the host engine before the C++ steps), ms
     per call and the calls whose ids equal the C++ step's;
     `FeatureTracker` 256-d at n = 10, 100, 500 (ids kept, ms per call);
     the general SORT step with assignment="native" against "hungarian" on
     the main path's stream (--step-frames frames, ids equal); the Kalman
     API's `filter_sequence` (C++ `kf_box_sequence`) beside its NumPy
     twin; `nms(device="cpu")` (C++ `nms_host`) on phase 7's frames cut to
     64 boxes, the kept boxes equal to `nms_kernel`'s on the card.  Every
     launch counter is zeroed before each call and read after it;
 18. the sharded scene paths on an NCCL process group of one rank
     (`parallel/mesh.py::scene_mesh(1)`): `sharded_visual_scan` at phase
     10's shape and stream, ids, voting types, overflow and state
     bit-equal to phase 10's plain step, the reduced new-track count equal
     to is_new's sum, scene-frames/s beside phase 10's, 2 merge launches
     per frame; the sharded step frame by frame under `StepTimer`, one
     frame under `trace()` (its Chrome trace must name
     `lane_merge_kernel`); `sharded_sort_scan` at phase 12's equal to
     phase 12, and oriented on 8 scenes of phase 6's stream equal to the
     unsharded batched scan (1 clip launch a frame: the batched step's
     sorted path over every scene); `global_gallery_query` (Q=256, k=16, cosine and euclidean)
     on the visual scan's state equal to a stable full sort of the score
     matrix, and `merge_shard_topk` of the state's 2, 4 and 8 blocks
     equal to it, ms per query batch and the products' share;
     `track_migration` / `track_merge` with M=64 entries bit-equal to the
     same calls on the CPU through a gloo group, ms per call; a bf16
     `VisualSort` checkpoint saved halfway through phase 4's stream,
     loaded and resumed with the uninterrupted tracker's ids, save and
     load seconds; `dryrun_multichip` in one NCCL rank per card when the
     machine has two or more (else printed as unverified);
 19. the MOT-file route: phase 4's SORT sequence written as a MOT det csv
     with 7 columns, with 6 (no confidence: read as 1.0) and with 7 behind
     a header line, each run as `run_sequence_device(path)` (the C++
     loader `native.load_sequence_soa`, then the fused SORT kernel on the
     card): outputs equal to phase 4's in-memory run, the fused kernel's
     launches counted; the loader's ms beside its NumPy version's, their
     buffers equal;
 20. valid zero-height detections (5% of the valid rows at height 0): the
     Mahalanobis `Sort`, `BatchSort` (two scenes) and `VisualSort` with
     assignment "auction" on the card, ids equal call for call to the same
     trackers on the CPU with "native"; `run_sequence_device(engine=
     "step", method="maha")` likewise; the fused runners (SORT, VisualSORT
     with IoU and Mahalanobis positional votes) on such a stream, outputs
     equal to the same runners through the plain chunks on the card;
 21. the generic `TrackStore` with its feature index on the card: the
     feature-tracker bench's shape (100 objects x 256-d, history 3, 50
     epochs of TopNVoting(1, 100, 1)), winners equal to a device="cpu"
     store's every epoch, ms per epoch; then 20,000 tracks x 3
     observations x 512-d f32 and `foreign_track_distances_arrays` for 64
     candidates of 3 observations: to_id and obs_ix equal to the CPU
     store's, distances within 1e-4 + 1e-5 x the largest, ms per query on
     both stores (CUDA events on the card) and the product's own ms
     beside its bound;
 22. the eval path and the MOTChallenge kit: two sequences of the port's
     `generate_sequence` (40 objects, 300 frames, seeds 1 and 2, the
     second with 128-d features) through the fused runners, outputs equal
     to the plain chunks on the card, MOTA / IDF1 by the port's metrics
     above tests/test_eval.py's bars (0.85 / 0.8); then `evaluate_sequences`
     (a `KitConfig` built in code, platform "cuda") with the `sort` (iou,
     maha) and `visual_sort` trackers on both sequences written in MOT
     layout: the bars, MOTA / IDF1 within 0.005 of the same kit on the
     CPU, the frames whose ids differ from the CPU run, fps per sequence.
     Each of phases 20-22 zeroes every launch counter before each run and
     reads them after;
 23. the forms ported last, every launch counter zeroed before and read
     after (none of them launches a custom kernel): oriented `sort_scan`
     at D=500, T=2000 (phase 6's stream, 64 frames) with
     oriented_block_sort=False and oriented_neighbors=16 (the radius-pruned
     top-k rotated IoU) against the dense form, ids, slots, is_new and
     lengths equal, the first 8 frames equal to the same run on the CPU;
     `nms_kernel` at n=1000 (phase 7's stream, 16 frames) with
     neighbors=16 against dense, keep masks equal on every frame where the
     prune is exact, the first 8 equal to the CPU's; the scene-chunked
     batched steps (`batched_visual_step_chunked` bf16 F=512,
     `batched_sort_step_chunked`) at S=256 x 100 with chunks of 64 and 256
     scenes over 16 frames, outputs equal every frame, states equal; and
     `clip_polygon_quads` on 65,536 quad pairs against the CPU's.
     Frames/s, ms per call, scene-frames/s and peak device memory of
     each; then, outside the counted window, the sorted clip-kernel path
     and block-skip NMS on the same frames for comparison;
 24. the benchmark entry points (`similari_tpu_torch/bench.py`,
     `bench_interactive.py`): the workloads of bench.py's rows
     `sort_iou_100_pallas` and `visual_sort_100x512_pallas` (64 frames,
     chunk 32: the fused kernels and `gallery_dots`),
     `sort_iou_oriented_500` and `nms_oriented_1000` (16 frames: the clip
     kernel), `sort_iou_oriented_100` and `nms_oriented_100` (16 frames,
     below the clip kernel's gates: no launch) and
     `batch_visual_64x100x512` (8 frames: the merge kernel) called once
     each on the card with every launch counter zeroed before and read
     after, the fused rows' ids equal to the same workload through the
     plain chunks on the card and the batched row's to the batched step;
     then `python -m similari_tpu_torch.bench` under BENCH_FAST=1 and
     `python -m similari_tpu_torch.bench_interactive --objects 10 100
     --reps 5 --captures 1` with `--engine host` and `--engine device`,
     each rc 0 with a parseable last line whose numbers are all finite
     and positive and which records no `_error`;
 25. the remaining entry points, as processes from the checkout, all at
     once: `python -m similari_tpu_torch.bench_pod --devices 1` with
     `--tracker both` and `--tracker gallery` at 8 scenes x 100 objects,
     16 frames (rc 0, every number finite and positive, no `_error`, the
     visual rows' merge launches 2 a frame over the warm-up and both
     measured runs), `tools.profile_gallery` and `tools.profile_oriented`
     (finite numbers, the device Sort's oriented-500 call one clip launch
     a call), and the examples `batch_scenes_device` (on the card and
     with `--device cpu`: the same lines), `visual_pallas_pipeline` (the
     step and fused engines' ids equal) and `cross_camera_handoff` (one
     NCCL rank a card, at most 4); meanwhile, in this process, the
     adversarial suite's `crossing` (every SORT axis) and `reid_crossing`
     (every VisualSORT axis) at seed 0 over 120 frames on the card, every
     launch counter zeroed before and read after: each axis within 0.5 pt
     MOTA / IDF1 of its host axis, the fused axis's ids equal to the
     auction axis's (or within 0.5 pt), `fused_visual_kernel` and
     `gallery_dots` launched once a chunk, no other kernel;
 26. the last entry points, as processes from the checkout, all at once:
     `python -m similari_tpu_torch.tools.decision_margins --seeds 0`
     (its artifact in a temporary directory; every scenario's row, the
     own-area host/device delta at most 1e-6), `tools.
     experiment_batch_merge` at its full shape (S=256, T=200, K=3, F=512
     bf16, D=128, 16 steps: the three forms' states bit-equal, the merge
     kernel's launches 16 a chain), `tools.experiment_pallas_batch` (x1
     and x2 at chunk 32, D=100, T=400: every scene's ids equal to its
     lone run through the plain version, `fused_visual_kernel` and
     `gallery_dots` launched once a scene a chunk) and `tools.ablate_visual
     256` (every stage and the rest, the merge kernel 2 launches a step
     in full and merge only, none elsewhere); then `tools.gen_doc_tables`
     on a temporary copy of README.md, fed phase 24's `bench.py` and
     host `bench_interactive` lines and phase 26's margins artifact,
     written there: rc 0, the blocks it was fed regenerated, no byte
     outside the `port-*` blocks changed;
 27. one `kernels` JSON line (the clip's and the merge's launches include
     the API paths', phase 17's device Sort's and phase 18's; the fused
     SORT kernel's, phase 19's; the fused kernels' and `gallery_dots`',
     phases 20 and 22; phase 23 adds none; every kernel's, phase 24's;
     the fused visual kernel's, `gallery_dots`' and the merge's, phases
     25 and 26, counted in the tools' processes), then the result line.
 28. (run after phase 9) the votes and BestFit kernel
     (`ops/visual_votes.py`) against its plain version at the two
     VisualSORT stream cells' shapes (S=1024, D=128, T=200 and S=256,
     D=256, T=512; K=3, 512-d f32 features, euclidean 100): t1, has_any,
     wins and claimed bit-equal; the kernel's device ms a launch, its
     CUDA-event ms a call, the plain version's and the byte bound.  Its
     launches are a launch counter like the others: every phase that
     holds the counters to a count holds it to one launch a general
     VisualSORT step on the card, and those launches go into the
     `kernels` line.
 29. (run after phase 28) the fallback auction kernel
     (`ops/assignment.py::auction_fb_cuda`, through `solve_voting`)
     against the plain rounds at the four stream cells' shapes
     (S=1024, D=128, T=200; S=4096, D=128, T=200; S=256, D=256, T=512;
     S=256, D=640, T=1024) on tracking-shaped IoU weights
     (`torch_parity.tracking_weights`): columns bit-equal and the same
     `auction.rounds`; the kernel's device ms a launch, its CUDA-event ms
     a call, the plain rounds' ms and the byte bound.  Its launches are a
     counter like the others: every phase that holds the counters to a
     count holds it to one launch a general SORT or VisualSORT step on
     the card with the auction (phase 6 too), and those launches go into
     the `kernels` line.

The fused-kernel checks take the main path's configurations from the
runners' own builders, the other configurations and the crowded stream
from tests/torch_parity.py.

Usage: python3 chip_smoke.py [--frames N] [--main-frames N]
                             [--oriented-frames N] [--nms-frames N]
                             [--batch-frames N] [--step-frames N]
                             [--seed S]
Exits non-zero, printing no result, when CUDA is missing or any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import multiprocessing
import os
import platform
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))

from similari_tpu_torch import (  # noqa: E402
    BatchSort, BatchVisualSort, BoundingBox, FeatureTracker,
    Point2DKalmanFilter, PositionalMetricType, Sort,
    SortPredictionBatchRequest, SpatioTemporalConstraints, Universal2DBox,
    Universal2DBoxKalmanFilter, Vec2DKalmanFilter, VisualSort,
    VisualSortMetricType, VisualSortObservation, VisualSortOptions,
    VisualSortPredictionBatchRequest, _build, nms)
from similari_tpu_torch import bench as pbench  # noqa: E402
from similari_tpu_torch import native  # noqa: E402
from similari_tpu_torch.core import (  # noqa: E402
    ObservationBuilder, TopNVoting, TrackStoreBuilder)
from similari_tpu_torch.core import store as core_store  # noqa: E402
from similari_tpu_torch.core.examples import (  # noqa: E402
    BatchedSimpleMetric, UnboundAttrs)
from similari_tpu_torch.eval import (  # noqa: E402
    clear_metrics, generate_sequence, identity_metrics, write_csv)
from similari_tpu_torch.eval.mot import (  # noqa: E402
    CHUNK, DeviceTimer, run_sequence_device, run_sequence_device_visual,
    sequence_sort_config, sequence_visual_config)
from similari_tpu_torch.motchallenge import (  # noqa: E402
    KitConfig, TrackerConfig, run_config)
from similari_tpu_torch.ops import assignment as asg  # noqa: E402
from similari_tpu_torch.ops import clip as cl  # noqa: E402
from similari_tpu_torch.ops import fused_sort as fs  # noqa: E402
from similari_tpu_torch.ops import fused_visual as fv  # noqa: E402
from similari_tpu_torch.ops import gallery_dots as gd  # noqa: E402
from similari_tpu_torch.ops import geometry as geo  # noqa: E402
from similari_tpu_torch.ops import merge_inplace as mi  # noqa: E402
from similari_tpu_torch.ops import visual_votes as vv  # noqa: E402
from similari_tpu_torch.ops.distances import gram  # noqa: E402
from similari_tpu_torch.ops.nms import nms_kernel, use_block_skip  # noqa: E402
from similari_tpu_torch.ops.ownarea import own_area_shares  # noqa: E402
from similari_tpu_torch.parallel import dryrun_multichip  # noqa: E402
from similari_tpu_torch.parallel import gallery as pgallery  # noqa: E402
from similari_tpu_torch.parallel import handoff as phandoff  # noqa: E402
from similari_tpu_torch.parallel import mesh  # noqa: E402
from similari_tpu_torch.trackers.host_sort import (  # noqa: E402
    host_sort_step_numpy)
from similari_tpu_torch.trackers.host_visual import (  # noqa: E402
    host_visual_step_numpy)
from similari_tpu_torch.trackers.sort_step import (  # noqa: E402
    SortConfig, sort_scan, use_sorted_path)
from similari_tpu_torch.trackers.state import (  # noqa: E402
    map_tensors, new_sort_state)
from similari_tpu_torch.trackers.visual_state import new_visual_state  # noqa: E402
from similari_tpu_torch.trackers.visual_step import (  # noqa: E402
    VT_VISUAL, VisualConfig, visual_scan)
from similari_tpu_torch.utils import (  # noqa: E402
    StepTimer, load_tracker, save_tracker, trace)
from similari_tpu_torch.utils import profiling  # noqa: E402
from similari_tpu_torch.utils.kalman import box_sequence_numpy  # noqa: E402
from similari_tpu_torch.utils.nms import HOST_MAX_BOXES  # noqa: E402
from similari_tpu_torch.utils.pad import pad_pow2  # noqa: E402
from torch_parity import (  # noqa: E402
    ATOL, EXACT_BOX_COLUMNS, RTOL, VISUAL_CONFIGS, churn_stream,
    crowded_stream, solutions_tie, tracking_weights, write_mot_det)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # non-tensor float32
BF16_OPS_PER_S = 989e12  # dense bf16 tensor cores
D_VALID, T, K, F = 100, 512, 3, 512
D = pad_pow2(D_VALID)  # the rows the runners pad 100 detections to
CROWD_SPREAD = 400.0  # px: 100 objects of 30-60 px overlap their neighbours
MIN_CROWDED_ROUNDS = 4.0  # auction rounds per frame the crowded stream needs
# oriented SORT (bench.py `sort_iou_oriented_500`: 500 objects, 4x slots)
# and oriented NMS (bench.py `nms_oriented_1000`)
OD, OT = 500, 2000
NMS_N, NMS_THRESHOLD = 1000, 0.8
PARITY_FRAMES = 64  # frames of the oriented path rerun with the plain clip
# the batched clip launch at the oriented SORT cell's shape: S scenes of
# 450-550 rotated vehicles (12-28 px tall, length / width 1.8-2.6, heading
# in +-1.45 rad) in 1920 x 1080, rows padded to D, T slots
CB_S, CB_D, CB_T, CB_N = 256, 640, 1024, (450, 550)
# bench.py's batch configs (`batch_visual_256x100x512`, `batch_sort_*x100`):
# S scenes of BD objects, BT = 2 x BD slots, K=3 lanes, F=512
BS, BD, BT = 256, 100, 200
# the oriented own-area config: D=100 boxes, T=400, gates of
# tools/adversarial_suite.py
OA_D, OA_T, OA_H, OA_FRAMES = 100, 400, 3, 64
OA_USE, OA_COLLECT = 0.4, 0.6
# f32 operations of one in-radius pair in csrc/clip.cu, counted from the
# source: every add, sub, mul, div, min, max, abs, negation and comparison
# (far test 7, recentred vertices 24, first boundary pass 4 x 87, tie pass
# 4 x 107, area 3, IoU 5)
CLIP_FLOPS = 815
PROFILED_FRAMES = 256  # frames of the main path under torch.profiler


def log(*a):
    print(*a, flush=True)


def box_stream(steps, n, rng, spread=1000.0):
    """Random-walk boxes (xc, yc, 0, aspect, h), as bench.py's stream."""
    xy = rng.uniform(0, spread, size=(n, 2)).astype(np.float32)
    wh = rng.uniform(30, 60, size=(n, 2)).astype(np.float32)
    out = np.zeros((steps, n, 5), np.float32)
    for s in range(steps):
        xy += rng.uniform(-2, 2, size=xy.shape).astype(np.float32)
        wh += rng.uniform(-0.5, 0.5, size=wh.shape).astype(np.float32)
        out[s, :, 0] = xy[:, 0]
        out[s, :, 1] = xy[:, 1]
        out[s, :, 3] = wh[:, 0] / wh[:, 1]
        out[s, :, 4] = wh[:, 1]
    return out


def make_inputs(steps, seed):
    """Padded full-width stream: 100 objects in D=128 rows, some frames
    with fewer rows, some rows without features."""
    rng = np.random.default_rng(seed)
    box = np.zeros((steps, D, 5), np.float32)
    box[:, :D_VALID] = box_stream(steps, D_VALID, rng)
    valid = np.zeros((steps, D), bool)
    valid[:, :D_VALID] = True
    valid[steps // 2, D_VALID // 2:] = False
    conf = rng.uniform(0.4, 1.0, (steps, D)).astype(np.float32) * valid
    ident = rng.normal(size=(D_VALID, F)).astype(np.float32)
    feat = np.zeros((steps, D, F), np.float32)
    for s in range(steps):
        feat[s, :D_VALID] = ident + 0.05 * rng.normal(
            size=(D_VALID, F)).astype(np.float32)
    fvalid = valid.copy()
    fvalid[1, : D_VALID // 4] = False
    fvalid[steps - 2, D_VALID // 2:] = False
    qual = rng.uniform(0.3, 1.0, (steps, D)).astype(np.float32)
    oa = np.ones((steps, D), np.float32)
    return box, conf, valid, feat, fvalid, qual, oa


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def run_chunks(fn, cfg, state, inputs):
    """Chain `fn` over the stream in the runners' chunks; returns (state,
    stacked per-frame outputs, ms per launch)."""
    steps = len(inputs[0])
    outs = []
    with DeviceTimer(inputs[0].device) as timer:
        for c0 in range(0, steps, CHUNK):
            sl = slice(c0, c0 + CHUNK)
            state, *o = fn(cfg, state, *(x[sl] for x in inputs), 1 + c0)
            outs.append(o)
    outs = [torch.cat(x) for x in zip(*outs)]
    return state, outs, timer.seconds * 1e3 / (steps // CHUNK)


def compare(name, k_state, k_outs, p_state, p_outs):
    """Exact equality of the integer and boolean outputs and state,
    tolerance on the floats.  Returns the largest absolute float
    difference."""
    err = 0.0
    for i, (a, b) in enumerate(zip(k_outs, p_outs)):
        if a.dtype in (torch.bool, torch.int32):
            if not torch.equal(a, b):
                bad = (a != b).nonzero()[:5].tolist()
                raise AssertionError(f"{name}: output {i} differs at {bad}")
        else:
            err = max(err, float((a - b).abs().max()))
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    for i, (a, b) in enumerate(zip(k_state, p_state)):
        if a.dtype == torch.int32:
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: state entry {i} differs")
        else:
            err = max(err, float((a - b).abs().max()))
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    return err


def check_kernel(name, kernel, plain, cfg, state, inputs):
    """Warm up on the whole stream (one chunk left the script's first
    timed kernel at twice its time), run the stream through the kernel
    and its plain version from the same state, compare.  Returns
    (kernel ms per launch, plain ms per launch, max_abs_err, per-frame
    stats [S, 3] as numpy: auction rounds, bids, gallery pairs)."""
    run_chunks(kernel, cfg, state, inputs)
    ks, ko, k_ms = run_chunks(kernel, cfg, state, inputs)
    ps, po, p_ms = run_chunks(plain, cfg, state, inputs)
    err = compare(name, ks, ko, ps, po)
    return k_ms, p_ms, err, ko[-1].cpu().numpy()


def log_check(name, k_ms, p_ms, err, stats):
    log(f"[3] {name}  C={CHUNK}  kernel {k_ms:.4f} ms/launch  plain "
        f"{p_ms:.4f} ms/launch  max_abs_err {err:.3e}  auction rounds/frame "
        f"{stats[:, 0].mean():.2f} (max {stats[:, 0].max()})  bids/frame "
        f"{stats[:, 1].mean():.2f}  gallery pairs/frame "
        f"{stats[:, 2].mean():.1f}")


def check_crowded(name, stats):
    rounds = float(stats[:, 0].mean())
    if rounds < MIN_CROWDED_ROUNDS:
        raise AssertionError(
            f"{name}: the crowded stream ran {rounds:.2f} auction rounds per "
            f"frame, fewer than {MIN_CROWDED_ROUNDS}: no contention")


def per_launch(stats):
    """Per-frame stats [S, 3] -> their mean over launches, [CHUNK, 3]."""
    return stats.reshape(-1, CHUNK, 3).mean(0)


def sort_bound_ms(c, stats):
    n = D + T
    nbytes = (c * D * 7 * 4 + 2 * (T * 40 * 4 + 4)
              + c * D * 28 + c * 16)
    ops = c * D * T * 20 + int(stats[:, 1].sum()) * n * 3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def visual_bound_ms(c, stats, bf16):
    n = D + T
    state = T * 40 * 4 + T * K * F * 4 + T * K * 8 + 2 * T * 4 + T * F * 4 + T * 4
    nbytes = c * D * (10 + F) * 4 + 2 * state + c * D * 44 + c * 16
    pairs = int(stats[:, 2].sum())
    dot_ms = pairs * 2 * F / (BF16_OPS_PER_S if bf16 else F32_OPS_PER_S) * 1e3
    other = c * D * T * 40 + int(stats[:, 1].sum()) * n * 3
    by_ops = dot_ms + other / F32_OPS_PER_S * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def kernel_entry(name, replaces, k_ms, p_ms, bound):
    return dict(name=name, route="cuda",
                source="similari_tpu_torch/csrc/fused_track.cu",
                replaces=replaces, launches=0, max_abs_err=0.0, ms=k_ms,
                plain_ms=p_ms, bound_ms=bound[0], bound_by=bound[1],
                library_ms=None)


def phase_sort(args, dev):
    cfg = sequence_sort_config()
    st0 = fs.state_to_tuple(new_sort_state(T, 1, device=dev))
    streams = {
        "random_walk": make_inputs(args.frames, args.seed)[:3],
        "crowded": crowded_stream(args.seed, args.frames, D, D_VALID, F,
                                  CROWD_SPREAD)[:3],
    }
    errs, entry = [], None
    for stream, arrays in streams.items():
        inputs = [torch.as_tensor(x, device=dev) for x in arrays]
        k_ms, p_ms, err, stats = check_kernel(
            f"fused_sort[{stream}]", fs.fused_sort_chunk,
            fs.fused_sort_chunk_plain, cfg, st0, inputs)
        errs.append(err)
        log_check(f"fused_sort[{stream}]", k_ms, p_ms, err, stats)
        if dev.type == "cuda":
            plan = fs.fused_sort_chunk.plan
            log(f"[3] fused_sort[{stream}] launch: one cluster of "
                f"{plan['cluster']} blocks x {plan['threads']} threads, "
                f"{fs.STORAGE[plan['storage']]}, {plan['smem_bytes']} bytes "
                f"of shared memory per block")
            split = phase_split(fs, fs.fused_sort_chunk, cfg, st0, inputs)
            log_split(f"fused_sort[{stream}]", fs.PHASES, split)
            log(f"[3] fused_sort[{stream}] cluster barriers: {split[2]:.2f} "
                f"per frame, {(split[2] - 2) / stats[:, 0].mean():.2f} per "
                f"auction round (two per frame: the span, the match flags), "
                f"plus one per launch")
        if stream == "crowded":
            check_crowded("fused_sort", stats)
        else:
            entry = kernel_entry("fused_sort",
                                 "similari_tpu/ops/pallas_sort.py:140", k_ms,
                                 p_ms, sort_bound_ms(CHUNK, per_launch(stats)))
    entry["max_abs_err"] = max(errs)
    return entry


def visual_configs():
    """Name -> VisualConfig: tests/test_pallas_visual.py's four, the
    flagship euclidean one also with bf16 inputs, and the main path's."""
    cfgs = {name: VisualConfig(**kw) for name, kw in VISUAL_CONFIGS.items()}
    cfgs["euclid_iou_bf16"] = VisualConfig(**VISUAL_CONFIGS["euclid_iou"],
                                           feature_precision="bf16")
    cfgs["main_path"] = sequence_visual_config()
    return cfgs


def mma_counts():
    """{kernel: (HGMMA, HMMA) instructions} for each kernel of
    `csrc/gallery_dots.cu` in the built library (`cuobjdump -sass`): the
    bf16 product (`gallery_dots_wgmma_kernel`), the staging pass and the
    f32 forms."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.build())],
                          capture_output=True, text=True, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        m = re.search(r"\d(gallery_dots_[a-z0-9_]*?kernel)(ILb([01])E)?",
                      part.split("\n", 1)[0])
        if m:
            name = m.group(1) + ("" if m.group(3) is None else
                                 "<vec>" if m.group(3) == "1" else "<scalar>")
            counts[name] = (len(re.findall(r"\bHGMMA\.", part)),
                            len(re.findall(r"\bHMMA\.", part)))
    return counts


def kernel_resources(build_log, name):
    """(registers, spill line) that ptxas reported for the kernel whose
    mangled name holds `name`; None when this process built nothing (the
    library was built before)."""
    if not build_log:
        return None
    lines = build_log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and name in line:
            spill = next(x for x in lines[i + 1:] if "spill" in x)
            regs = next(x for x in lines[i + 1:] if "registers" in x)
            return (int(re.search(r"Used (\d+) registers", regs).group(1)),
                    spill.strip())
    raise AssertionError(f"ptxas reported nothing for {name}")


def device_ms_per_call(fn, match, calls):
    """torch.profiler over `calls` calls of fn, after one warm-up call:
    device ms per call of the kernels whose name holds `match` (the mean
    time of each such kernel, summed over the kernels: each runs once a
    call; the profiler may drop some launches), and {kernel name: launches
    seen}."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in profiling.device_events(prof):
        if match in e.name:
            times.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return (sum(float(np.mean(t)) for t in times.values()) / 1e3,
            {name: len(t) for name, t in times.items()})


def phase_split(mod, chunk_fn, cfg, state, inputs):
    """One extra run of the stream through a fused kernel's wrapper
    (`fs.fused_sort_chunk` or `fv.fused_visual_chunk`; `mod` its module)
    with its phase stamps: ms per frame in each of `mod.PHASES`, the mean
    over the frames, the whole frame, and (SORT) the mean cluster barriers
    per frame, else None."""
    stamps, n = [], len(mod.PHASES) + 1

    def profiled(cfg, st, *xs):
        prof = torch.zeros((CHUNK, mod.PROF_WIDTH), dtype=torch.int64,
                           device=xs[0].device)
        stamps.append(prof)
        return chunk_fn(cfg, st, *xs, prof=prof)

    run_chunks(profiled, cfg, state, inputs)
    st = torch.cat(stamps).cpu().numpy()
    per_phase = np.diff(st[:, :n], axis=1).mean(0) / 1e6
    barriers = float(st[:, n].mean()) if st.shape[1] > n else None
    return per_phase, float((st[:, n - 1] - st[:, 0]).mean() / 1e6), barriers


def log_split(label, phases, split):
    per_phase, frame, barriers = split
    log(f"[3] {label} phase split (ms/frame, global timer, one profiled run):"
        f" " + ", ".join(f"{n} {x:.4f}" for n, x in zip(phases, per_phase))
        + f"; frame {frame:.4f}" + ("" if barriers is None else
                                    f"; cluster barriers/frame {barriers:.2f}"))


def dots_bound_ms(n, m, needed, bf16):
    """The chunk rows and lanes read once, the needed products and the
    norms written once; 2F operations per needed product (bf16 or f32
    rate) and per norm (f32)."""
    by_bytes = ((n + m) * F * 4 + needed * 4 + (n + m) * 4) / HBM_BYTES_PER_S
    by_ops = (needed * 2 * F / (BF16_OPS_PER_S if bf16 else F32_OPS_PER_S)
              + (n + m) * 2 * F / F32_OPS_PER_S)
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def library_dots(x, cols, bf16):
    """(call, name): one PyTorch call of the product the kernel computes.
    bf16: `torch.mm` of the bf16 operands with f32 sums and output (or,
    where this PyTorch lacks `out_dtype`, with a bf16 output, named so);
    f32: `x @ cols.T` with TF32 off."""
    if not bf16:
        return (lambda: gd.f32_dots(x, cols),
                "x @ cols.T in f32, TF32 off")
    xb, cb = x.bfloat16(), cols.bfloat16()
    try:
        torch.mm(xb[:1], cb[:1].T, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        return (lambda: torch.mm(xb, cb.T),
                "torch.mm(x_bf16, cols_bf16.T) with a bf16 output (no "
                "out_dtype in this PyTorch)")
    return (lambda: torch.mm(xb, cb.T, out_dtype=torch.float32),
            "torch.mm(x_bf16, cols_bf16.T, out_dtype=torch.float32)")


def check_gallery_dots(dev, feat):
    """The gallery product's kernels against `gallery_dots_plain` at the
    main path's launch shape: the stream's first chunk (N = 16 x 128 rows)
    against T*K = 1536 lanes holding rows of its next chunk, bf16 and
    f32.  Every entry the scan reads within rtol 1e-5 and 1e-4 x |q| |g|,
    norms within 1e-5.  Times: a wrapper call's CUDA-event ms, the
    kernels' device ms per call (profiler), and the library call's.
    Returns the bf16 (main path) `kernels` entry."""
    x = feat[:CHUNK].reshape(CHUNK * D, F)
    g = feat[CHUNK:2 * CHUNK].reshape(-1, F)[:T * K].contiguous()
    n, m = x.shape[0], g.shape[0]
    need = gd.needed_columns(n, m, D, dev)
    cols = torch.cat([g, x])
    scale = x.norm(dim=1)[:, None] * cols.norm(dim=1)[None, :]
    entry = None
    for bf16 in (True, False):
        label = f"gallery_dots[{'bf16' if bf16 else 'f32'}]"
        dots, norms = gd.gallery_dots(x, g, bf16, D)
        p_dots, p_norms = gd.gallery_dots_plain(x, g, bf16)
        err = (dots - p_dots).abs()
        bad = need & ~(err <= 1e-5 * p_dots.abs() + 1e-4 * scale)
        if bool(bad.any()):
            raise AssertionError(f"{label}: products differ at "
                                 f"{bad.nonzero()[:5].tolist()}")
        torch.testing.assert_close(norms, p_norms, rtol=1e-5, atol=1e-5)
        max_err = float(err[need].max())
        rel = float((err / scale.clamp(min=1e-30))[need].max())
        call = lambda: gd.gallery_dots(x, g, bf16, D)  # noqa: E731
        k_ms = time_ms(dev, call, 50)
        dev_ms, kernels = device_ms_per_call(call, "gallery_dots", 20)
        p_ms = time_ms(dev, lambda: gd.gallery_dots_plain(x, g, bf16), 10)
        lib, lib_name = library_dots(x, cols, bf16)
        lib_ms = time_ms(dev, lib, 50)
        lib_dev_ms = device_ms_per_call(lib, "", 20)[0]
        needed = int(need.sum())
        bound = dots_bound_ms(n, m, needed, bf16)
        log(f"[3] {label} N={n} M={m} F={F}: max_abs_err {max_err:.3e} "
            f"(max {rel:.2e} x |q| |g|) over {needed} needed products; in a "
            f"loop of repeats: kernel {k_ms:.5f} ms (device {dev_ms:.5f} ms "
            f"per call: {kernels})  plain {p_ms:.5f} ms  {lib_name} "
            f"{lib_ms:.5f} ms (device {lib_dev_ms:.5f})  bound "
            f"{bound[0]:.6f} ms ({bound[1]})")
        if bf16:
            entry = dict(name="gallery_dots", route="cuda",
                         source="similari_tpu_torch/csrc/gallery_dots.cu",
                         replaces="similari_tpu/ops/pallas_visual.py:245",
                         launches=0, max_abs_err=max_err, ms=k_ms,
                         plain_ms=p_ms, bound_ms=bound[0], bound_by=bound[1],
                         library_ms=lib_ms, device_ms=dev_ms)
    return entry


def phase_visual(args, dev):
    st0 = fv.state_to_tuple(new_visual_state(T, 1, K, F, device=dev))
    random_walk = [torch.as_tensor(x, device=dev)
                   for x in make_inputs(args.frames, args.seed + 1)]
    crowded = [torch.as_tensor(x, device=dev) for x in crowded_stream(
        args.seed + 1, args.frames, D, D_VALID, F, CROWD_SPREAD)]
    cfgs = visual_configs()
    runs = [(name, "random_walk", cfg, random_walk)
            for name, cfg in cfgs.items()]
    runs.append(("main_path", "crowded", cfgs["main_path"], crowded))
    errs, entry = [], None
    for name, stream, cfg, inputs in runs:
        label = f"fused_visual[{name}, {stream}]"
        k_ms, p_ms, err, stats = check_kernel(
            label, fv.fused_visual_chunk, fv.fused_visual_chunk_plain, cfg,
            st0, inputs)
        errs.append(err)
        log_check(label, k_ms, p_ms, err, stats)
        if name == "main_path" and dev.type == "cuda":
            plan = fv.fused_visual_chunk.plan
            log(f"[3] {label} launch: one cluster of {plan['cluster']} blocks "
                f"x {plan['threads']} threads, "
                f"{fv.storage_name(plan['storage'])}, {plan['smem_bytes']} "
                f"bytes of shared memory per block")
            split = phase_split(fv, fv.fused_visual_chunk, cfg, st0, inputs)
            log_split(label, fv.PHASES, split)
            log(f"[3] {label} cluster barriers: {split[2]:.2f} per frame, "
                f"{(split[2] - 4) / stats[:, 0].mean():.2f} per auction round "
                f"(four per frame: the max distance, the argmaxes, the span, "
                f"the match flags)")
        if stream == "crowded":
            check_crowded("fused_visual", stats)
        elif name == "main_path":
            entry = kernel_entry(
                "fused_visual", "similari_tpu/ops/pallas_visual.py:85", k_ms,
                p_ms, visual_bound_ms(CHUNK, per_launch(stats),
                                      cfg.feature_precision == "bf16"))
            entry["plan"] = fv.fused_visual_chunk.plan
    entry["max_abs_err"] = max(errs)
    return entry, check_gallery_dots(dev, random_walk[3])


def synthetic_sequence(frames, seed):
    """100 random-walk objects, each with a 512-d identity plus noise."""
    rng = np.random.default_rng(seed)
    boxes = box_stream(frames, D_VALID, rng)
    ident = rng.normal(size=(D_VALID, F)).astype(np.float32)
    dets, feats = {}, {}
    for s in range(frames):
        b = boxes[s]
        w = b[:, 3] * b[:, 4]
        ltwh = np.stack([b[:, 0] - w / 2, b[:, 1] - b[:, 4] / 2, w, b[:, 4],
                         np.ones(D_VALID, np.float32)], axis=1)
        dets[s + 1] = [tuple(map(float, r)) for r in ltwh]
        noisy = ident + 0.1 * rng.normal(size=ident.shape).astype(np.float32)
        feats[s + 1] = list(noisy)
    return dets, feats


def ids_per_object(out):
    ids = np.array([[r[0] for r in out[f]] for f in sorted(out)])
    return [len(set(ids[:, i].tolist())) for i in range(ids.shape[1])], ids


def main_path_device_ms(dets, feats):
    """torch.profiler over `run_sequence_device_visual` and
    `run_sequence_device` on the first PROFILED_FRAMES frames: {kernel:
    (device ms per launch, launches)} for the fused paths' three
    kernels."""
    frames = sorted(dets)[:PROFILED_FRAMES]
    sub_d = {f: dets[f] for f in frames}
    sub_f = {f: feats[f] for f in frames}
    _, _, kernels = device_profile(lambda: run_sequence_device_visual(
        sub_d, sub_f, capacity=T, gallery=K), len(frames))
    _, _, sort_kernels = device_profile(
        lambda: run_sequence_device(sub_d, capacity=T), len(frames))
    kernels = kernels + sort_kernels
    chunks = len(frames) // CHUNK
    out = {}
    # the gallery product's two kernels (bf16: staging, then the product)
    # count as one launch of the wrapper
    for name, per_launch in (("gallery_dots", 2), ("fused_visual_kernel", 1),
                             ("fused_sort_kernel", 1)):
        times = [e.time_range.elapsed_us() / 1e3 for e in kernels
                 if name in e.name]
        if len(times) != per_launch * chunks:
            raise AssertionError(f"profile of the main path: {len(times)} "
                                 f"{name} kernels for {len(frames)} frames")
        out[name] = (float(np.sum(times)) / chunks, chunks)
    return out


def phase_main(args, dets, feats):
    zero_counts()
    vout, vfps = run_sequence_device_visual(dets, feats, capacity=T,
                                            gallery=K)
    sout, sfps = run_sequence_device(dets, capacity=T)
    counts = read_counts()
    launches = {k: counts[k]
                for k in ("fused_visual", "gallery_dots", "fused_sort")}
    log(f"[4] main path: {args.main_frames} frames x {D_VALID} objects; "
        f"run_sequence_device_visual {vfps:.1f} frames/s, "
        f"run_sequence_device {sfps:.1f} frames/s (CUDA events); "
        f"launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched {name}")
    vcount, vids = ids_per_object(vout)
    scount, _ = ids_per_object(sout)
    if any(c != 1 for c in vcount) or len(set(vids[0].tolist())) != D_VALID:
        raise AssertionError(
            f"VisualSORT: objects with more than one id: "
            f"{sum(c != 1 for c in vcount)}")
    for out in (vout, sout):
        vals = np.array([r[1:] for f in out for r in out[f]])
        if len(out) != args.main_frames or not np.isfinite(vals).all():
            raise AssertionError("main path outputs are not finite/complete")
    log(f"[4] VisualSORT: every object kept one id; SORT: "
        f"{sum(c == 1 for c in scount)}/{D_VALID} objects kept one id")
    dev_ms = main_path_device_ms(dets, feats)
    (g_ms, n), (s_ms, _), (f_ms, _) = (dev_ms[k] for k in (
        "gallery_dots", "fused_visual_kernel", "fused_sort_kernel"))
    log(f"[4] VisualSORT device ms per launch (torch.profiler, first {n} "
        f"chunks): gallery_dots (staging + product) {g_ms:.5f}, "
        f"fused_visual_kernel {s_ms:.5f}, both {g_ms + s_ms:.5f} per "
        f"{CHUNK}-frame chunk")
    log(f"[4] SORT device ms per launch (torch.profiler, first {n} chunks): "
        f"fused_sort_kernel {f_ms:.5f} per {CHUNK}-frame launch")
    return launches, vout, sout, dev_ms


# ---------------------------------------------------------------------------
# phases 5-8: the clip kernel, the oriented SORT path, NMS, Mahalanobis SORT
# ---------------------------------------------------------------------------

def oriented_stream(frames, seed=42):
    """bench.py's `bench_sort_scan` stream: 500 random-walk boxes (spread
    1000 px, 30-60 px), angles U(0, 0.6) per box and frame."""
    s = box_stream(frames, OD, np.random.default_rng(seed))
    s[..., 2] = np.random.default_rng(7).uniform(0, 0.6, size=s.shape[:2])
    return s


def nms_stream(frames):
    """bench.py's `bench_nms` stream at n=1000: boxes (seed 5, spread
    500), angles U(0, 0.6), each frame in descending order of a rank
    drawn U(0.5, 1)."""
    rng = np.random.default_rng(3)
    b = box_stream(frames, NMS_N, np.random.default_rng(5), spread=500.0)
    b[..., 2] = rng.uniform(0, 0.6, size=b.shape[:2])
    ranks = rng.uniform(0.5, 1.0, size=(frames, NMS_N)).astype(np.float32)
    order = np.argsort(-ranks, axis=1, kind="stable")
    return np.take_along_axis(b, order[:, :, None], axis=1)


def x_sorted(boxes, active):
    """The sorted path's view: stable sort by x, inactive rows last."""
    key = torch.where(active, boxes[:, 0], 3.0e38)
    return boxes[torch.sort(key, stable=True).indices]


def time_ms(dev, fn, n):
    """CUDA-event ms per call of fn, after one warm-up call."""
    fn()
    with DeviceTimer(dev) as timer:
        for _ in range(n):
            fn()
    return timer.seconds * 1e3 / n


def clip_bound_ms(d, t, near_pairs, s=1):
    """The larger of: the clip columns read once and [S, D, T] written
    once at the HBM rate; the in-radius pairs' clips at the f32 rate."""
    by_bytes = s * ((d + t) * 8 * 4 + d * t * 4) / HBM_BYTES_PER_S * 1e3
    by_ops = near_pairs * CLIP_FLOPS / F32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def check_clip_case(dev, name, det_box, trk_box, want_iou):
    """Kernel against plain version on one input; returns (a wrapper
    call's CUDA-event ms, plain ms, max_abs_err, bound, the kernel's device
    ms per launch by the profiler)."""
    det8, trk8 = cl.clip_columns(det_box), cl.clip_columns(trk_box)
    tiles = torch.zeros(1, dtype=torch.int32, device=dev)
    k = cl.clip_pairs(det8, trk8, want_iou, tiles)
    p = cl.pair_block_plain(det8, trk8, want_iou)
    far = cl.far_pairs(det8, trk8)
    if not torch.equal(k > 0, p > 0):
        raise AssertionError(f"clip[{name}]: masks differ at "
                             f"{((k > 0) != (p > 0)).nonzero()[:5].tolist()}")
    torch.testing.assert_close(k, p, rtol=RTOL, atol=ATOL)
    err = float((k - p).abs().max())
    run, want = int(tiles.item()), int(cl.tiles_to_run(far))
    if run != want:
        raise AssertionError(f"clip[{name}]: {run} tiles ran, {want} hold "
                             "an in-radius pair")
    d, t = far.shape
    total = -(-d // cl.TILE) * -(-t // cl.TILE)
    call = lambda: cl.clip_pairs(det8, trk8, want_iou)  # noqa: E731
    k_ms = time_ms(dev, call, 20)
    dev_ms = device_ms_per_call(call, "clip_pairs", 20)[0]
    p_ms = time_ms(dev, lambda: cl.pair_block_plain(det8, trk8, want_iou), 3)
    near = int((~far).sum())
    bound = clip_bound_ms(d, t, near)
    log(f"[5] clip[{name}] D={d} T={t} {'iou' if want_iou else 'inter'}  "
        f"kernel {k_ms:.4f} ms (device {dev_ms:.5f} ms per launch)  plain "
        f"{p_ms:.4f} ms  max_abs_err {err:.3e}  tiles run {run}/{total}  "
        f"in-radius pairs {near}  bound {bound[0]:.6f} ms ({bound[1]})")
    return k_ms, p_ms, err, bound, dev_ms


def vehicle_boxes(rng, n):
    """n rotated vehicles of the oriented SORT cell's model: [n, 5]."""
    h = rng.uniform(12, 28, n)
    return np.stack([rng.uniform(0, 1920, n), rng.uniform(0, 1080, n),
                     rng.uniform(-1.45, 1.45, n), rng.uniform(1.8, 2.6, n),
                     h], axis=1)


def batched_clip_scenes(dev, seed):
    """CB_S scenes, x-sorted as the sorted path sorts them: (det clip
    columns [S, D, 8], track clip columns [S, T, 8]).  A scene's n valid
    rows are vehicles, its padded rows zero; its first n + 0-64 slots are
    live (the vehicles moved by ~1 px and 0.02 rad, then new boxes), the
    rest hold stale vehicles, sorted last."""
    rng = np.random.default_rng(seed)
    det = np.zeros((CB_S, CB_D, 5), np.float32)
    trk = np.zeros((CB_S, CB_T, 5), np.float32)
    live = np.zeros((CB_S, CB_T), bool)
    for j in range(CB_S):
        n = int(rng.integers(CB_N[0], CB_N[1] + 1))
        m = n + int(rng.integers(0, 65))
        det[j, :n] = vehicle_boxes(rng, n)
        trk[j] = vehicle_boxes(rng, CB_T)
        trk[j, :n] = det[j, :n]
        trk[j, :n, :2] += rng.normal(0, 1.0, (n, 2))
        trk[j, :n, 2] += rng.normal(0, 0.02, n)
        live[j, :m] = True
    det, trk = (torch.as_tensor(x, device=dev) for x in (det, trk))
    live = torch.as_tensor(live, device=dev)

    def x_sorted_scenes(boxes, active):
        key = torch.where(active, boxes[..., 0], 3.0e38)
        idx = torch.sort(key, dim=1, stable=True).indices
        return boxes.gather(1, idx[..., None].expand_as(boxes))

    return (cl.clip_columns(x_sorted_scenes(det, det[..., 4] > 0)),
            cl.clip_columns(x_sorted_scenes(trk, live)))


def check_batched_clip(dev, seed):
    """The batched launch at the oriented SORT cell's shape: each scene
    bit-equal to its own launch and within tolerance of the plain
    version, masks equal; the tiles run equal to the tiles that hold an
    in-radius pair.  Returns the largest difference from the plain
    version."""
    det8, trk8 = batched_clip_scenes(dev, seed)
    tiles = torch.zeros(1, dtype=torch.int32, device=dev)
    k = cl.clip_pairs(det8, trk8, True, tiles)
    err, want, near = 0.0, 0, 0
    for j in range(CB_S):
        one = cl.clip_pairs(det8[j], trk8[j], True)
        if not torch.equal(k[j], one):
            raise AssertionError(f"batched clip: scene {j} differs from its "
                                 "own launch")
        p = cl.pair_block_plain(det8[j], trk8[j], True)
        if not torch.equal(k[j] > 0, p > 0):
            raise AssertionError(f"batched clip: scene {j}'s mask differs "
                                 "from the plain version's")
        torch.testing.assert_close(k[j], p, rtol=RTOL, atol=ATOL)
        err = max(err, float((k[j] - p).abs().max()))
        far = cl.far_pairs(det8[j], trk8[j])
        want += int(cl.tiles_to_run(far))
        near += int((~far).sum())
    run = int(tiles.item())
    if run != want:
        raise AssertionError(f"batched clip: {run} tiles ran, {want} hold an "
                             "in-radius pair")
    call = lambda: cl.clip_pairs(det8, trk8, True)  # noqa: E731
    dev_ms = device_ms_per_call(call, "clip_pairs", 10)[0]
    bound = clip_bound_ms(CB_D, CB_T, near, CB_S)
    log(f"[5] batched clip S={CB_S} D={CB_D} T={CB_T} (the oriented SORT "
        f"cell's shape): every scene bit-equal to its own launch, masks "
        f"equal to the plain version's, max_abs_err {err:.3e}; tiles run "
        f"{run}/{cl.tile_count(CB_S, CB_D, CB_T)}, in-radius pairs {near}; "
        f"device {dev_ms:.5f} ms per launch, bound {bound[0]:.6f} ms "
        f"({bound[1]})")
    return err


def phase_clip(args, dev):
    """Phase 5; returns the kernel's entry (launches filled in later)."""
    stream = torch.as_tensor(oriented_stream(2, args.seed + 42), device=dev)
    # one frame of the oriented SORT path: frame 1's detections against
    # frame 0's boxes in the first 500 of 2000 slots, both x-sorted
    pred = torch.zeros((OT, 5), dtype=torch.float32, device=dev)
    pred[:OD] = stream[0]
    active = torch.arange(OT, device=dev) < OD
    det_s = x_sorted(stream[1], torch.ones(OD, dtype=torch.bool, device=dev))
    trk_s = x_sorted(pred, active)
    k_ms, p_ms, err, bound, dev_ms = check_clip_case(dev, "sorted", det_s,
                                                     trk_s, True)
    g = torch.Generator(device="cpu").manual_seed(args.seed)
    errs = [err]
    errs.append(check_clip_case(
        dev, "unsorted", det_s[torch.randperm(OD, generator=g).to(dev)],
        trk_s[torch.randperm(OT, generator=g).to(dev)], True)[2])
    nms_boxes = torch.as_tensor(nms_stream(args.nms_frames)[0], device=dev)
    nms_s = x_sorted(nms_boxes, torch.ones(NMS_N, dtype=torch.bool,
                                           device=dev))
    errs.append(check_clip_case(dev, "nms", nms_s, nms_s, False)[2])
    errs.append(check_batched_clip(dev, args.seed + 21))

    exact = torch.tensor(EXACT_BOX_COLUMNS, dtype=torch.float32, device=dev)
    same = cl.clip_pairs(exact, exact, True).diagonal()
    if not torch.equal(same, torch.ones_like(same)):
        raise AssertionError(f"identical rotated boxes: IoU {same.tolist()}, "
                             "not exactly 1.0")
    det8 = cl.clip_columns(det_s)
    self_iou = cl.clip_pairs(det8, det8, True).diagonal()
    if not torch.equal(self_iou, cl.pair_block_plain(det8, det8,
                                                     True).diagonal()):
        raise AssertionError("self IoU of the stream's boxes: kernel and "
                             "plain version differ")
    gap = float((self_iou - 1.0).abs().max())
    if gap > 1e-6:
        raise AssertionError(f"a box against itself has IoU {1 - gap}")
    log(f"[5] identical rotated boxes: IoU exactly 1.0 for "
        f"{len(EXACT_BOX_COLUMNS)} boxes with integer corner offsets; the "
        f"stream's {OD} boxes against themselves within {gap:.2e} of 1 "
        f"({int((self_iou == 1.0).sum())} exactly 1.0), equal to the plain "
        "version")
    return dict(name="clip_pairs", route="cuda",
                source="similari_tpu_torch/csrc/clip.cu",
                replaces="similari_tpu/ops/pallas_clip.py:96", launches=0,
                max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms,
                bound_ms=bound[0], bound_by=bound[1], library_ms=None,
                device_ms=dev_ms)


def plain_clip_pairs(det8, trk8, want_iou, tiles=None):
    """`clip_pairs` with the plain version on any device: what phase 6
    patches into ops/clip.py to rerun the path without the kernel."""
    return cl.pair_block_plain(det8, trk8, want_iou)


def compare_scans(name, k, p):
    """Integers equal, floats within tolerance, over (state, outputs) of
    two `sort_scan` runs.  Returns the largest float difference."""
    (ks, ko), (ps, po) = k, p
    err = 0.0
    for f in ("slot", "track_id", "is_new", "length", "overflow",
              "pred_box"):
        a, b = getattr(ko, f), getattr(po, f)
        if a.dtype.is_floating_point:
            err = max(err, float((a - b).abs().max()))
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        elif not torch.equal(a, b):
            raise AssertionError(f"{name}: out.{f} differs")
    return max(err, compare_sort_states(name, ks, ps))


def compare_sort_states(label, a, b):
    """SortState fields: integers equal, floats within RTOL/ATOL; returns
    the largest float difference."""
    err = 0.0
    for fld in dataclasses.fields(a):
        x, y = getattr(a, fld.name), getattr(b, fld.name)
        pairs = ([(getattr(x, f.name), getattr(y, f.name))
                  for f in dataclasses.fields(x)] if fld.name == "kf"
                 else [(x, y)])
        for u, v in pairs:
            if u.dtype.is_floating_point:
                err = max(err, float((u - v).abs().max()))
                torch.testing.assert_close(u, v, rtol=RTOL, atol=ATOL)
            elif not torch.equal(u, v):
                raise AssertionError(f"{label}: state.{fld.name} differs")
    return err


def phase_oriented_sort(args, dev):
    """Phase 6; returns (clip launches, max_abs_err, the whole run's
    (state, outputs))."""
    s = args.oriented_frames
    box = torch.as_tensor(oriented_stream(s, args.seed + 42), device=dev)
    conf = torch.ones((s, OD), dtype=torch.float32, device=dev)
    valid = torch.ones((s, OD), dtype=torch.bool, device=dev)
    cfg = SortConfig(method="iou", assignment="auction", max_idle_epochs=5,
                     oriented=True)
    if not use_sorted_path(cfg, OD, OT, dev):
        raise AssertionError("the oriented config does not take the sorted "
                             "path on CUDA")
    st0 = new_sort_state(OT, 1, device=dev)
    sort_scan(cfg, st0, box[:2], conf[:2], valid[:2], 1)  # warm-up
    zero_counts()
    with DeviceTimer(dev) as timer:
        state, out = sort_scan(cfg, st0, box, conf, valid, 1)
    counts = read_counts()
    launches = counts["clip_pairs"]
    if launches != s:
        raise AssertionError(f"oriented SORT: {launches} clip launches for "
                             f"{s} frames")
    expect_counts("oriented SORT", counts, {"clip_pairs": s, "auction": s})
    if bool(out.overflow.any()):
        raise AssertionError("oriented SORT overflowed its 2000 slots")
    n = min(PARITY_FRAMES, s)
    kernel_run = sort_scan(cfg, st0, box[:n], conf[:n], valid[:n], 1)
    for f in ("slot", "track_id", "is_new", "length"):
        if not torch.equal(getattr(kernel_run[1], f), getattr(out, f)[:n]):
            raise AssertionError(f"oriented SORT: a second kernel run gave "
                                 f"other {f}")
    orig = cl.clip_pairs
    cl.clip_pairs = plain_clip_pairs
    try:
        plain_run = sort_scan(cfg, st0, box[:n], conf[:n], valid[:n], 1)
    finally:
        cl.clip_pairs = orig
    err = compare_scans("oriented SORT", kernel_run, plain_run)
    ids = out.track_id.cpu().numpy()
    kept = sum(len(set(ids[:, i].tolist())) == 1 for i in range(OD))
    log(f"[6] oriented SORT D={OD} T={OT}: {s} frames, "
        f"{s / timer.seconds:.1f} frames/s (CUDA events), clip launches "
        f"{launches}; {int(state.next_id)} ids, {kept}/{OD} objects kept "
        f"one id; first {n} frames equal to the plain-clip run "
        f"(max_abs_err {err:.3e})")
    return launches, err, (state, out)


def phase_nms(args, dev):
    """Phase 7; returns (the clip launches on the NMS path, the keep mask
    of each frame)."""
    frames = torch.as_tensor(nms_stream(args.nms_frames), device=dev)
    valid = torch.ones(NMS_N, dtype=torch.bool, device=dev)
    if not use_block_skip(None, True, 0, NMS_N, dev):
        raise AssertionError("NMS at n=1000 does not take the block-skip "
                             "route on CUDA")
    nms_kernel(frames[0], valid, NMS_THRESHOLD)  # warm-up
    zero_counts()
    with DeviceTimer(dev) as timer:
        keep = [nms_kernel(b, valid, NMS_THRESHOLD) for b in frames]
    launches = read_counts()["clip_pairs"]
    with DeviceTimer(dev) as dense_timer:
        dense = [nms_kernel(b, valid, NMS_THRESHOLD, block_skip=False)
                 for b in frames]
    if launches != len(frames):
        raise AssertionError(f"NMS: {launches} clip launches for "
                             f"{len(frames)} frames")
    for f, (a, b) in enumerate(zip(keep, dense)):
        if not torch.equal(a, b):
            raise AssertionError(f"NMS frame {f}: block-skip and dense keep "
                                 "other boxes")
    kept = float(torch.stack(keep).sum(1).float().mean())
    n = len(frames)
    log(f"[7] oriented NMS n={NMS_N}: block-skip "
        f"{timer.seconds * 1e3 / n:.4f} ms/frame, dense "
        f"{dense_timer.seconds * 1e3 / n:.4f} ms/frame (CUDA events), "
        f"{n} frames, clip launches {launches}, keep masks equal, "
        f"{kept:.1f} boxes kept per frame")
    return launches, keep


def phase_maha(dets, frames):
    """Phase 8: the general step's Mahalanobis SORT on phase 4's sequence."""
    out, fps = run_sequence_device(dets, method="maha", engine="step",
                                   capacity=T)
    vals = np.array([r[1:] for f in out for r in out[f]])
    if len(out) != frames or not np.isfinite(vals).all():
        raise AssertionError("Mahalanobis SORT outputs are not "
                             "finite/complete")
    count, _ = ids_per_object(out)
    log(f"[8] Mahalanobis SORT (engine='step'): {frames} frames x {D_VALID} "
        f"objects, {fps:.1f} frames/s (CUDA events), "
        f"{sum(c == 1 for c in count)}/{D_VALID} objects kept one id")


# ---------------------------------------------------------------------------
# phases 9-12: the merge kernel, batched VisualSORT, the general visual step,
# batched SORT
# ---------------------------------------------------------------------------

MERGE_CASES = [  # (label, R, F, dtype); the first is the main path's launch
    ("gallery bf16", BT * K, F, torch.bfloat16),
    ("history bf16", BT * 1, F, torch.bfloat16),
    ("gallery f32", BT * K, F, torch.float32),
    ("gallery int32", BT * K, F, torch.int32),
    ("odd bf16", BT * K, 3, torch.bfloat16),
    ("odd f32", BT * K, 129, torch.float32),
]


def merge_inputs(dev, g, s, r, f, dtype):
    """state [S, R, F], src [S, BD, F], rows unique per scene, ~90% valid,
    and in each scene two rows outside [0, R) with valid 0."""
    if dtype == torch.int32:
        state = torch.randint(-999, 999, (s, r, f), generator=g,
                              dtype=torch.int32)
        src = torch.randint(-999, 999, (s, BD, f), generator=g,
                            dtype=torch.int32)
    else:
        state = torch.randn((s, r, f), generator=g).to(dtype)
        src = torch.randn((s, BD, f), generator=g).to(dtype)
    row = torch.rand((s, r), generator=g).argsort(dim=1)[:, :BD].int()
    valid = (torch.rand((s, BD), generator=g) < 0.9).int()
    row[:, 0], valid[:, 0] = -1, 0
    row[:, 1], valid[:, 1] = r + 5, 0
    return [x.to(dev) for x in (state, src, row, valid)]


def bits(x):
    """The tensor's bytes, as an integer view (bit-equality of floats)."""
    return x.view(torch.int16) if x.dtype == torch.bfloat16 else (
        x.view(torch.int32) if x.dtype == torch.float32 else x)


def merge_bound_ms(valid, f, itemsize):
    """Each written row read from src and written to the state once, plus
    the row and valid entries."""
    nbytes = 2 * int((valid != 0).sum()) * f * itemsize + 8 * valid.numel()
    return nbytes / HBM_BYTES_PER_S * 1e3


def merge_loop_ms(dev, state, src, row, valid):
    """CUDA-event ms per call, in a loop of repeats on the same inputs, of
    the kernel, its plain version and `index_put_` (each on its own copy
    of the state)."""
    k_state, p_state, l_state = state.clone(), state.clone(), state.clone()
    s, r, f = state.shape
    sc, dd = (valid != 0).nonzero(as_tuple=True)
    flat_rows = sc.long() * r + row[sc, dd].long()
    vals = src[sc, dd]
    flat = l_state.view(s * r, f)
    return (time_ms(dev, lambda: mi.lane_merge_inplace(k_state, src, row,
                                                       valid), 50),
            time_ms(dev, lambda: mi.lane_merge_plain(p_state, src, row,
                                                     valid), 20),
            time_ms(dev, lambda: flat.index_put_((flat_rows,), vals), 50))


def phase_merge(args, dev):
    """Phase 9: the kernel bit-equal to its plain version at every dtype
    and width, written in place."""
    g = torch.Generator().manual_seed(args.seed)
    for label, r, f, dtype in MERGE_CASES:
        state, src, row, valid = merge_inputs(dev, g, BS, r, f, dtype)
        k_state, p_state = state.clone(), state.clone()
        ptr = k_state.data_ptr()
        out = mi.lane_merge_inplace(k_state, src, row, valid)
        mi.lane_merge_plain(p_state, src, row, valid)
        if out.data_ptr() != ptr:
            raise AssertionError(f"merge[{label}]: the result is not the "
                                 "input state")
        if not torch.equal(bits(k_state), bits(p_state)):
            raise AssertionError(f"merge[{label}]: kernel and plain version "
                                 "differ")
        if torch.equal(bits(k_state), bits(state)):
            raise AssertionError(f"merge[{label}]: nothing was written")
        k_ms, p_ms, lib_ms = merge_loop_ms(dev, state, src, row, valid)
        bound = merge_bound_ms(valid, f, state.element_size())
        log(f"[9] merge[{label}] S={BS} D={BD} R={r} F={f}: bit-equal, in "
            f"place; in a loop of repeats: kernel {k_ms:.5f} ms  plain "
            f"{p_ms:.5f} ms  index_put_ {lib_ms:.5f} ms  bound {bound:.6f} "
            f"ms (bytes; {int((valid != 0).sum())} valid rows)")


# phase 28: the votes and BestFit kernel at the VisualSORT stream cells'
# shapes (perfbench/mixes: scenes, padded rows, slots, objects a scene)
VOTE_CELLS = (("vsort512_stream_s1024", 1024, 128, 200, 80, 120),
              ("vsort512_crowd_s256", 256, 256, 512, 150, 250))
VOTE_THRESHOLD = 100.0  # perfbench/configs/visualsort_f512_g3.json


def votes_cell_inputs(dev, seed, s, d, t, lo, hi):
    """visual_best_fit's inputs as a cell's step makes them: lo..hi valid
    rows a scene, as many live tracks and 10 idle, 512-d identities
    N(0, 4^2) with N(0, 0.05^2) noise on each lane and row, a tenth of the
    rows new, nine tenths of the lanes valid; compat the step's stride-0
    view of the live tracks; the product and squared norms in f32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.arange(d, device=dev)
    cols = torch.arange(t, device=dev)
    n = torch.randint(lo, hi + 1, (s, 1), generator=g, device=dev)
    det_valid = rows < n
    active = cols < torch.clamp(n + 10, max=t)
    ident = 4.0 * torch.randn(s, t, F, generator=g, device=dev)
    gal = ident[:, :, None] + 0.05 * torch.randn(s, t, K, F, generator=g,
                                                 device=dev)
    src = (rows[None] % (n + 10)).expand(s, d)
    q = ident.gather(1, src[..., None].expand(s, d, F))
    new = torch.rand(s, d, generator=g, device=dev) < 0.1
    q = torch.where(new[..., None],
                    4.0 * torch.randn(s, d, F, generator=g, device=dev), q)
    q = q + 0.05 * torch.randn(s, d, F, generator=g, device=dev)
    del ident
    dot, qn, gn = gram(q, gal, "euclidean")
    feat_valid = torch.rand(s, t, K, generator=g, device=dev) < 0.9
    track_gate = active & (torch.rand(s, t, generator=g, device=dev) < 0.95)
    return (dot, qn, gn, det_valid, active[:, None, :].expand(s, d, t),
            track_gate, feat_valid, det_valid, "euclidean", VOTE_THRESHOLD)


def votes_bound_ms(args):
    """Every input read once (compat one row a scene where it is a
    stride-0 view) and every output written once, at the HBM rate."""
    dot, qn, gn, use_gate, compat, track_gate, feat_valid, det_valid = (
        args[:8])
    s, d = dot.shape[:2]
    t = track_gate.shape[1]
    nbytes = (4 * (dot.numel() + qn.numel() + gn.numel()) + use_gate.numel()
              + (s * t if compat.stride(1) == 0 else compat.numel())
              + track_gate.numel() + feat_valid.numel() + det_valid.numel()
              + s * d * (8 + 1 + 1) + s * t)
    return nbytes / HBM_BYTES_PER_S * 1e3


def phase_votes(dev, seed):
    """Phase 28: the votes and BestFit kernel against its plain version at
    the two VisualSORT stream cells' shapes: all four outputs bit-equal;
    the kernel's device ms a launch (profiler) and CUDA-event ms a call
    beside the byte bound and the plain version's ms a call.  Returns
    the kernels line's entry, from the first cell."""
    entry = None
    for i, (cell, s, d, t, lo, hi) in enumerate(VOTE_CELLS):
        args = votes_cell_inputs(dev, seed + i, s, d, t, lo, hi)
        got = vv.visual_best_fit(*args, 1)
        want = vv.visual_best_fit_plain(*args, 1)
        torch.cuda.synchronize()
        for name, a, b in zip(("t1", "has_any", "wins", "claimed"), got,
                              want):
            if not torch.equal(a, b):
                raise AssertionError(f"votes[{cell}]: {name} of the kernel "
                                     "and the plain version differ")
        wins = int(got[2].sum())
        if wins < s * lo // 2:
            raise AssertionError(f"votes[{cell}]: only {wins} rows win")
        dev_ms, seen = device_ms_per_call(
            lambda: vv.visual_best_fit(*args, 1), "visual_votes", 20)
        k_ms = time_ms(dev, lambda: vv.visual_best_fit(*args, 1), 50)
        p_ms = time_ms(dev, lambda: vv.visual_best_fit_plain(*args, 1), 5)
        bound = votes_bound_ms(args)
        log(f"[28] votes[{cell}] S={s} D={d} T={t} K={K}: bit-equal, "
            f"{wins} wins; kernel device {dev_ms:.5f} ms/launch ({seen}), "
            f"call {k_ms:.5f} ms; plain {p_ms:.4f} ms; bound {bound:.5f} "
            f"ms (bytes)")
        if entry is None:
            entry = dict(name="visual_votes", route="cuda",
                         source="similari_tpu_torch/csrc/visual_votes.cu",
                         replaces="none (the general step's votes and "
                         "BestFit; XLA in the JAX package)", launches=0,
                         max_abs_err=0.0, ms=k_ms, device_ms=dev_ms,
                         plain_ms=p_ms, bound_ms=bound, bound_by="bytes",
                         library_ms=None)
    return entry


# phase 29: the fallback auction kernel at the stream cells' shapes
# (perfbench/mixes: scenes, padded rows, slots)
AUCTION_CELLS = (("vsort512_stream_s1024", 1024, 128, 200),
                 ("sort_iou_stream_s4096", 4096, 128, 200),
                 ("vsort512_crowd_s256", 256, 256, 512),
                 ("sort_obb500_stream_s128", 256, 640, 1024))
AUCTION_THETA = 0.3  # the new-track threshold of every cell's config


def phase_auction(dev, seed):
    """Phase 29: the auction kernel through `solve_voting` against the
    plain rounds on the same masked weights at the four stream cells'
    shapes: columns bit-equal and the same rounds a call; the kernel's
    device ms a launch (profiler) and CUDA-event ms a call beside the
    byte bound (the weights read once, the columns written once) and the
    plain rounds' ms a call.  Returns the kernels line's entry, from the
    second cell (the largest share of a step)."""
    entry = None
    for i, (cell, s, d, t) in enumerate(AUCTION_CELLS):
        w, rv, cv = (torch.as_tensor(x, device=dev)
                     for x in tracking_weights(seed + i, s, d, t))
        masked = asg.edges(w, rv, cv)

        def kernel():
            return asg.solve_voting(w, AUCTION_THETA, rv, cv, "auction")

        def plain():
            return asg.auction_lap_fallback_plain(masked, AUCTION_THETA)

        r0 = profiling.counter("auction.rounds")
        got = kernel()
        r1 = profiling.counter("auction.rounds")
        want = plain()
        r2 = profiling.counter("auction.rounds")
        if not torch.equal(got, want):
            raise AssertionError(f"auction[{cell}]: the kernel's columns and "
                                 "the plain rounds' differ")
        if r1 - r0 != r2 - r1:
            raise AssertionError(f"auction[{cell}]: {r1 - r0} rounds counted "
                                 f"by the kernel, {r2 - r1} by the plain "
                                 "rounds")
        matched = int((got >= d).sum())
        dev_ms, seen = device_ms_per_call(kernel, "auction_fb_kernel", 20)
        k_ms = time_ms(dev, kernel, 50)
        p_ms = time_ms(dev, plain, 3)
        bound = (w.numel() * 4 + got.numel() * 8) / HBM_BYTES_PER_S * 1e3
        log(f"[29] auction[{cell}] S={s} D={d} T={t}: bit-equal, {matched} "
            f"rows matched, {r1 - r0} rounds; kernel device {dev_ms:.5f} "
            f"ms/launch ({seen}), call {k_ms:.5f} ms; plain rounds "
            f"{p_ms:.4f} ms; bound {bound:.5f} ms (bytes)")
        if i == 1:
            entry = dict(name="auction_fb", route="cuda",
                         source="similari_tpu_torch/csrc/auction.cu",
                         replaces="none (the general steps' fallback "
                         "auction; XLA in the JAX package)", launches=0,
                         max_abs_err=0.0, ms=k_ms, device_ms=dev_ms,
                         plain_ms=p_ms, bound_ms=bound, bound_by="bytes",
                         library_ms=None)
        del w, rv, cv, masked, got, want
    return entry


def bench_visual_config(**kw):
    """bench.py's VisualSORT bench config (`bench.py:383-388`)."""
    return VisualConfig(**dict(dict(
        positional_kind="iou", visual_kind="euclidean",
        visual_threshold=100.0, visual_minimal_track_length=3,
        max_idle_epochs=5, assignment="auction", oriented=False,
        feature_precision="bf16"), **kw))


def batch_stream(frames, scenes, dev):
    """bench.py's batched stream: one random walk of scenes x BD boxes
    (seed 42) cut into scenes, and constant per-scene features (seed 0)."""
    boxes = box_stream(frames, scenes * BD, np.random.default_rng(42))
    feat = np.random.default_rng(0).normal(size=(scenes, BD, F))
    return (torch.as_tensor(boxes.reshape(frames, scenes, BD, 5), device=dev),
            torch.as_tensor(feat.astype(np.float32), device=dev))


def compare_states(name, a, b):
    """Integer and boolean fields equal, gallery and feature history bit
    for bit, other floats within RTOL/ATOL.  Returns the largest float
    difference."""
    err = 0.0
    for fld in ("pred_box", "obs_box", "conf", "active", "last_epoch",
                "length", "track_id", "next_id", "feats", "feat_quality",
                "feat_valid", "collected", "voting_type", "hist_obs",
                "hist_pred", "hist_conf", "hist_feat", "hist_feat_valid"):
        x, y = getattr(a, fld), getattr(b, fld)
        if fld in ("feats", "hist_feat") or not x.dtype.is_floating_point:
            if not torch.equal(bits(x), bits(y)):
                raise AssertionError(f"{name}: state.{fld} differs")
        else:
            err = max(err, float((x - y).abs().max()))
            torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)
    for fld in ("mean_pos", "mean_vel", "cpp", "cpv", "cvv"):
        x, y = getattr(a.kf, fld), getattr(b.kf, fld)
        err = max(err, float((x - y).abs().max()))
        torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)
    return err


def device_profile(run, frames):
    """torch.profiler over one call of `run` (a run of `frames` frames).
    Returns (device busy ms per frame, kernel launches per frame, the
    device events in launch order).  The idle share of a frame is one
    minus the busy time over the CUDA-event frame time of unprofiled runs
    of the same frames (`tools/profile_torch_sort.py`'s reckoning)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    kernels = sorted(profiling.device_events(prof),
                     key=lambda e: e.time_range.start)
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / frames
    launches = len(kernels) / frames
    return busy, launches, kernels


def phase_batched_visual(args, dev):
    """Phase 10; returns (the merge kernel's `kernels` entry, its time and
    launches taken on this path; the in-place form's scene-frames/s; the
    plain form's final state and per-frame outputs)."""
    s, n = BS, args.batch_frames
    cfg = bench_visual_config()
    boxes, feat = batch_stream(n, s, dev)
    ones = torch.ones((s, BD), dtype=torch.float32, device=dev)
    tru = ones > 0
    st0 = mesh.new_batched_visual_state(s, BT, 1, K, F, torch.bfloat16,
                                        device=dev)
    plain_step = mesh.batched_visual_step(cfg)
    inplace_step = mesh.batched_visual_step_inplace(cfg)

    def run(step, st, frames):
        outs = []
        for i in range(frames):
            ep = torch.full((s,), 1 + i, dtype=torch.int32, device=dev)
            st, out = step(st, boxes[i], ones, tru, feat, tru, ones, ones, ep)
            outs.append(out)
        return st, outs

    # a whole warm-up run of each form: the caching allocator and the
    # auction's round count settle over the first frames.  The in-place
    # one records each merge launch's bound and keeps copies of the last
    # frame's two launch inputs (gallery, history) for the loop timings.
    merge, bounds, last = mesh.lane_merge_inplace, [], []

    def recording(state, src, row, valid):
        bounds.append(merge_bound_ms(valid, state.shape[2],
                                     state.element_size()))
        last[:] = last[-1:] + [tuple(x.clone()
                                     for x in (state, src, row, valid))]
        return merge(state, src, row, valid)

    mesh.lane_merge_inplace = recording
    try:
        run(inplace_step, map_tensors(torch.clone, st0), n)
    finally:
        mesh.lane_merge_inplace = merge
    run(plain_step, map_tensors(torch.clone, st0), n)
    # three runs of each form in turns: the host-bound frame time drifts
    # between runs by more than the forms differ
    secs = {"plain": [], "in-place": []}
    for form in ("plain", "in-place", "in-place", "plain", "plain",
                 "in-place"):
        start = map_tensors(torch.clone, st0)
        zero_counts()
        if form == "plain":
            with DeviceTimer(dev) as timer:
                st_pl, out_pl = run(plain_step, start, n)
            expect_counts("batched VisualSORT, plain", read_counts(),
                          {"visual_votes": n, "auction": n})
        else:
            with DeviceTimer(dev) as timer:
                st_in, out_in = run(inplace_step, start, n)
            counts = read_counts()
            expect_counts("batched VisualSORT, in place", counts,
                          {"lane_merge": 2 * n, "visual_votes": n,
                           "auction": n})
            launches = counts["lane_merge"]
        secs[form].append(timer.seconds)
    t_in, t_pl = (float(np.median(secs[f])) for f in ("in-place", "plain"))
    for i, (a, b) in enumerate(zip(out_in, out_pl)):
        for fld in ("track_id", "voting_type", "is_new", "overflow"):
            if not torch.equal(getattr(a, fld), getattr(b, fld)):
                raise AssertionError(f"batched VisualSORT frame {i}: {fld} "
                                     "differs between the in-place and the "
                                     "plain step")
    err = compare_states("batched VisualSORT", st_in, st_pl)
    vt = torch.stack([o.voting_type for o in out_in])
    visual = int((vt[3:] == VT_VISUAL).sum())
    if visual == 0:
        raise AssertionError("batched VisualSORT: no visual match after "
                             "frame 3: the gallery path never ran")
    if bool(torch.stack([o.overflow for o in out_in]).any()):
        raise AssertionError("batched VisualSORT overflowed its slots")
    ids = torch.stack([o.track_id for o in out_in]).cpu().numpy()
    kept = float(np.mean(ids == ids[:1]))
    loop = [merge_loop_ms(dev, *x) for x in last]
    loop_k, loop_p, loop_lib = (float(np.mean(x)) for x in zip(*loop))
    entry = dict(name="lane_merge", route="cuda",
                 source="similari_tpu_torch/csrc/merge.cu",
                 replaces="similari_tpu/ops/pallas_merge.py:36",
                 launches=launches, max_abs_err=0.0, ms=None,
                 plain_ms=loop_p, bound_ms=float(np.mean(bounds)),
                 bound_by="bytes", library_ms=loop_lib)
    profile = ""
    if dev.type == "cuda":
        for form, step, t in (("in-place", inplace_step, t_in),
                              ("plain", plain_step, t_pl)):
            start = map_tensors(torch.clone, st0)
            busy_ms, per_frame, kernels = device_profile(
                lambda: run(step, start, n), n)
            profile += (f"; {form} device busy {busy_ms:.3f} ms/frame, idle "
                        f"share {1.0 - busy_ms / (t * 1e3 / n):.3f}, "
                        f"{per_frame:.1f} kernel launches/frame")
            if form == "in-place":
                path = [e.time_range.elapsed_us() / 1e3 for e in kernels
                        if "lane_merge_kernel" in e.name]
                if len(path) != 2 * n:
                    raise AssertionError(f"batched VisualSORT profile: "
                                         f"{len(path)} merge kernels for "
                                         f"{n} frames")
                entry["ms"] = entry["device_ms"] = float(np.mean(path))
    each = "; ".join(f"{f} " + ", ".join(f"{x * 1e3 / n:.3f}" for x in v)
                     for f, v in secs.items())
    log(f"[10] batched VisualSORT S={s} D={BD} T={BT} K={K} F={F} bf16, {n} "
        f"frames: in-place {s * n / t_in:.1f} scene-frames/s "
        f"({t_in * 1e3 / n:.3f} ms/frame), plain {s * n / t_pl:.1f} "
        f"scene-frames/s ({t_pl * 1e3 / n:.3f} ms/frame) (CUDA events, "
        f"median of three runs each in turns; ms/frame {each}); merge "
        f"launches {launches} (2 per frame), votes kernel launches {n} a run "
        f"of either form (1 per frame); outputs equal every frame, "
        f"state equal (feature arrays bit for bit, max_abs_err {err:.3e}); "
        f"{visual} visual matches after frame 3; {kept:.4f} of ids equal "
        f"their first frame's{profile}")
    if entry["ms"] is not None:
        log(f"[10] merge kernel on this path: {entry['ms']:.5f} ms per launch "
            f"(profiler device time, mean of {2 * n}: gallery "
            f"{float(np.mean(path[0::2])):.5f}, history "
            f"{float(np.mean(path[1::2])):.5f}); bound {entry['bound_ms']:.6f} "
            f"ms (bytes, mean over the path's launches)")
    log(f"[10] the last frame's merge inputs in a loop of repeats (mean of "
        f"gallery and history): kernel {loop_k:.5f} ms  plain {loop_p:.5f} "
        f"ms  index_put_ {loop_lib:.5f} ms")
    return entry, s * n / t_in, (st_pl, out_pl)


def phase_general_visual(args, dev, dets, feats, fused_out):
    """Phase 11, first half: the general step on the fused path's whole
    sequence (--main-frames).  Returns its outputs."""
    n = args.main_frames
    frames = sorted(dets)[:n]
    sub_d = {f: dets[f] for f in frames}
    sub_f = {f: feats[f] for f in frames}
    out, fps = run_sequence_device_visual(sub_d, sub_f, capacity=T,
                                          gallery=K, engine="step",
                                          device=dev)
    bad = [f for f in frames if [r[0] for r in out[f]]
           != [r[0] for r in fused_out[f]]]
    log(f"[11] general step (engine='step', bf16 features): {n} frames x "
        f"{D_VALID} objects, {fps:.1f} frames/s (CUDA events); ids equal to "
        f"the fused engine's on {n - len(bad)}/{n} frames")
    if bad:
        # the general step takes norms of bf16-rounded features, the fused
        # kernel of the f32 values: compare both in f32
        f32 = [run_sequence_device_visual(
            sub_d, sub_f, capacity=T, gallery=K, engine=e, device=dev,
            feature_precision="f32")[0] for e in ("step", "fused")]
        bad32 = [f for f in frames if [r[0] for r in f32[0][f]]
                 != [r[0] for r in f32[1][f]]]
        log(f"[11] bf16 ids first differ at frame {bad[0]}; in f32 the two "
            f"engines differ on {len(bad32)} frames")
        if bad32:
            raise AssertionError("the general step and the fused engine give "
                                 "other ids in f32")
    return out


def own_area_stream(seed):
    """Phase 11's stream (numpy): bench's random walk of OA_D boxes, each
    keeping its angle U(0, 0.6) over the frames (as
    `tests/torch_parity.py::oriented_stream`), and constant identities."""
    rng = np.random.default_rng(seed + 7)
    box = box_stream(OA_FRAMES, OA_D, rng)
    box[..., 2] = rng.uniform(0, 0.6, size=OA_D)
    ident = rng.normal(size=(OA_D, F)).astype(np.float32)
    return box, np.broadcast_to(ident, (OA_FRAMES, OA_D, F)).copy()


def own_area_config(**kw):
    """Phase 11's config: bench's, oriented, own-area gated."""
    return bench_visual_config(oriented=True, own_area_use=OA_USE,
                               own_area_collect=OA_COLLECT, **kw)


def phase_own_area(args, dev):
    """Phase 11, second half: the oriented own-area history-3 config on
    `own_area_stream`.  Returns its outputs."""
    m = OA_FRAMES
    box, feat = (torch.as_tensor(x, device=dev)
                 for x in own_area_stream(args.seed))
    ones = torch.ones((m, OA_D), dtype=torch.float32, device=dev)
    # a box whose own-area share is below the use gate (~6% here) cannot
    # match a track past the minimal length visually, so ~15 detections a
    # frame start new tracks: recycling keeps the live ones within 400 slots
    cfg = own_area_config(recycle_idle=True)
    st0 = new_visual_state(OA_T, OA_H, K, F, device=dev)
    visual_scan(cfg, st0, *(x[:2] for x in (box, ones, ones > 0, feat,
                                            ones > 0, ones, ones)), 1)
    with DeviceTimer(dev) as timer:
        st, out = visual_scan(cfg, st0, box, ones, ones > 0, feat, ones > 0,
                              ones, ones, 1)
    shares = own_area_shares(box, ones > 0)
    gated = float((shares < OA_USE).float().mean())
    if not (bool(torch.isfinite(out.pred_box).all())
            and bool(torch.isfinite(st.kf.mean_pos).all())):
        raise AssertionError("oriented own-area run: outputs not finite")
    if not bool((shares < 1.0).any()):
        raise AssertionError("oriented own-area run: no box is occluded")
    if bool(out.overflow.any()):
        raise AssertionError("oriented own-area run overflowed")
    vis = float((out.voting_type[3:] == VT_VISUAL).float().mean())
    ids = out.track_id.cpu().numpy()
    kept = sum(len(set(ids[:, i].tolist())) == 1 for i in range(OA_D))
    log(f"[11] oriented own-area H={OA_H}: D={OA_D} T={OA_T} K={K} F={F}, "
        f"{m} frames, {m / timer.seconds:.1f} frames/s (CUDA events); "
        f"shares < 1 for {float((shares < 1).float().mean()):.3f} of boxes, "
        f"below the use gate for {gated:.3f}; {vis:.3f} of matches after "
        f"frame 3 visual; {int(st.next_id)} ids, {kept}/{OA_D} objects "
        f"kept one id; history rows filled "
        f"{int(st.hist_feat_valid.sum())}")
    return out


def phase_batched_sort(args, dev):
    """Phase 12: bench.py's batched SORT.  Returns (its scene-frames/s,
    (the final state, ids [N, S, D], overflow [N, S]))."""
    s, n = BS, args.batch_frames
    cfg = SortConfig(method="iou", assignment="auction", max_idle_epochs=5,
                     oriented=False)
    boxes = box_stream(n, s * BD, np.random.default_rng(42))
    boxes = torch.as_tensor(boxes.reshape(n, s, BD, 5), device=dev)
    conf = torch.ones((n, s, BD), dtype=torch.float32, device=dev)
    scan = mesh.batched_sort_scan(cfg)
    ep0 = torch.ones(s, dtype=torch.int32, device=dev)
    scan(mesh.new_batched_state(s, BT, 1, device=dev), boxes[:2], conf[:2],
         conf[:2] > 0, ep0)
    with DeviceTimer(dev) as timer:
        st, (ids, ovf) = scan(mesh.new_batched_state(s, BT, 1, device=dev),
                              boxes, conf, conf > 0, ep0)
    if bool(ovf.any()) or not bool(torch.isfinite(st.pred_box).all()):
        raise AssertionError("batched SORT overflowed or is not finite")
    ids = ids.cpu().numpy()
    log(f"[12] batched SORT S={s} x {BD} objects, T={BT}, aligned IoU, {n} "
        f"frames: {s * n / timer.seconds:.1f} scene-frames/s "
        f"({timer.seconds * 1e3 / n:.3f} ms/frame, CUDA events); "
        f"{float(np.mean(ids == ids[:1])):.4f} of ids equal their first "
        f"frame's")
    return s * n / timer.seconds, (st, torch.as_tensor(ids), ovf)


# ---------------------------------------------------------------------------
# phases 13-16: the public API (Sort, nms(), VisualSort, BatchVisualSort,
# BatchSort) on the paths above, each driven with every launch counter at 0
# ---------------------------------------------------------------------------

# the kernel wrappers' launch counters (`utils/profiling.py`) by label
COUNTERS = {"fused_sort": "fused_sort.launches",
            "fused_visual": "fused_visual.launches",
            "gallery_dots": "gallery_dots.launches",
            "clip_pairs": "clip.launches",
            "lane_merge": "merge_inplace.launches",
            "visual_votes": "visual_votes.launches",
            "auction": "auction.launches"}
_COUNT_BASE = {}
# the votes and auction kernels' launches that a phase held to its count:
# one a general VisualSORT step on the card, and one a general SORT or
# VisualSORT step with the auction (the kernels line's `launches`)
HELD = {"visual_votes": 0, "auction": 0}
OBJECT_FRAMES = 8  # phase 13's frames through `predict` on box objects
API_PROFILED_FRAMES = 16  # calls under torch.profiler for the idle share


def zero_counts():
    """Start every launch count of `read_counts` from 0."""
    _COUNT_BASE.update({k: profiling.counter(n) for k, n in COUNTERS.items()})


def read_counts():
    return {k: profiling.counter(n) - _COUNT_BASE.get(k, 0)
            for k, n in COUNTERS.items()}


def expect_counts(label, counts, want):
    """Every counter 0 except `want`'s, which must equal their values."""
    wrong = {k: v for k, v in counts.items() if v != want.get(k, 0)}
    if wrong:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    for k in HELD:
        HELD[k] += counts[k]


def api_idle_share(dev, make, call, frames):
    """(device busy ms per call, idle share) of `call(tracker, i)` over
    the first `frames` calls of a fresh tracker: torch.profiler's kernel
    time against the CUDA-event time of an unprofiled run of the same
    calls on another fresh tracker."""
    tr = make()
    with DeviceTimer(dev) as timer:
        for i in range(frames):
            call(tr, i)
    tr = make()
    busy, _, _ = device_profile(
        lambda: [call(tr, i) for i in range(frames)], frames)
    return busy, 1.0 - busy / (timer.seconds * 1e3 / frames)


def check_same(label, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = np.argwhere(got != want)[:5].tolist() if got.shape == \
            want.shape else f"shape {got.shape} vs {want.shape}"
        raise AssertionError(f"{label} differ: {bad}")


def phase_sort_api(args, dev, scan):
    """Phase 13: phase 6's stream through `Sort.predict` (the first
    OBJECT_FRAMES frames, on Universal2DBox objects) and `predict_arrays`,
    from 128 slots.  Auto-waste is held off for the run (set_auto_waste
    past its end), so slots stay comparable with phase 6's scan, which
    never wastes.  Returns the clip launches."""
    scan_state, scan_out = scan
    s = args.oriented_frames
    boxes = oriented_stream(s, args.seed + 42)
    conf = np.ones(OD, np.float32)
    objs = [[(Universal2DBox(*map(float, r)), None) for r in boxes[f]]
            for f in range(min(OBJECT_FRAMES, s))]

    def make():
        return Sort(method=PositionalMetricType.iou(0.3), max_idle_epochs=5,
                    initial_capacity=128, assignment_backend="auction",
                    device=dev)

    for b in boxes[:2]:  # warm-up
        make().predict_arrays(0, b, conf)
    tr = make()
    tr.set_auto_waste(s + 1)
    obj_ms, arr_ms = [], []
    zero_counts()
    for f in range(s):
        with DeviceTimer(dev) as timer:
            if f < len(objs):
                tracks = tr.predict(objs[f])
            else:
                _, ids, _, length, slot = tr.predict_arrays(0, boxes[f], conf)
        if f < len(objs):
            obj_ms.append(timer.seconds * 1e3)
            ids = [t.id for t in tracks]
            length = [t.length for t in tracks]
        else:
            arr_ms.append(timer.seconds * 1e3)
            check_same(f"Sort frame {f}: slots", slot,
                       scan_out.slot[f].cpu().numpy())
        check_same(f"Sort frame {f}: ids", ids,
                   scan_out.track_id[f].cpu().numpy())
        check_same(f"Sort frame {f}: lengths", length,
                   scan_out.length[f].cpu().numpy())
    counts = read_counts()
    expect_counts("Sort", counts, {"clip_pairs": s, "auction": s})
    st = tr._scenes[0].state
    cap = st.capacity
    t = min(cap, OT)  # the slots both stores have; the others inactive
    for fld in ("active", "track_id", "length", "last_epoch"):
        a, b = getattr(st, fld), getattr(scan_state, fld)
        check_same(f"Sort final state.{fld}", a[:t].cpu().numpy(),
                   b[:t].cpu().numpy())
    if bool(st.active[t:].any()) or bool(scan_state.active[t:].any()):
        raise AssertionError("Sort: a slot only one store has is active")
    n_ids = tr._next_track_id
    busy, idle = api_idle_share(
        dev, make, lambda t, i: t.predict_arrays(0, boxes[i], conf),
        min(API_PROFILED_FRAMES, s))
    tr.skip_epochs(tr._max_idle + 1)
    wasted = sorted(w.id for w in tr.wasted())
    if wasted != list(range(1, n_ids + 1)) or tr.wasted():
        raise AssertionError(f"Sort: wasted() gave {len(wasted)} tracks "
                             f"({len(set(wasted))} ids) for {n_ids} ids")
    log(f"[13] Sort API, oriented D={OD} from 128 slots (grown to {cap}), "
        f"{s} frames: ids, slots and lengths equal to phase 6's scan "
        f"(T={OT}) every frame, final state equal; clip launches "
        f"{counts['clip_pairs']} (one per predict); predict on "
        f"Universal2DBox objects {np.mean(obj_ms):.3f} ms per call (first "
        f"{len(obj_ms)} frames; without the first "
        f"{np.mean(obj_ms[1:] or obj_ms):.3f}), predict_arrays "
        f"{np.mean(arr_ms):.3f} ms per call ({1e3 / np.mean(arr_ms):.1f} "
        f"frames/s; CUDA events); device busy {busy:.3f} ms per call, idle "
        f"share {idle:.3f} (torch.profiler, first "
        f"{min(API_PROFILED_FRAMES, s)} calls); wasted() after "
        f"skip_epochs({tr._max_idle + 1}) returned each of the {n_ids} "
        f"tracks once")
    return counts["clip_pairs"]


def phase_nms_api(args, dev, keeps):
    """Phase 14: phase 7's frames through the public `nms()` on
    Universal2DBox inputs, each scored in the frame's rank order.
    Returns the clip launches."""
    frames = nms_stream(args.nms_frames)
    scores = 1.0 - np.arange(NMS_N) / NMS_N
    dets = [[(Universal2DBox(*map(float, r)), float(sc))
             for r, sc in zip(fr, scores)] for fr in frames]
    nms(dets[0], NMS_THRESHOLD, device=dev)  # warm-up
    zero_counts()
    with DeviceTimer(dev) as timer:
        kept = [nms(d, NMS_THRESHOLD, device=dev) for d in dets]
    counts = read_counts()
    expect_counts("nms()", counts, {"clip_pairs": len(frames)})
    for f, (k, d) in enumerate(zip(kept, dets)):
        index = {id(bb): i for i, (bb, _) in enumerate(d)}
        check_same(f"nms() frame {f}: kept boxes", [index[id(b)] for b in k],
                   keeps[f].nonzero().squeeze(1).cpu().numpy())
    log(f"[14] nms() API, oriented n={NMS_N}, {len(frames)} frames: kept "
        f"boxes equal to phase 7's nms_kernel every frame; clip launches "
        f"{counts['clip_pairs']}; {timer.seconds * 1e3 / len(frames):.3f} ms "
        f"per call (CUDA events; phase 7's kernel alone above)")
    return counts["clip_pairs"]


def visual_api_options(backend=None, **kw):
    opts = VisualSortOptions().feature_precision("bf16")
    for name, value in kw.items():
        getattr(opts, name)(value)
    if backend is not None:
        opts.visual_minimal_own_area_percentage_use(OA_USE)
        opts.visual_minimal_own_area_percentage_collect(OA_COLLECT)
        opts.own_area_backend(backend)
    return opts


def run_visual_api(dev, opts, frames, inputs):
    """`VisualSort.predict_arrays` over `frames` frames of
    inputs(f) = (box, conf, feat); returns (tracker, per-frame ids,
    seconds, launch counts)."""
    def make():
        return VisualSort(1, opts, initial_capacity=128,
                          assignment_backend="auction", device=dev)

    warm = make()
    for f in range(2):
        warm.predict_arrays(0, *inputs(f))
    tr, ids = make(), []
    zero_counts()
    with DeviceTimer(dev) as timer:
        for f in range(frames):
            ids.append(tr.predict_arrays(0, *inputs(f))[1])
    return tr, ids, timer.seconds, read_counts()


def phase_visual_api(args, dev, dets, feats, step_out, oa_out):
    """Phase 15: VisualSort on phase 4's stream (phase 11's engine='step'
    config, bf16), then on phase 11's oriented own-area config with the
    device and the host (f64 clipping oracle) shares."""
    from similari_tpu_torch.eval.mot import ltwh_to_vec5

    n = min(args.step_frames, args.main_frames)
    frames = sorted(dets)[:n]
    rows = [np.asarray(dets[f], np.float32) for f in frames]
    arrays = [(ltwh_to_vec5(r), np.clip(r[:, 4], 0.0, 1.0),
               np.asarray(feats[f], np.float32)) for r, f in zip(rows, frames)]
    opts = visual_api_options(
        visual_metric=VisualSortMetricType.cosine(0.5),
        positional_metric=PositionalMetricType.iou(0.3),
        visual_minimal_track_length=1, max_idle_epochs=10,
        kept_history_length=1, visual_max_observations=K)
    tr, ids, secs, counts = run_visual_api(dev, opts, n, arrays.__getitem__)
    expect_counts("VisualSort", counts, {"visual_votes": n, "auction": n})
    for i, f in enumerate(frames):
        check_same(f"VisualSort frame {f}: ids", ids[i],
                   [r[0] for r in step_out[f]])
    log(f"[15] VisualSort API (phase 11's engine='step' config, bf16 "
        f"gallery), {n} frames x {D_VALID} objects from 128 slots (grown to "
        f"{tr._scenes[0].state.capacity}): ids equal to phase 11's every "
        f"frame; {n / secs:.1f} frames/s ({secs * 1e3 / n:.3f} ms per "
        f"predict_arrays, CUDA events); the votes kernel launched once a "
        f"frame (the general step), no other kernel")

    box, feat = own_area_stream(args.seed)
    ones = np.ones(OA_D, np.float32)
    runs = {}
    for backend in ("device", "host"):
        opts = visual_api_options(
            backend, visual_metric=VisualSortMetricType.euclidean(100.0),
            visual_minimal_track_length=3, max_idle_epochs=5,
            kept_history_length=OA_H, visual_max_observations=K)
        runs[backend] = run_visual_api(
            dev, opts, OA_FRAMES, lambda f: (box[f], ones, feat[f]))
    tr, dev_ids, dev_secs, counts = runs["device"]
    expect_counts("VisualSort own-area", counts,
                  {"visual_votes": OA_FRAMES, "auction": OA_FRAMES})
    cap = tr._scenes[0].state.capacity
    # the API retires idle tracks by auto-waste, not in the step: the
    # same config without recycle_idle, at the capacity the API grew to
    ones_t = torch.ones((OA_FRAMES, OA_D), device=dev)
    _, ref = visual_scan(own_area_config(), new_visual_state(
        cap, OA_H, K, F, torch.bfloat16, device=dev),
        torch.as_tensor(box, device=dev), ones_t, ones_t > 0,
        torch.as_tensor(feat, device=dev), ones_t > 0, ones_t, ones_t, 1)
    for f in range(OA_FRAMES):
        check_same(f"VisualSort own-area frame {f}: ids", dev_ids[f],
                   ref.track_id[f].cpu().numpy())
    p11 = oa_out.track_id.cpu().numpy()
    same11 = sum(np.array_equal(dev_ids[f], p11[f]) for f in range(OA_FRAMES))
    _, host_ids, host_secs, _ = runs["host"]
    differ = sum(not np.array_equal(a, b) for a, b in zip(dev_ids, host_ids))
    log(f"[15] VisualSort API, phase 11's oriented own-area config (D={OA_D}, "
        f"H={OA_H}, K={K}, F={F} bf16, use/collect {OA_USE}/{OA_COLLECT}) "
        f"from 128 slots (grown to {cap}), {OA_FRAMES} frames: "
        f"own_area_backend='device' ids equal to the general scan of that "
        f"config without recycle_idle at T={cap} every frame, and to phase "
        f"11's (recycle_idle, T={OA_T}) on {same11}/{OA_FRAMES} frames; "
        f"{OA_FRAMES / dev_secs:.1f} frames/s; 'host' (the f64 clipping "
        f"oracle) {OA_FRAMES / host_secs:.1f} frames/s, ids differing from "
        f"'device' on {differ}/{OA_FRAMES} frames "
        f"({differ / OA_FRAMES:.3f}; CUDA events)")


def scene_id_maps(label, maps, api_ids, ref_ids):
    """Per scene, the API's id of each detection must be a fixed
    one-to-one function of the plain step's id (they differ only by the
    per-scene reservation)."""
    for sc, (a, r) in enumerate(zip(api_ids, ref_ids)):
        m = maps.setdefault(sc, {})
        if len(set(a)) != len(a):
            raise AssertionError(f"{label} scene {sc}: ids not distinct")
        for x, y in zip(a, r):
            if m.setdefault(y, x) != x:
                raise AssertionError(f"{label} scene {sc}: ids not stable")


def run_batch_api(label, dev, tracker, requests, ref_step, ref_state, ref_in):
    """Predict every request (counters zeroed before, read after; CUDA
    events around each predict), then step the plain batched step over
    the same frames and compare per frame: lengths, is_new (length 1),
    voting types, the per-slot state (active, length, last_epoch, so
    every slot allocation) and per-scene id maps.  Returns (scene-frames
    per second, launch counts)."""
    secs, snaps, results = 0.0, [], []
    zero_counts()
    for req in requests:
        with DeviceTimer(dev) as timer:
            res = tracker.predict(req)
        secs += timer.seconds
        scenes = dict(res.get() for _ in range(res.batch_size()))
        results.append([scenes[sc] for sc in range(BS)])
        st = tracker._engine.state
        snaps.append([getattr(st, f).cpu().numpy()
                      for f in ("active", "length", "last_epoch")])
    counts = read_counts()
    maps, cap = {}, tracker._engine.T
    for i, (tracks, snap) in enumerate(zip(results, snaps)):
        ref_state, out = ref_step(ref_state, *ref_in(i))
        length = np.array([[t.length for t in ts] for ts in tracks])
        vt = np.array([[t.voting_type.value for t in ts] for ts in tracks])
        check_same(f"{label} frame {i}: lengths", length,
                   out.length[:, :BD].cpu().numpy())
        check_same(f"{label} frame {i}: is_new", length == 1,
                   out.is_new[:, :BD].cpu().numpy())
        if hasattr(out, "voting_type"):
            check_same(f"{label} frame {i}: voting types", vt,
                       out.voting_type[:, :BD].cpu().numpy())
        # the capacities differ (the API's grows from 128): the slots both
        # have must agree, and every other slot be inactive
        ref_active = ref_state.active.cpu().numpy()
        t = min(snap[0].shape[1], BT)
        for fld, a in zip(("active", "length", "last_epoch"), snap):
            check_same(f"{label} frame {i}: state.{fld}", a[:BS, :t],
                       getattr(ref_state, fld)[:, :t].cpu().numpy())
        if snap[0][:, t:].any() or snap[0][BS:].any() or \
                ref_active[:, t:].any():
            raise AssertionError(f"{label} frame {i}: a slot only one side "
                                 "has is active")
        scene_id_maps(label, maps,
                      [[t.id for t in ts] for ts in tracks],
                      out.track_id[:, :BD].cpu().numpy())
    return BS * len(requests) / secs, counts, cap


def phase_batch_api(args, dev, visual_rate, sort_rate):
    """Phase 16: phase 10's stream through BatchVisualSort and phase 12's
    through BatchSort (engine="device"), from 128 slots."""
    n = args.batch_frames
    boxes, feat = batch_stream(n, BS, dev)
    boxes_np, feat_np = boxes.cpu().numpy(), feat.cpu().numpy()
    t0 = time.perf_counter()
    requests = []
    for i in range(n):
        req = VisualSortPredictionBatchRequest()
        for sc in range(BS):
            for j in range(BD):
                req.add(sc, VisualSortObservation(
                    feat_np[sc, j], 1.0,
                    Universal2DBox.from_vec5(boxes_np[i, sc, j], 1.0)))
        requests.append(req)
    build_ms = (time.perf_counter() - t0) * 1e3 / n
    opts = VisualSortOptions().feature_precision("bf16")
    for name, value in (("visual_metric", VisualSortMetricType.euclidean(100.0)),
                        ("visual_minimal_track_length", 3),
                        ("max_idle_epochs", 5), ("kept_history_length", 1),
                        ("visual_max_observations", K)):
        getattr(opts, name)(value)
    tracker = BatchVisualSort(opts=opts, initial_capacity=128,
                              assignment_backend="auction", engine="device",
                              device=dev)
    ones = torch.ones((BS, BD), dtype=torch.float32, device=dev)
    ep = lambda i: torch.full((BS,), 1 + i, dtype=torch.int32,  # noqa: E731
                              device=dev)
    rate, counts, cap = run_batch_api(
        "BatchVisualSort", dev, tracker, requests,
        mesh.batched_visual_step_inplace(bench_visual_config()),
        mesh.new_batched_visual_state(BS, BT, 1, K, F, torch.bfloat16,
                                      device=dev),
        lambda i: (boxes[i], ones, ones > 0, feat, ones > 0, ones, ones,
                   ep(i)))
    expect_counts("BatchVisualSort", counts,
                  {"lane_merge": 2 * n, "visual_votes": n, "auction": n})
    log(f"[16] BatchVisualSort API S={BS} x {BD} objects, F={F} bf16, from "
        f"128 slots (grown to {cap}), {n} frames: lengths, is_new, voting "
        f"types and every slot's state equal to phase 10's in-place step "
        f"every frame, ids a fixed one-to-one map of its ids per scene; "
        f"merge launches {counts['lane_merge']} (2 per predict), votes "
        f"kernel launches {counts['visual_votes']} (1 per predict); "
        f"{rate:.1f} scene-frames/s in predict ({BS / rate * 1e3:.3f} ms "
        f"per request; phase 10's bare in-place step {visual_rate:.1f}; "
        f"building a request {build_ms:.3f} ms more; CUDA events)")
    merge_launches = counts["lane_merge"]

    sboxes = torch.as_tensor(box_stream(n, BS * BD, np.random.default_rng(42))
                             .reshape(n, BS, BD, 5), device=dev)
    sboxes_np = sboxes.cpu().numpy()
    requests = []
    for i in range(n):
        req = SortPredictionBatchRequest()
        for sc in range(BS):
            for j in range(BD):
                req.add(sc, Universal2DBox.from_vec5(sboxes_np[i, sc, j]))
        requests.append(req)
    tracker = BatchSort(max_idle_epochs=5,
                        method=PositionalMetricType.iou(0.3),
                        initial_capacity=128, assignment_backend="auction",
                        engine="device", device=dev)
    cfg = SortConfig(method="iou", assignment="auction", max_idle_epochs=5,
                     oriented=False)
    rate, counts, cap = run_batch_api(
        "BatchSort", dev, tracker, requests, mesh.batched_sort_step(cfg),
        mesh.new_batched_state(BS, BT, 1, device=dev),
        lambda i: (sboxes[i], ones, ones > 0, ep(i)))
    expect_counts("BatchSort", counts, {"auction": n})
    log(f"[16] BatchSort API S={BS} x {BD} objects from 128 slots (grown to "
        f"{cap}), {n} frames: lengths, is_new and every slot's state equal "
        f"to phase 12's step every frame, ids a fixed one-to-one map per "
        f"scene; {rate:.1f} scene-frames/s in predict "
        f"({BS / rate * 1e3:.3f} ms per request; phase 12's bare scan "
        f"{sort_rate:.1f}; CUDA events); no kernel launched")
    return merge_launches

# ---------------------------------------------------------------------------
# phase 17: the host engines (engine="host": NumPy and the C++ LAP solver)
# beside the device engines on the same calls, at the per-call widths of
# bench.py::bench_interactive_host
# ---------------------------------------------------------------------------

HOST_WARMUP = 2  # calls compared but not timed
HOST_CALLS = {10: 16, 50: 16, 100: 16, 500: 8, 1000: 4}  # timed calls
HOST_FEATURE_DIM = 256
HOST_VISUAL_DIM = 512
HOST_BATCH_REQUESTS = 4  # S=256 x 100 requests through both engines
KF_STEPS = 10_000  # filter_sequence's track length


def cpu_model():
    """The host CPU's model name from /proc/cpuinfo (or lscpu); where the
    name reads "unknown", as in a sandboxed VM, its vendor, family, model
    and vector extensions instead."""
    fields = {}
    cpuinfo = Path("/proc/cpuinfo")
    if cpuinfo.exists():
        for line in cpuinfo.read_text().splitlines():
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    elif shutil.which("lscpu"):
        out = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
        for line in out.splitlines():
            key, _, value = line.partition(":")
            fields.setdefault(key.strip().replace("Model name", "model name"),
                              value.strip())
    name = fields.get("model name", "")
    if name and name.lower() != "unknown":
        return name
    flags = set(fields.get("flags", "").split())
    ext = [f for f in ("avx2", "avx512f", "amx_tile") if f in flags]
    return (f"model name {name or 'not reported'} (vendor "
            f"{fields.get('vendor_id', '?')}, family "
            f"{fields.get('cpu family', '?')}, model "
            f"{fields.get('model', '?')}; {', '.join(ext) or 'no avx2'}; "
            f"{platform.machine()})")


def blas_threads():
    """The thread count of the OpenBLAS that numpy loaded, asked through
    its own entry point (found in this process's memory map)."""
    import ctypes

    maps = Path("/proc/self/maps")
    libs = sorted({line.split()[-1] for line in (
        maps.read_text().splitlines() if maps.exists() else [])
        if "openblas" in line.lower() and line.split()[-1].startswith("/")})
    for path in libs:
        lib = ctypes.CDLL(path)
        for sym in ("scipy_openblas_get_num_threads64_",
                    "openblas_get_num_threads64_", "openblas_get_num_threads"):
            fn = getattr(lib, sym, None)
            if fn is not None:
                return f"{fn()} ({Path(path).name})"
    return "not reported"


def host_info():
    """(CPU model, BLAS threads, torch threads, cores) of this host, written
    beside every host timing."""
    return cpu_model(), blas_threads(), torch.get_num_threads(), os.cpu_count()


def timed(dev, fn):
    """(fn(), wall ms): a device engine's call returns only after its
    outputs are on the host."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def counted(dev, fn):
    """(fn(), wall ms, launch counts of the call)."""
    zero_counts()
    out, ms = timed(dev, fn)
    return out, ms, read_counts()


def resync(dev_tr, host_tr, dev):
    """Seed the device tracker's scene 0 with the host tracker's state
    (after a frame whose two solutions tie)."""
    from similari_tpu_torch.trackers.host_sort import state_to_device

    hs, ds = host_tr._scenes[0], dev_tr._scenes[0]
    ds.state = state_to_device(hs.state, dev)
    ds.active_count = hs.active_count
    dev_tr._next_track_id = host_tr._next_track_id


class NumpySortSession:
    """`native.SortStepSession`'s interface over the NumPy twin
    (`host_sort_step_numpy`, the host engine before the C++ steps), for
    timing it beside them."""

    def __init__(self, cfg, state):
        self.cfg, self.state = cfg, state

    def step(self, det_box, det_conf, epoch, next_id):
        st = dataclasses.replace(self.state, next_id=np.int32(next_id))
        st, o = host_sort_step_numpy(self.cfg, st, det_box, det_conf, epoch)
        return (int(st.next_id), o["slot"], o["track_id"], o["is_new"],
                o["pred_box"], o["length"])


class NumpyVisualSession(NumpySortSession):
    """`native.VisualStepSession`'s interface over
    `host_visual_step_numpy`."""

    def step(self, *args):
        *dets, epoch, next_id = args
        st = dataclasses.replace(self.state, next_id=np.int32(next_id))
        st, o = host_visual_step_numpy(self.cfg, st, *dets, epoch)
        return (int(st.next_id), o["slot"], o["track_id"], o["is_new"],
                o["pred_box"], o["length"], o["voting_type"])


@contextlib.contextmanager
def numpy_twins():
    """Host stores made or grown inside take the NumPy twins' sessions."""
    saved = native.SortStepSession, native.VisualStepSession
    native.SortStepSession = NumpySortSession
    native.VisualStepSession = NumpyVisualSession
    try:
        yield
    finally:
        native.SortStepSession, native.VisualStepSession = saved


def twin_ms(dev, make, frames, call):
    """A host tracker on the NumPy twins beside one on the C++ steps, on
    the same calls (`call(tracker, args)` returns the ids as a list):
    (median wall ms per timed call of the twin, calls whose ids equal the
    C++ engine's).  Neither launches a kernel."""
    native_tr, twin_tr = make(), make()
    times, same = [], 0
    for i, args in enumerate(frames):
        want, _, n_counts = counted(dev, lambda: call(native_tr, args))
        with numpy_twins():
            got, ms, t_counts = counted(dev, lambda: call(twin_tr, args))
        expect_counts(f"C++ host call {i}", n_counts, {})
        expect_counts(f"NumPy twin call {i}", t_counts, {})
        same += got == want
        if i >= HOST_WARMUP:
            times.append(ms)
    return float(np.median(times)), same


def log_twin(label, ms, same, calls):
    log(f"[17] {label}: NumPy twin {ms:.3f} ms per call (median, wall "
        f"clock), ids equal to the C++ step's on {same}/{calls} calls")


def compare_engines(label, host_tr, dev_tr, frames, dev, visual, want_dev):
    """Both trackers' predict_arrays on the same calls: ids equal, or the
    two solutions tie in the voting LP (torch_parity.solutions_tie; for
    VisualSort the visual winners equal and the positional LP tied), after
    which the device tracker takes the host tracker's state.  The host
    engine launches no kernel; each device call launches `want_dev(call)`.
    Returns (host ms, device ms) per timed call, the tie count, the host
    engine's visual matches and the device calls' clip launches."""
    from similari_tpu_torch.trackers.host_sort import as_tensors, state_to_host

    host_ms, dev_ms, ties, votes, clips = [], [], 0, 0, 0
    for i, args in enumerate(frames):
        store = host_tr._scenes.get(0)
        before = (None if store is None
                  else state_to_host(as_tensors(store.state)))
        oh, h_ms, h_counts = counted(
            dev, lambda: host_tr.predict_arrays(0, *args))
        od, d_ms, d_counts = counted(
            dev, lambda: dev_tr.predict_arrays(0, *args))
        expect_counts(f"{label} host call {i}", h_counts, {})
        expect_counts(f"{label} device call {i}", d_counts, want_dev(i))
        clips += d_counts["clip_pairs"]
        if i >= HOST_WARMUP:
            host_ms.append(h_ms)
            dev_ms.append(d_ms)
        if visual:
            votes += int((oh[5] == VT_VISUAL).sum())
        if np.array_equal(oh[1], od[1]):
            check_same(f"{label} call {i}: slots", od[4], oh[4])
            check_same(f"{label} call {i}: lengths", od[3], oh[3])
            if visual:
                check_same(f"{label} call {i}: voting types", od[5], oh[5])
            continue
        rows = np.ones(len(oh[1]), bool)
        if visual:
            check_same(f"{label} call {i}: visual winners", od[5] == VT_VISUAL,
                       oh[5] == VT_VISUAL)
            rows = oh[5] != VT_VISUAL
        cfg = dataclasses.replace(host_tr._cfg,
                                  oriented=host_tr._scenes[0].oriented)
        if before is None or not solutions_tie(
                cfg, before, args[0], args[1], oh[0], rows,
                (oh[4], oh[3] == 1), (od[4], od[3] == 1)):
            raise AssertionError(f"{label} call {i}: ids differ and the "
                                 "voting LP totals do not tie")
        ties += 1
        resync(dev_tr, host_tr, dev)
    return host_ms, dev_ms, ties, votes, clips


def log_pair(label, host_ms, dev_ms, agreement):
    log(f"[17] {label}: host {np.median(host_ms):.3f} ms per call, device "
        f"{np.median(dev_ms):.3f} (medians of {len(host_ms)} timed calls "
        f"after {HOST_WARMUP}; wall clock); {agreement}")


def ids_agree(calls, ties):
    return f"ids equal on {calls - ties}/{calls} calls, {ties} LP ties"


BATCH_AGREE = ("lengths and custom ids equal, ids one fixed one-to-one map "
               "per scene, on every request")


def host_sort_frames(n, oriented, calls):
    """bench_interactive_host's SORT stream: n boxes of 30-60 px over
    2000 x 2000 px moving +-2 px per call, fixed angles U(0, 1) when
    oriented."""
    rng = np.random.default_rng(1)
    xy = rng.uniform(0, 2000, (n, 2)).astype(np.float32)
    wh = rng.uniform(30, 60, (n, 2)).astype(np.float32)
    ang = rng.uniform(0, 1.0, (n,)).astype(np.float32)
    out = []
    for _ in range(calls):
        xy = xy + rng.uniform(-2, 2, xy.shape).astype(np.float32)
        b = np.zeros((n, 5), np.float32)
        b[:, :2] = xy
        if oriented:
            b[:, 2] = ang
        b[:, 3] = wh[:, 0] / wh[:, 1]
        b[:, 4] = wh[:, 1]
        out.append((b, np.ones((n,), np.float32)))
    return out


def host_visual_frames(n, calls):
    """bench_interactive_host's VisualSORT stream: n boxes 40 px tall over
    600 sqrt(n / 10) px with 512-d identities plus N(0, 0.05) noise,
    quality 0.9."""
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 600 * np.sqrt(n / 10), (n, 2)).astype(np.float32)
    ident = rng.normal(size=(n, HOST_VISUAL_DIM)).astype(np.float32)
    out = []
    for _ in range(calls):
        xy = xy + rng.uniform(-2, 2, xy.shape).astype(np.float32)
        box = np.zeros((n, 5), np.float32)
        box[:, :2] = xy
        box[:, 3] = 0.5
        box[:, 4] = 40.0
        feat = ident + rng.normal(scale=0.05, size=ident.shape).astype(
            np.float32)
        out.append((box, np.ones((n,), np.float32), feat, np.ones((n,), bool),
                    np.full((n,), 0.9, np.float32)))
    return out


def phase_host_sort(dev):
    """Returns the device engine's clip launches."""
    launches = 0
    for oriented in (False, True):
        # the NumPy twin's oriented n=1000 took 1.1-1.9 s a call
        for n in (10, 100, 500) if oriented else (10, 100, 500, 1000):
            calls = HOST_WARMUP + HOST_CALLS[n]
            frames = host_sort_frames(n, oriented, calls)

            def make(engine):
                return Sort(shards=1, bbox_history=1, max_idle_epochs=5,
                            method=PositionalMetricType.iou(0.3),
                            engine=engine, device=dev)

            # the device step's sorted path: oriented, >= 512 slots (the
            # store grows to the next power of two of n) and >= 64 rows
            clip = oriented and pad_pow2(n) >= 512
            host_tr, dev_tr = make("host"), make("device")
            host_ms, dev_ms, ties, _, clips = compare_engines(
                f"Sort {'oriented' if oriented else 'aligned'} n={n}",
                host_tr, dev_tr, frames, dev, False,
                lambda i: {"clip_pairs": 1, "auction": 1} if clip
                else {"auction": 1})
            launches += clips
            label = (f"Sort IoU 0.3 {'oriented' if oriented else 'aligned'} "
                     f"n={n}")
            log_pair(label, host_ms, dev_ms, ids_agree(calls, ties)
                     + f"; clip launches: host 0, device {clips}")
            log_twin(label, *twin_ms(
                dev, lambda: make("host"), frames,
                lambda tr, a: tr.predict_arrays(0, *a)[1].tolist()), calls)
    return launches


def phase_host_visual(dev):
    for n in (10, 50, 100):
        calls = HOST_WARMUP + HOST_CALLS[n]
        frames = host_visual_frames(n, calls)

        def make(engine):
            opts = (VisualSortOptions()
                    .visual_metric(VisualSortMetricType.euclidean(10.0))
                    .positional_metric(PositionalMetricType.iou(0.3))
                    .visual_minimal_track_length(2).max_idle_epochs(5))
            return VisualSort(1, opts, engine=engine, device=dev)

        host_tr, dev_tr = make("host"), make("device")
        host_ms, dev_ms, ties, votes, _ = compare_engines(
            f"VisualSort n={n}", host_tr, dev_tr, frames, dev, True,
            lambda i: {"visual_votes": 1, "auction": 1})
        if votes == 0:
            raise AssertionError(f"VisualSort n={n}: no visual match")
        label = f"VisualSort {HOST_VISUAL_DIM}-d f32 euclidean(10) n={n}"
        log_pair(label, host_ms, dev_ms, ids_agree(calls, ties)
                 + f"; {votes} visual matches over the calls")
        log_twin(label, *twin_ms(
            dev, lambda: make("host"), frames,
            lambda tr, a: tr.predict_arrays(0, *a)[1].tolist()), calls)

    # a bf16 gallery under "host" takes the device step, as in the JAX
    # package: no numpy state, the same ids as engine="device"
    frames = host_visual_frames(50, 6)
    opts = (VisualSortOptions().feature_precision("bf16")
            .visual_metric(VisualSortMetricType.euclidean(10.0))
            .visual_minimal_track_length(2))
    a = VisualSort(1, opts, engine="host", device=dev)
    b = VisualSort(1, opts, engine="device", device=dev)
    zero_counts()
    for i, fr in enumerate(frames):
        check_same(f"bf16 VisualSort call {i}: ids",
                   a.predict_arrays(0, *fr)[1], b.predict_arrays(0, *fr)[1])
    expect_counts("bf16 VisualSort", read_counts(),
                  {"visual_votes": 2 * len(frames),
                   "auction": 2 * len(frames)})
    st = a._scenes[0].state
    if a._scenes[0].host or st.feats.dtype != torch.bfloat16 or \
            st.feats.device.type != dev.type:
        raise AssertionError("bf16 VisualSort under 'host' left the device")
    log(f"[17] bf16 VisualSort under engine='host' n=50: the device step "
        f"(bf16 gallery on {st.feats.device}), ids equal to "
        f"engine='device' on {len(frames)}/{len(frames)} calls; the votes "
        f"kernel launched once a call of each, no other kernel (the general "
        f"visual step has no sorted clip path)")


def host_batch_boxes(n, calls):
    """bench_interactive_host's BatchSORT stream: n 50 x 50 px boxes over
    1000 n px, moving +-1 px per call."""
    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 1000.0 * n, (n, 2)).astype(np.float32)
    out = []
    for _ in range(calls):
        xy = xy + rng.uniform(-1, 1, xy.shape).astype(np.float32)
        out.append([BoundingBox(float(xy[i, 0]), float(xy[i, 1]), 50.0,
                                50.0).as_xyaah() for i in range(n)])
    return out


def batch_call(tracker, scenes):
    """One request of `scenes` ({scene: boxes}) built and predicted, as
    the reference's bench builds it inside its timed region; returns
    {scene: tracks}."""
    req = SortPredictionBatchRequest()
    for sc, boxes in scenes.items():
        for i, bb in enumerate(boxes):
            req.add(sc, bb, i)
    res = tracker.predict(req)
    return dict(res.get() for _ in range(res.batch_size()))


def batch_ids(tracker, scenes):
    """The ids of one request's tracks, scene by scene."""
    res = batch_call(tracker, scenes)
    return [[t.id for t in res[sc]] for sc in sorted(res)]


def compare_batches(label, host_tr, dev_tr, requests, dev):
    """Lengths and custom ids equal per scene, ids a fixed one-to-one map
    (the device engine reserves ids per scene); host engine launches
    nothing."""
    host_ms, dev_ms, maps = [], [], {}
    for i, scenes in enumerate(requests):
        rh, h_ms, h_counts = counted(dev, lambda: batch_call(host_tr, scenes))
        rd, d_ms, d_counts = counted(dev, lambda: batch_call(dev_tr, scenes))
        expect_counts(f"{label} host request {i}", h_counts, {})
        expect_counts(f"{label} device request {i}", d_counts,
                      {"auction": 1})
        if i >= HOST_WARMUP:
            host_ms.append(h_ms)
            dev_ms.append(d_ms)
        for sc in scenes:
            for fld in ("length", "custom_object_id"):
                check_same(f"{label} request {i} scene {sc}: {fld}s",
                           [getattr(t, fld) for t in rh[sc]],
                           [getattr(t, fld) for t in rd[sc]])
        scene_id_maps(label, maps, [[t.id for t in rh[sc]] for sc in scenes],
                      [[t.id for t in rd[sc]] for sc in scenes])
    return host_ms, dev_ms


def phase_host_batch(dev):
    for n in (10, 100, 500):
        calls = HOST_WARMUP + HOST_CALLS[n]

        def make(engine):
            stc = SpatioTemporalConstraints()
            stc.add_constraints([(1, 1.0)])
            return BatchSort(1, 1, bbox_history=10, max_idle_epochs=1,
                             method=PositionalMetricType.iou(0.3),
                             spatio_temporal_constraints=stc, engine=engine,
                             device=dev)

        requests = [{0: b} for b in host_batch_boxes(n, calls)]
        host_ms, dev_ms = compare_batches(f"BatchSort 1 x {n}", make("host"),
                                          make("device"), requests, dev)
        label = (f"BatchSort one scene x {n}, constraint (1, 1.0), request "
                 f"built in the timed call")
        log_pair(label, host_ms, dev_ms, BATCH_AGREE)
        log_twin(label, *twin_ms(dev, lambda: make("host"), requests,
                                 batch_ids), calls)

    # phase 16's shape: S=256 scenes x 100 objects per request
    calls = HOST_WARMUP + HOST_BATCH_REQUESTS
    boxes = box_stream(calls, BS * BD, np.random.default_rng(42)).reshape(
        calls, BS, BD, 5)
    requests = [{sc: [Universal2DBox.from_vec5(r) for r in boxes[i, sc]]
                 for sc in range(BS)} for i in range(calls)]

    def make(engine):
        return BatchSort(max_idle_epochs=5,
                         method=PositionalMetricType.iou(0.3),
                         initial_capacity=128, engine=engine, device=dev)

    host_ms, dev_ms = compare_batches(f"BatchSort {BS} x {BD}", make("host"),
                                      make("device"), requests, dev)
    label = (f"BatchSort {BS} scenes x {BD} objects (phase 16's shape), "
             f"request built in the timed call")
    log_pair(label, host_ms, dev_ms, BATCH_AGREE)
    log_twin(label, *twin_ms(dev, lambda: make("host"), requests, batch_ids),
             calls)


def phase_host_feature(dev):
    for n in (10, 100, 500):
        calls = HOST_WARMUP + HOST_CALLS[n]
        rng = np.random.default_rng(2)
        base = np.zeros((n, HOST_FEATURE_DIM), np.float32)
        base[:, 0] = 1000.0 * np.arange(n)
        ft = FeatureTracker(HOST_FEATURE_DIM, gallery=3)
        want = np.arange(1, n + 1)
        times = []
        zero_counts()
        for i in range(calls):
            base = base + rng.uniform(-0.1, 0.1, base.shape).astype(
                np.float32)
            ids, ms = timed(dev, lambda: ft.predict(base))
            check_same(f"FeatureTracker n={n} call {i}: ids", ids, want)
            if i >= HOST_WARMUP:
                times.append(ms)
        expect_counts(f"FeatureTracker n={n}", read_counts(), {})
        log(f"[17] FeatureTracker {HOST_FEATURE_DIM}-d n={n}: "
            f"{np.median(times):.3f} ms per call (median of {len(times)} "
            f"after {HOST_WARMUP}); every object kept its id; host only")


def phase_native_assignment(args, dev, dets):
    """The general SORT step with assignment='native' (the C++ solver)
    against 'hungarian' (scipy) on the main path's stream."""
    frames = sorted(dets)[:args.step_frames]
    sub = {f: dets[f] for f in frames}
    outs = {}
    for assignment in ("native", "hungarian"):
        zero_counts()
        outs[assignment] = run_sequence_device(
            sub, engine="step", assignment=assignment, capacity=T,
            device=dev)
        expect_counts(f"step assignment={assignment}", read_counts(), {})
    (nat, nat_fps), (hun, hun_fps) = outs["native"], outs["hungarian"]
    for f in frames:
        check_same(f"native vs hungarian frame {f}: ids",
                   [r[0] for r in nat[f]], [r[0] for r in hun[f]])
    log(f"[17] general SORT step (engine='step'), main path's stream, "
        f"{len(frames)} frames x {D_VALID} objects: assignment='native' "
        f"ids equal to 'hungarian' every frame; {nat_fps:.1f} frames/s "
        f"native, {hun_fps:.1f} hungarian (CUDA events)")


def phase_kalman_api(dev):
    rng = np.random.default_rng(9)
    z = np.zeros((KF_STEPS, 5), np.float32)
    z[:, 0] = np.cumsum(rng.normal(size=KF_STEPS))
    z[:, 1] = np.cumsum(rng.normal(size=KF_STEPS))
    z[:, 3] = 2.0
    z[:, 4] = 5.0 + rng.uniform(0, 1, KF_STEPS)
    kf = Universal2DBoxKalmanFilter()
    got, ms = timed(dev, lambda: kf.filter_sequence(z))
    twin, twin_ms_ = timed(dev, lambda: box_sequence_numpy(z, kf._f.pw,
                                                           kf._f.vw))
    st = kf.initiate(Universal2DBox.from_vec5(z[0]))
    for i in range(1, 200):
        st = kf.update(kf.predict(st), Universal2DBox.from_vec5(z[i]))
    # the C++ loop may contract a multiply-add the NumPy loop rounds twice:
    # the JAX package holds its own native loop at 1e-5
    check_same("filter_sequence's NumPy twin row 199", twin[199],
               st._state.mean_pos)
    if not np.allclose(got, twin, rtol=1e-5, atol=1e-5):
        raise AssertionError("filter_sequence: the C++ loop and its NumPy "
                             "twin differ past 1e-5")
    pts = np.cumsum(rng.normal(size=(KF_STEPS // 10, 17, 2)), axis=0).astype(
        np.float32)
    vec, vms = timed(dev, lambda: Vec2DKalmanFilter().filter_sequence(pts))
    check_same("Vec2D chain 3", vec[:, 3],
               Point2DKalmanFilter().filter_sequence(pts[:, 3]))
    if not (np.isfinite(got).all() and np.isfinite(vec).all()):
        raise AssertionError("filter_sequence: non-finite output")
    log(f"[17] Kalman API filter_sequence (C++ kf_box_sequence): box track "
        f"of {KF_STEPS} steps {ms:.3f} ms ({ms * 1e3 / KF_STEPS:.4f} us per "
        f"step), its NumPy twin {twin_ms_:.3f} ms "
        f"({twin_ms_ * 1e3 / KF_STEPS:.3f} us per step), equal to the "
        f"per-call API at step 199, the two within 1e-5; Vec2D "
        f"{KF_STEPS // 10} steps x 17 keypoints {vms:.3f} ms, each chain "
        f"equal to the point filter's; host only")


def nearest_boxes(frames, n):
    """Each frame cut to the `n` boxes nearest its first one, in rank
    order: a crowd, so that some are suppressed."""
    out = []
    for fr in frames:
        d2 = ((fr[:, :2] - fr[0, :2]) ** 2).sum(1)
        out.append(fr[np.sort(np.argsort(d2, kind="stable")[:n])])
    return np.stack(out)


def phase_host_nms(args, dev):
    """`nms(device="cpu")`, the C++ loop, on phase 7's frames cut to
    HOST_MAX_BOXES boxes each: the kept boxes equal `nms_kernel`'s on the
    card."""
    frames = nearest_boxes(nms_stream(args.nms_frames), HOST_MAX_BOXES)
    scores = 1.0 - np.arange(HOST_MAX_BOXES) / NMS_N
    valid = torch.ones(HOST_MAX_BOXES, dtype=torch.bool, device=dev)
    host_ms, dev_ms, kept = [], [], 0
    for f, fr in enumerate(frames):
        dets = [(Universal2DBox(*map(float, r)), float(sc))
                for r, sc in zip(fr, scores)]
        got, h_ms, counts = counted(
            dev, lambda: nms(dets, NMS_THRESHOLD, device="cpu"))
        expect_counts(f"nms(device='cpu') frame {f}", counts, {})
        keep, d_ms, counts = counted(dev, lambda: nms_kernel(
            torch.as_tensor(fr, device=dev), valid, NMS_THRESHOLD).cpu())
        expect_counts(f"nms_kernel n={HOST_MAX_BOXES} frame {f}", counts, {})
        index = {id(bb): i for i, (bb, _) in enumerate(dets)}
        check_same(f"nms(device='cpu') frame {f}: kept boxes",
                   [index[id(b)] for b in got],
                   keep.nonzero().squeeze(1).numpy())
        kept += len(got)
        host_ms.append(h_ms)
        dev_ms.append(d_ms)
    if kept == frames.shape[0] * HOST_MAX_BOXES:
        raise AssertionError("nms(device='cpu'): no box was suppressed")
    log(f"[17] nms(device='cpu') (C++ nms_host), phase 7's {len(frames)} "
        f"frames cut to the {HOST_MAX_BOXES} oriented boxes nearest each "
        f"frame's first: kept boxes equal "
        f"to nms_kernel's on the card every frame ({kept / len(frames):.1f} "
        f"kept per frame); {np.median(host_ms):.3f} ms per call against "
        f"the kernel's {np.median(dev_ms):.3f} (medians, wall clock, the "
        f"kernel's copy back included); no kernel launched")


def phase_host_engines(args, dev, dets):
    """Phase 17: the host engines beside the device engines.  Returns the
    device Sort's clip launches."""
    model, blas, threads, cores = host_info()
    log(f"[17] host: {model}, {cores} cores; BLAS threads {blas}, torch "
        f"threads {threads}; card {gpu_line()}")
    t0 = time.perf_counter()
    _build.host_library()
    secs, _ = _build.host_build_info()
    log(f"[17] host library ({', '.join(_build.HOST_SOURCES)}) built in "
        f"{secs:.2f} s, loaded in {time.perf_counter() - t0:.2f} s; "
        f"{_build._cxx()} {' '.join(_build.HOST_FLAGS)}")
    launches = phase_host_sort(dev)
    phase_host_visual(dev)
    phase_host_batch(dev)
    phase_host_feature(dev)
    phase_native_assignment(args, dev, dets)
    phase_kalman_api(dev)
    phase_host_nms(args, dev)
    return launches


# ---------------------------------------------------------------------------
# phase 19: the MOT-file route
# ---------------------------------------------------------------------------

MOT_FILES = (("7 columns", dict(columns=7)), ("6 columns", dict(columns=6)),
             ("7 columns and a header line", dict(columns=7, header=True)))


def phase_mot_file(dets, sort_out, want_launches):
    """Phase 19: the main path's SORT sequence written as a MOT det csv
    three ways and run from the path (`run_sequence_device(path)`: the C++
    loader, then the fused kernel on the card): outputs equal to phase 4's
    in-memory run.  Returns the fused SORT launches."""
    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        for label, kw in MOT_FILES:
            path = Path(tmp) / f"det_{kw['columns']}_{len(kw)}.txt"
            if write_mot_det(path, dets, **kw) != dets:
                raise AssertionError(f"MOT file, {label}: the file does not "
                                     "hold the main path's detections")
            zero_counts()
            out, fps = run_sequence_device(path, capacity=T)
            counts = read_counts()
            expect_counts(f"MOT file, {label}", counts,
                          {"fused_sort": want_launches})
            launches += counts["fused_sort"]
            if out != sort_out:
                bad = [f for f in sort_out if out.get(f) != sort_out[f]][:5]
                raise AssertionError(f"MOT file, {label}: outputs differ "
                                     f"from the in-memory run at frames "
                                     f"{bad}")
            log(f"[19] run_sequence_device(path), {label}: {len(out)} frames "
                f"x {D_VALID} objects, ids and boxes equal to phase 4's "
                f"in-memory run; {fps:.1f} frames/s (CUDA events); "
                f"fused_sort_kernel launches {counts['fused_sort']}")
        loaded, c_ms = timed(torch.device("cpu"),
                             lambda: native.load_sequence_soa(path))
        plain, p_ms = timed(torch.device("cpu"),
                            lambda: native._load_sequence_soa_numpy(path))
        for a, b in zip(loaded, plain):
            check_same("load_sequence_soa against its NumPy version", a, b)
        rows = int(loaded[3].sum())
        log(f"[19] load_sequence_soa (C++) {c_ms:.2f} ms for {rows} rows "
            f"({path.stat().st_size} bytes), _load_sequence_soa_numpy "
            f"{p_ms:.2f} ms, equal buffers; host {cpu_model()}")
    return launches


# ---------------------------------------------------------------------------
# phase 18: the sharded scene paths on an NCCL mesh of this card
# ---------------------------------------------------------------------------

GALLERY_Q, GALLERY_K = 256, 16  # one query per scene; the top k kept
MERGE_BLOCKS = (2, 4, 8)  # the state split into this many shards' blocks
HANDOFF_M = 64  # entries of one migration or merge call
ORIENTED_SCENES, ORIENTED_SHARDED_FRAMES = 8, 16
CKPT_FRAMES = 64  # the checkpoint's stream; saved halfway
TIMED_CALLS = 5


def same_tensors(label, got, want):
    """Bit-equal tensors, pair by pair."""
    for i, (a, b) in enumerate(zip(got, want)):
        check_same(f"{label} [{i}]", bits(a.detach().cpu()).numpy(),
                   bits(b.detach().cpu()).numpy())


def phase_sharded_visual(args, dev, gmesh, visual_ref, visual_rate, card):
    """The sharded VisualSORT scan, bit-equal to phase 10's unsharded
    batched step; then the sharded step frame by frame under `StepTimer`,
    one frame of it under `trace()`.  Returns (the scan's final state,
    merge launches)."""
    s, n = BS, args.batch_frames
    cfg = bench_visual_config()
    boxes, feat = batch_stream(n, s, dev)
    ones = torch.ones((n, s, BD), dtype=torch.float32, device=dev)
    tru = ones > 0
    feats = feat[None].expand(n, *feat.shape)
    st0 = mesh.new_batched_visual_state(s, BT, 1, K, F, torch.bfloat16,
                                        device=dev)
    ep0 = torch.ones(s, dtype=torch.int32, device=dev)
    scan = mesh.sharded_visual_scan(cfg, gmesh)
    scan(mesh.shard_batched_state(st0, gmesh), boxes[:2], ones[:2], tru[:2],
         feats[:2], tru[:2], ones[:2], ones[:2], ep0)  # warm-up
    zero_counts()
    with DeviceTimer(dev) as timer:
        st, ids, new, ovf = scan(mesh.shard_batched_state(st0, gmesh), boxes,
                                 ones, tru, feats, tru, ones, ones, ep0)
    expect_counts("sharded VisualSORT scan", read_counts(),
                  {"lane_merge": 2 * n, "visual_votes": n, "auction": n})
    st_ref, out_ref = visual_ref
    same_tensors("sharded VisualSORT scan ids", [ids],
                 [torch.stack([o.track_id for o in out_ref])])
    want_new = sum(int(o.is_new.sum()) for o in out_ref)
    want_ovf = sum(int(o.overflow.sum()) for o in out_ref)
    if (int(new), int(ovf)) != (want_new, want_ovf):
        raise AssertionError(f"sharded VisualSORT scan: counts {int(new)}, "
                             f"{int(ovf)}; the step's {want_new}, {want_ovf}")
    # voting types and the feature arrays bit for bit, floats RTOL/ATOL
    err = compare_states("sharded VisualSORT scan", st, st_ref)
    log(f"[18] sharded_visual_scan, NCCL mesh of 1 rank, S={s} D={BD} "
        f"T={BT} K={K} F={F} bf16, {n} frames: ids, voting types, overflow "
        f"({int(ovf)}) and state bit-equal to phase 10's unsharded step "
        f"(other floats max_abs_err {err:.3e}); new tracks reduced "
        f"{int(new)} = is_new.sum(); {s * n / timer.seconds:.1f} "
        f"scene-frames/s ({timer.seconds * 1e3 / n:.3f} ms/frame, CUDA "
        f"events) against phase 10's in-place step {visual_rate:.1f}; merge "
        f"launches {2 * n}; {card}")

    step = mesh.sharded_visual_step(cfg, gmesh)
    timer = StepTimer()
    stp = mesh.shard_batched_state(st0, gmesh)
    zero_counts()
    with tempfile.TemporaryDirectory() as tdir:
        for i in range(n):
            frame = (boxes[i], ones[i], tru[i], feat, tru[i], ones[i],
                     ones[i], ep0 + i)
            if i == 1:
                with trace(tdir):
                    stp, out, _ = step(stp, *frame)
            else:
                with timer.step(scenes=s):
                    stp, out, new_i = step(stp, *frame)
                    int(new_i)  # the count's copy back ends the frame
            same_tensors(f"sharded VisualSORT step frame {i}",
                         [out.track_id, out.voting_type],
                         [out_ref[i].track_id, out_ref[i].voting_type])
        traces = list(Path(tdir).glob("trace_*.json"))
        text = traces[0].read_text() if len(traces) == 1 else ""
        if "lane_merge_kernel" not in text:
            raise AssertionError(f"trace(): {len(traces)} files, none "
                                 "naming lane_merge_kernel")
    expect_counts("sharded VisualSORT steps", read_counts(),
                  {"lane_merge": 2 * n, "visual_votes": n, "auction": n})
    rates = timer.summary()
    log(f"[18] sharded_visual_step frame by frame: ids and voting types "
        f"equal to phase 10's every frame; StepTimer {rates['scenes_per_sec']}"
        f" scenes/s, {rates['steps_per_sec']} steps/s over "
        f"{rates['total_steps']} steps (host clock, each step ending in the "
        f"new-track count's copy back); trace() of frame 1 wrote a Chrome "
        f"trace of {len(text) / 1e6:.2f} MB naming lane_merge_kernel; {card}")
    return st, 4 * n


def phase_sharded_sort(args, dev, gmesh, sort_ref, sort_rate, card):
    """The sharded SORT scan, equal to phase 12's; an oriented one on
    8 scenes of phase 6's stream, equal to the unsharded batched scan,
    which equals itself with the plain clip patched in.  Returns the
    sharded scan's clip launches."""
    s, n = BS, args.batch_frames
    cfg = SortConfig(method="iou", assignment="auction", max_idle_epochs=5,
                     oriented=False)
    boxes = box_stream(n, s * BD, np.random.default_rng(42))
    boxes = torch.as_tensor(boxes.reshape(n, s, BD, 5), device=dev)
    conf = torch.ones((n, s, BD), dtype=torch.float32, device=dev)
    ep0 = torch.ones(s, dtype=torch.int32, device=dev)
    scan = mesh.sharded_sort_scan(cfg, gmesh)
    scan(mesh.new_batched_state(s, BT, 1, device=dev), boxes[:2], conf[:2],
         conf[:2] > 0, ep0)
    zero_counts()
    with DeviceTimer(dev) as timer:
        st, ids, new, ovf = scan(mesh.new_batched_state(s, BT, 1, device=dev),
                                 boxes, conf, conf > 0, ep0)
    expect_counts("sharded SORT scan", read_counts(), {"auction": n})
    st_ref, ids_ref, ovf_ref = sort_ref
    same_tensors("sharded SORT scan ids", [ids], [ids_ref])
    if int(ovf) != int(ovf_ref.sum()):
        raise AssertionError("sharded SORT scan: overflow count differs")
    err = compare_sort_states("sharded SORT scan", st, st_ref)
    log(f"[18] sharded_sort_scan, S={s} x {BD} objects, T={BT}, aligned "
        f"IoU, {n} frames: ids and overflow equal to phase 12's scan, state "
        f"max_abs_err {err:.3e}; new tracks reduced {int(new)}; "
        f"{s * n / timer.seconds:.1f} scene-frames/s against phase 12's "
        f"{sort_rate:.1f} (CUDA events); {card}")

    total = args.oriented_frames
    src = oriented_stream(total, args.seed + 42)
    idx = (8 * np.arange(ORIENTED_SCENES)[None, :]
           + np.arange(ORIENTED_SHARDED_FRAMES)[:, None]) % total
    obox = torch.as_tensor(src[idx], device=dev)  # [N, 8, OD, 5]
    oconf = torch.ones(obox.shape[:3], dtype=torch.float32, device=dev)
    ocfg = SortConfig(method="iou", assignment="auction", max_idle_epochs=5,
                      oriented=True)
    oep = torch.ones(ORIENTED_SCENES, dtype=torch.int32, device=dev)
    zero_counts()
    with DeviceTimer(dev) as timer:
        ost, oids, onew, oovf = mesh.sharded_sort_scan(ocfg, gmesh)(
            mesh.new_batched_state(ORIENTED_SCENES, OT, 1, device=dev), obox,
            oconf, oconf > 0, oep)
    clip = read_counts()["clip_pairs"]
    expect_counts("oriented sharded SORT scan", read_counts(),
                  {"clip_pairs": ORIENTED_SHARDED_FRAMES,
                   "auction": ORIENTED_SHARDED_FRAMES})
    rst, (rids, rovf) = mesh.batched_sort_scan(ocfg)(
        mesh.new_batched_state(ORIENTED_SCENES, OT, 1, device=dev), obox,
        oconf, oconf > 0, oep)
    same_tensors("oriented sharded SORT scan ids", [oids], [rids])
    if int(oovf) != int(rovf.sum()):
        raise AssertionError("oriented sharded SORT scan: overflow count "
                             "differs")
    err = compare_sort_states("oriented sharded SORT scan", ost, rst)
    orig = cl.clip_pairs
    cl.clip_pairs = plain_clip_pairs
    try:
        pst, (pids, povf) = mesh.batched_sort_scan(ocfg)(
            mesh.new_batched_state(ORIENTED_SCENES, OT, 1, device=dev), obox,
            oconf, oconf > 0, oep)
    finally:
        cl.clip_pairs = orig
    same_tensors("oriented batched SORT scan, plain clip: ids", [pids],
                 [rids])
    if not torch.equal(povf, rovf):
        raise AssertionError("oriented batched SORT scan: the plain clip's "
                             "overflow differs")
    perr = compare_sort_states("oriented batched SORT scan, plain clip", pst,
                               rst)
    log(f"[18] oriented sharded_sort_scan, {ORIENTED_SCENES} scenes of phase "
        f"6's stream (frames offset by 8) x D={OD}, T={OT}, "
        f"{ORIENTED_SHARDED_FRAMES} frames: ids and overflow equal to the "
        f"unsharded batched scan, state max_abs_err {err:.3e}; the "
        f"batched scan with the plain clip patched in: ids and overflow "
        f"equal, state max_abs_err {perr:.3e}; "
        f"{ORIENTED_SCENES * ORIENTED_SHARDED_FRAMES / timer.seconds:.1f} "
        f"scene-frames/s (CUDA events); clip launches {clip}: the batched "
        f"step matches every scene on x-sorted views through one clip "
        f"launch a frame; {card}")
    return clip


def phase_sharded_gallery(dev, gmesh, state, card):
    """`global_gallery_query` on phase 10's stream's state: equal to a
    plain stable sort of the whole score matrix, and the merge of 2, 4 and
    8 blocks' local answers equal to the one-shard answer."""
    s, t, g, f = state.feats.shape
    _, feat = batch_stream(1, s, dev)
    q = feat[:, 0].contiguous()  # each scene's first detection's feature
    valid = (state.feat_valid & state.active[:, :, None]).reshape(-1)
    for kind in pgallery.KINDS:
        query = pgallery.global_gallery_query(kind, GALLERY_K, gmesh)
        zero_counts()
        got = query(state, q)
        expect_counts(f"gallery query {kind}", read_counts(), {})
        scores = pgallery._score_rows(state.feats.reshape(-1, f), q, kind)
        scores = torch.where(valid[None], scores, -torch.inf)
        negzero = int(((scores == 0) & torch.signbit(scores)).sum())
        if negzero:  # the plain sort orders -0.0 as 0.0, top_k below it
            raise AssertionError(f"gallery {kind}: {negzero} scores -0.0")
        ref = torch.sort(scores, dim=1, descending=True, stable=True)
        top, idx = ref.values[:, :GALLERY_K], ref.indices[:, :GALLERY_K]
        scene = idx // (t * g)
        same_tensors(f"gallery {kind} vs the stable sort", got, [
            top, torch.zeros_like(scene), scene,
            state.track_id[scene, (idx // g) % t]])
        # the blocked product against one product of the whole gallery
        qf, gf = q.float(), state.feats.reshape(-1, f).float()
        if kind == "cosine":
            qf = qf / qf.norm(dim=-1, keepdim=True).clamp(min=1e-9)
            gf = gf / gf.norm(dim=-1, keepdim=True).clamp(min=1e-9)
            plain = gd.f32_dots(qf, gf)
            scale = 1.0
        else:
            plain = -((qf * qf).sum(-1)[:, None] + (gf * gf).sum(-1)[None]
                      - 2.0 * gd.f32_dots(qf, gf))
            scale = float(plain.abs().max())
        perr = float((torch.where(valid[None], plain, 0.0)
                      - torch.where(valid[None], scores, 0.0)).abs().max())
        if perr > 1e-5 * scale:
            raise AssertionError(f"gallery {kind}: blocked product off the "
                                 f"whole product by {perr}")
        local = pgallery.local_gallery_query(kind, GALLERY_K, gmesh)
        for blocks in MERGE_BLOCKS:
            n = s // blocks
            parts = [local(map_tensors(lambda a: a[b * n:(b + 1) * n], state),
                           q) for b in range(blocks)]
            sc, se, tr = (torch.stack(x) for x in zip(*parts))
            sh = torch.arange(blocks, dtype=torch.int32, device=dev)[
                :, None, None].expand(se.shape)
            m = pgallery.merge_shard_topk(sc, sh, se, tr)
            same_tensors(f"gallery {kind} merge of {blocks} blocks",
                         [m[0], m[1] * n + m[2], m[3]],
                         [got[0], got[2], got[3]])
        q_ms = time_ms(dev, lambda: query(state, q), TIMED_CALLS)
        rows = pgallery.GALLERY_ROWS
        blocks = [torch.nn.functional.pad(
            gf[lo:lo + rows], (0, 0, 0, max(0, lo + rows - gf.shape[0])))
            for lo in range(0, gf.shape[0], rows)]
        p_ms = time_ms(dev, lambda: [gd.f32_dots(qf, b) for b in blocks],
                       TIMED_CALLS)
        hits = float((got[3][:, 0] > 0).float().mean())
        log(f"[18] global_gallery_query {kind}, Q={q.shape[0]} x "
            f"{s * t * g} gallery lanes (F={f} bf16), k={GALLERY_K}: equal "
            f"to a stable full sort of the score matrix (blocked product "
            f"within {perr:.2e} of one whole product); merge_shard_topk of "
            f"{', '.join(map(str, MERGE_BLOCKS))} blocks equal to the "
            f"one-shard answer; {q_ms:.3f} ms per query batch, the f32 "
            f"products {p_ms:.3f} ms of it ({p_ms / q_ms:.3f}; CUDA events, "
            f"mean of {TIMED_CALLS}); top-1 a live track for {hits:.3f} of "
            f"queries; {card}")


def handoff_entries(state, rng):
    """(migration, merge) entries [M] of live tracks between scenes of the
    one shard: the last 4 migrations ask for missing ids, and the last 4
    merges repeat the first 4's destinations (all 8 fail)."""
    s = state.active.shape[0]
    act = state.active.cpu().numpy()
    ids = state.track_id.cpu().numpy()

    def live(scene):
        return int(rng.choice(ids[scene][act[scene]]))

    src = rng.choice(s, HANDOFF_M, replace=False)
    dst = (src + 1 + rng.integers(0, s - 1, HANDOFF_M)) % s
    src_id = [live(sc) for sc in src]
    src_id[-4:] = [10 ** 6] * 4
    mig = (src, src_id, dst, np.full(HANDOFF_M, 1000))
    order = rng.permutation(s)
    msrc, mdst = order[:HANDOFF_M], order[HANDOFF_M:2 * HANDOFF_M].copy()
    mdst_id = [live(sc) for sc in mdst]
    mdst[-4:], mdst_id[-4:] = mdst[:4], mdst_id[:4]
    mer = (msrc, [live(sc) for sc in msrc], mdst, mdst_id)
    return [[torch.tensor(np.asarray(x), dtype=torch.int32) for x in e]
            for e in (mig, mer)]


def phase_sharded_handoff(dev, gmesh, state, card):
    """`track_migration` and `track_merge`, M=64 entries between scenes of
    the one shard: bit-equal to the same calls on the CPU through a gloo
    group of the same rank."""
    cpu_mesh = mesh.scene_mesh(1, device="cpu")
    entries = handoff_entries(state, np.random.default_rng(18))
    host = map_tensors(lambda a: a.cpu(), state)
    for name, op, ent, landed in (
            ("track_migration", phandoff.track_migration, entries[0],
             HANDOFF_M - 4),
            ("track_merge", phandoff.track_merge, entries[1],
             HANDOFF_M - 8)):
        card_op, cpu_op = op(gmesh), op(cpu_mesh)
        on_card = [e.to(dev) for e in ent]
        zero_counts()
        got_state, *got = card_op(map_tensors(torch.clone, state), *on_card)
        expect_counts(name, read_counts(), {})
        if int(got[0].sum()) != landed:
            raise AssertionError(f"{name}: {int(got[0].sum())} entries "
                                 f"succeeded, expected {landed}")
        want_state, *want = cpu_op(map_tensors(torch.clone, host), *ent)
        same_tensors(f"{name} outputs", got, want)
        for fld in dataclasses.fields(got_state):
            a, b = getattr(got_state, fld.name), getattr(want_state, fld.name)
            pairs = ([(getattr(a, k.name), getattr(b, k.name))
                      for k in dataclasses.fields(a)] if fld.name == "kf"
                     else [(a, b)])
            same_tensors(f"{name} state.{fld.name}", *zip(*pairs))
        ms = []
        for _ in range(TIMED_CALLS):
            st = map_tensors(torch.clone, state)
            with DeviceTimer(dev) as timer:
                card_op(st, *on_card)
            ms.append(timer.seconds * 1e3)
        log(f"[18] {name}, M={HANDOFF_M} entries on S={state.active.shape[0]}"
            f" scenes (phase 10's stream's state): {int(got[0].sum())} "
            f"succeed; outputs and every state leaf bit-equal to the port's "
            f"CPU run on a gloo group of the same rank; "
            f"{float(np.median(ms)):.3f} ms per call (CUDA events, median of "
            f"{TIMED_CALLS}, state copies outside); {card}")


def phase_checkpoint(args, dev, dets, feats, card):
    """A bf16 VisualSort on phase 4's stream saved halfway, loaded into a
    fresh tracker: the rest of the stream gives the uninterrupted
    tracker's ids."""
    from similari_tpu_torch.eval.mot import ltwh_to_vec5

    frames = sorted(dets)[:min(CKPT_FRAMES, args.main_frames)]
    rows = [np.asarray(dets[f], np.float32) for f in frames]
    arrays = [(ltwh_to_vec5(r), np.clip(r[:, 4], 0.0, 1.0),
               np.asarray(feats[f], np.float32)) for r, f in zip(rows, frames)]
    opts = visual_api_options(
        visual_metric=VisualSortMetricType.cosine(0.5),
        positional_metric=PositionalMetricType.iou(0.3),
        visual_minimal_track_length=1, max_idle_epochs=10,
        kept_history_length=1, visual_max_observations=K)

    def make():
        return VisualSort(1, opts, initial_capacity=128,
                          assignment_backend="auction", device=dev)

    half = len(arrays) // 2
    run = make()
    for a in arrays[:half]:
        run.predict_arrays(0, *a)
    with tempfile.TemporaryDirectory() as tdir:
        path = Path(tdir) / "visual_sort.npz"
        t0 = time.perf_counter()
        save_tracker(run, path)
        t_save = time.perf_counter() - t0
        size = path.stat().st_size
        resumed = make()
        t0 = time.perf_counter()
        load_tracker(resumed, path)
        t_load = time.perf_counter() - t0
    st = resumed._scenes[0].state
    if st.feats.dtype != torch.bfloat16 or st.feats.device.type != dev.type:
        raise AssertionError("checkpoint: the gallery did not come back as "
                             "bf16 on the card")
    for i, a in enumerate(arrays[half:], half):
        check_same(f"checkpoint frame {i}: ids", resumed.predict_arrays(
            0, *a)[1], run.predict_arrays(0, *a)[1])
    log(f"[18] checkpoint: bf16 VisualSort on phase 4's stream saved after "
        f"{half} frames (capacity {st.capacity}, {size / 1e6:.2f} MB npz) "
        f"in {t_save:.3f} s, loaded into a fresh tracker in {t_load:.3f} s; "
        f"the next {len(arrays) - half} frames' ids equal the uninterrupted "
        f"tracker's (host clock); {card}")


def dryrun_rank(rank, world, port):
    """One NCCL rank of the multi-card dry run (a spawned process)."""
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://localhost:{port}", world_size=world,
        rank=rank)
    torch.cuda.set_device(rank)
    try:
        dryrun_multichip(world)
    finally:
        torch.distributed.destroy_process_group()


def phase_multi_card(card):
    n = torch.cuda.device_count()
    dryrun_multichip(1)  # on this process's NCCL world of one rank
    if n < 2:
        log(f"[18] dryrun_multichip(1) passed on the NCCL world of one rank;"
            f" multi-rank NCCL is unverified on this machine ({n} card); "
            f"{card}")
        return
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=dryrun_rank, args=(r, n, port))
             for r in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise AssertionError(f"dryrun_multichip({n}) ranks exited {codes}")
    log(f"[18] dryrun_multichip({n}) passed in {n} NCCL ranks, one per card;"
        f" {card}")


def phase_sharded(args, dev, visual_ref, visual_rate, sort_ref, sort_rate,
                  dets, feats):
    """Phase 18; returns (merge launches, clip launches)."""
    card = gpu_line()
    gmesh = mesh.scene_mesh(1)
    if gmesh.backend != "nccl":
        raise AssertionError(f"phase 18's mesh runs {gmesh.backend}")
    state, merge = phase_sharded_visual(args, dev, gmesh, visual_ref,
                                        visual_rate, card)
    clip = phase_sharded_sort(args, dev, gmesh, sort_ref, sort_rate, card)
    phase_sharded_gallery(dev, gmesh, state, card)
    phase_sharded_handoff(dev, gmesh, state, card)
    phase_checkpoint(args, dev, dets, feats, card)
    phase_multi_card(card)
    torch.distributed.destroy_process_group()
    return merge, clip


# ---------------------------------------------------------------------------
# phases 20-22: zero-height streams, the generic store, the eval kit
# ---------------------------------------------------------------------------

ZH_SHARE = 0.05  # share of valid detections given height 0 in phase 20
ZH_N, ZH_FRAMES, ZH_F = 100, 48, 128  # the API trackers' stream
ZH_RUNNER = dict(n_objects=40, n_frames=128, seed=5, feature_dim=128)
STORE_BENCH = (100, 256, 50)  # objects, feature dim, epochs (the bench shape)
STORE_TRACKS, STORE_OBS, STORE_F = 20_000, 3, 512  # the gallery-scale store
STORE_QUERIES = 64  # candidates of STORE_OBS observations each
STORE_RTOL, STORE_ATOL = 1e-5, 1e-4  # card's distances against the CPU's
KIT_SEQS = (dict(n_objects=40, n_frames=300, seed=1, p_miss=0.05,
                 fp_per_frame=0.3),
            dict(n_objects=40, n_frames=300, seed=2, p_miss=0.05,
                 fp_per_frame=0.3, feature_dim=128))
# (label, tracker type, params, held to the accuracy bars): Mahalanobis
# SORT is not; on these 40-object, 300-frame sequences its IDF1 falls
# below 0.8 in the JAX package's kit too (the same scores as the port's on
# the CPU, tests/test_torch_motchallenge.py holds the two kits equal), so
# it is held to the CPU run alone
KIT_TRACKERS = (("sort_iou", "sort", dict(method="iou"), True),
                ("sort_maha", "sort", dict(method="maha"), False),
                ("visual_sort", "visual_sort", dict(method="iou"), True))
VISUAL_LAUNCHES = ("fused_visual", "gallery_dots")
MOTA_BAR, IDF1_BAR = 0.85, 0.8  # tests/test_eval.py's accuracy bars
KIT_CPU_TOL = 0.005  # MOTA / IDF1 of the card's kit against the CPU's


def expect_launched(label, counts, names):
    """Each counter in `names` launched, every other one not."""
    if any(counts[k] <= 0 for k in names) or any(
            v for k, v in counts.items() if k not in names):
        raise AssertionError(f"{label}: launches {counts}, expected "
                             f"{sorted(names)} only")
    for k in HELD:
        HELD[k] += counts[k]


@contextlib.contextmanager
def plain_chunks():
    """The fused runners through the plain versions of both fused chunks
    (on the card: PyTorch ops, no custom kernel)."""
    kept = fs.fused_sort_chunk, fv.fused_visual_chunk
    fs.fused_sort_chunk = fs.fused_sort_chunk_plain
    fv.fused_visual_chunk = fv.fused_visual_chunk_plain
    try:
        yield
    finally:
        fs.fused_sort_chunk, fv.fused_visual_chunk = kept


def same_outputs(label, got, want):
    """Runner outputs: equal frames and ids, boxes within RTOL/ATOL (NaN
    where the other has NaN)."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: frames differ")
    for f in want:
        if [r[0] for r in got[f]] != [r[0] for r in want[f]]:
            raise AssertionError(f"{label}: ids differ at frame {f}")
        a = np.array([r[1:] for r in got[f]], np.float64)
        b = np.array([r[1:] for r in want[f]], np.float64)
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True,
                                   err_msg=f"{label}: boxes at frame {f}")


def zero_heights(dets, seed):
    """A MOT detections dict with ZH_SHARE of its rows at height 0."""
    rng = np.random.default_rng(seed)
    return {f: [r[:3] + (0.0,) + r[4:] if rng.random() < ZH_SHARE else r
                for r in rows] for f, rows in dets.items()}


def zero_height_frames(seed):
    """churn_stream frames (ZH_N objects) with ZH_SHARE of the heights 0,
    plus ZH_F-d identity features."""
    rng = np.random.default_rng(seed)
    ident = rng.normal(size=(ZH_N, ZH_F)).astype(np.float32)
    out = []
    for boxes, conf in churn_stream(seed, ZH_FRAMES, ZH_N, spread=1000.0,
                                    churn=8):
        boxes = boxes.copy()
        boxes[rng.random(ZH_N) < ZH_SHARE, 4] = 0.0
        out.append((boxes, conf, (ident + 0.05 * rng.normal(
            size=ident.shape)).astype(np.float32)))
    return out


def zero_height_api(dev, frames):
    """Phase 20's trackers: Mahalanobis `Sort`, `BatchSort` (two scenes)
    and `VisualSort`, the auction on `dev` against "native" on the CPU;
    ids per call equal."""
    maha = PositionalMetricType.maha()

    def sort(d, backend):
        return Sort(shards=1, bbox_history=2, max_idle_epochs=3, method=maha,
                    initial_capacity=128, assignment_backend=backend,
                    device=d)

    def batch(d, backend):
        return BatchSort(bbox_history=2, max_idle_epochs=3, method=maha,
                         initial_capacity=128, assignment_backend=backend,
                         device=d)

    def visual(d, backend):
        opts = (VisualSortOptions()
                .visual_metric(VisualSortMetricType.euclidean(5.0))
                .positional_metric(maha).visual_minimal_track_length(2)
                .visual_max_observations(3).max_idle_epochs(3)
                .kept_history_length(2))
        return VisualSort(1, opts, initial_capacity=128,
                          assignment_backend=backend, device=d)

    def run_sort(tr):
        return [tr.predict_arrays(0, b, c)[1].tolist() for b, c, _ in frames]

    def run_batch(tr):
        out = []
        for b, c, _ in frames:
            req = SortPredictionBatchRequest()
            for sid, shift in ((1, 0.0), (2, 5000.0)):
                for i in range(len(b)):
                    req.add(sid, Universal2DBox.new_with_confidence(
                        float(b[i, 0]) + shift, float(b[i, 1]), None,
                        float(b[i, 3]), float(b[i, 4]), float(c[i])), None)
            res, got = tr.predict(req), {}
            while res.ready():
                sid, tracks = res.get()
                got[sid] = [t.id for t in tracks]
            out.append(got)
        return out

    def run_visual(tr):
        fv_ok = np.arange(ZH_N) % 3 != 0
        return [tr.predict_arrays(0, b, c, f, fv_ok)[1].tolist()
                for b, c, f in frames]

    cpu = torch.device("cpu")
    for name, make, run in (("Sort", sort, run_sort),
                            ("BatchSort", batch, run_batch),
                            ("VisualSort", visual, run_visual)):
        zero_counts()
        got, ms = timed(dev, lambda: run(make(dev, "auction")))
        counts = read_counts()
        expect_counts(f"zero heights, {name}", counts,
                      {"visual_votes": len(frames), "auction": len(frames)}
                      if name == "VisualSort" else {"auction": len(frames)})
        want, cpu_ms = timed(cpu, lambda: run(make(cpu, "native")))
        if got != want:
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            raise AssertionError(f"zero heights, {name}: ids differ from the "
                                 f"CPU 'native' run at calls {bad[:5]}")
        log(f"[20] {name} (Mahalanobis, assignment 'auction') on {dev}: "
            f"{len(frames)} calls x {ZH_N} detections, ids equal to "
            f"device='cpu' 'native'; {ms / len(frames):.2f} ms per call "
            f"(CPU {cpu_ms / len(frames):.2f})")


def phase_zero_height(dev):
    """Phase 20: valid zero-height detections on the card.  Returns the
    launches of {fused_sort, fused_visual, gallery_dots}."""
    frames = zero_height_frames(20)
    zeros = sum(int((b[:, 4] == 0).sum()) for b, _, _ in frames)
    log(f"[20] zero-height stream: {zeros} of {ZH_N * len(frames)} valid "
        f"detections at height 0")
    zero_height_api(dev, frames)
    _, dets, feats = generate_sequence(**ZH_RUNNER)
    dets = zero_heights(dets, 21)
    cpu = torch.device("cpu")
    got, _ = run_sequence_device(dets, method="maha", engine="step",
                                 assignment="auction", capacity=T,
                                 device=dev)
    want, _ = run_sequence_device(dets, method="maha", engine="step",
                                  assignment="native", capacity=T,
                                  device="cpu")
    same_outputs("zero heights, run_sequence_device(step, maha) against "
                 "the CPU 'native' run", got, want)
    log(f"[20] run_sequence_device(engine='step', method='maha', auction): "
        f"{len(got)} frames, ids equal to device='cpu' 'native'")
    launches = {"fused_sort": 0, "fused_visual": 0, "gallery_dots": 0}
    runs = (("run_sequence_device", ("fused_sort",),
             lambda: run_sequence_device(dets, capacity=T,
                                         report_observed=True, device=dev)),
            ("run_sequence_device_visual[iou]", VISUAL_LAUNCHES,
             lambda: run_sequence_device_visual(dets, feats, capacity=T,
                                                device=dev)),
            ("run_sequence_device_visual[maha]", VISUAL_LAUNCHES,
             lambda: run_sequence_device_visual(dets, feats, capacity=T,
                                                positional_kind="maha",
                                                device=dev)))
    for label, names, run in runs:
        zero_counts()
        kern, _ = run()
        counts = read_counts()
        with plain_chunks():
            plain, _ = run()
        same_outputs(f"zero heights, {label}: kernel against plain", kern,
                     plain)
        expect_launched(f"zero heights, {label}", counts, names)
        for k in launches:
            launches[k] += counts[k]
        log(f"[20] {label} (fused): {len(kern)} frames, kernel outputs "
            f"equal to the plain versions on {dev}; launches {counts}")
    return launches


def bench_metric(kind="euclidean"):
    """The feature-tracker bench's metric on the store's sweep: euclidean,
    the newest 3 observations kept."""
    class BenchMetric(BatchedSimpleMetric):
        supports_batch_features = kind

        def optimize(self, feature_class, merge_history, attrs, observations,
                     prev_length, is_merge):
            del observations[:-3]

    return BenchMetric()


def store_bench_epochs(dev, stream):
    """The reference's feature-tracker bench on a `TrackStore` of `dev`:
    per epoch one candidate per object, TopNVoting(1, 100, 1), merge the
    winners and add the rest.  Returns (winners per epoch, wall ms per
    epoch)."""
    store = (TrackStoreBuilder(1, device=dev).default_attributes(
        UnboundAttrs()).metric(bench_metric()).build())
    voting = TopNVoting(1, 100.0, 1)
    winners = []
    t0 = time.perf_counter()
    for e, feats in enumerate(stream):
        cands = [store.new_track(1_000_000 * (e + 1) + i).observation(
            ObservationBuilder(0).observation(f).build()).build()
            for i, f in enumerate(feats)]
        dists, errs = store.foreign_track_distances(cands, 0, False)
        if errs:
            raise AssertionError(f"store bench: errors {errs[:3]}")
        win = voting.winners(dists)
        winners.append({k: v[0].winner_track for k, v in win.items()})
        for c in cands:
            if c.track_id in win:
                store.merge_external(win[c.track_id][0].winner_track, c, None,
                                     True)
            else:
                store.add_track(c)
    if store.bulk_fallbacks:
        raise AssertionError(f"store bench left the bulk path "
                             f"{store.bulk_fallbacks} times")
    return winners, (time.perf_counter() - t0) * 1e3 / len(stream), len(store)


def store_query_ms(dev, store, cands):
    """(outputs of foreign_track_distances_arrays per candidate, ms per
    query: CUDA events on the card, the host clock on the CPU)."""
    store.foreign_track_distances_arrays(cands[0], 0)  # builds the index
    with DeviceTimer(dev) as timer:
        outs = [store.foreign_track_distances_arrays(c, 0) for c in cands]
    return outs, timer.seconds * 1e3 / len(cands)


def phase_store(dev):
    """Phase 21: the generic `TrackStore` with its feature index on the
    card, at the feature-tracker bench's shape and at gallery scale, each
    against a device="cpu" store."""
    card = gpu_line()
    n, f, epochs = STORE_BENCH
    rng = np.random.default_rng(21)
    base = np.zeros((n, f), np.float32)
    base[:, 0] = 1000.0 * np.arange(n)
    stream = []
    for _ in range(epochs):
        base = base + rng.uniform(-0.1, 0.1, (n, f)).astype(np.float32)
        stream.append(base.copy())
    win_dev, ms_dev, tracks = store_bench_epochs(dev, stream)
    win_cpu, ms_cpu, _ = store_bench_epochs(torch.device("cpu"), stream)
    if win_dev != win_cpu:
        bad = [e for e, (a, b) in enumerate(zip(win_dev, win_cpu)) if a != b]
        raise AssertionError(f"store bench: winners differ from the CPU "
                             f"store at epochs {bad[:5]}")
    if tracks != n:
        raise AssertionError(f"store bench: {tracks} tracks for {n} objects")
    log(f"[21] TrackStore bench shape ({n} objects x {f}-d, history 3, "
        f"{epochs} epochs of TopNVoting(1, 100, 1)): winners equal to the "
        f"CPU store every epoch, {tracks} tracks; {ms_dev:.2f} ms per epoch "
        f"on {dev}, {ms_cpu:.2f} on the CPU store (wall clock; {card})")

    t0 = time.perf_counter()
    rng = np.random.default_rng(22)
    feats = rng.normal(size=(STORE_TRACKS, STORE_OBS, STORE_F)).astype(
        np.float32)
    store = (TrackStoreBuilder(1, device=dev).default_attributes(
        UnboundAttrs()).metric(bench_metric()).build())
    for tid in range(STORE_TRACKS):
        for k in range(STORE_OBS):
            store.add(tid, 0, None, feats[tid, k])
    cpu_store = (TrackStoreBuilder(1, device="cpu").default_attributes(
        UnboundAttrs()).metric(bench_metric()).build())
    cpu_store.tracks = store.tracks  # the same Track objects
    cand_feats = rng.normal(size=(STORE_QUERIES, STORE_OBS, STORE_F)).astype(
        np.float32)
    cands = []
    for i in range(STORE_QUERIES):
        b = store.new_track(10_000_000 + i)
        for k in range(STORE_OBS):
            b = b.observation(ObservationBuilder(0).observation(
                cand_feats[i, k]).build())
        cands.append(b.build())
    build_s = time.perf_counter() - t0
    out_dev, q_dev = store_query_ms(dev, store, cands)
    out_cpu, q_cpu = store_query_ms(torch.device("cpu"), cpu_store, cands)
    err = 0.0
    for (ti, oi, d), (tc, oc, dc) in zip(out_dev, out_cpu):
        check_same("store query to_id", ti, tc)
        check_same("store query obs_ix", oi, oc)
        if d.shape != (STORE_OBS, STORE_TRACKS * STORE_OBS) or \
                d.dtype != np.float32 or not np.isfinite(d).all():
            raise AssertionError(f"store query: dist {d.shape} {d.dtype}")
        err = max(err, float(np.abs(d - dc).max()))
        bound = STORE_ATOL + STORE_RTOL * float(np.abs(dc).max())
        if np.abs(d - dc).max() > bound:
            raise AssertionError(f"store query: distances differ from the "
                                 f"CPU store by {err} > {bound}")
    index = store._feature_index(0)
    q = torch.from_numpy(cand_feats[0]).to(dev)
    for _ in range(3):
        core_store._distances(q, index.rows, index.prep, "euclidean")
    with DeviceTimer(dev) as timer:
        for _ in range(STORE_QUERIES):
            core_store._distances(q, index.rows, index.prep, "euclidean")
    prod_ms = timer.seconds * 1e3 / STORE_QUERIES
    rows = STORE_TRACKS * STORE_OBS
    bound_ms = max(4.0 * (rows * STORE_F + rows + STORE_OBS * rows)
                   / HBM_BYTES_PER_S,
                   2.0 * STORE_OBS * rows * STORE_F / F32_OPS_PER_S) * 1e3
    log(f"[21] TrackStore gallery scale: {STORE_TRACKS} tracks x "
        f"{STORE_OBS} observations x {STORE_F}-d f32 ({rows} rows, "
        f"{index.rows.numel() * 4 / 1e6:.1f} MB on {index.rows.device}; "
        f"built in {build_s:.1f} s): foreign_track_distances_arrays for "
        f"{STORE_QUERIES} candidates of {STORE_OBS} observations, to_id and "
        f"obs_ix equal to the CPU store's, largest distance difference "
        f"{err:.3g} (bound {STORE_ATOL} + {STORE_RTOL} x max distance)")
    log(f"[21] TrackStore query: {q_dev:.4f} ms per query on {dev} (CUDA "
        f"events around the call: the product, the [{STORE_OBS}, {rows}] "
        f"copy to the host and the per-track compatible() loop), "
        f"{q_cpu:.4f} ms on the CPU store; the product alone "
        f"{prod_ms:.4f} ms per query (CUDA events), bound {bound_ms:.4f} ms "
        f"(bytes); {card}")



def write_mot_sequence(root, name, gt, dets):
    seq = Path(root) / name
    (seq / "det").mkdir(parents=True)
    (seq / "gt").mkdir(parents=True)
    write_csv(seq / "det" / "det.txt", [
        (f, -1, round(l, 2), round(t, 2), round(w, 2), round(h, 2),
         round(c, 3), -1, -1, -1)
        for f in sorted(dets) for l, t, w, h, c in dets[f]])
    write_csv(seq / "gt" / "gt.txt", [
        (f, tid, round(l, 2), round(t, 2), round(w, 2), round(h, 2), 1, 1,
         1.0) for f in sorted(gt) for tid, l, t, w, h in gt[f]])


def kit_run(data, out, kind, params, platform):
    """(metrics per sequence, fps per sequence, ids per frame per
    sequence) of the kit on `platform`."""
    cfg = KitConfig(name=kind, data_path=str(data), output_path=str(out),
                    platform=platform,
                    tracker=TrackerConfig(kind, dict(params)))
    results = run_config(cfg)
    stats = (Path(out) / "processing_stats.csv").read_text().splitlines()[1:]
    fps = {row.split(",")[0]: float(row.split(",")[3]) for row in stats}
    ids = {}
    for seq in results:
        per_frame = {}
        for line in (Path(out) / f"{seq}.txt").read_text().splitlines():
            cols = line.split(",")
            per_frame.setdefault(int(cols[0]), []).append(int(cols[1]))
        ids[seq] = per_frame
    return results, fps, ids


def check_bars(label, m):
    if not (m["MOTA"] > MOTA_BAR and m["IDF1"] > IDF1_BAR):
        raise AssertionError(f"{label}: MOTA {m['MOTA']:.4f} IDF1 "
                             f"{m['IDF1']:.4f} below {MOTA_BAR} / {IDF1_BAR}")


def phase_kit(dev):
    """Phase 22: the eval path and the MOTChallenge kit on the card.
    Returns the launches of {fused_sort, fused_visual, gallery_dots}."""
    card = gpu_line()
    seqs = []
    for kw in KIT_SEQS:
        gt, dets, *feats = generate_sequence(**kw)
        seqs.append((gt, dets, feats[0] if feats else None))
    launches = {"fused_sort": 0, "fused_visual": 0, "gallery_dots": 0}
    gt2, dets2, feats2 = seqs[1]
    runs = [(f"run_sequence_device[seed {kw['seed']}]", gt, ("fused_sort",),
             lambda d=dets: run_sequence_device(d, report_observed=True,
                                                device=dev))
            for kw, (gt, dets, _) in zip(KIT_SEQS, seqs)]
    runs.append(("run_sequence_device_visual[seed 2]", gt2, VISUAL_LAUNCHES,
                 lambda: run_sequence_device_visual(dets2, feats2,
                                                    device=dev)))
    for label, gt, names, run in runs:
        zero_counts()
        kern, fps = run()
        counts = read_counts()
        with plain_chunks():
            plain, _ = run()
        same_outputs(f"{label}: kernel against plain", kern, plain)
        expect_launched(label, counts, names)
        for k in launches:
            launches[k] += counts[k]
        m = clear_metrics(gt, kern)
        m.update(identity_metrics(gt, kern))
        check_bars(label, m)
        log(f"[22] {label} (fused) on {dev}: MOTA {m['MOTA']:.4f} IDF1 "
            f"{m['IDF1']:.4f}, outputs equal to the plain versions on the "
            f"card; {fps:.1f} frames/s (CUDA events); launches {counts}")
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "data"
        for k, (gt, dets, _) in enumerate(seqs):
            write_mot_sequence(data, f"SYN-{k + 1:02d}", gt, dets)
        for label, kind, params, bars in KIT_TRACKERS:
            zero_counts()
            res, fps, ids = kit_run(data, Path(tmp) / f"{label}-cuda", kind,
                                    params, dev.type)
            # a general step a frame with detections, each on the card
            steps = sum(sum(1 for rows in dets.values() if len(rows))
                        for _, dets, _ in seqs)
            expect_counts(f"kit {label}", read_counts(),
                          {"visual_votes": steps, "auction": steps}
                          if kind == "visual_sort" else {"auction": steps})
            res_c, fps_c, ids_c = kit_run(data, Path(tmp) / f"{label}-cpu",
                                          kind, params, "cpu")
            for seq, m in res.items():
                if bars:
                    check_bars(f"kit {label} {seq}", m)
                mc = res_c[seq]
                for key in ("MOTA", "IDF1"):
                    if abs(m[key] - mc[key]) > KIT_CPU_TOL:
                        raise AssertionError(
                            f"kit {label} {seq}: {key} {m[key]:.4f} against "
                            f"{mc[key]:.4f} on the CPU")
                differ = sum(ids[seq].get(f) != ids_c[seq].get(f)
                             for f in set(ids[seq]) | set(ids_c[seq]))
                log(f"[22] kit {label} {seq} on {dev}: MOTA {m['MOTA']:.4f} "
                    f"IDF1 {m['IDF1']:.4f} (CPU {mc['MOTA']:.4f} / "
                    f"{mc['IDF1']:.4f}), frames whose ids differ from the "
                    f"CPU run {differ} of {len(ids[seq])}; {fps[seq]:.2f} "
                    f"fps (CPU {fps_c[seq]:.2f}; wall clock, {card})")
    return launches


# ---------------------------------------------------------------------------
# phase 23: the forms ported last (the radius-pruned top-k rotated IoU, the
# scene-chunked batched steps, the tensor Sutherland-Hodgman clip); none of
# them launches a custom kernel
# ---------------------------------------------------------------------------

TOPK_K = 16  # oriented_neighbors of the SORT run, neighbors of NMS
TOPK_FRAMES = 64  # oriented sort_scan frames, each form
TOPK_CPU_FRAMES = 8  # of them rerun on the CPU
TOPK_NMS_FRAMES = 16
CHUNKS = (64, 256)  # scene chunks of the chunked batched steps
CHUNK_FRAMES = 16
SH_PAIRS = 65536  # quad pairs of the Sutherland-Hodgman clip


def max_partners(a, b):
    """The most not-too-far partners of a row of a[D, 5] x b[T, 5]."""
    return int((~geo.too_far(a[:, None], b[None])).sum(1).max())


def run_timed(dev, fn):
    """(fn's result, its CUDA-event seconds)."""
    with DeviceTimer(dev) as timer:
        out = fn()
    return out, timer.seconds


def topk_sort(dev):
    """23a: oriented `sort_scan` at D=500, T=2000 with oriented_neighbors=16
    against the dense form (oriented_block_sort=False for both).  Returns
    (frames/s of each form, the top-k run, the stream)."""
    n = TOPK_FRAMES
    box = torch.as_tensor(oriented_stream(n, 42), device=dev)
    conf = torch.ones((n, OD), dtype=torch.float32, device=dev)
    valid = torch.ones((n, OD), dtype=torch.bool, device=dev)
    dense = SortConfig(method="iou", assignment="auction", max_idle_epochs=5,
                       oriented=True, oriented_block_sort=False)
    topk = dataclasses.replace(dense, oriented_neighbors=TOPK_K)
    st0 = new_sort_state(OT, 1, device=dev)
    rates, runs = {}, {}
    for label, cfg in (("top-k", topk), ("dense", dense)):
        if use_sorted_path(cfg, OD, OT, dev):
            raise AssertionError(f"{label}: oriented_block_sort=False takes "
                                 "the sorted path")
        sort_scan(cfg, st0, box[:2], conf[:2], valid[:2], 1)  # warm-up
        runs[label], secs = run_timed(
            dev, lambda cfg=cfg: sort_scan(cfg, st0, box, conf, valid, 1))
        rates[label] = n / secs
    err = compare_scans("oriented SORT top-k against dense", runs["top-k"],
                        runs["dense"])
    return rates, err, runs["top-k"], (box, conf, valid, topk)


def topk_sort_cpu(run, stream):
    """23a on the CPU: the first frames' top-k ids equal the card's."""
    box, conf, valid, topk = stream
    n, cpu = TOPK_CPU_FRAMES, torch.device("cpu")
    _, out = sort_scan(topk, new_sort_state(OT, 1, device=cpu),
                       box[:n].cpu(), conf[:n].cpu(), valid[:n].cpu(), 1)
    for f in ("slot", "track_id", "is_new", "length"):
        if not torch.equal(getattr(out, f), getattr(run[1], f)[:n].cpu()):
            raise AssertionError(f"oriented SORT top-k: {f} of the first {n} "
                                 "frames differs from the CPU run")


def topk_nms(dev):
    """23b: `nms_kernel` at n=1000 with neighbors=16 and dense.  Returns
    ({form: ms per frame}, {form: keep masks}, the frames)."""
    frames = torch.as_tensor(nms_stream(TOPK_NMS_FRAMES), device=dev)
    valid = torch.ones(NMS_N, dtype=torch.bool, device=dev)
    ms, keeps = {}, {}
    for label, nb in (("top-k", TOPK_K), ("dense", 0)):
        nms_kernel(frames[0], valid, NMS_THRESHOLD, neighbors=nb,
                   block_skip=False)  # warm-up
        keeps[label], secs = run_timed(dev, lambda nb=nb: [
            nms_kernel(b, valid, NMS_THRESHOLD, neighbors=nb,
                       block_skip=False) for b in frames])
        ms[label] = secs * 1e3 / len(frames)
    return ms, keeps, (frames, valid)


def topk_nms_checks(dev, keeps, inputs):
    """23b's comparisons: top-k keeps equal the dense ones on every frame
    where no box has more than 16 partners besides itself (where the
    prune is exact), and the CPU top-k run's on the first frames; the
    block-skip route (the clip kernel: comparison launches, not counted)
    timed beside.  Returns (exact frames, frames whose keeps differ from
    dense, block-skip ms per frame)."""
    frames, valid = inputs
    exact = differ = 0
    for f, b in enumerate(frames):
        same = torch.equal(keeps["top-k"][f], keeps["dense"][f])
        differ += not same
        if max_partners(b, b) <= TOPK_K + 1:
            exact += 1
            if not same:
                raise AssertionError(f"NMS frame {f}: top-k keeps differ "
                                     "from dense where the prune is exact")
    cpu = torch.device("cpu")
    for f in range(min(TOPK_CPU_FRAMES, len(frames))):
        want = nms_kernel(frames[f].cpu(), valid.cpu(), NMS_THRESHOLD,
                          neighbors=TOPK_K)
        if not torch.equal(want, keeps["top-k"][f].cpu()):
            raise AssertionError(f"NMS frame {f}: top-k keeps differ from "
                                 "the CPU run")
    blk, secs = run_timed(dev, lambda: [nms_kernel(b, valid, NMS_THRESHOLD)
                                        for b in frames])
    for f, (a, b) in enumerate(zip(blk, keeps["dense"])):
        if not torch.equal(a, b):
            raise AssertionError(f"NMS frame {f}: block-skip keeps differ "
                                 "from dense")
    return exact, differ, secs * 1e3 / len(frames)


def chunked_steps(dev):
    """23c: `batched_visual_step_chunked` and `batched_sort_step_chunked`
    at S=256 x 100 (VisualSORT bf16, F=512) with chunks of 64 and 256
    scenes, two runs of each chunk in turns from one state: outputs equal
    every frame, states equal.  Returns {kind: {chunk: (scene-frames/s of
    each run, peak bytes allocated in a run, bytes held before it)}}."""
    s, n = BS, CHUNK_FRAMES
    boxes, feat = batch_stream(n, s, dev)
    ones = torch.ones((s, BD), dtype=torch.float32, device=dev)
    tru = ones > 0
    sort_cfg = SortConfig(method="iou", assignment="auction",
                          max_idle_epochs=5, oriented=False)
    kinds = (
        ("visual",
         lambda c: mesh.batched_visual_step_chunked(bench_visual_config(), c),
         lambda: mesh.new_batched_visual_state(s, BT, 1, K, F, torch.bfloat16,
                                               device=dev),
         lambda i: (boxes[i], ones, tru, feat, tru, ones, ones),
         compare_states),
        ("sort", lambda c: mesh.batched_sort_step_chunked(sort_cfg, c),
         lambda: mesh.new_batched_state(s, BT, 1, device=dev),
         lambda i: (boxes[i], ones, tru), compare_sort_states))
    cuda = dev.type == "cuda"
    result = {}
    for kind, make, new_state, frame, same_state in kinds:
        st0 = new_state()

        def run(step, frames):
            st, outs = st0, []
            for i in range(frames):
                ep = torch.full((s,), 1 + i, dtype=torch.int32, device=dev)
                st, out = step(st, *frame(i), ep)
                outs.append(out)
            return st, outs

        for c in CHUNKS:
            run(make(c), 2)  # warm-up
        rates, peak, held, last = {c: [] for c in CHUNKS}, {}, {}, {}
        for c in CHUNKS + CHUNKS[::-1]:
            if cuda:
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            held[c] = torch.cuda.memory_allocated(dev) if cuda else 0
            last[c], secs = run_timed(dev, lambda c=c: run(make(c), n))
            top = torch.cuda.max_memory_allocated(dev) if cuda else 0
            peak[c] = max(peak.get(c, 0), top)
            rates[c].append(s * n / secs)
        (sa, oa), (sb, ob) = (last[c] for c in CHUNKS)
        fields = ("slot", "track_id", "is_new", "length", "overflow") + (
            ("voting_type",) if kind == "visual" else ())
        for i, (a, b) in enumerate(zip(oa, ob)):
            for fld in fields:
                if not torch.equal(getattr(a, fld), getattr(b, fld)):
                    raise AssertionError(f"chunked batched {kind} frame {i}: "
                                         f"{fld} differs between chunks "
                                         f"{CHUNKS}")
        same_state(f"chunked batched {kind}", sa, sb)
        if bool(torch.stack([o.overflow for o in oa]).any()):
            raise AssertionError(f"chunked batched {kind} overflowed")
        result[kind] = {c: (rates[c], peak[c], held[c]) for c in CHUNKS}
        del st0, last, sa, oa, sb, ob
    return result


def sh_clip(dev):
    """23d: `clip_polygon_quads` on 65,536 quad pairs on the card against
    the same call on the CPU (the quads made once on the CPU): counts
    equal, vertices within RTOL/ATOL; the clipped area against the
    Green's-theorem area at tests/test_geometry.py's tolerance.  Returns
    (card ms per call, CPU ms per call, pairs with a polygon, max abs
    vertex difference, the card's quads)."""
    rng = np.random.default_rng(23)
    boxes = np.zeros((2, SH_PAIRS, 5), np.float32)
    for arr in boxes:
        arr[:, :2] = rng.uniform(-20, 20, (SH_PAIRS, 2))
        arr[:, 2] = rng.uniform(0, 2 * np.pi, SH_PAIRS)
        arr[:, 3] = rng.uniform(0.2, 3.0, SH_PAIRS)
        arr[:, 4] = rng.uniform(1, 30, SH_PAIRS)
    qa, qb = (geo.box_vertices(torch.as_tensor(b)) for b in boxes)
    cpu_out, cpu_secs = run_timed(torch.device("cpu"),
                                  lambda: geo.clip_polygon_quads(qa, qb))
    da, db = qa.to(dev), qb.to(dev)
    verts, n = geo.clip_polygon_quads(da, db)
    if not torch.equal(n.cpu(), cpu_out[1]):
        raise AssertionError("Sutherland-Hodgman clip: vertex counts differ "
                             "from the CPU run")
    torch.testing.assert_close(verts.cpu(), cpu_out[0], rtol=RTOL, atol=ATOL)
    err = float((verts.cpu() - cpu_out[0]).abs().max())
    area = geo._clip_area_one(da, db)
    torch.testing.assert_close(geo.quad_intersection_area(da, db), area,
                               rtol=2e-3, atol=1e-2)
    ms = time_ms(dev, lambda: geo.clip_polygon_quads(da, db), 10)
    return ms, cpu_secs * 1e3, int((n >= 3).sum()), err, (da, db)


def form_profiles(dev, stream, nms_in, quads):
    """torch.profiler over 8 frames of each 23a and 23b form and one
    clip_polygon_quads call: {form: (device busy ms, kernel launches, idle
    share) per frame or call}; the idle share against unprofiled CUDA-event
    times of the same calls.  Empty off the card."""
    if dev.type != "cuda":
        return {}
    n = TOPK_CPU_FRAMES
    box, conf, valid, topk = stream
    frames, v = nms_in
    runs = {f"sort_scan {label}": lambda cfg=cfg: sort_scan(
        cfg, new_sort_state(OT, 1, device=dev), box[:n], conf[:n],
        valid[:n], 1) for label, cfg in (
            ("top-k", topk),
            ("dense", dataclasses.replace(topk, oriented_neighbors=0)))}
    runs.update({f"nms_kernel {label}": lambda nb=nb: [
        nms_kernel(b, v, NMS_THRESHOLD, neighbors=nb, block_skip=False)
        for b in frames[:n]] for label, nb in (("top-k", TOPK_K),
                                               ("dense", 0))})
    out = {}
    for label, run in runs.items():
        run()
        _, secs = run_timed(dev, run)
        busy, launches, _ = device_profile(run, n)
        out[label] = (busy, launches, 1.0 - busy / (secs * 1e3 / n))
    run = lambda: geo.clip_polygon_quads(*quads)  # noqa: E731
    _, secs = run_timed(dev, run)
    busy, launches, _ = device_profile(run, 1)
    out["clip_polygon_quads"] = (busy, launches, 1.0 - busy / (secs * 1e3))
    return out


def phase_last_forms(dev):
    """Phase 23: the paths a-d driven with every launch counter at 0; then,
    outside that window, the comparisons that launch the clip kernel."""
    card = gpu_line()
    zero_counts()
    rates, err, run, stream = topk_sort(dev)
    nms_ms, keeps, nms_in = topk_nms(dev)
    chunked = chunked_steps(dev)
    sh_ms, sh_cpu_ms, polys, sh_err, quads = sh_clip(dev)
    profiles = form_profiles(dev, stream, nms_in, quads)
    counts = read_counts()
    # 23c's visual step: S / chunk slices a frame, 2 warm-up frames and two
    # runs of CHUNK_FRAMES for each chunk; its SORT step the same; 23a's
    # two forms: 2 warm-up frames and TOPK_FRAMES, then on the card three
    # runs of TOPK_CPU_FRAMES in `form_profiles`
    chunk_steps = sum((2 + 2 * CHUNK_FRAMES) * max(BS // c, 1)
                      for c in CHUNKS)
    topk_steps = 2 * (2 + TOPK_FRAMES) + (
        2 * 3 * TOPK_CPU_FRAMES if dev.type == "cuda" else 0)
    expect_counts("phase 23", counts, {"visual_votes": chunk_steps,
                                       "auction": 2 * chunk_steps
                                       + topk_steps})
    topk_sort_cpu(run, stream)
    box = stream[0]
    partners = max(max_partners(b, b) - 1 for b in box[:TOPK_CPU_FRAMES])
    cfg = SortConfig(method="iou", assignment="auction", max_idle_epochs=5,
                     oriented=True)
    sort_scan(cfg, new_sort_state(OT, 1, device=dev), *(
        x[:2] for x in stream[:3]), 1)  # warm-up
    _, secs = run_timed(dev, lambda: sort_scan(
        cfg, new_sort_state(OT, 1, device=dev), *stream[:3], 1))
    exact, differ, blk_ms = topk_nms_checks(dev, keeps, nms_in)
    log(f"[23] launches on phase 23's paths {counts} (none of the forms "
        f"launches a custom kernel; the comparison runs below launch the "
        f"clip kernel outside that window and are not counted)")
    log(f"[23] oriented sort_scan D={OD} T={OT}, {TOPK_FRAMES} frames, "
        f"oriented_block_sort=False: top-k (oriented_neighbors={TOPK_K}) "
        f"{rates['top-k']:.1f} frames/s, dense {rates['dense']:.1f} "
        f"frames/s; the sorted clip-kernel path (\"auto\") "
        f"{TOPK_FRAMES / secs:.1f} frames/s on the same frames (CUDA "
        f"events); top-k ids, slots, is_new and lengths equal to dense "
        f"(max_abs_err {err:.3e}) and to the CPU top-k run's first "
        f"{TOPK_CPU_FRAMES} frames; at most {partners} other boxes within "
        f"the radius of a box in those frames; {card}")
    log(f"[23] nms_kernel n={NMS_N}, {TOPK_NMS_FRAMES} frames: top-k "
        f"(neighbors={TOPK_K}) {nms_ms['top-k']:.4f} ms/frame, dense "
        f"{nms_ms['dense']:.4f}, block-skip {blk_ms:.4f} (CUDA events); "
        f"top-k keeps equal dense on {TOPK_NMS_FRAMES - differ} of "
        f"{TOPK_NMS_FRAMES} frames ({exact} where the prune is exact, all "
        f"equal there), equal to the CPU top-k run on the first "
        f"{TOPK_CPU_FRAMES}; block-skip keeps equal dense")
    for kind, stats in chunked.items():
        parts = ", ".join(
            f"chunk {c}: " + " / ".join(f"{r:.1f}" for r in rates_)
            + f" scene-frames/s, peak {peak / 2**20:.1f} MiB allocated "
            f"({(peak - before) / 2**20:.1f} MiB above the "
            f"{before / 2**20:.1f} MiB held before the run)"
            for c, (rates_, peak, before) in stats.items())
        log(f"[23] batched_{kind}_step_chunked S={BS} x {BD}"
            f"{' bf16 F=' + str(F) if kind == 'visual' else ''}, "
            f"{CHUNK_FRAMES} frames (two runs per chunk in turns, CUDA "
            f"events; torch.cuda.max_memory_allocated): {parts}; outputs "
            f"equal every frame, states equal")
    if profiles:
        log("[23] per frame (per call for the clip), torch.profiler over "
            f"{TOPK_CPU_FRAMES} frames: " + "; ".join(
                f"{k} device busy {b:.3f} ms, {n:.1f} kernel launches, idle "
                f"share {i:.3f}" for k, (b, n, i) in profiles.items()))
    log(f"[23] clip_polygon_quads {SH_PAIRS} pairs: {sh_ms:.4f} ms per call "
        f"on the card (CUDA events), {sh_cpu_ms:.2f} ms on the CPU (host "
        f"clock, one call); counts equal, vertices max_abs_err "
        f"{sh_err:.3e}, {polys} pairs intersect; clipped area within "
        f"2e-3 / 1e-2 of quad_intersection_area")


# ---------------------------------------------------------------------------
# phase 24: the benchmark entry points (similari_tpu_torch/bench.py and
# bench_interactive.py)
# ---------------------------------------------------------------------------

# (bench.py configuration, frames, launches its workload must make there):
# the rows that reach each kernel, and the two oriented rows below the
# clip kernel's gates (T >= 512 slots and D >= 64 for SORT, n >= 512 for
# NMS), which take the dense path
BENCH_ROWS = (
    ("sort_iou_100_pallas", 64, {"fused_sort": 2}),
    ("visual_sort_100x512_pallas", 64, {"fused_visual": 2,
                                        "gallery_dots": 2}),
    ("sort_iou_oriented_100", 16, {"auction": 16}),
    ("sort_iou_oriented_500", 16, {"clip_pairs": 16, "auction": 16}),
    ("nms_oriented_100", 16, {}),
    ("nms_oriented_1000", 16, {"clip_pairs": 16}),
    ("batch_visual_64x100x512", 8, {"lane_merge": 16, "visual_votes": 8,
                                    "auction": 8}),
)
BENCH_CMDS = (
    ("bench.py BENCH_FAST=1", ["similari_tpu_torch.bench"],
     {"BENCH_FAST": "1"}),
    *((f"bench_interactive --engine {e}",
       ["similari_tpu_torch.bench_interactive", "--objects", "10", "100",
        "--reps", "5", "--captures", "1", "--engine", e], {})
      for e in ("host", "device")),
)
BENCH_TIMEOUT = 400  # s for the entry-point processes


def bench_references(dev, c, frames):
    """{form: ids} of bench row `c` from other forms on the card: the fused
    scans through the plain chunks and through the kernels at the runners'
    chunk (CHUNK, 16: bench.py's 32 must give its ids), the in-place
    batched step's plain form (`scene_chunk` = S: the batched step).
    Empty for the rows other phases hold (the clip against its plain
    version: phases 5-7)."""
    def ids(**kw):
        return c.build(*c.args, frames, device=dev, **{**c.kwargs, **kw}
                       ).run(frames)[0]

    if c.build in (pbench.sort_pallas_workload,
                   pbench.visual_pallas_workload):
        with plain_chunks():
            plain = ids()
        return {"the plain chunks": plain,
                f"the kernels at chunk {CHUNK}": ids(chunk=CHUNK)}
    if c.build is pbench.batch_visual_workload:
        return {"the batched step": ids(scene_chunk=c.args[0])}
    return {}


def finite_positive(label, value, positive=True):
    """Every number in `value` (nested lists and dicts) finite and, unless
    `positive` is False, > 0."""
    if isinstance(value, dict):
        for k, v in value.items():
            finite_positive(f"{label}.{k}", v, positive)
    elif isinstance(value, list):
        for v in value:
            finite_positive(label, v, positive)
    elif isinstance(value, (int, float)) and not isinstance(value, bool):
        if not (np.isfinite(value) and (value > 0 or not positive)):
            raise AssertionError(f"{label} = {value}")


def run_entry_points(cmds, meanwhile=None, label="[24]"):
    """Each (label, `python -m` arguments, extra environment) of `cmds`
    as a process from the checkout, all at once (a smoke check: their
    times are not measurements), its output in files; while they run,
    `meanwhile()` runs here.  Every one must exit 0.  Returns
    [(label, its stdout, its stderr)] and `meanwhile`'s result; a process
    still running after BENCH_TIMEOUT, or left when one fails, is
    killed."""
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as st:
        procs = []
        for i, (name, args, env) in enumerate(cmds):
            files = [st.enter_context(open(Path(tmp) / f"{i}.{k}", "w+"))
                     for k in ("out", "err")]
            procs.append((name, files, subprocess.Popen(
                [sys.executable, "-m", *args], cwd=root,
                env={**os.environ, **env}, stdout=files[0], stderr=files[1],
                text=True)))
        out = []
        deadline = time.monotonic() + BENCH_TIMEOUT
        try:
            extra = meanwhile() if meanwhile else None
            for name, files, proc in procs:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
                stdout, stderr = (f.seek(0) or f.read() for f in files)
                if proc.returncode != 0:
                    raise AssertionError(
                        f"{label} {name}: rc {proc.returncode}\n"
                        f"{stderr[-4000:]}\n{stdout[-2000:]}")
                out.append((name, stdout, stderr))
        finally:
            for _, _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return out, extra


def last_json(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


def phase_bench(dev):
    """Phase 24: each BENCH_ROWS workload of the port's bench.py called
    once on the card, every launch counter zeroed before and read after
    (the kernels' outputs held to their plain forms where no other phase
    does); then both entry points as processes: bench.py under
    BENCH_FAST=1 and bench_interactive on both engines, rc 0, a parseable
    last line, every number in it finite and positive, no `_error`.
    Returns the launches of the rows by counter and each entry point's
    stdout by label."""
    card = gpu_line()
    configs = {c.name: c for c in pbench.CONFIGS}
    launches = dict.fromkeys(COUNTERS, 0)
    for name, frames, want in BENCH_ROWS:
        c = configs[name]
        w = c.build(*c.args, frames, device=dev, **c.kwargs)
        zero_counts()
        with DeviceTimer(dev) as timer:
            out = w.run(frames)
        counts = read_counts()
        expect_counts(f"[24] {name}", counts, want)
        for k, v in counts.items():
            launches[k] += v
        refs = bench_references(dev, c, frames)
        for form, ref in refs.items():
            if not torch.equal(out[0], ref):
                raise AssertionError(f"[24] {name}: ids differ from {form}")
        log(f"[24] {name}: {frames} frames in {timer.seconds * 1e3:.1f} ms "
            f"(first call, CUDA events), launches {counts}"
            + (f"; ids equal to {' and to '.join(refs)} on the card"
               if refs else ""))
    t0 = time.perf_counter()
    results, _ = run_entry_points(BENCH_CMDS)
    secs = time.perf_counter() - t0
    for label, stdout, err in results:
        line = last_json(stdout)
        rows = line.get("extra", line.get("rows"))
        errors = [k for k in rows if k.endswith("_error")]
        if errors or not rows:
            raise AssertionError(f"[24] {label}: errors {errors}\n"
                                 f"{err[-4000:]}")
        finite_positive(label, line)
        for ln in err.splitlines():
            if ln.strip():
                log(f"[24]   {ln}")
        log(f"[24] {label}: rc 0, {len(rows)} values, all finite and "
            f"positive; last line {json.dumps(line)[:1500]}")
    log(f"[24] the {len(BENCH_CMDS)} entry-point processes, run at once, "
        f"ended in {secs:.1f} s")
    log(f"[24] launches of the bench rows {launches}; {card}")
    return launches, {label: stdout for label, stdout, _ in results}


# ---------------------------------------------------------------------------
# phase 25: the remaining entry points (similari_tpu_torch/bench_pod.py,
# tools/, examples/)
# ---------------------------------------------------------------------------

POD_FRAMES, POD_REPS = 16, 2  # bench_pod's runs: a warm-up and the reps
POD_ARGS = ["--devices", "1", "--scenes-per-device", "8", "--objects", "100",
            "--base-len", str(POD_FRAMES), "--point-reps", str(POD_REPS)]
ENTRY_CMDS = (
    ("bench_pod --tracker both", ["similari_tpu_torch.bench_pod",
                                  *POD_ARGS, "--tracker", "both"], {}),
    ("bench_pod --tracker gallery", ["similari_tpu_torch.bench_pod",
                                     *POD_ARGS, "--tracker", "gallery"], {}),
    ("tools.profile_gallery", ["similari_tpu_torch.tools.profile_gallery",
                               "--devices", "1", "--scenes-per-device", "8",
                               "--calls", "16", "--point-reps", "2"], {}),
    ("tools.profile_oriented", ["similari_tpu_torch.tools.profile_oriented",
                                "--reps", "10", "--profiled", "8"], {}),
    *((f"examples.{name}{' --device cpu' if cpu else ''}",
       [f"similari_tpu_torch.examples.{name}",
        *(["--device", "cpu"] if cpu else [])], {})
      for name, cpu in (("batch_scenes_device", False),
                        ("batch_scenes_device", True),
                        ("visual_pallas_pipeline", False),
                        ("cross_camera_handoff", False))),
)
ADV_FRAMES = 120  # the adversarial scenarios' frames here (the suite: 240)


def adversarial_on_card(dev):
    """The adversarial suite's `crossing` (every SORT axis) and
    `reid_crossing` (every VisualSORT axis, the fused one included), seed
    0, ADV_FRAMES frames, on the card, every launch counter zeroed before
    and read after.  Returns ({(scenario, axis): (MOTA, IDF1)}, the
    fused axis's and the auction axis's predictions, launches)."""
    from similari_tpu_torch.tools import adversarial_suite as adv

    zero_counts()
    scores, preds = {}, {}
    for runner, axes in ((adv.SortRunner("crossing", dev), adv.SORT_AXES),
                         (adv.VisualRunner("reid_crossing", dev),
                          adv.REID_AXES["reid_crossing"])):
        streams = runner.make(0, n_frames=ADV_FRAMES)
        for axis in axes:
            pred = runner.run(axis, streams)
            scores[runner.scenario, axis] = adv.score(streams[0], pred)
            preds[axis] = pred
    return scores, preds, read_counts()


def check_adversarial(scores, preds, counts, card):
    # the fused axis launches the fused kernels, the card's other
    # VisualSORT axes the votes kernel, its auction axes the auction kernel
    expect_launched("[25] the adversarial suite", counts,
                    ("fused_visual", "gallery_dots", "visual_votes",
                     "auction"))
    if counts["fused_visual"] != counts["gallery_dots"]:
        raise AssertionError(f"[25] launches {counts}: one product a chunk")
    worst = 0.0
    for (scenario, axis), (mota, idf1) in scores.items():
        base = scores[scenario, "host" if scenario == "crossing"
                      else "vhost"]
        worst = max(worst, abs(mota - base[0]), abs(idf1 - base[1]))
    fused, auction = preds["vfused"], preds["vauction"]
    same = fused.keys() == auction.keys() and all(
        [r[0] for r in fused[f]] == [r[0] for r in auction[f]]
        for f in fused)
    d = [abs(a - b) for a, b in zip(scores["reid_crossing", "vfused"],
                                    scores["reid_crossing", "vauction"])]
    if not same and max(d) > 0.5:
        raise AssertionError(f"[25] vfused against vauction: deltas {d}")
    log("[25] adversarial suite on the card, seed 0, "
        f"{ADV_FRAMES} frames: " + "; ".join(
            f"{sc} {ax} MOTA {m:.2f} IDF1 {i:.2f}"
            for (sc, ax), (m, i) in scores.items()))
    log(f"[25] worst |delta| against each scenario's host axis {worst:.3f} "
        f"pt (bar 0.5); vfused ids {'equal to' if same else 'differ from'} "
        f"vauction's (|dMOTA|, |dIDF1| {d[0]:.3f}, {d[1]:.3f} pt); "
        f"launches {counts}; {card}")
    if worst > 0.5:
        raise AssertionError(f"[25] an axis is {worst:.3f} pt off its host "
                             "axis")


def check_pod(label, line):
    rows = line["rows"]
    errors = [k for k in rows if k.endswith("_error")]
    if errors or not rows:
        raise AssertionError(f"[25] {label}: rows {rows}")
    finite_positive(label, line)
    if "visual_n1_scene_fps" in rows:
        want = 2 * POD_FRAMES * (POD_REPS + 1)
        got = line["launches"]["visual_n1"]["lane_merge"]
        if got != want:
            raise AssertionError(f"[25] {label}: {got} merge launches, "
                                 f"expected {want}")
        return got
    return 0


def check_profilers(results):
    gallery = last_json(results["tools.profile_gallery"])
    oriented = last_json(results["tools.profile_oriented"])
    for label, line in (("profile_gallery", gallery),
                        ("profile_oriented", oriented)):
        finite_positive(label, line, positive=False)
    row = gallery["rows"]["n1"]
    finite_positive("profile_gallery", {k: row[k] for k in (
        "full_ms", "scoring_ms", "qps_total", "gather_payload_bytes",
        "gallery_lanes")})
    finite_positive("profile_oriented", {k: oriented[k] for k in (
        "oriented_full_ms", "oriented_native_ms", "aligned_native_ms",
        "device_call_ms", "device_busy_ms_per_call", "kernels_per_call",
        "clip_device_ms_per_launch", "pair_weight_calls")})
    if oriented["clip_launches_per_call"] != 1:
        raise AssertionError(f"[25] the device Sort's oriented-500 call: "
                             f"{oriented['clip_launches_per_call']} clip "
                             "launches a call, expected 1")
    return gallery, oriented


def phase_entry_points(dev):
    """Phase 25: the remaining entry points.  bench_pod (both trackers and
    the gallery), both profilers and three examples run as processes
    from the checkout, all at once; meanwhile, in this process, the
    adversarial suite's `crossing` and `reid_crossing` on the card with
    every launch counter zeroed before and read after.  Returns the
    launches by counter: the suite's, and bench_pod's merge launches."""
    card = gpu_line()
    t0 = time.perf_counter()
    results, (scores, preds, counts) = run_entry_points(
        ENTRY_CMDS, lambda: adversarial_on_card(dev), label="[25]")
    secs = time.perf_counter() - t0
    out = {name: stdout for name, stdout, _ in results}
    check_adversarial(scores, preds, counts, card)
    merge = 0
    for label in ("bench_pod --tracker both", "bench_pod --tracker gallery"):
        line = last_json(out[label])
        merge += check_pod(label, line)
        log(f"[25] {label}: rc 0, every number finite and positive; "
            f"{json.dumps(line)}")
    gallery, oriented = check_profilers(out)
    log(f"[25] profile_gallery n=1: {json.dumps(gallery['rows']['n1'])}")
    log(f"[25] profile_oriented: {json.dumps(oriented)}")
    card_ids, cpu_ids = (out[f"examples.batch_scenes_device{s}"]
                         for s in ("", " --device cpu"))
    if card_ids != cpu_ids:
        raise AssertionError(f"[25] batch_scenes_device on the card printed "
                             f"{card_ids!r}, on the CPU {cpu_ids!r}")
    for name in ("batch_scenes_device", "visual_pallas_pipeline",
                 "cross_camera_handoff"):
        log(f"[25] examples.{name} on the card: rc 0; "
            + " | ".join(out[f"examples.{name}"].strip().splitlines()))
    log(f"[25] batch_scenes_device printed the same lines on the card and "
        f"on the CPU; the {len(ENTRY_CMDS)} processes and the suite, run "
        f"at once, ended in {secs:.1f} s; {card}")
    return {**counts, "lane_merge": counts["lane_merge"] + merge}


# ---------------------------------------------------------------------------
# phase 26: the last entry points (similari_tpu_torch/tools/:
# decision_margins, experiment_batch_merge, experiment_pallas_batch,
# ablate_visual, gen_doc_tables)
# ---------------------------------------------------------------------------

ABLATE_SCENES = 256
MARGIN_SEED = 0
OWN_AREA_BAR = 1e-6  # the margins' own-area host/device delta
PORT_BLOCK = re.compile(r"(<!-- BEGIN GENERATED: (port-[a-z-]+) -->\n)"
                        r".*?(<!-- END GENERATED: \2 -->)", re.S)


def last_tool_cmds(margins_out):
    """(label, `python -m` arguments, extra environment) of the four
    measuring tools; the margins' artifact goes to `margins_out`."""
    tool = "similari_tpu_torch.tools."
    return (
        ("tools.decision_margins", [tool + "decision_margins", "--seeds",
                                    str(MARGIN_SEED), "--out",
                                    str(margins_out)], {}),
        ("tools.experiment_batch_merge", [tool + "experiment_batch_merge"],
         {}),
        ("tools.experiment_pallas_batch", [tool + "experiment_pallas_batch"],
         {}),
        ("tools.ablate_visual", [tool + "ablate_visual",
                                 str(ABLATE_SCENES)], {}),
    )


def check_margins(line, blob):
    rows = blob["rows"]
    if set(rows) != {"reid_crossing", "reid_confusable", "reid_gaps"}:
        raise AssertionError(f"[26] decision_margins rows {sorted(rows)}")
    finite_positive("decision_margins", line)
    for scenario, row in rows.items():
        finite_positive(f"decision_margins {scenario}", {
            k: row[k] for k in ("min_claim_margin", "min_row_margin",
                                "max_bf16_weight_delta", "competing_pairs")})
    delta = rows["reid_crossing"]["max_ownarea_host_dev_delta"]
    if not delta <= OWN_AREA_BAR:
        raise AssertionError(f"[26] own-area host/device delta {delta} > "
                             f"{OWN_AREA_BAR}")
    return delta


def check_batch_merge(line):
    from similari_tpu_torch.tools import experiment_batch_merge as ebm

    if line["bit_equal"] is not True:
        raise AssertionError(f"[26] experiment_batch_merge: the forms' "
                             f"states differ: {line}")
    finite_positive("experiment_batch_merge", line["ms_per_step"])
    # a launch a step, a warm-up chain and the timed ones
    want = ebm.SHAPE["steps"] * (ebm.REPS + 1)
    if line["launches"]["lane_merge"] != want:
        raise AssertionError(f"[26] experiment_batch_merge launches "
                             f"{line['launches']}, expected {want}")
    return want


def check_pallas_batch(line):
    from similari_tpu_torch.tools import experiment_pallas_batch as epb

    if line["ids_equal_alone"] is not True:
        raise AssertionError(f"[26] experiment_pallas_batch: a scene's ids "
                             f"differ from its lone plain run: {line}")
    launches = {"fused_visual": 0, "gallery_dots": 0}
    for name, row in line["rows"].items():
        n = int(name[1:])
        want = epb.ITERS * epb.REPS * n  # a launch a scene a chunk
        if row["launches"] != {"fused_visual": want, "gallery_dots": want}:
            raise AssertionError(f"[26] experiment_pallas_batch {name}: "
                                 f"launches {row['launches']}, expected "
                                 f"{want} of each")
        finite_positive(f"experiment_pallas_batch {name}",
                        {k: row[k] for k in ("us_per_frame", "scene_fps")})
        for k in launches:
            launches[k] += row["launches"][k]
    return launches


def check_ablation(line):
    from similari_tpu_torch.tools import ablate_visual as abl

    stages = ["full", "posonly", "votesonly", "auctiononly", "mergeonly"]
    if list(line["ms_per_step"]) != stages or line["scenes"] != ABLATE_SCENES:
        raise AssertionError(f"[26] ablate_visual: {line}")
    finite_positive("ablate_visual", line["ms_per_step"])
    finite_positive("ablate_visual rest", line["rest_ms"], positive=False)
    # 2 a step in the full and merge stages, a warm-up run and the timed
    per_stage = 2 * abl.BASE_LEN * (abl.REPS + 1)
    want = {k: per_stage if k in ("full", "mergeonly") else 0
            for k in stages}
    if line["merge_launches"] != want:
        raise AssertionError(f"[26] ablate_visual merge launches "
                             f"{line['merge_launches']}, expected {want}")
    return sum(want.values())


def doc_tables(tmp, bench_out, margins_out):
    """`tools.gen_doc_tables` on a copy of README.md in `tmp`, fed phase
    24's bench.py and host bench_interactive lines and the margins'
    artifact; only the fed `port-*` blocks may change.  Returns the
    blocks regenerated."""
    root = Path(__file__).resolve().parent
    arts = {"bench": "bench.py BENCH_FAST=1",
            "interactive": "bench_interactive --engine host"}
    args = ["--readme", str(Path(tmp) / "README.md"),
            "--margins", str(margins_out)]
    for name, label in arts.items():
        path = Path(tmp) / f"{name}.json"
        path.write_text(bench_out[label])
        args += [f"--{name}", str(path)]
    shutil.copy(root / "README.md", Path(tmp) / "README.md")
    results, _ = run_entry_points(
        [("tools.gen_doc_tables",
          ["similari_tpu_torch.tools.gen_doc_tables", *args], {})],
        label="[26]")
    line = last_json(results[0][1])
    before = (root / "README.md").read_text()
    after = (Path(tmp) / "README.md").read_text()

    def strip(text):
        return PORT_BLOCK.sub(lambda m: m.group(1) + m.group(3), text)

    want = ["port-headline", "port-full-matrix", "port-margins",
            "port-interactive-ranges"]
    if sorted(line["blocks"]) != sorted(want):
        raise AssertionError(f"[26] gen_doc_tables regenerated "
                             f"{line['blocks']}, expected {want}")
    if strip(after) != strip(before):
        raise AssertionError("[26] gen_doc_tables changed README.md outside "
                             "its port-* blocks")
    return line["blocks"]


def phase_last_tools(dev, bench_out):
    """Phase 26: the four measuring tools as processes from the checkout,
    all at once (their times are a smoke check, not measurements), each
    held to its own check; then the doc tables on a copy of README.md.
    Returns the launches the tools report, by counter."""
    card = gpu_line()
    with tempfile.TemporaryDirectory() as tmp:
        margins_out = Path(tmp) / "margins.json"
        t0 = time.perf_counter()
        results, _ = run_entry_points(last_tool_cmds(margins_out),
                                      label="[26]")
        secs = time.perf_counter() - t0
        out = {name: last_json(stdout) for name, stdout, _ in results}
        for name, _, err in results:
            for ln in err.splitlines():
                if ln.strip():
                    log(f"[26]   {name}: {ln}")
        delta = check_margins(out["tools.decision_margins"],
                              json.loads(margins_out.read_text()))
        merge = check_batch_merge(out["tools.experiment_batch_merge"])
        fused = check_pallas_batch(out["tools.experiment_pallas_batch"])
        merge += check_ablation(out["tools.ablate_visual"])
        blocks = doc_tables(tmp, bench_out, margins_out)
    for name, line in out.items():
        log(f"[26] {name}: rc 0; {json.dumps(line)}")
    log(f"[26] own-area host/device delta {delta:.3e} (bar {OWN_AREA_BAR}); "
        f"the merge forms bit-equal; every scene's ids equal to its lone "
        f"plain run; gen_doc_tables regenerated {blocks} on a copy of "
        f"README.md, nothing else changed; the {len(results)} tools, run at "
        f"once, ended in {secs:.1f} s; launches: merge {merge}, fused "
        f"{fused}; {card}")
    return {**fused, "lane_merge": merge}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--main-frames", type=int, default=1024)
    ap.add_argument("--oriented-frames", type=int, default=256)
    ap.add_argument("--nms-frames", type=int, default=64)
    ap.add_argument("--batch-frames", type=int, default=32)
    ap.add_argument("--step-frames", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.frames % CHUNK:
        ap.error(f"--frames must be a multiple of {CHUNK}")

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"[1] device {kind} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}; "
        f"torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}")
    log(gpu_line())
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 f32 products would break the gallery "
                             "distances")

    t0 = time.perf_counter()
    _build.library()
    secs, build_log = _build.build_info()
    log(f"[2] nvcc build {secs:.2f} s (load {time.perf_counter() - t0:.2f} s); "
        f"flags {' '.join(_build.NVCC_FLAGS)}")
    for line in build_log.splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill",
                                   "error")):
            log("    " + line.strip())
    for name in ("fused_visual_kernel", "fused_sort_kernel"):
        res = kernel_resources(build_log, name)
        log(f"[2] {name}: " + ("library built before this run, no ptxas "
                               "report" if res is None else
                               f"{res[0]} registers, {res[1]} (ptxas)"))
    mma = mma_counts()
    log("[2] HGMMA / HMMA instructions in csrc/gallery_dots.cu: " + ", ".join(
        f"{name} {hg} / {hm}" for name, (hg, hm) in sorted(mma.items())))
    if mma.get("gallery_dots_wgmma_kernel", (0, 0))[0] == 0:
        raise AssertionError("the bf16 gallery product does not run on "
                             "wgmma")

    start = time.perf_counter()

    def stamp(label):
        log(f"[t] {label} at {time.perf_counter() - start:.1f} s")

    kernels = [phase_sort(args, dev), *phase_visual(args, dev)]
    stamp("phases 1-3 done")
    dets, feats = synthetic_sequence(args.main_frames, args.seed + 2)
    launches, fused_out, sort_out, dev_ms = phase_main(args, dets, feats)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    # `ms` is a wrapper call's CUDA-event time (phase 3), host work
    # included; `device_ms` the kernels' own device time on the main path
    for k, name in zip(kernels, ("fused_sort_kernel", "fused_visual_kernel",
                                 "gallery_dots")):
        k["device_ms"] = dev_ms[name][0]
    stamp("phase 4 done")
    clip_entry = phase_clip(args, dev)
    clip_entry["launches"], err, scan = phase_oriented_sort(args, dev)
    clip_entry["max_abs_err"] = max(clip_entry["max_abs_err"], err)
    nms_launches, keeps = phase_nms(args, dev)
    log(f"[7] clip launches: oriented SORT path {clip_entry['launches']}, "
        f"NMS path {nms_launches}")
    stamp("phases 5-7 done")
    phase_maha(dets, args.main_frames)
    kernels.append(clip_entry)
    phase_merge(args, dev)
    votes_entry = phase_votes(dev, args.seed)
    auction_entry = phase_auction(dev, args.seed)
    stamp("phases 8-9, 28 and 29 done")
    merge_entry, visual_rate, visual_ref = phase_batched_visual(args, dev)
    kernels.append(merge_entry)
    step_out = phase_general_visual(args, dev, dets, feats, fused_out)
    oa_out = phase_own_area(args, dev)
    sort_rate, sort_ref = phase_batched_sort(args, dev)
    stamp("phases 10-12 done")
    # the public API on the same paths; the clip and merge entries add
    # their launches there
    api_clip = phase_sort_api(args, dev, scan)
    api_clip += phase_nms_api(args, dev, keeps)
    stamp("phases 13-14 done")
    phase_visual_api(args, dev, dets, feats, step_out, oa_out)
    stamp("phase 15 done")
    api_merge = phase_batch_api(args, dev, visual_rate, sort_rate)
    stamp("phase 16 done")
    host_clip = phase_host_engines(args, dev, dets)
    stamp("phase 17 done")
    sharded_merge, sharded_clip = phase_sharded(args, dev, visual_ref,
                                                visual_rate, sort_ref,
                                                sort_rate, dets, feats)
    stamp("phase 18 done")
    file_launches = phase_mot_file(dets, sort_out, launches["fused_sort"])
    stamp("phase 19 done")
    kernels[0]["launches"] += file_launches
    zero_height = phase_zero_height(dev)
    stamp("phase 20 done")
    phase_store(dev)
    stamp("phase 21 done")
    kit = phase_kit(dev)
    stamp("phase 22 done")
    phase_last_forms(dev)
    stamp("phase 23 done")
    bench, bench_out = phase_bench(dev)
    stamp("phase 24 done")
    entry = phase_entry_points(dev)
    stamp("phase 25 done")
    tools = phase_last_tools(dev, bench_out)
    stamp("phase 26 done")
    for k in kernels[:3]:
        k["launches"] += (zero_height[k["name"]] + kit[k["name"]]
                          + bench[k["name"]] + entry[k["name"]]
                          + tools.get(k["name"], 0))
    clip_entry["launches"] += (api_clip + host_clip + sharded_clip
                               + bench["clip_pairs"])
    merge_entry["launches"] += (api_merge + sharded_merge
                                + bench["lane_merge"] + entry["lane_merge"]
                                + tools["lane_merge"])
    log(f"[16] launches on the API paths: clip {api_clip} (Sort, nms()), "
        f"merge {api_merge} (BatchVisualSort); [17] clip {host_clip} (the "
        f"device Sort beside the host engine; the host engines launch "
        f"none); [18] merge {sharded_merge} (the sharded visual scan and "
        f"steps), clip {sharded_clip} (the batched SORT step's sorted "
        f"path, one launch a frame); [19] fused_sort "
        f"{file_launches} (the MOT-file route, three files); [20] "
        f"{zero_height} (the fused runners on zero-height streams); [22] "
        f"{kit} (the fused runners on the kit's sequences); [24] {bench} "
        f"(the bench rows); [25] {entry} (the adversarial suite's fused "
        f"axis; bench_pod's visual rows, counted in its process); [26] "
        f"{tools} (the last tools, counted in their processes)")
    votes_entry["launches"] = HELD["visual_votes"]
    kernels.append(votes_entry)
    log(f"[28] votes kernel launches held to their phases' counts: "
        f"{votes_entry['launches']} (one a general VisualSORT step on the "
        f"card, phases 10, 15-18, 20 and 22-25; the processes of phases "
        f"24-26 not counted)")
    auction_entry["launches"] = HELD["auction"]
    kernels.append(auction_entry)
    log(f"[29] auction kernel launches held to their phases' counts: "
        f"{auction_entry['launches']} (one a general SORT or VisualSORT "
        f"step with the auction on the card, phases 6, 10, 13, 15-18, 20 "
        f"and 22-25; the processes of phases 24-26 not counted)")
    log(json.dumps({"kernels": kernels, "not_ported": []}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
