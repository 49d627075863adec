"""The batched gallery merge's three forms at the bench shape, on the card
(the JAX package's `tools/experiment_batch_merge.py`).

Each step writes D rows a scene into the gallery lanes feats[S, T, K, F]
(bf16): lane (slot, lane) of scene s takes src[s, d] where valid[s, d].
Slots are unique per (step, scene), lanes random, ~100 of 128 rows valid;
S=256, T=200, K=3, F=512, D=128, L=16 steps, seed 0, the arrays drawn as
the JAX tool draws them.  Three forms, each chained over the L steps from
its own copy of the start state:

  merge_lane - the gather form: `ops/merge.py::write_index` + `merge_lane`
               (the whole state copied with a scratch row a scene, then
               one indexed write), the counterpart of the JAX tool's
               `onehot` body (`writer_hit` + the one-hot `merge_lane`);
  index_put  - ONE flattened `index_put_` over the state's [S*T*K, F]
               rows, the invalid rows sent to a scratch row past the end
               (the JAX tool's `scatter` body and its mode="drop");
  kernel     - `ops/merge_inplace.py::lane_merge_inplace`, i.e.
               `csrc/merge.cu::lane_merge_kernel` (the JAX tool's
               `pallas` body): the state written in place, only the
               written rows moved.

Timing: CUDA events around a whole chain of L steps (the inputs on the
card, the copy of the start state made before the first event), the
median of REPS chains after one warm-up chain; the host clock on the
CPU.  The three final states must be equal bit for bit (the JAX tool
leaves this check out): a difference is exit code 1.

Run: python -m similari_tpu_torch.tools.experiment_batch_merge
         [--device cuda|cpu] [--variants merge_lane index_put kernel]
The GB/s lines and the speedups against the gather form go to stderr; one
JSON line to stdout: seconds per step by form (the JAX tool's dict),
`ms_per_step`, `bit_equal`, the kernel's `launches` and `device`.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

from ..bench_interactive import device_line, log
from ..device import resolve_device
from ..eval.mot import DeviceTimer
from ..ops import merge as mrg
from ..ops import merge_inplace as mi
from ..utils import profiling

# the JAX tool's bench shape: scenes, slots, lanes, feature width, rows a
# scene, steps
SHAPE = dict(s=256, t=200, k=3, f=512, d=128, steps=16)
VARIANTS = ("merge_lane", "index_put", "kernel")
REPS = 3  # timed chains of each form


def make_inputs(s, t, k, f, d, steps, seed=0):
    """The JAX tool's arrays, drawn in its order: feats0 [S, T, K, F] and
    src [L, S, D, F] f32 (rounded to bf16 on the device), slot, lane and
    valid [L, S, D] int32."""
    rng = np.random.default_rng(seed)
    feats0 = rng.normal(size=(s, t, k, f)).astype(np.float32)
    src = rng.normal(size=(steps, s, d, f)).astype(np.float32)
    slot = np.stack([
        np.stack([rng.permutation(t)[:d] for _ in range(s)])
        for _ in range(steps)
    ]).astype(np.int32)
    lane = rng.integers(0, k, size=(steps, s, d)).astype(np.int32)
    valid = (rng.random((steps, s, d)) < 100 / 128).astype(np.int32)
    return feats0, src, slot, lane, valid


def to_device(arrays, dev, dtype=torch.bfloat16):
    """The arrays on `dev`, the features converted to `dtype` there."""
    feats0, src, *ints = arrays
    return (torch.as_tensor(feats0, device=dev).to(dtype),
            torch.as_tensor(src, device=dev).to(dtype),
            *(torch.as_tensor(x, device=dev) for x in ints))


class Form:
    """One merge form: `start(feats0)` makes its own state, `step(state,
    slot, lane, valid, src)` writes one step's rows and returns the state,
    `final(state)` is the [S, T, K, F] result."""

    def start(self, feats0):
        return feats0.clone()

    def final(self, state):
        return state


class GatherForm(Form):
    def step(self, feats, sl, ln, va, sr):
        index = mrg.write_index(sl, va.bool(), feats.shape[1])
        return mrg.merge_lane(feats, sr, ln, index)


class ScatterForm(Form):
    def start(self, feats0):
        self.shape = feats0.shape
        s, t, k, f = self.shape
        buf = feats0.new_zeros((s * t * k + 1, f))
        buf[:-1].copy_(feats0.view(-1, f))
        self.scene = torch.arange(s, device=feats0.device)[:, None]
        return buf

    def step(self, buf, sl, ln, va, sr):
        s, t, k, f = self.shape
        rows = (self.scene * t + sl) * k + ln
        rows = torch.where(va != 0, rows, s * t * k)  # the scratch row
        return buf.index_put_((rows.reshape(-1),), sr.reshape(-1, f))

    def final(self, buf):
        return buf[:-1].view(self.shape)


class KernelForm(Form):
    def step(self, feats, sl, ln, va, sr):
        s, t, k, f = feats.shape
        mi.lane_merge_inplace(feats.view(s, t * k, f), sr,
                              (sl * k + ln).to(torch.int32), va)
        return feats


FORMS = {"merge_lane": GatherForm, "index_put": ScatterForm,
         "kernel": KernelForm}


def run_form(form, dev, feats0, src, slot, lane, valid, reps):
    """(median seconds per step over `reps` timed chains after a warm-up
    chain, the last chain's final state)."""
    times, state = [], None
    for rep in range(reps + 1):
        state = form.start(feats0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        with DeviceTimer(dev) as timer:
            for i in range(slot.shape[0]):
                state = form.step(state, slot[i], lane[i], valid[i], src[i])
        if rep:
            times.append(timer.seconds / slot.shape[0])
    return statistics.median(times), form.final(state)


def experiment(dev, inputs, variants=VARIANTS, reps=REPS):
    """({form: seconds per step}, {form: final state}, kernel launches)."""
    merges = profiling.counter("merge_inplace.launches")
    results, finals = {}, {}
    for name in variants:
        results[name], finals[name] = run_form(FORMS[name](), dev, *inputs,
                                               reps)
    return (results, finals,
            profiling.counter("merge_inplace.launches") - merges)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    ap.add_argument("--variants", nargs="*", choices=VARIANTS,
                    default=list(VARIANTS))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = device_line(dev)
    log(f"device {card}")
    s, t, k, f, d = (SHAPE[x] for x in "stkfd")
    inputs = to_device(make_inputs(**SHAPE), dev)

    results, finals, launches = experiment(dev, inputs, args.variants)
    for name, dt in results.items():
        tb = s * (2 * d * f * 2)  # payload read + write bytes per step
        log(f"{name}: {dt * 1e3:.3f} ms/step  "
            f"({s * t * k * f * 2 * 2 / dt / 1e9:.0f} GB/s if full r+w; "
            f"payload-only {tb / dt / 1e9:.0f} GB/s)")
    base = results.get("merge_lane")
    if base is not None:
        for name, dt in results.items():
            log(f"{name}: x{base / dt:.2f} vs merge_lane")
    first = next(iter(finals.values()))
    equal = all(torch.equal(x, first) for x in finals.values())
    log(f"final states of {list(finals)} "
        f"{'bit-equal' if equal else 'DIFFER'}; kernel launches {launches}")
    print(json.dumps({
        **results,
        "ms_per_step": {n: round(v * 1e3, 5) for n, v in results.items()},
        "bit_equal": equal,
        "launches": {"lane_merge": launches},
        "device": card,
    }))
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
