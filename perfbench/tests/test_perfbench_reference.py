"""The frozen reference against the port's CPU path, through the cells'
own drivers at a tiny size: every cell comes out correct, each control
comes out not correct, and each fault planted under the timed path turns
`correct` false."""

import dataclasses

import pytest
import torch

from cells import TINY, correct, run_tiny

SEED = 2**32 + 17


@pytest.mark.parametrize("name", sorted(TINY))
def test_port_on_the_cpu_equals_the_reference(name):
    nums, limits, run = run_tiny(name, SEED)
    assert correct(nums, limits), nums
    assert nums["mismatches"] == 0
    assert run["frames"] > 0 and run["failed"] == 0


@pytest.mark.parametrize("name,control,number", [
    ("vsort512_stream_s1024", "program_bf16", "gallery_err"),
    ("vsort512_replay_mot17", "program_bf16", "gallery_err"),
    ("sort_iou_stream_s4096", "reference_bf16", "kf_err"),
    ("vsort512_stream_s1024", "reference_bf16", "kf_err"),
])
def test_control_is_not_correct(name, control, number):
    nums, limits, _ = run_tiny(name, SEED + 1, control)
    assert nums[number] > limits[number], nums
    assert not correct(nums, limits)


def _stream_fault(kind):
    from similari_tpu_torch.trackers.state import map_tensors

    def patch(drv):
        real = drv.vstep

        def broken(state, *args):
            args = list(args)
            if kind == "half":
                # half of every frame's detections left out of the step
                valid = args[2].clone()
                valid[:, valid.shape[1] // 2:] = False
                args[2] = valid
            new, out = real(map_tensors(torch.clone, state)
                            if kind == "frozen" else state, *args)
            if kind == "altered":
                out.track_id[:, 0] += 1
            return (state if kind == "frozen" else new), out

        drv.vstep = broken
    return patch


def _replay_fault(kind, monkeypatch):
    from similari_tpu_torch.ops import fused_visual as fv

    real = fv.fused_visual_chunk

    def broken(cfg, state, box, conf, valid, *rest, **kw):
        if kind == "half":
            valid = valid.clone()
            valid[:, valid.shape[1] // 2:] = 0
        st, ids, *out = real(cfg, state, box, conf, valid, *rest, **kw)
        if kind == "altered":
            ids[:, 0] += 1
        return (state if kind == "frozen" else st), ids, *out

    monkeypatch.setattr(fv, "fused_visual_chunk", broken)
    return None


def _half_of_the_scenes(which):
    """A step that leaves half of the batch's scenes out: their state comes
    back unchanged and their rows unassigned."""
    from similari_tpu_torch.trackers.state import map_tensors

    def patch(drv):
        real = drv.vstep
        s = drv.s
        skip = (torch.arange(s) >= s // 2 if which == "upper"
                else torch.arange(s) % 2 == 1).to(drv.dev)

        def broken(state, *args):
            before = map_tensors(torch.clone, state)
            new, out = real(state, *args)
            old = iter(_leaves(before))  # map_tensors' order of leaves

            def restore(a):
                m = skip.view(-1, *([1] * (a.dim() - 1)))
                return torch.where(m, next(old), a)
            new = map_tensors(restore, new)
            out.track_id[skip] = -1
            return new, out

        drv.vstep = broken
    return patch


def _leaves(obj):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _leaves(v)
        else:
            yield v


@pytest.mark.parametrize("which", ["upper", "odd"])
@pytest.mark.parametrize("name", sorted(n for n in TINY if "replay" not in n))
def test_half_of_the_scenes_left_out_is_not_correct(name, which):
    nums, limits, _ = run_tiny(name, SEED + 3,
                               patch=_half_of_the_scenes(which))
    assert not correct(nums, limits), nums


def test_the_sample_meets_each_quarter_and_both_parities():
    from perfbench.drivers.stream import sample_scenes

    for seed in (0, 1, 2**31 + 5, 2**40 + 3):
        pos = sample_scenes(1024, 4, seed).tolist()
        assert [p // 256 for p in pos] == [0, 1, 2, 3]
        assert [p % 2 for p in pos] == [0, 1, 0, 1]
    assert sample_scenes(3, 2, 7).tolist() == [0, 1]
    assert sorted(sample_scenes(2, 2, 7).tolist()) == [0, 1]


@pytest.mark.parametrize("kind", ["frozen", "half", "altered"])
@pytest.mark.parametrize("name", sorted(TINY))
def test_fault_under_the_timed_path_is_not_correct(name, kind, monkeypatch):
    if "replay" in name:
        patch = _replay_fault(kind, monkeypatch)
    else:
        patch = _stream_fault(kind)
    nums, limits, _ = run_tiny(name, SEED + 2, patch=patch)
    assert not correct(nums, limits), nums
