"""The generator: the same seed gives the same frames, and its counts sit
within sampling error of the mix's parameters."""

import math

import pytest
import torch

from perfbench import harness
from perfbench.traffic import Scenes, record

CPU = torch.device("cpu")


def _mix():
    return harness.load_cell("vsort512_stream_s1024").mix


def _frames(seed, n=4, feature_dim=16, scenes=8):
    g = Scenes(_mix(), scenes, seed, CPU, feature_dim)
    return [g.step() for _ in range(n)]


def test_same_seed_same_frames_and_another_seed_orders_the_same_set():
    a, b, c = _frames(2**33 + 7), _frames(2**33 + 7), _frames(2**33 + 8)
    for x, y in zip(a, b):
        for k in ("box", "conf", "valid", "feat", "src"):
            assert torch.equal(getattr(x, k), getattr(y, k))
    assert not torch.equal(a[-1].box, c[-1].box)
    assert not torch.equal(a[-1].feat, c[-1].feat)

    def scenes(frame):  # each scene's rows, in a seed-free order
        return sorted(tuple(r.tolist()) for r in frame.box.reshape(8, -1))

    assert scenes(a[-1]) == scenes(c[-1])


def test_rates_within_sampling_error():
    mix = _mix()
    s, n = 40, 50
    g = Scenes(mix, s, 12345, CPU, 0)
    pop = g.present.sum(1)
    assert int(pop.min()) >= mix["population"][0]
    assert int(pop.max()) <= mix["population"][1]
    shown = fps = 0
    for _ in range(n):
        fr = g.step()
        shown += int((fr.src >= 0).sum())
        fps += int((fr.src == -1).sum())
        assert int(fr.valid.sum(1).max()) <= mix["dpad"]
    objects = int(pop.sum()) * n
    p_miss = 1.0 - shown / objects
    sd = math.sqrt(mix["p_miss"] * (1 - mix["p_miss"]) / objects)
    assert abs(p_miss - mix["p_miss"]) < 5 * sd
    lam = mix["fp_per_frame"]
    assert abs(fps / (s * n) - lam) < 5 * math.sqrt(lam / (s * n))


def test_population_is_steady_through_rebirths():
    mix = dict(_mix(), lifetime=[5, 10])
    g = Scenes(mix, 2, 7, CPU, 8)
    pop = g.present.sum(1).clone()
    for _ in range(30):
        g.step()
    assert torch.equal(g.present.sum(1), pop)
    assert int(g.version.max()) >= 2


@pytest.mark.parametrize("versions", [0, 6])
def test_features_are_identity_plus_noise(versions):
    mix = _mix()
    g = Scenes(mix, 2, 99, CPU, 64, versions=versions)
    fr = g.step()
    real = fr.src >= 0
    slot = fr.src.clamp(min=0)
    if versions:
        scene = torch.arange(2)[:, None].expand_as(slot)
        want = g.identity[scene, slot, g.version.gather(1, slot)]
    else:
        want = g.identity.gather(1, slot[..., None].expand(-1, -1, 64))
    noise = (fr.feat - want)[real]
    assert float(noise.std()) == pytest.approx(mix["feature_noise"], rel=0.1)
    assert not fr.feat[fr.src == -2].any()


def test_recorded_sequences_make_their_features_again():
    mix = _mix()
    g = Scenes(mix, 2, 5, CPU, 32, versions=4)
    pool = record(g, 6)
    feat = g.sequence_features(1, pool["src"][:, 1], pool["version"][:, 1])
    real = pool["src"][:, 1] >= 0
    ident = g.identity[1, pool["src"][:, 1].clamp(min=0),
                       pool["version"][:, 1]]
    assert float((feat - ident)[real].abs().max()) < 10 * mix["feature_noise"]
