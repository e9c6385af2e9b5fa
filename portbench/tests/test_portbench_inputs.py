"""Traffic and inputs repeat exactly from a seed, and change with it."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.lib import inputs
from portbench.reference import feed

ROOT = Path(__file__).resolve().parents[2]
SERVING = ["zr19-en.serve-open", "jvs-ja.serve-batch"]


def _traffic(cell):
    return json.loads((ROOT / "portbench" / "traffic" / f"{cell}.json").read_text())


def _requests(cell, seed, n=64):
    t = _traffic(cell)
    gaps = inputs.poisson_gaps(t, n) if "arrivals" in t else None
    return inputs.make_requests(t, 512, 100, seed, n, gaps)


@pytest.mark.parametrize("cell", SERVING)
def test_requests_repeat_from_a_seed(cell):
    a, b = _requests(cell, 3_000_000_123), _requests(cell, 3_000_000_123)
    for x, y in zip(a, b):
        assert np.array_equal(x["codes"], y["codes"])
        assert (x["speaker"], x["due"]) == (y["speaker"], y["due"])


@pytest.mark.parametrize("cell", SERVING)
def test_requests_change_with_the_seed_but_not_their_sizes(cell):
    a, b = _requests(cell, 11), _requests(cell, 12)
    assert any(not np.array_equal(x["codes"][:5], y["codes"][:5]) for x, y in zip(a, b))
    assert sorted(len(x["codes"]) for x in a) == sorted(len(y["codes"]) for y in b)
    fixed = _traffic(cell).get("order") == "fixed"
    assert ([len(x["codes"]) for x in a] == [len(y["codes"]) for y in b]) == fixed
    if "arrivals" in _traffic(cell):
        assert ([x["due"] for x in a] == [y["due"] for y in b]) == fixed
        assert abs(a[-1]["due"] - b[-1]["due"]) < 1e-9  # the same gaps


@pytest.mark.parametrize("cell", SERVING)
def test_lengths_keep_to_the_traffic(cell):
    t = _traffic(cell)["lengths"]
    n = inputs.request_lengths(_traffic(cell), 4096) / t["codes_per_s"]
    assert n.min() >= t["min_s"] - 0.01 and n.max() <= t["max_s"] + 0.01
    assert abs(np.median(n) - t["median_s"]) < 0.1 * t["median_s"]


def test_sub_seeds_take_large_seeds():
    a = inputs.sub_seed(2**31 + 17, "x")
    assert a == inputs.sub_seed(2**31 + 17, "x") != inputs.sub_seed(2**31 + 18, "x")
    assert 0 <= a < 2**63


def test_weights_repeat_from_a_seed():
    def draw(seed):
        m = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.LayerNorm(3),
                                torch.nn.GRU(3, 5), torch.nn.Embedding(7, 2))
        return inputs.fill_from_seed(m, seed)

    a, b, c = draw(5), draw(5), draw(6)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["0.weight"], c["0.weight"])
    assert torch.equal(a["1.weight"], torch.ones(3)) and torch.equal(a["1.bias"], torch.zeros(3))
    assert a["2.weight_hh_l0"].abs().max() <= 1 / 5 ** 0.5


def test_features_repeat_and_are_drawn_again_by_the_reference(tmp_path):
    corpus = {"n_speakers": 3, "speaker_prefix": "s", "utterances_per_speaker": 2,
              "utterance_seconds": [0.5, 0.7]}
    a = inputs.write_features(tmp_path / "a", corpus, 9, 8, 800, 4, mulaw=True)
    b = inputs.write_features(tmp_path / "b", corpus, 9, 8, 800, 4, mulaw=True)
    assert a == b
    fa, fb = feed.Features(tmp_path / "a"), feed.Features(tmp_path / "b")
    for pos in range(len(fa.utts)):
        assert np.array_equal(fa.load(pos, "mel"), fb.load(pos, "mel"))
    x = feed.vocoder_batch(fa, 4, 1, 0, 2, 4, 8)
    y = feed.vocoder_batch(fb, 4, 1, 0, 2, 4, 8)
    assert all(np.array_equal(p, q) for p, q in zip(x, y))
    assert x[0].shape == (2, 33) and x[1].shape == (2, 4, 4)
