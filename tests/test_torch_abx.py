"""The port's machine ABX against the JAX package's, on the CPU."""

import json

import numpy as np
import pytest
import torch

from torch_port_util import module_time_limit, time_limit  # noqa: F401
from vectorquantizedcpc_tpu.eval import abx as jax_abx
from vectorquantizedcpc_tpu_torch.cli import eval_abx as cli
from vectorquantizedcpc_tpu_torch.eval import abx

torch.set_num_threads(1)
TIME_LIMIT_S = 60  # each test's own limit (torch_port_util.time_limit)


def _padded_pairs(rng, lens_a, lens_b, dim=4):
    a = np.zeros((len(lens_a), max(lens_a), dim), np.float32)
    b = np.zeros((len(lens_b), max(lens_b), dim), np.float32)
    for p, (la, lb) in enumerate(zip(lens_a, lens_b)):
        a[p, :la] = rng.normal(size=(la, dim))
        b[p, :lb] = rng.normal(size=(lb, dim))
    return a, b, np.array(lens_a), np.array(lens_b)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_batched_dtw_matches_jax(rng, metric):
    a, b, la, lb = _padded_pairs(rng, [5, 9, 1, 7, 12], [8, 3, 6, 7, 1])
    got = abx.batched_dtw(a, b, la, lb, metric, device="cpu")
    want = jax_abx.batched_dtw(a, b, la, lb, metric)
    assert got.shape == (5,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _items(rng, n_spk=3, n_utt=3):
    """Two categories as directions plus speaker offsets and noise."""
    feats, cats, spks = [], [], []
    for cat, base in (("aa", np.eye(4)[0]), ("ee", np.eye(4)[1])):
        for s in range(n_spk):
            off = 0.6 * rng.normal(size=4)
            for _ in range(n_utt):
                t = int(rng.integers(4, 9))
                feats.append((base + off + 0.4 * rng.normal(size=(t, 4))).astype(np.float32))
                cats.append(cat)
                spks.append(f"s{s}")
    return feats, cats, spks


@pytest.mark.parametrize("across", [True, False])
def test_abx_error_rate_equals_jax(rng, across):
    """The same features, items and seed give the same rate; a cell cap
    below the triple count exercises the seeded sampling."""
    feats, cats, spks = _items(rng)
    kw = dict(across=across, max_triples_per_cell=5, seed=3)
    got = abx.abx_error_rate(feats, cats, spks, device="cpu", **kw)
    assert got == jax_abx.abx_error_rate(feats, cats, spks, **kw)
    assert 0.0 <= got <= 1.0


def test_cli_items_round_trip(rng, tmp_path):
    feats, cats, spks = _items(rng, n_spk=2, n_utt=2)
    items = {}
    for i, (f, c, s) in enumerate(zip(feats, cats, spks)):
        np.savetxt(tmp_path / f"utt{i:03d}.txt", f, fmt="%.16f")
        items[f"utt{i:03d}"] = {"category": c, "speaker": s}
    items["missing"] = {"category": "aa", "speaker": "s0"}
    (tmp_path / "items.json").write_text(json.dumps(items))
    out = cli.main(["--features", str(tmp_path), "--items", str(tmp_path / "items.json"),
                    "--metric", "euclidean", "--platform", "cpu"])
    lf, lc, ls = jax_abx.load_feature_dir(str(tmp_path), str(tmp_path / "items.json"))
    assert out["abx_error_rate"] == round(jax_abx.abx_error_rate(lf, lc, ls, metric="euclidean"), 6)
    assert (out["task"], out["n_items"], out["n_categories"]) == ("across", len(feats), 2)


def test_cli_item_file_round_trip(rng, tmp_path):
    lines = ["#file onset offset #phone prev-phone next-phone speaker"]
    for spk in ("s01", "s02"):
        for ci, phone in enumerate(("x", "y")):
            for k in range(2):
                stem = f"{spk}_{ci}_{k}"
                base = np.zeros((20, 4)) + 2.0 * ci
                np.savetxt(tmp_path / f"{stem}.txt", base + 0.5 * rng.normal(size=(20, 4)))
                lines.append(f"{stem} 0.0 0.{2 + k} {phone} a b {spk}")
    lines.append("nofile 0.0 0.3 x a b s01")
    (tmp_path / "t.item").write_text("\n".join(lines) + "\n")
    out = cli.main(["--features", str(tmp_path), "--item-file", str(tmp_path / "t.item"),
                    "--within", "--platform", "cpu"])
    feats, cats, spks = abx.load_item_file(str(tmp_path / "t.item"), str(tmp_path))
    ref = jax_abx.load_item_file(str(tmp_path / "t.item"), str(tmp_path))
    assert cats == ref[1] and spks == ref[2]
    assert [f.shape for f in feats] == [f.shape for f in ref[0]] == [(10, 4), (15, 4)] * 4
    want = jax_abx.abx_error_rate(*ref, across=False)
    assert out["abx_error_rate"] == round(want, 6) and out["task"] == "within"
    assert (out["n_items"], out["n_categories"], out["n_speakers"]) == (8, 2, 2)


def test_abx_needs_a_card_unless_asked_for_the_cpu(rng, monkeypatch):
    a, b, la, lb = _padded_pairs(rng, [3], [4])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        abx.batched_dtw(a, b, la, lb)
