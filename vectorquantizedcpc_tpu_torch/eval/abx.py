"""Machine-ABX discriminability over latent dumps, with a batched DTW on the device.

The counterpart of the JAX package's ``eval/abx.py``:

- **DTW** between two feature sequences with per-frame cosine (or
  euclidean) distance, normalized by the optimal path's length (the ABXpy
  convention);
- **batched**: the per-frame distance matrices of P pairs are one batched
  matmul, and the dynamic program walks the N + M - 1 anti-diagonal
  wavefronts as a loop of tensor operations over (pair, wavefront), as the
  JAX package's ``lax.scan`` does;
- **ABX score**: for a triple (A, B, X) with category(A) = category(X) and
  category(B) != category(X), X is right when DTW(X, A) < DTW(X, B).
  Across speakers, A and B share a speaker and X is another; within, all
  three share one. Triples are sampled with numpy's generator from ``seed``
  and averaged hierarchically (triples -> (speaker, category pair) cells ->
  symmetrized category pairs -> mean), as in the JAX package.
"""

import itertools
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "batched_dtw", "pairwise_dtw", "abx_error_rate", "load_feature_dir", "load_item_file",
]

BIG = 1e30  # the cost of an unreachable cell


def _frame_costs(a: torch.Tensor, b: torch.Tensor, metric: str) -> torch.Tensor:
    """(P, N, D), (P, M, D) -> per-frame distances (P, N, M)."""
    if metric == "cosine":
        an = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True), min=1e-12)
        bn = b / torch.clamp(torch.linalg.vector_norm(b, dim=-1, keepdim=True), min=1e-12)
        return 1.0 - torch.bmm(an, bn.transpose(1, 2))
    if metric == "euclidean":
        sq = (
            (a * a).sum(-1)[:, :, None]
            + (b * b).sum(-1)[:, None, :]
            - 2.0 * torch.bmm(a, b.transpose(1, 2))
        )
        return torch.sqrt(torch.clamp(sq, min=0.0))
    raise ValueError(f"unknown metric {metric!r} (cosine|euclidean)")


def _dtw_wavefront(costs: torch.Tensor, len_a: torch.Tensor, len_b: torch.Tensor) -> torch.Tensor:
    """Path-length-normalized DTW over padded cost matrices (P, N, M).

    Cell (i, j) on anti-diagonal k = i + j depends on diagonals k - 1 and
    k - 2 only, so the carry is two (P, N) wavefronts indexed by i and each
    of the N + M - 1 steps is one vectorized (P, N) update. Cells outside
    [len_a[p], len_b[p]) are masked. Returns (P,) float32.
    """
    p, n, m = costs.shape
    dev = costs.device
    ar = torch.arange(n, device=dev)[None, :]  # (1, N)
    k_final = (len_a + len_b - 2)[:, None]
    i_final = (len_a - 1)[:, None]
    big = torch.full((p, 1), BIG, device=dev)
    zero = torch.zeros((p, 1), dtype=torch.int32, device=dev)

    def shift_i(x, fill):  # x at wavefront index i - 1
        return torch.cat([fill, x[:, :-1]], dim=1)

    d_pp = torch.full((p, n), BIG, device=dev)
    d_p = d_pp.clone()
    l_pp = torch.zeros((p, n), dtype=torch.int32, device=dev)
    l_p = l_pp.clone()
    ans = torch.full((p, 1), BIG, device=dev)
    ans_l = torch.ones((p, 1), dtype=torch.int32, device=dev)
    for k in range(n + m - 1):
        j = k - ar  # (1, N)
        c_k = torch.gather(costs, 2, j.clamp(0, m - 1)[:, :, None].expand(p, n, 1))[..., 0]
        valid = (ar <= torch.clamp(len_a[:, None] - 1, max=k)) & (j >= 0) & (j <= len_b[:, None] - 1)
        up = torch.where(j >= 1, d_p, BIG)  # (i, j - 1): index i of k - 1
        left = torch.where(ar >= 1, shift_i(d_p, big), BIG)  # (i - 1, j): index i - 1 of k - 1
        diag = torch.where((ar >= 1) & (j >= 1), shift_i(d_pp, big), BIG)  # (i - 1, j - 1)
        best = torch.minimum(torch.minimum(up, left), diag)
        best_l = torch.where(
            best == diag, shift_i(l_pp, zero), torch.where(best == up, l_p, shift_i(l_p, zero))
        )
        origin = (ar == 0) & (j == 0)
        best = torch.where(origin, 0.0, best)
        best_l = torch.where(origin, 0, best_l)
        d_k = torch.where(valid, c_k + best, BIG)
        l_k = torch.where(valid, best_l + 1, 0)
        hit = k_final == k
        ans = torch.where(hit, torch.gather(d_k, 1, i_final), ans)
        ans_l = torch.where(hit, torch.gather(l_k, 1, i_final), ans_l)
        d_pp, l_pp, d_p, l_p = d_p, l_p, d_k, l_k
    return (ans / torch.clamp(ans_l, min=1))[:, 0]


@torch.no_grad()
def batched_dtw(
    feats_a,
    feats_b,
    len_a,
    len_b,
    metric: str = "cosine",
    device: Optional[Union[str, torch.device]] = None,
) -> np.ndarray:
    """DTW distances of P aligned pairs of padded sequences, (P,) float32.

    feats_a (P, N, D), feats_b (P, M, D), len_* (P,) valid lengths. Runs on
    ``device``, else on the CUDA card; raises without a card unless
    ``device="cpu"``.
    """
    dev = resolve_device(device)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    i64 = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=dev)
    costs = _frame_costs(f32(feats_a), f32(feats_b), metric)
    return _dtw_wavefront(costs, i64(len_a), i64(len_b)).cpu().numpy()


def pairwise_dtw(
    features: Sequence[np.ndarray],
    metric: str = "cosine",
    chunk: int = 256,
    device: Optional[Union[str, torch.device]] = None,
) -> np.ndarray:
    """The symmetric DTW distance matrix (U, U) float64 of a set of sequences,
    padded to the longest and batched ``chunk`` pairs at a time."""
    u = len(features)
    lens = np.array([f.shape[0] for f in features], np.int32)
    padded = np.zeros((u, int(lens.max()), features[0].shape[1]), np.float32)
    for i, f in enumerate(features):
        padded[i, : f.shape[0]] = f
    ii, jj = np.triu_indices(u, k=1)
    dist = np.zeros((u, u), np.float64)
    for s in range(0, len(ii), chunk):
        a_idx, b_idx = ii[s : s + chunk], jj[s : s + chunk]
        d = batched_dtw(padded[a_idx], padded[b_idx], lens[a_idx], lens[b_idx], metric, device)
        dist[a_idx, b_idx] = d
        dist[b_idx, a_idx] = d
    return dist


def abx_error_rate(
    features: Sequence[np.ndarray],
    categories: Sequence[str],
    speakers: Sequence[str],
    across: bool = True,
    metric: str = "cosine",
    max_triples_per_cell: int = 512,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> float:
    """Hierarchically averaged ABX error rate in [0, 1] (0 = perfect).

    across=True: A and B share a speaker, X is another (the ZeroSpeech
    across-speaker task); across=False: all three share one.
    """
    cats = np.asarray(categories)
    spks = np.asarray(speakers)
    dist = pairwise_dtw(features, metric=metric, device=device)
    rng = np.random.default_rng(seed)

    by: Dict[Tuple[str, str], List[int]] = {}
    for idx, (c, s) in enumerate(zip(cats, spks)):
        by.setdefault((c, s), []).append(idx)
    uniq_cats = sorted(set(cats))
    uniq_spks = sorted(set(spks))
    pair_scores: Dict[Tuple[str, str], List[float]] = {}
    for ca, cb in itertools.permutations(uniq_cats, 2):
        for s_ab in uniq_spks:
            a_pool = by.get((ca, s_ab), [])
            b_pool = by.get((cb, s_ab), [])
            if not a_pool or not b_pool:
                continue
            for s_x in [s for s in uniq_spks if s != s_ab] if across else [s_ab]:
                x_pool = by.get((ca, s_x), [])
                triples = [
                    (a, b, x)
                    for a in a_pool
                    for b in b_pool
                    for x in x_pool
                    if x != a and x != b and a != b
                ]
                if not triples:
                    continue
                if len(triples) > max_triples_per_cell:
                    sel = rng.choice(len(triples), max_triples_per_cell, replace=False)
                    triples = [triples[i] for i in sel]
                t = np.array(triples)
                dxa = dist[t[:, 2], t[:, 0]]
                dxb = dist[t[:, 2], t[:, 1]]
                correct = np.where(dxa < dxb, 1.0, np.where(dxa == dxb, 0.5, 0.0))
                pair_scores.setdefault((ca, cb), []).append(float(correct.mean()))
    if not pair_scores:
        raise ValueError("no valid ABX triples (check categories/speakers)")

    # Symmetrize (ca, cb) / (cb, ca), then average over category pairs.
    sym: Dict[Tuple[str, str], List[float]] = {}
    for (ca, cb), scores in pair_scores.items():
        sym.setdefault((min(ca, cb), max(ca, cb)), []).append(float(np.mean(scores)))
    return 1.0 - float(np.mean([np.mean(v) for v in sym.values()]))


def load_item_file(
    item_path: str,
    feature_dir: str,
    frame_period: float = 0.02,
    min_frames: int = 2,
) -> Tuple[List[np.ndarray], List[str], List[str]]:
    """A ZeroSpeech/bootphon ``.item`` file -> (features, categories, speakers).

    A header line, then one item per row::

        #file onset offset #phone prev-phone next-phone speaker
        s2801a 0.3825 0.5825 n ay l s2801a

    Each item is the latent frames of ``<file>.txt`` within [onset, offset)
    (``frame_period`` seconds per frame: a 10 ms mel hop halved by the conv),
    its category the (prev, phone, next) triphone, its speaker the last
    column. Items shorter than ``min_frames`` or without a feature file are
    skipped.
    """
    feats: List[np.ndarray] = []
    cats: List[str] = []
    spks: List[str] = []
    cache: Dict[str, Optional[np.ndarray]] = {}
    root = Path(feature_dir)
    with open(item_path) as f:
        lines = [line.strip() for line in f if line.strip()]
    if lines and lines[0].startswith("#"):
        lines = lines[1:]
    for line in lines:
        parts = line.split()
        if len(parts) != 7:
            raise ValueError(f"malformed .item line (want 7 columns): {line!r}")
        fname, onset, offset, phone, prev, nxt, speaker = parts
        if fname not in cache:
            path = root / f"{fname}.txt"
            cache[fname] = np.loadtxt(path, dtype=np.float32, ndmin=2) if path.exists() else None
        arr = cache[fname]
        if arr is None:
            continue
        lo = int(round(float(onset) / frame_period))
        hi = int(round(float(offset) / frame_period))
        seg = arr[max(lo, 0) : min(hi, arr.shape[0])]
        if seg.shape[0] < min_frames:
            continue
        feats.append(seg)
        cats.append(f"{prev}-{phone}-{nxt}")
        spks.append(speaker)
    if not feats:
        raise FileNotFoundError(f"no usable items from {item_path} with features in {feature_dir}")
    return feats, cats, spks


def load_feature_dir(
    feature_dir: str, items_json: str
) -> Tuple[List[np.ndarray], List[str], List[str]]:
    """``<stem>.txt`` dumps plus an items JSON
    ``{"<stem>": {"category": ..., "speaker": ...}}``; stems without a file
    are skipped."""
    with open(items_json) as f:
        items = json.load(f)
    feats, cats, spks = [], [], []
    for stem, meta in sorted(items.items()):
        path = Path(feature_dir) / f"{stem}.txt"
        if not path.exists():
            continue
        feats.append(np.loadtxt(path, dtype=np.float32, ndmin=2))
        cats.append(str(meta["category"]))
        spks.append(str(meta["speaker"]))
    if not feats:
        raise FileNotFoundError(f"no feature files from {items_json} found under {feature_dir}")
    return feats, cats, spks
