"""The serving cells' shared parts: the server, its warm-up and the judge.

The server is the program's ``ContinuousBatcher`` over a vocoder drawn
from the seed, sampling as users do. The judge takes a sample of finished
requests (the longest among them) and, for each, works out from the
harness's weights and the request's codes and speaker what the decode
should have produced, with the plain reference (``portbench/reference``):

- each returned value must be the mu-law expansion of a class (to 1e-6);
  those classes are the served classes;
- the reference's logits before every served sample, teacher-forced on the
  served classes, plus the decode's specified Gumbel noise for that
  sample: the served class should be the best of those scores. Where the
  program's rounding moves a near tie, it is not, by a gap as wide as the
  rounding: ``logit_gap_max``, the widest such gap over every judged
  sample, is the number judged (the share of samples that flipped is
  printed beside it). The noise is fixed by (the server's seed, the global
  segment, the slot, the step, the class); the slot and the first segment
  of a request are found among those the driver allows by the smallest
  gaps over its first 256 samples (any other pair puts the served class at
  random among 256).
"""

import heapq
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..reference import strict_float32
from ..reference import noise as ref_noise
from ..reference import vocoder as ref_voc
from .harness import Check
from .program import port_conf, seeded_vocoder

SEARCH_SAMPLES = 256
MULAW_TOL = 1e-6


def build_server(run, slots: int, precision: str, max_frames: int):
    """(server, vocoder state, server seed, conf) for the run."""
    from vectorquantizedcpc_tpu_torch.infer.serving import ContinuousBatcher

    conf = port_conf(run.config)
    vocoder, state = seeded_vocoder(conf, run.seed, run.device)
    server_seed = run.seed & 0xFFFFFFFF
    server = ContinuousBatcher(vocoder, slots=slots,
                               segment_frames=run.traffic["server"]["segment_frames"],
                               max_frames=max_frames, precision=precision, greedy=False,
                               seed=server_seed, device=run.device)
    return server, state, server_seed, conf


def planned_starts(frames: Sequence[int], slots: int, segment_frames: int) -> List[int]:
    """The first segment of each request (by its index) in one planned drain
    of an empty server, worked out again: longest first (ties in submission
    order), each into the slot that frees first (ties to the lower slot)."""
    ends = [(0, s) for s in range(slots)]
    heapq.heapify(ends)
    start = [0] * len(frames)
    for i in sorted(range(len(frames)), key=lambda i: -frames[i]):
        t0, s = heapq.heappop(ends)
        start[i] = t0
        heapq.heappush(ends, (t0 + -(-frames[i] // segment_frames), s))
    return start


def sample_requests(done: Sequence[int], lengths: Dict[int, int], seed: int,
                    count: int) -> List[int]:
    """``count`` finished requests drawn from the seed, the longest among them."""
    done = sorted(done)
    if not done:
        return []
    longest = max(done, key=lambda r: (lengths[r], -r))
    rest = [r for r in done if r != longest]
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(rest), size=min(count - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[i] for i in sorted(pick)]


def _classes_of(wave: np.ndarray, table: torch.Tensor, device) -> Tuple[torch.Tensor, int]:
    x = torch.from_numpy(np.ascontiguousarray(wave, np.float32)).to(device)
    idx = torch.bucketize(x, table).clamp(1, table.numel() - 1)
    lo, hi = table[idx - 1], table[idx]
    idx = torch.where((x - lo).abs() <= (hi - x).abs(), idx - 1, idx)
    off = int(((x - table[idx]).abs() > MULAW_TOL).sum())
    return idx, off


def _scores(logits: torch.Tensor, launch_seed: int, steps: torch.Tensor, row: int,
            n_classes: int) -> torch.Tensor:
    rows = torch.full_like(steps, row)
    return logits + ref_noise.gumbel(launch_seed, steps, rows, n_classes)


def _gaps(scores: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    return scores.max(dim=-1).values - scores.gather(-1, served[:, None])[:, 0]


def _locate(logits, served, server_seed, k0_range, slots, seg_samples, n_classes):
    """(row, first segment) of a request: the pair whose noise makes the
    first samples' served classes the best scores."""
    m = min(SEARCH_SAMPLES, served.shape[0], seg_samples)
    steps = torch.arange(m, device=served.device)
    best = None
    for k0 in range(k0_range[0], k0_range[1] + 1):
        launch = ref_noise.segment_seed(server_seed, k0)
        st = steps.repeat(slots)
        rows = torch.arange(slots, device=served.device).repeat_interleave(m)
        g = ref_noise.gumbel(launch, st, rows, n_classes).view(slots, m, n_classes)
        sc = logits[None, :m] + g
        gap = (sc.max(-1).values - sc.gather(-1, served[None, :m, None].expand(slots, m, 1))[
            ..., 0]).sum(-1)
        val, row = gap.min(0)
        if best is None or float(val) < best[0]:
            best = (float(val), int(row), k0)
    return best[1], best[2]


@torch.no_grad()
def judge(state: Dict[str, torch.Tensor], items: List[dict], server_seed: int, slots: int,
          hop: int, segment_frames: int, device, mm=ref_voc.f32_mm) -> Tuple[List[Check], str]:
    """(The serving checks over ``items``, a note): dicts of codes, speaker,
    wave and ``k0_range`` (the global segments where the request may have
    started)."""
    strict_float32()
    state = {k: v.to(device) for k, v in state.items()}
    n_classes = state["rnnms.fc2.weight"].shape[0]
    table = ref_voc.mulaw_table(n_classes, device)
    seg_samples = segment_frames * hop
    length_off, mulaw_off, widest, flips, judged = 0, 0, 0.0, 0, 0
    if not items:
        return [Check("sampled_requests", 0, -1)], "no request to judge"
    tz = max(len(it["codes"]) for it in items)
    codes = torch.zeros(len(items), tz, dtype=torch.long, device=device)
    for i, it in enumerate(items):
        codes[i, :len(it["codes"])] = torch.from_numpy(it["codes"]).to(device)
    n_codes = torch.tensor([len(it["codes"]) for it in items], device=device)
    speakers = torch.tensor([it["speaker"] for it in items], device=device)
    cond = ref_voc.conditioning(state, codes, speakers, n_codes, mm)
    served = torch.zeros(len(items), 2 * tz * hop, dtype=torch.long, device=device)
    for i, it in enumerate(items):
        n = 2 * len(it["codes"]) * hop
        if len(it["wave"]) != n:
            length_off += 1
        idx, off = _classes_of(it["wave"][:n], table, device)
        mulaw_off += off
        served[i, :idx.numel()] = idx
    logits = ref_voc.served_logits(state, cond, served, hop, mm=mm)
    for i, it in enumerate(items):
        n = min(len(it["wave"]), 2 * len(it["codes"]) * hop)
        row, k0 = _locate(logits[i, :n], served[i, :n], server_seed, it["k0_range"], slots,
                          seg_samples, n_classes)
        for j, s0 in enumerate(range(0, n, seg_samples)):
            steps = torch.arange(s0, min(n, s0 + seg_samples), device=device)
            sc = _scores(logits[i, steps], ref_noise.segment_seed(server_seed, k0 + j),
                         steps - s0, row, n_classes)
            gaps = _gaps(sc, served[i, steps])
            widest = max(widest, float(gaps.max()))
            flips += int((gaps > 0).sum())
            judged += steps.numel()
    checks = [Check("logit_gap_max", widest, float("nan")),
              Check("mulaw_off", mulaw_off, 0), Check("length_off", length_off, 0)]
    return checks, (f"{judged} samples judged, {flips} flipped "
                    f"({1e6 * flips / max(judged, 1):.3f} per million)")
