"""The training cells' shared parts: the program's readings and the judge.

The judge compares two stages of the one trainer that the window drives,
each against the plain reference, through the window's own call and feed:

- set-up: the first three steps from the seed (the first two run eagerly
  and the third is captured into the step graph: the trainer's own
  warm-up);
- the window's path: once the window has closed, the trainer's state
  (parameters, Adam's moments and step count) is read, and two more steps
  replay the step graph on the next batches of the same feed, as every
  step of the window did.

For each stage the harness keeps each step's loss, as the step returned
it; the first gradient as the optimizer got it, from Adam's first moment
before and after the stage's first step (m1 = b1 m0 + (1 - b1) g, so g =
(m1 - b1 m0) / (1 - b1); m0 is 0 at set-up); and each parameter after the
stage's last step. The reference follows the same steps from the same
state (the seed's weights and a fresh Adam; the state read after the
window) on batches it draws again from the feature files, and the judge
compares, by the worst leaf, the gap between the program's norm and the
reference's (of the first gradient, and of each leaf's change over the
stage), against the reference's norm of that leaf or of the median leaf,
whichever is larger. A leaf whose reference gradient is under a thousandth
of the median leaf's moves by round-off alone and is left out of the
change.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .harness import Check

BETA1 = 0.9
SMALL_GRAD = 1e-3


def first_gradient(optimizer, named_params: Dict[str, torch.Tensor],
                   before: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """The gradient of the step just taken as Adam received it, from its
    first moment now and ``before`` the step (zero at the first step)."""
    out = {}
    for name, p in named_params.items():
        m = optimizer.state.get(p, {}).get("exp_avg")
        m = torch.zeros_like(p).cpu() if m is None else m.detach().float().cpu()
        if before is not None:
            m = m - BETA1 * before[name]
        out[name] = m / (1 - BETA1)
    return out


def optimizer_state(optimizer, named_params: Dict[str, torch.Tensor]) -> dict:
    """The parameters and Adam's state on the host: {"params", "exp_avg",
    "exp_avg_sq": {name: float32 tensor}, "step": the count of steps} (zero
    moments and count where Adam has no state)."""
    out = {"params": {}, "exp_avg": {}, "exp_avg_sq": {}}
    steps = set()
    for name, p in named_params.items():
        st = optimizer.state.get(p, {})  # empty where no step reached Adam
        out["params"][name] = p.detach().float().cpu().clone()
        for key in ("exp_avg", "exp_avg_sq"):
            out[key][name] = st[key].detach().float().cpu().clone() if key in st else \
                torch.zeros_like(out["params"][name])
        steps.add(float(st.get("step", 0)))
    out["step"] = steps.pop() if len(steps) == 1 else float("nan")
    return out


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   leaves: Sequence[str]) -> Tuple[float, str]:
    """(the largest gap, its leaf)."""
    median = float(np.median([ref[k] for k in leaves])) if leaves else 0.0
    gaps = [(abs(prog[k] - ref[k]) / max(ref[k], median), k) for k in leaves
            if max(ref[k], median) > 0]
    return max(gaps) if gaps else (float("inf"), "none")


def judge(losses: List[float], grads: Dict[str, torch.Tensor], after: Dict[str, torch.Tensor],
          ref_losses: List[float], ref_grads: Dict[str, torch.Tensor],
          ref_after: Dict[str, torch.Tensor], start: Dict[str, torch.Tensor], prefix: str = ""
          ) -> Tuple[List[Check], str]:
    """(loss_gap, grad_gap and change_gap, each name after ``prefix``, with
    their limits unset; the worst leaves)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    if len(losses) != len(ref_losses) or not all(np.isfinite(losses)):
        loss_gap = float("inf")
    g_ref = norms(ref_grads)
    g_prog = norms({k: grads[k] for k in ref_grads})
    grad_gap, grad_leaf = worst_leaf_gap(g_prog, g_ref, list(g_ref))
    median_g = float(np.median(list(g_ref.values())))
    moved = [k for k in ref_after if k not in g_ref or g_ref[k] >= SMALL_GRAD * median_g]
    d_ref = norms({k: ref_after[k].cpu() - start[k].cpu() for k in moved})
    d_prog = norms({k: after[k].cpu() - start[k].cpu() for k in moved})
    change_gap, change_leaf = worst_leaf_gap(d_prog, d_ref, moved)
    return ([Check(prefix + "loss_gap", loss_gap, float("nan")),
             Check(prefix + "grad_gap", grad_gap, float("nan")),
             Check(prefix + "change_gap", change_gap, float("nan"))],
            f"{prefix}worst leaves: gradient {grad_leaf}, change {change_leaf}")


def feed_check(program_batches: List[Sequence[np.ndarray]],
               ref_batches: List[Sequence[np.ndarray]], name: str = "feed_off") -> Check:
    """Elements of the staged batches that differ from the reference's draws."""
    off = 0
    for pb, rb in zip(program_batches, ref_batches):
        for p, r in zip(pb, rb):
            p, r = np.asarray(p), np.asarray(r)
            off += p.size if p.shape != r.shape else int((p != r).sum())
    return Check(name, off, 0)
