"""What the data-parallel trainers share across ranks: batch shares and sums.

The counterpart of the JAX package's ``parallel/sharding.py`` for the data
axis. JAX writes the step on the global batch and lets XLA insert the
collectives; here each rank runs the step on its share and the trainers
call these explicitly, so that every rank ends the step with the
parameters one process would hold after the step on the whole batch:

- ``shard_batch``: a rank's equal share of a global batch (the JAX
  package's ``batch_sharding`` on the data axis);
- ``FlatGrads``: every parameter's ``.grad`` a view of one flat buffer,
  with room after it for the step's metrics, summed by one ``all_reduce``
  a step and divided by the ranks: each rank's loss is a mean over an
  equal share, so the global mean's gradient is the ranks' mean. Both
  trainers take their gradients through it, with a group or without;
- ``all_reduce_sum``: the VQ-EMA statistics, summed before the EMA;
- ``agree``: one flag (the preemption request) agreed by every rank.

The JAX package's tensor-parallel rules (``_spec_for``, ``_divisible``:
the GRU gate axes, the FC outputs, the codebook's codes on the model axis)
are not ported yet.
"""

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import DataMesh


def local_share(n: int, world: int, what: str) -> int:
    """``n // world``, raising when ``n`` does not divide over the ranks."""
    if n % world:
        raise ValueError(f"{what}={n} does not divide over runtime.mesh_data={world} ranks")
    return n // world


def shard_batch(x, mesh: Optional[DataMesh], axis: int = 0):
    """This rank's rows ``[r n / W, (r + 1) n / W)`` of ``x`` along ``axis``
    (an array or a tensor); ``x`` itself for one process."""
    if mesh is None:
        return x
    n = local_share(x.shape[axis], mesh.world, f"the batch axis {axis}")
    index = [slice(None)] * x.ndim
    index[axis] = slice(mesh.rank * n, (mesh.rank + 1) * n)
    return x[tuple(index)]


def world_of(group: Optional["dist.ProcessGroup"]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_sum(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The ranks' sums of ``tensors`` (one dtype), by one ``all_reduce`` of
    their concatenation; same shapes as given."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset: offset + t.numel()].view(t.shape))
        offset += t.numel()
    return out


class FlatGrads:
    """``params``' gradients as views of one preallocated flat buffer, and
    ``n_metrics`` slots after them, reduced by one ``all_reduce`` a step.

    ``backward(loss, metrics)`` writes the gradients of ``loss`` and the
    step's ``metrics`` into the buffer by one ``torch.cat`` (so no
    ``.grad`` is accumulated into, nor the buffer zeroed), then sums it
    over the ranks and divides by their number; the metrics' means come
    back in one tensor. Without a group nothing is reduced, and with one
    rank nothing is divided, so both give the bits of one process's step.
    Nothing waits for the device: a CUDA graph can hold it under NCCL.
    """

    def __init__(self, params: Sequence[torch.nn.Parameter], n_metrics: int, group):
        dtypes = {p.dtype for p in params}
        if len(dtypes) != 1:
            raise ValueError(f"one flat gradient buffer needs one dtype, got {dtypes}")
        self.params = list(params)
        self.group = group
        self.world = world_of(group)
        self.n_params = sum(p.numel() for p in params)
        self.flat = torch.zeros(self.n_params + n_metrics, dtype=dtypes.pop(),
                                device=params[0].device)
        offset = 0
        for p in params:
            p.grad = self.flat[offset: offset + p.numel()].view_as(p)
            offset += p.numel()

    def backward(self, loss: torch.Tensor, metrics: Sequence[torch.Tensor]) -> torch.Tensor:
        """The gradients of ``loss`` into the parameters' ``.grad``, then
        every rank's gradients and ``metrics`` summed and divided by the
        ranks; returns the metrics' means, flattened into one tensor."""
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        parts = [(torch.zeros_like(p) if g is None else g).reshape(-1)
                 for g, p in zip(grads, self.params)]
        parts += [m.detach().reshape(-1).to(self.flat.dtype) for m in metrics]
        torch.cat(parts, out=self.flat)
        if self.group is not None:
            dist.all_reduce(self.flat, group=self.group)
            if self.world > 1:
                self.flat.div_(self.world)
        return self.flat[self.n_params:].clone()


def agree(flag: bool, mesh: Optional[DataMesh]) -> bool:
    """True on every rank when any rank's ``flag`` is (an ``all_reduce``
    of the max; it waits for the device)."""
    if mesh is None:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(t.item())
