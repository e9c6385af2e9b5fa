"""Tensor parallelism on the model axis: sharding rules and the products' collectives.

The counterpart of the JAX package's ``parallel/sharding.py`` rules
(``_spec_for``, ``_divisible``) on the port's tensors. JAX gives every
leaf of a train state a NamedSharding and lets XLA insert the
collectives; here each of a model group's M ranks holds its shards as its
modules' own parameters and buffers (``shard_module_``), and the models
call the collectives of each partitioned product themselves:

- ``shard_dim(name, shape, size)``: the torch dim of a reference
  ``state_dict`` tensor that the model axis splits, or None (replicated).
  Torch keeps weights as (out, in), so JAX's last axis is dim 0. A dim
  that M does not divide is replicated, as ``_divisible`` does;
- ``shard_module_`` cuts a module's full tensors to this rank's contiguous
  slices and marks them (``model_dim``); ``shard_tensor`` slices a full
  tensor of a checkpoint the same way; ``gather_tensor`` undoes it over the
  model group;
- ``copy_to_model`` (forward identity, backward ``all_reduce``),
  ``reduce_from_model`` (forward ``all_reduce``, backward identity) and
  ``gather_from_model`` (forward ``all_gather`` along a dim, backward this
  rank's slice): Megatron's conjugate pair and a gather. A column-parallel
  product reads ``copy_to_model(x)`` (each rank's input gradient is a
  partial sum) and gathers its output; a row-parallel one sums its
  partial output with ``reduce_from_model``.

Nothing here waits for the device, so a CUDA graph holds the collectives
under NCCL. They are ``all_reduce`` and ``all_gather`` (into one buffer
under NCCL, into a list under gloo, which serves that form for CUDA
tensors too).
"""

import re
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist


class ModelGroup(NamedTuple):
    """This rank's model group: its ``rank`` of ``size`` and their process group."""

    group: "dist.ProcessGroup"
    rank: int
    size: int


# The Encoder's output Linear in its Sequential: LN, ReLU, then 4 blocks of
# (Linear, LN, ReLU) (models/encoder.py), so index 2 + 3 x 4.
ENCODER_OUT = 14
_CODEBOOK = re.compile(r"(^|\.)codebook\.(embedding|ema_count|ema_weight)$")
_CONV = re.compile(r"(^|\.)conv\.weight$")
_SEGFC = re.compile(r"(^|\.)encoder\.(\d+)\.weight$")
_RNN = re.compile(r"(^|\.)(rnn|prenet)\.(weight_ih|weight_hh|bias_ih|bias_hh)_l\d+(_reverse)?$")
_FC = re.compile(r"(^|\.)fc[12]\.(weight|bias)$")


def spec_dim(name: str, ndim: int) -> Optional[int]:
    """The torch dim JAX's ``_spec_for`` puts on the model axis, before
    divisibility: the codebook's codes; the conv's output channels; the
    SegFC Linears' outputs and the output projection's contracting axis;
    the LSTM's and GRUs' gate axis, biases included; the vocoder FCs'
    outputs. Everything else (LayerNorms, the projection's bias, the CPC
    predictors, the embeddings) is replicated."""
    if ndim == 0:
        return None
    if _CODEBOOK.search(name) or _CONV.search(name) or _RNN.search(name) or _FC.search(name):
        return 0
    segfc = _SEGFC.search(name)
    if segfc and ndim == 2:
        return 1 if int(segfc.group(2)) == ENCODER_OUT else 0
    return None


def shard_dim(name: str, shape: Sequence[int], size: int) -> Optional[int]:
    """``spec_dim``, replicated where ``size`` does not divide the dim."""
    dim = spec_dim(name, len(shape))
    return dim if dim is not None and shape[dim] % size == 0 else None


def model_dim(t: torch.Tensor) -> Optional[int]:
    """The dim of ``t`` that ``shard_module_`` split over the model group, or None."""
    return getattr(t, "model_dim", None)


def split_on(model: Optional[ModelGroup], t: torch.Tensor, dim: int = 0) -> Optional[ModelGroup]:
    """``model`` where ``t`` holds this rank's slice along ``dim``, else None."""
    return model if model is not None and model_dim(t) == dim else None


def shard_tensor(t: torch.Tensor, dim: Optional[int], model: ModelGroup) -> torch.Tensor:
    """This rank's contiguous slice of the full ``t`` along ``dim`` (all of
    it for None), as a tensor of its own."""
    if dim is None:
        return t
    n = t.shape[dim] // model.size
    return t.narrow(dim, model.rank * n, n).contiguous().clone()


def shard_module_(module: torch.nn.Module, model: ModelGroup, prefix: str = "") -> dict:
    """Cut ``module``'s parameters and buffers, in place, to this rank's
    slices by ``shard_dim`` of their names (``prefix`` + the state_dict
    name), and mark each cut tensor's ``model_dim``. Call it after the
    module is on its device (``Module.to`` replaces buffers) and before
    an optimizer sees the parameters. Returns {name: dim} of the cut ones."""
    dims = {}
    for name, t in module.state_dict(keep_vars=True).items():
        dim = shard_dim(prefix + name, t.shape, model.size)
        if dim is None:
            continue
        with torch.no_grad():
            t.data = shard_tensor(t.data, dim, model)
        t.model_dim = dim
        dims[name] = dim
    return dims


def shard_state(state: dict, dims: dict, model: ModelGroup) -> dict:
    """A full state_dict's tensors cut to this rank's slices where ``dims``
    ({name: dim}, ``shard_module_``'s) names them."""
    return {k: shard_tensor(v, dims.get(k), model) for k, v in state.items()}


def _all_gather(x: torch.Tensor, model: ModelGroup, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``: NCCL gathers into one
    buffer, gloo into a list (the form it serves for CUDA tensors too)."""
    x = x.contiguous()
    if dist.get_backend(model.group) == "nccl":
        flat = torch.empty((model.size,) + x.shape, dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(flat, x, group=model.group)
        parts = flat.unbind(0)
    else:
        parts = [torch.empty_like(x) for _ in range(model.size)]
        dist.all_gather(parts, x, group=model.group)
    return torch.cat(parts, dim=dim)


def gather_tensor(t: torch.Tensor, dim: Optional[int],
                  model: Optional[ModelGroup]) -> torch.Tensor:
    """The full tensor of every rank's ``t`` along ``dim`` (``t`` detached
    for None), outside autograd."""
    if dim is None:
        return t.detach()
    with torch.no_grad():
        return _all_gather(t.detach(), model, dim)


def all_reduce_model(x: torch.Tensor, model: ModelGroup, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The model group's ``op`` of ``x`` (a new tensor), outside autograd."""
    x = x.detach().clone()
    dist.all_reduce(x, op=op, group=model.group)
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, model):
        ctx.model = model
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.model.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, model):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=model.group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, model, dim):
        ctx.model, ctx.dim, ctx.n = model, dim, x.shape[dim]
        return _all_gather(x, model, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.model.rank * ctx.n, ctx.n).contiguous(), None, None


def copy_to_model(x: torch.Tensor, model: ModelGroup) -> torch.Tensor:
    """``x``, whose gradient is summed over the model group: the input of a
    column-parallel product, replicated on every rank."""
    return _CopyToModel.apply(x, model)


def reduce_from_model(x: torch.Tensor, model: ModelGroup) -> torch.Tensor:
    """The model group's sum of the partial products ``x``: the output of a
    row-parallel product; its gradient reaches every rank whole."""
    return _ReduceFromModel.apply(x, model)


def gather_from_model(x: torch.Tensor, model: ModelGroup, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (the full
    output of a column-parallel product); its gradient is this rank's slice."""
    return _GatherFromModel.apply(x, model, dim % x.dim())


def column_product(x: torch.Tensor, w: torch.Tensor, product, model: Optional[ModelGroup]):
    """``product(x, w)`` of ``x`` (..., K) and ``w`` (K, N) whose ``w`` may
    be a column shard (``model_dim`` of its parameter 0, ``w`` given as its
    transpose): then ``x`` is copied to the model group and the rank's
    columns gathered along the last dim."""
    if model is None:
        return product(x, w)
    return gather_from_model(product(copy_to_model(x, model), w), model)


class _VocabParallelCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, target, model):
        n_local = logits.shape[-1]
        first = model.rank * n_local
        row_max = all_reduce_model(logits.max(dim=-1).values, model, dist.ReduceOp.MAX)
        exp = (logits - row_max[:, None]).exp()
        mine = (target >= first) & (target < first + n_local)
        local = (target - first).clamp(0, n_local - 1)
        picked = (logits.gather(1, local[:, None])[:, 0] - row_max) * mine
        sums = all_reduce_model(torch.stack([exp.sum(dim=-1), picked]), model)
        ctx.save_for_backward(exp / sums[0][:, None], local, mine)
        return (sums[0].log() - sums[1]).mean()

    @staticmethod
    def backward(ctx, grad):
        softmax, local, mine = ctx.saved_tensors
        d = softmax.clone()
        d.scatter_add_(1, local[:, None], -mine[:, None].to(d.dtype))
        return d * (grad / d.shape[0]), None, None


def vocab_parallel_cross_entropy(
    logits: torch.Tensor, target: torch.Tensor, model: ModelGroup
) -> torch.Tensor:
    """The mean cross-entropy of ``logits`` (N, C / size) f32, this rank's
    contiguous classes, against ``target`` (N,) global classes, without
    gathering the logits: the row max by one ``all_reduce`` (max), then the
    sum of exponentials and the target's logit by one (sum). Its gradient
    is the rank's columns of softmax - one-hot, with no collective."""
    return _VocabParallelCrossEntropy.apply(logits, target, model)


def gather_module_state(module: torch.nn.Module, model: Optional[ModelGroup]) -> dict:
    """``module``'s full state_dict: every ``shard_module_`` cut tensor
    gathered over the model group (a plain detached state_dict without one)."""
    return {k: gather_tensor(v, model_dim(v), model)
            for k, v in module.state_dict(keep_vars=True).items()}


_MOMENTS = ("exp_avg", "exp_avg_sq")


def _map_moments(state: dict, params: Sequence[torch.Tensor], fn) -> dict:
    """An Adam state_dict with ``fn(moment, dim)`` for each parameter's
    moments, the rest as it is (the live state's dicts are not touched)."""
    out = {k: v for k, v in state.items() if k != "state"}
    out["state"] = {i: {k: fn(v, model_dim(params[i])) if k in _MOMENTS else v
                        for k, v in st.items()}
                    for i, st in state["state"].items()}
    return out


def gather_optimizer_state(optimizer: torch.optim.Optimizer,
                           model: Optional[ModelGroup]) -> dict:
    """The optimizer's state_dict with each cut parameter's Adam moments
    gathered over the model group: the state of one process's optimizer."""
    state = optimizer.state_dict()
    if model is None:
        return state
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return _map_moments(state, params, lambda v, dim: gather_tensor(v, dim, model))


def shard_optimizer_state(state: dict, optimizer: torch.optim.Optimizer,
                          model: Optional[ModelGroup]) -> dict:
    """A full Adam state_dict (one process's, over ``optimizer``'s
    parameters in order) with each cut parameter's moments sliced for this rank."""
    if model is None:
        return state
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return _map_moments(state, params, lambda v, dim: shard_tensor(v, dim, model))
