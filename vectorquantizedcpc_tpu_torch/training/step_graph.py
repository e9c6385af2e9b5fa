"""One optimizer step as a CUDA graph, replayed over a group of staged batches.

The counterpart of the JAX trainers' grouped dispatch (``make_train_epochs``,
``make_train_multi_step``). JAX jits one step and folds a group of them into
one dispatch with ``lax.scan``; here a card captures the whole step (forward,
loss, backward, clip, Adam, the VQ-EMA update) once into a CUDA graph and
replays it for each batch of a group staged on the device in one copy. The
host then queues a few copies and one graph launch per step in place of the
step's few hundred kernels.

- Inputs: the graph reads static device buffers, one per input; each step
  copies its batch into them (device to device). The learning rate is the
  optimizer's 0-dim device tensor (``make_adam``), filled before each step.
- Warm-up: the first ``WARMUP_STEPS`` steps of each input shape run
  eagerly on a side stream, as ``torch.cuda.graph`` requires (Adam's
  moments, cuBLAS's handles and workspaces are made lazily). They are real
  steps on real batches: none is thrown away and none is added.
- Capture: the next step is captured, then replayed once for its own batch.
  A capture that fails raises; nothing falls back to the eager step.
- One graph per input shape, kept for the run.
- Counts: the kernel wrappers' ``*_LAUNCHES`` counters count in Python, so
  a replay adds nothing to them. ``captured`` holds each counter's delta
  during the capture (the kernel launches of one replayed step),
  ``replays`` the replays and ``eager_steps`` the warm-up steps.
- On the CPU there is no graph: every step runs eagerly, the plain version
  of the graph path, with the learning rate set as a float.
- No cyclic garbage collection runs inside a capture (a dead trainer's
  graph freed there would invalidate it): one runs just before.
- The capture is thread-local: other threads may use the card meanwhile
  (a process group's watchdog querying its events, a checkpoint writer
  waiting on its copy), with a process group or without one in the step.
- Data and tensor parallel (``group``, and ``model``'s group): the step's
  collectives (the VQ statistics', the gradients' and metrics'
  ``all_reduce``; the model group's gathers and sums of the partitioned
  products, the VQ argmin, the clip's norm and the vocab-parallel loss) go
  inside the graph under NCCL, called in the same order on every rank. The
  warm-up steps run them eagerly first, which makes both NCCL
  communicators before the capture. A gloo group's collectives run on the
  host and cannot be captured: on a card ``step`` raises, and a caller
  that wants eager steps calls the trainer's ``train_step``.
- Spans (``utils/profiling.py``): ``step.stage``, a group's copy to the
  device (:func:`stage`), and ``step.dispatch``, one :meth:`StepGraph.step`
  on any of its paths (eager, capture, replay).
"""

import gc
import time
from typing import Callable, Dict, List, NamedTuple, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..utils.profiling import span

WARMUP_STEPS = 2  # eager steps of each input shape before its capture
COUNTED_MODULES = ("ar_decode", "cpc_select", "gru_train", "lstm_scan")


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch counter, by kernel name:
    ``LSTM_SCAN_TRAIN_LAUNCHES`` is "lstm_scan_train"."""
    import importlib

    counts = {}
    for name in COUNTED_MODULES:
        module = importlib.import_module(f"..ops.{name}", __package__)
        for attr, value in vars(module).items():
            if attr.endswith("_LAUNCHES") and isinstance(value, int):
                counts[attr[: -len("_LAUNCHES")].lower()] = value
    return counts


def make_adam(params, device: Union[str, torch.device]) -> torch.optim.Adam:
    """Adam with betas (0.9, 0.999) and eps 1e-8, optax's defaults. On a
    card it is capturable, its learning rate a 0-dim f32 tensor there, which
    a graph reads, and fused: one kernel updates every parameter, with the
    bias corrections in double as the plain optimizer's (the capturable
    multi-tensor form takes 1 - 0.999^t in f32, 1.3e-5 off at the first
    step). On the CPU, which capturable Adam refuses, the plain optimizer
    with a float learning rate."""
    kwargs = dict(betas=(0.9, 0.999), eps=1e-8)
    device = torch.device(device)
    if device.type == "cuda":
        lr = torch.zeros((), dtype=torch.float32, device=device)
        return torch.optim.Adam(params, lr=lr, capturable=True, fused=True, **kwargs)
    return torch.optim.Adam(params, lr=0.0, **kwargs)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Fill the learning-rate tensor in place (a graph reads it), or set the float."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: dict) -> None:
    """``load_state_dict`` that keeps this optimizer's learning-rate tensor
    and its capturable and fused flags, and moves the step counts where
    capturable Adam keeps them (a checkpoint of either device loads on
    either). Load before a capture: the graph holds the tensors it read then."""
    kept = [(group["lr"], group.get("capturable", False), group.get("fused"))
            for group in optimizer.param_groups]
    optimizer.load_state_dict(state)
    for group, (lr, capturable, fused) in zip(optimizer.param_groups, kept):
        if isinstance(lr, torch.Tensor):
            lr.fill_(float(group["lr"]))
        group["lr"], group["capturable"], group["fused"] = lr, capturable, fused
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "step" in st:
                st["step"] = st["step"].to(p.device if capturable else "cpu", torch.float32)


def stage(batches: Sequence[np.ndarray], device: Union[str, torch.device]) -> torch.Tensor:
    """A group's batches stacked (G, ...) on ``device`` in one copy: to a
    card from pinned memory, without waiting for it."""
    with span("step.stage"):
        if torch.device(device).type != "cuda":
            return torch.from_numpy(np.stack(batches))
        first = np.asarray(batches[0])
        host = torch.empty((len(batches),) + first.shape, dtype=torch.from_numpy(first).dtype,
                           pin_memory=True)
        np.stack(batches, out=host.numpy())
        return host.to(device, non_blocking=True)


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: List[torch.Tensor]
    outputs: Dict[str, torch.Tensor]


class StepGraph:
    """``step_fn(*inputs) -> {metric: tensor}``, one optimizer step that
    reads its learning rate from ``optimizer``, run through a CUDA graph
    per input shape on a card and eagerly on the CPU."""

    def __init__(self, step_fn: Callable[..., Dict[str, torch.Tensor]],
                 optimizer: torch.optim.Optimizer, device: Union[str, torch.device],
                 group=None, model=None):
        self.step_fn = step_fn
        self.optimizer = optimizer
        self.device = torch.device(device)
        self.groups = [g for g in (group, None if model is None else model.group)
                       if g is not None]
        self._graphs: Dict[tuple, _Graph] = {}
        self._warm: Dict[tuple, int] = {}
        self._stream = None
        self.eager_steps = 0
        self.replays = 0
        self.captures = 0
        self.captured: Dict[str, int] = {}  # counter deltas of the last capture
        self.capture_s = 0.0
        self.pool_bytes = 0  # device memory the graphs' private pools reserve

    def step(self, inputs: Sequence[torch.Tensor], lr: float) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``inputs`` (tensors on the step's device) at
        ``lr``; returns the step's metrics as tensors there, without waiting."""
        with span("step.dispatch"):
            return self._step(inputs, lr)

    def _step(self, inputs, lr: float) -> Dict[str, torch.Tensor]:
        set_lr(self.optimizer, lr)
        if self.device.type != "cuda":
            self.eager_steps += 1
            return self.step_fn(*inputs)
        for group in self.groups:
            if dist.get_backend(group) != "nccl":
                raise RuntimeError(
                    f"a {dist.get_backend(group)} process group's collectives cannot be "
                    "captured in a CUDA graph; use NCCL, or call the trainer's train_step for "
                    "eager steps"
                )
        key = tuple((tuple(x.shape), x.dtype) for x in inputs)
        graph = self._graphs.get(key)
        if graph is None:
            if self._warm.get(key, 0) < WARMUP_STEPS:
                self._warm[key] = self._warm.get(key, 0) + 1
                return self._eager(inputs)
            graph = self._graphs[key] = self._capture(inputs)
        else:
            for static, x in zip(graph.inputs, inputs):
                static.copy_(x)
        graph.graph.replay()
        self.replays += 1
        return {k: v.clone() for k, v in graph.outputs.items()}

    def _eager(self, inputs) -> Dict[str, torch.Tensor]:
        # The side stream waits for everything queued before (the batch,
        # the learning rate, readers of the last warm-up's outputs), so a
        # block it frees is never reused under a pending read.
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            out = self.step_fn(*inputs)
        main.wait_stream(self._stream)
        self.eager_steps += 1
        return out

    def _capture(self, inputs) -> _Graph:
        static = [x.clone() for x in inputs]  # outside the graph's pool
        # A dead trainer's graph sits in a reference cycle (its step_fn is a
        # bound method of the trainer); the cyclic collector must free it
        # now, not inside this capture, where destroying a graph is refused
        # and invalidates the capture.
        gc.collect()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = launch_counts()
        start = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outputs = self.step_fn(*static)
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(self.device)
        self.capture_s += time.perf_counter() - start
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        after = launch_counts()
        self.captured = {k: v - before.get(k, 0) for k, v in after.items()}
        self.captures += 1
        return _Graph(graph, static, outputs)
