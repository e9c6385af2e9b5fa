"""Training checkpoints: the port's ``model.ckpt-{n}.pt`` and the JAX package's ``model.ckpt-{n}``.

The port writes ``model.ckpt-{n}.pt`` (``torch.save``, every tensor on the
CPU):

- CPC: n is the epoch; ``{"encoder", "cpc", "optimizer", "scheduler",
  "epoch"}`` (the reference's train_cpc.py save), so the port's encode CLI
  and the JAX package's importer
  (``training/torch_import.py:load_reference_cpc_checkpoint``) read it as
  it is.
- Vocoder: n is the optimizer step; ``{"vocoder", "optimizer", "step",
  "epoch"}`` under ``{dir_root}/{name_exp}/{name_version}/checkpoints/``,
  which ``weights.load_vocoder_checkpoint`` (and so the convert CLI) reads;
  ``latest_checkpoint`` finds the one to resume from.

It reads both that and the JAX package's ``model.ckpt-{n}``, flax msgpack
bytes of a whole train state (``read_jax_checkpoint``; ``weights.py`` maps
the tree onto the port). ``checkpoint_format`` tells them apart by their
first bytes, not their names.

A write goes to a temporary file that is then renamed, so a cut save never
leaves a broken checkpoint. ``AsyncCheckpointer`` takes the write off the
training loop, as the JAX package's does.
"""

import os
import re
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..utils import msgpack

_CKPT_RE = re.compile(r"^model\.ckpt-(\d+)(\.pt)?$")
_ZIP_MAGIC = b"PK\x03\x04"  # torch.save's zip archive


def _map(tree: Any, fn) -> Any:
    """``fn`` on every tensor of a tree of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


def _plain_numbers(tree: Any) -> Any:
    """A host tree as the file holds it: an optimizer state_dict's 0-dim
    tensors in its param groups (the learning rate a CUDA graph reads on
    the card) become Python numbers, the layout of the reference."""
    if isinstance(tree, dict):
        if "param_groups" in tree:
            tree["param_groups"] = [
                {k: v.item() if isinstance(v, torch.Tensor) and v.dim() == 0 else v
                 for k, v in group.items()}
                for group in tree["param_groups"]
            ]
        for v in tree.values():
            _plain_numbers(v)
    return tree


def _write(checkpoint_dir: Union[str, Path], n: int, host_state: Dict[str, Any]) -> Path:
    checkpoint_dir = Path(checkpoint_dir)
    checkpoint_dir.mkdir(parents=True, exist_ok=True)
    path = checkpoint_dir / f"model.ckpt-{n}.pt"
    tmp = path.with_name(path.name + ".tmp")
    torch.save(_plain_numbers(host_state), tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(checkpoint_dir: Union[str, Path], n: int, state: Dict[str, Any]) -> Path:
    """Write ``state`` (state_dicts and plain values) as ``model.ckpt-{n}.pt``
    now, the caller waiting for the card and the disk."""
    return _write(checkpoint_dir, n, _map(state, lambda t: t.detach().cpu().clone()))


class _Snapshot:
    """A tree's tensors copied at one point of the training stream: each
    card dtype packed into one device buffer by one ``torch.cat`` (the
    copy), then copied to pinned host memory on a side stream; ``event``
    marks the end of that copy. CPU tensors are cloned at once."""

    def __init__(self, tree: Any, side: Optional["torch.cuda.Stream"]):
        self.slots: List[Tuple[torch.dtype, int, torch.Size]] = []  # (dtype, offset, shape)
        groups: Dict[torch.dtype, List[torch.Tensor]] = {}
        sizes: Dict[torch.dtype, int] = {}

        def take(t: torch.Tensor) -> Any:
            t = t.detach()
            if t.device.type != "cuda":
                return t.clone()
            offset = sizes.get(t.dtype, 0)
            groups.setdefault(t.dtype, []).append(t.reshape(-1))
            sizes[t.dtype] = offset + t.numel()
            self.slots.append((t.dtype, offset, t.shape))
            return _Slot(len(self.slots) - 1)

        self.tree = _map(tree, take)
        self.host: Dict[torch.dtype, torch.Tensor] = {}
        self.event = None
        if not groups:
            return
        packed = {dtype: torch.cat(parts) for dtype, parts in groups.items()}
        side.wait_stream(torch.cuda.current_stream(side.device))
        with torch.cuda.stream(side):
            for dtype, buf in packed.items():
                host = torch.empty(buf.shape, dtype=dtype, pin_memory=True)
                host.copy_(buf, non_blocking=True)
                buf.record_stream(side)  # its memory is not reused before the copy ends
                self.host[dtype] = host
            self.event = torch.cuda.Event()
            self.event.record(side)

    def host_tree(self) -> Any:
        """The tree on the host, once the copy has ended (waits for it)."""
        if self.event is not None:
            self.event.synchronize()

        def place(x: Any) -> Any:
            if isinstance(x, _Slot):
                dtype, offset, shape = self.slots[x.index]
                return self.host[dtype][offset: offset + shape.numel()].view(shape).clone()
            if isinstance(x, dict):
                return {k: place(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(place(v) for v in x)
            return x

        return place(self.tree)


class _Slot:
    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


class AsyncCheckpointer:
    """Checkpoint writes off the training loop: the JAX package's
    ``AsyncCheckpointer`` (its ``training/checkpoint.py``) on PyTorch.

    :meth:`save` joins the write in flight, then snapshots the state where
    the training stream stands: on a card one device copy per dtype,
    queued after the last step and so before the next step (a CUDA graph
    replay whose fused Adam updates every parameter and moment in place)
    can change anything, then the copy to pinned host memory on a side
    stream, and returns. A writer thread waits for that copy's event, then
    ``torch.save``s to a temporary file and renames it. Nothing waits for
    the card on the calling thread. At most one write is in flight, so one
    snapshot's memory at most, on the card and the host. A writer's error
    is raised by the next :meth:`save` or :meth:`wait`. On the CPU the same
    class runs with no streams (the snapshot is a clone).

    Data parallel, only rank 0 writes: the other ranks hold one made with
    ``active=False``, whose :meth:`save` does nothing. Every rank reads.
    """

    def __init__(self, active: bool = True) -> None:
        self.active = active
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._last_path: Optional[Path] = None
        self._side: Optional["torch.cuda.Stream"] = None

    def save(self, checkpoint_dir: Union[str, Path], n: int, state: Dict[str, Any]) -> None:
        """Write ``state`` as ``model.ckpt-{n}.pt`` in the background."""
        self.wait()
        if not self.active:
            return
        device = next((t.device for t in _tensors(state) if t.device.type == "cuda"), None)
        if device is not None and self._side is None:
            self._side = torch.cuda.Stream(device)
        snapshot = _Snapshot(state, self._side)

        def write() -> None:
            try:
                self._last_path = _write(checkpoint_dir, n, snapshot.host_tree())
            except Exception as e:  # raised by the next save() or wait()
                self._error = e

        self._thread = threading.Thread(target=write, name=f"ckpt-writer-{n}", daemon=True)
        self._thread.start()

    def wait(self) -> Optional[Path]:
        """Block until the write in flight (if any) is on disk; returns the
        last path written. Raises the writer's error, if it had one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        return self._last_path


def _tensors(tree: Any) -> List[torch.Tensor]:
    found: List[torch.Tensor] = []
    _map(tree, found.append)
    return found


def checkpoint_format(path: Union[str, Path]) -> str:
    """"jax" for the JAX package's flax msgpack bytes (a map marker first:
    0x81-0x8f, 0xde, 0xdf), "torch" for ``torch.save``'s zip or its legacy
    pickle (0x80 then the protocol, which msgpack would read as an empty
    map, never a train state); anything else raises ``ValueError``."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head.startswith(_ZIP_MAGIC) or (len(head) > 1 and head[0] == 0x80 and 2 <= head[1] <= 5):
        return "torch"
    if head and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        return "jax"
    raise ValueError(
        f"{path}: neither a torch.save checkpoint nor the JAX package's msgpack "
        f"train state (first bytes {head!r})"
    )


def read_jax_checkpoint(path: Union[str, Path]) -> Dict[str, Any]:
    """The JAX package's checkpoint as its nested dict (flax's state dict
    of the train state: dataclasses and optax states as dicts of their
    fields, tuples as {"0": ...} dicts), leaves as numpy arrays."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    tree = msgpack.unpackb(data)
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: the msgpack value is a {type(tree).__name__}, not a train state")
    return tree


def load_checkpoint(path: Union[str, Path]) -> Dict[str, Any]:
    """A ``.pt`` checkpoint of the port (or the reference), on the CPU."""
    return torch.load(str(path), map_location="cpu", weights_only=True)


def latest_checkpoint(checkpoint_dir: Union[str, Path]) -> Optional[Path]:
    """The highest-numbered checkpoint under ``checkpoint_dir``, the port's
    ``model.ckpt-{n}.pt`` or the JAX package's ``model.ckpt-{n}``, or None.
    Both forms at one n raise ``ValueError``: neither is picked silently."""
    checkpoint_dir = Path(checkpoint_dir)
    if not checkpoint_dir.is_dir():
        return None
    found: Dict[int, List[Path]] = {}
    for p in checkpoint_dir.iterdir():
        m = _CKPT_RE.match(p.name)
        if m:
            found.setdefault(int(m.group(1)), []).append(p)
    if not found:
        return None
    for n, paths in found.items():
        if len(paths) > 1:
            raise ValueError(
                f"two checkpoints of step {n} in {checkpoint_dir}: "
                f"{sorted(p.name for p in paths)}; remove one"
            )
    return found[max(found)][0]
