"""Training checkpoints as ``model.ckpt-{n}.pt``, every tensor on the CPU.

- CPC: n is the epoch; ``{"encoder", "cpc", "optimizer", "scheduler",
  "epoch"}`` (the reference's train_cpc.py save), so the port's encode CLI
  and the JAX package's importer
  (``training/torch_import.py:load_reference_cpc_checkpoint``) read it as
  it is.
- Vocoder: n is the optimizer step; ``{"vocoder", "optimizer", "step",
  "epoch"}`` under ``{dir_root}/{name_exp}/{name_version}/checkpoints/``,
  which ``weights.load_vocoder_checkpoint`` (and so the convert CLI) reads;
  ``latest_checkpoint`` finds the one to resume from.

The write goes to a temporary file that is then renamed, so a cut save
never leaves a broken checkpoint.
"""

import os
import re
from pathlib import Path
from typing import Any, Dict, Optional, Union

_CKPT_RE = re.compile(r"^model\.ckpt-(\d+)\.pt$")

import torch


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(checkpoint_dir: Union[str, Path], epoch: int, state: Dict[str, Any]) -> Path:
    """Write ``state`` (state_dicts and plain values) as ``model.ckpt-{epoch}.pt``."""
    checkpoint_dir = Path(checkpoint_dir)
    checkpoint_dir.mkdir(parents=True, exist_ok=True)
    path = checkpoint_dir / f"model.ckpt-{epoch}.pt"
    tmp = path.with_name(path.name + ".tmp")
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: Union[str, Path]) -> Dict[str, Any]:
    return torch.load(str(path), map_location="cpu", weights_only=True)


def latest_checkpoint(checkpoint_dir: Union[str, Path]) -> Optional[Path]:
    """The highest-numbered ``model.ckpt-{n}.pt`` under ``checkpoint_dir``, or None."""
    checkpoint_dir = Path(checkpoint_dir)
    if not checkpoint_dir.is_dir():
        return None
    found = [(int(m.group(1)), p) for p in checkpoint_dir.iterdir()
             if (m := _CKPT_RE.match(p.name))]
    return max(found)[1] if found else None
