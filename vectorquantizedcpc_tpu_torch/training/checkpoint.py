"""CPC checkpoints in the reference's layout.

``model.ckpt-{epoch}.pt`` holds ``{"encoder", "cpc", "optimizer",
"scheduler", "epoch"}`` (the reference's train_cpc.py save), every tensor on
the CPU, so the port's encode CLI and the JAX package's importer
(``training/torch_import.py:load_reference_cpc_checkpoint``) read it as it
is. The write goes to a temporary file that is then renamed, so a cut save
never leaves a broken checkpoint.
"""

import os
from pathlib import Path
from typing import Any, Dict, Union

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
