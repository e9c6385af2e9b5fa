"""Weights in and out of the port: reference ``.pt`` checkpoints and JAX params.

Reference checkpoints (the formats the JAX package's
``training/torch_import.py`` reads):

- CPC: ``{"encoder": state_dict, ...}`` (reference train_cpc.py:17-33);
- vocoder: a raw ``Vocoder`` state_dict, ``{"vocoder": state_dict}``, or a
  Lightning checkpoint whose ``state_dict`` prefixes it with ``model.``.

The vocoder's rnnms internals are found by structure, as the JAX importer
does (bidirectional GRU = PreNet, unidirectional GRU = AR GRU, the weight
without a bias = AR embedding, the Linear fed by the GRU = fc1), and renamed
to the port's module names so they load with ``strict=True``.

``from_jax_params`` and ``cpc_from_jax_params`` map JAX parameters, given
as numpy arrays keyed by the JAX dataclass field paths, to the reference
layouts, the inverse of the JAX importer.
"""

from pathlib import Path
from typing import Dict, Tuple, Union

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _load(path: Union[str, Path]) -> dict:
    return torch.load(str(path), map_location="cpu", weights_only=True)


def load_cpc_checkpoint(path: Union[str, Path]) -> StateDict:
    """The encoder state_dict of a reference CPC checkpoint."""
    return dict(_load(path)["encoder"])


def _gru_prefixes(sd: StateDict) -> Dict[str, Dict[str, torch.Tensor]]:
    groups: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, v in sd.items():
        prefix, _, name = k.rpartition(".")
        if name.startswith(("weight_ih_l", "weight_hh_l", "bias_ih_l", "bias_hh_l")):
            groups.setdefault(prefix, {})[name] = v
    return groups


def vocoder_state_dict(sd: StateDict) -> StateDict:
    """Rename a reference vocoder state_dict onto the port's module names."""
    sd = dict(sd)
    out = {
        "code_embedding.weight": sd.pop("code_embedding.weight"),
        "speaker_embedding.weight": sd.pop("speaker_embedding.weight"),
    }
    prenet = ar = None
    for prefix, g in _gru_prefixes(sd).items():
        if any(name.endswith("_reverse") for name in g):
            prenet = (prefix, g)
        else:
            ar = (prefix, g)
    if prenet is None or ar is None:
        raise ValueError(
            "could not locate the PreNet (bidirectional) and AR GRU modules "
            "in the vocoder state_dict"
        )
    for (prefix, g), name in ((prenet, "rnnms.prenet"), (ar, "rnnms.rnn")):
        for k, v in g.items():
            out[f"{name}.{k}"] = v
            del sd[f"{prefix}.{k}"]
    hidden = ar[1]["weight_hh_l0"].shape[1]
    linears, embed = [], None
    for k in sorted(sd):
        if not k.endswith(".weight"):
            continue
        bias = k[: -len(".weight")] + ".bias"
        if bias in sd:
            linears.append((k, bias))
        elif sd[k].ndim == 2:
            if embed is not None:
                raise ValueError(f"ambiguous AR embedding: {embed} vs {k}")
            embed = k
    if embed is None or len(linears) != 2:
        raise ValueError(
            "expected 1 embedding + 2 linear layers in the AR head, found "
            f"embedding={embed} linears={[k for k, _ in linears]}"
        )
    fc1, fc2 = sorted(linears, key=lambda kb: sd[kb[0]].shape[1] != hidden)
    if sd[fc1[0]].shape[1] != hidden:
        raise ValueError(f"no Linear with input dim {hidden} (AR GRU hidden) found")
    out["rnnms.embedding.weight"] = sd[embed]
    for (w, b), name in ((fc1, "rnnms.fc1"), (fc2, "rnnms.fc2")):
        out[f"{name}.weight"] = sd[w]
        out[f"{name}.bias"] = sd[b]
    return out


def load_vocoder_checkpoint(path: Union[str, Path]) -> StateDict:
    """The vocoder state_dict of a reference checkpoint, in the port's names."""
    ckpt = _load(path)
    if "vocoder" in ckpt:
        sd = ckpt["vocoder"]
    elif "state_dict" in ckpt:
        sd = {
            k[len("model."):]: v
            for k, v in ckpt["state_dict"].items()
            if k.startswith("model.")
        }
    else:
        sd = ckpt
    return vocoder_state_dict(sd)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _gru(params: Dict[str, np.ndarray], prefix: str, sfx: str) -> StateDict:
    return {
        f"weight_ih_{sfx}": _t(params[f"{prefix}.wx"].T),
        f"weight_hh_{sfx}": _t(params[f"{prefix}.wh"].T),
        f"bias_ih_{sfx}": _t(params[f"{prefix}.bx"]),
        f"bias_hh_{sfx}": _t(params[f"{prefix}.bh"]),
    }


def encoder_from_jax_params(
    encoder: Dict[str, np.ndarray], vq: Dict[str, np.ndarray]
) -> StateDict:
    """JAX encoder params and VQ state (numpy, keyed by field path) -> the
    reference Encoder state_dict. Conv WIO -> OIW, Linear and LSTM kernels
    transposed; the JAX LSTM's one fused bias becomes ``bias_ih`` with a
    zero ``bias_hh``."""
    n_blocks = encoder["fc_w"].shape[0]
    enc = {
        "conv.weight": _t(np.transpose(encoder["conv_w"], (2, 1, 0))),
        "encoder.0.weight": _t(encoder["ln_in_scale"]),
        "encoder.0.bias": _t(encoder["ln_in_bias"]),
    }
    for i in range(n_blocks):
        enc[f"encoder.{2 + 3 * i}.weight"] = _t(encoder["fc_w"][i].T)
        enc[f"encoder.{3 + 3 * i}.weight"] = _t(encoder["fc_ln_scale"][i])
        enc[f"encoder.{3 + 3 * i}.bias"] = _t(encoder["fc_ln_bias"][i])
    out_idx = 2 + 3 * n_blocks
    enc[f"encoder.{out_idx}.weight"] = _t(encoder["out_w"].T)
    enc[f"encoder.{out_idx}.bias"] = _t(encoder["out_b"])
    for name in ("embedding", "ema_count", "ema_weight"):
        enc[f"codebook.{name}"] = _t(vq[name])
    enc["rnn.weight_ih_l0"] = _t(encoder["rnn.wx"].T)
    enc["rnn.weight_hh_l0"] = _t(encoder["rnn.wh"].T)
    enc["rnn.bias_ih_l0"] = _t(encoder["rnn.b"])
    enc["rnn.bias_hh_l0"] = torch.zeros_like(enc["rnn.bias_ih_l0"])
    return enc


def from_jax_params(
    encoder: Dict[str, np.ndarray],
    vq: Dict[str, np.ndarray],
    vocoder: Dict[str, np.ndarray],
) -> Tuple[StateDict, StateDict]:
    """JAX params (numpy, keyed by field path) -> (encoder, vocoder) state_dicts.

    The encoder as ``encoder_from_jax_params``; vocoder Linear and GRU
    kernels transposed, GRU biases kept apart (bx -> bias_ih, bh -> bias_hh).
    """
    enc = encoder_from_jax_params(encoder, vq)
    voc = {
        "code_embedding.weight": _t(vocoder["code_embedding"]),
        "speaker_embedding.weight": _t(vocoder["speaker_embedding"]),
        "rnnms.embedding.weight": _t(vocoder["ar_embed"]),
        "rnnms.fc1.weight": _t(vocoder["fc1_w"].T),
        "rnnms.fc1.bias": _t(vocoder["fc1_b"]),
        "rnnms.fc2.weight": _t(vocoder["fc2_w"].T),
        "rnnms.fc2.bias": _t(vocoder["fc2_b"]),
    }
    n_layers = 1 + max(
        int(k.split(".")[1]) for k in vocoder if k.startswith("prenet_fwd.")
    )
    for i in range(n_layers):
        for k, v in _gru(vocoder, f"prenet_fwd.{i}", f"l{i}").items():
            voc[f"rnnms.prenet.{k}"] = v
        for k, v in _gru(vocoder, f"prenet_bwd.{i}", f"l{i}_reverse").items():
            voc[f"rnnms.prenet.{k}"] = v
    for k, v in _gru(vocoder, "ar_gru", "l0").items():
        voc[f"rnnms.rnn.{k}"] = v
    return enc, voc


def cpc_from_jax_params(cpc: Dict[str, np.ndarray]) -> StateDict:
    """JAX CPC params {"w": (n, C, Z), "b": (n, Z)} -> the reference CPCLoss
    state_dict: ``predictors.{k}.weight`` (Z, C) and ``.bias``."""
    out = {}
    for k in range(cpc["w"].shape[0]):
        out[f"predictors.{k}.weight"] = _t(cpc["w"][k].T)
        out[f"predictors.{k}.bias"] = _t(cpc["b"][k])
    return out
