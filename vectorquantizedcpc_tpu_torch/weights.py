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
layouts, the inverse of the JAX importer. ``cpc_train_state_from_jax`` and
``vocoder_train_state_from_jax`` map a whole JAX train state (a checkpoint
the JAX trainers wrote, ``training/checkpoint.py:read_jax_checkpoint``),
Adam's moments included, onto the port's checkpoint layouts.

``load_cpc_checkpoint`` and ``load_vocoder_checkpoint`` read either kind of
file, told apart by its first bytes (``checkpoint_format``): a reference
``.pt`` or the JAX package's ``model.ckpt-{n}``, of which they take the
encoder (``enc`` and ``vq``) or the vocoder's ``params``, as the JAX
package's ``infer/encode.py`` and ``infer/convert.py`` do.
"""

from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .training.checkpoint import checkpoint_format, read_jax_checkpoint

StateDict = Dict[str, torch.Tensor]


def _load(path: Union[str, Path]) -> dict:
    return torch.load(str(path), map_location="cpu", weights_only=True)


def _read_jax(path: Union[str, Path]) -> Optional[dict]:
    """The JAX package's train state in ``path``, or None for a ``.pt``."""
    return read_jax_checkpoint(path) if checkpoint_format(path) == "jax" else None


def load_cpc_checkpoint(path: Union[str, Path]) -> StateDict:
    """The encoder state_dict of a reference CPC checkpoint or of the JAX
    package's CPC train state."""
    tree = _read_jax(path)
    if tree is not None:
        return encoder_from_jax_params(flatten(tree["enc"]), flatten(tree["vq"]))
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
    """The vocoder state_dict of a reference checkpoint or of the JAX
    package's vocoder train state, in the port's names."""
    tree = _read_jax(path)
    if tree is not None:
        return vocoder_from_jax_params(flatten(tree["params"]))
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
    """A C-contiguous f32 copy: a transposed kernel keeps no strides of its
    own, which the fused Adam would refuse as a moment's layout."""
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C", copy=True))


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


def vocoder_from_jax_params(vocoder: Dict[str, np.ndarray]) -> StateDict:
    """JAX vocoder params (numpy, keyed by field path) -> the port's Vocoder
    state_dict: Linear and GRU kernels transposed, GRU biases kept apart
    (bx -> bias_ih, bh -> bias_hh)."""
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
    return voc


def from_jax_params(
    encoder: Dict[str, np.ndarray],
    vq: Dict[str, np.ndarray],
    vocoder: Dict[str, np.ndarray],
) -> Tuple[StateDict, StateDict]:
    """JAX params (numpy, keyed by field path) -> (encoder, vocoder)
    state_dicts, as ``encoder_from_jax_params`` and ``vocoder_from_jax_params``."""
    return encoder_from_jax_params(encoder, vq), vocoder_from_jax_params(vocoder)


def cpc_from_jax_params(cpc: Dict[str, np.ndarray]) -> StateDict:
    """JAX CPC params {"w": (n, C, Z), "b": (n, Z)} -> the reference CPCLoss
    state_dict: ``predictors.{k}.weight`` (Z, C) and ``.bias``."""
    out = {}
    for k in range(cpc["w"].shape[0]):
        out[f"predictors.{k}.weight"] = _t(cpc["w"][k].T)
        out[f"predictors.{k}.bias"] = _t(cpc["b"][k])
    return out


# The port's Adam (training/step_graph.py:make_adam): optax.adam's defaults.
ADAM_HYPERPARAMS = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0}


def flatten(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict's leaves keyed by "."-joined paths (the JAX params'
    field paths: ``rnn.wx``, ``prenet_fwd.0.wh``)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "."))
        else:
            out[key] = v
    return out


def _adam_state(opt_state: dict) -> dict:
    """The one ``ScaleByAdamState`` ({count, mu, nu}) of an optax state tree,
    wherever the optimizer's chain put it."""
    found = []

    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"count", "mu", "nu"}:
                found.append(node)
            else:
                for v in node.values():
                    walk(v)

    walk(opt_state)
    if len(found) != 1:
        raise ValueError(f"expected one Adam state (count, mu, nu) in opt_state, found {len(found)}")
    hyper = opt_state.get("hyperparams", {})
    for name, value in ADAM_HYPERPARAMS.items():
        if name in hyper and np.float32(hyper[name]) != np.float32(value):
            raise ValueError(
                f"opt_state hyperparams {name}={float(hyper[name])!r}; the port's Adam has {value}"
            )
    return found[0]


def _optimizer_state(opt_state: dict, moments, param_names) -> dict:
    """A ``torch.optim.Adam`` state_dict over ``param_names`` (the trainer's
    optimizer order) from an optax Adam state. ``moments(tree)`` maps a
    moment tree ({mu, nu} have the params' layout) onto {port name:
    tensor}. optax's count is the updates applied and torch's step the
    same number, so step = count. The learning rate is the stored one; the
    trainers set their own per step, as the JAX trainers do."""
    adam = _adam_state(opt_state)
    mu, nu = moments(adam["mu"]), moments(adam["nu"])
    missing = [n for n in param_names if n not in mu or n not in nu]
    if missing:
        raise ValueError(f"the JAX Adam state has no moments for {missing}")
    lr = float(opt_state.get("hyperparams", {}).get("learning_rate", 0.0))
    group = torch.optim.Adam([torch.zeros(1)], lr=lr, betas=(ADAM_HYPERPARAMS["b1"],
                             ADAM_HYPERPARAMS["b2"]), eps=ADAM_HYPERPARAMS["eps"]
                             ).state_dict()["param_groups"][0]
    group["params"] = list(range(len(param_names)))
    step = float(np.asarray(adam["count"]))
    state = {i: {"step": torch.tensor(step, dtype=torch.float32),
                 "exp_avg": mu[name], "exp_avg_sq": nu[name]}
             for i, name in enumerate(param_names)}
    return {"state": state, "param_groups": [group]}


def _prefixed(prefix: str, sd: StateDict) -> StateDict:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def cpc_train_state_from_jax(tree: dict, param_names: Sequence[str]) -> dict:
    """The JAX CPC train state (``read_jax_checkpoint``'s dict: enc, cpc, vq,
    opt_state, epoch) in the port's checkpoint layout: {"encoder": the
    Encoder state_dict with the VQ-EMA buffers (``codebook.embedding``,
    ``ema_count``, ``ema_weight``), "cpc": the CPCLoss state_dict,
    "optimizer": Adam's state_dict over ``param_names`` ("encoder.<name>"
    and "cpc.<name>" in the trainer's optimizer order), "epoch"}. The
    moments take the parameters' transposes and renames, so the LSTM's one
    fused bias ``b`` gives ``rnn.bias_ih_l0`` its moments."""
    vq = flatten(tree["vq"])

    def port(params: dict) -> StateDict:
        return {**_prefixed("encoder", encoder_from_jax_params(flatten(params["enc"]), vq)),
                **_prefixed("cpc", cpc_from_jax_params(flatten(params["cpc"])))}

    return {
        "encoder": encoder_from_jax_params(flatten(tree["enc"]), vq),
        "cpc": cpc_from_jax_params(flatten(tree["cpc"])),
        "optimizer": _optimizer_state(tree["opt_state"], port, param_names),
        "epoch": int(np.asarray(tree["epoch"])),
    }


def vocoder_train_state_from_jax(tree: dict, param_names: Sequence[str]) -> dict:
    """The JAX vocoder train state (params, opt_state, step, epoch) in the
    port's checkpoint layout: {"vocoder": the Vocoder state_dict,
    "optimizer": Adam's state_dict over ``param_names`` (the Vocoder's
    parameter names in the trainer's optimizer order), "step", "epoch"}."""
    return {
        "vocoder": vocoder_from_jax_params(flatten(tree["params"])),
        "optimizer": _optimizer_state(
            tree["opt_state"], lambda m: vocoder_from_jax_params(flatten(m)), param_names),
        "step": int(np.asarray(tree["step"])),
        "epoch": int(np.asarray(tree["epoch"])),
    }
