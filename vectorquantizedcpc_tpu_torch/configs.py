"""Typed configuration for the port's CLIs: defaults, ``${}`` links, overrides.

The conversion and export subset of the JAX package's config tree, under the
same key paths, so a ``key=value`` override written for one CLI works for the other
(``training_vocoder.model.network.rnnms.wave_ar.size_h_rnn=32``). The
defaults are a Python literal and overrides are parsed without yaml. An
unknown key raises ``ValueError``, as in the JAX CLI.
"""

import dataclasses
import re
import sys
import typing
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .dsp.mel import ConfPreprocessing

MISSING = "???"


def conf_default_tree() -> Dict[str, Any]:
    """The defaults; ``${a.b}`` strings link to another key."""
    return {
        "sampling_rate": 16000,
        "bit_mulaw": 8,
        "dim_mel_freq": 80,
        "size_latent_codebook": 512,
        "dim_latent": 64,
        "dim_cpc_context": 256,
        "cpc_checkpoint": "checkpoints/cpc/english2019/model.ckpt-22000.pt",
        "vocoder_checkpoint": (
            "checkpoints/vocoder/english2019/version1/model.ckpt-xxxxxx.pt"
        ),
        "save_auxiliary": False,
        "synthesis_list": "./target_vc.json",
        "in_dir": "./in",
        "out_dir": "./out",
        "model": {
            "encoder": {
                "in_channels": "${dim_mel_freq}",
                "channels": 512,
                "n_embeddings": "${size_latent_codebook}",
                "z_dim": "${dim_latent}",
                "c_dim": "${dim_cpc_context}",
            },
        },
        "training_vocoder": {
            "model": {
                "n_speakers": 102,
                "network": {
                    "size_i_codebook": "${size_latent_codebook}",
                    "dim_i_embedding": "${dim_latent}",
                    "dim_speaker_embedding": 64,
                    "rnnms": {
                        "dim_voc_latent": 256,
                        "bits_mu_law": "${bit_mulaw}",
                        "upsampling_t": "${data.dataset.preprocess.hop_length}",
                        "prenet": {"num_layers": 2},
                        "wave_ar": {
                            "size_i_embed_ar": 256,
                            "size_h_rnn": 896,
                            "size_h_fc": 256,
                        },
                    },
                },
            },
        },
        "data": {
            "dataset": {
                "mel_stft_stride": 160,
                "preprocess": {
                    "sr": "${sampling_rate}",
                    "n_fft": 2048,
                    "n_mels": "${dim_mel_freq}",
                    "fmin": 50,
                    "preemph": 0.97,
                    "top_db": 80,
                    "hop_length": "${data.dataset.mel_stft_stride}",
                    "win_length": 400,
                    "bits": "${bit_mulaw}",
                },
            },
        },
        "runtime": {"precision": "bfloat16", "platform": None},
    }


@dataclass
class ConfEncoder:
    in_channels: int = MISSING
    channels: int = MISSING
    n_embeddings: int = MISSING
    z_dim: int = MISSING
    c_dim: int = MISSING


@dataclass
class ConfModel:
    encoder: ConfEncoder = field(default_factory=ConfEncoder)


@dataclass
class ConfPrenet:
    num_layers: int = MISSING  # bidirectional layers


@dataclass
class ConfWaveAR:
    size_i_embed_ar: int = MISSING
    size_h_rnn: int = MISSING
    size_h_fc: int = MISSING


@dataclass
class ConfRNNMS:
    dim_voc_latent: int = MISSING
    bits_mu_law: int = MISSING
    upsampling_t: int = MISSING
    dim_i_feature: int = -1  # derived: dim_i_embedding + dim_speaker_embedding
    prenet: ConfPrenet = field(default_factory=ConfPrenet)
    wave_ar: ConfWaveAR = field(default_factory=ConfWaveAR)


@dataclass
class ConfVocoderNetwork:
    size_i_codebook: int = MISSING
    dim_i_embedding: int = MISSING
    dim_speaker_embedding: int = MISSING
    n_speakers: int = -1  # wired from training_vocoder.model.n_speakers
    rnnms: ConfRNNMS = field(default_factory=ConfRNNMS)


@dataclass
class ConfVocoderModel:
    n_speakers: int = MISSING
    network: ConfVocoderNetwork = field(default_factory=ConfVocoderNetwork)


@dataclass
class ConfTrainVocoder:
    model: ConfVocoderModel = field(default_factory=ConfVocoderModel)


@dataclass
class ConfDataset:
    mel_stft_stride: int = MISSING
    preprocess: ConfPreprocessing = field(default_factory=ConfPreprocessing)


@dataclass
class ConfData:
    dataset: ConfDataset = field(default_factory=ConfDataset)


@dataclass
class ConfRuntime:
    # "bfloat16" / "bf16" / "float32" decode through the bf16 kernel, as in
    # the JAX package; "int8" and "auto" are not ported yet. The export's
    # compute dtype: resolve_compute_dtype.
    precision: str = "bfloat16"
    # "cpu" runs on the CPU; null or "cuda" needs a CUDA card.
    platform: Optional[str] = None


@dataclass
class ConfGlobal:
    sampling_rate: int = MISSING
    bit_mulaw: int = MISSING
    dim_mel_freq: int = MISSING
    size_latent_codebook: int = MISSING
    dim_latent: int = MISSING
    dim_cpc_context: int = MISSING
    cpc_checkpoint: str = MISSING
    vocoder_checkpoint: str = MISSING
    save_auxiliary: bool = MISSING
    synthesis_list: str = MISSING
    in_dir: str = MISSING
    out_dir: str = MISSING
    model: ConfModel = field(default_factory=ConfModel)
    training_vocoder: ConfTrainVocoder = field(default_factory=ConfTrainVocoder)
    data: ConfData = field(default_factory=ConfData)
    runtime: ConfRuntime = field(default_factory=ConfRuntime)


def resolve_compute_dtype(precision: str):
    """``runtime.precision`` -> the encoder's compute dtype, in the JAX
    package's spellings. The decode-only modes compute in bfloat16."""
    import torch

    if precision in ("auto", "int8"):
        warnings.warn(
            f"runtime.precision={precision!r} is a decode-only mode; "
            "the encoder computes in bfloat16"
        )
        return torch.bfloat16
    if precision in ("bfloat16", "bf16"):
        return torch.bfloat16
    if precision in ("float32", "f32", "fp32"):
        return torch.float32
    raise ValueError(
        f"runtime.precision={precision!r} is not a compute dtype "
        "(float32/bfloat16) or a decode mode (bf16/int8/auto)"
    )


_INTERP_RE = re.compile(r"^\$\{([A-Za-z0-9_.]+)\}$")


def _parse_value(raw: str) -> Any:
    """A scalar as yaml reads it: null, bool, int, float, else the string."""
    if raw == "" or raw in ("null", "~"):
        return None
    if raw in ("true", "false"):
        return raw == "true"
    for cast in (int, float):
        try:
            return cast(raw)
        except ValueError:
            pass
    return raw


def parse_cli_overrides(argv: List[str]) -> Dict[str, Any]:
    """Parse bare ``key=value`` dotted-path overrides into a nested dict."""
    tree: Dict[str, Any] = {}
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"CLI override must be key=value, got: {arg!r}")
        key, _, raw = arg.partition("=")
        node = tree
        parts = key.strip().split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise ValueError(f"Cannot override through non-dict key: {key}")
        node[parts[-1]] = _parse_value(raw)
    return tree


def _deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _resolve_interpolations(tree: Dict[str, Any]) -> Dict[str, Any]:
    def lookup(dotted: str) -> Any:
        node: Any = tree
        for part in dotted.split("."):
            node = node[part]
        return node

    def resolve(v: Any, seen: tuple) -> Any:
        if isinstance(v, dict):
            return {k: resolve(x, seen) for k, x in v.items()}
        if isinstance(v, str):
            m = _INTERP_RE.match(v)
            if m:
                path = m.group(1)
                if path in seen:
                    raise ValueError(f"Interpolation cycle at ${{{path}}}")
                return resolve(lookup(path), seen + (path,))
        return v

    return resolve(tree, ())


def _coerce(hint: Any, value: Any, path: str) -> Any:
    if typing.get_origin(hint) is typing.Union:  # Optional[...]
        if value is None:
            return None
        (hint,) = [a for a in typing.get_args(hint) if a is not type(None)]
    if hint is float and isinstance(value, int) and not isinstance(value, bool):
        return float(value)
    if isinstance(value, bool) != (hint is bool) or not isinstance(value, hint):
        raise ValueError(
            f"Expected {hint.__name__} at '{path}', got {value!r}"
        )
    return value


def _instantiate(cls: type, tree: Dict[str, Any], path: str = "") -> Any:
    """Build a dataclass from a nested dict, rejecting unknown keys."""
    hints = typing.get_type_hints(cls)
    unknown = set(tree) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise ValueError(
            f"Unknown config key(s) at '{path or '<root>'}': {sorted(unknown)}"
        )
    kwargs = {}
    for f in dataclasses.fields(cls):
        sub_path = f"{path}.{f.name}" if path else f.name
        hint = hints[f.name]
        if dataclasses.is_dataclass(hint):
            sub = tree.get(f.name, {})
            if not isinstance(sub, dict):
                raise ValueError(f"Expected mapping at '{sub_path}'")
            kwargs[f.name] = _instantiate(hint, sub, sub_path)
            continue
        value = tree.get(f.name, f.default)
        if value == MISSING:
            raise ValueError(f"Missing mandatory value at '{sub_path}'")
        kwargs[f.name] = _coerce(hint, value, sub_path)
    return cls(**kwargs)


def conf_programatic(conf: ConfGlobal) -> ConfGlobal:
    """Derived fields, as in the JAX package's config."""
    model = conf.training_vocoder.model
    net = model.network
    net.rnnms.dim_i_feature = net.dim_i_embedding + net.dim_speaker_embedding
    net.n_speakers = model.n_speakers
    return conf


def load_conf(argv: Optional[List[str]] = None) -> ConfGlobal:
    """Defaults merged with ``key=value`` overrides (``sys.argv`` by default),
    links resolved, every key validated, derived fields set."""
    if argv is None:
        argv = sys.argv[1:]
    tree = _deep_merge(conf_default_tree(), parse_cli_overrides(list(argv)))
    return conf_programatic(_instantiate(ConfGlobal, _resolve_interpolations(tree)))
