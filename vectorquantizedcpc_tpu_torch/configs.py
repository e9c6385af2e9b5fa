"""Typed configuration for the port's CLIs: defaults, ``${}`` links, overrides.

The conversion, export, CPC-training and vocoder-training subset of the
JAX package's config tree, under the same key paths, so a ``key=value``
override written for one CLI works for the other
(``training_vocoder.model.network.rnnms.wave_ar.size_h_rnn=32``,
``training.cpc.scheduler.milestones=[4]``). The defaults are a Python
literal. ``path_extend_conf=<yaml>`` merges a file over them and the
``key=value`` overrides over both (CLI > file > defaults, the JAX
package's order); files and values are read by ``utils/yaml_subset.py``,
as ``yaml.safe_load`` reads them. An unknown key raises ``ValueError``, as
in the JAX CLI, and a key of the JAX package's config that the port lacks
says so.
"""

import dataclasses
import re
import sys
import typing
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .dsp.mel import ConfPreprocessing
from .utils import yaml_subset

MISSING = "???"


def conf_default_tree() -> Dict[str, Any]:
    """The defaults; ``${a.b}`` strings link to another key."""
    return {
        "seed": 13,
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
        "checkpoint_dir": "./ckpt",
        "resume": "scratch",
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
            "cpc": {
                "n_prediction_steps": "${training.cpc.n_prediction_steps}",
                "n_speakers_per_batch": "${training.cpc.n_speakers_per_batch}",
                "n_utterances_per_speaker": "${training.cpc.n_utterances_per_speaker}",
                "n_negatives": "${training.cpc.n_negatives}",
                "z_dim": "${dim_latent}",
                "c_dim": "${dim_cpc_context}",
            },
        },
        "training": {
            "cpc": {
                "sample_frames": 128,
                "n_speakers_per_batch": 8,
                "n_utterances_per_speaker": 8,
                "n_prediction_steps": 12,
                "n_negatives": 17,
                "exclude_self_negatives": False,
                "n_epochs": 22000,
                "scheduler": {
                    "warmup_epochs": 150,
                    "initial_lr": 1.0e-5,
                    "max_lr": 4.0e-4,
                    "gamma": 0.25,
                    "milestones": [20000],
                },
                "checkpoint_interval": 2000,
                "log_interval": 10,
                "epochs_per_dispatch": 1,
            },
        },
        "training_vocoder": {
            "model": {
                "sampling_rate": "${sampling_rate}",
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
                        "output": "mulaw",
                        "wave_ar": {
                            "size_i_embed_ar": 256,
                            "size_h_rnn": 896,
                            "size_h_fc": 256,
                        },
                    },
                },
                "optim": {
                    "learning_rate": 4.0e-4,
                    "sched_milestones": [50000, 75000, 100000, 125000],
                    "sched_gamma": 0.5,
                },
            },
            "trainer": {
                "max_epochs": 540,
                "val_interval_epoch": 10,
                "gradient_clip_val": 1.0,
                "steps_per_dispatch": 1,
                "profiler": None,
            },
            "ckpt_log": {
                "dir_root": "vqcpc_vocoder",
                "name_exp": "default",
                "name_version": "version_-1",
            },
        },
        "data": {
            "adress_data_root": None,
            "corpus": {"download": False, "root": None},
            "dataset": {
                "name": "ZR19",
                "adress_data_root": None,
                "clip_length_mel": 32,
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
                "cpc": {
                    "clip_length_mel": -1,
                    "n_utterances_per_speaker": "${training.cpc.n_utterances_per_speaker}",
                },
            },
            "loader": {"batch_size": 32, "num_workers": 1, "pin_memory": None},
        },
        "runtime": {
            "precision": "bfloat16",
            "platform": None,
            "profile_dir": None,
            "mesh_data": 1,
            "mesh_model": 1,
            "coordinator_address": None,
            "num_processes": None,
            "process_id": None,
        },
    }


@dataclass
class ConfEncoder:
    in_channels: int = MISSING
    channels: int = MISSING
    n_embeddings: int = MISSING
    z_dim: int = MISSING
    c_dim: int = MISSING


@dataclass
class ConfCPC:
    n_prediction_steps: int = MISSING
    n_speakers_per_batch: int = MISSING
    n_utterances_per_speaker: int = MISSING
    n_negatives: int = MISSING
    z_dim: int = MISSING
    c_dim: int = MISSING


@dataclass
class ConfModel:
    encoder: ConfEncoder = field(default_factory=ConfEncoder)
    cpc: ConfCPC = field(default_factory=ConfCPC)


@dataclass
class ConfTrainCPCSched:
    warmup_epochs: int = MISSING
    initial_lr: float = MISSING
    max_lr: float = MISSING
    gamma: float = MISSING
    milestones: List[int] = MISSING


@dataclass
class ConfTrainCPC:
    sample_frames: int = MISSING
    n_speakers_per_batch: int = MISSING
    n_utterances_per_speaker: int = MISSING
    n_prediction_steps: int = MISSING
    n_negatives: int = MISSING
    exclude_self_negatives: bool = False
    n_epochs: int = MISSING
    scheduler: ConfTrainCPCSched = field(default_factory=ConfTrainCPCSched)
    checkpoint_interval: int = MISSING
    log_interval: int = MISSING
    # Epochs per group: staged on the device in one copy and stepped through
    # the step graph (training/step_graph.py) on a card; logs and
    # checkpoints quantize to it, as in the JAX trainer's dispatch groups.
    epochs_per_dispatch: int = 1


@dataclass
class ConfTraining:
    cpc: ConfTrainCPC = field(default_factory=ConfTrainCPC)


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
    # The output head (OUTPUT_HEADS): "mulaw", RNN_MS's one softmax over
    # 2^bits_mu_law mu-law classes; "dual16", WaveRNN's dual softmax, a
    # 16-bit linear sample as a coarse and a fine byte (models/vocoder.py).
    output: str = "mulaw"
    wave_ar: ConfWaveAR = field(default_factory=ConfWaveAR)


@dataclass
class ConfVocoderNetwork:
    size_i_codebook: int = MISSING
    dim_i_embedding: int = MISSING
    dim_speaker_embedding: int = MISSING
    n_speakers: int = -1  # wired from training_vocoder.model.n_speakers
    rnnms: ConfRNNMS = field(default_factory=ConfRNNMS)


@dataclass
class ConfVocoderOptim:
    learning_rate: float = MISSING
    sched_milestones: List[int] = MISSING
    sched_gamma: float = MISSING


@dataclass
class ConfVocoderModel:
    sampling_rate: int = MISSING
    n_speakers: int = MISSING
    network: ConfVocoderNetwork = field(default_factory=ConfVocoderNetwork)
    optim: ConfVocoderOptim = field(default_factory=ConfVocoderOptim)


@dataclass
class ConfTrainer:
    max_epochs: int = MISSING
    val_interval_epoch: int = MISSING
    gradient_clip_val: float = 1.0
    # Steps per group: staged on the device in one copy and stepped through
    # the step graph on a card; checkpoint and preemption checks quantize to
    # it, as in the JAX trainer's dispatch groups.
    steps_per_dispatch: int = 1
    # Any value ("simple", "advanced") prints the data-wait / train-dispatch
    # report at the end of training.
    profiler: Optional[str] = None


@dataclass
class ConfCkptLog:
    dir_root: str = MISSING
    name_exp: str = MISSING
    name_version: str = MISSING


@dataclass
class ConfTrainVocoder:
    model: ConfVocoderModel = field(default_factory=ConfVocoderModel)
    trainer: ConfTrainer = field(default_factory=ConfTrainer)
    ckpt_log: ConfCkptLog = field(default_factory=ConfCkptLog)


@dataclass
class ConfCorpus:
    download: bool = False
    root: Optional[str] = None


@dataclass
class ConfDatasetCPC:
    clip_length_mel: int = -1  # derived: sample_frames + n_prediction_steps
    n_utterances_per_speaker: int = MISSING


@dataclass
class ConfDataset:
    name: str = MISSING
    adress_data_root: Optional[str] = None
    clip_length_mel: int = MISSING  # vocoder training clips, mel frames
    mel_stft_stride: int = MISSING
    preprocess: ConfPreprocessing = field(default_factory=ConfPreprocessing)
    cpc: ConfDatasetCPC = field(default_factory=ConfDatasetCPC)


@dataclass
class ConfLoader:
    batch_size: int = MISSING
    num_workers: Optional[int] = None
    pin_memory: Optional[bool] = None  # read by neither package; kept for the key path


@dataclass
class ConfData:
    adress_data_root: Optional[str] = None
    corpus: ConfCorpus = field(default_factory=ConfCorpus)
    dataset: ConfDataset = field(default_factory=ConfDataset)
    loader: ConfLoader = field(default_factory=ConfLoader)


@dataclass
class ConfRuntime:
    # The AR decode's mode (ops/ar_decode.resolve_precision): "bfloat16" /
    # "bf16" / "float32" decode through the bf16 kernel, as in the JAX
    # package; "int8" through the int8 kernel; "auto" picks per decode batch
    # the mode with the lower step time on the card. Vocoder validation
    # decodes at int8 only for "int8". The export's and training's compute
    # dtype: resolve_compute_dtype (bfloat16 for "int8" and "auto").
    precision: str = "bfloat16"
    # "cpu" runs on the CPU; null or "cuda" needs a CUDA card.
    platform: Optional[str] = None
    # A directory: both trainers write one profiler trace of a few steps
    # after the first dispatch group there (utils/profiling.trace).
    profile_dir: Optional[str] = None
    # The trainers' (data, model) mesh (parallel/mesh.py), the JAX
    # package's keys, one process per card: the batches split over
    # mesh_data ranks, the train state's wide tensors over mesh_model
    # (parallel/tensor.py: the JAX package's sharding rules). The CLIs start
    # the mesh_data x mesh_model ranks: all locally, or, with all three
    # cluster keys, an equal share of whole model groups on each of
    # num_processes hosts, the rendezvous at coordinator_address
    # ("host:port"); under torchrun its RANK / WORLD_SIZE / LOCAL_RANK.
    # Serving, convert and encode take no model axis, as in the JAX package.
    mesh_data: int = 1
    mesh_model: int = 1
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None


@dataclass
class ConfGlobal:
    seed: int = MISSING
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
    checkpoint_dir: str = MISSING
    resume: str = MISSING
    in_dir: str = MISSING
    out_dir: str = MISSING
    model: ConfModel = field(default_factory=ConfModel)
    training: ConfTraining = field(default_factory=ConfTraining)
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

# Keys of the JAX package's config (its configs.py CONF_DEFAULT_STR) that the
# port does not have: a file or override naming one raises, saying so.
JAX_ONLY_KEYS = frozenset({
    "dataset_name",
    "training_vocoder.model.network.rnnms.prenet.bidirectional",
    "runtime.use_pallas",
    "runtime.prng_impl",
    "runtime.num_cpu_devices",
})


# Keys the port has and the JAX package's config lacks (each at its default
# there is the JAX package's model).
PORT_ONLY_KEYS = frozenset({"training_vocoder.model.network.rnnms.output"})
OUTPUT_HEADS = ("mulaw", "dual16")


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
        node[parts[-1]] = yaml_subset.load_value(raw)
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
        if isinstance(v, list):
            return [resolve(x, seen) for x in v]
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
    if typing.get_origin(hint) is list:
        if not isinstance(value, list):
            raise ValueError(f"Expected list at '{path}', got {value!r}")
        (item,) = typing.get_args(hint)
        return [_coerce(item, v, path) for v in value]
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
        jax_only = sorted(k for k in (f"{path}.{u}" if path else u for u in unknown)
                          if k in JAX_ONLY_KEYS)
        raise ValueError(
            f"Unknown config key(s) at '{path or '<root>'}': {sorted(unknown)}"
            + (f"; {jax_only} belong to the JAX package's config and are not ported"
               if jax_only else "")
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
    """Derived fields, as in the JAX package's config (its ``configs.py:596-607``)."""
    model = conf.training_vocoder.model
    net = model.network
    net.rnnms.dim_i_feature = net.dim_i_embedding + net.dim_speaker_embedding
    net.n_speakers = model.n_speakers
    if net.rnnms.output not in OUTPUT_HEADS:
        raise ValueError(f"training_vocoder.model.network.rnnms.output={net.rnnms.output!r}: "
                         f"expected one of {OUTPUT_HEADS}")
    if net.rnnms.output == "dual16" and net.rnnms.wave_ar.size_h_rnn % 2:
        raise ValueError("rnnms.output=dual16 splits the AR GRU's state in two halves: "
                         f"size_h_rnn={net.rnnms.wave_ar.size_h_rnn} is odd")
    tc = conf.training.cpc
    conf.data.dataset.cpc.clip_length_mel = tc.sample_frames + tc.n_prediction_steps
    return conf


def load_conf(argv: Optional[List[str]] = None) -> ConfGlobal:
    """Defaults, then the ``path_extend_conf`` yaml file if one is given,
    then the ``key=value`` overrides (``sys.argv`` by default), as the JAX
    package's ``load_conf``; links resolved after both, every key
    validated, derived fields set."""
    if argv is None:
        argv = sys.argv[1:]
    cli = parse_cli_overrides(list(argv))
    tree = conf_default_tree()
    extend = cli.pop("path_extend_conf", None)
    if extend:
        with open(extend) as f:
            extension = yaml_subset.safe_load(f.read()) or {}
        if not isinstance(extension, dict):
            raise ValueError(f"path_extend_conf={extend}: the document is not a mapping")
        tree = _deep_merge(tree, extension)
    tree = _deep_merge(tree, cli)
    return conf_programatic(_instantiate(ConfGlobal, _resolve_interpolations(tree)))
