"""Small cells for the CPU: the real traffic and config files at tiny widths.

``small_run`` builds a :class:`portbench.lib.harness.Run` of a cell (of
``BENCHMARK.json``, or one with only its traffic file) on the CPU, with the configuration's widths and the
traffic's sizes cut so that the program's plain versions and the
reference finish in seconds.
"""

import copy
import tempfile
from pathlib import Path

import torch

from portbench.lib import harness

SMALL_CONF = {
    "size_latent_codebook": 16, "dim_latent": 8, "dim_cpc_context": 12,
    "model.encoder.channels": 16, "dim_mel_freq": 8,
    "training.cpc.sample_frames": 16, "training.cpc.n_speakers_per_batch": 2,
    "training.cpc.n_utterances_per_speaker": 2, "training.cpc.n_prediction_steps": 4,
    "training.cpc.n_negatives": 3,
    "training_vocoder.model.n_speakers": 4,
    "training_vocoder.model.network.dim_speaker_embedding": 8,
    "training_vocoder.model.network.rnnms.dim_voc_latent": 16,
    "training_vocoder.model.network.rnnms.wave_ar.size_i_embed_ar": 16,
    "training_vocoder.model.network.rnnms.wave_ar.size_h_rnn": 32,
    "training_vocoder.model.network.rnnms.wave_ar.size_h_fc": 16,
    "data.dataset.mel_stft_stride": 8, "data.dataset.clip_length_mel": 8,
    "data.loader.batch_size": 4, "sampling_rate": 800,
}

SMALL_TRAFFIC = {
    "server": {"slots": 4, "segment_frames": 2},
    "lengths": {"median_s": 0.2, "sigma": 0.3, "min_s": 0.1, "max_s": 0.4, "codes_per_s": 50},
    "arrivals": {"rate_per_s": 20.0},
    "requests_per_s": 12,
    "grace_s": 20,
    "judge_requests": 3,
    "epochs_per_dispatch": 2,
}

SMALL_CORPUS = {"n_speakers": 8, "utterances_per_speaker": 3, "utterance_seconds": [0.4, 0.6]}


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        elif k in out:
            out[k] = v
    return out


def small_run(workload: str, seed: int = 5, seconds: float = 1.0, traffic: dict = None):
    cell, config, full_traffic = harness.candidate_cell(harness.load_benchmark(), workload)
    config = copy.deepcopy(config)
    config["conf"].update(SMALL_CONF)
    config["conf"]["training_vocoder.model.n_speakers"] = SMALL_CORPUS["n_speakers"]
    config["corpus"].update(SMALL_CORPUS)
    small = _merge(full_traffic, SMALL_TRAFFIC)
    small = _merge(small, traffic or {})
    workdir = Path(tempfile.mkdtemp(prefix="portbench-test-"))
    return harness.Run(cell, config, small, seed, seconds, False, torch.device("cpu"), workdir)
