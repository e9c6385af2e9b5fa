"""Voice conversion: source wav + target speaker -> converted wav.

For each synthesis-list triple ``[wav_path, speaker_id, out_filename]``:

    load wav @16k -> BS.1770 loudness -> mel -> encoder codes
    -> vocoder decode with the target speaker -> loudness-match -> write wav

Utterances are grouped into padded batches by 32-frame length buckets, so
that the sample-by-sample decode serves several utterances at once. The
decode mode is resolved per batch (``runtime.precision`` "auto" may pick
int8 for a full batch and bf16 for the smaller last one of a bucket). Work is
queued on the device without waiting, with at most 3 batches in flight:
the host's loudness matching and wav writing for one batch overlap the
device's decode of the next.
"""

import json
from collections import deque
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..configs import ConfGlobal
from ..device import resolve_device
from ..dsp.audio_io import read_wav, write_wav
from ..dsp.loudness import integrated_loudness, normalize_loudness
from ..dsp.mel import wave_to_mel
from ..models.encoder import Encoder
from ..models.vocoder import Vocoder
from ..ops.ar_decode import fused_ar_decode, resolve_precision
from ..weights import load_vocoder_checkpoint
from .encode import load_encoder_checkpoint

QUANTUM = 32  # mel frames per length bucket
WINDOW = 3  # batches in flight


def _load_speakers(in_dir: Path) -> List[str]:
    """speakers.json (sorted; id = index), or the preprocessing manifest's list."""
    for cand in (in_dir / "speakers.json", in_dir / "index.json"):
        if cand.exists():
            with open(cand) as f:
                data = json.load(f)
            if isinstance(data, list):
                return sorted(data)
            if "speakers" in data:
                return list(data["speakers"])
    raise FileNotFoundError(f"No speakers.json or index.json under {in_dir}")


def load_models(conf: ConfGlobal, device: torch.device) -> Tuple[Encoder, Vocoder]:
    """Both models, on ``device``, from reference ``.pt`` checkpoints or the
    JAX package's ``model.ckpt-{n}`` (of a vocoder train state its
    ``params``), each told apart by its contents."""
    encoder = load_encoder_checkpoint(conf.cpc_checkpoint, conf)
    vocoder = Vocoder(conf.training_vocoder.model.network)
    vocoder.load_state_dict(
        load_vocoder_checkpoint(conf.vocoder_checkpoint), strict=True
    )
    return encoder.to(device).eval(), vocoder.to(device).eval()


def convert(
    conf: ConfGlobal,
    batch_size: int = 8,
    device: Optional[Union[str, torch.device]] = None,
) -> int:
    """Convert every utterance of the synthesis list; returns their number.

    Runs on ``device``, else on ``runtime.platform``, else on the CUDA card;
    raises when no card is there and the CPU was not asked for.
    """
    device = resolve_device(device if device is not None else conf.runtime.platform)
    precision = conf.runtime.precision
    resolve_precision(precision, batch_size)  # an unknown mode fails before any work
    in_dir, out_dir = Path(conf.in_dir), Path(conf.out_dir)
    speakers = _load_speakers(in_dir)
    with open(conf.synthesis_list) as f:
        synthesis_list = json.load(f)
    out_dir.mkdir(exist_ok=True, parents=True)

    print(f"Load checkpoints from: {conf.cpc_checkpoint}, {conf.vocoder_checkpoint}")
    encoder, vocoder = load_models(conf, device)
    weights = {}  # prepared decode weights by mode, filled by fused_ar_decode

    pp = conf.data.dataset.preprocess
    jobs = []
    for wav_path, speaker_id, out_filename in synthesis_list:
        wav, _ = read_wav((in_dir / wav_path).with_suffix(".wav"), sr=pp.sr)
        jobs.append(
            {
                "loudness": integrated_loudness(wav, pp.sr),
                "mel": wave_to_mel(wav, pp),
                "speaker": speakers.index(speaker_id),
                "out": out_filename,
            }
        )

    buckets = {}
    for i, job in enumerate(jobs):
        padded = max(QUANTUM, -(-job["mel"].shape[1] // QUANTUM) * QUANTUM)
        buckets.setdefault(padded, []).append(i)

    pending: deque = deque()

    def flush_one() -> int:
        chunk, wave_dev = pending.popleft()
        waves = wave_dev.cpu().numpy()
        for j, i in enumerate(chunk):
            # floor(T / 2) codes -> x2 frames -> x hop samples.
            n_samples = (jobs[i]["mel"].shape[1] // 2) * 2 * conf.data.dataset.mel_stft_stride
            out_wave = np.asarray(waves[j][:n_samples], np.float64)
            out_wave = normalize_loudness(
                out_wave, integrated_loudness(out_wave, pp.sr), jobs[i]["loudness"]
            )
            write_wav(
                (out_dir / jobs[i]["out"]).with_suffix(".wav"),
                out_wave.astype(np.float32),
                pp.sr,
            )
        return len(chunk)

    n_done = n_dispatched = 0
    for padded_len, idxs in sorted(buckets.items()):
        for b0 in range(0, len(idxs), batch_size):
            chunk = idxs[b0 : b0 + batch_size]
            mels = np.zeros((len(chunk), pp.n_mels, padded_len), np.float32)
            for j, i in enumerate(chunk):
                mels[j, :, : jobs[i]["mel"].shape[1]] = jobs[i]["mel"]
            spk = torch.tensor([jobs[i]["speaker"] for i in chunk], device=device)
            _, codes = encoder.encode(torch.from_numpy(mels).to(device), return_context=False)
            # The seed depends only on how many utterances went before.
            wave = fused_ar_decode(
                vocoder, codes, spk, seed=n_dispatched, precision=precision,
                weights=weights,
            )
            pending.append((chunk, wave))
            n_dispatched += len(chunk)
            if len(pending) >= WINDOW:
                n_done += flush_one()
    while pending:
        n_done += flush_one()
    return n_done
