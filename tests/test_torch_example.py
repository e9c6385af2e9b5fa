"""``examples/full_pipeline_torch.py --cpu``: the port's five CLIs chained.

Runs the example in a subprocess at 2 CPC epochs (preprocess -> train_cpc
-> encode -> train_vocoder -> convert on the synthetic corpus, each CLI its
own process) and checks the exported codes and the converted wav.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from torch_port_util import module_time_limit, time_limit  # noqa: F401
from vectorquantizedcpc_tpu_torch.dsp.audio_io import read_wav

ROOT = Path(__file__).resolve().parents[1]
RUN_LIMIT_S = 480  # about 90 s on 2 free cores
TIME_LIMIT_S = RUN_LIMIT_S + 60


def test_full_pipeline_example_on_the_cpu(tmp_path):
    ws = tmp_path / "ws"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "full_pipeline_torch.py"), "--cpu",
         "--epochs", "2", "--workdir", str(ws)],
        cwd=ROOT, env={**os.environ, "JAX_PLATFORMS": "cpu"}, capture_output=True, text=True,
        timeout=RUN_LIMIT_S,
    )
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "Converted 1 utterances" in proc.stdout
    assert (ws / "ckpt" / "model.ckpt-2.pt").exists()
    mels = sorted((ws / "features").glob("*/*.mel.npy"))
    codes = sorted((ws / "codes").glob("*.txt"))
    assert len(mels) == len(codes) == 40
    for mel in mels[:4]:
        rows = np.loadtxt(ws / "codes" / f"{mel.name[: -len('.mel.npy')]}.txt", ndmin=2)
        assert rows.shape == (np.load(mel).shape[1] // 2, 16) and np.isfinite(rows).all()
    wave, sr = read_wav(ws / "converted" / "demo_vc.wav")
    assert sr == 16000 and wave.size > 0
    assert np.isfinite(wave).all() and np.abs(wave).max() <= 1.0
