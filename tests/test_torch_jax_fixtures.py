"""The committed JAX-made fixtures (``tests/fixtures/jax_ckpt``) are what their script writes.

A fresh run of ``tests/torch_port_jax_fixtures.py`` (the JAX package's
CLIs, about 50 s on the CPU) must give the same files: the same tree
structure, dtypes and shapes in both checkpoints with values within 1e-6
(not the same bytes: XLA's CPU sums may take other orders with other thread
counts), the same mels, wavs and JSON files. The test of what the port does
with them is ``tests/test_torch_jax_checkpoint.py``.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import torch_port_jax_fixtures as fixtures
from torch_port_util import module_time_limit, time_limit  # noqa: F401
from vectorquantizedcpc_tpu_torch.dsp.audio_io import read_wav
from vectorquantizedcpc_tpu_torch.training.checkpoint import read_jax_checkpoint

TIME_LIMIT_S = 300  # each test's own limit (torch_port_util.time_limit)

torch.set_num_threads(1)


def _files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _compare_trees(got, want, path):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _compare_trees(got[k], want[k], f"{path}/{k}")
        return
    assert type(got) is type(want), path
    if isinstance(want, torch.Tensor):
        got, want = got.float().numpy(), want.float().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=path)


def _write_fresh(out_dir: Path) -> Path:
    """``fixtures.write_fixtures`` in a process of its own, with the JAX
    settings of ``tests/conftest.py``: the JAX CLIs leave threads running
    (their tensorboardX writers) that must not outlive this module."""
    code = "\n".join([
        "import sys",
        "import jax",
        "jax.config.update('jax_platforms', 'cpu')",
        "jax.config.update('jax_num_cpu_devices', 8)",
        "jax.config.update('jax_default_matmul_precision', 'highest')",
        f"sys.path.insert(0, {str(Path(fixtures.__file__).parent)!r})",
        "import torch_port_jax_fixtures",
        f"torch_port_jax_fixtures.write_fixtures({str(out_dir)!r})",
    ])
    subprocess.run([sys.executable, "-c", code], check=True, timeout=TIME_LIMIT_S - 30)
    return out_dir


def test_committed_fixtures_match_a_fresh_run(tmp_path):
    fresh = _write_fresh(tmp_path / "jax_ckpt")
    committed = fixtures.DEFAULT_DIR
    assert _files(fresh) == _files(committed)
    total = 0
    for rel in _files(committed):
        a, b = fresh / rel, committed / rel
        total += b.stat().st_size
        if rel.endswith(".json"):
            assert json.loads(a.read_text()) == json.loads(b.read_text()), rel
        elif rel.endswith(".mel.npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b), err_msg=rel)
        elif rel.endswith(".wav"):
            np.testing.assert_array_equal(read_wav(a)[0], read_wav(b)[0], err_msg=rel)
        else:
            _compare_trees(read_jax_checkpoint(a), read_jax_checkpoint(b), rel)
    assert total < 1.5 * 2 ** 20, total
    argv = json.loads((committed / "argv.json").read_text())
    assert argv["cpc"] == fixtures.CPC and argv["vocoder"] == fixtures.VOCODER
