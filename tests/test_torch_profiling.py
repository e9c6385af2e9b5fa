"""The port's ``utils/profiling.py`` against the JAX package's, on the CPU.

``trace`` writes one Chrome trace of a block into a directory and nothing
without one; ``device_time`` reads no device time from a CPU trace;
``StepTimer`` counts and resets as the JAX package's on the same sequence
of ticks; ``enable_nan_checks`` toggles autograd's anomaly mode.
"""

import json

import pytest
import torch

from vectorquantizedcpc_tpu.utils import profiling as jax_profiling
from vectorquantizedcpc_tpu_torch.utils import profiling

torch.set_num_threads(1)


def test_trace_writes_one_chrome_trace(tmp_path):
    out = tmp_path / "prof"
    with profiling.trace(out) as prof:
        x = torch.randn(64, 64)
        (x @ x).relu().sum()
    assert prof is not None
    files = list(out.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    summary = profiling.device_time(prof, n_steps=1)
    assert summary == {"device_busy_ms": None, "device_ops_per_step": 0.0, "largest": []}


@pytest.mark.parametrize("profile_dir", [None, ""])
def test_trace_without_a_directory_does_nothing(tmp_path, monkeypatch, profile_dir):
    monkeypatch.chdir(tmp_path)
    with profiling.trace(profile_dir) as prof:
        torch.ones(3).sum()
    assert prof is None and not list(tmp_path.iterdir())


def test_step_timer_counts_and_resets_as_jax(monkeypatch):
    """Both timers on one fake clock: the same counts, origins and rates
    through ticks, reads with and without a reset, and an empty interval."""
    import time

    now = {"t": 10.0}
    monkeypatch.setattr(time, "time", lambda: now["t"])  # read by both modules
    ours, theirs = profiling.StepTimer(), jax_profiling.StepTimer()
    rates = []
    for ticks, t, reset in (([1, 2], 12.0, True), ([4], 13.0, False), ([1, 1, 1], 15.0, True),
                            ([], 15.5, True), ([2], 15.5, True)):
        for n in ticks:
            ours.tick(n)
            theirs.tick(n)
        now["t"] = t
        rates.append((ours.rate(reset=reset), theirs.rate(reset=reset)))
        assert (ours.count, ours.t0) == (theirs.count, theirs.t0)
    assert [a for a, _ in rates] == [b for _, b in rates]
    assert [a for a, _ in rates] == [3 / 2.0, 4 / 1.0, 7 / 3.0, 0.0, 0.0]


def test_enable_nan_checks_toggles_anomaly_mode():
    before = torch.is_anomaly_enabled()
    try:
        profiling.enable_nan_checks(True)
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan|NaN"):
            torch.sqrt(x).sum().backward()
        profiling.enable_nan_checks(False)
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(before)
