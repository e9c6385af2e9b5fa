"""The port's ``utils/profiling.py`` on the CPU (its spans: ``test_torch_spans.py``).

``trace`` writes one Chrome trace of a block into a directory and nothing
without one; ``device_time`` reads no device time from a CPU trace;
``enable_nan_checks`` toggles autograd's anomaly mode.
"""

import json

import pytest
import torch

from torch_port_util import module_time_limit, time_limit  # noqa: F401
from vectorquantizedcpc_tpu_torch.utils import profiling

TIME_LIMIT_S = 60  # each test's own limit (torch_port_util.time_limit)

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
