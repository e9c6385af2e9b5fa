"""The per-layer readers: their arithmetic, and silence where there is nothing to read."""

import pytest

from portbench.lib import harness
from portbench.lib.trace import TraceSummary
from portbench.roofline import ar_decode

BENCH = harness.load_benchmark()
LAYER = [m["name"] for m in BENCH["per_layer"]]


def _run(counters=None, calls=None, summary=None):
    run = harness.Run({"name": "x"}, {}, {}, 1, 1.0, True, "cpu", None)
    run.counters.update(counters or {})
    run.calls.update(calls or {})

    class _T:
        pass

    if summary is not None:
        run.tracer = _T()
        run.tracer.summary = summary
    return run


@pytest.mark.parametrize("name", LAYER)
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    assert harness.reader_module(name).read(name, _run()) is None


def _summary():
    ms = 1_000_000
    ops = {"void ar_decode_kernel<false, false>(DecodeArgs)": [(0, 60 * ms), (70 * ms, 130 * ms)],
           "copy": [(50 * ms, 80 * ms)]}
    return TraceSummary((0, 200 * ms), ops, [("bench.window", 0, 200 * ms),
                                             ("bench.step", 130 * ms, 200 * ms)])


def test_the_trace_summary():
    s = _summary()
    assert s.window_s == 0.2 and abs(s.busy_s - 0.13) < 1e-12
    assert s.kernel_seconds(("ar_decode_kernel",)) == (0.12, 2)
    assert s.idle_gaps() == [["bench.step", 0.07]]
    assert s.top_ops(1)[0][1] == 0.12


def test_device_idle_and_roofline():
    call = dict(batch=64, steps=5120, hidden=896, fc=256, classes=256, frames=32)
    run = _run(calls={"ar_decode": [call, call]}, summary=_summary())
    idle = harness.reader_module("device_idle.serve_open").read("device_idle.serve_open", run)
    assert abs(idle - 35.0) < 1e-9
    roof = harness.reader_module("roofline.ar_decode.open").read("roofline.ar_decode.open", run)
    assert abs(roof - 100 * 2 * ar_decode.least(call) / 0.12) < 1e-9
    run.calls["ar_decode"] = [call]  # one call for two launches: not attributable
    assert harness.reader_module("roofline.x").read("roofline.ar_decode.open", run) is None


def test_host_and_fill_counters():
    stats = {"samples_out": 5120.0 * 3, "dispatch_wall_s": 0.5, "steps": 2.0}
    run = _run(counters={"stats_window": stats, "slots": 4, "segment_frames": 32, "hop": 160})
    assert harness.reader_module("serve_host_ms.x").read("serve_host_ms.batch", run) == 250.0
    assert harness.reader_module("slot_fill.x").read("slot_fill.batch", run) == 37.5
    run = _run(counters={"steps": 4, "data_wait_s": 0.002})
    assert harness.reader_module("data_wait_ms.x").read("data_wait_ms.cpc", run) == 0.5


def test_mfu():
    run = _run(counters={"conf": {}, "traced_steps": 10, "batch": 32, "samples": 5120},
               summary=_summary())
    from portbench.roofline import models, peaks

    want = 100 * 10 * models.vocoder_train_step(models.widths({}), 32, 5120) / 0.2
    want /= peaks.BF16_FLOPS
    assert abs(harness.reader_module("mfu.x").read("mfu.vocoder", run) - want) < 1e-9
