"""The readers of the program's spans: ``span_ms`` and ``idle_under``.

Their arithmetic on a hand-built trace summary and hand-built intervals
of the program (``utils/profiling.py:intervals``): clipping to the window,
one span open on two threads at once, an idle gap only partly under a
span; and silence where the program keeps no intervals.
"""

import pytest

from portbench.lib import harness, spans
from portbench.lib.trace import TraceSummary
from vectorquantizedcpc_tpu_torch.utils import profiling

MS = 1_000_000
T0 = 1_700_000_000 * 10**9  # the profiler's clock is Unix nanoseconds


def _run(summary):
    run = harness.Run({"name": "x"}, {}, {}, 1, 1.0, True, "cpu", None)

    class _T:
        pass

    run.tracer = _T()
    run.tracer.summary = summary
    return run


def _summary():
    """A 100 ms window: the card busy over [0, 40) and [60, 90) ms."""
    ops = {"kernel": [(T0, T0 + 40 * MS)], "Memcpy DtoH": [(T0 + 60 * MS, T0 + 90 * MS)]}
    return TraceSummary((T0, T0 + 100 * MS), ops, [("bench.window", T0, T0 + 100 * MS)])


def _keep(monkeypatch, *ivs):
    """The program keeps these (name, start ms, end ms, thread) intervals."""
    kept = [(name, T0 + a * MS, T0 + b * MS, tid, None, {}) for name, a, b, tid in ivs]
    monkeypatch.setattr(profiling, "intervals", lambda: list(kept), raising=False)


def _read(name, run):
    return harness.reader_module(name).read(name, run)


def test_the_metric_names_their_span():
    assert spans.metric_span("span_ms.data_wait.vocoder") == "data.wait"
    assert spans.metric_span("idle_under.serving_fetch.batch") == "serving.fetch"
    assert spans.metric_span("span_ms.step_dispatch.vocoder") == "step.dispatch"


def test_span_ms_counts_spans_that_start_in_the_window_clipped_to_its_end(monkeypatch):
    _keep(monkeypatch,
          ("data.wait", -5, 10, 1),    # starts before the window: not counted
          ("data.wait", 20, 24, 1),
          ("data.wait", 95, 130, 1),   # clipped to the window's end: 5 ms
          ("data.wait", 100, 110, 1),  # starts at the window's end: not counted
          ("data.assemble", 30, 32, 2))
    run = _run(_summary())
    assert _read("span_ms.data_wait.vocoder", run) == pytest.approx((4 + 5) / 2)
    assert _read("span_ms.data_assemble.vocoder", run) == pytest.approx(2.0)
    assert _read("span_ms.step_stage.vocoder", run) is None  # no such span kept


def test_idle_under_a_span_open_on_two_threads_counts_once(monkeypatch):
    """Idle gaps: [40, 60) and [90, 100). serving.expand is open over [35, 50)
    on one thread and [45, 55) on another: the union [35, 55) holds 15 ms of
    the first gap; [85, 120) holds the last 10 ms, clipped to the window."""
    _keep(monkeypatch,
          ("serving.expand", 35, 50, 1),
          ("serving.expand", 45, 55, 2),
          ("serving.expand", 85, 120, 1),
          ("serving.fetch", 10, 20, 1))  # under busy time only
    run = _run(_summary())
    assert _read("idle_under.serving_expand.batch", run) == pytest.approx(100 * 25 / 100)
    assert _read("idle_under.serving_fetch.batch", run) == pytest.approx(0.0)
    assert _read("idle_under.data_wait.vocoder", run) is None


def test_idle_under_a_gap_partly_under_a_span(monkeypatch):
    """[50, 70) covers half of the gap [40, 60) and 10 ms of busy time."""
    _keep(monkeypatch, ("step.stage", 50, 70, 1))
    run = _run(_summary())
    assert _read("idle_under.step_stage.vocoder", run) == pytest.approx(10.0)
    assert _read("span_ms.step_stage.vocoder", run) == pytest.approx(20.0)


@pytest.mark.parametrize("name", ["span_ms.serving_launch.batch",
                                  "idle_under.serving_expand.batch"])
def test_a_program_that_keeps_no_intervals_reads_nothing(monkeypatch, name):
    """The parent of these readers: its profiling module has no intervals."""
    monkeypatch.delattr(profiling, "intervals", raising=False)
    assert spans.intervals("serving.launch") == []
    assert _read(name, _run(_summary())) is None
