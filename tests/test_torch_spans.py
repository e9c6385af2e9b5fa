"""The program's spans (``utils/profiling.py``) and where they open, on the CPU.

The registry: totals always; intervals, with their parent and ids, only
while a profiler collects, on every thread; the bound and its dropped
count; the stamps on the clock of the profiler's own events. Then the
spans of the server (``serving.*`` and its ``stats``), the prefetch loader
(``data.*``) and the step graph (``step.*``), counted against the work.
"""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_port_util import SMALL, module_time_limit, time_limit  # noqa: F401
from vectorquantizedcpc_tpu_torch.utils import profiling
from vectorquantizedcpc_tpu_torch.utils.profiling import span

TIME_LIMIT_S = 120  # each test's own limit (torch_port_util.time_limit)

torch.set_num_threads(1)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _delta(before, name):
    """(count, seconds) of ``name`` since the ``before`` totals."""
    n0, s0 = before.get(name, (0, 0.0))
    n1, s1 = profiling.totals().get(name, (0, 0.0))
    return n1 - n0, s1 - s0


def _named(name):
    return [iv for iv in profiling.intervals() if iv[0] == name]


@pytest.fixture(autouse=True)
def _fresh_intervals():
    profiling.reset()
    yield
    profiling.reset()


# ------------------------------------------------------------ the registry


def test_spans_count_into_the_totals_with_no_profiler():
    before = profiling.totals()
    for _ in range(3):
        with span("data.wait"):
            time.sleep(0.002)
    n, seconds = _delta(before, "data.wait")
    assert n == 3 and 0.006 <= seconds < 1.0
    assert not profiling.collecting() and profiling.intervals() == []


def test_intervals_with_parent_and_ids_while_a_profiler_collects():
    with _cpu_profile():
        assert profiling.collecting()
        with span("serving.launch", segment=7):
            with span("serving.expand", rid=3):
                pass
        with span("serving.fetch"):
            pass
    with span("serving.fetch"):  # the profiler has stopped: no interval
        pass
    got = {iv[0]: iv for iv in profiling.intervals()}
    assert len(profiling.intervals()) == 3 and set(got) == {
        "serving.launch", "serving.expand", "serving.fetch"}
    launch, expand, fetch = got["serving.launch"], got["serving.expand"], got["serving.fetch"]
    assert launch[4] is None and launch[5] == {"segment": 7}
    assert expand[4] == "serving.launch" and expand[5] == {"rid": 3}
    assert fetch[4] is None and fetch[5] == {}
    assert launch[1] <= expand[1] <= expand[2] <= launch[2] <= fetch[1] <= fetch[2]
    assert {iv[3] for iv in got.values()} == {threading.get_ident()}


def test_a_worker_thread_records_under_the_profiler_of_another():
    """The profiler opened on the main thread: a span on a worker records its
    interval there, on its own thread, with its own parent chain."""
    done = []

    def worker():
        with span("data.assemble"):
            with span("step.stage"):
                pass
        done.append(threading.get_ident())

    with _cpu_profile():
        with span("data.wait"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
    by_name = {iv[0]: iv for iv in profiling.intervals()}
    assert by_name["data.assemble"][3] == by_name["step.stage"][3] == done[0]
    assert by_name["data.wait"][3] == threading.get_ident() != done[0]
    assert by_name["data.assemble"][4] is None  # data.wait is open on another thread
    assert by_name["step.stage"][4] == "data.assemble"


def test_the_bound_drops_intervals_and_counts_them(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_INTERVALS", 3)
    before = profiling.totals()
    with _cpu_profile():
        for rid in range(5):
            with span("serving.expand", rid=rid):
                pass
    assert [iv[5]["rid"] for iv in profiling.intervals()] == [0, 1, 2]
    assert profiling.dropped() == 2 and _delta(before, "serving.expand")[0] == 5
    profiling.reset()
    assert profiling.intervals() == [] and profiling.dropped() == 0


def test_threads_closing_spans_at_once_lose_no_count():
    """More threads than cores close spans of one name at a fine switch
    interval, under a profiler: every count, second and interval is kept."""
    import os
    import sys

    n_threads, n_spans = 2 * (os.cpu_count() or 1) + 2, 500
    together = threading.Barrier(n_threads, timeout=60)

    def closer():
        together.wait()  # every thread alive at once
        for _ in range(n_spans):
            with span("data.assemble"):
                pass
        together.wait()

    before = profiling.totals()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            threads = [threading.Thread(target=closer) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert _delta(before, "data.assemble")[0] == n_threads * n_spans
    assert len(_named("data.assemble")) == n_threads * n_spans
    assert len({iv[3] for iv in _named("data.assemble")}) == n_threads


def test_stamps_sit_on_the_profilers_clock():
    """Each span's interval against its record_function event in the same
    trace: start and end within 100 us."""
    with _cpu_profile() as prof:
        for rid in range(3):
            with span("serving.expand", rid=rid):
                time.sleep(0.003)
    events = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "serving.expand")
    ours = sorted((iv[1], iv[2]) for iv in _named("serving.expand"))
    assert len(events) == len(ours) == 3
    for (a, b), (c, d) in zip(events, ours):
        assert abs(a - c) < 100_000 and abs(b - d) < 100_000


# ------------------------------------------------------------- the server


@pytest.fixture(scope="module")
def vocoder():
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder

    torch.manual_seed(5)
    return Vocoder(load_conf(list(SMALL)).training_vocoder.model.network).eval()


def _server(vocoder, greedy=False):
    from vectorquantizedcpc_tpu_torch.infer.serving import ContinuousBatcher

    return ContinuousBatcher(vocoder, slots=2, segment_frames=4, max_frames=64,
                             greedy=greedy, seed=1, device="cpu")


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 16, size=int(rng.integers(2, 7))), int(rng.integers(0, 4)))
            for _ in range(n)]


@pytest.mark.parametrize("greedy", [False, True])
def test_run_then_result_spans(vocoder, greedy):
    """A planned drain of 5 requests: one serving.launch per segment (the
    stats' steps); per segment, as the host takes its samples, one
    serving.fetch and then one serving.expand with its segment, between
    the launches; and the conditioning passes."""
    server = _server(vocoder, greedy)
    reqs = _requests(5)
    before, stats0 = profiling.totals(), server.stats
    with _cpu_profile():
        rids = [server.submit(z, s) for z, s in reqs]
        server.run(materialize=False, wait=False)
        waves = {rid: server.result(rid) for rid in rids}
    stats1 = server.stats
    steps = stats1["steps"] - stats0["steps"]
    assert steps > 0 and _delta(before, "serving.launch")[0] == steps
    launches = _named("serving.launch")
    assert [iv[5]["segment"] for iv in launches] == list(range(int(stats0["steps"]),
                                                               int(stats1["steps"])))
    segments = [iv[5]["segment"] for iv in launches]
    fetches, expands = _named("serving.fetch"), _named("serving.expand")
    assert _delta(before, "serving.fetch")[0] == len(fetches) == steps
    assert _delta(before, "serving.expand")[0] == steps
    assert [iv[5]["segment"] for iv in expands] == segments  # in launch order
    for fetch, expand in zip(fetches, expands):
        assert fetch[2] <= expand[1]  # each segment's wait, then its expansion
    assert all(iv[4] is None for iv in fetches + expands)  # not inside a launch
    lengths = {len(z) for z, _s in reqs}
    assert _delta(before, "serving.condition")[0] == (len(lengths) if greedy else 1)
    assert {rid: len(w) for rid, w in waves.items()} == {
        rid: 2 * len(z) * 8 for rid, (z, _s) in zip(rids, reqs)}
    assert stats1["admitted"] - stats0["admitted"] == len(reqs)


def test_step_counts_admissions_and_queue_wait(vocoder):
    """step(): one serving.admit per admitted request, with its rid; the
    stats' admitted and queue_wait_s are sums that two snapshots subtract."""
    server = _server(vocoder)
    reqs = _requests(4, seed=1)
    before, stats0 = profiling.totals(), server.stats
    with _cpu_profile():
        t_submit = time.perf_counter()
        rids = [server.submit(z, s) for z, s in reqs]
        time.sleep(0.01)
        server.step()  # two slots: two admitted
        stats1 = server.stats
        finished = []
        while len(finished) < len(rids):
            finished += server.step()
        stats2 = server.stats
        for rid in rids:
            server.result(rid)
    waited = time.perf_counter() - t_submit
    assert stats1["admitted"] - stats0["admitted"] == 2
    assert stats2["admitted"] - stats0["admitted"] == 4
    first = stats1["queue_wait_s"] - stats0["queue_wait_s"]
    assert 2 * 0.01 <= first <= 2 * waited
    assert first < stats2["queue_wait_s"] - stats0["queue_wait_s"] <= 4 * waited
    assert _delta(before, "serving.admit")[0] == 4
    assert sorted(iv[5]["rid"] for iv in _named("serving.admit")) == sorted(rids)
    assert all(iv[4] is None for iv in _named("serving.admit"))
    assert {iv[4] for iv in _named("serving.condition")} == {"serving.admit"}
    steps = stats2["steps"] - stats0["steps"]
    assert _delta(before, "serving.launch")[0] == steps
    assert _delta(before, "serving.expand")[0] == _delta(before, "serving.fetch")[0] == 4
    assert sorted(finished) == sorted(rids)


# ------------------------------------------------------ the loader and step


class _Batches:
    """A map-style dataset of 10 items whose batch assembly takes 2 ms."""

    def __len__(self):
        return 10

    def sample_batch(self, indices):
        time.sleep(0.002)
        return (np.asarray(indices, np.int64),)


@pytest.mark.parametrize("prefetch", [1, 2])
def test_the_loader_waits_and_assembles_once_a_batch(prefetch):
    from vectorquantizedcpc_tpu_torch.data.loader import PrefetchLoader

    loader = PrefetchLoader(_Batches(), batch_size=3, seed=2, prefetch=prefetch)
    before = profiling.totals()
    with _cpu_profile():
        batches = list(loader)
    assert len(batches) == 3
    assert _delta(before, "data.assemble")[0] == 3
    assert _delta(before, "data.wait")[0] == 4  # three batches, then the end
    assert _delta(before, "data.assemble")[1] >= 3 * 0.002
    main = threading.get_ident()
    assert {iv[3] for iv in _named("data.wait")} == {main}
    assert len(_named("data.assemble")) == 3
    assert main not in {iv[3] for iv in _named("data.assemble")}


def test_the_step_graph_dispatches_once_a_step():
    from vectorquantizedcpc_tpu_torch.training.step_graph import StepGraph, stage

    w = torch.zeros(3, requires_grad=True)
    opt = torch.optim.SGD([w], lr=0.1)

    def step_fn(x):
        opt.zero_grad()
        loss = ((w - x) ** 2).sum()
        loss.backward()
        opt.step()
        return {"loss": loss.detach()}

    graph = StepGraph(step_fn, opt, "cpu")
    before = profiling.totals()
    with _cpu_profile():
        xs = stage([np.ones(3, np.float32)] * 4, "cpu")
        for x in xs:
            graph.step((x,), 0.1)
    assert _delta(before, "step.stage")[0] == 1 and xs.shape == (4, 3)
    assert _delta(before, "step.dispatch")[0] == 4 == graph.eager_steps
    assert len(_named("step.dispatch")) == 4 and float(w.detach()[0]) > 0
