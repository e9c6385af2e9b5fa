"""The planned drain's streamed output, on the CPU.

A drain writes each segment's samples into their requests' waveforms as
the host takes them, not the whole job's after the last launch. Each
waveform is held bit for bit to the launches' own output, recorded as the
benchmark's faults wrap the segment decode, and put together the way a
drain did before it streamed: every launch stacked into a (steps, slots,
samples) timeline, each request's segments sliced out of its slot, then
the head's ``to_wave``. Both heads (mu-law and dual16), greedy and
sampled, ragged lengths that leave slots idle, a drain that starts with
requests in flight (``step()`` first), two CPU shards; two jobs on one
server, so that ``stats["expanded_in_flight"]`` is seen to be a running
sum. On the CPU a segment is on the host once its launch returns, so
every segment but the drain's last is expanded while the drain decodes.
"""

import numpy as np
import pytest
import torch

from torch_port_util import SMALL, module_time_limit, time_limit  # noqa: F401
from vectorquantizedcpc_tpu_torch.configs import load_conf
from vectorquantizedcpc_tpu_torch.infer import serving
from vectorquantizedcpc_tpu_torch.infer.serving import ContinuousBatcher
from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder
from vectorquantizedcpc_tpu_torch.ops.heads import decode_head

TIME_LIMIT_S = 180  # each test's own limit (torch_port_util.time_limit)

torch.set_num_threads(1)

HOP = 8
SF = 4  # segment frames
SLOTS = 4
HEADS = {"mulaw": SMALL, "dual16": SMALL + ["training_vocoder.model.network.rnnms.output=dual16"]}
CASES = [(head, case) for head in HEADS for case in ("ragged", "in_flight", "two_shards")
         if (head, case) != ("dual16", "two_shards")]  # the dual head serves on one device


@pytest.fixture(scope="module")
def vocoders():
    out = {}
    for head, argv in HEADS.items():
        torch.manual_seed(11)
        out[head] = Vocoder(load_conf(list(argv)).training_vocoder.model.network).eval()
    return out


@pytest.fixture
def recorded(monkeypatch):
    """Every segment launch's output, in launch order, and every drain's
    schedule tables."""
    launches, schedules = [], []
    for name in ("fused_ar_decode_segment", "fused_dual_decode_segment"):
        real = getattr(serving, name)

        def launch(*args, _real=real, **kwargs):
            out, state = _real(*args, **kwargs)
            launches.append(out.clone())
            return out, state

        monkeypatch.setattr(serving, name, launch)
    schedule = serving.compute_drain_schedule
    monkeypatch.setattr(serving, "compute_drain_schedule",
                        lambda *a: schedules.append(schedule(*a)) or schedules[-1])
    return launches, schedules


def _requests(rng, n):
    """Ragged lengths: odd code counts leave a ragged last segment."""
    return [(rng.integers(0, 16, size=int(rng.integers(1, 12))), int(rng.integers(0, 4)))
            for _ in range(n)]


def _job(server, requests, steps_first, launches, schedules, shards, to_wave, returned):
    """Submit ``requests``, run ``steps_first`` step() calls, drain with
    run(materialize=False, wait=False), then result() in rid order: (the
    rids, the waveforms, the expected ones, the samples of the drain's last
    segment). The drain returns only what result() had (``returned``)."""
    first_launch = len(launches)
    rids = [server.submit(z, s) for z, s in requests]
    for _ in range(steps_first):
        server.step()
    assert set(server.run(materialize=False, wait=False)) == returned
    waves = [server.result(rid) for rid in rids]

    per_step = [torch.cat(launches[i : i + shards])
                for i in range(first_launch, len(launches), shards)]
    timeline = torch.stack(per_step).numpy()  # (steps, slots, sf * hop)
    rows_t, _pos_t, _fresh_t, rid_sched, _pos0, _valid = schedules[-1]
    assert (rows_t < 0).any()  # slots idle at some step
    expected, last = [], 0
    seg = SF * HOP
    for j, (rid, (z, _s)) in enumerate(zip(rids, requests)):
        frames = 2 * len(z)
        if j < SLOTS and steps_first:  # admitted by step() into slot j at its first launch
            slot, g0 = j, 0
        else:
            slot, s0, _n = rid_sched[rid]
            g0 = steps_first + s0
        nseg = -(-frames // SF)
        expected.append(to_wave(timeline[g0 : g0 + nseg, slot].reshape(-1)[: frames * HOP]))
        if g0 + nseg == timeline.shape[0]:
            last += frames * HOP - (nseg - 1) * seg
    return rids, waves, expected, last


@pytest.mark.parametrize("head, case", CASES)
@pytest.mark.parametrize("greedy", [True, False])
def test_streamed_drain_equals_the_launches_output(vocoders, recorded, head, case, greedy):
    launches, schedules = recorded
    vocoder = vocoders[head]
    shards = 2 if case == "two_shards" else 1
    placement = dict(devices=["cpu", "cpu"]) if shards == 2 else dict(device="cpu")
    server = ContinuousBatcher(vocoder, slots=SLOTS, segment_frames=SF, max_frames=32,
                               greedy=greedy, seed=3, **placement)
    to_wave = decode_head(vocoder.conf.rnnms, "bf16", torch.device("cpu")).to_wave
    steps_first = 1 if case == "in_flight" else 0
    rng = np.random.default_rng(7)
    snaps, returned, in_flight = [server.stats], set(), []
    for n in (9, 6):  # two jobs on one server
        requests = _requests(rng, n)
        rids, waves, expected, last = _job(server, requests, steps_first, launches, schedules,
                                           shards, to_wave, returned)
        returned |= set(rids)
        snaps.append(server.stats)
        for (z, _s), got, want in zip(requests, waves, expected):
            assert got.dtype == np.float32 and got.shape == (2 * len(z) * HOP,)
            np.testing.assert_array_equal(got, want)
        in_flight.append(schedules[-1][-1] - last)  # the drain's samples but its last step's
        assert snaps[-1]["expanded_in_flight"] - snaps[-2]["expanded_in_flight"] == in_flight[-1]
    # a sum since the server was made: each job adds its own
    assert snaps[0]["expanded_in_flight"] == 0
    assert snaps[2]["expanded_in_flight"] == sum(in_flight) and min(in_flight) > 0
