"""The port's segmented decode and continuous-batching server, on the CPU.

Against the port's own single-shot decode and against the JAX package's
``ContinuousBatcher`` (interpret mode), at small widths with hop 8.

Server against single shot: the plain decode's (B, H) @ (H, 3H) product
may sum in another order at B = 2 (the server's slots) than at B = 1 (one
request alone), and the greedy conditioning groups requests of one length,
so the two are held to each other under the prefix rule (identical classes
up to the first divergence, a near-tie of the single shot's scores there),
not bit for bit. Segment chaining, at one batch size, is exact.
"""

import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401
    SMALL, assert_prefix_parity, classes_of, jax_models, module_time_limit, port_models, time_limit,
)
from vectorquantizedcpc_tpu.infer import serving as jax_serving
from vectorquantizedcpc_tpu_torch.infer import serving
from vectorquantizedcpc_tpu_torch.infer.serving import ContinuousBatcher, compute_drain_schedule
from vectorquantizedcpc_tpu_torch.models.vocoder import build_conditioning_frames
from vectorquantizedcpc_tpu_torch.ops import ar_decode as port

TIME_LIMIT_S = 180  # each test's own limit (torch_port_util.time_limit)

torch.set_num_threads(1)

HOP = 8
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def models():
    conf, enc, vq, voc = jax_models(SMALL, seed=3)
    _, _, vocoder = port_models(SMALL, enc, vq, voc)
    return conf.training_vocoder.model.network, voc, vocoder


def _cond_proj(vocoder, w, z, spk):
    cond = build_conditioning_frames(vocoder, torch.as_tensor(z), torch.as_tensor(spk))
    return port.project_cond_frames(w, cond)  # (B, Tf, 3H) bf16


def _single_shot(vocoder, w, z, spk):
    """One request alone: (classes (T,), scores (T, C)) of the plain greedy decode."""
    cond = _cond_proj(vocoder, w, np.asarray(z)[None], [spk]).transpose(0, 1).contiguous()
    h0, prev0 = port.init_decode_state(1, w.wh.shape[0], 256, CPU)
    out, _, scores = port.ar_decode_reference(cond, h0, prev0, w, HOP, greedy=True,
                                              return_scores=True)
    return out[:, 0].numpy(), scores[:, 0].numpy()


def _hold_to_single_shot(vocoder, requests, waves_by_request):
    w = port.prep_decode_weights(vocoder)
    same = 0
    for (z, spk), waves in zip(requests, waves_by_request):
        ref, scores = _single_shot(vocoder, w, z, spk)
        for wave in waves:
            got = classes_of(wave, 256)
            assert got.shape == ref.shape == (2 * len(z) * HOP,)
            assert_prefix_parity(got[None], ref[None], scores[None], 0.05)
            same += int(np.array_equal(got, ref))
    return same


@pytest.mark.parametrize("greedy", [True, False])
def test_segment_chaining_matches_single_shot(models, rng, monkeypatch, greedy):
    """Three chained segments == one decode, bit for bit. Sampled, the single
    shot draws step t's noise with the seed of the segment that holds t."""
    _net, _voc, vocoder = models
    w = port.prep_decode_weights(vocoder)
    cond = _cond_proj(vocoder, w, rng.integers(0, 16, size=(2, 6)), [0, 2])  # 12 frames
    h0, prev0 = port.init_decode_state(2, w.wh.shape[0], 256, CPU)
    state, outs = port.DecodeState(h0, prev0), []
    for k, f0 in enumerate(range(0, 12, 4)):
        classes, state = port.fused_ar_decode_segment(
            w, cond[:, f0 : f0 + 4], state, port.segment_seed(9, k), HOP, greedy
        )
        assert classes.shape == (2, 4 * HOP) and classes.dtype == torch.int32
        outs.append(classes)
    if not greedy:
        bits, steps = port.gumbel_bits, 4 * HOP
        monkeypatch.setattr(
            port, "gumbel_bits",
            lambda seed, t, *a: bits(port.segment_seed(seed, t // steps), t % steps, *a),
        )
    single, h_t = port.ar_decode(cond.transpose(0, 1).contiguous(), h0, prev0, w, HOP,
                                 seed=9, greedy=greedy)
    assert torch.equal(torch.cat(outs, dim=1), single.t())
    assert torch.equal(state.h, h_t) and torch.equal(state.prev, single[-1])


def test_drain_schedule_matches_jax():
    """Tables, reassembly map, pos0 map and valid count, exactly, on 30
    random mixes with requests already in flight."""
    rng = np.random.default_rng(11)
    for trial in range(30):
        s_count = int(rng.integers(1, 9))
        sf = int(rng.choice([2, 4, 8]))
        rid = 0
        slots_live = [None] * s_count
        for i in range(s_count):
            if rng.random() < 0.4:
                total = int(rng.integers(1, 40))
                pos = int(rng.integers(0, total))
                slots_live[i] = [rid, i, pos - pos % sf, total]
                rid += 1
        rid_row = {a[0]: a[1] for a in slots_live if a is not None}
        queued = []
        for total in sorted(rng.integers(1, 60, size=int(rng.integers(0, 20))), reverse=True):
            rid_row[rid] = 100 + rid
            queued.append((rid, 100 + rid, int(total)))
            rid += 1
        got = compute_drain_schedule(s_count, sf, 160, slots_live, list(queued), rid_row)
        want = jax_serving.compute_drain_schedule(
            s_count, sf, 160, slots_live, list(queued), rid_row
        )
        for k in range(3):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"table {k}, trial {trial}")
        assert got[3:] == want[3:], f"trial {trial}"


REQUESTS = [(8, 0), (12, 1), (4, 3), (10, 2), (6, 1)]


def test_greedy_server_matches_single_shot_and_jax(models):
    net, voc, vocoder = models
    rng = np.random.default_rng(5)
    requests = [(rng.integers(0, 16, size=n), spk) for n, spk in REQUESTS]
    server = ContinuousBatcher(vocoder, slots=2, segment_frames=4, max_frames=64,
                               greedy=True, device="cpu")
    rids = [server.submit(z, s) for z, s in requests]
    waves = server.run()
    assert set(waves) == set(rids)
    assert server.stats["samples_out"] == sum(2 * len(z) * HOP for z, _ in requests)
    jax_server = jax_serving.ContinuousBatcher(voc, net, slots=2, segment_frames=4,
                                               max_frames=64, greedy=True, interpret=True)
    jax_rids = [jax_server.submit(z, s) for z, s in requests]
    jax_waves = jax_server.run()
    pairs = [(waves[r], np.asarray(jax_waves[j])) for r, j in zip(rids, jax_rids)]
    same = _hold_to_single_shot(vocoder, requests, pairs)
    assert same >= len(requests)  # most requests agree outright


def test_greedy_server_with_32_slots_matches_single_shot(models):
    """Past the AR kernel's old 8-row cap: the plain route takes any slot
    count, as the JAX server does. 40 requests over 32 slots, two waves."""
    _net, _voc, vocoder = models
    rng = np.random.default_rng(8)
    requests = [(rng.integers(0, 16, size=int(n)), int(s))
                for n, s in zip(rng.integers(2, 9, size=40), rng.integers(0, 4, size=40))]
    server = ContinuousBatcher(vocoder, slots=32, segment_frames=4, max_frames=32,
                               greedy=True, device="cpu")
    rids = [server.submit(z, s) for z, s in requests]
    waves = server.run()
    assert set(waves) == set(rids)
    assert server.stats["samples_out"] == sum(2 * len(z) * HOP for z, _ in requests)
    same = _hold_to_single_shot(vocoder, requests, [[waves[r]] for r in rids])
    assert same >= len(requests) // 2


def test_incremental_then_drain_matches_single_shot(models):
    """step() admits and decodes segment by segment (one stream finishes on
    the third call); run() then drains the streams in flight, prefixed with
    what step() decoded, and the queue."""
    _net, _voc, vocoder = models
    rng = np.random.default_rng(6)
    requests = [(rng.integers(0, 16, size=n), spk) for n, spk in [(10, 0), (6, 2), (12, 1), (4, 3)]]
    server = ContinuousBatcher(vocoder, slots=2, segment_frames=4, max_frames=64,
                               greedy=True, device="cpu")
    rids = [server.submit(z, s) for z, s in requests]
    assert server.step() == [] and server.step() == []
    assert server.step() == [rids[1]]  # 12 frames in three segments of 4
    assert server.step() == []  # the third request entered the freed slot
    waves = server.run()
    assert set(waves) == set(rids)
    assert server.stats["steps"] >= 4
    _hold_to_single_shot(vocoder, requests, [[waves[r]] for r in rids])


@pytest.mark.parametrize(
    "kwargs, submit_codes, error, match",
    [
        (dict(max_frames=8), 5, ValueError, "max_frames=8"),
        (dict(slots=0), 0, ValueError, "at least one slot"),
        (dict(precision="fp8"), 0, ValueError, "precision"),
    ],
)
def test_server_refuses(models, kwargs, submit_codes, error, match):
    _net, _voc, vocoder = models
    with pytest.raises(error, match=match):
        server = ContinuousBatcher(vocoder, segment_frames=4, device="cpu", **kwargs)
        server.submit(np.zeros(submit_codes, np.int32), 0)


def test_sampled_drain_is_seeded_and_goes_through_the_ragged_prenet(models, monkeypatch):
    _net, _voc, vocoder = models
    rng = np.random.default_rng(7)
    requests = [(rng.integers(0, 16, size=n), spk) for n, spk in REQUESTS]
    calls = []
    ragged = serving.build_conditioning_frames_ragged
    monkeypatch.setattr(serving, "build_conditioning_frames_ragged",
                        lambda *a, **k: calls.append(k) or ragged(*a, **k))

    def drain(seed, materialize=True):
        server = ContinuousBatcher(vocoder, slots=3, segment_frames=4, max_frames=32,
                                   seed=seed, device="cpu")
        rids = [server.submit(z, s) for z, s in requests]
        out = server.run(materialize=materialize)
        if not materialize:
            assert out == {}
            out = {r: server.result(r) for r in rids}
        assert server.stats["samples_out"] == sum(2 * len(z) * HOP for z, _ in requests)
        return [out[r] for r in rids]

    a, b, c = drain(5), drain(5, materialize=False), drain(6)
    assert calls == [{"use_kernel": True}] * 3  # one ragged pass per drain
    for (z, _s), wa, wb in zip(requests, a, b):
        assert wa.shape == (2 * len(z) * HOP,) and wa.dtype == np.float32
        assert np.abs(wa).max() <= 1.0
        np.testing.assert_array_equal(wa, wb)
    assert any(not np.array_equal(wa, wc) for wa, wc in zip(a, c))


def test_server_needs_a_card_unless_asked_for_the_cpu(models, monkeypatch):
    _net, _voc, vocoder = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatcher(vocoder, device=None)
