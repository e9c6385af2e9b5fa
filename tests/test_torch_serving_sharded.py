"""The port's sharded server (``ContinuousBatcher(devices=[...])``) on the CPU.

Two shards on the CPU ("cpu", "cpu") at the widths of
``torch_port_util.SMALL`` with hop 8: greedy output against the one-device
server (bit for bit: the schedule and the conditioning rows are computed
once, and the plain decode sums each row in one order from two rows up)
and against the JAX package's server on a data = 2 mesh (interpret mode)
under the prefix rule of ``tests/test_torch_serving.py``; sampled output
seeded and decorrelated between shards; the refusals.
"""

import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401
    SMALL, jax_models, module_time_limit, port_models, time_limit,
)
from vectorquantizedcpc_tpu.infer import serving as jax_serving
from vectorquantizedcpc_tpu.parallel.mesh import make_mesh
from vectorquantizedcpc_tpu_torch.infer.serving import ContinuousBatcher

from test_torch_serving import REQUESTS, _hold_to_single_shot

TIME_LIMIT_S = 180  # each test's own limit (torch_port_util.time_limit)

torch.set_num_threads(1)

SHARDS = ["cpu", "cpu"]


@pytest.fixture(scope="module")
def models():
    conf, enc, vq, voc = jax_models(SMALL, seed=3)
    _, _, vocoder = port_models(SMALL, enc, vq, voc)
    return conf.training_vocoder.model.network, voc, vocoder


def _requests(seed: int):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 16, size=n), spk) for n, spk in REQUESTS + [(6, 0), (8, 3)]]


def _drain(vocoder, requests, **kwargs):
    server = ContinuousBatcher(vocoder, slots=4, segment_frames=4, max_frames=64, **kwargs)
    rids = [server.submit(z, s) for z, s in requests]
    waves = server.run()
    assert set(waves) == set(rids)
    assert server.stats["samples_out"] == sum(2 * len(z) * 8 for z, _ in requests)
    return [waves[r] for r in rids]


def test_greedy_sharded_equals_one_device_and_jax(models):
    net, voc, vocoder = models
    requests = _requests(5)
    sharded = _drain(vocoder, requests, greedy=True, devices=SHARDS)
    one = _drain(vocoder, requests, greedy=True, device="cpu")
    for a, b in zip(sharded, one):
        np.testing.assert_array_equal(a, b)
    jax_server = jax_serving.ContinuousBatcher(voc, net, slots=4, segment_frames=4,
                                               max_frames=64, greedy=True, interpret=True,
                                               mesh=make_mesh(data=2))
    jax_rids = [jax_server.submit(z, s) for z, s in requests]
    jax_waves = jax_server.run()
    pairs = [(a, np.asarray(jax_waves[j])) for a, j in zip(sharded, jax_rids)]
    same = _hold_to_single_shot(vocoder, requests, pairs)
    assert same >= len(requests)  # most requests agree outright


def test_incremental_steps_then_drain_equal_one_device(models):
    """step() admits into each shard's slots and decodes one segment on every
    shard; run() then drains what is in flight and the queue."""
    _net, _voc, vocoder = models
    requests = _requests(6)
    outs = []
    for kwargs in (dict(devices=SHARDS), dict(device="cpu")):
        server = ContinuousBatcher(vocoder, slots=4, segment_frames=4, max_frames=64,
                                   greedy=True, **kwargs)
        rids = [server.submit(z, s) for z, s in requests]
        finished = [server.step() for _ in range(3)]
        waves = server.run()
        outs.append((finished, [waves[r] for r in rids]))
    assert outs[0][0] == outs[1][0]
    for a, b in zip(outs[0][1], outs[1][1]):
        np.testing.assert_array_equal(a, b)


def test_sampled_is_seeded_and_shards_draw_their_own_noise(models):
    """Four copies of one request fill slots 0-3: shard 0 holds slots 0-1,
    shard 1 slots 2-3. The same seed gives the same bits; slot 0 and slot 2
    (row 0 of each shard's launch) draw other noise, as JAX folds the shard
    index into its key."""
    _net, _voc, vocoder = models
    z = np.random.default_rng(7).integers(0, 16, size=8)
    requests = [(z, 1)] * 4
    a = _drain(vocoder, requests, seed=11, devices=SHARDS)
    b = _drain(vocoder, requests, seed=11, devices=SHARDS)
    for wa, wb in zip(a, b):
        np.testing.assert_array_equal(wa, wb)
        assert np.abs(wa).max() <= 1.0
    assert not np.array_equal(a[0], a[2])  # request i runs in slot i
    one = _drain(vocoder, requests, seed=11, device="cpu")
    assert any(not np.array_equal(x, y) for x, y in zip(a, one))


@pytest.mark.parametrize("kwargs, match", [
    (dict(slots=3, devices=SHARDS), r"slots=3 must divide over the 2 devices"),
    (dict(slots=4, devices=SHARDS, device="cpu"), "give device or devices"),
])
def test_sharded_server_refuses(models, kwargs, match):
    _net, _voc, vocoder = models
    with pytest.raises(ValueError, match=match):
        ContinuousBatcher(vocoder, segment_frames=4, **kwargs)
