"""Streaming encode: bit for bit a full f32 encode in the port, and the JAX package's within 1e-5."""

import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401
    SMALL, jax_models, module_time_limit, port_models, time_limit,
)
from vectorquantizedcpc_tpu.infer.streaming import encode_streaming as jax_encode_streaming
from vectorquantizedcpc_tpu_torch.infer.streaming import StreamingEncoder, encode_streaming

TIME_LIMIT_S = 60  # each test's own limit (torch_port_util.time_limit)

torch.set_num_threads(1)

CHUNK = 32


@pytest.fixture(scope="module")
def models():
    conf, enc, vq, voc = jax_models(SMALL, seed=7)
    _, encoder, _ = port_models(SMALL, enc, vq, voc)
    return enc, vq, encoder


@pytest.mark.parametrize("t", [20, 64, 77, 130])  # shorter than a chunk, even, odd
def test_streaming_matches_full_encode(models, rng, t):
    """Equal to a full encode of the even-length prefix, bit for bit; equal to
    the JAX streaming encoder within 1e-5 (codes exactly)."""
    enc, vq, encoder = models
    mel = rng.normal(size=(80, t)).astype(np.float32)
    t_even = t // 2 * 2
    z, c, codes = encode_streaming(encoder, mel, chunk_frames=CHUNK, device="cpu")
    z_full, c_full, codes_full = encoder.encode(torch.from_numpy(mel[None, :, :t_even]))
    assert codes.shape == (1, t // 2)
    assert torch.equal(codes, codes_full)
    assert torch.equal(z, z_full) and torch.equal(c, c_full)
    z_r, c_r, codes_r = jax_encode_streaming(enc, vq, mel, chunk_frames=CHUNK)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_r))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_r), atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_r), atol=1e-5)


def test_incremental_pushes_and_a_second_utterance(models, rng):
    """Any push granularity gives the same frames; after flush the encoder
    starts the next utterance afresh."""
    _, _, encoder = models
    mel = rng.normal(size=(80, 100)).astype(np.float32)
    stream = StreamingEncoder(encoder, chunk_frames=16, device="cpu")
    cuts = [0, 7, 20, 33, 70, 100]
    outs = [stream.push(mel[:, a:b]) for a, b in zip(cuts, cuts[1:])] + [stream.flush()]
    got = [torch.cat(p, dim=1) for p in zip(*[o for o in outs if o is not None])]
    want = encoder.encode(torch.from_numpy(mel[None]))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    again = [torch.cat(p, dim=1) for p in zip(*[o for o in (stream.push(mel), stream.flush())
                                                 if o is not None])]
    for g, w in zip(again, want):
        assert torch.equal(g, w)


def test_streaming_needs_a_card_unless_asked_for_the_cpu(models, monkeypatch):
    _, _, encoder = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingEncoder(encoder)
    with pytest.raises(ValueError, match="chunk_frames"):
        StreamingEncoder(encoder, chunk_frames=7, device="cpu")
