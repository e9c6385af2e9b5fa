"""The GRU scans' plain versions and the ragged PreNet against the JAX package.

The CUDA kernels run only on the card: chip_smoke.py and
tests/test_torch_kernels_gpu.py hold them against ``gru_scan_reference``
and ``gru_scan_masked_reference`` there. Here those plain versions are held
against the JAX Pallas kernels in interpret mode, and the port's ragged
conditioning against the JAX one on both routes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_util import (  # noqa: F401
    SMALL, jax_models, module_time_limit, port_models, time_limit,
)
from vectorquantizedcpc_tpu.models.vocoder import (
    build_conditioning_frames_ragged as jax_ragged,
)
from vectorquantizedcpc_tpu.ops.gru_train import (
    fused_gru_scan as jax_scan,
    fused_gru_scan_masked as jax_scan_masked,
)
from vectorquantizedcpc_tpu_torch.models.vocoder import build_conditioning_frames_ragged
from vectorquantizedcpc_tpu_torch.ops import gru_train as port

TIME_LIMIT_S = 180  # each test's own limit (torch_port_util.time_limit)

torch.set_num_threads(1)

# One bf16 ulp of an |h| < 1 value is at most 2^-8 = 3.9e-3: where the two
# sums (taken in other orders) straddle a rounding boundary, hs differs by
# one ulp there, and the next steps see that through the gates, damped.
HS_ATOL = 8e-3


def _scan_inputs(rng, t=7, b=5, hidden=16):
    h3 = 3 * hidden
    return (
        rng.uniform(-1, 1, size=(hidden, h3)).astype(np.float32) / np.sqrt(hidden),
        rng.uniform(-0.3, 0.3, size=(h3,)).astype(np.float32),
        rng.normal(0, 0.8, size=(t, b, h3)).astype(np.float32),
        rng.uniform(-0.5, 0.5, size=(b, hidden)).astype(np.float32),
    )


def _torch(wh, bh, xproj, h0):
    """The kernels' operand types: bf16 wh and xproj, f32 bh and h0."""
    return (
        torch.from_numpy(wh).bfloat16(),
        torch.from_numpy(bh),
        torch.from_numpy(xproj).bfloat16(),
        torch.from_numpy(h0),
    )


@pytest.mark.parametrize("masked", [False, True])
def test_plain_scan_matches_pallas_kernel(rng, masked):
    wh, bh, xproj, h0 = _scan_inputs(rng)
    t, b = xproj.shape[:2]
    lengths = np.array([1, t, 3, 0, 5])  # reverse-time layout: valid at t >= T - len
    valid = (np.arange(t)[:, None] >= t - lengths[None, :]).astype(np.int32)
    jargs = (jnp.asarray(wh), jnp.asarray(bh), jnp.asarray(xproj).astype(jnp.bfloat16),
             jnp.asarray(h0))
    args = _torch(wh, bh, xproj, h0)
    if masked:
        ref = jax_scan_masked(*jargs[:3], jnp.asarray(valid), jargs[3], True)
        hs, h_t = port.gru_scan_masked_reference(*args[:3], torch.from_numpy(valid), args[3])
        # A row masked at every step keeps h0; one valid only at the end moves once.
        torch.testing.assert_close(h_t[3], args[3][3], rtol=0, atol=0)
        assert torch.equal(hs[:, 3], args[3][3].bfloat16()[None].expand(t, -1))
    else:
        ref = jax_scan(*jargs, True)
        hs, h_t = port.gru_scan_reference(*args)
    assert hs.dtype == torch.bfloat16 and hs.shape == (t, b, 16)
    assert h_t.dtype == torch.float32 and h_t.shape == (b, 16)
    torch.testing.assert_close(hs[-1].float(), h_t, rtol=0, atol=4e-3)
    np.testing.assert_allclose(hs.float().numpy(), np.asarray(ref, np.float32), atol=HS_ATOL)


@pytest.fixture(scope="module")
def models():
    conf, enc, vq, voc = jax_models(SMALL, seed=4)
    _, _, vocoder = port_models(SMALL, enc, vq, voc)
    return conf.training_vocoder.model.network, voc, vocoder


def _ragged_batch(rng):
    n_codes = [3, 7, 5, 8, 1, 4]  # frames 2..16: a row of length 1 code and the maximum
    zs = np.zeros((len(n_codes), max(n_codes)), np.int32)
    for i, n in enumerate(n_codes):
        zs[i, :n] = rng.integers(0, 16, size=n)
    spks = np.arange(len(n_codes), dtype=np.int32) % 4
    return n_codes, zs, spks, np.asarray([2 * n for n in n_codes], np.int32)


@pytest.mark.parametrize("use_kernel, atol", [(False, 1e-5), (True, 3e-2)])
def test_ragged_conditioning_matches_jax(models, rng, use_kernel, atol):
    """f32 route against JAX's f32 route (1e-5); the kernel route against
    JAX ``use_pallas`` in interpret mode at the bf16 tolerance of
    tests/test_vocoder.py:227 -- on every row's valid prefix."""
    net, voc, vocoder = models
    n_codes, zs, spks, n_frames = _ragged_batch(rng)
    ref = jax_ragged(voc, net, jnp.asarray(zs), jnp.asarray(spks), jnp.asarray(n_frames),
                     use_pallas=use_kernel, pallas_interpret=use_kernel)
    ours = build_conditioning_frames_ragged(
        vocoder, torch.from_numpy(zs).long(), torch.from_numpy(spks).long(),
        torch.from_numpy(n_frames), use_kernel=use_kernel,
    )
    assert ours.dtype == (torch.bfloat16 if use_kernel else torch.float32)
    assert ours.shape == (len(n_codes), 2 * max(n_codes), 16)
    for i, n in enumerate(n_codes):
        np.testing.assert_allclose(
            ours[i, : 2 * n].float().numpy(), np.asarray(ref[i, : 2 * n], np.float32), atol=atol
        )


def test_cpu_tensors_take_the_plain_version(rng):
    wh, bh, xproj, h0 = _torch(*_scan_inputs(rng, t=4, b=3, hidden=8))
    valid = torch.ones(4, 3, dtype=torch.int32)
    before = (port.GRU_SCAN_LAUNCHES, port.GRU_SCAN_MASKED_LAUNCHES)
    hs, h_t = port.gru_scan(wh, bh, xproj, h0)
    hs_m, h_m = port.gru_scan_masked(wh, bh, xproj, valid, h0)
    assert (port.GRU_SCAN_LAUNCHES, port.GRU_SCAN_MASKED_LAUNCHES) == before
    ref, ref_h = port.gru_scan_reference(wh, bh, xproj, h0)
    assert torch.equal(hs, ref) and torch.equal(h_t, ref_h)
    # An all-valid mask is the unmasked scan.
    assert torch.equal(hs_m, ref) and torch.equal(h_m, ref_h)
    assert torch.equal(port.fused_gru_scan(wh, bh, xproj, h0), ref)


@pytest.mark.parametrize(
    "field, bad, match",
    [
        ("xproj", lambda x: x.float(), "xproj"),
        ("wh", lambda x: x.float(), "wh"),
        ("bh", lambda x: x.bfloat16(), "bh"),
        ("h0", lambda x: x[:, :-1], "h0"),
        ("valid", lambda x: x.bool(), "valid"),
        ("valid", lambda x: x[:-1], "valid"),
        ("xproj", lambda x: x.transpose(0, 1).contiguous().transpose(0, 1), "contiguous"),
    ],
)
def test_wrappers_refuse_bad_input(rng, field, bad, match):
    wh, bh, xproj, h0 = _torch(*_scan_inputs(rng, t=4, b=3, hidden=8))
    args = dict(wh=wh, bh=bh, xproj=xproj, valid=torch.ones(4, 3, dtype=torch.int32), h0=h0)
    args[field] = bad(args[field])
    with pytest.raises(ValueError, match=match):
        port.gru_scan_masked(**args)
    if field != "valid":
        del args["valid"]
        with pytest.raises(ValueError, match=match):
            port.gru_scan(**args)


def test_hidden_beyond_shared_memory_is_refused():
    """The kernel keeps wh in the registers of a warp per 16 units, at most
    12 warps: H <= 192. Shared memory holds two 8-row bf16 h tiles, the
    xproj ring (and the fragments past 8 K steps), far below one block's
    limit."""
    assert port.scan_smem_bytes(128) == 2 * 2 * 8 * 136 + 2 * 3 * 8 * 392 + 96 == 23264
    assert port.scan_plan(192)[1] <= port.MAX_WARPS < port.scan_plan(193)[1]
    assert port.scan_smem_bytes(192) <= port.SMEM_LIMIT
    big = 193
    wh = torch.zeros(big, 3 * big, dtype=torch.bfloat16)
    args = (wh, torch.zeros(3 * big), torch.zeros(2, 1, 3 * big, dtype=torch.bfloat16),
            torch.zeros(1, big))
    port.check_scan_inputs(*args)  # the plain version takes any width
    with pytest.raises(ValueError, match="registers"):
        port.check_scan_inputs(*args, kernel=True)


@pytest.mark.parametrize(
    "hidden, threads, warps, smem",
    [
        (1, 32, 1, 2 * 2 * 8 * (16 + 8) + 2 * 3 * 8 * 11 + 96),  # one unit: K padded to 16
        (40, 96, 3, 2 * 2 * 8 * (48 + 8) + 2 * 3 * 8 * 128 + 96),  # H not a multiple of 16
        (128, 256, 8, 23264),  # the serving PreNet: every fragment in registers
        (129, 288, 9, 4864 + 2 * 3 * 8 * 395 + 96 + 16 * 32 * 3 * 9 * 1),  # a K step shared
        (192, 384, 12, 6400 + 2 * 3 * 8 * 584 + 96 + 16 * 32 * 3 * 12 * 4),  # the limit
    ],
)
def test_scan_plan(hidden, threads, warps, smem):
    """gru_scan.cu's block: a warp per 16 units (threads = 32 x warps), two
    bf16 h tiles of 8 rows of K + 8, a 3-stage ring of 8 xproj rows of 3H +
    8 bf16 and of 8 mask words, and the A fragments of the K steps past the
    8 held in registers, 16 bytes a lane per warp, gate and step."""
    assert port.scan_plan(hidden) == (threads, warps, smem)
    assert port.scan_smem_bytes(hidden) == smem <= port.SMEM_LIMIT
    assert port.scan_route(hidden) == "block"
