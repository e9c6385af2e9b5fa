"""The AR decode's plain version against the JAX Pallas kernel (interpret mode).

The CUDA kernel itself runs only on the card; chip_smoke.py holds it
against ``ar_decode_reference`` there. Here the plain version, which is what
the kernel is compared with, is held against the JAX package.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import (  # noqa: F401
    SMALL, assert_prefix_parity, classes_of, jax_models, module_time_limit, port_models, time_limit,
)
from vectorquantizedcpc_tpu.ops.ar_decode import fused_ar_decode as jax_fused
from vectorquantizedcpc_tpu_torch.ops import ar_decode as port

TIME_LIMIT_S = 180  # each test's own limit (torch_port_util.time_limit)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    conf, enc, vq, voc = jax_models(SMALL, seed=2)
    _, _, vocoder = port_models(SMALL, enc, vq, voc)
    return conf.training_vocoder.model.network, voc, vocoder


def _decode_inputs(vocoder, z, spk):
    from vectorquantizedcpc_tpu_torch.models.vocoder import build_conditioning_frames

    w = port.prep_decode_weights(vocoder)
    cond = build_conditioning_frames(vocoder, torch.from_numpy(z), torch.from_numpy(spk))
    cond_proj = port.project_cond_frames(w, cond).transpose(0, 1).contiguous()
    h0, prev0 = port.init_decode_state(len(z), w.wh.shape[0], 256, torch.device("cpu"))
    return w, cond_proj, h0, prev0


def test_plain_bf16_greedy_matches_pallas_kernel(models, rng):
    """bf16 greedy: prefix-exact against the Pallas kernel, near-tie <= 0.05."""
    net, voc, vocoder = models
    z = rng.integers(0, 16, size=(2, 6))
    spk = np.array([1, 3])
    ref = jax_fused(voc, net, jnp.asarray(z), jnp.asarray(spk), jax.random.key(5),
                    chunk=16, greedy=True, interpret=True)
    w, cond_proj, h0, prev0 = _decode_inputs(vocoder, z, spk)
    samples, h_t, scores = port.ar_decode_reference(
        cond_proj, h0, prev0, w, hop=8, greedy=True, return_scores=True
    )
    assert samples.shape == (96, 2) and h_t.shape == (2, 32)
    ours = samples.t().numpy()
    ref_classes = classes_of(ref, 256)
    # Scores are the plain version's: the Pallas kernel exposes none.
    assert_prefix_parity(ref_classes, ours, scores.transpose(0, 1).numpy(), 0.05)
    assert np.mean(ours == ref_classes) > 0.95
    wave = port.fused_ar_decode(vocoder, torch.from_numpy(z), torch.from_numpy(spk), greedy=True)
    np.testing.assert_array_equal(classes_of(wave.numpy(), 256), ours)


def test_plain_bf16_greedy_at_32_rows_matches_pallas_kernel(models, rng):
    """B = 32, past the old 8-row cap: prefix-exact against the Pallas kernel."""
    net, voc, vocoder = models
    z = rng.integers(0, 16, size=(32, 3))
    spk = rng.integers(0, 4, size=32)
    ref = jax_fused(voc, net, jnp.asarray(z), jnp.asarray(spk), jax.random.key(6),
                    chunk=16, greedy=True, interpret=True)
    w, cond_proj, h0, prev0 = _decode_inputs(vocoder, z, spk)
    samples, _, scores = port.ar_decode_reference(
        cond_proj, h0, prev0, w, hop=8, greedy=True, return_scores=True
    )
    ours = samples.t().numpy()
    assert ours.shape == (32, 48)
    ref_classes = classes_of(ref, 256)
    assert_prefix_parity(ref_classes, ours, scores.transpose(0, 1).numpy(), 0.05)
    assert np.mean(ours == ref_classes) > 0.95


def test_sampled_plain_decode_in_range_and_seeded(models, rng):
    net, voc, vocoder = models
    z = torch.from_numpy(rng.integers(0, 16, size=(3, 4)))
    spk = torch.tensor([0, 2, 3])
    draw = lambda s: port.fused_ar_decode(vocoder, z, spk, seed=s)
    w1, w2, w3 = draw(7), draw(7), draw(8)
    assert w1.shape == (3, 64) and float(w1.abs().max()) <= 1.0
    assert torch.equal(w1, w2) and not torch.equal(w1, w3)
    # The JAX sampled kernel only by range: its on-core PRNG has no port.
    ref = jax_fused(voc, net, jnp.asarray(z.numpy()), jnp.asarray(spk.numpy()),
                    jax.random.key(1), chunk=32, interpret=True)
    assert ref.shape == w1.shape and float(jnp.abs(ref).max()) <= 1.0


def test_gumbel_bits_match_uint32_arithmetic():
    """The int64 split-multiply hash equals the plain uint32 hash (the kernel's)."""
    def mix(x):
        x = np.uint32(x)
        with np.errstate(over="ignore"):
            x ^= x >> np.uint32(16)
            x *= np.uint32(0x7FEB352D)
            x ^= x >> np.uint32(15)
            x *= np.uint32(0x846CA68B)
            x ^= x >> np.uint32(16)
        return x

    for seed, step in [(0, 0), (12345, 7), (2**32 - 1, 99999), (-3, 1)]:
        bits = port.gumbel_bits(seed, step, 3, 5, "cpu").numpy()
        key = mix(np.uint32(mix(np.uint32(seed & 0xFFFFFFFF)) ^ np.uint32(step)))
        expect = [[int(mix(key ^ np.uint32(b * 5 + c))) for c in range(5)] for b in range(3)]
        np.testing.assert_array_equal(bits, np.array(expect, np.int64))
    u_noise = port.gumbel_noise(port.gumbel_bits(1, 2, 8, 256, "cpu"))
    assert torch.isfinite(u_noise).all() and u_noise.dtype == torch.float32


def test_cpu_tensors_take_the_plain_version(models, rng):
    net, voc, vocoder = models
    z = rng.integers(0, 16, size=(1, 3))
    w, cond_proj, h0, prev0 = _decode_inputs(vocoder, z, np.array([2]))
    before = port.AR_DECODE_LAUNCHES
    out, h_t = port.ar_decode(cond_proj, h0, prev0, w, hop=8, seed=4)
    ref, ref_h = port.ar_decode_reference(cond_proj, h0, prev0, w, hop=8, seed=4)
    assert port.AR_DECODE_LAUNCHES == before
    assert torch.equal(out, ref) and torch.equal(h_t, ref_h)


@pytest.mark.parametrize(
    "field, bad",
    [
        ("cond_proj", lambda x: x.float()),
        ("prev0", lambda x: x.long()),
        ("h0", lambda x: x[:, :-1]),
        ("wh", lambda x: x.t()),
    ],
)
def test_kernel_input_checks(models, rng, field, bad):
    """The wrapper refuses what the kernel does not take, before any launch."""
    net, voc, vocoder = models
    w, cond_proj, h0, prev0 = _decode_inputs(vocoder, rng.integers(0, 16, size=(2, 3)),
                                             np.array([0, 1]))
    args = dict(cond_proj=cond_proj, h0=h0, prev0=prev0)
    bad_w = w
    if field in args:
        args[field] = bad(args[field])
    else:
        bad_w = w._replace(**{field: bad(getattr(w, field))})
    with pytest.raises(ValueError):
        port._check_kernel_inputs(args["cond_proj"], args["h0"], args["prev0"], bad_w, 8)
    with pytest.raises(ValueError, match="rows"):  # 130 rows > MAX_BATCH = 128
        big = cond_proj.repeat(1, 65, 1)
        port._check_kernel_inputs(big, h0.repeat(65, 1), prev0.repeat(65), w, 8)


@pytest.mark.parametrize(
    "batch, mode, smem",
    [
        (1, "bf16", 201440),
        (8, "bf16", 202208),
        (64, "bf16", 200288),
        (128, "bf16", 207456),
        (1, "int8", 174736),
        (8, "int8", 175504),
        (128, "int8", 180752),
    ],
)
def test_decode_plan_at_the_reference_widths(batch, mode, smem):
    """The kernel's plan at H 896, F 256, C 256 on an H100's 132 SMs: 128
    blocks of 7 units. A block holds 23 A rows (21 wh columns, 2 FC1
    columns) and a zero row of K (1,792 bf16 or 896 int8 bytes, + 64 pad),
    fc2^T as 16 x 8 x 32 lanes x 32 bytes of fragments (128 KB), 21
    embedding columns, hproj and the carry of its units per row, 8 partial
    tiles where K is split over the warps (under 8 row tiles), its biases,
    8 FC1 rows of 256 bf16 (+ 64 pad) to sample; int8 also its scales."""
    rb = 1792 if mode == "bf16" else 896
    assert port.exchange_row_bytes(896, mode) == rb
    grid, units, got = port.decode_plan(batch, 896, 256, 256, mode)
    assert (grid, units, got) == (128, 7, smem)
    w = 1 if mode == "int8" else 2
    parts = [24 * (rb + 64), 131072, 256 * 21 * w, 4 * batch * 21, 4 * batch * 7,
             (8 if batch < 57 else 0) * 2 * 512, 4 * (21 + 2 + 256), 8 * (512 + 64),
             176 if mode == "int8" else 0, 512, 256, 256]
    assert got == sum(-(-p // 16) * 16 for p in parts)
    assert got <= 232448  # one H100 block's shared memory


def test_decode_plan_other_widths():
    """Units per block and FC1 columns per block as the grid divides them;
    exchanged rows padded to whole 64-byte K blocks."""
    assert port.decode_plan(3, 1001, 256, 256)[:2] == (126, 8)
    assert port.decode_plan(70, 37, 11, 64)[:2] == (37, 1)
    assert port.decode_plan(8, 301, 33, 100, "int8")[:2] == (101, 3)
    assert port.exchange_row_bytes(37, "bf16") == 128
    assert port.exchange_row_bytes(301, "int8") == 320


def test_summarize_stamps_on_a_synthetic_buffer():
    """Two blocks' rows: globaltimer and clock64 at the first step's start
    and the last step's end, then each step's cycles per phase. At 2
    cycles per ns, 2,000 cycles are 1 us; the first step is left out."""
    n_ph, steps = len(port.STAMP_PHASES), 4
    per_step = [2000 * (i + 1) for i in range(n_ph)]  # phase i takes i + 1 us
    first = [999_999] * n_ph  # a cold first step, skipped
    total = sum(per_step)
    row0 = [1000, 5000, 1000 + steps * total // 2, 5000 + steps * total]
    row0 += first + per_step * (steps - 1)
    empty = [0] * (4 + steps * n_ph)  # a block that recorded nothing
    split = port.summarize_stamps(np.array([row0, empty]), steps)
    assert list(split) == ["block 0"]
    got = split["block 0"]
    for i, phase in enumerate(port.STAMP_PHASES):
        assert got[phase] == pytest.approx(i + 1)
    assert got["total"] == pytest.approx(sum(range(1, n_ph + 1)))
    assert got["wall"] == pytest.approx(total / 2 / 1e3)
    assert port.summarize_stamps([row0, row0], steps, skip=0)["last block"]["gate pass"] > 1
