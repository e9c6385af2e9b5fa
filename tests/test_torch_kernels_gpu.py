"""The port's CUDA kernels against their plain versions, on a CUDA card.

Edge shapes that chip_smoke.py's full-width run does not reach. AR decode:
hidden sizes that do not split evenly over the SMs, FC1 widths below the
grid size, few classes, hop 1, odd batches, batches of several 8-row tiles
up to the 128-row cap. GRU scans: batches off the 8-row tile, one row, one
step, H = 96 and 128, rows masked at every step, the shared-memory limit.
LSTM scan: batches off the 8-row cluster tile, one step, odd step counts,
the width limits. Skipped without a card. This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weights(rng, hidden, fc, n_classes, device):
    from vectorquantizedcpc_tpu_torch.ops.ar_decode import DecodeWeights

    def t(shape, scale, dtype):
        return torch.from_numpy(rng.normal(0, scale, size=shape).astype(np.float32)).to(
            device=device, dtype=dtype
        )

    h3 = 3 * hidden
    return DecodeWeights(
        embed_proj=t((n_classes, h3), 0.5, torch.bfloat16),
        wx_cond=t((4, h3), 0.5, torch.float32),
        bx=t((h3,), 0.1, torch.float32),
        wh=t((hidden, h3), 1 / np.sqrt(hidden), torch.bfloat16),
        bh=t((h3,), 0.1, torch.float32),
        fc1_w=t((hidden, fc), 1 / np.sqrt(hidden), torch.bfloat16),
        fc1_b=t((fc,), 0.1, torch.float32),
        fc2_w=t((fc, n_classes), 4 / np.sqrt(fc), torch.bfloat16),
        fc2_b=t((n_classes,), 0.1, torch.float32),
    )


@pytest.mark.parametrize(
    "batch, hidden, fc, n_classes, hop, frames",
    [
        (1, 896, 256, 256, 160, 2),
        (5, 37, 11, 64, 1, 9),  # hidden < SMs: one unit per block, FC1 < grid
        (8, 301, 33, 100, 7, 5),  # last block holds 1 unit, 100 classes
        (3, 1001, 256, 256, 3, 4),  # 8 units per block, last block 1
        (9, 896, 256, 256, 160, 1),  # two row tiles, the second of one row
        (32, 896, 256, 256, 160, 1),
        (64, 896, 256, 256, 160, 1),
        (128, 896, 256, 256, 160, 1),  # the cap: one row per sampling block
        (70, 37, 11, 64, 1, 9),  # more rows than blocks: blocks sample 2 rows
    ],
)
@pytest.mark.parametrize("greedy", [True, False])
def test_ar_decode_kernel_matches_plain(cuda, batch, hidden, fc, n_classes, hop, frames, greedy):
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar

    rng = np.random.default_rng(hidden + batch)
    w = _weights(rng, hidden, fc, n_classes, cuda)
    cond_proj = torch.from_numpy(
        rng.normal(0, 0.5, size=(frames, batch, 3 * hidden)).astype(np.float32)
    ).to(cuda, torch.bfloat16)
    h0 = torch.from_numpy(rng.uniform(-0.5, 0.5, size=(batch, hidden)).astype(np.float32)).to(cuda)
    prev0 = torch.from_numpy(rng.integers(0, n_classes, size=batch).astype(np.int32)).to(cuda)

    before = ar.AR_DECODE_LAUNCHES
    out, h_t = ar.ar_decode(cond_proj, h0, prev0, w, hop, seed=11, greedy=greedy)
    torch.cuda.synchronize()
    assert ar.AR_DECODE_LAUNCHES == before + 1
    ref, ref_h, scores = ar.ar_decode_reference(
        cond_proj, h0, prev0, w, hop, seed=11, greedy=greedy, return_scores=True
    )
    out, ref, scores = out.cpu().numpy(), ref.cpu().numpy(), scores.cpu().numpy()
    assert out.shape == (frames * hop, batch)
    for r in range(batch):
        diff = np.nonzero(out[:, r] != ref[:, r])[0]
        if diff.size:  # a near-tie of the plain version's scores
            t0 = diff[0]
            assert scores[t0, r].max() - scores[t0, r, out[t0, r]] <= 0.05
        else:  # same bound as chip_smoke.py's MAX_H_ERR
            assert float((h_t[r] - ref_h[r]).abs().max()) <= 1e-2


def test_ar_decode_kernel_refuses_bad_input(cuda):
    from vectorquantizedcpc_tpu_torch.ops import ar_decode as ar

    w = _weights(np.random.default_rng(0), 64, 16, 32, cuda)
    cond = torch.zeros(2, 129, 192, dtype=torch.bfloat16, device=cuda)
    h0, prev0 = ar.init_decode_state(129, 64, 32, cuda)
    with pytest.raises(ValueError, match="rows"):
        ar.ar_decode(cond, h0, prev0, w, hop=4)
    with pytest.raises(ValueError, match="rows"):
        ar.kernel_plan(129, 64, 16, 32)
    with pytest.raises(ValueError, match="cond_proj"):
        ar.ar_decode(cond[:, :2].float(), h0[:2], prev0[:2], w, hop=4)


def _scan_case(rng, t, b, hidden, device):
    """GRU-scan operands at the kernel's types and a reverse-time mask whose
    row lengths include 0 (masked at every step), 1 and t."""
    h3 = 3 * hidden
    wh = rng.uniform(-1, 1, size=(hidden, h3)) / np.sqrt(hidden)
    bh = rng.uniform(-0.3, 0.3, size=(h3,))
    xproj = rng.normal(0, 0.8, size=(t, b, h3))
    h0 = rng.uniform(-0.5, 0.5, size=(b, hidden))
    lengths = rng.integers(0, t + 1, size=b)
    lengths[: min(b, 3)] = [0, 1, t][: min(b, 3)]
    valid = np.arange(t)[:, None] >= t - lengths[None, :]
    f32 = lambda x: torch.from_numpy(x.astype(np.float32)).to(device)
    return (f32(wh).bfloat16(), f32(bh), f32(xproj).bfloat16(), f32(h0),
            torch.from_numpy(valid.astype(np.int32)).to(device), lengths)


@pytest.mark.parametrize(
    "t, b, hidden",
    [
        (9, 13, 128),  # batch not a multiple of the 8-row tile
        (5, 1, 96),  # one row, 3H = 288 threads
        (1, 8, 128),  # one step
        (17, 20, 96),
    ],
)
@pytest.mark.parametrize("masked", [False, True])
def test_gru_scan_kernel_matches_plain(cuda, t, b, hidden, masked):
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    rng = np.random.default_rng(t * 100 + b + hidden)
    wh, bh, xproj, h0, valid, lengths = _scan_case(rng, t, b, hidden, cuda)
    before = (g.GRU_SCAN_LAUNCHES, g.GRU_SCAN_MASKED_LAUNCHES)
    if masked:
        hs, h_t = g.gru_scan_masked(wh, bh, xproj, valid, h0)
        ref, ref_h = g.gru_scan_masked_reference(wh, bh, xproj, valid, h0)
    else:
        hs, h_t = g.gru_scan(wh, bh, xproj, h0)
        ref, ref_h = g.gru_scan_reference(wh, bh, xproj, h0)
    torch.cuda.synchronize()
    assert (g.GRU_SCAN_LAUNCHES, g.GRU_SCAN_MASKED_LAUNCHES) == (
        before[0] + (not masked), before[1] + masked
    )
    assert hs.shape == (t, b, hidden) and h_t.shape == (b, hidden)
    # Same bounds as chip_smoke.py: a bf16 ulp of |h| < 1, and f32 sums.
    assert float((hs.float() - ref.float()).abs().max()) <= 1e-2
    assert float((h_t - ref_h).abs().max()) <= 1e-2
    if masked:
        frozen = int(np.flatnonzero(lengths == 0)[0])
        assert torch.equal(h_t[frozen], h0[frozen])
        assert torch.equal(hs[:, frozen], h0[frozen].bfloat16().expand(t, -1))


def test_gru_scan_all_valid_mask_is_the_plain_scan(cuda):
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    wh, bh, xproj, h0, valid, _ = _scan_case(np.random.default_rng(3), 12, 11, 128, cuda)
    hs, h_t = g.gru_scan(wh, bh, xproj, h0)
    hs_m, h_m = g.gru_scan_masked(wh, bh, xproj, torch.ones_like(valid), h0)
    torch.cuda.synchronize()
    assert torch.equal(hs, hs_m) and torch.equal(h_t, h_m)


def test_gru_scan_shared_memory_layout_and_limit(cuda):
    from vectorquantizedcpc_tpu_torch.ops import _build
    from vectorquantizedcpc_tpu_torch.ops import gru_train as g

    for hidden in (1, 96, 128, 183, 184):
        assert _build.library().vq_gru_scan_smem_bytes(hidden) == g.scan_smem_bytes(hidden)
    wh, bh, xproj, h0, _, _ = _scan_case(np.random.default_rng(4), 2, 3, 184, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        g.gru_scan(wh, bh, xproj, h0)


def test_server_refuses_more_slots_than_the_kernel_takes(cuda):
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.infer.serving import ContinuousBatcher
    from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder

    conf = load_conf(["training_vocoder.model.network.rnnms.wave_ar.size_h_rnn=64"])
    vocoder = Vocoder(conf.training_vocoder.model.network)
    with pytest.raises(ValueError, match="at most 128 rows"):
        ContinuousBatcher(vocoder, slots=129, device=cuda)


def _lstm_case(rng, t, b, hidden, device):
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device)
    wh = f32(rng.uniform(-1, 1, size=(hidden, 4 * hidden)) / np.sqrt(hidden)).bfloat16()
    xproj = f32(rng.normal(0, 1, size=(t, b, 4 * hidden))).bfloat16()
    h0 = f32(rng.uniform(-0.5, 0.5, size=(b, hidden)))
    c0 = f32(rng.uniform(-1, 1, size=(b, hidden)))
    return wh, xproj, h0, c0


@pytest.mark.parametrize("t", [1, 70, 257])
@pytest.mark.parametrize("b", [1, 15, 16, 17, 64])
def test_lstm_scan_kernel_matches_plain(cuda, t, b):
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    args = _lstm_case(np.random.default_rng(t * 1000 + b), t, b, 256, cuda)
    before = ls.LSTM_SCAN_LAUNCHES
    hs, h_t, c_t = ls.lstm_scan(*args)
    torch.cuda.synchronize()
    assert ls.LSTM_SCAN_LAUNCHES == before + 1
    ref, ref_h, ref_c = ls.lstm_scan_reference(*args)
    assert hs.shape == (t, b, 256) and h_t.shape == c_t.shape == (b, 256)
    # Same bounds as chip_smoke.py: a bf16 ulp of |h| < 1, and f32 sums.
    assert float((hs.float() - ref.float()).abs().max()) <= 1e-2
    assert float((h_t - ref_h).abs().max()) <= 1e-2
    assert float((c_t - ref_c).abs().max()) <= 1e-2


@pytest.mark.parametrize("hidden", [64, 128, 432])
def test_lstm_scan_kernel_other_widths(cuda, hidden):
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    args = _lstm_case(np.random.default_rng(hidden), 9, 11, hidden, cuda)
    hs, h_t, c_t = ls.lstm_scan(*args)
    ref, ref_h, ref_c = ls.lstm_scan_reference(*args)
    torch.cuda.synchronize()
    assert float((hs.float() - ref.float()).abs().max()) <= 1e-2
    assert float((c_t - ref_c).abs().max()) <= 1e-2


def test_lstm_scan_shared_memory_layout_and_limits(cuda):
    from vectorquantizedcpc_tpu_torch.ops import _build
    from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

    for hidden in (8, 64, 256, 432, 440):
        assert _build.library().vq_lstm_scan_smem_bytes(hidden) == ls.scan_smem_bytes(hidden)
    for hidden, match in ((440, "shared memory"), (36, "multiple of 8")):
        with pytest.raises(ValueError, match=match):
            ls.lstm_scan(*_lstm_case(np.random.default_rng(0), 2, 3, hidden, cuda))
