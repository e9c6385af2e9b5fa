"""The port's CUDA kernels against their plain versions, on a CUDA card.

Edge shapes that chip_smoke.py's full-width run does not reach: hidden
sizes that do not split evenly over the SMs, FC1 widths below the grid
size, few classes, hop 1, odd batches. Skipped without a card. This file
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
    cond = torch.zeros(2, 9, 192, dtype=torch.bfloat16, device=cuda)
    h0, prev0 = ar.init_decode_state(9, 64, 32, cuda)
    with pytest.raises(ValueError, match="rows"):
        ar.ar_decode(cond, h0, prev0, w, hop=4)
    with pytest.raises(ValueError, match="cond_proj"):
        ar.ar_decode(cond[:, :2].float(), h0[:2], prev0[:2], w, hop=4)
