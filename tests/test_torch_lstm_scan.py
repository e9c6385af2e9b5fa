"""The LSTM scan's plain version and ``lstm_apply`` against the JAX package.

The CUDA kernel itself runs only on the card; chip_smoke.py and
tests/test_torch_kernels_gpu.py hold it against ``lstm_scan_reference``
there. Here the plain version is held against the JAX Pallas kernel in
interpret mode (as tests/test_rnn.py runs it), and ``lstm_apply`` against
the JAX ``lstm_apply``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import module_time_limit, time_limit  # noqa: F401
from vectorquantizedcpc_tpu.models.rnn import LSTMParams
from vectorquantizedcpc_tpu.models.rnn import lstm_apply as jax_lstm_apply
from vectorquantizedcpc_tpu.models.rnn import lstm_init
from vectorquantizedcpc_tpu.ops.lstm_scan import fused_lstm_scan
from vectorquantizedcpc_tpu_torch.models import rnn as port_rnn
from vectorquantizedcpc_tpu_torch.ops import lstm_scan as port

TIME_LIMIT_S = 60  # each test's own limit (torch_port_util.time_limit)

torch.set_num_threads(1)

H = 32


def _bf16(x: np.ndarray) -> np.ndarray:
    """Round to bf16 and back, so both frameworks start from the same values."""
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()


def _scan_inputs(rng, t, b):
    wh = _bf16(rng.uniform(-1, 1, size=(H, 4 * H)) / np.sqrt(H))
    xproj = _bf16(rng.normal(0, 1, size=(t, b, 4 * H)))
    h0 = rng.uniform(-0.5, 0.5, size=(b, H)).astype(np.float32)
    c0 = rng.uniform(-1, 1, size=(b, H)).astype(np.float32)
    return wh, xproj, h0, c0


@pytest.mark.parametrize("t", [1, 22])
@pytest.mark.parametrize("b", [1, 4])
def test_plain_scan_matches_pallas_interpret(rng, t, b):
    """hs within one bf16 ulp of |h| < 1 (2^-7 = 7.8e-3: the two sum the
    H-deep product in another order, which can put an h on the other side of
    a bf16 rounding boundary); the f32 carries h_T and c_T within 1e-4."""
    wh, xproj, h0, c0 = _scan_inputs(rng, t, b)
    hs_ref, h_ref, c_ref = fused_lstm_scan(
        jnp.asarray(wh, jnp.bfloat16), jnp.asarray(xproj, jnp.bfloat16),
        jnp.asarray(h0), jnp.asarray(c0), interpret=True,
    )
    bf = lambda x: torch.from_numpy(x).bfloat16()
    hs, h_t, c_t = port.lstm_scan_reference(bf(wh), bf(xproj), torch.from_numpy(h0),
                                            torch.from_numpy(c0))
    assert hs.dtype == torch.bfloat16 and hs.shape == (t, b, H)
    assert h_t.dtype == c_t.dtype == torch.float32
    np.testing.assert_allclose(hs.float().numpy(), np.asarray(hs_ref, np.float32), atol=8e-3)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_ref), atol=1e-4)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_ref), atol=1e-4)


def test_cpu_tensors_take_the_plain_version(rng):
    wh, xproj, h0, c0 = (torch.from_numpy(x) for x in _scan_inputs(rng, 5, 3))
    args = (wh.bfloat16(), xproj.bfloat16(), h0, c0)
    before = port.LSTM_SCAN_LAUNCHES
    out = port.lstm_scan(*args)
    assert port.LSTM_SCAN_LAUNCHES == before
    for a, b in zip(out, port.lstm_scan_reference(*args)):
        assert torch.equal(a, b)


def _jax_params(seed, d):
    return lstm_init(jax.random.key(seed), d, H)


def _port_weights(params: LSTMParams):
    """The JAX params under torch's layouts; the fused bias becomes bias_ih."""
    t = lambda x: torch.from_numpy(np.array(x, np.float32))
    return t(params.wx).t(), t(params.wh).t(), t(params.b), torch.zeros(4 * H)


@pytest.mark.parametrize("with_state", [False, True])
def test_lstm_apply_f32_matches_jax(rng, with_state):
    params = _jax_params(1, 8)
    x = rng.normal(0, 1, size=(3, 17, 8)).astype(np.float32)
    state = None
    if with_state:
        state = tuple(rng.uniform(-0.5, 0.5, size=(3, H)).astype(np.float32) for _ in range(2))
    out_ref, (h_ref, c_ref) = jax_lstm_apply(
        params, jnp.asarray(x), None if state is None else tuple(map(jnp.asarray, state))
    )
    out, (h_t, c_t) = port_rnn.lstm_apply(
        torch.from_numpy(x), *_port_weights(params),
        state=None if state is None else tuple(map(torch.from_numpy, state)),
    )
    assert out.dtype == torch.float32 and out.shape == (3, 17, H)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), atol=1e-5)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_ref), atol=1e-5)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_ref), atol=1e-5)


def test_lstm_apply_bf16_runs_the_scan_as_jax_runs_its_kernel(rng, monkeypatch):
    """bf16 goes through ``lstm_scan`` once (its plain version on the CPU) and
    agrees with the JAX Pallas route within bf16 noise (3e-2: the input
    projection is a bf16 matmul in both, rounded in other orders)."""
    params = _jax_params(2, 8)
    x = rng.normal(0, 1, size=(4, 22, 8)).astype(np.float32)
    calls = []
    scan = port_rnn.lstm_scan
    monkeypatch.setattr(port_rnn, "lstm_scan", lambda *a: calls.append(1) or scan(*a))
    out, (h_t, c_t) = port_rnn.lstm_apply(
        torch.from_numpy(x), *_port_weights(params), compute_dtype=torch.bfloat16
    )
    out_ref, (h_ref, c_ref) = jax_lstm_apply(
        params, jnp.asarray(x, jnp.bfloat16), use_pallas=True, interpret=True
    )
    assert calls == [1]
    assert out.dtype == h_t.dtype == c_t.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(out_ref, np.float32), atol=3e-2)
    np.testing.assert_allclose(c_t.float().numpy(), np.asarray(c_ref, np.float32), atol=3e-2)


@pytest.mark.parametrize(
    "hidden, t, b, field, error",
    [
        (32, 4, 2, "xproj_f32", "xproj"),
        (32, 4, 2, "h0_shape", "h0"),
        (32, 0, 2, None, "empty"),
        (36, 4, 2, "c0_f64", "c0"),
        (440, 1, 1, "wh_shape", "wh"),
    ],
)
def test_kernel_input_checks(hidden, t, b, field, error):
    """The wrapper refuses what the kernels do not take, before any launch
    (any width is taken: tests/test_torch_widths.py)."""
    wh = torch.zeros(hidden, 4 * hidden, dtype=torch.bfloat16)
    xproj = torch.zeros(t, b, 4 * hidden, dtype=torch.bfloat16)
    h0 = c0 = torch.zeros(b, hidden)
    if field == "xproj_f32":
        xproj = xproj.float()
    if field == "h0_shape":
        h0 = torch.zeros(b, hidden + 1)
    if field == "c0_f64":
        c0 = c0.double()
    if field == "wh_shape":
        wh = wh[:, :-1]
    with pytest.raises(ValueError, match=error):
        port.check_scan_inputs(wh, xproj, h0, c0)


def test_shared_memory_bound():
    """H = 256: wh in registers, only the double-buffered bf16(h) tile (2 x
    8 K blocks of 512 B) and two mbarriers in shared memory; 432, the
    widest the cluster forward takes, keeps 12 of its 14 K blocks a warp in
    shared memory and still fits one CTA."""
    assert port.scan_smem_bytes(256) == 2 * 8 * 512 + 16 == 8208
    assert port.scan_smem_bytes(432) == 2 * 14 * 512 + 14 * 12 * 1024 + 16 <= port.SMEM_LIMIT
    assert port.scan_route(432) == "cluster" != port.scan_route(440)
