"""The LSTM scan's training forward, backward and autograd against the JAX package.

The CUDA kernels run only on the card (chip_smoke.py and
tests/test_torch_kernels_gpu.py hold them against the plain versions
there). Here the plain versions are held against the JAX Pallas kernels in
interpret mode (``_fused_fwd_impl(save_residuals=True)``, ``_bwd_call``,
and ``fused_lstm_scan``'s VJP), and ``lstm_apply``'s gradients against the
JAX ``lstm_apply``'s, at f32 and bf16.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vectorquantizedcpc_tpu.models.rnn import lstm_apply as jax_lstm_apply
from vectorquantizedcpc_tpu.models.rnn import lstm_init
from vectorquantizedcpc_tpu.ops.lstm_scan import (
    _bwd_call,
    _fused_fwd_impl,
    _pick_chunk,
    fused_lstm_scan,
)
from vectorquantizedcpc_tpu_torch.models import rnn as port_rnn
from vectorquantizedcpc_tpu_torch.ops import lstm_scan as port

torch.set_num_threads(1)

H = 32


def _bf16(x) -> np.ndarray:
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()


def _inputs(rng, t, b):
    wh = _bf16(rng.uniform(-1, 1, size=(H, 4 * H)) / np.sqrt(H))
    xproj = _bf16(rng.normal(0, 1, size=(t, b, 4 * H)))
    h0 = rng.uniform(-0.5, 0.5, size=(b, H)).astype(np.float32)
    c0 = rng.uniform(-1, 1, size=(b, H)).astype(np.float32)
    dhs = _bf16(rng.normal(0, 1, size=(t, b, H)))
    dh_t = rng.normal(0, 1, size=(b, H)).astype(np.float32)
    dc_t = rng.normal(0, 1, size=(b, H)).astype(np.float32)
    return wh, xproj, h0, c0, dhs, dh_t, dc_t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(x, np.float32)


@pytest.mark.parametrize("t, b", [(1, 1), (22, 4)])
def test_train_forward_matches_pallas_interpret(rng, t, b):
    """The residuals as the Pallas training variant writes them. hs and acts
    within 8e-3 (one bf16 ulp of a value in [0.5, 1) is 3.9e-3; the two sum
    the H-deep product in other orders, which can move a value across a
    rounding boundary, and twice for the next step); c_prev, h_T, c_T (f32)
    within 1e-4."""
    wh, xproj, h0, c0 = _inputs(rng, t, b)[:4]
    ref = _fused_fwd_impl(jnp.asarray(wh, jnp.bfloat16), jnp.asarray(xproj, jnp.bfloat16),
                          jnp.asarray(h0), jnp.asarray(c0), True, save_residuals=True)
    bf = lambda x: torch.from_numpy(x).bfloat16()
    got = port.lstm_scan_train_reference(bf(wh), bf(xproj), torch.from_numpy(h0),
                                         torch.from_numpy(c0))
    assert [x.dtype for x in got] == [torch.bfloat16, torch.bfloat16] + [torch.float32] * 3
    for name, a, r, tol in zip(("hs", "acts", "c_prev", "h_T", "c_T"), got, ref,
                               (8e-3, 8e-3, 1e-4, 1e-4, 1e-4)):
        np.testing.assert_allclose(_np(a), _np(r), atol=tol, err_msg=name)
    # The inference variant's outputs are the training variant's bits.
    inf = port.lstm_scan_reference(bf(wh), bf(xproj), torch.from_numpy(h0), torch.from_numpy(c0))
    for a, r in zip(inf, (got[0], got[3], got[4])):
        assert torch.equal(a, r)


@pytest.mark.parametrize("t, b", [(1, 3), (22, 4)])
def test_backward_matches_pallas_interpret(rng, t, b):
    """The backward from the same residuals. Both compute da in f32 in other
    orders and round it to bf16, so a dgates element may sit one bf16 ulp
    apart (2^-8 relative) and the carried dh move by that ulp's share of
    one product: dgates within 1e-2 relative to the largest (plus 1e-3),
    dh0 and dc0 within 1e-3 relative to their largest."""
    wh, xproj, h0, c0, dhs, dh_t, dc_t = _inputs(rng, t, b)
    _, acts, c_prev, _, _ = _fused_fwd_impl(
        jnp.asarray(wh, jnp.bfloat16), jnp.asarray(xproj, jnp.bfloat16),
        jnp.asarray(h0), jnp.asarray(c0), True, save_residuals=True)
    ref = _bwd_call(acts, c_prev, jnp.asarray(dhs, jnp.bfloat16),
                    jnp.asarray(wh.T, jnp.bfloat16), jnp.asarray(dh_t), jnp.asarray(dc_t),
                    hidden=H, chunk_t=_pick_chunk(t), interpret=True)
    got = port.lstm_scan_bwd_reference(
        torch.from_numpy(_np(acts)).bfloat16(), torch.from_numpy(_np(c_prev)),
        torch.from_numpy(dhs).bfloat16(), torch.from_numpy(wh).bfloat16(),
        torch.from_numpy(dh_t), torch.from_numpy(dc_t))
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == got[2].dtype == torch.float32
    for name, a, r in zip(("dgates", "dh0", "dc0"), got, ref):
        r = _np(r)
        rel = 1e-2 if name == "dgates" else 1e-3
        np.testing.assert_allclose(_np(a), r, atol=rel * np.abs(r).max() + 1e-3, err_msg=name)


def test_autograd_matches_fused_lstm_scan_vjp(rng):
    """``LstmScan`` against ``jax.vjp`` of ``fused_lstm_scan`` (interpret):
    outputs as above; dwh, dxproj, dh0, dc0 within 1e-2 relative to their
    largest element (bf16 dgates one ulp apart, summed T B deep for dwh)."""
    t, b = 13, 5
    wh, xproj, h0, c0, dhs, dh_t, dc_t = _inputs(rng, t, b)
    args = (jnp.asarray(wh, jnp.bfloat16), jnp.asarray(xproj, jnp.bfloat16),
            jnp.asarray(h0), jnp.asarray(c0))
    out_ref, vjp = jax.vjp(lambda *a: fused_lstm_scan(*a, True), *args)
    grads_ref = vjp((jnp.asarray(dhs, jnp.bfloat16), jnp.asarray(dh_t), jnp.asarray(dc_t)))

    leaves = [torch.from_numpy(wh).bfloat16(), torch.from_numpy(xproj).bfloat16(),
              torch.from_numpy(h0), torch.from_numpy(c0)]
    for x in leaves:
        x.requires_grad_(True)
    out = port.LstmScan.apply(*leaves)
    grads = torch.autograd.grad(out, leaves, (torch.from_numpy(dhs).bfloat16(),
                                              torch.from_numpy(dh_t), torch.from_numpy(dc_t)))
    np.testing.assert_allclose(_np(out[0]), _np(out_ref[0]), atol=8e-3)
    for name, g, r in zip(("dwh", "dxproj", "dh0", "dc0"), grads, grads_ref):
        assert g.dtype == {"dwh": torch.bfloat16, "dxproj": torch.bfloat16}.get(name, torch.float32)
        r = _np(r)
        np.testing.assert_allclose(_np(g), r, atol=1e-2 * np.abs(r).max(), err_msg=name)


def test_autograd_missing_cotangents_are_zeros(rng):
    """A loss of hs alone (no h_T, c_T) = cotangents of zero for h_T, c_T."""
    wh, xproj, h0, c0, dhs = _inputs(rng, 6, 2)[:5]
    leaves = [torch.from_numpy(wh).bfloat16().requires_grad_(),
              torch.from_numpy(xproj).bfloat16().requires_grad_()]
    hs, _, _ = port.LstmScan.apply(*leaves, torch.from_numpy(h0), torch.from_numpy(c0))
    g1 = torch.autograd.grad(hs, leaves, torch.from_numpy(dhs).bfloat16())
    hs, h_t, c_t = port.LstmScan.apply(*leaves, torch.from_numpy(h0), torch.from_numpy(c0))
    g2 = torch.autograd.grad((hs, h_t, c_t), leaves,
                             (torch.from_numpy(dhs).bfloat16(), torch.zeros_like(h_t),
                              torch.zeros_like(c_t)))
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


def _port_weights(params):
    t = lambda x: torch.from_numpy(np.array(x, np.float32))
    return [t(params.wx).t().contiguous(), t(params.wh).t().contiguous(), t(params.b),
            torch.zeros(4 * H)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_apply_gradients_match_jax(rng, dtype, monkeypatch):
    """Gradients of sum(w * out) + sum(c_T) through ``lstm_apply`` against
    the JAX ``lstm_apply`` (f32: the lax.scan; bf16: its Pallas kernels in
    interpret mode). f32 within 1e-4 relative to the largest element; bf16
    within 5e-2 relative (bf16 input projection and gates in both, rounded
    in other orders). The bf16 route runs ``LstmScan`` and not the
    inference scan."""
    params = lstm_init(jax.random.key(3), 8, H)
    x = rng.normal(0, 1, size=(4, 11, 8)).astype(np.float32)
    wout = rng.normal(0, 1, size=(4, 11, H)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    pallas = dtype == "bfloat16"

    def jax_loss(p, xx):
        out, (_, c_t) = jax_lstm_apply(p, xx.astype(jdt), use_pallas=pallas, interpret=pallas)
        return jnp.sum(out.astype(jnp.float32) * wout) + jnp.sum(c_t.astype(jnp.float32))

    g_ref, gx_ref = jax.grad(jax_loss, argnums=(0, 1))(params, jnp.asarray(x))
    calls = []
    monkeypatch.setattr(port_rnn, "lstm_scan", lambda *a: calls.append(1))
    w_ih, w_hh, b_ih, b_hh = [p.requires_grad_() for p in _port_weights(params)]
    xt = torch.from_numpy(x).requires_grad_()
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    out, (_, c_t) = port_rnn.lstm_apply(xt, w_ih, w_hh, b_ih, b_hh, compute_dtype=tdt)
    loss = (out.float() * torch.from_numpy(wout)).sum() + c_t.float().sum()
    loss.backward()
    assert calls == []
    rel = 1e-4 if dtype == "float32" else 5e-2
    for name, g, r in (("wx", w_ih.grad.t(), g_ref.wx), ("wh", w_hh.grad.t(), g_ref.wh),
                       ("b", b_ih.grad, g_ref.b), ("x", xt.grad, gx_ref)):
        r = np.asarray(r, np.float32)
        np.testing.assert_allclose(g.numpy(), r, atol=rel * np.abs(r).max(), err_msg=name)


def test_no_grad_keeps_the_inference_scan(rng, monkeypatch):
    params = lstm_init(jax.random.key(4), 8, H)
    x = torch.from_numpy(rng.normal(0, 1, size=(2, 5, 8)).astype(np.float32))
    calls = []
    scan = port_rnn.lstm_scan
    monkeypatch.setattr(port_rnn, "lstm_scan", lambda *a: calls.append(1) or scan(*a))
    weights = [p.requires_grad_() for p in _port_weights(params)]
    with torch.no_grad():
        port_rnn.lstm_apply(x, *weights, compute_dtype=torch.bfloat16)
    assert calls == [1]


@pytest.mark.parametrize(
    "field, error",
    [("acts_f32", "acts"), ("dhs_f32", "dhs"), ("c_prev_shape", "c_prev"), ("wide", "shared memory")],
)
def test_backward_input_checks(field, error):
    """The backward wrapper refuses what its kernel does not take."""
    hidden = 360 if field == "wide" else 32
    t, b = 3, 2
    args = {
        "acts": torch.zeros(t, b, 4 * hidden, dtype=torch.bfloat16),
        "c_prev": torch.zeros(t, b, hidden),
        "dhs": torch.zeros(t, b, hidden, dtype=torch.bfloat16),
        "wh": torch.zeros(hidden, 4 * hidden, dtype=torch.bfloat16),
        "dh_t": torch.zeros(b, hidden),
        "dc_t": torch.zeros(b, hidden),
    }
    if field == "acts_f32":
        args["acts"] = args["acts"].float()
    if field == "dhs_f32":
        args["dhs"] = args["dhs"].float()
    if field == "c_prev_shape":
        args["c_prev"] = torch.zeros(t, b, hidden + 1)
    with pytest.raises(ValueError, match=error):
        port.check_bwd_inputs(**args, kernel=True)


def test_backward_shared_memory_bound():
    """H = 256: 64 KB of wh rows, the 64 KB da tile pair, 8 KB of parts;
    352 is the widest that fits one block."""
    assert port.bwd_smem_bytes(256) == 65536 + 65536 + 8192
    assert port.bwd_smem_bytes(352) <= port.SMEM_LIMIT < port.bwd_smem_bytes(360)
