"""Each kernel's count of operations and bytes against a hand count at two shapes."""

import pytest

from portbench.roofline import (ar_decode, cpc_select, gru_train, lstm_scan, models, peaks,
                                prenet_gru)


@pytest.mark.parametrize("b,steps,frames", [(64, 5120, 32), (8, 16000, 100)])
def test_ar_decode(b, steps, frames):
    h, f, c = 896, 256, 256
    call = dict(batch=b, steps=steps, hidden=h, fc=f, classes=c, frames=frames)
    # per row and sample: h @ wh (896 x 2688), FC1 (896 x 256), FC2 (256 x 256)
    assert ar_decode.flops(**call) == 2 * b * steps * (896 * 2688 + 896 * 256 + 256 * 256)
    weights = 2 * (256 * 2688 + 896 * 2688 + 896 * 256 + 256 * 256) + 4 * (2688 + 256 + 256)
    io = 2 * frames * b * 2688 + 4 * b * 896 + 4 * b + 4 * steps * b + 4 * b * 896
    assert ar_decode.n_bytes(**call) == weights + io
    assert ar_decode.least(call) == max(ar_decode.flops(**call) / 989e12,
                                        ar_decode.n_bytes(**call) / 3.35e12)


def test_ar_decode_bound_at_b8_matches_the_kernel_table():
    # PERF.md's kernel table: 0.700 ms (operations) at B 8, 100 frames.
    call = dict(batch=8, steps=16000, hidden=896, fc=256, classes=256, frames=100)
    assert abs(ar_decode.least(call) * 1e3 - 0.700) < 0.01


@pytest.mark.parametrize("t,g,valid", [(500, 256, 256 * 220), (200, 48, 48 * 150)])
def test_prenet_gru(t, g, valid):
    h = 128
    call = dict(T=t, G=g, H=h, valid=valid)
    assert prenet_gru.flops(**call) == 2 * h * 3 * h * (t * g + valid)
    one = 2 * t * g * 384 + 2 * 128 * 384 + 4 * 384 + 4 * g * 128 + 2 * t * g * 128 + 4 * g * 128
    assert prenet_gru.n_bytes(**call) == 2 * one + 4 * t * g


@pytest.mark.parametrize("t,b,h", [(5120, 32, 896), (1024, 8, 256)])
def test_gru_train(t, b, h):
    call = dict(T=t, B=b, H=h)
    assert gru_train.flops(**call) == 2 * (2 * t * b * h * 3 * h)
    fwd = 2 * h * 3 * h + 4 * 3 * h + 2 * t * b * 3 * h + 4 * b * h  # wh, bh, xproj, h0
    fwd += 2 * t * b * h + 2 * t * b * 3 * h + 2 * t * b * h + 4 * b * h  # hs, acts, hns, h_T
    bwd = 2 * t * b * 3 * h + 2 * t * b * h * 3 + 2 * h * 3 * h + 4 * b * h  # acts, hns, h_prevs, dhs, wh, dh_T
    bwd += 2 * 2 * t * b * 3 * h + 4 * b * h  # dgx, dgh, dh0
    assert gru_train.n_bytes(**call) == fwd + bwd
    # the backward's bound at B 32, H 896 is PERF.md's 1.053 ms (bytes)
    if (t, b, h) == (5120, 32, 896):
        assert abs(bwd / 3.35e12 * 1e3 - 1.053) < 0.01


@pytest.mark.parametrize("t,b,h", [(70, 64, 256), (256, 16, 256)])
def test_lstm_scan(t, b, h):
    call = dict(T=t, B=b, H=h)
    assert lstm_scan.flops(**call) == 2 * (2 * t * b * h * 4 * h)
    fwd = 2 * h * 4 * h + 2 * t * b * 4 * h + 8 * b * h  # wh, xproj, h0, c0
    fwd += 2 * t * b * h + 2 * t * b * 4 * h + 4 * t * b * h + 8 * b * h  # hs, acts, c_prev, h_T, c_T
    bwd = 2 * t * b * 4 * h + 4 * t * b * h + 2 * t * b * h + 2 * h * 4 * h + 8 * b * h
    bwd += 2 * t * b * 4 * h + 8 * b * h
    assert lstm_scan.n_bytes(**call) == fwd + bwd


@pytest.mark.parametrize("k,s,u,n,l,z", [(6, 8, 8, 17, 64, 64), (2, 2, 3, 4, 5, 6)])
def test_cpc_select(k, s, u, n, l, z):
    call = dict(K=k, S=s, U=u, N=n, L=l, Z=z)
    rows = k * s * u * l
    assert cpc_select.flops(**call) == 3 * 2 * rows * (n + 1) * z
    wz = 4 * rows * z
    idx = 4 * k * u * n + 4 * k * s * u * n * l
    scores = 4 * k * s * u * n * l + 4 * rows
    assert cpc_select.n_bytes(**call) == (2 * wz + idx + scores) + (scores + 2 * wz + idx + 2 * wz)
    assert cpc_select.least(call) >= cpc_select.n_bytes(**call) / peaks.HBM_BYTES_S * 0.99


def test_model_flops():
    w = models.widths({})
    # per sample: (256 + 256) x 2688 + 896 x 2688 + 896 x 256 + 256 x 256, times 2
    assert models.decode_per_sample(w) == 2 * (512 * 2688 + 896 * 2688 + 896 * 256 + 256 * 256)
    # PreNet per frame: layer 0 in 128, layer 1 in 256; 2 directions of H 128
    assert models.prenet_per_frame(w) == 2 * (2 * 128 * 384 + 2 * 128 * 384) + 2 * (
        2 * 256 * 384 + 2 * 128 * 384)
    assert models.encoder_per_latent(w) == 2 * (320 * 512 + 4 * 512 * 512 + 512 * 64 + 64 * 512)
    step = models.vocoder_train_step(w, 32, 5120)
    assert step == 32 * (3 * (5120 * models.decode_per_sample(w) + 32 * models.prenet_per_frame(w))
                         + 16 * models.encoder_per_latent(w))
    lstm = 2 * (64 + 256) * 1024
    cpc = 6 * 64 * (2 * 256 * 64 + 18 * 2 * 64)
    assert models.cpc_train_step(w, 64, 140) == 3 * 64 * (70 * (models.encoder_per_latent(w)
                                                                 + lstm) + cpc)
