"""Helpers shared by the tests that hold the PyTorch port against the JAX package."""

import faulthandler
import hashlib
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

# A test that starts a trainer, a CLI, a thread or a subprocess runs under a
# time limit of its own (``time_limit``): its module sets ``TIME_LIMIT_S``
# to at least 5x its slowest test's time.
DEFAULT_TIME_LIMIT_S = 300.0

# Small widths for CPU parity runs (the shapes of tests/test_ar_decode.py).
SMALL = [
    "size_latent_codebook=16",
    "dim_latent=8",
    "model.encoder.channels=32",
    "dim_cpc_context=12",
    "training_vocoder.model.n_speakers=4",
    "training_vocoder.model.network.dim_speaker_embedding=8",
    "training_vocoder.model.network.rnnms.dim_voc_latent=16",
    "training_vocoder.model.network.rnnms.wave_ar.size_i_embed_ar=16",
    "training_vocoder.model.network.rnnms.wave_ar.size_h_rnn=32",
    "training_vocoder.model.network.rnnms.wave_ar.size_h_fc=16",
    "data.dataset.mel_stft_stride=8",
]


def flat(tree) -> dict:
    """A JAX params dataclass -> numpy arrays keyed by field path."""
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = ".".join(
            str(getattr(p, "name", getattr(p, "idx", getattr(p, "key", p))))
            for p in path
        )
        out[key] = np.asarray(leaf)
    return out


def jax_models(argv, seed=0):
    """(conf, enc_params, vq_state, voc_params) of the JAX package, random init."""
    import jax

    from vectorquantizedcpc_tpu.configs import load_conf
    from vectorquantizedcpc_tpu.models.encoder import encoder_init
    from vectorquantizedcpc_tpu.models.vocoder import vocoder_init

    conf = load_conf(list(argv))
    k1, k2 = jax.random.split(jax.random.key(seed))
    enc, vq = encoder_init(k1, conf.model.encoder)
    voc = vocoder_init(k2, conf.training_vocoder.model.network)
    return conf, enc, vq, voc


def port_models(argv, enc, vq, voc):
    """The port's Encoder and Vocoder holding the same weights as the JAX params."""
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.models.encoder import Encoder
    from vectorquantizedcpc_tpu_torch.models.vocoder import Vocoder
    from vectorquantizedcpc_tpu_torch.weights import from_jax_params

    conf = load_conf(list(argv))
    enc_sd, voc_sd = from_jax_params(flat(enc), flat(vq), flat(voc))
    encoder = Encoder(conf.model.encoder)
    encoder.load_state_dict(enc_sd, strict=True)
    vocoder = Vocoder(conf.training_vocoder.model.network)
    vocoder.load_state_dict(voc_sd, strict=True)
    return conf, encoder.eval(), vocoder.eval()


def assert_prefix_parity(test, ref, scores_ref, max_gap):
    """Class sequences (B, T) agree up to the first divergence, and there the
    tested choice is a near-tie of the reference scores (B, T, C)."""
    test, ref, scores_ref = (np.asarray(x) for x in (test, ref, scores_ref))
    assert test.shape == ref.shape
    for b in range(test.shape[0]):
        diff = np.nonzero(test[b] != ref[b])[0]
        if diff.size == 0:
            continue
        t0 = int(diff[0])
        gap = float(scores_ref[b, t0].max() - scores_ref[b, t0, test[b, t0]])
        assert gap <= max_gap, (
            f"row {b}: first divergence at step {t0} picked class "
            f"{test[b, t0]} with reference gap {gap:.5f} > {max_gap}"
        )


def classes_of(wave, n_classes):
    """Mu-law waveform -> integer classes (the decode is injective)."""
    from vectorquantizedcpc_tpu_torch.dsp.mulaw import mulaw_decode

    table = mulaw_decode(np.arange(n_classes), n_classes)
    return np.abs(np.asarray(wave)[..., None] - table).argmin(-1)


@pytest.fixture(autouse=True)
def time_limit(request):
    """Arm ``faulthandler.dump_traceback_later`` for the test: past its
    limit every thread's stack goes to the test run's stderr and the process
    exits, so a hang fails one test (xdist reports its worker down and goes
    on) in place of stopping the whole run. Imported by a test module, it
    applies to each of its tests; cancelled on teardown.

    xdist's ``--dist loadfile`` hands a crashed worker's unfinished file,
    the cut test included, to its replacement: a marker file per test and
    run, left only by a cut, makes that attempt fail at once."""
    limit = getattr(request.module, "TIME_LIMIT_S", DEFAULT_TIME_LIMIT_S)
    run = getattr(request.config, "workerinput", {}).get("testrunuid")
    marker = None
    if run is not None:
        digest = hashlib.sha256(request.node.nodeid.encode()).hexdigest()[:16]
        marker = Path(tempfile.gettempdir()) / f"vqcpc_time_limit_{run}_{digest}"
        if marker.exists():
            marker.unlink()
            pytest.fail(f"cut at its {limit:.0f} s time limit in an earlier worker of this run "
                        "(every thread's stack is in the run's stderr)")
        marker.write_text(request.node.nodeid)
    try:  # pytest's own copy of the stderr descriptor, outside the capture
        from _pytest.faulthandler import fault_handler_stderr_fd_key

        out = request.config.stash[fault_handler_stderr_fd_key]
    except (ImportError, KeyError):
        out = sys.__stderr__
    faulthandler.dump_traceback_later(limit, exit=True, file=out)
    yield
    faulthandler.cancel_dump_traceback_later()
    if marker is not None:
        marker.unlink(missing_ok=True)
