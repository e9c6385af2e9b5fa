"""Helpers shared by the tests that hold the PyTorch port against the JAX package."""

import faulthandler
import os
import signal
import sys
import threading
import time

import numpy as np
import pytest

# Every port test module imports ``module_time_limit`` and ``time_limit``:
# its module set-up, each test and its module teardown run under a limit,
# the module's ``TIME_LIMIT_S``, at least 5x its slowest test or module
# fixture.
DEFAULT_TIME_LIMIT_S = 300.0
# Past the limit plus this grace, with the main thread still not back in
# Python (a hang inside C code), the worker process exits.
GRACE_S = 30.0

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


class _Limit:
    """SIGALRM at ``limit`` seconds: every thread's stack goes to the test
    run's stderr, then the phase fails with ``pytest.fail`` raised in the
    main thread, and the worker goes on to the next test. A worker process
    that exits takes down more than one test: pytest-xdist 3.8's
    ``--dist loadfile`` puts every file the crashed worker had run back on
    its queue, its replacements are sent those files' finished (empty) work
    units, and a worker left holding its last test waits for a next one
    that never comes, so the run stalls to its time limit. Only a main
    thread that stays in C code past ``limit + GRACE_S`` makes
    ``faulthandler`` dump the stacks again and exit."""

    def __init__(self, request, what: str) -> None:
        module = request.module
        self.limit = float(getattr(module, "TIME_LIMIT_S", DEFAULT_TIME_LIMIT_S))
        self.what = what
        try:  # pytest's own copy of the stderr descriptor, outside the capture
            from _pytest.faulthandler import fault_handler_stderr_fd_key

            self.out = request.config.stash[fault_handler_stderr_fd_key]
        except (ImportError, KeyError):
            self.out = sys.__stderr__

    def _alarm(self, signum, frame) -> None:
        note = f"\n{self.what} exceeded its {self.limit:g} s time limit; every thread:\n"
        if isinstance(self.out, int):
            os.write(self.out, note.encode())
        else:
            self.out.write(note)
            self.out.flush()
        faulthandler.dump_traceback(file=self.out, all_threads=True)
        pytest.fail(f"{self.what} exceeded its {self.limit:g} s time limit "
                    "(every thread's stack is in the run's stderr)", pytrace=False)

    def arm(self) -> None:
        signal.signal(signal.SIGALRM, self._alarm)
        signal.setitimer(signal.ITIMER_REAL, self.limit)
        faulthandler.dump_traceback_later(self.limit + GRACE_S, exit=True, file=self.out)

    @staticmethod
    def disarm() -> None:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, signal.SIG_DFL)
        faulthandler.cancel_dump_traceback_later()


def _left_running(before) -> list:
    """What a test module left behind: threads started since ``before``
    still alive after 10 s in all, and a default process group."""
    deadline = time.monotonic() + 10.0
    left = []
    for thread in set(threading.enumerate()) - before:
        thread.join(max(0.0, deadline - time.monotonic()))
        if thread.is_alive():
            left.append(f"thread {thread.name} ({type(thread).__name__})")
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        left.append("a torch.distributed process group")
    return left


@pytest.fixture(scope="module", autouse=True)
def module_time_limit(request):
    """Arm the module's limit before its module-scoped fixtures set up
    (pytest sets up autouse fixtures first within a scope); ``time_limit``
    takes over for each test. After the module's teardown no thread it
    started may still run and no process group may stand: the next module
    in this worker would inherit them (and a fork there, their locks)."""
    _Limit(request, f"module set-up of {request.node.name}").arm()
    before = set(threading.enumerate())
    yield
    try:
        left = _left_running(before)
        assert not left, f"{request.node.name} left running: {', '.join(left)}"
    finally:
        _Limit.disarm()


@pytest.fixture(autouse=True)
def time_limit(request):
    """Each test of a module that imports it runs under ``_Limit``: a hang
    fails that test, and the run goes on. Its teardown arms the limit again
    for what follows up to the next test: the module fixtures that the next
    test sets up first, or the module's teardown."""
    _Limit(request, request.node.nodeid).arm()
    yield
    _Limit(request, f"module fixtures after {request.node.nodeid}").arm()
