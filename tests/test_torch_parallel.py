"""Data parallelism in the port (``parallel/``), on the CPU with 2 gloo ranks.

Each 2-rank run starts two processes through torchrun, as the CLIs do:
of ``torch_port_parallel_worker.py`` (whose process group has a 60 s
timeout) or of a training CLI. The run has a 120 s limit, after which
torchrun is stopped and stops its ranks, so a hang fails one test. The same weights, global batches and injected negatives (numpy,
from a seed) go through:

- the JAX package's sharded steps at data = 2 on the 8 virtual CPU devices
  of ``tests/conftest.py`` (``make_train_step(conf, make_mesh(data=2))``),
- the port's one-process step on the global batch,
- the port's 2-rank step, each rank on its share.

Then the launch keys and their refusals, the two training CLIs at
``runtime.mesh_data=2`` with checkpoints and resume, and a preemption
requested on one rank only.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from torch_port_util import SMALL, flat
from vectorquantizedcpc_tpu.configs import load_conf as jax_load_conf
from vectorquantizedcpc_tpu.models.cpc import sample_negative_indices as jax_sample
from vectorquantizedcpc_tpu.models.encoder import encoder_init
from vectorquantizedcpc_tpu.parallel.mesh import make_mesh
from vectorquantizedcpc_tpu.parallel.sharding import batch_sharding
from vectorquantizedcpc_tpu.training import cpc as jax_cpc
from vectorquantizedcpc_tpu.training import vocoder as jax_vocoder
from vectorquantizedcpc_tpu_torch import configs
from vectorquantizedcpc_tpu_torch.configs import load_conf
from vectorquantizedcpc_tpu_torch.models.encoder import Encoder
from vectorquantizedcpc_tpu_torch.parallel import mesh as port_mesh
from vectorquantizedcpc_tpu_torch.parallel.sharding import local_share, shard_batch
from vectorquantizedcpc_tpu_torch.training.cpc import CPCTrainer
from vectorquantizedcpc_tpu_torch.training.vocoder import VocoderTrainer
from vectorquantizedcpc_tpu_torch.weights import (cpc_from_jax_params, encoder_from_jax_params,
                                                  from_jax_params)

torch.set_num_threads(1)

WORKER = Path(__file__).resolve().parent / "torch_port_parallel_worker.py"
REPO = WORKER.parents[1]
RUN_LIMIT_S = 120
# tests/test_torch_train_cpc.py's TINY widths with S = 4: 2 speakers a rank.
CPC_ARGV = [
    "model.encoder.channels=32",
    "dim_latent=8",
    "dim_cpc_context=16",
    "size_latent_codebook=32",
    "training.cpc.sample_frames=20",
    "training.cpc.n_speakers_per_batch=4",
    "training.cpc.n_utterances_per_speaker=2",
    "training.cpc.n_negatives=3",
    "runtime.precision=float32",
]
# tests/test_torch_train_vocoder.py's widths; a clip of 1e-3 is far below
# the gradient's global norm (and each rank's), so the clip is active and a
# clip of each rank's own gradient would give another mean.
VOC_ARGV = SMALL + ["data.dataset.clip_length_mel=4", "runtime.precision=float32",
                    "training_vocoder.trainer.gradient_clip_val=0.001"]
STEPS = 2
LR = 1e-3
VOC_B = 4


def _run(cmd: list) -> str:
    """``cmd`` with the repo importable; its standard output. Fails the test
    when it exits non-zero or outlasts RUN_LIMIT_S: torchrun is then asked
    to stop (it stops its ranks), and killed with what is left of its
    session after 30 s more."""
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=str(REPO) + (os.pathsep + path if path else ""))
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=RUN_LIMIT_S)
    except subprocess.TimeoutExpired:
        proc.terminate()
        try:
            proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
        pytest.fail(f"{cmd} did not end within {RUN_LIMIT_S} s")
    assert proc.returncode == 0, f"{cmd} exited with {proc.returncode}:\n{err[-6000:]}"
    return out


def _torchrun(world: int, *cmd: str) -> str:
    return _run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                 f"--nproc-per-node={world}", *cmd])


def _run_ranks(case: str, d: Path, inputs: dict, world: int = 2) -> list:
    """``world`` ranks of the worker on ``inputs``; their outputs by rank."""
    d.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, d / "inputs.pt")
    _torchrun(world, str(WORKER), case, str(d))
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _cli(name: str, argv: list) -> str:
    """The training CLI ``name`` in a process of its own; its standard output."""
    return _run([sys.executable, "-m", f"vectorquantizedcpc_tpu_torch.cli.{name}", *argv])


def _np(t) -> np.ndarray:
    return t.detach().double().numpy()


# --------------------------------------------------------------------- CPC


@pytest.fixture(scope="module")
def cpc_runs(tmp_path_factory):
    """JAX's sharded steps at data = 2, the port's one-process steps and its
    2-rank steps, from the same weights, batches, negatives and lrs."""
    argv = CPC_ARGV + ["runtime.mesh_data=2", "runtime.platform=cpu"]
    jconf = jax_load_conf(CPC_ARGV)
    state = jax_cpc.init_train_state(jconf, jax.random.key(0))
    encoder_sd = encoder_from_jax_params(flat(state.enc), flat(state.vq))
    cpc_sd = cpc_from_jax_params(flat(state.cpc))
    rng = np.random.default_rng(21)
    t = jconf.data.dataset.cpc.clip_length_mel
    length = t // 2 - jconf.model.cpc.n_prediction_steps // 2
    mels = [rng.normal(size=(4, 2, 80, t)).astype(np.float32) for _ in range(STEPS)]
    negs = [tuple(np.array(x) for x in jax_sample(jconf.model.cpc, jax.random.key(30 + i), length))
            for i in range(STEPS)]

    mesh = make_mesh(data=2)
    step = jax_cpc.make_train_step(jconf, mesh, inject_negatives=True)
    theirs = []
    for m, (utt, seq) in zip(mels, negs):
        state, metrics = step(state, jax.device_put(m, batch_sharding(mesh, 4)),
                              (jnp.asarray(utt), jnp.asarray(seq)), jnp.float32(LR))
        theirs.append({k: np.asarray(v, np.float64) for k, v in metrics.items()})
    jax_sd = {"encoder": encoder_from_jax_params(flat(state.enc), flat(state.vq)),
              "cpc": cpc_from_jax_params(flat(state.cpc))}

    one = CPCTrainer(load_conf(CPC_ARGV), "cpu")
    one.encoder.load_state_dict(encoder_sd, strict=True)
    one.cpc.load_state_dict(cpc_sd, strict=True)
    ours_one = [{k: _np(v) for k, v in one.train_step(
        torch.from_numpy(m), torch.from_numpy(u), torch.from_numpy(q), LR).items()}
        for m, (u, q) in zip(mels, negs)]
    one_sd = {"encoder": one.encoder.state_dict(), "cpc": one.cpc.state_dict()}

    ranks = _run_ranks("cpc", tmp_path_factory.mktemp("cpc"), {
        "argv": argv, "encoder": encoder_sd, "cpc": cpc_sd,
        "mels": [torch.from_numpy(m) for m in mels],
        "utt": [torch.from_numpy(u) for u, _ in negs],
        "seq": [torch.from_numpy(q) for _, q in negs], "lrs": [LR] * STEPS})
    return {"jax": (theirs, jax_sd), "one": (ours_one, one_sd), "ranks": ranks,
            "n_anchors": 4 * 2 * length}


def _metrics_of(rank: dict) -> list:
    return [{k: _np(v) for k, v in m.items()} for m in rank["metrics"]]


def test_cpc_ranks_end_with_the_same_state(cpc_runs):
    """Every rank holds the same weights, EMA buffers, Adam moments and metrics, bit for bit."""
    a, b = cpc_runs["ranks"]
    for part in ("encoder", "cpc", "exp_avg"):
        for key, v in a[part].items():
            assert torch.equal(v, b[part][key]), (part, key)
    for ma, mb in zip(a["metrics"], b["metrics"]):
        for key in ma:
            assert torch.equal(ma[key], mb[key]), key


@pytest.mark.parametrize(
    "reference, loss_rtol, weight_agree, ema_rtol",
    [
        # JAX's sharded step: one algorithm in other summation orders, as the
        # one-process lockstep in tests/test_torch_train_cpc.py holds them:
        # losses and perplexity within 1e-5 at the first step, 1e-4 after
        # (Adam moves noise-level gradient elements by up to 2 lr); 99 % of
        # the weights within 0.1 lr; the EMA buffers within 1e-3.
        ("jax", 1e-4, 0.99, 1e-3),
        # The port's one-process step on the global batch: the same code, the
        # sums over the ranks taken in two parts.
        ("one", 1e-4, 0.99, 1e-3),
    ],
)
def test_cpc_two_ranks_match(cpc_runs, reference, loss_rtol, weight_agree, ema_rtol):
    """The 2-rank step against ``reference`` on the global batch: losses,
    perplexity (of the global code frequencies) and accuracies (within two
    anchors' share, near-tie flips), every weight within 2 lr a step, the
    VQ-EMA count and weight."""
    ref_metrics, ref_sd = cpc_runs[reference]
    rank = cpc_runs["ranks"][0]
    for i, (a, b) in enumerate(zip(_metrics_of(rank), ref_metrics)):
        rtol = 1e-5 if i == 0 else loss_rtol
        for key in ("loss", "cpc_loss", "vq_loss", "perplexity"):
            np.testing.assert_allclose(a[key], b[key], rtol=rtol, err_msg=f"step {i} {key}")
        np.testing.assert_allclose(a["accuracies"], b["accuracies"],
                                   atol=2.0 / cpc_runs["n_anchors"] + 1e-9)
    close = total = 0
    for part in ("encoder", "cpc"):
        for key, r in ref_sd[part].items():
            got, r = _np(rank[part][key]), _np(r)
            if key.startswith("codebook."):
                np.testing.assert_allclose(got, r, rtol=ema_rtol,
                                           atol=ema_rtol * np.abs(r).max(), err_msg=key)
                continue
            d = np.abs(got - r)
            assert d.max() <= 2 * LR * STEPS * 1.01, (part, key, d.max())
            close += int((d <= 0.1 * LR).sum())
            total += d.size
    assert close / total >= weight_agree, close / total


# ----------------------------------------------------------------- vocoder


@pytest.fixture(scope="module")
def vocoder_runs(tmp_path_factory):
    argv = VOC_ARGV + ["runtime.mesh_data=2", "runtime.platform=cpu",
                       f"data.loader.batch_size={VOC_B}"]
    jconf = jax_load_conf(VOC_ARGV)
    state = jax_vocoder.init_train_state(jconf, jax.random.key(0))
    enc, vq = encoder_init(jax.random.key(1), jconf.model.encoder)
    enc_sd, voc_sd = from_jax_params(flat(enc), flat(vq), flat(state.params))
    rng = np.random.default_rng(23)
    batches = [(rng.integers(0, 256, size=(VOC_B, 4 * 8 + 1)).astype(np.int32),
                rng.normal(size=(VOC_B, 80, 4)).astype(np.float32),
                rng.integers(0, 4, size=VOC_B).astype(np.int32)) for _ in range(STEPS)]

    mesh = make_mesh(data=2)
    step = jax_vocoder.make_train_step(jconf, mesh)
    theirs = []
    for audio, mels, spk in batches:
        state, m = step(state, enc, vq, *(jax.device_put(x, batch_sharding(mesh, x.ndim))
                                          for x in (audio, mels, spk)), jnp.float32(LR))
        theirs.append(float(m["loss"]))
    mu = state.opt_state.inner_state[1][0].mu
    jax_out = {"vocoder": from_jax_params(flat(enc), flat(vq), flat(state.params))[1],
               "exp_avg": from_jax_params(flat(enc), flat(vq), flat(mu))[1],
               "losses": np.asarray(theirs)}

    conf = load_conf(VOC_ARGV + [f"data.loader.batch_size={VOC_B}"])
    encoder = Encoder(conf.model.encoder)
    encoder.load_state_dict(enc_sd, strict=True)
    one = VocoderTrainer(conf, encoder, "cpu")
    one.vocoder.load_state_dict(voc_sd, strict=True)
    losses = [float(one.train_step(*(torch.from_numpy(x) for x in b), LR)["loss"])
              for b in batches]
    names = {id(p): n for n, p in one.vocoder.named_parameters()}
    one_out = {"vocoder": one.vocoder.state_dict(), "losses": np.asarray(losses),
               "exp_avg": {names[id(p)]: st["exp_avg"] for p, st in one.optimizer.state.items()}}

    ranks = _run_ranks("vocoder", tmp_path_factory.mktemp("vocoder"), {
        "argv": argv, "encoder": enc_sd, "vocoder": voc_sd,
        "audio": [torch.from_numpy(b[0]) for b in batches],
        "mels": [torch.from_numpy(b[1]) for b in batches],
        "spk": [torch.from_numpy(b[2]) for b in batches], "lrs": [LR] * STEPS})
    return {"jax": jax_out, "one": one_out, "ranks": ranks}


def test_vocoder_ranks_end_with_the_same_state(vocoder_runs):
    a, b = vocoder_runs["ranks"]
    assert torch.equal(a["losses"], b["losses"])
    for part in ("vocoder", "exp_avg"):
        for key, v in a[part].items():
            assert torch.equal(v, b[part][key]), (part, key)


@pytest.mark.parametrize("reference", ["jax", "one"])
def test_vocoder_two_ranks_match_with_the_clip_active(vocoder_runs, reference):
    """The 2-rank step against ``reference`` on the global batch, the clip
    active: losses within 1e-5; Adam's first moments (0.1 x the clipped
    gradient after the first step, then its EMA) within 1e-4 of their
    largest element, where clipping each rank's own gradient before the mean
    moves them by about 1e-1 of it; every weight within 0.1 lr (the
    one-process lockstep's bound at f32)."""
    ref = vocoder_runs[reference]
    rank = vocoder_runs["ranks"][0]
    np.testing.assert_allclose(_np(rank["losses"]), ref["losses"], rtol=1e-5)
    for key, r in ref["exp_avg"].items():
        got, r = _np(rank["exp_avg"][key]), _np(torch.as_tensor(r))
        np.testing.assert_allclose(got, r, rtol=0, atol=1e-4 * np.abs(r).max(), err_msg=key)
    for key, r in ref["vocoder"].items():
        d = np.abs(_np(rank["vocoder"][key]) - _np(torch.as_tensor(r)))
        assert d.max() <= 0.1 * LR, (key, d.max())


def test_a_local_clip_would_fail_the_vocoder_test():
    """The clip is active on each rank's share too: the mean of the ranks'
    clipped gradients (per-rank clip) is far from the clipped mean."""
    conf = load_conf(VOC_ARGV + [f"data.loader.batch_size={VOC_B}"])
    rng = np.random.default_rng(23)
    audio = torch.from_numpy(rng.integers(0, 256, size=(VOC_B, 33)).astype(np.int32))
    mels = torch.from_numpy(rng.normal(size=(VOC_B, 80, 4)).astype(np.float32))
    spk = torch.from_numpy(rng.integers(0, 4, size=VOC_B).astype(np.int32))
    torch.manual_seed(0)
    trainer = VocoderTrainer(conf, Encoder(conf.model.encoder), "cpu")
    params = list(trainer.vocoder.parameters())

    def grads(rows):
        loss = trainer.loss(audio[rows], mels[rows], spk[rows])
        return torch.autograd.grad(loss, params)

    def clipped(g):
        norm = torch.sqrt(sum((x.double() ** 2).sum() for x in g))
        assert norm > 10 * conf.training_vocoder.trainer.gradient_clip_val
        return [x.double() / norm * conf.training_vocoder.trainer.gradient_clip_val for x in g]

    halves = [grads(slice(0, 2)), grads(slice(2, 4))]
    mean = [(a + b) / 2 for a, b in zip(*halves)]
    local = [(a + b) / 2 for a, b in zip(*map(clipped, halves))]
    glob = clipped(mean)
    worst = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(local, glob))
    assert worst > 1e-2


# ------------------------------------------------------- keys and refusals


def test_mesh_keys_load_from_the_cli_and_a_jax_yaml(tmp_path):
    argv = ["runtime.mesh_data=8", "runtime.coordinator_address=10.0.0.1:1234",
            "runtime.num_processes=2", "runtime.process_id=1"]
    rt = load_conf(argv).runtime
    assert (rt.mesh_data, rt.mesh_model, rt.coordinator_address, rt.num_processes,
            rt.process_id) == (8, 1, "10.0.0.1:1234", 2, 1)
    # A path_extend_conf file as a JAX user writes it, read by both packages.
    path = tmp_path / "mesh.yaml"
    path.write_text(yaml.safe_dump({"runtime": {"mesh_data": 2, "mesh_model": 1}}))
    ours, theirs = load_conf([f"path_extend_conf={path}"]), jax_load_conf(
        [f"path_extend_conf={path}"])
    assert ours.runtime.mesh_data == theirs.runtime.mesh_data == 2
    assert "runtime.mesh_data" not in configs.JAX_ONLY_KEYS
    assert port_mesh.launch_args(load_conf(["runtime.platform=cpu", "runtime.mesh_data=2"])
                                 .runtime) == ["--nproc-per-node=2", "--standalone"]
    assert port_mesh.launch_args(load_conf(["runtime.platform=cpu"] + argv).runtime) == [
        "--nproc-per-node=4", "--nnodes=2", "--node-rank=1", "--master-addr=10.0.0.1",
        "--master-port=1234"]
    assert port_mesh.launch_args(load_conf(["runtime.platform=cpu"]).runtime) is None


@pytest.mark.parametrize("cli", ["train_cpc", "train_vocoder"])
@pytest.mark.parametrize("extra, error, match", [
    (["runtime.mesh_data=0"], ValueError, "runtime.mesh_data=0 must be at least 1"),
    (["runtime.mesh_data=2", "runtime.num_processes=2"], ValueError, "describe a cluster"),
    (["runtime.mesh_data=3", "training.cpc.n_speakers_per_batch=4",
      "data.loader.batch_size=4"], ValueError, "=4 does not divide over runtime.mesh_data=3"),
])
def test_cli_refuses_before_starting_ranks(cli, extra, error, match, monkeypatch):
    import importlib

    module = importlib.import_module(f"vectorquantizedcpc_tpu_torch.cli.{cli}")
    monkeypatch.setattr(module, "start_ranks", lambda *a, **k: pytest.fail("ranks started"))
    with pytest.raises(error, match=match):
        module.main(["runtime.platform=cpu"] + extra)


def test_more_local_ranks_than_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 local ranks need 2 CUDA cards and this host has 1"):
        port_mesh.launch_args(load_conf(["runtime.mesh_data=2"]).runtime)
    # An explicit card is a request to share it.
    assert port_mesh.launch_args(load_conf(["runtime.mesh_data=2", "runtime.platform=cuda:0"])
                                 .runtime)[0] == "--nproc-per-node=2"
    assert port_mesh.backend_for(torch.device("cuda", 0), "cuda:0", 2) == "gloo"
    assert port_mesh.backend_for(torch.device("cuda", 1), None, 2) == "nccl"
    assert port_mesh.backend_for(torch.device("cpu"), "cpu", 2) == "gloo"


def test_speakers_or_rows_that_do_not_divide_raise():
    with pytest.raises(ValueError, match="n_speakers_per_batch=3 does not divide over "
                                         r"runtime.mesh_data=2"):
        local_share(3, 2, "n_speakers_per_batch")
    mesh = port_mesh.DataMesh(None, 1, 2, torch.device("cpu"))
    x = np.arange(24).reshape(4, 6)
    np.testing.assert_array_equal(shard_batch(x, mesh), x[2:])
    np.testing.assert_array_equal(shard_batch(x, mesh, axis=1), x[:, 3:])
    assert shard_batch(x, None) is x
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(np.zeros((3, 2)), mesh)


def test_mesh_data_without_ranks_raises():
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        port_mesh.mesh_from_conf(load_conf(["runtime.platform=cpu",
                                            "runtime.mesh_data=2"]).runtime)


# ------------------------------------------------ one rank in this process


@pytest.fixture
def world_of_one():
    """A gloo process group of one rank in this process, destroyed after."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_one_rank_gives_the_bits_of_no_group(world_of_one):
    """At world size 1 the flat buffer, its all_reduce and the folded
    metrics change no bit of either trainer's step."""
    conf = load_conf(CPC_ARGV)
    rng = np.random.default_rng(5)
    t = conf.data.dataset.cpc.clip_length_mel
    length = t // 2 - conf.model.cpc.n_prediction_steps // 2
    gen = torch.Generator().manual_seed(3)
    from vectorquantizedcpc_tpu_torch.models.cpc import sample_negative_indices

    batches = [(torch.from_numpy(rng.normal(size=(4, 2, 80, t)).astype(np.float32)),
                *sample_negative_indices(conf.model.cpc, length, gen)) for _ in range(2)]
    runs = []
    for group in (None, world_of_one):
        tr = CPCTrainer(conf, "cpu", group)
        metrics = [tr.train_step(*b, LR) for b in batches]
        runs.append((metrics, {**tr.encoder.state_dict(), **tr.cpc.state_dict()}))
    for ma, mb in zip(runs[0][0], runs[1][0]):
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert all(torch.equal(v, runs[1][1][k]) for k, v in runs[0][1].items())

    vconf = load_conf(VOC_ARGV + [f"data.loader.batch_size={VOC_B}"])
    vrng = np.random.default_rng(6)
    vb = (torch.from_numpy(vrng.integers(0, 256, size=(VOC_B, 33)).astype(np.int32)),
          torch.from_numpy(vrng.normal(size=(VOC_B, 80, 4)).astype(np.float32)),
          torch.from_numpy(vrng.integers(0, 4, size=VOC_B).astype(np.int32)))
    vruns = []
    for group in (None, world_of_one):
        torch.manual_seed(1)
        tr = VocoderTrainer(vconf, Encoder(vconf.model.encoder), "cpu", group)
        losses = [tr.train_step(*vb, LR)["loss"] for _ in range(2)]
        vruns.append((losses, tr.vocoder.state_dict()))
    assert all(torch.equal(a, b) for a, b in zip(vruns[0][0], vruns[1][0]))
    assert all(torch.equal(v, vruns[1][1][k]) for k, v in vruns[0][1].items())


def test_step_graph_refuses_gloo_on_a_card(world_of_one):
    """A gloo group's collectives cannot be captured: on a card the step
    graph raises at once, before any eager step runs."""
    from vectorquantizedcpc_tpu_torch.training.step_graph import StepGraph

    ran = []
    graph = StepGraph(lambda *x: ran.append(x) or {}, torch.optim.SGD([torch.zeros(1)], 0.1),
                      torch.device("cuda"), world_of_one)
    with pytest.raises(RuntimeError, match="gloo process group's collectives cannot be captured"):
        graph.step((torch.zeros(1),), 0.1)
    assert ran == [] and graph.eager_steps == 0


# ------------------------------------------------------------- the CLIs


def _cpc_cli(d: Path, ckpt: str, *extra: str) -> list:
    return CPC_ARGV[:-1] + [
        "training.cpc.n_speakers_per_batch=2", "runtime.precision=float32",
        "runtime.platform=cpu", "runtime.mesh_data=2",
        "data.dataset.name=synthetic", f"data.corpus.root={d / 'corpus'}",
        f"data.dataset.adress_data_root={d / 'features'}", f"checkpoint_dir={d / ckpt}",
        "training.cpc.log_interval=1", "data.loader.num_workers=1", *extra]


def test_train_cpc_cli_two_ranks_checkpoint_and_resume(tmp_path):
    """4 speakers, S = 2 over 2 ranks: 2 steps an epoch. Rank 0 alone logs
    and saves; resume= from its checkpoint re-runs that epoch and goes on."""
    out = _cli("train_cpc", _cpc_cli(tmp_path, "a", "training.cpc.n_epochs=1",
                                     "training.cpc.checkpoint_interval=1"))
    assert out.count("Mesh: data=2 model=1 (gloo)") == 1
    assert out.count("Saving checkpoint (async): model.ckpt-1.pt") == 1
    assert out.count("epoch:1, cpc loss:") == 1
    assert [p.name for p in (tmp_path / "a").glob("*.pt")] == ["model.ckpt-1.pt"]
    first = torch.load(tmp_path / "a" / "model.ckpt-1.pt", weights_only=True)
    assert first["epoch"] == 1

    out = _cli("train_cpc", _cpc_cli(tmp_path, "b", "training.cpc.n_epochs=2",
                                     "training.cpc.checkpoint_interval=1",
                                     f"resume={tmp_path / 'a' / 'model.ckpt-1.pt'}"))
    assert out.count("Resume checkpoint from:") == 1 and "epoch 1" in out
    assert [p.name for p in (tmp_path / "b").glob("*.pt")] == ["model.ckpt-2.pt"]
    second = torch.load(tmp_path / "b" / "model.ckpt-2.pt", weights_only=True)
    assert second["epoch"] == 2
    moved = [k for k, v in second["encoder"].items()
             if v.is_floating_point() and not torch.equal(v, first["encoder"][k])]
    assert "rnn.weight_hh_l0" in moved


def test_preemption_on_one_rank_stops_both(tmp_path):
    """Rank 1 alone is asked to stop: both ranks agree at the first group's
    end and return there, and rank 0 alone writes the checkpoint."""
    argv = _cpc_cli(tmp_path, "ck", "training.cpc.n_epochs=5",
                    "training.cpc.checkpoint_interval=100")
    ranks = _run_ranks("preempt", tmp_path / "run", {"argv": argv})
    assert [(r["epoch"], r["global_step"]) for r in ranks] == [(1, 2), (1, 2)]
    assert (tmp_path / "run" / "writes.txt").read_text() == "0 model.ckpt-1.pt\n"
    assert [p.name for p in (tmp_path / "ck").glob("*.pt")] == ["model.ckpt-1.pt"]


def test_train_vocoder_cli_two_ranks_checkpoint_and_resume(tmp_path):
    """37 training utterances in global batches of 8 (4 a rank): 4 steps an
    epoch. Rank 0 alone validates and saves; a rerun auto-resumes on both
    ranks from its checkpoint."""
    from vectorquantizedcpc_tpu_torch.cli import preprocess
    from vectorquantizedcpc_tpu_torch.data.corpus import SyntheticCorpus
    from vectorquantizedcpc_tpu_torch.data.datamodule import VocoderDataModule

    SyntheticCorpus(tmp_path / "corpus", n_speakers=4, n_utterances=10,
                    duration_s=0.25).utterances()
    data = ["data.dataset.name=synthetic", f"data.corpus.root={tmp_path / 'corpus'}",
            f"data.dataset.adress_data_root={tmp_path / 'features'}",
            "data.loader.num_workers=1"]
    preprocess.main(SMALL + ["data.dataset.clip_length_mel=4"] + data)
    torch.manual_seed(0)
    conf = load_conf(VOC_ARGV)
    torch.save({"encoder": Encoder(conf.model.encoder).state_dict()}, tmp_path / "cpc.pt")
    argv = SMALL + ["data.dataset.clip_length_mel=4", "runtime.precision=float32",
                    "runtime.platform=cpu", "runtime.mesh_data=2", "data.loader.batch_size=8",
                    f"cpc_checkpoint={tmp_path / 'cpc.pt'}",
                    f"training_vocoder.ckpt_log.dir_root={tmp_path / 'runs'}",
                    "training_vocoder.trainer.val_interval_epoch=1"] + data
    ckpt_dir = tmp_path / "runs" / "default" / "version_-1" / "checkpoints"

    _cli("train_vocoder", argv + ["training_vocoder.trainer.max_epochs=1"])
    assert [p.name for p in ckpt_dir.glob("*.pt")] == ["model.ckpt-4.pt"]
    samples = sorted(p.name for p in (ckpt_dir.parent / "samples").glob("*.wav"))
    val_speakers = {spk for _, _, spk in VocoderDataModule(
        load_conf(argv).data, data_dir=tmp_path / "features", seed=13).val_items()}
    assert samples == sorted(f"spk_{s}{sfx}_step4.wav" for s in val_speakers
                             for sfx in ("", f"_to_{(s + 5) % 4}"))

    out = _cli("train_vocoder", argv + ["training_vocoder.trainer.max_epochs=2"])
    assert out.count("Auto-resume from:") == 1 and "model.ckpt-4.pt: step 4, epoch 1" in out
    assert sorted(p.name for p in ckpt_dir.glob("*.pt")) == ["model.ckpt-4.pt",
                                                             "model.ckpt-8.pt"]
    ckpt = torch.load(ckpt_dir / "model.ckpt-8.pt", weights_only=True)
    assert (ckpt["step"], ckpt["epoch"]) == (8, 2)
