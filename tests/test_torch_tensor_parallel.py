"""Tensor parallelism in the port (``parallel/tensor.py``), on the CPU with gloo ranks.

Each multi-rank run starts its processes through torchrun, as the CLIs
do: of ``torch_port_tp_worker.py`` (whose process group has a 60 s
timeout) or of a training CLI, limited to RUN_LIMIT_S, after which torchrun
is stopped and stops its ranks, so a hang fails one test. The same
weights, global batches and injected negatives (numpy, from a seed) go
through:

- the JAX package's sharded CPC step at ``make_mesh(data=2, model=2)`` on
  the 8 virtual CPU devices of ``tests/conftest.py``,
- the port's one-process steps on the global batch,
- the port's 2 ranks at M 2 and 4 ranks at D 2 x M 2, each on its data
  share with its shards.

Then the rules against the JAX package's ``state_shardings`` for every
leaf, the VQ tie across shards, the clip's norm, both training CLIs at
``runtime.mesh_model=2`` with the JAX package's checkpoints, and the
refusals.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from test_torch_parallel import CPC_ARGV, LR, _cli, _np, _torchrun, world_of_one  # noqa: F401
from torch_port_util import SMALL, flat
from vectorquantizedcpc_tpu.configs import load_conf as jax_load_conf
from vectorquantizedcpc_tpu.models.cpc import sample_negative_indices as jax_sample
from vectorquantizedcpc_tpu.models.encoder import encoder_init
from vectorquantizedcpc_tpu.parallel.mesh import make_mesh
from vectorquantizedcpc_tpu.parallel.sharding import batch_sharding, state_shardings
from vectorquantizedcpc_tpu.training import cpc as jax_cpc
from vectorquantizedcpc_tpu.training import vocoder as jax_vocoder
from vectorquantizedcpc_tpu_torch.configs import load_conf
from vectorquantizedcpc_tpu_torch.models.encoder import Encoder
from vectorquantizedcpc_tpu_torch.parallel import mesh as port_mesh
from vectorquantizedcpc_tpu_torch.parallel.tensor import ModelGroup, shard_dim
from vectorquantizedcpc_tpu_torch.training.checkpoint import save_checkpoint
from vectorquantizedcpc_tpu_torch.training.cpc import CPCTrainer
from vectorquantizedcpc_tpu_torch.training.schedule import WarmupSchedule
from vectorquantizedcpc_tpu_torch.training.vocoder import VocoderTrainer, clip_by_global_norm_
from vectorquantizedcpc_tpu_torch.weights import (cpc_from_jax_params, cpc_train_state_from_jax,
                                                  encoder_from_jax_params, from_jax_params,
                                                  vocoder_train_state_from_jax)

torch.set_num_threads(1)

WORKER = Path(__file__).resolve().parent / "torch_port_tp_worker.py"
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jax_ckpt"
FIXTURE_ARGV = json.loads((FIXTURES / "argv.json").read_text())
STEPS = 3
# SMALL's vocoder with a PreNet of 7 per direction: its gate axis (21) does
# not divide over 2 ranks and stays replicated, while the AR GRU's (96),
# fc1's (16) and fc2's (256) are split. A clip of 1e-3 is far below the
# gradient's global norm, so the clip is active.
VOC_ARGV = SMALL + ["data.dataset.clip_length_mel=4", "runtime.precision=float32",
                    "training_vocoder.model.network.rnnms.dim_voc_latent=14",
                    "training_vocoder.trainer.gradient_clip_val=0.001",
                    "data.loader.batch_size=4"]
VOC_STEPS = 2
TIE_CODES, TIE_DIM = 8, 4  # a rank's half of the tie test's codebook


def _mesh_argv(data: int, model: int) -> list:
    return [f"runtime.mesh_data={data}", f"runtime.mesh_model={model}", "runtime.platform=cpu"]


def _ranks(d: Path, inputs: dict, world: int, *cases: str) -> list:
    d.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, d / "inputs.pt")
    _torchrun(world, str(WORKER), str(d), *cases)
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def inputs():
    """The JAX package's initial CPC and vocoder weights in the port's
    layout, STEPS global CPC batches with negatives, VOC_STEPS vocoder
    batches and the tie test's codes."""
    jconf = jax_load_conf(CPC_ARGV)
    state = jax_cpc.init_train_state(jconf, jax.random.key(0))
    rng = np.random.default_rng(41)
    t = jconf.data.dataset.cpc.clip_length_mel
    length = t // 2 - jconf.model.cpc.n_prediction_steps // 2
    mels = [rng.normal(size=(4, 2, 80, t)).astype(np.float32) for _ in range(STEPS)]
    negs = [tuple(np.array(x) for x in jax_sample(jconf.model.cpc, jax.random.key(50 + i),
                                                  length)) for i in range(STEPS)]
    vconf = jax_load_conf(VOC_ARGV)
    vstate = jax_vocoder.init_train_state(vconf, jax.random.key(2))
    enc, vq = encoder_init(jax.random.key(3), vconf.model.encoder)
    voc_enc, voc = from_jax_params(flat(enc), flat(vq), flat(vstate.params))
    batches = [(rng.integers(0, 256, size=(4, 4 * 8 + 1)).astype(np.int32),
                rng.normal(size=(4, 80, 4)).astype(np.float32),
                rng.integers(0, 4, size=4).astype(np.int32)) for _ in range(VOC_STEPS)]
    tie_half = rng.normal(size=(TIE_CODES, TIE_DIM)).astype(np.float32)
    return {
        "jax_state": state, "jax_conf": jconf,
        "encoder": encoder_from_jax_params(flat(state.enc), flat(state.vq)),
        "cpc": cpc_from_jax_params(flat(state.cpc)),
        "mels": [torch.from_numpy(m) for m in mels],
        "utt": [torch.from_numpy(u) for u, _ in negs],
        "seq": [torch.from_numpy(q) for _, q in negs], "lrs": [LR] * STEPS,
        "n_anchors": 4 * 2 * length,
        "voc_encoder": voc_enc, "vocoder": voc,
        "audio": [torch.from_numpy(b[0]) for b in batches],
        "voc_mels": [torch.from_numpy(b[1]) for b in batches],
        "spk": [torch.from_numpy(b[2]) for b in batches], "voc_lrs": [LR] * VOC_STEPS,
        "tie_half": torch.from_numpy(tie_half),
        # each latent near one code, but exactly as near its copy in the other half
        "tie_x": torch.from_numpy((tie_half[rng.integers(0, TIE_CODES, size=(2, 5))]
                                   + 0.01 * rng.normal(size=(2, 5, TIE_DIM))).astype(np.float32)),
    }


def _port_inputs(inputs: dict, data: int, model: int) -> dict:
    out = {k: v for k, v in inputs.items() if not k.startswith("jax_")}
    out["argv"] = CPC_ARGV + _mesh_argv(data, model)
    out["voc_argv"] = VOC_ARGV + _mesh_argv(data, model)
    return out


@pytest.fixture(scope="module")
def jax_tp(inputs):
    """The JAX package's sharded CPC steps at data 2 x model 2."""
    mesh = make_mesh(data=2, model=2)
    step = jax_cpc.make_train_step(inputs["jax_conf"], mesh, inject_negatives=True)
    state, metrics = inputs["jax_state"], []
    for m, u, q in zip(inputs["mels"], inputs["utt"], inputs["seq"]):
        state, mt = step(state, jax.device_put(m.numpy(), batch_sharding(mesh, 4)),
                         (jnp.asarray(u.numpy()), jnp.asarray(q.numpy())), jnp.float32(LR))
        metrics.append({k: np.asarray(v, np.float64) for k, v in mt.items()})
    sd = {**{f"encoder.{k}": v for k, v in
             encoder_from_jax_params(flat(state.enc), flat(state.vq)).items()},
          **{f"cpc.{k}": v for k, v in cpc_from_jax_params(flat(state.cpc)).items()}}
    return metrics, sd


@pytest.fixture(scope="module")
def one(inputs):
    """The port's one process on the global batches: CPC and vocoder."""
    tr = CPCTrainer(load_conf(CPC_ARGV), "cpu")
    tr.encoder.load_state_dict(inputs["encoder"], strict=True)
    tr.cpc.load_state_dict(inputs["cpc"], strict=True)
    metrics = [{k: _np(v) for k, v in tr.train_step(m, u, q, LR).items()}
               for m, u, q in zip(inputs["mels"], inputs["utt"], inputs["seq"])]
    sd = {**{f"encoder.{k}": v for k, v in tr.encoder.state_dict().items()},
          **{f"cpc.{k}": v for k, v in tr.cpc.state_dict().items()}}
    conf = load_conf(VOC_ARGV)
    encoder = Encoder(conf.model.encoder)
    encoder.load_state_dict(inputs["voc_encoder"], strict=True)
    vt = VocoderTrainer(conf, encoder, "cpu")
    vt.vocoder.load_state_dict(inputs["vocoder"], strict=True)
    losses = [float(vt.train_step(a, m, s, LR)["loss"])
              for a, m, s in zip(inputs["audio"], inputs["voc_mels"], inputs["spk"])]
    return {"cpc": (metrics, sd, tr), "vocoder": (np.asarray(losses), vt)}


@pytest.fixture(scope="module")
def two(inputs, tmp_path_factory):
    """2 ranks at M 2: CPC, vocoder and the VQ tie."""
    return _ranks(tmp_path_factory.mktemp("tp2"), _port_inputs(inputs, 1, 2), 2,
                  "cpc", "vocoder", "tie")


@pytest.fixture(scope="module")
def four(inputs, tmp_path_factory):
    """4 ranks at D 2 x M 2: CPC."""
    return _ranks(tmp_path_factory.mktemp("tp4"), _port_inputs(inputs, 2, 2), 4, "cpc")


@pytest.fixture(scope="module", params=["two", "four"])
def cpc_ranks(request):
    return request.param, [r["cpc"] for r in request.getfixturevalue(request.param)]


# ----------------------------------------------------------------- (a) rules


def _marked(state, mesh):
    """``state``'s leaves as numpy arrays that vary only along the axis
    their JAX sharding puts on "model" (constant where it is replicated)."""
    def mark(leaf, sharding):
        shape = np.shape(leaf)
        axes = [i for i, a in enumerate(sharding.spec) if a == "model"]
        if not shape:  # scalars (counts, hyperparameters) as they are
            return np.asarray(leaf)
        if not axes:
            return np.zeros(shape, np.float32)
        a = axes[0]
        ramp = np.arange(1, shape[a] + 1, dtype=np.float32).reshape(
            [-1 if i == a else 1 for i in range(len(shape))])
        return np.broadcast_to(ramp, shape).copy()

    return jax.tree.map(mark, state, state_shardings(mesh, state))


def _varying_dim(t: torch.Tensor):
    dims = [d for d in range(t.dim()) if t.shape[d] > 1
            and not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]
    assert len(dims) <= 1, dims
    return dims[0] if dims else None


@pytest.mark.parametrize("what", ["cpc", "vocoder"])
def test_a_shard_dim_is_the_jax_spec_of_every_leaf(what, jax_devices):
    """Every leaf of the JAX train state at data 2 x model 4, Adam's moments
    included, through the weight-name map: the dim along which the port's
    tensor varies (its JAX axis on "model") is ``shard_dim``'s, at the
    test's widths, where some axes do not divide by 4."""
    mesh = make_mesh(data=2, model=4)
    if what == "cpc":
        argv = CPC_ARGV + ["model.encoder.channels=30"]  # 30 % 4 != 0: replicated
        state = jax_cpc.init_train_state(jax_load_conf(argv), jax.random.key(0))
        names = CPCTrainer(load_conf(argv), "cpu").param_names
        tree = cpc_train_state_from_jax(serialization.to_state_dict(_marked(state, mesh)), names)
        tensors = {**{f"encoder.{k}": v for k, v in tree["encoder"].items()
                      if k != "rnn.bias_hh_l0"},  # no JAX leaf: the folded bias' zeros
                   **{f"cpc.{k}": v for k, v in tree["cpc"].items()}}
    else:
        conf = jax_load_conf(VOC_ARGV)
        state = jax_vocoder.init_train_state(conf, jax.random.key(0))
        names = [n for n, _ in VocoderTrainer(load_conf(VOC_ARGV), Encoder(
            load_conf(VOC_ARGV).model.encoder), "cpu").vocoder.named_parameters()]
        tree = vocoder_train_state_from_jax(serialization.to_state_dict(_marked(state, mesh)),
                                            names)
        tensors = dict(tree["vocoder"])
    for i, name in enumerate(names):
        for k in ("exp_avg", "exp_avg_sq"):
            tensors[f"adam.{k}.{name}"] = tree["optimizer"]["state"][i][k]
    seen = {True: 0, False: 0}
    for name, t in tensors.items():
        rule = shard_dim(name.split(".", 2)[2] if name.startswith("adam.") else name,
                         t.shape, 4)
        assert rule == _varying_dim(t), (name, tuple(t.shape))
        seen[rule is not None] += 1
    assert seen[True] and seen[False], seen
    replicated = ("encoder.conv.weight", "encoder.encoder.2.weight") if what == "cpc" else (
        "rnnms.prenet.weight_ih_l0", "rnnms.prenet.bias_hh_l1_reverse")  # 30 channels, 21 gates
    assert all(shard_dim(n, tensors[n].shape, 4) is None for n in replicated)


# ----------------------------------------------------------- (b) CPC runs


def _replicated_bits(ranks: list, model: int) -> int:
    """The ranks of each model group hold the same bits of every replicated
    tensor and Adam moment; returns how many tensors were compared."""
    n = 0
    for g in range(len(ranks) // model):
        first = ranks[g * model]["local"]
        for r in ranks[g * model + 1:(g + 1) * model]:
            assert r["local"]["sharded"] == first["sharded"]
            for key, v in first["tensors"].items():
                if key not in first["sharded"]:
                    assert torch.equal(v, r["local"]["tensors"][key]), key
                    n += 1
    return n


def test_b_model_ranks_hold_the_same_replicated_bits(cpc_ranks):
    """After STEPS steps every model rank holds the same bits of each
    replicated parameter, buffer and moment, and every rank gathers the
    same checkpoint; a data group's ranks hold the same shards."""
    label, ranks = cpc_ranks
    assert _replicated_bits(ranks, 2) > 20
    ref = ranks[0]["checkpoint"]
    for r in ranks[1:]:
        for part in ("encoder", "cpc"):
            for key, v in ref[part].items():
                assert torch.equal(v, r["checkpoint"][part][key]), (label, part, key)
    if label == "four":
        for m in range(2):
            a, b = ranks[m]["local"]["tensors"], ranks[2 + m]["local"]["tensors"]
            assert all(torch.equal(v, b[k]) for k, v in a.items())


def test_b_each_rank_holds_only_its_shards(cpc_ranks, one):
    """A rank's parameters, Adam moments and VQ buffers at M 2 weigh the
    replicated tensors plus half the sharded ones: the bytes counted."""
    label, ranks = cpc_ranks
    local = ranks[0]["local"]
    full = one["cpc"][2]
    whole = {f"encoder.{k}": v for k, v in full.encoder.state_dict().items()}
    whole.update({f"cpc.{k}": v for k, v in full.cpc.state_dict().items()})
    names = {id(p): n for n, p in zip(full.param_names, [p for g in full.optimizer.param_groups
                                                         for p in g["params"]])}
    for p, st in full.optimizer.state.items():
        for k in ("exp_avg", "exp_avg_sq"):
            whole[f"adam.{k}.{names[id(p)]}"] = st[k]
    nbytes = lambda t: t.numel() * t.element_size()
    assert set(whole) == set(local["tensors"])
    want = sum(nbytes(v) // (2 if k in local["sharded"] else 1) for k, v in whole.items())
    assert sum(nbytes(v) for v in local["tensors"].values()) == want
    sharded = sum(nbytes(whole[k]) for k in local["sharded"])
    assert sharded > 0.8 * sum(nbytes(v) for v in whole.values())  # most of the state


@pytest.mark.parametrize("reference", ["jax", "one"])
def test_b_sharded_cpc_step_matches(cpc_ranks, reference, jax_tp, one, inputs):
    """The gathered state of the sharded steps against ``reference`` on the
    global batches (the JAX package's sharded step at data 2 x model 2, or
    the port's one process), tests/test_sharding.py's bounds: losses within
    rel 1e-5, every weight within atol 2e-5, the codebook within 1e-5;
    perplexity likewise, accuracies within two anchors' share."""
    label, ranks = cpc_ranks
    ref_metrics, ref_sd = jax_tp if reference == "jax" else one["cpc"][:2]
    rank = ranks[0]
    for i, (m, r) in enumerate(zip(rank["metrics"], ref_metrics)):
        for key in ("loss", "cpc_loss", "vq_loss", "perplexity"):
            np.testing.assert_allclose(_np(m[key]), r[key], rtol=1e-5,
                                       err_msg=f"{label} step {i} {key}")
        np.testing.assert_allclose(_np(m["accuracies"]), r["accuracies"],
                                   atol=2.0 / inputs["n_anchors"] + 1e-9)
    got = {**{f"encoder.{k}": v for k, v in rank["checkpoint"]["encoder"].items()},
           **{f"cpc.{k}": v for k, v in rank["checkpoint"]["cpc"].items()}}
    for key, r in ref_sd.items():
        atol = 1e-5 if ".codebook." in key else 2e-5
        np.testing.assert_allclose(_np(got[key]), _np(r), rtol=0, atol=atol,
                                   err_msg=f"{label} {key}")


# --------------------------------------------------------- (c) the vocoder


def test_c_sharded_vocoder_step_matches_one_process_with_the_clip_active(two, one):
    """2 ranks at M 2 against one process, the clip active (VOC_ARGV): the
    losses within 1e-5; the gathered Adam first moments (the clipped
    gradient's EMA) within 1e-4 of their largest element; every weight
    within 0.1 lr (tests/test_torch_parallel.py's vocoder bounds); the
    replicated tensors the same bits on both ranks."""
    losses, vt = one["vocoder"]
    assert _replicated_bits([r["vocoder"] for r in two], 2) > 4
    rank = two[0]["vocoder"]
    assert set(rank["dims"]) >= {"rnnms.rnn.weight_hh_l0", "rnnms.fc1.weight",
                                 "rnnms.fc2.weight"}
    assert not any(k.startswith("rnnms.prenet.") for k in rank["dims"])
    np.testing.assert_allclose(_np(rank["losses"]), losses, rtol=1e-5)
    names = {id(p): n for n, p in vt.vocoder.named_parameters()}
    params = [p for g in vt.optimizer.param_groups for p in g["params"]]
    for i, p in enumerate(params):
        r = _np(vt.optimizer.state[p]["exp_avg"])
        got = _np(rank["checkpoint"]["optimizer"]["state"][i]["exp_avg"])
        np.testing.assert_allclose(got, r, rtol=0, atol=1e-4 * np.abs(r).max(),
                                   err_msg=names[id(p)])
    for key, r in vt.vocoder.state_dict().items():
        d = np.abs(_np(rank["checkpoint"]["vocoder"][key]) - _np(r))
        assert d.max() <= 0.1 * LR, (key, d.max())


def test_c_a_norm_of_the_local_shards_would_fail_the_vocoder_test(inputs):
    """The negative control: with the clip active, a norm of one rank's
    shards and the replicated gradients (no sum over the model group), or
    with the replicated ones counted twice, clips the gradient to other
    values, far beyond the Adam moment bound above."""
    conf = load_conf(VOC_ARGV)
    encoder = Encoder(conf.model.encoder)
    encoder.load_state_dict(inputs["voc_encoder"], strict=True)
    trainer = VocoderTrainer(conf, encoder, "cpu")
    trainer.vocoder.load_state_dict(inputs["vocoder"], strict=True)
    params = list(trainer.vocoder.parameters())
    loss = trainer.loss(inputs["audio"][0], inputs["voc_mels"][0], inputs["spk"][0])
    grads = torch.autograd.grad(loss, params)
    names = [n for n, _ in trainer.vocoder.named_parameters()]
    dims = [shard_dim(n, p.shape, 2) for n, p in zip(names, params)]
    half = [g if d is None else g.narrow(d, 0, g.shape[d] // 2) for g, d in zip(grads, dims)]
    sharded = torch.tensor([d is not None for d in dims])

    def clipped(gs, norm_of):
        gs = [g.clone() for g in gs]
        norm = norm_of(gs)
        return [g / norm * conf.training_vocoder.trainer.gradient_clip_val for g in gs], norm

    glob = [g.clone() for g in half]
    norm = clip_by_global_norm_(glob, conf.training_vocoder.trainer.gradient_clip_val)
    assert norm > 10 * conf.training_vocoder.trainer.gradient_clip_val
    full_norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
    for wrong in (lambda gs: torch.sqrt(sum((g ** 2).sum() for g in gs)),  # local shards
                  lambda gs: torch.sqrt(sum((g ** 2).sum() * (1 if s else 2)  # twice
                                            for g, s in zip(grads, sharded)))):
        local, n = clipped(half, wrong)
        assert abs(float(n) / float(full_norm) - 1) > 1e-3
        want = [g / full_norm * conf.training_vocoder.trainer.gradient_clip_val for g in half]
        worst = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(local, want))
        assert worst > 1e-3  # ten times the moment bound


# --------------------------------------------------------------- (d) VQ tie


def test_d_vq_tie_across_shards_takes_the_lowest_global_index(two, inputs):
    """A codebook of two equal halves, one on each rank: every latent is as
    near a code of rank 0 as its copy on rank 1, and takes rank 0's, the
    lowest global index, as ``argmin`` over the whole codebook; the EMA
    counts of rank 1's codes decay, the perplexity is the global one."""
    from vectorquantizedcpc_tpu_torch.models.vq import VQEmbeddingEMA, vq_apply_train

    half, x = inputs["tie_half"], inputs["tie_x"]
    whole = VQEmbeddingEMA(2 * TIE_CODES, TIE_DIM)
    whole.load_state_dict({"embedding": torch.cat([half, half]),
                           "ema_count": torch.zeros(2 * TIE_CODES),
                           "ema_weight": torch.cat([half, half])})
    z, _, perplexity = vq_apply_train(whole, x)
    a, b = two[0]["tie"], two[1]["tie"]
    for r in (a, b):
        assert torch.equal(r["z"], z)
        np.testing.assert_allclose(_np(r["perplexity"]), _np(perplexity), rtol=1e-6)
    assert float(b["ema_count"].max()) < 1e-4 < float(a["ema_count"].max())
    torch.testing.assert_close(torch.cat([a["ema_count"], b["ema_count"]]), whole.ema_count,
                               rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(torch.cat([a["embedding"], b["embedding"]]), whole.embedding,
                               rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------- (e) the CLIs


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The JAX fixtures' synthetic corpus and its features."""
    from vectorquantizedcpc_tpu_torch.cli import preprocess
    from vectorquantizedcpc_tpu_torch.data.corpus import SyntheticCorpus

    d = tmp_path_factory.mktemp("tp_cli")
    SyntheticCorpus(d / "corpus", **FIXTURE_ARGV["corpus"]).utterances()
    data = ["data.dataset.name=synthetic", f"data.corpus.root={d / 'corpus'}",
            f"data.dataset.adress_data_root={d / 'features'}", "data.loader.num_workers=1"]
    preprocess.main(data)
    return d, data


def _shapes(tree) -> dict:
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape)
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items() if k != "param_groups"}
    return type(tree).__name__


def _schedule(argv):
    tc = load_conf(argv).training.cpc.scheduler
    return WarmupSchedule(tc.warmup_epochs, tc.initial_lr, tc.max_lr, tc.milestones, tc.gamma)


def test_e_train_cpc_cli_at_mesh_model_2(corpus, capsys):
    """The JAX package's CPC checkpoint resumed at M 2 (2 ranks): rank 0
    writes one checkpoint with the keys and shapes of one process's, which
    a resume at M 1 reads and trains on."""
    from vectorquantizedcpc_tpu_torch.cli import train_cpc

    d, data = corpus
    argv = FIXTURE_ARGV["cpc"] + data + [
        "runtime.platform=cpu", "runtime.precision=float32", "training.cpc.log_interval=1",
        "training.cpc.checkpoint_interval=1", f"checkpoint_dir={d / 'cpc'}"]
    ckpt = FIXTURES / "cpc" / f"model.ckpt-{FIXTURE_ARGV['cpc_epochs']}"
    out = _cli("train_cpc", argv + ["runtime.mesh_model=2", f"resume={ckpt}",
                                    "training.cpc.n_epochs=3"])
    assert out.count("Mesh: data=1 model=2 (gloo)") == 1
    assert out.count("Resume checkpoint from:") == 1 and "epoch 2" in out
    assert sorted(p.name for p in (d / "cpc").glob("*.pt")) == ["model.ckpt-3.pt"]
    saved = torch.load(d / "cpc" / "model.ckpt-3.pt", weights_only=True)
    one = CPCTrainer(load_conf(argv), "cpu")
    one.load(ckpt)
    want = torch.load(save_checkpoint(d / "one", 3, one.checkpoint(3, _schedule(argv))),
                      weights_only=True)
    assert _shapes(saved) == _shapes(want)

    capsys.readouterr()
    trainer = train_cpc.main(argv + [f"resume={d / 'cpc' / 'model.ckpt-3.pt'}",
                                     "training.cpc.n_epochs=4"])
    assert "Resume checkpoint from:" in capsys.readouterr().out
    assert trainer.epoch == 4 and trainer.global_step == 4


def test_e_train_vocoder_cli_at_mesh_model_2(corpus):
    """A JAX vocoder run directory (model.ckpt-3) auto-resumed by 2 ranks at
    M 2: one epoch of 3 steps, rank 0's validation decodes from the gathered
    weights, then one checkpoint with one process's keys and shapes; one
    process validating from that checkpoint writes the same wavs."""
    from vectorquantizedcpc_tpu_torch.data.datamodule import VocoderDataModule
    from vectorquantizedcpc_tpu_torch.infer.encode import load_encoder_checkpoint
    from vectorquantizedcpc_tpu_torch.training.vocoder import validate

    d, data = corpus
    shutil.copytree(FIXTURES / "vocoder", d / "vocoder")
    ckpt_dir = d / "vocoder" / "default" / "version_-1" / "checkpoints"
    argv = FIXTURE_ARGV["vocoder"] + data + [
        "runtime.platform=cpu", f"cpc_checkpoint={FIXTURES / 'cpc' / 'model.ckpt-2'}",
        f"training_vocoder.ckpt_log.dir_root={d / 'vocoder'}", "data.loader.batch_size=4",
        "training_vocoder.trainer.max_epochs=2", "training_vocoder.trainer.val_interval_epoch=2"]
    out = _cli("train_vocoder", argv + ["runtime.mesh_model=2"])
    assert out.count("Auto-resume from:") == 1 and "model.ckpt-3: step 3, epoch 1" in out
    saved = sorted(ckpt_dir.glob("*.pt"))
    assert [p.name for p in saved] == ["model.ckpt-6.pt"]
    got = torch.load(saved[0], weights_only=True)
    conf = load_conf(argv)
    one = VocoderTrainer(conf, load_encoder_checkpoint(conf.cpc_checkpoint, conf), "cpu")
    one.load(ckpt_dir / "model.ckpt-3")
    assert _shapes(got) == _shapes(one.checkpoint())
    assert (got["step"], got["epoch"]) == (6, 2)
    one.load(saved[0])
    dm = VocoderDataModule(conf.data, data_dir=d / "features", seed=conf.seed)
    dm.setup()
    validate(conf, one, dm.val_items(), d / "one_samples", 6)
    wavs = sorted(p.name for p in (d / "one_samples").glob("*.wav"))
    assert wavs and wavs == sorted(p.name for p in (ckpt_dir.parent / "samples").glob("*.wav"))
    for name in wavs:
        assert (d / "one_samples" / name).read_bytes() == (
            ckpt_dir.parent / "samples" / name).read_bytes(), name


def test_e_preemption_on_one_rank_gathers_on_both(corpus):
    """The last of 2 model ranks alone is asked to stop: both agree at the
    first group's end, both gather the shards and rank 0 alone writes the
    checkpoint, which holds one process's shapes."""
    d, data = corpus
    argv = FIXTURE_ARGV["cpc"] + data + _mesh_argv(1, 2) + [
        "runtime.precision=float32", f"checkpoint_dir={d / 'preempt'}",
        "training.cpc.n_epochs=5", "training.cpc.checkpoint_interval=100"]
    ranks = _ranks(d / "preempt_run", {"argv": argv, "dir": str(d / "preempt_run")}, 2,
                   "preempt")
    assert [(r["preempt"]["epoch"], r["preempt"]["global_step"]) for r in ranks] == [(1, 2)] * 2
    assert (d / "preempt_run" / "writes.txt").read_text() == "0 model.ckpt-1.pt\n"
    saved = torch.load(d / "preempt" / "model.ckpt-1.pt", weights_only=True)
    one = CPCTrainer(load_conf(FIXTURE_ARGV["cpc"]), "cpu")
    assert {k: tuple(v.shape) for k, v in saved["encoder"].items()} == {
        k: tuple(v.shape) for k, v in one.encoder.state_dict().items()}


# ---------------------------------------------------------- (f) refusals


@pytest.mark.parametrize("extra, error, match", [
    # 2 x 2 ranks over 4 hosts: one rank a host splits each model group
    (["runtime.mesh_data=2", "runtime.mesh_model=2", "runtime.num_processes=4",
      "runtime.process_id=0", "runtime.coordinator_address=h:1"], ValueError,
     "whole model groups"),
    (["runtime.mesh_model=0"], ValueError, "runtime.mesh_model=0 must be at least 1"),
])
@pytest.mark.parametrize("cli", ["train_cpc", "train_vocoder"])
def test_f_cli_refuses_before_starting_ranks(cli, extra, error, match, monkeypatch):
    import importlib

    module = importlib.import_module(f"vectorquantizedcpc_tpu_torch.cli.{cli}")
    monkeypatch.setattr(module, "start_ranks", lambda *a, **k: pytest.fail("ranks started"))
    with pytest.raises(error, match=match):
        module.main(["runtime.platform=cpu"] + extra)


def test_f_launch_keys_and_more_ranks_than_cards(monkeypatch):
    rt = lambda *a: load_conf(list(a)).runtime
    assert port_mesh.launch_args(rt("runtime.platform=cpu", "runtime.mesh_model=2")) == [
        "--nproc-per-node=2", "--standalone"]
    assert port_mesh.launch_args(rt(
        "runtime.platform=cpu", "runtime.mesh_data=2", "runtime.mesh_model=2",
        "runtime.num_processes=2", "runtime.process_id=1",
        "runtime.coordinator_address=10.0.0.1:29500")) == [
        "--nproc-per-node=2", "--nnodes=2", "--node-rank=1", "--master-addr=10.0.0.1",
        "--master-port=29500"]
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        port_mesh.mesh_from_conf(rt("runtime.platform=cpu", "runtime.mesh_data=2",
                                    "runtime.mesh_model=2"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 local ranks need 2 CUDA cards and this host has 1"):
        port_mesh.launch_args(rt("runtime.mesh_model=2"))


def test_f_step_graph_refuses_a_gloo_model_group(world_of_one):
    """A gloo model group's collectives cannot be captured either: on a card
    the step graph raises before any eager step runs."""
    from vectorquantizedcpc_tpu_torch.training.step_graph import StepGraph

    ran = []
    graph = StepGraph(lambda *x: ran.append(x) or {}, torch.optim.SGD([torch.zeros(1)], 0.1),
                      torch.device("cuda"), None, ModelGroup(world_of_one, 0, 1))
    with pytest.raises(RuntimeError, match="gloo process group's collectives cannot be captured"):
        graph.step((torch.zeros(1),), 0.1)
    assert ran == [] and graph.eager_steps == 0


def test_b_model_group_of_one_rank_gives_the_bits_of_no_group(inputs, world_of_one):
    """M 1 on a gloo group of one rank: every rule divides, so each product
    takes the tensor-parallel route with whole shards, its gathers, sums,
    sharded argmin and model-group clip on one rank, and both trainers end
    with the bits of no group (what the step graph holds on a card)."""
    model = ModelGroup(world_of_one, 0, 1)
    runs = []
    for mg in (None, model):
        tr = CPCTrainer(load_conf(CPC_ARGV), "cpu", None, mg)
        assert bool(tr.encoder_dims) == (mg is not None)
        tr.encoder.load_state_dict(inputs["encoder"], strict=True)
        tr.cpc.load_state_dict(inputs["cpc"], strict=True)
        metrics = [tr.train_step(m, u, q, LR)
                   for m, u, q in zip(inputs["mels"], inputs["utt"], inputs["seq"])]
        runs.append((metrics, tr.checkpoint(STEPS, _schedule(CPC_ARGV))))
    for ma, mb in zip(runs[0][0], runs[1][0]):
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for part in ("encoder", "cpc"):
        assert all(torch.equal(v, runs[1][1][part][k]) for k, v in runs[0][1][part].items())
    vruns = []
    for mg in (None, model):
        conf = load_conf(VOC_ARGV)
        encoder = Encoder(conf.model.encoder)
        encoder.load_state_dict(inputs["voc_encoder"], strict=True)
        vt = VocoderTrainer(conf, encoder, "cpu", None, mg)
        vt.vocoder.load_state_dict(inputs["vocoder"], strict=True)
        losses = [vt.train_step(a, m, s, LR)["loss"]
                  for a, m, s in zip(inputs["audio"], inputs["voc_mels"], inputs["spk"])]
        vruns.append((losses, vt.checkpoint()["vocoder"]))
    assert all(torch.equal(a, b) for a, b in zip(vruns[0][0], vruns[1][0]))
    assert all(torch.equal(v, vruns[1][1][k]) for k, v in vruns[0][1].items())
