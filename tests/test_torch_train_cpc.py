"""CPC training in the port against the JAX package, and the training CLIs on the CPU.

The lockstep runs the same weights, batches and injected negatives through
the JAX ``make_train_step(conf, inject_negatives=True)`` and the port's
``CPCTrainer.train_step`` for several steps, at float32 and at bfloat16
(where JAX runs its Pallas kernels in interpret mode and the port its
kernels' plain versions). Then the ``train_cpc`` CLI: checkpoint cadence,
resume, the LSTM bias fold, the JAX importer on the checkpoint, and the
refusal to run without a card unless the CPU is asked for; and the
``eval_abx --dry-run`` chain.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vectorquantizedcpc_tpu.configs import load_conf as jax_load_conf
from vectorquantizedcpc_tpu.models.cpc import sample_negative_indices as jax_sample
from vectorquantizedcpc_tpu.training.cpc import init_train_state, make_train_step
from vectorquantizedcpc_tpu.training.schedule import WarmupSchedule as JaxWarmupSchedule
from vectorquantizedcpc_tpu.training.torch_import import (
    import_cpc,
    import_encoder,
    load_reference_cpc_checkpoint,
)
from vectorquantizedcpc_tpu_torch.configs import load_conf
from vectorquantizedcpc_tpu_torch.training import cpc as port_train
from vectorquantizedcpc_tpu_torch.training.schedule import WarmupSchedule
from vectorquantizedcpc_tpu_torch.weights import cpc_from_jax_params, encoder_from_jax_params

from torch_port_util import flat, module_time_limit, time_limit  # noqa: F401

TIME_LIMIT_S = 300  # each test's own limit (torch_port_util.time_limit)

torch.set_num_threads(1)

# The JAX package's tests/test_training.py TINY widths (L = 10: not a multiple of 8).
TINY = [
    "model.encoder.channels=32",
    "dim_latent=8",
    "dim_cpc_context=16",
    "size_latent_codebook=32",
    "training.cpc.sample_frames=20",
    "training.cpc.n_speakers_per_batch=2",
    "training.cpc.n_utterances_per_speaker=2",
    "training.cpc.n_negatives=3",
]
LR = 1e-3
STEPS = 3


def _leaves(tree) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in flat(tree).items()}


def _lockstep(precision: str):
    """STEPS steps of both trainers on one batch stream; returns both
    metric histories and both final states in JAX layouts."""
    argv = TINY + [f"runtime.precision={precision}"]
    jconf = jax_load_conf(argv)
    state = init_train_state(jconf, jax.random.key(0))
    step = make_train_step(jconf, inject_negatives=True)

    trainer = port_train.CPCTrainer(load_conf(argv), "cpu")
    trainer.encoder.load_state_dict(encoder_from_jax_params(flat(state.enc), flat(state.vq)),
                                    strict=True)
    trainer.cpc.load_state_dict(cpc_from_jax_params(flat(state.cpc)), strict=True)

    rng = np.random.default_rng(11)
    t = jconf.data.dataset.cpc.clip_length_mel
    length = t // 2 - 6
    ours, theirs = [], []
    for i in range(STEPS):
        mels = rng.normal(size=(2, 2, 80, t)).astype(np.float32)
        utt, seq = (np.array(x) for x in jax_sample(jconf.model.cpc, jax.random.key(i), length))
        state, m = step(state, jnp.asarray(mels), (jnp.asarray(utt), jnp.asarray(seq)),
                        jnp.float32(LR))
        theirs.append({k: np.asarray(v, np.float64) for k, v in m.items()})
        m = trainer.train_step(torch.from_numpy(mels), torch.from_numpy(utt),
                               torch.from_numpy(seq), LR)
        ours.append({k: v.double().numpy() for k, v in m.items()})
    enc, vq = import_encoder(trainer.encoder.state_dict())
    mine = {"enc": _leaves(enc), "vq": _leaves(vq), "cpc": _leaves(import_cpc(trainer.cpc.state_dict()))}
    ref = {"enc": _leaves(state.enc), "vq": _leaves(state.vq), "cpc": _leaves(state.cpc)}
    return ours, theirs, mine, ref, 2 * 2 * length


@pytest.mark.parametrize(
    "precision, loss_rtol, step0_rtol, agree_all, agree_slice",
    [
        # f32: one exact algorithm in other summation orders; step 0 within
        # 1e-5, later steps within 1e-4 (Adam moves noise-level gradient
        # elements by up to 2 lr); 99 % of weights within 0.1 lr of JAX's.
        ("float32", 1e-4, 1e-5, 0.99, 0.99),
        # bf16: the frontend, input projection and LSTM round to bf16 at the
        # same points but sum in other orders: losses within 5e-3. The
        # frontend's bf16 backward (conv, LayerNorms, Linears) gives its
        # small gradient elements other signs, which Adam turns into whole
        # lr steps: 75 % of all weights within 0.1 lr, 95 % of the LSTM's and
        # the predictors' (the weights the slice's kernels differentiate).
        ("bfloat16", 5e-3, 5e-3, 0.75, 0.95),
    ],
)
def test_lockstep_against_make_train_step(monkeypatch, precision, loss_rtol, step0_rtol,
                                          agree_all, agree_slice):
    """Both trainers from the same weights on the same batches and negatives.
    Losses and perplexity as stated; accuracies within 2 anchors' share
    (near-tie flips) per step; every weight within 2 lr per step of JAX's
    (Adam's step is at most lr per element, up to bias correction), most of
    them far closer; the EMA buffers within 1e-3 relative (1e-2 at bf16)."""
    if precision == "bfloat16":
        monkeypatch.setenv("VQCPC_PALLAS_INTERPRET", "1")
    ours, theirs, mine, ref, n_anchors = _lockstep(precision)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        rtol = step0_rtol if i == 0 else loss_rtol
        for key in ("loss", "cpc_loss", "vq_loss", "perplexity"):
            np.testing.assert_allclose(a[key], b[key], rtol=rtol, err_msg=f"step {i} {key}")
        np.testing.assert_allclose(a["accuracies"], b["accuracies"], atol=2.0 / n_anchors + 1e-9)
    assert ours[-1]["loss"] != ours[0]["loss"]
    counts = {"all": [0, 0], "slice": [0, 0]}
    for group in ("enc", "cpc"):
        for key, r in ref[group].items():
            d = np.abs(mine[group][key] - r)
            assert d.max() <= 2 * LR * STEPS * 1.01, (group, key, d.max())
            for part in ("all", "slice") if group == "cpc" or key.startswith("rnn") else ("all",):
                counts[part][0] += int((d <= 0.1 * LR).sum())
                counts[part][1] += d.size
    assert counts["all"][0] / counts["all"][1] >= agree_all, counts
    assert counts["slice"][0] / counts["slice"][1] >= agree_slice, counts
    vq_rtol = 1e-3 if precision == "float32" else 1e-2
    for key, r in ref["vq"].items():
        np.testing.assert_allclose(mine["vq"][key], r, rtol=vq_rtol, atol=vq_rtol * np.abs(r).max(),
                                   err_msg=key)


def test_warmup_schedule_matches_jax():
    for args in ((5, 0.05, 0.1, [6, 14], 0.5), (150, 1e-5, 4e-4, [20000], 0.25)):
        ours, theirs = WarmupSchedule(*args), JaxWarmupSchedule(*args)
        for e in list(range(0, 200)) + [19999, 20000, 20001]:
            assert ours(e) == theirs(e)


def test_bias_fold():
    """Training keeps one LSTM bias: bias_ih holds the sum, bias_hh is zero,
    frozen and outside the optimizer."""
    conf = load_conf(TINY + ["runtime.precision=float32"])
    torch.manual_seed(conf.seed)
    from vectorquantizedcpc_tpu_torch.models.encoder import Encoder

    fresh = Encoder(conf.model.encoder)
    trainer = port_train.CPCTrainer(conf, "cpu")
    rnn = trainer.encoder.rnn
    assert torch.equal(rnn.bias_ih_l0, fresh.rnn.bias_ih_l0 + fresh.rnn.bias_hh_l0)
    assert not rnn.bias_hh_l0.requires_grad and not rnn.bias_hh_l0.any()
    in_opt = {id(p) for g in trainer.optimizer.param_groups for p in g["params"]}
    assert id(rnn.bias_hh_l0) not in in_opt and id(rnn.bias_ih_l0) in in_opt


def _cli_argv(tmp_path: Path, ckpt: str, *extra: str):
    return TINY + [
        "runtime.platform=cpu",
        "runtime.precision=float32",
        "data.dataset.name=synthetic",
        f"data.corpus.root={tmp_path / 'corpus'}",
        f"data.dataset.adress_data_root={tmp_path / 'features'}",
        f"checkpoint_dir={tmp_path / ckpt}",
        "training.cpc.scheduler.warmup_epochs=2",
        "training.cpc.scheduler.milestones=[3]",
        "training.cpc.log_interval=2",
        *extra,
    ]


def test_train_cpc_cli_checkpoints_resume_and_import(tmp_path, capsys):
    """4 speakers / S = 2: 2 steps per epoch. Checkpoints at the interval's
    epochs; epoch groups quantize them; resume re-runs the checkpointed
    epoch without saving it again; the JAX importer and the encode CLI read
    the files."""
    from vectorquantizedcpc_tpu_torch.cli import encode as encode_cli
    from vectorquantizedcpc_tpu_torch.cli import train_cpc

    trainer = train_cpc.main(_cli_argv(tmp_path, "a", "training.cpc.n_epochs=4",
                                       "training.cpc.checkpoint_interval=2"))
    out = capsys.readouterr().out
    assert trainer.global_step == 8
    assert sorted(p.name for p in (tmp_path / "a").glob("*.pt")) == [
        "model.ckpt-2.pt", "model.ckpt-4.pt"]
    assert "epoch:2, cpc loss:" in out and "epoch:4, cpc loss:" in out

    ckpt = torch.load(tmp_path / "a" / "model.ckpt-4.pt", weights_only=True)
    assert set(ckpt) == {"encoder", "cpc", "optimizer", "scheduler", "epoch"}
    assert ckpt["epoch"] == 4 and not ckpt["encoder"]["rnn.bias_hh_l0"].any()
    enc, vq, cpc, epoch = load_reference_cpc_checkpoint(tmp_path / "a" / "model.ckpt-4.pt")
    assert epoch == 4 and np.asarray(cpc.w).shape == (12, 16, 8)
    np.testing.assert_array_equal(np.asarray(enc.rnn.b),
                                  ckpt["encoder"]["rnn.bias_ih_l0"].numpy())
    np.testing.assert_array_equal(np.asarray(vq.embedding),
                                  ckpt["encoder"]["codebook.embedding"].numpy())

    # Resume from epoch 2 into another directory: epochs 2, 3, 4 run again
    # and only epoch 4 is saved.
    before = (tmp_path / "a" / "model.ckpt-2.pt").read_bytes()
    trainer = train_cpc.main(_cli_argv(
        tmp_path, "b", "training.cpc.n_epochs=4", "training.cpc.checkpoint_interval=2",
        f"resume={tmp_path / 'a' / 'model.ckpt-2.pt'}"))
    assert trainer.global_step == 6
    assert [p.name for p in (tmp_path / "b").glob("*.pt")] == ["model.ckpt-4.pt"]
    assert (tmp_path / "a" / "model.ckpt-2.pt").read_bytes() == before

    # Epoch groups of 2: interval 3 falls in the group [3, 4], saved as 4.
    train_cpc.main(_cli_argv(tmp_path, "c", "training.cpc.n_epochs=4",
                             "training.cpc.checkpoint_interval=3",
                             "training.cpc.epochs_per_dispatch=2"))
    assert [p.name for p in (tmp_path / "c").glob("*.pt")] == ["model.ckpt-4.pt"]

    n = encode_cli.main(TINY + ["runtime.platform=cpu", "runtime.precision=float32",
                                f"cpc_checkpoint={tmp_path / 'a' / 'model.ckpt-4.pt'}",
                                f"in_dir={tmp_path / 'features'}",
                                f"out_dir={tmp_path / 'codes'}"])
    assert n == len(list((tmp_path / "features").glob("*/*.mel.npy"))) == 40


def test_train_cpc_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    from vectorquantizedcpc_tpu_torch.cli import train_cpc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _cli_argv(tmp_path, "d", "training.cpc.n_epochs=1")
            if not a.startswith("runtime.platform")]
    with pytest.raises(RuntimeError, match="runtime.platform=cpu"):
        train_cpc.main(argv)


def test_eval_abx_dry_run_chains_the_clis(tmp_path):
    """preprocess -> train_cpc -> encode -> ABX, each CLI in its own process."""
    from vectorquantizedcpc_tpu_torch.cli import eval_abx

    result = eval_abx.main(["--dry-run", "--platform", "cpu", "--dry-run-epochs", "2",
                            "--workdir", str(tmp_path / "ws")])
    assert result["dry_run"] and result["n_items"] == 40
    assert 0.0 <= result["abx_error_rate"] <= 1.0
    assert (tmp_path / "ws" / "ckpt" / "model.ckpt-2.pt").exists()
