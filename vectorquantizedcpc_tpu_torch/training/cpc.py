"""CPC encoder training: the train step, grouped steps and the epoch loop.

The JAX package's ``training/cpc.py`` on PyTorch: encoder forward
(frontend, VQ-EMA step, context LSTM), InfoNCE over K steps, backward,
Adam. On a card the step runs the CUDA kernels of the slice: the LSTM
scan's training forward and backward (``LstmScan``) and the CPC
selection's forward and backward (``CpcNegativeScores``).

- ``train_step`` is one eager step on injected ``(utt_index, seq_index)``,
  the counterpart of ``make_train_step(inject_negatives=True)``.
  ``train_steps`` runs a group of them through the step graph
  (``training/step_graph.py``): on a card one CUDA graph of the whole step,
  replayed per batch; on the CPU the same eager step per batch. It is the
  counterpart of ``make_train_epochs``.
- ``train_model`` stages each group of ``epochs_per_dispatch`` epochs on
  the device in one copy and draws each step's negatives, in the eager
  order, from a ``torch.Generator`` on the step's device seeded by (seed,
  epoch), so a resumed epoch re-draws the same negatives and a group draws
  the bits of one step at a time.
- Adam is ``torch.optim.Adam`` with betas (0.9, 0.999) and eps 1e-8, as
  optax's defaults, capturable on a card (``step_graph.make_adam``); the
  learning rate is set per epoch from ``WarmupSchedule(epoch - 1)``.
- The JAX package trains ONE fused LSTM bias, while ``nn.LSTM`` keeps two,
  and Adam would move their sum twice as far. So training folds
  ``bias_hh_l0`` into ``bias_ih_l0``, keeps it at zero and leaves it out of
  the optimizer; the saved sum, which is what every importer reads, is
  unchanged.
- ``train_model`` keeps the JAX trainer's cadence: steps per epoch = usable
  speakers // S; logs and checkpoints are quantized to groups of
  ``epochs_per_dispatch`` epochs; ``resume`` re-runs the checkpointed epoch
  and does not save it again; ``runtime.profile_dir`` traces the second
  group. Checkpoints are ``model.ckpt-{epoch}.pt`` in the reference layout
  (``training/checkpoint.py``), written off the loop by ``AsyncCheckpointer``;
  ``resume`` takes such a file or the JAX package's ``model.ckpt-{epoch}``.
- Data parallel (``runtime.mesh_data`` ranks, ``parallel/``): the step is
  the same function as one process's on the global batch. Every rank
  builds the same global batch and draws the same global negatives, then
  keeps its share of the speakers (the mels and ``seq_index`` along S;
  ``utt_index`` whole); the VQ statistics are summed over the ranks before
  the EMA; the gradients and the logged metrics are their means over the
  ranks, by one ``all_reduce`` of one flat buffer a step. Only rank 0
  preprocesses, logs and writes checkpoints and TensorBoard; every rank
  reads the same ``resume`` checkpoint; the ranks agree on a preemption
  request at each group boundary and stop together.
- Tensor parallel (``runtime.mesh_model`` ranks in each model group,
  ``parallel/tensor.py``): every rank draws the full init from
  ``conf.seed``, then keeps its shards of the encoder's parameters and
  VQ-EMA buffers by the JAX package's rules; Adam's moments follow their
  parameters. The model ranks see the same batch share and negatives (by
  data rank) and run the partitioned products of ``models/``;
  ``FlatGrads`` holds the rank's tensors and reduces over the data group
  only. A checkpoint gathers the shards first: it holds one process's
  keys and shapes, which every entry point and mesh reads, sliced again
  for each rank on load.
"""

import collections
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..configs import ConfGlobal, resolve_compute_dtype
from ..data.corpus import get_corpus
from ..data.datasets import CPCMelSpkDataset
from ..data.loader import PrefetchLoader
from ..data.preprocess import preprocess_corpus
from ..device import resolve_device
from ..models.cpc import (CPCLoss, cpc_apply_with_indices, sample_negative_indices,
                          shard_negatives)
from ..models.encoder import Encoder
from ..parallel.mesh import is_main, mesh_from_conf
from ..parallel.sharding import FlatGrads, agree, local_share, shard_batch, world_of
from ..parallel.tensor import (ModelGroup, gather_module_state, gather_optimizer_state,
                               shard_module_, shard_optimizer_state, shard_state)
from ..utils.profiling import device_time, trace
from ..weights import cpc_train_state_from_jax
from .checkpoint import (AsyncCheckpointer, checkpoint_format, load_checkpoint,
                         read_jax_checkpoint, save_checkpoint)
from .preemption import install_preemption_handler, preemption_requested
from .schedule import WarmupSchedule
from .step_graph import StepGraph, load_optimizer_state, make_adam, set_lr, stage

FOLDED_BIAS = "rnn.bias_hh_l0"
HISTORY_STEPS = 10_000  # per-step host metrics kept on the trainer


@torch.no_grad()
def fold_lstm_bias(encoder: Encoder) -> None:
    """bias_ih += bias_hh, bias_hh = 0 and frozen: one trained LSTM bias."""
    rnn = encoder.rnn
    rnn.bias_ih_l0.add_(rnn.bias_hh_l0)
    rnn.bias_hh_l0.zero_()
    rnn.bias_hh_l0.requires_grad_(False)


def negatives_generator(seed: int, epoch: int, device: torch.device) -> torch.Generator:
    """The generator of one epoch's negative draws."""
    return torch.Generator(device=device).manual_seed((seed + 1) * 1_000_003 + epoch)


class CPCTrainer:
    """Encoder, CPC predictors and Adam on one device, at the config's widths.

    Weights are torch's default inits drawn on the CPU from ``conf.seed``
    (the reference's distributions, as the JAX package's inits), then moved.
    ``graph`` steps ``train_steps``. With a process ``group`` the trainer is
    one data-parallel rank: its steps take its share of the speakers
    (``n_speakers``) and reduce across the group; every rank starts from
    the same weights. With a ``model`` group it holds this rank's shards
    of the encoder (``encoder_dims``: {state_dict name: dim}).
    """

    def __init__(self, conf: ConfGlobal, device: Union[str, torch.device], group=None,
                 model: Optional[ModelGroup] = None):
        self.conf = conf
        self.device = torch.device(device)
        self.group = group
        self.model = model
        self.n_speakers = local_share(conf.model.cpc.n_speakers_per_batch, world_of(group),
                                      "training.cpc.n_speakers_per_batch")
        self.compute_dtype = resolve_compute_dtype(conf.runtime.precision)
        torch.manual_seed(conf.seed)
        self.encoder = Encoder(conf.model.encoder)
        self.cpc = CPCLoss(conf.model.cpc)
        fold_lstm_bias(self.encoder)
        self.encoder.to(self.device).train()
        self.cpc.to(self.device).train()
        self.encoder_dims = ({} if model is None else
                             shard_module_(self.encoder, model, "encoder."))
        named = [(f"encoder.{n}", p) for n, p in self.encoder.named_parameters()
                 if n != FOLDED_BIAS] + [(f"cpc.{n}", p) for n, p in self.cpc.named_parameters()]
        self.param_names = [n for n, _ in named]  # the optimizer's order
        self.optimizer = make_adam([p for _, p in named], self.device)
        k_steps = conf.model.cpc.n_prediction_steps // 2
        self.grads = FlatGrads([p for _, p in named], 3 + k_steps, group)
        self.graph = StepGraph(self._step, self.optimizer, self.device, group, model)

    def train_step(
        self,
        mels: torch.Tensor,
        utt_index: torch.Tensor,
        seq_index: torch.Tensor,
        lr: float,
    ) -> Dict[str, torch.Tensor]:
        """One eager optimizer step on mels (S, U, Freq, T) and this rank's
        negatives (``seq_index`` of its S); returns the metrics as tensors
        on the device, without waiting for them."""
        set_lr(self.optimizer, lr)
        return self._step(mels, utt_index, seq_index)

    def train_steps(
        self,
        mels: torch.Tensor,
        negatives: Tuple[torch.Tensor, torch.Tensor],
        lrs: Sequence[float],
    ) -> Dict[str, torch.Tensor]:
        """G optimizer steps through ``graph``: mels (G, S, U, Freq, T) and
        negatives (utt_index (G, K, U, N), seq_index (G, K, S, U, N, L)) on
        the device, one learning rate per step. Returns the metrics stacked
        (G, ...) on the device, without waiting for them: G sequential
        ``train_step`` calls' bits."""
        utt, seq = negatives
        steps = [self.graph.step((mels[i], utt[i], seq[i]), lr) for i, lr in enumerate(lrs)]
        return {k: torch.stack([m[k] for m in steps]) for k in steps[0]}

    def _step(self, mels, utt_index, seq_index) -> Dict[str, torch.Tensor]:
        """The step at the optimizer's learning rate: nothing in it waits
        for the device or reads the host, so a CUDA graph can hold it."""
        cc = self.conf.model.cpc
        s, u = self.n_speakers, cc.n_utterances_per_speaker
        mels = mels.reshape(s * u, mels.shape[2], mels.shape[3])
        z, c, vq_loss, perplexity = self.encoder(mels, self.compute_dtype, self.group,
                                                 self.model)
        cpc_loss, accuracies = cpc_apply_with_indices(
            self.cpc, cc, z, c, utt_index, seq_index,
            exclude_self_negatives=self.conf.training.cpc.exclude_self_negatives,
        )
        loss = cpc_loss + vq_loss
        means = self.grads.backward(loss, [loss, cpc_loss, vq_loss, accuracies])
        loss, cpc_loss, vq_loss, accuracies = means[0], means[1], means[2], means[3:]
        self.optimizer.step()
        return {
            "loss": loss.detach(),
            "cpc_loss": cpc_loss.detach(),
            "vq_loss": vq_loss.detach(),
            "perplexity": perplexity.detach(),
            "accuracies": accuracies,
        }

    def checkpoint(self, epoch: int, schedule: WarmupSchedule) -> dict:
        """The reference layout: {encoder, cpc, optimizer, scheduler, epoch},
        the shards gathered over the model group (every model rank calls it)."""
        return {
            "encoder": gather_module_state(self.encoder, self.model),
            "cpc": self.cpc.state_dict(),
            "optimizer": gather_optimizer_state(self.optimizer, self.model),
            "scheduler": {
                "last_epoch": epoch,
                "warmup_epochs": schedule.warmup_epochs,
                "initial_lr": schedule.initial_lr,
                "max_lr": schedule.max_lr,
                "milestones": list(schedule.milestones),
                "gamma": schedule.gamma,
            },
            "epoch": epoch,
        }

    def load(self, path: Union[str, Path]) -> int:
        """Restore a checkpoint of this layout, or the JAX package's CPC train
        state (parameters, VQ-EMA state, Adam's moments and count, epoch);
        returns its epoch; with a model group, this rank's slices of its full
        tensors. Load before the step graph's capture."""
        if checkpoint_format(path) == "jax":
            ckpt = cpc_train_state_from_jax(read_jax_checkpoint(path), self.param_names)
        else:
            ckpt = load_checkpoint(path)
        encoder = ckpt["encoder"]
        if self.model is not None:
            encoder = shard_state(encoder, self.encoder_dims, self.model)
        self.encoder.load_state_dict(encoder, strict=True)
        fold_lstm_bias(self.encoder)  # a reference checkpoint may hold two biases
        if "cpc" in ckpt:
            self.cpc.load_state_dict(ckpt["cpc"], strict=True)
        if "optimizer" in ckpt:
            load_optimizer_state(self.optimizer, shard_optimizer_state(
                ckpt["optimizer"], self.optimizer, self.model))
        return int(ckpt.get("epoch", 0))


class RunningMean:
    """Incremental running means (reference train_cpc.py:127-131)."""

    def __init__(self):
        self.values: Dict[str, np.ndarray] = {}
        self.count = 0

    def update(self, metrics: Dict[str, np.ndarray]):
        self.count += 1
        for k, v in metrics.items():
            v = np.asarray(v)
            prev = self.values.get(k, np.zeros_like(v))
            self.values[k] = prev + (v - prev) / self.count

    def __getitem__(self, k):
        return self.values[k]


def _fetch(groups: List[Dict[str, torch.Tensor]]) -> List[Dict[str, np.ndarray]]:
    """Per-step metrics of the groups' stacked metrics, on the host (one
    transfer per key)."""
    if not groups:
        return []
    stacked = {k: torch.cat([g[k] for g in groups]).cpu().numpy() for k in groups[0]}
    return [{k: v[i] for k, v in stacked.items()} for i in range(len(stacked["loss"]))]


def train_model(
    conf: ConfGlobal,
    max_steps: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> CPCTrainer:
    """The CPC training loop (reference train_model, train_cpc.py:37-155).

    Runs on ``device``, else on ``runtime.platform``, else on the CUDA card;
    raises when no card is there and the CPU was not asked for. In a
    rank of the mesh (``parallel/mesh.py:mesh_from_conf``) it runs on the
    rank's card with its data and model groups.
    ``max_steps`` caps the optimizer steps, checked after each epoch group.
    """
    mesh = mesh_from_conf(conf.runtime)
    if mesh is not None:
        device = mesh.device
    device = resolve_device(device if device is not None else conf.runtime.platform)
    main = is_main(mesh)
    log = print if main else (lambda *args, **kwargs: None)
    checkpoint_dir = Path(conf.checkpoint_dir)
    tc = conf.training.cpc
    trainer = CPCTrainer(conf, device, *((None, None) if mesh is None else
                                         (mesh.group, mesh.model)))
    schedule = WarmupSchedule(
        warmup_epochs=tc.scheduler.warmup_epochs,
        initial_lr=tc.scheduler.initial_lr,
        max_lr=tc.scheduler.max_lr,
        milestones=tc.scheduler.milestones,
        gamma=tc.scheduler.gamma,
    )

    start_epoch = 1
    resumed_epoch = None  # suppresses an immediate re-save of this epoch
    if conf.resume != "scratch":
        # Reference semantics re-run the checkpointed epoch (train_cpc.py:73,97).
        start_epoch = resumed_epoch = trainer.load(conf.resume)
        log(f"Resume checkpoint from: {conf.resume}: epoch {start_epoch}")

    # Data: corpus -> preprocessed features -> per-speaker clips.
    corpus = get_corpus(conf.data.dataset.name, conf.data.corpus)
    data_dir = Path(
        conf.data.dataset.adress_data_root
        or conf.data.adress_data_root
        or (checkpoint_dir / "features")
    )
    preprocess_corpus(corpus, data_dir, conf.data.dataset.preprocess,
                      num_workers=conf.data.loader.num_workers or 2, mesh=mesh)
    dataset = CPCMelSpkDataset(True, conf.data.dataset, data_dir, seed=conf.seed)
    log(f"Loaded dataset: CPCMelSpkDataset w/ {conf.data.dataset.name} "
          f"({len(dataset)} speakers)")
    loader = PrefetchLoader(dataset, batch_size=tc.n_speakers_per_batch, shuffle=True,
                            drop_last=True, seed=conf.seed)
    if len(loader) == 0:
        raise ValueError(
            f"Fewer speakers ({len(dataset)}) than n_speakers_per_batch "
            f"({tc.n_speakers_per_batch})."
        )
    steps_per_epoch = len(loader)
    length = conf.data.dataset.cpc.clip_length_mel // 2 - conf.model.cpc.n_prediction_steps // 2

    # Epoch groups: logs and checkpoints quantize to them, as the JAX
    # trainer's dispatch groups do.
    epd = max(1, int(tc.epochs_per_dispatch))
    epochs = list(range(start_epoch, tc.n_epochs + 1))
    trainer.history = collections.deque(maxlen=HISTORY_STEPS)  # appended at each log
    pending: List[Dict[str, torch.Tensor]] = []  # per group; fetched at log time
    global_step = 0
    t0 = time.time()
    ckpt_writer = AsyncCheckpointer(active=main)
    install_preemption_handler()
    # TensorBoard scalars when tensorboardX is there (optional, as in JAX).
    tb_writer = None
    try:
        from tensorboardX import SummaryWriter

        if main:
            tb_writer = SummaryWriter(str(checkpoint_dir / "tb"))
    except Exception:
        pass

    for g0 in range(0, len(epochs), epd):
        group = epochs[g0 : g0 + epd]
        epoch = group[-1]
        batches, utts, seqs, lrs = [], [], [], []
        for e in group:
            loader.set_epoch(e)
            generator = negatives_generator(conf.seed, e, device)
            for mels, _spk in loader:
                utt_index, seq_index = sample_negative_indices(
                    conf.model.cpc, length, generator, device
                )
                batches.append(shard_batch(mels, mesh))
                utts.append(utt_index)
                seqs.append(seq_index if mesh is None else
                            shard_negatives(seq_index, mesh.rank, mesh.world))
                lrs.append(schedule(e - 1))
        # One traced group after the first (which holds the warm-up and
        # the capture), once per run, as the JAX trainer's window.
        with trace(conf.runtime.profile_dir if g0 == epd else None, device) as prof:
            metrics = trainer.train_steps(
                stage(batches, device), (torch.stack(utts), torch.stack(seqs)), lrs
            )
        if prof is not None:
            busy = device_time(prof, len(lrs))["device_busy_ms"]
            log(f"Wrote profiler trace to {conf.runtime.profile_dir}"
                  + ("" if busy is None else f" ({busy:.3f} ms of device work per step)"))
        global_step += steps_per_epoch * len(group)
        pending.append(metrics)

        if any(e % tc.log_interval == 0 for e in group) and epoch != resumed_epoch:
            meter = RunningMean()
            for m in _fetch(pending):
                meter.update(m)
                trainer.history.append(m)
            pending = []
            steps_per_sec = meter.count / (time.time() - t0)
            t0 = time.time()
            log(
                "epoch:{}, cpc loss:{:.2E}, vq loss:{:.2E}, perplexity:{:.3f}, "
                "{:.2f} steps/s".format(
                    epoch,
                    float(meter["cpc_loss"]),
                    float(meter["vq_loss"]),
                    float(meter["perplexity"]),
                    steps_per_sec,
                )
            )
            log(100 * meter["accuracies"])
            if tb_writer is not None:
                tb_writer.add_scalar("loss/cpc", float(meter["cpc_loss"]), epoch)
                tb_writer.add_scalar("loss/vq", float(meter["vq_loss"]), epoch)
                tb_writer.add_scalar("perplexity", float(meter["perplexity"]), epoch)
                for k, acc in enumerate(np.ravel(meter["accuracies"])):
                    tb_writer.add_scalar(f"accuracy/step_{k + 1}", float(acc), epoch)
                tb_writer.add_scalar("steps_per_sec", steps_per_sec, epoch)
        elif len(pending) > 2 * tc.log_interval:
            pending = pending[-tc.log_interval :]

        if any(e % tc.checkpoint_interval == 0 and e != resumed_epoch for e in group):
            ckpt_writer.save(checkpoint_dir, epoch, trainer.checkpoint(epoch, schedule))
            log(f"Saving checkpoint (async): model.ckpt-{epoch}.pt")

        # Every rank stops at the same group: one stopping alone would
        # leave the others waiting in their next collective.
        if agree(preemption_requested(), mesh):
            ckpt_writer.wait()
            state = trainer.checkpoint(epoch, schedule)  # every model rank gathers
            if main:
                path = save_checkpoint(checkpoint_dir, epoch, state)
                print(f"Preempted: saved {path.name}; resume with resume={path}.")
            break

        if max_steps is not None and global_step >= max_steps:
            break

    ckpt_writer.wait()
    trainer.epoch = epoch if epochs else start_epoch
    trainer.global_step = global_step
    if tb_writer is not None:
        tb_writer.close()
    return trainer
