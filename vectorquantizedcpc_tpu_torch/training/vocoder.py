"""Vocoder training: teacher-forced next-sample cross-entropy with a frozen encoder.

The JAX package's ``training/vocoder.py`` on PyTorch:

- the frozen encoder gives the code indices of each batch's mels (no
  gradient, at the compute dtype); the vocoder's teacher-forced forward on
  ``audio[:, :-1]`` gives logits, scored against ``audio[:, 1:]`` by the
  mean cross-entropy of an f32 log-softmax. At bfloat16 on a card the AR
  GRU runs the CUDA kernels of ``ops/gru_train.py`` (``GruScan``: the
  training forward and the backward);
- the gradient is clipped to a global norm of ``gradient_clip_val`` in
  optax's form (scaled by max / norm only when norm >= max, no epsilon),
  then ``torch.optim.Adam`` with betas (0.9, 0.999) and eps 1e-8
  (capturable on a card, ``step_graph.make_adam``), its learning rate set
  per step from ``MultiStepSchedule``. Both GRU biases are trained, as
  JAX's ``GRUParams`` has both;
- ``train_step`` is one eager step; ``train_steps`` runs K of them through
  the step graph (``training/step_graph.py``): on a card one CUDA graph of
  the whole step, replayed per batch, on the CPU the same eager step per
  batch; the counterpart of ``make_train_multi_step``;
- validation every ``val_interval_epoch`` epochs on the three whole held-out
  utterances: reconstruction and conversion to speaker (spk + 5) %
  n_speakers, decoded with a seed of the global step through the AR decode
  kernel on a card, in int8 when ``runtime.precision`` is "int8" and in
  bf16 otherwise; on the CPU the plain f32 ``vocoder_generate`` in every
  mode, as JAX ``training/vocoder.py:234-249`` keeps its scan path off the
  TPU; written as wavs;
- checkpoints every ``checkpoint_minutes`` of wall time, written off the
  loop by ``AsyncCheckpointer``, and at the end; auto-resume from the
  latest of the port's ``model.ckpt-{step}.pt`` and the JAX package's
  ``model.ckpt-{step}`` in the run's directory; a final save on
  preemption.

``train_vocoder`` stages each group of ``steps_per_dispatch`` batches on the
device in one copy, with one learning rate per step; checkpoint and
preemption checks follow each group, as the JAX trainer's dispatch groups;
``max_steps`` stops at exactly that step; ``runtime.profile_dir`` traces the
groups from 3 steps after the start to 6 steps after it, once;
``training_vocoder.trainer.profiler`` reports the loop's host seconds in the
loader's ``data.wait`` and in ``step.stage`` + ``step.dispatch`` (spans of
``utils/profiling.py``). Validation decodes run outside the graph.

Data parallel (``runtime.mesh_data`` ranks, ``parallel/``): every rank
builds the same global batch and keeps its rows ``[r B / W, (r + 1) B /
W)``; the gradients and the loss are the ranks' means by one
``all_reduce`` of one flat buffer a step, and the clip runs after it, on
the global gradient, as JAX clips it. Only rank 0 validates and writes
checkpoints and TensorBoard; every rank auto-resumes from the same file;
the ranks agree on a preemption request at each group boundary.

Tensor parallel (``runtime.mesh_model``, ``parallel/tensor.py``): each
rank keeps its shards of the vocoder (the GRUs' gate axes, the FCs'
outputs) from the full seeded init, runs the partitioned forward of
``models/vocoder.py`` and scores its classes of the logits by the
vocab-parallel cross-entropy; the frozen encoder is replicated. The
clip's norm is the sharded gradients' sum of squares summed over the model
group, plus each replicated gradient's counted once, so the clip runs on
the global norm. Checkpoints and validation decodes read the gathered
weights, rank 0 decoding through the AR kernel as without a model group.
"""

import collections
import contextlib
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from ..configs import ConfGlobal, resolve_compute_dtype
from ..data.datamodule import VocoderDataModule
from ..device import resolve_device
from ..dsp.audio_io import write_wav
from ..models.encoder import Encoder
from ..models.vocoder import Vocoder, vocab_sharded, vocoder_forward, vocoder_generate
from ..ops.ar_decode import fused_ar_decode, resolve_precision
from ..parallel.mesh import is_main, mesh_from_conf
from ..parallel.sharding import FlatGrads, agree, local_share, shard_batch, world_of
from ..parallel.tensor import (ModelGroup, all_reduce_model, gather_module_state,
                               gather_optimizer_state, model_dim, shard_module_,
                               shard_optimizer_state, shard_state,
                               vocab_parallel_cross_entropy)
from ..utils.profiling import device_time, totals, trace
from ..weights import vocoder_train_state_from_jax
from .checkpoint import (AsyncCheckpointer, checkpoint_format, latest_checkpoint,
                         load_checkpoint, read_jax_checkpoint, save_checkpoint)
from .preemption import install_preemption_handler, preemption_requested
from .schedule import MultiStepSchedule
from .step_graph import StepGraph, load_optimizer_state, make_adam, set_lr, stage

HISTORY_STEPS = 10_000  # per-step losses kept on the trainer
SPEAKER_INCREMENT = 5  # validation converts speaker s to (s + 5) % n_speakers


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         model: Optional[ModelGroup] = None,
                         sharded: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: where the global norm is at
    least ``max_norm``, every gradient becomes g / norm * max_norm. Returns
    the norm, a scalar on the gradients' device (nothing waits for it).
    With ``model``, ``sharded`` (bool, one per gradient) marks this rank's
    slices: their sums of squares are summed over the model group, the
    replicated ones' counted once, then all summed in the gradients' order."""
    squares = torch.stack([g.square().sum() for g in grads])
    if model is not None:
        summed = all_reduce_model(torch.where(sharded, squares, 0.0), model)
        squares = torch.where(sharded, summed, squares)
    norm = squares.sum().sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def refuse_untrained_head(conf: ConfGlobal) -> None:
    """Raise for a vocoder head this trainer does not train: the dual softmax
    head (``rnnms.output=dual16``) needs 16-bit samples, and the feature
    store holds 8-bit mu-law audio only; with tensor parallelism
    (``runtime.mesh_model > 1``) the error says that it has no sharding
    rules either."""
    if conf.training_vocoder.model.network.rnnms.output != "dual16":
        return
    if conf.runtime.mesh_model > 1:
        raise ValueError("tensor parallelism (runtime.mesh_model > 1) has no sharding rules "
                         "for rnnms.output=dual16, which is not trained here")
    raise ValueError("rnnms.output=dual16 is not trained here: the feature store holds "
                     "8-bit mu-law audio only, and the dual head needs 16-bit samples")


class VocoderTrainer:
    """The vocoder and Adam on one device beside a frozen encoder.

    Weights are torch's default inits drawn on the CPU from ``conf.seed``,
    then moved. ``step`` counts optimizer steps, ``epoch`` finished epochs;
    ``graph`` steps ``train_steps``. With a process ``group`` the trainer is
    one data-parallel rank: its steps take its share of the batch and
    reduce across the group; every rank starts from the same weights. With
    a ``model`` group it holds this rank's shards of the vocoder
    (``vocoder_dims``: {state_dict name: dim}).
    """

    def __init__(self, conf: ConfGlobal, encoder: Encoder, device: Union[str, torch.device],
                 group=None, model: Optional[ModelGroup] = None):
        refuse_untrained_head(conf)
        self.conf = conf
        self.device = torch.device(device)
        self.group = group
        self.model = model
        local_share(conf.data.loader.batch_size, world_of(group), "data.loader.batch_size")
        self.compute_dtype = resolve_compute_dtype(conf.runtime.precision)
        tv = conf.training_vocoder
        torch.manual_seed(conf.seed)
        self.vocoder = Vocoder(tv.model.network).to(self.device).train()
        self.vocoder_dims, self.sharded = {}, None  # the clip's mask of shards
        if model is not None:
            self.vocoder_dims = shard_module_(self.vocoder, model)
            self.sharded = torch.tensor([model_dim(p) is not None
                                         for p in self.vocoder.parameters()], device=self.device)
        self.encoder = encoder.to(self.device).eval().requires_grad_(False)
        self.optimizer = make_adam(self.vocoder.parameters(), self.device)
        self.grads = FlatGrads(list(self.vocoder.parameters()), 1, group)
        self.graph = StepGraph(self._step, self.optimizer, self.device, group, model)
        self.clip = tv.trainer.gradient_clip_val
        self.step = 0
        self.epoch = 0
        self.history = collections.deque(maxlen=HISTORY_STEPS)

    @torch.no_grad()
    def codes(self, mels: torch.Tensor, compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The frozen encoder's code indices (B, F // 2) of mels (B, n_mels, F)."""
        return self.encoder.encode(mels, compute_dtype or self.compute_dtype,
                                   return_context=False)[1]

    def loss(self, audio: torch.Tensor, mels: torch.Tensor, speakers: torch.Tensor) -> torch.Tensor:
        """Mean next-sample cross-entropy of a batch: audio (B, L + 1) classes."""
        audio = audio.long()
        logits = vocoder_forward(self.vocoder, audio[:, :-1], self.codes(mels),
                                 speakers.long(), self.compute_dtype, self.model)
        logits, target = logits.reshape(-1, logits.shape[-1]), audio[:, 1:].reshape(-1)
        if vocab_sharded(self.vocoder, self.model):
            return vocab_parallel_cross_entropy(logits, target, self.model)
        return F.cross_entropy(logits, target)

    def train_step(
        self, audio: torch.Tensor, mels: torch.Tensor, speakers: torch.Tensor, lr: float
    ) -> Dict[str, torch.Tensor]:
        """One eager optimizer step; returns the loss as a tensor on the
        device, without waiting for it."""
        set_lr(self.optimizer, lr)
        out = self._step(audio, mels, speakers)
        self.step += 1
        return out

    def train_steps(
        self, audio: torch.Tensor, mels: torch.Tensor, speakers: torch.Tensor,
        lrs: Sequence[float],
    ) -> Dict[str, torch.Tensor]:
        """K optimizer steps through ``graph`` on audio (K, B, L + 1), mels
        (K, B, n_mels, F) and speakers (K, B) on the device, one learning
        rate per step. Returns the losses (K,) on the device, without
        waiting for them: K sequential ``train_step`` calls' bits."""
        losses = []
        for i, lr in enumerate(lrs):
            losses.append(self.graph.step((audio[i], mels[i], speakers[i]), lr)["loss"])
            self.step += 1
        return {"loss": torch.stack(losses)}

    def _step(self, audio, mels, speakers) -> Dict[str, torch.Tensor]:
        """The step at the optimizer's learning rate, without the host's
        step count: nothing in it waits for the device or reads the host,
        so a CUDA graph can hold it."""
        loss = self.loss(audio, mels, speakers)
        loss = self.grads.backward(loss, [loss])[0]
        clip_by_global_norm_([p.grad for p in self.vocoder.parameters()], self.clip, self.model,
                             self.sharded)
        self.optimizer.step()
        return {"loss": loss.detach()}

    def checkpoint(self) -> dict:
        """{vocoder, optimizer, step, epoch}, the shards gathered over the
        model group (every model rank calls it)."""
        return {
            "vocoder": gather_module_state(self.vocoder, self.model),
            "optimizer": gather_optimizer_state(self.optimizer, self.model),
            "step": self.step,
            "epoch": self.epoch,
        }

    def full_vocoder(self) -> Vocoder:
        """The vocoder with every weight whole: itself, or with a model
        group a copy holding the gathered shards (every model rank calls it)."""
        if self.model is None:
            return self.vocoder
        state = gather_module_state(self.vocoder, self.model)
        with torch.device("meta"):
            vocoder = Vocoder(self.conf.training_vocoder.model.network)
        vocoder = vocoder.to_empty(device=self.device)
        vocoder.load_state_dict(state, strict=True)
        return vocoder

    def load(self, path: Union[str, Path]) -> None:
        """Restore a checkpoint of this layout, or the JAX package's vocoder
        train state (parameters, Adam's moments and count, step, epoch).
        Load before the step graph's capture."""
        if checkpoint_format(path) == "jax":
            names = [n for n, _ in self.vocoder.named_parameters()]
            ckpt = vocoder_train_state_from_jax(read_jax_checkpoint(path), names)
        else:
            ckpt = load_checkpoint(path)
        vocoder = ckpt["vocoder"]
        if self.model is not None:
            vocoder = shard_state(vocoder, self.vocoder_dims, self.model)
        self.vocoder.load_state_dict(vocoder, strict=True)
        load_optimizer_state(self.optimizer, shard_optimizer_state(
            ckpt["optimizer"], self.optimizer, self.model))
        self.step, self.epoch = int(ckpt["step"]), int(ckpt["epoch"])


def validation_precision(precision: str) -> str:
    """The validation decode's mode for ``runtime.precision``: int8 only when
    it is "int8", bf16 for every other mode ("auto" included), as JAX
    ``training/vocoder.py:238``; an unknown mode raises ``ValueError``."""
    resolve_precision(precision, 1)
    return "int8" if precision == "int8" else "bf16"


@torch.no_grad()
def validate(conf: ConfGlobal, trainer: VocoderTrainer, val_items, out_dir: Path,
             global_step: int, writer=None, vocoder: Optional[Vocoder] = None) -> None:
    """Reconstruction and conversion of each validation utterance, written as
    ``spk_{s}_step{n}.wav`` and ``spk_{s}_to_{t}_step{n}.wav``, by ``vocoder``
    (the trainer's by default; ``full_vocoder`` with a model group). The
    codes come from an f32 encode, as in the JAX package."""
    n_speakers = conf.training_vocoder.model.n_speakers
    sr = conf.training_vocoder.model.sampling_rate
    vocoder = (trainer.vocoder if vocoder is None else vocoder).eval()
    on_card = trainer.device.type == "cuda"
    precision = validation_precision(conf.runtime.precision)
    weights = {}  # prepared once for every utterance of this validation

    def generate(codes, spk):
        spk = torch.tensor([spk], device=trainer.device)
        if on_card:
            return fused_ar_decode(vocoder, codes, spk, seed=global_step, precision=precision,
                                   weights=weights)
        gen = torch.Generator(device=trainer.device).manual_seed(global_step)
        return vocoder_generate(vocoder, codes, spk, generator=gen)

    out_dir.mkdir(parents=True, exist_ok=True)
    for _audio, mel, speaker in val_items:
        codes = trainer.codes(torch.tensor(mel)[None].to(trainer.device), torch.float32)
        src = int(speaker)
        tgt = (src + SPEAKER_INCREMENT) % n_speakers
        for name, spk in ((f"spk_{src}", src), (f"spk_{src}_to_{tgt}", tgt)):
            wave = generate(codes, spk)[0].cpu().numpy()
            write_wav(out_dir / f"{name}_step{global_step}.wav", wave, sr)
            if writer is not None:
                try:
                    writer.add_audio(name, wave[None], global_step=global_step, sample_rate=sr)
                except Exception:
                    pass  # tensorboardX audio needs extra packages; the wavs are on disk
    vocoder.train()


def _grouped(items: Iterable, k: int):
    buf = []
    for item in items:
        buf.append(item)
        if len(buf) == k:
            yield buf
            buf = []
    if buf:
        yield buf


def _fetch(trainer: VocoderTrainer, pending: List[torch.Tensor]) -> List[float]:
    losses = torch.cat(pending).cpu().tolist() if pending else []
    trainer.history.extend(losses)
    return losses


def train_vocoder(
    conf: ConfGlobal,
    encoder: Encoder,
    data_dir: Union[str, Path],
    max_steps: Optional[int] = None,
    checkpoint_minutes: float = 15.0,
    device: Optional[Union[str, torch.device]] = None,
) -> VocoderTrainer:
    """The vocoder training loop over preprocessed features in ``data_dir``.

    Runs on ``device``, else on ``runtime.platform``, else on the CUDA card;
    raises when no card is there and the CPU was not asked for. In a
    rank of the mesh (``parallel/mesh.py:mesh_from_conf``) it runs on the
    rank's card with its data and model groups.
    """
    mesh = mesh_from_conf(conf.runtime)
    if mesh is not None:
        device = mesh.device
    device = resolve_device(device if device is not None else conf.runtime.platform)
    main = is_main(mesh)
    log = print if main else (lambda *args, **kwargs: None)
    validation_precision(conf.runtime.precision)  # an unknown mode fails before any work
    tv = conf.training_vocoder
    ckpt_dir = (Path(tv.ckpt_log.dir_root) / tv.ckpt_log.name_exp / tv.ckpt_log.name_version
                / "checkpoints")
    sample_dir = ckpt_dir.parent / "samples"
    trainer = VocoderTrainer(conf, encoder, device, *((None, None) if mesh is None else
                                                      (mesh.group, mesh.model)))
    last = latest_checkpoint(ckpt_dir)
    if last is not None:
        trainer.load(last)
        log(f"Auto-resume from: {last}: step {trainer.step}, epoch {trainer.epoch}")
    schedule = MultiStepSchedule(base_lr=tv.model.optim.learning_rate,
                                 milestones=tv.model.optim.sched_milestones,
                                 gamma=tv.model.optim.sched_gamma)
    dm = VocoderDataModule(conf.data, data_dir=Path(data_dir), seed=conf.seed)
    dm.setup()
    loader = dm.train_dataloader()
    if len(loader) == 0:
        raise ValueError(f"Not enough utterances for batch size {conf.data.loader.batch_size}.")
    val_items = dm.val_items()
    # TensorBoard when tensorboardX is there (optional, as in JAX); opened
    # after the resume and the data, whose failures then leave no writer
    # thread behind.
    writer = None
    try:
        from tensorboardX import SummaryWriter

        if main:
            writer = SummaryWriter(str(ckpt_dir.parent))
    except Exception:
        pass

    spd = max(1, int(tv.trainer.steps_per_dispatch))
    last_ckpt_time = t_log = time.time()
    pending: List[torch.Tensor] = []  # device losses (K,) per group since the last log
    n_pending = 0
    ckpt_writer = AsyncCheckpointer(active=main)
    install_preemption_handler()
    preempted = False
    # The profiler report's rows: the spans' totals since here
    # (``data.wait``; ``step.stage`` and ``step.dispatch``) over the steps.
    spans_before, n_steps = totals(), 0
    # One traced window of groups, from 3 steps after the start (past the
    # warm-up and the capture) to 6 after it, as JAX's.
    profile_dir = conf.runtime.profile_dir
    profile_start = trainer.step + 3
    window = contextlib.ExitStack()
    window_prof, window_steps, profiled = None, 0, False

    def done() -> bool:
        return max_steps is not None and trainer.step >= max_steps

    def close_window() -> None:
        if window_prof is not None:
            window.close()
            busy = device_time(window_prof, window_steps)["device_busy_ms"]
            log(f"Wrote profiler trace to {profile_dir}"
                  + ("" if busy is None else f" ({busy:.3f} ms of device work per step)"))

    for epoch in range(trainer.epoch + 1, tv.trainer.max_epochs + 1):
        if done():
            break
        loader.set_epoch(epoch)
        for group in _grouped(loader, spd):
            if max_steps is not None:
                group = group[: max_steps - trainer.step]
            if profile_dir and not profiled and trainer.step >= profile_start:
                window_prof = window.enter_context(trace(profile_dir, device))
                profiled = True
            lrs = [schedule(trainer.step + j) for j in range(len(group))]
            audio, mel, spk = (stage([shard_batch(b[i], mesh) for b in group], device)
                               for i in range(3))
            pending.append(trainer.train_steps(audio, mel, spk, lrs)["loss"])
            n_pending += len(group)
            n_steps += len(group)
            if window_prof is not None:
                window_steps += len(group)
                if trainer.step >= profile_start + 3:
                    close_window()
                    window_prof = None
            if n_pending >= 100:
                losses = _fetch(trainer, pending)
                pending, n_pending = [], 0
                rate = len(losses) / (time.time() - t_log)
                t_log = time.time()
                loss_mean = sum(losses) / len(losses)
                log(f"step:{trainer.step} epoch:{epoch} loss:{loss_mean:.4f} "
                      f"{rate:.2f} steps/s")
                if writer is not None:
                    writer.add_scalar("loss", loss_mean, trainer.step)
            # Every rank saves and stops at the same group: a checkpoint's
            # gathers and every step are collectives of all the ranks.
            due, stop = agree([(time.time() - last_ckpt_time) / 60.0 >= checkpoint_minutes,
                               preemption_requested()], mesh)
            if due:
                ckpt_writer.save(ckpt_dir, trainer.step, trainer.checkpoint())
                last_ckpt_time = time.time()
            if stop:
                preempted = True
                break
            if done():
                break
        trainer.epoch = epoch
        if preempted:
            log(f"Preempted: saving model.ckpt-{trainer.step}.pt; rerun the same command "
                  "to auto-resume.")
            break
        if epoch % tv.trainer.val_interval_epoch == 0:
            vocoder = trainer.full_vocoder()  # every model rank gathers
            if main:
                validate(conf, trainer, val_items, sample_dir, trainer.step, writer, vocoder)
    close_window()  # a run that ended inside the window

    _fetch(trainer, pending)
    if tv.trainer.profiler is not None and n_steps:
        spans = totals()

        def seconds(*names):
            return sum(spans.get(k, (0, 0.0))[1] - spans_before.get(k, (0, 0.0))[1]
                       for k in names)

        data_wait, dispatch = seconds("data.wait"), seconds("step.stage", "step.dispatch")
        log(
            "Profiler report ({}):\n"
            "  action           total_s    mean_ms    steps\n"
            "  data_wait      {:9.3f}  {:9.3f}  {:7d}\n"
            "  train_dispatch {:9.3f}  {:9.3f}  {:7d}".format(
                tv.trainer.profiler,
                data_wait, 1e3 * data_wait / n_steps, n_steps,
                dispatch, 1e3 * dispatch / n_steps, n_steps,
            )
        )
    ckpt_writer.wait()
    state = trainer.checkpoint()  # every model rank gathers
    if main:
        save_checkpoint(ckpt_dir, trainer.step, state)
    if writer is not None:
        writer.close()
    return trainer
