"""One rank of the port's (data, model) mesh, for tests/test_torch_tensor_parallel.py.

    python tests/torch_port_tp_worker.py <dir> <case> [<case> ...]

Started by torchrun (``python -m torch.distributed.run``), one process a
rank; joins a gloo process group with a 60 s timeout, so that a rank left
waiting fails instead of hanging, then takes its place through
``mesh_from_conf`` (the argv of ``<dir>/inputs.pt``); runs each case in
turn and writes ``<dir>/rank<r>.pt`` ({case: result}). Imports nothing of
JAX.

Cases: ``cpc`` and ``vocoder`` run the inputs' steps through the trainers'
``train_step`` on this rank's data share of each global batch, with this
rank's shards; each returns the gathered checkpoint, the metrics, the
rank's own tensors and their bytes. ``tie`` runs one VQ step over a
codebook whose two halves, one a rank at M 2, are the same codes.
``preempt`` runs ``train_model`` with a preemption requested on the last
rank only.
"""

import sys
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

from vectorquantizedcpc_tpu_torch.configs import load_conf
from vectorquantizedcpc_tpu_torch.models.cpc import shard_negatives
from vectorquantizedcpc_tpu_torch.parallel.mesh import mesh_from_conf
from vectorquantizedcpc_tpu_torch.parallel.sharding import shard_batch
from vectorquantizedcpc_tpu_torch.parallel.tensor import model_dim, shard_state

torch.set_num_threads(1)


def _local(trainer, modules: dict) -> dict:
    """The rank's own tensors: parameters, buffers and Adam's moments, by
    name, with which of them are shards."""
    names = {}
    out, sharded = {}, set()
    for prefix, m in modules.items():
        for n, t in m.state_dict(keep_vars=True).items():
            out[prefix + n] = t.detach().clone()
            if model_dim(t) is not None:
                sharded.add(prefix + n)
            names[id(t)] = prefix + n
    for p, st in trainer.optimizer.state.items():
        for k in ("exp_avg", "exp_avg_sq"):
            out[f"adam.{k}.{names[id(p)]}"] = st[k].clone()
            if model_dim(p) is not None:
                sharded.add(f"adam.{k}.{names[id(p)]}")
    return {"tensors": out, "sharded": sorted(sharded)}


def cpc(inputs: dict, mesh) -> dict:
    from vectorquantizedcpc_tpu_torch.training.cpc import CPCTrainer
    from vectorquantizedcpc_tpu_torch.training.schedule import WarmupSchedule

    trainer = CPCTrainer(load_conf(inputs["argv"]), mesh.device, mesh.group, mesh.model)
    trainer.encoder.load_state_dict(shard_state(inputs["encoder"], trainer.encoder_dims,
                                                mesh.model), strict=True)
    trainer.cpc.load_state_dict(inputs["cpc"], strict=True)
    metrics = []
    for mels, utt, seq, lr in zip(inputs["mels"], inputs["utt"], inputs["seq"], inputs["lrs"]):
        m = trainer.train_step(shard_batch(mels, mesh), utt,
                               shard_negatives(seq, mesh.rank, mesh.world), lr)
        metrics.append({k: v.clone() for k, v in m.items()})
    tc = trainer.conf.training.cpc.scheduler
    ckpt = trainer.checkpoint(len(metrics), WarmupSchedule(
        tc.warmup_epochs, tc.initial_lr, tc.max_lr, tc.milestones, tc.gamma))
    return {"checkpoint": ckpt, "metrics": metrics,
            "local": _local(trainer, {"encoder.": trainer.encoder, "cpc.": trainer.cpc}),
            "param_names": trainer.param_names}


def vocoder(inputs: dict, mesh) -> dict:
    from vectorquantizedcpc_tpu_torch.models.encoder import Encoder
    from vectorquantizedcpc_tpu_torch.training.vocoder import VocoderTrainer

    conf = load_conf(inputs["voc_argv"])
    encoder = Encoder(conf.model.encoder)
    encoder.load_state_dict(inputs["voc_encoder"], strict=True)
    trainer = VocoderTrainer(conf, encoder, mesh.device, mesh.group, mesh.model)
    trainer.vocoder.load_state_dict(shard_state(inputs["vocoder"], trainer.vocoder_dims,
                                                mesh.model), strict=True)
    losses = []
    for audio, mels, spk, lr in zip(inputs["audio"], inputs["voc_mels"], inputs["spk"],
                                    inputs["voc_lrs"]):
        batch = (shard_batch(x, mesh) for x in (audio, mels, spk))
        losses.append(trainer.train_step(*batch, lr)["loss"].clone())
    return {"checkpoint": trainer.checkpoint(), "losses": torch.stack(losses),
            "local": _local(trainer, {"": trainer.vocoder}),
            "dims": trainer.vocoder_dims}


def tie(inputs: dict, mesh) -> dict:
    """One VQ step over a codebook of two equal halves: every latent ties
    between a code of rank 0 and the same code of rank 1."""
    from vectorquantizedcpc_tpu_torch.models.vq import VQEmbeddingEMA, vq_apply_train
    from vectorquantizedcpc_tpu_torch.parallel.tensor import shard_module_

    half, x = inputs["tie_half"], inputs["tie_x"]
    codebook = VQEmbeddingEMA(2 * half.shape[0], half.shape[1])
    codebook.load_state_dict({"embedding": torch.cat([half, half]),
                              "ema_count": torch.zeros(2 * half.shape[0]),
                              "ema_weight": torch.cat([half, half])})
    shard_module_(codebook, mesh.model, "codebook.")
    z, _, perplexity = vq_apply_train(codebook, x, model=mesh.model)
    return {"z": z, "perplexity": perplexity, "embedding": codebook.embedding.clone(),
            "ema_count": codebook.ema_count.clone()}


def preempt(inputs: dict, mesh) -> dict:
    """``train_model`` with a preemption requested on the last rank only;
    logs every checkpoint write with the global rank that made it."""
    from vectorquantizedcpc_tpu_torch.training import checkpoint, cpc, preemption

    write, rank = checkpoint._write, dist.get_rank()

    def logged(checkpoint_dir, n, host_state):
        with open(Path(inputs["dir"]) / "writes.txt", "a") as f:
            f.write(f"{rank} model.ckpt-{n}.pt\n")
        return write(checkpoint_dir, n, host_state)

    checkpoint._write = logged
    if rank == dist.get_world_size() - 1:
        preemption.request_preemption()
    trainer = cpc.train_model(load_conf(inputs["argv"]))
    return {"epoch": trainer.epoch, "global_step": trainer.global_step}


def main() -> None:
    d, cases = Path(sys.argv[1]), sys.argv[2:]
    inputs = torch.load(d / "inputs.pt", weights_only=False)
    dist.init_process_group("gloo", timeout=timedelta(seconds=60))
    mesh = mesh_from_conf(load_conf(inputs["argv"]).runtime)
    run = {"cpc": cpc, "vocoder": vocoder, "tie": tie, "preempt": preempt}
    torch.save({case: run[case](inputs, mesh) for case in cases},
               d / f"rank{dist.get_rank()}.pt")


if __name__ == "__main__":
    main()
