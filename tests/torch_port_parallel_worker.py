"""One data-parallel rank of the port, for tests/test_torch_parallel.py.

    python tests/torch_port_parallel_worker.py <case> <dir>

Started by torchrun (``python -m torch.distributed.run``), one process a
rank; joins a gloo process group with a 60 s timeout, so that a rank left
waiting fails instead of hanging, then takes its place through
``mesh_from_conf``; reads ``<dir>/inputs.pt`` and writes
``<dir>/rank<r>.pt``. Imports nothing of JAX.

Cases: ``cpc`` and ``vocoder`` run the inputs' steps through the trainers'
``train_step`` on this rank's share of each global batch; ``preempt`` runs
``train_model`` with a preemption requested on the last rank only and logs
every checkpoint write with the rank that made it.
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

torch.set_num_threads(1)


def _adam(trainer, modules):
    names = {id(p): f"{prefix}{n}" for prefix, m in modules.items()
             for n, p in m.named_parameters()}
    return {names[id(p)]: st["exp_avg"].clone() for p, st in trainer.optimizer.state.items()}


def cpc(d: Path, inputs: dict, mesh) -> dict:
    from vectorquantizedcpc_tpu_torch.training.cpc import CPCTrainer

    trainer = CPCTrainer(load_conf(inputs["argv"]), mesh.device, mesh.group)
    trainer.encoder.load_state_dict(inputs["encoder"], strict=True)
    trainer.cpc.load_state_dict(inputs["cpc"], strict=True)
    metrics = []
    for mels, utt, seq, lr in zip(inputs["mels"], inputs["utt"], inputs["seq"], inputs["lrs"]):
        m = trainer.train_step(shard_batch(mels, mesh), utt,
                               shard_negatives(seq, mesh.rank, mesh.world), lr)
        metrics.append({k: v.clone() for k, v in m.items()})
    return {"encoder": trainer.encoder.state_dict(), "cpc": trainer.cpc.state_dict(),
            "metrics": metrics,
            "exp_avg": _adam(trainer, {"encoder.": trainer.encoder, "cpc.": trainer.cpc})}


def vocoder(d: Path, inputs: dict, mesh) -> dict:
    from vectorquantizedcpc_tpu_torch.models.encoder import Encoder
    from vectorquantizedcpc_tpu_torch.training.vocoder import VocoderTrainer

    conf = load_conf(inputs["argv"])
    encoder = Encoder(conf.model.encoder)
    encoder.load_state_dict(inputs["encoder"], strict=True)
    trainer = VocoderTrainer(conf, encoder, mesh.device, mesh.group)
    trainer.vocoder.load_state_dict(inputs["vocoder"], strict=True)
    losses = []
    for audio, mels, spk, lr in zip(inputs["audio"], inputs["mels"], inputs["spk"],
                                    inputs["lrs"]):
        batch = (shard_batch(x, mesh) for x in (audio, mels, spk))
        losses.append(trainer.train_step(*batch, lr)["loss"].clone())
    return {"vocoder": trainer.vocoder.state_dict(), "losses": torch.stack(losses),
            "exp_avg": _adam(trainer, {"": trainer.vocoder})}


def preempt(d: Path, inputs: dict, mesh) -> dict:
    from vectorquantizedcpc_tpu_torch.training import checkpoint, cpc, preemption

    write = checkpoint._write

    def logged(checkpoint_dir, n, host_state):
        with open(d / "writes.txt", "a") as f:
            f.write(f"{mesh.rank} model.ckpt-{n}.pt\n")
        return write(checkpoint_dir, n, host_state)

    checkpoint._write = logged
    if mesh.rank == mesh.world - 1:
        preemption.request_preemption()
    trainer = cpc.train_model(load_conf(inputs["argv"]))
    return {"epoch": trainer.epoch, "global_step": trainer.global_step}


def main() -> None:
    case, d = sys.argv[1], Path(sys.argv[2])
    inputs = torch.load(d / "inputs.pt", weights_only=False)
    dist.init_process_group("gloo", timeout=timedelta(seconds=60))
    mesh = mesh_from_conf(load_conf(inputs["argv"]).runtime)
    out = {"cpc": cpc, "vocoder": vocoder, "preempt": preempt}[case](d, inputs, mesh)
    torch.save(out, d / f"rank{mesh.rank}.pt")


if __name__ == "__main__":
    main()
