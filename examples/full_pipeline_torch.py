"""The PyTorch port end to end, on the synthetic corpus.

preprocess -> train CPC -> encode -> train vocoder -> voice-convert, each
through the port's CLI (``python -m vectorquantizedcpc_tpu_torch.cli.<name>``,
one process each), in a scratch directory, at the tiny widths and step
counts of ``examples/full_pipeline.py``. Runs on the CUDA card by default;
``--cpu`` adds ``runtime.platform=cpu`` to every command.

    python examples/full_pipeline_torch.py [--workdir DIR] [--cpu] [--epochs N]
"""

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run(module: str, *overrides: str) -> None:
    cmd = [sys.executable, "-m", f"vectorquantizedcpc_tpu_torch.cli.{module}", *overrides]
    print(f"\n$ {' '.join(cmd)}\n", flush=True)
    subprocess.run(cmd, check=True, cwd=ROOT)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--epochs", type=int, default=60)
    args = ap.parse_args()

    ws = Path(args.workdir or tempfile.mkdtemp(prefix="vqcpc_torch_example_")).resolve()
    platform = ["runtime.platform=cpu"] if args.cpu else []
    tiny = [
        "model.encoder.channels=64",
        "dim_latent=16",
        "dim_cpc_context=32",
        "size_latent_codebook=64",
        "training_vocoder.model.n_speakers=4",
        "training_vocoder.model.network.rnnms.wave_ar.size_h_rnn=64",
        "training_vocoder.model.network.rnnms.wave_ar.size_h_fc=32",
        "runtime.precision=float32",
    ]
    data = [
        "data.dataset.name=synthetic",
        f"data.corpus.root={ws}/corpus",
        f"data.dataset.adress_data_root={ws}/features",
    ]

    # 1. Features.
    run("preprocess", *platform, *data, f"out_dir={ws}/features")

    # 2. CPC encoder.
    run(
        "train_cpc", *platform, *tiny, *data,
        f"checkpoint_dir={ws}/ckpt",
        "training.cpc.sample_frames=32",
        "training.cpc.n_speakers_per_batch=4",
        "training.cpc.n_utterances_per_speaker=4",
        "training.cpc.n_negatives=5",
        f"training.cpc.n_epochs={args.epochs}",
        "training.cpc.scheduler.warmup_epochs=5",
        f"training.cpc.scheduler.milestones=[{max(6, args.epochs - 10)}]",
        f"training.cpc.checkpoint_interval={args.epochs}",
        "training.cpc.log_interval=20",
    )
    ckpt = f"{ws}/ckpt/model.ckpt-{args.epochs}.pt"

    # 3. Latent export (ABX format).
    run(
        "encode", *platform, *tiny,
        f"cpc_checkpoint={ckpt}", f"in_dir={ws}/features",
        f"out_dir={ws}/codes", "save_auxiliary=true",
    )

    # 4. Vocoder (short demo run).
    run(
        "train_vocoder", *platform, *tiny, *data,
        f"cpc_checkpoint={ckpt}",
        "training_vocoder.trainer.max_epochs=2",
        "training_vocoder.trainer.val_interval_epoch=1000",
        "data.dataset.clip_length_mel=16",
        "data.loader.batch_size=8",
        f"training_vocoder.ckpt_log.dir_root={ws}/voc",
    )
    voc_dir = ws / "voc" / "default" / "version_-1" / "checkpoints"
    voc_ckpt = max(voc_dir.glob("model.ckpt-*.pt"), key=lambda p: int(p.stem.split("-")[-1]))

    # 5. Voice conversion.
    (ws / "target_vc.json").write_text(json.dumps([["V000/V000_0000", "V001", "demo_vc"]]))
    (ws / "corpus" / "speakers.json").write_text(json.dumps(["V000", "V001", "V002", "V003"]))
    run(
        "convert", *platform, *tiny,
        f"cpc_checkpoint={ckpt}", f"vocoder_checkpoint={voc_ckpt}",
        f"synthesis_list={ws}/target_vc.json",
        f"in_dir={ws}/corpus", f"out_dir={ws}/converted",
    )
    print(f"\nDone. Artifacts in {ws}:")
    print(f"  latent codes: {ws}/codes/*.txt")
    print(f"  converted audio: {ws}/converted/demo_vc.wav")


if __name__ == "__main__":
    main()
