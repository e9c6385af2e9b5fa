"""Write the JAX-made checkpoints and inputs that the port reads in its tests and on the card.

    JAX_PLATFORMS=cpu python tests/torch_port_jax_fixtures.py [out_dir]

``out_dir`` defaults to ``tests/fixtures/jax_ckpt``. Everything comes from
the JAX package's own CLIs on its synthetic corpus (4 speakers x 4
utterances of 0.5 s), at widths the port's CUDA kernels take:

- ``cpc/model.ckpt-2``: the preprocess and train_cpc CLIs at the ``TINY``
  widths of ``tests/test_torch_train_cpc.py``, 2 epochs of 2 steps, the
  checkpoint of epoch 2 (its Adam moments and count are not zero);
- ``vocoder/default/version_-1/checkpoints/model.ckpt-3``: the
  train_vocoder CLI from that checkpoint at small widths, one epoch of 3
  steps, as a JAX run directory;
- ``mels/``: two of the corpus's mels, the input of an export;
- ``wavs/`` and ``synthesis.json``: two of its wavs, ``speakers.json`` and
  a synthesis list, the input of a conversion;
- ``argv.json``: the widths both runs took (``cpc``, ``vocoder``) and the
  corpus (``corpus``), which the readers pass to the port's CLIs.

Not a test module (pytest collects ``test_*.py`` only);
``tests/test_torch_jax_checkpoint.py`` holds the committed files against a
fresh run of :func:`write_fixtures`.
"""

import json
import shutil
import sys
import tempfile
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parent / "fixtures" / "jax_ckpt"
CORPUS = {"n_speakers": 4, "n_utterances": 4, "duration_s": 0.5}
# tests/test_torch_train_cpc.py TINY: H 16 takes the LSTM cluster kernels.
ENCODER = [
    "model.encoder.channels=32",
    "dim_latent=8",
    "dim_cpc_context=16",
    "size_latent_codebook=32",
]
CPC = ENCODER + [
    "training.cpc.sample_frames=20",
    "training.cpc.n_speakers_per_batch=2",
    "training.cpc.n_utterances_per_speaker=2",
    "training.cpc.n_negatives=3",
]
VOCODER = ENCODER + [
    f"training_vocoder.model.n_speakers={CORPUS['n_speakers']}",
    "training_vocoder.model.network.dim_speaker_embedding=8",
    "training_vocoder.model.network.rnnms.dim_voc_latent=32",
    "training_vocoder.model.network.rnnms.wave_ar.size_i_embed_ar=16",
    "training_vocoder.model.network.rnnms.wave_ar.size_h_rnn=32",
    "training_vocoder.model.network.rnnms.wave_ar.size_h_fc=32",
    "data.dataset.clip_length_mel=4",
]
CPC_EPOCHS = 2
VOCODER_STEPS = 3  # one epoch: 13 training utterances in batches of 4
SAMPLES = ("V000_0001", "V002_0003")  # the mels and wavs the readers take


def _run_cli(module, argv) -> None:
    """A JAX CLI's ``main()`` on ``argv``, as ``python -m`` would run it."""
    saved = sys.argv
    sys.argv = [module.__name__] + list(argv)
    try:
        module.main()
    finally:
        sys.argv = saved


def write_fixtures(out_dir=DEFAULT_DIR) -> Path:
    """Run the JAX CLIs in a temporary directory and copy what the readers
    need into ``out_dir`` (replaced)."""
    from vectorquantizedcpc_tpu.cli import preprocess, train_cpc, train_vocoder
    from vectorquantizedcpc_tpu.data.corpus import SyntheticCorpus

    out_dir = Path(out_dir)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        SyntheticCorpus(tmp / "corpus", **CORPUS).utterances()
        data = ["data.dataset.name=synthetic", f"data.corpus.root={tmp / 'corpus'}",
                f"data.dataset.adress_data_root={tmp / 'features'}",
                "data.loader.num_workers=1"]
        _run_cli(preprocess, data)
        _run_cli(train_cpc, CPC + data + [
            f"checkpoint_dir={tmp / 'cpc'}", f"training.cpc.n_epochs={CPC_EPOCHS}",
            f"training.cpc.checkpoint_interval={CPC_EPOCHS}", "training.cpc.log_interval=1",
        ])
        cpc = tmp / "cpc" / f"model.ckpt-{CPC_EPOCHS}"
        _run_cli(train_vocoder, VOCODER + data + [
            f"cpc_checkpoint={cpc}", f"training_vocoder.ckpt_log.dir_root={tmp / 'vocoder'}",
            "data.loader.batch_size=4", "training_vocoder.trainer.max_epochs=1",
            "training_vocoder.trainer.val_interval_epoch=10",
        ])
        run = Path("default") / "version_-1" / "checkpoints"

        if out_dir.exists():
            shutil.rmtree(out_dir)
        (out_dir / "cpc").mkdir(parents=True)
        shutil.copy(cpc, out_dir / "cpc")
        (out_dir / "vocoder" / run).mkdir(parents=True)
        shutil.copy(tmp / "vocoder" / run / f"model.ckpt-{VOCODER_STEPS}", out_dir / "vocoder" / run)
        for sub in ("mels", "wavs"):
            (out_dir / sub).mkdir()
        speakers = sorted(p.name for p in (tmp / "corpus").iterdir() if p.is_dir())
        entries = []
        for i, name in enumerate(SAMPLES):
            spk = name.split("_")[0]
            shutil.copy(tmp / "features" / spk / f"{name}.mel.npy", out_dir / "mels")
            shutil.copy(tmp / "corpus" / spk / f"{name}.wav", out_dir / "wavs")
            entries.append([name, speakers[(speakers.index(spk) + 1) % len(speakers)], f"vc{i}"])
        (out_dir / "wavs" / "speakers.json").write_text(json.dumps(speakers))
        (out_dir / "synthesis.json").write_text(json.dumps(entries))
    (out_dir / "argv.json").write_text(json.dumps(
        {"cpc": CPC, "vocoder": VOCODER, "corpus": CORPUS, "cpc_epochs": CPC_EPOCHS,
         "vocoder_steps": VOCODER_STEPS}, indent=1))
    return out_dir


if __name__ == "__main__":
    print(write_fixtures(sys.argv[1] if len(sys.argv) > 1 else DEFAULT_DIR))
