"""Time the PyTorch port's preprocess CLI on phase 4d's synthetic corpus.

    python tools/time_preprocess.py [--root DIR] [--workers 4] [--reps 3]

Writes the corpus that ``chip_smoke.py`` phase 4d trains on (16 speakers x
8 utterances of 2 s, ``SyntheticCorpus``) once into a temporary directory,
then runs ``python -m vectorquantizedcpc_tpu_torch.cli.preprocess`` on it
``--reps`` times with ``data.loader.num_workers=--workers``, each into a
fresh output directory, and times each run's wall clock: interpreter start,
imports, the worker pool and the features. ``--root`` is a checkout of the
repository whose port is run (this one by default), so that two commits
can be compared on one host: run the script on the parent, the change, the
change and the parent, in one session. Prints one JSON line: the root, the
host's CPU count, the card's name and power limit where ``nvidia-smi``
answers, each run's seconds and their median.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "no card"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    env = dict(os.environ, PYTHONPATH=str(root))
    with tempfile.TemporaryDirectory() as tmp:
        corpus = Path(tmp) / "corpus"
        subprocess.run([sys.executable, "-c",
                        "from vectorquantizedcpc_tpu_torch.data.corpus import SyntheticCorpus; "
                        f"SyntheticCorpus({str(corpus)!r}, n_speakers=16, n_utterances=8, "
                        "duration_s=2.0).utterances()"], cwd=root, env=env, check=True)
        seconds = []
        for rep in range(args.reps):
            start = time.perf_counter()
            subprocess.run([sys.executable, "-m", "vectorquantizedcpc_tpu_torch.cli.preprocess",
                            "data.dataset.name=synthetic", f"data.corpus.root={corpus}",
                            f"out_dir={Path(tmp) / f'features{rep}'}",
                            f"data.loader.num_workers={args.workers}"],
                           cwd=root, env=env, check=True, capture_output=True)
            seconds.append(time.perf_counter() - start)
    print(json.dumps({"root": str(root), "cpus": os.cpu_count(), "card": _card(),
                      "workers": args.workers, "utterances": 128, "seconds": seconds,
                      "median_s": statistics.median(seconds)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
