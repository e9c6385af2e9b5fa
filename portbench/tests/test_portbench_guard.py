"""What a run may load, and a run where it cannot measure."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "vectorquantizedcpc_tpu"}
PORT_MODULES = ["infer.serving", "training.vocoder", "training.cpc", "training.step_graph",
                "data.datasets", "data.loader", "models.cpc", "models.encoder", "configs"]


def _loaded_after(code: str, cwd: Path = ROOT) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=cwd, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(cwd)))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_program_it_drives_load_no_jax():
    mods = ["portbench.run", "portbench.readings", "portbench.lib.harness",
            "portbench.lib.serving", "portbench.lib.training", "portbench.lib.trace"]
    mods += [f"portbench.drivers.{p.stem}" for p in (ROOT / "portbench/drivers").glob("*.py")]
    mods += [f"portbench.metrics.{p.stem}" for p in (ROOT / "portbench/metrics").glob("*.py")]
    mods += [f"vectorquantizedcpc_tpu_torch.{m}" for m in PORT_MODULES]
    loaded = _loaded_after("\n".join(f"import {m}" for m in mods))
    assert "vectorquantizedcpc_tpu_torch" in loaded  # compared whole, not by prefix
    assert not loaded & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench/reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            for name in names:
                assert name.split(".")[0] in {"torch", "numpy", "math", "json", "pathlib",
                                              "typing"}, (path.name, name)
    mods = [f"portbench.reference.{p.stem}" for p in (ROOT / "portbench/reference").glob("*.py")]
    loaded = _loaded_after("\n".join(f"import {m}" for m in mods))
    assert not loaded & (FORBIDDEN | {"vectorquantizedcpc_tpu_torch"})


def test_a_run_without_a_card_exits_and_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "jvs-ja.serve-batch",
                          "--seed", "3000000123", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == "" and "metrics" not in out.stdout


def test_a_run_beside_no_program_exits_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in json.loads((ROOT / "BENCHMARK.json").read_text())["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p, ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "jvs-ja.cpc-train",
                          "--seed", "5", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""
