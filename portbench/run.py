"""Benchmark of ``vectorquantizedcpc_tpu_torch`` on CUDA cards: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell, its configuration, its traffic
and its driver are found by name (``BENCHMARK.json``, ``portbench/``). The
run makes its weights and inputs from ``--seed``, warms up the cell's
shapes (set-up, timed from the start of this script), measures for
``--seconds``, judges what the timed work produced against the plain
reference in ``portbench/reference/``, and prints one JSON line last on
standard output: the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics read from a traced window (``--trace 1``). Every number
judged is printed with its limit, as the last lines on standard error and
under ``checks``, the line's last key. ``setup_s`` includes the load of
the program's kernel library, and in a checkout's first run its build,
which the line also gives apart under ``build``.

It exits non-zero and prints no result without the program beside it,
without a CUDA card (or with fewer cards than the cell asks for), or when
a module of JAX, Flax or the JAX package was loaded. Build caches stay
inside the checkout (``build/``); the features it writes go to a temporary
directory under ``TMPDIR``, removed at the end.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

PROGRAM = "vectorquantizedcpc_tpu_torch"


def fail(msg: str, code: int = 2) -> None:
    print(f"portbench: {msg}", file=sys.stderr)
    sys.exit(code)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.lib import harness

    try:
        bench = harness.load_benchmark(ROOT)
        cell, config, traffic = harness.resolve_cell(bench, args.workload, ROOT)
    except (OSError, KeyError, StopIteration, ValueError) as e:
        fail(f"cannot resolve the cell: {e!r}")
    if importlib.util.find_spec(PROGRAM) is None:
        fail(f"the program under test ({PROGRAM}) is not beside the benchmark")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available; this benchmark measures the card")
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"the cell asks for {cell['chips']} cards and {torch.cuda.device_count()} "
             "are visible")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    driver = harness.driver_module(traffic)
    limit = power_limit()

    # The kernels' library, built where the checkout has no build of these
    # sources yet (its first run): timed apart, inside set-up.
    from vectorquantizedcpc_tpu_torch.ops import _build

    built = not _build._library_path().exists()
    t_build = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t_build

    tmp_root = os.environ.get("TMPDIR") or tempfile.gettempdir()
    workdir = Path(tempfile.mkdtemp(prefix="portbench-", dir=tmp_root))
    try:
        run = harness.Run(cell, config, traffic, args.seed % (1 << 63), args.seconds,
                          bool(args.trace), device, workdir)
        driver.run(run)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if run.window_start is None:
        fail("the driver opened no window")
    found = harness.forbidden_modules()
    if found:
        fail(f"modules of JAX or the JAX package were loaded: {found}", 3)

    setup_s = run.window_start - T_START
    if args.trace:
        metrics = harness.read_per_layer(run, harness.cell_metrics(bench, run.name,
                                                                   "per_layer"))
    else:
        wanted = harness.cell_metrics(bench, run.name, "end_to_end")
        values = dict(run.e2e, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in wanted}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell["chips"],
           "memory_peak_bytes": int(run.memory_peak_bytes), "power_limit": limit}
    result = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev}
    summary = run.summary
    if args.trace and summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.top_ops(), "idle_gaps": summary.idle_gaps()}
    result["build"] = {"seconds": build_s, "built": built}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}

    for line in run.notes:
        print(line, file=sys.stderr)
    print(f"setup_s {setup_s:.3f}, of which the kernels' library {build_s:.3f} "
          f"({'built' if built else 'found built'}); card {limit}", file=sys.stderr)
    for c in run.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
