"""Readings behind the benchmark's limits and rates, many runs in one process.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 --seconds 10 [--control]
    python3 portbench/readings.py --workload <cell> --rates 2,4,8 --seconds 20 --seed 7

The first form runs the cell's driver once per seed, as the program
(the lower readings of each judged number) or, with ``--control``, as the
cell's control (the upper readings): for the serving cells the program's
own int8 decode path, for the training cells the reference computed with
float8 products in the program's place. The second runs an open-loop cell
at each arrival rate and prints its backlog over time, for the sweep that
finds the highest rate the server sustains. Each run prints one JSON line.
``--set key=value`` overrides a key of the traffic file, ``--trace``
adds the per-layer metrics of a traced window, ``--fault`` plants one
of ``portbench/lib/faults.py``'s faults in the timed path, and
``--stages`` judges only the named stages of a training cell. A cell
that has only its traffic file (not yet in ``BENCHMARK.json``) runs too. The benchmark's own runs
do not run either.
"""

import argparse
import copy
import gc
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def one_run(cell, config, traffic, seed, seconds, control, device, trace=False, fault=None,
            stages=None):
    import contextlib

    import torch

    from portbench.lib import faults, harness

    workdir = Path(tempfile.mkdtemp(prefix="portbench-readings-"))
    try:
        run = harness.Run(cell, config, traffic, seed, seconds, trace, device, workdir)
        run.control = control
        if stages:
            run.judge_stages = stages
        t = time.perf_counter()
        with faults.planted(cell["name"], fault) if fault else contextlib.nullcontext():
            harness.driver_module(traffic).run(run)
        took = time.perf_counter() - t
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return run, took


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--rates", default="")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--fault", default=None, help="a fault of portbench/lib/faults.py")
    ap.add_argument("--stages", default="",
                    help="the training judge's stages to judge, e.g. window (default: all)")
    ap.add_argument("--set", action="append", default=[],
                    help="a traffic key=value (JSON value), e.g. epochs_per_dispatch=20")
    args = ap.parse_args(argv)

    import torch

    from portbench.lib import harness

    if not torch.cuda.is_available():
        sys.exit("portbench readings: no CUDA device")
    device = torch.device("cuda", 0)
    bench = harness.load_benchmark(ROOT)
    cell, config, traffic = harness.candidate_cell(bench, args.workload, ROOT)
    for item in args.set:
        key, _, value = item.partition("=")
        traffic[key] = json.loads(value)
    runs = []
    if args.rates:
        for rate in [float(r) for r in args.rates.split(",")]:
            t = copy.deepcopy(traffic)
            t["arrivals"]["rate_per_s"] = rate
            runs.append(({"rate_per_s": rate}, t, args.seed))
    else:
        runs = [({}, traffic, int(s)) for s in args.seeds.split(",")]
    for extra, t, seed in runs:
        run, took = one_run(cell, config, t, seed, args.seconds, args.control, device,
                            args.trace, args.fault, tuple(filter(None, args.stages.split(","))))
        layer = (harness.read_per_layer(run, harness.cell_metrics(bench, run.name, "per_layer"))
                 if args.trace else {})
        summary = run.summary
        line = dict(extra, workload=args.workload, seed=seed, control=args.control,
                    fault=args.fault,
                    seconds=args.seconds, took_s=took, e2e=run.e2e, attempted=run.attempted,
                    failed=run.failed, correct=run.correct,
                    memory_peak_bytes=run.memory_peak_bytes,
                    checks={c.name: c.value for c in run.checks}, notes=run.notes,
                    backlog=run.counters.get("backlog"), per_layer=layer,
                    sets=args.set,
                    busy_window_s=None if summary is None else [summary.busy_s,
                                                                summary.window_s],
                    top_ops=None if summary is None else summary.top_ops(6))
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
