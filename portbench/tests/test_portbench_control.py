"""Each cell's control comes out not correct, at the cell's widths, on the card.

The control is the nearest precision below the configuration's bf16: for
the serving cells the program's own int8 decode path, for the training
cells the reference computed with float8 products in the program's place
(``portbench/reference/lowp.py``). Each runs with a short window here; the
readings behind the limits (a dozen seeds and more at the full window)
are in PERF.md. Run on a card:

    python -m pytest -m gpu portbench/tests/test_portbench_control.py
"""

import shutil
import tempfile
from pathlib import Path

import pytest
import torch

from portbench.lib import faults, harness

pytestmark = pytest.mark.gpu
BENCH = harness.load_benchmark()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's widths")
    return torch.device("cuda", 0)


def _run(cell, seed, card, control):
    w, config, traffic = harness.resolve_cell(BENCH, cell)
    workdir = Path(tempfile.mkdtemp(prefix="portbench-control-"))
    try:
        run = harness.Run(w, config, traffic, seed, 5.0, False, card, workdir)
        run.control = control
        harness.driver_module(traffic).run(run)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return run


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("seed", [3_000_000_001, 3_000_000_002, 3_000_000_003])
def test_the_control_is_not_correct(cell, seed, card):
    run = _run(cell, seed, card, True)
    assert not run.correct, [(c.name, c.value, c.limit) for c in run.checks]


@pytest.mark.parametrize("seed", [3_000_000_004, 3_000_000_005, 3_000_000_006])
def test_replays_on_a_stale_batch_fail_the_window_judge(seed, card):
    # The step graph's replays train on their captured batch: the set-up
    # steps are sound, the window's path is not.
    with faults.planted("zr19-en.vocoder-train", "stale_batch"):
        run = _run("zr19-en.vocoder-train", seed, card, False)
    checks = {c.name: c for c in run.checks}
    assert checks["loss_gap"].ok and not checks["window_loss_gap"].ok
