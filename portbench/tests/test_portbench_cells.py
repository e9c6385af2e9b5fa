"""Each driver end to end on the CPU at small widths, sound and with faults planted.

The look for a card is skipped (the drivers take a ``Run`` on the CPU,
where the program runs its kernels' plain versions); the rest of a run
happens: inputs from the seed, set-up, the window, the reference, the
judge with the cell's own limits. A planted fault in the timed path must
turn ``correct`` false: a step that leaves its state unchanged, half of
the batch left out (the mean taken over the rest), a token or an answer
altered where it is produced. (One card: no exchange between cards to
leave out.) The controls, which need the cell's sizes, are in
``test_portbench_control.py``.
"""

import shutil

import pytest
import torch

from portbench.lib import faults, harness
from portbench.tests.small import small_run

SERVING = ["zr19-en.serve-open", "jvs-ja.serve-batch"]
TRAINING = ["zr19-en.vocoder-train"]
ALL = {"judge_requests": 1000}  # every finished request judged


def _drive(cell, seed=7, seconds=1.0, traffic=None):
    torch.set_num_threads(2)
    run = small_run(cell, seed=seed, seconds=seconds, traffic=traffic)
    try:
        harness.driver_module(run.traffic).run(run)
    finally:
        shutil.rmtree(run.workdir, ignore_errors=True)
    return run


# Numbers whose limits were set from the cell's full size on the card: at
# these widths on the CPU a single flipped near tie can pass them.
AT_FULL_SIZE = {"flip_ppm", "loss_gap", "grad_gap", "change_gap", "window_loss_gap",
                "window_grad_gap", "window_change_gap"}


@pytest.mark.parametrize("cell", SERVING + TRAINING)
def test_a_sound_run_passes_its_exact_checks(cell):
    run = _drive(cell, traffic=ALL)
    assert run.window_start is not None and run.attempted > 0 and run.failed == 0
    assert all(v > 0 for v in run.e2e.values())
    exact = [c for c in run.checks if c.name not in AT_FULL_SIZE]
    assert exact and all(c.ok for c in exact), [(c.name, c.value, c.limit) for c in exact]
    assert all(c.value < 1e5 for c in run.checks if c.name in AT_FULL_SIZE)


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", SERVING + TRAINING)
def test_a_planted_fault_is_not_correct(cell, fault):
    with faults.planted(cell, fault):
        run = _drive(cell, traffic=ALL)
    assert not run.correct


def test_the_cpc_driver_runs_and_feeds_the_reference_draws():
    # Its cell is not in BENCHMARK.json (PERF.md, Open questions): no limits
    # are set for its judged numbers yet, only its feed's.
    run = _drive("jvs-ja.cpc-train")
    checks = {c.name: c for c in run.checks}
    assert run.attempted > 0 and run.e2e["cpc_frames_per_s"] > 0
    assert checks["feed_off"].ok and {"loss_gap", "grad_gap", "change_gap"} <= set(checks)
