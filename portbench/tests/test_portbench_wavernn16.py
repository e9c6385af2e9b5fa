"""The dual softmax cell (``jvs-ja-wavernn16.serve-batch``): its files, its judge, its counts.

On the CPU at small widths (``small.py``): the cell resolves its
configuration, traffic, driver and readers by name; a sound run passes
every check within the traffic file's limits, ``logit_gap_max`` included
(at these widths its largest reading over seeds 11-13 was 9.3e-05 of the
limit's 0.003); on the same seed each planted fault turns ``correct``
false, and the float8 control widens the gap (it fails the limit at the
cell's widths, on a card: ``test_portbench_control.py``); the new roofline
count matches a hand count at two shapes; the reference imports nothing of
the program.
"""

import ast
import shutil
from pathlib import Path

import pytest
import torch

from portbench.lib import harness
from portbench.metrics import mfu_wavernn16
from portbench.roofline import dual_decode, models, wavernn16
from portbench.tests.small import small_run

CELL = "jvs-ja-wavernn16.serve-batch"
ROOT = Path(__file__).resolve().parents[2]
ALL = {"judge_requests": 1000}


def _drive(fault=None, control=False, seed=11):
    torch.set_num_threads(2)
    run = small_run(CELL, seed=seed, traffic=ALL)
    run.traffic["fault"] = fault  # as ``readings.py --set fault=...`` sets it
    run.control = control
    try:
        harness.driver_module(run.traffic).run(run)
    finally:
        shutil.rmtree(run.workdir, ignore_errors=True)
    return run


def test_the_cell_resolves_its_files_and_readers():
    bench = harness.load_benchmark()
    cell, config, traffic = harness.resolve_cell(bench, CELL)
    assert config["conf"]["training_vocoder.model.network.rnnms.output"] == "dual16"
    assert config["reduced"] == ["corpus"] and traffic["driver"] == "serve_batch_dual"
    assert set(traffic["limits"]) == {"logit_gap_max", "pcm_off", "length_off"}
    e2e = {m["name"] for m in harness.cell_metrics(bench, CELL, "end_to_end")}
    layer = {m["name"] for m in harness.cell_metrics(bench, CELL, "per_layer")}
    assert e2e == {"served_audio_s_per_s", "setup_s"}
    assert layer == {"roofline.dual_decode.w16_batch", "mfu_wavernn16.serve_batch",
                     "device_idle.w16_batch", "span_ms.serving_launch.w16_batch",
                     "roofline.prenet_gru.w16_batch", "slot_fill.w16_batch",
                     "idle_under.serving_expand.w16_batch", "span_ms.serving_expand.w16_batch"}


@pytest.fixture(scope="module")
def sound():
    return _drive()


def test_a_sound_run_passes_its_exact_checks(sound):
    run = sound
    checks = {c.name: c for c in run.checks}
    assert run.attempted > 0 and run.failed == 0 and run.e2e["served_audio_s_per_s"] > 0
    assert set(checks) == {"logit_gap_max", "pcm_off", "length_off"}
    assert run.correct and all(c.ok for c in run.checks), [(c.name, c.value, c.limit)
                                                          for c in run.checks]


@pytest.mark.parametrize("fault", ["no_ct", "state_unchanged", "half_batch", "altered_token"])
def test_a_planted_fault_is_not_correct(sound, fault):
    # The sound run on the same seed is correct, so the fault is what the judge caught.
    run = _drive(fault)
    assert sound.correct
    assert not run.correct, [(c.name, c.value, c.limit) for c in run.checks]


def test_the_float8_control_widens_the_gap():
    # Its limit is set at the cell's widths, where the control fails it
    # (test_portbench_control.py, on a card); here its path runs and its
    # rounding shows against the program's on the same seed.
    program, control = _drive(), _drive(control=True)
    gap = {r: {c.name: c.value for c in r.checks} for r in (program, control)}
    assert gap[control]["pcm_off"] == gap[control]["length_off"] == 0
    assert gap[control]["logit_gap_max"] > gap[program]["logit_gap_max"]


@pytest.mark.parametrize("b,steps,frames", [(128, 5120, 32), (8, 16000, 100)])
def test_dual_decode_counts(b, steps, frames):
    call = dict(batch=b, steps=steps, hidden=896, classes=256, frames=frames)
    # per row and sample: h @ wh (896 x 2688), o1 and o3 (448 x 448), o2 and o4 (448 x 256)
    assert dual_decode.flops(**call) == 2 * b * steps * (896 * 2688 + 2 * 448 * 448
                                                         + 2 * 448 * 256)
    weights = 2 * (896 * 2688 + 2 * 448 * 448 + 2 * 448 * 256)
    vectors = 4 * (2688 + 2 * 2688 + 3 * 448 + 2 * 448 + 2 * 256)
    io = 2 * frames * b * 2688 + 4 * b * 896 + 8 * b + 4 * steps * b + 4 * b * 896
    assert dual_decode.n_bytes(**call) == weights + vectors + io
    assert dual_decode.least(call) == max(dual_decode.flops(**call) / 989e12,
                                          dual_decode.n_bytes(**call) / 3.35e12)
    assert "ar_decode_kernel" not in dual_decode.KERNELS[0]


def test_the_model_flops_and_the_mfu_reader():
    w = models.widths({})
    decode = 2 * (258 * 2688 + 896 * 2688 + 3 * 448 + 2 * (448 * 448 + 448 * 256))
    assert wavernn16.decode_per_sample(w) == decode
    assert wavernn16.served_per_sample(w) == decode + models.prenet_per_frame(w) / 160
    run = harness.Run({"name": "x"}, {}, {}, 1, 1.0, True, "cpu", None)
    assert mfu_wavernn16.read("mfu_wavernn16.serve_batch", run) is None

    class _S:
        window_s = 2.0

    class _T:
        summary = _S()

    run.tracer = _T()
    run.counters.update(conf={}, stats_traced={"samples_out": 1e9})
    want = 100 * 1e9 * wavernn16.served_per_sample(w) / 2.0 / 989e12
    assert mfu_wavernn16.read("mfu_wavernn16.serve_batch", run) == pytest.approx(want)


def test_the_reference_imports_nothing_of_the_program():
    tree = ast.parse((ROOT / "portbench/reference/wavernn16.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            assert all(a.name.split(".")[0] == "torch" for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            assert node.module.split(".")[0] == "torch"
    assert "vectorquantizedcpc" not in (ROOT / "portbench/reference/wavernn16.py").read_text()
