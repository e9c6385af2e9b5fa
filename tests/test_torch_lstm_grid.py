"""The grid LSTM pair's plan (``csrc/lstm_grid.cu`` on ``csrc/grid_common.cuh``).

The kernels split the batch into row groups of 8-row multiples, each with
its own blocks on an equal share of the SMs; a block keeps its 4 U i/f/g/o
columns of wh (forward, K = H) or its U rows of wh (backward, K = 4H) in
shared memory. ``lstm_scan.group_plan`` mirrors the plan on 132 SMs (a card
test holds the kernel's own plan against it); here, the plans of the widths
and batches the port runs, their shared memory against one H100 block, the
K chunks past the widths whose slice fits whole, and the refusals.
"""

import pytest

from torch_port_util import module_time_limit, time_limit  # noqa: F401
from vectorquantizedcpc_tpu_torch.ops import grid_plan
from vectorquantizedcpc_tpu_torch.ops import gru_train as gt
from vectorquantizedcpc_tpu_torch.ops import lstm_scan as ls

TIME_LIMIT_S = 60  # each test's own limit (torch_port_util.time_limit)


@pytest.mark.parametrize(
    "batch, hidden, groups, rows, blocks, units",
    [
        (64, 512, 8, 8, 16, 32),  # the CPC step at dim_cpc_context=512
        (16, 512, 2, 8, 64, 8),  # the export's batch of 16
        (32, 512, 4, 8, 32, 16),  # a rank's share at mesh_data=2
        (3, 512, 1, 8, 128, 4),  # one partial group
        (1, 512, 1, 8, 128, 4),
        (64, 37, 8, 8, 13, 3),  # not a multiple of 8
        (64, 36, 8, 8, 12, 3),
        (16, 37, 2, 8, 37, 1),
        (64, 1600, 1, 64, 124, 13),  # one group of all rows holds wh whole
    ],
)
def test_plan_holds_wh_whole(batch, hidden, groups, rows, blocks, units):
    """Both directions take the same groups, each block's slice of wh whole
    (K chunk = H forward, 4H backward) within one H100 block's shared
    memory; the groups cover the batch and the blocks cover H."""
    for backward, k in ((False, hidden), (True, 4 * hidden)):
        plan = ls.group_plan(batch, hidden, backward)
        assert tuple(plan[:4]) == (groups, rows, blocks, units)
        assert plan.chunk == k and plan.smem <= ls.SMEM_LIMIT
        assert plan.smem == ls.grid_layout_bytes(rows, hidden, units, backward)
        assert (groups - 1) * rows < batch <= groups * rows
        assert (blocks - 1) * units < hidden <= blocks * units
        assert groups * blocks <= grid_plan.SMS


def test_plan_at_b64_h512_reads_eight_rows_a_step():
    """B 64, H 512: 8 groups x 16 blocks x 32 units. A forward block holds
    its 4 x 32 columns of wh (128 KB of the 185,920 B it takes) and reads
    its group's 8 rows of h a step, 16 KB of tagged words, not all 64 rows;
    a backward block holds its 32 rows of wh (128 KB) and reads 8 rows of
    dgates, 32 KB."""
    fwd, bwd = ls.group_plan(64, 512), ls.group_plan(64, 512, backward=True)
    assert (fwd.smem, bwd.smem) == (185920, 148672)
    assert fwd.rows == bwd.rows == 64 // fwd.groups == 8
    assert 4 * fwd.units * 512 * 2 == bwd.units * 4 * 512 * 2 == 128 * 1024
    assert fwd.rows * 512 * 4 == 16 * 1024 and bwd.rows * 4 * 512 * 2 == 32 * 1024


@pytest.mark.parametrize("batch, hidden", [(16, 2048), (64, 2048), (64, 4096), (16, 8192)])
def test_plan_streams_k_chunks_past_the_whole_slice(batch, hidden):
    """Where not even one group's slice of wh fits a block, the plan keeps
    one group and stages K in the widest multiple of 16 that fits: one more
    chunk of 16 would not."""
    for backward, k in ((False, hidden), (True, 4 * hidden)):
        plan = ls.group_plan(batch, hidden, backward)
        assert plan.groups == 1 and 16 <= plan.chunk < k and plan.chunk % 16 == 0
        assert plan.smem <= ls.SMEM_LIMIT < ls.grid_layout_bytes(
            plan.rows, hidden, plan.units, backward, plan.chunk + 16)


@pytest.mark.parametrize(
    "batch, hidden, units, backward",
    [
        (64, 512, 1, False),  # 512 blocks of one unit cannot all be resident
        (64, 16384, 0, False),  # the partial sums of 500 A rows outgrow a block
        (65536, 2048, 0, True),  # 65,536 rows' carries and tiles do not fit
    ],
)
def test_plan_refuses_a_grid_that_cannot_fit(batch, hidden, units, backward):
    with pytest.raises(ValueError):
        ls.group_plan(batch, hidden, backward, units=units)


def test_one_plan_for_both_scans():
    """The LSTM's plan is the GRU's at 4 gates without biases: the same
    function of grid_plan.py, so the GRU's plans stay as they were."""
    assert gt.group_plan(32, 896) == grid_plan.group_plan(3, True, 32, 896)
    assert tuple(gt.group_plan(32, 896)[:4]) == (4, 8, 32, 28)
    assert ls.group_plan(32, 896) == grid_plan.group_plan(4, False, 32, 896)
    # Four gates, no biases: 4 U columns forward, 4H-deep rows backward.
    assert ls.grid_layout_bytes(8, 96, 12, False) == grid_plan.layout_bytes(4, False, 8, 96, 12, False)
    assert gt.grid_layout_bytes(8, 96, 16, False) - grid_plan.layout_bytes(3, False, 8, 96, 16, False) \
        == 4 * 3 * 16  # the GRU's 3 U f32 biases
