"""GDICT's card path counts each row's distinct values with a hash set, not
a sort; its layout (`codec_bytes.gdict_plan`) depends on the row length.
Here, on the CPU, where `gdict_bytes` runs its plain version:

* the edge inputs of `torch_port_util.gdict_edge_stack` at every class
  boundary +-1 are `==` the JAX package's NumPy batch formula and its
  Pallas GDICT kernel (interpret mode; the rows with a negative value lie
  outside the Pallas kernel's envelope, where it routes to NumPy, so the
  non-negative rows are also held to the Pallas kernel alone), with m = 1
  and m = 801 too;
* `gdict_plan` picks each class at the boundaries, never fills a table
  past 4/7, fits each block's share in its shared memory, widens a cluster
  only while the rows leave SMs idle, and keeps global tables within the
  L2 budget.

Integer results: every comparison is exact.  test_torch_cuda_kernels.py
holds the kernel bit-equal to the plain version on the same inputs.
"""
import numpy as np
import pytest
import torch

from repro.core import compression as ref_comp
from repro.kernels import codec_bytes as ref_ck
from repro_torch.kernels import codec_bytes as cb
from torch_port_util import GDICT_EDGE_NS, gdict_edge_stack

H100_SMS = 132


def port_gdict(cols, widths):
    got = cb.gdict_bytes(torch.as_tensor(cols), torch.as_tensor(widths))
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    return got.numpy()


def assert_gdict_exact(cols, widths):
    got = port_gdict(cols, widths)
    np.testing.assert_array_equal(
        got, ref_comp.BATCH_KERNELS["GDICT"](cols, widths, 1))
    np.testing.assert_array_equal(
        got, ref_ck.batched_codec_bytes("GDICT", cols, widths, 1))
    nonneg = cols.min(axis=1) >= 0
    assert ref_ck.in_envelope(cols[nonneg], widths[nonneg])
    np.testing.assert_array_equal(
        got[nonneg],
        ref_ck.batched_codec_bytes("GDICT", cols[nonneg], widths[nonneg], 1))


@pytest.mark.parametrize("n", GDICT_EDGE_NS)
def test_gdict_edge_rows_equal_reference(n):
    cols, widths = gdict_edge_stack(n, n)
    assert_gdict_exact(cols, widths)


@pytest.mark.parametrize("n,row", [(60000, 1), (60000, 2), (74899, 2),
                                   (4681, 3), (1, 5)])
def test_gdict_single_row_equals_reference(n, row):
    """m = 1: three distinct values and all distinct at the main path's
    length, all distinct past the cluster class, INT64_MIN among the
    extremes at the block class's limit, a single INT64_MIN."""
    cols, widths = gdict_edge_stack(n, n + 1)
    assert_gdict_exact(cols[row:row + 1], widths[row:row + 1])


@pytest.mark.parametrize("n", [100, 4682])
def test_gdict_801_rows_equal_reference(n):
    """m = 801 (the advisor's widest stack) of the edge rows over again."""
    cols, widths = gdict_edge_stack(n, 7)
    reps = -(-801 // len(cols))
    cols = np.tile(cols, (reps, 1))[:801]
    widths = np.tile(widths, reps)[:801]
    assert_gdict_exact(cols, widths)


def slots_of(n):
    return 1 << cb.gdict_plan(1, n, H100_SMS).log_slots


@pytest.mark.parametrize("n,route", [
    (1, "block"), (4681, "block"), (4682, "cluster"), (9362, "cluster"),
    (9363, "cluster"), (60000, "cluster"), (74898, "cluster"),
    (74899, "global"), (1 << 20, "global")])
def test_gdict_plan_classes(n, route):
    for m in (1, 11, 132, 801):
        plan = cb.gdict_plan(m, n, H100_SMS)
        assert plan.route == route
        slots = 1 << plan.log_slots
        assert 7 * n <= 4 * slots and slots >= 64     # at most 4/7 full
        assert slots == 64 or 2 * slots < 7 * n       # the least such power
        if route == "block":
            assert slots <= cb.GDICT_BLOCK_SLOTS and plan.parts == 1
            assert plan.scratch_bytes == 0
        elif route == "cluster":
            assert slots // plan.parts <= cb.GDICT_SHARE_SLOTS
            assert plan.parts in (1, 2, 4, 8) and plan.scratch_bytes == 0
        else:
            assert plan.parts == cb.GDICT_MAX_CLUSTER
            assert 1 <= plan.tables <= min(m, H100_SMS // plan.parts)
            assert plan.scratch_bytes == plan.tables * slots * 8
            assert plan.tables == 1 or \
                plan.scratch_bytes <= cb.GDICT_L2_TABLE_BYTES


@pytest.mark.parametrize("m,n,parts", [
    (11, 60000, 8),       # the main path: 8 x 128 KB, 88 blocks
    (801, 60000, 8),      # the table needs 8 blocks however many rows
    (1, 4682, 8), (17, 4682, 8), (33, 4682, 4), (65, 4682, 4),
    (66, 4682, 2), (131, 4682, 2), (132, 4682, 1),  # rows fill the card
    (801, 9362, 1),
    (11, 9363, 8), (200, 9363, 2)])
def test_gdict_plan_cluster_size(m, n, parts):
    """Like NS: the fewest blocks that hold the table, doubled while the
    rows alone leave SMs idle, up to 8."""
    assert cb.gdict_plan(m, n, H100_SMS).parts == parts


def test_gdict_plan_global_tables_fit_l2():
    # 2 MB tables: 16 clusters of 8 blocks in flight (32 MB), fewer rows
    # fewer tables
    assert cb.gdict_plan(801, 74899, H100_SMS).tables == 16
    assert cb.gdict_plan(801, 74899, 120).tables == 15
    assert cb.gdict_plan(11, 74899, H100_SMS).tables == 11
    # a table larger than the budget: one at a time
    assert cb.gdict_plan(3, 1 << 23, H100_SMS).tables == 1
    assert slots_of(1 << 23) * 8 > cb.GDICT_L2_TABLE_BYTES
