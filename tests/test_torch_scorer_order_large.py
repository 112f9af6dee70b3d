"""The greedy-step scorers' float32 totals in XLA's sum order at 4,096
queries and more, and at 18 or more kept secondaries.

From 4,096 queries on, the float32 q_w reaches the 16 KiB past which XLA's
CPU fusion leaves a vector-matrix dot unfused: a loop fusion writes new_q
and the dot runs as XLA's tiled GEMV, one FMA chain a candidate over the
queries in order (`cost_engine._gemv_order`; a leftover candidate at
m % 8 == 1 rounds the products of its first tile of 8 queries before
adding them).  At 18 or more kept secondaries the replace scorer's query
loop is a chain whose RID form follows whether LLVM keeps the candidate
loop around an unrolled query loop.  Both are held here bit for bit to the
JAX package's `_jax_score_secondary` / `_jax_score_replace` on seeded
random inputs (`torch_port_util.scorer_args`), on both sides of 4,096
queries and at the advisor's lineitem count on a 10,000-statement scaled
workload (6,833).
"""
import numpy as np
import pytest

from torch_port_util import scorer_bits_differ

NQ = (4095, 4096, 4097, 6833, 8192)
M = (1, 2, 3, 9, 40)
NS = (1, 2, 4, 12, 18, 24)
# (nq, m, ns) below 4,096 queries at 18 or more kept secondaries: both
# sides of m (nq + 1) = 12 and of 9 queries, one query, 32 and 33 kept
# secondaries, and a long chain
KEPT_18 = [(2, 40, 18), (7, 40, 24), (1, 5, 24), (2, 3, 18), (3, 4, 18),
           (2, 5, 18), (2, 6, 24), (5, 2, 24), (9, 2, 20), (10, 40, 18),
           (9, 40, 32), (15, 40, 33), (21, 9, 40), (20, 3, 20),
           (135, 9, 18), (4095, 3, 18)]


def _differs(scorer, nq, m, ns) -> int:
    return scorer_bits_differ(scorer, nq, m, ns,
                              np.random.default_rng([nq, m, ns]))


@pytest.mark.parametrize("nq,m", [(nq, m) for nq in NQ for m in M])
def test_secondary_scorer_bit_equal_reference_past_the_fused_dot(nq, m):
    assert not _differs("sec", nq, m, 0)


@pytest.mark.parametrize("nq,m", [(nq, m) for nq in NQ for m in M])
def test_replace_scorer_bit_equal_reference_past_the_fused_dot(nq, m):
    bad = [ns for ns in NS if _differs("rep", nq, m, ns)]
    assert not bad, f"kept secondaries {bad} differ at nq {nq}, m {m}"


@pytest.mark.parametrize("nq,m,ns", KEPT_18)
def test_replace_scorer_bit_equal_reference_at_18_kept_secondaries(nq, m,
                                                                   ns):
    assert not _differs("rep", nq, m, ns)
