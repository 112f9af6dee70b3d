"""The replace scorer's float32 step totals in XLA's sum order.

`cost_engine._score_replace_torch` sums `q_w @ new_q` in the order that
`_xla_sum_order` gives, the RID term in the form LLVM's contraction gives
each part of the loop.  Here it is held bit for bit to the JAX package's
`_jax_score_replace` on seeded random inputs (`scorer_args`) at:

* one kept secondary (the advisor's common case) on 40 query counts from
  1 to 4,095 and eight candidate counts, both sides of each class: m = 1,
  an interleave group (2-8; 5 and 6 cost apart), one load a lane (9+);
* 2, 3 and 4 kept secondaries, whose interleave count, costs and
  unroll limits differ, with the candidate counts on both sides of
  m (ns + 1) = 16, where LLVM stops unrolling the candidate loop and the
  RID form of the unrolled parts turns to "A" (8 kept secondaries are in
  `test_torch_scorer_order_grid_replace_mid.py`);
* the shape of the advisor's run on `make_scaled_workload(200, seed=1)`
  at scale 1.

Left open (ROADMAP Queue C) and so not held here: the shapes where XLA
unrolls both loops into scalar code (`_open`), where the form changes with
the query and the candidate; nine or more kept secondaries; m 2-8 beyond
~300 queries; and nq >= 4,096.
"""
import numpy as np
import pytest

from torch_port_util import scorer_bits_differ

NQ_1 = [1, 2, 3, 4, 5, 7, 8, 9, 12, 13, 14, 15, 16, 17, 18, 19, 20, 23, 24,
        28, 31, 32, 33, 38, 40, 47, 48, 49, 56, 63, 64, 65, 100, 127, 128,
        129, 135, 257, 1000, 4095]
NQ_S = [2, 3, 4, 5, 6, 7, 8, 9, 15, 16, 17, 20, 24, 38, 48, 63, 100, 135]
M_BY_NS = {1: (1, 2, 3, 5, 8, 9, 16), 2: (1, 2, 5, 6, 9, 16),
           3: (1, 3, 4, 5, 9), 4: (1, 3, 4, 9)}
CASES = [(nq, 1) for nq in NQ_1] + [(nq, ns) for ns in (2, 3, 4)
                                    for nq in NQ_S]


def _open(nq, m, ns) -> bool:
    """Both loops unrolled into scalar code: several candidates and little
    code (read off the dumps at nq 1-15, m 1-9, ns 1-9)."""
    return m >= 2 and m * nq * (11 + 13 * ns) <= 432


def _differs(nq, m, ns) -> bool:
    return scorer_bits_differ("rep", nq, m, ns,
                              np.random.default_rng([nq, m, ns])) > 0


@pytest.mark.parametrize("nq,ns", CASES)
def test_replace_scorer_bit_equal_reference(nq, ns):
    bad = [m for m in M_BY_NS[ns]
           if not _open(nq, m, ns) and _differs(nq, m, ns)]
    assert not bad, f"candidate counts {bad} differ at nq {nq}, ns {ns}"


def test_replace_scorer_bit_equal_reference_on_the_scaled_run():
    """(nq, m, ns) of the replace scorer's calls in that advisor run."""
    assert not _differs(135, 267, 1)
