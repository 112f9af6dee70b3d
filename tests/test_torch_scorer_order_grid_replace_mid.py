"""The replace scorer's float32 step totals in XLA's sum order at 16-40
queries, across candidate counts and kept secondaries.

`cost_engine._score_replace_torch` sums `q_w @ new_q` in the order that
`_xla_sum_order` gives.  Here it is held bit for bit to the JAX package's
`_jax_score_replace` on seeded random inputs (`scorer_args`) at:

* every (nq, m, ns) of nq 16, 18, 20, 23, 33 and 40, m 1, 2, 3, 4, 8, 9
  and 16 and ns 1, 2, 3 and 8: main loops of one to four accumulators,
  the vector epilogues of 8, 4 and 2 lanes and the scalar remainders
  after them, (16, 16, 8) and (18, 2, 2) among them;
* m = 4 at one kept secondary on the query counts of
  `test_torch_scorer_order_grid_replace.py` (an interleave group of unit
  cost), except where XLA unrolls both loops into scalar code (open,
  ROADMAP Queue C);
* 8 kept secondaries, with m 1, 2, 8 and 9 on both sides of
  m (ns + 1) = 16, on query counts from 2 to 135 (none of them where XLA
  unrolls both loops into scalar code);
* (4, 2, 5), where a query loop one instruction shorter at m = 2 would be
  unrolled: the rule keeps m = 2's one further unrolled query to one kept
  secondary.
"""
import numpy as np
import pytest

from torch_port_util import scorer_bits_differ

M = (1, 2, 3, 4, 8, 9, 16)
CROSS = [(nq, ns) for nq in (16, 18, 20, 23, 33, 40) for ns in (1, 2, 3, 8)]
NQ_M4 = [5, 7, 8, 9, 12, 13, 14, 15, 17, 19, 24, 28, 31, 32, 38, 47, 48, 49,
         56, 63, 64, 65, 100, 127, 128, 129, 135, 257, 1000, 4095]
NQ_NS8 = [2, 3, 4, 5, 6, 7, 8, 9, 15, 16, 17, 20, 24, 38, 48, 63, 100, 135]


def _differs(nq, m, ns) -> bool:
    return scorer_bits_differ("rep", nq, m, ns,
                              np.random.default_rng([nq, m, ns])) > 0


@pytest.mark.parametrize("nq,ns", CROSS)
def test_replace_scorer_bit_equal_reference_at_16_to_40_queries(nq, ns):
    bad = [m for m in M if _differs(nq, m, ns)]
    assert not bad, f"candidate counts {bad} differ at nq {nq}, ns {ns}"


@pytest.mark.parametrize("nq", NQ_M4)
def test_replace_scorer_bit_equal_reference_at_four_candidates(nq):
    assert not _differs(nq, 4, 1)


@pytest.mark.parametrize("nq", NQ_NS8)
def test_replace_scorer_bit_equal_reference_at_eight_kept(nq):
    bad = [m for m in (1, 2, 8, 9) if _differs(nq, m, 8)]
    assert not bad, f"candidate counts {bad} differ at nq {nq}, ns 8"


def test_replace_scorer_bit_equal_reference_at_m2_five_kept():
    assert not _differs(4, 2, 5)
