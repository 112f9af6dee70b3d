"""The secondary scorer's float32 step totals in XLA's sum order at every
query count of a grid, for 8 to 40 candidates.

`cost_engine._score_secondary_torch` sums `q_w @ new_q` in the order that
`_xla_sum_order` gives: LLVM's vectorized query loop (a main loop of 8 or
4 lanes and 1-4 interleaved accumulators, a vector epilogue of 8, 4 or 2
lanes, the scalar remainder), read off XLA's dumps of the JAX package's
fused scorer.  Here it is held bit for bit to the JAX package's
`_jax_score_secondary` on seeded random inputs (`scorer_args`: paths that
win through the RID term) at every nq from 1 to 64 and at 72-4,095, for
m = 8 (the widest interleave group) and 9-40 (one load a lane; m 1-4 are
in `test_torch_scorer_order_grid.py`), and at the shapes of the advisor's
run on `make_scaled_workload(200, seed=1)` at scale 1.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_engine as ref_ce
from repro_torch.core import cost_engine as ce
from torch_port_util import f32_bits, scorer_args

NQ = list(range(1, 65)) + [72, 90, 127, 128, 135, 200, 257, 1000, 4095]
M = (8, 9, 16, 40)
# (nq, m) of the secondary scorer's calls in that advisor run
SCALED_RUN = [(135, 352), (135, 354), (35, 79)]


@pytest.mark.parametrize("nq,m", [(nq, m) for nq in NQ for m in M]
                         + SCALED_RUN)
def test_secondary_scorer_bit_equal_reference(nq, m):
    args = scorer_args("sec", nq, m, 0, np.random.default_rng([nq, m, 0]))
    got = ce._score_secondary_torch(*[torch.as_tensor(a) for a in args])
    want = ref_ce._jax_score_secondary(*[jnp.asarray(a) for a in args])
    np.testing.assert_array_equal(f32_bits(got.numpy()), f32_bits(want))
