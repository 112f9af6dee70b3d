"""Probe the greedy-step scorers' sum order where `_xla_sum_order` leaves
it open, and watch it where the tests do not reach: count the totals that
differ in bits from the JAX package's scorers on seeded random inputs
(`torch_port_util.scorer_args`).

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/probe_scorer_order.py

Prints one line a shape: the class, (scorer, nq, m, ns) and how many of
its totals differ over the class's seeds.  Not a test: the open classes
are listed in ROADMAP Queue C; the watched ones should print 0.
"""
import numpy as np

from torch_port_util import scorer_bits_differ

# open class: (seeds, shapes); its differences are rare at m 2-8 beyond
# ~300 queries, so that class gets more seeds
PROBES = {
    "both loops unrolled into scalar code": (10, [
        ("rep", 5, 2, 1), ("rep", 6, 2, 1), ("rep", 3, 2, 2)]),
    "replace scorer, 9-17 kept secondaries": (10, [
        ("rep", 2, 40, 10), ("rep", 17, 40, 12), ("rep", 18, 9, 9)]),
    "replace scorer, m 2-8 beyond ~300 queries": (40, [
        ("rep", 350, 3, 2), ("rep", 350, 5, 2)]),
    "replace scorer, 33 or more kept secondaries from 22 queries": (10, [
        ("rep", 22, 9, 33), ("rep", 100, 3, 40)]),
}
# closed classes at sizes the tests do not reach: 0 differ
WATCHED = {
    "unfused dot (nq >= 4,096), above 8,192 queries": (3, [
        ("sec", 20000, 9, 0), ("sec", 12000, 1, 0), ("rep", 20000, 9, 1),
        ("rep", 10000, 17, 4)]),
    "unfused dot (nq >= 4,096)": (10, [
        ("sec", 4096, 40, 0), ("sec", 4096, 3, 0), ("rep", 4096, 9, 1)]),
    "replace scorer, 18 or more kept secondaries": (10, [
        ("rep", 2, 40, 18), ("rep", 7, 40, 24), ("rep", 20, 3, 20)]),
}


def differing(scorer, nq, m, ns, seeds):
    bad = sum(scorer_bits_differ(scorer, nq, m, ns,
                                 np.random.default_rng([nq, m, ns, seed]))
              for seed in range(seeds))
    return bad, m * seeds


def main():
    for kind, classes in (("open", PROBES), ("watched", WATCHED)):
        for cls, (seeds, shapes) in classes.items():
            for shape in shapes:
                bad, n = differing(*shape, seeds)
                print(f"{kind}: {cls}: {shape}: {bad} of {n} totals differ")


if __name__ == "__main__":
    main()
