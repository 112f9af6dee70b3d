"""Probe the greedy-step scorers' sum order where `_xla_sum_order` leaves
it open: count the totals that differ in bits from the JAX package's
scorers on seeded random inputs (`torch_port_util.scorer_args`).

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/probe_scorer_order.py

Prints one line a shape: the open class, (scorer, nq, m, ns) and how many
of its totals differ over the class's seeds.  Not a test: these classes are
listed in ROADMAP Queue C.
"""
import numpy as np

from torch_port_util import scorer_bits_differ

# open class: (seeds, shapes); its differences are rare at m 2-8 beyond
# ~300 queries, so that class gets more seeds
PROBES = {
    "unfused dot (nq >= 4,096)": (10, [
        ("sec", 4096, 40, 0), ("sec", 4096, 3, 0), ("rep", 4096, 9, 1)]),
    "both loops unrolled into scalar code": (10, [
        ("rep", 5, 2, 1), ("rep", 6, 2, 1), ("rep", 3, 2, 2)]),
    "replace scorer, 9-17 kept secondaries": (10, [
        ("rep", 2, 40, 10), ("rep", 17, 40, 12), ("rep", 18, 9, 9)]),
    "replace scorer, 18 or more kept secondaries": (10, [
        ("rep", 2, 40, 18), ("rep", 7, 40, 24)]),
    "replace scorer, m 2-8 beyond ~300 queries": (40, [
        ("rep", 350, 3, 2), ("rep", 350, 5, 2)]),
}


def differing(scorer, nq, m, ns, seeds):
    bad = sum(scorer_bits_differ(scorer, nq, m, ns,
                                 np.random.default_rng([nq, m, ns, seed]))
              for seed in range(seeds))
    return bad, m * seeds


def main():
    for cls, (seeds, shapes) in PROBES.items():
        for shape in shapes:
            bad, n = differing(*shape, seeds)
            print(f"{cls}: {shape}: {bad} of {n} totals differ")


if __name__ == "__main__":
    main()
