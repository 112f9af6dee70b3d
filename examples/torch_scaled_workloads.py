"""Workload compression on the PyTorch port: advising on 10k+ statements.

Twin of `scaled_workloads.py`: a compressed recommend at 10k statements
with its error certificate checked against the true full-workload cost
(`chunked_config_costs`), the exact-parity contract (budget None or >= n
is bit-identical to the plain advisor), and a compressed `AdvisorSession`
under drift.  Runs on the card (`--device cpu` for the CPU).

    PYTHONPATH=src python examples/torch_scaled_workloads.py [--device cpu]
"""
import argparse
import dataclasses
import time

from repro_torch.core import (AdvisorOptions, AdvisorSession, DesignAdvisor,
                              WorkloadDelta, base_configuration,
                              chunked_config_costs, make_scaled_workload,
                              make_tpch_like)
from repro_torch.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scale", type=float, default=0.3)
    ap.add_argument("--statements", type=int, default=10_000)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    schema = make_tpch_like(scale=args.scale, z=0, seed=0)
    wl = make_scaled_workload(schema, n_statements=args.statements, seed=0)
    plain = AdvisorOptions(device=args.device)
    budget = 0.3 * sum(DesignAdvisor(wl, plain).sizes.size(i)
                       for i in base_configuration(schema).indexes)

    # 1. compressed recommend + certified error bound
    opts = AdvisorOptions(compression_budget=128, device=args.device)
    t0 = time.perf_counter()
    adv = DesignAdvisor(wl, opts)
    rec = adv.recommend(budget)
    wall = time.perf_counter() - t0
    true_cost = float(chunked_config_costs(
        wl, adv.inner.sizes, [rec.config], device=dev)[0])
    print(f"compressed: {rec.n_statements_full} statements -> "
          f"{rec.n_representatives} representatives in {wall:.2f}s")
    print(f"  compressed cost {rec.cost:.1f}  true cost {true_cost:.1f}  "
          f"certified bound {rec.compression_error_bound:.1f} "
          f"({rec.compression_error_rel:.1%} rel)")
    assert abs(true_cost - rec.cost) <= rec.compression_error_bound + 1e-9

    # 2. exact-parity contract on a small slice
    wl_small = make_scaled_workload(schema, n_statements=200, seed=0)
    rec_full = DesignAdvisor(wl_small, plain).recommend(budget)
    rec_off = DesignAdvisor(wl_small, dataclasses.replace(
        plain, compression_budget=None)).recommend(budget)
    rec_big = DesignAdvisor(wl_small, dataclasses.replace(
        plain, compression_budget=10 ** 9)).recommend(budget)
    assert (rec_off.config, rec_off.cost) == (rec_full.config, rec_full.cost)
    assert (rec_big.config, rec_big.cost) == (rec_full.config, rec_full.cost)
    print("exact parity: budget None / >= n match the plain advisor "
          "bit-for-bit")

    # 3. compressed session under drift
    session = AdvisorSession(wl, opts)
    session.recommend(budget)
    names = [s.name for s in wl.statements[:4]]
    session.apply(WorkloadDelta(
        reweighted=tuple((n, 1.0001) for n in names)))   # tiny reweight
    session.recommend(budget)
    extra = make_scaled_workload(schema, n_statements=10, seed=99)
    session.apply(WorkloadDelta(added=tuple(
        dataclasses.replace(s, name=f"drift{i}")
        for i, s in enumerate(extra.statements[:5]))))   # structural drift
    session.recommend(budget)
    st = session.stats
    print(f"session: {st['rounds']} rounds, "
          f"{st['compression_rebuilds']} rebuilds, "
          f"{st['compression_reweights']} reweight fast paths, "
          f"{st['compression_bypasses']} bypasses")


if __name__ == "__main__":
    main()
