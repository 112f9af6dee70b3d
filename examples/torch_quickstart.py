"""Quickstart on the PyTorch port: the paper's pipeline end-to-end on a
mini TPC-H, on the card (`--device cpu` for the CPU).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

from repro_torch.core import (AdvisorOptions, DesignAdvisor, IndexDef,
                              NodeKey, SampleManager, base_configuration,
                              make_tpch_like, make_tpch_workload, sample_cf)
from repro_torch.core.estimation_graph import EstimationPlanner
from repro_torch.core.samplecf import full_index_sizes
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scale", type=float, default=0.5)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    schema = make_tpch_like(scale=args.scale, z=0, seed=0)
    li = schema.tables["lineitem"]

    # 1. SampleCF: estimate a compressed index size from a 5% sample
    mgr = SampleManager(schema.tables, seed=0)
    idx = IndexDef("lineitem", ("l_shipdate", "l_returnflag"),
                   compression="LDICT")
    est = sample_cf(mgr, idx, f=0.05)
    _, true = full_index_sizes(li, idx, device=dev)
    print(f"SampleCF: est {est.est_bytes/1e3:.0f}KB vs true "
          f"{true/1e3:.0f}KB (err {est.est_bytes/true-1:+.1%}, cost "
          f"{est.cost_pages:.0f} pages)")

    # 2. Estimation plan (§5): deduce what you can, sample what you must
    targets = [NodeKey("lineitem", ("l_shipdate",), "NS"),
               NodeKey("lineitem", ("l_extendedprice",), "NS"),
               NodeKey("lineitem", ("l_shipdate", "l_extendedprice"), "NS")]
    planner = EstimationPlanner(schema.tables, device=dev)
    plan = planner.plan(targets, e=0.5, q=0.9)
    print(f"Estimation plan: f={plan.f}, {plan.n_sampled()} sampled, "
          f"{plan.n_deduced()} deduced, cost {plan.total_cost:.0f} pages")

    # 3. Full advisor (DTAc): compression-aware design under a budget
    wl = make_tpch_workload(schema, insert_weight=0.1)
    opts = AdvisorOptions(device=args.device)
    base_size = sum(DesignAdvisor(wl, opts).sizes.size(i)
                    for i in base_configuration(schema).indexes)
    rec = DesignAdvisor(wl, AdvisorOptions.dtac(device=args.device)
                        ).recommend(0.25 * base_size)
    print(f"DTAc @25% budget: {rec.improvement:.1%} improvement, "
          f"{len(rec.config.indexes)-len(schema.tables)} indexes "
          f"({sum(1 for i in rec.config.indexes if i.compression)} "
          "compressed)")
    for s in rec.steps[:5]:
        print("   ", s)


if __name__ == "__main__":
    main()
