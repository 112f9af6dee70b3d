"""Fleet advisor quickstart on the PyTorch port: many tenants, one batched
service, on the card (`--device cpu` for the CPU).

Twin of `fleet_advisor.py`: every tenant's recommendation is exactly the
one a dedicated `DesignAdvisor` produces on its current workload, and
tenants on a common schema amortize sampling and SampleCF estimation
through the shared per-group cache and the cross-tenant batched prefetch.

    PYTHONPATH=src python examples/torch_fleet_advisor.py [--device cpu]
"""
import argparse
import dataclasses

from repro_torch.core import (AdvisorOptions, DesignAdvisor, WorkloadDelta,
                              make_scaled_workload, make_tpch_like)
from repro_torch.device import resolve_device
from repro_torch.serve.advisor_service import (AdvisorFleetService,
                                               FleetConfig, TenantBudget)

BUDGET = 2_000_000


def tenant_workload(schema, tid, n=14, seed=0):
    wl = make_scaled_workload(schema, n_statements=n, seed=seed)
    return dataclasses.replace(
        wl, statements=[dataclasses.replace(s, name=f"{tid}_{s.name}")
                        for s in wl.statements])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scale", type=float, default=0.1)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    shared_schema = make_tpch_like(scale=args.scale, seed=0)
    other_schema = make_tpch_like(scale=args.scale, seed=9)
    opt = AdvisorOptions.dtac(device=args.device)

    fleet = AdvisorFleetService(FleetConfig(slots=4))
    wls = {}
    for i in range(4):                      # four tenants, one schema
        tid = f"shop{i}"
        wls[tid] = tenant_workload(shared_schema, tid, seed=10 + i)
        fleet.register_tenant(tid, wls[tid], opt,
                              TenantBudget(max_statements=50))
    wls["solo"] = tenant_workload(other_schema, "solo", seed=99)
    fleet.register_tenant("solo", wls["solo"], opt)

    # interleaved traffic: every tenant drops two statements, then asks
    # for a fresh recommendation; the fleet batches the estimation work
    tickets = {}
    for tid, wl in wls.items():
        delta = WorkloadDelta(removed=(wl.statements[0].name,
                                       wl.statements[1].name))
        fleet.submit_delta(tid, delta)
        wls[tid] = wl.apply_delta(delta)
        tickets[tid] = fleet.submit_recommend(tid, BUDGET)
    fleet.run_until_drained()

    for tid, tk in tickets.items():
        rec = tk.result()
        fresh = DesignAdvisor(wls[tid], opt).recommend(BUDGET)
        exact = (rec.config == fresh.config and rec.cost == fresh.cost
                 and rec.used_bytes == fresh.used_bytes)
        print(f"  {tid}: cost {rec.cost:12.1f}  "
              f"latency {tk.latency * 1e3:6.1f}ms  "
              f"== fresh advisor: {exact}")
        assert exact

    s = fleet.stats
    print(f"\n{s['tenants']} tenants in {s['groups']} share groups, "
          f"{s['retired']} requests over {s['steps']} steps")
    print(f"cross-tenant prefetch: {s['prefetch_targets']} targets sized "
          f"in {s['prefetch_batches']} batches, "
          f"{s['prefetch_hits']} served from the shared cache; "
          f"{s['sampling_calls']} sample draws total")
    print(f"shop0 per-session SampleCF misses: "
          f"{fleet.tenant_stats('shop0')['samplecf_cache_misses']} "
          f"(estimation came from the shared cache)")


if __name__ == "__main__":
    main()
