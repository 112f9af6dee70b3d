"""Fault-tolerant fleet walkthrough on the PyTorch port (twin of
`fault_tolerant_fleet.py`; on the card, `--device cpu` for the CPU): crash
a tenant, watch the circuit
breaker quarantine it, and see checkpoint restore bring it back with a
bit-identical recommendation.

Three acts:

1. **Transient faults retry themselves.**  A seeded `FaultInjector`
   makes the tenant's first delta fail with a transient `FaultError`;
   the fleet requeues it with deterministic step backoff and the retry
   applies bit-exactly (faulted calls fail BEFORE mutating the session).
2. **Crash, quarantine, restore.**  `crash_tenant` drops a tenant's
   live session mid-flight.  Queued tickets resolve with
   `TenantQuarantined`, submits are rejected — and `readmit_tenant`
   rebuilds the session from its last checkpoint (taken after every
   successful delta), after which its recommendation is exactly the one
   a fresh `DesignAdvisor` produces on its current workload.
3. **Deadline pressure degrades gracefully.**  A recommend that would
   outlive its step deadline is served immediately at a smaller
   workload-compression budget instead of failing — still an exact
   advisor run, with the compression error certificate attached.
4. **Kill the process, recover the fleet.**  The acts above survive
   in-memory session loss; this one survives the process itself.  With
   `store=DurableStore(dir)` every delta is journaled to a per-tenant
   write-ahead log before it is applied and periodically compacted into
   an atomic snapshot.  We drop every live object — the only survivor
   is the directory — scribble a torn tail onto one WAL for good
   measure, and `AdvisorFleetService.recover(dir)` rebuilds both
   tenants with recommendations bit-identical to a fresh
   `DesignAdvisor` on their pre-death workloads.

    PYTHONPATH=src python examples/torch_fault_tolerant_fleet.py [--device cpu]
"""
import argparse
import dataclasses
import tempfile
from pathlib import Path

from repro_torch.core import (AdvisorOptions, DesignAdvisor, DurableStore,
                              FaultInjector, FaultSpec, WorkloadDelta,
                              make_scaled_workload, make_tpch_like)
from repro_torch.device import resolve_device
from repro_torch.serve.advisor_service import (AdvisorFleetService,
                                               FleetConfig,
                                               TenantQuarantined)

BUDGET = 2_000_000


def tenant_workload(schema, tid, n=12, seed=0):
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
    schema = make_tpch_like(scale=args.scale, seed=0)
    opt = AdvisorOptions.dtac(device=args.device)
    faults = FaultInjector(seed=0, specs={
        "apply_delta": FaultSpec(at=(0,))})   # script act 1's fault
    fleet = AdvisorFleetService(
        FleetConfig(slots=2, degraded_budget=5), faults=faults)

    wls = {}
    for i in range(2):
        tid = f"shop{i}"
        wls[tid] = tenant_workload(schema, tid, seed=10 + i)
        fleet.register_tenant(tid, wls[tid], opt)

    # -- act 1: a transient fault, retried to an exact result ----------
    delta = WorkloadDelta(removed=(wls["shop0"].statements[0].name,))
    tk = fleet.submit_delta("shop0", delta)
    fleet.run_until_drained()
    wls["shop0"] = wls["shop0"].apply_delta(delta)
    print(f"act 1: delta applied after {tk.attempts} attempts "
          f"(retries={fleet.stats['retries']})")

    # -- act 2: crash, quarantine, checkpoint restore ------------------
    fleet.crash_tenant("shop0")
    try:
        fleet.submit_recommend("shop0", BUDGET)
    except TenantQuarantined as e:
        print(f"act 2: quarantined -> {e}")
    fleet.readmit_tenant("shop0")             # restore from checkpoint
    rk = fleet.submit_recommend("shop0", BUDGET)
    fleet.run_until_drained()
    rec = rk.result()
    fresh = DesignAdvisor(wls["shop0"], opt).recommend(BUDGET)
    assert (rec.config == fresh.config and rec.cost == fresh.cost
            and rec.used_bytes == fresh.used_bytes)
    print(f"act 2: restored in {fleet.restore_seconds[-1] * 1e3:.2f} ms; "
          f"post-restore recommendation == fresh DesignAdvisor "
          f"(cost {rec.cost:.1f}, {len(rec.config.indexes)} indexes)")

    # -- act 3: deadline pressure -> degraded-but-exact ----------------
    fleet.submit_recommend("shop0", BUDGET)   # hogs one of the few slots
    fleet.submit_recommend("shop1", BUDGET)
    late = fleet.submit_recommend("shop1", BUDGET, deadline_steps=1)
    fleet.run_until_drained()
    rec = late.result()
    print(f"act 3: degraded={late.degraded}; advised on "
          f"{rec.n_representatives}/{rec.n_statements_full} "
          f"representatives, certified cost error "
          f"<= {rec.compression_error_bound:.3f}")

    s = fleet.stats
    print(f"fleet: retries={s['retries']} quarantines={s['quarantines']} "
          f"restores={s['restores']} degraded={s['degraded_recommends']} "
          f"timeouts={s['timeouts']}")

    # -- act 4: kill the process, recover the fleet from disk ----------
    with tempfile.TemporaryDirectory(prefix="fleet_store_") as d:
        store = DurableStore(d, group_commit=2, compact_after=8)
        durable = AdvisorFleetService(FleetConfig(slots=2), store=store)
        for tid, wl in wls.items():
            durable.register_tenant(tid, wl, opt)
        extra = tenant_workload(schema, "extra", n=4, seed=99).statements
        for j, stmt in enumerate(extra):
            durable.submit_delta("shop0" if j % 2 else "shop1",
                                 WorkloadDelta(added=(stmt,)))
        durable.run_until_drained()
        mirror = {
            tid: durable.tenants[tid].session.workload for tid in wls}
        store.close()
        del durable, store            # "process death": nothing in
        #                               memory survives past this line
        with open(Path(d) / "wal" / "shop0.wal", "ab") as f:
            f.write(b"DWAL" + b"\xff" * 9)   # a torn final append
        recovered = AdvisorFleetService.recover(d)
        assert not recovered.recovery_errors
        for tid in wls:
            rk = recovered.submit_recommend(tid, BUDGET)
            recovered.run_until_drained()
            rec, ref = rk.result(), DesignAdvisor(
                mirror[tid], opt).recommend(BUDGET)
            assert (rec.config == ref.config and rec.cost == ref.cost
                    and rec.used_bytes == ref.used_bytes)
        rs = recovered.stats
        print(f"act 4: recovered {rs['tenants']} tenants from disk "
              f"(wal replay + snapshots; torn tails truncated="
              f"{rs['torn_tail_truncations']}); every post-restart "
              f"recommendation == fresh DesignAdvisor")


if __name__ == "__main__":
    main()
