"""Online advisor session on the PyTorch port: continuous retuning under a
drifting workload.

Twin of `online_advisor.py`: drives `repro_torch.core.AdvisorSession`
through a drifting TPC-H-like workload and prints, per drift round, the
re-advise latency, what a from-scratch `DesignAdvisor` would have cost,
and the estimated runtime improvement of the recommended design.  Runs on
the card (`--device cpu` for the CPU).

    PYTHONPATH=src python examples/torch_online_advisor.py [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np

from repro_torch.core import (AdvisorOptions, AdvisorSession, DesignAdvisor,
                              WorkloadDelta, base_configuration,
                              make_scaled_workload, make_tpch_like)
from repro_torch.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scale", type=float, default=0.3)
    ap.add_argument("--statements", type=int, default=120)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    schema = make_tpch_like(scale=args.scale, z=0, seed=0)
    workload = make_scaled_workload(schema, n_statements=args.statements,
                                    seed=0)
    opts = AdvisorOptions.dtac(device=args.device)
    base_size = sum(DesignAdvisor(workload, opts).sizes.size(i)
                    for i in base_configuration(schema).indexes)
    budget = 0.25 * base_size

    session = AdvisorSession(workload, opts)
    t0 = time.perf_counter()
    rec = session.recommend(budget)
    print(f"cold build: {time.perf_counter() - t0:.2f}s  "
          f"improvement {rec.improvement:.1%}  "
          f"indexes {len(rec.config.indexes)}")

    # a pool of fresh statements to drift in
    drift = [dataclasses.replace(s, name=f"new{i:03d}") for i, s in
             enumerate(make_scaled_workload(schema, n_statements=120,
                                            seed=42).statements)]
    rng = np.random.default_rng(1)
    wl_cur = workload
    k = 0
    for rnd in range(6):
        names = [s.name for s in wl_cur.statements]
        if rnd % 2 == 0:   # churn round: statements enter and leave
            removed = tuple(rng.choice(names, size=3, replace=False))
            added = tuple(drift[k:k + 3])
            k += 3
        else:              # reweight round: the mix shifts
            removed, added = (), ()
        survivors = [n for n in names if n not in set(removed)]
        reweighted = tuple(
            (n, float(rng.uniform(0.5, 2.0)))
            for n in rng.choice(survivors, size=6, replace=False))
        delta = WorkloadDelta(added=added, removed=removed,
                              reweighted=reweighted)
        wl_cur = wl_cur.apply_delta(delta)

        t0 = time.perf_counter()
        session.apply(delta)
        rec = session.recommend(budget)
        t_session = time.perf_counter() - t0

        t0 = time.perf_counter()
        fresh = DesignAdvisor(wl_cur, opts).recommend(budget)
        t_fresh = time.perf_counter() - t0
        tag = "churn   " if added else "reweight"
        match = "ok" if (rec.config == fresh.config
                         and rec.cost == fresh.cost) else "DIVERGED"
        print(f"round {rnd} [{tag}]  session {t_session * 1000:6.0f}ms  "
              f"fresh {t_fresh * 1000:6.0f}ms  "
              f"({t_fresh / t_session:4.1f}x)  "
              f"improvement {rec.improvement:.1%}  parity {match}")

    stats = session.stats
    print(f"\nsession stats after {stats['rounds']} rounds: "
          f"{stats['replay_hits']} decisions replayed, "
          f"{stats['replay_verified']} verified after group deltas, "
          f"{stats['replay_misses']} re-scored; "
          f"{stats['samplecf_cache_hits']} SampleCF cache hits, "
          f"{stats['selection_hits']} per-query selections reused")


if __name__ == "__main__":
    main()
