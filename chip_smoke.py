#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the advisor on one GPU, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. print the card (nvidia-smi name, power limit) and build the four
     hand-written kernels from the sources under src/repro_torch/kernels/
     (one nvcc per source, all started together);
  2. hold each kernel against its plain PyTorch version on the card on
     edge cases: NS and LDICT bit-equal; prob_within and fused_score within
     the stated tolerances, plus their two bitwise properties (prob
     consistency, K-pad invariance);
  3. run DTAc `DesignAdvisor.recommend` on make_tpch_like(scale=100) --
     6,000,000 lineitem rows, TPC-H SF1's count -- with
     make_tpch_workload(insert_weight=0.1) at a budget of 25 % of the base
     size, on backend="torch", device="cuda", with the launch counters
     zeroed just before and read just after; run it once more, keeping
     each kernel's largest inputs, and require the same result; then run
     the port's numpy backend and compare the two;
  4. hold each kernel against its plain version again on the largest
     inputs the main path gave it, and time both there.

Prints the per-phase wall times, launch counts, kernel times beside their
bounds, peak device memory, a JSON line of kernel records, the card line,
and last {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
# H100 SXM float32 rate outside the tensor cores; integer operations are
# counted at it too (the card's int32 / int64 rates are lower, so the
# bound stays a least time)
OPS_PER_S = 67e12
SF1_SCALE = 100                  # make_tpch_like(scale=100): 6M lineitem
P_ATOL = 1e-6                    # kernel vs plain p (erff vs torch.erf)
CMCS_RTOL = 1e-6                 # kernel vs plain cm / cs (same IEEE ops)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch import core as pt
    from repro_torch.kernels import (build, codec_bytes as cb,
                                     launch_counts, planner_score as ps,
                                     reset_launch_counts)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")

    # ---- phase 1: build ----------------------------------------------
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.3f} s "
          f"({', '.join(p.name for p in libs)})")

    # ---- phase 2: kernels against plain versions, edge cases ---------
    rng = np.random.default_rng(0)

    def t64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

    def codec_case(label, cols, widths, rpp):
        cols, widths = t64(cols), t64(widths)
        got_ns = cb.ns_bytes(cols, widths)
        want_ns = cb.ns_bytes_plain(cols, widths)
        got_ld = cb.ldict_bytes(cols, widths, rpp)
        want_ld = cb.ldict_bytes_plain(cols, widths, rpp)
        torch.cuda.synchronize()
        if not torch.equal(got_ns, want_ns):
            fail(f"NS != plain on {label}")
        if not torch.equal(got_ld, want_ld):
            fail(f"LDICT != plain on {label} (rpp {rpp})")

    n_cases = 0
    for label, shape, hi, rpp in [
            ("sf1 NS/LDICT rpp273", (126, 60000), 1 << 32, 273),
            ("sf1 rpp1638", (11, 60000), 1 << 20, 1638),
            ("rows of 15000", (7, 15000), 1 << 12, 546),
            ("m=1", (1, 5000), 1 << 40, 273),
            ("n=1", (5, 1), 1 << 8, 273),
            ("rpp 1", (3, 777), 1 << 16, 1),
            ("single page", (9, 1000), 1 << 16, 1638),
            ("last partial page", (4, 1000), 1 << 10, 273)]:
        cols = rng.integers(0, hi, size=shape)
        widths = rng.integers(1, 9, size=shape[0])
        codec_case(label, cols, widths, rpp)
        n_cases += 1
    big = rng.integers(0, 1 << 62, size=(6, 3000))
    big[0] = 1 << 32
    big[1] = (1 << 56) + rng.integers(0, 5, size=3000)
    big[2] = rng.integers(0, 3, size=3000) << 56
    codec_case(">= 2^32 and >= 2^56", big, [8] * 6, 273)
    neg = rng.integers(-(1 << 40), 1 << 40, size=(5, 2000))
    neg[0] = -1
    codec_case("negatives", neg, [1, 2, 4, 8, 8], 273)
    const = np.full((4, 3000), 7)
    const[1] = 0
    const[2] = (1 << 63) - 1
    codec_case("constant rows", const, [1, 1, 8, 4], 1638)
    n_cases += 3
    print(f"codec kernels: NS and LDICT bit-equal to plain on {n_cases} "
          f"cases")

    e, q = 0.5, 0.9

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    means = np.concatenate([rng.uniform(0.3, 2.5, 4096),
                            [0.2, 1 / 1.5, 1.0, 1.5, 1.6]])
    stds = np.concatenate([rng.uniform(1e-6, 0.8, 4096), np.zeros(5)])
    got = ps.prob_within(f32(means), f32(stds), e)
    want = ps.prob_within_plain(f32(means), f32(stds), e)
    err_p = float((got - want).abs().max())
    if err_p > P_ATOL:
        fail(f"prob_within differs from plain by {err_p} > {P_ATOL}")

    def rvs(nc, k, nf, seed):
        r = np.random.default_rng(seed)
        return (f32(r.uniform(0.85, 1.15, (nc, k, nf))),
                f32(r.uniform(0.0, 0.1, (nc, k, nf))),
                f32(r.uniform(0.95, 1.05, nc)),
                f32(r.uniform(0.9, 1.2, nc)),
                f32(r.uniform(0.9, 1.1, nc)))

    def fused_check(args, label):
        got = ps.fused_score(*args, e, q)
        want = ps.fused_score_plain(*args, e, q)
        for name, a, b in zip(("cm", "cs"), got[:2], want[:2]):
            if not torch.allclose(a, b, rtol=CMCS_RTOL, atol=0.0):
                fail(f"fused_score {name} differs from plain on {label}")
        perr = float((got[2] - want[2]).abs().max())
        if perr > P_ATOL:
            fail(f"fused_score p differs from plain by {perr} on {label}")
        for name, a, b in zip(("w6", "w9"), got[3:], want[3:]):
            if not torch.equal(a, b):
                fail(f"fused_score {name} differs from plain on {label}")
        # prob consistency: prob_within recomputes p bitwise
        m67, p9 = args[5], args[6]
        again = ps.prob_within(got[0], got[1], e)
        mask = m67 | p9
        if not torch.equal(got[2][mask], again[mask]):
            fail(f"prob consistency broken on {label}")
        return got

    nc, k, nf = 14, 11, 5
    m, s, dm, vt, mq = rvs(nc, k, nf, 1)
    r = np.random.default_rng(2)
    mask67 = torch.as_tensor(r.random((nc, nf)) < 0.5, device=dev)
    pre9 = ~mask67 & torch.as_tensor(r.random((nc, nf)) < 0.7, device=dev)
    extra = f32(r.uniform(1.0, 50.0, (nc, nf)))
    fused_check((m, s, dm, vt, mq, mask67, pre9, extra), "sf1 shape")
    base = fused_check((m[:, :2], s[:, :2], dm, vt, mq, mask67, pre9, extra),
                       "K=2")
    pad_m = torch.cat([m[:, :2], torch.ones_like(m[:, :3])], dim=1)
    pad_s = torch.cat([s[:, :2], torch.zeros_like(s[:, :3])], dim=1)
    padded = fused_check((pad_m, pad_s, dm, vt, mq, mask67, pre9, extra),
                         "K=2 padded to 5")
    for a, b in zip(base, padded):
        if not torch.equal(a, b):
            fail("K-pad invariance broken")
    print(f"planner kernels: prob_within within {P_ATOL} of plain "
          f"(max {err_p:.3g}); fused_score cm/cs rtol {CMCS_RTOL}, p atol "
          f"{P_ATOL}, winners equal; prob consistency and K-pad invariance "
          f"bitwise")

    # ---- phase 3: the main path at TPC-H SF1 -------------------------
    t0 = time.perf_counter()
    schema = pt.make_tpch_like(scale=SF1_SCALE, z=0.0, seed=0)
    wl = pt.make_tpch_workload(schema, insert_weight=0.1)
    base_bytes = sum(
        t.nrows * (sum(c.width for c in t.columns) + 4)
        for t in schema.tables.values())
    budget = 0.25 * base_bytes
    print(f"data: TPC-H-like scale={SF1_SCALE}, lineitem "
          f"{schema.tables['lineitem'].nrows} rows, "
          f"{len(wl.statements)} statements, budget {budget:.1f} B, "
          f"generated in {time.perf_counter() - t0:.3f} s")

    torch.cuda.reset_peak_memory_stats(dev)
    opts = pt.AdvisorOptions(backend="torch", device="cuda")
    reset_launch_counts()
    t0 = time.perf_counter()
    rec_t = pt.DesignAdvisor(wl, opts).recommend(budget)
    torch.cuda.synchronize()
    wall_t = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")

    # a second torch run keeps each kernel's largest inputs for phase 4;
    # it is not the measured run, since holding them raises peak memory
    captured = {}

    def capture(mod, name, size_of):
        orig = getattr(mod, name)

        def wrapper(*a, **kw):
            size = size_of(*a)
            if name not in captured or size > captured[name][0]:
                captured[name] = (size, a)
            return orig(*a, **kw)
        setattr(mod, name, wrapper)
        return orig

    originals = {
        (cb, "ns_bytes"): capture(cb, "ns_bytes", lambda c, w: c.numel()),
        (cb, "ldict_bytes"): capture(
            cb, "ldict_bytes", lambda c, w, rpp: c.numel()),
        (ps, "prob_within"): capture(
            ps, "prob_within", lambda mm, ss, ee: mm.numel()),
        (ps, "fused_score"): capture(
            ps, "fused_score", lambda mm, *rest: mm.numel()),
    }
    rec_c = pt.DesignAdvisor(wl, opts).recommend(budget)
    for (mod, name), fn in originals.items():
        setattr(mod, name, fn)
    if (rec_c.cost, rec_c.used_bytes, rec_c.steps) != \
            (rec_t.cost, rec_t.used_bytes, rec_t.steps):
        fail("a second torch/cuda recommend differs from the first")

    t0 = time.perf_counter()
    adv_n = pt.DesignAdvisor(wl, pt.AdvisorOptions(backend="numpy"))
    rec_n = adv_n.recommend(budget)
    wall_n = time.perf_counter() - t0

    for label, rec, wall in (("torch/cuda", rec_t, wall_t),
                             ("numpy", rec_n, wall_n)):
        ph = ", ".join(f"{k} {rec.phase_seconds[k]:.3f}"
                       for k in pt.advisor.PHASES)
        print(f"recommend {label}: {wall:.3f} s ({ph}); plan f="
              f"{rec.estimation_plan.f} sampled={rec.n_sampled} "
              f"deduced={rec.n_deduced}; cost={rec.cost!r} "
              f"used_bytes={rec.used_bytes!r}; {len(rec.config.indexes)} "
              f"indexes, {len(rec.steps)} steps")
    if (rec_t.estimation_plan.f, rec_t.n_sampled, rec_t.n_deduced) != \
            (rec_n.estimation_plan.f, rec_n.n_sampled, rec_n.n_deduced):
        fail("torch and numpy plans differ")
    for what, a, b in (("cost", rec_t.cost, rec_n.cost),
                       ("used_bytes", rec_t.used_bytes, rec_n.used_bytes)):
        if not math.isclose(a, b, rel_tol=1e-6):
            fail(f"{what} differs beyond rtol 1e-6: {a!r} vs {b!r}")
    cfg_t = {i.label() for i in rec_t.config.indexes}
    cfg_n = {i.label() for i in rec_n.config.indexes}
    if cfg_t != cfg_n:
        # accepted only as an equal-cost tie: the numpy pipeline prices the
        # torch choice at its own optimum's cost
        judged = adv_n.build_engine().config_cost(rec_t.config)
        print(f"configs differ: torch-only {sorted(cfg_t - cfg_n)}; "
              f"numpy-only {sorted(cfg_n - cfg_t)}; numpy prices the torch "
              f"config at {judged!r} vs its own {rec_n.cost!r}")
        if not math.isclose(judged, rec_n.cost, rel_tol=1e-6):
            fail("configurations differ and are not an equal-cost tie")
    else:
        print("configs equal")
    if rec_t.steps != rec_n.steps:
        print(f"greedy steps differ ({len(rec_t.steps)} torch, "
              f"{len(rec_n.steps)} numpy); torch's last three: "
              f"{rec_t.steps[-3:]}")
    print(f"launches on the main path: {json.dumps(launches)}")
    print(f"peak device memory (max_memory_allocated): {peak} B")

    # ---- phase 4: kernels at the main path's inputs ------------------
    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            torch.cuda.synchronize()
            runs.append(a.elapsed_time(b) / reps)
        return float(np.median(runs))

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def ldict_ops(m_rows, n, rpp):
        # per page: a comparison sort of `rows` keys needs at least
        # log2(rows!) comparisons, then rows - 1 adjacent compares
        pages = [rpp] * (n // rpp) + ([n % rpp] if n % rpp else [])
        return m_rows * sum(math.lgamma(r + 1) / math.log(2) + r
                            for r in pages)

    # operations each function needs on its inputs: NS ~6 integer ops per
    # value (significant bytes, two mins, 2s+1, the sum); one probability
    # ~40 float ops (two erf polynomials, divisions, the difference); the
    # Goodman fold 6 float ops per (candidate, child, fraction)
    def ops_of(name, args):
        if name == "ns_bytes":
            return 6 * args[0].numel()
        if name == "ldict_bytes":
            return ldict_ops(args[0].shape[0], args[0].shape[1], args[2])
        if name == "prob_within":
            return 40 * args[0].numel()
        nc_, k_, nf_ = args[0].shape
        return nc_ * nf_ * (6 * k_ + 40 + 2)

    records = []
    sources = {"ns_bytes": ("src/repro_torch/kernels/csrc/codec_bytes.cu",
                            "src/repro/kernels/codec_bytes.py:95"),
               "ldict_bytes": ("src/repro_torch/kernels/csrc/codec_bytes.cu",
                               "src/repro/kernels/codec_bytes.py:113"),
               "prob_within": ("src/repro_torch/kernels/csrc/planner_score.cu",
                               "src/repro/kernels/planner_score.py:98"),
               "fused_score": ("src/repro_torch/kernels/csrc/planner_score.cu",
                               "src/repro/kernels/planner_score.py:138")}
    for name in ("ns_bytes", "ldict_bytes", "prob_within", "fused_score"):
        _, args = captured[name]
        fn = getattr(cb if name in ("ns_bytes", "ldict_bytes") else ps, name)
        plain = getattr(cb if name in ("ns_bytes", "ldict_bytes") else ps,
                        f"{name}_plain")
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        if name in ("ns_bytes", "ldict_bytes"):
            if not torch.equal(got, want):
                fail(f"{name} != plain on the main path's inputs")
            err = float((got - want).abs().max())
            out_b = got.numel() * 8
            in_t = args[:2]
            shape = tuple(args[0].shape)
            extra = f" rpp {args[2]}" if name == "ldict_bytes" else ""
        elif name == "prob_within":
            err = float((got - want).abs().max())
            if err > P_ATOL:
                fail(f"prob_within differs from plain by {err} on the main "
                     "path's inputs")
            out_b = got.numel() * 4
            in_t = args[:2]
            shape = tuple(args[0].shape)
            extra = ""
        else:
            err = max(float((a - b).abs().max()) for a, b in
                      zip(got[:3], want[:3])) if got[0].numel() else 0.0
            if err > P_ATOL or not all(torch.equal(a, b) for a, b in
                                       zip(got[3:], want[3:])):
                fail("fused_score differs from plain on the main path's "
                     "inputs")
            out_b = nbytes(*got)
            in_t = args[:8]
            shape = tuple(args[0].shape)
            extra = ""
        reps = 20 if name in ("ns_bytes", "ldict_bytes") else 200
        ms = time_ms(lambda: fn(*args), reps)
        plain_ms = time_ms(lambda: plain(*args), max(5, reps // 10))
        bytes_ms = (nbytes(*in_t) + out_b) / HBM_BYTES_PER_S * 1e3
        ops_ms = ops_of(name, args) / OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        print(f"kernel {name}: shape {shape}{extra}: {ms:.4f} ms per call "
              f"(plain {plain_ms:.4f} ms, bound {bound_ms:.6g} ms by "
              f"{bound_by}; bytes {bytes_ms:.6g} ms, operations "
              f"{ops_ms:.6g} ms), launches {launches[name]}, "
              f"max_abs_err {err}")
        records.append({"name": name, "route": "cuda",
                        "source": sources[name][0],
                        "replaces": sources[name][1],
                        "launches": launches[name], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None})
    # the timing launches above count too; the record keeps the main path's
    print(json.dumps({"kernels": records}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
