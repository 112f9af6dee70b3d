#!/usr/bin/env python3
"""Time the NS, GDICT, LDICT, PREFIX, RLE, prob_within, quantize,
dequantize and dequant-matmul kernels, the q8 gradient wire and the
planner of this checkout on one GPU.

    python3 chip_kernel_times.py

NS, LDICT, PREFIX and RLE (`kernels.codec_bytes.ns_bytes` /
`ldict_bytes` / `prefix_bytes` / `rle_bytes`) are timed on every distinct
input that the advisor runs of `chip_smoke.py` phases 3, 3b and 3c give
them (DTAc `recommend` at TPC-H SF1 size on the TPC-H workload, then on
10,000 statements with all five codecs and compression_budget 128, then
`staged_recommend` with the five codecs on the TPC-H workload), PREFIX
and RLE also at (801, 60000) int64, rpp 273, and NS at (11, 60000), values
below 2^32 from seed 0 (`"input": "seed 0"`); GDICT
(`kernels.codec_bytes.gdict_bytes`, on no advisor path) on every column of
the SF1 lineitem sample at f = 0.01 ((11, 60000), `chip_smoke.py` phase 4's
input), at (11, 60000) below 2^32 from seed 0, and on one row of 60,000
values of three distinct values and of all distinct ones;
`kernels.planner_score.prob_within` at (90,) float32 from seed 0 (the
planner's per-plan targets x fractions before the walk took it over); the
3b run's plan-phase seconds
(`Recommendation.phase_seconds["plan"]`) are kept, with those of a second
3b run and the split of a third one's (`cProfile` around
`DesignAdvisor.estimate_sizes`, cumulative seconds of the planner's parts
in either checkout); the single quantize call
(`kernels.quantize_blockwise.quantize_blockwise`, float32 input) at
(32000, 2048), (5632, 2048) and (2048,), on as many tensors as one
training step sends (2, 22 and 45), and at (32000, 2048) with 3/4 of the
rows zero and at (2048, 32000) with a tenth of the values subnormal
(where an IEEE division per element takes its slow path); the q8
gradient wire
(`train.step.q8_wire`) over one step's worth of TinyLlama-1.1B-shaped
random float32 gradients from seed 0 (201 tensors), and those tensors'
quantize as 201 single calls (and, where the checkout has it, as one
`quantize_blockwise_group` launch per wire bucket); the single dequantize
call (`kernels.quantize_blockwise.dequantize_blockwise`, float32 output)
at the q8 gradient wire's (32000, 2048) and (2048,) shapes, on as many
tensors as one training step sends (2 and 45), beside the one-call
broadcast multiply; dequant-matmul (`kernels.dequant_matmul`) at the
four shapes of `chip_smoke.py` phase 5c (TinyLlama-1.1B's MLP at M = 4
and 512), cycling through 22 layers' random q8 weights from seed 0,
beside float32 `torch.matmul` on the dequantized weight (TF32 off).
Each result is held against its plain version.  Every time is taken two
ways:

* per call: CUDA events around back-to-back calls, the host's first
  launch included; the median of 5 runs (as `chip_smoke.py` times);
* device time: the same calls enqueued behind `torch.cuda._sleep`, so no
  host gap falls between the events; the least of 3 runs.

It calls only entry points that the port's earlier checkouts have too
(the grouped quantize only where present), so two checkouts compare by
copying this file into each and running both on one card in turns (a,
b, b, a).  It prints the card's name and power limit, then one JSON
object.
"""
from __future__ import annotations

import cProfile
import json
import pstats
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

FIVE = ("NS", "GDICT", "LDICT", "PREFIX", "RLE")
# the codec kernels the advisor runs (GDICT is priced on the host)
CODECS = ("ns_bytes", "ldict_bytes", "prefix_bytes", "rle_bytes")
WIRE = (((32000, 2048), 2), ((2048,), 45))     # (shape, tensors a step)
# (shape, tensors, data): normal values; 3/4 of the rows zero (an
# embedding gradient's shape); a tenth of the values subnormal
QUANTIZE = (((32000, 2048), 2, "normal"), ((5632, 2048), 22, "normal"),
            ((2048,), 45, "normal"), ((32000, 2048), 2, "zero rows"),
            ((2048, 32000), 2, "subnormals"))
# the plan phase's parts, (file, function): target collection, graph build,
# sampling costs, the greedy (the record loop and the per-record scoring
# before the walk; packing, the walk and its read-back after), feasibility
# and assembly
PLAN_PARTS = (("advisor.py", "estimation_targets"),
              ("planner_engine.py", "_build_graph"),
              ("planner_engine.py", "_scost_matrix"),
              ("planner_engine.py", "_run"),
              ("planner_engine.py", "_torch_score"),
              ("planner_score.py", "fused_score"),
              ("planner_engine.py", "_walk"),
              ("planner_engine.py", "_pack"),
              ("planner_score.py", "planner_walk"),
              ("planner_engine.py", "_feasible_vec"),
              ("planner_engine.py", "_assemble_one"))
# phase 5c's dequant-matmul shapes (M, K, N) and TinyLlama-1.1B's layers
DMM = ((4, 2048, 5632), (4, 5632, 2048), (512, 2048, 5632),
       (512, 5632, 2048))
LAYERS = 22


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_kernel_times: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch import core as pt
    from repro_torch.kernels import codec_bytes as cb, quantize_blockwise as qb
    from repro_torch.kernels import dequant_matmul as dqm
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")

    def per_call_ms(fn, calls, reps=5):
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
            runs.append(a.elapsed_time(b) / (reps * calls))
        return float(np.median(runs))

    def device_ms(fn, calls, reps=5):
        fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(40_000_000)          # 4e7 clock cycles
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            torch.cuda.synchronize()
            runs.append(a.elapsed_time(b) / (reps * calls))
        return min(runs)

    # the codec kernels: the distinct (shape[, rpp]) inputs of the three
    # advisor runs
    schema = pt.make_tpch_like(scale=100, z=0.0, seed=0)
    budget = 0.25 * sum(t.nrows * (sum(c.width for c in t.columns) + 4)
                        for t in schema.tables.values())
    seen = {name: {} for name in CODECS}
    kernel = {name: getattr(cb, name) for name in CODECS}

    def capturing(name):
        def capture(cols, widths, *rpp):
            seen[name].setdefault((tuple(cols.shape), *map(int, rpp)),
                                  (cols, widths))
            return kernel[name](cols, widths, *rpp)
        return capture
    for name in CODECS:
        setattr(cb, name, capturing(name))
    try:
        wl = pt.make_tpch_workload(schema, insert_weight=0.1)
        pt.DesignAdvisor(wl, pt.AdvisorOptions(
            backend="torch", device="cuda")).recommend(budget)
        wl_big = pt.make_scaled_workload(schema, n_statements=10_000,
                                         insert_fraction=0.1, seed=0)
        opts5 = pt.AdvisorOptions(backend="torch", device="cuda",
                                  methods=FIVE, compression_budget=128)
        plan_s = [pt.DesignAdvisor(wl_big, opts5).recommend(
            budget).phase_seconds["plan"]]
        pt.staged_recommend(wl, budget, methods=FIVE,
                            options=pt.AdvisorOptions(backend="torch",
                                                      device="cuda"))
    finally:
        for name in CODECS:
            setattr(cb, name, kernel[name])
    plan_s.append(pt.DesignAdvisor(wl_big, opts5).recommend(
        budget).phase_seconds["plan"])
    # a third run's plan phase, profiled
    from repro_torch.core import advisor as adv_mod
    prof = cProfile.Profile()
    estimate = adv_mod.DesignAdvisor.estimate_sizes

    def profiled(self, *a, **kw):
        prof.enable()
        try:
            return estimate(self, *a, **kw)
        finally:
            prof.disable()
    adv_mod.DesignAdvisor.estimate_sizes = profiled
    try:
        plan_split = {"plan_s_profiled": pt.DesignAdvisor(
            wl_big, opts5).recommend(budget).phase_seconds["plan"]}
    finally:
        adv_mod.DesignAdvisor.estimate_sizes = estimate
    for (path, _, name), (_, calls, _, cum, _) in \
            pstats.Stats(prof).stats.items():
        if (Path(path).name, name) in PLAN_PARTS:
            plan_split[name] = {"calls": calls, "cumulative_s": cum}
    # the targets, values below 2^32 from seed 0
    rng = np.random.default_rng(0)
    big = tuple(torch.as_tensor(a, device="cuda") for a in (
        rng.integers(0, 1 << 32, size=(801, 60000)),
        rng.integers(1, 9, size=801)))
    wide = tuple(torch.as_tensor(a, device="cuda") for a in (
        rng.integers(0, 1 << 32, size=(11, 60000)),
        rng.integers(1, 9, size=11)))
    targets = {"ns_bytes": {((11, 60000),): wide},
               "prefix_bytes": {((801, 60000), 273): big},
               "rle_bytes": {((801, 60000), 273): big}}
    codec = {}
    for name in CODECS:
        fn, plain = kernel[name], getattr(cb, f"{name}_plain")
        codec[name] = []
        for source, inputs in (("advisor", seen[name]),
                               ("seed 0", targets.get(name, {}))):
            for key, (cols, widths) in sorted(inputs.items()):
                args = (cols, widths, *key[1:])
                if not torch.equal(fn(*args), plain(*args)):
                    raise SystemExit(f"{name} != plain on {key}")
                rec = {"input": source, "shape": list(key[0]),
                       "ms": per_call_ms(lambda: fn(*args), 1, 20),
                       "device_ms": device_ms(lambda: fn(*args), 1)}
                if len(key) > 1:
                    rec.update(rpp=key[1],
                               pages=key[0][0] * -(-key[0][1] // key[1]))
                codec[name].append(rec)
    del seen, targets, big, wide

    # GDICT: the smoke's lineitem input, seed 0, one row of three distinct
    # values and one of all distinct values
    sample = pt.SampleManager(schema.tables, seed=0).get_sample(
        "lineitem", 0.01)
    li = schema.tables["lineitem"]
    r0 = np.random.default_rng(0)
    gd_inputs = {
        "lineitem f=0.01": (np.stack([sample.values[c.name]
                                      for c in sample.columns]),
                            [li.col_by_name[c.name].width
                             for c in sample.columns]),
        "seed 0": (r0.integers(0, 1 << 32, size=(11, 60000)),
                   r0.integers(1, 9, size=11)),
        "3 distinct": (r0.choice([7, 1 << 20, 1 << 40], size=(1, 60000)),
                       [8]),
        "all distinct": (r0.permutation(60000)[None] * 7 + 3, [4])}
    gdict = []
    for label, (cols, widths) in gd_inputs.items():
        args = tuple(torch.as_tensor(np.asarray(a, dtype=np.int64),
                                     device="cuda") for a in (cols, widths))
        if not torch.equal(cb.gdict_bytes(*args), cb.gdict_bytes_plain(*args)):
            raise SystemExit(f"gdict_bytes != plain on {label}")
        gdict.append({"input": label, "shape": list(args[0].shape),
                      "ms": per_call_ms(lambda: cb.gdict_bytes(*args), 1, 20),
                      "device_ms": device_ms(lambda: cb.gdict_bytes(*args),
                                             1, 20)})
    # prob_within at the planner's (90,): means and stds from seed 0
    from repro_torch.kernels import planner_score as ps
    pw = tuple(torch.as_tensor(a, dtype=torch.float32, device="cuda")
               for a in (r0.uniform(0.8, 1.2, 90), r0.uniform(0.0, 0.1, 90)))
    if float((ps.prob_within(*pw, 0.5)
              - ps.prob_within_plain(*pw, 0.5)).abs().max()) > 1e-6:
        raise SystemExit("prob_within differs from plain at (90,)")
    prob = {"shape": [90], "ms": per_call_ms(
        lambda: ps.prob_within(*pw, 0.5), 1, 200),
        "device_ms": device_ms(lambda: ps.prob_within(*pw, 0.5), 1, 200)}
    del gd_inputs, args, pw

    # quantize at the LM shapes, random float32 tensors from seed 0
    gen = torch.Generator(device="cuda").manual_seed(0)
    qz = []
    for shape, count, data in QUANTIZE:
        xs = [torch.randn(shape, device="cuda", generator=gen) * 1e-3
              for _ in range(count)]
        for x in xs:
            if data == "zero rows":
                x[torch.rand(shape[0], device="cuda", generator=gen)
                  < 0.75] = 0.0
            elif data == "subnormals":
                tiny = torch.rand(shape, device="cuda", generator=gen) < 0.1
                x[tiny] *= 1e-35
        for x in xs[:2]:
            q, s = qb.quantize_blockwise(x)
            q_p, s_p = qb.quantize_blockwise_plain(x)
            if not (torch.equal(q, q_p) and torch.equal(s, s_p)):
                raise SystemExit(f"quantize_blockwise != plain at {shape}")

        def calls():
            for x in xs:
                qb.quantize_blockwise(x)
        qz.append({"shape": list(shape), "tensors": count, "data": data,
                   "ms": per_call_ms(calls, count),
                   "device_ms": device_ms(calls, count)})
        del xs

    # the q8 wire over one step of TinyLlama-1.1B-shaped gradients
    from repro_torch.configs import get_config
    from repro_torch.models import model as MD
    from repro_torch.train import step as train_step
    lm = get_config("tinyllama-1.1b")
    params = MD.init_params(torch.Generator("cuda").manual_seed(0), lm,
                            device="cuda")
    shapes = [(n, tuple(p.shape)) for n, p in params.named_parameters()]
    del params
    grads = {n: torch.randn(sh, device="cuda", generator=gen) * 1e-3
             for n, sh in shapes}
    wire_x = [g for g in grads.values() if train_step.on_wire(g)]
    buckets = train_step.wire_buckets(wire_x)

    def wire():
        train_step.q8_wire(grads)

    def singles():
        for x in wire_x:
            qb.quantize_blockwise(x)
    wire_rec = {"tensors": len(wire_x), "buckets": len(buckets),
                "q8_wire_ms": per_call_ms(wire, 1, 3),
                "q8_wire_device_ms": device_ms(wire, 1, 3),
                "quantize_single_calls_ms": per_call_ms(singles, 1, 3),
                "quantize_single_calls_device_ms": device_ms(singles, 1, 3)}
    if hasattr(qb, "quantize_blockwise_group"):
        items = [[(wire_x[i], torch.empty(wire_x[i].shape, dtype=torch.int8,
                                          device="cuda"),
                   torch.empty((*wire_x[i].shape[:-1],
                                -(-wire_x[i].shape[-1] // qb.DEFAULT_BLOCK)),
                               device="cuda")) for i in b] for b in buckets]

        def grouped():
            for b in items:
                qb.quantize_blockwise_group(b)
        wire_rec["quantize_grouped_ms"] = per_call_ms(grouped, 1, 3)
        wire_rec["quantize_grouped_device_ms"] = device_ms(grouped, 1, 3)
        del items
    del grads, wire_x

    # dequantize at the wire's shapes, random q8 tensors from seed 0
    dq = []
    for shape, count in WIRE:
        nb = -(-shape[-1] // qb.DEFAULT_BLOCK)
        args = [(torch.randint(-127, 128, shape, dtype=torch.int8,
                               device="cuda", generator=gen),
                 torch.rand(*shape[:-1], nb, device="cuda", generator=gen))
                for _ in range(count)]
        for q, s in args:
            got = qb.dequantize_blockwise(q, s)
            want = qb.dequantize_blockwise_plain(q, s)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise SystemExit(f"dequantize_blockwise != plain at {shape}")

        def calls():
            for q, s in args:
                qb.dequantize_blockwise(q, s)

        def multiplies():
            for q, s in args:
                q.view(*shape[:-1], nb, -1) * s[..., None]
        dq.append({"shape": list(shape), "tensors": count,
                   "ms": per_call_ms(calls, count),
                   "device_ms": device_ms(calls, count),
                   "multiply_ms": per_call_ms(multiplies, count),
                   "multiply_device_ms": device_ms(multiplies, count)})
    # dequant-matmul at phase 5c's shapes, 22 layers' weights cycling
    dm = []
    for m, k, n in DMM:
        args = []
        for _ in range(LAYERS):
            w = torch.randn((n, k), device="cuda", generator=gen) * 0.02
            q, s = qb.quantize_blockwise_plain(w)        # along K
            args.append((torch.randn((m, k), device="cuda", generator=gen),
                         q.t().contiguous(), s.t().contiguous()))
        dense = [(a, (q.float().reshape(-1, qb.DEFAULT_BLOCK, n)
                      * s[:, None, :]).reshape(k, n)) for a, q, s in args]
        got = dqm.dequant_matmul(*args[0])
        if not torch.allclose(got, dqm.dequant_matmul_plain(*args[0]),
                              rtol=1e-4, atol=1e-4):
            raise SystemExit(f"dequant_matmul != plain at {(m, k, n)}")

        def calls():
            for x in args:
                dqm.dequant_matmul(*x)

        def matmuls():
            for a, w in dense:
                torch.matmul(a, w)
        dm.append({"shape": [m, k, n], "layers": LAYERS,
                   "ms": per_call_ms(calls, LAYERS),
                   "device_ms": device_ms(calls, LAYERS),
                   "matmul_ms": per_call_ms(matmuls, LAYERS),
                   "matmul_device_ms": device_ms(matmuls, LAYERS)})
        del args, dense
    out = {"card": card}
    for name in CODECS:
        short = name[:-len("_bytes")]
        out[short] = codec[name]
        out[f"{short}_device_ms_sum"] = sum(
            r["device_ms"] for r in codec[name] if r["input"] == "advisor")
    print(json.dumps({**out, "gdict": gdict, "prob_within": prob,
                      "quantize": qz, "q8_wire": wire_rec,
                      "dequantize": dq, "dequant_matmul": dm,
                      "plan_seconds_3b": plan_s,
                      "plan_split_3b": plan_split}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
