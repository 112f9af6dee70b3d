#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU, end to end: the advisor, LM
serving and LM training, every model family served and trained, and
distribution.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught), run in the order
1, 2, 3, 3b, 3c, 3d, 3e, 4, 5, 4b, 6, 4c, 6f, 7, 8, 9, 11, 12, 10, with
3f in a process of its own from 9 on, joined after 10:
  1. print the card (nvidia-smi name, power limit) and build the eighteen
     hand-written kernels from the sources under src/repro_torch/kernels/
     (four libraries, one nvcc per source, all started together);
  2. hold each kernel against its plain PyTorch version on the card on
     edge cases: the five codec kernels (NS, GDICT, LDICT, PREFIX, RLE),
     and LDICT, PREFIX and RLE once more on page sizes around their warp
     and block paths, the int64 extremes, pages that mix signs, runs
     across page, 16-byte pair and warp-step boundaries and grids of more
     than 65,535 pages, NS on significant-byte edges with rows of one
     block and rows split over a cluster, GDICT's hash set on rows of
     equal, three, all distinct and int64-extreme values at the limits of
     each of its three layouts (a block's shared memory, a cluster's,
     global memory), blockwise quantization
     (single calls and groups: mixed ranks and types, unaligned views,
     other blocks, .5 boundaries, a group longer than one launch takes;
     quantize_kv at TinyLlama-1.1B's per-layer KV cache, head dimension 64
     in a block of 128)
     and blockwise dequantization (float32 and bfloat16 output; single
     calls and groups, one of them longer than one launch takes)
     bit-equal;
     prob_within and fused_score
     within the stated tolerances, plus their two bitwise properties (prob
     consistency, K-pad invariance); the planner walk bit-equal to its plain
     version on a synthetic graph, its feasibility verdict (p, feasible)
     too; dequant-matmul within rtol and atol 1e-4
     of the plain IEEE float32 product on both of its kernels (M on both
     sides of the decode threshold, N masked), bit-equal call to call;
  3. run DTAc `DesignAdvisor.recommend` on make_tpch_like(scale=100) --
     6,000,000 lineitem rows, TPC-H SF1's count -- with
     make_tpch_workload(insert_weight=0.1) at a budget of 25 % of the base
     size, on backend="torch", device="cuda", with the launch counters
     zeroed just before and read just after; run it once more, keeping
     each kernel's largest inputs, and require the same result; the
     plan's one planner_walk launch (no prob_within: the walk judges the
     plan's feasibility) bit-equal to planner_walk_plain on the card (the
     per-record fused_score kernel and float64 decisions); then run the
     port's numpy backend and compare the two;
  3b. the same for the large-workload path: make_scaled_workload(10,000
     statements) on the same data, all five codecs, compression_budget=128
     (workload compression, paper Section 7), budget 25 %; then the
     greedy-step scorers' calls of both measured runs (3 and 3b, kept by
     wrapping `cost_engine._score_secondary_torch` /
     `_score_replace_torch`) bit-equal to the same function on CPU copies
     of their operands at every distinct (scorer, nq, m, ns), which are
     printed (`check_scorer_order`);
  3c. staged_recommend (Example 1) with the five codecs on phase 3's
     workload, torch/cuda against numpy;
  3d. the online AdvisorSession on phase 3's data and budget, each round
     held to a fresh torch/cuda DesignAdvisor.recommend on the workload
     after it (config, cost, used bytes, base cost, plan counts, pool and
     candidate counts identical; 3d-ii also the error bound), its launches,
     cache and replay counters, walk layout, seconds and peak memory
     printed: 3d-i phase 3's workload (a cold round; 8 statements added, 2
     removed, 2 reweighted; a reweight-only round, which must launch no
     kernel; snapshot -> bytes -> restore, then a round), also on the
     numpy backend (same plan, same configuration or an equal-cost tie);
     3d-ii 3b's 10,000 statements with its options (a cold round; 200
     added, 100 removed, 50 reweighted; a reweight-only round, which
     launches nothing on the reweight fast path).  A re-planned round makes
     one planner_walk launch, an unchanged plan none; the codec kernels
     launch only for SampleCF cache misses;
  4. hold each advisor kernel against its plain version again on the
     largest inputs phases 3 and 3b gave it (GDICT, on no advisor path:
     every column of the SF1 lineitem sample at f = 0.01, per call and in
     device time, and rows past the cluster's layout with their scratch
     bytes; fused_score, on no advisor path since the walk: the largest
     record of 3b's plain walk; prob_within, on no advisor path since the
     walk judges feasibility: the targets' final RVs of 3b's walk, in
     device time), and time both there; the walk on 3b's graph, per call
     and in device time; LDICT's device time over the second runs of 3 and 3b
     (torch.profiler) beside their SampleCF seconds, LDICT at each
     phase's largest input, and NS, PREFIX and RLE per call and in device
     time at their largest inputs;
  5. LM serving at TinyLlama-1.1B's published size (22 layers, d_model
     2048, float32 weights from the port's init_params, seed 0): 5a the
     layout advisor's plan for the serve job at an 80 GB and a 1.5 GB
     budget (q8 weights required at 1.5 GB); 5b ServeEngine answering 8
     requests (one submitted per engine step), request 0 alone giving the
     same tokens, a float32-KV run's logits agreeing with `forward`, and
     the card's and the CPU's engines giving the same tokens at depth 2;
     5c the plan's q8 weights: quantize_mlp on all 22 MLPs and
     mlp_quantized on the MLP inputs each layer received in one decode
     step (M = 4) and one forward over 4 x 128 tokens (M = 512), against
     the plain version and the float MLP, with the launch counters zeroed
     before 5b and read after 5c;
  4b. time the quantize and dequant-matmul kernels at the shapes phase 5
     gave them, cycling through the 22 layers' weights (the main path
     finds them cold in the L2 cache), per call and in device time (both
     kernels), beside
     float32 torch.matmul on the dequantized weight; dequant-matmul's two
     bounds (float32: bytes or operations at 67 TFLOP/s; tensor cores: 2
     M K N per bf16 pass at 989 TFLOP/s);
  6. LM training at TinyLlama-1.1B's published size and context (batch
     4, seq 2048), phase 5's model freed first: 6a the layout advisor's
     plan for the train job at an 80 GB and a 10 GB budget (the q8
     gradient wire at both, q8 Adam moments at 10 GB required); 6b
     Trainer for 6 steps at 80 GB (float32 moments): losses finite, the
     first near ln(32000), the last below it, exactly one grouped
     quantize launch and one grouped dequantize launch per wire bucket
     per step, step time,
     tokens/s, share of the bf16 peak, peak device memory, then one more
     step traced with torch.profiler (device busy share, device time by
     kernel family); 6c the same for 4 steps at 10 GB (q8 moments: one
     more grouped launch of each kernel per parameter per step); 6d both
     kernels, and the grouped quantize and dequantize on the wire's
     buckets and on 6c's moment pairs, bit-equal to their plain versions
     on the gradients of 6b's next step (from the step's own
     loss-and-gradient function) and 6c's moments; 6e a two-layer model
     at width 2048 trained for 2 steps in
     float32 on the card and on the CPU, held to the CPU tests'
     tolerances;
  4c. time the dequantize and quantize kernels at every distinct shape
     of phase 6's wire, cycling through its tensors (per call and in
     device time), beside the plain version and the one PyTorch call that
     computes the same function; the grouped dequantize over all 201 wire
     tensors beside their summed bytes bound, 201 single calls and 201
     one-call multiplies; the wire's whole step of quantize (one grouped
     launch per bucket) beside its summed bytes bound and 201 single
     calls; the single dequantize call's host microseconds by part;
  6f. the training checkpoint at 6c's configuration (TinyLlama-1.1B,
     batch 4 x seq 2048, 10 GB: q8 moments and the q8 wire), every earlier
     trainer freed, the launch counters zeroed just before and read just
     after: T0 trains 6 steps without a checkpoint; T1 trains 3 with a
     checkpoint directory (only the end-of-run save, keep_last_k 1) and is
     dropped; its losses and parameters against T0's first 3 are the
     determinism baseline (bitwise, or the spread printed); T2, a new
     Trainer on the directory, starts at step 3 with every parameter,
     moment and step tensor bit-equal to T1's at its save, and its 3 steps
     give T0's last 3 losses and final parameters (bitwise when the
     baseline is, else within its spread); a q8+zlib save of T2's
     parameters (one grouped quantize launch per group_capacity()
     tensors) restored into a fresh model on the card (as many grouped
     dequantize launches), each tensor bit-equal to the plain dequantize
     of the plain quantize; phase 6e's depth-2 model after one q8 step:
     its q8+zlib checkpoint from the card byte-identical to its CPU
     copy's; a byte flipped in the smallest leaf file makes restore raise
     a checksum IOError; the training launcher twice on one directory (4
     steps, then 2 from step 4).  Prints each save's seconds (snapshot to
     host, encode, write + fsync), each restore's, raw and stored bytes,
     threads, os.cpu_count(), the disk's free bytes, peak device memory
     of T1 and T2 and the phase's seconds; fails with less than 3x the
     state's raw bytes free;
  7. the remaining model families (`phase_7`, module level like 6f), in
     float32 with weights from init_params (seed 0), every earlier model
     freed: 7a granite-moe-3b-a800m at full size (32 layers, 40 experts
     top-8) serving phase 5's 8 requests (ServeEngine(batch_slots=4,
     max_len=256), float32 KV): generated tokens/s, peak device memory, a
     second run's tokens equal, the kept share of the expert assignments
     per decode call (a forward pre-hook per MoE layer); 7b rwkv6-7b at
     full size, freed 7a first: the same run, request 0 alone equal to
     the crowd's, the engine's logits against `forward` within
     LOGITS_ATOL, `forward`'s seconds over 4 x 64 tokens; 7c
     granite-moe-3b-a800m, rwkv6-7b, pixtral-12b and musicgen-medium at
     full width and depth 2, card against CPU (a copy of the card's
     weights): `forward` over a `batch_at` batch (the stub frontends'
     embeddings in float32) and 8 `decode_step`s with `active` masks and
     a `reset_slot`, logits and serving state within rtol and atol
     FAMILY_TOL, the MoE routing (expert picks, keep masks) equal but
     for near-ties within ROUTE_GAP (counted and printed, gaps too); 7d
     jamba-1.5-large-398b's smoke configuration the same way, and its
     Mamba block alone at d_model 8192 (a 64-token prefill at B = 4,
     then 8 decode steps from the carried conv and ssm state), card
     against CPU; prints the phase's seconds;
  8. distribution and launch (`phase_8`, module level): 8a phase 6's
     TinyLlama-1.1B run (80 GB plan: the q8 wire, float32 moments), 3
     steps unsharded, then 3 from the same seed after `Trainer.reshard`
     onto `make_smoke_mesh` (a 1x1 NCCL mesh, FSDP2; a failed group fails
     the phase): losses, parameters and moments bit-equal (else phase
     6e's bounds, with the gap printed), the grouped q8 launches per step
     on each run, step seconds, device busy share (one more traced step)
     and peak memory of both; 8b one sharded step counted on the card
     with the dry run's `StepCounter` (torch.utils.flop_counter's
     formulas) and a forward with `FlopCounterMode`, beside `census(...,
     n_chips=1, tp=1)` (the forward within 15 %), and the census's
     roofline `t_bound` beside the measured step, with the card's name
     and power limit; 8c the dry run (`launch.dryrun.run_cell`, on the
     host) of TinyLlama's four shapes and yi-9b's train_4k on the 16x16
     and 2x16x16 meshes: status and argument bytes per chip, failing on
     an error; prints the phase's seconds;
  9. the paper's estimation experiments at SF1 (`phase_9`, module level,
     on phase 3's data): 9a full-index ground truth, `full_index_sizes`'
     codec kernels over whole lineitem indexes (Table 4's five column
     prefixes and one single-column index per codec; GDICT's first path)
     `==` the NumPy formula on the same built index, seconds per codec on
     the card and in NumPy and the builds' host seconds apart, GDICT's
     layout at 6,000,000 values; 9b Table 1: `SynopsisManager` GROUP BY
     MV samples (seven MVs on lineitem and orders, one through
     lineitem's foreign key to orders) and their index sizes at f = 0.05
     on the card `==` the NumPy run, AE against the multiply and
     optimizer baselines and the true group count; 9c Table 4: `greedy`
     at each fraction of F_GRID on the ten targets and the first eight,
     one planner_walk launch each, held to the NumPy engine's plans (the
     equal-p tie rule), `optimal` on the first eight <= greedy; 9d
     `chunked_config_costs` over 4,000 statements in 4 chunks, the base
     configuration and phase 3's, held to NumPy within rtol 1e-6, with
     seconds and peak device memory; 9e every examples/torch_*.py `main`
     on the card at its reference's default size (train_e2e: the fast
     preset, 3 steps), each one's seconds; the phase's launches join the
     advisor kernels' records;
  11. existing indexes (§5.1) and the what-if API at SF1 (`phase_11`,
     module level, right after phase 9 on phase 3's data and
     recommendation): 11a phase 3's compressed, predicate-free indexes
     (at most 8, the first by label) as the existing design, each sized
     whole by `samplecf.exact_size` on the card `==` NumPy, the builds'
     host seconds apart; 11b `EstimationPlanner(existing=...)` planning
     phase 3's targets at phase 3's (e, q) in one planner_walk launch,
     held to the NumPy engine's plan (the equal-p tie rule), every
     existing node EXACT with its bytes, beside the plan without
     `existing`; 11c that plan executed on the card and through NumPy,
     every estimate `==`; 11d a card `DesignAdvisor.optimizer`:
     `workload_cost` within rel 1e-12 of NumPy's `workload_cost_batch`,
     the card advisor's batch (priced on the host) within rtol 1e-6,
     `generate_candidates`' estimation targets those phase 3 planned; 11e the walk with exact start ids bit-equal to
     `planner_walk_plain` on the card; its launches join the advisor
     kernels' records (`launches_by_phase["11"]`);
  12. the statement-at-a-time oracle paths at SF1 (`phase_12`, module
     level, right after phase 11 on phase 3's workload, budget, numpy and
     torch/cuda recommendations and card estimates, and phase 3c's numpy
     staged recommendation), each run a torch/cuda `recommend` with one
     `AdvisorOptions` switch off and its launches counted: 12a
     `use_batched_planner=False`, the scalar §5.2 greedy's plan identical
     to the numpy engine's, its equal-p ties against phase 3's card walk
     counted, the recommendation identical to phase 3's torch/cuda one
     where there are none; 12b `use_batched_estimation=False`, every
     SAMPLED node's host `sample_cf` `==` phase 3's batched card estimate
     (the NS and LDICT kernels against the scalar oracle), the
     recommendation identical to phase 3's; 12c `use_engine=False`, the
     float64 scalar enumeration: numpy's configuration or an equal-cost
     tie, the cost within rel 1e-12 of numpy's, the steps beside numpy's
     and torch/cuda's; 12d all three off, then `staged_recommend(
     use_engine=False)` with 3c's five codecs, held to numpy's the same
     way; each run's seconds, steps and launches; the phase fails beyond
     30 s; its launches join the advisor kernels' records
     (`launches_by_phase["12"]`);
  10. the non-dense families trained on the card (`phase_10`, module
     level), every earlier model and the SF1 schema freed: 10a
     granite-moe-3b-a800m at its published size (3.374 B parameters)
     through `launch.train.main` at batch 4 x seq 2048, 5 steps, the 80 GB
     plan (float32 moments, the q8 wire): losses finite, the first within
     FIRST_LOSS_WINDOW of ln(vocab) + d_model * 0.02^2 / 2, the last below
     it, one grouped quantize and one grouped dequantize launch per wire
     bucket per step, step seconds, tokens/s, peak device memory, the
     share of expert assignments kept per step (each MoE call's keep mask
     as `moe_routing` returns it, each layer's first call a step), one
     more step traced (busy share,
     device time by kernel family, the index kernels); 10a-ii
     `make_loss_and_grads` twice on its final parameters (moments freed):
     the loss bit-equal, each gradient bit-equal or the largest gap per
     parameter kind printed, then both q8 kernels, single and grouped on
     the wire's buckets, bit-equal to their plain versions on those
     gradients; 10b rwkv6-7b at full width, cut to RWKV_DEPTH layers,
     `Trainer` at the 80 GB plan, batch 4 x seq 512 (two WKV chunks), step
     0 and 3 more: 10a's checks, one traced step with the WKV scan's share
     of host and device time, then the q8 kernels on its gradients; 10c
     granite-moe-3b-a800m, rwkv6-7b, pixtral-12b and musicgen-medium at
     full width and depth 2 trained FAMILY_TRAIN_STEPS steps on the card
     and on a CPU copy of the same weights (float32 compute, remat, the q8
     wire and q8 moments, batch 1 x seq 512), held to phase 6e's bounds,
     MoE routing differences and RWKV's near-eps group-norm rows counted,
     not exempted, the CPU copy's host bytes reckoned; 10d the Jamba smoke
     configuration the same way at seq 256, and its Mamba block alone at
     d_model 8192 (AdamW on the mean square of its output against a seeded
     target, batch 2 x seq 256); 10e `launch.train.main` at smoke size, 5
     steps, for the six non-dense architectures, each held to a CPU
     Trainer from the same initial weights (losses within rtol 2e-2,
     finite, the last below the first, a stub frontend's near ln(vocab));
     where a token model's loss does not fall with the plan's q8 moments
     and q8 wire at lr 1e-3 (the Jamba smoke's: the JAX Trainer rises so too,
     tests/test_torch_train_hybrid.py), the CPU's must not fall either and
     the same weights trained with float32 moments and no wire must fall
     on the card; prints each part's
     seconds; the q8 launches of its training runs join the q8 records;
  3f. (`chip_smoke.py --phase-3f`, started as phase 9 starts: its
     host-bound advisor work runs beside 9-12 and 10, which leave most of
     the host's cores idle; phase 10 starts once its SampleCF has handed
     back the ~43 GB of the card it needs; joined after 10, its output
     printed, its launches joining the advisor records)
     DesignAdvisor.recommend on
     make_scaled_workload(10,000 statements) on phase 3's data, options
     and budget, without workload compression: lineitem's 6,833 queries
     are past the 4,096 at which XLA's scorers leave their dot unfused.
     Every distinct (scorer, nq, m, ns) of its greedy-step scorer calls
     bit-equal card vs CPU (`check_scorer_order`), the calls at nq >= 4,096
     counted and timed; the card's configuration priced by the port's
     numpy CostEngine within rtol 1e-6 of the card's cost, its bytes
     within the budget.

Prints the per-phase wall times, launch counts, kernel times beside their
bounds, peak device memory, a JSON line of kernel records, the card line,
and last {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""
import contextlib
import dataclasses
import gc
import heapq
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
FIVE = ("NS", "GDICT", "LDICT", "PREFIX", "RLE")
CODECS = ("ns_bytes", "gdict_bytes", "ldict_bytes", "prefix_bytes",
          "rle_bytes")
ORD_IND = ("ns_bytes", "gdict_bytes")     # wrappers that take no rpp
# kernels whose device time phase 4 also records
DEVICE_TIMED = ("ns_bytes", "gdict_bytes", "prefix_bytes", "rle_bytes",
                "prob_within")
# phase 2: LDICT page sizes around a warp's 32 lanes, its warp / block
# split (512 rows), the main path's 273 and the largest (1638), and grids
# of more than 65,535 pages; PREFIX's the same, up to 4096
LDICT_RPPS = (1, 31, 32, 33, 273, 512, 513, 1638)
LDICT_GRIDS = (((1, 65535), 1), ((240, 75000), 273), ((41, 1638 * 1600), 1638))
PREFIX_RPPS = (1, 31, 32, 33, 273, 512, 513, 4096)
PREFIX_GRIDS = (((1, 65535), 1), ((65535, 3), 3), ((240, 75000), 273),
                ((801, 60000), 273))
# NS: (m, n) of one block a row and of rows split over a cluster of blocks
NS_EDGES = ((1, 1), (11, 7), (11, 60000), (11, 60001), (200, 60001),
            (4096, 7), (4096, 4097), (3, (1 << 20) + 3))
# GDICT: row lengths at its layouts' limits (a block's shared memory up to
# 4,681 values, a cluster's up to 74,898, one block's share up to 9,362)
# and the main path's 60,000; (m, n) stacks of the advisor's widths; a
# stack past the cluster's layout timed in phase 4
GDICT_NS = (1, 4681, 4682, 9362, 9363, 60000, 74898, 74899)
GDICT_STACKS = ((801, 60000), (801, 4682), (200, 74899))
GDICT_GLOBAL = (11, 100_000)
N_SCALED = 10_000                # phase 3b: statements before compression
COMPRESSION_BUDGET = 128         # phase 3b: representatives advised on
# GDICT is priced on the host by the Adaptive Estimator in SampleCF (as in
# the JAX package); only batched_bytes("GDICT", ...) reaches its kernel;
# the walk judges each plan's feasibility, so no prob_within either
ADVISOR_KERNELS = CODECS + ("planner_walk",)
LM_ARCH = "tinyllama-1.1b"       # phase 5: the dense model served
LM_SLOTS, LM_MAX_LEN, LM_NEW = 4, 256, 16
LM_REQUESTS = 8
LM_BUDGETS = (80e9, 1.5e9)       # phase 5a: HBM budgets of the layout plan
DMM_TOL = 1e-4                   # dequant-matmul vs plain, rtol and atol
# phase 5b: engine logits vs forward over the same tokens, float32 KV, 22
# layers on the card (different summation orders in the decode and the
# full-sequence attention); logits are O(1)
LOGITS_ATOL = 1e-3
Q8_REL_ERR = 0.05                # q8 MLP vs float MLP, mean relative error
Q8_BYTES_RATIO = 0.35            # q8 MLP bytes vs float32 bytes
# phase 6: training TinyLlama-1.1B at its published context
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 4, 2048, 3e-4
TRAIN_BUDGETS = (80e9, 10e9)     # 6b float32 moments, 6c q8 moments
TRAIN_STEPS = (6, 4)
BF16_PEAK = 989e12               # H100 SXM dense bf16 tensor-core rate
# phase 6e, card vs CPU in float32 (the CPU tests' tolerances against
# JAX): losses within rtol 1e-4; parameters within 6 lr everywhere and
# within 1e-5 on all but 0.1 % (Adam's first updates are near sign(g) * lr,
# so an element whose gradient or q8 level sits at a rounding boundary can
# move by up to 2 lr more on one side)
# phase 6b's trace: kernel families by substrings of the kernel name (the
# first match wins)
KERNEL_FAMILIES = (
    ("matrix products", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    # "dequantize_group_kernel" contains "quantize_group_kernel": the
    # dequantize family must come first
    ("q8 dequantize (ours)", ("dequantize_group_kernel",)),
    ("q8 quantize (ours)", ("quantize_group_kernel", "quantize_kernel")),
    ("softmax / logsumexp", ("softmax", "logsumexp")),
    ("reductions", ("reduce",)),
    ("index / gather / scatter", ("index", "gather", "scatter",
                                  "embedding")),
    ("copies and casts", ("copy", "cat", "memcpy", "memset")),
    ("elementwise", ("elementwise",)))
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_ATOL = 1e-5
TRAIN_FAR_SHARE = 1e-3
Q8_KERNELS = ("quantize_blockwise", "dequantize_blockwise")
SCAN_RANGE = "chunked_scan"      # the profiler range of a recurrence's time loop
# phase 6f: T1 runs the first CKPT_STEPS[0] steps and saves, T2 resumes
# for CKPT_STEPS[1] more; checkpoint_every beyond the run (only the
# end-of-run save fires); the disk must hold this many times the state's
# raw bytes (the old checkpoint and the new .tmp at once, with room)
CKPT_STEPS = (3, 3)
CKPT_EVERY = 1_000_000
DISK_FACTOR = 3
# phase 7: the remaining model families.  7a and 7b serve the two that
# fit one card in float32 at full size; 7c holds the card to the CPU at
# full width and depth 2 (phase 6e's method) in float32 at the CPU tests'
# tolerances; 7d the hybrid at its smoke size and its Mamba block alone at
# Jamba's width
MOE_ARCH, RWKV_ARCH, HYBRID_ARCH = ("granite-moe-3b-a800m", "rwkv6-7b",
                                    "jamba-1.5-large-398b")
WIDE_ARCHS = (MOE_ARCH, RWKV_ARCH, "pixtral-12b", "musicgen-medium")
FAMILY_TOL = 1e-4                # 7c / 7d card vs CPU, rtol and atol
# a card-vs-CPU routing difference is a near-tie, not a fault, only where
# the CPU's router logits of the two experts are this close
ROUTE_GAP = 1e-5
# an RWKV head whose WKV output's variance is below this at its group norm
# (100x the norm's eps) sits where the norm amplifies float32 rounding 10x
# and more (up to 1 / sqrt(eps)); the first token's output is rank one, so
# such heads occur there (PERF.md §6, PR 24)
GN_VAR = 1e-3
FAMILY_BATCH, FAMILY_SEQ, FAMILY_DECODES = 4, 16, 8
FWD_SEQ = 64                     # 7b: forward timed over 4 x 64 tokens
MAMBA_BATCH, MAMBA_PREFILL = 4, 64
FUSED_EXEMPT = ("fused_score is on no advisor path: the planner walks each "
                "plan in one planner_walk launch; the per-record kernel "
                "scores each record of planner_walk_plain, and is held "
                "against its plain version in phases 2 and 4")
# phase 2's synthetic walk graphs: nodes, records, fractions, nodes used;
# the second has more nodes than a block's shared memory holds, so the
# walk keeps its node state in global memory
WALK_SYNTH = ((600, 450, 5, 600), (12_000, 450, 5, 600))
TC_PEAK = 989e12                 # H100 SXM dense bf16 tensor-core rate
PREFILL_PASSES = 2               # dequant-matmul's prefill: a in hi + lo bf16
GDICT_EXEMPT = ("gdict_bytes is on no advisor path: SampleCF prices GDICT "
                "on the host with the Adaptive Estimator (App. B), in this "
                "port as in the JAX package; its kernel is held against its "
                "plain version in phases 2 and 4")
PROB_EXEMPT = ("prob_within is on no advisor path: each plan's one "
               "planner_walk launch judges its feasibility; the kernel "
               "stays for single records and is held against its plain "
               "version in phases 2 and 4")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


PHASE_SECONDS = {}                # host seconds of each phase of main()
_RUNNING = [None, 0.0]           # the running phase and its start


def enter_phase(name) -> None:
    """End the running phase's host seconds (into PHASE_SECONDS) and start
    `name`'s (None: start none)."""
    now = time.perf_counter()
    if _RUNNING[0] is not None:
        PHASE_SECONDS[_RUNNING[0]] = round(now - _RUNNING[1], 3)
    _RUNNING[:] = [name, now]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def short_name(kernel: str) -> str:
    """A CUDA kernel's name without its namespaces, cut to 160 characters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::",
                  "c10::", "std::"):
        kernel = kernel.replace(noise, "")
    return kernel[:160]


def bit_equal(a, b) -> bool:
    """Same type, shape and bits (float64 / float32 / bfloat16 / integer
    tensors)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    as_int = {torch.float64: torch.int64, torch.float32: torch.int32,
              torch.bfloat16: torch.int16}.get(a.dtype)
    if as_int is not None:
        a, b = a.contiguous().view(as_int), b.contiguous().view(as_int)
    return bool(torch.equal(a, b))


def counted(fn, total):
    """fn() with the launch counters zeroed just before and read just
    after, the counts added into `total`; returns (result, seconds,
    launches)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = launch_counts()
    for k, v in got.items():
        total[k] = total.get(k, 0) + v
    return out, secs, got


def timed(fn):
    """fn() and its host seconds."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


SCORERS = {"_score_secondary_torch": "sec", "_score_replace_torch": "rep"}
SCORER_CHECKS = 32               # scorer calls held to the CPU after 3b
UNFUSED_NQ = 4096                # XLA's scorers call an unfused dot from here
N_UNCOMPRESSED = 10_000          # phase 3f: statements, no compression
PHASE_3F_FLAG = "--phase-3f"     # argv of phase 3f's own process
SAMPLED_MARK = "phase 3f: SampleCF done, its device memory handed back"
_CHILDREN = []                   # processes main() started


def advisor_budget(schema) -> float:
    """The advisor phases' budget: 25 % of the base (heap) size."""
    return 0.25 * sum(t.nrows * (sum(c.width for c in t.columns) + 4)
                      for t in schema.tables.values())


class ScorerCalls:
    """The greedy-step scorer calls of the runs `keeping_scorer_calls`
    wraps: every call's (scorer, nq, m, ns) and seconds, and the operands
    and output, on their device, of what `check_scorer_order` holds to the
    CPU: each shape's first call and the SCORER_CHECKS largest others
    (every call's operands would fill the card at 10,000 statements)."""

    def __init__(self):
        self.count = {}          # (scorer, nq, m, ns) -> calls
        self.seconds = {}        # (scorer, nq, m, ns) -> their seconds
        self.first = {}          # (scorer, nq, m, ns) -> (name, args, out)
        self.largest = []        # heap of (cells, -order, key, name, args, out)

    def add(self, name, args, out, secs):
        key = scorer_shape(name, args)
        self.count[key] = self.count.get(key, 0) + 1
        self.seconds[key] = self.seconds.get(key, 0.0) + secs
        if key not in self.first:
            self.first[key] = (name, args, out)
            return
        item = (key[1] * key[2] * max(key[3], 1), -sum(self.count.values()),
                key, name, args, out)
        if len(self.largest) < SCORER_CHECKS:
            heapq.heappush(self.largest, item)
        else:
            heapq.heappushpop(self.largest, item)

    def picked(self):
        """Each shape's first call, then the largest others, up to
        SCORER_CHECKS in all: [(key, name, args, out)]."""
        rest = [c[2:] for c in sorted(self.largest, reverse=True)]
        return ([(k, *v) for k, v in self.first.items()]
                + rest[:max(0, SCORER_CHECKS - len(self.first))])


def keeping_scorer_calls(make, calls):
    """make() with the advisor's greedy-step scorers wrapped: each call
    added to `calls` (a ScorerCalls) with its seconds on the host clock
    to the output's being ready."""
    import torch
    from repro_torch.core import cost_engine as ce
    orig = {n: getattr(ce, n) for n in SCORERS}

    def wrap(name):
        def run(*args):
            t0 = time.perf_counter()
            out = orig[name](*args)
            if out.is_cuda:
                torch.cuda.synchronize()
            calls.add(name, args, out, time.perf_counter() - t0)
            return out
        return run
    for n in SCORERS:
        setattr(ce, n, wrap(n))
    try:
        return make()
    finally:
        for n, f in orig.items():
            setattr(ce, n, f)


def scorer_shape(name, args):
    """(scorer, nq, m, ns) of a greedy-step scorer call."""
    if name == "_score_secondary_torch":
        return (SCORERS[name], *args[1].shape, 0)
    return (SCORERS[name], *args[0].shape, args[1].shape[1])


def check_scorer_order(label, calls):
    """The scorers' outputs on the card bit-equal to the same function on
    CPU copies of the operands (the CPU sum is the one the tests hold to
    the JAX package's): every distinct (scorer, nq, m, ns) once, then more
    calls, the largest first, up to SCORER_CHECKS (`ScorerCalls`)."""
    import torch
    from repro_torch.core import cost_engine as ce
    t0 = time.perf_counter()
    picked = calls.picked()
    # small tensors: one host thread is the quickest
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for key, name, args, out in picked:
            want = getattr(ce, name)(*[a.cpu() for a in args])
            if not bit_equal(out.cpu(), want):
                fail(f"{label}: {name} at (scorer, nq, m, ns) {key} "
                     "differs between the card and the CPU")
    finally:
        torch.set_num_threads(threads)
    shapes = ", ".join(f"{k[0]} ({k[1]}, {k[2]}, {k[3]}) x{n}"
                       for k, n in sorted(calls.count.items()))
    print(f"{label}: {sum(calls.count.values())} scorer calls, "
          f"{len(calls.count)} distinct (scorer, nq, m, ns): {shapes}")
    print(f"{label}: {len(picked)} scorer calls (every distinct shape) "
          f"bit-equal card vs CPU in {time.perf_counter() - t0:.3f} s")


def host_copy(params, opt_state=None):
    """{checkpoint key: [CPU copies]} of a model's parameters and, where
    given, its optimizer state."""
    from repro_torch.models.interop import checkpoint_leaves
    return {k: [t.detach().to("cpu", copy=True) for t in ts]
            for k, (_, ts) in checkpoint_leaves(params, opt_state).items()}


def state_gap(a, b):
    """(tensors not bit-equal, largest absolute difference) between two
    `host_copy` results of the same keys."""
    import torch
    if list(a) != list(b):
        fail(f"phase 6f: the states hold different leaves: {list(a)[:4]} "
             f"against {list(b)[:4]}")
    unequal, gap = 0, 0.0
    for k in a:
        for x, y in zip(a[k], b[k]):
            if not bit_equal(x, y):
                unequal += 1
                gap = max(gap, float((x.to(torch.float64) -
                                      y.to(torch.float64)).abs().max()))
    return unequal, gap


def dir_bytes(path):
    return sum(p.stat().st_size for p in Path(path).rglob("*")
               if p.is_file())


def read_trace(prof):
    """({kernel name: device us}, host us, device us) of a torch.profiler
    profile, read from its raw events (building the profiler's event tree
    takes minutes for the million host events of a recurrent step).  The
    two times are those of the `SCAN_RANGE` ranges and of the backward
    nodes of the ops run inside them (matched by their forward op's
    autograd sequence number and thread), as the union of those intervals
    on each thread, and of the kernels their ops launched."""
    import bisect

    from torch.autograd import DeviceType
    raw = prof.profiler.kineto_results.events()
    kernels, ops = [], []
    for e in raw:
        if e.device_type() == DeviceType.CUDA:
            if e.name() != SCAN_RANGE:          # not the range's annotation
                kernels.append(e)
        elif e.linked_correlation_id() == 0:    # an op, range or node
            ops.append(e)
    by_name = {}
    for k in kernels:
        by_name[k.name()] = by_name.get(k.name(), 0.0) + \
            k.duration_ns() / 1e3
    by_thread = {}
    for e in ops:
        by_thread.setdefault(e.start_thread_id(), []).append(e)
    starts = {}
    for t, es in by_thread.items():
        es.sort(key=lambda e: e.start_ns())
        starts[t] = [e.start_ns() for e in es]
    spans = {}                                  # thread -> [(start, end)]
    fwd = set()
    for e in ops:
        if e.name() != SCAN_RANGE:
            continue
        t, lo, hi = e.start_thread_id(), e.start_ns(), e.end_ns()
        spans.setdefault(t, []).append((lo, hi))
        es = by_thread[t]
        for i in range(bisect.bisect_left(starts[t], lo),
                       bisect.bisect_left(starts[t], hi)):
            if es[i].sequence_nr() >= 0:
                fwd.add((t, es[i].sequence_nr()))
    for e in ops:
        if e.name().startswith("autograd::engine::evaluate_function") and \
                (e.fwd_thread_id(), e.sequence_nr()) in fwd:
            spans.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.end_ns()))
    host_ns = 0
    merged = {}
    for t, iv in spans.items():
        iv.sort()
        out = []
        for lo, hi in iv:
            if out and lo <= out[-1][1]:
                out[-1][1] = max(out[-1][1], hi)
            else:
                out.append([lo, hi])
        merged[t] = ([lo for lo, _ in out], [hi for _, hi in out])
        host_ns += sum(hi - lo for lo, hi in out)
    launcher = {e.correlation_id(): e for e in ops}
    dev_ns = 0
    for k in kernels:
        op = launcher.get(k.linked_correlation_id())
        if op is None or op.start_thread_id() not in merged:
            continue
        los, his = merged[op.start_thread_id()]
        i = bisect.bisect_right(los, op.start_ns()) - 1
        if i >= 0 and op.start_ns() < his[i]:
            dev_ns += k.duration_ns()
    return by_name, host_ns / 1e3, dev_ns / 1e3


def trace_step(label, trainer, scan_module=None):
    """One more step of `trainer` under torch.profiler: device busy time
    against the step's wall time, and the kernels' time by family
    (KERNEL_FAMILIES).  With `scan_module` (a model module that calls
    `chunked_scan`), each of its scans runs inside a `SCAN_RANGE` profiler
    range, and the scans' share of the step's host and device time
    (`read_trace`) is printed too.  Returns {kernel name: device us}."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile
    if scan_module is not None:
        orig = scan_module.chunked_scan

        def ranged(*args, **kw):
            with record_function(SCAN_RANGE):
                return orig(*args, **kw)
        scan_module.chunked_scan = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.run(1)
    finally:
        if scan_module is not None:
            scan_module.chunked_scan = orig
    t0 = time.perf_counter()
    step_us = trainer.history[-1]["seconds"] * 1e6
    by_name, host_us, dev_us = read_trace(prof)
    busy_us = sum(by_name.values())
    if scan_module is not None:
        print(f"phase {label} trace: the recurrence's chunked_scan (its "
              f"forward, both checkpoints' recomputes and its backward "
              f"nodes): host {host_us / 1e3:.3f} ms "
              f"({host_us / step_us:.4f} of the step's wall time), device "
              f"{dev_us / 1e3:.3f} ms ("
              f"{dev_us / busy_us if busy_us > 0 else float('nan'):.4f} of "
              f"the device time)")
    if busy_us <= 0:
        print(f"phase {label} trace: torch.profiler recorded no device time")
        return by_name
    fams = {}
    for name, us in by_name.items():
        low = name.lower()
        fam = next((f for f, keys in KERNEL_FAMILIES if any(
            k in low for k in keys)), "other")
        fams[fam] = fams.get(fam, 0.0) + us
    print(f"phase {label} trace: one step under torch.profiler: "
          f"{step_us / 1e3:.3f} ms wall (profiler on), {busy_us / 1e3:.3f}"
          f" ms of device work in {len(by_name)} kernel names: device "
          f"busy {busy_us / step_us:.4f}, idle "
          f"{1 - busy_us / step_us:.4f}; the trace read in "
          f"{time.perf_counter() - t0:.3f} s")
    print(f"phase {label} trace: device ms by family: " + ", ".join(
        f"{f} {us / 1e3:.3f} ({us / busy_us:.3f})"
        for f, us in sorted(fams.items(), key=lambda kv: -kv[1])))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(f"phase {label} trace: top kernels (device ms): " + "; ".join(
        f"{short_name(n)} {us / 1e3:.3f}" for n, us in top))
    return by_name


def q8_on_gradients(label, grads):
    """Both q8 kernels bit-equal to their plain versions on real gradients
    ({name: tensor} on the card): `quantize_blockwise` and
    `dequantize_blockwise` on each gradient, then the grouped quantize and
    dequantize on the q8 wire's buckets of them (`train.step.
    wire_buckets`).  Returns {name: (q, scales)} of the single calls."""
    import torch
    from repro_torch.kernels import quantize_blockwise as qb
    from repro_torch.train import step as train_step
    wire = {}
    for name, g in grads.items():
        q_, s_ = qb.quantize_blockwise(g)
        q_p, s_p = qb.quantize_blockwise_plain(g)
        if not (bit_equal(q_, q_p) and bit_equal(s_, s_p)):
            fail(f"{label}: quantize_blockwise != plain on the gradient of "
                 f"{name}")
        if not bit_equal(qb.dequantize_blockwise(q_, s_),
                         qb.dequantize_blockwise_plain(q_, s_)):
            fail(f"{label}: dequantize_blockwise != plain on the gradient "
                 f"of {name}")
        wire[name] = (q_, s_)
    wire_list = list(wire.values())
    grad_list = list(grads.values())
    buckets = train_step.wire_buckets(grad_list)
    for bucket in buckets:
        items = [(grad_list[i], torch.empty_like(wire_list[i][0]),
                  torch.empty_like(wire_list[i][1])) for i in bucket]
        qb.quantize_blockwise_group(items)
        for i, (_, q_, s_) in zip(bucket, items):
            if not (bit_equal(q_, wire_list[i][0])
                    and bit_equal(s_, wire_list[i][1])):
                fail(f"{label}: quantize_blockwise_group != plain on a "
                     f"{tuple(q_.shape)} gradient")
        items = [(*wire_list[i], torch.empty(wire_list[i][0].shape,
                                             device=grad_list[i].device))
                 for i in bucket]
        qb.dequantize_blockwise_group(items)
        for q_, s_, out in items:
            if not bit_equal(out, qb.dequantize_blockwise_plain(q_, s_)):
                fail(f"{label}: dequantize_blockwise_group != plain on a "
                     f"{tuple(q_.shape)} gradient")
    shapes = sorted({tuple(g.shape) for g in grads.values()})
    print(f"{label}: quantize_blockwise and dequantize_blockwise bit-equal "
          f"to plain on {len(wire)} real gradients of {len(shapes)} shapes "
          f"{shapes}; quantize_blockwise_group and dequantize_blockwise_group"
          f" bit-equal on the q8 wire's {len(buckets)} buckets of them")
    return wire


def family_step(cfg):
    """Phase 6e's step: `make_train_step` with float32 compute, per-layer
    remat, chunked attention, the q8 wire and q8 moments (FAMILY_OPT)."""
    from repro_torch.train import step as train_step
    return train_step.make_train_step(
        cfg, family_opt(), remat=True, grad_compression="q8",
        compute_dtype=None, attn_impl="chunked")


def family_opt():
    from repro_torch.optim import AdamWConfig
    return AdamWConfig(lr=TRAIN_LR, state_codec="q8")


def family_batches(cfg, batch, seq, steps):
    """`batch_at`'s first `steps` batches of `cfg` on the CPU (seed 0); a
    stub frontend's embeddings in float32, the models' type."""
    from repro_torch.data.pipeline import DataConfig, batch_at
    stub = cfg.frontend != "tokens"
    data = DataConfig(cfg.vocab, batch, seq, seed=0,
                      d_model=cfg.d_model if stub else 0)
    out = []
    for i in range(steps):
        b = batch_at(data, i, device="cpu")
        if stub:
            b["embeds"] = b["embeds"].float()
        out.append(b)
    return out


# 10c and 10d's CPU references take a large CPU tensor a block of rows at a
# time in AdamW and the q8 plain group functions (`cpu_row_blocks`): on
# tensors of gigabytes a whole tensor's temporaries are fresh pages, whose
# first touch costs more than the arithmetic (PERF.md, phase 10)
CPU_ROW_BLOCK_BYTES = 8 << 20


def row_blocks(t):
    """Slices of `t`'s first dimension of about CPU_ROW_BLOCK_BYTES of
    float32 each; one slice of all of it for a tensor off the CPU or of
    fewer than two dimensions."""
    if t.device.type != "cpu" or t.ndim < 2 or t.shape[0] == 0:
        return [slice(None)]
    rows = max(1, CPU_ROW_BLOCK_BYTES // max(1, 4 * t[0].numel()))
    return [slice(i, i + rows) for i in range(0, t.shape[0], rows)]


@contextlib.contextmanager
def cpu_row_blocks():
    """For the block, `adamw_update` (as `train.step` and `mamba_step`
    call it) and the plain q8 group functions (the CPU path of the q8 wire
    and the q8 moments) applied to each CPU tensor a block of rows at a
    time (`row_blocks`), through the port's own functions.  Rows are
    independent (a q8 block lies within a row; AdamW works element by
    element), so the bits are those of one call on the whole tensor."""
    import torch
    from repro_torch import optim
    from repro_torch.kernels import quantize_blockwise as qb
    from repro_torch.train import step as train_step
    update = optim.adamw_update
    q_plain = qb.quantize_blockwise_group_plain
    dq_plain = qb.dequantize_blockwise_group_plain

    def quantize(items, block=qb.DEFAULT_BLOCK):
        for x, q, s in items:
            for r in row_blocks(x):
                q_plain([(x[r], q[r], s[r])], block)

    def dequantize(items, block=qb.DEFAULT_BLOCK):
        for q, s, out in items:
            for r in row_blocks(q):
                dq_plain([(q[r], s[r], out[r])], block)

    def adamw(params, grads, state, cfg):
        moments = state["moments"]
        for name, p in params.named_parameters():
            blocks = row_blocks(p)
            new = {k: torch.empty_like(t) for k, t in moments[name].items()}
            for r in blocks:
                part = torch.nn.Module()
                # a parameter sharing the rows' storage: updated in place
                part.w = torch.nn.Parameter(p.data[r], requires_grad=False)
                sub = {"step": state["step"], "moments": {"w": {
                    k: t[r] for k, t in moments[name].items()}}}
                update(part, {"w": grads[name][r]}, sub, cfg)
                if len(blocks) == 1:
                    new = sub["moments"]["w"]
                else:
                    for k, t in sub["moments"]["w"].items():
                        new[k][r] = t
            moments[name] = new
        state["step"] = state["step"] + 1
        return params, state

    optim.adamw_update = train_step.adamw_update = adamw
    qb.quantize_blockwise_group_plain = quantize
    qb.dequantize_blockwise_group_plain = dequantize
    try:
        yield
    finally:
        optim.adamw_update = train_step.adamw_update = update
        qb.quantize_blockwise_group_plain = q_plain
        qb.dequantize_blockwise_group_plain = dq_plain


def train_card_vs_cpu(label, what, cfg, p_card, step, batches, dev):
    """Phase 6e's method: `p_card` and a CPU copy of the same weights,
    each trained by `step(params, opt_state, batch)` from fresh q8 AdamW
    state (`family_opt`) over `batches` (CPU tensors, moved to each
    device), held to the CPU tests' bounds against JAX: losses within rtol
    TRAIN_LOSS_RTOL, parameters within 6 lr everywhere and within
    TRAIN_PARAM_ATOL on all but TRAIN_FAR_SHARE of them.  MoE routing
    differences (`routing_gaps`, near-ties within ROUTE_GAP) and, for RWKV,
    the rows a group-norm head below variance GN_VAR touched are counted
    and printed, never exempted.  The CPU run takes large tensors a block
    of rows at a time (`cpu_row_blocks`).  Returns the card run's launch
    counts."""
    import copy
    import resource

    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.layers import MoE
    from repro_torch.optim import adamw_init
    p_cpu = copy.deepcopy(p_card).cpu()
    moe = any(isinstance(m, MoE) for m in p_card.modules())
    rwkv = cfg.mixer == "rwkv6"
    routes, hooks = {}, []
    near = {}
    losses, secs = {}, {}
    counts = None
    for where, p_, d_ in (("card", p_card, dev), ("cpu", p_cpu, "cpu")):
        blocked = (cpu_row_blocks() if where == "cpu" else
                   contextlib.nullcontext())
        with blocked:
            if moe:
                routes[where], h = moe_routes(p_)
                hooks += h
            flags, unwatch = (watch_group_norm() if rwkv
                              else ([], lambda: None))
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            state = adamw_init(p_, family_opt())
            losses[where] = []
            for b in batches:
                p_, state, loss = step(p_, state, {k: v.to(d_)
                                                   for k, v in b.items()})
                losses[where].append(float(loss))
            torch.cuda.synchronize()
            secs[where] = time.perf_counter() - t0
            if where == "card":
                counts = launch_counts()
            unwatch()
            near[where] = sum(int(f.sum()) for f in flags)
            state_b = sum(t.numel() * t.element_size()
                          for m in state["moments"].values()
                          for t in m.values())
            del state
    for h in hooks:
        h.remove()
    for a_, b_ in zip(losses["card"], losses["cpu"]):
        if not math.isclose(a_, b_, rel_tol=TRAIN_LOSS_RTOL):
            fail(f"{label}: card losses {losses['card']} and CPU losses "
                 f"{losses['cpu']} differ beyond rtol {TRAIN_LOSS_RTOL}")
    far = total = 0
    worst = 0.0
    for (name, pc), pp in zip(p_card.named_parameters(), p_cpu.parameters()):
        d = (pc.detach() - pp.detach().to(pc.device)).abs()
        worst = max(worst, float(d.max()))
        far += int((d > TRAIN_PARAM_ATOL).sum())
        total += d.numel()
    if worst > 6 * TRAIN_LR or far > TRAIN_FAR_SHARE * total:
        fail(f"{label}: parameters differ by up to {worst} (6 lr = "
             f"{6 * TRAIN_LR}); {far} of {total} beyond {TRAIN_PARAM_ATOL}")
    shape = tuple(next(iter(batches[0].values())).shape)
    param_b = sum(t.numel() * t.element_size() for t in p_cpu.parameters())
    print(f"{label}: {what}: width {cfg.d_model}, {total} float32 "
          f"parameters, batch {shape[0]} x seq {shape[1]}, float32 "
          f"compute, q8 wire "
          f"and q8 moments, {len(batches)} step(s): card losses "
          f"{losses['card']} ({secs['card']:.3f} s), CPU losses "
          f"{losses['cpu']} ({secs['cpu']:.3f} s), within rtol "
          f"{TRAIN_LOSS_RTOL}; parameters within {6 * TRAIN_LR} everywhere "
          f"(max {worst:.3g}), {far} of {total} beyond {TRAIN_PARAM_ATOL}; "
          f"the CPU copy's host bytes reckoned: parameters {param_b}, "
          f"gradients {param_b}, q8 moments {state_b} (sum "
          f"{2 * param_b + state_b}); the process's peak RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024} B")
    if moe:
        routing_gaps(label, routes["card"], routes["cpu"], hold=False)
    if rwkv:
        print(f"{label}: (row, position)s that a group-norm head below "
              f"variance {GN_VAR} touched over the run's forward and "
              f"recompute calls: card {near['card']}, CPU {near['cpu']} "
              f"(counted, held all the same)")
    del p_cpu
    gc.collect()
    return counts


def phase_6f(lm, dev):
    """Save, kill and resume TinyLlama-1.1B training at phase 6c's
    configuration (10 GB budget: q8 moments and the q8 wire), held to an
    uninterrupted run; a q8 save and restore through the grouped kernels;
    a card-written q8 checkpoint byte-identical to the CPU's; a damaged
    leaf; the launcher resuming.  The launch counters are zeroed just
    before and read just after; returns them."""
    import os
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import (launch_counts, quantize_blockwise as qb,
                                     reset_launch_counts)
    from repro_torch.launch import train as launcher
    from repro_torch.models import model as MD
    from repro_torch.models.interop import checkpoint_leaves
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import step as train_step
    from repro_torch.train.loop import TrainConfig, Trainer

    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 6f: device memory still allocated from earlier phases "
          f"{torch.cuda.memory_allocated(dev)} B")
    torch.cuda.synchronize()
    reset_launch_counts()
    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_6f_"))
    try:
        def config(steps, ckdir=None):
            return TrainConfig(
                steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
                hbm_budget_bytes=TRAIN_BUDGETS[1], seed=0, log_every=1,
                checkpoint_dir=ckdir, checkpoint_every=CKPT_EVERY,
                keep_last_k=1)

        def save_line(label, mgr):
            s = mgr.last_save
            return (f"phase 6f: {label}: {mgr.save_seconds + s['snapshot_s']:.3f}"
                    f" s (snapshot to host {s['snapshot_s']:.3f}, encode "
                    f"{s['encode_s']:.3f}, write + fsync {s['write_s']:.3f})"
                    f"; raw {s['raw_bytes']} B, stored {s['stored_bytes']} B,"
                    f" ratio {s['stored_bytes'] / s['raw_bytes']:.4f}; "
                    f"{mgr.threads} threads")

        # T0: the uninterrupted run, its state at step 3 and at the end
        t0_ = Trainer(lm, config(CKPT_STEPS[0] + CKPT_STEPS[1]), device=dev)
        if t0_.opt_cfg.state_codec != "q8":
            fail("phase 6f: the 10 GB plan does not compress the moments")
        raw_state = sum(t.numel() * t.element_size() for _, ts in
                        checkpoint_leaves(t0_.params,
                                          t0_.opt_state).values()
                        for t in ts)
        free = shutil.disk_usage(root).free
        print(f"phase 6f: checkpoint directory {root}: {free} B free before "
              f"the phase; the state holds {raw_state} B raw; "
              f"os.cpu_count() {os.cpu_count()}")
        if free < DISK_FACTOR * raw_state:
            fail(f"phase 6f: {free} B free under {root}, less than "
                 f"{DISK_FACTOR} x the state's {raw_state} raw bytes (a "
                 "save holds the old checkpoint and the new .tmp at once)")
        t0_.run(CKPT_STEPS[0])
        at3 = host_copy(t0_.params)
        t0_.run(CKPT_STEPS[1])
        whole_end = host_copy(t0_.params)
        whole = [h["loss"] for h in t0_.history]
        del t0_
        gc.collect()
        torch.cuda.empty_cache()

        # T1: the same run with a checkpoint directory, stopped after 3
        ck_a = root / "run"
        torch.cuda.reset_peak_memory_stats(dev)
        t1 = Trainer(lm, config(CKPT_STEPS[0], str(ck_a)), device=dev)
        t1.run()
        torch.cuda.synchronize()
        peak1 = torch.cuda.max_memory_allocated(dev)
        print(save_line(f"T1's save at step {t1.step}", t1.ckpt))
        saved = host_copy(t1.params, t1.opt_state)
        first = [h["loss"] for h in t1.history]
        del t1
        gc.collect()
        torch.cuda.empty_cache()
        loss_spread = max(abs(a - b) for a, b in zip(first, whole))
        n_unequal, param_spread = state_gap(
            {k: v for k, v in saved.items() if k.startswith("params/")},
            at3)
        bitwise = first == whole[:CKPT_STEPS[0]] and n_unequal == 0
        print(f"phase 6f: determinism baseline: T1's losses {first} against "
              f"T0's first {CKPT_STEPS[0]} {whole[:CKPT_STEPS[0]]}: "
              + ("bitwise equal, parameters too" if bitwise else
                 f"apart by up to {loss_spread!r} (losses) and "
                 f"{param_spread!r} ({n_unequal} parameter tensors differ)"))

        # T2: a new trainer on the same directory resumes at step 3
        torch.cuda.reset_peak_memory_stats(dev)
        t_ = time.perf_counter()
        t2 = Trainer(lm, config(CKPT_STEPS[1], str(ck_a)), device=dev)
        built = time.perf_counter() - t_
        if t2.step != CKPT_STEPS[0]:
            fail(f"phase 6f: T2 starts at step {t2.step}, not "
                 f"{CKPT_STEPS[0]}")
        n_bad, gap = state_gap(host_copy(t2.params, t2.opt_state), saved)
        if n_bad:
            fail(f"phase 6f: {n_bad} restored tensors differ from T1's at its"
                 f" save, by up to {gap}")
        print(f"phase 6f: T2 restored step {t2.step}: every one of "
              f"{sum(len(v) for v in saved.values())} parameter, moment and "
              f"step tensors bit-equal to T1's at its save; restore "
              f"{t2.ckpt.restore_seconds:.3f} s (the trainer built in "
              f"{built:.3f} s)")
        del saved
        t2.run()
        torch.cuda.synchronize()
        peak2 = torch.cuda.max_memory_allocated(dev)
        print(save_line(f"T2's save at step {t2.step}", t2.ckpt))
        resumed = [h["loss"] for h in t2.history]
        n_bad, gap = state_gap(host_copy(t2.params), whole_end)
        loss_gap = max(abs(a - b) for a, b in
                       zip(resumed, whole[CKPT_STEPS[0]:]))
        if bitwise:
            if resumed != whole[CKPT_STEPS[0]:] or n_bad:
                fail(f"phase 6f: resumed losses {resumed} against T0's "
                     f"{whole[CKPT_STEPS[0]:]}; {n_bad} final parameter "
                     f"tensors differ (by up to {gap}) with a bitwise "
                     "determinism baseline")
        elif loss_gap > loss_spread or gap > param_spread:
            fail(f"phase 6f: resumed losses {resumed} against T0's "
                 f"{whole[CKPT_STEPS[0]:]} (apart by {loss_gap!r}), final "
                 f"parameters apart by {gap!r}: beyond the baseline's "
                 f"{loss_spread!r} and {param_spread!r}")
        print(f"phase 6f: T2's losses {resumed} against T0's "
              f"{whole[CKPT_STEPS[0]:]}: "
              + ("bitwise equal, and its final parameters bit-equal to "
                 "T0's" if bitwise else
                 f"apart by {loss_gap!r}, final parameters by {gap!r} "
                 f"({n_bad} tensors), within the baseline's spread")
              + f"; peak device memory T1 {peak1} B, T2 {peak2} B")
        del at3, whole_end

        # a q8 save of T2's parameters and its restore into a fresh model
        mgr_q8 = CheckpointManager(CheckpointConfig(
            str(root / "q8"), keep_last_k=1, params_codec="q8+zlib"))
        names = [n for n, _ in t2.params.named_parameters()]
        want_launches = -(-len(names) // qb.group_capacity())
        before = launch_counts()
        mgr_q8.save(t2.step, t2.params)
        q_launches = (launch_counts()["quantize_blockwise"] -
                      before["quantize_blockwise"])
        fresh = MD.init_params(torch.Generator(dev).manual_seed(1), lm,
                               device=dev)
        before = launch_counts()
        mgr_q8.restore_into(fresh)
        torch.cuda.synchronize()
        dq_launches = (launch_counts()["dequantize_blockwise"] -
                       before["dequantize_blockwise"])
        print(save_line("q8+zlib save of T2's parameters", mgr_q8))
        print(f"phase 6f: q8+zlib restore into a fresh CUDA model "
              f"{mgr_q8.restore_seconds:.3f} s; {q_launches} quantize_blockwise"
              f" and {dq_launches} dequantize_blockwise launches for "
              f"{len(names)} tensors (group capacity {qb.group_capacity()})")
        if q_launches != want_launches or dq_launches != want_launches:
            fail(f"phase 6f: the q8 save made {q_launches} quantize and its "
                 f"restore {dq_launches} dequantize launches, not "
                 f"{want_launches} each")
        for (name, p_), f_ in zip(t2.params.named_parameters(),
                                  fresh.parameters()):
            want = qb.dequantize_blockwise_plain(
                *qb.quantize_blockwise_plain(p_))
            if not bit_equal(f_.detach(), want):
                fail(f"phase 6f: the q8 restore of {name} != plain "
                     "dequantize(quantize(p)) on the card")
        del fresh, want, t2
        gc.collect()
        torch.cuda.empty_cache()

        # the q8 checkpoint of phase 6e's model: the card's bytes are the
        # CPU's
        lm2 = dataclasses.replace(lm, name=f"{LM_ARCH}-depth2", n_layers=2)
        opt2 = AdamWConfig(lr=TRAIN_LR, state_codec="q8")
        p_card = MD.init_params(torch.Generator(dev).manual_seed(0), lm2,
                                device=dev)
        st_card = adamw_init(p_card, opt2)
        step2 = train_step.make_train_step(lm2, opt2, remat=True,
                                           grad_compression="q8",
                                           attn_impl="chunked")
        step2(p_card, st_card, batch_at(DataConfig(
            vocab=lm.vocab, batch=1, seq=TRAIN_SEQ, seed=0), 0, dev))
        p_cpu = MD.init_params(torch.Generator().manual_seed(0), lm2,
                               device="cpu")
        p_cpu.load_state_dict(p_card.state_dict())
        st_cpu = {"step": st_card["step"].cpu(),
                  "moments": {n: {k: v.cpu() for k, v in m.items()}
                              for n, m in st_card["moments"].items()}}
        for where, p_, st_ in (("card", p_card, st_card),
                               ("cpu", p_cpu, st_cpu)):
            CheckpointManager(CheckpointConfig(
                str(root / f"depth2_{where}"),
                params_codec="q8+zlib")).save(1, p_, st_)
        card_dir, cpu_dir = (root / f"depth2_{w}" / "step_00000001"
                             for w in ("card", "cpu"))
        files = sorted(p.name for p in card_dir.iterdir())
        if files != sorted(p.name for p in cpu_dir.iterdir()):
            fail("phase 6f: the card's and the CPU's depth-2 q8 checkpoints "
                 "hold different files")
        differ = [f for f in files if (card_dir / f).read_bytes() !=
                  (cpu_dir / f).read_bytes()]
        if differ:
            fail(f"phase 6f: the depth-2 q8 checkpoint from the card differs "
                 f"from the CPU's in {differ}")
        print(f"phase 6f: depth-2 width-{lm2.d_model} model after one q8 "
              f"step on the card: its q8+zlib checkpoint ({len(files)} files,"
              f" {dir_bytes(card_dir)} B) byte-identical to the one written "
              f"from its CPU copy")
        del p_card, p_cpu, st_card, st_cpu, step2

        # a damaged leaf: the smallest file of the run's checkpoint
        last = ck_a / f"step_{CKPT_STEPS[0] + CKPT_STEPS[1]:08d}"
        leaf = min(last.glob("leaf_*.bin"), key=lambda p: p.stat().st_size)
        raw = bytearray(leaf.read_bytes())
        raw[len(raw) // 2] ^= 0x01
        leaf.write_bytes(bytes(raw))
        t_ = time.perf_counter()
        try:
            CheckpointManager(CheckpointConfig(str(ck_a))).restore()
        except IOError as e:
            if "checksum" not in str(e):
                raise
            print(f"phase 6f: a byte flipped in {leaf.name} ({len(raw)} B): "
                  f"restore raised after {time.perf_counter() - t_:.3f} s: "
                  f"{e}")
        else:
            fail(f"phase 6f: restore read {leaf} with a flipped byte")

        # the launcher, twice on one directory
        argv = ["--arch", LM_ARCH, "--checkpoint-dir", str(root / "launch")]
        ta = launcher.main(argv + ["--steps", "4"])
        tb = launcher.main(argv + ["--steps", "2"])
        if (ta.step, tb.history[0]["step"], tb.step) != (4, 4, 6):
            fail(f"phase 6f: the launcher ran to step {ta.step}, then from "
                 f"{tb.history[0]['step']} to {tb.step}, not 4, 4 to 6")
        print(f"phase 6f: the launcher ({ta.cfg.name}, {ta.device}) ran steps"
              f" 0-3, then resumed at step 4 and ended at step 6")
        del ta, tb
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"phase 6f: {time.perf_counter() - t_phase:.3f} s; launches "
          f"{json.dumps(counts)}")
    for k in ("quantize_blockwise", "dequantize_blockwise"):
        if counts[k] == 0:
            fail(f"phase 6f: no {k} launch")
    return counts


def serve_requests(params, cfg, prompts, uids, dev, kv="f32"):
    """Phase 5's engine run: one request submitted per engine step, then
    drained (batch LM_SLOTS, max_len LM_MAX_LEN, LM_NEW tokens each)."""
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    eng = ServeEngine(cfg, params, EngineConfig(
        batch_slots=LM_SLOTS, max_len=LM_MAX_LEN, kv_dtype=kv), device=dev)
    for uid in uids:
        eng.submit(Request(uid=uid, prompt=list(prompts[uid]),
                           max_new_tokens=LM_NEW))
        eng.step()
    eng.run_until_drained()
    return eng


def engine_vs_forward(params, cfg, prompt, dev):
    """One request through a float32-KV engine, each step's logits of its
    slot recorded, and `forward` over the tokens the engine was fed:
    (the tokens, the engine's logits, forward's), logits (steps, vocab)."""
    import torch
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    eng = ServeEngine(cfg, params, EngineConfig(
        batch_slots=LM_SLOTS, max_len=LM_MAX_LEN, kv_dtype="f32"),
        device=dev)
    seen = []
    decode = eng._decode

    def recording(p, st, t, a):
        logits, st = decode(p, st, t, a)
        seen.append(logits[0, 0].clone())
        return logits, st
    eng._decode = recording
    eng.submit(Request(uid=0, prompt=list(prompt), max_new_tokens=LM_NEW))
    eng.run_until_drained()
    fed = list(prompt) + eng.finished[0].out_tokens[:-1]
    full = MD.forward(params, cfg, torch.tensor([fed], device=dev))[0]
    stepwise = torch.stack(seen)
    if stepwise.shape != full.shape:
        fail(f"{tuple(stepwise.shape)} engine logits against forward's "
             f"{tuple(full.shape)}")
    return fed, stepwise, full


def moe_routes(params):
    """Forward pre-hooks on every MoE layer of `params` that keep each
    call's routing as the layer computes it then (`moe_routing`: router
    logits, expert indices, keep mask; copied to the CPU); returns (the
    list they fill, the hook handles)."""
    import torch
    from repro_torch.models.layers import MoE, moe_routing
    seen = []

    def hook(mod, args):
        with torch.no_grad():
            logits, _, idx, _, keep = moe_routing(
                mod, args[0].reshape(-1, args[0].shape[-1]), mod.moe)
        seen.append((logits.cpu(), idx.cpu(), keep.cpu()))
    hooks = [m.register_forward_pre_hook(hook) for m in params.modules()
             if isinstance(m, MoE)]
    return seen, hooks


def routing_gaps(label, card_seen, cpu_seen, hold=True):
    """Compare the card's MoE routing with the CPU's, call by call
    (`moe_routes`): expert indices and keep masks equal, or an index
    difference where the CPU's router logits of the two experts lie within
    ROUTE_GAP (a near-tie; with `hold`, a wider gap fails).  Returns (the
    assignments that differ, those at near-ties)."""
    import torch
    if len(card_seen) != len(cpu_seen):
        fail(f"{label}: {len(card_seen)} MoE calls on the card, "
             f"{len(cpu_seen)} on the CPU")
    diffs, ties, gaps, n = 0, 0, [], 0
    for (_, idx_c, keep_c), (logits, idx, keep) in zip(card_seen, cpu_seen):
        n += idx.numel()
        diff = idx_c != idx
        if not diff.any():
            if hold and not torch.equal(keep_c, keep):
                fail(f"{label}: equal expert picks, different keep masks")
            continue
        t, j = torch.nonzero(diff, as_tuple=True)
        gap = (logits[t, idx_c[t, j]] - logits[t, idx[t, j]]).abs()
        gaps += gap.tolist()
        if hold and float(gap.max()) > ROUTE_GAP:
            fail(f"{label}: the card routes {int(diff.sum())} assignments "
                 f"to other experts than the CPU, router-logit gaps up to "
                 f"{float(gap.max()):.3g} > {ROUTE_GAP}")
        diffs += int(diff.sum())
        ties += int((gap <= ROUTE_GAP).sum())
    print(f"{label}: MoE routing card vs CPU over {len(card_seen)} layer "
          f"calls, {n} assignments: {diffs} differ"
          + (f" ({ties} at near-ties within {ROUTE_GAP}), router-logit "
             f"gaps {sorted(gaps)[:16]}{' ...' if len(gaps) > 16 else ''}"
             if diffs else "; keep masks equal"))
    return diffs, ties


def watch_group_norm():
    """Wrap the RWKV block's per-head group norm to record, per call, which
    (batch row, position) had a head whose WKV output's variance lies below
    GN_VAR; returns (the list of (B, S) bool CPU tensors, the undo)."""
    import torch
    from repro_torch.models import rwkv as R
    orig = R._group_norm
    near = []

    def watched(y, scale, eps):
        with torch.no_grad():
            var = y.float().var(dim=-1, correction=0)      # (B, S, H)
        near.append((var < GN_VAR).any(-1).cpu())
        return orig(y, scale, eps)
    R._group_norm = watched
    return near, lambda: setattr(R, "_group_norm", orig)


def card_vs_cpu(label, arch, cfg, p_card, p_cpu, dev):
    """Phase 6e's method for a family: the same weights on the card and on
    the CPU; `forward` logits over a `batch_at` batch, then FAMILY_DECODES
    `decode_step`s with `active` masks and one `reset_slot`, logits and
    serving state, within FAMILY_TOL.  Two exemptions, each triggered by a
    measured property of the inputs, never by the error itself, and each
    counted and printed: MoE routing differences at near-ties
    (`routing_gaps`), and for RWKV the rows a group-norm head near its eps
    has touched (GN_VAR, on either device): a forward row from that
    position on, a decode slot's logits at that step, and its state until
    it is reset."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import model as MD
    stub = cfg.frontend != "tokens"
    rwkv = cfg.mixer == "rwkv6"
    batch = batch_at(DataConfig(cfg.vocab, FAMILY_BATCH, FAMILY_SEQ, seed=0,
                                d_model=cfg.d_model if stub else 0), 0,
                     device="cpu")
    embeds = batch["embeds"].float() if stub else None
    seen = {}
    hooks = []
    for where, p_ in (("card", p_card), ("cpu", p_cpu)):
        seen[where], h = moe_routes(p_)
        hooks += h
    near, unwatch = watch_group_norm() if rwkv else ([], lambda: None)

    def touched(shape):
        """The rows the recorded group-norm calls flagged, then clear."""
        flags = torch.stack(near).any(0) if near else \
            torch.zeros(shape, dtype=torch.bool)
        near.clear()
        return flags

    t0 = time.perf_counter()
    with torch.no_grad():
        out = {}
        for where, p_, d_ in (("card", p_card, dev), ("cpu", p_cpu, "cpu")):
            out[where] = MD.forward(
                p_, cfg, batch["tokens"].to(d_),
                None if embeds is None else embeds.to(d_)).cpu()
        fwd_taint = touched((FAMILY_BATCH, FAMILY_SEQ)).int().cummax(
            dim=1).values.bool()
        steps = {"forward": (out["card"], out["cpu"],
                             ~fwd_taint[..., None])}
        states = {where: MD.init_serve_state(cfg, FAMILY_BATCH, 32,
                                             torch.float32, device=d_)
                  for where, d_ in (("card", dev), ("cpu", "cpu"))}
        slot_taint = torch.zeros(FAMILY_BATCH, dtype=torch.bool)
        rng = np.random.default_rng(7)
        for step in range(FAMILY_DECODES):
            toks = torch.from_numpy(rng.integers(
                0, cfg.vocab, (FAMILY_BATCH, 1)).astype(np.int32))
            active = torch.tensor([True, step % 2 == 0, step != 3,
                                   step > 1])
            got = {}
            for where, p_, d_ in (("card", p_card, dev),
                                  ("cpu", p_cpu, "cpu")):
                logits, states[where] = MD.decode_step(
                    p_, states[where], cfg, toks.to(d_), active.to(d_))
                got[where] = logits.cpu()
                if step == 4:
                    states[where] = MD.reset_slot(states[where], cfg, 2)
            flags = touched((FAMILY_BATCH, 1))[:, 0]
            steps[f"decode {step}"] = (got["card"], got["cpu"],
                                       ~(slot_taint | flags)[:, None, None])
            slot_taint |= flags & active
            if step == 4:
                slot_taint[2] = False
    unwatch()
    for name, axis in (("kv", 1), ("rwkv", 1), ("mamba", 2)):
        for k, v in states["cpu"].get(name, {}).items():
            shape = [1] * v.ndim
            shape[axis] = -1
            steps[f"state {name}/{k}"] = (states["card"][name][k].cpu(), v,
                                          ~slot_taint.reshape(shape))
    seconds = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    ties = routing_gaps(label, seen["card"], seen["cpu"])[1] \
        if cfg.moe is not None else 0
    worst, exempt = {}, 0.0
    for what, (a, b, held) in steps.items():
        a, b = a.float(), b.float()
        diff = (a - b).abs()
        held = held.expand_as(diff)
        worst[what] = float(diff[held].max()) if held.any() else 0.0
        if not held.all():
            exempt = max(exempt, float(diff[~held].max()))
        far = ~torch.isclose(a, b, rtol=FAMILY_TOL, atol=FAMILY_TOL) & held
        if bool(far.any()) and not ties:
            fail(f"{label}: {what} on the card differs from the CPU by "
                 f"{worst[what]} (rtol and atol {FAMILY_TOL})")
    def part(prefix):
        return max([v for k, v in worst.items() if k.startswith(prefix)]
                   or [0.0])

    gn = (f"; group-norm heads below variance {GN_VAR}: forward rows "
          f"{int(fwd_taint.any(1).sum())} of {FAMILY_BATCH} from position "
          f"{[int(r.nonzero()[0]) if r.any() else None for r in fwd_taint]}"
          f", decode slots tainted at the end "
          f"{slot_taint.nonzero().flatten().tolist()}, their max abs err "
          f"{exempt:.3g} (not held)" if rwkv else "")
    print(f"{label}: {arch} width {cfg.d_model}, depth {cfg.n_layers}, "
          f"{sum(p.numel() for p in p_card.parameters())} float32 "
          f"parameters: forward over {FAMILY_BATCH} x {FAMILY_SEQ} "
          f"{'stub embeddings' if stub else 'tokens'} and {FAMILY_DECODES} "
          f"decode steps with active masks and a reset_slot, card vs CPU "
          f"in {seconds:.3f} s: max abs err forward "
          f"{worst['forward']:.3g}, decode {part('decode'):.3g}, state "
          f"{part('state'):.3g}"
          + (f" (within rtol and atol {FAMILY_TOL})" if not ties else
             f" (not held: {ties} near-tie routing differences)") + gn)


def phase_7(dev, prompts):
    """The remaining model families on the card: granite-moe-3b-a800m and
    rwkv6-7b served at full size, every family's card run held to the CPU
    at full width and depth 2, and the hybrid at its smoke size and its
    Mamba block at Jamba's width."""
    import copy

    import numpy as np
    import torch
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import mamba as MB, model as MD
    from repro_torch.models.layers import MoE, moe_capacity, moe_routing

    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 7: device memory still allocated from earlier phases "
          f"{torch.cuda.memory_allocated(dev)} B")
    t_phase = time.perf_counter()
    made = LM_REQUESTS * LM_NEW
    prefill = sum(len(p_) - 1 for p_ in prompts)

    def full_model(arch):
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params = MD.init_params(torch.Generator(dev).manual_seed(0), cfg,
                                device=dev)
        torch.cuda.synchronize()
        print(f"phase 7: {arch}: {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, vocab {cfg.vocab}: "
              f"{sum(p.numel() for p in params.parameters())} float32 "
              f"parameters made on the card by init_params (seed 0) in "
              f"{time.perf_counter() - t0:.3f} s; device memory allocated "
              f"{torch.cuda.memory_allocated(dev)} B")
        return cfg, params

    def timed_serve(label, params, cfg):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        eng = serve_requests(params, cfg, prompts, range(LM_REQUESTS), dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if sorted(eng.finished) != list(range(LM_REQUESTS)) or any(
                len(q.out_tokens) != LM_NEW for q in eng.finished.values()):
            fail(f"{label}: not every request finished with its tokens")
        print(f"{label}: ServeEngine(batch_slots={LM_SLOTS}, max_len="
              f"{LM_MAX_LEN}, kv f32): {LM_REQUESTS} requests (phase 5's "
              f"prompts), {LM_NEW} new each: {eng.steps} engine steps and "
              f"{prefill} prefill steps in {wall:.3f} s; "
              f"{made / wall:.2f} generated tokens/s "
              f"({(made + prefill) / wall:.2f} tokens/s counting prefill); "
              f"peak device memory "
              f"{torch.cuda.max_memory_allocated(dev)} B")
        return {u: q.out_tokens for u, q in eng.finished.items()}

    with torch.no_grad():
        # ---- 7a: granite-moe-3b-a800m at full size ----------------------
        cfg, params = full_model(MOE_ARCH)
        first = timed_serve("phase 7a", params, cfg)
        shares, calls = [], []
        hooks = [m.register_forward_pre_hook(
            lambda mod, args: calls.append(moe_routing(
                mod, args[0].reshape(-1, args[0].shape[-1]), mod.moe)[4]))
            for m in params.modules() if isinstance(m, MoE)]
        eng = serve_requests(params, cfg, prompts, range(LM_REQUESTS), dev)
        for h in hooks:
            h.remove()
        again = {u: q.out_tokens for u, q in eng.finished.items()}
        if again != first:
            fail("phase 7a: two runs of the same 8 requests give different "
                 "tokens")
        for i in range(0, len(calls), cfg.n_layers):
            keep = torch.stack(calls[i:i + cfg.n_layers])
            shares.append(float(keep.float().mean()))
        print(f"phase 7a: a second run gives the same tokens; kept share "
              f"of the {LM_SLOTS} x {cfg.moe.top_k} expert assignments per "
              f"decode call (capacity {moe_capacity(LM_SLOTS, cfg.moe)} "
              f"row(s) per expert at T = "
              f"{LM_SLOTS}, every slot routed), over the {len(shares)} calls"
              f": mean {np.mean(shares):.4f}, min {min(shares):.4f}, max "
              f"{max(shares):.4f}; per call "
              f"{[round(x, 3) for x in shares]}")
        del params, eng, calls
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 7b: rwkv6-7b at full size -----------------------------------
        cfg, params = full_model(RWKV_ARCH)
        crowd = timed_serve("phase 7b", params, cfg)
        alone = serve_requests(params, cfg, prompts, [0], dev
                               ).finished[0].out_tokens
        if alone != crowd[0]:
            fail(f"phase 7b: request 0 alone gives {alone}, with the others "
                 f"admitted mid-flight {crowd[0]}")
        print(f"phase 7b: request 0 alone gives the same {LM_NEW} tokens as "
              "with the others admitted mid-flight")
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, (LM_SLOTS, FWD_SEQ)).astype(np.int32)).to(dev)
        for run in ("first", "second"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = MD.forward(params, cfg, toks)
            torch.cuda.synchronize()
            print(f"phase 7b: forward over {LM_SLOTS} x {FWD_SEQ} tokens "
                  f"({cfg.n_layers} layers x {FWD_SEQ} scan steps), {run} "
                  f"call: {time.perf_counter() - t0:.3f} s")
        if not bool(torch.isfinite(logits).all()):
            fail("phase 7b: forward gave non-finite logits")
        fed, stepwise, full = engine_vs_forward(params, cfg, prompts[0], dev)
        gap = (stepwise - full).abs().amax(-1)
        # the engine turns the logits of the last prompt token and of every
        # generated token into tokens; the prefill steps' logits before
        # them are computed, compared and printed, not held (see PERF.md
        # §6, PR 24: the first token's WKV output is rank one, and heads
        # whose group norm then sits near its eps turn float32 rounding
        # into ~0.1 of logit, a gap that decays over the next ~10 steps)
        served = gap[len(prompts[0]) - 1:]
        err = float(served.max())
        if err > LOGITS_ATOL:
            fail(f"phase 7b: the engine's logits at the {len(served)} steps "
                 f"it samples from differ from forward by {err} > "
                 f"{LOGITS_ATOL}")
        print(f"phase 7b: float32: the engine's logits at the {len(served)}"
              f" steps it samples from (the last prompt token on) agree "
              f"with forward over the same tokens (max abs err {err:.3g} <= "
              f"{LOGITS_ATOL}; max |logit| {float(full.abs().max()):.4g}); "
              f"at all {len(fed)} steps, not held: max abs err "
              f"{float(gap.max()):.4g}, by position "
              f"{[float(f'{v:.3g}') for v in gap.tolist()]}")
        near, unwatch = watch_group_norm()
        MD.forward(params, cfg, torch.tensor([fed], device=dev))
        unwatch()
        print(f"phase 7b: forward over request 0's {len(fed)} tokens: "
              f"group-norm heads below variance {GN_VAR} at (layer, "
              f"positions) " + str([(i, f[0].nonzero().flatten().tolist())
                                    for i, f in enumerate(near)
                                    if f.any()]))
        del params, full, stepwise, logits
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 7c: card vs CPU at full width, depth 2 ----------------------
        for arch in WIDE_ARCHS:
            cfg = dataclasses.replace(get_config(arch), name=f"{arch}-depth2",
                                      n_layers=2)
            p_card = MD.init_params(torch.Generator(dev).manual_seed(0),
                                    cfg, device=dev)
            p_cpu = copy.deepcopy(p_card).cpu()
            card_vs_cpu("phase 7c", arch, cfg, p_card, p_cpu, dev)
            del p_card, p_cpu
            gc.collect()
            torch.cuda.empty_cache()

        # ---- 7d: the hybrid ------------------------------------------------
        cfg = smoke_config(HYBRID_ARCH)
        p_card = MD.init_params(torch.Generator(dev).manual_seed(0), cfg,
                                device=dev)
        card_vs_cpu("phase 7d", HYBRID_ARCH, cfg, p_card,
                    copy.deepcopy(p_card).cpu(), dev)
        cfg = get_config(HYBRID_ARCH)
        blk = MB.init_mamba_block(torch.Generator(dev).manual_seed(0), cfg,
                                  device=dev)
        blk_cpu = copy.deepcopy(blk).cpu()
        g = torch.Generator().manual_seed(3)
        din, ds = MB.d_inner(cfg), cfg.hybrid.d_state
        state = {w: (torch.zeros((MAMBA_BATCH, cfg.hybrid.d_conv - 1, din),
                                 device=d_),
                     torch.zeros((MAMBA_BATCH, din, ds), device=d_))
                 for w, d_ in (("card", dev), ("cpu", "cpu"))}
        worst = 0.0
        t0 = time.perf_counter()
        for step, s in enumerate([MAMBA_PREFILL] + [1] * FAMILY_DECODES):
            x = torch.randn((MAMBA_BATCH, s, cfg.d_model), generator=g)
            out = {}
            for w, b_, d_ in (("card", blk, dev), ("cpu", blk_cpu, "cpu")):
                y, conv, ssm = MB.mamba_sequence(b_, x.to(d_), cfg,
                                                 *state[w])
                state[w] = (conv, ssm)
                out[w] = (y.cpu(), conv.cpu(), ssm.cpu())
            for a, b in zip(out["card"], out["cpu"]):
                worst = max(worst, float((a - b).abs().max()))
                if not torch.allclose(a, b, rtol=FAMILY_TOL,
                                      atol=FAMILY_TOL):
                    fail(f"phase 7d: the Mamba block at width {cfg.d_model}"
                         f" differs card vs CPU by "
                         f"{float((a - b).abs().max())} at call {step}")
        print(f"phase 7d: {HYBRID_ARCH}'s Mamba block alone at d_model "
              f"{cfg.d_model}, d_inner {din}, d_state {ds} "
              f"({sum(p.numel() for p in blk.parameters())} float32 "
              f"parameters): a {MAMBA_PREFILL}-token prefill at B = "
              f"{MAMBA_BATCH}, then {FAMILY_DECODES} decode steps from the "
              f"carried conv and ssm state, card vs CPU in "
              f"{time.perf_counter() - t0:.3f} s: max abs err {worst:.3g} "
              f"(outputs and states within rtol and atol {FAMILY_TOL})")
        del p_card, blk, blk_cpu, state, out
        gc.collect()
        torch.cuda.empty_cache()
    print(f"phase 7: {time.perf_counter() - t_phase:.3f} s")


def phase_8(lm, dev):
    """Phase 8: distribution and launch.  8a the sharded training step
    (TinyLlama-1.1B, phase 6's configuration: Trainer.reshard onto a 1x1
    NCCL mesh, FSDP2) against the unsharded step from the same seed; 8b
    the step's FLOPs counted on the card beside the census and the report's
    t_bound beside the measured step; 8c the dry run.  Returns the sharded
    run's launch counts."""
    import torch
    from repro_torch.data.pipeline import batch_at
    from repro_torch.distributed.sharding import (activation_specs,
                                                  param_specs)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import census as CS, dryrun as DR
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.mesh import dist_config, make_smoke_mesh
    from repro_torch.train.loop import TrainConfig, Trainer
    from torch.utils.flop_counter import FlopCounterMode

    t_phase = time.perf_counter()
    torch.set_grad_enabled(True)
    try:
        mesh = make_smoke_mesh(dev)
    except Exception as e:  # noqa: BLE001: the phase fails on it
        fail(f"phase 8a: the NCCL group or the 1x1 mesh failed: "
             f"{type(e).__name__}: {e}")
    dist = dist_config()
    act = activation_specs(dist)
    steps = 3

    def run(sharded):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        tr = Trainer(lm, TrainConfig(
            steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
            hbm_budget_bytes=TRAIN_BUDGETS[0], seed=0, log_every=1),
            device=dev)
        if sharded:
            tr.reshard(mesh, param_specs(tr.params, lm, dist, mesh),
                       {"hidden": act["hidden"], "logits": act["logits"]})
        tr.run()
        torch.cuda.synchronize()
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        secs = [h["seconds"] for h in tr.history]
        return tr, counts, peak, secs

    def busy(tr):
        """Device busy share of one more step under torch.profiler."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tr.run(1)
        step_us = tr.history[-1]["seconds"] * 1e6
        dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
        return dev_us / step_us if dev_us > 0 else float("nan")

    plain, counts_p, peak_p, secs_p = run(False)
    want = host_copy(plain.params, plain.opt_state)
    losses_p = [h["loss"] for h in plain.history]
    busy_p = busy(plain)
    n_group = q8_per_step(plain)[0]
    del plain
    sharded, counts_s, peak_s, secs_s = run(True)
    got = host_copy(sharded.params, sharded.opt_state)
    losses_s = [h["loss"] for h in sharded.history][:steps]
    kinds = sorted({type(p_).__name__ for p_ in sharded.params.parameters()})
    print(f"phase 8a: Trainer({LM_ARCH}, batch {TRAIN_BATCH}, seq "
          f"{TRAIN_SEQ}, lr {TRAIN_LR}, plan {sharded.plan.choices}) "
          f"resharded onto mesh {tuple(mesh.mesh_dim_names)} "
          f"{tuple(mesh.mesh.shape)} over "
          f"{torch.distributed.get_backend()} (parameters {kinds}, "
          f"n_chips {sharded.n_chips}); {steps} steps each")
    print(f"phase 8a: losses sharded {losses_s}, unsharded {losses_p}")
    for label, secs, peak, b in (("unsharded", secs_p, peak_p, busy_p),
                                 ("sharded", secs_s, peak_s, None)):
        step_s = sum(secs[1:steps]) / (steps - 1)
        if b is None:
            b = busy(sharded)
        print(f"phase 8a: {label}: step seconds {secs[:steps]}, "
              f"{step_s:.4f} s per step without step 0, device busy "
              f"{b:.4f} (one more step under torch.profiler), peak device "
              f"memory {peak} B")
    step_s8 = sum(secs_s[1:steps]) / (steps - 1)
    unequal, gap = state_gap(want, got)
    if losses_s != losses_p or unequal:
        print(f"phase 8a: NOT bit-equal: {unequal} tensors differ, by up "
              f"to {gap}; losses {losses_s} against {losses_p}")
        for a_, b_ in zip(losses_s, losses_p):
            if not math.isclose(a_, b_, rel_tol=TRAIN_LOSS_RTOL):
                fail(f"phase 8a: losses {losses_s} and {losses_p} differ "
                     f"beyond rtol {TRAIN_LOSS_RTOL}")
        far = total = 0
        for k in want:
            if not k.startswith("params/"):
                continue
            for x, y in zip(want[k], got[k]):
                d = (x.double() - y.double()).abs()
                far += int((d > TRAIN_PARAM_ATOL).sum())
                total += d.numel()
        if gap > 6 * TRAIN_LR or far > TRAIN_FAR_SHARE * total:
            fail(f"phase 8a: parameters differ by up to {gap}; {far} of "
                 f"{total} beyond {TRAIN_PARAM_ATOL}")
    else:
        print(f"phase 8a: losses, parameters and moments bit-equal to the "
              f"unsharded run ({len(got)} leaves)")
    per_step = {"quantize_blockwise": n_group, "dequantize_blockwise": n_group}
    for counts, label in ((counts_p, "unsharded"), (counts_s, "sharded")):
        for k, n_k in per_step.items():
            if counts[k] != steps * n_k:
                fail(f"phase 8a: {label}: {counts[k]} {k} launches, not "
                     f"{steps} steps x {n_k}")
    print(f"phase 8a: {n_group} quantize_blockwise and {n_group} "
          f"dequantize_blockwise launches per step on each run (the q8 "
          f"wire on the gradients' local shards, and AdamW's q8 moments "
          f"where the plan takes them); launches in the sharded run: "
          f"{json.dumps(counts_s)}")
    del want, got

    # 8b: the step's FLOPs on the card against the census
    counter = DR.StepCounter()
    with counter:
        sharded.run(1)
    torch.cuda.synchronize()
    fwd = FlopCounterMode(display=False)
    tokens = batch_at(sharded.data_cfg, 0, dev)["tokens"]
    with fwd, torch.no_grad():
        sharded.params(tokens, attn_impl="chunked", remat=False)
    cen = CS.census(lm, "train", TRAIN_BATCH, TRAIN_SEQ, n_chips=1, tp=1)
    cen_fwd = sum(CS.forward_flops(lm, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ,
                                   False).values())
    ratio = cen_fwd / fwd.get_total_flops()
    rl = RL.analyze(cen.flops, cen.hbm_bytes, RL.CollectiveStats(), 1)
    print(f"phase 8b: one sharded step counted on the card "
          f"(StepCounter: torch.utils.flop_counter's formulas): "
          f"{counter.flops:.6g} FLOPs, {counter.bytes:.6g} op bytes; "
          f"census(train, batch {TRAIN_BATCH}, seq {TRAIN_SEQ}, n_chips 1, "
          f"tp 1): {cen.flops:.6g} FLOPs, {cen.hbm_bytes:.6g} HBM bytes "
          f"(step count / census {counter.flops / cen.flops:.4f}); "
          f"forward: FlopCounterMode {fwd.get_total_flops():.6g}, census "
          f"{cen_fwd:.6g}, census / counted {ratio:.4f}")
    if abs(ratio - 1) >= 0.15:
        fail(f"phase 8b: the census's forward FLOPs are {ratio:.4f} of "
             f"FlopCounterMode's (the reference holds dense models within "
             f"15 %)")
    print(f"phase 8b: roofline of that cell on the H100's constants: "
          f"t_compute {rl.t_compute:.6g} s, t_memory {rl.t_memory:.6g} s, "
          f"t_bound {rl.t_bound:.6g} s ({rl.bottleneck}); measured sharded "
          f"step {step_s8:.6g} s: {rl.t_bound / step_s8:.4f} of the "
          f"roofline (card: {card_line()})")
    del sharded, counter, tokens
    gc.collect()
    torch.cuda.empty_cache()

    # 8c: the dry run on the production meshes
    t0 = time.perf_counter()
    cells = [(LM_ARCH, sh) for sh in DR.SHAPES] + [("yi-9b", "train_4k")]
    for arch, sh in cells:
        for mp in (False, True):
            rec = DR.run_cell(arch, sh, multi_pod=mp)
            mem = rec.get("memory") or {}
            print(f"phase 8c: dry run {arch} {sh} {rec['mesh']}: "
                  f"{rec['status']}"
                  + (f", argument bytes per chip {mem['argument_bytes']} "
                     f"(params {mem['param_bytes']}, moments "
                     f"{mem['moment_bytes']}, inputs {mem['input_bytes']})"
                     f", {rec['roofline']['flops_per_chip']:.6g} FLOPs per "
                     f"chip, collectives {rec['collective_counts']}, "
                     f"{rec['count_s']} s" if rec["status"] == "ok" else
                     f" ({rec.get('reason', '')})"))
            if rec["status"] == "error" or (
                    rec["status"] == "skipped" and sh != "long_500k"):
                fail(f"phase 8c: {arch} {sh}: {rec}")
    print(f"phase 8c: {len(cells) * 2} cells in "
          f"{time.perf_counter() - t0:.3f} s")
    print(f"phase 8: {time.perf_counter() - t_phase:.3f} s")
    return counts_s


# phase 9: the paper's estimation experiments at SF1
TABLE4_COLS = ("l_shipdate", "l_returnflag", "l_extendedprice",
               "l_quantity", "l_discount")
# 9a: one single-column lineitem index per codec beside Table 4's prefixes
TRUTH_SINGLE = {"NS": "l_orderkey", "GDICT": "l_suppkey",
                "LDICT": "l_partkey", "PREFIX": "l_extendedprice",
                "RLE": "l_linestatus"}
MV_F = 0.05                      # 9b: Table 1's sampling fraction
TABLE1_MVS = (("lineitem", ("l_shipdate",)), ("lineitem", ("l_partkey",)),
              ("lineitem", ("l_shipdate", "l_returnflag")),
              ("lineitem", ("l_suppkey", "l_shipmode")),
              ("orders", ("o_orderdate",)), ("orders", ("o_custkey",)),
              ("orders", ("o_orderdate", "o_orderpriority")))
# a GROUP BY through lineitem's foreign key to orders (a join synopsis)
JOIN_MV = ("lineitem", ("o_orderpriority", "l_shipmode"))
MV_METHODS = ("NS", "LDICT", "PREFIX")
TABLE4_EQ = (0.5, 0.9)           # 9c: (e, q) of Table 4
CHUNKED = (4000, 1000)           # 9d: statements, statements a chunk
CHUNKED_F = 0.05                 # 9d: SampleCF fraction of the sizes
EXAMPLES = (("quickstart", []), ("scaled_workloads", []),
            ("layout_advisor", []), ("online_advisor", []),
            ("fleet_advisor", []), ("fault_tolerant_fleet", []),
            ("serve_batched", []), ("train_e2e", ["--steps", "3"]))


def packed_ndv(values) -> int:
    """Distinct rows of non-negative integer columns, packed into one
    int64 key (np.unique on one column; `Table.ndv` stacks rows)."""
    import numpy as np
    key = np.zeros(values[0].shape[0], dtype=np.int64)
    for v in values:
        v = np.asarray(v, dtype=np.int64)
        lo, hi = int(v.min()), int(v.max())
        if lo < 0 or (int(key.max()) + 1) * (hi + 1) >= 1 << 62:
            raise ValueError("packed_ndv: columns do not pack into int64")
        key = key * (hi + 1) + v
    return int(np.unique(key).size)


def phase_9(dev, schema, rec3_config):
    """Phase 9: the paper's estimation experiments on the card at SF1
    (`schema`, phase 3's data).  9a full-index ground truth
    (`full_index_sizes`, Fig. 9's truth) for the five codecs on Table 4's
    lineitem prefixes and one single-column index each, `==` the NumPy
    formula on the same built index; 9b Table 1: GROUP BY MV samples and
    their index sizes (`SynopsisManager`, f = 0.05) `==` the NumPy run,
    AE against the multiply and optimizer baselines; 9c Table 4: `greedy`
    at each fraction of F_GRID against the NumPy engine's plans, `optimal`
    on the first eight targets <= greedy; 9d streamed costing
    (`chunked_config_costs`, 4 chunks) of the base configuration and
    `rec3_config` against NumPy within rtol 1e-6; 9e every
    examples/torch_*.py `main` on the card.  Returns the phase's launch
    counts and GDICT's timing at its first path's shape."""
    import importlib.util
    import tempfile
    import numpy as np
    import torch
    from repro_torch import core as pt
    from repro_torch.core import distinct as dv
    from repro_torch.core import estimation_graph as eg
    from repro_torch.core import samplecf as scf
    from repro_torch.core.relation import build_index_data
    from repro_torch.kernels import codec_bytes as cb

    t_phase = time.perf_counter()
    total = {}
    extras = {}

    # ---- 9a: full-index ground truth --------------------------------
    t0 = time.perf_counter()
    li = schema.tables["lineitem"]
    before = dict(total)
    index_cols = [TABLE4_COLS[:i] for i in range(1, len(TABLE4_COLS) + 1)]
    index_cols += sorted({(c,) for c in TRUTH_SINGLE.values()} -
                         set(index_cols))
    built, build_s = {}, 0.0
    for cols in index_cols:
        built[cols], s = timed(lambda: build_index_data(
            li, pt.IndexDef("lineitem", cols)))
        build_s += s
    print(f"phase 9a: {len(built)} lineitem indexes of {li.nrows} rows "
          f"built on the host in {build_s:.3f} s")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = cb.gdict_plan(1, li.nrows, sms)
    print(f"phase 9a: gdict_plan for a {li.nrows}-value row: {plan.route} "
          f"layout, {plan.tables} tables of {1 << plan.log_slots} slots, "
          f"{plan.parts} blocks a table, scratch {plan.scratch_bytes} B")
    for method in FIVE:
        card_s = np_s = 0.0
        cases = index_cols[:len(TABLE4_COLS)] + [(TRUTH_SINGLE[method],)]
        for cols in cases:
            data = built[cols]
            widths = [li.col_by_name[c].width for c in cols]
            got, s, _ = counted(lambda: scf.compressed_index_bytes(
                data, widths, method, dev), total)
            card_s += s
            want, s = timed(lambda: scf.compressed_index_bytes(
                data, widths, method))
            np_s += s
            if got != want:
                fail(f"phase 9a: {method} on lineitem{cols}: card {got} B "
                     f"!= NumPy {want} B")
        idx = pt.IndexDef("lineitem", (TRUTH_SINGLE[method],), method)
        sizes, s, _ = counted(lambda: scf.full_index_sizes(li, idx, dev),
                              total)
        data = built[idx.cols]
        want = scf.compressed_index_bytes(
            data, [li.col_by_name[idx.cols[0]].width], method)
        if sizes[1] != want:
            fail(f"phase 9a: full_index_sizes({idx.label()}) {sizes} != "
                 f"NumPy {want} B")
        print(f"phase 9a: {method}: {len(cases)} indexes == NumPy; card "
              f"{card_s:.3f} s, NumPy {np_s:.3f} s; full_index_sizes("
              f"{idx.label()}) = {sizes} in {s:.3f} s (its build included)")
    launches = {k: total.get(k, 0) - before.get(k, 0) for k in total}
    for name in CODECS:
        if launches.get(name, 0) <= 0:
            fail(f"phase 9a: kernel {name} was not launched")
    print(f"phase 9a: launches {json.dumps(launches)}")
    # GDICT at its first path's shape: the l_suppkey index's row, per
    # call (CUDA events, outside the counted runs) beside its plain
    # version and its bound
    row = torch.as_tensor(built[("l_suppkey",)][:, 0][None], device=dev)
    w = torch.tensor([4], dtype=torch.int64, device=dev)
    if not torch.equal(cb.gdict_bytes(row, w), cb.gdict_bytes_plain(row, w)):
        fail("phase 9a: gdict_bytes != plain on the l_suppkey index row")

    def event_ms(fn, reps):
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
    g_ms = event_ms(lambda: cb.gdict_bytes(row, w), 10)
    g_plain = event_ms(lambda: cb.gdict_bytes_plain(row, w), 2)
    bytes_ms = (row.numel() * 8 + 16) / HBM_BYTES_PER_S * 1e3
    ops_ms = 8 * row.numel() / OPS_PER_S * 1e3
    extras["gdict_bytes"] = {
        "shape": list(row.shape), "ms": g_ms, "plain_ms": g_plain,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "scratch_bytes": plan.scratch_bytes}
    print(f"phase 9a: kernel gdict_bytes at {tuple(row.shape)} (the "
          f"l_suppkey index): {g_ms:.4f} ms per call (plain {g_plain:.4f} "
          f"ms, bound {max(bytes_ms, ops_ms):.6g} ms by "
          f"{extras['gdict_bytes']['bound_by']})")
    del built, row
    print(f"phase 9a: {time.perf_counter() - t0:.3f} s")

    # ---- 9b: Table 1, MV cardinality ----------------------------------
    t0 = time.perf_counter()
    before = dict(total)
    syn_card = pt.SynopsisManager(
        schema, pt.SampleManager(schema.tables, seed=0), device=dev)
    syn_np = pt.SynopsisManager(schema, pt.SampleManager(schema.tables,
                                                         seed=0))
    fk = next(k for k in schema.fks_of("lineitem")
              if k.dim_table == "orders")
    joined = pt.synopses.join_sample_with_dims(li, schema, (fk,))
    errs = {"AE": [], "Multiply": [], "Optimizer": []}
    for tbl, cols in TABLE1_MVS + (JOIN_MV,):
        joins = (fk,) if (tbl, cols) == JOIN_MV else ()
        mv = pt.MVDef(f"mv_{tbl}_{'_'.join(cols)}", tbl, joins=joins,
                      group_by=cols)
        full = joined if joins else schema.tables[tbl]
        true = packed_ndv([full.values[c] for c in cols])
        (smv, ae), s_card, _ = counted(
            lambda: syn_card.mv_sample(mv, MV_F), total)
        (smv_n, ae_n), s_np = timed(lambda: syn_np.mv_sample(mv, MV_F))
        if ae != ae_n or smv.nrows != smv_n.nrows or any(
                not np.array_equal(smv.values[c], smv_n.values[c])
                for c in smv.values):
            fail(f"phase 9b: {mv.name}: card MV sample or n_est != NumPy")
        sizes = []
        for method in MV_METHODS:
            est, s, _ = counted(lambda: syn_card.mv_index_size(
                mv, cols, method, MV_F), total)
            s_card += s
            est_n, s = timed(lambda: syn_np.mv_index_size(
                mv, cols, method, MV_F))
            s_np += s
            if (est.est_bytes, est.cf, est.cost_pages) != \
                    (est_n.est_bytes, est_n.cf, est_n.cost_pages):
                fail(f"phase 9b: {mv.name} {method}: card {est} != NumPy "
                     f"{est_n}")
            sizes.append(f"{method} {est.est_bytes!r} B")
        base = syn_np.join_synopsis(tbl, MV_F) if joins else \
            syn_np.samples.get_sample(tbl, MV_F)
        d = packed_ndv([base.values[c] for c in cols])
        mult = dv.estimate_multiply(d, base.nrows / full.nrows)
        opt = dv.estimate_optimizer(
            [packed_ndv([full.values[c]]) for c in cols], full.nrows)
        for k, v in (("AE", ae), ("Multiply", mult), ("Optimizer", opt)):
            errs[k].append(abs(v / true - 1))
        print(f"phase 9b: {mv.name}{' (join)' if joins else ''}: true "
              f"{true}, AE {ae!r}, multiply {mult!r}, optimizer {opt!r}; "
              f"{smv.nrows} sampled groups; index sizes {', '.join(sizes)} "
              f"== NumPy; card {s_card:.3f} s, NumPy {s_np:.3f} s")
    print("phase 9b: Table 1 average errors " + ", ".join(
        f"{k} {100 * float(np.mean(v)):.1f} %" for k, v in errs.items()))
    launches = {k: total.get(k, 0) - before.get(k, 0) for k in total}
    print(f"phase 9b: launches {json.dumps(launches)}")
    del joined
    print(f"phase 9b: {time.perf_counter() - t0:.3f} s")

    # ---- 9c: Table 4, Greedy against Optimal ---------------------------
    t0 = time.perf_counter()
    before = dict(total)
    e, q = TABLE4_EQ
    targets = [pt.NodeKey("lineitem", TABLE4_COLS[:i], m)
               for i in range(1, len(TABLE4_COLS) + 1)
               for m in ("NS", "LDICT")]
    card = pt.EstimationPlanner(schema.tables, device=dev)
    host = pt.EstimationPlanner(schema.tables)
    ties = 0
    for f in eg.F_GRID:
        greedy = []
        for tg in (targets, targets[:8]):
            got, _, _ = counted(lambda: card.greedy(tg, f, e, q), total)
            ties += plans_match(got, host.greedy(tg, f, e, q), e,
                                f"phase 9c: greedy f={f} on {len(tg)}")
            greedy.append(got)
        g10, g8 = greedy
        (opt, opt_s) = timed(lambda: card.optimal(targets[:8], f, e, q))
        opt_n = host.optimal(targets[:8], f, e, q)
        if opt.total_cost != opt_n.total_cost or opt.total_cost > \
                g8.total_cost:
            fail(f"phase 9c: f={f}: optimal {opt.total_cost} (NumPy "
                 f"{opt_n.total_cost}) against greedy {g8.total_cost}")
        all_cost = sum(eg.sampling_cost(li, t, f) for t in targets)
        print(f"phase 9c: f={f}: All {all_cost}, Greedy "
              f"{g10.total_cost}, on the first "
              f"eight Greedy {g8.total_cost} / Optimal {opt.total_cost} = "
              f"{g8.total_cost / max(opt.total_cost, 1e-9):.3f} "
              f"(optimal {opt_s:.3f} s on the host)")
    launches = {k: total.get(k, 0) - before.get(k, 0) for k in total}
    if launches.get("planner_walk", 0) < 2 * len(eg.F_GRID):
        fail(f"phase 9c: planner_walk launches {launches}")
    print(f"phase 9c: launches {json.dumps(launches)} (one planner_walk "
          f"per greedy on the card); {ties} equal-p ties")
    print(f"phase 9c: {time.perf_counter() - t0:.3f} s")

    # ---- 9d: streamed costing -------------------------------------------
    t0 = time.perf_counter()
    before = dict(total)
    n9, chunk = CHUNKED
    wl9 = pt.make_scaled_workload(schema, n_statements=n9, seed=0)
    configs = [pt.base_configuration(schema), rec3_config]

    def sized(device):
        """A SizeProvider holding the configs' compressed indexes' SampleCF
        estimates (the estimation engine on `device`)."""
        sp = pt.SizeProvider(schema)
        eng = pt.EstimationEngine(
            schema.tables, pt.SampleManager(schema.tables, seed=0), device)
        keys = {pt.NodeKey(i.table, i.cols, i.compression): i
                for c in configs for i in c.indexes
                if i.compression and i.predicate is None}
        for k, est in eng.estimate_batch(list(keys), CHUNKED_F).items():
            sp.register(keys[k], est.est_bytes)
        return sp

    torch.cuda.reset_peak_memory_stats(dev)
    got, s_card, _ = counted(lambda: pt.chunked_config_costs(
        wl9, sized(dev), configs, chunk_statements=chunk, device=dev), total)
    peak = torch.cuda.max_memory_allocated(dev)
    want, s_np = timed(lambda: pt.chunked_config_costs(
        wl9, sized(None), configs, chunk_statements=chunk))
    if not np.allclose(got, want, rtol=1e-6, atol=0.0):
        fail(f"phase 9d: chunked costs {got.tolist()} != NumPy "
             f"{want.tolist()}")
    launches = {k: total.get(k, 0) - before.get(k, 0) for k in total}
    print(f"phase 9d: chunked_config_costs over {n9} statements in "
          f"{-(-n9 // chunk)} chunks: base {float(got[0])!r}, phase 3's "
          f"config {float(got[1])!r} (NumPy {want.tolist()}); card "
          f"{s_card:.3f} s, NumPy {s_np:.3f} s; peak device memory "
          f"(max_memory_allocated) {peak} B; launches "
          f"{json.dumps(launches)}")
    print(f"phase 9d: {time.perf_counter() - t0:.3f} s")

    # ---- 9e: the example twins on the card ----------------------------
    t0 = time.perf_counter()
    before = dict(total)
    for name, argv in EXAMPLES:
        path = ROOT / "examples" / f"torch_{name}.py"
        spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with tempfile.TemporaryDirectory(prefix="ex_") as d:
            args = argv + (["--checkpoint-dir", d]
                           if name == "train_e2e" else [])
            print(f"phase 9e: examples/torch_{name}.py {' '.join(args)}")
            _, s, _ = counted(lambda: mod.main(args), total)
        print(f"phase 9e: examples/torch_{name}.py: {s:.3f} s")
    launches = {k: total.get(k, 0) - before.get(k, 0) for k in total}
    print(f"phase 9e: launches {json.dumps(launches)}")
    print(f"phase 9e: {time.perf_counter() - t0:.3f} s")
    print(f"phase 9: {time.perf_counter() - t_phase:.3f} s; launches "
          f"{json.dumps(total)}")
    return total, extras


def plans_match(got, want, e, label) -> int:
    """The card's plan against the NumPy engine's: the same f, total cost,
    feasibility, nodes and states, each DEDUCED node with the same chosen
    deduction and RV (float32 against float64: rtol 1e-5 on the mean,
    1e-4 on the std) or else an equal-p tie (the float32 walk breaks ties
    among candidates whose p agree to 1e-7 by its own roundings), whose
    two RVs' p agree within 5e-5.  Returns the number of ties."""
    import numpy as np
    from repro_torch.core import errors as err
    if (got.f, got.total_cost, got.feasible) != \
            (want.f, want.total_cost, want.feasible) or \
            [k.label() for k in got.nodes] != [k.label() for k in want.nodes]:
        fail(f"{label}: plans differ ({got.total_cost} vs "
             f"{want.total_cost})")
    ties = 0
    for kg, kw in zip(got.nodes, want.nodes):
        ng, nw = got.nodes[kg], want.nodes[kw]
        if ng.state is not nw.state or \
                (ng.chosen is None) != (nw.chosen is None):
            fail(f"{label}: {kg.label()} state differs")
        same = ng.chosen is None or \
            [c.label() for c in ng.chosen.children] == \
            [c.label() for c in nw.chosen.children]
        close = np.isclose(ng.rv.mean, nw.rv.mean, rtol=1e-5, atol=0.0) \
            and np.isclose(ng.rv.std, nw.rv.std, rtol=1e-4, atol=1e-6)
        if not (same and close):
            pg, pw = err.prob_within_batch(
                np.array([ng.rv.mean, nw.rv.mean]),
                np.array([ng.rv.std, nw.rv.std]), e)
            if abs(pg - pw) > 5e-5:
                fail(f"{label}: {kg.label()} differs beyond an equal-p tie")
            ties += 1
    return ties


# phase 11: existing indexes (§5.1) and the what-if API at SF1
EXISTING_MAX = 8                 # 11a: phase 3's indexes taken as existing
WHATIF_REL = 1e-12               # 11d: statement-at-a-time vs the batch
WHATIF_RTOL = 1e-6               # 11d: the card's batch vs NumPy's


def phase_11(dev, schema, rec3_config, rec3_targets):
    """Phase 11: existing indexes (§5.1) and the what-if API on the card
    at SF1 (`schema`, phase 3's data; `rec3_config` and `rec3_targets`,
    phase 3's recommendation and its plan's estimation targets).  11a: phase 3's compressed, predicate-free indexes
    (at most EXISTING_MAX, the first by label) are the existing design,
    each sized whole by `samplecf.exact_size` on the card `==` the NumPy
    route on the same built index (built once on the host for both, its
    seconds apart); 11b: `EstimationPlanner(
    existing=..., device=dev).plan` over phase 3's estimation targets at
    phase 3's (e, q) in one planner_walk launch, held to the NumPy
    engine's plan with the same `existing` (the equal-p tie rule), every
    existing node EXACT with its bytes, an existing target EXACT at no
    cost; its sampled / deduced counts and total cost beside the plan
    without `existing`; 11c: the card's plan executed on the card and
    through the NumPy estimation engine, every estimate `==`; 11d: a
    card `DesignAdvisor`'s `optimizer` over phase 3's workload, sized by
    11c: `workload_cost` of the base configuration and phase 3's within
    rel WHATIF_REL of the NumPy route's `workload_cost_batch`, the card
    advisor's `workload_cost_batch` (`config_costs` runs on the host for
    every device) within rtol WHATIF_RTOL, `generate_candidates`' estimation
    targets those phase 3's recommendation planned; 11e: the walk of 11b, with its
    exact start ids, bit-equal to `planner_walk_plain` on the card.
    Returns the phase's launch counts."""
    import torch
    from repro_torch import core as pt
    from repro_torch.core import estimation_graph as eg
    from repro_torch.core import samplecf as scf
    from repro_torch.kernels import planner_score as ps

    t_phase = time.perf_counter()
    total = {}

    # ---- 11a: the existing design, sized whole -----------------------
    t0 = time.perf_counter()
    chosen = sorted((i for i in rec3_config.indexes
                     if i.compression is not None and i.predicate is None),
                    key=lambda i: i.label())[:EXISTING_MAX]
    if not chosen:
        fail("phase 11a: phase 3 recommended no compressed index")
    build = scf.build_index_data
    build_s = [0.0]
    built = {}

    def timed_build(table, idx):
        """The index built on the host once, for both routes (timed)."""
        if idx.key not in built:
            t = time.perf_counter()
            built.clear()
            built[idx.key] = build(table, idx)
            build_s[0] += time.perf_counter() - t
        return built[idx.key]
    existing = {}
    card_s = np_s = 0.0
    scf.build_index_data = timed_build
    try:
        for idx in chosen:
            table = schema.tables[idx.table]
            built0 = build_s[0]
            est, s, _ = counted(lambda: scf.exact_size(table, idx, dev),
                                total)
            card_s += s - (build_s[0] - built0)
            want, np_s_i = timed(lambda: scf.exact_size(table, idx))
            np_s += np_s_i
            if (est.est_bytes, est.cf) != (want.est_bytes, want.cf) or \
                    est.method != "exact" or est.cost_pages != 0.0:
                fail(f"phase 11a: exact_size({idx.label()}) card "
                     f"{est.est_bytes!r} B != NumPy {want.est_bytes!r} B")
            existing[pt.NodeKey(idx.table, idx.cols, idx.compression)] = \
                est.est_bytes
            print(f"phase 11a: {idx.label()} ({table.nrows} rows): "
                  f"{est.est_bytes!r} B, cf {est.cf!r} == NumPy")
    finally:
        scf.build_index_data = build
        built.clear()
    print(f"phase 11a: {len(existing)} existing indexes sized whole: card "
          f"{card_s:.3f} s, NumPy {np_s:.3f} s, the builds {build_s[0]:.3f} "
          f"s of host time apart; launches {json.dumps(total)}")
    print(f"phase 11a: {time.perf_counter() - t0:.3f} s")

    # ---- 11b: the plan with existing indexes -------------------------
    t0 = time.perf_counter()
    wl = pt.make_tpch_workload(schema, insert_weight=0.1)
    opts = pt.AdvisorOptions(backend="torch", device=dev.type)
    e, q = opts.e, opts.q
    adv = pt.DesignAdvisor(wl, opts)
    universe = adv.generate_candidates()
    tkey_to_defs = adv.estimation_targets(universe)
    targets = list(tkey_to_defs)
    card = pt.EstimationPlanner(schema.tables, existing=existing, device=dev)
    host = pt.EstimationPlanner(schema.tables, existing=existing)
    walks = []
    walk = ps.planner_walk

    def recording(g, *a):
        walks.append((g, a, walk(g, *a)))
        return walks[-1][2]
    ps.planner_walk = recording
    try:
        plan, plan_s, launches = counted(
            lambda: card.plan(targets, e, q), total)
    finally:
        ps.planner_walk = walk
    if launches.get("planner_walk", 0) != 1 or len(walks) != 1:
        fail(f"phase 11b: planner launches {launches}, not one walk")
    want, host_s = timed(lambda: host.plan(targets, e, q))
    ties = plans_match(plan, want, e, "phase 11b")
    for k, size in existing.items():
        n = plan.nodes.get(k)
        if n is None or n.state is not eg.State.EXACT or \
                n.exact_bytes != size:
            fail(f"phase 11b: existing {k.label()} is not EXACT with its "
                 f"{size!r} B")
    exact_targets = [t for t in targets if t in existing]
    bare, _, _ = counted(lambda: pt.EstimationPlanner(
        schema.tables, device=dev).plan(targets, e, q), total)
    print(f"phase 11b: {len(targets)} targets ({len(exact_targets)} of them "
          f"existing), e={e} q={q}: with existing f={plan.f} sampled="
          f"{plan.n_sampled()} deduced={plan.n_deduced()} exact="
          f"{len(existing)} total cost {plan.total_cost!r}; without f="
          f"{bare.f} sampled={bare.n_sampled()} deduced={bare.n_deduced()} "
          f"total cost {bare.total_cost!r}; == NumPy ({ties} equal-p ties)"
          f"; card {plan_s:.3f} s, NumPy {host_s:.3f} s")
    print(f"phase 11b: {time.perf_counter() - t0:.3f} s")

    # ---- 11c: executing the plan -------------------------------------
    t0 = time.perf_counter()
    ests, card_s, launches = counted(lambda: card.execute(
        plan, pt.EstimationEngine(schema.tables,
                                  pt.SampleManager(schema.tables, seed=0),
                                  dev)), total)
    want, np_s = timed(lambda: host.execute(plan, pt.EstimationEngine(
        schema.tables, pt.SampleManager(schema.tables, seed=0))))
    if list(ests) != list(want):
        fail("phase 11c: the executed nodes differ from NumPy's")
    for k, est in ests.items():
        if est.est_bytes != want[k].est_bytes:
            fail(f"phase 11c: {k.label()}: card {est.est_bytes!r} B != "
                 f"NumPy {want[k].est_bytes!r} B")
    for k in exact_targets:
        if ests[k].est_bytes != existing[k] or ests[k].cost_pages != 0.0:
            fail(f"phase 11c: existing target {k.label()} not exact at no "
                 "cost")
    print(f"phase 11c: {len(ests)} estimates (SampleCF on "
          f"{plan.n_sampled()} nodes at f={plan.f}) == NumPy; card "
          f"{card_s:.3f} s, NumPy {np_s:.3f} s; launches "
          f"{json.dumps(launches)}")
    print(f"phase 11c: {time.perf_counter() - t0:.3f} s")

    # ---- 11d: the what-if API ----------------------------------------
    t0 = time.perf_counter()
    for k, defs in tkey_to_defs.items():
        for idx in defs:
            adv.sizes.register(idx, ests[k].est_bytes)
    configs = [pt.base_configuration(schema), rec3_config]
    opt = adv.optimizer
    scalar, scalar_s = timed(lambda: [opt.workload_cost(c)
                                      for c in configs])
    want, np_s = timed(lambda: pt.WhatIfOptimizer(
        wl, adv.sizes).workload_cost_batch(configs))
    got, card_s, launches = counted(
        lambda: opt.workload_cost_batch(configs), total)
    for what, a, b in zip(("base", "phase 3's"), scalar, want):
        if abs(a - b) > WHATIF_REL * abs(b):
            fail(f"phase 11d: workload_cost({what}) {a!r} beyond rel "
                 f"{WHATIF_REL} of NumPy's batch {b!r}")
    if not all(abs(a - b) <= WHATIF_RTOL * abs(b) for a, b in zip(got, want)):
        fail(f"phase 11d: the card's workload_cost_batch {got.tolist()} "
             f"against NumPy's {want.tolist()}")
    if tuple(adv.estimation_targets(universe)) != tuple(rec3_targets):
        fail("phase 11d: generate_candidates()' estimation targets differ "
             "from those phase 3's recommendation planned")
    keys = {i.key for i in universe}
    base_keys = {i.key for i in configs[0].indexes}
    if not all(i.key in keys or i.key in base_keys
               for i in rec3_config.indexes):
        fail("phase 11d: phase 3's configuration holds an index outside "
             "the candidate universe")
    print(f"phase 11d: {len(wl.statements)} statements, "
          f"{len(universe)} candidates, their {len(rec3_targets)} "
          f"estimation targets == phase 3's plan's; "
          f"workload_cost base {float(scalar[0])!r}, phase 3's "
          f"{float(scalar[1])!r} "
          f"({opt.calls} statement costs, {scalar_s:.3f} s); NumPy batch "
          f"{want.tolist()} ({np_s:.3f} s); the card advisor's batch "
          f"{got.tolist()}, priced on the host ({card_s:.3f} s, launches "
          f"{json.dumps(launches)})")
    print(f"phase 11d: {time.perf_counter() - t0:.3f} s")

    # ---- 11e: the walk with exact ids against its plain version ------
    t0 = time.perf_counter()
    g, args_, res = walks[0]
    if g.exact is None or sorted(g.exact.tolist()) != sorted(
            card.engine._node_id[k] for k in existing):
        fail("phase 11e: the walk was not given the existing indexes' ids")
    plain = ps.planner_walk_plain(g, *args_)
    torch.cuda.synchronize()
    for name, a, b in zip(ps.WalkResult._fields, res, plain):
        if not bit_equal(a, b):
            fail(f"phase 11e: the walk's {name} differs from "
                 "planner_walk_plain on the card")
    print(f"phase 11e: planner_walk ({g.tid.numel()} records, "
          f"{g.dm.numel()} candidates, {g.scost.shape[0]} nodes with the "
          f"pad, {g.exact.numel()} exact) bit-equal to planner_walk_plain "
          f"on the card ({time.perf_counter() - t0:.3f} s)")
    print(f"phase 11: {time.perf_counter() - t_phase:.3f} s; launches "
          f"{json.dumps(total)}")
    return total


# phase 12: the statement-at-a-time oracle paths at SF1
SCALAR_REL = 1e-12               # 12c, 12d: scalar cost vs the numpy engine's
PHASE_12_LIMIT_S = 30.0          # 12a-12d together, seconds of host time
ALL_SCALAR = dict(use_engine=False, use_batched_estimation=False,
                  use_batched_planner=False)


def phase_3f(schema, opts, budget):
    """Phase 3f: `recommend` on make_scaled_workload(N_UNCOMPRESSED) over
    phase 3's schema and options at phase 3's budget, without workload
    compression, on the card, with the launch counters zeroed just before
    and read just after.  Lineitem's queries are past UNFUSED_NQ, where the
    JAX package's scorers sum as XLA's unfused dot does: every distinct
    (scorer, nq, m, ns) of the run's greedy-step scorer calls bit-equal
    card vs CPU (`check_scorer_order`).  The card's configuration priced
    by the port's numpy CostEngine (`config_cost`) on the same workload
    and sizes within rtol 1e-6 of the card's cost, its bytes within the
    budget.  Returns the run's launches."""
    import torch
    from repro_torch import core as pt
    t_phase = time.perf_counter()
    wl = pt.make_scaled_workload(schema, n_statements=N_UNCOMPRESSED,
                                 seed=0)
    by_table = {}
    for q in wl.queries():
        by_table[q.table] = by_table.get(q.table, 0) + 1
    print(f"data 3f: {len(wl.statements)} statements (make_scaled_workload,"
          f" seed 0), queries by table {by_table}, no workload compression")
    if by_table["lineitem"] < UNFUSED_NQ:
        fail(f"phase 3f: lineitem has {by_table['lineitem']} queries, "
             f"fewer than {UNFUSED_NQ}")
    calls, launches = ScorerCalls(), {}
    adv = pt.DesignAdvisor(wl, opts)
    execute = pt.EstimationPlanner.execute
    sampled = {}

    def releasing(self, plan, engine):
        """SampleCF's batches are this phase's peak of device memory; hand
        the cached blocks back after them (phase 10 runs beside)."""
        out = execute(self, plan, engine)
        sampled["peak"] = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        print(SAMPLED_MARK, flush=True)
        return out
    pt.EstimationPlanner.execute = releasing
    try:
        rec, secs, _ = counted(lambda: keeping_scorer_calls(
            lambda: adv.recommend(budget), calls), launches)
    finally:
        pt.EstimationPlanner.execute = execute
    ph = ", ".join(f"{k} {rec.phase_seconds[k]:.3f}"
                   for k in pt.advisor.PHASES)
    print(f"recommend 3f torch/cuda: {secs:.3f} s ({ph}); {len(rec.steps)} "
          f"steps, {len(rec.config.indexes)} indexes, cost {rec.cost!r}, "
          f"used_bytes {rec.used_bytes!r}; launches {json.dumps(launches)}")
    for name in ("ns_bytes", "ldict_bytes", "planner_walk"):
        if launches[name] <= 0:
            fail(f"phase 3f: kernel {name} was not launched")
    big = [k for k in calls.count if k[1] >= UNFUSED_NQ]
    print(f"phase 3f: {sum(calls.count.values())} scorer calls in "
          f"{sum(calls.seconds.values()):.3f} s, "
          f"{sum(calls.count[k] for k in big)} of them at nq >= "
          f"{UNFUSED_NQ} in {sum(calls.seconds[k] for k in big):.3f} s; "
          f"peak device memory {sampled['peak']} B up to SampleCF's end, "
          f"{torch.cuda.max_memory_allocated()} B in all, "
          f"{torch.cuda.memory_reserved()} B reserved after")
    if not big:
        fail(f"phase 3f: no scorer call at nq >= {UNFUSED_NQ}")
    check_scorer_order("phase 3f", calls)
    del calls
    t0 = time.perf_counter()
    priced = pt.CostEngine(wl, adv.sizes).config_cost(rec.config)
    print(f"phase 3f: the numpy CostEngine prices the card's configuration "
          f"at {priced!r} against the card's {rec.cost!r} "
          f"({time.perf_counter() - t0:.3f} s); used {rec.used_bytes!r} of "
          f"{budget!r} B")
    if not math.isclose(priced, rec.cost, rel_tol=1e-6):
        fail(f"phase 3f: numpy prices the configuration at {priced!r}, "
             f"the card at {rec.cost!r}, beyond rtol 1e-6")
    if rec.used_bytes > budget:
        fail(f"phase 3f: {rec.used_bytes!r} B used of a {budget!r} B budget")
    print(f"phase 3f: {time.perf_counter() - t_phase:.3f} s")
    return launches


def phase_3f_alone() -> int:
    """`chip_smoke.py --phase-3f`: phase 3f on phase 3's SF1 data, options
    and budget, in a process of its own; its last line the launches."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke --phase-3f: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch import core as pt
    schema = pt.make_tpch_like(scale=SF1_SCALE, z=0.0, seed=0)
    launches = phase_3f(schema, pt.AdvisorOptions(backend="torch",
                                                  device="cuda"),
                        advisor_budget(schema))
    print(f"launches 3f: {json.dumps(launches)}")
    return 0


def start_phase_3f():
    """Start phase 3f's own process, its output to a temporary file: its
    host-bound advisor work runs beside phases 9-12 and 10, which leave
    most of the host's cores idle.  Returns (process, log path, start
    time)."""
    import tempfile
    fd, log = tempfile.mkstemp(prefix="chip_smoke_3f_", suffix=".log")
    with open(fd, "w") as out:
        proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                 PHASE_3F_FLAG], stdout=out,
                                stderr=subprocess.STDOUT, cwd=ROOT)
    _CHILDREN.append(proc)
    print(f"phase 3f: started in process {proc.pid}")
    return proc, Path(log), time.perf_counter()


def wait_for_sampling(proc, log, t0):
    """Wait until phase 3f's SampleCF, which needs ~43 GB of the card
    (call 5, PR 33), has handed its memory back (or its process ended)."""
    t_wait = time.perf_counter()
    while proc.poll() is None and SAMPLED_MARK not in log.read_text():
        time.sleep(0.5)
    print(f"phase 3f: its SampleCF done {time.perf_counter() - t0:.3f} s "
          f"after its start; {time.perf_counter() - t_wait:.3f} s of "
          f"waiting for it before phase 10")


def join_phase_3f(proc, log, t0):
    """Wait for phase 3f's process, print its output, fail if it failed;
    returns its launches."""
    t_wait = time.perf_counter()
    rc = proc.wait()
    now = time.perf_counter()
    out = log.read_text()
    log.unlink()
    print(out, end="")
    if rc != 0:
        fail(f"phase 3f's process exited with {rc}")
    print(f"phase 3f: its process took {now - t0:.3f} s beside phases "
          f"9-12 and 10; {now - t_wait:.3f} s of waiting for it after 10")
    return json.loads(out.splitlines()[-1].split(": ", 1)[1])


def phase_12(dev, wl, budget, rec3_t, rec3_n, price3_n, est3, rec3c_n):
    """Phase 12: the reference's statement-at-a-time paths beside the
    batched ones at SF1, on phase 3's workload `wl` and `budget`, every
    run on backend="torch", device="cuda" with its launches counted.
    `rec3_t` / `rec3_n` are phase 3's torch/cuda and numpy
    recommendations, `price3_n` the numpy pipeline's cost oracle,
    `est3` phase 3's batched card estimates ({NodeKey: SizeEstimate}),
    `rec3c_n` phase 3c's numpy staged recommendation (with FIVE).  12a `use_batched_planner=False`: the scalar greedy's plan
    identical to the numpy engine's (states, deductions, RVs, f, total
    cost), its node labels against phase 3's card walk (equal-p ties
    counted), the recommendation identical to phase 3's torch/cuda one
    where there are no ties; 12b `use_batched_estimation=False`: each
    SAMPLED node's host `sample_cf` estimate `==` phase 3's card estimate,
    the recommendation identical to phase 3's; 12c `use_engine=False`: the
    float64 scalar enumeration, its configuration phase 3's numpy one or
    an equal-cost tie, its cost within rel SCALAR_REL of numpy's, its
    steps beside numpy's and torch/cuda's; 12d all three off, then
    `staged_recommend(use_engine=False)` with 3c's five codecs, each held
    to numpy's in the same way.  Fails beyond PHASE_12_LIMIT_S.  Returns
    the phase's launch counts."""
    from repro_torch import core as pt
    from repro_torch.core import estimation_graph as eg
    from repro_torch.core.planner_engine import assert_plan_identical

    t_phase = time.perf_counter()
    total = {}
    e = pt.AdvisorOptions(backend="numpy").e

    def labels(rec):
        return sorted(i.label() for i in rec.config.indexes)

    def same_rec(label, got, want):
        if (labels(got), got.cost, got.used_bytes) != \
                (labels(want), want.cost, want.used_bytes):
            fail(f"{label}: the recommendation differs from phase 3's "
                 f"torch/cuda one: cost {float(got.cost)!r} vs "
                 f"{float(want.cost)!r}, used bytes "
                 f"{float(got.used_bytes)!r} vs {float(want.used_bytes)!r}")

    def near_numpy(label, got, want, prices):
        """Phase 3's rule against numpy: the same configuration or an
        equal-cost tie by `prices` (the numpy pipeline's costs of both
        configurations); the cost within rel SCALAR_REL."""
        if labels(got) != labels(want):
            judged, mine = prices(got.config, want.config)
            print(f"{label}: configs differ from numpy's; numpy prices the "
                  f"scalar config at {judged!r} vs its own {mine!r}")
            if not math.isclose(judged, mine, rel_tol=1e-6):
                fail(f"{label}: configurations differ and are not an "
                     "equal-cost tie")
        if abs(got.cost - want.cost) > SCALAR_REL * abs(want.cost):
            fail(f"{label}: cost {float(got.cost)!r} beyond rel "
                 f"{SCALAR_REL} of numpy's {float(want.cost)!r}")

    def price3(*configs):
        return [price3_n(c) for c in configs]

    def staged_prices(*configs):
        # phase 3c's judge: the numpy pipeline sizes every compressed
        # index of the configurations at once, then its engine prices them
        judge = pt.DesignAdvisor(wl, pt.AdvisorOptions(backend="numpy",
                                                       methods=FIVE))
        judge.estimate_sizes([i for c in configs for i in c.indexes])
        engine = judge.build_engine()
        return [engine.config_cost(c) for c in configs]

    def run(label, **switches):
        opts = pt.AdvisorOptions(backend="torch", device=dev.type,
                                 **switches)
        rec, secs, launches = counted(
            lambda: pt.DesignAdvisor(wl, opts).recommend(budget), total)
        print(f"{label}: {json.dumps(switches)}: {secs:.3f} s, "
              f"{len(rec.steps)} steps, cost {float(rec.cost)!r}, used bytes "
              f"{float(rec.used_bytes)!r}, plan f={rec.estimation_plan.f} "
              f"sampled={rec.n_sampled} deduced={rec.n_deduced}; launches "
              f"{json.dumps(launches)}")
        return rec, secs, launches

    def kernels_ran(label, launches, walk, codecs):
        """The walk's launches as expected, and codec launches or none."""
        ran = sum(launches.get(n, 0) for n in CODECS)
        if launches.get("planner_walk", 0) != walk or (ran > 0) != codecs:
            fail(f"{label}: launches {launches}: expected {walk} walk(s) "
                 f"and {'some' if codecs else 'no'} codec launches")

    # ---- 12a: the scalar §5.2 planner --------------------------------
    rec_a, secs_a, launches = run("phase 12a", use_batched_planner=False)
    kernels_ran("phase 12a", launches, 0, True)
    try:
        assert_plan_identical(rec3_n.estimation_plan, rec_a.estimation_plan)
    except AssertionError as err:
        fail(f"phase 12a: the scalar plan differs from the numpy "
             f"engine's: {err}")
    if list(rec_a.estimation_plan.nodes) != \
            list(rec3_n.estimation_plan.nodes):
        fail("phase 12a: the scalar plan's node order differs from numpy's")
    ties = plans_match(rec3_t.estimation_plan, rec_a.estimation_plan, e,
                       "phase 12a")
    print(f"phase 12a: the scalar plan == the numpy engine's "
          f"({len(rec_a.estimation_plan.nodes)} nodes); {ties} node labels "
          f"differ from phase 3's card walk plan (equal-p ties)")
    if ties == 0:
        same_rec("phase 12a", rec_a, rec3_t)
        print("phase 12a: recommendation identical to phase 3's torch/cuda")

    # ---- 12b: per-node SampleCF on the host --------------------------
    scalar_ests = {}
    execute_scalar = eg.EstimationPlanner.execute_scalar

    def keeping(self, plan, manager):
        out = execute_scalar(self, plan, manager)
        scalar_ests.update(out)
        return out
    eg.EstimationPlanner.execute_scalar = keeping
    try:
        rec_b, secs_b, launches = run("phase 12b",
                                      use_batched_estimation=False)
    finally:
        eg.EstimationPlanner.execute_scalar = execute_scalar
    kernels_ran("phase 12b", launches, 1, False)
    sampled = [k for k, n in rec_b.estimation_plan.nodes.items()
               if n.state is eg.State.SAMPLED]
    if not sampled:
        fail("phase 12b: the plan samples no node")
    by_method = {}
    for k in sampled:
        got, want = scalar_ests[k], est3.get(k)
        if want is None or (got.est_bytes, got.cf, got.cost_pages) != \
                (want.est_bytes, want.cf, want.cost_pages):
            fail(f"phase 12b: {k.label()}: host sample_cf "
                 f"{got.est_bytes!r} B != phase 3's card estimate "
                 f"{None if want is None else want.est_bytes!r} B")
        by_method[k.method] = by_method.get(k.method, 0) + 1
    print(f"phase 12b: {len(sampled)} SAMPLED nodes at f="
          f"{rec_b.estimation_plan.f}, each host sample_cf == phase 3's "
          f"card estimate (by method {json.dumps(by_method)})")
    same_rec("phase 12b", rec_b, rec3_t)
    print("phase 12b: recommendation identical to phase 3's torch/cuda")

    # ---- 12c: the float64 scalar enumeration -------------------------
    rec_c, secs_c, launches = run("phase 12c", use_engine=False)
    kernels_ran("phase 12c", launches, 1, True)
    near_numpy("phase 12c", rec_c, rec3_n, price3)
    tie = "==" if labels(rec_c) == labels(rec3_n) else "an equal-cost tie of"
    print(f"phase 12c: config {tie} numpy's, cost {float(rec_c.cost)!r} vs "
          f"numpy {float(rec3_n.cost)!r} (rel "
          f"{abs(rec_c.cost - rec3_n.cost) / abs(rec3_n.cost):.3g}); steps "
          f"scalar {len(rec_c.steps)}, numpy {len(rec3_n.steps)}, "
          f"torch/cuda {len(rec3_t.steps)}")

    # ---- 12d: all three off, then the staged baseline ----------------
    rec_d, secs_d, launches = run("phase 12d", **ALL_SCALAR)
    kernels_ran("phase 12d", launches, 0, False)
    near_numpy("phase 12d", rec_d, rec3_n, price3)
    if rec_d.steps != rec_c.steps:
        print(f"phase 12d: steps differ from 12c's ({len(rec_d.steps)} vs "
              f"{len(rec_c.steps)})")
    opts = pt.AdvisorOptions(backend="torch", device=dev.type,
                             use_engine=False)
    rec_s, secs_s, launches = counted(lambda: pt.staged_recommend(
        wl, budget, methods=FIVE, options=opts), total)
    kernels_ran("phase 12d staged", launches, 1, True)
    near_numpy("phase 12d staged", rec_s, rec3c_n, staged_prices)
    print(f"phase 12d staged: use_engine=False, methods {FIVE}: "
          f"{secs_s:.3f} s, cost {float(rec_s.cost)!r} vs numpy "
          f"{float(rec3c_n.cost)!r}, used bytes {float(rec_s.used_bytes)!r}; "
          f"launches {json.dumps(launches)}")
    secs = time.perf_counter() - t_phase
    print(f"phase 12: {secs:.3f} s (runs: 12a {secs_a:.3f}, 12b "
          f"{secs_b:.3f}, 12c {secs_c:.3f}, 12d {secs_d:.3f}, staged "
          f"{secs_s:.3f}); launches {json.dumps(total)}")
    if secs > PHASE_12_LIMIT_S:
        fail(f"phase 12 took {secs:.3f} s, beyond {PHASE_12_LIMIT_S} s")
    return total


# phase 10: training the remaining families on the card
# 10a: granite-moe-3b-a800m at its published size through the launcher, at
# phase 6's batch and context
MOE_TRAIN_ARGV = ("--arch", MOE_ARCH, "--full", "--batch", "4", "--seq",
                  "2048", "--steps", "5", "--lr", "3e-4")
# 10b: rwkv6-7b at full width, cut to 8 layers (its 32 fit no card with
# float32 moments), batch 4 x seq 512 (two WKV chunks of 256), step 0 + 3
RWKV_DEPTH, RWKV_BATCH, RWKV_SEQ, RWKV_STEPS = 8, 4, 512, 4
# 10a, 10b: the first loss within this of `init_loss`
FIRST_LOSS_WINDOW = 0.7
# 10c: batch, seq (two WKV chunks); 10d: the Jamba smoke config (two Mamba
# chunks of 128) and the Mamba block alone at Jamba's width; two steps on
# each device, as phase 6e
FAMILY_TRAIN = (1, 512)
HYBRID_TRAIN = (1, 256)
MAMBA_TRAIN = (2, 256)
FAMILY_TRAIN_STEPS = 2
# 10e: every non-dense architecture through the launcher at smoke size
LAUNCH_ARCHS = (MOE_ARCH, "qwen3-moe-235b-a22b", RWKV_ARCH, HYBRID_ARCH,
                "pixtral-12b", "musicgen-medium")
LAUNCH_STEPS = 5
# 10e: the card's losses against the CPU's from the same initial weights,
# bfloat16 compute on both (as the Trainer tests against JAX)
LAUNCH_LOSS_RTOL = 2e-2


def init_loss(cfg) -> float:
    """The loss at init: ln(vocab) + d_model * 0.02^2 / 2.  The final
    norm's output has unit RMS, so each logit is normal with variance
    d_model * 0.02^2 (the head's init scale), and the mean logsumexp of
    vocab such logits is about ln(vocab) + variance / 2."""
    return math.log(cfg.vocab) + cfg.d_model * 0.02 ** 2 / 2


def q8_per_step(trainer):
    """(grouped quantize launches a step = grouped dequantize launches a
    step, wire buckets, gradients on the wire) of `trainer`: one launch
    each way per q8 wire bucket (per `group_capacity()` tensors), and with
    q8 moments one more each way per parameter (its (m, sqrt v) pair)."""
    from repro_torch.kernels import quantize_blockwise as qb
    from repro_torch.train import step as train_step
    plist = [p_ for _, p_ in trainer.params.named_parameters()]
    buckets = (train_step.wire_buckets(plist)
               if trainer.grad_compression == "q8" else [])
    n_group = sum(-(-len(b) // qb.group_capacity()) for b in buckets)
    per_param = len(plist) if trainer.opt_cfg.state_codec == "q8" else 0
    return n_group + per_param, len(buckets), sum(len(b) for b in buckets)


def train_report(label, trainer, counts, peak):
    """Print a training run's plan, losses, step seconds (step 0 left
    out), tokens/s and peak device memory, and fail unless every loss is
    finite, the first is within FIRST_LOSS_WINDOW of `init_loss`, the last
    is below the first, and each step made one grouped quantize and one
    grouped dequantize launch per wire bucket (`q8_per_step`)."""
    losses = [h["loss"] for h in trainer.history]
    secs = [h["seconds"] for h in trainer.history]
    steps, tc, cfg = len(losses), trainer.tc, trainer.cfg
    step_s = sum(secs[1:]) / (steps - 1)
    want = init_loss(cfg)
    print(f"phase {label}: Trainer({cfg.name}: {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab}, "
          f"{cfg.param_count()} parameters; batch {tc.batch}, seq {tc.seq}, "
          f"lr {tc.lr}, hbm_budget_bytes {tc.hbm_budget_bytes:.3g}): plan "
          f"{trainer.plan.choices}, moments {trainer.opt_cfg.state_codec}; "
          f"losses {losses} (init {want:.4f}); step seconds {secs}")
    print(f"phase {label}: {step_s:.4f} s per step without step 0; "
          f"{tc.batch * tc.seq / step_s:.1f} tokens/s; peak device memory "
          f"{peak} B")
    if not all(math.isfinite(v) for v in losses):
        fail(f"phase {label}: a loss is not finite: {losses}")
    if abs(losses[0] - want) > FIRST_LOSS_WINDOW:
        fail(f"phase {label}: first loss {losses[0]} not within "
             f"{FIRST_LOSS_WINDOW} of {want:.4f}")
    if not losses[-1] < losses[0]:
        fail(f"phase {label}: the loss did not fall: {losses}")
    per_step, n_buckets, n_wire = q8_per_step(trainer)
    for k in Q8_KERNELS:
        if counts[k] != steps * per_step:
            fail(f"phase {label}: {counts[k]} {k} launches, not {steps} "
                 f"steps x {per_step}")
    print(f"phase {label}: {per_step} quantize_blockwise and {per_step} "
          f"dequantize_blockwise launches per step ({n_wire} gradients on "
          f"the q8 wire in {n_buckets} buckets)")


def keep_masks():
    """Wrap `layers.moe_routing`, which `moe_mlp` calls, so that each MoE
    call's keep mask (k * T,) (each expert assignment within its expert's
    capacity or not) is kept on the device as the layer computes it: no
    work added to the step and no host read inside it.  Returns (the list
    it fills, a function that unwraps)."""
    from repro_torch.models import layers
    routing, masks = layers.moe_routing, []

    def recorded(p, xt, moe):
        out = routing(p, xt, moe)
        masks.append(out[-1])
        return out

    def unwrap():
        layers.moe_routing = routing
    layers.moe_routing = recorded
    return masks, unwrap


def real_gradients(label, trainer, dev, twice):
    """10a-ii's check on `trainer`'s final parameters (its moments freed
    first): the step's loss and gradients (`make_loss_and_grads`, bf16
    compute, remat) on its next batch, with `twice` computed once more,
    the loss required bit-equal, each gradient bit-equal or the largest
    gap per parameter kind printed; then both q8 kernels bit-equal to
    their plain versions on those gradients (`q8_on_gradients`)."""
    import re

    import torch
    from repro_torch.data.pipeline import batch_at
    from repro_torch.train import step as train_step
    trainer.opt_state = None
    gc.collect()
    torch.cuda.empty_cache()
    lg = train_step.make_loss_and_grads(
        trainer.cfg, remat=True,
        attn_impl="chunked" if trainer.tc.seq >= 2048 else "full")
    batch = batch_at(trainer.data_cfg, trainer.step, dev)
    runs = []
    for _ in range(2 if twice else 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(lg(trainer.params, batch))
        torch.cuda.synchronize()
        print(f"{label}: make_loss_and_grads on {trainer.cfg.name}'s final "
              f"parameters and batch {trainer.step}: "
              f"{time.perf_counter() - t0:.3f} s")
    l1, g1 = runs[0]
    if not twice:
        del runs
        q8_on_gradients(label, g1)
        return
    l2, g2 = runs[1]
    del runs
    if not bit_equal(l1, l2):
        fail(f"{label}: the same loss computed twice differs: "
             f"{float(l1)!r} against {float(l2)!r}")
    gaps, kinds = {}, set()
    for name, a in g1.items():
        kind = re.sub(r"\.\d+\.", ".*.", name)      # the layer index out
        kinds.add(kind)
        if not bit_equal(a, g2[name]):
            gap = float((a.double() - g2[name].double()).abs().max())
            gaps[kind] = max(gaps.get(kind, 0.0), gap)
    del g2
    print(f"{label}: the loss bit-equal ({float(l1)!r}); " + (
        f"every one of {len(g1)} gradients bit-equal" if not gaps else
        f"gradients not bit-equal, the largest gap by kind: "
        f"{json.dumps(gaps)}; bit-equal kinds: {sorted(kinds - set(gaps))}"))
    q8_on_gradients(label, g1)
    del g1


def mamba_step(cfg):
    """One AdamW step of a Mamba block alone (`init_mamba_block`) on the
    mean square of its output against a target, from zero conv and ssm
    state: float32, the q8 wire and q8 moments (`family_opt`)."""
    import torch
    from repro_torch import optim
    from repro_torch.models import mamba as MB
    from repro_torch.train.step import q8_wire
    opt = family_opt()

    def step(blk, state, batch):
        x, target = batch["x"], batch["target"]
        b, din = x.shape[0], MB.d_inner(cfg)
        conv0 = torch.zeros((b, cfg.hybrid.d_conv - 1, din), device=x.device)
        ssm0 = torch.zeros((b, din, cfg.hybrid.d_state), device=x.device)
        names, ps = zip(*blk.named_parameters())
        with torch.enable_grad():
            y = MB.mamba_sequence(blk, x, cfg, conv0, ssm0)[0]
            loss = torch.mean(torch.square(y - target))
            grads = dict(zip(names, torch.autograd.grad(loss, ps)))
        q8_wire(grads)
        blk, state = optim.adamw_update(blk, grads, state, opt)
        return blk, state, loss.detach()
    return step


def q8_rise(arch, tr, losses, want):
    """10e where the loss of launcher Trainer `tr` did not fall: fail
    unless it trains a token model whose plan took q8 moments and the q8
    wire at lr >= 1e-3 (with
    which the JAX Trainer's loss rises so from some inits too:
    tests/test_torch_train_hybrid.py::
    test_launcher_trainer_matches_jax_through_a_q8_loss_rise), the CPU's
    losses `want` from the same weights did not fall either, and the same
    weights trained on the card with float32 moments and no wire end below
    their first loss."""
    import torch
    from repro_torch.train.loop import Trainer
    if not (tr.cfg.frontend == "tokens" and tr.opt_cfg.state_codec == "q8"
            and tr.grad_compression == "q8" and tr.tc.lr >= 1e-3):
        fail(f"phase 10e: {arch}: the loss did not fall ({losses}); "
             f"frontend {tr.cfg.frontend}, moments "
             f"{tr.opt_cfg.state_codec}, wire {tr.grad_compression}, lr "
             f"{tr.tc.lr}")
    if want[-1] < want[0]:
        fail(f"phase 10e: {arch}: the loss did not fall on the card "
             f"({losses}), but did on the CPU ({want})")
    f32 = Trainer(tr.cfg, dataclasses.replace(tr.tc,
                                              use_design_advisor=False),
                  device=tr.device)
    f32.params.load_state_dict(tr.initial)
    f32.run()
    got = [h["loss"] for h in f32.history]
    torch.cuda.synchronize()
    print(f"phase 10e: {arch}: the loss did not fall in {LAUNCH_STEPS} "
          f"steps with q8 moments and the q8 wire at lr {tr.tc.lr}, on the "
          f"card as on the CPU; from the same weights with float32 moments "
          f"and no wire: {got}")
    if not (all(math.isfinite(v) for v in got) and got[-1] < got[0]):
        fail(f"phase 10e: {arch}: with float32 moments and no wire the "
             f"loss did not fall either: {got}")


def phase_10(dev):
    """Phase 10: the remaining families trained on the card.  10a
    granite-moe-3b-a800m at its published size through the launcher; 10a-ii
    its gradients twice and the q8 kernels on them; 10b rwkv6-7b at full
    width and depth RWKV_DEPTH, then the same check; 10c four families at
    full width and depth 2 and 10d the hybrid (the Jamba smoke config, the
    Mamba block at Jamba's width) trained card against CPU; 10e every
    non-dense architecture through the launcher at smoke size.  Returns
    the q8 kernels' launches over the phase's training runs."""
    import torch
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as launcher
    from repro_torch.models import mamba as MB, model as MD, rwkv as R
    from repro_torch.train.loop import TrainConfig, Trainer

    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 10: device memory still allocated from earlier phases "
          f"{torch.cuda.memory_allocated(dev)} B")
    torch.set_grad_enabled(True)
    t_phase = time.perf_counter()
    total = dict.fromkeys(Q8_KERNELS, 0)
    secs = {}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    def start():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        return time.perf_counter()

    def read():
        torch.cuda.synchronize()
        counts = launch_counts()
        add(counts)
        return counts, torch.cuda.max_memory_allocated(dev)

    # ---- 10a: granite-moe-3b-a800m at its published size -----------------
    masks, unwrap = keep_masks()
    t0 = start()
    try:
        tr = launcher.main(list(MOE_TRAIN_ARGV))
    finally:
        unwrap()
    counts, peak = read()
    train_report("10a", tr, counts, peak)
    n_l, steps = tr.cfg.n_layers, len(tr.history)
    # per step each MoE layer runs once forward and, under per-layer
    # remat, once more in the backward pass; each layer's first call counts
    per_call = len(masks) // steps
    if per_call not in (n_l, 2 * n_l) or len(masks) != steps * per_call:
        fail(f"phase 10a: {len(masks)} MoE calls in {steps} steps of "
             f"{n_l} MoE layers")
    kept = [float(torch.stack(masks[i * per_call:i * per_call + n_l]
                              ).float().mean()) for i in range(steps)]
    del masks
    print(f"phase 10a: kept share of the {tr.cfg.moe.top_k} x "
          f"{tr.tc.batch * tr.tc.seq} expert assignments per step (each "
          f"layer's first call; {per_call} MoE calls a step): "
          f"{[round(x, 4) for x in kept]}")
    by_name = trace_step("10a", tr)
    index = {short_name(n): round(us / 1e3, 3) for n, us in by_name.items()
             if any(k in n.lower() for k in ("index", "scatter", "gather",
                                             "embedding"))}
    print(f"phase 10a trace: index, gather and scatter kernels (device ms):"
          f" {index}")
    secs["10a"] = time.perf_counter() - t0
    print(f"phase 10a: {secs['10a']:.3f} s")
    t0 = time.perf_counter()
    real_gradients("phase 10a-ii", tr, dev, twice=True)
    del tr
    secs["10a-ii"] = time.perf_counter() - t0
    print(f"phase 10a-ii: {secs['10a-ii']:.3f} s")

    # ---- 10b: rwkv6-7b at full width, depth RWKV_DEPTH --------------------
    cfg = dataclasses.replace(get_config(RWKV_ARCH),
                              name=f"{RWKV_ARCH}-depth{RWKV_DEPTH}",
                              n_layers=RWKV_DEPTH)
    t0 = start()
    tr = Trainer(cfg, TrainConfig(
        steps=RWKV_STEPS, batch=RWKV_BATCH, seq=RWKV_SEQ, lr=TRAIN_LR,
        hbm_budget_bytes=TRAIN_BUDGETS[0], seed=0, log_every=1), device=dev)
    tr.run()
    counts, peak = read()
    train_report("10b", tr, counts, peak)
    trace_step("10b", tr, scan_module=R)
    secs["10b"] = time.perf_counter() - t0
    print(f"phase 10b: {secs['10b']:.3f} s")
    t0 = time.perf_counter()
    real_gradients("phase 10b-ii", tr, dev, twice=False)
    del tr
    secs["10b-ii"] = time.perf_counter() - t0
    print(f"phase 10b-ii: {secs['10b-ii']:.3f} s")

    # ---- 10c: card vs CPU at full width, depth 2 ---------------------------
    t0 = time.perf_counter()
    b, s = FAMILY_TRAIN
    for arch in WIDE_ARCHS:
        cfg = dataclasses.replace(get_config(arch), name=f"{arch}-depth2",
                                  n_layers=2)
        start()
        p_card = MD.init_params(torch.Generator(dev).manual_seed(0), cfg,
                                device=dev)
        add(train_card_vs_cpu("phase 10c", cfg.name, cfg, p_card,
                              family_step(cfg),
                              family_batches(cfg, b, s, FAMILY_TRAIN_STEPS),
                              dev))
        del p_card
    secs["10c"] = time.perf_counter() - t0
    print(f"phase 10c: {secs['10c']:.3f} s")

    # ---- 10d: the hybrid -------------------------------------------------
    t0 = time.perf_counter()
    cfg = smoke_config(HYBRID_ARCH)
    start()
    p_card = MD.init_params(torch.Generator(dev).manual_seed(0), cfg,
                            device=dev)
    add(train_card_vs_cpu("phase 10d", cfg.name, cfg, p_card,
                          family_step(cfg),
                          family_batches(cfg, *HYBRID_TRAIN,
                                         FAMILY_TRAIN_STEPS), dev))
    cfg = get_config(HYBRID_ARCH)
    start()
    blk = MB.init_mamba_block(torch.Generator(dev).manual_seed(0), cfg,
                              device=dev)
    g = torch.Generator().manual_seed(3)
    b, s = MAMBA_TRAIN
    batches = [{k: torch.randn((b, s, cfg.d_model), generator=g)
                for k in ("x", "target")} for _ in range(FAMILY_TRAIN_STEPS)]
    add(train_card_vs_cpu(
        "phase 10d", f"{HYBRID_ARCH}'s Mamba block alone (d_inner "
        f"{MB.d_inner(cfg)}, d_state {cfg.hybrid.d_state})", cfg, blk,
        mamba_step(cfg), batches, dev))
    del p_card, blk, batches
    secs["10d"] = time.perf_counter() - t0
    print(f"phase 10d: {secs['10d']:.3f} s")

    # ---- 10e: every non-dense architecture through the launcher ----------
    t0 = time.perf_counter()

    class Recorded(Trainer):
        """The launcher's Trainer, keeping a CPU copy of its initial
        parameters."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.initial = {n: p_.detach().to("cpu", copy=True)
                            for n, p_ in self.params.named_parameters()}

    launcher.Trainer = Recorded
    try:
        for arch in LAUNCH_ARCHS:
            t1 = start()
            tr = launcher.main(["--arch", arch, "--steps",
                                str(LAUNCH_STEPS)])
            counts, _ = read()
            t_card = time.perf_counter() - t1
            t1 = time.perf_counter()
            ref = Trainer(tr.cfg, tr.tc, device="cpu")
            ref.params.load_state_dict(tr.initial)
            ref.run()
            losses = [h["loss"] for h in tr.history]
            want = [h["loss"] for h in ref.history]
            print(f"phase 10e: launch.train.main(--arch {arch} --steps "
                  f"{LAUNCH_STEPS}): {tr.cfg.name} on {tr.device}, plan "
                  f"{tr.plan.choices}, losses {losses} ({t_card:.3f} s; q8 "
                  f"launches {[counts[k] for k in Q8_KERNELS]}); the same "
                  f"initial weights trained on the CPU: {want} "
                  f"({time.perf_counter() - t1:.3f} s)")
            if not all(math.isfinite(v) for v in losses):
                fail(f"phase 10e: {arch}: losses {losses}")
            for a_, b_ in zip(losses, want):
                if not math.isclose(a_, b_, rel_tol=LAUNCH_LOSS_RTOL):
                    fail(f"phase 10e: {arch}: card losses {losses} and CPU "
                         f"losses {want} differ beyond rtol "
                         f"{LAUNCH_LOSS_RTOL}")
            if tr.cfg.frontend != "tokens" and max(
                    abs(v - init_loss(tr.cfg)) for v in losses) > \
                    FIRST_LOSS_WINDOW:
                # a stub frontend sees `batch_at`'s noise embeddings, which
                # say nothing of the labels: its loss stays near ln(vocab)
                fail(f"phase 10e: {arch}: losses {losses} leave "
                     f"{init_loss(tr.cfg):.4f} +- {FIRST_LOSS_WINDOW}")
            if not losses[-1] < losses[0]:
                q8_rise(arch, tr, losses, want)
            del tr, ref
    finally:
        launcher.Trainer = Trainer
    secs["10e"] = time.perf_counter() - t0
    print(f"phase 10e: {secs['10e']:.3f} s")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 10: {time.perf_counter() - t_phase:.3f} s; by part "
          f"{json.dumps({k: round(v, 3) for k, v in secs.items()})}; q8 "
          f"launches over its training runs {json.dumps(total)}")
    for k, n_k in total.items():
        if n_k == 0:
            fail(f"phase 10: no {k} launch")
    return total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch import core as pt
    from repro_torch.kernels import (build, codec_bytes as cb,
                                     dequant_matmul as dqm, launch_counts,
                                     planner_score as ps,
                                     quantize_blockwise as qb,
                                     reset_launch_counts)

    # the plain versions' float32 products run in IEEE float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")

    # ---- phase 1: build ----------------------------------------------
    enter_phase("1")
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.3f} s "
          f"({', '.join(p.name for p in libs)})")

    # ---- phase 2: kernels against plain versions, edge cases ---------
    enter_phase("2")
    rng = np.random.default_rng(0)

    def t64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

    def codec_case(label, cols, widths, rpp):
        cols, widths = t64(cols), t64(widths)
        for name in CODECS:
            args = (cols, widths) if name in ORD_IND else (cols, widths, rpp)
            got = getattr(cb, name)(*args)
            want = getattr(cb, f"{name}_plain")(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"{name} != plain on {label} (rpp {rpp})")

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
    # runs of repeated values with both signs, for PREFIX and RLE
    for label, n, rpp in [("runs rpp 1", 500, 1),
                          ("runs single page", 1500, 1638),
                          ("runs last partial page", 1000, 273)]:
        runs = np.repeat(rng.integers(-50, 50, size=(6, n)),
                         rng.integers(1, 40, size=n), axis=1)[:, :n]
        runs[1] = np.sort(runs[1])
        runs[2] = 9
        codec_case(label, runs, [1, 2, 4, 8, 8, 3], rpp)
        n_cases += 1
    print(f"codec kernels: {', '.join(CODECS)} bit-equal to plain on "
          f"{n_cases} cases")

    # LDICT's hash set: page sizes on both sides of its warp / block split
    # and of a warp's 32 lanes, ragged last pages and single short pages,
    # rows all equal, all distinct, at the int64 extremes (INT64_MIN is its
    # empty-slot marker) or differing only in their high bits; then grids
    # of more than 65,535 pages
    i64_min, i64_max = -(1 << 63), (1 << 63) - 1

    def run_stack(n, rpp):
        """Runs where RLE's page walk cuts: a run of rpp across every page
        boundary, alternating values, runs of two on and off a 16-byte
        pair, changes at and one before a warp step's 64 values."""
        i = np.arange(n)
        return np.stack([(i + rpp // 2) // rpp, i % 2, i // 2, (i + 1) // 2,
                         i // 64, (i + 1) // 64])

    def byte_edge_stack(n):
        """Each row the values 2^(8k) - 1 and 2^(8k), k = 1..7, and -2^(8k)
        at shifting positions."""
        edges = np.array([v for k in range(1, 8) for v in
                          ((1 << (8 * k)) - 1, 1 << (8 * k), -(1 << (8 * k)))],
                         dtype=np.int64)
        return np.stack([np.resize(np.roll(edges, j), n) for j in range(3)])

    def edge_stack(n):
        """Rows all equal, of both signs, at the int64 extremes, differing
        only in their high bits, of a small domain, of the full range."""
        ext = rng.choice([i64_min, i64_max, 0, -1, 1], size=n)
        ext[0], ext[-1] = i64_min, i64_max
        return np.stack([np.full(n, 5), np.arange(n) * 7 - n, ext,
                         np.full(n, i64_min), np.full(n, i64_max),
                         rng.integers(0, 256, size=n) << 55,
                         rng.integers(0, 5, size=n),
                         rng.integers(i64_min, i64_max, size=n,
                                      endpoint=True)])

    n_ld = 0
    for rpp in LDICT_RPPS:
        for n in (3 * rpp + rpp // 2 + 1, max(1, rpp - 3)):
            stack = edge_stack(n)
            # as they are (few pages: a block per page) and 256 times over
            # (>= 1,024 pages: a warp per page, where a page has <= 512 rows)
            for copies in (1, 256):
                cols = t64(np.tile(stack, (copies, 1)))
                widths = t64([1, 2, 8, 8, 8, 8, 1, 8] * copies)
                if not torch.equal(cb.ldict_bytes(cols, widths, rpp),
                                   cb.ldict_bytes_plain(cols, widths, rpp)):
                    fail(f"ldict_bytes != plain on edge rows, rpp {rpp}, n "
                         f"{n}, {copies} copies")
                n_ld += 1
    for shape, rpp in LDICT_GRIDS:
        cols = t64(rng.integers(0, 1 << 24, size=shape))
        widths = t64(rng.integers(1, 9, size=shape[0]))
        if not torch.equal(cb.ldict_bytes(cols, widths, rpp),
                           cb.ldict_bytes_plain(cols, widths, rpp)):
            fail(f"ldict_bytes != plain on {shape} at rpp {rpp} "
                 f"({shape[0] * -(-shape[1] // rpp)} pages)")
        n_ld += 1
    print(f"codec kernels: ldict_bytes bit-equal to plain on {n_ld} more "
          f"cases (rpp {LDICT_RPPS}, ragged and single short pages, equal, "
          f"distinct and int64-extreme rows, on few pages and on many; "
          f"grids {LDICT_GRIDS})")
    # PREFIX and RLE (one page walk) on the same rows and on runs across
    # page, 16-byte pair and warp-step boundaries: few pages or pages of
    # more than 512 rows take the block per page, >= 1,024 pages of <= 512
    # rows the warp path; each stack also from its second row on (pages
    # whose first value is not 16-byte aligned where n is odd); then grids
    # of more than 65,535 pages, runs of 1-4 values of both signs
    n_px = 0
    for rpp in PREFIX_RPPS:
        for n in (3 * rpp + rpp // 2 + 1, max(1, rpp - 3)):
            stack = np.concatenate([edge_stack(n), run_stack(n, rpp)])
            for copies in (1, 256):
                cols = t64(np.tile(stack, (copies, 1)))
                widths = t64(np.resize([1, 2, 8, 8, 8, 8, 1, 8, 3],
                                       len(stack) * copies))
                for off in (0, 1):
                    args = (cols[off:], widths[off:], rpp)
                    for name in ("prefix_bytes", "rle_bytes"):
                        if not torch.equal(
                                getattr(cb, name)(*args),
                                getattr(cb, f"{name}_plain")(*args)):
                            fail(f"{name} != plain on edge rows, rpp {rpp}, "
                                 f"n {n}, {copies} copies, from row {off}")
                    n_px += 1
    for shape, rpp in PREFIX_GRIDS:
        vals = rng.integers(-(1 << 40), 1 << 40, size=shape)
        cols = t64(np.repeat(vals, rng.integers(1, 5, size=shape[1]),
                             axis=1)[:, :shape[1]])
        widths = t64(rng.integers(1, 9, size=shape[0]))
        for name in ("prefix_bytes", "rle_bytes"):
            if not torch.equal(getattr(cb, name)(cols, widths, rpp),
                               getattr(cb, f"{name}_plain")(cols, widths,
                                                            rpp)):
                fail(f"{name} != plain on {shape} at rpp {rpp} "
                     f"({shape[0] * -(-shape[1] // rpp)} pages)")
        n_px += 1
    del cols, widths, stack, args, vals
    print(f"codec kernels: prefix_bytes and rle_bytes bit-equal to plain on "
          f"{n_px} more cases each (rpp {PREFIX_RPPS}, the same rows and "
          f"runs across page, pair and warp-step boundaries on few pages "
          f"and on many, aligned and not; grids {PREFIX_GRIDS})")
    # NS on the same rows with the significant-byte edges, rows of one
    # block and rows split over a cluster of up to 8 blocks, 16-byte
    # aligned and not
    n_ns = 0
    for m, n in NS_EDGES:
        stack = np.concatenate([edge_stack(n), byte_edge_stack(n)])
        cols = t64(np.resize(stack, (m + 1, n)))
        widths = t64(np.resize(np.arange(1, 9), m + 1))
        for off in (0, 1):
            args = (cols[off:], widths[off:])
            if not torch.equal(cb.ns_bytes(*args), cb.ns_bytes_plain(*args)):
                fail(f"ns_bytes != plain on edge rows ({m}, {n}) from row "
                     f"{off}")
            n_ns += 1
    del cols, widths, stack, args
    print(f"codec kernels: ns_bytes bit-equal to plain on {n_ns} more cases "
          f"((m, n) {NS_EDGES}, significant-byte edges at widths 1-8, "
          f"aligned and not)")
    # GDICT's hash set on the same rows and on rows of three distinct
    # values, values differing only in their high or low 32 bits, and
    # INT64_MIN (its empty-slot marker) replaced by its successor, at each
    # layout's limits; one launch a call
    def gdict_stack(n):
        i = np.arange(n)
        ext = edge_stack(n)
        return np.concatenate([ext, np.stack([
            np.resize([7, 1 << 20, 1 << 40], n), (i // 2) << 32,
            (5 << 32) | (i // 2),
            np.where(ext[2] == i64_min, i64_min + 1, ext[2])])])

    n_gd, routes = 0, set()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n in GDICT_NS:
        stack = gdict_stack(n)
        for m in [len(stack)] + [m_ for m_, n_ in GDICT_STACKS if n_ == n]:
            cols = t64(np.resize(stack, (m + 1, n)))
            widths = t64(np.resize([1, 2, 4, 8, 3], m + 1))
            for off in (0, 1):
                args = (cols[off:], widths[off:])
                before = launch_counts()["gdict_bytes"]
                got = cb.gdict_bytes(*args)
                if launch_counts()["gdict_bytes"] != before + 1 or \
                        not torch.equal(got, cb.gdict_bytes_plain(*args)):
                    fail(f"gdict_bytes != plain, or not one launch, on edge "
                         f"rows ({m}, {n}) from row {off}")
                routes.add(cb.gdict_plan(m, n, sms).route)
                n_gd += 1
    if routes != set(cb.GDICT_ROUTES):
        fail(f"phase 2 reached GDICT's layouts {sorted(routes)} only")
    del cols, widths, stack, args, got
    print(f"codec kernels: gdict_bytes bit-equal to plain in one launch on "
          f"{n_gd} more cases (n {GDICT_NS}, stacks {GDICT_STACKS}, aligned "
          f"and not; layouts {sorted(routes)})")

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

    # the planner walk on synthetic graphs: random targets (some twice),
    # candidates of 1-6 children (shared, repeated, the target itself)
    # over `used` of the n nodes, bit-equal to its plain version, which
    # scores each record with the fused_score kernel; its node state in
    # shared memory, then (12,000 nodes) in global memory
    def synth_walk(seed, n, nrec, nf, used):
        r = np.random.default_rng(seed)
        ncand = r.integers(0, 30, nrec)
        nc_all = int(ncand.sum())
        k = 6
        nchild = r.integers(1, k + 1, nc_all)
        child = np.full((nc_all, k), n)
        for i in range(nc_all):
            child[i, :nchild[i]] = r.integers(0, used, nchild[i])
        off = np.concatenate([[0], np.cumsum(ncand)])
        dmv = r.uniform(0.95, 1.05, nc_all)
        sdv = r.uniform(0.0, 0.05, nc_all)
        scost = np.zeros((n + 1, nf))
        scost[:n] = r.uniform(1.0, 100.0, (n, nf))

        def t(a, dt):
            return torch.as_tensor(np.asarray(a, dtype=dt), device=dev)
        tids = r.integers(0, used, nrec)
        if used < n:     # the used nodes spread over all n
            ids = np.append(np.sort(r.choice(n, used, replace=False)), n)
            tids, child = ids[tids], ids[np.where(child == n, used, child)]
        return ps.WalkGraph(
            t(tids, np.int32), t(r.integers(0, 2, nrec), np.int32),
            t(off, np.int32), t(child, np.int32), t(nchild, np.int32),
            t(dmv, np.float32), t(sdv * sdv + dmv * dmv, np.float32),
            t(dmv * dmv, np.float32), t(scost, np.float64),
            t(r.uniform(0.9, 1.1, (2, nf)), np.float64),
            t(r.uniform(0.01, 0.3, (2, nf)), np.float64),
            t(tids, np.int32), max_cands=int(ncand.max()))

    def walk_equal(got, want):
        return all(bit_equal(a, b) for a, b in zip(got, want))

    for shape, in_smem in zip(WALK_SYNTH, (True, False)):
        wg = synth_walk(3, *shape)
        layout = "shared" if ps.walk_in_shared_memory(wg) else "global"
        if layout != ("shared" if in_smem else "global"):
            fail(f"planner_walk keeps a graph of {shape[0]} nodes in "
                 f"{layout} memory")
        # feasibility judged against a q_feas that splits the fractions:
        # the median over the fractions of their least target p
        q_feas = float(ps.planner_walk(wg, e, q).p.double().amin(dim=0)
                       .median())
        got = ps.planner_walk(wg, e, q, q_feas)
        if not walk_equal(got, ps.planner_walk_plain(wg, e, q, q_feas)):
            fail(f"planner_walk differs from its plain version on the "
                 f"synthetic graph {shape}")
        tg = wg.targets.long()
        if not bit_equal(got.p, ps.prob_within(got.mean[tg].float(),
                                               got.std[tg].float(), e)):
            fail(f"planner_walk's p differs from prob_within on its own "
                 f"final RVs on the synthetic graph {shape}")
        kinds = {c: int(v) for c, v in (
            ("skipped", (got.win == ps.WALK_SKIP).sum()),
            ("fallback", (got.win == ps.WALK_FALLBACK).sum()),
            ("lines 6-7", ((got.win >= 0) & (got.win < ps.WALK_LINE9)).sum()),
            ("lines 8-9", (got.win >= ps.WALK_LINE9).sum()))}
        if min(kinds.values()) == 0:
            fail(f"the synthetic walk graph {shape} misses a decision kind: "
                 f"{kinds}")
        print(f"planner kernels: planner_walk bit-equal to its plain version "
              f"on a synthetic graph {shape} (nodes, records, fractions, "
              f"nodes used), node state in {layout} memory: decisions "
              f"{kinds}; feasible {got.feasible.tolist()} against q_feas "
              f"{q_feas!r}, p = prob_within's on its final RVs")

    # blockwise quantization, bit-equal to plain
    half = np.zeros((2, 128), np.float32)
    half[0, 0] = 127.0                   # scale 1: x / scale lands on .5
    half[0, 1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    zero_block = rng.standard_normal((3, 256)) * 3
    zero_block[1, 128:] = 0.0
    q_cases = [("ragged 7", rng.standard_normal((5, 7)), torch.float32),
               ("ragged 130", rng.standard_normal((9, 130)) * 5,
                torch.float32),
               ("all-zero block", zero_block, torch.float32),
               (".5 after division", half, torch.float32),
               ("bf16", rng.standard_normal((64, 384)) * 3, torch.bfloat16),
               ("rank 3", rng.standard_normal((4, 2, 96)), torch.float32),
               ("rank 4", rng.standard_normal((3, 5, 7, 130)),
                torch.float32)]
    for label, x, dt in q_cases:
        xt = f32(x).to(dt)
        qt, st = qb.quantize_blockwise(xt)
        qt_p, st_p = qb.quantize_blockwise_plain(xt)
        torch.cuda.synchronize()
        if not (torch.equal(qt, qt_p) and torch.equal(st, st_p)):
            fail(f"quantize_blockwise != plain on {label}")
    if qb.quantize_blockwise(f32(half))[0][0, 1:9].tolist() != \
            [0, 2, 2, 0, -2, -2, 126, -126]:
        fail("quantize_blockwise does not round half to even")
    # quantize_kv at TinyLlama-1.1B's per-layer KV cache (phase 5's slots
    # and length, its KV heads and head dimension): each head row is one
    # block of 128 with 64 masked, as the JAX package zero-pads it
    from repro_torch.configs import get_config
    lm_cfg = get_config(LM_ARCH)
    kv = f32(np.random.default_rng(31).standard_normal(
        (LM_SLOTS, LM_MAX_LEN, lm_cfg.n_kv_heads, lm_cfg.d_head)) * 2)
    kv_q, kv_s = qb.quantize_kv(kv)
    kv_qp, kv_sp = qb.quantize_blockwise_plain(kv)
    torch.cuda.synchronize()
    if not (torch.equal(kv_q, kv_qp) and bit_equal(kv_s, kv_sp)) or \
            kv_s.shape[-1] != 1:
        fail("quantize_kv != plain at TinyLlama-1.1B's KV shape")
    print(f"LM kernels: quantize_kv bit-equal to plain at {tuple(kv.shape)}"
          f" (block {qb.DEFAULT_BLOCK}, head dimension {lm_cfg.d_head})")
    del kv, kv_q, kv_s, kv_qp, kv_sp

    # grouped quantization, bit-equal to plain in one launch per
    # group_capacity() items: a mixed list (ranks 1-4, ragged last blocks,
    # last dimensions under one block and under 4, bfloat16, an empty
    # tensor); a list longer than one parameter struct; x or q one element
    # off an aligned address; blocks of 1, 6, 64, 100 and 256 (the
    # two-pass path); x / scale on and a few ulps around every k + .5 and
    # +-127 under random scales
    def q_items(shapes, seed, block=qb.DEFAULT_BLOCK):
        r = np.random.default_rng(seed)
        items = []
        for i, shape in enumerate(shapes):
            x = f32(r.standard_normal(shape) * 3)
            if i % 3 == 1:
                x = x.to(torch.bfloat16)
            items.append((x, torch.full(shape, 99, dtype=torch.int8,
                                        device=dev),
                          torch.full((*shape[:-1], -(-shape[-1] // block)),
                                     float("nan"), device=dev)))
        return items

    def qgroup_case(label, items, block=qb.DEFAULT_BLOCK):
        before = launch_counts()["quantize_blockwise"]
        qb.quantize_blockwise_group(items, block)
        launched = launch_counts()["quantize_blockwise"] - before
        live = sum(1 for x, _, _ in items if x.numel())
        if launched != -(-live // qb.group_capacity()):
            fail(f"quantize_blockwise_group launched {launched} times for "
                 f"{live} items ({label})")
        for x, gq, gs in items:
            q_p, s_p = qb.quantize_blockwise_plain(x, block)
            if not (torch.equal(gq, q_p) and bit_equal(gs, s_p)):
                fail(f"quantize_blockwise_group != plain on {label}: "
                     f"{tuple(x.shape)} {x.dtype}, block {block}")
        return len(items)

    n_qg = qgroup_case("a mixed list", q_items(
        [(2048,), (300,), (7,), (3,), (32, 64), (9, 130), (128, 256),
         (3, 5, 200), (2, 3, 4, 384), (2, 2, 2, 129), (1000,), (0, 5),
         (40, 8), (6, 1)], 7))
    r = np.random.default_rng(8)
    n_qg += qgroup_case("a list longer than one launch", q_items(
        [(int(r.integers(1, 4)), int(r.integers(1, 300)))
         for _ in range(qb.group_capacity() + 5)], 9))
    for where in ("x", "q"):
        items = q_items([(37, 256), (5, 130), (64,)], 10)
        for i, (x, gq, gs) in enumerate(items):
            src_t = x if where == "x" else gq
            buf = torch.empty(src_t.numel() + 1, dtype=src_t.dtype,
                              device=dev)
            moved = buf[1:].view(src_t.shape).copy_(src_t)
            items[i] = (moved, gq, gs) if where == "x" else (x, moved, gs)
        n_qg += qgroup_case(f"{where} at an odd address", items)
    for block in (1, 6, 64, 100, 256):
        n_qg += qgroup_case(f"block {block}", q_items(
            [(3, 300), (7,), (4, 2, 129), (1, 1000), (50, 64)], block,
            block), block)
    kq = r.integers(-127, 127, size=(8192, 128)).astype(np.float32)
    sc = r.uniform(1e-6, 1e3, size=(8192, 1)).astype(np.float32)
    edge = (kq + 0.5) * sc
    edge[:, 0], edge[:, 1] = 127 * sc[:, 0], -127 * sc[:, 0]
    edge *= (1 + r.integers(-3, 4, size=edge.shape) * 2.0 ** -23).astype(
        np.float32)
    for dt in (torch.float32, torch.bfloat16):
        xe = f32(edge).to(dt)
        n_qg += qgroup_case(f".5 boundaries ({dt})", [(
            xe, torch.empty(xe.shape, dtype=torch.int8, device=dev),
            torch.empty((8192, 1), device=dev))])
    del items, buf, moved, src_t, edge, xe
    print(f"LM kernels: quantize_blockwise_group bit-equal to plain on "
          f"{n_qg} tensors (mixed ranks and types, unaligned x and q, blocks "
          f"1 to 256, .5 boundaries; one launch per "
          f"{qb.group_capacity()} items)")

    # blockwise dequantization of the same cases, bit-equal to plain in
    # float32 and bfloat16, and once more from an int8 tensor at an odd
    # address (the kernel's one-element-at-a-time path)
    n_dq = 0
    for label, x, dt in q_cases + [("odd address", rng.standard_normal(
            (6, 256)), torch.float32)]:
        dq_q, dq_s = qb.quantize_blockwise_plain(f32(x).to(dt))
        if label == "odd address":
            buf = torch.empty(dq_q.numel() + 1, dtype=torch.int8, device=dev)
            dq_q = buf[1:].view(dq_q.shape).copy_(dq_q)
        for out_dt in (torch.float32, torch.bfloat16):
            if not bit_equal(qb.dequantize_blockwise(dq_q, dq_s, dtype=out_dt),
                             qb.dequantize_blockwise_plain(dq_q, dq_s,
                                                           dtype=out_dt)):
                fail(f"dequantize_blockwise != plain on {label} ({out_dt})")
            n_dq += 1

    # grouped dequantization: a mixed list (ranks 1-4, ragged last blocks,
    # last dimensions under one block, both output types, a q at an odd
    # address) in one launch, then a list longer than one parameter struct
    def group_case(shapes, seed):
        r = np.random.default_rng(seed)
        items = []
        for i, shape in enumerate(shapes):
            gq, gs = qb.quantize_blockwise_plain(f32(r.standard_normal(shape)
                                                     * 3))
            if i == 4:
                buf = torch.empty(gq.numel() + 1, dtype=torch.int8,
                                  device=dev)
                gq = buf[1:].view(gq.shape).copy_(gq)
            items.append((gq, gs, torch.full(
                shape, float("nan"), device=dev,
                dtype=torch.bfloat16 if i % 3 == 1 else torch.float32)))
        before = launch_counts()["dequantize_blockwise"]
        qb.dequantize_blockwise_group(items)
        launched = launch_counts()["dequantize_blockwise"] - before
        if launched != -(-len(items) // qb.group_capacity()):
            fail(f"dequantize_blockwise_group launched {launched} times for "
                 f"{len(items)} items")
        for gq, gs, out in items:
            if not bit_equal(out, qb.dequantize_blockwise_plain(
                    gq, gs, dtype=out.dtype)):
                fail(f"dequantize_blockwise_group != plain on "
                     f"{tuple(gq.shape)} ({out.dtype})")
        return len(items)

    cap = qb.group_capacity()
    r = np.random.default_rng(5)
    n_group = group_case([(2048,), (300,), (7,), (32, 64), (9, 130),
                          (128, 256), (3, 5, 200), (2, 3, 4, 384),
                          (2, 2, 2, 129), (1000,)], 4)
    n_group += group_case([(int(r.integers(1, 4)), int(r.integers(1, 300)))
                           for _ in range(cap + 5)], 6)
    print(f"LM kernels: dequantize_blockwise_group bit-equal to plain on "
          f"{n_group} tensors in 2 groups (one launch per {cap} items)")

    # dequant-matmul within DMM_TOL of the plain IEEE float32 product
    if torch.backends.cuda.matmul.allow_tf32:
        fail("the plain dequant-matmul would run in TF32")

    def dmm_inputs(m, k, n, seed):
        r = np.random.default_rng(seed)
        a = f32(r.standard_normal((m, k)))
        w = f32(r.standard_normal((k, n)) * 0.02)
        qw, sw = qb.quantize_blockwise_plain(w.t().contiguous())
        return a, qw.t().contiguous(), sw.t().contiguous()

    # M on both sides of the decode kernel's threshold (8), masked N
    n_dmm = 0
    worst = 0.0
    for dm_m in (1, 3, 4, 8, 9, 16, 17, 512):
        for dm_k in (128, 384, 2048, 5632):
            for dm_n in ((200, 5632) if dm_m == 4 else (70,) if dm_m in (
                    1, 3, 512) else (70, 200)):
                a, qw, sw = dmm_inputs(dm_m, dm_k, dm_n,
                                       dm_m * dm_k + dm_n)
                got = dqm.dequant_matmul(a, qw, sw)
                again = dqm.dequant_matmul(a, qw, sw)
                want = dqm.dequant_matmul_plain(a, qw, sw)
                torch.cuda.synchronize()
                if not torch.allclose(got, want, rtol=DMM_TOL, atol=DMM_TOL):
                    fail(f"dequant_matmul differs from plain at M={dm_m} "
                         f"K={dm_k} N={dm_n}")
                if not bit_equal(got, again):
                    fail(f"two dequant_matmul calls differ at M={dm_m} "
                         f"K={dm_k} N={dm_n}")
                worst = max(worst, float((got - want).abs().max()))
                n_dmm += 1
    del a, qw, sw, got, again, want, xt, qt, st, qt_p, st_p, dq_q, dq_s, \
        buf, r, wg
    print(f"LM kernels: quantize_blockwise bit-equal to plain on "
          f"{len(q_cases)} cases (round half to even); dequant_matmul within "
          f"rtol/atol {DMM_TOL} of plain on {n_dmm} cases (max abs err "
          f"{worst:.3g}; decode kernel for M <= {dqm._decode_max_m}, "
          f"tensor cores above), bit-equal from call to call")
    print(f"LM kernels: dequantize_blockwise bit-equal to plain on {n_dq} "
          "cases (float32 and bfloat16 output)")

    # phase 2's large edge cases must not weigh on phase 3's host code
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 3: the main path at TPC-H SF1 -------------------------
    enter_phase("3")
    t0 = time.perf_counter()
    schema = pt.make_tpch_like(scale=SF1_SCALE, z=0.0, seed=0)
    wl = pt.make_tpch_workload(schema, insert_weight=0.1)
    budget = advisor_budget(schema)
    print(f"data: TPC-H-like scale={SF1_SCALE}, lineitem "
          f"{schema.tables['lineitem'].nrows} rows, "
          f"{len(wl.statements)} statements, budget {budget:.1f} B, "
          f"generated in {time.perf_counter() - t0:.3f} s")

    # a second torch run of phases 3 and 3b, after every measured run,
    # keeps each kernel's largest inputs for phase 4 (holding them would
    # raise a measured run's peak memory)
    captured = {}
    # LDICT's inputs per phase, one for each (shape, rpp) it was given
    ldict_inputs = {}

    def capture(mod, name, size_of, label=None):
        orig = getattr(mod, name)

        def wrapper(*a, **kw):
            size = size_of(*a)
            if name not in captured or size > captured[name][0]:
                captured[name] = (size, a)
            if name == "ldict_bytes":
                ldict_inputs.setdefault(label, {}).setdefault(
                    (tuple(a[0].shape), int(a[2])), a)
            return orig(*a, **kw)
        setattr(mod, name, wrapper)
        return orig

    def captured_run(make, label):
        originals = {(cb, n): capture(cb, n, lambda c, *r: c.numel(), label)
                     for n in CODECS}
        try:
            return make()
        finally:
            for (mod, name), fn in originals.items():
                setattr(mod, name, fn)

    def measured(label, make):
        """Run `make` with the launch counters zeroed just before and read
        just after, and the peak device memory reset and printed; returns
        (result, wall seconds, launches)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        got = make()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"launches in {label}: {json.dumps(counts)}")
        print(f"peak device memory in {label} (max_memory_allocated): "
              f"{peak} B")
        return got, wall, counts

    def print_rec(label, rec, wall):
        ph = ", ".join(f"{k} {rec.phase_seconds[k]:.3f}"
                       for k in pt.advisor.PHASES)
        print(f"recommend {label}: {wall:.3f} s ({ph}); plan f="
              f"{rec.estimation_plan.f} sampled={rec.n_sampled} "
              f"deduced={rec.n_deduced}; cost={rec.cost!r} "
              f"used_bytes={rec.used_bytes!r}; {len(rec.config.indexes)} "
              f"indexes, {len(rec.steps)} steps; statements "
              f"{rec.n_statements_full} -> {rec.n_representatives}, "
              f"error bound {float(rec.compression_error_bound)!r}")

    def judge_config(label, rec_t, rec_n, price):
        """Equal configurations, or an equal-cost tie: `price` (the numpy
        pipeline's cost oracle) puts the torch choice at the numpy
        optimum's cost."""
        cfg_t = {i.label() for i in rec_t.config.indexes}
        cfg_n = {i.label() for i in rec_n.config.indexes}
        if cfg_t == cfg_n:
            print(f"{label}: configs equal")
            return True
        judged = price(rec_t.config)
        mine = price(rec_n.config)
        print(f"{label}: configs differ: torch-only {sorted(cfg_t - cfg_n)}"
              f"; numpy-only {sorted(cfg_n - cfg_t)}; numpy prices the "
              f"torch config at {judged!r} vs its own {mine!r}")
        if not math.isclose(judged, mine, rel_tol=1e-6):
            fail(f"{label}: configurations differ and are not an "
                 "equal-cost tie")
        return False

    def compare_recs(label, rec_t, rec_n):
        if (rec_t.estimation_plan.f, rec_t.n_sampled, rec_t.n_deduced,
                rec_t.n_representatives) != \
                (rec_n.estimation_plan.f, rec_n.n_sampled, rec_n.n_deduced,
                 rec_n.n_representatives):
            fail(f"{label}: torch and numpy plans or representatives differ")
        for what, a, b in (("cost", rec_t.cost, rec_n.cost),
                           ("used_bytes", rec_t.used_bytes,
                            rec_n.used_bytes)):
            if not math.isclose(a, b, rel_tol=1e-6):
                fail(f"{label}: {what} differs beyond rtol 1e-6: {a!r} vs "
                     f"{b!r}")
        if rec_t.steps != rec_n.steps:
            print(f"{label}: greedy steps differ ({len(rec_t.steps)} torch, "
                  f"{len(rec_n.steps)} numpy); torch's last three: "
                  f"{rec_t.steps[-3:]}")

    def need_launches(label, counts, names):
        for name in names:
            if counts[name] <= 0:
                fail(f"kernel {name} was not launched in {label}")
        # the planner: one walk for the run's one plan, no per-record
        # launch, no probability launch (the walk judges feasibility)
        planner = {n: counts[n] for n in ("planner_walk", "fused_score",
                                          "prob_within")}
        if planner != {"planner_walk": 1, "fused_score": 0, "prob_within": 0}:
            fail(f"{label}: planner launches {planner}, not one walk alone")

    # each measured run's walk: its packed graph, (e, q, q_feas) and result
    walks = {}
    walk = ps.planner_walk

    def walked(label, make):
        def recording(g, *a):
            walks[label] = (g, a, walk(g, *a))
            return walks[label][2]
        ps.planner_walk = recording
        try:
            return measured(label, make)
        finally:
            ps.planner_walk = walk

    def check_walk(label):
        """The run's walk bit-equal to planner_walk_plain on the card (each
        record scored by the fused_score kernel); returns the plain walk's
        seconds."""
        g, args_, got = walks[label]
        t0 = time.perf_counter()
        want = ps.planner_walk_plain(g, *args_)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for name, a, b in zip(ps.WalkResult._fields, got, want):
            if not bit_equal(a, b):
                fail(f"{label}: the walk's {name} differs from "
                     "planner_walk_plain on the card")
        print(f"{label}: planner_walk (one launch, {g.tid.numel()} records, "
              f"{g.dm.numel()} candidates, {g.scost.shape[0]} nodes with the "
              f"pad, {g.scost.shape[1]} fractions, {g.targets.numel()} "
              f"targets; e, q, q_feas {args_}: feasible "
              f"{got.feasible.tolist()}) bit-equal to planner_walk_plain "
              f"on the card ({secs:.3f} s)")
        return secs

    opts = pt.AdvisorOptions(backend="torch", device="cuda")
    # the greedy-step scorers' calls of phases 3 and 3b, held to the CPU
    # after 3b
    scorer_calls = ScorerCalls()
    # the run's batched card estimates, kept for phase 12b
    est3 = {}
    execute = pt.EstimationPlanner.execute

    def keeping(self, plan, engine):
        out = execute(self, plan, engine)
        est3.update(out)
        return out
    pt.EstimationPlanner.execute = keeping
    try:
        rec_t, wall_t, launches3 = walked(
            "phase 3", lambda: keeping_scorer_calls(
                lambda: pt.DesignAdvisor(wl, opts).recommend(budget),
                scorer_calls))
    finally:
        pt.EstimationPlanner.execute = execute
    need_launches("phase 3", launches3, ("ns_bytes", "ldict_bytes",
                                         "planner_walk"))
    check_walk("phase 3")
    print(f"phase 3: {FUSED_EXEMPT}")
    print(f"phase 3: {PROB_EXEMPT}")
    t0 = time.perf_counter()
    adv_n = pt.DesignAdvisor(wl, pt.AdvisorOptions(backend="numpy"))
    rec_n = adv_n.recommend(budget)
    wall_n = time.perf_counter() - t0
    print_rec("phase 3 torch/cuda", rec_t, wall_t)
    print_rec("phase 3 numpy", rec_n, wall_n)
    compare_recs("phase 3", rec_t, rec_n)
    judge_config("phase 3", rec_t, rec_n,
                 adv_n.build_engine().config_cost)

    # ---- phase 3b: large workload, five codecs, workload compression --
    enter_phase("3b")
    t0 = time.perf_counter()
    wl_big = pt.make_scaled_workload(schema, n_statements=N_SCALED,
                                     insert_fraction=0.1, seed=0)
    print(f"data 3b: {len(wl_big.statements)} statements "
          f"(make_scaled_workload, seed 0), methods {FIVE}, "
          f"compression_budget {COMPRESSION_BUDGET}, generated in "
          f"{time.perf_counter() - t0:.3f} s")
    opts5 = pt.AdvisorOptions(backend="torch", device="cuda", methods=FIVE,
                              compression_budget=COMPRESSION_BUDGET)
    rec_t5, wall_t5, launches3b = walked(
        "phase 3b", lambda: keeping_scorer_calls(
            lambda: pt.DesignAdvisor(wl_big, opts5).recommend(budget),
            scorer_calls))
    need_launches("phase 3b", launches3b,
                  [n for n in ADVISOR_KERNELS if n != "gdict_bytes"])
    # the plain walk scores each record with the fused_score kernel:
    # phase 4 times that kernel at the largest of them
    orig_fused = capture(ps, "fused_score", lambda mm, *rest: mm.numel())
    try:
        walk_plain_s = check_walk("phase 3b")
    finally:
        ps.fused_score = orig_fused
    print(f"phase 3b: {GDICT_EXEMPT}")
    t0 = time.perf_counter()
    adv_n5 = pt.DesignAdvisor(wl_big, pt.AdvisorOptions(
        backend="numpy", methods=FIVE, compression_budget=COMPRESSION_BUDGET))
    rec_n5 = adv_n5.recommend(budget)
    wall_n5 = time.perf_counter() - t0
    print_rec("phase 3b torch/cuda", rec_t5, wall_t5)
    print_rec("phase 3b numpy", rec_n5, wall_n5)
    compare_recs("phase 3b", rec_t5, rec_n5)
    if judge_config("phase 3b", rec_t5, rec_n5,
                    adv_n5.inner.build_engine().config_cost) and \
            not math.isclose(rec_t5.compression_error_bound,
                             rec_n5.compression_error_bound, rel_tol=1e-6):
        fail("phase 3b: equal configurations with different error bounds")
    chosen = sorted({i.compression for i in rec_t5.config.indexes} - {None})
    print(f"phase 3b: methods in the recommendation {chosen}")
    check_scorer_order("phases 3 and 3b", scorer_calls)
    del scorer_calls

    # ---- phase 3c: the staged baseline (Example 1) ---------------------
    enter_phase("3c")
    rec_st, wall_st, launches3c = walked(
        "phase 3c", lambda: pt.staged_recommend(
            wl, budget, methods=FIVE,
            options=pt.AdvisorOptions(backend="torch", device="cuda")))
    if launches3c["prefix_bytes"] + launches3c["rle_bytes"] <= 0:
        fail("neither prefix_bytes nor rle_bytes launched in phase 3c")
    need_launches("phase 3c", launches3c, ("planner_walk",))
    check_walk("phase 3c")
    t0 = time.perf_counter()
    staged_n = pt.staged_recommend(wl, budget, methods=FIVE,
                                   options=pt.AdvisorOptions(backend="numpy"))
    wall_stn = time.perf_counter() - t0
    for label, rec, wall in (("torch/cuda", rec_st, wall_st),
                             ("numpy", staged_n, wall_stn)):
        print(f"staged {label}: {wall:.3f} s; cost={rec.cost!r} "
              f"used_bytes={rec.used_bytes!r}; "
              f"{len(rec.config.indexes)} indexes")
    if not math.isclose(rec_st.cost, staged_n.cost, rel_tol=1e-6):
        fail(f"phase 3c: cost differs beyond rtol 1e-6: {rec_st.cost!r} vs "
             f"{staged_n.cost!r}")

    def staged_price(config):
        # the numpy pipeline's sizes for every compressed index of both
        # configurations, then its cost engine
        judge = pt.DesignAdvisor(wl, pt.AdvisorOptions(backend="numpy",
                                                       methods=FIVE))
        judge.estimate_sizes(list(rec_st.config.indexes)
                             + list(staged_n.config.indexes))
        return judge.build_engine().config_cost(config)
    judge_config("phase 3c", rec_st, staged_n, staged_price)

    # ---- phase 3d: the online session at SF1 ---------------------------
    enter_phase("3d")
    # each round of a session held to a fresh torch/cuda recommend on the
    # workload after it; only the session rounds count as 3d's launches
    launches3d = {k: 0 for k in launches3}
    session_walks = []

    def session_round(label, what, sess, wl_after, opts_, budget_,
                      check=None):
        st0 = sess.stats
        walk_graphs = []

        def recording(g, *a):
            walk_graphs.append(g)
            return walk(g, *a)
        ps.planner_walk = recording
        try:
            rec_s, wall_s, counts = measured(f"{label} session", lambda:
                                             sess.recommend(budget_))
        finally:
            ps.planner_walk = walk
        peak_s = torch.cuda.max_memory_allocated(dev)
        st1 = sess.stats
        rec_f, wall_f, counts_f = measured(
            f"{label} fresh", lambda: pt.DesignAdvisor(wl_after, opts_)
            .recommend(budget_))
        peak_f = torch.cuda.max_memory_allocated(dev)
        fields = ["config", "cost", "used_bytes", "base_cost", "n_sampled",
                  "n_deduced", "estimation_cost_pages", "pool_size",
                  "candidate_count"]
        if opts_.compression_budget is not None:
            fields.append("compression_error_bound")
        for name in fields:
            if getattr(rec_s, name) != getattr(rec_f, name):
                fail(f"{label}: the session's {name} "
                     f"{getattr(rec_s, name)!r} differs from a fresh "
                     f"recommend's {getattr(rec_f, name)!r}")

        def grew(key):
            return st1.get(key, 0) - st0.get(key, 0)
        # a compressed session's inner session may be new this round: its
        # counters start from zero
        rebuilt = grew("compression_rebuilds") > 0
        if rebuilt:
            st0 = {k: v for k, v in st0.items() if k.startswith("compr")}
        replanned = grew("replay_misses") > 0
        misses = grew("samplecf_cache_misses")
        if counts["planner_walk"] != int(replanned) or \
                counts["fused_score"] or counts["prob_within"]:
            fail(f"{label}: planner launches {counts} for a "
                 f"{'re-planned' if replanned else 'replayed'} plan")
        codec = sum(counts[n] for n in CODECS)
        if (codec > 0) != (misses > 0):
            fail(f"{label}: {codec} codec launches for {misses} SampleCF "
                 "cache misses")
        if check is not None:
            check(counts, st0, st1)
        for k in launches3d:
            launches3d[k] += counts[k]
        route = (ps.walk_in_shared_memory(walk_graphs[0]) if walk_graphs
                 else None)
        session_walks.extend(walk_graphs)
        print(f"{label} ({what}): session {wall_s:.3f} s, fresh "
              f"{wall_f:.3f} s; identical ({', '.join(fields)}); cost "
              f"{rec_s.cost!r}, plan f={rec_s.estimation_plan.f} sampled="
              f"{rec_s.n_sampled} deduced={rec_s.n_deduced}, "
              f"{len(rec_s.steps)} steps; session launches "
              f"{json.dumps(counts)}; fresh launches {json.dumps(counts_f)}; "
              f"samplecf hits +{grew('samplecf_cache_hits')} misses "
              f"+{misses}; replay hits +{grew('replay_hits')} misses "
              f"+{grew('replay_misses')}; universe "
              f"{st1.get('universe_nodes')} nodes; walk in shared memory "
              f"{route}; peak device memory session {peak_s} B, fresh "
              f"{peak_f} B")
        return rec_s, wall_s, st1

    def no_launch(label):
        def check(counts, st0, st1):
            if any(counts.values()):
                fail(f"{label}: a reweight-only round launched {counts}")
        return check

    # 3d-i: phase 3's workload and options, and the numpy backend beside
    names = [s.name for s in wl.statements]
    extra = [dataclasses.replace(s, name=f"sess_{s.name}") for s in
             pt.make_scaled_workload(schema, 8, seed=7).statements]
    deltas_i = [
        ("structural delta: 8 added, 2 removed, 2 reweighted",
         pt.WorkloadDelta(added=tuple(extra), removed=(names[1], names[3]),
                          reweighted=((names[0], 3.0), (names[2], 0.5)))),
        ("reweight-only delta",
         pt.WorkloadDelta(reweighted=((names[4], 2.0), (names[5], 0.25)))),
    ]
    opts_n = pt.AdvisorOptions(backend="numpy")
    sess = pt.AdvisorSession(wl, opts)
    sess_n = pt.AdvisorSession(wl, opts_n)
    wl_i = wl
    rounds = [("cold", None, None)] + [(w, d, None) for w, d in deltas_i] + \
        [("snapshot -> to_bytes -> from_bytes -> restore", None, "restore")]
    for i, (what, delta, step) in enumerate(rounds, 1):
        label = f"phase 3d-i round {i}"
        check = None
        if delta is not None:
            sess.apply(delta)
            sess_n.apply(delta)
            wl_i = wl_i.apply_delta(delta)
            if not delta.added and not delta.removed:
                check = no_launch(label)
        if step == "restore":
            blob = sess.snapshot().to_bytes()
            sess = pt.AdvisorSession.restore(
                pt.SessionSnapshot.from_bytes(blob))
            blob_n = sess_n.snapshot().to_bytes()
            sess_n = pt.AdvisorSession.restore(
                pt.SessionSnapshot.from_bytes(blob_n))
            what += f" ({len(blob)} B)"

            def check(counts, st0, st1, label=label):
                if counts["planner_walk"] != 1:
                    fail(f"{label}: a restored session must walk once")
        rec_s, _, _ = session_round(label, what, sess, wl_i, opts, budget,
                                    check)
        t0 = time.perf_counter()
        rec_sn = sess_n.recommend(budget)
        wall_sn = time.perf_counter() - t0
        print(f"{label} numpy session: {wall_sn:.3f} s; cost "
              f"{rec_sn.cost!r}, plan f={rec_sn.estimation_plan.f} sampled="
              f"{rec_sn.n_sampled} deduced={rec_sn.n_deduced}")
        compare_recs(label, rec_s, rec_sn)
        judge_config(label, rec_s, rec_sn, sess_n.engine.config_cost)

    # 3d-ii: 3b's statements and options (five codecs, compression)
    names = [s.name for s in wl_big.statements]
    added = [dataclasses.replace(s, name=f"sess_{s.name}") for s in
             pt.make_scaled_workload(schema, 200, seed=1).statements]
    rng = np.random.default_rng(0)
    weight = {s.name: s.weight for s in wl_big.statements}
    deltas_ii = [
        ("structural delta: 200 added, 100 removed, 50 reweighted",
         pt.WorkloadDelta(
             added=tuple(added), removed=tuple(names[0:10_000:100]),
             reweighted=tuple((n, float(w)) for n, w in zip(
                 names[50:10_000:200], rng.uniform(0.5, 2.0, 50))))),
        ("reweight-only delta: 50 weights scaled by 0.5-1.5",
         pt.WorkloadDelta(reweighted=tuple(
             (n, weight[n] * float(f)) for n, f in zip(
                 names[7:10_000:150][:50], rng.uniform(0.5, 1.5, 50))))),
    ]
    sess = pt.AdvisorSession(wl_big, opts5)
    wl_ii = wl_big
    for i, (what, delta) in enumerate([("cold", None)] + deltas_ii, 1):
        label = f"phase 3d-ii round {i}"
        if delta is not None:
            sess.apply(delta)
            wl_ii = wl_ii.apply_delta(delta)
        reweight_only = delta is not None and not delta.added and \
            not delta.removed

        def check(counts, st0, st1, label=label,
                  reweight_only=reweight_only):
            fast = st1["compression_reweights"] > st0["compression_reweights"]
            if reweight_only:
                print(f"{label}: served on the "
                      f"{'reweight fast path' if fast else 'rebuild path'} "
                      f"(compression_reweights {st1['compression_reweights']}"
                      f", compression_rebuilds "
                      f"{st1['compression_rebuilds']})")
            if fast and any(counts.values()):
                fail(f"{label}: the reweight fast path launched {counts}")
        session_round(label, what, sess, wl_ii, opts5, budget, check)
    del sess, sess_n
    gc.collect()
    torch.cuda.empty_cache()
    for name in ("ns_bytes", "ldict_bytes", "prefix_bytes", "rle_bytes",
                 "planner_walk"):
        if launches3d[name] <= 0:
            fail(f"kernel {name} was not launched in phase 3d")
    print(f"launches in phase 3d's session rounds: {json.dumps(launches3d)}")

    # ---- phase 3e: the fleet and its durable store at SF1 ---------------
    enter_phase("3e")
    # every tenant on phase 3's schema, options and budget (one share
    # group); only the fleet's drains count as 3e's launches
    from repro_torch.serve import advisor_service as fleet_mod
    launches3e = {k: 0 for k in launches3}
    fleet_fields = ("config", "cost", "used_bytes", "base_cost", "n_sampled",
                    "n_deduced", "estimation_cost_pages", "pool_size",
                    "candidate_count")
    fleet_counters = ("prefetch_batches", "prefetch_targets",
                      "prefetch_hits", "prefetch_failures",
                      "cost_prefetch_batches", "cost_prefetch_jobs",
                      "sampling_calls", "shared_cache_entries")

    def tenant_workload(i, n, seed):
        w = pt.make_scaled_workload(schema, n, seed=seed)
        return dataclasses.replace(w, statements=[
            dataclasses.replace(s, name=f"t{i}_{s.name}")
            for s in w.statements])

    def tenant_delta(rng_, i, rnd, w):
        """2 statements added, the 2 oldest removed, 3 reweighted by
        factors in 0.5-1.5."""
        names_ = [s.name for s in w.statements]
        weight_ = {s.name: s.weight for s in w.statements}
        added_ = tuple(
            dataclasses.replace(s, name=f"t{i}_r{rnd}_{j}")
            for j, s in enumerate(pt.make_scaled_workload(
                schema, 2, seed=1000 + 10 * rnd + i).statements))
        keep = names_[2:]
        picks = rng_.choice(len(keep), size=3, replace=False)
        factors = rng_.uniform(0.5, 1.5, size=3)
        return pt.WorkloadDelta(
            added=added_, removed=tuple(names_[:2]),
            reweighted=tuple((keep[k], weight_[keep[k]] * float(f))
                             for k, f in zip(picks, factors)))

    def fresh_identical(label, rec, w):
        """A fresh torch/cuda recommend on `w` gives `rec`'s fields;
        returns its seconds."""
        t0 = time.perf_counter()
        want = pt.DesignAdvisor(w, opts).recommend(budget)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for name in fleet_fields:
            if getattr(rec, name) != getattr(want, name):
                fail(f"{label}: the fleet's {name} {getattr(rec, name)!r} "
                     f"differs from a fresh recommend's "
                     f"{getattr(want, name)!r}")
        return secs

    def fleet_drain(label, fleet_, n_recommends):
        """Drain the fleet with the launch counters zeroed before and read
        after; checks the planner's launches; returns (wall s, launches)."""
        _, wall, counts = measured(label, fleet_.run_until_drained)
        if counts["fused_score"] or counts["prob_within"] or \
                counts["planner_walk"] > n_recommends:
            fail(f"{label}: planner launches {counts} for {n_recommends} "
                 "recommends")
        for k in launches3e:
            launches3e[k] += counts[k]
        return wall, counts

    def watch_prefetch_errors(fleet_):
        """Every error the fleet's two prefetches attach to a ticket, in
        order, once each (a ticket's `prefetch_error` keeps only the last;
        a caught prefetch error lets the tenant recompute on its own)."""
        errors = []
        for name in ("_prefetch", "_cost_prefetch"):
            def watched(orig=getattr(fleet_, name), name=name):
                orig()
                for req in fleet_.slots:
                    e = req.ticket.prefetch_error if req else None
                    if e is not None and all(e is not x for _, x in errors):
                        errors.append((name, e))
            setattr(fleet_, name, watched)
        return errors

    # 3e-i: 16 tenants, no store; a delta and a recommend a tenant a round
    t0 = time.perf_counter()
    fp = pt.samplecf.schema_fingerprint(schema, opts.sample_seed)
    print(f"phase 3e: schema_fingerprint at SF1 {time.perf_counter() - t0:.3f}"
          f" s (host; cached on the schema's tables, so once for the 16 "
          f"tenants that share it) {fp[:16]}")
    wl_3e = {f"t{i}": tenant_workload(i, 12, 100 + i) for i in range(16)}
    fleet = fleet_mod.AdvisorFleetService(fleet_mod.FleetConfig(slots=16))
    errors_3e = watch_prefetch_errors(fleet)
    t0 = time.perf_counter()
    for tid, w in wl_3e.items():
        fleet.register_tenant(tid, w, opts)
    print(f"phase 3e-i: 16 tenants registered in "
          f"{time.perf_counter() - t0:.3f} s, {fleet.stats['groups']} share "
          "group")
    # the share group's prefetch batches: targets, device memory allocated
    # before each, the peak just after it (is the union batch the round's
    # peak?)
    prefetches = []
    group_engine = next(iter(fleet.groups.values())).engine
    group_batch = group_engine.estimate_batch

    def watched_batch(targets, f):
        before = torch.cuda.memory_allocated(dev)
        got = group_batch(targets, f)
        torch.cuda.synchronize()
        prefetches.append((len(targets), before,
                           torch.cuda.max_memory_allocated(dev)))
        return got
    group_engine.estimate_batch = watched_batch
    # the first stacked cost batch, held bitwise to per-job costing: the
    # jobs' (engine, query, base, candidates) recorded as they are gathered
    job_sources = []
    stacked = {}
    parity_s = [0.0]
    orig_job_arrays = pt.CostEngine.cost_job_arrays
    orig_batched = fleet_mod.batched_candidate_costs

    def recording_job_arrays(self, query, base_, cands):
        job_sources.append((self, query, base_, list(cands)))
        return orig_job_arrays(self, query, base_, cands)

    def checking_batched(jobs, device=None):
        costs = orig_batched(jobs, device=device)
        sources_, job_sources[:] = list(job_sources), []
        if not stacked:
            t0 = time.perf_counter()
            if device is None or len(sources_) != len(jobs):
                fail(f"phase 3e-i: a stacked batch of {len(jobs)} jobs on "
                     f"{device} from {len(sources_)} recorded jobs")
            for k, (eng, q, base_, cands) in enumerate(sources_):
                want = eng.candidate_query_costs(q, base_, cands)
                got = np.ascontiguousarray(costs[k, :len(want)])
                if not np.array_equal(got.view(np.int64),
                                      want.view(np.int64)):
                    fail(f"phase 3e-i: stacked job {k} ({q.name}) differs "
                         "from its per-job candidate_query_costs on the "
                         "card")
            stacked.update(jobs=len(jobs), width=int(costs.shape[1]),
                           secs=time.perf_counter() - t0)
            parity_s[0] += stacked["secs"]
        return costs
    pt.CostEngine.cost_job_arrays = recording_job_arrays
    fleet_mod.batched_candidate_costs = checking_batched
    rng = np.random.default_rng(0)
    mirror = dict(wl_3e)
    try:
        for rnd in range(3):
            label = f"phase 3e-i round {rnd + 1}"
            tks = {}
            for i, tid in enumerate(mirror):
                d = tenant_delta(rng, i, rnd, mirror[tid])
                fleet.submit_delta(tid, d)
                mirror[tid] = mirror[tid].apply_delta(d)
                tks[tid] = fleet.submit_recommend(tid, budget)
            st0 = fleet.stats
            parity_s[0] = 0.0
            prefetches.clear()
            wall, counts = fleet_drain(label, fleet, len(tks))
            peak = torch.cuda.max_memory_allocated(dev)
            wall -= parity_s[0]
            st1 = fleet.stats
            fresh_s = sum(fresh_identical(f"{label} {tid}", tk.result(0),
                                          mirror[tid])
                          for tid, tk in tks.items())
            grew = {k: st1[k] - st0[k] for k in fleet_counters}
            # no fault is injected here: one union SampleCF batch and one
            # stacked cost batch a round, neither failing
            if grew["prefetch_failures"] or errors_3e or \
                    grew["prefetch_batches"] != 1 or \
                    grew["cost_prefetch_batches"] != 1:
                fail(f"{label}: prefetch counters {json.dumps(grew)}, "
                     f"errors {errors_3e!r}")
            print(f"{label}: fleet {wall:.3f} s (synchronised, the bitwise "
                  f"check excluded) for 16 deltas + 16 recommends in "
                  f"{st1['steps'] - st0['steps']} steps; 16 fresh recommends "
                  f"{fresh_s:.3f} s; all 16 identical "
                  f"({', '.join(fleet_fields)}); this round "
                  f"{json.dumps(grew)}; launches {json.dumps(counts)}; "
                  f"prefetch batches (targets, B allocated before, peak B "
                  f"after) {prefetches}, the round's peak {peak} B")
    finally:
        pt.CostEngine.cost_job_arrays = orig_job_arrays
        fleet_mod.batched_candidate_costs = orig_batched
    st = fleet.stats
    consumed = sum(t.session.cost_prefetch_consumed
                   for t in fleet.tenants.values())
    if not 0 < st["cost_prefetch_jobs"] == consumed:
        fail(f"phase 3e-i: cost_prefetch_jobs {st['cost_prefetch_jobs']}, "
             f"consumed by the tenants' recommends {consumed}")
    if st["prefetch_batches"] <= 0 or not stacked:
        fail("phase 3e-i: no prefetch batch or no stacked cost batch")
    print(f"phase 3e-i: stacked cost batch of {stacked['jobs']} jobs x "
          f"{stacked['width']} candidates bit-equal to per-job "
          f"candidate_query_costs on the card ({stacked['secs']:.3f} s); "
          f"cost_prefetch_jobs {st['cost_prefetch_jobs']} == consumed "
          f"{consumed}; fleet counters "
          f"{json.dumps({k: st[k] for k in fleet_counters})}")
    del fleet, tks
    gc.collect()
    torch.cuda.empty_cache()

    # 3e-ii: 4 tenants on a durable store under faults, then a restart
    import shutil
    import tempfile
    # the rates of the JAX package's benchmarks/fault_recovery.py; the
    # disk sites and the prefetch also fire at their second check
    faults = pt.FaultInjector(seed=14, specs={
        "apply_delta": 0.08, "estimation": 0.05, "costing": 0.05,
        "prefetch": pt.FaultSpec(rate=0.25, at=(1,)),
        "planner_replay": 0.05,
        "disk_write": pt.FaultSpec(rate=0.05, at=(1,)),
        "fsync": pt.FaultSpec(rate=0.05, at=(1,))})
    fc2 = fleet_mod.FleetConfig(slots=4, retry_backoff=(1, 2, 4),
                                quarantine_after=3)
    tids2 = [f"t{i}" for i in range(4)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_3e_") as tmp:
        tmp = Path(tmp)
        root = tmp / "store"
        print(f"phase 3e-ii: store under {tmp}, "
              f"{shutil.disk_usage(tmp).free} B free")
        store = pt.DurableStore(root, group_commit=1, compact_after=3)
        compactions = []
        orig_compact = store.maybe_compact

        def timed_compact(tid, *a, **kw):
            t0 = time.perf_counter()
            ran = orig_compact(tid, *a, **kw)
            if ran:
                compactions.append((tid, time.perf_counter() - t0))
            return ran
        store.maybe_compact = timed_compact
        fleet2 = fleet_mod.AdvisorFleetService(fc2, faults=faults,
                                               store=store)
        errors_3e2 = watch_prefetch_errors(fleet2)
        mirror2 = {tid: wl_3e[tid] for tid in tids2}
        for tid in tids2:
            t0 = time.perf_counter()
            fleet2.register_tenant(tid, mirror2[tid], opts)
            secs = time.perf_counter() - t0
            size = (root / "snap" / f"{tid}.snap").stat().st_size
            print(f"phase 3e-ii: register {tid} {secs:.3f} s, snapshot "
                  f"{size} B")
        peak_dir = dir_bytes(root)
        rng2 = np.random.default_rng(1)
        unresolved = 0
        for rnd in range(4):
            label = f"phase 3e-ii round {rnd + 1}"
            for tid, t in fleet2.tenants.items():
                if t.quarantined_at is not None:
                    fleet2.readmit_tenant(tid)
            dks, rks, deltas = {}, {}, {}
            for i, tid in enumerate(tids2):
                deltas[tid] = tenant_delta(rng2, i, rnd, mirror2[tid])
                dks[tid] = fleet2.submit_delta(tid, deltas[tid])
                rks[tid] = fleet2.submit_recommend(tid, budget)
            n_cp = len(compactions)
            wall, counts = fleet_drain(label, fleet2, len(rks))
            fresh_s, outcomes = 0.0, []
            for tid in tids2:
                if dks[tid].exception(0) is None:
                    mirror2[tid] = mirror2[tid].apply_delta(deltas[tid])
                err = rks[tid].exception(0)
                if err is None:
                    fresh_s += fresh_identical(f"{label} {tid}",
                                               rks[tid].result(0),
                                               mirror2[tid])
                    outcomes.append(f"{tid} identical")
                elif isinstance(err, (pt.FaultError,
                                      fleet_mod.TenantQuarantined)):
                    unresolved += 1
                    outcomes.append(f"{tid} {type(err).__name__}")
                else:
                    fail(f"{label}: {tid}'s recommend raised {err!r}")
            peak_dir = max(peak_dir, dir_bytes(root))
            s2 = fleet2.stats
            delta_out = [type(dks[t].exception(0)).__name__
                         if dks[t].exception(0) else "ok" for t in tids2]
            cps = [f"{t} {s:.3f} s" for t, s in compactions[n_cp:]]
            print(f"{label}: fleet {wall:.3f} s, fresh {fresh_s:.3f} s; "
                  f"{', '.join(outcomes)}; delta outcomes {delta_out}; "
                  f"retries {s2['retries']}, quarantines "
                  f"{s2['quarantines']}, failures {s2['failures']}; "
                  f"compactions {cps}; fault counters "
                  f"{json.dumps(faults.stats())}; launches "
                  f"{json.dumps(counts)}")
        fired = faults.stats()["fired"]
        for site in ("disk_write", "fsync", "prefetch"):
            if fired[site] <= 0:
                fail(f"phase 3e-ii: the {site} fault never fired")
        # a prefetch may fail here only by an injected fault
        stray = [(n, e) for n, e in errors_3e2
                 if not isinstance(e, pt.FaultError)]
        if stray:
            fail(f"phase 3e-ii: prefetch errors that are no injected "
                 f"fault: {stray!r}")
        if fleet2.stats["prefetch_failures"] != len(errors_3e2):
            fail(f"phase 3e-ii: {len(errors_3e2)} prefetch errors on tickets"
                 f", prefetch_failures {fleet2.stats['prefetch_failures']}")
        snaps = {tid: (root / "snap" / f"{tid}.snap").stat().st_size
                 for tid in tids2}
        print(f"phase 3e-ii: store counters {json.dumps(store.stats())}; "
              f"snapshot bytes {json.dumps(snaps)}; {unresolved} "
              "recommends unresolved (fault or quarantine); prefetch "
              f"failures {fleet2.stats['prefetch_failures']}, all injected "
              f"faults: {[(n, str(e)) for n, e in errors_3e2]}")
        # process death: close the store, drop the fleet, recover copies
        store.close()
        del fleet2, store, dks, rks
        gc.collect()
        torch.cuda.empty_cache()
        recover_s = {}
        orig_store_rec = pt.DurableStore._recover_tenant
        orig_fleet_rec = fleet_mod.AdvisorFleetService._recover_tenant

        def timed_store_rec(self, snap_path):
            t0 = time.perf_counter()
            rt = orig_store_rec(self, snap_path)
            recover_s[rt.tenant_id] = [time.perf_counter() - t0]
            return rt

        def timed_fleet_rec(self, rt):
            t0 = time.perf_counter()
            orig_fleet_rec(self, rt)
            recover_s[rt.tenant_id].append(time.perf_counter() - t0)
        pt.DurableStore._recover_tenant = timed_store_rec
        fleet_mod.AdvisorFleetService._recover_tenant = timed_fleet_rec
        try:
            for copy in ("A", "B"):
                label = f"phase 3e-ii copy {copy}"
                path = tmp / copy
                t0 = time.perf_counter()
                shutil.copytree(root, path)
                copy_s = time.perf_counter() - t0
                peak_dir = max(peak_dir, dir_bytes(root) + dir_bytes(path))
                victim = None
                if copy == "B":
                    bounds = {tid: pt.DurableStore(path)
                              .wal_record_boundaries(tid) for tid in tids2}
                    victim = next((tid for tid in ["t1"] + tids2
                                   if len(bounds[tid]) >= 3), None)
                    if victim is None:
                        n_rec = {t: len(b) - 1 for t, b in bounds.items()}
                        fail(f"{label}: no WAL holds two records {n_rec}")
                    wal = path / "wal" / f"{victim}.wal"
                    data = bytearray(wal.read_bytes())
                    hdr = pt.durability._HEADER.size
                    at = hdr + (bounds[victim][1] - hdr) // 2
                    data[at] ^= 1
                    wal.write_bytes(bytes(data))
                    print(f"{label}: flipped bit 0 of byte {at} (inside the "
                          f"payload of the first of {len(bounds[victim]) - 1}"
                          f" records) of {victim}'s WAL")
                recover_s.clear()
                t0 = time.perf_counter()
                fr = fleet_mod.AdvisorFleetService.recover(path, fc2)
                rec_wall = time.perf_counter() - t0
                peak_dir = max(peak_dir, dir_bytes(root) + dir_bytes(path))
                for tid in tids2:
                    t = fr.tenants[tid]
                    if tid == victim:
                        if t.quarantined_at is None or \
                                tid not in fr.recovery_errors:
                            fail(f"{label}: {tid} with a flipped bit "
                                 "recovered unquarantined")
                        continue
                    if t.quarantined_at is not None:
                        fail(f"{label}: {tid} recovered quarantined: "
                             f"{fr.recovery_errors.get(tid)!r}")
                    if [(s.name, s.weight) for s in
                            t.session.workload.statements] != \
                            [(s.name, s.weight) for s in
                             mirror2[tid].statements]:
                        fail(f"{label}: {tid}'s recovered statements differ "
                             "from its mirror's")
                if sorted(fr.recovery_errors) != ([victim] if victim else []):
                    fail(f"{label}: recovery errors "
                         f"{sorted(fr.recovery_errors)}")
                healthy = [tid for tid in tids2 if tid != victim]
                tks = {tid: fr.submit_recommend(tid, budget)
                       for tid in healthy}
                wall, counts = fleet_drain(label, fr, len(tks))
                fresh_s = sum(fresh_identical(f"{label} {tid}",
                                              tk.result(0), mirror2[tid])
                              for tid, tk in tks.items())
                per_tenant = {t: [round(x, 3) for x in v]
                              for t, v in recover_s.items()}
                print(f"{label}: copied in {copy_s:.3f} s; recover "
                      f"{rec_wall:.3f} s (per tenant, store scan / session "
                      f"restore and replay: {per_tenant}); quarantined "
                      f"{victim}; next recommends of {healthy} identical to "
                      f"fresh runs: fleet {wall:.3f} s, fresh "
                      f"{fresh_s:.3f} s; launches {json.dumps(counts)}")
                del fr, tks
                gc.collect()
                shutil.rmtree(path)
        finally:
            pt.DurableStore._recover_tenant = orig_store_rec
            fleet_mod.AdvisorFleetService._recover_tenant = orig_fleet_rec
        print(f"phase 3e-ii: the directory's peak {peak_dir} B (the store "
              "and one recovered copy)")
    for name in ("ns_bytes", "ldict_bytes", "planner_walk"):
        if launches3e[name] <= 0:
            fail(f"kernel {name} was not launched in phase 3e")
    if launches3e["fused_score"] or launches3e["prob_within"]:
        fail(f"phase 3e: planner launches {launches3e}")
    print(f"launches in phase 3e's fleet drains: {json.dumps(launches3e)}")

    # ---- phase 4: kernels at the main paths' inputs -------------------
    enter_phase("4")
    # the second run of each path is traced: LDICT's device time over its
    # launches beside the measured run's SampleCF seconds
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ldict_dev = {}
    for label, w, o, rec in (("phase 3", wl, opts, rec_t),
                             ("phase 3b", wl_big, opts5, rec_t5)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            again = captured_run(
                lambda: pt.DesignAdvisor(w, o).recommend(budget), label)
        if (again.cost, again.used_bytes, again.steps) != \
                (rec.cost, rec.used_bytes, rec.steps):
            fail(f"a second {label} torch/cuda recommend differs from the "
                 "first")
        spans = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and "ldict" in e.name]
        ldict_dev[label] = sum(spans) / 1e3
        print(f"phase 4: {label}: LDICT device time {ldict_dev[label]:.4f} ms "
              f"over {len(spans)} kernel runs (torch.profiler, the traced "
              f"second run; {len(ldict_inputs.get(label, {}))} distinct "
              f"inputs) beside SampleCF {rec.phase_seconds['samplecf']:.4f} s "
              f"of the measured run ({again.phase_seconds['samplecf']:.4f} s "
              "traced)")
    print(f"phase 4: LDICT device time over phases 3 and 3b "
          f"{sum(ldict_dev.values()):.4f} ms beside SampleCF "
          f"{rec_t.phase_seconds['samplecf'] + rec_t5.phase_seconds['samplecf']:.4f}"
          " s")
    sample = pt.SampleManager(schema.tables, seed=0).get_sample(
        "lineitem", 0.01)
    li_cols = torch.as_tensor(np.stack([sample.values[c.name]
                                        for c in sample.columns]),
                              device=dev)
    li_widths = t64([schema.tables["lineitem"].col_by_name[c.name].width
                     for c in sample.columns])
    captured["gdict_bytes"] = (li_cols.numel(), (li_cols, li_widths))
    # prob_within at the targets' final RVs of 3b's walk, as float32
    g, a, res = walks["phase 3b"]
    tg = g.targets.long()
    captured["prob_within"] = (res.p.numel(), (
        res.mean[tg].float().contiguous(), res.std[tg].float().contiguous(),
        a[0]))

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

    def device_ms(fn, reps):
        """ms of device time per call of fn: the launches are enqueued
        while the stream is kept busy (torch.cuda._sleep), so no host gap
        falls between the two events; the least of 3 runs."""
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
            runs.append(a.elapsed_time(b) / reps)
        return min(runs)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def sort_ops(m_rows, n, rpp):
        # per page: a comparison sort of `rows` keys needs at least
        # log2(rows!) comparisons, then rows - 1 adjacent compares
        pages = [rpp] * (n // rpp) + ([n % rpp] if n % rpp else [])
        return m_rows * sum(math.lgamma(r + 1) / math.log(2) + r
                            for r in pages)

    # operations each function needs on its inputs: NS ~6 integer ops per
    # value (significant bytes, two mins, 2s+1, the sum); GDICT ~8 (a hash:
    # xor, shift, multiply, shift; a probe's compare); LDICT a comparison
    # sort of each page and the adjacent compares;
    # PREFIX two compares per value (min and max); RLE one compare and one
    # add per value; one probability ~40 float ops (two erf polynomials,
    # divisions, the difference); the Goodman fold 6 float ops per
    # (candidate, child, fraction)
    def ops_of(name, args):
        if name == "ns_bytes":
            return 6 * args[0].numel()
        if name == "gdict_bytes":
            return 8 * args[0].numel()
        if name == "ldict_bytes":
            return sort_ops(args[0].shape[0], args[0].shape[1], args[2])
        if name in ("prefix_bytes", "rle_bytes"):
            return 2 * args[0].numel()
        if name == "prob_within":
            return 40 * args[0].numel()
        nc_, k_, nf_ = args[0].shape
        return nc_ * nf_ * (6 * k_ + 40 + 2)

    launches = {k: launches3[k] + launches3b[k] + launches3c[k]
                + launches3d[k] + launches3e[k] for k in launches3}
    print(f"launches on the measured paths (3 + 3b + 3c + 3d's sessions + "
          f"3e's fleet drains): {json.dumps(launches)}")
    print("advisor launches by phase: " + json.dumps({
        name: {"3": launches3[name], "3b": launches3b[name],
               "3c": launches3c[name], "3d": launches3d[name],
               "3e": launches3e[name]} for name in ADVISOR_KERNELS}))
    records = []
    codec_src = "src/repro_torch/kernels/csrc/codec_bytes.cu"
    planner_src = "src/repro_torch/kernels/csrc/planner_score.cu"
    sources = {"ns_bytes": (codec_src, "src/repro/kernels/codec_bytes.py:95"),
               "gdict_bytes": (codec_src,
                               "src/repro/kernels/codec_bytes.py:104"),
               "ldict_bytes": (codec_src,
                               "src/repro/kernels/codec_bytes.py:113"),
               "prefix_bytes": (codec_src,
                                "src/repro/kernels/codec_bytes.py:128"),
               "rle_bytes": (codec_src,
                             "src/repro/kernels/codec_bytes.py:149"),
               "prob_within": (planner_src,
                               "src/repro/kernels/planner_score.py:98"),
               "fused_score": (planner_src,
                               "src/repro/kernels/planner_score.py:138")}
    for name in sources:
        _, args = captured[name]
        mod = cb if name in CODECS else ps
        fn, plain = getattr(mod, name), getattr(mod, f"{name}_plain")
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        extra = ""
        if name in CODECS:
            if not torch.equal(got, want):
                fail(f"{name} != plain on the main path's inputs")
            err = float((got - want).abs().max())
            out_b = got.numel() * 8
            in_t = args[:2]
            if name not in ORD_IND:
                extra = f" rpp {args[2]}"
        elif name == "prob_within":
            err = float((got - want).abs().max())
            if err > P_ATOL:
                fail(f"prob_within differs from plain by {err} on the main "
                     "path's inputs")
            out_b = got.numel() * 4
            in_t = args[:2]
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
        reps = 20 if name in CODECS else 200
        ms = time_ms(lambda: fn(*args), reps)
        plain_ms = time_ms(lambda: plain(*args), max(5, reps // 10))
        dev_ms = None
        if name in DEVICE_TIMED:
            dev_ms = device_ms(lambda: fn(*args), reps)
            extra += f", device time {dev_ms:.4f} ms"
        if name == "gdict_bytes":
            plan = cb.gdict_plan(*shape, sms)
            extra += (f", {plan.route} layout ({plan.parts} blocks a row, "
                      f"scratch {plan.scratch_bytes} B)")
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
        if dev_ms is not None:
            records[-1].update(device_ms=dev_ms, shape=list(shape))
            if name in CODECS and name not in ORD_IND:
                records[-1]["rpp"] = int(args[2])
    # GDICT past the cluster's layout: tables in global memory, the
    # wrapper's scratch; values below 2^32 from seed 0
    r0 = np.random.default_rng(0)
    args = (t64(r0.integers(0, 1 << 32, size=GDICT_GLOBAL)),
            t64(r0.integers(1, 9, size=GDICT_GLOBAL[0])))
    plan = cb.gdict_plan(*GDICT_GLOBAL, sms)
    if plan.route != "global" or not torch.equal(
            cb.gdict_bytes(*args), cb.gdict_bytes_plain(*args)):
        fail(f"gdict_bytes at {GDICT_GLOBAL}: {plan.route} layout, or != "
             "plain")
    ms = time_ms(lambda: cb.gdict_bytes(*args), 20)
    dev_ms = device_ms(lambda: cb.gdict_bytes(*args), 20)
    bytes_ms = (nbytes(*args) + GDICT_GLOBAL[0] * 8) / HBM_BYTES_PER_S * 1e3
    print(f"kernel gdict_bytes: shape {GDICT_GLOBAL}, global layout "
          f"({plan.tables} tables of {1 << plan.log_slots} slots, scratch "
          f"{plan.scratch_bytes} B): {ms:.4f} ms per call, device time "
          f"{dev_ms:.4f} ms (bound {bytes_ms:.6g} ms by bytes)")
    next(r for r in records if r["name"] == "gdict_bytes")["global"] = {
        "shape": list(GDICT_GLOBAL), "ms": ms, "device_ms": dev_ms,
        "bound_ms": bytes_ms, "scratch_bytes": plan.scratch_bytes}
    # the timing launches above count too; the record keeps the measured
    # paths' counts (phases 3, 3b, 3c, 3d's session rounds and 3e's fleet
    # drains)
    rec_ld = next(r for r in records if r["name"] == "ldict_bytes")
    rec_ld["device_ms_by_phase"] = ldict_dev
    rec_ld["largest_by_phase"] = {}
    for label, inputs in ldict_inputs.items():
        (shape, rpp), args = max(inputs.items(),
                                 key=lambda kv: kv[1][0].numel())
        bytes_ms = (nbytes(*args[:2]) + shape[0] * 8) / HBM_BYTES_PER_S * 1e3
        ms = time_ms(lambda: cb.ldict_bytes(*args), 20)
        rec_ld["largest_by_phase"][label] = {
            "shape": list(shape), "rpp": rpp, "ms": ms, "bound_ms": bytes_ms}
        print(f"kernel ldict_bytes: largest input of {label}: shape {shape} "
              f"rpp {rpp}: {ms:.4f} ms per call (bound {bytes_ms:.6g} ms by "
              "bytes)")
    # the walk at 3b's graph: per call, device time, the plain walk's
    # seconds from phase 3b; bound by the bytes it must move or the fold and
    # probability work of the (record, fraction) pairs this run walked and
    # the targets' probabilities
    g, a, res = walks["phase 3b"]
    walk_ms = time_ms(lambda: ps.planner_walk(g, *a), 5)
    walk_dev = device_ms(lambda: ps.planner_walk(g, *a), 5)
    again = ps.planner_walk(g, *a)
    torch.cuda.synchronize()
    if not all(bit_equal(a, b) for a, b in zip(again, res)):
        fail("a second planner_walk on 3b's graph differs from the first")
    per_cand = 6 * g.nchild.cpu().numpy().astype(np.int64) + 42
    csum = np.concatenate([[0], np.cumsum(per_cand)])
    off = g.cand_off.cpu().numpy()
    active = (res.win != ps.WALK_SKIP).sum(dim=1).cpu().numpy()
    w_ops = float(((csum[off[1:]] - csum[off[:-1]]) * active).sum()) + \
        40 * res.p.numel()
    w_bytes = nbytes(g.tid, g.kind, g.cand_off, g.child, g.nchild, g.dm, g.vt,
                     g.mq, g.scost, g.samp_mean, g.samp_std, *res)
    bytes_ms = w_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = w_ops / OPS_PER_S * 1e3
    print(f"kernel planner_walk: 3b's graph ({g.tid.numel()} records, "
          f"{g.dm.numel()} candidates, {g.scost.shape[0]} nodes, "
          f"{g.scost.shape[1]} fractions; {int(active.sum())} (record, "
          f"fraction) walks): {walk_ms:.4f} ms per call, device time "
          f"{walk_dev:.4f} ms (plain {walk_plain_s * 1e3:.4f} ms, one run; "
          f"bound {max(bytes_ms, ops_ms):.6g} ms by "
          f"{'bytes' if bytes_ms >= ops_ms else 'operations'}; bytes "
          f"{bytes_ms:.6g} ms, operations {ops_ms:.6g} ms), launches "
          f"{launches['planner_walk']}, max_abs_err 0.0")
    records.append({"name": "planner_walk", "route": "cuda",
                    "source": planner_src,
                    "replaces": "src/repro/kernels/planner_score.py:138",
                    "launches": launches["planner_walk"], "max_abs_err": 0.0,
                    "ms": walk_ms, "device_ms": walk_dev,
                    "plain_ms": walk_plain_s * 1e3,
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms
                    else "operations", "library_ms": None,
                    "shape": [g.tid.numel(), g.dm.numel(),
                              g.scost.shape[0], g.scost.shape[1]]})
    # phase 4's inputs must not count in phase 5's peak device memory
    captured.clear()
    ldict_inputs.clear()
    walks.clear()
    del li_cols, args, got, want, inputs, g, res, again, tg

    # ---- phase 5: LM serving at TinyLlama-1.1B -------------------------
    enter_phase("5")
    from repro_torch.configs import get_config
    from repro_torch.design.advisor import plan_layout
    from repro_torch.models import layers as L, model as MD
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    torch.set_grad_enabled(False)        # serving: no autograd anywhere
    lm = get_config(LM_ARCH)
    for hbm in LM_BUDGETS:               # 5a: the layout advisor's plan
        plan = plan_layout(lm, "serve", batch=LM_SLOTS, seq=LM_MAX_LEN,
                           n_chips=1, hbm_budget_bytes=hbm)
        print(f"phase 5a: plan_layout({LM_ARCH}, 'serve', batch={LM_SLOTS},"
              f" seq={LM_MAX_LEN}, n_chips=1, hbm_budget_bytes={hbm:.3g}) "
              f"-> {plan.choices}, {plan.hbm_bytes!r} B, step "
              f"{plan.step_cost_s * 1e3:.6g} ms; log {plan.log}")
    if plan.choices["weights"] != "q8" or plan.hbm_bytes > LM_BUDGETS[-1]:
        fail(f"phase 5a: the plan at {LM_BUDGETS[-1]:.3g} B does not choose "
             f"q8 weights within the budget: {plan.choices}")
    print(f"phase 5a: kv_cache {plan.choices.get('kv_cache')!r} is printed, "
          "not executed: the engine stores its KV cache in bf16 or f32")

    held = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    params = MD.init_params(torch.Generator(dev).manual_seed(0), lm,
                            device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"phase 5b: {LM_ARCH}: {lm.n_layers} layers, d_model "
          f"{lm.d_model}, {lm.heads} heads / {lm.kv_heads} KV heads, d_ff "
          f"{lm.d_ff}, vocab {lm.vocab}: {n_params} float32 parameters made "
          f"on the card by init_params (seed 0) in "
          f"{time.perf_counter() - t0:.3f} s; device memory allocated "
          f"before them {held} B, after {torch.cuda.memory_allocated(dev)} B")
    r = np.random.default_rng(0)
    prompts = [r.integers(0, lm.vocab, int(r.integers(4, 33))).tolist()
               for _ in range(LM_REQUESTS)]

    def serve(p, c, uids, kv="bf16", device=dev):
        """One request submitted per engine step, then drained."""
        eng = ServeEngine(c, p, EngineConfig(
            batch_slots=LM_SLOTS, max_len=LM_MAX_LEN, kv_dtype=kv),
            device=device)
        for uid in uids:
            eng.submit(Request(uid=uid, prompt=list(prompts[uid]),
                               max_new_tokens=LM_NEW))
            eng.step()
        eng.run_until_drained()
        return eng

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    eng = serve(params, lm, range(LM_REQUESTS))
    torch.cuda.synchronize()
    wall5 = time.perf_counter() - t0
    peak5 = torch.cuda.max_memory_allocated(dev)
    if sorted(eng.finished) != list(range(LM_REQUESTS)) or any(
            len(q.out_tokens) != LM_NEW for q in eng.finished.values()):
        fail("phase 5b: not every request finished with its tokens")
    crowd = {u: q.out_tokens for u, q in eng.finished.items()}
    made = LM_REQUESTS * LM_NEW
    prefill = sum(len(p_) - 1 for p_ in prompts)
    print(f"phase 5b: ServeEngine(batch_slots={LM_SLOTS}, max_len="
          f"{LM_MAX_LEN}, kv bf16): {LM_REQUESTS} requests, prompts "
          f"{[len(p_) for p_ in prompts]} tokens, {LM_NEW} new each: "
          f"{eng.steps} engine steps and {prefill} prefill steps in "
          f"{wall5:.3f} s; {made / wall5:.2f} generated tokens/s "
          f"({(made + prefill) / wall5:.2f} tokens/s counting prefill); "
          f"peak device memory {peak5} B")
    alone = serve(params, lm, [0]).finished[0].out_tokens
    if alone != crowd[0]:
        fail(f"phase 5b: request 0 alone gives {alone}, with the others "
             f"admitted mid-flight {crowd[0]}")
    print(f"phase 5b: request 0 alone gives the same {LM_NEW} tokens as "
          "with the others admitted mid-flight")

    eng32 = ServeEngine(lm, params, EngineConfig(
        batch_slots=LM_SLOTS, max_len=LM_MAX_LEN, kv_dtype="f32"),
        device=dev)
    seen = []
    decode = eng32._decode

    def recording(p, st, t, a):
        logits, st = decode(p, st, t, a)
        seen.append(logits[0, 0].clone())
        return logits, st
    eng32._decode = recording
    eng32.submit(Request(uid=0, prompt=list(prompts[0]),
                         max_new_tokens=LM_NEW))
    eng32.run_until_drained()
    out32 = eng32.finished[0].out_tokens
    fed = prompts[0] + out32[:-1]
    full = MD.forward(params, lm, torch.tensor([fed], device=dev))[0]
    stepwise = torch.stack(seen)
    if stepwise.shape != full.shape:
        fail(f"phase 5b: {tuple(stepwise.shape)} engine logits against "
             f"forward's {tuple(full.shape)}")
    err_fwd = float((stepwise - full).abs().max())
    if err_fwd > LOGITS_ATOL:
        fail(f"phase 5b: engine logits differ from forward by {err_fwd} > "
             f"{LOGITS_ATOL}")
    print(f"phase 5b: kv f32: the engine's logits at all {len(fed)} steps "
          f"of request 0 agree with forward over the same tokens (max abs "
          f"err {err_fwd:.3g} <= {LOGITS_ATOL}; max |logit| "
          f"{float(full.abs().max()):.4g}); its tokens "
          f"{'equal' if out32 == crowd[0] else 'differ from'} the bf16-KV "
          "run's")

    lm2 = dataclasses.replace(lm, name=f"{LM_ARCH}-depth2", n_layers=2)
    p_card = MD.init_params(torch.Generator(dev).manual_seed(0), lm2,
                            device=dev)
    p_cpu = MD.init_params(torch.Generator().manual_seed(0), lm2,
                           device="cpu")
    p_cpu.load_state_dict(p_card.state_dict())
    got2 = {}
    for where, p_ in (("card", p_card), ("cpu", p_cpu)):
        t0 = time.perf_counter()
        e2 = serve(p_, lm2, range(LM_REQUESTS), kv="f32",
                   device=p_["embed"].device)
        got2[where] = ({u: q.out_tokens for u, q in e2.finished.items()},
                       time.perf_counter() - t0)
    if got2["card"][0] != got2["cpu"][0]:
        fail("phase 5b: at depth 2 the card's and the CPU's engines give "
             "different tokens")
    print(f"phase 5b: width {lm2.d_model}, depth 2, kv f32: the card's "
          f"engine ({got2['card'][1]:.3f} s) and the CPU's ({got2['cpu'][1]:.3f}"
          f" s) give the same tokens for all {LM_REQUESTS} requests")
    del p_card, p_cpu

    # 5c: the plan's q8 weights on every layer's real MLP inputs
    mlps = [lp["mlp"] for lp in params.layers]

    def mlp_inputs(run):
        got = [None] * len(mlps)
        hooks = [m.register_forward_pre_hook(
            lambda mod, args, i=i: got.__setitem__(i, args[0].clone()))
            for i, m in enumerate(mlps)]
        try:
            run()
        finally:
            for h in hooks:
                h.remove()
        return got

    eng_c = ServeEngine(lm, params, EngineConfig(
        batch_slots=LM_SLOTS, max_len=LM_MAX_LEN), device=dev)
    for uid in range(LM_SLOTS):
        eng_c.submit(Request(uid=uid, prompt=list(prompts[uid]),
                             max_new_tokens=LM_NEW))
    eng_c.step()              # admits (prefills) all four, decodes once
    x_dec = mlp_inputs(eng_c.step)       # one decode step, all active
    toks = torch.as_tensor(r.integers(0, lm.vocab, (4, 128)), device=dev)
    x_pre = mlp_inputs(lambda: MD.forward(params, lm, toks))
    for xs, want in ((x_dec, (LM_SLOTS, 1)), (x_pre, (4, 128))):
        if any(x is None or tuple(x.shape) != want + (lm.d_model,)
               for x in xs):
            fail("phase 5c: an MLP input was not captured")
    t0 = time.perf_counter()
    pq = [L.quantize_mlp(m) for m in mlps]
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    rel_worst = dev_worst = 0.0
    for label, xs in (("decode", x_dec), ("prefill", x_pre)):
        for i, x in enumerate(xs):
            got = L.mlp_quantized(pq[i], x, lm.mlp)
            plain = L.mlp_quantized(pq[i], x, lm.mlp, use_kernel=False)
            fl = L.mlp(mlps[i], x, lm.mlp)
            torch.cuda.synchronize()
            if not torch.allclose(got, plain, rtol=DMM_TOL, atol=DMM_TOL):
                fail(f"phase 5c: layer {i} {label}: mlp_quantized differs "
                     "from its plain version")
            rel = float((fl - got).abs().mean() / fl.abs().mean())
            if rel >= Q8_REL_ERR:
                fail(f"phase 5c: layer {i} {label}: q8 MLP mean relative "
                     f"error {rel} >= {Q8_REL_ERR}")
            rel_worst = max(rel_worst, rel)
            dev_worst = max(dev_worst, float((got - plain).abs().max()))
    launches5 = launch_counts()
    print(f"launches in phase 5: {json.dumps(launches5)}")
    if launches5["quantize_blockwise"] < 3 * lm.n_layers or \
            launches5["dequant_matmul"] < 6 * lm.n_layers:
        fail("phase 5: quantize_blockwise or dequant_matmul launched too "
             "few times")
    f32_b = sum(w.numel() * w.element_size() for m in mlps
                for _, w in m.items())
    q8_b = sum(t.numel() * t.element_size() for d in pq for w in d.values()
               for t in w.values())
    if q8_b >= Q8_BYTES_RATIO * f32_b:
        fail(f"phase 5c: q8 MLP bytes {q8_b} >= {Q8_BYTES_RATIO} of f32 "
             f"{f32_b}")
    print(f"phase 5c: quantize_mlp on {len(mlps)} MLPs in {t_quant:.3f} s; "
          f"mlp_quantized within rtol/atol {DMM_TOL} of plain (max abs err "
          f"{dev_worst:.3g}) and within {Q8_REL_ERR} of the float MLP (worst "
          f"mean relative error {rel_worst:.4f}) at M = {LM_SLOTS} and "
          f"M = 512 on all layers; q8 MLP bytes {q8_b} = "
          f"{q8_b / f32_b:.4f} of float32 {f32_b}")

    def cycle_ms(fn, args_list, reps=5):
        """ms per call of fn over args cycling through all layers (each
        layer's weights are cold in L2, as on the main path)."""
        return time_ms(lambda: [fn(*a) for a in args_list], reps) / \
            len(args_list)

    for label, xs in (("M=4", x_dec), ("M=512", x_pre)):
        args = [(pq[i], xs[i], lm.mlp) for i in range(len(mlps))]
        q_ms = cycle_ms(L.mlp_quantized, args)
        f_ms = cycle_ms(L.mlp, [(mlps[i], xs[i], lm.mlp)
                                for i in range(len(mlps))])
        print(f"phase 5c: {label}: mlp_quantized {q_ms:.4f} ms per layer "
              f"beside the float32 mlp {f_ms:.4f} ms")

    # ---- phase 4b: the LM kernels at phase 5's shapes -----------------
    enter_phase("4b")
    wi_t = [m["wi"].t().contiguous() for m in mlps]     # (5632, 2048)
    wo_t = [m["wo"].t().contiguous() for m in mlps]     # (2048, 5632)
    for name, ws in (("wi", wi_t), ("wo", wo_t)):
        t_ms = cycle_ms(lambda w: w.t().contiguous(),
                        [(m[name],) for m in mlps])
        print(f"phase 4b: quantize_mlp's transpose copy of {name} "
              f"{tuple(mlps[0][name].shape)}: {t_ms:.4f} ms per weight "
              "(apart from the kernel)")
    q_cases = []
    for ws in (wi_t, wo_t):
        q_got, s_got = qb.quantize_blockwise(ws[0])
        q_pl, s_pl = qb.quantize_blockwise_plain(ws[0])
        torch.cuda.synchronize()
        if not (torch.equal(q_got, q_pl) and torch.equal(s_got, s_pl)):
            fail("quantize_blockwise != plain on phase 5's weights")
        rows, n = ws[0].shape
        b_ms = (rows * n * 5 + rows * -(-n // 128) * 4) / HBM_BYTES_PER_S * 1e3
        o_ms = 6 * rows * n / OPS_PER_S * 1e3
        q_cases.append({
            "shape": [rows, n],
            "ms": cycle_ms(qb.quantize_blockwise, [(w,) for w in ws]),
            "device_ms": device_ms(lambda: [qb.quantize_blockwise(w)
                                            for w in ws], 3) / len(ws),
            "plain_ms": cycle_ms(qb.quantize_blockwise_plain,
                                 [(w,) for w in ws], reps=2),
            "bound_ms": max(b_ms, o_ms), "bytes_ms": b_ms, "ops_ms": o_ms,
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "max_abs_err": float((q_got.int() - q_pl.int()).abs().max())})
    d_cases = []
    for xs, label in ((x_dec, "decode"), (x_pre, "prefill")):
        for wname in ("wi", "wo"):
            args = []
            for i in range(len(mlps)):
                a = xs[i].reshape(-1, lm.d_model)
                if wname == "wo":   # the input the wo product receives
                    a = torch.nn.functional.silu(dqm.dequant_matmul_plain(
                        a, pq[i]["wg"]["q"], pq[i]["wg"]["s"])) * \
                        dqm.dequant_matmul_plain(a, pq[i]["wi"]["q"],
                                                pq[i]["wi"]["s"])
                args.append((a, pq[i][wname]["q"], pq[i][wname]["s"]))
            a0, q0, s0 = args[0]
            got = dqm.dequant_matmul(*args[0])
            want = dqm.dequant_matmul_plain(*args[0])
            torch.cuda.synchronize()
            if not torch.allclose(got, want, rtol=DMM_TOL, atol=DMM_TOL):
                fail("dequant_matmul differs from plain on phase 5's inputs")
            (m_, k_), n_ = a0.shape, q0.shape[1]
            b_ms = (m_ * k_ * 4 + k_ * n_ + (k_ // 128) * n_ * 4
                    + m_ * n_ * 4) / HBM_BYTES_PER_S * 1e3
            o_ms = (2 * m_ * k_ * n_ + k_ * n_) / OPS_PER_S * 1e3
            # the tensor-core figure: 2 M K N per bf16 pass at 989 TFLOP/s,
            # times the prefill kernel's passes (a in hi + lo).  Each
            # kernel's bound takes the rate of the arithmetic it runs: the
            # decode kernel's float32 FMAs on the CUDA cores, the prefill
            # kernel's bf16 products on the tensor cores
            tc_o_ms = 2 * m_ * k_ * n_ * PREFILL_PASSES / TC_PEAK * 1e3
            kern = "decode" if m_ <= dqm._decode_max_m else "prefill"
            own_o_ms = o_ms if kern == "decode" else tc_o_ms
            dq = [(a, (q.float().reshape(-1, 128, q.shape[1])
                       * s[:, None, :]).reshape(q.shape)) for a, q, s in args]
            d_cases.append({
                "shape": [m_, k_, n_], "path": label, "kernel": kern,
                "ms": cycle_ms(dqm.dequant_matmul, args),
                "device_ms": device_ms(lambda: [dqm.dequant_matmul(*x)
                                                for x in args], 3) / len(args),
                "plain_ms": cycle_ms(dqm.dequant_matmul_plain, args),
                "float_matmul_ms": cycle_ms(torch.matmul, dq),
                "float_matmul_device_ms": device_ms(
                    lambda: [torch.matmul(*x) for x in dq], 3) / len(dq),
                "bound_ms": max(b_ms, own_o_ms), "bytes_ms": b_ms,
                "ops_ms": own_o_ms,
                "bound_by": "bytes" if b_ms >= own_o_ms else "operations",
                "f32_bound_ms": max(b_ms, o_ms),
                "tc_bound_ms": max(b_ms, tc_o_ms),
                "max_abs_err": float((got - want).abs().max())})
            del dq
    for name, cases, head, src, tpu in (
            ("quantize_blockwise", q_cases, 0,
             "src/repro_torch/kernels/csrc/quantize_blockwise.cu",
             "src/repro/kernels/quantize_blockwise.py:27"),
            ("dequant_matmul", d_cases, 2,
             "src/repro_torch/kernels/csrc/dequant_matmul.cu",
             "src/repro/kernels/dequant_matmul.py:29")):
        for c in cases:
            yard = (f", float32 torch.matmul on the dequantized weight (the "
                    f"float path q8 replaces) {c['float_matmul_ms']:.4f} ms "
                    f"(device {c['float_matmul_device_ms']:.4f}); "
                    f"{c['kernel']} kernel; float32 bound "
                    f"{c['f32_bound_ms']:.6g} ms, tensor-core bound "
                    f"{c['tc_bound_ms']:.6g} ms ({PREFILL_PASSES} bf16 "
                    f"passes); the bound above is the "
                    f"{'float32' if c['kernel'] == 'decode' else 'tensor-core'}"
                    f" one, the arithmetic this kernel runs"
                    if "float_matmul_ms" in c else "")
            print(f"kernel {name}: shape {tuple(c['shape'])}"
                  f"{' ' + c['path'] if 'path' in c else ''}: "
                  f"{c['ms']:.4f} ms per call, device time "
                  f"{c['device_ms']:.4f} ms (plain {c['plain_ms']:.4f} ms, "
                  f"bound {c['bound_ms']:.6g} ms by {c['bound_by']}; bytes "
                  f"{c['bytes_ms']:.6g} ms, operations {c['ops_ms']:.6g} ms"
                  f"{yard}), "
                  f"launches {launches5[name]}, max_abs_err "
                  f"{c['max_abs_err']}")
        h = cases[head]
        records.append({"name": name, "route": "cuda", "source": src,
                        "replaces": tpu, "launches": launches5[name],
                        "max_abs_err": max(c["max_abs_err"] for c in cases),
                        "ms": h["ms"], "device_ms": h["device_ms"],
                        "plain_ms": h["plain_ms"],
                        "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
                        "library_ms": h.get("float_matmul_ms"),
                        "shape": h["shape"], "cases": cases})

    # ---- phase 6: LM training at TinyLlama-1.1B -------------------------
    enter_phase("6")
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import step as train_step
    from repro_torch.train.loop import TrainConfig, Trainer

    # phase 5's model, engines, captures and q8 weights must not count in
    # phase 6's peak device memory
    del (params, eng, eng32, decode, recording, seen, full, stepwise, e2,
         mlps, eng_c, x_dec, toks, x_pre, pq, x, xs, got, plain, fl, want,
         args, a, a0, q0, s0, wi_t, wo_t, ws, q_got, s_got, q_pl, s_pl)
    gc.collect()
    torch.cuda.empty_cache()
    torch.set_grad_enabled(True)         # training: autograd again
    print(f"phase 6: device memory still allocated from earlier phases "
          f"{torch.cuda.memory_allocated(dev)} B")
    n_lm = lm.param_count()
    flops6 = 6.0 * n_lm * TRAIN_BATCH * TRAIN_SEQ
    for hbm in TRAIN_BUDGETS:            # 6a: the layout advisor's plan
        tplan = plan_layout(lm, "train", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                            n_chips=1, hbm_budget_bytes=hbm,
                            base_flops_per_chip=flops6)
        print(f"phase 6a: plan_layout({LM_ARCH}, 'train', batch="
              f"{TRAIN_BATCH}, seq={TRAIN_SEQ}, n_chips=1, hbm_budget_bytes="
              f"{hbm:.3g}, base_flops_per_chip={flops6:.6g}) -> "
              f"{tplan.choices}, {tplan.hbm_bytes!r} B, step "
              f"{tplan.step_cost_s * 1e3:.6g} ms")
        if tplan.choices.get("grad_wire") != "q8":
            fail(f"phase 6a: the plan at {hbm:.3g} B does not put the "
                 f"gradients on the q8 wire: {tplan.choices}")
    if tplan.choices.get("adam_m") != "q8":
        fail(f"phase 6a: the plan at {TRAIN_BUDGETS[-1]:.3g} B does not "
             f"compress the Adam moments: {tplan.choices}")

    def train(label, hbm, steps):
        """Trainer(TinyLlama-1.1B) for `steps` steps on the card, the
        launch counters zeroed just before and read just after."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        trainer = Trainer(lm, TrainConfig(
            steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
            hbm_budget_bytes=hbm, seed=0, log_every=1), device=dev)
        trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        train_report(label, trainer, counts,
                     torch.cuda.max_memory_allocated(dev))
        secs = [h["seconds"] for h in trainer.history]
        step_s = sum(secs[1:]) / len(secs[1:])
        names = [n for n, _ in trainer.params.named_parameters()]
        print(f"phase {label}: {steps} steps in {wall:.3f} s (with init); "
              f"6*N*tokens / (step s * {BF16_PEAK:.4g}) = "
              f"{flops6 / (step_s * BF16_PEAK):.4f} of the bf16 peak "
              f"(N = {n_lm}); the q8 wire's buckets hold at most "
              f"{train_step.WIRE_BUCKET_BYTES} q8 bytes"
              + (f"; m and sqrt v of each of {len(names)} parameters as one "
                 "group" if trainer.opt_cfg.state_codec == "q8" else ""))
        print(f"launches in phase {label}: {json.dumps(counts)}")
        return trainer, counts, names

    # 6b: 80 GB, float32 moments, the q8 wire
    trainer, launches6b, names6 = train("6b", TRAIN_BUDGETS[0],
                                        TRAIN_STEPS[0])
    if trainer.opt_cfg.state_codec != "f32":
        fail("phase 6b: the plan at 80 GB compresses the moments")
    trace_step("6b", trainer)
    # the gradients the trainer's next step puts on the q8 wire, from the
    # step's own loss-and-gradient function (bf16 compute copy, remat,
    # chunked attention), for 6d and 4c
    _, grads6 = train_step.make_loss_and_grads(lm, remat=True)(
        trainer.params, batch_at(trainer.data_cfg, trainer.step, dev))
    mom_b = {"f32": sum(nbytes(*m.values())
                        for m in trainer.opt_state["moments"].values())}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    if list(grads6) != names6:
        fail(f"phase 6b: {len(grads6)} gradients, not one for each of the "
             f"{len(names6)} parameters")

    # 6c: 10 GB, q8 moments
    trainer, launches6c, _ = train("6c", TRAIN_BUDGETS[1], TRAIN_STEPS[1])
    moments6 = trainer.opt_state["moments"]
    if trainer.opt_cfg.state_codec != "q8" or any(
            m[k].dtype != torch.int8 for m in moments6.values()
            for k in ("m_q", "v_q")):
        fail("phase 6c: the moments are not int8")
    mom_b["q8"] = sum(nbytes(*m.values()) for m in moments6.values())
    print(f"phase 6c: moment bytes {mom_b['q8']} (q8, int8 + float32 scales) "
          f"against {mom_b['f32']} (float32, 6b): "
          f"{mom_b['q8'] / mom_b['f32']:.4f}")
    del trainer

    # 6d: both kernels on the real gradients and moments, bit-equal to plain
    wire6 = q8_on_gradients("phase 6d", grads6)
    n6d = len(wire6)
    # 6c's moments: single calls, then each parameter's (m, sqrt v) pair
    # as one group each way, as AdamW runs them
    for name, m in moments6.items():
        pair = []
        for k in ("m", "v"):
            got_d = qb.dequantize_blockwise(m[f"{k}_q"], m[f"{k}_s"])
            if not bit_equal(got_d, qb.dequantize_blockwise_plain(
                    m[f"{k}_q"], m[f"{k}_s"])):
                fail(f"phase 6d: dequantize_blockwise != plain on {k} of "
                     f"{name}")
            q_, s_ = qb.quantize_blockwise(got_d)
            q_p, s_p = qb.quantize_blockwise_plain(got_d)
            if not (bit_equal(q_, q_p) and bit_equal(s_, s_p)):
                fail(f"phase 6d: quantize_blockwise != plain on {k} of "
                     f"{name}")
            pair.append((got_d, q_p, s_p))
            n6d += 1
        outs = [torch.empty_like(d) for d, _, _ in pair]
        qb.dequantize_blockwise_group([(m["m_q"], m["m_s"], outs[0]),
                                       (m["v_q"], m["v_s"], outs[1])])
        items = [(d, torch.empty_like(q_p), torch.empty_like(s_p))
                 for d, q_p, s_p in pair]
        qb.quantize_blockwise_group(items)
        for (d, q_p, s_p), out, (_, q_, s_) in zip(pair, outs, items):
            if not (bit_equal(out, d) and bit_equal(q_, q_p)
                    and bit_equal(s_, s_p)):
                fail(f"phase 6d: a grouped kernel != plain on the moment "
                     f"pair of {name}")
    del (moments6, got_d, q_, s_, q_p, s_p, grads6, items, out, outs, pair,
         d)
    print(f"phase 6d: quantize_blockwise and dequantize_blockwise bit-equal "
          f"to plain on {n6d} real tensors (6b's next step's gradients, "
          f"6c's q8 m and sqrt v); quantize_blockwise_group and "
          f"dequantize_blockwise_group bit-equal on each parameter's moment "
          f"pair")

    # 6e: the card against the CPU at width 2048, depth 2, float32 compute
    lm6e = dataclasses.replace(lm, name=f"{LM_ARCH}-depth2", n_layers=2)
    p_card = MD.init_params(torch.Generator(dev).manual_seed(0), lm6e,
                            device=dev)
    train_card_vs_cpu(
        "phase 6e", f"{lm6e.name} (two attention chunks each way)", lm6e,
        p_card, family_step(lm6e), family_batches(lm6e, 1, TRAIN_SEQ, 2),
        dev)
    del p_card

    # ---- phase 4c: the dequantize kernel at phase 6's shapes ------------
    enter_phase("4c")
    # (and quantize at the same shapes: most of its launches are here):
    # every distinct shape on the q8 wire, cycling through its tensors
    by_shape = {}
    for name, (q_, s_) in wire6.items():
        by_shape.setdefault(tuple(q_.shape), []).append((name, q_, s_))

    def one_call(q_, s_):
        """The one PyTorch call that dequantizes q_, a broadcast multiply,
        where there is one (a last dimension of whole blocks, or of one)."""
        if q_.shape[-1] % qb.DEFAULT_BLOCK == 0:
            return q_.view(*q_.shape[:-1], s_.shape[-1],
                           qb.DEFAULT_BLOCK) * s_[..., None]
        return q_ * s_ if s_.shape[-1] == 1 else None

    dq_cases, q6_cases = [], []
    for shape, entries in sorted(by_shape.items(),
                                 key=lambda kv: -math.prod(kv[0])):
        label = entries[0][0].replace("layers.0.", "") + " gradient"
        args = [(q_, s_) for _, q_, s_ in entries]
        q0, s0 = args[0]
        got = qb.dequantize_blockwise(q0, s0)
        want = qb.dequantize_blockwise_plain(q0, s0)
        if not bit_equal(got, want):
            fail(f"dequantize_blockwise != plain on the {label}")
        lib = one_call(q0, s0)
        if lib is not None and not bit_equal(lib.reshape(want.shape), want):
            fail(f"the broadcast multiply != plain on the {label}")
        numel, nb_ = q0.numel(), s0.shape[-1]
        b_ms = (numel * 5 + s0.numel() * 4) / HBM_BYTES_PER_S * 1e3
        o_ms = numel / OPS_PER_S * 1e3
        dq_cases.append({
            "shape": list(q0.shape), "path": label, "tensors": len(args),
            "ms": cycle_ms(qb.dequantize_blockwise, args),
            "device_ms": device_ms(lambda: [qb.dequantize_blockwise(*a)
                                            for a in args], 3) / len(args),
            "plain_ms": cycle_ms(qb.dequantize_blockwise_plain, args,
                                 reps=2),
            "library_ms": None if lib is None else cycle_ms(one_call, args),
            "bound_ms": max(b_ms, o_ms), "bytes_ms": b_ms, "ops_ms": o_ms,
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "max_abs_err": float((got - want).abs().max())})
        # quantize on the wire's float32 input of the same shapes
        xs6 = [(qb.dequantize_blockwise(q_, s_),) for q_, s_ in args]
        q_got, s_got = qb.quantize_blockwise(*xs6[0])
        q_pl, s_pl = qb.quantize_blockwise_plain(*xs6[0])
        if not (bit_equal(q_got, q_pl) and bit_equal(s_got, s_pl)):
            fail(f"quantize_blockwise != plain on the {label}'s wire "
                 f"tensor")
        qb_ms = (numel * 5 + s0.numel() * 4) / HBM_BYTES_PER_S * 1e3
        qo_ms = 6 * numel / OPS_PER_S * 1e3
        q6_cases.append({
            "shape": list(q0.shape), "path": f"training: {label}",
            "tensors": len(args),
            "ms": cycle_ms(qb.quantize_blockwise, xs6),
            "device_ms": device_ms(lambda: [qb.quantize_blockwise(*a)
                                            for a in xs6], 3) / len(xs6),
            "plain_ms": cycle_ms(qb.quantize_blockwise_plain, xs6, reps=2),
            "bound_ms": max(qb_ms, qo_ms), "bytes_ms": qb_ms,
            "ops_ms": qo_ms,
            "bound_by": "bytes" if qb_ms >= qo_ms else "operations",
            "max_abs_err": float((q_got.int() - q_pl.int()).abs().max())})
    del args, q0, s0, got, want, lib, xs6, q_got, s_got, q_pl, s_pl

    # the grouped launch over every tensor on the wire: its time per call
    # (CUDA events) and its kernel's device time (torch.profiler) beside
    # the summed bytes bound, the single calls and the one-call multiplies
    wire_all = list(wire6.values())
    items = [(q_, s_, torch.empty(q_.shape, device=dev))
             for q_, s_ in wire_all]
    before = launch_counts()["dequantize_blockwise"]
    qb.dequantize_blockwise_group(items)
    g_launches = launch_counts()["dequantize_blockwise"] - before
    for q_, s_, out in items:
        if not bit_equal(out, qb.dequantize_blockwise_plain(q_, s_)):
            fail(f"dequantize_blockwise_group != plain on a "
                 f"{tuple(q_.shape)} gradient")
    g_bound = sum(q_.numel() * 5 + s_.numel() * 4
                  for q_, s_ in wire_all) / HBM_BYTES_PER_S * 1e3
    g_ms = time_ms(lambda: qb.dequantize_blockwise_group(items), 5)
    g_dev = device_ms(lambda: qb.dequantize_blockwise_group(items), 5)
    g_singles = time_ms(lambda: [qb.dequantize_blockwise(q_, s_)
                                 for q_, s_ in wire_all], 3)
    g_mults = time_ms(lambda: [one_call(q_, s_) for q_, s_ in wire_all], 3)
    group = {"tensors": len(items), "launches": g_launches, "ms": g_ms,
             "device_ms": g_dev, "bound_ms": g_bound,
             "single_calls_ms": g_singles, "one_call_multiplies_ms": g_mults}
    print(f"kernel dequantize_blockwise_group: all {len(items)} wire tensors "
          f"in {g_launches} launch(es): {g_ms:.4f} ms per call (CUDA events), "
          f"device time {g_dev:.4f} ms (CUDA events, launches enqueued "
          f"behind a busy stream), bytes bound {g_bound:.6g} ms "
          f"({g_bound / g_dev:.4f} of it in device time); "
          f"{len(items)} single calls {g_singles:.4f} ms, {len(items)} "
          f"one-call broadcast multiplies {g_mults:.4f} ms")
    del items, out

    # the wire's whole step of quantize: one grouped launch per bucket
    # over the float32 inputs of all its tensors (6b's wire values), beside
    # the summed bytes bound and the same tensors in single calls
    wire_x = [qb.dequantize_blockwise(q_, s_) for q_, s_ in wire_all
              if train_step.on_wire(q_)]
    q_buckets = [[(wire_x[i], torch.empty(wire_x[i].shape, dtype=torch.int8,
                                          device=dev),
                   torch.empty((*wire_x[i].shape[:-1],
                                -(-wire_x[i].shape[-1] // qb.DEFAULT_BLOCK)),
                               device=dev)) for i in b]
                 for b in train_step.wire_buckets(wire_x)]

    def wire_quantize():
        for b in q_buckets:
            qb.quantize_blockwise_group(b)

    before = launch_counts()["quantize_blockwise"]
    wire_quantize()
    qw_launches = launch_counts()["quantize_blockwise"] - before
    for b in q_buckets:
        for x_, q_, s_ in b:
            q_p, s_p = qb.quantize_blockwise_plain(x_)
            if not (bit_equal(q_, q_p) and bit_equal(s_, s_p)):
                fail(f"quantize_blockwise_group != plain on a "
                     f"{tuple(x_.shape)} wire tensor")
    qw_bound = sum(x_.numel() * 5 + s_.numel() * 4 for b in q_buckets
                   for x_, _, s_ in b) / HBM_BYTES_PER_S * 1e3
    qw_ms = time_ms(wire_quantize, 3)
    qw_dev = device_ms(wire_quantize, 3)
    qw_singles = device_ms(lambda: [qb.quantize_blockwise(x_)
                                    for x_ in wire_x], 3)
    wire_q = {"tensors": len(wire_x), "buckets": len(q_buckets),
              "launches": qw_launches, "ms": qw_ms, "device_ms": qw_dev,
              "bound_ms": qw_bound, "single_calls_device_ms": qw_singles}
    print(f"kernel quantize_blockwise_group: the wire's step, {len(wire_x)} "
          f"tensors in {len(q_buckets)} buckets, {qw_launches} launches: "
          f"{qw_ms:.4f} ms per step (CUDA events), device time "
          f"{qw_dev:.4f} ms, bytes bound {qw_bound:.6g} ms "
          f"({qw_bound / qw_dev:.4f} of it in device time); the same "
          f"{len(wire_x)} tensors in single calls {qw_singles:.4f} ms of "
          f"device time")
    del wire_x, q_buckets, q_p, s_p, x_, q_, s_, b

    # where a single call's host microseconds go, at the (d_model,) norm
    # gradient: each part alone, enqueued 2,000 times (the raw launches
    # here are timing, not a wrapper's work, and count nowhere)
    _, qn, sn = by_shape[(lm.d_model,)][0]
    out_n = torch.empty(qn.shape, device=dev)
    launch = qb._load().dequantize_blockwise_launch
    st = qb._stream(qn.get_device())
    ptrs = (qn.data_ptr(), sn.data_ptr(), out_n.data_ptr(), 1,
            qn.shape[-1], qb.DEFAULT_BLOCK, 0, st)

    def host_us(fn, n=2000):
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        took = time.perf_counter() - t0
        torch.cuda.synchronize()
        return took / n * 1e6

    host = {
        "whole call": host_us(lambda: qb.dequantize_blockwise(qn, sn)),
        "checks": host_us(lambda: qb._check_dequantize(
            qn, sn, qb.DEFAULT_BLOCK, torch.float32)),
        "torch.empty": host_us(lambda: torch.empty(qn.shape, device=dev)),
        "is_contiguous x2": host_us(lambda: (qn.is_contiguous(),
                                             sn.is_contiguous())),
        "stream handle": host_us(lambda: qb._stream(qn.get_device())),
        "data_ptr x3": host_us(lambda: (qn.data_ptr(), sn.data_ptr(),
                                        out_n.data_ptr())),
        "ctypes call and launch": host_us(lambda: launch(*ptrs)),
        "one-call broadcast multiply": host_us(lambda: one_call(qn, sn))}
    print("phase 4c: host microseconds per dequantize_blockwise call at "
          f"{tuple(qn.shape)}, by part: " + ", ".join(
              f"{k} {v:.2f}" for k, v in host.items()))
    del wire6, by_shape, qn, sn, out_n, wire_all

    # ---- phase 6f: save, kill and resume training at TinyLlama-1.1B -----
    enter_phase("6f")
    launches6f = phase_6f(lm, dev)

    dq_launches = {"6b": launches6b["dequantize_blockwise"],
                   "6c": launches6c["dequantize_blockwise"],
                   "6f": launches6f["dequantize_blockwise"]}
    for c in dq_cases:
        lib = (f", one-call broadcast multiply {c['library_ms']:.4f} ms"
               if c["library_ms"] is not None else
               ", no one-call equivalent (a ragged last block)")
        print(f"kernel dequantize_blockwise: shape {tuple(c['shape'])} "
              f"{c['path']} (cycling {c['tensors']}): {c['ms']:.4f} ms per "
              f"call, device time {c['device_ms']:.4f} ms ("
              f"{c['bound_ms'] / c['device_ms']:.4f} of the bound) (plain "
              f"{c['plain_ms']:.4f} ms, bound {c['bound_ms']:.6g}"
              f" ms by {c['bound_by']}; bytes {c['bytes_ms']:.6g} ms, "
              f"operations {c['ops_ms']:.6g} ms{lib}), launches "
              f"{json.dumps(dq_launches)}, max_abs_err {c['max_abs_err']}")
    for c in q6_cases:
        print(f"kernel quantize_blockwise: shape {tuple(c['shape'])} "
              f"{c['path']} (cycling {c['tensors']}): {c['ms']:.4f} ms per "
              f"call, device time {c['device_ms']:.4f} ms ("
              f"{c['bound_ms'] / c['device_ms']:.4f} of the bound) (plain "
              f"{c['plain_ms']:.4f} ms, bound {c['bound_ms']:.6g}"
              f" ms by {c['bound_by']}; bytes {c['bytes_ms']:.6g} ms, "
              f"operations {c['ops_ms']:.6g} ms), max_abs_err "
              f"{c['max_abs_err']}")
    h = dq_cases[0]
    records.append({
        "name": "dequantize_blockwise", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize_blockwise.cu",
        "replaces": "src/repro/kernels/quantize_blockwise.py:38",
        "launches": sum(dq_launches.values()),
        "launches_by_phase": dq_launches,
        "max_abs_err": max(c["max_abs_err"] for c in dq_cases),
        "ms": h["ms"], "device_ms": h["device_ms"], "plain_ms": h["plain_ms"],
        "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
        "library_ms": h["library_ms"], "shape": h["shape"], "cases": dq_cases,
        "group": group,
        "host_us_at_norm": host})
    rec_q = next(r for r in records if r["name"] == "quantize_blockwise")
    rec_q["launches_by_phase"] = {
        "5": rec_q["launches"], "6b": launches6b["quantize_blockwise"],
        "6c": launches6c["quantize_blockwise"],
        "6f": launches6f["quantize_blockwise"]}
    rec_q["launches"] = sum(rec_q["launches_by_phase"].values())
    rec_q["cases"] += q6_cases
    rec_q["wire_step"] = wire_q
    print(f"launches of quantize_blockwise by phase: "
          f"{json.dumps(rec_q['launches_by_phase'])}")

    # ---- phase 7: the remaining model families --------------------------
    enter_phase("7")
    phase_7(dev, prompts)

    # ---- phase 8: distribution and launch -------------------------------
    enter_phase("8")
    launches8 = phase_8(lm, dev)
    for rec in records:
        if rec["name"] in ("quantize_blockwise", "dequantize_blockwise"):
            rec["launches_by_phase"]["8a"] = launches8[rec["name"]]
            rec["launches"] += launches8[rec["name"]]

    # ---- phase 9: the paper's estimation experiments at SF1 -------------
    enter_phase("9")
    child3f = start_phase_3f()
    gc.collect()
    torch.cuda.empty_cache()
    launches9, extras9 = phase_9(dev, schema, rec_t.config)
    for rec in records:
        n9 = launches9.get(rec["name"], 0)
        if rec["name"] in extras9:
            rec["phase_9"] = extras9[rec["name"]]
        rec.setdefault("launches_by_phase", {
            "before 9": rec["launches"]})["9"] = n9
        rec["launches"] += n9

    # ---- phase 11: existing indexes and the what-if API at SF1 ----------
    enter_phase("11")
    launches11 = phase_11(dev, schema, rec_t.config,
                          rec_t.estimation_plan.targets)
    for rec in records:
        n11 = launches11.get(rec["name"], 0)
        rec["launches_by_phase"]["11"] = n11
        rec["launches"] += n11

    # ---- phase 12: the statement-at-a-time oracle paths at SF1 ----------
    enter_phase("12")
    launches12 = phase_12(dev, wl, budget, rec_t, rec_n,
                          adv_n.build_engine().config_cost, est3, staged_n)
    for rec in records:
        n12 = launches12.get(rec["name"], 0)
        rec["launches_by_phase"]["12"] = n12
        rec["launches"] += n12

    # ---- phase 10: training the remaining families on the card ----------
    enter_phase("10")
    del schema, rec_t, launches9, extras9, launches11, launches12, est3, \
        adv_n, rec_n, staged_n
    wait_for_sampling(*child3f)
    launches10 = phase_10(dev)
    for rec in records:
        if rec["name"] in launches10:
            rec["launches_by_phase"]["10"] = launches10[rec["name"]]
            rec["launches"] += launches10[rec["name"]]

    # ---- phase 3f: past the fused dot, its process joined ---------------
    enter_phase("3f wait")
    launches3f = join_phase_3f(*child3f)
    for rec in records:
        if rec["name"] in ADVISOR_KERNELS:
            rec["launches_by_phase"]["3f"] = launches3f[rec["name"]]
            rec["launches"] += launches3f[rec["name"]]

    enter_phase(None)
    print(f"phase seconds: {json.dumps(PHASE_SECONDS)}; total "
          f"{sum(PHASE_SECONDS.values()):.3f} s")
    print(json.dumps({"kernels": records}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    if sys.argv[1:] == [PHASE_3F_FLAG]:
        sys.exit(phase_3f_alone())
    try:
        sys.exit(main())
    finally:
        for child in _CHILDREN:
            if child.poll() is None:
                child.kill()
                child.wait()
