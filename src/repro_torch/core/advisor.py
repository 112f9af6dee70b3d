"""DTAc — the compression-aware physical design advisor (paper Figure 1).

Pipeline: per-query candidate generation -> compressed-size estimation
(§4-§5 framework: amortized SampleCF + deductions chosen by the greedy graph
search) -> candidate selection (top-k or Skyline, §6.1) -> enumeration
(pure/density/backtracking greedy, §6.2) -> recommendation.

`AdvisorOptions` reproduces the tool variants the paper evaluates:
  DTA      = no compression, top-k, pure greedy
  DTAc     = compression + skyline + backtrack (the full tool)
  staged   = DTA first, then compress the chosen indexes (the decoupled
             strategy of Example 1; `staged_recommend`)
  ablations= DTAc(None)/DTAc(Skyline)/DTAc(Backtrack) for Figures 12-13

`backend` / `device` choose where the advisor's array work runs (see
`repro_torch.core.backend`): by default the torch backend on the CUDA
card, with the hand-written kernels; `device="cpu"` runs their plain
PyTorch versions; `backend="numpy"` is the float64 host path, equal to the
JAX package's numpy backend.

Three switches, all on by default, each move ONE phase to its
statement-at-a-time reference on the host (float64 Python and NumPy,
whatever the backend), as the caller's explicit choice:
`use_batched_planner=False` plans with the scalar §5.2 greedy,
`use_batched_estimation=False` runs one `sample_cf` per SAMPLED node, and
`use_engine=False` costs candidates and enumerates with the
`WhatIfOptimizer` (`greedy_enumerate_scalar`).  Every other phase stays on
the backend's device.

Large workloads: `AdvisorOptions.compression_budget = N` advises on at
most ~N weighted representative statements instead of the raw workload
(`repro_torch.core.workload_compression`), and the Recommendation carries
the cost-error certificate (`compression_error_bound` /
`compression_error_rel`).  `None` (the default), and any budget >= the
statement count, runs the uncompressed pipeline.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from . import candidates as cand
from .backend import resolve_device
from .compression import DEFAULT_ADVISOR_METHODS
from .cost_engine import CostEngine
from .enumeration import (EnumerationResult, greedy_enumerate,
                          greedy_enumerate_scalar)
from .estimation_engine import EstimationEngine
from .estimation_graph import EstimationPlanner, NodeKey, Plan
from .relation import IndexDef
from .samplecf import SampleManager
from .whatif import (Configuration, SizeProvider, WhatIfOptimizer,
                     base_configuration, storage_used)
from .workload import Workload
from .workload_compression import CompressedWorkload, compress_workload

# "compression" is workload compression with its error certificate (0.0
# when bypassed)
PHASES = ("compression", "candidates", "plan", "samplecf", "costing",
          "enumeration")


@dataclasses.dataclass
class AdvisorOptions:
    methods: Tuple[str, ...] = DEFAULT_ADVISOR_METHODS
    consider_compression: bool = True
    candidate_mode: str = "skyline"        # "skyline" | "topk"
    enumeration: str = "backtrack"         # "backtrack" | "pure" | "density"
    topk: int = 2
    max_skyline_points: int = 8
    include_clustered: bool = True
    e: float = 0.5                         # size-estimation error tolerance
    q: float = 0.9                         # ... at this confidence
    use_deduction: bool = True
    sample_seed: int = 0
    backend: str = "torch"                 # "torch" | "numpy"
    device: str = "cuda"                   # torch backend: "cuda" | "cpu"
    use_engine: bool = True                # batched cost engine (else the
                                           # WhatIfOptimizer's scalar path)
    use_batched_estimation: bool = True    # batched SampleCF (§4-§5)
    use_batched_planner: bool = True       # batched §5.2 planner engine
    # advise on <= ~N weighted representatives (workload compression);
    # None disables, and budget >= n_statements is an exact bypass
    compression_budget: Optional[int] = None
    # bounds on a long-lived AdvisorSession's recomputable state (None =
    # unbounded); results stay bit-identical under any of them
    samplecf_cache_entries: Optional[int] = None  # LRU (NodeKey, f) cache
    max_planner_nodes: Optional[int] = None       # node-universe epoch bound
    max_replay_entries: Optional[int] = None      # replay-store bound

    def __post_init__(self):
        # validates the pair, and raises for CUDA on a host without it
        resolve_device(self.backend, self.device)

    @staticmethod
    def dta(**kw) -> "AdvisorOptions":
        return AdvisorOptions(consider_compression=False,
                              candidate_mode="topk", enumeration="pure",
                              **kw)

    @staticmethod
    def dtac(**kw) -> "AdvisorOptions":
        return AdvisorOptions(**kw)


def select_candidates(costed: Sequence[cand.Candidate],
                      options: AdvisorOptions) -> List[cand.Candidate]:
    """§6.1 per-query selection switch (skyline or top-k)."""
    if options.candidate_mode == "skyline":
        sel = cand.select_skyline(costed)
        return cand.skyline_representatives(sel, options.max_skyline_points)
    return cand.select_topk(costed, options.topk)


def pool_with_merged(pool: Dict[Tuple, IndexDef],
                     merged_all: Sequence[IndexDef]
                     ) -> Dict[Tuple, IndexDef]:
    """Append merged candidates to the selection pool (Figure 1: Merging
    sits between candidate selection and enumeration); shared by the
    one-shot advisor and the online session so the two cannot drift."""
    for idx in merged_all:
        pool.setdefault(idx.key, idx)
    return pool


def enumerate_pool(sizes: SizeProvider, options: AdvisorOptions,
                   pool: Dict[Tuple, IndexDef], base: Configuration,
                   budget_bytes: float, engine: Optional[CostEngine],
                   optimizer: Optional[WhatIfOptimizer] = None
                   ) -> EnumerationResult:
    """§6.2 greedy enumeration over the selected pool: the batched greedy
    on `engine`, or the scalar greedy over `optimizer` where `engine` is
    None (`use_engine=False`); shared by the one-shot advisor and the
    online session (their bit-exact parity depends on running the same
    code here)."""
    if engine is not None:
        return greedy_enumerate(engine, sizes, list(pool.values()), base,
                                budget_bytes, variant=options.enumeration)
    return greedy_enumerate_scalar(optimizer, sizes, list(pool.values()),
                                   base, budget_bytes,
                                   variant=options.enumeration)


@dataclasses.dataclass
class Recommendation:
    config: Configuration
    base: Configuration
    base_cost: float
    cost: float
    used_bytes: float
    budget_bytes: float
    estimation_cost_pages: float
    estimation_plan: Optional[Plan]
    n_sampled: int
    n_deduced: int
    candidate_count: int
    pool_size: int
    wall_seconds: float
    steps: List[str]
    # host wall seconds per pipeline phase (keys: PHASES)
    phase_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    # workload-compression annotations
    n_statements_full: int = 0      # raw workload statement count
    n_representatives: int = 0      # statements actually advised on
    compression_error_bound: float = 0.0   # certified |C_full - C_comp|
    compression_error_rel: float = 0.0     # ... relative to `cost`

    @property
    def improvement(self) -> float:
        """Estimated runtime improvement vs. the base design (Fig. 12-17)."""
        if self.base_cost <= 0:
            return 0.0
        return 1.0 - self.cost / self.base_cost


class DesignAdvisor:
    def __init__(self, workload: Workload,
                 options: Optional[AdvisorOptions] = None):
        self.workload = workload
        self.schema = workload.schema
        self.opt = options or AdvisorOptions()
        self.device = resolve_device(self.opt.backend, self.opt.device)
        self.sizes = SizeProvider(self.schema)
        # statement-at-a-time what-if costs over the advisor's sizes (the
        # pipeline costs through `build_engine`, or through this optimizer
        # with `use_engine=False`)
        self.optimizer = WhatIfOptimizer(workload, self.sizes, self.device)
        self.samples = SampleManager(self.schema.tables,
                                     seed=self.opt.sample_seed)
        # set by `recommend` when workload compression engages
        self.compressed: Optional[CompressedWorkload] = None
        self.inner: Optional["DesignAdvisor"] = None

    # ------------------------------------------------------------------
    def per_query_raw(self) -> Dict[str, List[IndexDef]]:
        return {
            q.name: cand.syntactically_relevant(
                q, self.schema.tables[q.table],
                include_clustered=self.opt.include_clustered)
            for q in self.workload.queries()
        }

    def _candidate_universe(self) -> Tuple[Dict[str, List[IndexDef]],
                                           List[IndexDef], List[IndexDef]]:
        """One pass over candidate generation + compression expansion.

        Returns (per-query expanded candidates, expanded merged candidates,
        the deduplicated union of both).  Everything downstream — size
        estimation, per-query costing, the enumeration pool — reuses these
        lists.
        """
        per_query = self.per_query_raw()
        seen: Dict[Tuple, IndexDef] = {}
        for cands in per_query.values():
            for idx in cands:
                seen.setdefault(idx.key, idx)
        merged = cand.merged_candidates(per_query)
        for idx in merged:
            seen.setdefault(idx.key, idx)
        # canonical union order (raw candidates are predicate-free, so
        # (table, cols, clustered) is unique)
        raw = sorted(seen.values(),
                     key=lambda i: (i.table, i.cols, i.clustered))
        if not self.opt.consider_compression:
            return per_query, merged, raw
        per_query_exp = {name: cand.expand_with_compression(c,
                                                            self.opt.methods)
                         for name, c in per_query.items()}
        merged_exp = cand.expand_with_compression(merged, self.opt.methods)
        all_cands = cand.expand_with_compression(raw, self.opt.methods)
        return per_query_exp, merged_exp, all_cands

    def generate_candidates(self) -> List[IndexDef]:
        return self._candidate_universe()[2]

    # ------------------------------------------------------------------
    @staticmethod
    def estimation_targets(all_cands: Sequence[IndexDef]
                           ) -> Dict[NodeKey, List[IndexDef]]:
        """Size-estimation targets of a candidate set: the compressed,
        predicate-free candidates, deduplicated (in order) into NodeKeys
        mapped to their IndexDef variants."""
        tkey_to_defs: Dict[NodeKey, List[IndexDef]] = {}
        for idx in all_cands:
            if idx.compression is None or idx.predicate is not None:
                continue
            k = NodeKey(idx.table, idx.cols, idx.compression)
            tkey_to_defs.setdefault(k, []).append(idx)
        return tkey_to_defs

    def estimate_sizes(self, all_cands: Sequence[IndexDef],
                       phases: Optional[Dict[str, float]] = None
                       ) -> Tuple[float, Optional[Plan], int, int]:
        """Register estimated sizes for every compressed candidate.  With
        `phases`, adds the planning and SampleCF wall seconds to it."""
        t0 = time.perf_counter()
        if phases is not None:
            phases.setdefault("plan", 0.0)
            phases.setdefault("samplecf", 0.0)
        tkey_to_defs = self.estimation_targets(all_cands)
        targets = list(tkey_to_defs)
        if not targets:
            return 0.0, None, 0, 0
        planner = EstimationPlanner(self.schema.tables, device=self.device,
                                    use_engine=self.opt.use_batched_planner,
                                    record=False)
        if self.opt.use_deduction:
            plan = planner.plan(targets, self.opt.e, self.opt.q)
        else:
            # "All": SampleCF on every target (the paper's baseline)
            plan = planner.plan_all_sampled(targets, self.opt.e, self.opt.q)
        t1 = time.perf_counter()
        if self.opt.use_batched_estimation:
            ests = planner.execute(plan, EstimationEngine(
                self.schema.tables, self.samples, device=self.device))
        else:
            ests = planner.execute_scalar(plan, self.samples)
        # execute() also resolves intermediate plan nodes; only register
        # sizes for defs that were actually requested as targets.
        for k, est in ests.items():
            for idx in tkey_to_defs.get(k, ()):
                self.sizes.register(idx, est.est_bytes)
        if phases is not None:
            phases["plan"] += t1 - t0
            phases["samplecf"] += time.perf_counter() - t1
        return plan.total_cost, plan, plan.n_sampled(), plan.n_deduced()

    # ------------------------------------------------------------------
    def build_engine(self) -> Optional[CostEngine]:
        """The batched what-if engine over the current sizes (None with
        `use_engine=False`: the pipeline then costs through
        `self.optimizer`).  Built after size estimation so every
        compressed candidate is scored with its estimated size."""
        if not self.opt.use_engine:
            return None
        return CostEngine(self.workload, self.sizes, device=self.device)

    def select_pool(self, per_query_exp: Dict[str, List[IndexDef]],
                    merged_all: Sequence[IndexDef], base: Configuration,
                    engine: Optional[CostEngine]
                    ) -> Tuple[Dict[Tuple, IndexDef], int]:
        """Per-query candidate costing + §6.1 selection; merged candidates
        enter the pool directly (Figure 1: Merging sits between candidate
        selection and enumeration)."""
        pool: Dict[Tuple, IndexDef] = {}
        n_cand = 0
        for q in self.workload.queries():
            costed = cand.cost_candidates(q, per_query_exp[q.name], base,
                                          self.sizes, engine,
                                          optimizer=self.optimizer)
            n_cand += len(costed)
            for c in select_candidates(costed, self.opt):
                pool.setdefault(c.index.key, c.index)
        return pool_with_merged(pool, merged_all), n_cand

    def enumerate_pool(self, pool: Dict[Tuple, IndexDef],
                       base: Configuration, budget_bytes: float,
                       engine: Optional[CostEngine]) -> EnumerationResult:
        """§6.2 greedy enumeration over the selected pool."""
        return enumerate_pool(self.sizes, self.opt, pool, base,
                              budget_bytes, engine, self.optimizer)

    def _recommend_full(self, budget_bytes: float) -> Recommendation:
        """The uncompressed pipeline (every statement advised directly)."""
        phases: Dict[str, float] = {"compression": 0.0}
        t0 = time.perf_counter()
        base = base_configuration(self.schema)
        per_query_exp, merged_all, all_cands = self._candidate_universe()
        t1 = time.perf_counter()
        phases["candidates"] = t1 - t0
        est_cost, plan, n_s, n_d = self.estimate_sizes(all_cands, phases)

        t2 = time.perf_counter()
        engine = self.build_engine()
        base_cost = (engine.config_cost(base) if engine is not None
                     else self.optimizer.workload_cost(base))
        pool, n_cand = self.select_pool(per_query_exp, merged_all, base,
                                        engine)
        t3 = time.perf_counter()
        phases["costing"] = t3 - t2
        res = self.enumerate_pool(pool, base, budget_bytes, engine)
        t4 = time.perf_counter()
        phases["enumeration"] = t4 - t3
        n_full = len(self.workload.statements)
        return Recommendation(
            config=res.config, base=base, base_cost=base_cost, cost=res.cost,
            used_bytes=res.used_bytes, budget_bytes=budget_bytes,
            estimation_cost_pages=est_cost, estimation_plan=plan,
            n_sampled=n_s, n_deduced=n_d, candidate_count=n_cand,
            pool_size=len(pool), wall_seconds=t4 - t0, steps=res.steps,
            phase_seconds=phases, n_statements_full=n_full,
            n_representatives=n_full)

    def recommend(self, budget_bytes: float) -> Recommendation:
        """The DTAc pipeline.  With `opt.compression_budget` set below the
        statement count it runs on the compressed weighted-representative
        workload (an inner advisor sharing this one's samples), and the
        recommendation carries the certified cost-error bound; otherwise
        `_recommend_full` on every statement."""
        t0 = time.perf_counter()
        comp = compress_workload(self.workload, self.opt.compression_budget)
        if comp is None:
            self.compressed = None
            self.inner = None
            return self._recommend_full(budget_bytes)
        inner = DesignAdvisor(
            comp.workload,
            dataclasses.replace(self.opt, compression_budget=None))
        inner.samples = self.samples   # draw-order-independent: shareable
        self.compressed = comp
        self.inner = inner
        t1 = time.perf_counter()
        rec = inner._recommend_full(budget_bytes)
        t2 = time.perf_counter()
        eps = comp.error_bound(rec.config, inner.sizes)
        t3 = time.perf_counter()
        phases = dict(rec.phase_seconds, compression=(t1 - t0) + (t3 - t2))
        return dataclasses.replace(
            rec, n_statements_full=comp.n_full,
            n_representatives=comp.n_representatives,
            compression_error_bound=eps,
            compression_error_rel=eps / max(abs(rec.cost), 1e-12),
            wall_seconds=t3 - t0, phase_seconds=phases)


def staged_recommend(workload: Workload, budget_bytes: float,
                     methods: Optional[Sequence[str]] = None,
                     options: Optional[AdvisorOptions] = None
                     ) -> Recommendation:
    """The decoupled strategy of Example 1: select uncompressed indexes
    first (DTA), then compress each chosen secondary index with the method
    that lowers the workload cost most, and account the recompressed
    footprint.

    Stage 1 inherits the caller's (e, q), sample seed, clustered-candidate
    switch, backend, device and the three `use_*` switches; stage 2 plans
    the compressed sizes at the caller's (e, q) and runs their SampleCF on
    the advisor's device, so on the card PREFIX / RLE / LDICT / NS sizes
    come from the kernels.  (The JAX package's stage 2 runs SampleCF on
    NumPy whatever its backend; the sizes are the same integers either
    way.)  The recompression loop is costed by the batched
    `CostEngine.config_cost`, or with `use_engine=False` by stage 1's
    `WhatIfOptimizer.workload_cost`."""
    opt = options or AdvisorOptions()
    if methods is None:
        methods = opt.methods
    stage1 = AdvisorOptions.dta(
        e=opt.e, q=opt.q, sample_seed=opt.sample_seed,
        include_clustered=opt.include_clustered, backend=opt.backend,
        device=opt.device, use_engine=opt.use_engine,
        use_batched_estimation=opt.use_batched_estimation,
        use_batched_planner=opt.use_batched_planner)
    adv = DesignAdvisor(workload, stage1)
    rec = adv.recommend(budget_bytes)
    # stage 2: size the compressed variants of every chosen secondary index
    sizes = adv.sizes
    chosen = [i for i in rec.config.indexes if not i.clustered]
    variants = cand.expand_with_compression(chosen, methods)
    targets = [NodeKey(i.table, i.cols, i.compression) for i in variants
               if i.compression is not None]
    if targets:
        planner = EstimationPlanner(adv.schema.tables, device=adv.device,
                                    use_engine=opt.use_batched_planner,
                                    record=False)
        plan = planner.plan(targets, opt.e, opt.q)
        if opt.use_batched_estimation:
            ests = planner.execute(plan, EstimationEngine(
                adv.schema.tables, adv.samples, device=adv.device))
        else:
            ests = planner.execute_scalar(plan, adv.samples)
        for k, est in ests.items():
            sizes.register(IndexDef(k.table, k.cols, k.method),
                           est.est_bytes)
    # the recompression loop's cost oracle, built AFTER the compressed
    # sizes are registered so variants score with their estimated sizes
    if opt.use_engine:
        cost_fn = CostEngine(workload, sizes, device=adv.device).config_cost
    else:
        cost_fn = adv.optimizer.workload_cost
    config = rec.config
    for idx in chosen:
        best = (cost_fn(config), config)
        for m in methods:
            cfg2 = config.replace(idx, idx.with_compression(m))
            c2 = cost_fn(cfg2)
            if c2 < best[0]:
                best = (c2, cfg2)
        config = best[1]
    # stage 3: with reclaimed space, account the recompressed footprint
    used = storage_used(config, rec.base, sizes)
    return dataclasses.replace(
        rec, config=config, cost=cost_fn(config), used_bytes=used)
