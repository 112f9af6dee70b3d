"""DTAc — the compression-aware physical design advisor (paper Figure 1).

Pipeline: per-query candidate generation -> compressed-size estimation
(§4-§5 framework: amortized SampleCF + deductions chosen by the greedy graph
search) -> candidate selection (top-k or Skyline, §6.1) -> enumeration
(pure/density/backtracking greedy, §6.2) -> recommendation.

`AdvisorOptions` reproduces the tool variants the paper evaluates:
  DTA      = no compression, top-k, pure greedy
  DTAc     = compression + skyline + backtrack (the full tool)
  ablations= DTAc(None)/DTAc(Skyline)/DTAc(Backtrack) for Figures 12-13

`backend` / `device` choose where the advisor's array work runs (see
`repro_torch.core.backend`): by default the torch backend on the CUDA
card, with the hand-written kernels; `device="cpu"` runs their plain
PyTorch versions; `backend="numpy"` is the float64 host path, equal to the
JAX package's numpy backend.

Not ported yet: workload compression (`compression_budget` raises), and
the staged DTA-then-compress strategy of Example 1.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from . import candidates as cand
from .backend import resolve_device
from .compression import DEFAULT_ADVISOR_METHODS
from .cost_engine import CostEngine
from .enumeration import EnumerationResult, greedy_enumerate
from .estimation_engine import EstimationEngine
from .estimation_graph import EstimationPlanner, NodeKey, Plan
from .relation import IndexDef
from .samplecf import SampleManager
from .whatif import Configuration, SizeProvider, base_configuration
from .workload import Workload

PHASES = ("candidates", "plan", "samplecf", "costing", "enumeration")


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
    # workload compression is not ported: any budget raises
    compression_budget: Optional[int] = None

    def __post_init__(self):
        if self.compression_budget is not None:
            raise NotImplementedError(
                "compression_budget: workload compression is still to port "
                "(ROADMAP.md Queue A)")
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
        self.samples = SampleManager(self.schema.tables,
                                     seed=self.opt.sample_seed)

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
        planner = EstimationPlanner(self.schema.tables, device=self.device)
        if self.opt.use_deduction:
            plan = planner.plan(targets, self.opt.e, self.opt.q)
        else:
            # "All": SampleCF on every target (the paper's baseline)
            plan = planner.plan_all_sampled(targets, self.opt.e, self.opt.q)
        t1 = time.perf_counter()
        engine = EstimationEngine(self.schema.tables, self.samples,
                                  device=self.device)
        ests = planner.execute(plan, engine)
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
    def build_engine(self) -> CostEngine:
        """The batched what-if engine over the current sizes.  Built after
        size estimation so every compressed candidate is scored with its
        estimated size."""
        return CostEngine(self.workload, self.sizes, device=self.device)

    def select_pool(self, per_query_exp: Dict[str, List[IndexDef]],
                    merged_all: Sequence[IndexDef], base: Configuration,
                    engine: CostEngine) -> Tuple[Dict[Tuple, IndexDef], int]:
        """Per-query candidate costing + §6.1 selection; merged candidates
        enter the pool directly (Figure 1: Merging sits between candidate
        selection and enumeration)."""
        pool: Dict[Tuple, IndexDef] = {}
        n_cand = 0
        for q in self.workload.queries():
            costed = cand.cost_candidates(q, per_query_exp[q.name], base,
                                          self.sizes, engine)
            n_cand += len(costed)
            for c in select_candidates(costed, self.opt):
                pool.setdefault(c.index.key, c.index)
        for idx in merged_all:
            pool.setdefault(idx.key, idx)
        return pool, n_cand

    def enumerate_pool(self, pool: Dict[Tuple, IndexDef],
                       base: Configuration, budget_bytes: float,
                       engine: CostEngine) -> EnumerationResult:
        """§6.2 greedy enumeration over the selected pool."""
        return greedy_enumerate(engine, self.sizes, list(pool.values()),
                                base, budget_bytes,
                                variant=self.opt.enumeration)

    def recommend(self, budget_bytes: float) -> Recommendation:
        """The full DTAc pipeline on every statement of the workload."""
        phases: Dict[str, float] = {}
        t0 = time.perf_counter()
        base = base_configuration(self.schema)
        per_query_exp, merged_all, all_cands = self._candidate_universe()
        t1 = time.perf_counter()
        phases["candidates"] = t1 - t0
        est_cost, plan, n_s, n_d = self.estimate_sizes(all_cands, phases)

        t2 = time.perf_counter()
        engine = self.build_engine()
        base_cost = engine.config_cost(base)
        pool, n_cand = self.select_pool(per_query_exp, merged_all, base,
                                        engine)
        t3 = time.perf_counter()
        phases["costing"] = t3 - t2
        res = self.enumerate_pool(pool, base, budget_bytes, engine)
        t4 = time.perf_counter()
        phases["enumeration"] = t4 - t3
        return Recommendation(
            config=res.config, base=base, base_cost=base_cost, cost=res.cost,
            used_bytes=res.used_bytes, budget_bytes=budget_bytes,
            estimation_cost_pages=est_cost, estimation_plan=plan,
            n_sampled=n_s, n_deduced=n_d, candidate_count=n_cand,
            pool_size=len(pool), wall_seconds=t4 - t0, steps=res.steps,
            phase_seconds=phases)
