# Compression Aware Physical Database Design (Kimura, Narasayya, Syamala;
# PVLDB 4(10), 2011) in PyTorch: the DTAc advisor pipeline -- compression
# methods + SampleCF + deduction (§2, §4), the estimation-plan graph search
# (§5), skyline candidate selection + backtracking greedy enumeration (§6)
# and the compression-aware what-if cost model (App. A) -- with its array
# work on a torch device and hand-written CUDA kernels (repro_torch.kernels).
from .advisor import AdvisorOptions, DesignAdvisor, Recommendation
from .backend import BACKENDS, resolve_device
from .compression import DEFAULT_ADVISOR_METHODS, METHODS
from .cost_engine import CostEngine
from .estimation_engine import EstimationEngine, batched_sample_cf
from .estimation_graph import EstimationPlanner, NodeKey, Plan, State
from .interop import schema_from_arrays, workload_from_spec
from .planner_engine import PlannerEngine
from .relation import ColumnDef, IndexDef, Predicate, Table
from .samplecf import SampleManager, SizeEstimate, sample_cf
from .synopses import ForeignKey, Schema
from .whatif import Configuration, SizeProvider, base_configuration, \
    storage_used
from .workload import BulkInsert, Query, Workload, make_tpch_like, \
    make_tpch_workload

__all__ = [
    "AdvisorOptions", "DesignAdvisor", "Recommendation",
    "BACKENDS", "resolve_device",
    "DEFAULT_ADVISOR_METHODS", "METHODS", "CostEngine",
    "EstimationEngine", "batched_sample_cf",
    "EstimationPlanner", "NodeKey", "Plan", "State", "PlannerEngine",
    "schema_from_arrays", "workload_from_spec",
    "ColumnDef", "IndexDef", "Predicate", "Table",
    "SampleManager", "SizeEstimate", "sample_cf",
    "ForeignKey", "Schema",
    "Configuration", "SizeProvider", "base_configuration", "storage_used",
    "BulkInsert", "Query", "Workload", "make_tpch_like", "make_tpch_workload",
]
