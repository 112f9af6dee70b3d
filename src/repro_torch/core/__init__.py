# Compression Aware Physical Database Design (Kimura, Narasayya, Syamala;
# PVLDB 4(10), 2011) in PyTorch: the DTAc advisor pipeline -- compression
# methods + SampleCF + deduction (§2, §4), the estimation-plan graph search
# (§5), skyline candidate selection + backtracking greedy enumeration (§6),
# the compression-aware what-if cost model (App. A), workload compression
# for large workloads (§7), the staged baseline of Example 1 and the online
# advisor session (AdvisorSession: workload deltas, snapshots, seeded fault
# injection) and its durable store (DurableStore: per-tenant write-ahead
# log and atomic snapshots), join synopses / Adaptive-Estimator MV
# cardinalities (App. B) -- with its array work on a torch device and
# hand-written CUDA kernels (repro_torch.kernels).
from .advisor import AdvisorOptions, DesignAdvisor, Recommendation, \
    staged_recommend
from .backend import BACKENDS, resolve_device
from .compression import DEFAULT_ADVISOR_METHODS, METHODS
from .cost_engine import CostEngine, chunked_config_costs
from .durability import DurableStore, LogCorrupt, RecoveredTenant
from .estimation_engine import EstimationEngine, batched_sample_cf
from .estimation_graph import EstimationPlanner, NodeKey, Plan, State
from .faults import FaultError, FaultInjector, FaultSpec
from .interop import schema_from_arrays, workload_from_spec
from .planner_engine import PlannerEngine
from .relation import ColumnDef, IndexDef, Predicate, Table
from .samplecf import EstimateCache, SampleManager, SizeEstimate, sample_cf
from .session import AdvisorSession, SessionSnapshot, SnapshotCorrupt
from .synopses import ForeignKey, MVDef, Schema, SynopsisManager
from .whatif import Configuration, SizeProvider, WhatIfOptimizer, \
    base_configuration, storage_used
from .workload import BulkInsert, Query, Workload, WorkloadDelta, \
    make_scaled_workload, make_scaled_workload_reference, make_tpch_like, \
    make_tpch_workload
from .workload_compression import ClusterIndex, CompressedWorkload, \
    compress_workload

__all__ = [
    "AdvisorOptions", "DesignAdvisor", "Recommendation", "staged_recommend",
    "AdvisorSession", "SessionSnapshot", "SnapshotCorrupt",
    "BACKENDS", "resolve_device",
    "DEFAULT_ADVISOR_METHODS", "METHODS", "CostEngine",
    "chunked_config_costs",
    "DurableStore", "LogCorrupt", "RecoveredTenant",
    "EstimationEngine", "batched_sample_cf",
    "EstimationPlanner", "NodeKey", "Plan", "State", "PlannerEngine",
    "FaultError", "FaultInjector", "FaultSpec",
    "schema_from_arrays", "workload_from_spec",
    "ColumnDef", "IndexDef", "Predicate", "Table",
    "EstimateCache", "SampleManager", "SizeEstimate", "sample_cf",
    "ForeignKey", "MVDef", "Schema", "SynopsisManager",
    "Configuration", "SizeProvider", "WhatIfOptimizer",
    "base_configuration", "storage_used",
    "BulkInsert", "Query", "Workload", "WorkloadDelta",
    "make_scaled_workload", "make_scaled_workload_reference",
    "make_tpch_like", "make_tpch_workload",
    "ClusterIndex", "CompressedWorkload", "compress_workload",
]
