"""Core: the paper's cloud resource-allocation manager.

Public API:
    Catalog / InstanceType / fig3_catalog / fig6_catalog / table1_catalog
    Stream / AnalysisProgram / VGG16 / ZF / FIG3_SCENARIOS / make_streams
    AnalysisPipeline / PipelineStage / PIPELINES / scaled_program
    ResourceManager / AdaptiveManager / Plan
    strategies: ST1/ST2/ST3 (CPU-GPU), NL/ARMVAC/GCL (location-aware)
    solver: exact branch-and-bound MDMC vector-bin-packing
    arcflow: Brandão–Pedroso arc-flow graphs with compression
    gpu_catalog: the H100 catalog the serving measurements are packed onto

The modules are numpy and stdlib only, statement for statement those of the
JAX package's ``core``, so the same inputs give bit-equal plans.
"""
from repro_torch.core.adaptive import AdaptiveManager
from repro_torch.core.catalog import (Catalog, InstanceType, UTILIZATION_CAP,
                                fig3_catalog, fig6_catalog, table1_catalog)
from repro_torch.core.manager import ResourceManager
from repro_torch.core.markets import (MarketQuote, MixedConfig, MixedResult,
                                mixed_plan, quotes, replica_group,
                                spot_affinity_violations, spot_problem)
from repro_torch.core.packing import (Bin, Choice, Infeasible, Item, Problem,
                                Solution, validate)
from repro_torch.core.repair import (RepairConfig, RepairResult,
                               count_plan_migrations, plan_assignment,
                               repair_plan)
from repro_torch.core.strategies import Plan, STRATEGIES, build_problem
from repro_torch.core.workload import (FIG3_SCENARIOS, PIPELINES, PROGRAMS, VGG16,
                                 ZF, AnalysisPipeline, AnalysisProgram,
                                 PipelineStage, Stream, make_streams,
                                 scaled_program)

__all__ = [
    "AdaptiveManager", "AnalysisPipeline", "AnalysisProgram", "Bin",
    "Catalog", "Choice",
    "FIG3_SCENARIOS", "Infeasible", "InstanceType", "Item", "MarketQuote",
    "MixedConfig", "MixedResult", "PIPELINES", "PROGRAMS",
    "Plan", "PipelineStage", "Problem", "RepairConfig", "RepairResult",
    "ResourceManager",
    "STRATEGIES", "Solution", "Stream", "UTILIZATION_CAP", "VGG16", "ZF",
    "build_problem", "count_plan_migrations", "fig3_catalog", "fig6_catalog",
    "make_streams", "mixed_plan", "plan_assignment", "quotes", "repair_plan",
    "replica_group", "scaled_program", "spot_affinity_violations",
    "spot_problem", "table1_catalog", "validate",
]
