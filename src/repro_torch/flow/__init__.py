"""Workload pipelines: DAG-composed WorkloadSpecs with triggers,
gates, and canary checkpoint promotion — the batch-workflow layer the
Flux Operator paper frames the operator as the convergence point for.
A copy of the JAX package's ``flow`` (``repro.`` -> ``repro_torch.``); a
promotion lifts the trained params as host tensors.
"""
from repro_torch.flow.handle import (COMPLETED, FAILED, PENDING,  # noqa: F401
                                     RUNNING, SKIPPED, PipelineHandle,
                                     StageState)
from repro_torch.flow.loader import (check_pipeline,  # noqa: F401
                                     is_pipeline_doc, load_pipeline)
from repro_torch.flow.reconcile import PipelineReconciler  # noqa: F401
from repro_torch.flow.spec import (GATE_METRICS, GateSpec,  # noqa: F401
                                   PipelineSpec, PromoteSpec, StageSpec,
                                   TriggerSpec)

__all__ = [
    "PipelineSpec", "StageSpec", "TriggerSpec", "GateSpec",
    "PromoteSpec", "GATE_METRICS", "PipelineHandle", "StageState",
    "PipelineReconciler", "load_pipeline", "check_pipeline",
    "is_pipeline_doc", "PENDING", "RUNNING", "COMPLETED", "FAILED",
    "SKIPPED",
]
