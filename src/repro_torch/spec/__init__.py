"""Declarative workload API: one CRD-style spec, reconciled into every
executor.

* ``workload``  — :class:`WorkloadSpec` (kind ``train`` | ``serve`` |
                  ``dryrun``), serializable with strict
                  ``to_dict``/``from_dict`` round-trip and structured
                  submit-time validation (:class:`SpecError`);
* ``handle``    — :class:`WorkloadHandle`, the observable lifecycle
                  ``Pending -> Bound -> Running -> Resizing ->
                  Completed/Failed`` behind ``status()``/``events()``;
* ``reconcile`` — :class:`WorkloadReconciler`, the single submission
                  path ``FluxInstance.apply`` delegates to;
* ``loader``    — ``load_spec`` / ``check_spec`` for the ``--spec``
                  CLI flag and the spec lint.
"""
from repro_torch.spec.handle import (  # noqa: F401
    BOUND, COMPLETED, FAILED, PENDING, PHASES, RESIZING, RUNNING,
    WorkloadHandle,
)
from repro_torch.spec.loader import check_spec, load_spec  # noqa: F401
from repro_torch.spec.reconcile import WorkloadReconciler  # noqa: F401
from repro_torch.spec.workload import (  # noqa: F401
    KINDS, DryRunSpec, ResourceSpec, ServeSpec, SpecError, TrainSpec,
    WorkloadSpec,
)
