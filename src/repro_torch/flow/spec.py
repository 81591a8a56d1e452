"""PipelineSpec: DAG-composed WorkloadSpecs with triggers and gates.

The Flux Operator frames the operator as the convergence point for
batch *workflows*, not isolated jobs: production runs are chains
(train -> eval gate -> promote to serve) and recurring submissions.
``PipelineSpec`` is the declarative artifact for that layer — named
stages, each wrapping a :class:`repro_torch.spec.WorkloadSpec` (or a gate /
promote step over upstream results), ``depends_on`` edges, per-stage
triggers, and retry policy.  ``PipelineReconciler`` walks the DAG
event-driven off WorkloadHandle phase transitions.

Design rules are the WorkloadSpec ones: serializable round-trip
(``PipelineSpec.from_dict(p.to_dict()) == p``), strict ``from_dict``
(unknown keys are structured errors), and fail-at-apply (``errors()``
collects EVERY problem — cycles, unknown refs, unknown triggers,
gate/promote kind-compatibility — into one :class:`SpecError`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.spec.workload import SpecError, WorkloadSpec, _check_num, _err

STAGE_KINDS = ("workload", "gate", "promote")
TRIGGER_KINDS = ("completion", "cron", "interval")
ON_FAILURE = ("fail", "continue")
GATE_OPS = ("lt", "le", "gt", "ge", "eq")

# gate kind-compatibility: which result metrics each workload kind
# stamps (WorkloadHandle._stamp_result) — a gate over anything else is
# an apply-time error, not a None comparison at run time
GATE_METRICS = {
    "train": ("final_loss", "steps"),
    "serve": ("n_requests", "n_tokens", "ttft_mean_s", "replicas"),
    "dryrun": ("n_devices",),
}


@dataclass
class TriggerSpec:
    """When a stage fires once its dependencies are satisfied.

    * ``completion`` — once, the moment every upstream stage completes
      (the default; a root stage fires at pipeline activation).
    * ``interval`` — at activation + k*every for k = 1..count.
    * ``cron`` — at the aligned absolute sim times ``offset + k*every``
      that are >= the activation time (count fires total).  Alignment
      is what distinguishes cron from interval: two pipelines applied
      at different times fire at the SAME absolute ticks.
    """

    on: str = "completion"
    every: float = 0.0            # period (cron / interval), sim seconds
    offset: float = 0.0           # cron phase within the period grid
    count: int = 1                # total fires; 0 = unbounded


@dataclass
class GateSpec:
    """Predicate over the single upstream stage's ``handle.result()``.

    A failed gate completes (it did its job) but marks every
    descendant ``Skipped`` — never ``Failed`` — and leaves running
    siblings untouched.
    """

    metric: str = "final_loss"
    op: str = "lt"
    value: float = 0.0


@dataclass
class PromoteSpec:
    """Roll the checkpoint trained by ``from_stage`` into the LIVE
    elastic serve fleet of ``target``, replica by replica
    (``ElasticFleetServeExecutor.promote``)."""

    from_stage: str = ""
    target: str = ""
    note: str = ""


@dataclass
class StageSpec:
    """One named node of the DAG."""

    name: str = ""
    kind: str = "workload"
    workload: Optional[WorkloadSpec] = None
    depends_on: List[str] = field(default_factory=list)
    trigger: TriggerSpec = field(default_factory=TriggerSpec)
    gate: Optional[GateSpec] = None
    promote: Optional[PromoteSpec] = None
    max_retries: int = 0          # extra submissions after a Failed run
    on_failure: str = "fail"      # pipeline verdict when this stage fails


@dataclass
class PipelineSpec:
    """One declarative pipeline; ``FluxInstance.apply_pipeline``
    reconciles it."""

    name: str = "pipeline"
    stages: List[StageSpec] = field(default_factory=list)
    description: str = ""

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        out_stages = []
        for s in self.stages:
            d: Dict[str, Any] = {
                "name": s.name,
                "kind": s.kind,
                "depends_on": list(s.depends_on),
                "trigger": dataclasses.asdict(s.trigger),
                "max_retries": s.max_retries,
                "on_failure": s.on_failure,
            }
            if s.workload is not None:
                d["workload"] = s.workload.to_dict()
            if s.gate is not None:
                d["gate"] = dataclasses.asdict(s.gate)
            if s.promote is not None:
                d["promote"] = dataclasses.asdict(s.promote)
            out_stages.append(d)
        return {"name": self.name, "description": self.description,
                "stages": out_stages}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PipelineSpec":
        """Strict constructor: unknown keys anywhere are structured
        errors, not silent drops."""
        errors: List[Dict[str, str]] = []
        d = dict(d)
        d.pop("kind", None)           # tolerated "pipeline" discriminator
        known = {f.name for f in dataclasses.fields(cls)}
        for k in sorted(set(d) - known):
            errors.append(_err(k, "unknown-field",
                               f"unknown PipelineSpec field {k!r}"))
            d.pop(k)
        raw_stages = d.pop("stages", [])
        if not isinstance(raw_stages, list):
            errors.append(_err("stages", "bad-type",
                               "stages must be a list"))
            raw_stages = []
        stages: List[StageSpec] = []
        for i, raw in enumerate(raw_stages):
            where = f"stages[{i}]"
            if not isinstance(raw, dict):
                errors.append(_err(where, "bad-type",
                                   "stage must be an object"))
                continue
            raw = dict(raw)
            snames = {f.name for f in dataclasses.fields(StageSpec)}
            for k in sorted(set(raw) - snames):
                errors.append(_err(f"{where}.{k}", "unknown-field",
                                   f"unknown stage field {k!r}"))
                raw.pop(k)

            def sub(key, klass, raw=raw, where=where):
                v = raw.pop(key, None)
                if v is None:
                    return None
                if isinstance(v, klass):
                    return v
                if not isinstance(v, dict):
                    errors.append(_err(f"{where}.{key}", "bad-type",
                                       f"{key} must be an object"))
                    return None
                names = {f.name for f in dataclasses.fields(klass)}
                for k in sorted(set(v) - names):
                    errors.append(_err(
                        f"{where}.{key}.{k}", "unknown-field",
                        f"unknown {key} field {k!r}"))
                return klass(**{k: x for k, x in v.items() if k in names})

            trigger = sub("trigger", TriggerSpec) or TriggerSpec()
            gate = sub("gate", GateSpec)
            promote = sub("promote", PromoteSpec)
            wl = raw.pop("workload", None)
            if isinstance(wl, dict):
                try:
                    wl = WorkloadSpec.from_dict(wl)
                except SpecError as e:
                    errors.extend(
                        dict(err, field=f"{where}.workload.{err['field']}")
                        for err in e.errors)
                    wl = None
            elif wl is not None and not isinstance(wl, WorkloadSpec):
                errors.append(_err(f"{where}.workload", "bad-type",
                                   "workload must be an object"))
                wl = None
            stages.append(StageSpec(workload=wl, trigger=trigger,
                                    gate=gate, promote=promote, **raw))
        if errors:
            raise SpecError(errors)
        return cls(stages=stages, **d)

    # -- validation ---------------------------------------------------------
    def errors(self, *, known_arch: bool = True) -> List[Dict[str, str]]:
        """All structural problems (empty when the pipeline is
        well-formed): per-stage checks, unknown ``depends_on`` refs,
        DAG cycles, trigger sanity, gate/promote kind-compatibility."""
        errs: List[Dict[str, str]] = []
        if not isinstance(self.name, str) or not self.name:
            errs.append(_err("name", "bad-value",
                             "pipeline name must be a non-empty string"))
        if not self.stages:
            errs.append(_err("stages", "bad-value",
                             "a pipeline needs at least one stage"))
        by_name: Dict[str, StageSpec] = {}
        for i, s in enumerate(self.stages):
            where = f"stages[{i}]"
            if not isinstance(s.name, str) or not s.name:
                errs.append(_err(f"{where}.name", "bad-value",
                                 "stage name must be a non-empty string"))
                continue
            if s.name in by_name:
                errs.append(_err(f"{where}.name", "duplicate",
                                 f"duplicate stage name {s.name!r}"))
                continue
            by_name[s.name] = s
        for i, s in enumerate(self.stages):
            where = f"stages[{i}]"
            errs.extend(self._stage_errors(s, where, by_name, known_arch))
        errs.extend(self._cycle_errors(by_name))
        return errs

    def _stage_errors(self, s: StageSpec, where: str,
                      by_name: Dict[str, StageSpec],
                      known_arch: bool) -> List[Dict[str, str]]:
        errs: List[Dict[str, str]] = []
        if s.kind not in STAGE_KINDS:
            errs.append(_err(f"{where}.kind", "unknown-kind",
                             f"stage kind {s.kind!r} not in {STAGE_KINDS}"))
            return errs
        for dep in s.depends_on:
            if dep not in by_name:
                errs.append(_err(
                    f"{where}.depends_on", "unknown-ref",
                    f"stage {s.name!r} depends on unknown stage {dep!r}"))
            elif dep == s.name:
                errs.append(_err(f"{where}.depends_on", "cycle",
                                 f"stage {s.name!r} depends on itself"))
        t = s.trigger
        if t.on not in TRIGGER_KINDS:
            errs.append(_err(
                f"{where}.trigger.on", "unknown-trigger",
                f"trigger {t.on!r} not in {TRIGGER_KINDS}"))
        elif t.on in ("cron", "interval"):
            if s.kind != "workload":
                errs.append(_err(
                    f"{where}.trigger.on", "bad-trigger",
                    f"{s.kind} stages fire on completion only"))
            if _check_num(errs, f"{where}.trigger.every", t.every, 0) \
                    and t.every == 0:
                errs.append(_err(f"{where}.trigger.every", "bad-value",
                                 f"{t.on} triggers need every > 0"))
            _check_num(errs, f"{where}.trigger.offset", t.offset, 0)
            _check_num(errs, f"{where}.trigger.count", t.count, 0)
        if s.on_failure not in ON_FAILURE:
            errs.append(_err(
                f"{where}.on_failure", "bad-value",
                f"on_failure {s.on_failure!r} not in {ON_FAILURE}"))
        _check_num(errs, f"{where}.max_retries", s.max_retries, 0)
        if s.kind == "workload":
            if s.workload is None:
                errs.append(_err(f"{where}.workload", "missing",
                                 "workload stages need a workload spec"))
            else:
                errs.extend(
                    dict(e, field=f"{where}.workload.{e['field']}")
                    for e in s.workload.errors(known_arch=known_arch))
        elif s.kind == "gate":
            errs.extend(self._gate_errors(s, where, by_name))
        elif s.kind == "promote":
            errs.extend(self._promote_errors(s, where, by_name))
        return errs

    def _gate_errors(self, s: StageSpec, where: str,
                     by_name: Dict[str, StageSpec]) -> List[Dict[str, str]]:
        errs: List[Dict[str, str]] = []
        if s.gate is None:
            errs.append(_err(f"{where}.gate", "missing",
                             "gate stages need a gate predicate"))
            return errs
        if s.gate.op not in GATE_OPS:
            errs.append(_err(f"{where}.gate.op", "bad-value",
                             f"gate op {s.gate.op!r} not in {GATE_OPS}"))
        _check_num(errs, f"{where}.gate.value", s.gate.value,
                   float("-inf"))
        deps = [d for d in s.depends_on if d in by_name]
        if len(deps) != 1:
            errs.append(_err(
                f"{where}.depends_on", "bad-value",
                f"gate stage {s.name!r} needs exactly one upstream "
                f"stage to evaluate, got {len(deps)}"))
            return errs
        up = by_name[deps[0]]
        if up.kind != "workload" or up.workload is None:
            errs.append(_err(
                f"{where}.depends_on", "gate-upstream",
                f"gate {s.name!r} must evaluate a workload stage, "
                f"not a {up.kind} stage"))
            return errs
        allowed = GATE_METRICS.get(up.workload.kind, ())
        if s.gate.metric not in allowed:
            errs.append(_err(
                f"{where}.gate.metric", "kind-mismatch",
                f"metric {s.gate.metric!r} is not stamped by "
                f"{up.workload.kind!r} workloads (have: {allowed})"))
        return errs

    def _promote_errors(self, s: StageSpec, where: str,
                        by_name: Dict[str, StageSpec]
                        ) -> List[Dict[str, str]]:
        errs: List[Dict[str, str]] = []
        if s.promote is None:
            errs.append(_err(f"{where}.promote", "missing",
                             "promote stages need a promote target"))
            return errs
        p = s.promote
        src = by_name.get(p.from_stage)
        if src is None:
            errs.append(_err(
                f"{where}.promote.from_stage", "unknown-ref",
                f"promote source {p.from_stage!r} is not a stage"))
        elif (src.kind != "workload" or src.workload is None
                or src.workload.kind != "train"
                or not src.workload.resources.elastic):
            errs.append(_err(
                f"{where}.promote.from_stage", "kind-mismatch",
                f"promote source {p.from_stage!r} must be an elastic "
                "train stage (the checkpointing executor)"))
        tgt = by_name.get(p.target)
        if tgt is None:
            errs.append(_err(
                f"{where}.promote.target", "unknown-ref",
                f"promote target {p.target!r} is not a stage"))
        elif (tgt.kind != "workload" or tgt.workload is None
                or tgt.workload.kind != "serve"
                or not tgt.workload.resources.elastic
                or tgt.workload.serve.replicas < 2):
            errs.append(_err(
                f"{where}.promote.target", "kind-mismatch",
                f"promote target {p.target!r} must be an elastic serve "
                "stage with replicas >= 2 (a rolling promotion needs a "
                "fleet to roll)"))
        if (src is not None and tgt is not None
                and src.workload is not None and tgt.workload is not None
                and src.workload.arch != tgt.workload.arch):
            errs.append(_err(
                f"{where}.promote", "arch-mismatch",
                f"cannot promote {src.workload.arch!r} params into a "
                f"{tgt.workload.arch!r} fleet"))
        return errs

    def _cycle_errors(self, by_name: Dict[str, StageSpec]
                      ) -> List[Dict[str, str]]:
        """Kahn's algorithm over the known-name subgraph: whatever
        cannot be topologically ordered sits on a cycle."""
        indeg = {n: 0 for n in by_name}
        out: Dict[str, List[str]] = {n: [] for n in by_name}
        for s in by_name.values():
            for dep in s.depends_on:
                if dep in by_name and dep != s.name:
                    indeg[s.name] += 1
                    out[dep].append(s.name)
        ready = [n for n, d in indeg.items() if d == 0]
        seen = 0
        while ready:
            n = ready.pop()
            seen += 1
            for m in out[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    ready.append(m)
        if seen == len(by_name):
            return []
        stuck = sorted(n for n, d in indeg.items() if d > 0)
        return [_err("stages", "cycle",
                     f"dependency cycle through stages {stuck}")]

    def validate(self, *, known_arch: bool = True) -> "PipelineSpec":
        errs = self.errors(known_arch=known_arch)
        if errs:
            raise SpecError(errs)
        return self

    # -- topology helpers (the reconciler's view) ---------------------------
    def stage(self, name: str) -> StageSpec:
        for s in self.stages:
            if s.name == name:
                return s
        raise KeyError(name)

    def downstream(self, name: str) -> List[str]:
        """Transitive descendants of ``name`` (skip propagation set)."""
        out: Dict[str, List[str]] = {s.name: [] for s in self.stages}
        for s in self.stages:
            for dep in s.depends_on:
                if dep in out:
                    out[dep].append(s.name)
        seen: List[str] = []
        frontier = list(out.get(name, ()))
        while frontier:
            n = frontier.pop()
            if n in seen:
                continue
            seen.append(n)
            frontier.extend(out[n])
        return sorted(seen)
