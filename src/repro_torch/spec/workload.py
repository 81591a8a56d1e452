"""The declarative WorkloadSpec: one CRD-style spec for every executor.

The Flux Operator's central artifact is a declarative custom resource —
a user writes a spec, a reconciler converges the system to it.  This
module is that artifact for *workloads*: a validated, serializable
``WorkloadSpec`` (kind ``train`` | ``serve`` | ``dryrun``) that
``FluxInstance.apply`` reconciles into the right executor, replacing
the three imperative ``attach_*_executor`` entry points.

Design rules:

* **Serializable round-trip.**  ``WorkloadSpec.from_dict(s.to_dict())
  == s`` for every valid spec (property-pinned).  A custom
  ``ShardingStrategy`` serializes as its field dict; the named
  strategies serialize as their name.
* **Fail at submit, not at first step.**  ``validate()`` collects ALL
  structural errors into one :class:`SpecError` whose ``errors`` list
  is structured (``{"field", "code", "message"}``) — a bad spec never
  reaches the scheduler.  Cluster-aware checks (capacity, comm policy
  under ``comm_strict``) live in :mod:`repro_torch.spec.reconcile` and reuse
  ``comm.resolve_policy`` / ``sharding.submesh_for`` so the validator
  and the train step can never disagree.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

from repro_torch.configs.base import STRATEGIES, ShardingStrategy

KINDS = ("train", "serve", "dryrun")


class SpecError(ValueError):
    """A WorkloadSpec failed validation; ``errors`` is the structured
    list (every problem, not just the first)."""

    def __init__(self, errors: List[Dict[str, str]]):
        self.errors = list(errors)
        lines = [f"  - {e['field']}: {e['message']} [{e['code']}]"
                 for e in self.errors]
        super().__init__(
            "invalid WorkloadSpec (%d error%s):\n%s" % (
                len(self.errors), "s" if len(self.errors) != 1 else "",
                "\n".join(lines)))


def _err(field_: str, code: str, message: str) -> Dict[str, str]:
    return {"field": field_, "code": code, "message": message}


def _check_num(errs: List[Dict[str, str]], field_: str, value,
               minv) -> bool:
    """Append a structured error when ``value`` is not a number >=
    ``minv``; wrong TYPES report ``bad-type`` instead of raising (a
    drifted JSON spec must lint, not traceback).  Returns True when
    the value is usable for derived arithmetic."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        errs.append(_err(field_, "bad-type",
                         f"{field_.split('.')[-1]} must be a number, "
                         f"got {type(value).__name__}"))
        return False
    if value < minv:
        errs.append(_err(field_, "bad-value",
                         f"{field_.split('.')[-1]} must be >= {minv}"))
        return False
    return True


# --------------------------------------------------------------------------
# Sub-specs
# --------------------------------------------------------------------------


@dataclass
class ResourceSpec:
    """Resource request: hosts, pod locality, elasticity."""

    n_nodes: int = 1
    # pack the allocation into one pod when it fits (the Fluxion
    # hierarchy heuristic; cross-pod links are the contended resource)
    pod_local: bool = True
    # survive MiniCluster grow/shrink (train: checkpoint/remesh/restore;
    # serve: park in-flight slots, rebuild the engine on the new submesh)
    elastic: bool = False


@dataclass
class TrainSpec:
    """Train-kind knobs (ignored by other kinds)."""

    total_steps: int = 8
    global_batch: int = 8
    seq_len: int = 32
    chunk_steps: int = 1          # steps per scheduler chunk when elastic
    ckpt_dir: Optional[str] = None


@dataclass
class ServeSpec:
    """Serve-kind knobs: the engine's fixed shapes + request defaults."""

    n_slots: int = 4
    max_new: int = 4
    temperature: float = 0.0
    page_size: int = 8
    max_prompt_len: int = 16
    max_seq_len: int = 64
    n_pages: int = 0              # 0 -> every slot can reach max_seq_len
    n_requests: int = 2           # synthetic batch when no prompts given
    prefill_chunk: int = 0        # >0: chunked prefill inside decode ticks
    dp_shards: int = 1            # page-pool shards over the data tier
    replicas: int = 1             # >1: a Router over N engine replicas
    tenant: str = "default"       # fair-admission bucket for the batch
    ttft_slo_s: float = 0.0       # 0 -> no TTFT target (dispatch order)


@dataclass
class DryRunSpec:
    """Dryrun-kind knobs: which named shape/mesh cell to validate."""

    shape: str = "train_4k"
    multi_pod: bool = False


# --------------------------------------------------------------------------
# The spec
# --------------------------------------------------------------------------


@dataclass
class WorkloadSpec:
    """One declarative workload; ``FluxInstance.apply`` reconciles it."""

    kind: str = "train"
    arch: str = "lammps-proxy"            # config-registry id
    name: str = ""
    # a named strategy ("baseline" | "optimized" | "zero3") or a full
    # ShardingStrategy (serialized as its field dict)
    strategy: Union[str, ShardingStrategy] = "baseline"
    resources: ResourceSpec = field(default_factory=ResourceSpec)
    train: TrainSpec = field(default_factory=TrainSpec)
    serve: ServeSpec = field(default_factory=ServeSpec)
    dryrun: DryRunSpec = field(default_factory=DryRunSpec)
    walltime: float = 1e9
    user: str = "flux"
    urgency: int = 16

    # -- strategy resolution ------------------------------------------------
    @property
    def resolved_strategy(self) -> ShardingStrategy:
        if isinstance(self.strategy, ShardingStrategy):
            return self.strategy
        return STRATEGIES[self.strategy]

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "kind": self.kind,
            "arch": self.arch,
            "name": self.name,
            "strategy": (dataclasses.asdict(self.strategy)
                         if isinstance(self.strategy, ShardingStrategy)
                         else self.strategy),
            "resources": dataclasses.asdict(self.resources),
            "train": dataclasses.asdict(self.train),
            "serve": dataclasses.asdict(self.serve),
            "dryrun": dataclasses.asdict(self.dryrun),
            "walltime": self.walltime,
            "user": self.user,
            "urgency": self.urgency,
        }
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WorkloadSpec":
        """Strict constructor: unknown keys anywhere are structured
        errors, not silent drops — a committed spec cannot drift."""
        errors: List[Dict[str, str]] = []
        d = dict(d)
        known = {f.name for f in dataclasses.fields(cls)}
        for k in sorted(set(d) - known):
            errors.append(_err(k, "unknown-field",
                               f"unknown WorkloadSpec field {k!r}"))
            d.pop(k)

        def sub(key, klass):
            raw = d.pop(key, None)
            if raw is None:
                return klass()
            if not isinstance(raw, dict):
                errors.append(_err(key, "bad-type",
                                   f"{key} must be an object"))
                return klass()
            names = {f.name for f in dataclasses.fields(klass)}
            for k in sorted(set(raw) - names):
                errors.append(_err(f"{key}.{k}", "unknown-field",
                                   f"unknown {key} field {k!r}"))
            return klass(**{k: v for k, v in raw.items() if k in names})

        resources = sub("resources", ResourceSpec)
        train = sub("train", TrainSpec)
        serve = sub("serve", ServeSpec)
        dryrun = sub("dryrun", DryRunSpec)
        strategy = d.pop("strategy", "baseline")
        if isinstance(strategy, dict):
            names = {f.name for f in dataclasses.fields(ShardingStrategy)}
            for k in sorted(set(strategy) - names):
                errors.append(_err(f"strategy.{k}", "unknown-field",
                                   f"unknown ShardingStrategy field {k!r}"))
            strategy = ShardingStrategy(
                **{k: v for k, v in strategy.items() if k in names})
        elif not isinstance(strategy, (str, ShardingStrategy)):
            errors.append(_err(
                "strategy", "bad-type",
                f"strategy must be a registry name or a "
                f"ShardingStrategy field object, got "
                f"{type(strategy).__name__}"))
            strategy = "baseline"
        if errors:
            raise SpecError(errors)
        return cls(strategy=strategy, resources=resources, train=train,
                   serve=serve, dryrun=dryrun, **d)

    # -- validation ---------------------------------------------------------
    def errors(self, *, known_arch: bool = True) -> List[Dict[str, str]]:
        """All structural problems (empty when the spec is well-formed).

        ``known_arch=False`` skips the registry check — ``apply`` passes
        it when the caller supplies an in-memory config override.
        """
        errs: List[Dict[str, str]] = []
        if self.kind not in KINDS:
            errs.append(_err("kind", "unknown-kind",
                             f"kind {self.kind!r} not in {KINDS}"))
        if known_arch:
            from repro_torch.configs import registry
            if self.arch not in registry.ARCH_IDS + registry.EXTRA_IDS:
                errs.append(_err(
                    "arch", "unknown-config",
                    f"unknown model config {self.arch!r}; known: "
                    f"{registry.ARCH_IDS + registry.EXTRA_IDS}"))
        if isinstance(self.strategy, str):
            if self.strategy not in STRATEGIES:
                errs.append(_err("strategy", "unknown-strategy",
                                 f"unknown strategy {self.strategy!r}; "
                                 f"known: {sorted(STRATEGIES)}"))
        elif not isinstance(self.strategy, ShardingStrategy):
            errs.append(_err(
                "strategy", "bad-type",
                f"strategy must be a registry name or a "
                f"ShardingStrategy, got {type(self.strategy).__name__}"))
        _check_num(errs, "resources.n_nodes", self.resources.n_nodes, 1)
        if _check_num(errs, "walltime", self.walltime, 0) \
                and self.walltime == 0:
            errs.append(_err("walltime", "bad-value",
                             "walltime must be > 0"))
        if _check_num(errs, "urgency", self.urgency, 0) \
                and self.urgency > 31:
            errs.append(_err("urgency", "bad-value",
                             "urgency must be in 0..31 (flux RFC)"))
        if self.kind == "train":
            t = self.train
            for f_, v in [("total_steps", t.total_steps),
                          ("global_batch", t.global_batch),
                          ("seq_len", t.seq_len),
                          ("chunk_steps", t.chunk_steps)]:
                _check_num(errs, f"train.{f_}", v, 1)
        if self.kind == "serve":
            errs.extend(self._serve_errors())
        if self.kind == "dryrun":
            from repro_torch.configs.base import SHAPES
            if self.dryrun.shape not in SHAPES:
                errs.append(_err("dryrun.shape", "unknown-shape",
                                 f"unknown workload shape "
                                 f"{self.dryrun.shape!r}; known: "
                                 f"{sorted(SHAPES)}"))
        return errs

    def _serve_errors(self) -> List[Dict[str, str]]:
        """Engine-shape consistency: the same arithmetic
        ``EngineConfig.layout`` / ``Scheduler.submit`` enforce at run
        time, surfaced as structured submit-time errors."""
        errs: List[Dict[str, str]] = []
        s = self.serve
        ok = True
        for f_, v in [("n_slots", s.n_slots), ("max_new", s.max_new),
                      ("page_size", s.page_size),
                      ("max_prompt_len", s.max_prompt_len),
                      ("max_seq_len", s.max_seq_len),
                      ("n_requests", s.n_requests)]:
            ok = _check_num(errs, f"serve.{f_}", v, 1) and ok
        ok = _check_num(errs, "serve.n_pages", s.n_pages, 0) and ok
        ok = _check_num(errs, "serve.prefill_chunk", s.prefill_chunk, 0) \
            and ok
        ok = _check_num(errs, "serve.dp_shards", s.dp_shards, 1) and ok
        ok = _check_num(errs, "serve.replicas", s.replicas, 1) and ok
        _check_num(errs, "serve.temperature", s.temperature, 0)
        _check_num(errs, "serve.ttft_slo_s", s.ttft_slo_s, 0)
        if not isinstance(s.tenant, str) or not s.tenant:
            errs.append(_err("serve.tenant", "bad-type",
                             "tenant must be a non-empty string"))
        if not ok:
            return errs                 # derived checks need sane values
        if s.dp_shards > 1 and s.n_slots % s.dp_shards:
            errs.append(_err("serve.dp_shards", "bad-value",
                             f"dp_shards={s.dp_shards} must divide "
                             f"n_slots={s.n_slots}"))
        if s.max_seq_len % s.page_size:
            errs.append(_err("serve.max_seq_len", "unaligned",
                             f"max_seq_len={s.max_seq_len} must be a "
                             f"multiple of page_size={s.page_size}"))
        if s.max_prompt_len % s.page_size:
            errs.append(_err("serve.max_prompt_len", "unaligned",
                             f"max_prompt_len={s.max_prompt_len} must be "
                             f"a multiple of page_size={s.page_size}"))
        if s.max_prompt_len > s.max_seq_len:
            errs.append(_err("serve.max_prompt_len", "bad-value",
                             "max_prompt_len exceeds max_seq_len"))
        if s.n_pages:
            usable = s.n_pages - 1      # page 0 is the null page
            if usable < s.n_slots:
                errs.append(_err(
                    "serve.n_slots", "pool-capacity",
                    f"n_slots={s.n_slots} exceeds the page pool: only "
                    f"{usable} usable pages (n_pages={s.n_pages} minus "
                    "the null page) — every admitted slot needs at "
                    "least one page"))
            worst = -(-s.max_seq_len // s.page_size)
            if usable < worst:
                errs.append(_err(
                    "serve.n_pages", "pool-capacity",
                    f"a full-length request needs {worst} pages but the "
                    f"pool has {usable} usable; no request reaching "
                    f"max_seq_len={s.max_seq_len} could ever be "
                    "admitted"))
        return errs

    def validate(self, *, known_arch: bool = True) -> "WorkloadSpec":
        errs = self.errors(known_arch=known_arch)
        if errs:
            raise SpecError(errs)
        return self

    # -- convenience --------------------------------------------------------
    def engine_config(self):
        """The serve spec as an ``EngineConfig`` (serve kind only)."""
        from repro_torch.serve import EngineConfig
        s = self.serve
        return EngineConfig(n_slots=s.n_slots, page_size=s.page_size,
                            max_seq_len=s.max_seq_len,
                            max_prompt_len=s.max_prompt_len,
                            n_pages=s.n_pages,
                            prefill_chunk=s.prefill_chunk,
                            dp_shards=s.dp_shards)
