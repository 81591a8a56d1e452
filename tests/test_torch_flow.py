"""The port's pipeline layer (``repro_torch.flow``), its elastic fleet
with canary promotion (``ElasticFleetServeExecutor``), its export
(``repro_torch.obs.export``) and ``launch.pipeline``, against the JAX
package, on the CPU.  The invariants of ``tests/test_flow.py``:

* a PipelineSpec round-trips through ``to_dict``/``from_dict``, and a
  document of one package loads in the other;
* validation collects every problem into one SpecError, and the port's
  error list equals the reference's for the same document (cycles,
  refs, triggers, gate/promote compatibility, unknown keys);
* the DAG walk (fan-out/fan-in, retries, a failure skipping its
  descendants, ``on_failure: continue``, gates, triggers, races) gives
  the reference's pipeline event log exactly: stages run on the
  simulated clock and every executor here has a fixed measure;
* canary promotion rolls new params into a live fleet replica by
  replica, with zero dropped requests and each stream's tokens before
  its replica's swap equal to an unpromoted run's, and its records
  (replicas, swap times, requests in flight and their progress) equal
  the reference's;
* ``spans_from_pipeline`` gives the reference's spans, and the port's
  exports pass ``tools/validate_trace.py`` unchanged.

Event logs are compared without job ids (each package numbers its own),
meshes ((1, 1) on the port's one device, ROADMAP Queue 3) and losses
(each package draws its parameters from its own generator).
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.flow as jflow  # noqa: E402
import repro.spec as jspec  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.flow as tflow  # noqa: E402
import repro_torch.spec as tspec  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
_TINY = dict(name="tiny-flow", family="dense", n_layers=2, d_model=32,
             n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128)
JTINY, TINY = JModelConfig(**_TINY), ModelConfig(**_TINY)
CPU = dict(device="cpu")
MAX_NEW = 24
PKGS = {"jax": (jcore, jspec, jflow, JTINY, {}),
        "torch": (tcore, tspec, tflow, TINY, CPU)}


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads a test (xdist runs six workers on eight cores;
    a thread a core each oversubscribes them), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _need_8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 JAX devices (conftest forces them)")


def _cluster(pkg, n_pods=1, hosts_per_pod=4, size=4, max_size=4,
             chips_per_host=2, seed=0):
    core = PKGS[pkg][0]
    clock = core.SimClock(seed=seed)
    mc = core.FluxMiniCluster(clock, core.NetModel(),
                              core.ResourceGraph(n_pods=n_pods,
                                                 hosts_per_pod=hosts_per_pod,
                                                 chips_per_host=chips_per_host),
                              core.MiniClusterSpec(name="flow", size=size,
                                                   max_size=max_size))
    mc.create()
    mc.wait_ready()
    return clock, mc


def _run_until(clock, cond, horizon=100_000.0):
    clock.run(until=clock.now + horizon, stop_when=cond)
    assert cond(), "sim condition not reached within horizon"


def _dryrun(name="d", n_nodes=1):
    return dict(kind="dryrun", arch="lammps-proxy", name=name,
                resources=dict(n_nodes=n_nodes))


def _train(total_steps=4):
    return dict(kind="train", arch="yi-6b", name="flow-train",
                resources=dict(n_nodes=2, elastic=True),
                train=dict(total_steps=total_steps, global_batch=8,
                           seq_len=32, chunk_steps=2))


def _fleet(replicas=2, n_requests=4):
    return dict(kind="serve", arch="yi-6b", name="flow-fleet",
                resources=dict(n_nodes=1, elastic=True),
                serve=dict(n_slots=2, page_size=8, max_prompt_len=24,
                           max_seq_len=40, max_new=MAX_NEW,
                           n_requests=n_requests, replicas=replicas,
                           tenant="canary"))


def _stage(name, kind="workload", **kw):
    return dict(name=name, kind=kind, **kw)


def _pipe(pkg, name, stages):
    """A PipelineSpec of ``pkg`` from its document."""
    return PKGS[pkg][2].PipelineSpec.from_dict(dict(name=name, stages=stages))


def _canary(gate_value=50.0):
    return [_stage("fleet", workload=_fleet()),
            _stage("train", workload=_train()),
            _stage("eval-gate", "gate", depends_on=["train"],
                   gate=dict(metric="final_loss", op="lt", value=gate_value)),
            _stage("promote", "promote", depends_on=["eval-gate"],
                   promote=dict(from_stage="train", target="fleet"))]


def _canary_opts(pkg):
    cfg, opts = PKGS[pkg][3], PKGS[pkg][4]
    # serve ticks dominate the sim timeline so the train checkpoint
    # lands while the fleet is mid-decode
    return {"fleet": {"cfg": cfg, "executor_opts": dict(sim_tick_time=5.0,
                                                        **opts)},
            "train": {"cfg": cfg, "executor_opts": dict(sim_step_time=1.0,
                                                        **opts)}}


def _events(h):
    """A pipeline's (or a workload's) event log without job ids, meshes
    and a gate's loss value (each package draws its parameters from its
    own generator: the control flow is the same, the numbers differ)."""
    return [{k: v for k, v in e.items() if k not in ("jobid", "mesh",
                                                     "value")}
            for e in h.events()]


def _both(fn):
    return fn("torch"), fn("jax")


# ---------------------------------------------------------------------------
# Serialization + validation
# ---------------------------------------------------------------------------


def test_pipeline_round_trips_through_dict_and_across_packages():
    stages = _canary()
    stages[1]["trigger"] = dict(on="cron", every=100.0, offset=10.0, count=3)
    stages[1]["max_retries"] = 2
    stages[1]["on_failure"] = "continue"
    p = _pipe("torch", "canary", stages)
    q = tflow.PipelineSpec.from_dict(p.to_dict())
    assert q == p and q.to_dict() == p.to_dict()
    jp = _pipe("jax", "canary", stages)
    assert jp.to_dict() == p.to_dict()
    assert tflow.PipelineSpec.from_dict(jp.to_dict()) == p


def test_committed_example_pipeline_is_valid_through_the_port_loader():
    path = os.path.join(ROOT, "examples", "specs", "pipeline_canary.json")
    pspec, errors = tflow.check_pipeline(path)
    assert errors == []
    assert [s.kind for s in pspec.stages] == ["workload", "workload",
                                              "gate", "promote"]
    with open(path) as f:
        doc = json.load(f)
    assert tflow.is_pipeline_doc(doc)
    assert tflow.load_pipeline(path).to_dict() == \
        jflow.load_pipeline(path).to_dict()


def _errors_of(pkg, doc):
    flow, spec = PKGS[pkg][2], PKGS[pkg][1]
    try:
        p = flow.PipelineSpec.from_dict(doc)
    except spec.SpecError as exc:
        return exc.errors
    return p.errors()


BAD_DOCS = {
    "unknown-keys": dict(name="c", surprise=1, stages=[
        dict(_stage("fleet", workload=_fleet()), bogus=2),
        _stage("train", workload=_train()),
        _stage("g", "gate", depends_on=["train"],
               gate=dict(metric="final_loss", op="lt", value=1.0, typo=3))]),
    "cycles-refs-triggers": dict(name="bad", stages=[
        _stage("a", workload=_dryrun(), depends_on=["b"]),
        _stage("b", workload=_dryrun(), depends_on=["a"]),
        _stage("c", workload=_dryrun(), depends_on=["ghost"],
               trigger=dict(on="hourly")),
        _stage("c", "mystery")]),
    "gate-kind": dict(name="g", stages=[
        _stage("train", workload=_train()),
        _stage("gate", "gate", depends_on=["train"],
               gate=dict(metric="ttft_mean_s", op="lt", value=1.0))]),
    "promote-kind": dict(name="p", stages=[
        _stage("d", workload=_dryrun()),
        _stage("solo", workload=_fleet(replicas=1)),
        _stage("promote", "promote", depends_on=["d"],
               promote=dict(from_stage="d", target="solo"))]),
}


@pytest.mark.parametrize("name", BAD_DOCS)
def test_spec_errors_equal_the_references(name):
    got, want = _both(lambda pkg: _errors_of(pkg, BAD_DOCS[name]))
    assert got == want and got
    codes = {e["code"] for e in got}
    fields = {e["field"] for e in got}
    if name == "unknown-keys":
        assert {"surprise", "stages[0].bogus", "stages[2].gate.typo"} <= fields
    elif name == "cycles-refs-triggers":
        assert {"cycle", "unknown-ref", "unknown-trigger", "unknown-kind",
                "duplicate"} <= codes
    elif name == "gate-kind":
        assert any(e["code"] == "kind-mismatch" and "gate.metric" in
                   e["field"] for e in got)
    else:
        assert any("promote.from_stage" in f for f in fields)
        assert any("promote.target" in f for f in fields)


def test_apply_rejects_invalid_pipeline_with_all_errors():
    def run(pkg):
        _, mc = _cluster(pkg)
        p = _pipe(pkg, "bad", [
            _stage("a", workload=_dryrun(), depends_on=["a"]),
            _stage("b", "gate", depends_on=["a"], gate=dict(metric="nope"))])
        with pytest.raises(PKGS[pkg][1].SpecError) as exc:
            mc.apply_pipeline(p, executor_opts=PKGS[pkg][4] or None)
        assert mc.instance._pipelines.handles == {}
        return exc.value.errors
    got, want = _both(run)
    assert got == want and len(got) >= 2


# ---------------------------------------------------------------------------
# DAG walk: fan-out/fan-in, retries, failure propagation
# ---------------------------------------------------------------------------


def _apply_and_run(pkg, name, stages, **kw):
    clock, mc = _cluster(pkg)
    h = mc.apply_pipeline(_pipe(pkg, name, stages),
                          executor_opts=PKGS[pkg][4] or None, **kw)
    _run_until(clock, lambda: h.done)
    return h


def test_dag_fan_out_fan_in_completes_in_dependency_order():
    stages = [_stage("a", workload=_dryrun("a")),
              _stage("b", workload=_dryrun("b"), depends_on=["a"]),
              _stage("c", workload=_dryrun("c"), depends_on=["a"]),
              _stage("d", workload=_dryrun("d"), depends_on=["b", "c"])]
    h, jh = _both(lambda pkg: _apply_and_run(pkg, "diamond", stages))
    assert isinstance(h, tflow.PipelineHandle)
    assert h.phase == "Completed"
    assert all(st.phase == "Completed" for st in h.stages.values())
    assert h.stages["d"].t_started >= h.stages["b"].t_done
    assert h.stages["d"].t_started >= h.stages["c"].t_done
    assert all(len(st.handles) == 1 for st in h.stages.values())
    assert h.stages["a"].result["n_devices"] >= 1
    assert h.stages["a"].handle.result()["outcome"] == "completed"
    assert _events(h) == _events(jh)


class _Flaky:
    """Executor that fails the first ``n_failures`` runs."""

    def __init__(self, clock, n_failures):
        self.clock = clock
        self.n_failures = n_failures
        self.calls = 0
        self.ran = {}

    def __call__(self, job, rset, done):
        self.calls += 1
        if self.calls <= self.n_failures:
            self.clock.call_in(1.0, done, "failed", 1.0)
        else:
            self.ran[job.jobid] = {"mesh_shape": (1,), "n_devices": 1}
            self.clock.call_in(1.0, done, "completed", 1.0)


def _flaky_run(monkeypatch, pkg, n_failures, stages):
    reconciler = {"jax": "repro.spec.reconcile",
                  "torch": "repro_torch.spec.reconcile"}[pkg]
    import importlib
    wr = importlib.import_module(reconciler).WorkloadReconciler
    holder = {}

    def executor_for(self, *a, **k):
        if "flaky" not in holder:
            holder["flaky"] = _Flaky(self.instance.clock, n_failures)
        return holder["flaky"]

    monkeypatch.setattr(wr, "_executor_for", executor_for)
    h = _apply_and_run(pkg, "flaky", stages)
    return h, holder["flaky"]


def test_failed_run_retries_up_to_max_retries(monkeypatch):
    stages = [_stage("a", workload=_dryrun(), max_retries=1)]
    (h, flaky), (jh, _) = _both(
        lambda pkg: _flaky_run(monkeypatch, pkg, 1, stages))
    assert h.phase == "Completed"
    st = h.stages["a"]
    assert st.attempts == 2 and flaky.calls == 2 and len(st.handles) == 2
    assert any(e["phase"] == "retry" for e in h.events())
    assert _events(h) == _events(jh)


def test_failure_marks_descendants_skipped_never_failed(monkeypatch):
    stages = [_stage("a", workload=_dryrun()),
              _stage("b", workload=_dryrun(), depends_on=["a"]),
              _stage("c", workload=_dryrun(), depends_on=["b"])]
    (h, _), (jh, _) = _both(
        lambda pkg: _flaky_run(monkeypatch, pkg, 99, stages))
    assert [h.stages[n].phase for n in "abc"] == ["Failed", "Skipped",
                                                  "Skipped"]
    assert h.phase == "Failed"                  # on_failure="fail"
    assert _events(h) == _events(jh)


def test_on_failure_continue_keeps_pipeline_green(monkeypatch):
    stages = [_stage("a", workload=_dryrun(), on_failure="continue")]
    (h, _), (jh, _) = _both(
        lambda pkg: _flaky_run(monkeypatch, pkg, 99, stages))
    assert h.stages["a"].phase == "Failed" and h.phase == "Completed"
    assert _events(h) == _events(jh)


# ---------------------------------------------------------------------------
# Gates read stamped results
# ---------------------------------------------------------------------------


def test_gate_reads_stamped_train_result_and_passes():
    _need_8()
    stages = [_stage("train", workload=_train()),
              _stage("gate", "gate", depends_on=["train"],
                     gate=dict(metric="final_loss", op="lt", value=50.0)),
              _stage("after", workload=_dryrun(), depends_on=["gate"])]

    def run(pkg):
        return _apply_and_run(pkg, "gated", stages, stage_opts={
            "train": {"cfg": PKGS[pkg][3], "executor_opts": dict(
                sim_step_time=1.0, **PKGS[pkg][4])}})
    h, jh = _both(run)
    assert h.phase == "Completed"
    res = h.stages["train"].handle.result()
    assert res["kind"] == "train" and res["steps"] == 4
    assert isinstance(res["final_loss"], float)
    g = h.stages["gate"].result
    assert g["passed"] is True and g["value"] == res["final_loss"]
    assert h.stages["after"].phase == "Completed"
    assert _events(h) == _events(jh)


# ---------------------------------------------------------------------------
# Canary promotion into a LIVE fleet
# ---------------------------------------------------------------------------


def _canary_run(pkg, gate_value=50.0):
    clock, mc = _cluster(pkg)
    control = mc.apply(PKGS[pkg][1].WorkloadSpec.from_dict(_fleet()),
                       cfg=PKGS[pkg][3],
                       executor_opts=dict(sim_tick_time=5.0, **PKGS[pkg][4]))
    _run_until(clock, lambda: control.job.state == PKGS[pkg][0].JobState.INACTIVE)
    assert control.phase == "Completed"
    clock2, mc2 = _cluster(pkg)
    h = mc2.apply_pipeline(_pipe(pkg, "canary", _canary(gate_value)),
                           stage_opts=_canary_opts(pkg))
    _run_until(clock2, lambda: h.done)
    assert h.phase == "Completed", h.status()
    fwh = h.stages["fleet"].handle
    return {"control": control.executor.ran[control.job.jobid],
            "handle": h,
            "fleet": fwh.executor.ran[fwh.job.jobid],
            "promo": h.stages["promote"].result,
            "session": fwh.executor.sessions[fwh.job.jobid]}


@pytest.fixture(scope="module")
def canary():
    _need_8()
    return _canary_run("torch"), _canary_run("jax")


def test_canary_promotion_drops_zero_requests(canary):
    got, _ = canary
    promo, rec = got["promo"], got["fleet"]
    assert got["handle"].stages["promote"].phase == "Completed"
    assert type(got["handle"].stages["fleet"].handle.executor).__name__ == \
        "ElasticFleetServeExecutor"
    # promotion landed mid-decode on a busy fleet...
    assert promo["in_flight_at_begin"] > 0
    assert promo["replicas"] == 2 and len(promo["steps"]) == 2
    assert promo["sim_promote_s"] > 0
    # ...and every request still finished with its full token budget
    assert rec["n_requests"] == 4
    assert [len(t) for t in rec["tokens"]] == [MAX_NEW] * 4
    assert rec["version"] == promo["to_version"] == 1
    assert len(rec["promotions"]) == 1


def test_canary_prefix_identity_on_unpromoted_replicas(canary):
    """Tokens generated before a request's replica was swapped came from
    the old params: they equal the never-promoted control run's."""
    got, _ = canary
    control, promoted = got["control"]["tokens"], got["fleet"]["tokens"]
    rid_to_idx = {r.rid: i for i, r in enumerate(got["session"].requests)}
    checked = 0
    for step in got["promo"]["steps"]:
        for rid, n_at_swap in step["token_progress"].items():
            i = rid_to_idx[rid]
            assert promoted[i][:n_at_swap] == control[i][:n_at_swap]
            assert n_at_swap < MAX_NEW      # genuinely mid-decode
            checked += 1
    assert checked > 0
    # the roll changed what the fleet serves (new params)
    assert promoted != control


def test_canary_records_and_events_equal_jax(canary):
    got, want = canary
    keys = ("replicas", "replicas_at_begin", "in_flight_at_begin",
            "from_version", "to_version", "t_begin_sim", "t_done_sim",
            "sim_promote_s")
    assert {k: got["promo"][k] for k in keys} == \
        {k: want["promo"][k] for k in keys}

    def steps(promo):
        return [(s["replica"], s["t_sim"], s["in_flight"], s["waiting"],
                 sorted(s["token_progress"].values())) for s in promo["steps"]]
    assert steps(got["promo"]) == steps(want["promo"])
    assert _events(got["handle"]) == _events(want["handle"])
    for k in ("n_requests", "n_tokens", "ticks", "version", "assignments",
              "replicas", "hosts", "n_prefills"):
        assert got["fleet"][k] == want["fleet"][k], k


def test_promoted_replicas_serve_the_new_params():
    """After a promotion a request is served by a promoted replica: its
    stream equals a direct Engine's over the promoted params."""
    clock, mc = _cluster("torch")
    h = mc.apply(tspec.WorkloadSpec.from_dict(_fleet(n_requests=2)),
                 cfg=TINY, executor_opts=dict(sim_tick_time=5.0, **CPU))
    ex, job = h.executor, h.job
    _run_until(clock, lambda: job.jobid in ex.sessions
               and ex.sessions[job.jobid].ticks >= 2)
    from repro_torch.models import params as P
    from repro_torch.models.model import Model
    # float32 params, as a train state holds them; the fleet takes them
    # in its engines' dtypes
    new = Model(TINY).init(torch.Generator().manual_seed(7), device="cpu")
    done = []
    rec = ex.promote(job, new, note="t", on_done=done.append)
    _run_until(clock, lambda: done)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    req = h.submit_request(prompt, max_new_tokens=MAX_NEW)
    _run_until(clock, lambda: h.done)
    from repro_torch.core.executor import serving_params
    direct = Engine(TINY, h.spec.engine_config(), device="cpu",
                    params=serving_params(TINY, new, "cpu"))
    want = direct.submit(prompt, max_new_tokens=MAX_NEW)
    direct.run()
    assert req.tokens == want.tokens and len(req.tokens) == MAX_NEW
    assert rec["steps"] and ex.ran[job.jobid]["version"] == 1
    ses = ex.sessions[job.jobid]
    a, b = ses.router.engines
    # the promotion's params went to the device once, for both replicas
    assert all(x.data_ptr() == y.data_ptr() for x, y in
               zip(*(P.tree_leaves(e.params) for e in (a, b))))


def test_failed_gate_skips_promotion_and_leaves_fleet_untouched():
    _need_8()

    def run(pkg):
        clock, mc = _cluster(pkg)
        h = mc.apply_pipeline(_pipe(pkg, "canary", _canary(gate_value=-1.0)),
                              stage_opts=_canary_opts(pkg))
        _run_until(clock, lambda: h.done)
        return h
    h, jh = _both(run)
    assert h.phase == "Completed"
    gate = h.stages["eval-gate"]
    assert gate.phase == "Completed" and gate.result["passed"] is False
    assert h.stages["promote"].phase == "Skipped"
    fwh = h.stages["fleet"].handle
    rec = fwh.executor.ran[fwh.job.jobid]
    assert rec["version"] == 0 and rec["promotions"] == []
    assert [len(t) for t in rec["tokens"]] == [MAX_NEW] * 4
    assert _events(h) == _events(jh)


def test_elastic_fleet_scale_up_and_promote_events_equal_jax():
    """A grow adds replicas live (``_try_scale``), then a promotion rolls
    every replica: the handle's events, the scale events and the
    promotion record equal the reference executor's."""
    _need_8()

    def run(pkg):
        core, spec, _, cfg, opts = PKGS[pkg]
        clock, mc = _cluster(pkg, size=2, max_size=4)
        h = mc.apply(spec.WorkloadSpec.from_dict(_fleet(n_requests=6)),
                     cfg=cfg, executor_opts=dict(sim_tick_time=5.0, **opts))
        ex, job = h.executor, h.job
        _run_until(clock, lambda: job.jobid in ex.sessions
                   and ex.sessions[job.jobid].ticks >= 2)
        mc.patch_size(4)
        assert h.phase == "Resizing"
        _run_until(clock, lambda: len(ex.sessions[job.jobid]
                                      .router.engines) == 4)
        ses = ex.sessions[job.jobid]
        params = ses.params             # promote the fleet's own params
        done = []
        ex.promote(job, params, note="again", on_done=done.append)
        _run_until(clock, lambda: h.done)
        return h, ses, done[0]
    (h, ses, promo), (jh, jses, jpromo) = _both(run)
    assert h.phase == "Completed" and len(ses.router.engines) == 4
    assert [e["replicas"] for e in ses.scale_events] == [3, 4]
    assert [{k: v for k, v in e.items()} for e in ses.scale_events] == \
        jses.scale_events
    assert len(promo["steps"]) == 4
    assert [(s["replica"], s["t_sim"], s["in_flight"]) for s in
            promo["steps"]] == [(s["replica"], s["t_sim"], s["in_flight"])
                                for s in jpromo["steps"]]
    assert _events(h) == _events(jh)
    rec = h.executor.ran[h.job.jobid]
    assert rec["mesh_shapes"] == [(1, 1)] * 4
    assert all(len(t) == MAX_NEW for t in rec["tokens"])


# ---------------------------------------------------------------------------
# Triggers: deterministic on the SimClock; no double submission
# ---------------------------------------------------------------------------


def _running_times(handle, stage):
    return [e["t"] for e in handle.events()
            if e.get("stage") == stage and e["phase"] == "Running"]


def test_interval_trigger_fires_on_the_sim_grid():
    stages = [_stage("a", workload=_dryrun(),
                     trigger=dict(on="interval", every=60.0, count=2))]
    h, jh = _both(lambda pkg: _apply_and_run(pkg, "tick", stages))
    t_armed = next(e["t"] for e in h.events()
                   if e.get("stage") == "a" and e["phase"] == "armed")
    assert h.phase == "Completed"
    st = h.stages["a"]
    assert st.fires == 2 and len(st.handles) == 2
    assert _running_times(h, "a") == [t_armed + 60.0, t_armed + 120.0]
    assert _events(h) == _events(jh)


def test_cron_trigger_aligns_to_absolute_grid():
    stages = [_stage("a", workload=_dryrun(),
                     trigger=dict(on="cron", every=100.0, count=1))]
    h, jh = _both(lambda pkg: _apply_and_run(pkg, "cron", stages))
    (t_fire,) = _running_times(h, "a")
    assert t_fire % 100.0 == 0.0 and h.stages["a"].fires == 1
    assert _events(h) == _events(jh)


def test_trigger_racing_manual_fire_submits_once():
    def run(pkg):
        clock, mc = _cluster(pkg)
        h = mc.apply_pipeline(_pipe(pkg, "race", [
            _stage("a", workload=_dryrun(),
                   trigger=dict(on="interval", every=50.0, count=1))]),
            executor_opts=PKGS[pkg][4] or None)
        t_armed = next(e["t"] for e in h.events()
                       if e.get("stage") == "a" and e["phase"] == "armed")
        clock.call_at(t_armed + 50.0, h.fire, "a")
        _run_until(clock, lambda: h.done)
        return h
    h, jh = _both(run)
    st = h.stages["a"]
    assert st.fires == 1 and len(st.handles) == 1
    assert [e.get("reason") for e in h.events() if e.get("stage") == "a"
            and e["phase"] == "fire_suppressed"]
    assert _events(h) == _events(jh)


def test_manual_fire_while_running_is_suppressed():
    clock, mc = _cluster("torch")
    h = mc.apply_pipeline(_pipe("torch", "live", [
        _stage("a", workload=_train())]), stage_opts={
        "a": {"cfg": TINY, "executor_opts": dict(sim_step_time=5.0, **CPU)}})
    _run_until(clock, lambda: h.stages["a"].phase == "Running")
    assert h.fire("a") is False              # run still live
    _run_until(clock, lambda: h.done)
    assert h.stages["a"].fires == 1 and len(h.stages["a"].handles) == 1


# ---------------------------------------------------------------------------
# Observability: pipeline spans and the port's exports
# ---------------------------------------------------------------------------


def _spans(pkg):
    obs = __import__({"jax": "repro.obs", "torch": "repro_torch.obs"}[pkg],
                     fromlist=["x"])
    h = _apply_and_run(pkg, "obs", [
        _stage("a", workload=_dryrun("a")),
        _stage("b", workload=_dryrun("b"), depends_on=["a"])])
    tr = obs.Tracer()
    spans = obs.spans_from_pipeline(h, tr)
    return h, tr, [(sp.name, sp.trace, sp.t_start, sp.t_end,
                    {k: v for k, v in sp.attrs.items()
                     if k not in ("jobid", "mesh")}) for sp in spans]


def test_spans_from_pipeline_equal_the_references():
    (h, tr, spans), (_, _, jspans) = _both(_spans)
    assert spans == jspans
    pid = h.pid
    assert {s[1] for s in spans} == {f"pipe-{pid}", f"pipe-{pid}/a",
                                     f"pipe-{pid}/b"}
    assert {"running", "completed"} <= {s[0] for s in spans
                                        if s[1] == f"pipe-{pid}/a"}
    from repro_torch.obs import to_chrome_trace
    doc = to_chrome_trace(tr, meta={})
    assert any(ev.get("ph") == "X" for ev in doc["traceEvents"])


def test_port_exports_pass_validate_trace(tmp_path):
    from repro_torch import obs
    h, tr, _ = _spans("torch")
    for st in h.stages.values():
        for wh in st.handles:
            obs.spans_from_handle(wh, tr)
    obs.events_from_sim(h._reconciler.clock, tr)
    obs.write_chrome_trace(str(tmp_path / "TRACE_x.json"), tr)
    obs.write_jsonl(str(tmp_path / "TRACE_x.jsonl"), tr)
    reg = obs.MetricsRegistry()
    reg.inc("pipeline_stage_phase_total", stage="a", phase="Completed")
    obs.write_metrics(str(tmp_path / "METRICS_x.json"), reg)
    prov = obs.provenance()
    assert prov["backend"] == "cpu" and prov["jax_version"] == "none"
    assert prov["torch_version"] == torch.__version__
    run = subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                       "validate_trace.py"),
                          *(str(p) for p in sorted(tmp_path.iterdir()))],
                         capture_output=True, text=True)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "all 3 artifact(s) well-formed" in run.stdout


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_pipeline_launcher_check_and_a_cpu_run(capsys, tmp_path):
    from repro_torch.launch import pipeline
    path = os.path.join(ROOT, "examples", "specs", "pipeline_canary.json")
    pipeline.main(["--pipeline", path, "--check"])
    assert capsys.readouterr().out.startswith(f"OK {path}: 4 stages")
    trace = str(tmp_path / "TRACE_pipeline.json")
    with pytest.raises(SystemExit) as exc:
        pipeline.main(["--pipeline", path, "--device", "cpu",
                       "--trace", trace])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    status = json.loads(out[out.index("{"):out.rindex("}") + 1])
    assert status["phase"] == "Completed"
    assert status["stages"]["promote"]["phase"] == "Completed"
    run = subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                       "validate_trace.py"),
                          trace], capture_output=True, text=True)
    assert run.returncode == 0, run.stdout + run.stderr


def test_pipeline_launcher_check_rejects_a_bad_pipeline(capsys, tmp_path):
    from repro_torch.launch import pipeline
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(dict(kind="pipeline", **BAD_DOCS[
        "cycles-refs-triggers"])))
    with pytest.raises(SystemExit) as exc:
        pipeline.main(["--pipeline", str(bad), "--check"])
    assert exc.value.code == 1
    assert capsys.readouterr().out.startswith(f"INVALID {bad}")
