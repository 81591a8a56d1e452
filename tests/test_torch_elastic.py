"""Elastic training in the port against the JAX package: ``Trainer.remesh``
and the ``ElasticTrainExecutor`` (the invariants of
``tests/test_elastic.py``), on the CPU.

Held against the reference:

* ``Trainer.remesh`` with and without a checkpoint, started from the JAX
  trainer's own initial state (``P.from_numpy``): the losses against
  ``repro.train.Trainer.remesh``'s at 1e-4 relative (float32 compute on
  both sides; only the order of float32 sums differs), and against an
  uninterrupted port run (the same arithmetic on one device: bit-equal);
* a grow 2 -> 4 and a shrink 4 -> 2 through ``FluxMiniCluster.patch_size``
  keep the loss trajectory of an uninterrupted run, for BASELINE and for
  ZERO3 (the port's one-device step takes every strategy);
* the executor's lifecycle events, its ``segments`` and its ``resumes``
  equal the reference executor's field for field, where a field is not
  a wall-clock second or a mesh: every executor has a fixed
  ``sim_step_time``, so no wall clock reaches the simulated timeline.
  Meshes are (1, 1) on the port's one device where the reference spans
  its forced CPU devices (ROADMAP Queue 3);
* the requeue path of a shrink, a no-op re-patch, a node lost before the
  first checkpoint, queued jobs clamped by a shrink, resize events, and
  an autoscaler's resize, each as ``tests/test_elastic.py`` holds it;
* ``launch.train --elastic --device cpu``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.spec as jspec  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.spec as tspec  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.dist import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402

_TINY = dict(name="tiny-elastic", family="dense", n_layers=2, d_model=32,
             n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128)
JTINY, TINY = jbase.ModelConfig(**_TINY), tbase.ModelConfig(**_TINY)
_ZERO3 = dict(name="zero3", fsdp_params=True, tensor_parallel=False)
STRATEGIES = {"baseline": (jbase.BASELINE, tbase.BASELINE),
              "zero3": (jbase.ShardingStrategy(**_ZERO3),
                        tbase.ShardingStrategy(**_ZERO3))}
_SHAPE = dict(name="elastic", kind="train", seq_len=16, global_batch=8)
JSHAPE, SHAPE = jbase.WorkloadShape(**_SHAPE), tbase.WorkloadShape(**_SHAPE)
# float32 compute on both sides: the losses then differ only by the
# order of float32 sums (the reference's meshes shard them)
_TCFG = dict(warmup_steps=0, compute_dtype="float32")
PKGS = {"jax": (jcore, jspec, JTINY), "torch": (tcore, tspec, TINY)}
CPU = dict(device="cpu")
RTOL = 1e-4
TOTAL = 18
SIM_STEP = 20.0
# fields of a record that are wall-clock seconds or a mesh (one device
# here, the forced CPU devices there); every other field must be equal
WALL = ("wall_s", "restore_s", "first_chunk_s", "time_to_resume_s",
        "mesh_shape")


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


def _run_until(clock, cond, horizon=50_000.0):
    """Bounded sim wait: heartbeats keep the event queue alive forever,
    so a missed condition must fail loudly, never hang the suite."""
    clock.run(until=clock.now + horizon, stop_when=cond)
    assert cond(), "sim condition not reached within horizon"


def _jax_state(total_steps, strategy):
    """The reference's initial train state (seed 0) on the host."""
    tcfg = jbase.TrainConfig(total_steps=total_steps, **_TCFG)
    return jax.device_get(jsteps.init_train_state(
        JTINY, tcfg, jax.random.PRNGKey(0), strategy))


def _elastic_cluster(pkg, strategy="baseline", total_steps=TOTAL, size=2,
                     max_size=4):
    """A 2-host MiniCluster (maxSize 4) running one elastic train job,
    applied through the WorkloadSpec path, both packages from the
    reference's initial state, run until the first step has landed."""
    core, spec, cfg = PKGS[pkg]
    strat = STRATEGIES[strategy][pkg == "torch"]
    base = (jbase if pkg == "jax" else tbase)
    clock = core.SimClock(seed=0)
    mc = core.FluxMiniCluster(clock, core.NetModel(),
                              core.ResourceGraph(n_pods=1, hosts_per_pod=4,
                                                 chips_per_host=2),
                              core.MiniClusterSpec(name="el", size=size,
                                                   max_size=max_size))
    mc.create()
    mc.wait_ready()
    opts = dict(sim_step_time=SIM_STEP,
                tcfg=base.TrainConfig(total_steps=total_steps, **_TCFG))
    if pkg == "torch":
        opts.update(CPU)
    h = mc.apply(_train_spec(spec, total_steps), cfg=cfg, strategy=strat,
                 executor_opts=opts)
    ex, job = h.executor, h.job
    if pkg == "torch":
        # the reference's initial state, which the first placement takes
        # as a live state and moves onto its device
        ex._session(job).state = P.from_numpy(
            _jax_state(total_steps, STRATEGIES[strategy][0]))
    _run_until(clock, lambda: job.jobid in ex.sessions
               and ex.sessions[job.jobid].step >= 1)
    return clock, mc, h


def _train_spec(spec, total_steps=TOTAL, n_nodes=2):
    return spec.WorkloadSpec(
        kind="train", arch="tiny-elastic",
        resources=spec.ResourceSpec(n_nodes=n_nodes, elastic=True),
        train=spec.TrainSpec(total_steps=total_steps,
                             global_batch=SHAPE.global_batch,
                             seq_len=SHAPE.seq_len, chunk_steps=1))


def _fixed_losses(n_steps, strategy="baseline"):
    """The uninterrupted port Trainer from the reference's state."""
    tr = Trainer(TINY, tbase.TrainConfig(total_steps=n_steps, **_TCFG),
                 SHAPE, strategy=STRATEGIES[strategy][1], device="cpu")
    tr.state = P.from_numpy(_jax_state(n_steps, STRATEGIES[strategy][0]))
    return [h["loss"] for h in tr.run(n_steps, log_every=0)]


def _strip(recs):
    return [{k: v for k, v in r.items() if k not in WALL and k != "jobid"}
            for r in recs]


def _events(handle):
    """A handle's event log without job ids (each package numbers its
    jobs) and meshes ((1, 1) on the port's one device)."""
    return [{k: v for k, v in e.items() if k not in ("jobid", "mesh")}
            for e in handle.events()]


# ---------------------------------------------------------------------------
# Trainer.remesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_ckpt", [True, False], ids=["ckpt", "in-memory"])
def test_trainer_remesh_matches_jax_and_an_uninterrupted_run(use_ckpt,
                                                             tmp_path):
    _need_8()
    tcfg = dict(total_steps=9, **_TCFG)
    jtr = JTrainer(JTINY, jbase.TrainConfig(**tcfg), JSHAPE,
                   make_local_mesh(1, 1),
                   ckpt_dir=str(tmp_path / "j") if use_ckpt else None)
    jtr.init_or_resume()
    init = jax.device_get(jtr.state)
    tr = Trainer(TINY, tbase.TrainConfig(**tcfg), SHAPE, device="cpu",
                 ckpt_dir=str(tmp_path / "t") if use_ckpt else None)
    tr.state = P.from_numpy(init)
    for j_mesh in (make_local_mesh(2, 4), make_local_mesh(1, 1), None):
        jh = jtr.run(3, log_every=0)
        th = tr.run(3, log_every=0)
        if j_mesh is not None:
            jtr.remesh(j_mesh)
            assert tr.remesh() >= 0.0
    assert [h["step"] for h in th] == list(range(9)) == \
        [h["step"] for h in jh]
    losses = [h["loss"] for h in th]
    np.testing.assert_allclose(losses, [h["loss"] for h in jh], rtol=RTOL)
    ref = Trainer(TINY, tbase.TrainConfig(**tcfg), SHAPE, device="cpu")
    ref.state = P.from_numpy(init)
    assert losses == [h["loss"] for h in ref.run(9, log_every=0)]
    if use_ckpt:
        assert tr.ckpt.latest_step() == 6         # the second remesh's


def test_elastic_phase_steps_cover_budget_exactly():
    from repro.launch.train import phase_steps as jphase_steps
    from repro_torch.launch.train import phase_steps
    for total in (1, 2, 3, 7, 9):
        counts = phase_steps(total, 3)
        assert counts == jphase_steps(total, 3)
        assert sum(counts) == total
        assert all(c >= 0 for c in counts)
        assert counts[0] >= 1                  # first phase always runs


def test_train_launcher_elastic_runs_on_the_cpu(capsys, tmp_path):
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch import train
    train.main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                "--elastic", "--steps", "5", "--batch", "2", "--seq", "16",
                "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("[elastic]")]
    assert len(lines) == 2 and "mesh (1, 1)" in lines[0]
    assert "resumed at step 2" in lines[0] and "step 4" in lines[1]
    assert "final loss" in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 4


# ---------------------------------------------------------------------------
# The elastic invariant through the operator, held to the reference
# ---------------------------------------------------------------------------


def _grow_shrink(pkg, strategy):
    clock, mc, h = _elastic_cluster(pkg, strategy)
    ses = h.executor.sessions[h.job.jobid]
    _run_until(clock, lambda: ses.step >= 3)
    step_at_grow = ses.step
    mc.patch_size(4)                                   # grow mid-training
    _run_until(clock, lambda: ses.step >= 12 and len(ses.resumes) >= 1)
    mc.patch_size(2)                                   # shrink mid-training
    _run_until(clock, lambda: h.job.state == PKGS[pkg][0].JobState.INACTIVE)
    return h, ses, step_at_grow


@pytest.fixture(scope="module", params=list(STRATEGIES))
def grow_shrink(request):
    _need_8()
    return request.param, {pkg: _grow_shrink(pkg, request.param)
                           for pkg in ("torch", "jax")}


def test_grow_shrink_keeps_the_loss_trajectory(grow_shrink):
    strategy, runs = grow_shrink
    h, ses, step_at_grow = runs["torch"]
    assert h.job.result == "completed"
    assert ses.step == TOTAL and len(ses.losses) == TOTAL
    assert [r["transition"] for r in ses.resumes] == ["2->4", "4->2"]
    assert all(r["time_to_resume_s"] > 0 for r in ses.resumes)
    # grow never pauses the job: steps kept landing on the old mesh
    # while the new ranks paid boot + cold image pull
    assert ses.resumes[0]["step"] > step_at_grow
    assert ses.losses == _fixed_losses(TOTAL, strategy)
    _, jses, _ = runs["jax"]
    np.testing.assert_allclose(ses.losses, jses.losses, rtol=RTOL)


def test_elastic_train_records_and_events_equal_jax(grow_shrink):
    _, runs = grow_shrink
    (h, ses, _), (jh, jses, _) = runs["torch"], runs["jax"]
    assert type(h.executor).__name__ == "ElasticTrainExecutor"
    assert _events(h) == _events(jh)
    phases = [e["phase"] for e in h.events()]
    assert phases[:3] == ["Pending", "Bound", "Running"]
    assert phases.count("Resizing") == 2 and phases[-1] == "Completed"
    assert _strip(ses.segments) == _strip(jses.segments)
    assert _strip(ses.resumes) == _strip(jses.resumes)
    rec, jrec = (x.executor.ran[x.job.jobid] for x in (h, jh))
    for key in ("steps", "n_resumes", "hosts"):
        assert rec[key] == jrec[key], key
    assert rec["mesh_shape"] == (1, 1)
    assert h.result()["final_loss"] == rec["loss"] == ses.losses[-1]


def test_shrink_requeues_and_restores_from_committed_ckpt():
    _need_8()
    out = {}
    for pkg in ("torch", "jax"):
        clock, mc, h = _elastic_cluster(pkg, total_steps=8)
        ses = h.executor.sessions[h.job.jobid]
        _run_until(clock, lambda: ses.step >= 3)
        assert h.job.spec.n_nodes == 2
        mc.patch_size(1)
        # the resize event checkpointed synchronously, before any teardown
        assert ses.ckpt.latest_step() == ses.step
        assert h.job.spec.n_nodes == 1         # request follows the patch
        _run_until(clock, lambda: h.job.state == PKGS[pkg][0].JobState.INACTIVE)
        assert h.job.result == "completed" and ses.step == 8
        assert ses.resumes and ses.resumes[-1]["transition"] == "2->1"
        out[pkg] = (ses, h)
    ses, h = out["torch"]
    assert ses.losses == _fixed_losses(8)
    assert h.job.requeues == out["jax"][1].job.requeues >= 1
    assert _strip(ses.resumes) == _strip(out["jax"][0].resumes)


def test_noop_repatch_during_resume_window_is_harmless():
    _need_8()
    clock, mc, h = _elastic_cluster("torch", total_steps=12)
    ses = h.executor.sessions[h.job.jobid]
    _run_until(clock, lambda: ses.step >= 3)
    mc.patch_size(4)
    # stop exactly at placement: state restored, first chunk not yet run
    _run_until(clock, lambda: ses._resume_rec is not None)
    mc.patch_size(4)                           # no-op re-patch
    _run_until(clock, lambda: h.job.state == tcore.JobState.INACTIVE)
    assert h.job.result == "completed" and ses.step == 12
    assert [r["transition"] for r in ses.resumes] == ["2->4"]
    assert ses.resumes[0]["sim_resume_gap_s"] >= 0
    assert ses.losses == _fixed_losses(12)


def test_node_death_before_first_checkpoint_reshards_in_memory():
    _need_8()
    out = {}
    for pkg in ("torch", "jax"):
        core = PKGS[pkg][0]
        clock, mc, h = _elastic_cluster(pkg, total_steps=8)
        ses = h.executor.sessions[h.job.jobid]
        assert ses.ckpt.latest_step() is None  # no resize, no checkpoint
        core.kill_node(clock, mc, rank=1, at=clock.now + 1.0)
        _run_until(clock, lambda: h.job.state == core.JobState.INACTIVE)
        assert h.job.result == "completed" and ses.step == 8
        assert h.job.requeues >= 1
        # re-placed on a different host set than the original {0, 1}
        assert ses.segments[-1]["hosts"] != ses.segments[0]["hosts"]
        out[pkg] = ses
    assert out["torch"].losses == _fixed_losses(8)
    assert _strip(out["torch"].segments) == _strip(out["jax"].segments)


def test_shrink_clamps_queued_jobs_too():
    _need_8()
    clock, mc, h = _elastic_cluster("torch", total_steps=4)
    qh = mc.apply(_train_spec(tspec, total_steps=4), cfg=TINY,
                  executor_opts=dict(sim_step_time=SIM_STEP, **CPU))
    queued = qh.job
    clock.run(until=clock.now + 1.0)           # ingest; cluster is full
    assert queued.state == tcore.JobState.SCHED
    mc.patch_size(1)
    assert queued.spec.n_nodes == 1            # clamped while queued
    _run_until(clock, lambda: h.job.state == tcore.JobState.INACTIVE
               and queued.state == tcore.JobState.INACTIVE)
    assert h.job.result == "completed"
    assert queued.result == "completed"
    assert qh.executor.sessions[queued.jobid].step == 4


# ---------------------------------------------------------------------------
# Reconciler event plumbing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_patch_size_publishes_resize_events(pkg):
    core = PKGS[pkg][0]
    clock = core.SimClock(seed=0)
    mc = core.FluxMiniCluster(clock, core.NetModel(),
                              core.ResourceGraph(n_pods=1, hosts_per_pod=4),
                              core.MiniClusterSpec(name="ev", size=2,
                                                   max_size=4))
    seen = []
    mc.on_resize.append(lambda size, source: seen.append((size, source)))
    mc.create()
    mc.wait_ready()
    mc.patch_size(4)
    mc.patch_size(2, source="api")
    assert seen == [(4, "user"), (2, "api")]
    sources = [kw.get("source") for _, _, kw in clock.events("patch_size")]
    assert sources == ["user", "api"]


def test_autoscaler_resize_reaches_running_session():
    _need_8()
    out = {}
    for pkg in ("torch", "jax"):
        core = PKGS[pkg][0]
        clock, mc, h = _elastic_cluster(pkg, total_steps=12)
        ses = h.executor.sessions[h.job.jobid]

        class GrowPolicy:
            def desired(self, mc):
                return 4

        auto = core.Autoscaler(clock, mc, GrowPolicy(), interval=15.0)
        auto.start()
        _run_until(clock, lambda: h.job.state == core.JobState.INACTIVE)
        auto.stop()
        assert h.job.result == "completed"
        assert auto.decisions and auto.decisions[0][2] == 4
        assert ses.resumes and ses.resumes[0]["transition"] == "2->4"
        assert ses.resumes[0]["source"] == "autoscaler"
        out[pkg] = (h, ses)
    assert _events(out["torch"][0]) == _events(out["jax"][0])
    assert out["torch"][1].losses == _fixed_losses(12)


def test_attach_elastic_executor_binds_the_port_executor():
    clock = tcore.SimClock(seed=0)
    mc = tcore.FluxMiniCluster(clock, tcore.NetModel(),
                               tcore.ResourceGraph(1, 4, 2),
                               tcore.MiniClusterSpec(name="a", size=2))
    with pytest.warns(DeprecationWarning):
        ex = mc.instance.attach_elastic_executor(mc, cfg=TINY, **CPU)
    assert isinstance(ex, tcore.ElasticTrainExecutor)
    assert ex._on_resize in mc.on_resize
