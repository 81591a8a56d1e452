"""The port's training path (configs, optimizers, data, loss, train step,
checkpoints, Trainer, launcher) against the JAX package's, on the CPU,
from the same numpy inputs and the same parameters.

Tolerances: float32 compute 1e-4 relative on losses and 1e-4 on
gradients (the same math, summed in another order); bfloat16 compute
3e-2 (both frameworks round matmul outputs to bf16 at places that need
not coincide); optimizer updates 1e-5 (float32 elementwise arithmetic,
clip norms summed in another order); data batches bit for bit.
"""
import dataclasses
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.dist import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.optim import lr_schedule as jlr  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro_torch.ckpt import checkpoint as tckpt  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.dist import steps as tsteps  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import lr_schedule as tlr  # noqa: E402
from repro_torch.optim import make_optimizer as tmake_optimizer  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402

JCFG = jreg.smoke("yi-6b")
CFG = treg.smoke("yi-6b")
SHAPE = dict(name="t", kind="train", seq_len=32, global_batch=4)
# the sequence mixers' SMOKE configs (a Mamba block with a MoE FFN, and
# mLSTM / sLSTM) held to the same parity as yi-6b's
SEQMIX = ["jamba-v0.1-52b", "xlstm-1.3b"]
# a gradient leaf's scale is at least this share of the largest leaf's:
# below it lies rounding noise (the sLSTM's input-gate bias has no
# gradient in exact arithmetic: a shift of every input gate cancels in
# c / n); yi-6b's smallest leaf is 2e-3 of its largest, so its cases
# hold each leaf to its own scale as before
GRAD_FLOOR = 1e-5
# bfloat16 gradients of the sequence mixers: the reference's own bf16
# gradients of the small Mamba and mLSTM leaves (conv, dt and x
# projections) lie several percent of the leaf's largest from its float32
# ones, more than 3e-2, and the port's bf16 ones as far, so two bf16 runs
# part by more than yi-6b's 3e-2; float32 holds them to 1e-4 as yi-6b
SEQMIX_BF16_TOL = 6e-2


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads a test (xdist runs six workers on eight cores;
    a thread a core each oversubscribes them), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    """(JAX SMOKE config, port SMOKE config) of ``arch``."""
    return jreg.smoke(arch), treg.smoke(arch)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_trees(t_tree, j_tree, tol):
    jl = dict(_leaves(j_tree))
    tl = dict(_leaves(t_tree))
    assert jl.keys() == tl.keys()
    for path, j in jl.items():
        np.testing.assert_allclose(_np(tl[path]), _np(j), rtol=tol, atol=tol,
                                   err_msg=str(path))


def _tcfg(**kw):
    return tbase.TrainConfig(**kw), jbase.TrainConfig(**kw)


def _shapes(**kw):
    s = dict(SHAPE, **kw)
    return tbase.WorkloadShape(**s), jbase.WorkloadShape(**s)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_train_configs_are_field_for_field_copies():
    for cls in ("TrainConfig", "WorkloadShape"):
        tf = [(f.name, f.default) for f in
              dataclasses.fields(getattr(tbase, cls))]
        jf = [(f.name, f.default) for f in
              dataclasses.fields(getattr(jbase, cls))]
        assert tf == jf, cls
    assert {k: dataclasses.astuple(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jbase.SHAPES.items()}
    for arch in ("get", "smoke"):
        t, j = getattr(treg, arch)("yi-6b"), getattr(jreg, arch)("yi-6b")
        assert (t.optimizer, t.opt_state_dtype) == \
            (j.optimizer, j.opt_state_dtype)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


def test_lr_schedule_matches_jax():
    kw = dict(base_lr=3e-4, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(tlr(step, **kw)),
                                   float(jlr(step, **kw)), rtol=1e-6)
    assert float(tlr(torch.tensor(3, dtype=torch.int32), **kw)) == \
        pytest.approx(float(jlr(3, **kw)), rel=1e-6)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_optimizer_updates_match_jax(optimizer, state_dtype):
    """Three updates on identical grads, state and params; one grad
    scaled up so the global-norm clip bites."""
    jcfg = dataclasses.replace(JCFG, optimizer=optimizer,
                               opt_state_dtype=state_dtype)
    cfg = dataclasses.replace(CFG, optimizer=optimizer,
                              opt_state_dtype=state_dtype)
    tcfg, jtcfg = _tcfg(warmup_steps=1, total_steps=4)
    js = jsteps.init_train_state(jcfg, jtcfg, jax.random.PRNGKey(1))
    ts = P.from_numpy(jax.device_get(js))
    jupdate, tupdate = jmake_optimizer(jcfg, jtcfg), tmake_optimizer(cfg, tcfg)
    jp, jo = js["params"], js["opt"]
    tp, to = ts["params"], ts["opt"]
    rng = np.random.default_rng(0)
    tol = 1e-5 if state_dtype == "float32" else 1e-2
    for step in range(3):
        g = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32)
            * (30.0 if step == 1 else 0.01), jax.device_get(jp))
        jp, jo, jstats = jupdate(g, jo, jp, jnp.int32(step))
        tp, to, tstats = tupdate(P.from_numpy(g), to, tp,
                                 torch.tensor(step, dtype=torch.int32))
        np.testing.assert_allclose(float(tstats["grad_norm"]),
                                   float(jstats["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(tstats["lr"]), float(jstats["lr"]),
                                   rtol=1e-6)
        _close_trees(tp, jp, tol)
        _close_trees(to, jo, tol)
        for path, t in _leaves(to):
            assert t.dtype == P.DTYPES[state_dtype], path


def test_train_state_defs_mirror_the_jax_schema():
    """yi-6b's and the sequence mixers' schemas, named custom inits
    included (the optimizer's moments start at zero whatever the
    parameter's init)."""
    for arch, optimizer in [("yi-6b", "adamw"), ("yi-6b", "adafactor")] + [
            (a, o) for a in SEQMIX for o in ("adamw", "adafactor")]:
        j0, t0 = _cfgs(arch)
        jcfg = dataclasses.replace(j0, optimizer=optimizer)
        cfg = dataclasses.replace(t0, optimizer=optimizer)
        jdefs = dict(_leaves(jsteps.train_state_defs(jcfg)))
        tdefs = dict(_leaves(tsteps.train_state_defs(cfg)))
        assert jdefs.keys() == tdefs.keys()
        for path, jd in jdefs.items():
            td = tdefs[path]
            assert (td.shape, td.axes, td.init, td.custom) == \
                (jd.shape, jd.axes, jd.init, jd.custom), path
            assert str(jd.resolve_dtype(jnp.float32)) == \
                str(td.dtype or "float32"), path
        ts = tsteps.init_train_state(cfg, tbase.TrainConfig(), device="cpu")
        assert all(bool((t == 0).all()) for _, t in _leaves(ts["opt"])), \
            (arch, optimizer)
    jabs = jsteps.abstract_train_state(JCFG, jbase.TrainConfig())
    tabs = tsteps.abstract_train_state(CFG, tbase.TrainConfig())
    for (jpath, j), (tpath, t) in zip(_leaves(jabs), _leaves(tabs)):
        assert jpath == tpath
        assert tuple(t.shape) == j.shape, tpath
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), tpath
    ts = tsteps.init_train_state(CFG, tbase.TrainConfig(), device="cpu")
    assert all(bool((t == 0).all()) for _, t in _leaves(ts["opt"]))
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 0


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_data_batches_equal_jax_bit_for_bit():
    tshape, jshape = _shapes(seq_len=64, global_batch=3)
    for step in (0, 7):
        t = tpipe.synthetic_batch(CFG, tshape, seed=5, step=step)
        j = jpipe.synthetic_batch(JCFG, jshape, seed=5, step=step)
        assert t.keys() == j.keys() == {"tokens", "labels"}
        for k in t:
            assert t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k])
    tp = tpipe.DataPipeline(CFG, tshape, seed=2, start_step=3)
    jp = jpipe.DataPipeline(JCFG, jshape, seed=2, start_step=3)
    try:
        for _ in range(2):
            a, b = next(tp), next(jp)
            assert a["_step"] == b["_step"]
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
    finally:
        tp.close()
        jp.close()


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,dtype,tol", [
    pytest.param("yi-6b", "float32", 1e-4, id="float32-0.0001"),
    pytest.param("yi-6b", "bfloat16", 3e-2, id="bfloat16-0.03")] + [
    pytest.param(a, d, t, id=f"{a}-{d}-{t}") for a in SEQMIX
    for d, t in (("float32", 1e-4), ("bfloat16", SEQMIX_BF16_TOL))])
@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax(arch, dtype, tol, remat):
    """Loss, xent, moe_aux and every gradient leaf against
    jax.value_and_grad of the reference's loss: yi-6b, and jamba's Mamba
    (the reference's recompute backward and the port's SelectiveScan)
    with its MoE aux loss and xlstm's mLSTM and sLSTM by autodiff and
    autograd."""
    jcfg, cfg = _cfgs(arch)
    tshape, jshape = _shapes()
    batch = jpipe.synthetic_batch(jcfg, jshape, seed=0, step=0)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JModel(jcfg).loss(p, batch, remat=remat,
                                    compute_dtype=jnp.dtype(dtype)),
        has_aux=True)(jp)
    tp = P.from_numpy(jax.device_get(jp))
    leaves = P.tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tl, tm = Model(cfg).loss(
        tp, {k: torch.from_numpy(v).long() for k, v in batch.items()},
        remat=remat, compute_dtype=P.DTYPES[dtype])
    tg = P.tree_unflatten(tp, torch.autograd.grad(tl, leaves))
    assert set(tm) == {"loss", "xent", "moe_aux"}
    assert (float(tm["moe_aux"].detach()) == 0) == (cfg.moe is None)
    for k, t, j in (("loss", tl, jl), ("xent", tm["xent"], jm["xent"]),
                    ("moe_aux", tm["moe_aux"], jm["moe_aux"])):
        np.testing.assert_allclose(float(t.detach()), float(j), rtol=tol,
                                   err_msg=k)
    # gradients relative to each leaf's own scale (at least GRAD_FLOOR
    # of the largest leaf's)
    want = [(path, np.asarray(j, np.float32))
            for path, j in _leaves(jax.device_get(jg))]
    top = max(float(np.abs(j).max()) for _, j in want)
    for (path, j), (_, t) in zip(want, _leaves(tg)):
        scale = max(float(np.abs(j).max()), GRAD_FLOOR * top)
        np.testing.assert_allclose(_np(t), j, rtol=0, atol=tol * scale,
                                   err_msg=str(path))


# ---------------------------------------------------------------------------
# the train step and the Trainer against the JAX trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grad_accum,arch", [
    pytest.param(1, "yi-6b", id="1"), pytest.param(2, "yi-6b", id="2")])
def test_trainer_matches_jax_train_step_for_five_steps(grad_accum, arch):
    """Five Trainer steps against the JAX trainer's from the same state
    (the sequence mixers' cases: tests/test_torch_train_seqmix.py)."""
    jcfg, cfg = _cfgs(arch)
    tcfg, jtcfg = _tcfg(compute_dtype="float32", grad_accum=grad_accum,
                        warmup_steps=2, total_steps=5)
    tshape, jshape = _shapes()
    jtr = JTrainer(jcfg, jtcfg, jshape, make_local_mesh(1, 1))
    jtr.init_or_resume()
    tr = Trainer(cfg, tcfg, tshape, device="cpu")
    tr.state = P.from_numpy(jax.device_get(jtr.state))
    jh = jtr.run(5, log_every=0)
    th = tr.run(5, log_every=0)
    assert [h["step"] for h in th] == list(range(5))
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], rtol=1e-4)
    np.testing.assert_allclose([h["grad_norm"] for h in th],
                               [h["grad_norm"] for h in jh], rtol=1e-3)
    assert int(tr.state["step"]) == 5
    _close_trees(tr.state["params"], jax.device_get(jtr.state["params"]),
                 1e-4)


def test_train_step_metrics_and_grad_accum_average():
    """grad_accum=2 over the same rows gives the loss of grad_accum=1
    (the mean of the two half-batch means) and the keys of the JAX
    step's metrics."""
    tshape, jshape = _shapes()
    batch = {k: torch.from_numpy(v).long() for k, v in
             jpipe.synthetic_batch(JCFG, jshape, step=0).items()}
    out = {}
    for ga in (1, 2):
        tcfg = tbase.TrainConfig(compute_dtype="float32", grad_accum=ga)
        state = tsteps.init_train_state(CFG, tcfg, device="cpu")
        step = tsteps.build_train_step(CFG, tcfg, tshape)
        state, m = step(state, batch)
        assert set(m) == {"loss", "xent", "moe_aux", "grad_norm", "lr"}
        out[ga] = m
        assert int(state["step"]) == 1
    np.testing.assert_allclose(float(out[2]["loss"]), float(out[1]["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(out[2]["grad_norm"]),
                               float(out[1]["grad_norm"]), rtol=1e-4)


@pytest.mark.parametrize("remat", [True, False])
def test_train_step_runs_each_forward_twice_under_remat(monkeypatch, remat):
    """Per step and layer: two attention forwards under remat (the
    checkpointed block is recomputed in the backward), one backward;
    two norms per layer per forward, plus the final norm once.  The
    card's launch counts follow the same calls."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import ref as tfa
    calls = {"fwd": 0, "bwd": 0, "norm": 0}

    def counted(name, fn):
        def f(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return f

    monkeypatch.setattr(tfa, "fwd", counted("fwd", tfa.fwd))
    monkeypatch.setattr(tfa, "bwd", counted("bwd", tfa.bwd))
    monkeypatch.setattr(ops._rn_ref, "rmsnorm_ref",
                        counted("norm", ops._rn_ref.rmsnorm_ref))
    tshape, jshape = _shapes()
    tcfg = tbase.TrainConfig(remat=remat)
    state = tsteps.init_train_state(CFG, tcfg, device="cpu")
    step = tsteps.build_train_step(CFG, tcfg, tshape)
    batch = {k: torch.from_numpy(v).long() for k, v in
             jpipe.synthetic_batch(JCFG, jshape).items()}
    for _ in range(2):
        state, _ = step(state, batch)
    n, f = CFG.n_layers * 2, 2 if remat else 1
    assert calls == {"fwd": f * n, "bwd": n, "norm": (2 * f * CFG.n_layers
                                                       + 1) * 2}


def test_trainer_without_device_raises_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    tshape, _ = _shapes()
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(CFG, tbase.TrainConfig(), tshape)


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------


def test_checkpoint_round_trip_keeps_every_leaf_and_dtype(tmp_path):
    tcfg = tbase.TrainConfig(param_dtype="bfloat16")
    state = tsteps.init_train_state(CFG, tcfg, device="cpu")
    state["step"] += 7
    tckpt.save_state(state, str(tmp_path / "s"), meta={"who": "port"})
    back = tckpt.restore_state(tsteps.abstract_train_state(CFG, tcfg),
                               str(tmp_path / "s"))
    for (path, a), (_, b) in zip(_leaves(state), _leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    assert tckpt.load_meta(str(tmp_path / "s")) == {"who": "port"}
    wider = dataclasses.replace(CFG, d_ff=2 * CFG.d_ff)
    with pytest.raises(ValueError, match="mlp"):
        tckpt.restore_state(tsteps.abstract_train_state(wider, tcfg),
                            str(tmp_path / "s"))
    # the JAX package reads the bf16 leaves through the same bits
    jb = jckpt.restore_state(
        jsteps.abstract_train_state(JCFG, jbase.TrainConfig(
            param_dtype="bfloat16")), str(tmp_path / "s"))
    _close_trees(back, jb, 0)


@pytest.mark.parametrize("how", ["compressed", "corrupt"])
def test_restore_reads_any_npz_and_refuses_a_corrupt_one(tmp_path, how):
    """Stored members are read from their offsets in the file and held
    to their CRC-32; a compressed member (an ``np.savez_compressed``
    file) goes through ``np.load``."""
    tcfg = tbase.TrainConfig(param_dtype="bfloat16")
    state = tsteps.init_train_state(CFG, tcfg, device="cpu")
    path = str(tmp_path / "s")
    tckpt.save_state(state, path)
    template = tsteps.abstract_train_state(CFG, tcfg)
    with np.load(path + ".npz") as z:
        arrays = {k: z[k] for k in z.files}
    if how == "compressed":
        np.savez_compressed(path + ".npz", **arrays)
        back = tckpt.restore_state(template, path)
        for (p, a), (_, b) in zip(_leaves(state), _leaves(back)):
            assert a.dtype == b.dtype and torch.equal(a, b), p
        return
    # one byte of the largest member's array flipped in place
    big = max(arrays, key=lambda k: arrays[k].nbytes)
    with zipfile.ZipFile(path + ".npz") as zf:
        info = zf.getinfo(big + ".npy")
    with open(path + ".npz", "r+b") as f:
        f.seek(info.header_offset + info.file_size)   # inside the array
        byte = f.read(1)[0]
        f.seek(-1, 1)
        f.write(bytes([byte ^ 0xFF]))
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        tckpt.restore_state(template, path)


def test_manager_commits_keeps_and_ignores_torn_steps(tmp_path):
    tcfg = tbase.TrainConfig()
    state = tsteps.init_train_state(CFG, tcfg, device="cpu")
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save(state, step)
    mgr.wait()
    (tmp_path / "step_00000009").mkdir()          # torn: no COMMIT
    assert mgr.latest_step() == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000002", "step_00000003", "step_00000009"]
    restored, step = mgr.restore_latest(
        tsteps.abstract_train_state(CFG, tcfg))
    assert step == 3 and restored["step"].dtype == torch.int32
    # the JAX manager sees the same committed steps
    assert jckpt.CheckpointManager(str(tmp_path)).latest_step() == 3


@pytest.mark.parametrize("writer,arch", [
    pytest.param("jax", "yi-6b", id="jax"),
    pytest.param("port", "yi-6b", id="port")] + [
    pytest.param(w, a, id=f"{w}-{a}") for a in SEQMIX
    for w in ("jax", "port")])
def test_checkpoint_written_by_one_package_resumes_in_the_other(writer, arch,
                                                                tmp_path):
    """Two steps in one package, a checkpoint, then two more steps in
    each package from it: the same losses (the sequence mixers' float32
    leaves, a_log and the sLSTM's, carried as they are)."""
    jcfg, cfg = _cfgs(arch)
    tcfg, jtcfg = _tcfg(compute_dtype="float32", warmup_steps=1,
                        total_steps=4)
    tshape, jshape = _shapes()
    ck = str(tmp_path / "ck")
    if writer == "jax":
        first = JTrainer(jcfg, jtcfg, jshape, make_local_mesh(1, 1),
                         ckpt_dir=ck)
        first.run(2, ckpt_every=2, log_every=0)
    else:
        jtr = JTrainer(jcfg, jtcfg, jshape, make_local_mesh(1, 1))
        jtr.init_or_resume()
        first = Trainer(cfg, tcfg, tshape, ckpt_dir=ck, device="cpu")
        first.state = P.from_numpy(jax.device_get(jtr.state))
        first.run(2, ckpt_every=2, log_every=0)
    cont = first.run(2, log_every=0)[2:]
    tr = Trainer(cfg, tcfg, tshape, ckpt_dir=ck, device="cpu")
    jtr = JTrainer(jcfg, jtcfg, jshape, make_local_mesh(1, 1), ckpt_dir=ck)
    assert tr.init_or_resume() == jtr.init_or_resume() == "resumed"
    assert tr.start_step == jtr.start_step == 2
    th, jh = tr.run(2, log_every=0), jtr.run(2, log_every=0)
    assert [h["step"] for h in th] == [h["step"] for h in jh] == [2, 3]
    for h in (th, jh):
        np.testing.assert_allclose([r["loss"] for r in h],
                                   [r["loss"] for r in cont], rtol=1e-4)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_train_launcher_runs_on_the_cpu(capsys, tmp_path):
    from repro_torch.launch import train
    train.main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                "--steps", "3", "--batch", "2", "--seq", "16",
                "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"])
    out = capsys.readouterr().out
    assert "final loss" in out and "step 0" in out
    assert tckpt.CheckpointManager(str(tmp_path)).latest_step() == 3
