"""The sequence mixers' training cases of ``tests/test_torch_train.py``
(jamba-v0.1-52b and xlstm-1.3b SMOKE), in a file of their own so that a
test run that hands out whole files spreads them over its workers: five
Trainer steps against the JAX trainer, each mixer leaf's dtype through a
checkpoint and a remesh, and the train launcher, plain and elastic.  The
helpers, configs and tolerances are ``test_torch_train``'s."""
import pytest

torch = pytest.importorskip("torch")

import test_torch_train as T  # noqa: E402
from repro_torch.ckpt import checkpoint as tckpt  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.dist import steps as tsteps  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402
from test_torch_train import SEQMIX, _cfgs, _leaves, _shapes  # noqa: E402


@pytest.mark.parametrize("grad_accum,arch", [
    pytest.param(1, a, id=f"{a}-1") for a in SEQMIX])
def test_trainer_matches_jax_train_step_for_five_steps(grad_accum, arch):
    T.test_trainer_matches_jax_train_step_for_five_steps(grad_accum, arch)


def _assert_same(got, want):
    """Every leaf of ``want`` in ``got`` with its dtype and bits."""
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.mark.parametrize("arch", SEQMIX)
def test_sequence_mixer_leaves_keep_their_dtypes_through_resume_and_remesh(
        arch, tmp_path):
    """A bf16 train state of jamba or xlstm SMOKE keeps each mixer leaf in
    its own dtype (a_log and the xLSTM gate biases, head norms and sLSTM
    recurrence float32; dt_bias and d_skip in the tree's bf16) through a
    checkpoint the Trainer wrote and a remesh at an unchanged rank count,
    bit for bit, and the remeshed run continues the uninterrupted one."""
    _, cfg = _cfgs(arch)
    tcfg = tbase.TrainConfig(param_dtype="bfloat16", compute_dtype="float32",
                             warmup_steps=1, total_steps=4)
    tshape, _ = _shapes()
    f32 = {"a_log", "b_i", "b_f", "b_z", "b_o", "hnorm", "r"}
    state = tsteps.init_train_state(cfg, tcfg, device="cpu")
    kinds = set()
    for path, t in _leaves(state["params"]):
        if path[0] == "blocks" and path[2] in ("mamba", "mlstm", "slstm"):
            kinds.add(path[2])
            want = torch.float32 if path[3] in f32 else torch.bfloat16
            assert t.dtype == want, path
    assert kinds == ({"mamba"} if arch.startswith("jamba")
                     else {"mlstm", "slstm"})
    tr = Trainer(cfg, tcfg, tshape, ckpt_dir=str(tmp_path), device="cpu")
    tr.run(2, ckpt_every=2, log_every=0)
    before = P.tree_map(lambda t: t.detach().clone(), tr.state)
    restored, step = tckpt.CheckpointManager(str(tmp_path)).restore_latest(
        tsteps.abstract_train_state(cfg, tcfg))
    assert step == 2
    _assert_same(restored, before)
    assert tr.remesh() >= 0.0
    _assert_same(tr.state, before)
    ref = Trainer(cfg, tcfg, tshape, device="cpu")
    ref_losses = [h["loss"] for h in ref.run(4, log_every=0)]
    assert [h["loss"] for h in tr.run(2, log_every=0)] == ref_losses



@pytest.mark.parametrize("elastic", [False, True], ids=["plain", "elastic"])
@pytest.mark.parametrize("arch", SEQMIX)
def test_train_launcher_trains_the_sequence_mixers(arch, elastic, capsys,
                                                   tmp_path):
    """``launch.train`` on jamba's and xlstm's SMOKE configs, on the CPU,
    and with ``--elastic`` through a grow and a shrink (each a remesh
    through a checkpoint); the elastic run's final loss is the plain
    one's."""
    from repro_torch.launch import train
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "5",
            "--batch", "2", "--seq", "16"]
    train.main(args)
    plain = capsys.readouterr().out
    if not elastic:
        assert "final loss" in plain and "nan" not in plain
        return
    train.main(args + ["--elastic", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("[elastic]")]
    assert len(lines) == 2 and "resumed at step 2" in lines[0]
    final = [ln for ln in out.splitlines() if ln.startswith("final loss")]
    assert final == [ln for ln in plain.splitlines()
                     if ln.startswith("final loss")]
