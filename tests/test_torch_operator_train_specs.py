"""The train and elastic-train specs of the sequence mixers, whisper and
pixtral through ``apply`` against the JAX package's, a case of
``tests/test_torch_operator.py`` in a file of its own so that a test run
that hands out whole files spreads the two over its workers.  The
packages, MiniCluster and event helpers are ``test_torch_operator``'s."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as treg  # noqa: E402
from test_torch_operator import (  # noqa: E402
    PKGS, SEQMIX, _events, _mini, _need_8,
)

TRAIN_ARCHS = SEQMIX + ["whisper-base", "pixtral-12b"]

# (train kwargs, elastic, executor options, executor)
TRAIN_SPECS = {
    "train": (dict(total_steps=2, seq_len=16), False, dict(time_scale=0.0),
              "SubmeshExecutor"),
    "elastic-train": (dict(total_steps=4, chunk_steps=2, global_batch=4,
                           seq_len=16), True, dict(sim_step_time=5.0),
                      "ElasticTrainExecutor")}


@pytest.mark.parametrize("name", list(TRAIN_SPECS))
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sequence_mixer_train_specs_match_jax(arch, name):
    """A train and an elastic train spec of each sequence-mixer arch, of
    whisper (frames in every batch) and of pixtral (patches), without
    ``cfg=`` (its SMOKE config): the port, which refused them all
    before, takes the handle through the reference executor's phases at
    the same simulated times, and its loss is the port's own training
    run: an uninterrupted Trainer's losses step for step (elastic), or
    the train step run as the submesh executor runs it (a warm step,
    then ``total_steps`` more on one batch)."""
    from repro_torch.configs.base import TrainConfig, WorkloadShape
    from repro_torch.data import synthetic_batch, to_tensors
    from repro_torch.dist import steps as tsteps
    from repro_torch.train import Trainer

    _need_8()
    train, elastic, ex_opts, executor = TRAIN_SPECS[name]
    out = {}
    for pkg in ("torch", "jax"):
        core, spec, _, _, opts = PKGS[pkg]
        clock, mc = _mini(core)
        h = mc.apply(spec.WorkloadSpec(
            kind="train", arch=arch,
            resources=spec.ResourceSpec(n_nodes=1, elastic=elastic),
            train=spec.TrainSpec(**train)), executor_opts=dict(ex_opts, **opts))
        clock.run(until=clock.now + 10_000.0,
                  stop_when=lambda: h.phase in ("Completed", "Failed"))
        out[pkg] = h
    got, want = out["torch"], out["jax"]
    assert type(got.executor).__name__ == executor
    assert got.phase == "Completed"
    assert _events(got) == _events(want)
    cfg = treg.smoke(arch)
    loss = got.executor.ran[got.job.jobid]["loss"]
    assert got.result()["final_loss"] == loss
    n = train["total_steps"]
    tcfg = TrainConfig(total_steps=n, warmup_steps=0)
    if elastic:
        shape = WorkloadShape("elastic", "train", train["seq_len"],
                              train["global_batch"])
        tr = Trainer(cfg, tcfg, shape, seed=0, device="cpu")
        losses = [h["loss"] for h in tr.run(n, log_every=0)]
        assert got.executor.sessions[got.job.jobid].losses == losses
        assert loss == losses[-1]
        return
    shape = WorkloadShape("submesh", "train", train["seq_len"], 2)
    step = tsteps.build_train_step(cfg, tcfg, shape)
    state = tsteps.init_train_state(cfg, tcfg, torch.Generator().manual_seed(0),
                                    "cpu")
    batch = to_tensors(synthetic_batch(cfg, shape), "cpu")
    for _ in range(1 + n):
        state, metrics = step(state, batch)
    assert loss == float(metrics["loss"])
