"""The port's launchers at the JAX launchers' flags (``--spec``,
``--replicas``, ``--strategy``, ``--dp``/``--tp``), ``launch/mesh.py``,
and the examples' twins (``examples/torch_*.py``) against the JAX
package's, on the CPU.

Held exactly: the serve launcher's printed mesh, strategy, temperature
and replicas, and its ``stats()`` (every key and counter: ticks by kind,
prefills, pages, the prefill and prefix caches, the router's dispatch)
against the reference launcher's on the same spec, less the port's own
``device`` and ``strategy`` keys of an engine; each request's stream
against a directly built ``Router`` or ``Engine`` of the port from the
same seed, token for token (the weights differ between the packages, a
torch generator against ``jax.random``, so streams are held inside the
port), except on a (data 2, model 2) mesh of ranks, where the
reference's engines are given the port's weights and the streams are
held to the reference's; the train launcher's losses on a spec against a direct
``Trainer``'s (1e-6); and each example twin's lifecycle lines against
the reference example's.

The port's CPU kernels run on two intra-op threads here (restored after
each test): a test runner that starts several workers on few cores
otherwise spends its time in idle threads' spin-waits.
"""
import ast
import json
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.configs import TrainConfig, WorkloadShape  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.serve import Engine, Router  # noqa: E402
from repro_torch.spec import load_spec  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPECS = ROOT / "examples" / "specs"
CPU = ["--smoke", "--device", "cpu"]
# an engine's stats keys the reference's have not
PORT_ONLY = {"device", "strategy"}


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _need_8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 JAX devices (conftest forces them)")


def _run_reference(monkeypatch, capsys, argv, module=None, path=None):
    """The JAX package's launcher ``module`` or example script ``path``
    as ``python ... argv`` would run it; returns what it printed."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [str(path or module)] + list(argv))
    if module is not None:
        runpy.run_module(module, run_name="__main__")
    else:
        runpy.run_path(str(path), run_name="__main__")
    return capsys.readouterr().out


def _printed(out):
    """The launcher's mesh line (up to its build time) and its stats."""
    head = next(ln for ln in out.splitlines() if ln.startswith("mesh "))
    stats = next(ln for ln in out.splitlines()
                 if ln.startswith("engine stats: "))
    return (head.split(" (engine build")[0],
            ast.literal_eval(stats.removeprefix("engine stats: ")))


def _without_port_keys(stats):
    if "engines" in stats:
        return dict(stats, engines=[_without_port_keys(s)
                                    for s in stats["engines"]])
    return {k: v for k, v in stats.items() if k not in PORT_ONLY}


# ---------------------------------------------------------------------------
# launch/mesh.py
# ---------------------------------------------------------------------------


def test_local_mesh_and_workload_resolution():
    mesh = tmesh.make_local_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    assert mesh.devices.shape == (1, 1)
    assert mesh.devices.flat[0] == torch.device("cpu")
    for dp, tp in ((2, 1), (1, 2), (2, 4)):
        with pytest.raises(ValueError, match="devices"):
            tmesh.make_local_mesh(dp, tp, device="cpu")
    cfg, mesh = tmesh.resolve_workload("yi-6b", device="cpu")
    assert cfg == treg.get("yi-6b") and mesh.shape == {"data": 1,
                                                       "model": 1}
    cfg, _ = tmesh.resolve_workload("yi-6b", smoke=True, device="cpu")
    assert cfg == treg.smoke("yi-6b")
    assert tmesh.PEAK_FLOPS_BF16 == 989e12 and tmesh.HBM_BW == 3.35e12


# ---------------------------------------------------------------------------
# the serve launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["serve_fleet.json", "serve_batch.json"])
def test_serve_launcher_spec_equals_the_reference(spec, monkeypatch,
                                                  capsys):
    from repro_torch.launch import serve
    _need_8()
    path = str(SPECS / spec)
    want = _run_reference(monkeypatch, capsys, ["--spec", path, "--smoke"],
                          module="repro.launch.serve")
    eng, reqs = serve.main(["--spec", path] + CPU)
    got = capsys.readouterr().out
    (ghead, gstats), (whead, wstats) = _printed(got), _printed(want)
    assert ghead == whead
    assert _without_port_keys(gstats) == wstats
    engines = eng.engines if isinstance(eng, Router) else [eng]
    assert {e.stats()["strategy"] for e in engines} == {"baseline"}

    wspec = load_spec(path)
    s = wspec.serve
    assert len(engines) == max(s.replicas, 1)
    cfg = treg.smoke(wspec.arch)
    direct = [Engine(cfg, wspec.engine_config(), seed=0, device="cpu")
              for _ in range(len(engines))]
    fleet = Router(direct) if len(direct) > 1 else direct[0]
    rng = np.random.default_rng(0)
    plen = min(32, s.max_prompt_len)
    dreqs = [fleet.submit(rng.integers(0, cfg.vocab_size, plen).tolist(),
                          max_new_tokens=s.max_new,
                          temperature=s.temperature)
             for _ in range(s.n_slots)]
    fleet.run()
    assert [r.prompt for r in reqs] == [r.prompt for r in dreqs]
    assert [r.tokens for r in reqs] == [r.tokens for r in dreqs]
    assert all(len(r.tokens) == s.max_new for r in reqs)


def test_serve_launcher_arch_flags_and_sharded_meshes(capsys):
    """``--arch`` with ``--replicas 2`` and ``--strategy``: a Router over
    two engines, each on the one CPU device, naming the strategy; a
    ``--dp 2`` mesh spawns two gloo ranks, each running every slot on a
    whole copy of the weights, whose streams are the one-rank
    launcher's, token for token (the ``--tp`` meshes:
    ``test_serve_launcher_on_a_rank_mesh_equals_the_reference``)."""
    from repro_torch.launch import serve
    eng, reqs = serve.main(["--arch", "yi-6b", "--replicas", "2",
                            "--strategy", "optimized", "--prompt-len", "8",
                            "--gen", "3", "--batch", "3",
                            "--prefill-chunk", "4"] + CPU)
    out = capsys.readouterr().out
    assert isinstance(eng, Router) and len(eng.engines) == 2
    assert "strategy optimized temperature 0.0 replicas 2 " in out
    assert [e.stats()["strategy"] for e in eng.engines] == ["optimized"] * 2
    assert eng.stats()["n_generated"] == 9
    assert all(len(r.tokens) == 3 for r in reqs)
    flags = ["--arch", "yi-6b", "--prompt-len", "8", "--gen", "3",
             "--batch", "2"] + CPU
    _, one = serve.main(flags)
    stats, reqs = serve.main(flags + ["--dp", "2"])
    assert stats["mesh_shape"] == {"data": 2, "model": 1}
    assert "ranks 2 (gloo)" in capsys.readouterr().out
    assert [r.tokens for r in reqs] == [r.tokens for r in one]


def _reference_requests(monkeypatch, params):
    """Make the reference's engines draw ``params`` (the port's default
    draw, carried across) and keep every request its launcher submits;
    returns that list."""
    import jax.numpy as jnp
    from repro.models.model import Model as JModel
    from repro.serve.engine import Engine as JEngine
    from repro.serve.fleet import Router as JRouter
    whole = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.float().numpy()), params)
    monkeypatch.setattr(JModel, "init", lambda self, key: whole)
    kept = []
    for cls in (JEngine, JRouter):
        submit = cls.submit

        def keep(self, *a, _submit=submit, **k):
            req = _submit(self, *a, **k)
            kept.append(req)
            return req
        monkeypatch.setattr(cls, "submit", keep)
    return kept


@pytest.mark.parametrize("argv", [
    ["--arch", "yi-6b", "--prompt-len", "16", "--gen", "8", "--batch", "4"],
    ["--spec", str(SPECS / "serve_fleet.json")]], ids=["arch", "spec"])
def test_serve_launcher_on_a_rank_mesh_equals_the_reference(
        argv, monkeypatch, capsys):
    """``--dp 2 --tp 2``: the port's launcher spawns four gloo ranks of a
    (data 2, model 2) mesh; the reference's runs on four forced CPU
    devices, its engines drawing the port's weights (each package draws
    its own otherwise).  The printed mesh line, the stats (less the
    port's own keys), the prompts and every request's tokens (bf16 on
    both sides) are the reference's."""
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    _need_8()
    flags = argv + ["--smoke", "--dp", "2", "--tp", "2"]
    arch = load_spec(argv[1]).arch if argv[0] == "--spec" else argv[1]
    params = Model(treg.smoke(arch)).init(
        torch.Generator().manual_seed(0), dtype=torch.bfloat16, device="cpu")
    kept = _reference_requests(monkeypatch, params)
    want = _run_reference(monkeypatch, capsys, flags,
                          module="repro.launch.serve")
    stats, reqs = serve.main(flags + ["--device", "cpu"])
    got = capsys.readouterr().out
    (ghead, gstats), (whead, wstats) = _printed(got), _printed(want)
    assert ghead == whead and "ranks 4 (gloo)" in got
    assert _without_port_keys(gstats) == wstats
    assert _without_port_keys(stats) == wstats
    assert [r.prompt for r in reqs] == [r.prompt for r in kept]
    assert [r.tokens for r in reqs] == [r.tokens for r in kept]
    assert all(r.finished for r in reqs)


def test_serve_launcher_serves_a_sequence_mixer_on_model_2(monkeypatch,
                                                         capsys):
    """``--smoke --dp 1 --tp 2`` with a hybrid (jamba: its Mamba channels,
    attention heads and experts over ``model``): the port's launcher
    spawns two gloo ranks, the reference's runs on two forced CPU
    devices from the port's weights; the printed mesh line, the stats
    (less the port's own keys), the prompts and every request's tokens
    (bf16 on both sides) are the reference's."""
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    _need_8()
    arch = "jamba-v0.1-52b"
    flags = ["--arch", arch, "--prompt-len", "8", "--gen", "4", "--batch",
             "2", "--smoke", "--dp", "1", "--tp", "2"]
    params = Model(treg.smoke(arch)).init(
        torch.Generator().manual_seed(0), dtype=torch.bfloat16, device="cpu")
    kept = _reference_requests(monkeypatch, params)
    want = _run_reference(monkeypatch, capsys, flags,
                          module="repro.launch.serve")
    stats, reqs = serve.main(flags + ["--device", "cpu"])
    got = capsys.readouterr().out
    (ghead, gstats), (whead, wstats) = _printed(got), _printed(want)
    assert ghead == whead and "ranks 2 (gloo)" in got
    assert stats["mesh_shape"] == {"data": 1, "model": 2}
    assert _without_port_keys(gstats) == wstats
    assert [r.prompt for r in reqs] == [r.prompt for r in kept]
    assert [r.tokens for r in reqs] == [r.tokens for r in kept]
    assert all(r.finished and len(r.tokens) == 4 for r in reqs)


def test_engine_takes_the_reference_strategy_and_mesh():
    from repro_torch.configs import STRATEGIES
    from repro_torch.dist.mesh import Mesh
    from repro_torch.serve import EngineConfig
    cfg, ecfg = treg.smoke("yi-6b"), EngineConfig(n_slots=2)
    mesh = tmesh.make_local_mesh(device="cpu")
    eng = Engine(cfg, ecfg, strategy=STRATEGIES["zero3"], mesh=mesh)
    assert eng.device == torch.device("cpu") and eng.mesh is mesh
    st = eng.stats()
    assert st["strategy"] == "zero3" and st["mesh_shape"] == {"data": 1,
                                                            "model": 1}
    default = Engine(cfg, ecfg, device="cpu").stats()
    assert (default["strategy"], default["mesh_shape"]) == (
        "baseline", {"data": 1, "model": 1})
    with pytest.raises(ValueError, match="mesh's device"):
        Engine(cfg, ecfg, mesh=mesh, device="meta")
    # a mesh of several ranks built from a shape alone runs no collective
    with pytest.raises(ValueError, match="make_mesh"):
        Engine(cfg, ecfg, mesh=Mesh((2, 1), ("data", "model")),
               device="cpu")
    with pytest.raises(ValueError, match="make_mesh"):
        Engine(cfg, ecfg, mesh=Mesh((1, 2), ("data", "model")),
               device="cpu")


# ---------------------------------------------------------------------------
# the train launcher
# ---------------------------------------------------------------------------


def test_train_launcher_spec_equals_a_direct_trainer(tmp_path, capsys):
    """``quickstart_train.json`` cut to 2 steps, with the strategy
    ``optimized`` (its hierarchical sync degrades on the (1, 1) mesh
    with the reference's warning): the launcher's losses are a direct
    Trainer's."""
    from repro_torch.comm import CommFallbackWarning
    from repro_torch.configs import STRATEGIES
    from repro_torch.launch import train
    spec = json.loads((SPECS / "quickstart_train.json").read_text())
    spec["train"]["total_steps"] = 2
    spec["strategy"] = "optimized"
    path = tmp_path / "train.json"
    path.write_text(json.dumps(spec))
    with pytest.warns(CommFallbackWarning):
        tr, hist = train.main(["--spec", str(path)] + CPU)
    assert tr.strategy is STRATEGIES["optimized"]
    assert tr.mesh.shape == {"data": 1, "model": 1}
    assert "final loss" in capsys.readouterr().out
    t = spec["train"]
    direct = Trainer(treg.smoke("yi-6b"),
                     TrainConfig(learning_rate=3e-4, total_steps=2,
                                 warmup_steps=1),
                     WorkloadShape("smoke", "train", t["seq_len"],
                                   t["global_batch"]), device="cpu")
    want = direct.run(2, log_every=0)
    assert [h["step"] for h in hist] == [0, 1]
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in want], rtol=1e-6)


# ---------------------------------------------------------------------------
# the examples' twins
# ---------------------------------------------------------------------------


def _twin(name, argv, capsys):
    capsys.readouterr()
    out = runpy.run_path(str(ROOT / "examples" / name))["main"](argv)
    return out, capsys.readouterr().out


def _lines(out, pattern):
    """The printed lines that start with ``pattern``, job ids masked
    (each package numbers its jobs from a counter of its own, which the
    tests before this one in the process have moved)."""
    return [re.sub(r"(job|workload) \d+", r"\1 #", ln)
            for ln in out.splitlines() if re.match(pattern, ln)]


def test_quickstart_twin_equals_the_reference(monkeypatch, capsys):
    _need_8()
    handles, got = _twin("torch_quickstart.py", ["--device", "cpu"], capsys)
    want = _run_reference(monkeypatch, capsys, [],
                          path=ROOT / "examples" / "quickstart.py")
    assert [h.phase for h in handles] == ["Completed"] * 3
    for pattern in (r"MiniCluster ready", r"applied workload",
                    r"job \d+ ", r"queue stats"):
        assert _lines(got, pattern) == _lines(want, pattern), pattern
    assert len(_lines(got, r"job \d+ .*lifecycle Pending -> Bound -> "
                           r"Running -> Completed\)")) == 3


def test_serve_batch_twin_equals_the_reference(monkeypatch, capsys):
    _need_8()
    h, got = _twin("torch_serve_batch.py", ["--device", "cpu"], capsys)
    want = _run_reference(monkeypatch, capsys, [],
                          path=ROOT / "examples" / "serve_batch.py")
    assert h.phase == "Completed"
    assert _lines(got, "lifecycle: ") == _lines(want, "lifecycle: ") == [
        "lifecycle: Pending -> Bound -> Running -> Completed"]

    def served(out):
        ln, = _lines(out, "served ")
        return ln.split(" in ")[0]
    assert served(got) == served(want) == \
        "served 4 requests (2 admitted mid-decode): 48 tokens"


def test_elastic_training_twin_equals_the_reference(monkeypatch, capsys):
    _need_8()
    (h, hist, hist2), got = _twin("torch_elastic_training.py",
                                  ["--steps", "6", "--device", "cpu"], capsys)
    want = _run_reference(monkeypatch, capsys, ["--steps", "6"],
                          path=ROOT / "examples" / "elastic_training.py")
    assert h.phase == "Completed" and len(hist) == 3 and len(hist2) == 6
    for pattern in (r"cluster ready", r"workload \d+ ", r"simulating",
                    r"cluster now", r"trainer ", r"OK: "):
        assert _lines(got, pattern) == _lines(want, pattern), pattern
