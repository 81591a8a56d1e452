"""The port's sharding rule tables, resolvers and activation constraints
(``dist/sharding.py``, ``dist/actsharding.py``) and the comm layer's
overlap model (``comm/overlap.py``) against the JAX package's, on the
CPU.

Held exactly: every rule table for every named strategy and for variants
that flip each toggle the tables read; resolved specs (``tuple`` of the
reference's ``PartitionSpec``) of every parameter, optimizer-state and
cache leaf of five architectures' full configs on the (1, 1), (2, 4),
(8, 1) and (pod 2, data 2, model 2) meshes (jax meshes over the 8 host
devices ``tests/conftest.py`` forces); ``batch_sharding`` and
``activation_spec`` on a grid of shapes and names; and the overlap
schedule and the all-to-all pricing field for field on the cases of
``tests/test_overlap.py``.  All of it is pure Python arithmetic on both
sides, so nothing is held to a tolerance.
"""
import dataclasses
import itertools
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

try:
    import hypothesis.strategies as st
    from hypothesis import HealthCheck, given, settings
except ModuleNotFoundError:        # no extra deps in tier-1: see shim
    from _hypothesis_fallback import HealthCheck, given, settings, st

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import comm as jcomm  # noqa: E402
from repro.comm import bucketing as jbucketing  # noqa: E402
from repro.configs import STRATEGIES as JSTRATEGIES  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.dist import actsharding as jact  # noqa: E402
from repro.dist import sharding as jshd  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import comm as tcomm  # noqa: E402
from repro_torch.comm import bucketing as tbucketing  # noqa: E402
from repro_torch.configs import STRATEGIES as TSTRATEGIES  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.dist import actsharding as tact  # noqa: E402
from repro_torch.dist import sharding as tshd  # noqa: E402
from repro_torch.dist.mesh import Mesh  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402

FAST = settings(max_examples=40, deadline=None,
                suppress_health_check=[HealthCheck.too_slow])

# the toggles the rule tables read, each flipped from the baseline
VARIANTS = {
    "no-tp": dict(tensor_parallel=False),
    "no-ep": dict(expert_parallel=False),
    "hier-moe": dict(hierarchical_moe=True),
    "kv-seq-none": dict(kv_seq_axis="none"),
    "fsdp-no-tp": dict(fsdp_params=True, tensor_parallel=False),
    "seq-shard": dict(seq_shard_activations=True),
}
STRATS = list(TSTRATEGIES) + list(VARIANTS)

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "8x1": ((8, 1), ("data", "model")),
    "pod2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}
ARCHS = ["yi-6b", "granite-moe-1b-a400m", "jamba-v0.1-52b", "xlstm-1.3b",
         "whisper-base"]


def _strategies(name):
    """(port strategy, JAX strategy) of a named strategy or variant."""
    if name in TSTRATEGIES:
        return TSTRATEGIES[name], JSTRATEGIES[name]
    kw = VARIANTS[name]
    return (dataclasses.replace(TSTRATEGIES["baseline"], name=name, **kw),
            dataclasses.replace(JSTRATEGIES["baseline"], name=name, **kw))


def _meshes(name):
    """(port mesh, JAX mesh) of the same shape and axes."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 JAX devices (conftest forces them)")
    shape, axes = MESHES[name]
    return Mesh(shape, axes), jshd.make_mesh(shape, axes)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _same_specs(got, want):
    """A tree of the port's resolved specs against a tree of the JAX
    package's NamedShardings, leaf for leaf."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for path, sh in w.items():
        assert g[path] == tuple(sh.spec), path


# ---------------------------------------------------------------------------
# rule tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", STRATS)
def test_rule_tables_equal_the_reference(name):
    ts, js = _strategies(name)
    assert tshd.param_rules(ts) == jshd.param_rules(js)
    assert tshd.opt_rules(ts) == jshd.opt_rules(js)
    assert tshd.cache_rules(ts) == jshd.cache_rules(js)
    assert tact.act_rules(ts) == jact.act_rules(js)


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_opt_and_cache_specs_equal_the_reference(mesh):
    """Every parameter leaf (param and optimizer rules) and every cache
    leaf (contiguous, and paged where the arch serves) of five full
    configs, under every strategy: the port's resolved spec is
    ``tuple`` of the reference's."""
    tm, jm = _meshes(mesh)
    for arch in ARCHS:
        tcfg, jcfg = treg.get(arch), jreg.get(arch)
        tdefs, jdefs = TModel(tcfg).param_defs(), JModel(jcfg).param_defs()
        enc = 1500 if tcfg.encoder_layers else 0
        tcache = ttf.cache_defs(tcfg, 8, 1024, enc)
        jcache = jtf.cache_defs(jcfg, 8, 1024, enc)
        if not tcfg.encoder_layers:
            tcache["paged"] = ttf.paged_cache_defs(tcfg, 8, 513, 16)
            jcache["paged"] = jtf.paged_cache_defs(jcfg, 8, 513, 16)
        for name in STRATS:
            ts, js = _strategies(name)
            for tr, jr in ((tshd.param_rules(ts), jshd.param_rules(js)),
                           (tshd.opt_rules(ts), jshd.opt_rules(js))):
                _same_specs(tshd.tree_shardings(tdefs, tm, tr),
                            jshd.tree_shardings(jdefs, jm, jr))
            _same_specs(tshd.cache_shardings(tcache, tm, ts),
                        jshd.cache_shardings(jcache, jm, js))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_sharding_and_activation_spec_equal_the_reference(mesh):
    tm, jm = _meshes(mesh)
    act_cases = [
        ((8, 128, 4096), ("act_batch", "act_seq", None)),
        ((8, 128, 14336), ("act_batch", None, "act_ff")),
        ((8, 128, 32, 128), ("act_batch", None, "act_heads", None)),
        ((8, 1024, 4, 128), ("act_batch", "act_kv_seq", "act_kv", None)),
        ((8, 128, 64000), ("act_batch", None, "act_vocab")),
        ((2, 40, 64, 4096), ("act_expert_home", "act_expert", None, None)),
        ((4, 6, 2048), ("act_batch", "act_seq_force", "act_inner")),
        ((3, 7, 5), ("act_batch", "act_seq_force", "act_heads")),
        ((16, 12), ("act_expert", "act_batch")),
    ]
    for name in STRATS:
        ts, js = _strategies(name)
        assert tshd.replicated(tm) == tuple(jshd.replicated(jm).spec)
        for ndim, gb, seq_dim in itertools.product(
                (2, 3), (1, 2, 3, 4, 6, 8, 16, 32), (None, 1)):
            got = tshd.batch_sharding(tm, ndim, gb, ts, seq_dim=seq_dim)
            want = jshd.batch_sharding(jm, ndim, gb, js, seq_dim=seq_dim)
            assert got == tuple(want.spec), (name, ndim, gb, seq_dim)
        for shape, names in act_cases:
            got = tact.activation_spec(tm, ts, shape, *names)
            want = jact.activation_spec(jm, js, shape, *names)
            assert got == tuple(want), (name, shape, names)


@FAST
@given(st.tuples(st.integers(1, 512), st.integers(1, 512)),
       st.sampled_from([("embed", "ff"), ("vocab", "embed"),
                        ("heads", None), ("expert", "embed")]),
       st.sampled_from(list(MESHES)), st.sampled_from(STRATS))
def test_resolve_spec_equals_the_reference_and_divides(shape, axes, mesh,
                                                       name):
    """``tests/test_properties.py``'s divisibility property on the port's
    resolver, over every mesh and strategy, with its spec the
    reference's."""
    tm, jm = _meshes(mesh)
    ts, js = _strategies(name)
    spec = tshd.resolve_spec(shape, axes, tshd.param_rules(ts), tm)
    assert spec == tuple(jshd.resolve_spec(shape, axes,
                                           jshd.param_rules(js), jm))
    seen = []
    for dim, s in zip(shape, spec):
        if s is None:
            continue
        axes_used = s if isinstance(s, tuple) else (s,)
        seen.extend(axes_used)
        assert dim % int(np.prod([tm.shape[a] for a in axes_used])) == 0
    assert len(seen) == len(set(seen))


# ---------------------------------------------------------------------------
# activation constraints
# ---------------------------------------------------------------------------


def test_constrain_is_the_identity_off_mesh_and_on_one_device():
    x = torch.zeros(8, 16, 64)
    names = ("act_batch", "act_seq", "act_ff")
    assert tact.current() is None
    assert tact.constrain(x, *names) is x
    assert tact.model_axis_divides(3)
    one = Mesh((1, 1), ("data", "model"))
    with tact.activation_sharding(one, TSTRATEGIES["optimized"]) as ctx:
        assert tact.current() is ctx
        assert tact.constrain(x, *names) is x
        assert tact.model_axis_divides(3)
        with pytest.raises(ValueError, match="rank-3"):
            tact.constrain(x, "act_batch", None)
    assert tact.current() is None


def test_constrain_raises_where_the_spec_would_shard():
    """Where the spec would shard, ``constrain`` is the identity too: a
    rank holds what its own computation makes (tensor parallelism places
    the weights, tests/test_torch_tp.py), and only the rank check
    raises."""
    x = torch.zeros(8, 16, 64)
    mesh = Mesh((2, 4), ("data", "model"))
    with tact.activation_sharding(mesh, TSTRATEGIES["baseline"]):
        assert not tact.model_axis_divides(6)
        # nothing divides: every dim replicates, the identity
        y = torch.zeros(3, 5, 7)
        assert tact.constrain(y, "act_batch", None, "act_ff") is y
        assert tact.activation_spec(mesh, TSTRATEGIES["baseline"], x.shape,
                                    "act_batch", None, "act_ff") == (
            "data", None, "model")
        assert tact.constrain(x, "act_batch", None, "act_ff") is x
        with pytest.raises(ValueError, match="rank-3"):
            tact.constrain(x, "act_batch", None)
        # a mesh of one process's shapes runs no collective
        assert tact.on_ranks() is None and tact.tp() == (None, 1)
    assert tact.current() is None


# ---------------------------------------------------------------------------
# the overlap schedule and the all-to-all pricing
# ---------------------------------------------------------------------------


def _mesh_stub(pod, data, model):
    return SimpleNamespace(shape={"pod": pod, "data": data, "model": model})


def _trees(block_dims, embed_rows, enc_rows):
    """``tests/test_overlap.py``'s transformer-shaped PDef tree, built in
    each package."""
    out = []
    for PDef in (TP.PDef, JP.PDef):
        defs = {"embed": {"w": PDef((embed_rows, 8), ("vocab", "embed"))},
                "encoder": {"w": PDef((enc_rows, 4), (None, None))},
                "blocks": {}}
        for i, rows in enumerate(block_dims):
            defs["blocks"][f"p{i}"] = {
                "a": PDef((rows, 16), ("embed", "ff")),
                "b": PDef((16, rows), ("ff", "embed"))}
        out.append(defs)
    return out


def _schedules(block_dims, embed_rows, enc_rows, n_buckets, backward_s,
               compress=False, mesh=(2, 2, 2)):
    tdefs, jdefs = _trees(block_dims, embed_rows, enc_rows)
    got = tcomm.schedule_overlap(
        tcomm.CommTopology.from_mesh(_mesh_stub(*mesh)),
        tbucketing.partition_buckets(tdefs, n_buckets),
        backward_s=backward_s, compress=compress)
    want = jcomm.schedule_overlap(
        jcomm.CommTopology.from_mesh(_mesh_stub(*mesh)),
        jbucketing.partition_buckets(jdefs, n_buckets),
        backward_s=backward_s, compress=compress)
    return got, want


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("n_buckets,bw_us", [(1, 1), (3, 250), (5, 7_000),
                                             (8, 50_000)])
def test_schedule_overlap_equals_the_reference(n_buckets, bw_us, compress):
    """The event-model case of ``tests/test_overlap.py``: the schedule,
    its summary and its metrics, field for field."""
    from repro.obs.metrics import MetricsRegistry as JRegistry
    from repro_torch.comm import overlap as toverlap
    from repro_torch.obs.metrics import MetricsRegistry as TRegistry
    got, want = _schedules([8, 16, 32], 256, 16, n_buckets, bw_us * 1e-6,
                           compress)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.hidden_frac, got.n_buckets) == (want.hidden_frac,
                                                want.n_buckets)
    assert toverlap.summarize(got) == jcomm.overlap.summarize(want)
    treg_, jreg_ = TRegistry(), JRegistry()
    toverlap.to_metrics(treg_, got)
    jcomm.overlap.to_metrics(jreg_, want)
    assert treg_.snapshot() == jreg_.snapshot()


def test_schedule_overlap_bench_magnitudes_equal_the_reference():
    for nb in (1, 4, 8):
        got, want = _schedules([64, 64, 64, 64], 128, 16, nb, 20e-3)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), nb


@pytest.mark.parametrize("pods", [1, 2, 4])
def test_a2a_pricing_equals_the_reference(pods):
    """``estimate_a2a_bytes`` on ``tests/test_overlap.py``'s grid, flat
    and hierarchical, a pod-less mesh included."""
    ttopo = tcomm.CommTopology.from_mesh(_mesh_stub(pods, 2, 2))
    jtopo = jcomm.CommTopology.from_mesh(_mesh_stub(pods, 2, 2))
    for n_tokens, top_k, n_experts, cf, d_model, hier in itertools.product(
            (8, 128, 2048), (1, 2, 4), (4, 8, 16), (1.0, 1.25, 3.0),
            (64, 256), (False, True)):
        capacity = max(1, int(-(-n_tokens * top_k * cf // n_experts)))
        kw = dict(n_tokens=n_tokens, d_model=d_model, n_experts=n_experts,
                  capacity=capacity, top_k=top_k, hierarchical=hier)
        assert tcomm.estimate_a2a_bytes(ttopo, **kw) == \
            jcomm.estimate_a2a_bytes(jtopo, **kw), kw
