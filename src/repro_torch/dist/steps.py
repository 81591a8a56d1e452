"""The train step: the port of the JAX package's ``dist/steps.py``
train-state schema, shardings, init and train step.

Train state is a plain dict ``{"params", "opt", "step"}`` (plus
``"comm"`` under a compressing strategy) with PDef schemas behind it,
as in the JAX package, so the checkpoint manager can build templates
and a checkpoint carries across both packages.

On a mesh of one rank the step runs the whole batch on one device.  On
a mesh of several ranks (``dist.mesh``: any of ``pod``, ``data`` and
``model``) each rank holds exactly the shard of every parameter and
optimizer leaf that the rule tables resolve for it
(:func:`train_state_shardings`): the ``model`` axis splits heads, the
FFN, the vocabulary and the experts (tensor and expert parallelism, the
layers' collectives in ``comm.collectives``), ``data`` splits a leaf
under FSDP (gathered per layer) and the optimizer state under ZeRO-1,
and ``pod`` the experts under hierarchical MoE dispatch.  Each rank runs
its rows of the batch; gradients are synced leaf by leaf over the batch
axes that do not shard the leaf: through the comm layer's two-phase
``sync_grads`` where the strategy asks for it and the mesh has a pod
tier, else by all-reduce.  The step computes what the single-device
step computes.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import comm
from repro_torch.configs.base import (BASELINE, ModelConfig,
                                      ShardingStrategy, TrainConfig,
                                      WorkloadShape)
from repro_torch.device import resolve_device
from repro_torch.dist import mesh as dmesh
from repro_torch.dist import sharding as shd
from repro_torch.dist.actsharding import activation_sharding
from repro_torch.models import params as P
from repro_torch.models.model import VISION_PATCHES, Model
from repro_torch.optim import make_optimizer, opt_state_defs

METRIC_KEYS = ("loss", "xent", "moe_aux")


def train_state_defs(cfg: ModelConfig,
                     strategy: Optional[ShardingStrategy] = None) -> Dict:
    """State schema.  A strategy with ``compress_cross_pod`` adds the
    comm layer's error-feedback residual under ``comm/ef``, schema'd by
    (cfg, strategy) alone, never by the live mesh."""
    model_defs = Model(cfg).param_defs()
    defs = {"params": model_defs, "opt": opt_state_defs(cfg, model_defs)}
    if strategy is not None and strategy.compress_cross_pod:
        defs["comm"] = {"ef": comm.ef_defs(model_defs, strategy)}
    return defs


def abstract_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                         strategy: Optional[ShardingStrategy] = None) -> Dict:
    """Shapes and dtypes of the whole train state, as ``meta`` tensors
    (the residual with all its ``(pods, ...)`` rows, as a checkpoint
    holds it)."""
    defs = train_state_defs(cfg, strategy)
    out = {"params": P.abstract_params(defs["params"],
                                       P.DTYPES[tcfg.param_dtype]),
           "opt": P.abstract_params(defs["opt"]),
           "step": torch.empty((), dtype=torch.int32, device="meta")}
    if "comm" in defs:
        out["comm"] = P.abstract_params(defs["comm"])
    return out


def train_state_shardings(cfg: ModelConfig, strategy: ShardingStrategy,
                          mesh: dmesh.Mesh) -> Dict:
    """The resolved spec of every leaf of the train state (the
    reference's ``NamedSharding`` tree as plain tuples): parameters by
    ``param_rules``, optimizer state by ``opt_rules`` (ZeRO-1), the
    residual by ``comm.grad_rules``."""
    defs = train_state_defs(cfg, strategy)
    out = {"params": shd.tree_shardings(defs["params"], mesh,
                                        shd.param_rules(strategy)),
           "opt": shd.tree_shardings(defs["opt"], mesh,
                                     shd.opt_rules(strategy)),
           "step": shd.replicated(mesh)}
    if "comm" in defs:
        out["comm"] = shd.tree_shardings(defs["comm"], mesh,
                                         comm.grad_rules(strategy))
    return out


def input_shapes(cfg: ModelConfig, shape: WorkloadShape) -> Dict:
    """The model inputs of one (arch, shape) cell: name -> shape (the
    reference's ``input_specs``)."""
    b, s = shape.global_batch, shape.seq_len
    out = ({"tokens": (b, s), "labels": (b, s)} if shape.kind == "train"
           else {"tokens": (b, s if shape.kind == "prefill" else 1)})
    if cfg.encoder_layers and shape.kind != "decode":
        out["frames"] = (b, s // max(cfg.encoder_seq_divisor, 1),
                         cfg.d_model)
    if cfg.frontend == "vision" and shape.kind != "decode":
        out["patches"] = (b, min(VISION_PATCHES, s // 2), cfg.d_model)
    return out


def batch_shardings(cfg: ModelConfig, shape: WorkloadShape,
                    strategy: ShardingStrategy, mesh: dmesh.Mesh) -> Dict:
    return {k: shd.batch_sharding(mesh, len(v), v[0], strategy)
            for k, v in input_shapes(cfg, shape).items()}


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                     generator: Optional[torch.Generator] = None,
                     device=None, *,
                     strategy: Optional[ShardingStrategy] = None,
                     mesh: Optional[dmesh.Mesh] = None) -> Dict:
    """Random parameters from ``generator`` (default: seeded with
    ``tcfg.seed`` on the device), zero optimizer state, step 0, and a
    zero residual.  On a mesh the whole state is drawn from the same
    generator as a one-rank init, leaf by leaf, and each rank keeps its
    shard of each (:func:`train_state_shardings`), so both compute the
    same thing.  Runs on CUDA unless ``device`` says otherwise."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(tcfg.seed)
    defs = train_state_defs(cfg, strategy)
    specs = None
    if mesh is not None and mesh.size > 1:
        specs = train_state_shardings(cfg, strategy or BASELINE, mesh)

    def keep(rules):
        if specs is None:
            return None
        return lambda d, t: shd.shard(
            t, shd.resolve_spec(d.shape, d.axes, rules, mesh), mesh)

    st = strategy or BASELINE
    out = {"params": P.init_params(defs["params"], generator,
                                   P.DTYPES[tcfg.param_dtype], device,
                                   local=keep(shd.param_rules(st))),
           "opt": P.init_params(defs["opt"], generator, torch.float32,
                                device, local=keep(shd.opt_rules(st))),
           "step": torch.zeros((), dtype=torch.int32, device=device)}
    if "comm" in defs:
        out["comm"] = P.init_params(defs["comm"], generator, torch.float32,
                                    device, local=keep(comm.grad_rules(st)))
    return out


def _row_bounds(rows: int, world: int):
    """Rows ``[b[r], b[r+1])`` of a microbatch of ``rows`` go to batch
    shard r."""
    return [rows * r // world for r in range(world + 1)]


def _axes_of(spec) -> Tuple[str, ...]:
    return tuple(a for e in spec for a in shd.entry_axes(e))


class _LeafPlan:
    """How one parameter leaf's gradient is synced and updated on a mesh
    of ranks (built from its resolved specs alone, so every rank agrees):

    * ``reduce``: the batch axes its gradient is summed over (those that
      do not shard it: the FSDP gather's backward already reduce-scattered
      the ones that do, and the experts' exchange gathered every pod's
      tokens);
    * ``how``: ``"sync"`` (``comm.sync_grads``: reduce-scatter over
      ``data``, all-reduce or int8 across ``pod``, all-gather back),
      ``"pod"`` (the pod phase alone, for a leaf split over ``data``),
      or ``"sum"`` (an all-reduce over each axis of ``reduce``);
    * ``zero1``: ``(dim, axes)`` where the optimizer state splits the
      leaf further than the parameter (ZeRO-1): the update runs on that
      slice, and the parameter is all-gathered back over ``axes``; where
      the gradient is summed over those axes anyway (``"sum"``), it is
      reduce-scattered to the slice instead (``scattered``);
    * ``norm``: the axes sharding the updated slice, for the global
      norm; ``fsdp``: the residual's spec on this leaf's ``data``-split
      dims (``"pod"`` leaves)."""

    def __init__(self, pspec, ospec, mesh, batch, policy):
        live = lambda axes: tuple(a for a in axes if mesh.shape[a] > 1)
        paxes = set(_axes_of(pspec))
        self.reduce = live(tuple(a for a in batch if a not in paxes))
        data_live = live(("data",) if "data" in mesh.shape else ())
        if policy.hierarchical and "pod" in self.reduce and (
                set(data_live) <= set(self.reduce)):
            self.how = "sync"
        elif policy.hierarchical and "pod" in self.reduce:
            self.how = "pod"
        else:
            self.how = "sum"
        self.fsdp = tuple(
            tuple(a for a in shd.entry_axes(e) if a in batch and a != "pod")
            or None for e in pspec)
        self.zero1 = []
        for dim, (pe, oe) in enumerate(zip(pspec, ospec)):
            pa, oa = shd.entry_axes(pe), shd.entry_axes(oe)
            if oa != pa:
                if oa[:len(pa)] != pa:
                    raise NotImplementedError(
                        f"optimizer spec {ospec} does not refine the "
                        f"parameter's {pspec}")
                extra = live(oa[len(pa):])
                if extra:
                    self.zero1.append((dim, extra))
        self.scattered = self.how == "sum" and bool(self.zero1) and all(
            set(axes) <= set(self.reduce) for _, axes in self.zero1)
        self.norm = live(_axes_of(ospec))


def _paths(tree, prefix=()):
    """Key paths of the tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _paths(tree[k],
                                                        prefix + (k,))]
    return [prefix]


def _subtree(paths, idx, leaves):
    """The nested dict holding ``leaves[i]`` at ``paths[i]`` for each i
    in ``idx``."""
    out: Dict = {}
    for i in idx:
        node = out
        for k in paths[i][:-1]:
            node = node.setdefault(k, {})
        node[paths[i][-1]] = leaves[i]
    return out


def _pod_view(mesh):
    """The mesh's ``pod`` tier alone, for a sync whose ``data`` phase
    already ran (a leaf split over ``data``)."""
    return dmesh.Mesh((mesh.shape["pod"],), ("pod",), mesh.coords["pod"],
                      {"pod": mesh.group("pod")})


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                     shape: WorkloadShape, *,
                     strategy: ShardingStrategy = BASELINE,
                     mesh: Optional[dmesh.Mesh] = None):
    """Returns ``step_fn(state, batch) -> (state, metrics)``.

    ``batch`` holds the GLOBAL batch's ``tokens`` and ``labels`` (B, S),
    and an encoder-decoder's ``frames`` or a vision frontend's
    ``patches`` (B, ..., d_model), on the state's device, the same on
    every rank; every entry is cut by rows alike; metrics are float32
    scalars (loss, xent, moe_aux, grad_norm, lr), the same on every rank.
    With ``tcfg.grad_accum > 1`` the batch is cut into that many
    microbatches of consecutive rows whose float32 gradients and metrics
    are averaged.  On a mesh of ranks the batch axes (``pod`` and
    ``data``, and ``model`` without tensor parallelism) cut each
    microbatch: batch shard r (rank-major over those axes, pod-major)
    takes rows ``[r*b, (r+1)*b)`` of each microbatch of n*b rows, chunk
    (microbatch, shard) in the JAX package's ``(accum, pod, data)``
    order, and the ranks of ``model`` run the same rows on their shards
    of the layers.  Gradients are synced before the update, leaf by leaf
    (:class:`_LeafPlan`):

    * through ``comm.sync_grads`` (``comm.sync_grads_bucketed`` with
      ``strategy.comm_buckets > 1``) when ``comm.resolve_policy`` says
      hierarchical: two-phase, optionally with int8 error feedback on
      the cross-pod hop, the residual carried in ``state["comm"]``;
    * otherwise through all-reduces over the batch axes, each rank's
      share weighted by its rows (a batch that does not divide over the
      shards splits as evenly as it can).

    The state is updated in place (see ``optim``) and returned.  The
    kernels or their plain versions run by the state's device
    (``kernels/ops``).  Every block kind trains: a Mamba position through
    ``models.mamba.SelectiveScan``'s recompute backward, mLSTM and sLSTM
    by autograd, on a ``model`` axis too (their tensor parallelism:
    ``models/mamba.py``, ``models/xlstm.py``)."""
    mesh = mesh if mesh is not None else dmesh.make_mesh((1,), ("data",))
    model = Model(cfg)
    update = make_optimizer(cfg, tcfg)
    cdt = P.DTYPES[tcfg.compute_dtype]
    ga = max(tcfg.grad_accum, 1)
    if shape.global_batch % ga:
        raise ValueError(f"global batch {shape.global_batch} does not "
                         f"divide into grad_accum={ga} microbatches")
    batch_ax = dmesh.batch_axes(mesh, strategy.tensor_parallel)
    n_shards = dmesh.axis_size(mesh, batch_ax)
    dp_world = dmesh.axis_size(mesh, dmesh.data_axes(mesh))
    specs = train_state_shardings(cfg, strategy, mesh)
    if mesh.size > 1 and cfg.optimizer == "adafactor" and any(
            shd.local_shape(d.shape, sp, mesh) != tuple(d.shape)
            for d, sp in zip(P.tree_leaves(train_state_defs(cfg)["opt"]),
                             P.tree_leaves(specs["opt"]))):
        raise NotImplementedError(
            f"{cfg.name}: Adafactor's factored moments on sharded leaves "
            "(ROADMAP Queue 1 item 5(e))")

    policy = comm.resolve_policy(strategy, mesh)
    n_chunks = ga * dp_world
    if policy.hierarchical and (shape.global_batch % (ga * n_shards) != 0
                                or shape.global_batch % n_chunks != 0):
        comm.degrade(strategy, f"global batch {shape.global_batch} does "
                     f"not divide into {n_chunks} chunks "
                     f"(grad_accum={ga} x dp={dp_world})", mesh=mesh)
        policy = comm.CommPolicy()
    mb_rows = shape.global_batch // ga
    bounds = _row_bounds(mb_rows, n_shards)
    shard_idx = int(np.ravel_multi_index(
        tuple(mesh.coords[a] for a in batch_ax),
        tuple(mesh.shape[a] for a in batch_ax))) if batch_ax else 0
    lo, hi = bounds[shard_idx], bounds[shard_idx + 1]
    if hi == lo:
        raise ValueError(f"a microbatch of {mb_rows} rows leaves batch "
                         f"shard {shard_idx} of {n_shards} none")
    weight = (hi - lo) / mb_rows              # this rank's share of a mean
    even = mb_rows % n_shards == 0
    defs = model.param_defs()
    paths = _paths(defs)
    pspecs = P.tree_leaves(specs["params"])
    # Adafactor's factored moments never split here (refused above)
    ospecs = (P.tree_leaves(specs["opt"]["m"]) if "m" in specs["opt"]
              else pspecs)
    plans = ([_LeafPlan(ps, os_, mesh, batch_ax, policy)
              for ps, os_ in zip(pspecs, ospecs)]
             if mesh.size > 1 else None)
    # the flat sync weights each rank's rows into the mean before the
    # backward (a gradient an FSDP gather reduce-scatters is then the
    # mean already); the hierarchical one takes per-chunk means
    scale = 1.0 if policy.hierarchical or n_shards == 1 else weight

    def grads_and_metrics(params, leaves, mb):
        with activation_sharding(mesh, strategy,
                                 global_rows=mb_rows if even else None):
            loss, metrics = model.loss(params, mb, remat=tcfg.remat,
                                       compute_dtype=cdt)
            grads = torch.autograd.grad(loss * scale if scale != 1.0
                                        else loss, leaves)
        return list(grads), {k: metrics[k].detach().float()
                             for k in METRIC_KEYS}

    def local_grads(params, leaves, batch):
        """This rank's rows of every microbatch: float32 gradients and
        metrics, averaged over the microbatches."""
        if ga == 1 and n_shards == 1:
            return grads_and_metrics(params, leaves, batch)
        grads, metrics = None, None
        for i in range(ga):
            a, b = i * mb_rows + lo, i * mb_rows + hi
            mb = {k: v[a:b] for k, v in batch.items()}
            g, m = grads_and_metrics(params, leaves, mb)
            if grads is None:
                grads, metrics = [x.float() for x in g], m
            else:
                for acc, x in zip(grads, g):
                    acc.add_(x.float())
                metrics = {k: metrics[k] + m[k] for k in METRIC_KEYS}
        if ga > 1:
            for g in grads:
                g.div_(ga)
            metrics = {k: v / ga for k, v in metrics.items()}
        return grads, metrics

    def sync(state, grads):
        """Each leaf's gradient summed over the batch axes its plan
        names (in place where it can)."""
        residual = (state["comm"]["ef"]
                    if policy.compress and "comm" in state else None)
        res_leaves = (P.tree_leaves(residual) if residual is not None
                      else [None] * len(grads))
        idx = [i for i, pl in enumerate(plans) if pl.how == "sync"]
        if idx:
            # one call over every such leaf, the tree's key paths kept
            # (bucketed in reverse-layer order when asked)
            sub = lambda leaves: _subtree(paths, idx, leaves)
            run = (comm.sync_grads_bucketed if policy.buckets > 1
                   else comm.sync_grads)
            synced, new_res = run(
                sub([g[None] for g in grads]), sub(P.tree_leaves(defs)),
                mesh, policy, strategy,
                residual=None if residual is None else sub(res_leaves))
            synced = P.tree_leaves(synced)
            new_res = P.tree_leaves(new_res) if residual is not None else ()
            for j, i in enumerate(idx):
                grads[i] = synced[j]
                if residual is not None:
                    res_leaves[i].copy_(new_res[j])
        pod_mesh = None
        for i, pl in enumerate(plans):
            g = grads[i]
            if pl.how == "pod":
                # the data phase ran in the FSDP gather's backward: the
                # pod phase of ``sync_grads`` on this rank's slice, the
                # payload its pod's mean (the data tier's sum / D)
                pod_mesh = pod_mesh or _pod_view(mesh)
                d_size = mesh.shape.get("data", 1)
                e = res_leaves[i]
                e_loc = (shd.shard(e[0], pl.fsdp, mesh)[None]
                         if e is not None else None)
                one = {"g": (g / d_size)[None]}
                got, new_e = comm.sync_grads(
                    one, {"g": P.PDef(tuple(g.shape), (None,) * g.dim())},
                    pod_mesh, policy, strategy,
                    residual=None if e_loc is None else {"g": e_loc})
                grads[i] = got["g"]
                if e is not None:
                    e.copy_(shd.gather(new_e["g"][0], pl.fsdp, mesh)[None])
            # the batch axes the two-phase sync leaves (``model`` without
            # tensor parallelism), or all of the plan's: the ZeRO-1 slice's
            # axes by reduce-scatter where the plan says so
            rest = (pl.reduce if pl.how == "sum" else tuple(
                a for a in pl.reduce if a not in dmesh.DATA_AXES))
            if pl.scattered:
                for dim, axes in pl.zero1:
                    for a in axes:
                        grads[i] = comm.collectives.scatter_along(
                            grads[i], dim, mesh, a)
                    rest = tuple(a for a in rest if a not in axes)
            comm.collectives.sum_over(grads[i], mesh, rest)
            if policy.hierarchical:
                # per-chunk means came in: a plain sum covered every
                # batch shard once (this leaf's own axes in its backward:
                # an FSDP reduce-scatter, the experts' exchange), the
                # synced ones are means over pod and data already
                n = (n_shards if pl.how == "sum"
                     else dmesh.axis_size(mesh, rest))
                if n > 1:
                    grads[i].div_(n)
        return grads

    def apply_update(state, params, grads):
        """AdamW or Adafactor on each leaf's optimizer slice; a ZeRO-1
        leaf's updated slice is all-gathered back into the parameter."""
        leaves = P.tree_leaves(params)
        if plans is None:
            return update(P.tree_unflatten(params, grads), state["opt"],
                          params, state["step"])
        g_view, p_view = [], []
        for g, p, pl in zip(grads, leaves, plans):
            for dim, axes in pl.zero1:
                k = p.shape[dim] // dmesh.axis_size(mesh, axes)
                at = shd.shard_index(axes, mesh) * k
                p = p.narrow(dim, at, k)
                if not pl.scattered:
                    g = g.narrow(dim, at, k)
            g_view.append(g)
            p_view.append(p)
        out = update(P.tree_unflatten(params, g_view), state["opt"],
                     P.tree_unflatten(params, p_view), state["step"],
                     norm_axes=[pl.norm for pl in plans], mesh=mesh)
        for p, v, pl in zip(leaves, p_view, plans):
            for dim, axes in reversed(pl.zero1):
                whole = v.contiguous()
                for a in reversed(axes):
                    whole = comm.collectives.gather_along(whole, dim, mesh,
                                                           a)
                p.copy_(whole)
        return out

    def step_fn(state, batch):
        params = state["params"]
        leaves = P.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        grads, metrics = local_grads(params, leaves, batch)
        with torch.no_grad():
            if n_shards > 1:
                m = torch.stack([metrics[k] for k in METRIC_KEYS]) * weight
                comm.collectives.sum_over(m, mesh, batch_ax)
                metrics = dict(zip(METRIC_KEYS, m.unbind()))
            if plans is not None:
                grads = sync(state, grads)
            _, _, stats = apply_update(state, params, grads)
            state["step"] += 1
        return state, dict(metrics, grad_norm=stats["grad_norm"],
                           lr=stats["lr"])

    return step_fn


# --------------------------------------------------------------------------
# Serving placement (the engine's params, pool, block table and logits)
# --------------------------------------------------------------------------


def serving_param_shardings(cfg: ModelConfig, strategy: ShardingStrategy,
                            mesh: dmesh.Mesh) -> Dict:
    """The resolved spec of every parameter leaf of a serving engine:
    ``param_rules`` over the model's PDef tree (the reference's
    ``_serving_param_shardings``)."""
    return shd.tree_shardings(Model(cfg).param_defs(), mesh,
                              shd.param_rules(strategy))


def paged_cache_shardings(cfg: ModelConfig, layout, n_slots: int,
                          strategy: ShardingStrategy, mesh: dmesh.Mesh):
    """The resolved spec of every leaf of the paged pool of ``layout``
    (a ``serve.paging.PagedLayout``): ``cache_rules`` over
    ``paged_cache_defs``, whose page dim is named (and so split over the
    data tier) only when the layout has several shards."""
    from repro_torch.models import transformer
    defs = transformer.paged_cache_defs(cfg, n_slots, layout.n_pages,
                                        layout.page_size,
                                        n_shards=layout.n_shards)
    return shd.cache_shardings(defs, mesh, strategy)


def paged_table_shardings(mesh: dmesh.Mesh, layout, n_slots: int):
    """(block table spec, lengths spec): the slots split over the data
    tier when the pool's shards are the data tier's (``layout.n_shards``
    equal to its size, dividing ``n_slots``), so each data shard's rows
    name only its own pages; else nothing split."""
    d = dmesh.data_axes(mesh)
    if (layout.n_shards > 1 and d
            and dmesh.axis_size(mesh, d) == layout.n_shards
            and n_slots % layout.n_shards == 0):
        ax = d[0] if len(d) == 1 else d
        return (ax, None), (ax,)
    return shd.replicated(mesh), shd.replicated(mesh)


def logits_sharding(cfg: ModelConfig, n_rows: int,
                    strategy: ShardingStrategy, mesh: dmesh.Mesh):
    """The spec of a serving step's ``(n_rows, vocab)`` logits: rows over
    the data tier, the vocabulary over ``model`` (the reference's
    ``_logits_sharding``)."""
    from repro_torch.dist.actsharding import activation_spec
    return activation_spec(mesh, strategy, (n_rows, cfg.vocab_size),
                           "act_batch", "act_vocab")
