"""The port's serving stack: allocator and scheduler units, the Engine
against JAX greedy references, chunked against legacy, and isolation of
the port from the JAX package.
"""
import ast
import functools
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import (Engine, EngineConfig, PageAllocator,  # noqa: E402
                               PagedLayout, sample_tokens)
from repro_torch.serve.scheduler import (Request, Scheduler,  # noqa: E402
                                         StreamError, SubmitError, WAITING)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JTINY = JModelConfig(name="tiny", family="dense", n_layers=2, d_model=32,
                     n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128)
TINY = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=32,
                   n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128)
ECFG = dict(n_slots=2, page_size=4, max_seq_len=32, max_prompt_len=8)
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9, 10, 11, 12, 13], [2, 4]]
NEW = [8, 6, 5]


@pytest.fixture(scope="module")
def params():
    jp = JModel(JTINY).init(jax.random.PRNGKey(0))
    return jp, P.from_numpy(jax.device_get(jp))


def _jax_greedy_f32(jp, prompt, gen, cap=32):
    """Reference: the prompt alone through the JAX contiguous-cache path
    at float32 compute (right-padded prefill, exact for attention-only
    archs).  The cache is rounded to bf16 after the prefill, the type a
    page pool holds."""
    m = JModel(JTINY)
    toks = np.zeros((1, cap), np.int32)
    toks[0, :len(prompt)] = prompt
    logits, cache = m.prefill(jp, {"tokens": jnp.asarray(toks)},
                              compute_dtype=jnp.float32,
                              last_index=jnp.array([len(prompt) - 1]))
    cache = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), cache)
    step = jax.jit(functools.partial(m.decode_step,
                                     compute_dtype=jnp.float32))
    out = [int(jnp.argmax(logits[0]))]
    for i in range(gen - 1):
        logits, cache = step(jp, cache, jnp.asarray([[out[-1]]], jnp.int32),
                             jnp.int32(len(prompt) + i))
        out.append(int(jnp.argmax(logits[0])))
    return out


@pytest.fixture(scope="module")
def jax_refs(params):
    return [_jax_greedy_f32(params[0], p, n) for p, n in zip(PROMPTS, NEW)]


def _drive(eng):
    """Submit the first two prompts, decode a little, then submit the
    third mid-decode (two slots: it waits for an eviction and then reuses
    the freed pages)."""
    reqs = [eng.submit(p, max_new_tokens=n)
            for p, n in zip(PROMPTS[:2], NEW[:2])]
    while eng.scheduler.prefilling or not reqs[0].tokens:
        eng.step()
    eng.step()
    assert not reqs[0].finished and reqs[0].tokens
    reqs.append(eng.submit(PROMPTS[2], max_new_tokens=NEW[2]))
    eng.run()
    assert all(r.finished for r in reqs)
    assert eng.alloc.pages_in_use() == 0
    return [r.tokens for r in reqs]


# ---------------------------------------------------------------------------
# Page allocator / scheduler units
# ---------------------------------------------------------------------------


def test_allocator_lifecycle_and_page_reuse():
    alloc = PageAllocator(2, PagedLayout(page_size=4, pages_per_slot=4,
                                         n_pages=9))
    s0 = alloc.admit(5, 3)
    assert alloc.pages_in_use() == 2 and alloc.lengths[s0] == 5
    alloc.lengths[s0] = 8
    alloc.ensure_page(s0)                  # position 8 opens a third page
    assert alloc.pages_in_use() == 3
    used = {int(p) for p in alloc.block_table[s0] if p != 0}
    alloc.free(s0)
    assert alloc.pages_in_use() == 0 and alloc.lengths[s0] == 0
    s1 = alloc.admit(12, 0)                # LIFO: freed pages come back first
    assert {int(p) for p in alloc.block_table[s1] if p != 0} == used


def test_allocator_admission_is_length_aware():
    alloc = PageAllocator(2, PagedLayout(page_size=4, pages_per_slot=4,
                                         n_pages=5))
    assert not alloc.can_admit(9, 8)       # 17 tokens > 16-token slot
    alloc.admit(5, 7)                      # reserves 3 of 4 usable pages
    assert not alloc.can_admit(4, 1) and alloc.can_admit(3, 1)


def test_submit_errors_collect_every_problem():
    sched = Scheduler(PageAllocator(2, PagedLayout(4, 4, 4)), max_prompt_len=8)
    with pytest.raises(SubmitError) as exc:
        sched.submit(Request(prompt=[], max_new_tokens=0, temperature=-1.0))
    codes = {(e["field"], e["code"]) for e in exc.value.errors}
    assert {("prompt", "bad_length"), ("max_new_tokens", "too_small"),
            ("temperature", "negative")} <= codes
    with pytest.raises(SubmitError) as exc:
        sched.submit(Request(prompt=[1] * 8, max_new_tokens=8))
    assert any(e["code"] == "exceeds_pool" for e in exc.value.errors)


def test_scheduler_first_fit_and_chunks():
    alloc = PageAllocator(3, PagedLayout(4, 4, 4))   # 3 usable pages
    sched = Scheduler(alloc, max_prompt_len=8, prefill_chunk=3)
    holder = sched.submit(Request(prompt=[1] * 2, max_new_tokens=2))
    assert sched.admit() == [holder]
    big = sched.submit(Request(prompt=[1] * 8, max_new_tokens=4))
    small = sched.submit(Request(prompt=[1] * 4, max_new_tokens=4))
    assert sched.admit() == [small] and big.state == WAITING
    assert sched.next_chunk() == (holder, 0, 2)
    assert sched.chunk_done(holder, 2)
    assert sched.next_chunk() == (small, 0, 3)
    assert not sched.chunk_done(small, 3)
    assert sched.next_chunk() == (small, 3, 1)
    assert set(sched.decodable()) == {holder.slot}


def test_cache_schemas_mirror_jax():
    from repro.models import transformer as jtr
    from repro_torch.models import transformer as ttr
    pairs = [(jtr.cache_defs(JTINY, 3, 16), ttr.cache_defs(TINY, 3, 16)),
             (jtr.paged_cache_defs(JTINY, 2, 9, 4),
              ttr.paged_cache_defs(TINY, 2, 9, 4))]
    for jd, td in pairs:
        for n in ("k", "v"):
            j, t = jd["p0"][n], td["p0"][n]
            assert (t.shape, t.init, t.dtype) == (j.shape, j.init, j.dtype)


def test_pad_and_scatter_prefill_match_jax():
    from repro.serve import paging as jpaging
    from repro_torch.serve import paging as tpaging
    rng = np.random.default_rng(5)
    kv = {n: rng.standard_normal((2, 1, 6, 2, 8), np.float32)
          for n in ("k", "v")}
    pool = {n: rng.standard_normal((2, 9, 4, 2, 8), np.float32)
            for n in ("k", "v")}
    rows = np.array([[3, 7]], np.int32)
    jc = jpaging.pad_prefill_cache(JTINY, {"p0": {n: jnp.asarray(a)
                                                  for n, a in kv.items()}}, 8)
    jp = jpaging.scatter_prefill(
        JTINY, {"p0": {n: jnp.asarray(a, jnp.bfloat16)
                       for n, a in pool.items()}}, jc, jnp.asarray(rows),
        jnp.asarray([0]))
    tc = tpaging.pad_prefill_cache(TINY, {"p0": {n: torch.from_numpy(a)
                                                 for n, a in kv.items()}}, 8)
    tp = tpaging.scatter_prefill(
        TINY, {"p0": {n: torch.from_numpy(a).to(torch.bfloat16)
                      for n, a in pool.items()}}, tc, torch.from_numpy(rows))
    for n in ("k", "v"):
        np.testing.assert_array_equal(
            tp["p0"][n].float().numpy(),
            np.asarray(jp["p0"][n].astype(jnp.float32)))


# ---------------------------------------------------------------------------
# Engine against the JAX references
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [0, 4, 8], ids=["legacy", "c4", "c8"])
def test_engine_f32_greedy_matches_jax_reference(params, jax_refs, chunk):
    eng = Engine(TINY, EngineConfig(**ECFG, prefill_chunk=chunk),
                 params=params[1], device="cpu", compute_dtype=torch.float32)
    assert _drive(eng) == jax_refs
    assert (eng.n_mixed_steps > 0) == (chunk > 0)


def test_engine_chunked_equals_legacy_at_bf16(params):
    streams = [_drive(Engine(TINY, EngineConfig(**ECFG, prefill_chunk=c),
                             params=params[1], device="cpu"))
               for c in (0, 3, 4, 8)]
    assert all(s == streams[0] for s in streams)


def test_jax_engine_bf16_stream_is_greedy_under_the_port_model(params):
    """Teacher-force the JAX engine's bf16 greedy streams through the
    port's model: every JAX token's logit lies within 3e-2 (a few bf16
    ulps of these logits) of the port's max logit at that step."""
    jp, tp = params
    jeng = JEngine(JTINY, JEngineConfig(**ECFG), params=jp)
    jreqs = [jeng.submit(p, max_new_tokens=n) for p, n in zip(PROMPTS, NEW)]
    jeng.run()
    model = Model(TINY)
    for prompt, req in zip(PROMPTS, jreqs):
        seq = prompt + req.tokens[:-1]
        n = len(req.tokens)
        toks = torch.tensor([seq] * n)
        last = torch.arange(n) + len(prompt) - 1
        logits, _ = model.prefill(tp, {"tokens": toks}, last_index=last)
        logits = logits.float()
        chosen = logits[torch.arange(n), torch.tensor(req.tokens)]
        assert bool((chosen >= logits.amax(-1) - 3e-2).all()), \
            (chosen - logits.amax(-1))


# ---------------------------------------------------------------------------
# Park / adopt, and page-pool shards
# ---------------------------------------------------------------------------


def _submit(eng, temp=0.0):
    return [eng.submit(p, max_new_tokens=n, temperature=temp)
            for p, n in zip(PROMPTS, NEW)]


@pytest.mark.parametrize("chunk", [0, 4], ids=["legacy", "c4"])
@pytest.mark.parametrize("temp", [0.0, 1.3], ids=["t0", "hot"])
def test_snapshot_then_adopt_is_token_identical(params, chunk, temp):
    """Park an engine mid-decode (4 ticks in: requests running, one
    still waiting or mid-prefill), adopt the snapshot into a fresh
    engine of the same shapes and another seed, and finish there: every
    stream equals the uninterrupted run's, at t > 0 too (the generator's
    state rides the snapshot)."""
    ecfg = EngineConfig(**ECFG, prefill_chunk=chunk)
    base = Engine(TINY, ecfg, params=params[1], device="cpu", seed=3)
    want = _submit(base, temp)
    base.run()
    eng = Engine(TINY, ecfg, params=params[1], device="cpu", seed=3)
    reqs = _submit(eng, temp)
    for _ in range(4):
        eng.step()
    assert any(r.tokens for r in reqs) and not all(r.finished for r in reqs)
    snap = eng.snapshot_state()
    assert all(t.device.type == "cpu"
               for kv in snap["pool"].values() for t in kv.values())
    for kv in eng.pool.values():           # the snapshot owns its pools
        for t in kv.values():
            t.zero_()
    counters = (eng.n_prefills, eng.n_decode_steps, eng.n_generated)
    new = Engine(TINY, ecfg, params=params[1], device="cpu", seed=99)
    new.adopt_state(snap)
    assert (new.n_prefills, new.n_decode_steps, new.n_generated) == counters
    new.run()
    assert [r.tokens for r in reqs] == [r.tokens for r in want]
    assert all(r.finished for r in reqs) and new.alloc.pages_in_use() == 0


def test_adopt_with_other_params_continues_from_the_parked_tokens(params):
    """The canary-promotion path: an engine with other params adopts a
    parked engine and finishes its requests from the tokens they had."""
    other = Model(TINY).init(torch.Generator().manual_seed(5), device="cpu")
    base = Engine(TINY, EngineConfig(**ECFG), params=params[1], device="cpu")
    want = _submit(base)
    base.run()
    eng = Engine(TINY, EngineConfig(**ECFG), params=params[1], device="cpu")
    reqs = _submit(eng)
    for _ in range(4):
        eng.step()
    parked = [list(r.tokens) for r in reqs]
    new = Engine(TINY, EngineConfig(**ECFG), params=other, device="cpu")
    new.adopt_state(eng.snapshot_state())
    new.run()
    for r, before, n in zip(reqs, parked, NEW):
        assert r.finished and len(r.tokens) == n
        assert r.tokens[:len(before)] == before
    assert [r.tokens for r in reqs] != [r.tokens for r in want]


SHARDED = dict(n_slots=4, page_size=4, max_seq_len=32, max_prompt_len=8)
SHARD_PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14], [2, 4],
                 [5, 6, 7, 8, 9, 10, 11], [3, 1]]


def _shard_streams(params, **kw):
    eng = Engine(TINY, EngineConfig(**SHARDED, **kw), params=params,
                 device="cpu")
    reqs = [eng.submit(p, max_new_tokens=6) for p in SHARD_PROMPTS]
    return eng, reqs


@pytest.mark.parametrize("chunk", [0, 3, 4], ids=["legacy", "c3", "c4"])
def test_sharded_pool_keeps_each_shards_pages(params, chunk):
    """dp_shards=2: each shard has its own null page (its first id) and
    free list; at every tick a slot holds only its shard's pages, the
    null pages are never free, and each shard's pages are conserved
    (in use + free = its pages less its null page).  The greedy streams
    equal those of one shard, legacy and chunked alike."""
    ref, ref_reqs = _shard_streams(params[1])
    ref.run()
    eng, reqs = _shard_streams(params[1], dp_shards=2, prefill_chunk=chunk)
    al, lay = eng.alloc, eng.layout
    stride = lay.n_pages // 2
    assert lay.n_shards == 2 and lay.n_pages == 4 * 8 + 2
    assert [al.null_page_of(s) for s in range(4)] == [0, 0, stride, stride]
    assert eng.stats()["dp_shards"] == 2
    while eng.step():
        for slot in range(4):
            lo = al.shard_of(slot) * stride
            row = al.block_table[slot]
            assert bool(((row >= lo) & (row < lo + stride)).all()), slot
        for shard, used in enumerate(al.pages_in_use_by_shard()):
            assert shard * stride not in al._free[shard]
            assert used + len(al._free[shard]) == stride - 1
    assert [r.tokens for r in reqs] == [r.tokens for r in ref_reqs]
    assert al.pages_in_use() == 0


def test_sharded_engine_parks_and_adopts(params):
    """Park and adopt with two shards: the free lists re-bucket into
    their shards and the streams go on unchanged."""
    ref, ref_reqs = _shard_streams(params[1], dp_shards=2, prefill_chunk=3)
    ref.run()
    eng, reqs = _shard_streams(params[1], dp_shards=2, prefill_chunk=3)
    for _ in range(6):
        eng.step()
    new = Engine(TINY, EngineConfig(**SHARDED, dp_shards=2, prefill_chunk=3),
                 params=params[1], device="cpu")
    new.adopt_state(eng.snapshot_state())
    assert new.alloc._free == eng.alloc._free
    new.run()
    assert [r.tokens for r in reqs] == [r.tokens for r in ref_reqs]


# ---------------------------------------------------------------------------
# Sampling, streaming, devices, metrics
# ---------------------------------------------------------------------------


def test_sample_tokens_greedy_is_first_argmax_and_hot_rows_sample():
    logits = torch.zeros((2, 64))
    logits[:, 3] = logits[:, 9] = 10.0        # a tie: the first index wins
    temps = torch.tensor([0.0, 8.0])
    seen = set()
    g = torch.Generator().manual_seed(0)
    for _ in range(12):
        tok = sample_tokens(logits, temps, g)
        assert tok.dtype == torch.int32 and int(tok[0]) == 3
        seen.add(int(tok[1]))
    assert len(seen) > 1


def test_engine_temperature_is_seeded(params):
    def run(seed):
        eng = Engine(TINY, EngineConfig(**ECFG), params=params[1],
                     device="cpu", seed=seed)
        req = eng.submit([1, 2, 3], max_new_tokens=6, temperature=1.5)
        eng.run()
        return req.tokens

    assert run(0) == run(0)
    assert len({tuple(run(s)) for s in range(4)}) > 1


def test_stream_and_foreign_request(params):
    a = Engine(TINY, EngineConfig(**ECFG), params=params[1], device="cpu")
    b = Engine(TINY, EngineConfig(**ECFG), params=params[1], device="cpu")
    r1 = a.submit([1, 2, 3, 4], max_new_tokens=5)
    r2 = a.submit([5, 6], max_new_tokens=5)
    assert list(a.stream(r1)) == r1.tokens and len(r1.tokens) == 5
    assert r2.finished
    r3 = a.submit([1, 2, 3], max_new_tokens=2)
    with pytest.raises(StreamError) as exc:
        list(b.stream(r3))
    assert exc.value.errors[0]["code"] == "foreign_request"


def test_engine_metrics_use_the_jax_names(params):
    eng = Engine(TINY, EngineConfig(**ECFG, prefill_chunk=4),
                 params=params[1], device="cpu")
    eng.submit([1, 2, 3, 4, 5, 6], max_new_tokens=3)
    eng.run()
    m = eng.metrics
    assert m.value("serve_ticks_total", kind="mixed") == eng.n_mixed_steps > 0
    assert m.value("serve_generated_tokens_total") == 3
    assert m.value("serve_prefill_tokens_total") == 6
    assert m.histogram("serve_ttft_s")["count"] == 1
    assert eng.stats()["dp_shards"] == 1


def test_engine_without_device_raises_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(TINY, EngineConfig(**ECFG))


def test_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                "--prompt-len", "8", "--gen", "3", "--batch", "2",
                "--prefill-chunk", "4"])
    out = capsys.readouterr().out
    assert "engine stats" in out and "'n_generated': 6" in out


# ---------------------------------------------------------------------------
# Isolation: the port imports neither jax nor the JAX package
# ---------------------------------------------------------------------------


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    port = ROOT / "src" / "repro_torch"
    assert {port / "models" / "moe.py", port / "kernels" / "moe_gemm" / "ops.py",
            port / "kernels" / "moe_gemm" / "kernel.py",
            port / "kernels" / "moe_gemm" / "ref.py",
            port / "configs" / "granite_moe_1b_a400m.py",
            port / "configs" / "arctic_480b.py",
            port / "configs" / "chatglm3_6b.py",
            port / "configs" / "qwen2_72b.py",
            port / "configs" / "deepseek_67b.py",
            port / "configs" / "lammps_proxy.py"} <= set(files)
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
