"""The port's paged KV (marlin_tpu_torch/serving/pages.py, prefix.
PagedPrefixIndex, slots.prefill_chunk_into_row_paged, transformer.
gather_kv_pages / decode_chunk_paged / prefill_chunk_paged, the engine's
paged mode), twins of tests/test_paged_kv.py (the host tier's are in
tests/test_torch_host_kv.py).

Inside the port, bitwise on the CPU: the page-gathered read is the
contiguous read (``gather_kv_pages``, ``decode_chunk_paged`` ==
``decode_chunk``), the paged engine equals B=1 ``generate`` and the
contiguous chunked engine in tokens, and prefix sharing on == off.
Prefix hits alias pages (``admission_copy_bytes == 0``), aliased pages
stay bytewise immutable, and a randomized drive holds the refcounts to a
shadow model. Against the JAX package: ``gather_kv_pages`` exactly and
``decode_chunk_paged`` within 1e-5 (f32).
"""

import random
from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marlin_tpu.models import transformer as jt
from marlin_tpu_torch.models import convert
from marlin_tpu_torch.models import transformer as pt
from marlin_tpu_torch.obs.metrics import MetricsRegistry
from marlin_tpu_torch.serving import (PAGE, HostKVTier, PagedPrefixIndex,
                                      PagePool, PrefixCache, ServingEngine,
                                      prefill_chunk_into_row_paged)
from marlin_tpu_torch.serving.pages import SINK_PAGE

VARIANTS = [{}, {"rope": True, "n_kv_heads": 1}]
IDS = ["pos_mha", "rope_mqa"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One intra-op thread: these tests run beside wall-clock-timed tests
    # in the parallel suite, and their shapes are too small to need more.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    base = dict(vocab=48, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                max_len=160)
    base.update(kw)
    return pt.TransformerConfig(**base)


def _params(cfg, seed=0):
    return pt.init_params(cfg, seed=seed, device="cpu")


def _pool(cfg, n_pages, **kw):
    kw.setdefault("registry", MetricsRegistry())
    return PagePool(cfg, n_pages, device="cpu", **kw)


def _engine(params, cfg, **kw):
    kw.setdefault("metrics_registry", MetricsRegistry())
    return ServingEngine(params, cfg, device="cpu", **kw)


def _generate(params, cfg, prompt, steps, **kw):
    return pt.generate(params, torch.as_tensor(prompt[None]), steps, cfg,
                       **kw).numpy()[0]


def _shared_prefix_workload(cfg, rng, prefix_len=48, n=6):
    shared = rng.integers(0, cfg.vocab, prefix_len)
    out = [(np.concatenate([shared, rng.integers(0, cfg.vocab, 4 + i)]),
            4 + i) for i in range(n - 1)]
    out.append((rng.integers(0, cfg.vocab, 9), 5))
    return out


def _run_workload(engine, workload, waves=1):
    ids = {}
    finished = []
    per = -(-len(workload) // waves)
    for w in range(waves):
        for prompt, steps in workload[w * per:(w + 1) * per]:
            ids[engine.submit(prompt, steps)] = (prompt, steps)
        if w + 1 < waves:
            finished += engine.step()
    finished += engine.run()
    return ids, {r.request_id: r for r in finished}


def _tokens_by_id(ids, done):
    return [done[r].tokens.tolist() for r in sorted(ids)]


def _fill_random(pool, seed):
    gen = torch.Generator().manual_seed(seed)
    for layer in pool:
        for buf in layer.values():
            buf.copy_(torch.randn(buf.shape, generator=gen))


class TestPagePoolConfig:
    @pytest.mark.parametrize("bad", [0, -1, 1.5, "8", True])
    def test_n_pages_must_be_positive_int(self, bad):
        with pytest.raises(ValueError, match="n_pages"):
            _pool(_cfg(), bad)

    def test_max_len_must_tile_pages(self):
        with pytest.raises(ValueError, match="divisible"):
            _pool(_cfg(max_len=150), 4)

    def test_window_rejected(self):
        with pytest.raises(ValueError, match="window"):
            _pool(_cfg(window=32), 4)

    def test_engine_rejects_prefix_cache_with_kv_pages(self):
        cfg = _cfg()
        with pytest.raises(ValueError, match="mutually exclusive"):
            _engine(_params(cfg), cfg, batch=2, kv_pages=8,
                    prefix_cache=PrefixCache(cfg, pool_rows=2,
                                             device="cpu"))

    def test_prefix_sharing_flag_is_paged_only(self):
        cfg = _cfg()
        with pytest.raises(ValueError, match="prefix_sharing"):
            _engine(_params(cfg), cfg, batch=2, prefix_sharing=False)

    def test_submit_rejects_request_bigger_than_pool(self):
        cfg = _cfg()
        eng = _engine(_params(cfg), cfg, batch=2, kv_pages=3)
        with pytest.raises(ValueError, match="KV pages"):
            eng.submit(np.zeros(40, np.int64), 40)  # 5 pages > 3

    def test_buffers_default_to_the_card(self):
        # The pool and the prefix cache allocate on "cuda" unless told
        # otherwise; without CUDA that raises, never falls back.
        if torch.cuda.is_available():
            pytest.skip("CUDA is present: the default device is valid here")
        with pytest.raises(RuntimeError, match="CUDA"):
            PagePool(_cfg(), 4)
        with pytest.raises(RuntimeError, match="CUDA"):
            PrefixCache(_cfg(), pool_rows=1)

    def test_host_tier_is_not_ported_yet(self):
        # The index takes a host tier beneath it (test_torch_host_kv.py
        # holds what the tier does).
        pool = _pool(_cfg(), 4)
        tier = HostKVTier(pool, registry=pool.registry)
        idx = PagedPrefixIndex(pool, registry=pool.registry, host_tier=tier)
        assert idx.host_tier is tier
        assert idx.summary()["prefix_spilled_entries"] == 0

    def test_page_table_must_tile_max_len(self):
        cfg = _cfg()
        pool = _pool(cfg, 4)
        with pytest.raises(ValueError, match="max_len"):
            pt.decode_chunk_paged(_params(cfg), pool.pages,
                                  torch.zeros((1, 4), dtype=torch.long),
                                  torch.zeros((1, 1), dtype=torch.long), 0,
                                  cfg)


class TestPagePoolHost:
    def test_alloc_ref_unref_free_discipline(self):
        pool = _pool(_cfg(), 4)
        a = pool.alloc(3)
        assert sorted(a) == [1, 2, 3] and pool.n_free == 1
        assert pool.alloc(2) is None          # short: no partial grant
        assert pool.alloc_failures == 1
        pool.ref([a[0]])                      # alias: refcount 2
        assert pool.refcount(a[0]) == 2
        pool.unref(a)                         # row release
        assert pool.n_free == 3               # a[0] still held
        assert pool.refcount(a[0]) == 1
        pool.unref([a[0]])
        assert pool.n_free == 4 and pool.refcount(a[0]) == 0
        with pytest.raises(RuntimeError, match="double free"):
            pool.unref([a[0]])
        with pytest.raises(RuntimeError, match="free/unallocated"):
            pool.ref([a[0]])
        assert pool.alloc(0) == []            # fully aliased admission

    def test_sink_page_never_allocated_and_pool_on_its_device(self):
        cfg = _cfg()
        pool = _pool(cfg, 4)
        got = pool.alloc(4)
        assert SINK_PAGE not in got
        assert pool.alloc(1) is None
        dh = cfg.d_model // cfg.n_heads
        for layer in pool.pages:
            for buf in layer.values():
                assert buf.device.type == "cpu"
                assert tuple(buf.shape) == (5, PAGE, cfg.kv_heads, dh)
        assert pool.page_bytes == 2 * cfg.n_layers * PAGE * cfg.kv_heads \
            * dh * 4
        assert pool.summary()["kv_pages_used"] == 4


class TestRefcountProperty:
    def test_randomized_interleavings_match_shadow_model(self):
        """Interleaved admission (alloc + alias ref), store (ref),
        release (unref) and eviction (unref) against a shadow refcount
        model. After every op: refcounts == shadow, the free list ==
        zero-ref pages without duplicates, the allocator never hands out
        a live page, frees == pages whose last reference dropped."""
        cfg = _cfg(d_model=8, n_heads=2, n_layers=1, d_ff=16, max_len=64)
        pool = _pool(cfg, 12)
        index = PagedPrefixIndex(pool, registry=MetricsRegistry())
        rng = random.Random(1234)
        shadow = {}   # page -> refcount
        rows = {}     # row id -> held page list
        entries = {}  # entry key -> page tuple (mirror of the index)
        next_row = 0
        freed_total = 0

        def drop(pages):
            nonlocal freed_total
            for p in pages:
                shadow[p] -= 1
                freed_total += shadow[p] == 0

        def check():
            live = {p: n for p, n in shadow.items() if n > 0}
            assert dict(pool._refs) == live
            free = sorted(pool._free)
            assert free == sorted(set(free)), "duplicate free-list entry"
            assert set(free) == set(range(1, 13)) - set(live)
            assert SINK_PAGE not in live and SINK_PAGE not in free
            assert pool.frees == freed_total

        for _ in range(400):
            op = rng.choice(["admit", "admit", "store", "release",
                             "release", "evict"])
            if op == "admit":
                alias = []
                if entries and rng.random() < 0.5:
                    key = rng.choice(sorted(entries))
                    alias = list(entries[key])[:rng.randint(
                        1, len(entries[key]))]
                    pool.ref(alias)
                    for p in alias:
                        shadow[p] = shadow.get(p, 0) + 1
                fresh = pool.alloc(rng.randint(1, 4))
                if fresh is None:
                    if alias:
                        pool.unref(alias)
                        drop(alias)
                else:
                    for p in fresh:
                        assert shadow.get(p, 0) == 0, \
                            "allocator handed out a live page"
                        shadow[p] = 1
                    rows[next_row] = alias + fresh
                    next_row += 1
            elif op == "store" and rows:
                row = rng.choice(sorted(rows))
                pages = rows[row][:rng.randint(1, len(rows[row]))]
                toks = np.asarray([rng.randrange(997)
                                   for _ in range(len(pages) * PAGE)])
                stored = index.store(toks, pages)
                if stored:
                    entries[toks.tobytes()] = tuple(pages[:stored // PAGE])
                    for p in pages[:stored // PAGE]:
                        shadow[p] += 1
            elif op == "release" and rows:
                held = rows.pop(rng.choice(sorted(rows)))
                pool.unref(held)
                drop(held)
            elif op == "evict" and entries:
                before = {e.tokens.tobytes() for e in
                          index._entries.values()}
                assert index.evict_lru()
                (gone,) = before - {e.tokens.tobytes() for e in
                                    index._entries.values()}
                drop(entries.pop(gone))
            check()


class TestPagedModel:
    """The model half: gathered reads and scattered writes are the
    contiguous cache's, bitwise in the port, and the JAX package's."""

    def _tables(self, cfg, b, seed):
        # Every row's chunks on distinct, shuffled pages (page 0 unused).
        n = cfg.max_len // PAGE
        perm = np.random.default_rng(seed).permutation(b * n) + 1
        return torch.as_tensor(perm.reshape(b, n))

    @pytest.mark.parametrize("kw", VARIANTS, ids=IDS)
    def test_gather_kv_pages_is_the_contiguous_layout(self, kw):
        cfg = _cfg(**kw)
        tables = self._tables(cfg, 2, seed=1)
        pool = _pool(cfg, 2 * cfg.max_len // PAGE).pages
        _fill_random(pool, seed=2)
        got = pt.gather_kv_pages(pool, tables)
        jgot = jt.gather_kv_pages(
            [{k: jnp.asarray(v.numpy()) for k, v in layer.items()}
             for layer in pool], jnp.asarray(tables.numpy(), jnp.int32))
        for layer, jlayer, src in zip(got, jgot, pool):
            for name, view in layer.items():
                assert tuple(view.shape) == (2, cfg.max_len, cfg.kv_heads,
                                             cfg.d_model // cfg.n_heads)
                for r in range(2):
                    for c in range(cfg.max_len // PAGE):
                        assert torch.equal(
                            view[r, c * PAGE:(c + 1) * PAGE],
                            src[name][tables[r, c]])
                np.testing.assert_array_equal(view.numpy(),
                                              np.asarray(jlayer[name]))

    @pytest.mark.parametrize("kw", VARIANTS, ids=IDS)
    def test_paged_chunks_equal_contiguous_and_jax(self, kw):
        # A 40-token prefill (chunks of 32 and 8) then two per-row decode
        # steps, paged and contiguous side by side: bitwise equal logits
        # and cache bytes; the paged decode within 1e-5 of the JAX one.
        jcfg = jt.TransformerConfig(**_cfg(**kw)._asdict())
        cfg = _cfg(**kw)
        jparams = jt.init_params(jcfg, seed=5)
        params = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                         cfg, device="cpu")
        rng = np.random.default_rng(6)
        prompts = rng.integers(0, cfg.vocab, (2, 40))
        tables = self._tables(cfg, 2, seed=3)
        pool = _pool(cfg, 2 * cfg.max_len // PAGE).pages
        cache = pt.init_kv_cache(cfg, 2, device="cpu")
        for c0, c1 in ((0, 32), (32, 40)):
            chunk = torch.as_tensor(prompts[:, c0:c1])
            a, _ = pt.prefill_chunk_paged(params, pool, tables, chunk, c0,
                                          cfg)
            b, _ = pt.prefill_chunk(params, cache, chunk, c0, cfg)
            assert torch.equal(a, b)
        jpool = [{k: jnp.asarray(v.numpy()) for k, v in layer.items()}
                 for layer in pool]
        pos = torch.tensor([40, 40])
        for i in range(2):
            tok = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 1)))
            a, _ = pt.decode_chunk_paged(params, pool, tables, tok, pos + i,
                                         cfg)
            b, _ = pt.decode_chunk(params, cache, tok, pos + i, cfg)
            assert torch.equal(a, b)
            jl, jpool = jt.decode_chunk_paged(
                jparams, jpool, jnp.asarray(tables.numpy(), jnp.int32),
                jnp.asarray(tok.numpy(), jnp.int32),
                jnp.asarray((pos + i).numpy(), jnp.int32), jcfg)
            ref = np.asarray(jl)
            err = np.abs(a.numpy() - ref).max() / np.abs(ref).max()
            assert err <= 1e-5, f"decode step {i}: {err:.3e}"
        for view, layer in zip(pt.gather_kv_pages(pool, tables), cache):
            for name in layer:
                assert torch.equal(view[name][:, :42], layer[name][:, :42])

    def test_prefill_chunk_into_row_paged_writes_through_the_table(self):
        cfg = _cfg()
        params = _params(cfg, seed=1)
        pool = _pool(cfg, 12)
        pages = pool.alloc(3)
        table = torch.full((cfg.max_len // PAGE,), SINK_PAGE)
        table[:3] = torch.as_tensor(pages)
        prompt = torch.as_tensor(np.random.default_rng(2).integers(0, 48, 40))
        buf = torch.zeros((2, cfg.max_len), dtype=torch.long)
        first = prefill_chunk_into_row_paged(
            params, pool.pages, buf, 1, table, torch.nn.functional.pad(
                prompt, (0, 8)), 0, 40, prompt, 40, cfg, final=True)
        cache = pt.init_kv_cache(cfg, 1, device="cpu")
        lg, _ = pt.prefill_chunk(params, cache, prompt[None], 0, cfg)
        assert int(first) == int(lg.argmax())
        assert buf[1, :40].tolist() == prompt.tolist()
        for layer, clayer in zip(pool.pages, cache):
            for name in layer:
                got = layer[name][torch.as_tensor(pages)].reshape(
                    (48,) + tuple(layer[name].shape[2:]))
                assert torch.equal(got[:40], clayer[name][0, :40])


class TestPagedExactness:
    @pytest.mark.parametrize("kw", VARIANTS, ids=IDS)
    def test_paged_outputs_equal_b1_generate(self, kw):
        # The paged engine (sharing on) against B=1 generate, with hits.
        cfg = _cfg(**kw)
        params = _params(cfg, seed=0)
        workload = _shared_prefix_workload(cfg, np.random.default_rng(9))
        eng = _engine(params, cfg, batch=3, round_steps=4, kv_pages=40)
        ids, done = _run_workload(eng, workload, waves=3)
        assert eng.stats.n_completed == len(workload)
        assert eng.stats.n_prefix_hits > 0
        assert eng.stats.admission_copy_bytes == 0
        for rid, (prompt, steps) in ids.items():
            np.testing.assert_array_equal(
                done[rid].tokens, _generate(params, cfg, prompt, steps),
                err_msg=f"request {rid}")

    def test_sharing_on_off_and_contiguous_are_bitwise_one(self):
        # Paged with sharing on, off, and the contiguous chunked engine
        # with and without its prefix cache: one set of tokens.
        cfg = _cfg()
        params = _params(cfg, seed=0)
        workload = _shared_prefix_workload(cfg, np.random.default_rng(9))

        def run(**kw):
            eng = _engine(params, cfg, batch=3, round_steps=4,
                          prefill_chunk=32, **kw)
            return eng, _tokens_by_id(*_run_workload(eng, workload,
                                                     waves=2))

        eng_off, off = run(kv_pages=40, prefix_sharing=False)
        eng_on, on = run(kv_pages=40)
        _, contiguous = run()
        _, copied = run(prefix_cache=PrefixCache(cfg, pool_rows=4,
                                                 device="cpu"))
        assert on == off == contiguous == copied
        assert eng_off.stats.n_prefix_hits == 0
        assert eng_off.prefix_index is None
        assert eng_on.stats.n_zero_copy_hits > 0

    def test_eos_freeze_with_paged_hits_matches_generate(self):
        cfg = _cfg()
        params = _params(cfg, seed=5)
        rng = np.random.default_rng(2)
        shared = rng.integers(0, cfg.vocab, 32)
        prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, k)])
                   for k in (3, 5, 8)]
        steps = 16
        eos = int(_generate(params, cfg, prompts[0], steps)[steps // 2])
        eng = _engine(params, cfg, batch=2, round_steps=4, eos_id=eos,
                      kv_pages=30)
        ids = {eng.submit(p, steps): p for p in prompts}
        done = {r.request_id: r for r in eng.run()}
        fired = 0
        for rid, p in ids.items():
            ref = _generate(params, cfg, p, steps, eos_id=eos)
            np.testing.assert_array_equal(done[rid].tokens, ref)
            fired += int((ref == eos).any())
        assert fired >= 1 and eng.stats.n_prefix_hits >= 1

    def test_page_pressure_waits_and_evicts_exactly(self):
        # A pool too small for the batch: reservations that don't fit
        # leave requests queued (no drops), stored prefixes are evicted
        # under pressure, and the tokens stay the sharing-off run's.
        cfg = _cfg()
        params = _params(cfg, seed=6)
        rng = np.random.default_rng(10)
        shares = [rng.integers(0, cfg.vocab, 32) for _ in range(3)]
        workload = [(np.concatenate([sh, rng.integers(0, cfg.vocab,
                                                      3 + rep + j)]),
                     3 + rep + j)
                    for rep in range(2) for j, sh in enumerate(shares)]

        def run(sharing):
            # 5 pages: one 3-page reservation plus one stored 2-page
            # prefix exhaust the pool.
            eng = _engine(params, cfg, batch=2, round_steps=6, kv_pages=5,
                          prefix_sharing=sharing)
            ids = [eng.submit(p, s) for p, s in workload]
            done = {r.request_id: r for r in eng.run()}
            return eng, [done[r].tokens.tolist() for r in ids]

        _, off = run(False)
        eng, on = run(True)
        assert on == off
        assert eng.stats.n_completed == len(workload)
        assert eng.page_pool.alloc_failures > 0
        assert eng.prefix_index.evictions > 0
        # Everything came back: only stored entries hold pages now.
        held = Counter(p for e in eng.prefix_index._entries.values()
                       for p in e.pages)
        assert dict(eng.page_pool._refs) == dict(held)
        assert eng.page_pool.n_used == len(held)


class TestZeroCopyAliasing:
    def test_aliased_pages_are_bytewise_immutable(self):
        # Store a prefix, snapshot its pages, then decode several hit
        # admissions over the aliased pages: the stored bytes must not
        # move (decode writes land at page index >= hit / PAGE).
        cfg = _cfg()
        params = _params(cfg, seed=3)
        rng = np.random.default_rng(4)
        shared = rng.integers(0, cfg.vocab, 48)
        eng = _engine(params, cfg, batch=2, round_steps=4, kv_pages=30)
        eng.submit(np.concatenate([shared, rng.integers(0, cfg.vocab, 5)]),
                   4)
        eng.run()
        (entry,) = eng.prefix_index._entries.values()
        pages = torch.as_tensor(entry.pages)

        def snap():
            return [{name: buf[pages].clone() for name, buf in layer.items()}
                    for layer in eng.page_pool.pages]

        before = snap()
        for i in range(3):
            eng.submit(np.concatenate(
                [shared, rng.integers(0, cfg.vocab, 4 + i)]), 5)
        eng.run()
        assert eng.stats.n_zero_copy_hits >= 3
        for la, lb in zip(before, snap()):
            for name in la:
                assert torch.equal(la[name], lb[name])

    def test_ledgers_and_registry(self):
        cfg = _cfg()
        params = _params(cfg, seed=0)
        eng = _engine(params, cfg, batch=3, round_steps=4, kv_pages=40)
        _run_workload(eng, _shared_prefix_workload(
            cfg, np.random.default_rng(9)), waves=2)
        summ = eng.stats.summary()
        assert summ["admission_copy_bytes"] == 0
        assert summ["zero_copy_hits"] == eng.stats.n_prefix_hits > 0
        assert summ["prefix_hits"] == eng.prefix_index.hits
        assert summ["prefix_reclaimed_prefill_tokens"] \
            == eng.prefix_index.reclaimed_tokens
        assert summ["kv_pages"]["kv_pages_total"] == 40
        assert summ["kv_pages"]["kv_pages_used"] > 0
        assert eng.prefix_index.summary()["prefix_stores"] > 0
        ms = eng.metrics.snapshot()
        assert ms["gauges"]["serving_kv_pages_total"] == 40
        assert ms["gauges"]["serving_kv_pages_used"] > 0
        assert "serving_kv_page_fragmentation" in ms["gauges"]
        assert ms["counters"]["serving_kv_zero_copy_hits_total"] > 0
        rounds = eng.runlog.events("round")
        assert rounds and all("pages_used" in e for e in rounds)
        start = eng.runlog.events("engine_start")[-1]
        assert start["kv_pages"] == 40 and start["prefix_sharing"]
        assert start["prefill_chunk"] == 32  # kv_pages defaults it


class TestPagedNoRebuild:
    def test_storage_stable_and_shapes_bounded(self):
        # The reference's donation and compile-count pins in the port's
        # terms: the pool and buffer keep their storage across admissions
        # and rounds, and every call runs at one of two shapes (a prefill
        # tile, a decode tile), hit or miss.
        cfg = _cfg()
        params = _params(cfg, seed=8)
        rng = np.random.default_rng(3)
        shared = rng.integers(0, cfg.vocab, 32)
        eng = _engine(params, cfg, batch=3, round_steps=4, kv_pages=40)

        def submit_two():
            for _ in range(2):
                eng.submit(np.concatenate(
                    [shared, rng.integers(0, cfg.vocab, 6)]), 5)

        for _ in range(2):  # miss-path chunks, then the hit path
            submit_two()
            eng.run()
        assert eng.stats.n_prefix_hits >= 2

        def pointers():
            return [eng._buf.data_ptr()] + [
                b.data_ptr() for layer in eng.page_pool.pages
                for b in layer.values()]

        shapes = set()
        split = pt._split_qkv

        def recording(bp, x, cfg_, positions=None):
            shapes.add(tuple(x.shape))
            return split(bp, x, cfg_, positions=positions)

        before = pointers()
        pt._split_qkv = recording
        try:
            for _ in range(3):
                submit_two()
                eng.run()
        finally:
            pt._split_qkv = split
        assert eng.stats.n_zero_copy_hits >= 8
        assert pointers() == before
        assert shapes == {(1, pt.PREFILL_TILE, cfg.d_model),
                          (3, pt.DECODE_TILE, cfg.d_model)}


class TestCapacity:
    def test_strictly_more_concurrent_sequences_per_pool_byte(self):
        # Equal bytes: 2 contiguous rows at max_len == 2 x 10 pages. The
        # row cache holds 2 sequences at once; the paged pool holds all 6
        # short requests (reservation-exact sizing).
        cfg = _cfg()
        params = _params(cfg, seed=0)
        rng = np.random.default_rng(0)
        shared = rng.integers(0, cfg.vocab, 32)
        n_pages = 2 * (cfg.max_len // PAGE)
        eng = _engine(params, cfg, batch=8, round_steps=1, kv_pages=n_pages,
                      prefill_chunks_per_round=4)
        assert eng.page_pool.pool_bytes == 2 * sum(
            buf[0].numel() * buf.element_size()
            for layer in pt.init_kv_cache(cfg, 1, device="cpu")
            for buf in layer.values())
        for _ in range(6):
            # prompt 36 + steps 8 -> 3 pages each: 18 <= 20.
            eng.submit(np.concatenate(
                [shared, rng.integers(0, cfg.vocab, 4)]), 8)
        eng.step()  # one admission round: everything placed
        assert eng.slots.n_occupied + len(eng._prefilling) == 6 > 2
        assert eng.page_pool.alloc_failures == 0
        eng.run()
        assert eng.stats.n_completed == 6
