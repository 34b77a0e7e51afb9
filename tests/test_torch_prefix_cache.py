"""The port's chunked admission and contiguous prefix cache
(marlin_tpu_torch/serving/prefix.py, slots.prefill_chunk_into_row,
transformer.prefill_chunk), twins of tests/test_prefix_cache.py plus the
cross-framework checks.

Inside the port the reference's invariants hold bitwise on the CPU:

* any split of a prompt into chunks writes the same cache bits and gives
  the same last logits (prefill runs in tiles of one fixed shape);
* the prefix cache on == off, token for token, with real hits;
* the chunked engine == B=1 ``generate`` in tokens.

Against the JAX package (same weights through ``params_from_jax``):
``prefill_chunk`` within 1e-5 (f32), and the prefix-cache engine's tokens
equal the JAX engine's except at a near-tie of the JAX logits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marlin_tpu.models import transformer as jt
from marlin_tpu.serving import PrefixCache as JaxPrefixCache
from marlin_tpu.serving import ServingEngine as JaxEngine
from marlin_tpu.utils import cost_model as jcm
from marlin_tpu_torch.models import convert
from marlin_tpu_torch.models import transformer as pt
from marlin_tpu_torch.obs.metrics import MetricsRegistry
from marlin_tpu_torch.serving import (PrefixCache, ServingEngine,
                                      copy_kv_rows, prefill_chunk_into_row)
from marlin_tpu_torch.serving.prefix import GRAIN
from marlin_tpu_torch.utils import cost_model as cm

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


def _cache(cfg, batch=1):
    return pt.init_kv_cache(cfg, batch, dtype=cfg.compute_dtype,
                            device="cpu")


def _pc(cfg, pool_rows):
    return PrefixCache(cfg, pool_rows=pool_rows, device="cpu")


def _engine(params, cfg, **kw):
    kw.setdefault("metrics_registry", MetricsRegistry())
    return ServingEngine(params, cfg, device="cpu", **kw)


def _generate(params, cfg, prompt, steps, **kw):
    return pt.generate(params, torch.as_tensor(prompt[None]), steps, cfg,
                       **kw).numpy()[0]


def _shared_prefix_workload(cfg, rng, prefix_len=48, n=7):
    """n-1 requests sharing a prefix_len system prompt plus unique tails,
    and one short cold request."""
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


class TestPrefixCacheHost:
    """Trie, pool, LRU and refcounts, against a real cache."""

    def _store(self, pc, cfg, tokens):
        # A one-row cache stands in for an engine row holding the prompt's
        # K/V; the host logic under test does not read the bits.
        return pc.store_from(_cache(cfg), 0, tokens)

    def test_store_then_longest_grain_lookup(self):
        cfg = _cfg()
        pc = _pc(cfg, 4)
        t = np.random.default_rng(0).integers(0, cfg.vocab, 48)
        assert self._store(pc, cfg, t) == 48
        # Longest match at 16-granularity, capped so at least the last
        # prompt position is always computed (hit <= floor16(s - 1)).
        row, hit = pc.lookup(np.concatenate([t, t[:5]]))
        assert hit == 48 and row is not None
        assert pc.lookup(t)[1] == 32          # s=48: cap at floor16(47)
        assert pc.lookup(t[:33])[1] == 32
        assert pc.lookup(t[:17])[1] == 16
        mismatch = np.concatenate([t[:16], (t[16:32] + 1) % cfg.vocab,
                                   t[:8]])
        assert pc.lookup(mismatch)[1] == 16   # diverges in chunk 2
        assert pc.lookup(t[:16])[1] == 0      # limit floor16(15) == 0
        assert pc.hits == 5 and pc.misses == 1
        assert pc.reclaimed_tokens == 48 + 32 + 32 + 16 + 16

    def test_store_dedup_and_deeper_extension(self):
        cfg = _cfg()
        pc = _pc(cfg, 4)
        t64 = np.random.default_rng(1).integers(0, cfg.vocab, 64)
        assert self._store(pc, cfg, t64[:48]) == 48
        assert self._store(pc, cfg, t64[:50]) == 0  # covered: skip
        assert pc.store_skips == 1
        assert self._store(pc, cfg, t64) == 64      # deeper: new row
        assert pc.rows_used == 2
        row, hit = pc.lookup(np.concatenate([t64, t64[:4]]))
        assert hit == 64 and pc.stored_len(row) == 64

    def test_lru_eviction_under_pool_pressure(self):
        cfg = _cfg()
        pc = _pc(cfg, 2)
        rng = np.random.default_rng(2)
        p1, p2, p3 = (rng.integers(0, cfg.vocab, 32) for _ in range(3))
        self._store(pc, cfg, p1)
        self._store(pc, cfg, p2)
        pc.lookup(np.concatenate([p1, p1[:4]]))  # touch p1: p2 is LRU
        assert self._store(pc, cfg, p3) == 32
        assert pc.evictions == 1 and pc.rows_used == 2
        # The evicted prefix is gone from the trie: no use-after-evict.
        assert pc.lookup(np.concatenate([p2, p2[:4]]))[1] == 0
        assert pc.lookup(np.concatenate([p1, p1[:4]]))[1] == 32
        assert pc.lookup(np.concatenate([p3, p3[:4]]))[1] == 32

    def test_refcount_blocks_eviction(self):
        cfg = _cfg()
        pc = _pc(cfg, 1)
        rng = np.random.default_rng(3)
        p1, p2 = (rng.integers(0, cfg.vocab, 32) for _ in range(2))
        self._store(pc, cfg, p1)
        (row,) = list(pc._len)
        pc.acquire(row)  # a copy out of row is in flight
        assert self._store(pc, cfg, p2) == 0  # pinned: store skipped
        assert pc.evictions == 0 and pc.store_skips == 1
        pc.release(row)
        assert self._store(pc, cfg, p2) == 32  # now evictable
        assert pc.evictions == 1
        with pytest.raises(RuntimeError, match="unacquired"):
            pc.release(row)

    def test_load_into_validates_length_and_liveness(self):
        cfg = _cfg()
        pc = _pc(cfg, 1)
        self._store(pc, cfg, np.random.default_rng(4).integers(0, 48, 48))
        (row,) = list(pc._len)
        cache = _cache(cfg, 2)
        with pytest.raises(ValueError, match="multiple"):
            pc.load_into(cache, 0, row, 20)
        with pytest.raises(ValueError, match="holds"):
            pc.load_into(cache, 0, row, 64)

    @pytest.mark.parametrize("kw", VARIANTS, ids=IDS)
    def test_copy_kv_rows_roundtrip_bitwise(self, kw):
        # Row 0 -> pool -> row 1: every buffer round-trips bitwise over
        # the copied slots and the rest stays untouched; the copy is in
        # place (same storage).
        cfg = _cfg(**kw)
        gen = torch.Generator().manual_seed(5)
        cache = _cache(cfg, 2)
        for layer in cache:
            for buf in layer.values():
                buf.copy_(torch.randn(buf.shape, generator=gen))
        pool = _cache(cfg, 3)
        ref = [{k: v.clone() for k, v in layer.items()} for layer in cache]
        ptrs = [b.data_ptr() for layer in cache for b in layer.values()]
        assert copy_kv_rows(pool, cache, 2, 0, 32) is pool
        copy_kv_rows(cache, pool, 1, 2, 32)
        assert [b.data_ptr() for layer in cache
                for b in layer.values()] == ptrs
        for i, layer in enumerate(cache):
            for name, got in layer.items():
                assert torch.equal(got[1, :32], ref[i][name][0, :32])
                assert torch.equal(got[1, 32:], ref[i][name][1, 32:])
                assert torch.equal(got[0], ref[i][name][0])


class TestChunkSplitBitExactness:
    """The foundation: any split of a prompt into chunks, a copied prefix
    plus its tail among them, writes the same cache bits and gives the
    same last logits, bitwise."""

    @pytest.mark.parametrize("split", [16, 48], ids=["split16", "split48"])
    @pytest.mark.parametrize("kw", VARIANTS, ids=IDS)
    def test_chunked_prefill_bitwise_equals_one_shot(self, kw, split):
        cfg = _cfg(**kw)
        params = _params(cfg, seed=0)
        rng = np.random.default_rng(6)
        for s in (9, 33, 48, 150):
            prompt = torch.as_tensor(rng.integers(0, cfg.vocab, s))
            one = _cache(cfg)
            lg1, _ = pt.prefill_chunk(params, one, prompt[None], 0, cfg)
            part = _cache(cfg)
            for c0 in range(0, s, split):
                lg2, _ = pt.prefill_chunk(params, part,
                                          prompt[None, c0:c0 + split], c0,
                                          cfg)
            for i, (a, b) in enumerate(zip(one, part)):
                for name in a:
                    assert torch.equal(a[name][:, :s], b[name][:, :s]), \
                        f"s={s} layer {i} {name}"
            assert torch.equal(lg1, lg2), f"s={s} last logits"

    def test_copied_prefix_plus_tail_is_bitwise_cold(self):
        # The prefix cache's admission, at the model level: the first 32
        # slots copied from another row that prefilled a longer prompt
        # with the same prefix, then the tail from position 32.
        cfg = _cfg()
        params = _params(cfg, seed=2)
        rng = np.random.default_rng(8)
        shared = rng.integers(0, cfg.vocab, 32)
        donor = torch.as_tensor(np.concatenate(
            [shared, rng.integers(0, cfg.vocab, 21)]))
        prompt = torch.as_tensor(np.concatenate(
            [shared, rng.integers(0, cfg.vocab, 11)]))
        cache = _cache(cfg, 2)
        pt.prefill_chunk(params, [{k: v[0:1] for k, v in layer.items()}
                                  for layer in cache], donor[None], 0, cfg)
        copy_kv_rows(cache, cache, 1, 0, 32)
        row1 = [{k: v[1:2] for k, v in layer.items()} for layer in cache]
        lg_hit, _ = pt.prefill_chunk(params, row1, prompt[None, 32:], 32,
                                     cfg)
        cold = _cache(cfg)
        lg_cold, _ = pt.prefill_chunk(params, cold, prompt[None], 0, cfg)
        assert torch.equal(lg_hit, lg_cold)
        for a, b in zip(row1, cold):
            for name in a:
                assert torch.equal(a[name][:, :43], b[name][:, :43])

    def test_prefill_chunk_readout_matches_decode_chunk(self):
        # prefill_chunk's one-tile readout equals decode_chunk's
        # readout of every position at the same position, bit for bit.
        cfg = _cfg()
        params = _params(cfg, seed=1)
        prompt = torch.as_tensor(
            np.random.default_rng(7).integers(0, cfg.vocab, 20))
        full, _ = pt.decode_chunk(params, _cache(cfg), prompt[None], 0, cfg)
        one, _ = pt.prefill_chunk(params, _cache(cfg), prompt[None], 0, cfg,
                                  last=11)
        assert torch.equal(full[:, 11], one)

    def test_chunk_guards(self):
        cfg = _cfg()
        params = _params(cfg)
        with pytest.raises(ValueError, match="cache length"):
            pt.prefill_chunk(params, _cache(_cfg(max_len=64)),
                             torch.zeros((1, 4), dtype=torch.long), 0, cfg)
        ring = _cfg(window=8)
        with pytest.raises(NotImplementedError, match="slot==position"):
            pt.prefill_chunk(_params(ring), _cache(ring),
                             torch.zeros((1, 4), dtype=torch.long), 0, ring)

    @pytest.mark.parametrize("kw", VARIANTS, ids=IDS)
    def test_prefill_chunk_matches_jax(self, kw):
        # The same weights and a 40-token prompt in chunks of 32 and 8 on
        # both sides: logits at a mid position and the cache within 1e-5.
        jcfg = jt.TransformerConfig(**_cfg(**kw)._asdict())
        cfg = _cfg(**kw)
        jparams = jt.init_params(jcfg, seed=3)
        params = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                         cfg, device="cpu")
        prompt = np.random.default_rng(9).integers(0, cfg.vocab, 40)
        jcache = jt.init_kv_cache(jcfg, 1)
        cache = _cache(cfg)
        for c0, c1, last in ((0, 32, 31), (32, 40, 5)):
            chunk = prompt[None, c0:c1]
            jl, jcache = jt.prefill_chunk(
                jparams, jcache, jnp.asarray(chunk, jnp.int32),
                jnp.int32(c0), jcfg, last=jnp.int32(last))
            got, _ = pt.prefill_chunk(params, cache, torch.as_tensor(chunk),
                                      c0, cfg, last=last)
            ref = np.asarray(jl)
            err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
            assert err <= 1e-5, f"chunk [{c0}, {c1}): {err:.3e}"
        for layer, jlayer in zip(cache, jcache):
            for name in layer:
                np.testing.assert_allclose(
                    layer[name][:, :40].numpy(),
                    np.asarray(jlayer[name])[:, :40], rtol=1e-5, atol=1e-5)


class TestChunkedAdmissionExactness:
    @pytest.mark.parametrize("kw", VARIANTS, ids=IDS)
    def test_chunked_outputs_equal_b1_generate(self, kw):
        # Mixed buckets, waves and mid-stream admissions: every request
        # emits its own B=1 generate tokens.
        cfg = _cfg(**kw)
        params = _params(cfg, seed=0)
        eng = _engine(params, cfg, batch=3, round_steps=5, prefill_chunk=32)
        rng = np.random.default_rng(7)
        workload = [(rng.integers(0, cfg.vocab, s), steps)
                    for s, steps in ((9, 10), (17, 5), (20, 8), (5, 14),
                                     (33, 7), (12, 9), (6, 3), (70, 6))]
        ids, done = _run_workload(eng, workload, waves=3)
        assert eng.stats.n_completed == len(workload)
        assert not eng._prefilling and not eng.requests
        for rid, (prompt, steps) in ids.items():
            np.testing.assert_array_equal(
                done[rid].tokens, _generate(params, cfg, prompt, steps),
                err_msg=f"request {rid}")

    def test_long_prompt_interleaves_with_live_decode(self):
        # A long cold prompt must not stall a row that is mid-decode: its
        # prefill spreads over rounds (one job, several admit_chunk
        # rounds) while the live row keeps emitting.
        cfg = _cfg()
        params = _params(cfg, seed=3)
        eng = _engine(params, cfg, batch=2, round_steps=4, prefill_chunk=16,
                      prefill_chunks_per_round=1)
        rng = np.random.default_rng(8)
        short = rng.integers(0, cfg.vocab, 8)
        long_p = rng.integers(0, cfg.vocab, 96)
        id_s = eng.submit(short, 16)
        id_l = eng.submit(long_p, 4)
        done = {r.request_id: r for r in eng.run()}
        by_id = {e["request_id"]: e for e in eng.runlog.events("admit")}
        # 96 tokens at 16 a chunk, one chunk a round: 6 prefill rounds.
        assert by_id[id_l]["prefill_rounds"] >= 6
        assert by_id[id_l]["chunks"] == 6
        assert by_id[id_l]["prefix_hit_len"] == 0
        assert by_id[id_s]["round"] < by_id[id_l]["round"]
        # The short row decoded during those rounds.
        rounds = eng.runlog.events("round")
        assert any(e["prefilling"] and e["live_iters"] for e in rounds)
        for rid, prompt, steps in ((id_s, short, 16), (id_l, long_p, 4)):
            np.testing.assert_array_equal(
                done[rid].tokens, _generate(params, cfg, prompt, steps))


class TestPrefixReuseExactness:
    @pytest.mark.parametrize("kw", VARIANTS, ids=IDS)
    def test_cache_on_bitwise_equals_cache_off(self, kw):
        # Same workload, same chunked discipline, the cache on and off:
        # the same tokens for every request, with real hits, and the
        # engine's ledger equal to the cache's counters.
        cfg = _cfg(**kw)
        params = _params(cfg, seed=0)
        workload = _shared_prefix_workload(cfg, np.random.default_rng(9))

        def run(pc):
            eng = _engine(params, cfg, batch=3, round_steps=4,
                          prefill_chunk=32, prefix_cache=pc)
            ids, done = _run_workload(eng, workload, waves=3)
            return eng, _tokens_by_id(ids, done)

        _, off = run(None)
        pc = _pc(cfg, 4)
        eng, on = run(pc)
        assert on == off
        assert pc.hits > 0 and pc.reclaimed_tokens >= 48
        st = eng.stats
        assert st.n_prefix_hits == pc.hits
        assert st.n_prefix_misses == pc.misses
        assert st.reclaimed_prefill_tokens == pc.reclaimed_tokens
        assert st.reclaimed_prefill_flops > 0
        # Each hit copied 2 x layers x Hk x Dh x 4 bytes per position,
        # read and written.
        dh = cfg.d_model // cfg.n_heads
        per_pos = 2 * cfg.n_layers * cfg.kv_heads * dh * 4
        assert st.admission_copy_bytes == 2 * per_pos * pc.reclaimed_tokens
        summ = st.summary()
        assert summ["prefix_hits"] == pc.hits
        assert summ["zero_copy_hits"] == 0
        ms = eng.metrics.snapshot()
        assert ms["counters"]["serving_prefix_hits_total"] == pc.hits
        assert ms["counters"]["serving_prefix_stores_total"] == pc.stores
        hit_admits = [e for e in eng.runlog.events("admit")
                      if e["prefix_hit_len"]]
        assert len(hit_admits) == pc.hits

    def test_eos_freeze_with_prefix_hits_matches_generate(self):
        cfg = _cfg()
        params = _params(cfg, seed=5)
        rng = np.random.default_rng(2)
        shared = rng.integers(0, cfg.vocab, 32)
        prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, k)])
                   for k in (3, 5, 8)]
        steps = 16
        eos = int(_generate(params, cfg, prompts[0], steps)[steps // 2])
        pc = _pc(cfg, 2)
        eng = _engine(params, cfg, batch=2, round_steps=4, eos_id=eos,
                      prefill_chunk=16, prefix_cache=pc)
        ids = {eng.submit(p, steps): p for p in prompts}
        done = {r.request_id: r for r in eng.run()}
        fired = 0
        for rid, p in ids.items():
            ref = _generate(params, cfg, p, steps, eos_id=eos)
            np.testing.assert_array_equal(done[rid].tokens, ref)
            fired += int((ref == eos).any())
        assert fired >= 1 and pc.hits >= 1

    def test_eviction_under_pool_pressure_stays_exact(self):
        # One pool row, three distinct shared prefixes cycling: stores
        # evict each other and later requests re-miss; the tokens stay
        # those of the cache-off run (no use-after-evict).
        cfg = _cfg()
        params = _params(cfg, seed=6)
        rng = np.random.default_rng(10)
        shares = [rng.integers(0, cfg.vocab, 32) for _ in range(3)]
        workload = [(np.concatenate([sh, rng.integers(0, cfg.vocab,
                                                      3 + rep + j)]),
                     3 + rep + j)
                    for rep in range(2) for j, sh in enumerate(shares)]

        def run(pc):
            # batch=1: every store lands before the next lookup.
            eng = _engine(params, cfg, batch=1, round_steps=6,
                          prefill_chunk=16, prefix_cache=pc)
            return _tokens_by_id(*_run_workload(eng, workload))

        off = run(None)
        pc = _pc(cfg, 1)
        assert run(pc) == off
        assert pc.evictions >= 2 and pc.rows_used == 1

    def test_storage_stable_and_shapes_bounded_across_hit_admissions(self):
        # The reference's donation and no-recompile pins in the port's
        # terms: copies, chunk prefills and rounds land in the SAME
        # buffers, and every prefill call runs at one tile shape whatever
        # the chunk, the hit or the prompt length (decode in (B,
        # DECODE_TILE) tiles).
        cfg = _cfg()
        params = _params(cfg, seed=8)
        rng = np.random.default_rng(3)
        shared = rng.integers(0, cfg.vocab, 48)
        pc = _pc(cfg, 2)
        eng = _engine(params, cfg, batch=2, round_steps=4, prefill_chunk=16,
                      prefix_cache=pc)

        def submit_two():
            for _ in range(2):
                eng.submit(np.concatenate(
                    [shared, rng.integers(0, cfg.vocab, 6)]), 5)

        for _ in range(2):  # the first run stores, the second hits
            submit_two()
            eng.run()
        assert pc.hits >= 2

        def pointers():
            return [eng._buf.data_ptr()] + [
                b.data_ptr() for cache in (eng._cache, pc.pool)
                for layer in cache for b in layer.values()]

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
        assert pc.hits >= 8
        assert pointers() == before
        assert shapes == {(1, pt.PREFILL_TILE, cfg.d_model),
                          (2, pt.DECODE_TILE, cfg.d_model)}

    def test_prefix_cache_engine_matches_the_jax_engine(self):
        # Same weights, the same shared-prefix workload through both
        # frameworks' prefix-cache engines: tokens agree up to any point
        # where the JAX model's top two logits are within 1e-4; both
        # caches see the same hits.
        kw = dict(vocab=48, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                  max_len=96, rope=True, n_kv_heads=1)
        jcfg = jt.TransformerConfig(**kw)
        cfg = pt.TransformerConfig(**kw)
        jparams = jt.init_params(jcfg, seed=4)
        params = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                         cfg, device="cpu")
        workload = _shared_prefix_workload(cfg, np.random.default_rng(11),
                                           prefix_len=32, n=5)
        jpc = JaxPrefixCache(jcfg, pool_rows=2)
        jeng = JaxEngine(jparams, jcfg, batch=2, round_steps=4,
                         prefill_chunk=32, prefix_cache=jpc)
        jids = [jeng.submit(p, st) for p, st in workload]
        jdone = {r.request_id: r for r in jeng.run()}
        pc = _pc(cfg, 2)
        eng = _engine(params, cfg, batch=2, round_steps=4, prefill_chunk=32,
                      prefix_cache=pc)
        ids = [eng.submit(p, st) for p, st in workload]
        done = {r.request_id: r for r in eng.run()}
        assert pc.hits == jpc.hits > 0
        assert pc.reclaimed_tokens == jpc.reclaimed_tokens
        for (prompt, _), jid, rid in zip(workload, jids, ids):
            ref, got = jdone[jid].tokens, done[rid].tokens
            if (ref == got).all():
                continue
            j = int(np.argmin(ref == got))
            seq = np.concatenate([prompt, ref[:j]])[None]
            logits = np.asarray(jt.forward(
                jparams, jnp.asarray(seq, jnp.int32), jcfg))[0, -1]
            top = np.sort(logits)[-2:]
            assert top[1] - top[0] <= 1e-4, \
                f"request {rid} diverges at token {j} off a near-tie"


class TestSampledPathKeys:
    def test_sampled_invariance_holds_with_prefix_reuse(self):
        # Per-request generators make sampled outputs independent of
        # batch, waves and round length, and hit and miss admissions
        # sample alike: the prefix engine's sampled outputs equal the
        # cache-off chunked run's.
        cfg = _cfg()
        params = _params(cfg, seed=4)
        workload = _shared_prefix_workload(cfg, np.random.default_rng(12),
                                           prefix_len=32, n=6)

        def run(batch, waves, rsteps, pc=None):
            eng = _engine(params, cfg, batch=batch, round_steps=rsteps,
                          temperature=0.8, seed=3, prefill_chunk=16,
                          prefix_cache=pc)
            return _tokens_by_id(*_run_workload(eng, workload, waves=waves))

        off = run(2, 1, 5)
        pc1, pc2 = _pc(cfg, 2), _pc(cfg, 2)
        on1 = run(2, 1, 5, pc1)
        on2 = run(3, 3, 9, pc2)
        assert pc1.hits > 0 and pc2.hits > 0
        assert on1 == off and on2 == off


class TestAdmissionCostModel:
    def test_hit_length_term(self):
        cfg = _cfg()
        cold_f, cold_b = cm.admission_cost(cfg, 96)
        warm_f, _ = cm.admission_cost(cfg, 96, hit_len=64)
        assert warm_f < cold_f
        # Reclaimed FLOPs grow faster than the hit (the attention
        # triangle): a 64-hit reclaims more than 2x a 32-hit.
        f32, _ = cm.admission_cost(cfg, 96, hit_len=32)
        assert (cold_f - warm_f) > 2 * (cold_f - f32)
        # A full hit computes nothing; only copy bytes remain.
        full_f, full_b = cm.admission_cost(cfg, 96, hit_len=96)
        assert full_f == 0 and 0 < full_b < cold_b
        # Chunked admission re-streams the params per chunk.
        assert cm.admission_cost(cfg, 96, chunk=32)[1] > cold_b
        with pytest.raises(ValueError, match="hit_len"):
            cm.admission_cost(cfg, 96, hit_len=97)

    @pytest.mark.parametrize("prompt_len,hit_len,chunk", [
        (96, 0, None), (96, 64, None), (160, 48, 32), (17, 16, 16)])
    def test_matches_the_jax_cost_model(self, prompt_len, hit_len, chunk):
        cfg = _cfg(rope=True, n_kv_heads=1)
        jcfg = jt.TransformerConfig(**cfg._asdict())
        assert cm.admission_cost(cfg, prompt_len, hit_len=hit_len,
                                 chunk=chunk) == \
            jcm.admission_cost(jcfg, prompt_len, hit_len=hit_len,
                               chunk=chunk)


def test_prefill_chunk_into_row_final_contract():
    # An interior chunk writes K/V only; the final one samples the first
    # token from the last prompt position and rewrites the row's buffer.
    cfg = _cfg()
    params = _params(cfg, seed=2)
    prompt = torch.as_tensor(np.random.default_rng(5).integers(0, 48, 40))
    cache = _cache(cfg, 2)
    buf = torch.full((2, cfg.max_len), 7, dtype=torch.long)
    assert prefill_chunk_into_row(params, cache, buf, 1, prompt[:32], 0, 32,
                                  prompt[:32], 40, cfg) is None
    assert (buf == 7).all()
    seg = torch.nn.functional.pad(prompt[32:], (0, GRAIN - 8))
    first = prefill_chunk_into_row(params, cache, buf, 1, seg, 32, 8, prompt,
                                   40, cfg, final=True)
    assert int(first) == _generate(params, cfg, prompt.numpy(), 1)[0]
    assert buf[1, :40].tolist() == prompt.tolist()
    assert int(buf[1, 40]) == int(first) and (buf[1, 41:] == 0).all()
    assert (buf[0] == 7).all()
