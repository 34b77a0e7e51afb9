"""The port's host KV tier (marlin_tpu_torch/serving/pages.HostKVTier,
PagedPrefixIndex's host half, slots.restore_pages_into_pool, the engine's
host_kv_bytes / host_kv_dir / restore_min_tokens, cost_model's restore
pricing and crossover), twins of tests/test_host_kv.py.

Inside the port, bitwise on the CPU: payloads round-trip through memory
and through the spill dir (float32, bfloat16 written as float32, int8
with its scales); the budget drops prefixes least recently used and never
a pinned row; the index spills only an entry it alone holds and a restore
pins it once; a tier-on engine's tokens equal the tier-off engine's, and
an engine adopts what another wrote to a shared dir. Against the JAX
package: the content key is string-equal, a spill dir's ``.npz`` written
by either tier is restored by the other byte for byte, and the cost
model's restore, preemption and crossover functions are equal.
"""

import os

import numpy as np
import pytest
import torch

import jax

from marlin_tpu.models import transformer as jt
from marlin_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from marlin_tpu.serving.pages import HostKVTier as JaxTier
from marlin_tpu.serving.pages import PagePool as JaxPool
from marlin_tpu.serving.slots import \
    restore_pages_into_pool as jax_restore
from marlin_tpu.utils import cost_model as jcm
from marlin_tpu_torch.models import transformer as pt
from marlin_tpu_torch.models.quant import kv_layer_keys
from marlin_tpu_torch.obs.metrics import MetricsRegistry
from marlin_tpu_torch.obs.runlog import RunLog
from marlin_tpu_torch.serving import (PAGE, HostKVTier, PagedPrefixIndex,
                                      PagePool, ServingEngine,
                                      restore_pages_into_pool)
from marlin_tpu_torch.utils import cost_model as cm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    base = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                max_len=128)
    base.update(kw)
    return pt.TransformerConfig(**base)


def _pool(cfg, n_pages=8):
    return PagePool(cfg, n_pages, registry=MetricsRegistry(), device="cpu")


def _random_payload(layers, n, seed):
    """A typed random payload for ``n`` pages of pool ``layers`` (numpy,
    float32 for float pools): the bytes a test scatters in."""
    rng = np.random.default_rng(seed)
    out = []
    for layer in layers:
        nl = {}
        for name in kv_layer_keys(layer):
            shape = (n,) + tuple(layer[name].shape[1:])
            if str(layer[name].dtype).endswith("int8"):
                nl[name] = rng.integers(-127, 127, shape).astype(np.int8)
            else:
                nl[name] = rng.standard_normal(shape).astype(np.float32)
        out.append(nl)
    return out


def _held(pool, pages):
    """What the pool holds at ``pages`` (copies)."""
    idx = torch.as_tensor(pages)
    return [{n: layer[n].index_select(0, idx) for n in kv_layer_keys(layer)}
            for layer in pool.pages]


def _filled_pages(pool, n, seed=3):
    """Alloc ``n`` pages and scatter a random payload into them through
    the restore; returns (pages, what the pool then holds)."""
    pages = pool.alloc(n)
    payload = [{k: torch.from_numpy(v) for k, v in layer.items()}
               for layer in _random_payload(pool.pages, n, seed)]
    restore_pages_into_pool(pool.pages, payload, pages)
    return pages, _held(pool, pages)


def _values(t):
    """A payload entry's values in float64 (exact for float32, bfloat16
    and int8, so equal values are equal bytes in one dtype)."""
    if isinstance(t, torch.Tensor):
        return t.double().numpy()
    return np.asarray(t).astype(np.float64)


def _payloads_equal(a, b):
    return all(np.array_equal(_values(la[n]), _values(lb[n]))
               for la, lb in zip(a, b) for n in lb)


class TestHostTierPayloads:
    def test_spill_fetch_roundtrip_is_bit_identical(self):
        pool = _pool(_cfg())
        tier = HostKVTier(pool, registry=pool.registry)
        pages, held = _filled_pages(pool, 3)
        tokens = np.arange(3 * PAGE)
        key, nbytes, dt = tier.spill(tokens, 3 * PAGE, pages)
        assert nbytes == sum(t.numel() * t.element_size()
                             for l in held for t in l.values())
        got, got_bytes = tier.fetch(key)
        assert got_bytes == nbytes and _payloads_equal(got, held)
        assert dt >= 0.0
        # The host copy is its own: overwriting the pages moves nothing.
        restore_pages_into_pool(
            pool.pages, [{n: torch.zeros_like(t) for n, t in l.items()}
                         for l in held], pages)
        assert _payloads_equal(tier.fetch(key)[0], held)

    def test_spill_dir_roundtrip_survives_drop(self, tmp_path):
        pool = _pool(_cfg())
        tier = HostKVTier(pool, registry=pool.registry,
                          spill_dir=str(tmp_path))
        pages, held = _filled_pages(pool, 2)
        key, _, _ = tier.spill(np.arange(2 * PAGE), 2 * PAGE, pages)
        tier.drop(key)  # memory gone; the dir's file is the durable copy
        assert tier.summary()["host_entries"] == 0
        got, _ = tier.fetch(key)
        assert got is not None and _payloads_equal(got, held)

    def test_bfloat16_pool_roundtrips_exactly_through_disk(self, tmp_path):
        pool = _pool(_cfg(dtype="bfloat16"))
        tier = HostKVTier(pool, registry=pool.registry,
                          spill_dir=str(tmp_path))
        pages, held = _filled_pages(pool, 2)
        key, _, _ = tier.spill(np.arange(2 * PAGE), 2 * PAGE, pages)
        mem, _ = tier.fetch(key)
        assert mem[0]["k"].dtype == torch.bfloat16  # in the pool's dtype
        tier.drop(key)
        got, _ = tier.fetch(key)
        assert got[0]["k"].dtype == torch.float32  # the file's float32
        assert _payloads_equal(got, held)
        fresh = pool.alloc(2)
        restore_pages_into_pool(pool.pages, got, fresh)
        assert _payloads_equal(_held(pool, fresh), held)

    def test_int8_scales_travel_with_their_pages(self, tmp_path):
        pool = _pool(_cfg(kv_quant="int8"))
        tier = HostKVTier(pool, registry=pool.registry,
                          spill_dir=str(tmp_path))
        pages, held = _filled_pages(pool, 2)
        key, _, _ = tier.spill(np.arange(2 * PAGE), 2 * PAGE, pages)
        got, _ = tier.fetch(key)
        assert {"k", "v", "ks", "vs"} <= {n for l in got for n in l}
        assert _payloads_equal(got, held)
        tier.drop(key)
        assert _payloads_equal(tier.fetch(key)[0], held)

    def test_budget_lru_drops_oldest_and_oversize_is_refused(self):
        pool = _pool(_cfg())
        pages1, _ = _filled_pages(pool, 2, seed=1)
        pages2, _ = _filled_pages(pool, 2, seed=2)
        t1 = np.arange(2 * PAGE)
        t2 = t1 + 1
        _, one_payload, _ = HostKVTier(
            pool, registry=pool.registry).spill(t1, 2 * PAGE, pages1)
        tier = HostKVTier(pool, budget_bytes=one_payload,
                          registry=pool.registry)
        k1, _, _ = tier.spill(t1, 2 * PAGE, pages1)
        k2, _, _ = tier.spill(t2, 2 * PAGE, pages2)
        assert tier.fetch(k1) is None and tier.fetch(k2) is not None
        assert tier.summary()["host_drops"] == 1
        assert HostKVTier(pool, budget_bytes=1, registry=pool.registry) \
            .spill(t1, 2 * PAGE, pages1) is None

    def test_pinned_rows_survive_budget_pressure_and_evict_prefixes(self):
        pool = _pool(_cfg())
        pages1, held1 = _filled_pages(pool, 2, seed=1)
        pages2, _ = _filled_pages(pool, 2, seed=2)
        t1 = np.arange(2 * PAGE)
        _, one_payload, _ = HostKVTier(pool, registry=pool.registry) \
            .spill(t1, 2 * PAGE, pages1)
        row_bytes = one_payload + 4 * t1.size  # tokens kept as int32
        tier = HostKVTier(pool, budget_bytes=row_bytes + one_payload,
                          registry=pool.registry)
        k_prefix, _, _ = tier.spill(t1, 2 * PAGE, pages1)
        res = tier.spill_row("row-0-0", t1, pages1)
        assert res is not None and res[0] == row_bytes
        # The second pinned row evicts the prefix, then still does not fit.
        assert tier.spill_row("row-1-0", t1, pages2) is None
        assert tier.fetch(k_prefix) is None
        summ = tier.summary()
        assert summ["host_rows"] == 1 and summ["host_row_bytes"] == row_bytes
        payload, toks, nbytes = tier.fetch_row("row-0-0")
        assert nbytes == row_bytes and _payloads_equal(payload, held1)
        assert np.array_equal(toks, t1)
        with pytest.raises(RuntimeError, match="one freeze, one spill"):
            tier.spill_row("row-0-0", t1, pages2)
        tier.drop_row("row-0-0")
        assert tier.fetch_row("row-0-0") is None
        assert tier.summary()["host_row_bytes"] == 0
        tier.drop_row("row-0-0")  # idempotent

    def test_probe_finds_longest_prefix_and_content_key_is_stable(
            self, tmp_path):
        pool = _pool(_cfg())
        tier = HostKVTier(pool, registry=pool.registry,
                          spill_dir=str(tmp_path))
        pages, _ = _filled_pages(pool, 2)
        tokens = np.arange(2 * PAGE)
        key, _, _ = tier.spill(tokens, 2 * PAGE, pages)
        assert key == HostKVTier.key_for(tokens, 2 * PAGE)
        prompt = np.concatenate([tokens, np.full(5, 63)])
        assert tier.probe(prompt) == (key, 2 * PAGE)
        assert HostKVTier(pool, registry=pool.registry,
                          spill_dir=str(tmp_path)).probe(prompt) == \
            (key, 2 * PAGE)  # a fresh tier finds the file
        assert HostKVTier(pool, registry=pool.registry).probe(prompt) == \
            (None, 0)

    def test_spill_and_restore_go_through_the_pool_device(self):
        # CPU pool: a plain (pageable) host copy; the restore scatters in
        # place, so the pool's storage never moves.
        pool = _pool(_cfg())
        ptrs = [t.data_ptr() for l in pool.pages for t in l.values()]
        tier = HostKVTier(pool, registry=pool.registry)
        pages, _ = _filled_pages(pool, 2)
        key, _, _ = tier.spill(np.arange(2 * PAGE), 2 * PAGE, pages)
        assert not tier.fetch(key)[0][0]["k"].is_pinned()
        assert [t.data_ptr() for l in pool.pages for t in l.values()] \
            == ptrs


class TestAgainstTheJaxTier:
    @pytest.mark.parametrize("n", [16, 32, 48, 120])
    def test_content_key_is_the_jax_key(self, n):
        tokens = np.random.default_rng(n).integers(0, 50_000, n + 7)
        length = n // PAGE * PAGE
        assert HostKVTier.key_for(tokens, length) == \
            JaxTier.key_for(tokens.astype(np.int32), length)
        assert HostKVTier.key_for(torch.as_tensor(tokens), length) == \
            JaxTier.key_for(tokens, length)

    @pytest.mark.parametrize("kw", [{}, {"dtype": "bfloat16"},
                                     {"kv_quant": "int8", "n_kv_heads": 1}],
                             ids=["f32", "bf16", "int8"])
    def test_spill_dirs_are_interchangeable(self, kw, tmp_path):
        cfg = _cfg(**kw)
        jcfg = jt.TransformerConfig(**cfg._asdict())
        tokens = np.random.default_rng(4).integers(1, cfg.vocab, 3 * PAGE)
        prompt = np.concatenate([tokens, [5, 6]])
        # JAX writes, the port adopts and restores.
        jpool = JaxPool(jcfg, 8, registry=JaxRegistry())
        jpages = jpool.alloc(3)
        payload = _random_payload(jpool.pages, 3, seed=11)
        jpool.pages = jax_restore(jpool.pages, payload,
                                  jax.numpy.asarray(np.int32(jpages)))
        idx = np.asarray(jpages, np.int32)
        jheld = [{n: np.asarray(l[n][idx]) for n in kv_layer_keys(l)}
                 for l in jpool.pages]
        jdir = tmp_path / "from_jax"
        jkey, _, _ = JaxTier(jpool, registry=jpool.registry,
                             spill_dir=str(jdir)).spill(
            tokens.astype(np.int32), 3 * PAGE, jpages)
        pool = _pool(cfg)
        tier = HostKVTier(pool, registry=pool.registry, spill_dir=str(jdir))
        assert tier.probe(prompt) == (jkey, 3 * PAGE)
        got, _ = tier.fetch(jkey)
        pages = pool.alloc(3)
        restore_pages_into_pool(pool.pages, got, pages)
        assert _payloads_equal(_held(pool, pages), jheld)
        # The port writes, JAX adopts and restores.
        pdir = tmp_path / "from_port"
        pkey, _, _ = HostKVTier(pool, registry=pool.registry,
                                spill_dir=str(pdir)).spill(
            tokens, 3 * PAGE, pages)
        assert pkey == jkey
        jtier = JaxTier(jpool, registry=jpool.registry, spill_dir=str(pdir))
        assert jtier.probe(prompt) == (pkey, 3 * PAGE)
        jgot, _ = jtier.fetch(pkey)
        jfresh = jpool.alloc(3)
        jpool.pages = jax_restore(jpool.pages, jgot,
                                  jax.numpy.asarray(np.int32(jfresh)))
        idx = np.asarray(jfresh, np.int32)
        back = [{n: np.asarray(l[n][idx]) for n in kv_layer_keys(l)}
                for l in jpool.pages]
        assert _payloads_equal(back, jheld)
        with np.load(jdir / f"{jkey}.npz") as a, \
                np.load(pdir / f"{pkey}.npz") as b:
            assert a.files == b.files
            for name in a.files:
                assert a[name].dtype == b[name].dtype, name
                assert np.array_equal(a[name], b[name]), name


class TestIndexSpillTransitions:
    def _setup(self, tmp_path=None, n_pages=8):
        cfg = _cfg()
        pool = _pool(cfg, n_pages)
        tier = HostKVTier(
            pool, registry=pool.registry,
            spill_dir=str(tmp_path) if tmp_path is not None else None)
        idx = PagedPrefixIndex(pool, registry=pool.registry, host_tier=tier)
        return cfg, pool, tier, idx

    def _prompt(self, cfg):
        return np.arange(2 * PAGE + 4) % cfg.vocab

    def test_evict_spills_only_when_index_is_sole_holder(self):
        cfg, pool, tier, idx = self._setup()
        pages, _ = _filled_pages(pool, 2)
        idx.store(self._prompt(cfg), pages)
        pool.ref(pages)  # a live row still aliases the pages
        before = pool.n_free
        idx.evict_until_free(pool.n_free + 1)
        assert tier.summary()["spills"] == 0
        assert idx.summary()["prefix_entries"] == 0
        assert pool.n_free == before
        pool.unref(pages)
        pool.unref(pages)
        assert pool.n_free == 8

    def test_spill_then_rebind_refcounts_exactly(self):
        cfg, pool, tier, idx = self._setup()
        pages, _ = _filled_pages(pool, 2)
        prompt = self._prompt(cfg)
        assert idx.store(prompt, pages) == 2 * PAGE
        pool.unref(pages)  # the storing row retired: the index alone
        idx.evict_until_free(pool.n_pages)
        assert tier.summary()["spills"] == 1
        assert all(pool.refcount(p) == 0 for p in pages)
        s = idx.summary()
        assert s["prefix_spilled_entries"] == 1 and s["prefix_entries"] == 1
        probe = np.concatenate([prompt, np.zeros(4, np.int64)])
        _, hit, sp, sp_hit = idx.lookup_candidates(probe)
        assert hit == 0 and sp is not None and sp_hit == 2 * PAGE
        fresh = pool.alloc(2)
        idx.rebind(sp, fresh)
        assert all(pool.refcount(p) == 2 for p in fresh)
        assert idx.summary()["prefix_spilled_entries"] == 0
        res, hit = idx.lookup(probe)
        assert hit == 2 * PAGE and list(res) == list(fresh)

    def test_rebind_rejects_resident_entries_and_bad_page_counts(self):
        cfg, pool, tier, idx = self._setup()
        pages, _ = _filled_pages(pool, 2)
        idx.store(self._prompt(cfg), pages)
        (eid,) = idx._entries
        with pytest.raises(RuntimeError, match="state 'resident'"):
            idx.rebind(eid, pages)
        pool.unref(pages)
        idx.evict_until_free(pool.n_pages)
        with pytest.raises(ValueError, match="pages"):
            idx.rebind(eid, pool.alloc(1))

    def test_forget_drops_stale_spilled_entry(self):
        cfg, pool, tier, idx = self._setup()
        pages, _ = _filled_pages(pool, 2)
        prompt = self._prompt(cfg)
        idx.store(prompt, pages)
        pool.unref(pages)
        idx.evict_until_free(pool.n_pages)
        probe = np.concatenate([prompt, np.zeros(4, np.int64)])
        eid = idx.lookup_candidates(probe)[2]
        assert eid is not None
        idx.forget(eid)
        assert idx.summary()["prefix_entries"] == 0
        assert tier.summary()["host_entries"] == 0  # its payload went too
        assert idx.lookup_candidates(probe)[2] is None
        idx.forget(eid)  # idempotent

    def test_adopt_creates_spilled_entry_without_device_refs(self, tmp_path):
        cfg, pool, tier, idx = self._setup(tmp_path)
        pages, _ = _filled_pages(pool, 2)
        tokens = np.arange(2 * PAGE)
        key, _, _ = tier.spill(tokens, 2 * PAGE, pages)
        eid = idx.adopt(tokens, 2 * PAGE, key)
        assert eid is not None and idx.host_key_of(eid) == key
        assert pool.n_free == pool.n_pages - 2  # no new references
        probe = np.concatenate([tokens, np.zeros(4, np.int64)])
        assert idx.lookup_candidates(probe)[2] == eid
        assert idx.adopt(tokens, 2 * PAGE, key) is None  # covered

    def test_resident_store_dedupes_covered_spilled_entry(self):
        cfg, pool, tier, idx = self._setup()
        pages, _ = _filled_pages(pool, 2)
        prompt = self._prompt(cfg)
        idx.store(prompt, pages)
        pool.unref(pages)
        idx.evict_until_free(pool.n_pages)
        assert idx.summary()["prefix_spilled_entries"] == 1
        fresh, _ = _filled_pages(pool, 2, seed=9)
        idx.store(prompt, fresh)  # the same prefix, resident again
        s = idx.summary()
        assert s["prefix_spilled_entries"] == 0 and s["prefix_entries"] == 1


def _workload(cfg, eng):
    """A 48-token prefix admitted, pushed out of a 10-page pool by three
    cold prompts, then hit again."""
    rng = np.random.default_rng(5)
    prefix = rng.integers(1, cfg.vocab, 48)
    outs = []
    eng.submit(np.concatenate([prefix, rng.integers(1, cfg.vocab, 8)]), 8)
    outs.append([r.tokens.tolist() for r in eng.run()])
    for i in range(3):
        eng.submit(np.random.default_rng(100 + i).integers(1, cfg.vocab,
                                                           64), 8)
    outs.append(sorted(r.tokens.tolist() for r in eng.run()))
    eng.submit(np.concatenate([prefix, rng.integers(1, cfg.vocab, 4)]), 8)
    outs.append([r.tokens.tolist() for r in eng.run()])
    return outs


def _engine(params, cfg, tier, tmp_path=None, **kw):
    kw.setdefault("metrics_registry", MetricsRegistry())
    return ServingEngine(
        params, cfg, batch=2, kv_pages=10, prefill_chunk=16,
        host_kv_bytes=(1 << 22) if tier else None,
        host_kv_dir=str(tmp_path) if tmp_path is not None else None,
        restore_min_tokens=16 if (tier or tmp_path is not None) else None,
        device="cpu", **kw)


class TestEngineRestore:
    @pytest.mark.parametrize("kw", [{}, {"kv_quant": "int8", "rope": True,
                                         "n_kv_heads": 1}],
                             ids=["f32", "int8_rope_mqa"])
    def test_restore_is_bitexact_and_observable(self, kw):
        cfg = _cfg(**kw)
        params = pt.init_params(cfg, seed=0, device="cpu")
        runlog = RunLog(maxlen=512)
        reg = MetricsRegistry()
        eng = _engine(params, cfg, tier=True, metrics_registry=reg,
                      runlog=runlog)
        on = _workload(cfg, eng)
        ht = eng.host_tier.summary()
        off = _workload(cfg, _engine(params, cfg, tier=False))
        assert on == off
        assert ht["spills"] >= 1 and ht["restores"] >= 1
        assert eng.restore_min_tokens == 16
        assert reg.counter("serving_kv_spills_total").value == ht["spills"]
        assert reg.counter("serving_kv_restores_total").value \
            == ht["restores"]
        assert reg.histogram("serving_kv_restore_seconds").summary()[
            "count"] == ht["restores"]
        spills, restores = runlog.events("spill"), runlog.events("restore")
        assert spills and restores
        assert all(e["bytes"] > 0 and e["spill_s"] >= 0 for e in spills)
        assert all(e["bytes"] > 0 and e["restore_s"] >= 0
                   and e["length"] == 48 for e in restores)
        rounds = runlog.events("round")
        assert sum(e.get("spills", 0) for e in rounds) == ht["spills"]
        assert sum(e.get("restores", 0) for e in rounds) == ht["restores"]
        # The restored admission prefilled only its tail.
        last = runlog.events("admit")[-1]
        assert last["prefix_hit_len"] == 48
        assert eng.prefix_index.summary()["prefix_restores"] >= 1

    def test_crossover_gate_reprefills_short_hits(self):
        cfg = _cfg()
        params = pt.init_params(cfg, seed=0, device="cpu")
        eng = ServingEngine(params, cfg, batch=2, kv_pages=10,
                            prefill_chunk=16, host_kv_bytes=1 << 22,
                            restore_min_tokens=cfg.max_len + 1,
                            metrics_registry=MetricsRegistry(),
                            device="cpu")
        on = _workload(cfg, eng)
        summ = eng.host_tier.summary()
        assert summ["spills"] >= 1 and summ["restores"] == 0
        assert on == _workload(cfg, _engine(params, cfg, tier=False))

    def test_adoption_across_engines_sharing_a_spill_dir(self, tmp_path):
        cfg = _cfg()
        params = pt.init_params(cfg, seed=0, device="cpu")
        a = _engine(params, cfg, tier=True, tmp_path=tmp_path)
        _workload(cfg, a)
        assert a.host_tier.summary()["spills"] >= 1
        assert any(f.endswith(".npz") for f in os.listdir(tmp_path))
        prefix = np.random.default_rng(5).integers(1, cfg.vocab, 48)
        pb = np.concatenate([prefix, np.full(4, 7)])
        b = _engine(params, cfg, tier=True, tmp_path=tmp_path)
        b.submit(pb, 8)
        toks_b = [r.tokens.tolist() for r in b.run()]
        assert b.prefix_index.adoptions >= 1
        assert b.host_tier.summary()["restores"] >= 1
        ref = ServingEngine(params, cfg, batch=2, kv_pages=10,
                            prefill_chunk=16, device="cpu",
                            metrics_registry=MetricsRegistry())
        ref.submit(pb, 8)
        assert toks_b == [r.tokens.tolist() for r in ref.run()]

    def test_host_rows_and_bytes_end_at_zero_without_a_scheduler(self):
        cfg = _cfg()
        eng = _engine(pt.init_params(cfg, seed=0, device="cpu"), cfg,
                      tier=True)
        _workload(cfg, eng)
        s = eng.host_tier.summary()
        assert s["host_rows"] == 0 and s["host_row_bytes"] == 0
        assert eng.debug_sched() is None

    def test_knob_validation(self):
        cfg = _cfg()
        params = pt.init_params(cfg, seed=0, device="cpu")
        with pytest.raises(ValueError, match="kv_pages"):
            ServingEngine(params, cfg, host_kv_bytes=1 << 20, device="cpu")
        with pytest.raises(ValueError, match="prefix_sharing"):
            ServingEngine(params, cfg, kv_pages=10, prefix_sharing=False,
                          host_kv_bytes=1 << 20, device="cpu")
        with pytest.raises(ValueError, match="restore_min_tokens"):
            ServingEngine(params, cfg, kv_pages=10, restore_min_tokens=32,
                          device="cpu")
        with pytest.raises(ValueError, match="budget_bytes"):
            HostKVTier(_pool(cfg), budget_bytes=0)
        eng = ServingEngine(params, cfg, kv_pages=10, host_kv_bytes=1 << 20,
                            device="cpu", metrics_registry=MetricsRegistry())
        assert eng.restore_min_tokens == cm.KV_RESTORE_MIN_TOKENS_DEFAULT


class TestRestoreCostModel:
    def test_restore_cost_matches_admission_copy_pricing(self):
        for kw in ({}, {"kv_quant": "int8"}, {"n_kv_heads": 1}):
            cfg = _cfg(**kw)
            for h in (0, 16, 64):
                flops, byts = cm.restore_cost(cfg, h)
                assert flops == 0.0
                assert byts == cm.admission_cost(cfg, h, hit_len=h)[1]
        with pytest.raises(ValueError):
            cm.restore_cost(_cfg(), -1)

    def test_restore_wins_beyond_crossover_in_the_model(self):
        cfg = _cfg()
        ratio = [cm.restore_cost(cfg, h)[1] / cm.admission_cost(cfg, h)[0]
                 for h in (64, 1024 * 16)]
        assert ratio[1] < ratio[0]

    def test_derive_interpolates_and_clamps(self):
        assert cm.derive_kv_restore_min_tokens(
            [{"length": 64, "restore_over_reprefill": 2.0},
             {"length": 256, "restore_over_reprefill": 0.5}]) == 128
        assert cm.derive_kv_restore_min_tokens(
            [{"length": 64, "restore_over_reprefill": 0.5},
             {"length": 256, "restore_over_reprefill": 0.1}]) == 32
        assert cm.derive_kv_restore_min_tokens(
            [{"length": 64, "restore_over_reprefill": 3.0},
             {"length": 256, "restore_over_reprefill": 1.5}]) == 512
        with pytest.raises(ValueError):
            cm.derive_kv_restore_min_tokens([])
        with pytest.raises(ValueError):
            cm.derive_kv_restore_min_tokens(
                [{"length": 64, "restore_over_reprefill": 0.0}])

    def test_crossover_sweep_runs_on_the_device_it_is_given(self):
        pts = cm.run_kv_restore_crossover_sweep(lengths=(64, 128), reps=1,
                                                device="cpu")
        assert [p["length"] for p in pts] == [64, 128]
        assert all(p["restore_s"] > 0 and p["reprefill_s"] > 0
                   and p["restore_over_reprefill"] > 0 for p in pts)
        assert cm.derive_kv_restore_min_tokens(pts) >= 16
        with pytest.raises(ValueError, match="multiple"):
            cm.run_kv_restore_crossover_sweep(lengths=(40,), device="cpu")

    @pytest.mark.parametrize("kw", [{}, {"kv_quant": "int8"},
                                     {"n_kv_heads": 1, "rope": True},
                                     {"dtype": "bfloat16", "d_model": 64}],
                             ids=["f32", "int8", "rope_mqa", "bf16"])
    def test_matches_the_jax_cost_model(self, kw):
        cfg = _cfg(**kw)
        jcfg = jt.TransformerConfig(**cfg._asdict())
        for h in (0, 16, 48, 512):
            assert cm.restore_cost(cfg, h) == jcm.restore_cost(jcfg, h)
            assert cm.preempt_cost(cfg, h) == jcm.preempt_cost(jcfg, h)
            assert cm.admission_cost(cfg, h, hit_len=h) == \
                jcm.admission_cost(jcfg, h, hit_len=h)
        for row_len, remaining, margin in ((16, 1000, 1.0), (64, 4096, 1.0),
                                           (64, 4096, 1e9), (96, 3, 1.0),
                                           (64, 0, 1.0), (300, 40, 2.5)):
            assert cm.preempt_beneficial(cfg, row_len, remaining,
                                         margin=margin) == \
                jcm.preempt_beneficial(jcfg, row_len, remaining,
                                       margin=margin)
        rng = np.random.default_rng(len(kw))
        for _ in range(5):
            pts = [{"length": int(l), "restore_over_reprefill":
                    float(r)} for l, r in zip(
                        rng.choice([32, 64, 128, 256, 512], 3, False),
                        rng.uniform(0.1, 3.0, 3))]
            assert cm.derive_kv_restore_min_tokens(pts) == \
                jcm.derive_kv_restore_min_tokens(pts)
        assert cm.KV_RESTORE_MIN_TOKENS_DEFAULT == \
            jcm.KV_RESTORE_MIN_TOKENS_DEFAULT
        assert cm.KV_RESTORE_LENGTHS == jcm.KV_RESTORE_LENGTHS
