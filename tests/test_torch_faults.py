"""The port's fault injection and supervised restart (marlin_tpu_torch/
serving/faults.py, serving/frontend.py's crash boundary, the engine's
spawn_successor / requeue), twins of tests/test_faults.py's in-process
classes (TestFaultPlan, TestBitExactRecovery, TestQuarantineAndFailClosed,
TestDeadlinesAcrossRecovery) and of the restart tests of
tests/test_host_kv.py, tests/test_serving_spec.py and tests/test_sched.py,
plus a TP = 2 crash on two CPU shards.

Inside the port, bitwise on the CPU: a recovered request's tokens equal
the same request's in an uninterrupted run, in every site and discipline
(one-shot, chunked, prefix cache, paged with sharing, speculative, host
tier with re-adoption, scheduler preemption, TP = 2). Against the JAX
package, the same plan over the same seeded inputs and weights
(``params_from_jax``) gives the same schedule facts exactly (restarts,
recovered and quarantined ids, each request's ``crash_count`` and
``requeues``), and the same greedy tokens up to a JAX top-2 logit margin
of 1e-4, the tolerance of tests/test_torch_serving.py.

Every request is submitted before the driver starts (or, for the
staggered preemption, between rounds the test steps itself), so the
schedule, and the requests in flight at a crash, do not depend on thread
timing.
"""

import os
import time
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marlin_tpu.models import transformer as jt
from marlin_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from marlin_tpu.serving import EngineFrontend as JaxFrontend
from marlin_tpu.serving import PoisonedRequest as JaxPoisoned
from marlin_tpu.serving import PrefixCache as JaxPrefixCache
from marlin_tpu.serving import ServingEngine as JaxEngine
from marlin_tpu.serving import faults as jfaults
from marlin_tpu_torch.models import convert
from marlin_tpu_torch.models import transformer as pt
from marlin_tpu_torch.obs import metrics as obs_metrics
from marlin_tpu_torch.obs.metrics import MetricsRegistry
from marlin_tpu_torch.serving import (EngineFailed, EngineFrontend,
                                      PoisonedRequest, PrefixCache,
                                      Scheduler, ServingEngine, faults)

JOIN_S = 30.0  # the longest a test waits on a handle or a driver thread


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_plan():
    """No plan leaks out of a test, the port's or the reference's."""
    yield
    faults.reset()
    jfaults.reset()


@pytest.fixture
def frontends():
    """Builds frontends (the port's or the reference's) and stops every
    one at teardown, its driver thread joined within JOIN_S."""
    made = []

    def make(cls, engine, **kw):
        fe = cls(engine, **kw)
        made.append(fe)
        return fe

    yield make
    for fe in made:
        fe._stopped.set()
        fe._wake.set()
        if fe._thread is not None:
            fe._thread.join(JOIN_S)
            assert not fe._thread.is_alive(), "driver thread did not stop"


_CFG = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
            max_len=64)


@pytest.fixture(scope="module")
def model():
    """The reference tests' model, its JAX weights and the port's copy."""
    jcfg = jt.TransformerConfig(**_CFG)
    jparams = jt.init_params(jcfg, seed=0)
    cfg = pt.TransformerConfig(**_CFG)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    return params, cfg, jparams, jcfg


def _prompts(cfg, n, length=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, length).astype(np.int32)
            for _ in range(n)]


def _shared_prompts(cfg, n=5):
    """A 32-token shared prefix and 8-token tails."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, cfg.vocab, 32).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, cfg.vocab, 8)
                            .astype(np.int32)]) for _ in range(n)]


def _golden(params, cfg, prompts, steps, **eng_kw):
    """An uninterrupted port run of the same workload (ids in submission
    order): the bitwise reference."""
    eng_kw.setdefault("metrics_registry", MetricsRegistry())
    eng = ServingEngine(params, cfg, device="cpu", **eng_kw)
    for i, p in enumerate(prompts):
        eng.submit(p, steps if np.isscalar(steps) else steps[i])
    return {r.request_id: list(map(int, r.tokens)) for r in eng.run()}


def _drive(make, frontend_cls, engine, prompts, steps, stream_mod=0,
           **fe_kw):
    """Submit every request, then start the driver and wait for each.
    Returns (frontend, {rid: streamed tokens}, {rid: Request or the
    PoisonedRequest it raised})."""
    fe = make(frontend_cls, engine, **fe_kw)
    handles = [fe.submit(p, steps if np.isscalar(steps) else steps[i],
                         stream=bool(stream_mod) and i % stream_mod == 0)
               for i, p in enumerate(prompts)]
    fe.start()
    streamed, results = {}, {}
    for h in handles:
        if h.stream:
            toks = []
            for chunk in h.chunks(timeout=JOIN_S):
                toks.extend(int(t) for t in chunk)
            streamed[h.request_id] = toks
    for h in handles:
        try:
            results[h.request_id] = h.result(JOIN_S)
        except (PoisonedRequest, JaxPoisoned) as e:
            results[h.request_id] = e
    return fe, streamed, results


def _chaos(make, params, cfg, specs, prompts, steps, temperature=0.0,
           stream_mod=2, fe_kw=None, **eng_kw):
    """The port's engine under ``specs`` through its frontend: (frontend,
    registry, streamed, results); the plan is active only for the run."""
    plan = faults.install(faults.FaultPlan())
    for s in specs:
        plan.add(**s)
    reg = MetricsRegistry()
    eng_kw.setdefault("batch", 2)
    eng_kw.setdefault("round_steps", 2)
    eng = ServingEngine(params, cfg, temperature=temperature,
                        metrics_registry=reg, device="cpu", **eng_kw)
    fe, streamed, results = _drive(make, EngineFrontend, eng, prompts,
                                   steps, stream_mod, **(fe_kw or {}))
    faults.reset()
    return fe, reg, streamed, results


def _jax_chaos(make, jparams, jcfg, specs, prompts, steps, temperature=0.0,
               fe_kw=None, prefix_cache=False, **eng_kw):
    """The same plan and workload through the JAX package's engine and
    frontend (blocking handles only: the schedule does not depend on
    which handles stream)."""
    plan = jfaults.install(jfaults.FaultPlan())
    for s in specs:
        plan.add(**s)
    eng_kw.setdefault("batch", 2)
    eng_kw.setdefault("round_steps", 2)
    if prefix_cache:
        eng_kw["prefix_cache"] = JaxPrefixCache(jcfg, pool_rows=4)
    eng = JaxEngine(jparams, jcfg, temperature=temperature,
                    metrics_registry=JaxRegistry(), **eng_kw)
    fe, _, results = _drive(make, JaxFrontend, eng, prompts, steps,
                            **(fe_kw or {}))
    jfaults.reset()
    return fe, results


def _facts(fe, results):
    """The schedule facts a plan must reproduce across frameworks."""
    per = {}
    for rid, r in results.items():
        if isinstance(r, Exception):
            per[rid] = ("poisoned", r.crash_count)
        else:
            per[rid] = (r.status, r.crash_count, r.requeues)
    return dict(
        restarts=fe.restarts,
        recovered=sorted(rid for rid, r in results.items()
                         if not isinstance(r, Exception) and r.requeues),
        quarantined=sorted(rid for rid, r in results.items()
                           if isinstance(r, Exception)),
        per_request=per)


def _jax_margin(jparams, jcfg, prompt, tokens, j):
    """Top-2 logit margin of the JAX model before token ``j``."""
    seq = np.concatenate([prompt, tokens[:j]])[None]
    logits = np.asarray(jt.forward(jparams, jnp.asarray(seq, jnp.int32),
                                   jcfg))[0, -1]
    top = np.sort(logits)[-2:]
    return float(top[1] - top[0])


def _against_reference(model, prompts, port, ref):
    """The reference's facts and greedy tokens against the port's."""
    _, _, jparams, jcfg = model
    pfe, pres = port
    jfe, jres = ref
    assert _facts(pfe, pres) == _facts(jfe, jres)
    for rid, r in pres.items():
        if isinstance(r, Exception) or r.status != "done":
            continue
        got, want = np.asarray(r.tokens), np.asarray(jres[rid].tokens)
        if (got == want).all():
            continue
        j = int(np.argmin(got == want))
        assert _jax_margin(jparams, jcfg, prompts[rid], want, j) <= 1e-4, \
            f"request {rid} diverges from the reference at token {j}"


def _tokens(results):
    return {rid: list(map(int, r.tokens)) for rid, r in results.items()
            if not isinstance(r, Exception) and r.status == "done"}


def _assert_exact_accounting(fe, reg, n, quarantined=0, timeout=0):
    st = fe.engine.stats
    assert st.n_completed + st.n_timeout + st.n_quarantined == n
    assert st.n_quarantined == quarantined
    assert st.n_timeout == timeout
    assert reg.counter("serving_submitted_total").value == n
    assert reg.counter("serving_completed_total").value == st.n_completed
    assert len(fe.engine.requests) == 0
    assert len(fe._handles) == 0


def _flat_tensors(obj):
    """The tensors in a nest of lists, tuples and dicts."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _flat_tensors(o)]
    return []


def _fired(site):
    return obs_metrics.registry.counter("serving_faults_injected_total",
                                        site=site).value


# -- the fault plan itself ---------------------------------------------


class TestFaultPlan:
    def test_spec_validation(self):
        with pytest.raises(ValueError):
            faults.FaultSpec(site="nope")
        with pytest.raises(ValueError):
            faults.FaultSpec(site="decode_round", action="explode")
        with pytest.raises(ValueError):
            faults.FaultSpec(site="decode_round", max_fires=0)
        with pytest.raises(ValueError):
            faults.FaultSpec(site="decode_round", round_every=0)

    def test_deterministic_matching_and_max_fires(self):
        plan = faults.FaultPlan()
        plan.add(site="decode_round", round=3, max_fires=1)
        plan.check("decode_round", round_idx=2)
        plan.check("prefill_chunk", round_idx=3)
        with pytest.raises(faults.FaultInjected):
            plan.check("decode_round", round_idx=3)
        plan.check("decode_round", round_idx=3)  # consumed
        assert plan.total_fires() == 1

    def test_round_every_and_request_predicates(self):
        plan = faults.FaultPlan()
        plan.add(site="prefill_chunk", round_every=2, request_id=5,
                 max_fires=10)
        plan.check("prefill_chunk", round_idx=1, request_id=5)
        plan.check("prefill_chunk", round_idx=2, request_id=4)
        with pytest.raises(faults.FaultInjected):
            plan.check("prefill_chunk", round_idx=2, request_id=5)

    def test_delay_and_corrupt_actions(self):
        plan = faults.FaultPlan()
        plan.add(site="decode_round", action="delay", round=0,
                 delay_s=0.01)
        t0 = time.perf_counter()
        plan.check("decode_round", round_idx=0)
        assert time.perf_counter() - t0 >= 0.009
        plan.add(site="decode_round", action="corrupt", round=1)
        arr = np.arange(4, dtype=np.int32) + 1
        out = plan.corrupt("decode_round", arr, round_idx=1)
        assert out[0] == -1 and arr[0] == 1  # a scribbled copy
        assert plan.corrupt("decode_round", arr, round_idx=1) is arr

    def test_json_roundtrip_and_env_install(self):
        # install_from_env reads the mapping it is given: the test never
        # writes MARLIN_FAULT_PLAN into this process's environment.
        assert faults.ENV_VAR == jfaults.ENV_VAR == "MARLIN_FAULT_PLAN"
        plan = faults.FaultPlan()
        plan.add(site="decode_round", round=4)
        plan.check("decode_round", round_idx=3)
        plan2 = faults.FaultPlan.from_json(plan.to_json())
        assert plan2.specs[0].site == "decode_round"
        assert plan2.specs[0].round == 4
        assert plan2.specs[0].fires == 0
        installed = faults.install_from_env(
            {faults.ENV_VAR: plan.to_json()})
        assert faults.active() is installed
        bare = faults.FaultPlan.from_json(
            '[{"site": "decode_round", "round": 4}]')
        assert bare.specs[0].round == 4
        faults.reset()
        assert faults.install_from_env({}) is None
        assert faults.active() is None
        assert faults.ENV_VAR not in os.environ

    def test_plan_json_is_the_reference_json(self):
        # One plan text arms either framework the same way.
        plan = faults.FaultPlan()
        plan.add(site="kv_restore", request_id=3, max_fires=2)
        plan.add(site="decode_round", action="corrupt", round_every=4)
        jplan = jfaults.FaultPlan.from_json(plan.to_json())
        assert jplan.summary() == plan.summary()
        back = faults.FaultPlan.from_json(jplan.to_json())
        assert back.summary() == plan.summary()

    def test_no_plan_fast_path(self):
        faults.reset()
        faults.check("decode_round", round_idx=0)
        arr = np.ones(2)
        assert faults.corrupt("decode_round", arr) is arr


# -- bitwise recovery ----------------------------------------------------


class TestBitExactRecovery:
    @pytest.mark.parametrize("temperature", [0.0, 0.7],
                             ids=["greedy", "sampled"])
    def test_decode_round_crash_recovers_bitexact(self, model, frontends,
                                                  temperature):
        params, cfg, jparams, jcfg = model
        prompts = _prompts(cfg, 6)
        gold = _golden(params, cfg, prompts, 6, batch=2, round_steps=2,
                       temperature=temperature)
        fired0 = _fired("decode_round")
        specs = [dict(site="decode_round", round=2)]
        fe, reg, streamed, results = _chaos(
            frontends, params, cfg, specs, prompts, 6,
            temperature=temperature)
        assert fe.restarts == 1
        assert all(r.status == "done" for r in results.values())
        assert _tokens(results) == gold
        for rid, toks in streamed.items():
            assert toks == gold[rid], rid
        _assert_exact_accounting(fe, reg, 6)
        assert reg.counter("serving_engine_restarts_total").value == 1
        assert reg.counter("serving_requests_recovered_total").value >= 1
        assert _fired("decode_round") == fired0 + 1
        kinds = [e["kind"] for e in fe.engine.runlog.events()]
        assert "engine_crash" in kinds and "recover" in kinds
        rec = [r for r in results.values() if r.crash_count]
        assert rec
        for r in rec:
            ph = r.phases()
            assert ph["recovery"] > 0
            assert ph["queue_wait"] + ph["admit"] + ph["decode"] \
                == pytest.approx(ph["total"], rel=1e-9, abs=1e-12)
        assert fe.drain(JOIN_S)
        ref = _jax_chaos(frontends, jparams, jcfg, specs, prompts, 6,
                         temperature=temperature)
        if temperature:
            # The frameworks' samplers differ; the schedule does not.
            assert _facts(fe, results) == _facts(*ref)
        else:
            _against_reference(model, prompts, (fe, results), ref)

    @pytest.mark.parametrize("site,specs,eng_kw", [
        # admission_pop runs only while a row is free: round 3's pop is
        # the first one with rows mid-decode.
        ("admission_pop", [dict(site="admission_pop", round=3)], {}),
        ("runlog_emit", [dict(site="runlog_emit", round=2)], {}),
        ("stream_fanout", [dict(site="stream_fanout", round=2)], {}),
        ("prefill_oneshot", [dict(site="prefill_chunk", request_id=3)], {}),
        ("prefill_chunked", [dict(site="prefill_chunk", request_id=3)],
         {"prefill_chunk": 32}),
    ])
    def test_every_site_recovers_bitexact(self, model, frontends, site,
                                          specs, eng_kw):
        params, cfg, jparams, jcfg = model
        prompts = _prompts(cfg, 6)
        gold = _golden(params, cfg, prompts, 6, batch=2, round_steps=2,
                       **eng_kw)
        fe, reg, streamed, results = _chaos(frontends, params, cfg, specs,
                                            prompts, 6, **eng_kw)
        assert fe.restarts == 1, site
        assert all(r.status == "done" for r in results.values())
        assert _tokens(results) == gold
        for rid, toks in streamed.items():
            assert toks == gold[rid], (site, rid)
        _assert_exact_accounting(fe, reg, 6)
        assert fe.drain(JOIN_S)
        _against_reference(model, prompts, (fe, results), _jax_chaos(
            frontends, jparams, jcfg, specs, prompts, 6, **eng_kw))

    def test_prefix_copy_crash_recovers_bitexact(self, model, frontends):
        # The successor gets a fresh pool: the cache is a performance
        # layer, never a correctness one.
        params, cfg, jparams, jcfg = model
        prompts = _shared_prompts(cfg)
        kw = dict(batch=2, round_steps=2, prefill_chunk=16)
        gold = _golden(params, cfg, prompts, 4, **kw)
        specs = [dict(site="prefix_copy", request_id=2)]
        cache = PrefixCache(cfg, pool_rows=4, device="cpu")
        fe, reg, _, results = _chaos(frontends, params, cfg, specs, prompts,
                                     4, stream_mod=0, prefix_cache=cache,
                                     **kw)
        assert fe.restarts == 1
        assert _tokens(results) == gold
        _assert_exact_accounting(fe, reg, 5)
        assert fe.engine.prefix_cache is not cache
        assert fe.engine.prefix_cache.pool_rows == 4
        assert fe.drain(JOIN_S)
        _against_reference(model, prompts, (fe, results), _jax_chaos(
            frontends, jparams, jcfg, specs, prompts, 4, prefix_cache=True,
            **kw))

    def test_paged_alias_crash_discards_torn_refcounts(self, model,
                                                       frontends):
        params, cfg, jparams, jcfg = model
        prompts = _shared_prompts(cfg)
        kw = dict(batch=2, round_steps=2, kv_pages=12)
        gold = _golden(params, cfg, prompts, 4, **kw)
        specs = [dict(site="prefix_copy", request_id=2)]
        plan = faults.install(faults.FaultPlan())
        plan.add(**specs[0])
        reg = MetricsRegistry()
        eng = ServingEngine(params, cfg, metrics_registry=reg, device="cpu",
                            **kw)
        crashed_pool = eng.page_pool
        fe, _, results = _drive(frontends, EngineFrontend, eng, prompts, 4)
        faults.reset()
        assert plan.total_fires() == 1
        assert fe.restarts == 1
        assert _tokens(results) == gold
        _assert_exact_accounting(fe, reg, 5)
        st = fe.engine.stats
        assert st.n_prefix_hits + st.n_prefix_misses == st.n_admitted
        pool = fe.engine.page_pool
        assert pool is not crashed_pool
        stored = sum(e.length // 16
                     for e in fe.engine.prefix_index._entries.values())
        assert pool.n_used == stored  # no pin of the dead incarnation
        assert fe.drain(JOIN_S)
        _against_reference(model, prompts, (fe, results), _jax_chaos(
            frontends, jparams, jcfg, specs, prompts, 4, **kw))

    def test_corrupted_fetch_is_detected_and_recovered(self, model,
                                                       frontends):
        params, cfg, jparams, jcfg = model
        prompts = _prompts(cfg, 4)
        gold = _golden(params, cfg, prompts, 6, batch=2, round_steps=2)
        specs = [dict(site="decode_round", action="corrupt", round=2)]
        fe, reg, _, results = _chaos(frontends, params, cfg, specs, prompts,
                                     6, stream_mod=0)
        assert fe.restarts == 1
        assert _tokens(results) == gold
        crash = fe.engine.runlog.events("engine_crash")[0]
        assert crash["error_type"] == "EngineStateCorrupt"
        _assert_exact_accounting(fe, reg, 4)
        assert fe.drain(JOIN_S)
        _against_reference(model, prompts, (fe, results), _jax_chaos(
            frontends, jparams, jcfg, specs, prompts, 6))

    def test_kv_restore_crash_rebuilds_tier_and_readopts(self, model,
                                                         frontends,
                                                         tmp_path):
        # The first restore crashes; the successor's fresh tier adopts the
        # dead incarnation's spill from the dir and restores it.
        params, cfg, _, _ = model
        rng = np.random.default_rng(5)
        shared = rng.integers(0, cfg.vocab, 32).astype(np.int32)

        def prompt(i):
            if i in (0, 3):  # the shared-prefix pair
                return np.concatenate([shared, rng.integers(
                    0, cfg.vocab, 8).astype(np.int32)])
            return np.random.default_rng(50 + i).integers(
                0, cfg.vocab, 40).astype(np.int32)

        prompts = [prompt(i) for i in range(4)]
        kw = dict(batch=2, round_steps=2, prefill_chunk=16)
        gold = _golden(params, cfg, prompts, 4, kv_pages=7, **kw)
        plan = faults.install(faults.FaultPlan())
        plan.add(site="kv_restore")
        reg = MetricsRegistry()
        eng = ServingEngine(params, cfg, metrics_registry=reg, kv_pages=7,
                            host_kv_bytes=1 << 22, host_kv_dir=str(tmp_path),
                            restore_min_tokens=16, device="cpu", **kw)
        crashed_pool, crashed_tier = eng.page_pool, eng.host_tier
        fe = frontends(EngineFrontend, eng).start()
        # Phased: request 0 stores the prefix, the churn pair spills it,
        # request 3's admission restores it, where the fault fires.
        results = {}
        for wave in ([0], [1, 2], [3]):
            handles = [fe.submit(prompts[i], 4) for i in wave]
            for h in handles:
                results[h.request_id] = h.result(JOIN_S)
        faults.reset()
        assert plan.total_fires() == 1
        assert fe.restarts == 1
        assert _tokens(results) == gold
        _assert_exact_accounting(fe, reg, 4)
        succ = fe.engine
        assert succ.page_pool is not crashed_pool
        assert succ.host_tier is not crashed_tier
        assert succ.host_tier.summary()["spill_dir"] == str(tmp_path)
        stored = sum(len(e.pages)
                     for e in succ.prefix_index._entries.values())
        assert succ.page_pool.n_used == stored
        assert succ.prefix_index.adoptions >= 1
        assert succ.host_tier.summary()["restores"] >= 1
        assert any(f.endswith(".npz") for f in os.listdir(tmp_path))
        restores = fe.engine.runlog.events("restore")
        assert restores and all(e["bytes"] > 0 for e in restores)
        assert fe.drain(JOIN_S)


# -- quarantine and failing closed ----------------------------------------


class TestQuarantineAndFailClosed:
    def test_poison_request_quarantined_after_two_crashes(self, model,
                                                          frontends):
        params, cfg, jparams, jcfg = model
        prompts = _prompts(cfg, 4)
        gold = _golden(params, cfg, prompts, 6, batch=2, round_steps=2)
        specs = [dict(site="prefill_chunk", request_id=1, max_fires=2)]
        fe, reg, _, out = _chaos(frontends, params, cfg, specs, prompts, 6,
                                 stream_mod=0)
        poisoned = out[1]
        assert isinstance(poisoned, PoisonedRequest)
        assert poisoned.request_id == 1 and poisoned.crash_count == 2
        for rid in (0, 2, 3):
            assert out[rid].status == "done"
            assert list(map(int, out[rid].tokens)) == gold[rid]
            assert out[rid].crash_count == 0, rid  # blame was request 1's
        assert fe.restarts == 2
        assert fe.ready
        st = fe.engine.stats
        assert st.n_quarantined == 1
        (qrec,) = st.quarantine_snapshot()
        assert qrec["request_id"] == 1 and qrec["crash_count"] == 2
        assert st.summary()["quarantine"] == [qrec]
        assert reg.counter(
            "serving_requests_quarantined_total").value == 1
        _assert_exact_accounting(fe, reg, 4, quarantined=1)
        assert [e["request_id"]
                for e in fe.engine.runlog.events("quarantine")] == [1]
        assert fe.drain(JOIN_S)
        _against_reference(model, prompts, (fe, out), _jax_chaos(
            frontends, jparams, jcfg, specs, prompts, 6))

    def test_unrelated_crashes_far_apart_do_not_poison(self, model,
                                                       frontends):
        # An implication older than restart_window_s is stale: the
        # post-crash delays (5 x 0.08 s) put more than the window between
        # the two crashes.
        params, cfg, _, _ = model
        specs = [dict(site="decode_round", round=2),
                 dict(site="decode_round", action="delay", round_every=1,
                      max_fires=7, delay_s=0.08),
                 dict(site="decode_round", round=8)]
        fe, reg, _, out = _chaos(frontends, params, cfg, specs,
                                 _prompts(cfg, 2), 24, stream_mod=0,
                                 fe_kw=dict(restart_window_s=0.2))
        assert fe.restarts == 2
        assert all(r.status == "done" for r in out.values())
        assert all(r.crash_count <= 1 for r in out.values())
        assert fe.engine.stats.n_quarantined == 0
        _assert_exact_accounting(fe, reg, 2)
        assert fe.drain(JOIN_S)

    @pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning")
    @pytest.mark.parametrize("broken", ["spawn_successor", "_sync_device"])
    def test_recovery_failure_fails_closed_not_silent(self, model,
                                                      frontends, broken):
        # A successor that cannot be built, or a device that cannot
        # synchronize (how a sticky CUDA error shows), fails every handle
        # with EngineFailed and never loops.
        params, cfg, _, _ = model
        plan = faults.install(faults.FaultPlan())
        plan.add(site="decode_round", round=1)
        eng = ServingEngine(params, cfg, batch=2, round_steps=2,
                            metrics_registry=MetricsRegistry(), device="cpu")

        def refuse():
            raise RuntimeError("CUDA error: an illegal memory access")

        setattr(eng, broken, refuse)
        fe = frontends(EngineFrontend, eng)
        handles = [fe.submit(p, 6) for p in _prompts(cfg, 2)]
        fe.start()
        for h in handles:
            with pytest.raises(EngineFailed, match="recovery failed"):
                h.result(JOIN_S)
        faults.reset()
        fe._thread.join(JOIN_S)
        assert not fe.alive and not fe.ready
        assert fe.restarts == 0 and fe.engine is eng
        assert len(fe._handles) == 0
        with pytest.raises(EngineFailed):
            fe.submit(_prompts(cfg, 1)[0], 2)

    @pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_restart_cap_fails_closed(self, model, frontends):
        params, cfg, jparams, jcfg = model
        prompts = _prompts(cfg, 4)
        specs = [dict(site="decode_round", round_every=1, max_fires=50)]
        plan = faults.install(faults.FaultPlan())
        plan.add(**specs[0])
        reg = MetricsRegistry()
        eng = ServingEngine(params, cfg, batch=2, round_steps=2,
                            metrics_registry=reg, device="cpu")
        fe = frontends(EngineFrontend, eng, max_restarts=2, poison_after=10)
        handles = [fe.submit(p, 6) for p in prompts]
        fe.start()
        for h in handles:
            with pytest.raises(EngineFailed):
                h.result(JOIN_S)
        faults.reset()
        fe._thread.join(JOIN_S)
        assert not fe.alive and not fe.ready
        with pytest.raises(EngineFailed):
            fe.submit(prompts[0], 2)
        assert fe.restarts == 2
        assert reg.counter("serving_engine_restarts_total").value == 2
        assert "engine_failed" in [e["kind"]
                                   for e in fe.engine.runlog.events()]
        assert len(fe._handles) == 0
        # The reference fails closed after as many restarts.
        jplan = jfaults.install(jfaults.FaultPlan())
        jplan.add(**specs[0])
        jeng = JaxEngine(jparams, jcfg, batch=2, round_steps=2,
                         metrics_registry=JaxRegistry())
        jfe = frontends(JaxFrontend, jeng, max_restarts=2, poison_after=10)
        jhandles = [jfe.submit(p, 6) for p in prompts]
        jfe.start()
        for h in jhandles:
            with pytest.raises(Exception, match="failing closed"):
                h.result(JOIN_S)
        jfaults.reset()
        jfe._thread.join(JOIN_S)
        assert jfe.restarts == fe.restarts

    @pytest.mark.parametrize("layout,crash", [
        ("paged", "plan"), ("prefix_cache", "plan"), ("paged", "frame")])
    def test_crashed_engine_releases_its_state(self, model, frontends,
                                               layout, crash):
        # The crashed engine's cache, pool and token buffer are gone (no
        # reference left, the crash's frames included) by the time its
        # successor allocates its own: one incarnation's cache at a time.
        params, cfg, _, _ = model
        if crash == "plan":
            plan = faults.install(faults.FaultPlan())
            plan.add(site="decode_round", round=1)
        kw = (dict(kv_pages=24) if layout == "paged" else
              dict(prefill_chunk=16, prefix_cache=PrefixCache(
                  cfg, pool_rows=4, device="cpu")))
        eng = ServingEngine(params, cfg, batch=2, round_steps=2,
                            metrics_registry=MetricsRegistry(), device="cpu",
                            **kw)
        held = [eng._buf, eng._cache,
                eng.page_pool.pages if eng.page_pool else None,
                eng.prefix_cache.pool if eng.prefix_cache else None]
        refs = [weakref.ref(t) for t in _flat_tensors(held)]
        del held
        alive_at_spawn = []

        def spawn():
            alive_at_spawn.append(sum(r() is not None for r in refs))
            return ServingEngine.spawn_successor(eng)

        eng.spawn_successor = spawn
        if crash == "frame":
            def step():
                pages = eng.page_pool.pages  # the crash's frame holds it
                raise RuntimeError(f"crashed over {len(pages)} layers")

            eng.step = step
        fe, _, out = _drive(frontends, EngineFrontend, eng,
                            _prompts(cfg, 3), 6)
        faults.reset()
        assert len(refs) > 2 and alive_at_spawn == [0]
        assert fe.restarts == 1 and fe.engine is not eng
        assert eng._buf is None and eng._run_params is None
        assert eng.page_pool is None and eng.prefix_index is None
        assert fe.engine.stats is eng.stats
        assert all(r.status == "done" for r in out.values())
        assert fe.drain(JOIN_S)


# -- deadlines across recovery --------------------------------------------


class TestDeadlinesAcrossRecovery:
    def test_requeued_keeps_deadline_and_expiry_is_timeout(self, model,
                                                           frontends):
        params, cfg, jparams, jcfg = model
        prompts = _prompts(cfg, 3)
        steps = [12, 4, 4]
        deadlines = [None, 30.0, 0.001]
        plan = faults.install(faults.FaultPlan())
        plan.add(site="decode_round", round=1)
        reg = MetricsRegistry()
        eng = ServingEngine(params, cfg, batch=1, round_steps=2,
                            metrics_registry=reg, device="cpu")
        fe = frontends(EngineFrontend, eng)
        hs = [fe.submit(p, s, deadline_s=d)
              for p, s, d in zip(prompts, steps, deadlines)]
        req1 = fe.engine.requests[hs[1].request_id]
        req2 = fe.engine.requests[hs[2].request_id]
        d1, d2 = req1.deadline_time, req2.deadline_time
        fe.start()
        r0, r1, r2 = (h.result(JOIN_S) for h in hs)
        faults.reset()
        assert fe.restarts == 1
        assert r0.status == "done" and r1.status == "done"
        assert r1 is req1 and r1.deadline_time == d1
        assert r1.requeues == 1
        assert r2.status == "timeout"  # an expiry, not a retry
        assert r2 is req2 and r2.deadline_time == d2
        assert r2.admit_round == -1
        _assert_exact_accounting(fe, reg, 3, timeout=1)
        assert fe.drain(JOIN_S)
        jplan = jfaults.install(jfaults.FaultPlan())
        jplan.add(site="decode_round", round=1)
        jeng = JaxEngine(jparams, jcfg, batch=1, round_steps=2,
                         metrics_registry=JaxRegistry())
        jfe = frontends(JaxFrontend, jeng)
        jhs = [jfe.submit(p, s, deadline_s=d)
               for p, s, d in zip(prompts, steps, deadlines)]
        jfe.start()
        jres = {h.request_id: h.result(JOIN_S) for h in jhs}
        jfaults.reset()
        _against_reference(model, prompts, (fe, {0: r0, 1: r1, 2: r2}),
                           (jfe, jres))
        assert jfe.drain(JOIN_S)

    def test_arrivals_after_a_crash_queue_behind_the_recovered(
            self, model, frontends):
        # The batch class has neither SLO nor deadline, so its heap key is
        # (inf, arrival sequence): requeued requests keep theirs, and the
        # successor's arrivals, submitted from the hook after its first
        # round, must draw larger ones (a tie would compare two Requests)
        # and so run after every recovered request.
        params, cfg, _, _ = model
        prompts = _prompts(cfg, 6)
        gold = _golden(params, cfg, prompts, 4, batch=1, round_steps=2)
        eng = ServingEngine(params, cfg, batch=1, round_steps=2,
                            scheduler=Scheduler(),
                            metrics_registry=MetricsRegistry(), device="cpu")
        late, rounds = [], []

        def on_round(e, round_idx, finished):
            rounds.append((e, round_idx))
            if fe.restarts == 1 and not late:
                late.extend(fe.submit(p, 4, sched_class="batch")
                            for p in prompts[3:])

        fe = frontends(EngineFrontend, eng, on_round=on_round)
        early = [fe.submit(p, 4, sched_class="batch") for p in prompts[:3]]
        plan = faults.install(faults.FaultPlan())
        crash = plan.add(site="decode_round", round=1)
        fe.start()
        done = {h.request_id: h.result(JOIN_S) for h in early}
        assert len(late) == 3
        done.update((h.request_id, h.result(JOIN_S)) for h in late)
        faults.reset()
        assert crash.fires == 1 and fe.restarts == 1
        assert _tokens(done) == gold
        recovered = [done[h.request_id] for h in early]
        arrivals = [done[h.request_id] for h in late]
        assert all(r.requeues == 1 for r in recovered)
        assert all(r.requeues == 0 for r in arrivals)
        assert max(r.sched_seq for r in recovered) \
            < min(r.sched_seq for r in arrivals)
        assert max(r.admit_round for r in recovered) \
            < min(r.admit_round for r in arrivals)
        # The hook saw each round once, the successor's from one past the
        # crashed round.
        idx = [i for _, i in rounds]
        assert idx == sorted(set(idx)) and rounds[-1][0] is fe.engine
        assert fe.drain(JOIN_S)


# -- restarts across the disciplines ---------------------------------------


def _spec_workload(cfg):
    """Patterned prompts (drafts land), random ones (drafts miss), ragged
    steps: tests/test_serving_spec.py's workload."""
    rng = np.random.default_rng(13)
    prompts = [
        np.tile(np.array([5, 9, 17, 3], np.int32), 6)[:20],
        np.tile(np.array([7, 2, 11], np.int32), 8)[:18],
        rng.integers(0, cfg.vocab, 8).astype(np.int32),
        np.tile(np.array([4, 4, 9], np.int32), 10)[:24],
        rng.integers(0, cfg.vocab, 13).astype(np.int32),
    ]
    return prompts, [30, 25, 20, 28, 9]


def _sched_prompts(cfg):
    rng = np.random.default_rng(3)
    return [rng.integers(1, cfg.vocab, 9).astype(np.int32) for _ in range(3)]


class TestRestartAcrossDisciplines:
    def test_successor_rebuilds_fresh_tier_with_knobs_carried(
            self, model, tmp_path):
        # tests/test_host_kv.py's twin: a fresh tier (the dead one's host
        # memory discarded), knobs carried, the dir's payloads adopted.
        params, cfg, _, _ = model
        eng = ServingEngine(params, cfg, batch=2, kv_pages=7,
                            prefill_chunk=16, host_kv_bytes=1 << 22,
                            host_kv_dir=str(tmp_path), restore_min_tokens=16,
                            metrics_registry=MetricsRegistry(), device="cpu")
        rng = np.random.default_rng(5)
        prefix = rng.integers(1, cfg.vocab, 32).astype(np.int32)
        eng.submit(np.concatenate([prefix, np.full(8, 3, np.int32)]), 4)
        eng.run()
        for i in range(2):
            eng.submit(np.random.default_rng(100 + i).integers(
                1, cfg.vocab, 40).astype(np.int32), 4)
        eng.run()
        assert eng.host_tier.summary()["spills"] >= 1
        succ = eng.spawn_successor()
        s = succ.host_tier.summary()
        assert s["host_entries"] == 0 and s["host_bytes"] == 0
        assert s["spill_dir"] == str(tmp_path)
        assert succ.restore_min_tokens == eng.restore_min_tokens
        assert succ.host_kv_bytes == eng.host_kv_bytes
        assert succ.stats is eng.stats
        assert succ.round_idx == eng.round_idx + 1
        assert succ._next_id == eng._next_id
        succ.submit(np.concatenate([prefix, np.full(4, 9, np.int32)]), 4)
        succ.run()
        assert succ.prefix_index.adoptions >= 1
        succ.drain()
        eng.drain()

    def test_spec_crash_midstream_recovers_bitexact(self, model,
                                                    frontends):
        # tests/test_serving_spec.py's twin: greedy, so the draft-length
        # sequence, which a restart changes, does not move a token.
        params, cfg, _, _ = model
        prompts, steps = _spec_workload(cfg)
        kw = dict(batch=2, round_steps=4, spec_draft_lens=(2, 4, 6))
        gold = _golden(params, cfg, prompts, steps, **kw)
        fe, reg, _, results = _chaos(
            frontends, params, cfg, [dict(site="decode_round", round=2)],
            prompts, steps, stream_mod=0, **kw)
        assert fe.restarts == 1
        assert fe.engine.spec and fe.engine.spec_draft_lens == (2, 4, 6)
        assert _tokens(results) == gold
        for r in results.values():
            assert r.emitted == 1 + r.live_iters + r.spec_accepted
        assert fe.engine.stats.n_completed == len(prompts)
        assert reg.counter("serving_engine_restarts_total").value == 1
        assert fe.drain(JOIN_S)

    @pytest.mark.parametrize("site", ["preempt_spill", "kv_restore"])
    def test_crash_in_preemption_replays_bitexact(self, model, frontends,
                                                  site):
        # tests/test_sched.py's twin, and the thaw's restore: two batch
        # jobs fill the rows, three rounds pass, an interactive request
        # arrives; the freeze (or, later, the thaw) crashes, and the
        # successor replays from scratch with fresh heaps.
        params, cfg, _, _ = model
        prompts = _sched_prompts(cfg)
        steps = [40, 40, 6]
        gold = _golden(params, cfg, prompts, steps, batch=2, round_steps=4,
                       seed=7, kv_pages=24)
        eng = ServingEngine(params, cfg, batch=2, round_steps=4, seed=7,
                            kv_pages=24, host_kv_bytes=1 << 24,
                            scheduler=Scheduler(),
                            metrics_registry=MetricsRegistry(), device="cpu")
        fe = frontends(EngineFrontend, eng)
        hs = [fe.submit(prompts[i], steps[i], request_id=i,
                        sched_class="batch") for i in (0, 1)]
        for _ in range(3):
            assert eng.step() == []
        hs.append(fe.submit(prompts[2], steps[2], request_id=2,
                            sched_class="interactive"))
        plan = faults.install(faults.FaultPlan())
        crash = plan.add(site=site)
        fe.start()
        toks = {h.request_id: list(map(int, h.result(JOIN_S).tokens))
                for h in hs}
        faults.reset()
        assert crash.fires == 1 and fe.restarts == 1
        assert toks == gold
        # The freeze crashed before it counted; the thaw after one.
        assert (eng.stats.n_preempted >= 1) == (site == "kv_restore")
        assert fe.engine.scheduler is not eng.scheduler
        (ev,) = fe.engine.runlog.events("engine_crash")
        assert ev["blamed_request_id"] in (0, 1)  # the victim alone
        assert fe.drain(JOIN_S)
        assert fe.engine.host_tier.summary()["host_rows"] == 0

    @pytest.mark.parametrize("mode,specs,eng_kw", [
        ("oneshot", [dict(site="decode_round", round=2)], {}),
        ("oneshot_prefill", [dict(site="prefill_chunk", request_id=3)], {}),
        ("paged", [dict(site="decode_round", action="corrupt", round=3)],
         {"kv_pages": 16, "prefill_chunk": 16}),
    ])
    def test_tp2_crash_replays_tp1_tokens(self, model, frontends, mode,
                                          specs, eng_kw):
        # Two CPU shards: the successor re-derives its sharded run params
        # and replays to TP = 1's tokens, bitwise.
        params, cfg, _, _ = model
        prompts = _prompts(cfg, 6)
        gold = _golden(params, cfg, prompts, 6, batch=2, round_steps=2,
                       temperature=0.7, **eng_kw)
        fe, reg, streamed, results = _chaos(
            frontends, params, cfg._replace(tp=2), specs, prompts, 6,
            temperature=0.7, **eng_kw)
        assert fe.restarts == 1, mode
        assert fe.engine.tp == 2
        assert _tokens(results) == gold
        for rid, toks in streamed.items():
            assert toks == gold[rid], (mode, rid)
        _assert_exact_accounting(fe, reg, 6)
        assert fe.drain(JOIN_S)
