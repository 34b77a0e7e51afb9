"""Speculative serving rounds in the port
(``ServingEngine(spec_draft_lens=...)``), twin of tests/test_serving_spec.py.

* Exactness: greedy outputs are bitwise the non-speculative engine's and a
  B=1 ``generate``'s, contiguous and paged, with eos, and with the int8
  stack. Paged admission is chunked (plain cached attention) where the
  contiguous default is the one-shot flash prefill, so the paged arms are
  also held to a chunked contiguous engine, bit for bit.
* Sampled invariance: at ``spec_adaptive=False`` a sampled request's
  tokens are a function of (prompt, steps, seed, request id) alone.
* The ledger: ``emitted == 1 + live_iters + spec_accepted`` a request.
* The guards: the submit extent check with the draft overhang, the ngram
  floor, the knob validation, the paged reservation.
* The cost model's ``spec_round_cost`` and ``pick_draft_len`` equal the
  JAX package's; the port's engine against the JAX engine by the near-tie
  margin rule.

The reference's compile-budget, crash-recovery and SLO-gate tests wait for
CUDA-graph capture, the supervised restart surface and the port's
benchmark (ROADMAP).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marlin_tpu.models import transformer as jt
from marlin_tpu.serving import ServingEngine as JaxEngine
from marlin_tpu.utils import cost_model as jcm
from marlin_tpu_torch.models import convert
from marlin_tpu_torch.models import transformer as pt
from marlin_tpu_torch.models.quant import quantize_params_int8
from marlin_tpu_torch.obs.metrics import MetricsRegistry
from marlin_tpu_torch.obs.runlog import RunLog
from marlin_tpu_torch.serving import PrefixCache, ServingEngine
from marlin_tpu_torch.utils import cost_model as pcm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BASE = dict(vocab=48, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=96)


def _cfg(**kw):
    return pt.TransformerConfig(**{**BASE, **kw})


def _workload(cfg):
    """Patterned prompts (drafts land), random ones (drafts miss), ragged
    steps."""
    rng = np.random.default_rng(13)
    prompts = [
        np.tile(np.array([5, 9, 17, 3]), 6)[:20],
        np.tile(np.array([7, 2, 11]), 8)[:18],
        rng.integers(0, cfg.vocab, 8),
        np.tile(np.array([4, 4, 9]), 10)[:24],
        rng.integers(0, cfg.vocab, 13),
    ]
    return prompts, [30, 25, 20, 28, 9]


def _drain(params, cfg, spec, paged=False, order=None, **kw):
    """Run the workload to completion; returns (engine, tokens by workload
    index, Request by workload index)."""
    prompts, steps = _workload(cfg)
    eng = ServingEngine(
        params, cfg, batch=kw.pop("batch", 2),
        round_steps=kw.pop("round_steps", 4), seed=3,
        kv_pages=(cfg.max_len // 16 * 4) if paged else None,
        spec_draft_lens=kw.pop("lens", (2, 4, 6)) if spec else None,
        device="cpu", **kw)
    idx = list(order) if order is not None else list(range(len(prompts)))
    rid = {i: eng.submit(prompts[i], steps[i]) for i in idx}
    eng.close()
    by_id = {r.request_id: r for r in eng.run()}
    reqs = [by_id[rid[i]] for i in range(len(prompts))]
    return eng, [r.tokens for r in reqs], reqs


def _equal(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"request {i}")


class TestSpecExactness:
    @pytest.mark.parametrize("cfg_kw", [
        {}, {"rope": True, "n_kv_heads": 1}, {"kv_quant": "int8"},
    ], ids=["plain", "rope_mqa", "int8_kv"])
    def test_greedy_bitexact_vs_nonspec_and_generate(self, cfg_kw):
        cfg = _cfg(**cfg_kw)
        params = pt.init_params(cfg, seed=0, device="cpu")
        _, base, _ = _drain(params, cfg, spec=False)
        _, spec, reqs = _drain(params, cfg, spec=True)
        _equal(base, spec)
        prompts, steps = _workload(cfg)
        _equal(spec, [pt.generate(params, torch.as_tensor(p[None]), s,
                                  cfg).numpy()[0]
                      for p, s in zip(prompts, steps)])
        assert sum(r.spec_accepted for r in reqs) > 0  # drafts landed

    def test_greedy_bitexact_paged(self):
        # Paged spec == paged non-spec == contiguous spec == chunked
        # contiguous spec.
        cfg = _cfg()
        params = pt.init_params(cfg, seed=0, device="cpu")
        _, base, _ = _drain(params, cfg, spec=False, paged=True)
        _, spec, reqs = _drain(params, cfg, spec=True, paged=True)
        _, cont, _ = _drain(params, cfg, spec=True)
        _, chunked, _ = _drain(params, cfg, spec=True, prefill_chunk=16)
        _equal(base, spec)
        _equal(spec, cont)
        _equal(spec, chunked)
        assert sum(r.spec_accepted for r in reqs) > 0

    def test_int8_stack_paged_equals_chunked(self):
        # int8 weights and cache. One-shot admission attends the float
        # prompt K/V (the flash prefill, as generate's); the chunked and
        # paged admissions attend the quantized cache. So the paged arms
        # are bitwise the chunked contiguous engine, and the one-shot
        # ones B=1 generate.
        cfg = _cfg(kv_quant="int8", dtype="bfloat16")
        q = quantize_params_int8(pt.init_params(cfg, seed=1, device="cpu"))
        _, oneshot, _ = _drain(q, cfg, spec=False)
        _, oneshot_spec, _ = _drain(q, cfg, spec=True)
        _equal(oneshot, oneshot_spec)
        prompts, steps = _workload(cfg)
        _equal(oneshot, [pt.generate(q, torch.as_tensor(p[None]), s,
                                     cfg).numpy()[0]
                         for p, s in zip(prompts, steps)])
        _, chunked, _ = _drain(q, cfg, spec=False, prefill_chunk=16)
        _, paged, _ = _drain(q, cfg, spec=False, paged=True)
        _, paged_spec, _ = _drain(q, cfg, spec=True, paged=True)
        _equal(chunked, paged)
        _equal(paged, paged_spec)

    def test_eos_freeze_is_exact_under_speculation(self):
        cfg = _cfg()
        params = pt.init_params(cfg, seed=5, device="cpu")
        prompts, steps = _workload(cfg)
        free = pt.generate(params, torch.as_tensor(prompts[0][None]),
                           steps[0], cfg).numpy()[0]
        eos = int(free[steps[0] // 2])
        _, base, _ = _drain(params, cfg, spec=False, eos_id=eos)
        _, spec, reqs = _drain(params, cfg, spec=True, eos_id=eos)
        _, paged, _ = _drain(params, cfg, spec=True, paged=True, eos_id=eos)
        _equal(base, spec)
        _equal(spec, paged)
        refs = [pt.generate(params, torch.as_tensor(p[None]), s, cfg,
                            eos_id=eos).numpy()[0]
                for p, s in zip(prompts, steps)]
        _equal(spec, refs)
        assert any((r == eos).any() for r in refs)
        assert any(r.emitted < s for r, s in zip(reqs, steps))
        assert all(r.emitted == 1 + r.live_iters + r.spec_accepted
                   for r in reqs)

    def test_chunked_admission_with_spec(self):
        # Chunked admission and the prefix cache ride speculative rounds
        # (the reference allows both): tokens equal the non-spec chunked
        # engine's, and the cache hits.
        cfg = _cfg()
        params = pt.init_params(cfg, seed=2, device="cpu")
        _, base, _ = _drain(params, cfg, spec=False, prefill_chunk=32)
        eng, spec, _ = _drain(
            params, cfg, spec=True, prefill_chunk=32,
            prefix_cache=PrefixCache(cfg, pool_rows=2, device="cpu"),
            order=[0, 1, 2, 0, 3, 4])
        _equal(base, spec)
        assert eng.stats.n_prefix_hits >= 1

    def test_spec_engine_matches_the_jax_spec_engine(self):
        # The same weights, both engines greedy and speculative: tokens
        # agree up to any point where the JAX model's top two logits are
        # within 1e-4.
        jcfg = jt.TransformerConfig(**BASE, rope=True, n_kv_heads=1)
        cfg = _cfg(rope=True, n_kv_heads=1)
        jparams = jt.init_params(jcfg, seed=4)
        params = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                         cfg, device="cpu")
        prompts, steps = _workload(cfg)
        jeng = JaxEngine(jparams, jcfg, batch=2, round_steps=4,
                         spec_draft_lens=(4,))
        jids = [jeng.submit(p, s) for p, s in zip(prompts, steps)]
        jdone = {r.request_id: r for r in jeng.run()}
        _, got, _ = _drain(params, cfg, spec=True, lens=(4,))
        for i, (prompt, jid) in enumerate(zip(prompts, jids)):
            ref = np.asarray(jdone[jid].tokens)
            if (ref == got[i]).all():
                continue
            j = int(np.argmin(ref == got[i]))
            seq = np.concatenate([prompt, ref[:j]])[None]
            lg = np.sort(np.asarray(jt.forward(
                jparams, jnp.asarray(seq, jnp.int32), jcfg))[0, -1])
            assert lg[-1] - lg[-2] <= 1e-4, \
                f"request {i} diverges at token {j} off a near-tie"


class TestSpecSampledInvariance:
    def test_arrival_pattern_cannot_move_sampled_outputs(self):
        # Batch size, round length, waves of arrivals (admissions beside
        # rows mid-decode) and the cache layout move slots and
        # interleaving; at a fixed draft length each request's sampled
        # tokens stay put (ids follow submission order, streams the ids).
        cfg = _cfg()
        params = pt.init_params(cfg, seed=0, device="cpu")
        prompts, steps = _workload(cfg)
        outs = []
        for batch, rsteps, waves, paged in ((2, 4, 1, False),
                                            (3, 7, 3, False),
                                            (5, 16, 2, True)):
            eng = ServingEngine(
                params, cfg, batch=batch, round_steps=rsteps, seed=3,
                temperature=0.9, spec_draft_lens=(2, 4, 6),
                spec_adaptive=False, device="cpu",
                kv_pages=(cfg.max_len // 16 * 5) if paged else None)
            per = -(-len(prompts) // waves)
            done = []
            for w in range(waves):
                for i in range(w * per, min((w + 1) * per, len(prompts))):
                    eng.submit(prompts[i], steps[i])
                done += eng.step()
            done += eng.run()
            by_id = {r.request_id: r.tokens.tolist() for r in done}
            outs.append([by_id[i] for i in range(len(prompts))])
        assert outs[0] == outs[1] == outs[2]
        _, greedy, _ = _drain(params, cfg, spec=True)
        assert [t.tolist() for t in greedy] != outs[0]  # it did sample


class TestSpecAccounting:
    def test_ledger_identity_and_counters(self):
        cfg = _cfg()
        params = pt.init_params(cfg, seed=0, device="cpu")
        reg = MetricsRegistry()
        log = RunLog()
        eng, _, reqs = _drain(params, cfg, spec=True, metrics_registry=reg,
                              runlog=log)
        for r in reqs:
            assert r.emitted == 1 + r.live_iters + r.spec_accepted
            assert r.spec_drafted >= r.spec_accepted >= 0
        st = eng.stats
        assert st.n_spec_drafted == sum(r.spec_drafted for r in reqs)
        assert st.n_spec_accepted == sum(r.spec_accepted for r in reqs)
        summary = st.summary()
        assert summary["spec_accepted"] == st.n_spec_accepted
        assert 0.0 < summary["spec_accept_rate"] <= 1.0
        assert reg.counter("serving_spec_accepted_total").value \
            == st.n_spec_accepted
        assert reg.gauge("serving_spec_draft_len").value in (2, 4, 6)
        rounds = [e for e in log.events("round") if e["iters"]]
        assert rounds and all(e["draft_len"] in (2, 4, 6) for e in rounds)
        assert sum(e["spec_accepted"] for e in rounds) == st.n_spec_accepted
        assert log.events("engine_start")[0]["spec_draft_lens"] == [2, 4, 6]

    def test_adaptive_policy_follows_acceptance(self):
        # Drafts that always land raise the draft length to the set's top;
        # the policy reads the EWMA through pick_draft_len.
        cfg = _cfg()
        params = pt.init_params(cfg, seed=0, device="cpu")
        eng = ServingEngine(params, cfg, batch=1, round_steps=2,
                            spec_draft_lens=(2, 8), device="cpu")
        assert eng._draft_len == 2
        eng.stats.record_spec_round(10, 10, 2)
        eng._spec_fields(np.array([7]), np.array([7]), 2)
        assert eng._draft_len == pcm.pick_draft_len(
            eng.stats.spec_accept_rate(), (2, 8), cfg, 1) == 8
        fixed = ServingEngine(params, cfg, batch=1, round_steps=2,
                              spec_draft_lens=(2, 8), spec_adaptive=False,
                              device="cpu")
        fixed._spec_fields(np.array([7]), np.array([7]), 2)
        assert fixed._draft_len == 2


class TestSpecSubmitValidation:
    def test_overhang_tightens_the_extent_check(self):
        cfg = _cfg()
        params = pt.init_params(cfg, seed=0, device="cpu")
        eng = ServingEngine(params, cfg, spec_draft_lens=(2, 6),
                            device="cpu")
        prompt = np.arange(10) % cfg.vocab
        with pytest.raises(ValueError, match="draft overhang 5"):
            eng.submit(prompt, cfg.max_len - 10)
        eng.submit(prompt, cfg.max_len - 10 - 5)
        ServingEngine(params, cfg, device="cpu").submit(prompt,
                                                        cfg.max_len - 10)

    def test_prompt_shorter_than_ngram_is_rejected(self):
        cfg = _cfg()
        eng = ServingEngine(pt.init_params(cfg, seed=0, device="cpu"), cfg,
                            spec_draft_lens=(2,), spec_ngram=3,
                            device="cpu")
        with pytest.raises(ValueError, match="spec_ngram"):
            eng.submit(np.array([1, 2]), 4)

    @pytest.mark.parametrize("options,match", [
        (dict(spec_draft_lens=()), "non-empty"),
        (dict(spec_draft_lens=(1, 4)), ">= 2"),
        (dict(spec_draft_lens=(2,), spec_ngram=0), "spec_ngram"),
        (dict(spec_draft_lens=(2, 96)), "max_len"),
    ], ids=["empty", "below_2", "ngram_0", "at_max_len"])
    def test_knob_validation(self, options, match):
        cfg = _cfg()
        with pytest.raises(ValueError, match=match):
            ServingEngine(pt.init_params(cfg, seed=0, device="cpu"), cfg,
                          device="cpu", **options)

    def test_paged_reservation_includes_overhang(self):
        cfg = _cfg()
        params = pt.init_params(cfg, seed=0, device="cpu")
        eng = ServingEngine(params, cfg, batch=1, kv_pages=5,
                            spec_draft_lens=(2, 8), device="cpu")
        # 10 + 63 + 7 = 80 slots: 5 pages; 10 + 64 + 7: 6 > 5, where the
        # non-speculative engine's 10 + 64 fits in 5.
        with pytest.raises(ValueError, match="KV pages"):
            eng.submit(np.arange(10), 64)
        ServingEngine(params, cfg, batch=1, kv_pages=5,
                      device="cpu").submit(np.arange(10), 64)
        eng.submit(np.arange(10), 63)
        eng.step()
        assert len(eng._row_pages[0]) == 5


class TestCostModelTwins:
    def test_spec_round_cost_and_pick_draft_len_equal_jax(self):
        for kw in ({}, {"kv_quant": "int8"}, {"rope": True, "n_kv_heads": 1}):
            jcfg = jt.TransformerConfig(**BASE, **kw)
            cfg = _cfg(**kw)
            for c in (1, 2, 5, 8):
                for qw in (False, True):
                    assert pcm.spec_round_cost(cfg, 4, c, quant_weights=qw) \
                        == jcm.spec_round_cost(jcfg, 4, c, quant_weights=qw)
            for rate in (0.0, 0.2, 0.5, 0.8, 0.95, 1.0):
                for lens in ((2, 4, 6), (2, 8), (4,)):
                    assert pcm.pick_draft_len(rate, lens, cfg, 8) \
                        == jcm.pick_draft_len(rate, lens, jcfg, 8)
        with pytest.raises(ValueError, match="draft_len"):
            pcm.spec_round_cost(_cfg(), 1, 0)
