"""The port's serving engine (marlin_tpu_torch/serving), twins of
tests/test_serving.py plus the cross-framework check.

On the CPU the port's engine is held to its own B=1 ``generate`` token
for token (every row's arithmetic is independent of its neighbours and of
the 16-token admission padding at these sizes), and to the JAX engine on
the same weights wherever the JAX logits are not near-tied.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marlin_tpu.models import transformer as jt
from marlin_tpu.serving import ServingEngine as JaxEngine
from marlin_tpu_torch.models import convert
from marlin_tpu_torch.models import transformer as pt
from marlin_tpu_torch.serving import (AdmissionQueue, QueueClosed,
                                      QueueFull, Request, ServingEngine,
                                      SlotManager, pad_prompt_len,
                                      request_stats)
from marlin_tpu_torch.serving import faults


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One intra-op thread: these tests run beside wall-clock-timed tests
    # in the parallel suite, and their shapes are too small to need more.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    base = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                max_len=96)
    base.update(kw)
    return pt.TransformerConfig(**base)


def _params(cfg, seed=0):
    return pt.init_params(cfg, seed=seed, device="cpu")


def _engine(params, cfg, **kw):
    return ServingEngine(params, cfg, device="cpu", **kw)


def _req(rid=0, steps=4, prompt_len=4, **kw):
    return Request(request_id=rid, steps=steps,
                   prompt=np.zeros((prompt_len,), np.int64), **kw)


def _generate(params, cfg, prompt, steps, **kw):
    return pt.generate(params, torch.as_tensor(prompt[None]), steps, cfg,
                       **kw).numpy()[0]


def _run_workload(engine, workload, waves=1):
    """Submit ``workload`` [(prompt, steps), ...] in ``waves`` batches with
    an engine step between them (mid-stream admission), then drain.
    Returns ({request_id: (prompt, steps)}, {request_id: Request})."""
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


class TestAdmissionQueue:
    def test_fifo_and_backpressure(self):
        q = AdmissionQueue(max_pending=2)
        q.submit(_req(0))
        q.submit(_req(1))
        with pytest.raises(QueueFull, match="max_pending"):
            q.submit(_req(2))
        got, expired = q.pop_ready(0)
        assert got.request_id == 0 and not expired
        q.submit(_req(2))
        assert q.pop_ready(0)[0].request_id == 1

    def test_close_drains_but_rejects_new(self):
        q = AdmissionQueue()
        q.submit(_req(0))
        q.close()
        with pytest.raises(QueueClosed):
            q.submit(_req(1))
        assert q.pop_ready(0)[0].request_id == 0

    def test_deadline_expiry_drops_at_pop(self):
        q = AdmissionQueue()
        q.submit(_req(0, deadline_rounds=2))
        q.submit(_req(1, deadline_time=1.0))  # an instant long past
        q.submit(_req(2))
        got, expired = q.pop_ready(5)
        assert got.request_id == 2
        assert [r.request_id for r in expired] == [0, 1]
        assert all(r.status == "timeout" for r in expired)


class TestSlots:
    def test_acquire_release_cycle(self):
        sm = SlotManager(2)
        a, b = sm.acquire(10), sm.acquire(11)
        assert {a, b} == {0, 1} and sm.n_free == 0
        with pytest.raises(RuntimeError, match="no free slot"):
            sm.acquire(12)
        sm.release(a)
        assert sm.n_free == 1 and sm.owner_of(a) is None
        with pytest.raises(RuntimeError, match="double free"):
            sm.release(a)
        assert sm.acquire(12) == a

    def test_pad_prompt_len_is_the_16_bucket(self):
        assert [pad_prompt_len(s) for s in (1, 15, 16, 17, 32, 33)] == \
            [16, 16, 16, 32, 32, 48]
        with pytest.raises(ValueError):
            pad_prompt_len(0)


class TestServingExactness:
    @pytest.mark.parametrize("kw", [{}, {"rope": True, "n_kv_heads": 1}],
                             ids=["pos_mha", "rope_mqa"])
    def test_outputs_equal_b1_generate(self, kw):
        # Mixed prompt lengths (several 16-buckets, a 1-token prompt) and
        # skewed step counts in three waves, so admissions land while
        # neighbours are mid-decode.
        cfg = _cfg(**kw)
        params = _params(cfg, seed=0)
        eng = _engine(params, cfg, batch=3, round_steps=5)
        rng = np.random.default_rng(7)
        workload = [(rng.integers(0, cfg.vocab, s), steps)
                    for s, steps in ((9, 20), (17, 5), (20, 12), (5, 30),
                                     (33, 7), (12, 18), (6, 3), (1, 6))]
        ids, done = _run_workload(eng, workload, waves=3)
        assert eng.stats.n_completed == len(workload)
        assert not eng.requests  # finished work is handed back, not held
        for rid, (prompt, steps) in ids.items():
            np.testing.assert_array_equal(
                done[rid].tokens, _generate(params, cfg, prompt, steps),
                err_msg=f"request {rid}")

    @pytest.mark.parametrize("temperature", [0.0, 0.9],
                             ids=["greedy", "sampled"])
    def test_arrival_pattern_cannot_move_outputs(self, temperature):
        # Batch size, wave split and round length change slot assignment
        # and interleaving; each request's tokens must not move. Sampled
        # requests draw from their own generator (engine seed, request
        # id), advanced only on their live iterations.
        cfg = _cfg()
        params = _params(cfg, seed=3)
        rng = np.random.default_rng(11)
        workload = [(rng.integers(0, cfg.vocab, int(s)), int(st))
                    for s, st in zip(rng.integers(4, 30, 8),
                                     rng.integers(2, 24, 8))]
        outs = []
        for batch, waves, rsteps in ((2, 1, 4), (4, 4, 7), (3, 2, 16)):
            eng = _engine(params, cfg, batch=batch, round_steps=rsteps,
                          temperature=temperature, seed=5)
            ids, done = _run_workload(eng, workload, waves=waves)
            outs.append([done[rid].tokens.tolist() for rid in sorted(ids)])
        assert outs[0] == outs[1] == outs[2]

    def test_steps_one_at_max_len_boundary(self):
        # A steps=1 request is complete at admission; at prompt_len + 1 ==
        # max_len an extra decode append would land past the buffer.
        cfg = _cfg()
        params = _params(cfg, seed=4)
        rng = np.random.default_rng(6)
        eng = _engine(params, cfg, batch=2, round_steps=4)
        prompts = [rng.integers(0, cfg.vocab, cfg.max_len - 1),
                   rng.integers(0, cfg.vocab, 9)]
        ids = [eng.submit(p, 1) for p in prompts]
        done = {r.request_id: r for r in eng.run()}
        for rid, p in zip(ids, prompts):
            np.testing.assert_array_equal(done[rid].tokens,
                                          _generate(params, cfg, p, 1))
            assert done[rid].live_iters == 0
            assert done[rid].emitted == 1

    def test_eos_freeze_matches_generate(self):
        cfg = _cfg()
        params = _params(cfg, seed=5)
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, cfg.vocab, s) for s in (8, 13, 21)]
        steps = 16
        free = [_generate(params, cfg, p, steps) for p in prompts]
        eos = int(free[0][steps // 2])  # a mid-stream token: fires early
        eng = _engine(params, cfg, batch=2, round_steps=4, eos_id=eos)
        ids = {eng.submit(p, steps): p for p in prompts}
        done = {r.request_id: r for r in eng.run()}
        fired = 0
        for rid, p in ids.items():
            ref = _generate(params, cfg, p, steps, eos_id=eos)
            np.testing.assert_array_equal(done[rid].tokens, ref)
            fired += int((ref == eos).any())
        assert fired >= 1
        emitted = [done[r].emitted for r in ids]
        assert eng.stats.tokens_out == sum(emitted)
        assert any(e < steps for e in emitted)


def _jax_margin(jparams, jcfg, prompt, tokens, j):
    """Top-2 logit margin of the JAX model before token ``j``."""
    seq = np.concatenate([prompt, tokens[:j]])[None]
    logits = np.asarray(jt.forward(jparams, jnp.asarray(seq, jnp.int32),
                                   jcfg))[0, -1]
    top = np.sort(logits)[-2:]
    return float(top[1] - top[0])


def test_engine_matches_the_jax_engine():
    # Same weights (params_from_jax), same prompts, both engines greedy:
    # tokens must agree up to any point where the JAX model's top two
    # logits are within 1e-4 (there the frameworks' summation orders may
    # legitimately pick different tokens).
    jcfg = jt.TransformerConfig(vocab=64, d_model=32, n_heads=2,
                                n_layers=2, d_ff=64, max_len=96, rope=True,
                                n_kv_heads=1)
    cfg = pt.TransformerConfig(**jcfg._asdict())
    jparams = jt.init_params(jcfg, seed=1)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    rng = np.random.default_rng(3)
    workload = [(rng.integers(0, cfg.vocab, s), st)
                for s, st in ((10, 12), (23, 6), (4, 16), (17, 9), (30, 5))]
    jeng = JaxEngine(jparams, jcfg, batch=3, round_steps=4)
    jids = [jeng.submit(p, st) for p, st in workload]
    jdone = {r.request_id: r for r in jeng.run()}
    eng = _engine(params, cfg, batch=3, round_steps=4)
    ids = [eng.submit(p, st) for p, st in workload]
    done = {r.request_id: r for r in eng.run()}
    for (prompt, _), jid, rid in zip(workload, jids, ids):
        ref, got = jdone[jid].tokens, done[rid].tokens
        if (ref == got).all():
            continue
        j = int(np.argmin(ref == got))
        assert _jax_margin(jparams, jcfg, prompt, ref, j) <= 1e-4, \
            f"request {rid} diverges at token {j} off a near-tie"


class TestServingLedgerAndGuards:
    def test_deadline_timeout_and_drain(self):
        cfg = _cfg()
        eng = _engine(_params(cfg, seed=2), cfg, batch=1, round_steps=2)
        rng = np.random.default_rng(9)
        blocker = eng.submit(rng.integers(0, cfg.vocab, 8), steps=30)
        doomed = eng.submit(rng.integers(0, cfg.vocab, 8), steps=4,
                            deadline_rounds=1)
        eng.close()
        with pytest.raises(QueueClosed):
            eng.submit(rng.integers(0, cfg.vocab, 8), steps=2)
        by_id = {r.request_id: r for r in eng.run()}
        assert by_id[blocker].status == "done"
        assert by_id[doomed].status == "timeout"
        assert by_id[doomed].tokens is None
        assert eng.stats.n_timeout == 1
        assert eng.runlog.events("drain_complete")

    def test_ledger_counts_live_work(self):
        cfg = _cfg()
        eng = _engine(_params(cfg, seed=6), cfg, batch=2, round_steps=4)
        rng = np.random.default_rng(1)
        for steps in (3, 9, 5):
            eng.submit(rng.integers(0, cfg.vocab, 7), steps)
        done = eng.run()
        # Each request's first token comes from its admission prefill.
        assert sum(r.live_iters for r in done) == (3 - 1) + (9 - 1) + (5 - 1)
        assert eng.stats.useful_row_iters == 14
        assert 0.0 < eng.stats.utilization() <= 1.0
        stats = request_stats(done[0])
        assert stats["status"] == "done" and stats["emitted"] == 3
        summary = eng.stats.summary()
        assert summary["completed"] == 3 and summary["tokens_out"] == 17

    def test_submit_guards(self):
        cfg = _cfg()
        eng = _engine(_params(cfg), cfg, batch=1)
        with pytest.raises(ValueError, match="max_len"):
            eng.submit(np.zeros(90, np.int64), steps=10)
        with pytest.raises(ValueError, match="steps"):
            eng.submit(np.zeros(4, np.int64), steps=0)
        short = _cfg(max_len=90)  # 81 + 1 fits; its 16-bucket (96) not
        with pytest.raises(ValueError, match="padded prompt"):
            _engine(_params(short), short).submit(np.zeros(81, np.int64),
                                                  steps=1)

    def test_injected_faults_reach_the_caller(self):
        cfg = _cfg()
        params = _params(cfg)
        plan = faults.install(faults.FaultPlan())
        try:
            plan.add(site="decode_round", round=1)
            eng = _engine(params, cfg, batch=2, round_steps=2)
            eng.submit(np.arange(5), 8)
            eng.step()
            with pytest.raises(faults.FaultInjected):
                eng.step()
            plan.add(site="decode_round", action="corrupt")
            with pytest.raises(faults.EngineStateCorrupt):
                eng.step()
        finally:
            faults.reset()
        assert plan.total_fires() == 2


@pytest.mark.parametrize("option,value,error,match", [
    ("host_kv_bytes", 1 << 20, ValueError, "kv_pages"),
    ("host_kv_dir", "/tmp/kv", ValueError, "kv_pages"),
    ("restore_min_tokens", 32, ValueError, "restore_min_tokens"),
    ("sched_class", "batch", ValueError, "needs a scheduler"),
], ids=["host_kv_bytes-1048576", "host_kv_dir-/tmp/kv",
        "restore_min_tokens-32", "scheduler-value3"])
def test_non_default_engine_options_raise(option, value, error, match):
    # The reference's guards: the host tier needs the paged prefix index,
    # restore_min_tokens a tier, a request's sched_class a scheduler.
    cfg = _cfg()
    with pytest.raises(error, match=match):
        if option == "sched_class":
            _engine(_params(cfg), cfg).submit(np.arange(4), 2,
                                              sched_class=value)
        else:
            _engine(_params(cfg), cfg, **{option: value})


@pytest.mark.parametrize("options", [
    dict(spec_draft_lens=(2, 4)),
    dict(spec_draft_lens=(2, 4), spec_ngram=3),
    dict(spec_draft_lens=(2, 4), spec_adaptive=False),
], ids=["spec_draft_lens", "spec_ngram", "spec_adaptive"])
def test_spec_options_serve(options):
    # The speculative options the engine once refused: each serves, and
    # every request's tokens are its B=1 generate's.
    cfg = _cfg()
    params = _params(cfg, seed=6)
    eng = _engine(params, cfg, batch=2, round_steps=3, **options)
    rng = np.random.default_rng(8)
    workload = [(np.tile(rng.integers(0, cfg.vocab, 3), 5), 14),
                (rng.integers(0, cfg.vocab, 11), 9),
                (np.tile(rng.integers(0, cfg.vocab, 4), 3), 12)]
    ids, done = _run_workload(eng, workload, waves=2)
    assert eng.spec and eng.stats.n_spec_drafted > 0
    if not options.get("spec_adaptive", True):
        assert eng._draft_len == 2
    for rid, (prompt, steps) in ids.items():
        np.testing.assert_array_equal(
            done[rid].tokens, _generate(params, cfg, prompt, steps),
            err_msg=f"request {rid}")


@pytest.mark.parametrize("options,error,match", [
    (dict(kv_pages=8, prefix_cache="cache"), ValueError,
     "mutually exclusive"),
    (dict(prefix_sharing=False), ValueError, "prefix_sharing"),
    (dict(prefill_chunk=24), ValueError, "multiple of 16"),
    (dict(prefill_chunk=8), ValueError, "multiple of 16"),
    (dict(prefill_chunk=32, prefill_chunks_per_round=0), ValueError,
     "prefill_chunks_per_round"),
    (dict(kv_pages=8, prefix_sharing=False, host_kv_bytes=1 << 20),
     ValueError, "prefix_sharing=True"),
    (dict(kv_pages=8, scheduler="scheduler", restore_min_tokens=32),
     ValueError, "restore_min_tokens"),
], ids=["pages_with_cache", "sharing_paged_only", "chunk_24", "chunk_8",
        "chunks_per_round_0", "pages_with_host_tier",
        "pages_with_scheduler"])
def test_discipline_guards(options, error, match):
    # The reference's constructor guards: a host tier rides on the paged
    # prefix index (sharing on), and restore_min_tokens needs a tier
    # beside a scheduler too.
    from marlin_tpu_torch.serving import PrefixCache, Scheduler

    cfg = _cfg()
    if options.get("prefix_cache") == "cache":
        options = dict(options, prefix_cache=PrefixCache(cfg, pool_rows=1,
                                                         device="cpu"))
    if options.get("scheduler") == "scheduler":
        options = dict(options, scheduler=Scheduler())
    with pytest.raises(error, match=match):
        _engine(_params(cfg), cfg, **options)


def test_reuse_options_default_the_chunked_discipline():
    # A prefix cache or a page pool runs on chunked admission, at 32
    # positions a chunk unless asked otherwise.
    from marlin_tpu_torch.serving import PrefixCache

    cfg = _cfg()
    params = _params(cfg)
    cache = PrefixCache(cfg, pool_rows=1, device="cpu")
    assert _engine(params, cfg, prefix_cache=cache).prefill_chunk == 32
    assert _engine(params, cfg, kv_pages=8).prefill_chunk == 32
    assert _engine(params, cfg, kv_pages=8, prefill_chunk=64) \
        .prefill_chunk == 64
    assert _engine(params, cfg).prefill_chunk is None


def test_stats_default_is_accepted():
    # The reference's default (no inherited EngineStats) builds the engine.
    cfg = _cfg()
    eng = _engine(_params(cfg), cfg, stats=None)
    assert eng.stats.n_admitted == 0


def test_successor_stats_is_the_predecessor_ledger():
    # stats= is served: a successor (spawn_successor, the supervised
    # restart) keeps counting into its predecessor's ledger, so one serving
    # lifetime's totals span its engine incarnations.
    cfg = _cfg()
    params = _params(cfg)
    eng = _engine(params, cfg, batch=2, round_steps=4)
    rng = np.random.default_rng(4)
    for _ in range(3):
        eng.submit(rng.integers(0, cfg.vocab, 6), 3)
    eng.run()
    succ = eng.spawn_successor()
    assert succ.stats is eng.stats
    succ.submit(rng.integers(0, cfg.vocab, 6), 3)
    succ.run()
    assert eng.stats.n_completed == 4 and eng.stats.tokens_out == 12
    # An engine built on another's ledger adds to it too.
    other = _engine(params, cfg, stats=eng.stats)
    other.submit(rng.integers(0, cfg.vocab, 6), 2)
    other.run()
    assert eng.stats.n_completed == 5


def test_configs_outside_the_slice_raise():
    params = _params(_cfg())
    with pytest.raises(NotImplementedError, match="dense"):
        _engine(params, _cfg(window=8))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _engine(params, _cfg(n_experts=2))
    # tp is served (test_torch_tp_serving.py); a degree that splits no
    # head evenly is validate_tp's refusal.
    with pytest.raises(ValueError, match="must divide"):
        _engine(params, _cfg(tp=3))
    with pytest.raises(TypeError, match="unexpected keyword argument"):
        _engine(params, _cfg(), no_such_option=1)
