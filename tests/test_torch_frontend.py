"""The port's in-process frontend (marlin_tpu_torch/serving/frontend.py's
EngineFrontend and FrontendRequest, the admission queue under concurrent
submitters, the drain's sealed run log), twins of tests/test_frontend.py's
TestQueueConcurrency, TestEngineConcurrentSubmitters, TestDrainRunlog and
TestEngineFrontend. The HTTP server, the wire and the matrix service are
not ported yet, and neither are their tests.

Inside the port, on the CPU: eight producer threads racing the driver
lose, duplicate and double-retire nothing, and every metric mirror agrees
to the unit; a streamed sequence is the blocking response chunked, and
both equal an in-process ``engine.run()`` of the same workload bitwise;
``drain`` seals the run log once. Against the JAX package: the same
workload through its frontend gives the same greedy tokens up to a JAX
top-2 logit margin of 1e-4 (tests/test_torch_serving.py's tolerance).
"""

import json
import threading
import time

import numpy as np
import pytest

import jax.numpy as jnp

from marlin_tpu.models import transformer as jt
from marlin_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from marlin_tpu.serving import EngineFrontend as JaxFrontend
from marlin_tpu.serving import ServingEngine as JaxEngine
from marlin_tpu_torch import serving
from marlin_tpu_torch.obs.metrics import MetricsRegistry
from marlin_tpu_torch.obs.runlog import RunLog
from marlin_tpu_torch.obs.trace import Tracer
from marlin_tpu_torch.serving import (AdmissionQueue, EngineFrontend,
                                      FrontendError, QueueClosed, QueueFull,
                                      Request, Scheduler, ServingEngine)
# The shared fixtures (the model on both frameworks, one torch thread, the
# plans reset, every frontend stopped) and helpers.
from test_torch_faults import (JOIN_S, _clean_plan,  # noqa: F401
                               _one_torch_thread, _prompts, frontends,
                               model)


def _engine(params, cfg, **kw):
    kw.setdefault("metrics_registry", MetricsRegistry())
    return ServingEngine(params, cfg, device="cpu", **kw)


def _golden(params, cfg, prompts, steps, **eng_kw):
    eng = _engine(params, cfg, **eng_kw)
    for p in prompts:
        eng.submit(p, steps)
    return {r.request_id: list(map(int, r.tokens)) for r in eng.run()}


def _req(rid, **kw):
    return Request(request_id=rid, steps=1, prompt=np.zeros(4, np.int32),
                   **kw)


# -- the queue under concurrency -------------------------------------------


class TestQueueConcurrency:
    def test_producers_vs_consumer_exact_accounting(self):
        q = AdmissionQueue(max_pending=10_000)
        n_threads, per = 8, 200
        accepted = [[] for _ in range(n_threads)]

        def producer(t):
            for i in range(per):
                q.submit(_req(t * per + i))
                accepted[t].append(t * per + i)

        popped = []
        stop = threading.Event()

        def consumer():
            while not stop.is_set() or len(q):
                req, expired = q.pop_ready(0)
                assert not expired
                if req is not None:
                    popped.append(req.request_id)

        threads = [threading.Thread(target=producer, args=(t,))
                   for t in range(n_threads)]
        c = threading.Thread(target=consumer)
        c.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
        stop.set()
        c.join(JOIN_S)
        assert not c.is_alive()
        assert sorted(popped) == sorted(sum(accepted, []))
        assert len(set(popped)) == len(popped)
        assert len(q) == 0

    def test_backpressure_races_never_overfill(self):
        q = AdmissionQueue(max_pending=4)
        outcomes = []
        lock = threading.Lock()
        barrier = threading.Barrier(8)

        def producer(t):
            barrier.wait()
            for i in range(25):
                try:
                    q.submit(_req(t * 25 + i))
                    ok = True
                except QueueFull:
                    ok = False
                with lock:
                    outcomes.append(ok)
                    assert len(q) <= 4

        threads = [threading.Thread(target=producer, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
        assert sum(outcomes) >= 4
        drained = 0
        while q.pop_ready(0)[0] is not None:
            drained += 1
        assert drained == 4

    def test_wallclock_deadline_drops_at_pop(self):
        q = AdmissionQueue()
        now = time.perf_counter()
        q.submit(_req(0, deadline_time=now - 1.0))
        q.submit(_req(1, deadline_time=now + 60.0))
        got, expired = q.pop_ready(0)
        assert got.request_id == 1
        assert [r.request_id for r in expired] == [0]
        assert expired[0].status == "timeout"

    @pytest.mark.parametrize("sched", [False, True], ids=["fifo", "edf"])
    def test_restore_bypasses_cap_and_close_in_order(self, sched):
        # The recovery path: accepted work comes back past a full or closed
        # queue, in request-id order, and a scheduler keeps each request's
        # arrival sequence (the EDF tie-break).
        q = AdmissionQueue(max_pending=2,
                           scheduler=Scheduler() if sched else None)
        cls = {"sched_class": "batch"} if sched else {}
        reqs = [_req(i, **cls) for i in range(4)]
        for r in reqs[:2]:
            q.submit(r)
        seqs = [r.sched_seq for r in reqs[:2]]
        assert [q.pop_ready(0)[0].request_id for _ in range(2)] == [0, 1]
        q.submit(reqs[2])
        q.submit(reqs[3])
        q.close()
        with pytest.raises(QueueClosed):
            q.submit(_req(9, **cls))
        for r in reqs[:2]:
            r.reset_for_requeue(time.perf_counter())
            q.restore(r)
        assert len(q) == 4  # past max_pending, past close
        assert [r.sched_seq for r in reqs[:2]] == seqs
        order = [q.pop_ready(0)[0].request_id for _ in range(4)]
        assert order == ([0, 1, 2, 3] if sched else [2, 3, 0, 1])
        assert all(r.requeues == 1 and r.status == "pending"
                   for r in reqs[:2])


class TestEngineConcurrentSubmitters:
    def test_eight_producers_exact_request_accounting(self, model,
                                                      frontends):
        params, cfg, _, _ = model
        reg = MetricsRegistry()
        eng = _engine(params, cfg, batch=4, round_steps=4, max_pending=512,
                      metrics_registry=reg)
        fe = frontends(EngineFrontend, eng).start()
        n_threads, per = 8, 6
        handles = [[] for _ in range(n_threads)]
        prompts = _prompts(cfg, n_threads * per)
        barrier = threading.Barrier(n_threads)

        def producer(t):
            barrier.wait()
            for i in range(per):
                handles[t].append(fe.submit(prompts[t * per + i], steps=3))

        threads = [threading.Thread(target=producer, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
        flat = sum(handles, [])
        results = [h.result(JOIN_S) for h in flat]
        assert fe.drain(JOIN_S)
        n = n_threads * per
        assert len({r.request_id for r in results}) == n
        assert all(r.status == "done" for r in results)
        assert all(len(r.tokens) == 3 for r in results)
        assert eng.stats.n_completed == n and eng.stats.n_timeout == 0
        assert reg.counter("serving_submitted_total").value == n
        assert reg.counter("serving_completed_total").value == n
        assert reg.counter("serving_tokens_out_total").value == 3 * n
        assert reg.gauge("serving_queue_depth").value == 0
        assert len(eng.requests) == 0
        gold = _golden(params, cfg, prompts, 3, batch=4, round_steps=4)
        by_prompt = {tuple(map(int, prompts[i])): gold[i] for i in range(n)}
        for r in results:
            assert list(map(int, r.tokens)) \
                == by_prompt[tuple(map(int, r.prompt))]


# -- drain -----------------------------------------------------------------


class TestDrainRunlog:
    def test_drain_flushes_jsonl_and_emits_terminal_ledger(
            self, model, tmp_path):
        params, cfg, _, _ = model
        path = tmp_path / "runlog.jsonl"
        eng = _engine(params, cfg, batch=2, round_steps=4,
                      runlog=RunLog(maxlen=8, path=path))
        for p in _prompts(cfg, 5):
            eng.submit(p, 6)
        eng.step()
        assert eng.slots.n_occupied > 0
        assert len(eng.drain()) == 5
        lines = [json.loads(line)
                 for line in path.read_text().strip().splitlines()]
        assert len(lines) == eng.runlog.n_emitted
        assert lines[-1]["kind"] == "drain_complete"
        ledger = lines[-1]["ledger"]
        assert ledger["completed"] == 5 and ledger["admitted"] == 5
        assert ledger == json.loads(json.dumps(eng.stats.summary(),
                                               default=str))
        for kind in ("submit", "admit", "complete"):
            assert {e["request_id"] for e in lines
                    if e["kind"] == kind} == set(range(5)), kind
        assert len(eng.runlog) <= 8

    def test_drain_complete_is_emitted_exactly_once(self, model):
        params, cfg, _, _ = model
        eng = _engine(params, cfg, batch=2, round_steps=4)
        eng.submit(_prompts(cfg, 1)[0], 2)
        eng.drain()
        eng.run()
        eng.drain()
        assert len(eng.runlog.events("drain_complete")) == 1

    def test_open_queue_run_does_not_seal(self, model):
        params, cfg, _, _ = model
        eng = _engine(params, cfg, batch=2, round_steps=4)
        eng.submit(_prompts(cfg, 1)[0], 2)
        eng.run()
        assert eng.runlog.events("drain_complete") == []
        eng.submit(_prompts(cfg, 1)[0], 2)
        eng.drain()
        assert len(eng.runlog.events("drain_complete")) == 1


# -- the frontend ----------------------------------------------------------


class TestEngineFrontend:
    def test_blocking_and_streaming_match_engine_run(self, model,
                                                     frontends):
        params, cfg, jparams, jcfg = model
        prompts = _prompts(cfg, 6)
        steps = 5
        gold = _golden(params, cfg, prompts, steps, batch=2, round_steps=4)
        eng = _engine(params, cfg, batch=2, round_steps=4)
        fe = frontends(EngineFrontend, eng).start()
        stream_handles = [fe.submit(p, steps, stream=True)
                          for p in prompts[:3]]
        block_handles = [fe.submit(p, steps) for p in prompts[3:]]
        for i, h in enumerate(stream_handles):
            toks = [int(t) for chunk in h.chunks(timeout=JOIN_S)
                    for t in chunk]
            assert toks == gold[i]
            assert toks == list(map(int, h.result(JOIN_S).tokens))
        for i, h in enumerate(block_handles):
            assert list(map(int, h.result(JOIN_S).tokens)) == gold[3 + i]
        assert fe.drain(JOIN_S)
        assert not fe.ready
        assert eng.runlog.events("drain_complete")
        # The reference's frontend over the same weights and workload.
        jeng = JaxEngine(jparams, jcfg, batch=2, round_steps=4,
                         metrics_registry=JaxRegistry())
        jfe = frontends(JaxFrontend, jeng)
        jhandles = [jfe.submit(p, steps) for p in prompts]
        jfe.start()
        for i, h in enumerate(jhandles):
            want = np.asarray(h.result(JOIN_S).tokens)
            got = np.asarray(gold[i])
            if (got == want).all():
                continue
            j = int(np.argmin(got == want))
            seq = np.concatenate([prompts[i], want[:j]])[None]
            logits = np.sort(np.asarray(jt.forward(
                jparams, jnp.asarray(seq, jnp.int32), jcfg))[0, -1])
            assert logits[-1] - logits[-2] <= 1e-4, (i, j)
        assert jfe.drain(JOIN_S)

    def test_deadline_s_times_out_queued_request(self, model, frontends):
        params, cfg, _, _ = model
        eng = _engine(params, cfg, batch=1, round_steps=4)
        fe = frontends(EngineFrontend, eng).start()
        long_h = fe.submit(_prompts(cfg, 1)[0], 32)
        short_h = fe.submit(_prompts(cfg, 2)[1], 2, deadline_s=0.002)
        assert short_h.result(JOIN_S).status == "timeout"
        assert long_h.result(JOIN_S).status == "done"
        assert eng.stats.n_timeout == 1
        assert fe.drain(JOIN_S)

    def test_debug_views_and_abandoned_stream(self, model, frontends):
        params, cfg, _, _ = model
        eng = _engine(params, cfg, batch=2, round_steps=2, kv_pages=16,
                      scheduler=Scheduler())
        fe = frontends(EngineFrontend, eng)
        h0 = fe.submit(_prompts(cfg, 1)[0], 6, stream=True)
        h1 = fe.submit(_prompts(cfg, 2)[1], 3, sched_class="interactive")
        snap = fe.debug_engine()
        assert snap["queue_depth"] == 2 and snap["tp_degree"] == 1
        assert snap["frontend"]["handles"] == 2
        assert not snap["frontend"]["alive"]
        assert "kv_pages" in snap and "prefix_index" in snap
        live = fe.debug_request(h0.request_id)
        assert live["status"] == "pending" and live["row"] == -1
        assert fe.debug_sched()["can_preempt"] is False  # no host tier
        fe.abandon_stream(h0)
        fe.abandon_stream(h0)
        fe.start()
        r0, r1 = h0.result(JOIN_S), h1.result(JOIN_S)
        assert list(h0.chunks(timeout=JOIN_S)) == []  # fed nothing
        assert len(r0.tokens) == 6 and r1.status == "done"
        assert len(eng.runlog.events("stream_abandoned")) == 1
        done = fe.debug_request(h1.request_id)
        assert done["status"] == "done" and done["emitted"] == 3
        assert r1.phases()["stream_delivery"] >= 0.0
        assert fe.debug_request(987654) is None
        assert fe.drain(JOIN_S)
        assert fe.debug_engine()["queue_closed"]

    def test_stop_fails_pending_handles(self, model, frontends):
        params, cfg, _, _ = model
        eng = _engine(params, cfg, batch=1, round_steps=1)
        fe = frontends(EngineFrontend, eng)
        handles = [fe.submit(p, 40) for p in _prompts(cfg, 3)]
        fe.start()
        assert fe.stop(JOIN_S)
        for h in handles:
            if h.error is not None:
                with pytest.raises(FrontendError, match="stopped"):
                    h.result(JOIN_S)
        assert any(h.error is not None for h in handles)
        assert not fe.alive

    def test_matrix_and_enabled_tracer_are_refused(self, model):
        params, cfg, _, _ = model
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A1"):
            EngineFrontend(_engine(params, cfg), matrix=object())
        traced = _engine(params, cfg, tracer=Tracer(enabled=True))
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A5"):
            EngineFrontend(traced)
        with pytest.raises(ValueError, match="max_restarts"):
            EngineFrontend(_engine(params, cfg), max_restarts=-1)
        with pytest.raises(ValueError, match="poison_after"):
            EngineFrontend(_engine(params, cfg), poison_after=0)

    def test_serving_exports_the_reference_names(self):
        for name in ("EngineFrontend", "EngineFailed", "FrontendError",
                     "PoisonedRequest", "FaultPlan", "FaultSpec",
                     "FaultInjected", "EngineStateCorrupt",
                     "static_schedule_iters", "static_completed_at_budget"):
            assert name in serving.__all__, name
            assert getattr(serving, name) is not None
        # The static batcher's pricing agrees with the reference's.
        from marlin_tpu.serving import stats as jstats

        steps = [5, 9, 2, 7, 7, 3, 11]
        for batch in (1, 2, 3):
            assert serving.static_schedule_iters(steps, batch) \
                == jstats.static_schedule_iters(steps, batch)
            for budget in (0, 9, 20):
                assert serving.static_completed_at_budget(
                    steps, batch, budget) \
                    == jstats.static_completed_at_budget(steps, batch,
                                                         budget)

    def test_reclaimed_flops_is_the_references(self, model):
        # The same ragged workload through both engines: the same
        # row-iteration ledger, priced the same against the static
        # batcher.
        params, cfg, jparams, jcfg = model
        from marlin_tpu.serving import stats as jstats

        steps = [5, 9, 2, 7, 3]
        prompts = _prompts(cfg, len(steps))
        eng = _engine(params, cfg, batch=2, round_steps=2)
        jeng = JaxEngine(jparams, jcfg, batch=2, round_steps=2,
                         metrics_registry=JaxRegistry())
        for p, n in zip(prompts, steps):
            eng.submit(p, n)
            jeng.submit(p, n)
        eng.run()
        jeng.run()
        st, jst = eng.stats, jeng.stats
        assert (st.useful_row_iters, st.wasted_row_iters) \
            == (jst.useful_row_iters, jst.wasted_row_iters)
        assert st.flops_per_row_iter() == jst.flops_per_row_iter()
        static = serving.static_schedule_iters(steps, 2)
        assert static == jstats.static_schedule_iters(steps, 2)
        for kw in (dict(static_iters=static),
                   dict(static_row_iters=2 * static + 3)):
            assert st.reclaimed_flops(**kw) == jst.reclaimed_flops(**kw)
        assert st.reclaimed_flops(static_iters=static) > 0
        with pytest.raises(ValueError, match="static_row_iters"):
            st.reclaimed_flops()
