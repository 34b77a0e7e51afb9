"""The port's SLO scheduling (marlin_tpu_torch/serving/sched.py, the
queue's scheduler mode, the engine's ``scheduler=`` and preemption
through the host KV tier), twins of tests/test_sched.py.

* Policy (no engine): ClassSpec and Scheduler validation, EDF within a
  class, rank across classes, work-conserving quotas, expiry at pop, the
  preemption candidate, victim order and cost gate, the metrics.
* Preemption (CPU engines): an interactive arrival freezes a decoding
  batch row at a round boundary, spills it through the host tier and
  resumes it; every request's tokens equal a FIFO engine's that never
  preempted, bitwise, for the plain, rope+GQA, int8 and speculative
  models and at temperature > 0 (the row's sampling stream survives the
  freeze). Aborts (cost gate, host budget) leave the tokens alone; a
  frozen request dropped for deadline releases its pinned row; the
  runlog, counters and ``debug_sched`` narrate every freeze.
* Against the JAX package: a seeded mix of classes and deadlines pops in
  the same order from both schedulers, with the same victim order; on the
  staggered workload the port's engine freezes and resumes the same
  request in the same rounds as the JAX engine's runlog, its tokens equal
  except after a near-tie of the JAX logits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marlin_tpu.models import transformer as jt
from marlin_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from marlin_tpu.serving import Scheduler as JaxScheduler
from marlin_tpu.serving import ServingEngine as JaxEngine
from marlin_tpu.serving.queue import Request as JaxRequest
from marlin_tpu_torch.models import convert
from marlin_tpu_torch.models import transformer as pt
from marlin_tpu_torch.obs.metrics import MetricsRegistry
from marlin_tpu_torch.obs.runlog import RunLog
from marlin_tpu_torch.serving import (DEFAULT_CLASSES, AdmissionQueue,
                                      ClassSpec, Scheduler, ServingEngine,
                                      faults)
from marlin_tpu_torch.serving.queue import Request
from marlin_tpu_torch.utils import cost_model as cm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    base = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                max_len=96)
    base.update(kw)
    return pt.TransformerConfig(**base)


def _req(rid, cls="", submit=0.0, deadline_time=None, deadline_rounds=None,
         make=Request):
    return make(request_id=rid, prompt=np.zeros(4, np.int64), steps=4,
                deadline_time=deadline_time,
                deadline_rounds=deadline_rounds, submit_time=submit,
                sched_class=cls)


class TestClassSpec:
    def test_validation(self):
        with pytest.raises(ValueError, match="identifier"):
            ClassSpec("", rank=0)
        with pytest.raises(ValueError, match="identifier"):
            ClassSpec("no-dashes", rank=0)
        with pytest.raises(ValueError, match="quota"):
            ClassSpec("a", rank=0, quota=0)
        with pytest.raises(ValueError, match="slo_s"):
            ClassSpec("a", rank=0, slo_s=0.0)

    def test_default_taxonomy(self):
        by_name = {c.name: c for c in DEFAULT_CLASSES}
        assert set(by_name) == {"interactive", "batch", "best_effort"}
        it = by_name["interactive"]
        assert it.rank == 0 and it.can_preempt and not it.preemptible
        assert it.slo_s == 1.0
        assert by_name["batch"].preemptible
        assert not by_name["batch"].can_preempt


class TestSchedulerPolicy:
    def test_constructor_validation(self):
        with pytest.raises(ValueError, match="at least one"):
            Scheduler(classes=())
        with pytest.raises(ValueError, match="duplicate class names"):
            Scheduler(classes=(ClassSpec("a", 0), ClassSpec("a", 1)))
        with pytest.raises(ValueError, match="ranks must be unique"):
            Scheduler(classes=(ClassSpec("a", 0), ClassSpec("b", 0)))
        with pytest.raises(ValueError, match="default_class"):
            Scheduler(default_class="gold")
        with pytest.raises(ValueError, match="max_preempts_per_round"):
            Scheduler(max_preempts_per_round=-1)

    def test_resolve_default_and_unknown(self):
        s = Scheduler()
        assert s.resolve(None).name == "interactive"
        assert s.resolve("batch").name == "batch"
        with pytest.raises(ValueError, match="unknown scheduling class"):
            s.resolve("gold")

    def test_edf_orders_within_class(self):
        s = Scheduler()
        for r in (_req(0, "batch"), _req(1, "batch", deadline_time=50.0),
                  _req(2, "batch", deadline_time=20.0), _req(3, "batch")):
            s.push(r)
        order = []
        while len(s):
            req, expired = s.pop(0, now=0.0)
            assert expired == []
            order.append(req.request_id)
        assert order == [2, 1, 0, 3]

    def test_class_slo_caps_the_effective_deadline(self):
        s = Scheduler()
        assert s.effective_deadline(_req(0, "interactive", submit=5.0)) \
            == 6.0
        assert s.effective_deadline(_req(1, "interactive", submit=0.0,
                                         deadline_time=100.0)) == 1.0

    def test_rank_beats_deadline_across_classes(self):
        s = Scheduler()
        s.push(_req(0, "batch", deadline_time=0.5))
        s.push(_req(1, "interactive", submit=10.0))
        assert s.pop(0, now=0.0)[0].request_id == 1

    def test_quota_bounds_only_under_contention(self):
        s = Scheduler(classes=(ClassSpec("gold", 0, quota=1,
                                         can_preempt=True),
                               ClassSpec("bulk", 1)))
        s.push(_req(0, "gold"))
        s.push(_req(1, "bulk"))
        assert s.pop(0, now=0.0, occupancy={"gold": 1})[0].request_id == 1
        assert s.pop(0, now=0.0, occupancy={"gold": 1})[0].request_id == 0
        s.push(_req(2, "gold"))
        s.push(_req(3, "bulk"))
        assert s.pop(0, now=0.0, occupancy={"gold": 0})[0].request_id == 2

    def test_pop_drops_expired_with_timeout_status(self):
        s = Scheduler()
        s.push(_req(0, "batch", deadline_time=1.0))
        s.push(_req(1, "batch"))
        s.push(_req(2, "batch", deadline_time=10.0, deadline_rounds=3))
        req, expired = s.pop(round_idx=5, now=2.0)
        assert req.request_id == 1
        assert sorted(r.request_id for r in expired) == [0, 2]
        assert all(r.status == "timeout" and r.finish_round == 5
                   for r in expired)
        assert len(s) == 0

    def test_push_assigns_sequence_once(self):
        s = Scheduler()
        first = _req(0, "batch")
        s.push(first)
        s.push(_req(1, "batch"))
        popped, _ = s.pop(0, now=0.0)
        assert popped is first and first.sched_seq == 0
        s.push(first)
        assert first.sched_seq == 0
        assert s.pop(0, now=0.0)[0] is first

    def test_preempt_candidate_rank_order(self):
        s = Scheduler()
        assert s.preempt_candidate(now=0.0) is None
        s.push(_req(0, "batch"))
        assert s.preempt_candidate(now=0.0) is None
        it = _req(1, "interactive")
        s.push(it)
        assert s.preempt_candidate(now=0.0) is it
        assert len(s) == 2

    def test_victim_order_prefers_lowest_priority_most_work(self):
        s = Scheduler()
        cands = [(_req(0, "batch"), 30), (_req(1, "batch"), 90),
                 (_req(2, "best_effort"), 5), (_req(3, "interactive"), 99)]
        order = s.victim_order(cands, requester_rank=0)
        assert [r.request_id for r, _ in order] == [2, 1, 0]
        order = s.victim_order(cands, requester_rank=1)
        assert [r.request_id for r, _ in order] == [2]
        tie = s.victim_order([(_req(7, "batch"), 30),
                              (_req(4, "batch"), 30)], requester_rank=0)
        assert [r.request_id for r, _ in tie] == [7, 4]

    def test_spawn_successor_carries_policy_not_heaps(self):
        s = Scheduler(classes=(ClassSpec("gold", 0, quota=2,
                                         can_preempt=True),
                               ClassSpec("bulk", 3)),
                      default_class="bulk", preempt_margin=2.5,
                      max_preempts_per_round=4)
        s.push(_req(0, "gold"))
        succ = s.spawn_successor()
        assert len(succ) == 0 and len(s) == 1
        assert succ.default_class == "bulk"
        assert succ.preempt_margin == 2.5
        assert succ.max_preempts_per_round == 4
        assert [c.name for c in succ.by_rank] == ["gold", "bulk"]

    def test_summary_and_queued_by_class(self):
        s = Scheduler()
        s.push(_req(0, "batch"))
        s.push(_req(1, "batch"))
        assert s.queued_by_class() == {"interactive": 0, "batch": 2,
                                       "best_effort": 0}
        summ = s.summary()
        assert summ["default_class"] == "interactive"
        assert [c["name"] for c in summ["classes"]] == \
            ["interactive", "batch", "best_effort"]
        (batch,) = [c for c in summ["classes"] if c["name"] == "batch"]
        assert batch["queued"] == 2 and batch["preemptible"] is True

    def test_metrics_recorders(self):
        reg = MetricsRegistry()
        s = Scheduler(registry=reg)
        s.note_admitted(_req(0, "interactive"), queue_wait_s=0.2)
        s.note_admitted(_req(1, "interactive"), queue_wait_s=5.0)
        assert reg.histogram("serving_sched_queue_wait_seconds",
                             cls="interactive").summary()["count"] == 2
        s.note_timeout(_req(2, "interactive"))
        s.note_timeout(_req(3, "batch"))
        assert reg.counter("serving_sched_slo_miss_total",
                           cls="interactive").value == 2
        s.note_preempt(_req(4, "batch"))
        s.note_resume(_req(4, "batch"))
        s.note_preempt_abort("cost_gate")
        assert reg.counter("serving_sched_preemptions_total",
                           cls="batch").value == 1
        assert reg.counter("serving_sched_resumes_total",
                           cls="batch").value == 1
        assert reg.counter("serving_sched_preempt_aborts_total",
                           reason="cost_gate").value == 1
        s.push(_req(5, "batch"))
        s.mirror_queued()
        assert reg.gauge("serving_sched_class_queued",
                         cls="batch").value == 1.0

    def test_queue_delegates_order_and_hooks_expiry(self):
        # The queue keeps backpressure and deadlines; the scheduler
        # orders; every drop reaches on_expire, outside the lock.
        dropped = []
        q = AdmissionQueue(max_pending=3, scheduler=Scheduler(),
                           on_expire=dropped.append)
        q.submit(_req(0, "batch"))
        q.submit(_req(1, "interactive", submit=0.0))
        q.submit(_req(2, "batch", deadline_time=0.1))  # the batch head
        with pytest.raises(Exception, match="max_pending"):
            q.submit(_req(3, "batch"))
        with pytest.raises(ValueError, match="unknown scheduling class"):
            AdmissionQueue(scheduler=Scheduler()).submit(_req(4, "gold"))
        assert q.peek_urgent().request_id == 1 and len(q) == 3
        req, expired = q.pop_ready(round_idx=1, now=0.5,
                                   occupancy={"batch": 1})
        assert req.request_id == 1 and expired == []
        req, expired = q.pop_ready(round_idx=1, now=0.5)
        assert req.request_id == 0  # FIFO within the class by sequence
        assert [r.request_id for r in expired] == [2]
        assert [r.request_id for r in dropped] == [2]
        q.push_front(req)
        assert q.pop_ready(round_idx=1)[0] is req
        assert AdmissionQueue().peek_urgent() is None


class TestAgainstTheJaxScheduler:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_pop_and_victim_order_equal_the_jax_scheduler(self, seed):
        rng = np.random.default_rng(seed)
        classes = [("interactive", "batch", "best_effort")[i]
                   for i in rng.integers(0, 3, 40)]
        mix = []
        for i, cls in enumerate(classes):
            dl = float(rng.uniform(0, 12)) if rng.random() < 0.5 else None
            rd = int(rng.integers(0, 8)) if rng.random() < 0.2 else None
            mix.append(dict(rid=i, cls=cls, submit=float(rng.uniform(0, 5)),
                            deadline_time=dl, deadline_rounds=rd))
        from marlin_tpu.serving.sched import ClassSpec as JaxClassSpec

        pops = []
        for make_sched, make_req, make_spec in (
                (Scheduler, Request, ClassSpec),
                (JaxScheduler, JaxRequest, JaxClassSpec)):
            s = make_sched(classes=(
                make_spec("interactive", 0, quota=2, slo_s=1.0,
                          preemptible=False, can_preempt=True),
                make_spec("batch", 1, quota=3),
                make_spec("best_effort", 2)))
            reqs = [_req(m["rid"], m["cls"], m["submit"], m["deadline_time"],
                         m["deadline_rounds"], make=make_req) for m in mix]
            for r in reqs[:25]:
                s.push(r)
            seq = []
            for t in range(30):
                if t == 10:
                    for r in reqs[25:]:
                        s.push(r)
                cand = s.preempt_candidate(now=float(t))
                req, expired = s.pop(t // 3, now=float(t) * 0.6,
                                     occupancy={"interactive": t % 3,
                                                "batch": t % 4})
                seq.append((None if cand is None else cand.request_id,
                            None if req is None else req.request_id,
                            [r.request_id for r in expired]))
            remaining = np.random.default_rng(seed + 9).integers(0, 50, 40)
            cands = [(r, int(n)) for r, n in zip(reqs, remaining)]
            victims = [[r.request_id for r, _ in s.victim_order(cands, rank)]
                       for rank in (0, 1, 2)]
            pops.append((seq, victims))
        assert pops[0] == pops[1]


class TestPreemptCostModel:
    def test_preempt_cost_is_round_trip_restore(self):
        cfg = _cfg()
        _, one_way = cm.restore_cost(cfg, 64)
        flops, rt = cm.preempt_cost(cfg, 64)
        assert flops == 0.0 and rt == 2.0 * one_way

    def test_beneficial_monotone_in_remaining_work(self):
        cfg = _cfg()
        assert not cm.preempt_beneficial(cfg, 64, 0)
        assert not cm.preempt_beneficial(cfg, 64, -3)
        assert cm.preempt_beneficial(cfg, 16, 1000)
        assert cm.preempt_beneficial(cfg, 64, 4096, margin=1.0)
        assert not cm.preempt_beneficial(cfg, 64, 4096, margin=1e9)

    def test_gate_disabled_by_nonpositive_margin(self):
        assert not Scheduler(preempt_margin=0.0).preempt_gate(_cfg(), 64,
                                                              10_000)
        assert Scheduler(preempt_margin=1.0).preempt_gate(_cfg(), 16, 10_000)


_VARIANTS = {
    "plain": ({}, False),
    "rope_gqa": ({"rope": True, "n_kv_heads": 1}, False),
    "int8": ({"kv_quant": "int8"}, False),
    "spec": ({}, True),
}


def _prompts(cfg):
    rng = np.random.default_rng(3)
    return [rng.integers(1, cfg.vocab, 9) for _ in range(3)]


def _staggered_run(cfg_kw, spec, sched, *, scheduler=None, steps0=40,
                   steps1=40, deadline_rounds=None, host_kv_bytes=1 << 24,
                   params=None, **engine_kw):
    """Two long batch-class jobs fill both rows, three rounds pass, an
    interactive request arrives (the scheduler arm preempts a victim).
    Returns ({rid: tokens}, statuses, debug_sched, host tier summary,
    engine)."""
    cfg = _cfg(**cfg_kw)
    if params is None:
        params = pt.init_params(cfg, seed=0, device="cpu")
    engine_kw.setdefault("metrics_registry", MetricsRegistry())
    eng = ServingEngine(
        params, cfg, batch=2, round_steps=4, seed=7, kv_pages=24,
        host_kv_bytes=host_kv_bytes,
        spec_draft_lens=(4,) if spec else None,
        scheduler=(scheduler if scheduler is not None
                   else (Scheduler() if sched else None)),
        device="cpu", **engine_kw)
    prompts = _prompts(cfg)
    kw = (lambda c: {"sched_class": c}) if sched else (lambda c: {})
    eng.submit(prompts[0], steps0, request_id=0,
               deadline_rounds=deadline_rounds, **kw("batch"))
    eng.submit(prompts[1], steps1, request_id=1, **kw("batch"))
    out, status = {}, {}

    def collect():
        for r in eng.step():
            out[r.request_id] = (r.tokens.tolist()
                                 if r.tokens is not None else None)
            status[r.request_id] = r.status

    for _ in range(3):
        collect()
    eng.submit(prompts[2], 6, request_id=2, **kw("interactive"))
    for _ in range(400):
        collect()
        if len(out) == 3:
            break
    snap = eng.debug_sched()
    host = eng.host_tier.summary()
    eng.close()
    return out, status, snap, host, eng


class TestBitExactPreemption:
    @pytest.mark.parametrize("name", list(_VARIANTS))
    def test_preempted_equals_uninterrupted(self, name):
        cfg_kw, spec = _VARIANTS[name]
        on, st_on, snap, host, _ = _staggered_run(cfg_kw, spec, sched=True)
        off, _, _, _, _ = _staggered_run(cfg_kw, spec, sched=False)
        assert on == off, f"preemption moved tokens ({name})"
        assert st_on == {0: "done", 1: "done", 2: "done"}
        assert snap["preempts"] >= 1 and snap["resumes"] == snap["preempts"]
        assert host["host_rows"] == 0 and host["host_row_bytes"] == 0

    def test_sampled_stream_survives_the_freeze(self):
        # At temperature > 0 the frozen row's generator goes to the host
        # with its pages and comes back at the thaw.
        on, _, snap, _, _ = _staggered_run({}, False, sched=True,
                                           temperature=0.8)
        off, _, _, _, _ = _staggered_run({}, False, sched=False,
                                         temperature=0.8)
        assert snap["preempts"] >= 1 and snap["resumes"] >= 1
        assert on == off
        greedy, _, _, _, _ = _staggered_run({}, False, sched=False)
        assert greedy != off  # it did sample

    def test_cost_gate_abort_is_clean(self):
        reg = MetricsRegistry()
        on, _, snap, _, _ = _staggered_run(
            {}, False, sched=True,
            scheduler=Scheduler(preempt_margin=0.0, registry=reg),
            metrics_registry=reg)
        off, _, _, _, _ = _staggered_run({}, False, sched=False)
        assert on == off
        assert snap["preempts"] == 0 and snap["resumes"] == 0
        assert reg.counter("serving_sched_preempt_aborts_total",
                           reason="cost_gate").value >= 1

    def test_host_budget_refusal_aborts_preemption(self):
        reg = MetricsRegistry()
        on, _, snap, host, _ = _staggered_run(
            {}, False, sched=True, scheduler=Scheduler(registry=reg),
            host_kv_bytes=4096, metrics_registry=reg)
        off, _, _, _, _ = _staggered_run({}, False, sched=False)
        assert on == off
        assert snap["preempts"] == 0
        assert host["host_rows"] == 0 and host["host_row_bytes"] == 0
        assert reg.counter("serving_sched_preempt_aborts_total",
                           reason="host_budget").value >= 1

    def test_frozen_request_dropped_for_deadline_releases_row(self):
        # Request 0 (the most remaining work: the victim) is frozen, its
        # round deadline passes in the queue, and the drop must release
        # its pinned host row.
        out, status, snap, host, _ = _staggered_run(
            {}, False, sched=True, steps0=50, steps1=30,
            deadline_rounds=4)
        assert status == {0: "timeout", 1: "done", 2: "done"}
        assert out[0] is None
        assert snap["preempts"] >= 1 and snap["resumes"] == 0
        assert host["host_rows"] == 0, "pinned row leaked on expiry"
        assert host["host_row_bytes"] == 0

    def test_preemption_is_observable(self):
        reg = MetricsRegistry()
        runlog = RunLog(maxlen=4096)
        out, _, snap, _, eng = _staggered_run(
            {}, False, sched=True, scheduler=Scheduler(registry=reg),
            metrics_registry=reg, runlog=runlog)
        assert snap["preempts"] >= 1 and snap["resumes"] >= 1
        frz, thaw = runlog.events("preempt"), runlog.events("resume")
        assert len(frz) == snap["preempts"] and len(thaw) == snap["resumes"]
        assert all(e["bytes"] > 0 and e["spill_s"] >= 0 and e["filled"] > 0
                   and e["pages"] >= 1 for e in frz)
        assert all(e["frozen_rounds"] >= 1 and e["restore_s"] >= 0
                   for e in thaw)
        rounds = runlog.events("round")
        assert sum(e.get("preempts", 0) for e in rounds) == snap["preempts"]
        assert sum(e.get("resumes", 0) for e in rounds) == snap["resumes"]
        assert reg.counter("serving_sched_preemptions_total",
                           cls="batch").value == snap["preempts"]
        assert reg.counter("serving_kv_row_spills_total").value == \
            snap["preempts"]
        assert reg.counter("serving_kv_row_restores_total").value == \
            snap["resumes"]
        assert reg.counter("serving_preempted_total").value == \
            snap["preempts"]
        assert reg.counter("serving_resumed_total").value == snap["resumes"]
        assert reg.histogram("serving_sched_queue_wait_seconds",
                             cls="interactive").summary()["count"] >= 1
        summary = eng.stats.summary()
        assert summary["preempted"] == summary["resumed"] == snap["preempts"]
        assert [e["sched_class"] for e in runlog.events("submit")] == \
            ["batch", "batch", "interactive"]

    def test_debug_sched_surfaces_frozen_rows(self):
        cfg = _cfg()
        params = pt.init_params(cfg, seed=0, device="cpu")
        eng = ServingEngine(params, cfg, batch=2, round_steps=4, seed=7,
                            kv_pages=24, host_kv_bytes=1 << 24,
                            scheduler=Scheduler(), device="cpu",
                            metrics_registry=MetricsRegistry())
        prompts = _prompts(cfg)
        eng.submit(prompts[0], 40, request_id=0, sched_class="batch",
                   tenant="bulk-co")
        eng.submit(prompts[1], 40, request_id=1, sched_class="batch",
                   tenant="bulk-co")
        for _ in range(3):
            eng.step()
        eng.submit(prompts[2], 6, request_id=2, sched_class="interactive",
                   tenant="chat-co")
        seen = None
        for _ in range(50):
            eng.step()
            snap = eng.debug_sched()
            if snap["frozen"]:
                seen = snap
                break
        assert seen is not None, "never observed a frozen row"
        (fz,) = seen["frozen"]
        assert fz["sched_class"] == "batch" and fz["tenant"] == "bulk-co"
        assert fz["filled"] > 0 and fz["bytes"] > 0
        assert fz["preempt_count"] == 1
        assert seen["host_rows"] == 1
        assert seen["host_row_bytes"] == fz["bytes"]
        assert seen["can_preempt"] is True
        assert sum(seen["occupancy"].values()) >= 1
        plain = ServingEngine(params, cfg, batch=2, kv_pages=24,
                              device="cpu",
                              metrics_registry=MetricsRegistry())
        assert plain.debug_sched() is None

    def test_submit_ids_and_classes(self):
        cfg = _cfg()
        eng = ServingEngine(pt.init_params(cfg, seed=0, device="cpu"), cfg,
                            batch=2, kv_pages=24, scheduler=Scheduler(),
                            device="cpu", metrics_registry=MetricsRegistry())
        assert eng.submit(np.arange(4), 2, request_id=5) == 5
        assert eng.submit(np.arange(4), 2) == 6  # past the explicit id
        assert eng.requests[6].sched_class == "interactive"  # the default
        assert eng.requests[5].tenant == "default"
        for bad, match in (({"request_id": 5}, "in use"),
                           ({"request_id": -1}, ">= 0"),
                           ({"sched_class": "gold"}, "unknown")):
            with pytest.raises(ValueError, match=match):
                eng.submit(np.arange(4), 2, **bad)
        assert len(eng.queue) == 2  # the refused submits left no trace
        # Without a tier a scheduler orders admission but never freezes.
        assert not eng._can_preempt

    @pytest.mark.parametrize("site", ["preempt_spill", "kv_restore"])
    def test_fault_sites_fire_at_the_freeze_and_the_thaw(self, site):
        plan = faults.install(faults.FaultPlan())
        try:
            spec = plan.add(site=site)
            with pytest.raises(faults.FaultInjected):
                _staggered_run({}, False, sched=True)
            assert spec.fires == 1
        finally:
            faults.reset()


@pytest.fixture(scope="module")
def jax_staggered():
    """The JAX engine on the staggered workload (plain model, greedy), run
    once: its tokens and its freeze and thaw events."""
    jcfg = jt.TransformerConfig(**_cfg()._asdict())
    jparams = jt.init_params(jcfg, seed=0)
    eng = JaxEngine(jparams, jcfg, batch=2, round_steps=4, seed=7,
                    kv_pages=24, host_kv_bytes=1 << 24,
                    scheduler=JaxScheduler(), metrics_registry=JaxRegistry())
    prompts = [p.astype(np.int32) for p in _prompts(jcfg)]
    eng.submit(prompts[0], 40, request_id=0, sched_class="batch")
    eng.submit(prompts[1], 40, request_id=1, sched_class="batch")
    out = {}
    for _ in range(3):
        out.update({r.request_id: np.asarray(r.tokens) for r in eng.step()})
    eng.submit(prompts[2], 6, request_id=2, sched_class="interactive")
    for _ in range(400):
        out.update({r.request_id: np.asarray(r.tokens) for r in eng.step()})
        if len(out) == 3:
            break
    return dict(jcfg=jcfg, jparams=jparams, prompts=prompts, tokens=out,
                preempt=eng.runlog.events("preempt"),
                resume=eng.runlog.events("resume"))


def test_staggered_rounds_and_tokens_match_the_jax_engine(jax_staggered):
    j = jax_staggered
    cfg = _cfg()
    params = convert.params_from_jax(jax.tree.map(np.asarray, j["jparams"]),
                                     cfg, device="cpu")
    runlog = RunLog()
    out, _, _, _, _ = _staggered_run({}, False, sched=True, params=params,
                                     runlog=runlog)

    def marks(events):
        return [(e["round"], e["request_id"], e["filled"], e["pages"])
                for e in events]

    assert marks(runlog.events("preempt")) == marks(j["preempt"])
    assert marks(runlog.events("resume")) == marks(j["resume"])
    assert [e["bytes"] for e in runlog.events("preempt")] == \
        [e["bytes"] for e in j["preempt"]]
    for rid, prompt in enumerate(j["prompts"]):
        ref, got = j["tokens"][rid], np.asarray(out[rid])
        if (ref == got).all():
            continue
        k = int(np.argmin(ref == got))
        seq = np.concatenate([prompt, ref[:k]])[None]
        lg = np.sort(np.asarray(jt.forward(
            j["jparams"], jnp.asarray(seq, jnp.int32), j["jcfg"]))[0, -1])
        assert lg[-1] - lg[-2] <= 1e-4, \
            f"request {rid} diverges at token {k} off a near-tie"
