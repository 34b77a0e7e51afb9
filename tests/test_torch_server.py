"""The port's HTTP server (marlin_tpu_torch/serving/server.py over the
supervised EngineFrontend), twins of tests/test_frontend.py's
TestHTTPServer, TestClientMultiTarget::test_failover_lands_on_live_target,
TestBaselineMetricConsistency and TestSigtermSubprocess, of
tests/test_faults.py's TestHTTPFailureSurface, TestStreamAbandon,
TestClientRetry::test_retry_rides_a_real_429 and TestChaosSubprocessSmoke,
and of tests/test_runlog_report.py's TestRealEngineRunlog. Every call goes
through the JAX package's ``tools/serving_client.py`` and is read by its
``tools/runlog_report.py``, both unchanged.

Inside the port, bitwise on the CPU: a response's tokens equal an
in-process run of the same prompts; a streamed sequence equals the
blocking array; a request replayed after a crash (in a subprocess armed
through ``MARLIN_FAULT_PLAN``) equals the clean run. Against the JAX
package: its engine's greedy tokens on the same weights
(``params_from_jax``) agree up to a top-2 logit margin of 1e-4 where they
differ (tests/test_torch_serving.py's tolerance).

Every server binds 127.0.0.1 port 0 and runs on daemon threads
(``start_background``), and is torn down with ``close_now`` or a drain;
every client call and handle wait has a timeout. The 429s are made
deterministic by filling the queue before the driver starts. The two
subprocess tests each start one server child (one thread, its own
session), waited on with ``communicate(timeout=60)`` and its process group
killed in ``finally``; no signal handler is installed here. The bench
smoke (TestHTTPBenchSmoke) waits for the port's benchmark.
"""

import http.client
import importlib.util
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import jax.numpy as jnp

from marlin_tpu.models import transformer as jt
from marlin_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from marlin_tpu.serving import ServingEngine as JaxEngine
from marlin_tpu_torch.models import transformer as pt
from marlin_tpu_torch.obs.metrics import MetricsRegistry
from marlin_tpu_torch.obs.runlog import RunLog
from marlin_tpu_torch.serving import (EngineFrontend, MatrixService,
                                      Scheduler, ServingEngine,
                                      ServingHTTPServer, faults, serve)
from marlin_tpu_torch.serving.jobs import validate_job
# The shared fixtures: the model on both frameworks, one torch thread,
# the plans reset.
from test_torch_faults import (JOIN_S, _clean_plan,  # noqa: F401
                               _one_torch_thread, _prompts, model)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_S = 60.0  # the longest a test waits on a server child


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    # Registered before exec: its dataclasses resolve annotations there.
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def client_mod():
    return _load_tool("serving_client")


@pytest.fixture(scope="module")
def rr():
    return _load_tool("runlog_report")


@pytest.fixture(scope="module")
def http_server(model):
    params, cfg, _, _ = model
    srv = serve(params, cfg, port=0, batch=2, round_steps=4,
                max_pending=8, seed=0, device="cpu").start_background()
    yield srv
    srv.close_now()


def _client(client_mod, port, **kw):
    kw.setdefault("timeout", JOIN_S)
    return client_mod.ServingClient(port=port, **kw)


def _golden(params, cfg, prompts, steps, **eng_kw):
    eng_kw.setdefault("metrics_registry", MetricsRegistry())
    eng = ServingEngine(params, cfg, device="cpu", **eng_kw)
    for p in prompts:
        eng.submit(p, steps)
    return {r.request_id: list(map(int, r.tokens)) for r in eng.run()}


def _jax_agrees(model, prompts, steps, tokens, **eng_kw):
    """The JAX engine's greedy tokens for ``prompts`` against the port's
    ``tokens`` (by prompt index): equal, or, at the first difference, a
    JAX top-2 logit margin of at most 1e-4."""
    _, _, jparams, jcfg = model
    jeng = JaxEngine(jparams, jcfg, metrics_registry=JaxRegistry(),
                     **eng_kw)
    for p in prompts:
        jeng.submit(p, steps)
    want = {r.request_id: np.asarray(r.tokens) for r in jeng.run()}
    for i, p in enumerate(prompts):
        got = np.asarray(tokens[i])
        if (got == want[i]).all():
            continue
        j = int(np.argmin(got == want[i]))
        seq = np.concatenate([p, want[i][:j]])[None]
        logits = np.sort(np.asarray(jt.forward(
            jparams, jnp.asarray(seq, jnp.int32), jcfg))[0, -1])
        assert logits[-1] - logits[-2] <= 1e-4, (i, j)


def _wait_for(pred, what):
    deadline = time.perf_counter() + JOIN_S
    while not pred():
        if time.perf_counter() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def _unstarted(model, **eng_kw):
    """An HTTP server over a frontend whose driver has not started:
    requests queue, nothing runs until ``fe.start()``."""
    params, cfg, _, _ = model
    eng = ServingEngine(params, cfg, seed=0, device="cpu",
                        metrics_registry=MetricsRegistry(), **eng_kw)
    fe = EngineFrontend(eng)
    return fe, ServingHTTPServer(("127.0.0.1", 0), fe).start_background()


class TestHTTPServer:
    def test_blocking_request_matches_golden(self, http_server, model,
                                             client_mod):
        params, cfg, _, _ = model
        prompts = _prompts(cfg, 2, seed=7)
        gold = _golden(params, cfg, prompts, 4, batch=2, round_steps=4)
        c = _client(client_mod, http_server.port)
        r = c.generate(prompts[0], 4, request_id="my-id-123")
        assert r["code"] == 200 and r["status"] == "done"
        assert r["tokens"] == gold[0]
        assert r["emitted"] == 4
        assert r["x_request_id"] == "my-id-123"  # the caller's id echoed
        assert r["x_engine_request_id"] is not None
        r2 = c.generate(prompts[1], 4)
        assert r2["x_request_id"] == r2["x_engine_request_id"]
        assert r2["tokens"] == gold[1]
        _jax_agrees(model, prompts, 4, [r["tokens"], r2["tokens"]],
                    batch=2, round_steps=4)
        trace = [e for e in http_server.runlog.events("trace_ctx")
                 if e.get("http_id") == "my-id-123"]
        assert trace and trace[0]["request_id"] == int(
            r["x_engine_request_id"])

    def test_streaming_bitexact_with_blocking(self, http_server, model,
                                              client_mod):
        params, cfg, _, _ = model
        prompt = _prompts(cfg, 1, seed=11)[0]
        c = _client(client_mod, http_server.port)
        st = c.stream(prompt, 6)
        bl = c.generate(prompt, 6)
        assert st["code"] == bl["code"] == 200
        assert st["tokens"] == bl["tokens"]
        assert st["tokens"] == _golden(params, cfg, [prompt], 6, batch=2,
                                       round_steps=4)[0]
        assert st["status"] == "done" and st["emitted"] == 6
        assert st["ttft_s"] > 0
        assert len(st["chunks"]) >= 1

    def test_metrics_healthz_readyz(self, http_server, client_mod):
        c = _client(client_mod, http_server.port)
        c.generate([1, 2, 3], 2)
        m = c.metrics()
        assert m["code"] == 200
        for series in ("serving_http_requests_total",
                       "serving_http_ttft_seconds",
                       "serving_ttft_seconds", "serving_queue_depth"):
            assert series in m["text"], series
        assert any(k.startswith("serving_http_responses_total")
                   for k in m["samples"])
        assert "# TYPE serving_http_requests_total counter" in m["text"]
        assert c.healthz()["code"] == 200
        rz = c.readyz()
        assert rz["code"] == 200 and rz["ready"] and rz["driver_alive"]
        assert "tp_degree" not in rz

    def test_timing_block_attributes_latency(self, http_server, model,
                                             client_mod):
        c = _client(client_mod, http_server.port)
        prompt = _prompts(model[1], 1, seed=21)[0]
        r = c.generate(prompt, 4)
        assert r["code"] == 200
        t = r["timing"]
        for k in ("queue_wait_s", "admit_s", "decode_s", "total_s",
                  "http_total_s"):
            assert k in t, t
        contiguous = t["queue_wait_s"] + t["admit_s"] + t["decode_s"]
        assert contiguous == pytest.approx(t["total_s"], abs=5e-6)
        assert t["http_total_s"] >= t["total_s"] - 5e-3  # one clock
        st = c.stream(prompt, 4)
        assert st["code"] == 200
        ts = st["timing"]
        assert ts["queue_wait_s"] + ts["admit_s"] + ts["decode_s"] \
            == pytest.approx(ts["total_s"], abs=5e-6)
        assert "http_ttft_s" in ts and "stream_delivery_s" in ts
        m = c.metrics()
        assert 'serving_phase_seconds_bucket{phase="decode"' in m["text"]
        assert "# HELP serving_phase_seconds" in m["text"]
        assert "# HELP cost_model_drift_ratio" in m["text"]

    def test_debug_endpoints(self, http_server, model, client_mod):
        c = _client(client_mod, http_server.port)
        r = c.generate(_prompts(model[1], 1, seed=23)[0], 3)
        assert r["code"] == 200
        code, body, _ = c._get("/debug/engine")
        assert code == 200
        dbg = json.loads(body)
        assert dbg["batch"] == 2 and dbg["round"] > 0
        assert dbg["frontend"]["alive"] is True
        assert "cost_model_drift" in dbg and "stats" in dbg
        assert dbg["stats"]["completed"] >= 1
        assert "matrix" not in dbg
        code, body, _ = c._get(f"/debug/requests/{r['request_id']}")
        assert code == 200
        info = json.loads(body)
        assert info["status"] == "done"
        ph = info["phases"]
        assert ph["queue_wait"] + ph["admit"] + ph["decode"] \
            == pytest.approx(ph["total"], rel=1e-6, abs=1e-9)
        assert c._get("/debug/requests/987654")[0] == 404
        assert c._get("/debug/requests/not-an-id")[0] == 400
        assert c._get("/debug/sched")[0] == 404  # a FIFO engine
        # The tracer's surface waits for ROADMAP Queue A5.
        for path in ("/debug/trace", "/debug/trace?exemplars=1"):
            code, body, _ = c._get(path)
            assert code == 501
            assert "ROADMAP Queue A5" in json.loads(body)["error"]

    @pytest.mark.parametrize("flag", [["--trace"],
                                      ["--trace-export", "t.json"],
                                      ["--trace-sample", "0.5"]])
    def test_trace_flags_are_refused(self, flag, capsys):
        from marlin_tpu_torch.serving import server

        with pytest.raises(SystemExit) as ei:
            server.main(["--force-cpu", *flag])
        assert ei.value.code == 2
        assert "ROADMAP Queue A5" in capsys.readouterr().err

    def test_bad_requests_map_to_400_and_404(self, http_server,
                                             client_mod):
        c = _client(client_mod, http_server.port)
        r = c.generate([1, 2, 3], 10_000)  # past max_len: the engine's 400
        assert r["code"] == 400 and "error" in r
        conn = http.client.HTTPConnection("127.0.0.1", http_server.port,
                                          timeout=JOIN_S)
        try:
            conn.request("POST", "/v1/generate", b"{not json",
                         {"Content-Type": "application/json"})
            assert conn.getresponse().status == 400
        finally:
            conn.close()
        assert c._get("/nope")[0] == 404
        assert c.matrix("gemm", [4, 4, 4], seed=1)["code"] == 404

    def test_queue_full_maps_to_429_with_retry_after(self, model,
                                                     client_mod):
        """One pending slot, filled before the driver starts: the next
        request is shed with 429 and Retry-After; the queued one
        completes once the driver runs."""
        fe, srv = _unstarted(model, batch=1, round_steps=4, max_pending=1)
        prompts = _prompts(model[1], 2, seed=3)
        first = {}
        t = threading.Thread(target=lambda: first.update(
            _client(client_mod, srv.port).generate(prompts[0], 8)))
        try:
            t.start()
            _wait_for(lambda: len(fe.engine.queue) == 1, "the queued one")
            shed = _client(client_mod, srv.port).generate(prompts[1], 8)
            assert shed["code"] == 429
            assert shed["retry_after"] is not None
            fe.start()
            t.join(JOIN_S)
            assert first["code"] == 200 and len(first["tokens"]) == 8
            again = _client(client_mod, srv.port).generate(prompts[1], 8)
            assert again["code"] == 200
        finally:
            srv.close_now()

    def test_drain_completes_in_flight_and_503s_new(self, model,
                                                    client_mod):
        params, cfg, _, _ = model
        srv = serve(params, cfg, port=0, batch=2, round_steps=2,
                    max_pending=8, seed=0, device="cpu",
                    metrics_registry=MetricsRegistry()).start_background()
        c = _client(client_mod, srv.port)
        prompt = _prompts(cfg, 1, seed=5)[0]
        stream_res, drained = {}, {}
        st = threading.Thread(
            target=lambda: stream_res.update(c.stream(prompt, 40)))
        dt = threading.Thread(
            target=lambda: drained.update(ok=srv.begin_drain(JOIN_S)))
        try:
            st.start()
            _wait_for(lambda: srv.frontend.engine.stats.n_admitted >= 1,
                      "the stream's admission")
            dt.start()
            _wait_for(lambda: srv.frontend.draining, "the drain")
            try:
                r = c.generate(prompt, 2)
                assert r["code"] == 503, r
                assert r["retry_after"] is not None
            except (ConnectionError, OSError):
                pass  # late in the drain the listener is already down
            st.join(JOIN_S)
            dt.join(JOIN_S)
        finally:
            srv.close_now()
        assert drained.get("ok") is True
        assert stream_res["code"] == 200 and stream_res["status"] == "done"
        assert stream_res["emitted"] == 40
        assert len(stream_res["tokens"]) == 40
        assert srv.runlog.events("drain_complete")
        assert srv.runlog.events("http_drain_begin")


class TestClientMultiTarget:
    def test_failover_lands_on_live_target(self, http_server, model,
                                           client_mod):
        import socket

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        dead_port = s.getsockname()[1]
        s.close()
        params, cfg, _, _ = model
        prompts = _prompts(cfg, 2, seed=7)
        gold = _golden(params, cfg, prompts, 4, batch=2, round_steps=4)
        c = client_mod.ServingClient(
            targets=[f":{dead_port}", f":{http_server.port}"],
            timeout=JOIN_S)
        policy = client_mod.RetryPolicy(max_attempts=3, base_delay_s=0.01)
        r = c.generate(prompts[0], 4, retry=policy)
        assert r["code"] == 200 and r["status"] == "done"
        assert r["tokens"] == gold[0]
        assert r["attempts"] == 2  # one dead hit, one live
        assert c.port == http_server.port
        r2 = c.generate(prompts[1], 4)
        assert r2["code"] == 200 and r2["tokens"] == gold[1]


class TestBaselineMetricConsistency:
    def test_every_baseline_metric_name_exists_in_live_registry(
            self, model):
        """Every registry series the committed SLO baseline references
        exists in the port's registry after a smoke workload: paged with
        a host tier and a scheduler, a matrix job, streamed requests."""
        params, cfg, _, _ = model
        reg = MetricsRegistry()
        eng = ServingEngine(params, cfg, batch=2, round_steps=4,
                            metrics_registry=reg, kv_pages=32,
                            host_kv_bytes=1 << 20, scheduler=Scheduler(),
                            device="cpu")
        mx = MatrixService(metrics=reg, device="cpu")
        fe = EngineFrontend(eng, matrix=mx)
        try:
            mh = fe.submit_matrix(validate_job(
                {"op": "gemm", "shapes": [16, 8, 8], "dtype": "float32",
                 "seed": 0}))
            handles = [fe.submit(p, 4, stream=True)
                       for p in _prompts(cfg, 4, seed=31)]
            fe.start()
            for h in handles:
                list(h.chunks(timeout=JOIN_S))
                assert h.result(JOIN_S).status == "done"
            assert mh.result(JOIN_S)[1]["status"] == "done"
            assert fe.drain(JOIN_S)
        finally:
            fe.stop(JOIN_S)
        snap = reg.snapshot()
        with open(os.path.join(_REPO, "tools",
                               "serving_slo_baseline.json")) as f:
            baseline = json.load(f)
        referenced = []
        for key, blocks in baseline.items():
            if key.startswith("_") or not isinstance(blocks, dict):
                continue
            for checks in blocks.values():
                for spec in checks.values():
                    if isinstance(spec, dict) and "histogram" in spec:
                        referenced.append(("histograms",
                                           spec["histogram"]))
                    if isinstance(spec, dict) and "gauge" in spec:
                        referenced.append(("gauges", spec["gauge"]))
        assert referenced
        missing = [f"{kind}:{name}" for kind, name in referenced
                   if name not in snap[kind]]
        assert not missing, (missing, sorted(snap["histograms"]),
                             sorted(snap["gauges"]))


class TestHTTPFailureSurface:
    def test_poison_maps_to_500_and_server_stays_ready(self, model,
                                                       client_mod):
        params, cfg, _, _ = model
        plan = faults.install(faults.FaultPlan())
        plan.add(site="prefill_chunk", request_id=1, max_fires=2)
        srv = serve(params, cfg, port=0, batch=2, round_steps=2,
                    max_pending=8, seed=0, device="cpu",
                    metrics_registry=MetricsRegistry()).start_background()
        try:
            c = _client(client_mod, srv.port)
            prompts = _prompts(cfg, 3, seed=9)
            warm = c.generate(prompts[0], 4)  # id 0
            assert warm["code"] == 200
            poisoned = c.generate(prompts[1], 4)  # id 1: crashes twice
            faults.reset()
            assert poisoned["code"] == 500
            assert poisoned["status"] == "poisoned"
            assert poisoned["request_id"] == 1
            assert poisoned["crash_count"] == 2
            rz = c.readyz()
            assert rz["code"] == 200 and rz["ready"]
            after = c.generate(prompts[2], 4)
            assert after["code"] == 200 and after["status"] == "done"
            gold = _golden(params, cfg, [prompts[0], prompts[2]], 4,
                           batch=2, round_steps=2)
            assert [warm["tokens"], after["tokens"]] == [gold[0], gold[1]]
            samples = c.metrics()["samples"]
            assert samples["serving_engine_restarts_total"] == 2
            assert samples["serving_requests_quarantined_total"] == 1
            code, body, _ = c._get("/debug/engine")
            dbg = json.loads(body)
            assert dbg["frontend"]["restarts"] == 2
            assert dbg["frontend"]["failed"] is False
            assert dbg["stats"]["quarantined"] == 1
        finally:
            faults.reset()
            srv.close_now()

    def test_fail_closed_maps_to_503_and_readyz_503(self, model,
                                                    client_mod):
        params, cfg, _, _ = model
        plan = faults.install(faults.FaultPlan())
        plan.add(site="decode_round", max_fires=10)
        srv = serve(params, cfg, port=0, batch=2, round_steps=2, seed=0,
                    max_restarts=1, device="cpu",
                    metrics_registry=MetricsRegistry()).start_background()
        try:
            c = _client(client_mod, srv.port)
            r = c.generate(_prompts(cfg, 1)[0], 4)
            assert r["code"] == 503 and "failing closed" in r["error"]
            rz = c.readyz()
            assert rz["code"] == 503 and not rz["ready"]
            assert rz["driver_alive"] is False
            assert c.generate(_prompts(cfg, 1)[0], 4)["code"] == 503
        finally:
            faults.reset()
            srv.close_now()


class TestStreamAbandon:
    def test_client_disconnect_abandons_stream_request_completes(
            self, model, client_mod):
        params, cfg, _, _ = model
        reg = MetricsRegistry()
        srv = serve(params, cfg, port=0, batch=2, round_steps=2,
                    max_pending=8, seed=0, device="cpu",
                    metrics_registry=reg).start_background()
        try:
            c = _client(client_mod, srv.port)
            conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                              timeout=JOIN_S)
            body = json.dumps({"prompt": [1, 2, 3, 4], "steps": 40,
                               "stream": True})
            conn.request("POST", "/v1/generate", body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            got = b""
            while b"data: " not in got:  # the first chunk arrived
                got += resp.read1(256)
            conn.close()  # hang up mid-stream

            def settled():
                snap = reg.snapshot()["counters"]
                return (snap.get("serving_streams_abandoned_total", 0) >= 1
                        and snap.get("serving_completed_total", 0) >= 1)

            _wait_for(settled, "the abandoned stream's completion")
            snap = reg.snapshot()["counters"]
            assert snap["serving_streams_abandoned_total"] == 1
            assert snap["serving_completed_total"] == 1
            assert srv.runlog.events("stream_abandoned")
            r = c.generate([1, 2, 3, 4], 4)
            assert r["code"] == 200 and r["status"] == "done"
        finally:
            srv.close_now()


class TestClientRetry:
    def test_retry_rides_a_real_429(self, model, client_mod):
        """The queue's one slot filled before the driver starts: a
        retrying client's first attempt is shed with 429 and a later one
        wins once the driver runs."""
        fe, srv = _unstarted(model, batch=1, round_steps=4, max_pending=1)
        prompts = _prompts(model[1], 2, seed=13)
        policy = client_mod.RetryPolicy(max_attempts=8, base_delay_s=0.2,
                                        budget_s=JOIN_S)
        out = {}
        first = threading.Thread(target=lambda: out.update(
            first=_client(client_mod, srv.port).generate(prompts[0], 8)))
        retried = threading.Thread(target=lambda: out.update(
            retried=_client(client_mod, srv.port).generate(
                prompts[1], 8, retry=policy)))
        try:
            first.start()
            _wait_for(lambda: len(fe.engine.queue) == 1, "the queued one")
            retried.start()
            _wait_for(lambda: fe.metrics.counter(
                "serving_http_responses_total", code="429").value >= 1,
                "the first 429")
            fe.start()
            first.join(JOIN_S)
            retried.join(JOIN_S)
        finally:
            srv.close_now()
        assert out["first"]["code"] == 200
        assert out["retried"]["code"] == 200
        assert out["retried"]["attempts"] > 1
        assert 429 in out["retried"]["retried_codes"]
        assert len(out["retried"]["tokens"]) == 8


class TestRealEngineRunlog:
    def test_engine_drain_runlog_is_clean(self, model, rr, tmp_path):
        params, cfg, _, _ = model
        path = tmp_path / "engine_runlog.jsonl"
        eng = ServingEngine(params, cfg, batch=2, round_steps=4,
                            runlog=RunLog(maxlen=8, path=path),
                            metrics_registry=MetricsRegistry(),
                            device="cpu")
        rng = np.random.default_rng(3)
        for i in range(5):
            eng.submit(rng.integers(0, cfg.vocab, 8), int(2 + i))
        assert len(eng.drain()) == 5
        report = rr.build_report(rr.load_runlog(str(path)))
        assert report["ok"] is True, report["anomalies"]
        assert report["sealed"] is True
        assert report["n_completed"] == 5
        assert report["post_warmup_compiles"] == 0
        assert report["phase_sum_checked"] == 5
        assert report["phase_sum_max_rel_err"] <= 0.01
        assert report["rounds"]["n_rounds"] == eng.stats.n_rounds
        assert report["rounds"]["batch"] == 2
        assert report["ledger"] == json.loads(json.dumps(
            eng.stats.summary(), default=str))


# -- the two server children -------------------------------------------------

_CHILD_ARGS = ["--port", "0", "--force-cpu", "--d-model", "32",
               "--n-layers", "2", "--vocab", "64", "--max-len", "64",
               "--batch", "2", "--round-steps", "2"]


def _child(runlog, plan=None):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("MARLIN_FAULT_PLAN", None)
    if plan is not None:
        env["MARLIN_FAULT_PLAN"] = json.dumps(plan)
    return subprocess.Popen(
        [sys.executable, "-m", "marlin_tpu_torch.serving.server",
         *_CHILD_ARGS, "--runlog", str(runlog)],
        cwd=_REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)


def _child_port(proc) -> int:
    """The port from the child's ``SERVING host=... port=...`` line, read
    with a timeout."""
    line = []
    t = threading.Thread(target=lambda: line.append(proc.stdout.readline()),
                         daemon=True)
    t.start()
    t.join(CHILD_S)
    assert line and line[0].startswith("SERVING "), (
        line, proc.poll())
    return int(line[0].strip().split("port=")[1])


def _kill_group(proc) -> None:
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(10)


def _child_golden(prompts_steps):
    """The child's model (the demo entry's d_ff = 4 d_model, seed 0) in
    process: greedy tokens by prompt."""
    cfg = pt.TransformerConfig(vocab=64, d_model=32, n_heads=2, n_layers=2,
                               d_ff=128, max_len=64, dtype="float32")
    params = pt.init_params(cfg, seed=0, device="cpu")
    eng = ServingEngine(params, cfg, batch=2, round_steps=2,
                        metrics_registry=MetricsRegistry(), device="cpu")
    for p, steps in prompts_steps:
        eng.submit(np.asarray(p, np.int32), steps)
    return {tuple(map(int, r.prompt)): list(map(int, r.tokens))
            for r in eng.run()}


class TestSigtermSubprocess:
    def test_sigterm_drains_and_exits_zero(self, client_mod, rr,
                                           tmp_path):
        runlog = tmp_path / "server_runlog.jsonl"
        proc = _child(runlog)
        try:
            c = _client(client_mod, _child_port(proc), timeout=CHILD_S)
            warm = c.generate(list(range(8)), 2)
            assert warm["code"] == 200
            stream_res = {}
            st = threading.Thread(target=lambda: stream_res.update(
                c.stream(list(range(8)), 24)))
            st.start()

            def in_flight():
                dbg = json.loads(c._get("/debug/engine")[1])
                return dbg["stats"]["admitted"] >= 2 or not st.is_alive()

            _wait_for(in_flight, "the stream's admission")
            proc.send_signal(signal.SIGTERM)
            st.join(CHILD_S)
            out, err = proc.communicate(timeout=CHILD_S)
            assert proc.returncode == 0, err[-800:]
            assert "DRAINED" in out
        finally:
            _kill_group(proc)
        assert stream_res.get("code") == 200, stream_res
        assert stream_res.get("emitted") == 24
        assert stream_res["tokens"] \
            == _child_golden([(list(range(8)), 24)])[tuple(range(8))]
        events = [json.loads(line) for line in
                  runlog.read_text().strip().splitlines()]
        assert events[-1]["kind"] == "drain_complete"
        assert events[-1]["ledger"]["completed"] >= 2
        report = rr.build_report(rr.load_runlog(str(runlog)))
        assert report["ok"] is True, report["anomalies"]
        assert report["anomalies"] == []
        assert report["sealed"] is True
        assert report["post_warmup_compiles"] == 0
        assert report["n_completed"] >= 2
        assert report["phase_sum_checked"] == report["n_completed"]
        assert report["phase_sum_max_rel_err"] <= 0.05


class TestChaosSubprocessSmoke:
    def test_fault_injected_server_recovers_and_runlog_is_clean(
            self, client_mod, rr, tmp_path):
        """A child armed through MARLIN_FAULT_PLAN crashes at round 4 under
        three concurrent streams, recovers, and every stream equals an
        in-process run of the same model; /metrics shows one restart;
        SIGTERM drains clean; the sealed run log passes the crash-cycle
        detector."""
        runlog = tmp_path / "chaos_runlog.jsonl"
        plan = {"specs": [{"site": "decode_round", "round": 4,
                           "action": "raise"}]}
        proc = _child(runlog, plan)
        prompts = [list(map(int, p))
                   for p in _prompts(pt.TransformerConfig(vocab=64), 3,
                                     seed=17)]
        warm_prompt = list(range(8))
        try:
            port = _child_port(proc)
            c = _client(client_mod, port, timeout=CHILD_S)
            warm = c.generate(warm_prompt, 2)
            assert warm["code"] == 200
            results = [None] * 3

            def fire(i):
                results[i] = _client(client_mod, port,
                                     timeout=CHILD_S).stream(prompts[i], 24)

            threads = [threading.Thread(target=fire, args=(i,))
                       for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(CHILD_S)
            samples = c.metrics()["samples"]
            rz = c.readyz()
            proc.send_signal(signal.SIGTERM)
            out, err = proc.communicate(timeout=CHILD_S)
            assert proc.returncode == 0, err[-800:]
            assert "DRAINED" in out
        finally:
            _kill_group(proc)
        gold = _child_golden([(warm_prompt, 2)]
                             + [(p, 24) for p in prompts])
        assert warm["tokens"] == gold[tuple(warm_prompt)]
        for i, res in enumerate(results):
            assert res["code"] == 200, res
            assert res["status"] == "done" and res["emitted"] == 24
            assert res["tokens"] == gold[tuple(prompts[i])], i
        assert samples.get("serving_engine_restarts_total") == 1
        assert samples.get(
            'serving_faults_injected_total{site="decode_round"}') == 1
        assert rz["code"] == 200 and rz["ready"]
        report = rr.build_report(rr.load_runlog(str(runlog)))
        assert report["ok"] is True, report["anomalies"]
        assert report["sealed"] is True
        assert report["n_crashes"] == 1
        assert report["n_recovered"] >= 1
        assert report["n_quarantined"] == 0
        assert report["engine_failed"] is False
        assert report["post_warmup_compiles"] == 0
        assert report["n_completed"] == 4
        assert report["phase_sum_max_rel_err"] <= 0.05
        kinds = [json.loads(line)["kind"]
                 for line in runlog.read_text().strip().splitlines()]
        assert "fault_plan" in kinds  # the arming is on record
        assert kinds[-1] == "drain_complete"
