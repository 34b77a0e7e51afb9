"""The port's matrix-ops job service (marlin_tpu_torch/serving/jobs.py,
``POST /v1/matrix`` of serving/server.py, the frontend's matrix slice),
twins of tests/test_matrix_service.py's TestTypedValidation,
TestExecutorContracts, TestHTTPRoundtrips, TestChaosReplay and
TestClientRetrySemantics.

Against the JAX package, on the same seeded inputs: ``validate_job``
rejects with the same typed codes; ``generate_inputs`` gives the same
bytes for every op and dtype (bfloat16 rounded as ml_dtypes rounds, through
float32); ``matrix_compute`` agrees with the reference's within
the ROADMAP's tolerances, relative to the largest reference value: 1e-10
in float64, 1e-5 in float32, 1e-2 in bfloat16 and for int8 results
dequantized by their scales (a rounding step of the two requantizations
may differ), with LU's ``perm`` equal and singular vectors compared up
to sign.

Within the port, bitwise on the CPU: the HTTP payload decodes to the
in-process ``matrix_compute`` arrays in dtype, shape and bytes, blocking
and streamed alike; the LU executor is ``lu_factor_array(mode="dist",
base_size=base)`` paused between panels; a job crashed mid-way replays
from its seed to the clean bytes. The interleave and the mid-job crash
are made deterministic by queueing everything before the driver starts.
The fleet's job class (TestFleetJobClass) waits for ROADMAP Queue A5, the
bench smoke (TestMatrixSloSmoke) for the port's benchmark.
"""

import http.client
import importlib.util
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from marlin_tpu.serving import jobs as jjobs
from marlin_tpu_torch.linalg.lu import lu_factor_array
from marlin_tpu_torch.obs.metrics import MetricsRegistry
from marlin_tpu_torch.obs.runlog import RunLog
from marlin_tpu_torch.serving import (EngineFrontend, MatrixJobError,
                                      MatrixService, PoisonedRequest,
                                      ServingEngine, ServingHTTPServer,
                                      faults, serve)
from marlin_tpu_torch.serving.jobs import (build_executor, decode_result,
                                           encode_result, executor_quanta,
                                           generate_inputs, matrix_compute,
                                           validate_job)
# The shared fixtures: the model on both frameworks, one torch thread,
# the plans reset.
from test_torch_faults import (JOIN_S, _clean_plan,  # noqa: F401
                               _one_torch_thread, _prompts, model)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def client_mod():
    return _load_tool("serving_client")


@pytest.fixture(scope="module")
def mx_server(model):
    params, cfg, _, _ = model
    srv = serve(params, cfg, port=0, batch=2, round_steps=4,
                max_pending=8, seed=0, matrix=True,
                device="cpu").start_background()
    yield srv
    srv.close_now()


def _client(client_mod, srv):
    return client_mod.ServingClient(port=srv.port, timeout=JOIN_S)


def _wire(x):
    """(dtype name, shape, bytes) of a numpy array, an ml_dtypes bfloat16
    array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return ("bfloat16", tuple(x.shape),
                    x.view(torch.int16).numpy().tobytes())
        x = x.numpy()
    x = np.asarray(x)
    return x.dtype.name, x.shape, x.tobytes()


def _assert_bytes_equal(arrays, ref):
    assert sorted(arrays) == sorted(ref)
    for k in ref:
        got, want = _wire(arrays[k]), _wire(ref[k])
        assert got[:2] == want[:2], (k, got[:2], want[:2])
        assert got[2] == want[2], k


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x, np.float64)


# The nine bodies of the reference's round-trip test.
BODIES = [
    {"op": "gemm", "shapes": [24, 16, 12], "dtype": "float32", "seed": 7},
    {"op": "gemm", "shapes": [24, 16, 12], "dtype": "float64", "seed": 7},
    {"op": "gemm", "shapes": [24, 16, 12], "dtype": "bfloat16", "seed": 7},
    {"op": "gemm", "shapes": [24, 16, 12], "dtype": "int8", "seed": 7},
    {"op": "lu", "shapes": [32], "dtype": "float32", "seed": 8},
    {"op": "cholesky", "shapes": [16], "dtype": "float64", "seed": 9},
    {"op": "spmm", "shapes": [32, 32, 8], "dtype": "float32", "seed": 10},
    {"op": "svd", "shapes": [16, 12], "dtype": "float32", "seed": 11,
     "k": 3},
    {"op": "inverse", "shapes": [12], "dtype": "float32", "seed": 12},
]
_IDS = [f"{b['op']}_{b['dtype']}" for b in BODIES]
TOLERANCE = {"float64": 1e-10, "float32": 1e-5, "bfloat16": 1e-2,
             "int8": 1e-2}


class TestTypedValidation:
    @pytest.mark.parametrize("body,code", [
        ({"op": "qr", "shapes": [4, 4], "dtype": "float32",
          "seed": 1}, "unknown_op"),
        ({"op": "gemm", "shapes": [4, "x", 4], "dtype": "float32",
          "seed": 1}, "bad_shape"),
        ({"op": "gemm", "shapes": [4, 4], "dtype": "float32",
          "seed": 1}, "bad_shape"),
        ({"op": "lu", "shapes": [0], "dtype": "float32",
          "seed": 1}, "bad_shape"),
        ({"op": "gemm", "shapes": [1 << 20, 4, 4], "dtype": "float32",
          "seed": 1}, "shape_overflow"),
        ({"op": "lu", "shapes": [8], "dtype": "int8",
          "seed": 1}, "bad_dtype"),
        ({"op": "gemm", "shapes": [4, 4, 4], "dtype": "float32",
          "seed": "not-an-int"}, "bad_inputs"),
        ({"op": "gemm", "shapes": [4, 4, 4], "dtype": "float32",
          "seed": 1, "payload": {}}, "bad_inputs"),
        ({"op": "svd", "shapes": [8, 8], "dtype": "float32", "seed": 1,
          "k": 99}, "bad_knob"),
    ])
    def test_typed_rejections(self, body, code):
        with pytest.raises(MatrixJobError) as ei:
            validate_job(dict(body))
        assert ei.value.code == code
        assert isinstance(ei.value.detail, dict)
        with pytest.raises(jjobs.MatrixJobError) as ej:
            jjobs.validate_job(dict(body))
        assert ej.value.code == code
        assert ej.value.detail == ei.value.detail

    def test_payload_mismatch_is_typed(self):
        spec = validate_job({"op": "gemm", "shapes": [4, 3, 2],
                             "dtype": "float32", "seed": 0})
        ok = matrix_compute({"op": "gemm", "shapes": [4, 3, 2],
                             "dtype": "float32", "seed": 0}, device="cpu")
        assert spec.op == "gemm" and "c" in ok
        with pytest.raises(MatrixJobError) as ei:
            validate_job({"op": "gemm", "shapes": [4, 3, 2],
                          "dtype": "float32",
                          "payload": {"a": [[1.0, 2.0]],
                                      "b": [[1.0], [2.0]]}})
        assert ei.value.code == "payload_mismatch"

    def test_service_counts_rejections(self):
        reg = MetricsRegistry()
        mx = MatrixService(metrics=reg, device="cpu")
        with pytest.raises(MatrixJobError):
            mx.validate({"op": "qr", "shapes": [4, 4],
                         "dtype": "float32", "seed": 1})
        snap = reg.snapshot()
        assert snap["counters"][
            "serving_matrix_jobs_rejected_total"] == 1

    def test_bf16_payload_rounds_as_the_references_cast(self):
        """A payload's bfloat16 operand is the reference's ml_dtypes cast
        of the same numbers, bit for bit: through float32 (so 1 + 2^-8 +
        2^-30 lands on a tie and rounds to even, 1.0), ties, overflow to
        inf, subnormals, NaN."""
        vals = [1.0 + 2.0 ** -8 + 2.0 ** -30, 1.0 + 2.0 ** -8,
                1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8 + 2.0 ** -30),
                3.0e38, 1.0e-40, -0.0, 0.1, 65504.0, 1e39, float("nan")]
        body = {"op": "gemm", "shapes": [1, 11, 1], "dtype": "bfloat16",
                "payload": {"a": [vals], "b": [[1.0]] * 11}}
        got = validate_job(dict(body)).payload["a"]
        want = jjobs.validate_job(dict(body)).payload["a"]
        assert got.view(torch.int16).numpy().view(np.uint16).tolist() \
            == want.view(np.uint16).tolist()
        assert float(got[0, 0]) == 1.0


class TestExecutorContracts:
    @pytest.mark.parametrize("body", [
        {"op": "gemm", "shapes": [70, 16, 8], "dtype": "float32",
         "seed": 2, "panel": 32},
        {"op": "lu", "shapes": [40], "dtype": "float32", "seed": 2,
         "base": 16},
        {"op": "spmm", "shapes": [64, 32, 8], "dtype": "float32",
         "seed": 2, "nnz_chunk": 17},
        {"op": "cholesky", "shapes": [12], "dtype": "float32",
         "seed": 2},
        {"op": "svd", "shapes": [16, 12], "dtype": "float32",
         "seed": 2, "k": 3},
        {"op": "inverse", "shapes": [10], "dtype": "float32",
         "seed": 2},
    ])
    def test_pricing_and_executor_agree_on_quanta(self, body):
        spec = validate_job(dict(body))
        ex = build_executor(spec, device="cpu")
        assert executor_quanta(spec) == ex.n_quanta
        assert executor_quanta(spec) \
            == jjobs.executor_quanta(jjobs.validate_job(dict(body)))
        steps = 0
        while not ex.done:
            ex.step()
            steps += 1
        assert steps == ex.n_quanta

    @pytest.mark.parametrize("n,base", [(48, 16), (40, 16), (12, 16)])
    def test_lu_executor_matches_library_bytes(self, n, base):
        """The quantum-sliced LU IS ``lu_factor_array(mode="dist")``
        paused between panels (a padded tail at n = 40, the one-call
        route at base >= n)."""
        body = {"op": "lu", "shapes": [n], "dtype": "float32",
                "seed": 5, "base": base}
        out = matrix_compute(dict(body), device="cpu")
        a = generate_inputs(validate_job(dict(body)))["a"]
        packed, perm = lu_factor_array(torch.from_numpy(a), mode="dist",
                                       base_size=base)
        _assert_bytes_equal(out, {"lu": packed, "perm": perm})

    def test_npz_roundtrip_preserves_nonnative_dtypes(self):
        arrays = {
            "x": torch.arange(6, dtype=torch.float32).reshape(2, 3)
            .to(torch.bfloat16) / 3,
            "q": np.array([[-127, 3], [5, 127]], dtype=np.int8),
            "d": np.linspace(0, 1, 5),
        }
        payload = encode_result(dict(arrays), {"op": "t"})
        back, meta = decode_result(payload)
        assert meta["op"] == "t"
        _assert_bytes_equal(back, arrays)
        # The reference's decoder reads the port's payload (ml_dtypes
        # bfloat16 for the tagged array).
        jback, jmeta = jjobs.decode_result(payload)
        assert jmeta == meta
        _assert_bytes_equal(jback, arrays)


class TestAgainstReference:
    @pytest.mark.parametrize("body", BODIES + [
        {"op": "svd", "shapes": [20, 12], "dtype": "float64", "seed": 3},
        {"op": "spmm", "shapes": [40, 24, 8], "dtype": "float64",
         "seed": 4, "density": 0.2},
        {"op": "gemm", "shapes": [8, 40, 4], "dtype": "bfloat16",
         "seed": 0}], ids=_IDS + ["svd_f64", "spmm_f64", "gemm_bf16_b"])
    def test_generate_inputs_is_the_references(self, body):
        got = generate_inputs(validate_job(dict(body)))
        want = jjobs.generate_inputs(jjobs.validate_job(dict(body)))
        _assert_bytes_equal(got, want)

    @pytest.mark.parametrize("body", BODIES, ids=_IDS)
    def test_results_match_the_reference(self, body):
        got = matrix_compute(dict(body), device="cpu")
        want = jjobs.matrix_compute(dict(body))
        assert sorted(got) == sorted(want)
        if body["dtype"] == "int8":
            got = {"c": _f64(got["c"]) * got["c_scale"][:, None]}
            want = {"c": _f64(want["c"]) * want["c_scale"][:, None]}
        if "perm" in want:
            assert np.asarray(got.pop("perm")).tolist() \
                == np.asarray(want.pop("perm")).tolist()
        tol = TOLERANCE[body["dtype"]]
        for k, w in want.items():
            g, w = _f64(got[k]), _f64(w)
            assert g.shape == w.shape, k
            if body["op"] == "svd" and k in ("u", "v"):
                g = g * np.sign(np.sum(g * w, axis=0))  # column signs
            err = np.max(np.abs(g - w)) / np.max(np.abs(w))
            assert err <= tol, (k, err)


class TestHTTPRoundtrips:
    @pytest.mark.parametrize("body", BODIES, ids=_IDS)
    def test_blocking_roundtrip_value_exact(self, mx_server, client_mod,
                                            body):
        res = _client(client_mod, mx_server).matrix(**dict(body))
        assert res["code"] == 200, res
        ref = matrix_compute(dict(body), device="cpu")
        _assert_bytes_equal(res["arrays"], ref)
        arrays, meta = decode_result(res["payload_bytes"])
        _assert_bytes_equal(arrays, ref)
        assert meta == res["meta"]
        assert meta["op"] == body["op"] and meta["status"] == "done"
        assert meta["quanta"] == executor_quanta(validate_job(dict(body)))
        assert meta["budget_rel_err"] is None or \
            meta["budget_rel_err"] >= 0

    def test_stream_matches_blocking_bytes(self, mx_server, client_mod):
        body = {"op": "gemm", "shapes": [48, 16, 8], "dtype": "float32",
                "seed": 21}
        c = _client(client_mod, mx_server)
        blocking = c.matrix(**dict(body))
        streamed = c.matrix_stream(**dict(body))
        assert streamed["code"] == 200, streamed
        _assert_bytes_equal(streamed["arrays"], blocking["arrays"])
        _assert_bytes_equal(decode_result(streamed["payload_bytes"])[0],
                            matrix_compute(dict(body), device="cpu"))
        phases = [e.get("phase") for e in streamed["events"]]
        assert phases[0] == "queued" and "execute" in phases
        progress = [e["progress"] for e in streamed["events"]
                    if "progress" in e]
        assert progress == sorted(progress) and progress[-1] == 1.0

    def test_http_typed_400_and_bad_json(self, mx_server, client_mod):
        c = _client(client_mod, mx_server)
        res = c.matrix("qr", [4, 4], seed=1)
        assert res["code"] == 400
        assert res["error_code"] == "unknown_op"
        assert "detail" in res
        conn = http.client.HTTPConnection("127.0.0.1", mx_server.port,
                                          timeout=JOIN_S)
        try:
            conn.request("POST", "/v1/matrix", b"{nope",
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            err = json.loads(resp.read())
            assert resp.status == 400
            assert err["code"] == "bad_json"
        finally:
            conn.close()

    def test_matrixless_server_404s(self, model, client_mod):
        params, cfg, _, _ = model
        srv = serve(params, cfg, port=0, batch=2, round_steps=4, seed=0,
                    device="cpu").start_background()
        try:
            res = _client(client_mod, srv).matrix("gemm", [4, 4, 4],
                                                  seed=1)
            assert res["code"] == 404
            assert "--matrix" in res["error"]
        finally:
            srv.close_now()

    def test_llm_traffic_interleaves_and_rounds_carry_quanta(
            self, model, client_mod):
        """An LLM stream and a matrix job queued together before the
        driver starts: the job's quanta run between decode rounds, and a
        round with a live row carries ``matrix_quanta``; both results are
        the standalone ones."""
        params, cfg, _, _ = model
        reg = MetricsRegistry()
        eng = ServingEngine(params, cfg, batch=2, round_steps=4, seed=0,
                            metrics_registry=reg, device="cpu")
        mx = MatrixService(metrics=reg, runlog=eng.runlog, device="cpu")
        fe = EngineFrontend(eng, matrix=mx)
        srv = ServingHTTPServer(("127.0.0.1", 0), fe).start_background()
        prompt = _prompts(cfg, 1, seed=4)[0]
        body = {"op": "gemm", "shapes": [64, 32, 16], "dtype": "float32",
                "seed": 33}
        out = {}
        threads = [
            threading.Thread(target=lambda: out.update(
                llm=_client(client_mod, srv).stream(prompt, 16))),
            threading.Thread(target=lambda: out.update(
                mx=_client(client_mod, srv).matrix(**dict(body))))]
        try:
            for t in threads:
                t.start()
            deadline = time.perf_counter() + JOIN_S
            while (len(eng.queue) < 1 or not mx.has_work()) \
                    and time.perf_counter() < deadline:
                time.sleep(0.01)
            fe.start()
            for t in threads:
                t.join(JOIN_S)
        finally:
            srv.close_now()
        gold = ServingEngine(params, cfg, batch=2, round_steps=4, seed=0,
                             metrics_registry=MetricsRegistry(),
                             device="cpu")
        gold.submit(prompt, 16)
        assert out["llm"]["code"] == 200
        assert out["llm"]["tokens"] == list(map(int, gold.run()[0].tokens))
        assert out["mx"]["code"] == 200
        _assert_bytes_equal(out["mx"]["arrays"],
                            matrix_compute(dict(body), device="cpu"))
        rounds = eng.runlog.events("round")
        assert any(r.get("matrix_quanta", 0) > 0 and r["occupied"] > 0
                   for r in rounds), rounds
        assert sum(r.get("matrix_quanta", 0) for r in rounds) <= 2
        assert fe.debug_engine()["matrix"]["jobs_done"] == 1


class TestChaosReplay:
    def _frontend(self, model, runlog=None, poison_after=2):
        """A frontend whose matrix slice between rounds is one quantum
        (a round budget below any quantum's time)."""
        params, cfg, _, _ = model
        reg = MetricsRegistry()
        eng = ServingEngine(params, cfg, batch=2, round_steps=2,
                            metrics_registry=reg, seed=0, runlog=runlog,
                            device="cpu")
        mx = MatrixService(metrics=reg, runlog=runlog, round_budget_s=1e-9,
                           poison_after=poison_after, device="cpu")
        return EngineFrontend(eng, matrix=mx), reg

    def test_crash_mid_job_replays_bitexact_from_seed(self, model,
                                                      tmp_path):
        """A matrix_quantum fault at the slice after round 2 (the job's
        third quantum of twelve, one a round while the LLM request
        decodes): the supervisor restarts the engine, the job replays
        from its seed to the clean bytes, and the LLM request's tokens
        are the clean ones."""
        params, cfg, _, _ = model
        body = {"op": "lu", "shapes": [96], "dtype": "float32",
                "seed": 13, "base": 8}
        ref = matrix_compute(dict(body), device="cpu")
        prompt = _prompts(cfg, 1, seed=6)[0]
        gold = ServingEngine(params, cfg, batch=2, round_steps=2, seed=0,
                             metrics_registry=MetricsRegistry(),
                             device="cpu")
        gold.submit(prompt, 16)
        gold_tokens = list(map(int, gold.run()[0].tokens))
        runlog = RunLog(path=str(tmp_path / "chaos.jsonl"))
        plan = faults.install(faults.FaultPlan())
        crash = plan.add(site="matrix_quantum", round=2)
        fe, reg = self._frontend(model, runlog=runlog)
        try:
            lh = fe.submit(prompt, 16)
            h = fe.submit_matrix(validate_job(dict(body)))
            fe.start()
            payload, meta = h.result(timeout=JOIN_S)
            assert list(map(int, lh.result(JOIN_S).tokens)) == gold_tokens
            assert crash.fires == 1
            assert fe.restarts == 1
            assert meta["status"] == "done"
            assert meta["crash_count"] == 1 and meta["quanta"] == 12
            arrays, _ = decode_result(payload)
            _assert_bytes_equal(arrays, ref)
            assert fe.drain(JOIN_S)
        finally:
            fe.stop(JOIN_S)
        events = [json.loads(line) for line in
                  open(tmp_path / "chaos.jsonl")]
        replay = [e for e in events if e["kind"] == "job_replay"]
        assert len(replay) == 1 and replay[0]["crash_count"] == 1
        # The crash came mid-job: two quanta had run, credited to rounds
        # 1 and 2 of the first engine.
        quanta = sum(e.get("matrix_quanta", 0) for e in events
                     if e["kind"] == "round" and e["round"] <= 2)
        assert quanta == 2

    def test_repeated_crashes_quarantine_as_poisoned(self, model):
        body = {"op": "gemm", "shapes": [32, 16, 8],
                "dtype": "float32", "seed": 14}
        plan = faults.install(faults.FaultPlan())
        plan.add(site="matrix_quantum", action="raise", max_fires=5)
        fe, reg = self._frontend(model, poison_after=2)
        try:
            h = fe.submit_matrix(validate_job(dict(body)))
            fe.start()
            with pytest.raises(PoisonedRequest) as ei:
                h.result(timeout=JOIN_S)
            assert ei.value.crash_count == 2
            snap = reg.snapshot()
            assert snap["counters"][
                "serving_matrix_jobs_poisoned_total"] == 1
            assert fe.ready and fe.restarts == 2
            assert fe.drain(JOIN_S)
        finally:
            fe.stop(JOIN_S)

    def test_poisoned_maps_to_500_over_http(self, model, client_mod):
        params, cfg, _, _ = model
        plan = faults.install(faults.FaultPlan())
        plan.add(site="matrix_quantum", action="raise", max_fires=5)
        srv = serve(params, cfg, port=0, batch=2, round_steps=4, seed=0,
                    matrix=True, device="cpu").start_background()
        try:
            c = _client(client_mod, srv)
            res = c.matrix("gemm", [16, 8, 8], seed=15)
            assert res["code"] == 500
            assert res["status"] == "poisoned" and res["crash_count"] == 2
            rz = c.readyz()
            assert rz["code"] == 200 and rz["ready"]
        finally:
            faults.reset()
            srv.close_now()


class TestClientRetrySemantics:
    def test_streamed_progress_is_never_silently_resent(self,
                                                        client_mod):
        """The client's idempotency guard on a matrix job: a retryable
        result that already delivered progress events stops the retry
        loop, as delivered tokens do."""
        sc = client_mod
        policy = sc.RetryPolicy(max_attempts=4, base_delay_s=0.0)
        calls = []

        def partial_stream():
            calls.append(1)
            return {"code": 503, "retry_after": None,
                    "events": [{"phase": "execute", "quantum": 1}],
                    "stream_error": "died mid-progress"}

        res = sc.call_with_retry(partial_stream, policy, key="k",
                                 sleep=lambda s: None)
        assert res["attempts"] == 1 and len(calls) == 1

        def clean_503():
            calls.append(1)
            return {"code": 503, "retry_after": None}

        calls.clear()
        res = sc.call_with_retry(clean_503, policy, key="k",
                                 sleep=lambda s: None)
        assert res["attempts"] == 4 and len(calls) == 4
