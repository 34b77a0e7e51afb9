"""The port's observability exports and job pricing against the JAX
package's (marlin_tpu_torch/obs/metrics.py, runlog.py, distributed.py and
utils/cost_model.py's matrix-job functions): the part of
tests/test_obs.py's twin that the HTTP server and the matrix service call.

The same series go into both registries: ``prometheus()`` text equal byte
for byte, ``snapshot()``, ``dump()`` and ``reset()`` equal, the gauges'
``inc``/``dec``. The run log's ``dumps``/``dump``/``clear`` on the same
events and clock equal. The trace-context wire and the matrix-job cost
functions give the reference's values exactly. Stdlib and numpy only: no
model, no thread.
"""

import pytest

from marlin_tpu.obs import distributed as jdist
from marlin_tpu.obs import metrics as jmetrics
from marlin_tpu.obs.runlog import RunLog as JaxRunLog
from marlin_tpu.utils import cost_model as jcm
from marlin_tpu_torch.obs import distributed as pdist
from marlin_tpu_torch.obs import metrics as pmetrics
from marlin_tpu_torch.obs.runlog import RunLog
from marlin_tpu_torch.utils import cost_model as pcm


def _fill(reg):
    """One workload of series into a registry of either package: labels,
    help text with a backslash and a newline, a name with dots, custom
    buckets, exemplars, a gauge moved by set, inc and dec."""
    reg.counter("serving_http_requests_total", route="/v1/generate",
                help="requests by route").inc()
    reg.counter("serving_http_requests_total", route="/metrics").inc(3)
    reg.counter("serving_http_responses_total", code="429").inc()
    reg.counter("DenseVecMatrix.multiply", help="op timing\\ a\nb").inc(2)
    g = reg.gauge("serving_queue_depth", help="queued requests")
    g.set(5)
    g.inc(2.5)
    g.dec()
    reg.gauge("serving_slots_occupied", dev="0").dec(4)
    h = reg.histogram("serving_ttft_seconds", help="time to first token")
    for v, ex in ((0.0004, "7"), (0.03, None), (12.0, "9"), (0.03, "8")):
        h.observe(v, exemplar=ex)
    hb = reg.histogram("serving_matrix_budget_rel_err",
                       buckets=(0.05, 0.1, 0.25, 1.0), op="gemm")
    hb.observe(0.07)
    hb.observe(3.0)
    # A later call with other buckets keeps the family's layout.
    reg.histogram("serving_matrix_budget_rel_err", buckets=(0.5,),
                  op="lu").observe(0.07)
    reg.histogram("empty_seconds")  # a family with no observation
    return reg


class TestMetricsExports:
    def test_prometheus_text_is_the_references_byte_for_byte(self):
        port = _fill(pmetrics.MetricsRegistry()).prometheus()
        ref = _fill(jmetrics.MetricsRegistry()).prometheus()
        assert port == ref
        assert "# HELP DenseVecMatrix_multiply op timing\\\\ a\\nb" in port
        assert 'serving_ttft_seconds_bucket{le="+Inf"} 4' in port

    def test_snapshot_dump_and_reset_equal(self):
        port, ref = (_fill(pmetrics.MetricsRegistry()),
                     _fill(jmetrics.MetricsRegistry()))
        assert port.snapshot() == ref.snapshot()
        assert port.dump() == ref.dump()
        snap = port.snapshot()
        assert snap["gauges"]["serving_queue_depth"] == 6.5
        assert snap["gauges"]['serving_slots_occupied{dev="0"}'] == -4.0
        ex = snap["histograms"]["serving_ttft_seconds"]["exemplars"]
        assert ex == {"0.0005": "7", "0.05": "8", "+Inf": "9"}
        port.reset()
        ref.reset()
        assert port.snapshot() == ref.snapshot() == {
            "counters": {}, "gauges": {}, "histograms": {}}
        assert port.prometheus() == ref.prometheus() == "\n"

    def test_module_level_exports_read_the_default_registry(self):
        name = "test_torch_obs_marker_total"
        pmetrics.registry.counter(name).inc()
        try:
            assert pmetrics.snapshot()["counters"][name] >= 1
            assert f"# TYPE {name} counter" in pmetrics.prometheus()
        finally:
            pmetrics.registry.remove(name)

    def test_kind_clash_raises_as_the_reference(self):
        for mod in (pmetrics, jmetrics):
            reg = mod.MetricsRegistry()
            reg.counter("x")
            with pytest.raises(ValueError, match="is a counter"):
                reg.gauge("x")


class TestRunLogExports:
    @staticmethod
    def _log(cls, path=None):
        ticks = iter(range(100))
        log = cls(maxlen=3, clock=lambda: float(next(ticks)), path=path)
        log.emit("engine_start", batch=2)
        for r in range(3):
            log.emit("round", round=r, occupied=r % 2, extra={"a": [r]})
        log.emit("drain_complete", ledger={"completed": 3})
        return log

    def test_dumps_dump_and_clear_equal(self, tmp_path):
        port = self._log(RunLog, tmp_path / "p.jsonl")
        ref = self._log(JaxRunLog, tmp_path / "r.jsonl")
        assert port.dumps() == ref.dumps()
        assert len(port.dumps().splitlines()) == 3  # the retained window
        port.dump(tmp_path / "p_dump.jsonl")
        ref.dump(tmp_path / "r_dump.jsonl")
        assert (tmp_path / "p_dump.jsonl").read_text() \
            == (tmp_path / "r_dump.jsonl").read_text()
        port.flush()
        ref.flush()
        # The streamed sink holds every event, not only the window.
        assert (tmp_path / "p.jsonl").read_text() \
            == (tmp_path / "r.jsonl").read_text()
        assert port.n_emitted == ref.n_emitted == 5
        assert port.maxlen == ref.maxlen == 3
        port.clear()
        ref.clear()
        assert port.dumps() == ref.dumps() == ""
        assert len(port) == 0 and port.n_emitted == 5
        port.dump(tmp_path / "empty.jsonl")
        assert (tmp_path / "empty.jsonl").read_text() == ""
        port.close()
        ref.close()


class TestTraceContextWire:
    @pytest.mark.parametrize("rid", [0, 17, "fleet-3"])
    def test_mint_and_parse_match_the_reference(self, rid):
        for sampled in (True, False):
            p, j = pdist.mint(rid, sampled), jdist.mint(rid, sampled)
            assert p.to_header() == j.to_header()
            assert pdist.parse(p.to_header()) == p
            assert dict(vars(pdist.parse(j.to_header()))) \
                == dict(vars(jdist.parse(j.to_header())))
        assert pdist.trace_id_for(rid) == jdist.trace_id_for(rid)
        assert pdist.span_id_for("ab", "x") == jdist.span_id_for("ab", "x")

    @pytest.mark.parametrize("header", [
        None, "", "garbage", "01-" + "a" * 32 + "-" + "b" * 16 + "-01",
        "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
        "00-" + "a" * 32 + "-" + "0" * 16 + "-00",
        "  00-" + "A" * 32 + "-" + "b" * 16 + "-03  "])
    def test_tolerant_parse_matches_the_reference(self, header):
        p, j = pdist.parse(header), jdist.parse(header)
        assert (p is None) == (j is None)
        if p is not None:
            assert (p.trace_id, p.span_id, p.sampled) \
                == (j.trace_id, j.span_id, j.sampled)
        assert pdist.TRACE_HEADER == jdist.TRACE_HEADER


class TestMatrixJobPricing:
    @pytest.mark.parametrize("op,shapes", [
        ("gemm", [24, 16, 12]), ("spmm", [2048, 2048, 512]),
        ("lu", [2048]), ("cholesky", [16]), ("inverse", [12]),
        ("svd", [4096, 1024])])
    def test_matrix_job_cost_is_the_references(self, op, shapes):
        for kw in ({}, dict(itemsize=2, density=0.3, k_singular=4),
                   dict(itemsize=8, n_devices=4)):
            assert pcm.matrix_job_cost(op, shapes, **kw) \
                == jcm.matrix_job_cost(op, shapes, **kw)
        assert pcm.MATRIX_JOB_OPS == jcm.MATRIX_JOB_OPS

    def test_unknown_op_raises(self):
        with pytest.raises(ValueError, match="unknown matrix job op"):
            pcm.matrix_job_cost("qr", [4, 4])

    @pytest.mark.parametrize("units,n_quanta,spu,budget", [
        (1e9, 64, None, 0.01), (1e9, 64, 2e-12, 0.01),
        (5e6, 1, 1e-9, 0.05), (0.0, 3, 1e-9, 0.01),
        (3e8, 128, 1e-15, 0.01), (1e9, 0, 1e-11, 0.002)])
    def test_round_budget_is_the_references(self, units, n_quanta, spu,
                                            budget):
        assert pcm.matrix_round_budget(units, n_quanta, spu, budget) \
            == jcm.matrix_round_budget(units, n_quanta, spu, budget)

    def test_ell_cost_and_calibration_sec_per_unit(self):
        for args in ((64, 32, 8, 3, 1), (1000, 512, 64, 12, 4)):
            assert pcm.ell_product_cost(*args, itemsize=8) \
                == jcm.ell_product_cost(*args, itemsize=8)
        port, ref = pcm.CostCalibration(warmup=2), jcm.CostCalibration(
            warmup=2)
        assert port.sec_per_unit("matrix_lu_float32") is None
        for units, s in ((1e6, 2e-3), (2e6, 3e-3), (1e6, 1e-3),
                         (4e6, 9e-3)):
            port.record("matrix_lu_float32", units, s)
            ref.record("matrix_lu_float32", units, s)
            assert port.sec_per_unit("matrix_lu_float32") \
                == ref.sec_per_unit("matrix_lu_float32")
            assert port.summary() == ref.summary()
