"""The port's tensor-parallel serving (marlin_tpu_torch/serving/tp.py and
the engine's ``cfg.tp > 1``), twins of tests/test_tp_serving.py::
TestTPEngineBitExact and of its cost-model floor.

Inside the port, bitwise on the CPU: whole serving rounds at TP = 2 and 4
drain token for token as TP = 1 does, request by request, contiguous,
paged, chunked and speculative paged (sampled at temperature 0.7, so the
request generators are drawn from exactly as at TP = 1); int8 paged at
TP = 1 and 2; a paged engine with a host tier and Scheduler preemption at
TP = 2 as at TP = 1, its frozen rows' payloads the same bytes; a sharded
page pool gathers to, and restores from, the global head layout. The
contiguous PrefixCache is refused at TP > 1, and ``engine_start`` carries
the degree and mode. Against the JAX package: the TP cost model's values,
and the 3.5 modeled-scaling floor at TP = 4 on the reference TP shape.
"""

import numpy as np
import pytest
import torch

from benchlib.configs_tp import _REF_SHAPE
from marlin_tpu.models import TransformerConfig as JaxConfig
from marlin_tpu.utils import cost_model as jcm
from marlin_tpu_torch.models import tp as mtp
from marlin_tpu_torch.models import transformer as pt
from marlin_tpu_torch.models.quant import quantize_params_int8
from marlin_tpu_torch.obs.metrics import MetricsRegistry
from marlin_tpu_torch.serving import (PAGE, PagePool, PrefixCache,
                                      Scheduler, ServingEngine,
                                      restore_pages_into_pool)
from marlin_tpu_torch.serving.pages import gather_pages_to_host
from marlin_tpu_torch.utils import cost_model as cm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GQA = dict(rope=True, n_heads=8, n_kv_heads=4)


def _cfg(tp=1, **kw):
    base = dict(vocab=61, d_model=32, n_layers=2, d_ff=64, max_len=64,
                tp=tp)
    base.update(kw)
    return pt.TransformerConfig(**base)


def _run_engine(params, cfg, prompts, steps, *, paged, spec, chunk=None):
    eng = ServingEngine(
        params, cfg, batch=2, round_steps=2, temperature=0.7, seed=0,
        max_pending=4 * len(prompts) + 8,
        kv_pages=16 if paged else None, prefill_chunk=chunk,
        spec_draft_lens=(4,) if spec else None,
        metrics_registry=MetricsRegistry(), device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(p, steps, request_id=100 + i)
    got = {r.request_id: list(map(int, r.tokens)) for r in eng.run()}
    return eng, got


class TestTPEngineBitExact:
    STEPS = 6

    def _prompts(self, rng, n=4):
        return [rng.integers(1, 61, int(rng.integers(4, 20)))
                .astype(np.int32) for _ in range(n)]

    @pytest.mark.parametrize("mode", ["contig", "paged", "chunked",
                                      "spec_paged"])
    def test_rounds_bitexact_across_tp(self, rng, mode):
        params = pt.init_params(_cfg(**GQA), seed=1, device="cpu")
        prompts = self._prompts(rng)
        paged = mode in ("paged", "spec_paged")
        spec = mode == "spec_paged"
        chunk = 16 if mode == "chunked" or paged else None
        ref = None
        for tp in (1, 2, 4):
            eng, got = _run_engine(params, _cfg(tp=tp, **GQA), prompts,
                                   self.STEPS, paged=paged, spec=spec,
                                   chunk=chunk)
            assert len(got) == len(prompts)
            assert eng.tp == tp
            if ref is None:
                ref = got
            else:
                assert got == ref, f"{mode}: tp={tp} diverged from tp=1"

    def test_int8_rounds_bitexact_across_tp(self, rng):
        params = quantize_params_int8(pt.init_params(_cfg(**GQA), seed=2,
                                                     device="cpu"))
        prompts = self._prompts(rng)
        ref = None
        for tp in (1, 2):
            _, got = _run_engine(params, _cfg(tp=tp, **GQA), prompts,
                                 self.STEPS, paged=True, spec=False,
                                 chunk=16)
            ref = got if ref is None else ref
            assert got == ref

    def test_tier_preemption_bitexact_across_tp(self):
        """Two long batch-class jobs fill both rows, an interactive one
        arrives and preempts: the frozen row's pages go to the host tier
        in the global head layout, so its payload bytes and the tokens
        are TP = 1's."""
        params = pt.init_params(_cfg(**GQA), seed=0, device="cpu")
        prompts = [np.random.default_rng(3).integers(1, 61, 9)
                   for _ in range(3)]
        runs = {}
        for tp in (1, 2):
            eng = ServingEngine(
                params, _cfg(tp=tp, **GQA), batch=2, round_steps=4, seed=7,
                kv_pages=24, host_kv_bytes=1 << 24, scheduler=Scheduler(),
                temperature=0.8, metrics_registry=MetricsRegistry(),
                device="cpu")
            payloads = []
            spill_row = eng.host_tier.spill_row

            def record(key, tokens, pages, spill_row=spill_row,
                       payloads=payloads, eng=eng):
                payloads.append(gather_pages_to_host(
                    eng.page_pool.pages, pages)[0])
                return spill_row(key, tokens, pages)

            eng.host_tier.spill_row = record
            eng.submit(prompts[0], 40, request_id=0, sched_class="batch")
            eng.submit(prompts[1], 40, request_id=1, sched_class="batch")
            out = {}
            for i in range(400):
                if i == 3:
                    eng.submit(prompts[2], 6, request_id=2,
                               sched_class="interactive")
                out.update({r.request_id: r.tokens.tolist()
                            for r in eng.step()})
                if len(out) == 3:
                    break
            snap = eng.debug_sched()
            assert snap["preempts"] >= 1
            assert snap["resumes"] == snap["preempts"]
            runs[tp] = (out, payloads)
        (out1, pay1), (out2, pay2) = runs[1], runs[2]
        assert out2 == out1
        assert len(pay2) == len(pay1) >= 1
        for a, b in zip(pay1, pay2):
            for la, lb in zip(a, b):
                assert la.keys() == lb.keys()
                for name in la:
                    assert torch.equal(la[name], lb[name])

    @pytest.mark.parametrize("quant", ["", "int8"])
    def test_sharded_pool_payload_is_the_global_layout(self, rng, quant):
        kw = dict(GQA, max_len=32, kv_quant=quant)
        glob = PagePool(_cfg(**kw), 6, registry=MetricsRegistry(),
                        device="cpu")
        shard = PagePool(_cfg(tp=2, **kw), 6, registry=MetricsRegistry(),
                         device="cpu")
        assert isinstance(shard.pages, mtp.Sharded)
        assert shard.pages[0][0]["k"].shape[2] == 2
        assert shard.page_bytes == glob.page_bytes
        for layer in glob.pages:
            for name, buf in layer.items():
                vals = torch.as_tensor(rng.standard_normal(buf.shape) * 50)
                buf.copy_(vals.to(buf.dtype))
        payload, nbytes = gather_pages_to_host(glob.pages, [2, 5])
        restore_pages_into_pool(shard.pages, payload, [1, 4])
        back, nbytes2 = gather_pages_to_host(shard.pages, [1, 4])
        assert nbytes2 == nbytes
        for la, lb in zip(payload, back):
            for name in la:
                assert torch.equal(la[name], lb[name])
        # Each shard holds its heads of the restored pages.
        assert torch.equal(shard.pages[1][0]["k"][4],
                           glob.pages[0]["k"][5][:, 2:])
        assert PAGE == shard.pages[0][0]["k"].shape[1]

    def test_contiguous_prefix_cache_gated_at_tp(self):
        params = pt.init_params(_cfg(**GQA), seed=0, device="cpu")
        with pytest.raises(NotImplementedError, match="PAGED"):
            ServingEngine(params, _cfg(tp=2, **GQA), batch=2,
                          prefix_cache=PrefixCache(_cfg(tp=2, **GQA),
                                                   pool_rows=4,
                                                   device="cpu"),
                          device="cpu")

    def test_engine_surfaces_tp_degree(self):
        params = pt.init_params(_cfg(**GQA), seed=0, device="cpu")
        eng = ServingEngine(params, _cfg(tp=2, **GQA), batch=2,
                            kv_pages=16, prefill_chunk=16,
                            metrics_registry=MetricsRegistry(),
                            device="cpu")
        (start,) = eng.runlog.events("engine_start")
        assert start["tp_degree"] == 2
        assert start["tp_mode"] == "gather"
        assert eng.devices == (torch.device("cpu"),) * 2
        # The run copy is sharded and permuted; self.params is the tree
        # the caller passed.
        assert eng.params is params
        assert isinstance(eng._run_params, mtp.Sharded)
        eng1 = ServingEngine(params, _cfg(**GQA), batch=2,
                             metrics_registry=MetricsRegistry(),
                             device="cpu")
        (start1,) = eng1.runlog.events("engine_start")
        assert start1["tp_degree"] == 1 and start1["tp_mode"] is None

    def test_tp_on_too_few_cards_raises(self):
        # No fallback: device="cuda" at tp 2 needs two cards (on a host
        # without CUDA it raises for CUDA itself).
        params = pt.init_params(_cfg(**GQA), seed=0, device="cpu")
        expect = ValueError if torch.cuda.is_available() else RuntimeError
        n = torch.cuda.device_count() if torch.cuda.is_available() else 1
        cfg = _cfg(tp=2 * n, n_heads=8 * n, n_kv_heads=4 * n, rope=True)
        with pytest.raises(expect):
            ServingEngine(params, cfg, batch=2, device="cuda")


def _ref_cfgs():
    kw = dict(d_ff=4 * _REF_SHAPE["d_model"], rope=True, dtype="bfloat16",
              **_REF_SHAPE)
    return JaxConfig(**kw), pt.TransformerConfig(**kw)


class TestTPCostModel:
    @pytest.mark.parametrize("tp", [1, 2, 4])
    @pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
    def test_tp_decode_step_cost_matches_jax(self, tp, quant):
        jcfg, pcfg = _ref_cfgs()
        assert cm.tp_decode_step_cost(pcfg, 8, tp=tp, param_itemsize=2,
                                      quant_weights=quant) \
            == jcm.tp_decode_step_cost(jcfg, 8, tp=tp, param_itemsize=2,
                                       quant_weights=quant)
        assert cm.tp_decode_flop_scaling(pcfg, 8, tp, quant) \
            == jcm.tp_decode_flop_scaling(jcfg, 8, tp, quant)

    def test_modeled_scaling_floor_fast(self):
        _, ref = _ref_cfgs()
        s2 = cm.tp_decode_flop_scaling(ref, batch=8, tp=2)
        s4 = cm.tp_decode_flop_scaling(ref, batch=8, tp=4)
        assert 1.8 <= s2 <= 2.0
        assert 3.5 <= s4 <= 4.0
        # Per-shard cost at tp=1 is the base model exactly.
        assert cm.tp_decode_step_cost(ref, 8, tp=1) \
            == cm.decode_step_cost(ref, 8)
        # Learned positions are replicated too.
        flat = ref._replace(rope=False, max_len=512)
        assert cm._tp_replicated_params(flat) \
            == cm._tp_replicated_params(ref) + 512 * ref.d_model
