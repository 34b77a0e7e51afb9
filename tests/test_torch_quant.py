"""The port's int8 stack (marlin_tpu_torch/models/quant.py and the int8
paths of the transformer and the serving engine), twin of
tests/test_quant.py.

Against the JAX package on the same numpy inputs: ``q8``/``s8`` bit for
bit (per-channel symmetric int8 with round half to even, computed in f32
by both), int8 decode within 1e-5 of JAX's at f32, and the cost model's
int8 bytes equal. Within the port: the dequantized oracle, the guards, and
the int8 cache's scales moving with their slots through the prefix cache
and the page pool.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marlin_tpu.models import quant as jq
from marlin_tpu.models import transformer as jt
from marlin_tpu.utils import cost_model as jcm
from marlin_tpu_torch.models import convert
from marlin_tpu_torch.models import quant as pq
from marlin_tpu_torch.models import transformer as pt
from marlin_tpu_torch.serving import PrefixCache, ServingEngine
from marlin_tpu_torch.serving.prefix import copy_kv_rows
from marlin_tpu_torch.utils import cost_model as pcm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BASE = dict(vocab=96, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=48)


def _cfg(**kw):
    return pt.TransformerConfig(**{**BASE, **kw})


def _cfgs(**kw):
    return jt.TransformerConfig(**{**BASE, **kw}), _cfg(**kw)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves(tree[k], f"{prefix}.{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


class TestQuantizationBits:
    def test_q8_s8_bitwise_equal_to_jax(self):
        # The same f32 masters quantized by both packages: every q8 and s8
        # bit equal; params_from_jax carries JAX's int8 leaves across
        # unchanged.
        jcfg, pcfg = _cfgs(rope=True, n_kv_heads=1)
        jp = jt.init_params(jcfg, seed=1)
        masters = convert.params_from_jax(_np_tree(jp), pcfg, device="cpu")
        mine = pq.quantize_params_int8(masters)
        theirs = _np_tree(jq.quantize_params_int8(jp))
        carried = convert.params_from_jax(theirs, pcfg, device="cpu")
        a, b, c = _leaves(mine), _leaves(theirs), _leaves(carried)
        assert [n for n, _ in a] == [n for n, _ in b] == [n for n, _ in c]
        assert sum(n.endswith(".q8") for n, _ in a) == 1 + 4 * 2
        for (name, x), (_, y), (_, z) in zip(a, b, c):
            assert x.dtype == z.dtype, name
            np.testing.assert_array_equal(x.numpy(), y, err_msg=name)
            np.testing.assert_array_equal(z.numpy(), y, err_msg=name)

    def test_kv_quantize_bitwise_equal_to_jax(self):
        # Random vectors, a zero vector, and exact .5 multiples of the
        # step (half-to-even rounding decides them).
        rng = np.random.default_rng(0)
        x = rng.standard_normal((3, 7, 2, 16)).astype(np.float32)
        x[0, 0, 0] = 0.0
        x[1, 2, 1] = np.float32(127.0) * np.arange(16) / 16 - 63.5
        x[1, 2, 1, 0] = 127.0
        q, s = pq.kv_quantize(torch.from_numpy(x))
        jq8, js = jq.kv_quantize(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq8))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        assert q.dtype == torch.int8 and s.shape == (3, 7, 2, 1)

    def test_roundtrip_error_bounded_by_half_step(self):
        p = pt.init_params(_cfg(), seed=0, device="cpu")
        q = pq.quantize_params_int8(p)
        d = pq.dequantize_params(q)
        w, wq = p["blocks"][0]["wqkv"], q["blocks"][0]["wqkv"]
        assert wq["q8"].dtype == torch.int8
        err = (w - d["blocks"][0]["wqkv"]).abs()
        assert bool((err <= 0.5 * wq["s8"] + 1e-8).all())

    def test_idempotent_and_zero_channel_survives(self):
        p = pt.init_params(_cfg(), seed=0, device="cpu")
        p["blocks"][0]["wo"][:, 3] = 0.0
        q = pq.quantize_params_int8(p)
        assert pq.quantize_params_int8(q) is q
        assert pq.is_quantized(q) and not pq.is_quantized(p)
        wo = pq.dequantize_params(q)["blocks"][0]["wo"]
        assert bool(torch.isfinite(wo).all()) and bool((wo[:, 3] == 0).all())

    def test_donate_frees_each_master(self):
        p = pt.init_params(_cfg(), seed=0, device="cpu")
        ref = pq.quantize_params_int8(p)
        q = pq.quantize_params_int8(p, donate=True)
        assert p["embed"].numel() == 0
        assert all(p["blocks"][0][k].numel() == 0
                   for k in ("wqkv", "wo", "w1", "w2"))
        assert p["blocks"][0]["b1"].numel() == BASE["d_ff"]  # not donated
        for (name, x), (_, y) in zip(_leaves(q), _leaves(ref)):
            assert torch.equal(x, y), name


class TestInt8Decode:
    @pytest.mark.parametrize("kw", [
        {}, {"rope": True, "n_kv_heads": 1}, {"kv_quant": "int8"},
    ], ids=["weights", "weights_rope_mqa", "weights_and_cache"])
    def test_decode_within_1e5_of_jax(self, kw):
        # JAX's int8 params carried across: prefill, then three decode
        # steps over the (int8, with kv_quant) cache, logits within 1e-5.
        jcfg, pcfg = _cfgs(**kw)
        jq8 = jq.quantize_params_int8(jt.init_params(jcfg, seed=2))
        params = convert.params_from_jax(_np_tree(jq8), pcfg, device="cpu")
        prompt = np.random.default_rng(3).integers(0, BASE["vocab"], (2, 9))
        jl, jcache = jt.prefill(jq8, jnp.asarray(prompt, jnp.int32), jcfg)
        pl, pcache = pt.prefill(params, torch.as_tensor(prompt), pcfg)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-5)
        for i, tok in enumerate(([3, 11], [9, 2], [40, 7])):
            jl, jcache = jt.decode_step(jq8, jcache,
                                        jnp.asarray(tok, jnp.int32), 9 + i,
                                        jcfg)
            pl, pcache = pt.decode_step(params, pcache, torch.as_tensor(tok),
                                        9 + i, pcfg)
            np.testing.assert_allclose(pl.numpy(), np.asarray(jl),
                                       atol=1e-5, err_msg=f"step {i}")

    @pytest.mark.parametrize("kw", [
        {}, {"rope": True, "n_kv_heads": 1, "window": 16},
        {"dtype": "bfloat16"},
    ], ids=["f32", "rope_ring", "bf16"])
    def test_decode_matches_dequantized_oracle(self, kw):
        cfg = _cfg(**kw)
        q = pq.quantize_params_int8(pt.init_params(cfg, seed=2,
                                                   device="cpu"))
        d = pq.dequantize_params(q)
        tok = torch.tensor([5, 7])
        out = []
        for params in (q, d):
            cache = pt.init_kv_cache(cfg, 2, dtype=cfg.compute_dtype,
                                     device="cpu")
            out.append(pt.decode_step(params, cache, tok, 0, cfg)[0]
                       .float())
        tol = 2e-2 if cfg.dtype == "bfloat16" else 2e-5
        torch.testing.assert_close(out[0], out[1], rtol=tol,
                                   atol=tol * out[1].abs().max().item())

    def test_generate_equals_the_dequantized_oracle(self):
        cfg = _cfg()
        q = pq.quantize_params_int8(pt.init_params(cfg, seed=3,
                                                   device="cpu"))
        prompt = torch.as_tensor(
            np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)))
        out = pt.generate(q, prompt, 6, cfg)
        assert out.shape == (2, 6) and 0 <= int(out.min()) \
            and int(out.max()) < cfg.vocab
        assert torch.equal(out, pt.generate(pq.dequantize_params(q), prompt,
                                            6, cfg))

    def test_cache_layout_and_bytes(self):
        lay = pt.init_kv_cache(_cfg(kv_quant="int8"), 2, device="cpu")[0]
        assert lay["k"].dtype == torch.int8 and lay["v"].dtype == torch.int8
        assert lay["ks"].shape == lay["k"].shape[:-1] + (1,)
        assert pq.kv_layer_keys(lay) == ("k", "v", "ks", "vs")
        assert pq.kv_layer_keys(False) == ("k", "v")
        qbytes = sum(x.numel() * x.element_size() for x in lay.values())
        flay = pt.init_kv_cache(_cfg(), 2, device="cpu")[0]
        fbytes = sum(x.numel() * x.element_size() for x in flay.values())
        assert qbytes < 0.3 * fbytes + 8 * lay["ks"].numel()

    def test_rejects_unknown_mode(self):
        with pytest.raises(ValueError, match="kv_quant"):
            pt.init_kv_cache(_cfg(kv_quant="fp4"), 1, device="cpu")

    @pytest.mark.parametrize("kw", [
        {}, {"rope": True, "n_kv_heads": 1, "window": 16},
        {"dtype": "bfloat16"},
    ], ids=["f32", "rope_ring", "bf16"])
    def test_int8_cache_close_to_float_cache(self, kw):
        cfg_f, cfg_q = _cfg(**kw), _cfg(kv_quant="int8", **kw)
        p = pt.init_params(cfg_f, seed=6, device="cpu")
        cf = pt.init_kv_cache(cfg_f, 2, dtype=cfg_f.compute_dtype,
                              device="cpu")
        cq = pt.init_kv_cache(cfg_q, 2, device="cpu")
        for i, tok in enumerate(([3, 11], [9, 2])):
            lf, _ = pt.decode_step(p, cf, torch.tensor(tok), i, cfg_f)
            lq, _ = pt.decode_step(p, cq, torch.tensor(tok), i, cfg_q)
        lf, lq = lf.float(), lq.float()
        assert (lq - lf).abs().max() <= 0.05 * lf.abs().max()

    def test_prefill_primes_quantized_ring(self):
        cfg_q = _cfg(kv_quant="int8", rope=True, window=8, max_len=32)
        cfg_f = _cfg(rope=True, window=8, max_len=32)
        p = pt.init_params(cfg_q, seed=8, device="cpu")
        prompt = torch.as_tensor(
            np.random.default_rng(2).integers(0, cfg_q.vocab, (1, 12)))
        _, cache_q = pt.prefill(p, prompt, cfg_q)
        _, cache_f = pt.prefill(p, prompt, cfg_f)
        assert cache_q[0]["k"].dtype == torch.int8
        assert cache_q[0]["k"].shape[1] == 8
        # The scales are kv_quantize's of the float cache's vectors.
        q8, s = pq.kv_quantize(cache_f[0]["k"])
        assert torch.equal(cache_q[0]["k"], q8)
        assert torch.equal(cache_q[0]["ks"], s)
        tok = torch.tensor([5])
        lq, _ = pt.decode_step(p, cache_q, tok, 12, cfg_q)
        lf, _ = pt.decode_step(p, cache_f, tok, 12, cfg_f)
        assert (lq - lf).abs().max() <= 0.05 * lf.abs().max()


class TestGuards:
    def test_loss_fn_rejects_quantized_params(self):
        cfg = _cfg()
        q = pq.quantize_params_int8(pt.init_params(cfg, seed=0,
                                                   device="cpu"))
        tok = torch.zeros((1, 8), dtype=torch.long)
        with pytest.raises(ValueError, match="inference-only"):
            pt.loss_fn(q, tok, tok, cfg)

    def test_decode_rejects_cache_config_mismatch(self):
        cfg_q, cfg_f = _cfg(kv_quant="int8"), _cfg()
        p = pt.init_params(cfg_f, seed=0, device="cpu")
        tok = torch.zeros((1,), dtype=torch.long)
        for cache_cfg, cfg in ((cfg_q, cfg_f), (cfg_f, cfg_q)):
            cache = pt.init_kv_cache(cache_cfg, 1, device="cpu")
            with pytest.raises(ValueError, match="int8-quantized"):
                pt.decode_step(p, cache, tok, 0, cfg)
            with pytest.raises(ValueError, match="int8-quantized"):
                pt.decode_chunk(p, cache, tok[:, None], 0, cfg)
            pool = pt.init_kv_cache(cache_cfg._replace(max_len=16), 3,
                                    device="cpu")
            tables = torch.ones((1, cfg.max_len // 16), dtype=torch.long)
            with pytest.raises(ValueError, match="int8-quantized"):
                pt.decode_chunk_paged(p, pool, tables, tok[:, None], 0, cfg)


class TestCostModel:
    @pytest.mark.parametrize("kw", [{}, {"rope": True, "n_kv_heads": 1},
                                    {"kv_quant": "int8"}])
    def test_int8_bytes_equal_jax(self, kw):
        jcfg, pcfg = _cfgs(**kw)
        assert pcm.quantized_weight_counts(pcfg) \
            == jcm.quantized_weight_counts(jcfg)
        for qw in (False, True):
            for itemsize in (2, 4):
                assert pcm.decode_step_cost(
                    pcfg, 3, param_itemsize=itemsize, quant_weights=qw) \
                    == jcm.decode_step_cost(
                        jcfg, 3, param_itemsize=itemsize, quant_weights=qw)

    def test_counts_match_a_quantized_pytree(self):
        cfg = _cfg(rope=True, n_kv_heads=1)
        q = pq.quantize_params_int8(pt.init_params(cfg, seed=0,
                                                   device="cpu"))
        leaves = _leaves(q)
        n_q = sum(x.numel() for n, x in leaves if n.endswith(".q8"))
        n_s = sum(x.numel() for n, x in leaves if n.endswith(".s8"))
        assert pcm.quantized_weight_counts(cfg) == (n_q, n_s)

    def test_int8_decode_streams_a_quarter_of_the_bytes(self):
        cfg = _cfg(vocab=256, d_model=64, d_ff=256, max_len=64)
        _, f32 = pcm.decode_step_cost(cfg, 2)
        _, q8 = pcm.decode_step_cost(cfg._replace(kv_quant="int8"), 2,
                                     quant_weights=True)
        assert q8 < 0.3 * f32


class TestServingInt8:
    def test_engine_int8_stack_equals_b1_generate(self):
        # One-shot admission quantizes the prompt K/V after the flash
        # prefill, as generate's prefill does: rows equal B=1 generate.
        cfg = _cfg(kv_quant="int8", rope=True, n_kv_heads=1)
        q = pq.quantize_params_int8(pt.init_params(cfg, seed=1,
                                                   device="cpu"))
        eng = ServingEngine(q, cfg, batch=2, round_steps=3, device="cpu")
        rng = np.random.default_rng(4)
        work = [(rng.integers(0, cfg.vocab, s), st)
                for s, st in ((9, 12), (20, 5), (4, 14))]
        ids = {eng.submit(p, st): (p, st) for p, st in work}
        done = {r.request_id: r for r in eng.run()}
        for rid, (p, st) in ids.items():
            ref = pt.generate(q, torch.as_tensor(p[None]), st, cfg)
            np.testing.assert_array_equal(done[rid].tokens, ref.numpy()[0])

    def test_scales_travel_with_rows_and_pages(self):
        # copy_kv_rows moves ks/vs; a prefix-cache hit and a paged alias
        # over the int8 cache give the cold chunked admission's tokens.
        cfg = _cfg(kv_quant="int8", max_len=64)
        params = pt.init_params(cfg, seed=2, device="cpu")
        src = pt.init_kv_cache(cfg, 2, device="cpu")
        for layer in src:
            for buf in layer.values():
                buf.copy_(torch.randint(-5, 5, buf.shape).to(buf.dtype))
        dst = copy_kv_rows(pt.init_kv_cache(cfg, 2, device="cpu"), src, 0,
                           1, 16)
        for dl, sl in zip(dst, src):
            for name in ("k", "v", "ks", "vs"):
                assert torch.equal(dl[name][0, :16], sl[name][1, :16])
        rng = np.random.default_rng(5)
        system = rng.integers(0, cfg.vocab, 32)
        work = [(np.concatenate([system, rng.integers(0, cfg.vocab, t)]), 8)
                for t in (3, 9, 5)]
        outs = []
        for options in (dict(prefill_chunk=16),
                        dict(prefill_chunk=16, prefix_cache=PrefixCache(
                            cfg, pool_rows=2, device="cpu")),
                        dict(kv_pages=16)):
            eng = ServingEngine(params, cfg, batch=1, round_steps=4,
                                device="cpu", **options)
            ids = [eng.submit(p, st) for p, st in work]
            done = {r.request_id: r for r in eng.run()}
            outs.append([done[i].tokens.tolist() for i in ids])
            if "prefix_cache" in options or "kv_pages" in options:
                assert eng.stats.n_prefix_hits == 2
        assert outs[0] == outs[1] == outs[2]
