"""Prompt-lookup speculative decoding in the port
(marlin_tpu_torch/models/transformer.py: ``decode_chunk``,
``_prompt_lookup_draft``, ``_spec_emit``, ``generate_speculative``), twin
of tests/test_speculative.py.

Speculation changes the schedule, never a token. Within the port that is
bitwise: decode steps and verify chunks run in ``DECODE_TILE`` tiles, so
``decode_chunk`` equals sequential ``decode_step`` calls and greedy
``generate_speculative`` equals ``generate`` bit for bit, at f32 and bf16,
at every draft length and with the int8 stack. Against the JAX package:
the drafting rule bit for bit, and ``generate_speculative``'s tokens by the
near-tie margin rule of test_torch_serving's cross-framework check. The
sampled kernel's PRNG streams differ between the frameworks, so it is held
to the target distribution instead.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marlin_tpu.models import transformer as jt
from marlin_tpu_torch.models import convert
from marlin_tpu_torch.models import transformer as pt
from marlin_tpu_torch.models.quant import quantize_params_int8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BASE = dict(vocab=48, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=96)


def _cfg(**kw):
    return pt.TransformerConfig(**{**BASE, **kw})


def _params(cfg, seed):
    return pt.init_params(cfg, seed=seed, device="cpu")


def _prompts(cfg):
    return np.stack([
        np.tile([5, 9, 17, 3], 5),                               # cyclic
        np.random.default_rng(3).integers(0, cfg.vocab, 20),     # random
        np.tile([1, 2], 10),                                     # short
    ])


class TestDraft:
    @pytest.mark.parametrize("draft_len,ngram", [(2, 1), (5, 2), (8, 3)])
    @pytest.mark.parametrize("mask_history", [False, True],
                             ids=["plain", "masked"])
    def test_prompt_lookup_draft_bitwise_equal_to_jax(self, draft_len,
                                                      ngram, mask_history):
        # Buffers with planted repeats, fills from below ngram (the gram
        # slice clamps) to the buffer's end, and a frozen row.
        rng = np.random.default_rng(draft_len * 10 + ngram)
        buf = rng.integers(0, 6, (6, 40))
        buf[1, 20:30] = buf[1, 5:15]
        buf[2] = np.tile([3, 1, 4], 14)[:40]
        filled = np.array([1, 30, 40, 17, 25, 8])
        fin = np.array([False, False, False, True, False, False])
        got = pt._prompt_lookup_draft(
            torch.as_tensor(buf), torch.as_tensor(filled),
            torch.as_tensor(fin), draft_len, ngram,
            mask_history=mask_history)
        want = jt._prompt_lookup_draft(
            jnp.asarray(buf, jnp.int32), jnp.asarray(filled, jnp.int32),
            jnp.asarray(fin), draft_len, ngram, mask_history=mask_history)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.shape == (6, draft_len)


class TestDecodeChunk:
    @pytest.mark.parametrize("kw", [
        {}, {"rope": True, "n_kv_heads": 1}, {"dtype": "bfloat16"},
        {"kv_quant": "int8"},
    ], ids=["f32", "rope_mqa", "bf16", "int8_kv"])
    @pytest.mark.parametrize("c", [4, 11], ids=["short", "two_tiles"])
    def test_bitwise_equal_to_sequential_decode_steps(self, kw, c):
        cfg = _cfg(**kw)
        p = _params(cfg, 1)
        b, pos0 = 2, 3
        toks = torch.as_tensor(
            np.random.default_rng(0).integers(0, cfg.vocab, (b, c)))
        c1 = pt.init_kv_cache(cfg, b, dtype=cfg.compute_dtype, device="cpu")
        c2 = pt.init_kv_cache(cfg, b, dtype=cfg.compute_dtype, device="cpu")
        lc, _ = pt.decode_chunk(p, c1, toks, pos0, cfg)
        ls = torch.stack([pt.decode_step(p, c2, toks[:, i], pos0 + i, cfg)[0]
                          for i in range(c)], dim=1)
        assert torch.equal(lc, ls)
        for l1, l2 in zip(c1, c2):
            for k in l1:
                assert torch.equal(l1[k], l2[k]), k

    def test_rejects_ring_cache(self):
        cfg = _cfg(window=8)
        cache = pt.init_kv_cache(cfg, 1, device="cpu")
        with pytest.raises(NotImplementedError, match="ring"):
            pt.decode_chunk(_params(cfg, 0), cache,
                            torch.zeros((1, 3), dtype=torch.long), 0, cfg)


class TestSpeculativeGeneration:
    @pytest.mark.parametrize("kw", [
        {}, {"rope": True, "n_kv_heads": 1}, {"dtype": "bfloat16"},
    ], ids=["f32", "rope_mqa", "bf16"])
    @pytest.mark.parametrize("kind", ["repetitive", "random"])
    def test_bitwise_equal_to_plain_greedy(self, kw, kind):
        # bf16 too: the decode tile makes the verify chunk's arithmetic
        # the one-token step's, so no near-tie can break differently.
        cfg = _cfg(**kw)
        p = _params(cfg, 3)
        pr = _prompts(cfg)[0 if kind == "repetitive" else 1]
        prompt = torch.as_tensor(pr[None])
        base = pt.generate(p, prompt, 18, cfg)
        spec = pt.generate_speculative(p, prompt, 18, cfg, draft_len=6)
        assert torch.equal(base, spec)

    def test_full_int8_stack_composition(self):
        cfg = _cfg(kv_quant="int8", dtype="bfloat16")
        p = quantize_params_int8(_params(cfg, 4))
        prompt = torch.as_tensor(np.tile([7, 2, 31], 5)[None])
        assert torch.equal(
            pt.generate(p, prompt, 12, cfg),
            pt.generate_speculative(p, prompt, 12, cfg, draft_len=5))

    def test_draft_len_sweep_all_exact(self):
        cfg = _cfg()
        p = _params(cfg, 5)
        prompt = torch.as_tensor(np.tile([1, 2, 3, 4, 5], 4)[None])
        base = pt.generate(p, prompt, 16, cfg)
        for dl in (2, 3, 8):
            spec = pt.generate_speculative(p, prompt, 16, cfg, draft_len=dl)
            assert torch.equal(base, spec), dl

    def test_matches_the_jax_generate_speculative(self):
        # The same weights in both frameworks: tokens agree up to any
        # point where the JAX model's top two logits are within 1e-4.
        jcfg = jt.TransformerConfig(**BASE, rope=True, n_kv_heads=1)
        cfg = _cfg(rope=True, n_kv_heads=1)
        jparams = jt.init_params(jcfg, seed=7)
        params = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                         cfg, device="cpu")
        prompts = _prompts(cfg)
        want = np.asarray(jt.generate_speculative(
            jparams, jnp.asarray(prompts, jnp.int32), 14, jcfg, draft_len=5))
        got = pt.generate_speculative(params, torch.as_tensor(prompts), 14,
                                      cfg, draft_len=5).numpy()
        for i in range(len(prompts)):
            if (want[i] == got[i]).all():
                continue
            j = int(np.argmin(want[i] == got[i]))
            seq = np.concatenate([prompts[i], want[i, :j]])[None]
            lg = np.sort(np.asarray(jt.forward(
                jparams, jnp.asarray(seq, jnp.int32), jcfg))[0, -1])
            assert lg[-1] - lg[-2] <= 1e-4, \
                f"sequence {i} diverges at token {j} off a near-tie"

    def test_sampled_spec_kernel_preserves_distribution(self):
        # Delta-draft speculative sampling on the pure kernel: the first
        # emitted token is p0-distributed, the first draft is accepted
        # with probability p0(d0), the token at position 1 (given the
        # chain reached it) is p1-distributed, and a rejection never
        # re-emits the rejected draft. n = 20000: 0.015 is > 4 sigma.
        rng = np.random.default_rng(0)
        v, c = 7, 4
        lp = torch.log_softmax(
            torch.as_tensor(rng.standard_normal((c, v)), dtype=torch.float32),
            dim=-1)
        drafts = torch.tensor([2, 5, 2])
        gen = torch.Generator().manual_seed(1)
        n = 20_000
        draws = [pt._spec_emit(lp, drafts, gen) for _ in range(n)]
        emit = torch.stack([e for e, _ in draws]).numpy()
        m = np.array([int(k) for _, k in draws])
        p0, p1 = lp[0].exp().numpy(), lp[1].exp().numpy()
        np.testing.assert_allclose(np.bincount(emit[:, 0], minlength=v) / n,
                                   p0, atol=0.015)
        np.testing.assert_allclose((m >= 1).mean(), p0[2], atol=0.015)
        reached = m >= 1
        np.testing.assert_allclose(
            np.bincount(emit[reached, 1], minlength=v) / reached.sum(), p1,
            atol=0.02)
        assert not (emit[m == 0, 0] == 2).any()

    def test_sampled_draws_a_fixed_count_a_chunk(self):
        # Whatever the chunk accepts, one call advances the generator by
        # the same amount: C - 1 uniforms, C - 1 resample rows, one bonus.
        lp = torch.log_softmax(torch.randn(5, 9), dim=-1)
        for drafts in (torch.tensor([0, 1, 2, 3]), torch.tensor([8, 8, 8, 8])):
            gen = torch.Generator().manual_seed(2)
            pt._spec_emit(lp, drafts, gen)
            after = torch.rand(3, generator=gen)
            ref = torch.Generator().manual_seed(2)
            torch.rand(4, generator=ref)
            torch.rand(4 * 9 + 9, generator=ref)
            assert torch.equal(after, torch.rand(3, generator=ref))

    def test_sampled_spec_end_to_end(self):
        cfg = _cfg()
        p = _params(cfg, 6)
        prompt = torch.as_tensor(np.tile([3, 8, 1, 4], 5)[None])

        def run(seed):
            return pt.generate_speculative(p, prompt, 16, cfg, draft_len=5,
                                           temperature=0.8, seed=seed)

        out = run(11)
        assert out.shape == (1, 16)
        assert 0 <= int(out.min()) and int(out.max()) < cfg.vocab
        assert torch.equal(out, run(11))
        assert not torch.equal(out, run(12))

    @pytest.mark.parametrize("kw", [
        {}, {"rope": True, "n_kv_heads": 1}, {"kv_quant": "int8"},
    ], ids=["f32", "rope_mqa", "int8_kv"])
    def test_batched_matches_per_sequence_runs(self, kw):
        cfg = _cfg(**kw)
        p = _params(cfg, 9)
        batch = torch.as_tensor(_prompts(cfg))
        spec = pt.generate_speculative(p, batch, 14, cfg, draft_len=5)
        assert torch.equal(spec, pt.generate(p, batch, 14, cfg))
        for i in range(3):
            solo = pt.generate_speculative(p, batch[i:i + 1], 14, cfg,
                                           draft_len=5)
            assert torch.equal(spec[i:i + 1], solo), i

    def test_skewed_batch_freezes_finished_sequences(self):
        # A finished sequence freezes: its verify-chunk count stops at its
        # own finish (the same count it takes alone), the slowest
        # member's equals the loop's iterations, and outputs stay exact.
        cfg = _cfg()
        p = _params(cfg, 9)
        batch = torch.as_tensor(_prompts(cfg))
        out, stats = pt.generate_speculative(p, batch, 14, cfg, draft_len=5,
                                             return_stats=True)
        assert torch.equal(out, pt.generate(p, batch, 14, cfg))
        v = stats["verify_chunks"].numpy()
        assert v.max() == stats["iterations"] and v.min() >= 1
        assert v.min() < v.max(), v  # the batch is skewed: someone froze
        for i in range(3):
            _, solo = pt.generate_speculative(p, batch[i:i + 1], 14, cfg,
                                              draft_len=5, return_stats=True)
            assert solo["iterations"] == v[i], i

    def test_guards(self):
        cfg = _cfg()
        p = _params(cfg, 0)
        pr = torch.zeros((1, 8), dtype=torch.long)
        with pytest.raises(NotImplementedError, match="dense cache"):
            pt.generate_speculative(p, pr, 4, _cfg(window=8))
        with pytest.raises(ValueError, match="ngram"):
            pt.generate_speculative(p, pr[:, :1], 4, cfg)
        with pytest.raises(ValueError, match="draft_len"):
            pt.generate_speculative(p, pr, 4, cfg, draft_len=1)
        with pytest.raises(ValueError, match="max_len"):
            pt.generate_speculative(p, pr, cfg.max_len, cfg)
        # The JAX package's refusal, in its words.
        with pytest.raises(NotImplementedError,
                           match="doesn't fit the MoE router's"):
            pt.generate_speculative(p, pr, 4, _cfg(n_experts=2))
