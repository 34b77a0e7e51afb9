"""The port's transformer (marlin_tpu_torch/models) against the JAX
package's, on the CPU: the same weights (carried across by
``params_from_jax``), the same numpy inputs, at f32 with 1e-5 relative
bounds on logits (the two frameworks differ only in summation order).
The JAX side's flash attention runs as its own tests run it, in interpret
mode; the port's runs its plain version.

Sampling draws differ between the frameworks (threefry vs Philox), so
the sampler is held by feeding both the same Gumbel noise and by its
empirical distribution, never token for token.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marlin_tpu.models import transformer as jt
from marlin_tpu_torch.models import convert
from marlin_tpu_torch.models import transformer as pt

# The JAX side jitted: eager op-by-op dispatch of the interpret-mode
# kernel would dominate the file's run time.
_jforward = jax.jit(jt.forward, static_argnames=("cfg",))
_jprefill = jt._prefill_jit
_jdecode_step = jax.jit(jt.decode_step, static_argnames=("cfg",))
_jdecode_chunk = jax.jit(jt.decode_chunk, static_argnames=("cfg",))

VARIANTS = {
    "pos_mha": dict(),
    "rope_gqa": dict(rope=True, n_kv_heads=2),
    "rope_window": dict(rope=True, window=8),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One intra-op thread: these tests run beside wall-clock-timed tests
    # in the parallel suite, and their shapes are too small to need more.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    base = dict(vocab=256, d_model=128, n_heads=4, n_layers=2, d_ff=256,
                max_len=64)
    base.update(kw)
    cfg = jt.TransformerConfig(**base)
    return cfg, pt.TransformerConfig(**cfg._asdict())


def _params(cfg, pcfg, seed=0):
    jp = jt.init_params(cfg, seed=seed)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), pcfg,
                                       device="cpu")


def _rel_close(got, ref, rtol=1e-5):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rtol, f"max relative error {err:.3e} > {rtol}"


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape)


class TestParamsFromJax:
    def test_round_trip_is_exact(self):
        cfg, pcfg = _cfgs(rope=True, n_kv_heads=2)
        jp, pp = _params(cfg, pcfg, seed=3)
        ref = jax.tree.map(np.asarray, jp)
        back = jax.tree.map(lambda t: t.numpy(), pp)
        assert jax.tree.structure(ref) == jax.tree.structure(back)
        for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)

    def test_layout_matches_the_ports_own_init(self):
        for kw in VARIANTS.values():
            cfg, pcfg = _cfgs(**kw)
            jp, _ = _params(cfg, pcfg)
            own = pt.init_params(pcfg, seed=0, device="cpu")
            assert jax.tree.map(np.shape, jax.tree.map(np.asarray, jp)) \
                == jax.tree.map(lambda t: tuple(t.shape), own)

    def test_mismatches_raise(self):
        cfg, pcfg = _cfgs()
        tree = jax.tree.map(np.asarray, jt.init_params(cfg, seed=0))
        _, wrong = _cfgs(d_ff=128)
        with pytest.raises(ValueError, match="w1"):
            convert.params_from_jax(tree, wrong, device="cpu")
        del tree["pos"]
        with pytest.raises(ValueError, match="keys"):
            convert.params_from_jax(tree, pcfg, device="cpu")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(variant):
    cfg, pcfg = _cfgs(**VARIANTS[variant])
    jp, pp = _params(cfg, pcfg, seed=1)
    toks = _tokens(0, (2, 24))
    ref = _jforward(jp, jnp.asarray(toks, jnp.int32), cfg)
    got = pt.forward(pp, torch.from_numpy(toks), pcfg)
    assert got.shape == (2, 24, cfg.vocab)
    _rel_close(got.numpy(), ref)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_logits_and_cache_match_jax(variant):
    # The window variant's 24-token prompt overfills its 8-slot ring:
    # only the last 8 positions survive, each at slot position mod 8.
    cfg, pcfg = _cfgs(**VARIANTS[variant])
    jp, pp = _params(cfg, pcfg, seed=2)
    toks = _tokens(1, (2, 24))
    ref_logits, ref_cache = _jprefill(jp, jnp.asarray(toks, jnp.int32), cfg)
    logits, cache = pt.prefill(pp, torch.from_numpy(toks), pcfg)
    _rel_close(logits.numpy(), ref_logits)
    assert len(cache) == cfg.n_layers
    for layer, ref_layer in zip(cache, ref_cache):
        for name in ("k", "v"):
            assert layer[name].shape == ref_layer[name].shape
            np.testing.assert_allclose(layer[name].numpy(),
                                       np.asarray(ref_layer[name]),
                                       atol=1e-5, rtol=1e-5)


def test_decode_step_teacher_forced_matches_jax():
    cfg, pcfg = _cfgs(rope=True, n_kv_heads=2)
    jp, pp = _params(cfg, pcfg, seed=4)
    prompt = _tokens(2, (2, 12))
    feed = _tokens(3, (5, 2))  # the same tokens fed to both, step by step
    _, jc = _jprefill(jp, jnp.asarray(prompt, jnp.int32), cfg)
    _, pc = pt.prefill(pp, torch.from_numpy(prompt), pcfg)
    for i, tok in enumerate(feed):
        pos = prompt.shape[1] + i
        jl, jc = _jdecode_step(jp, jc, jnp.asarray(tok, jnp.int32), pos,
                                cfg)
        pl, pc = pt.decode_step(pp, pc, torch.from_numpy(tok), pos, pcfg)
        _rel_close(pl.numpy(), jl)
    for layer, ref_layer in zip(pc, jc):
        np.testing.assert_allclose(layer["k"].numpy(),
                                   np.asarray(ref_layer["k"]),
                                   atol=1e-5, rtol=1e-5)


def test_decode_step_on_a_ring_cache_matches_jax():
    cfg, pcfg = _cfgs(rope=True, window=8)
    jp, pp = _params(cfg, pcfg, seed=5)
    prompt = _tokens(4, (1, 6))
    _, jc = _jprefill(jp, jnp.asarray(prompt, jnp.int32), cfg)
    _, pc = pt.prefill(pp, torch.from_numpy(prompt), pcfg)
    for i, tok in enumerate(_tokens(5, (7, 1))):  # wraps the 8-slot ring
        jl, jc = _jdecode_step(jp, jc, jnp.asarray(tok, jnp.int32), 6 + i,
                                cfg)
        pl, pc = pt.decode_step(pp, pc, torch.from_numpy(tok), 6 + i, pcfg)
        _rel_close(pl.numpy(), jl)


@pytest.mark.parametrize("pos", [10, [10, 7]], ids=["scalar", "per_row"])
def test_decode_chunk_matches_jax(pos):
    cfg, pcfg = _cfgs(rope=True, n_kv_heads=2)
    jp, pp = _params(cfg, pcfg, seed=6)
    prompt = _tokens(6, (2, 10))
    chunk = _tokens(7, (2, 3))
    _, jc = _jprefill(jp, jnp.asarray(prompt, jnp.int32), cfg)
    _, pc = pt.prefill(pp, torch.from_numpy(prompt), pcfg)
    jl, jc = _jdecode_chunk(jp, jc, jnp.asarray(chunk, jnp.int32),
                             jnp.asarray(pos, jnp.int32), cfg)
    pl, pc = pt.decode_chunk(pp, pc, torch.from_numpy(chunk),
                             torch.as_tensor(pos), pcfg)
    assert pl.shape == (2, 3, cfg.vocab)
    _rel_close(pl.numpy(), jl)
    for layer, ref_layer in zip(pc, jc):
        np.testing.assert_allclose(layer["v"].numpy(),
                                   np.asarray(ref_layer["v"]),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_greedy_generate_matches_jax(variant):
    cfg, pcfg = _cfgs(**VARIANTS[variant])
    jp, pp = _params(cfg, pcfg, seed=7)
    prompt = _tokens(8, (2, 12))
    ref = np.asarray(jt.generate(jp, jnp.asarray(prompt, jnp.int32), 16,
                                 cfg))
    got = pt.generate(pp, torch.from_numpy(prompt), 16, pcfg)
    assert got.shape == (2, 16)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_generate_eos_freeze_matches_jax():
    cfg, pcfg = _cfgs()
    jp, pp = _params(cfg, pcfg, seed=8)
    prompt = _tokens(9, (2, 9))
    free = pt.generate(pp, torch.from_numpy(prompt), 16, pcfg).numpy()
    eos = int(free[0, 6])  # a token row 0 emits mid-stream
    ref = np.asarray(jt.generate(jp, jnp.asarray(prompt, jnp.int32), 16,
                                 cfg, eos_id=eos))
    got = pt.generate(pp, torch.from_numpy(prompt), 16, pcfg,
                      eos_id=eos).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[0, 7:] == eos).all()


def test_bf16_forward_close_to_jax():
    # Both run bf16 matmuls with f32 layer-norm/softmax statistics, but
    # round at different places (XLA fuses, torch rounds per op) and
    # jax.nn.gelu runs in bf16 where torch's upcasts: measured max gap
    # 0.006 on logits of magnitude < 1, i.e. ~1.5 bf16 ulps. Bound: 2e-2
    # absolute, ~5 ulps at this logit scale.
    cfg, pcfg = _cfgs(rope=True, n_kv_heads=2, dtype="bfloat16")
    jp, pp = _params(cfg, pcfg, seed=9)
    toks = _tokens(10, (2, 24))
    ref = np.asarray(_jforward(jp, jnp.asarray(toks, jnp.int32), cfg),
                     np.float32)
    got = pt.forward(pp, torch.from_numpy(toks), pcfg)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - ref).max() <= 2e-2


class TestSample:
    @pytest.mark.parametrize("top_k,top_p", [(0, 0.0), (5, 0.0),
                                             (0, 0.7), (5, 0.5)])
    def test_truncation_matches_jax_given_the_same_gumbel_noise(
            self, top_k, top_p):
        # jax.random.categorical is argmax(logits + gumbel(key)): feeding
        # the port's truncation the same noise must pick the same tokens.
        logits = np.random.default_rng(11).standard_normal(
            (64, 32)).astype(np.float32) * 3
        temperature = 0.8
        key = jax.random.PRNGKey(5)
        ref = np.asarray(jt._sample(jnp.asarray(logits), temperature, key,
                                    top_k, top_p))
        gumbel = np.array(jax.random.gumbel(key, logits.shape,
                                            jnp.float32))
        lg = pt._truncate(torch.from_numpy(logits) / temperature, top_k,
                          top_p)
        got = torch.argmax(lg + torch.from_numpy(gumbel), dim=-1)
        np.testing.assert_array_equal(got.numpy(), ref)

    def test_distribution_of_the_ports_own_draws(self):
        logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, -3.0]])
        n = 20000
        gen = torch.Generator().manual_seed(0)
        draws = pt._sample(logits.expand(n, -1), 1.0, gen)
        freq = torch.bincount(draws, minlength=6).double() / n
        want = torch.softmax(logits[0].double(), -1)
        assert (freq - want).abs().max() < 0.015  # ~4 sigma at n=20000
        top2 = pt._sample(logits.expand(n, -1), 1.0, gen, top_k=2)
        assert set(top2.unique().tolist()) == {0, 1}

    def test_greedy_takes_the_first_maximum(self):
        logits = torch.tensor([[0.0, 3.0, 3.0, 1.0]])
        assert pt._sample(logits, 0.0).tolist() == [1]


@pytest.mark.parametrize("kw,exc,match,forward_match", [
    # A degree that splits no head evenly: validate_tp's refusal.
    (dict(tp=3), ValueError, "must divide", "must divide"),
])
def test_options_outside_the_slice_raise(kw, exc, match, forward_match):
    _, pcfg = _cfgs(**kw)
    with pytest.raises(exc, match=match):
        pt.init_params(pcfg, device="cpu")
    with pytest.raises(exc, match=forward_match):
        pt.forward({}, torch.zeros((1, 4), dtype=torch.long), pcfg)


@pytest.mark.parametrize("kw", [dict(n_experts=8),
                                dict(sequence_parallel=True)])
def test_parallel_options_are_accepted(kw):
    # The JAX package accepts both at init: the port's params take the
    # JAX layout (expected_shapes, the MoE banks included), and the
    # forward runs on the default shard axis, 8 CPU shards here
    # (tests/test_torch_parallel_model.py holds its values).
    from marlin_tpu_torch.parallel import set_default_shards

    cfg, pcfg = _cfgs(n_heads=8, **kw)
    params = pt.init_params(pcfg, device="cpu")
    shapes = jax.tree.map(lambda t: tuple(t.shape), params)
    assert shapes == convert.expected_shapes(pcfg)
    assert jax.tree.map(lambda a: a.shape, jt.init_params(cfg)) == shapes
    set_default_shards(("cpu",) * 8)
    try:
        out = pt.forward(params, torch.zeros((1, 16), dtype=torch.long),
                         pcfg)
    finally:
        set_default_shards(None)
    assert out.shape == (1, 16, 256) and bool(torch.isfinite(out).all())
