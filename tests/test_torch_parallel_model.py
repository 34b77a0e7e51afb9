"""The port's transformer under sequence parallelism and the MoE MLP
(``cfg.sequence_parallel``, ``cfg.n_experts``) against the JAX package's,
the twins of tests/test_transformer.py's SP and MoE cases, of
__graft_entry__.py's GQA x SP x remat train step, of tests/test_quant.py's
MoE case and of the long_context example's CLI.

The JAX side runs as its tests run it, jitted on the 8-device CPU mesh;
the port on ``("cpu",) * 8`` shards, its weights carried across by
``params_from_jax``. f32 losses, logits and parameters are held at 1e-5
relative of max abs; the port's SP path against its local path at the
reference's own 2e-4; bf16 losses at 1e-2 (bf16 activations, 2^-9 a
rounding, through a layer and a mean).
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marlin_tpu.models import quant as jquant
from marlin_tpu.models import transformer as jt
from marlin_tpu_torch.examples import long_context
from marlin_tpu_torch.models import convert, quantize_params_int8
from marlin_tpu_torch.models import transformer as pt
from marlin_tpu_torch.parallel import set_default_shards

N_DEV = 8
_jforward = jax.jit(jt.forward, static_argnames=("cfg",))
_jtrain = jax.jit(jt.train_step, static_argnames=("cfg",))


@pytest.fixture(autouse=True, scope="module")
def _cpu_shards():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    set_default_shards(("cpu",) * N_DEV)
    yield
    set_default_shards(None)
    torch.set_num_threads(n)


def _cfgs(**kw):
    cfg = jt.TransformerConfig(**kw)
    return cfg, pt.TransformerConfig(**cfg._asdict())


def _params(cfg, pcfg, seed):
    jp = jt.init_params(cfg, seed=seed)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), pcfg,
                                       device="cpu")


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _held_params(jp, pp, rtol=1e-5):
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jp)),
                    jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), pp))):
        assert _rel(b, a) <= rtol


def _train(jp, cfg, pcfg, tok, steps, lr, rtol=1e-5):
    """``steps`` SGD steps of the JAX package's, each step of the port's
    taken from the same weights (the JAX step's input, carried across)
    and held to it: the loss and the updated weights within ``rtol``
    (1e-5: f32, summation order only; a run left to itself drifts past
    that over steps at a high learning rate). Returns (JAX losses, port
    losses, the port's last updated params)."""
    tgt = np.roll(tok, -1, axis=1)
    jl, pl = [], []
    for _ in range(steps):
        # numpy in: every step's inputs alike, so the step compiles once.
        jp = jax.tree.map(np.asarray, jp)
        pp = convert.params_from_jax(jp, pcfg, device="cpu")
        loss, jp = _jtrain(jp, tok, tgt, cfg=cfg, lr=lr)
        jl.append(float(loss))
        loss, pp = pt.train_step(pp, torch.as_tensor(tok),
                                 torch.as_tensor(tgt), pcfg, lr=lr)
        pl.append(float(loss))
        assert abs(pl[-1] - jl[-1]) / abs(jl[-1]) <= rtol
        if rtol <= 1e-5:
            _held_params(jp, pp, rtol)
    return jl, pl, pp


# (vocab 17, d_model 32, one head a shard, 1 layer): the reference's SP
# model, with and without its window.
SP = dict(vocab=17, d_model=32, n_heads=N_DEV, n_layers=1, d_ff=32,
          max_len=8 * N_DEV)
MOE = dict(vocab=17, d_model=16, n_heads=2, n_layers=1, d_ff=32,
           max_len=2 * N_DEV, n_experts=N_DEV)


@pytest.fixture(scope="module")
def sp_model():
    """The SP model's weights (JAX's seed 3) on both sides."""
    return _params(*_cfgs(**SP), seed=3)


class TestSequenceParallel:
    @pytest.mark.parametrize("window", [0, 6])
    def test_forward_matches_local(self, sp_model, window):
        # test_transformer.py:74-88 and :521-537: SP (all-to-all, the
        # window banding its local attention) against the local path.
        cfg_l, pcfg_l = _cfgs(**SP, window=window)
        jp, pp = sp_model
        tok = _tokens(0, (2, 8 * N_DEV), 17)
        logits = {}
        for sp in (False, True):
            cfg, pcfg = (c._replace(sequence_parallel=sp)
                         for c in (cfg_l, pcfg_l))
            got = pt.forward(pp, torch.as_tensor(tok), pcfg).numpy()
            assert _rel(got, _jforward(jp, jnp.asarray(tok), cfg=cfg)) \
                <= 1e-5
            logits[sp] = got
        np.testing.assert_allclose(logits[True], logits[False], rtol=2e-4,
                                   atol=2e-4)

    @pytest.mark.parametrize("window", [0, 6])
    def test_train_step(self, sp_model, window):
        # test_transformer.py:98-116 and :545-556: six SGD steps through
        # the all-to-all engine and the flash backward, each step's loss
        # and updated weights against the JAX package's; the loss falls.
        cfg, pcfg = _cfgs(**SP, sequence_parallel=True, window=window)
        jp, _ = sp_model
        tok = _tokens(1, (1, 8 * N_DEV), 17)
        _, pl, _ = _train(jp, cfg, pcfg, tok, 6, 0.1)
        assert pl[-1] < pl[0]

    def test_gqa_sp_remat_train_step_equals_local(self):
        # __graft_entry__.py:274-289: GQA x SP x remat in one step; the
        # ring takes it (2 KV heads do not divide 8 shards), and its loss
        # is the local path's.
        lcfg, plcfg = _cfgs(vocab=17, d_model=32, n_heads=4, n_kv_heads=2,
                            n_layers=1, d_ff=32, max_len=4 * N_DEV)
        jp = jt.init_params(lcfg, seed=1)
        tok = _tokens(2, (2, 4 * N_DEV), 17)
        losses = {}
        for sp in (False, True):
            cfg, pcfg = (c._replace(sequence_parallel=sp, remat=sp)
                         for c in (lcfg, plcfg))
            losses[sp] = _train(jp, cfg, pcfg, tok, 1, 0.1)[1][0]
        np.testing.assert_allclose(losses[True], losses[False], rtol=2e-4)

    def test_prefill_refuses_sp(self, sp_model):
        # The JAX package's refusal, in its words.
        cfg, pcfg = _cfgs(**SP, sequence_parallel=True)
        jp, pp = sp_model
        tok = np.zeros((1, 8), np.int64)
        for fn, p, c, t in ((jt.prefill, jp, cfg, jnp.asarray(tok)),
                            (pt.prefill, pp, pcfg, torch.as_tensor(tok))):
            with pytest.raises(NotImplementedError,
                               match="sequence-parallel decode is not "
                                     "meaningful"):
                fn(p, t, c)


@pytest.fixture(scope="module")
def moe_model():
    """The MoE model (JAX's seed 0; 8 experts, max_len 16) on both
    sides."""
    return _params(*_cfgs(**MOE), seed=0)


class TestMoE:
    def test_train_step(self, moe_model):
        # test_transformer.py:119-135: nine SGD steps at lr 0.3 through
        # the expert engine, each step's loss and updated weights (router
        # and expert banks included) against the JAX package's; the loss
        # falls.
        cfg, pcfg = _cfgs(**MOE)
        jp, pp = moe_model
        assert tuple(pp["blocks"][0]["w1"].shape) == (N_DEV, 16, 32)
        tok = _tokens(3, (2, 2 * N_DEV), 17)
        _, pl, _ = _train(jp, cfg, pcfg, tok, 9, 0.3)
        assert np.isfinite(pl[-1]) and pl[-1] < pl[0]

    def test_generate_runs(self, moe_model):
        # test_transformer.py:196-205: prefill one sequence at a time,
        # then decode steps routing the batch's B tokens together; the
        # greedy tokens are the JAX package's.
        cfg, pcfg = _cfgs(**MOE)
        jp, pp = moe_model
        prompt = _tokens(4, (2, 4), 17)
        got = pt.generate(pp, torch.as_tensor(prompt), 4, pcfg).numpy()
        assert got.shape == (2, 4) and got.min() >= 0 and got.max() < 17
        ref = np.asarray(jax.jit(jt.generate, static_argnums=(2, 3))(
            jp, jnp.asarray(prompt), 4, cfg))
        np.testing.assert_array_equal(got, ref)

    def test_composes_with_bf16_compute(self, moe_model):
        # test_transformer.py:834-849: bf16 activations through the
        # router (its softmax in f32) and the experts; the masters stay
        # f32 and the loss is the JAX package's within bf16 noise.
        cfg, pcfg = _cfgs(**dict(MOE, dtype="bfloat16"))
        jp, _ = moe_model
        tok = _tokens(5, (2, 2 * N_DEV), 17)
        _, pl, new = _train(jp, cfg, pcfg, tok, 1, 0.1, rtol=1e-2)
        assert np.isfinite(pl[0])
        assert all(p.dtype == torch.float32 for p in pt._leaves(new))

    def test_params_from_jax_round_trip(self, moe_model):
        # The expert banks and the router carry across; the port's
        # forward is the JAX package's at n_experts = 8.
        cfg, pcfg = _cfgs(**MOE)
        jp, pp = moe_model
        ref = jax.tree.map(np.asarray, jp)
        back = jax.tree.map(lambda t: t.numpy(), pp)
        assert jax.tree.structure(ref) == jax.tree.structure(back)
        for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
            np.testing.assert_array_equal(a, b)
        assert convert.expected_shapes(pcfg)["blocks"][0]["router"] == (16, 8)
        tok = _tokens(6, (2, 2 * N_DEV), 17)
        got = pt.forward(pp, torch.as_tensor(tok), pcfg).numpy()
        assert _rel(got, _jforward(jp, jnp.asarray(tok), cfg=cfg)) <= 1e-5

    @pytest.mark.parametrize("path", ["decode_chunk", "prefill_chunk",
                                      "decode_chunk_paged"])
    def test_chunk_paths_refuse_moe(self, moe_model, path):
        # The JAX package's refusals, in its words: the chunk and paged
        # paths' (B, C, D) activations do not fit the router's batch.
        cfg, pcfg = _cfgs(**MOE)
        jp, pp = moe_model
        tok = np.zeros((1, 2), np.int64)
        match = "MoE router's"
        if path == "decode_chunk_paged":
            tables = np.zeros((1, 1), np.int64)
            pool = pt.init_kv_cache(pcfg._replace(n_experts=0), 1,
                                    device="cpu")
            with pytest.raises(NotImplementedError, match=match):
                pt.decode_chunk_paged(pp, pool, torch.as_tensor(tables),
                                      torch.as_tensor(tok), 0, pcfg)
            with pytest.raises(NotImplementedError, match=match):
                jt.decode_chunk_paged(jp, jt.init_kv_cache(cfg, 1),
                                      jnp.asarray(tables), jnp.asarray(tok),
                                      0, cfg)
            return
        cache = pt.init_kv_cache(pcfg, 1, device="cpu")
        with pytest.raises(NotImplementedError, match=match):
            getattr(pt, path)(pp, cache, torch.as_tensor(tok), 0, pcfg)
        with pytest.raises(NotImplementedError, match=match):
            getattr(jt, path)(jp, jt.init_kv_cache(cfg, 1),
                              jnp.asarray(tok), 0, cfg)

    def test_quant_keeps_moe_banks_float(self, moe_model):
        # tests/test_quant.py:42: int8 quantization leaves the 3-D expert
        # banks (and the router) float, and is idempotent.
        jp, pp = moe_model
        q = quantize_params_int8(pp)
        assert quantize_params_int8(q) is q
        jq = jquant.quantize_params_int8(jp)
        for name in ("w1", "b1", "w2", "b2", "router"):
            assert not isinstance(q["blocks"][0][name], dict)
            np.testing.assert_array_equal(q["blocks"][0][name].numpy(),
                                          np.asarray(jq["blocks"][0][name]))
        assert q["blocks"][0]["w1"].dim() == 3
        assert isinstance(q["blocks"][0]["wqkv"], dict)


@pytest.mark.parametrize("argv", [["256", "8", "16"],
                                  ["256", "8", "16", "40"]])
def test_long_context_cli(argv):
    # examples/long_context.py on ("cpu",) * 8 (the default shard axis
    # here, and again through --device cpu --shards 8): both engines
    # agree and it returns 0, the JAX example's contract
    # (tests/test_examples.py:178).
    for extra in ([], ["--device", "cpu", "--shards", "8"]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = long_context.main(argv + extra)
        assert rc == 0
        text = out.getvalue()
        assert "engines agree" in text and "sharded 8-way" in text
        if len(argv) > 3:
            assert "hop-bounded" in text
