"""The port's tensor parallelism (marlin_tpu_torch/models/tp.py, the
transformer's ``_tp_out`` and local extents), twins of
tests/test_tp_serving.py::TestTPModelBitExact and of the GQA/RoPE
composition in tests/test_transformer.py::TestTensorParallel.

Inside the port, bitwise on the CPU: ``tp_block_outputs`` at TP = 2 and 4
equals TP = 1 at every layer boundary (attention residual, MLP residual,
logits) for the plain, RoPE + GQA and int8 models, and ``tp_forward``
under GQA and RoPE. Against the JAX package: the same weights
(``params_from_jax``) give ``tp_block_outputs`` within 1e-5 (f32) at
every degree, ``tp_shard_params``' shards equal the JAX shards'
``addressable_shards`` byte for byte, psum mode is allclose (1e-6), and
``validate_tp`` refuses with the JAX package's messages. The shard runner
fails loudly: a shard's exception reaches the caller, and a shard that
skips a collective fails the run within the barrier's timeout.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marlin_tpu.models import init_params as jax_init
from marlin_tpu.models import quantize_params_int8 as jax_quantize
from marlin_tpu.models import tp as jtp
from marlin_tpu.models import transformer as jt
from marlin_tpu_torch.models import convert
from marlin_tpu_torch.models import tp as mtp
from marlin_tpu_torch.models import transformer as pt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(tp=1, rope=False, n_heads=4, n_kv_heads=0, tp_mode="gather"):
    return dict(vocab=61, d_model=32, n_heads=n_heads, n_kv_heads=n_kv_heads,
                n_layers=2, d_ff=64, max_len=64, rope=rope, tp=tp,
                tp_mode=tp_mode)


def _cfgs(**kw):
    return jt.TransformerConfig(**_kw(**kw)), pt.TransformerConfig(**_kw(**kw))


# (name, cfg kwargs, int8): the GQA arm keeps kv_heads divisible by 4 so
# the TP = 4 arm shards whole KV-head groups.
VARIANTS = [
    ("plain", dict(), False),
    ("rope_gqa", dict(rope=True, n_heads=8, n_kv_heads=4), False),
    ("int8", dict(rope=True, n_heads=8, n_kv_heads=4), True),
]
IDS = [v[0] for v in VARIANTS]


def _params(kw, int8, seed):
    """(JAX params, the port's from the same numpy arrays) at tp 1."""
    jcfg, pcfg = _cfgs(**kw)
    jp = jax_init(jcfg, seed=seed)
    if int8:
        jp = jax_quantize(jp)
    pp = convert.params_from_jax(jax.tree.map(np.asarray, jp), pcfg,
                                 device="cpu")
    return jp, pp


def _tokens(rng, b=3, s=24):
    return rng.integers(0, 61, (b, s)).astype(np.int32)


class TestTPModelBitExact:
    @pytest.mark.parametrize("name,kw,int8", VARIANTS, ids=IDS)
    def test_block_outputs_bitexact(self, rng, name, kw, int8):
        _, params = _params(kw, int8, seed=7)
        tok = torch.as_tensor(_tokens(rng))
        ref = mtp.tp_block_outputs(params, tok, _cfgs(**kw)[1])
        for tp in (2, 4):
            got = mtp.tp_block_outputs(params, tok, _cfgs(tp=tp, **kw)[1],
                                       device="cpu")
            for what, a, b in zip(("atts", "outs", "logits"), got, ref):
                assert torch.equal(a, b), f"{name}: tp={tp} {what} diverged"

    @pytest.mark.parametrize("name,kw,int8", VARIANTS, ids=IDS)
    def test_block_outputs_match_jax(self, rng, name, kw, int8):
        jp, params = _params(kw, int8, seed=7)
        tok = _tokens(rng)
        for tp in (1, 2, 4):
            jcfg, pcfg = _cfgs(tp=tp, **kw)
            want = jtp.tp_block_outputs(jp, jnp.asarray(tok), jcfg)
            got = mtp.tp_block_outputs(params, torch.as_tensor(tok), pcfg,
                                       device="cpu")
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("name,kw,int8,mode", [
        ("rope_gqa", dict(rope=True, n_heads=8, n_kv_heads=4), False,
         "gather"),
        ("int8", dict(rope=True, n_heads=8, n_kv_heads=4), True, "gather"),
        ("int8_psum", dict(rope=True, n_heads=8, n_kv_heads=4), True,
         "psum"),
    ], ids=["rope_gqa", "int8", "int8_psum"])
    def test_shards_equal_jax_addressable_shards(self, name, kw, int8,
                                                 mode):
        jp, params = _params(kw, int8, seed=5)
        jcfg, pcfg = _cfgs(tp=4, tp_mode=mode, **kw)
        jsh = jtp.tp_shard_params(jp, jcfg)
        psh = mtp.tp_shard_params(params, pcfg, ("cpu",) * 4)
        assert isinstance(psh, mtp.Sharded) and len(psh) == 4
        jleaves = jax.tree_util.tree_leaves_with_path(jsh)
        assert len(jleaves) == len(pt._leaves(params))
        mesh_devices = list(jtp.tp_mesh(4).devices)
        for r, shard in enumerate(psh):
            for path, jl in jleaves:
                pl = shard
                for key in path:  # the same leaf of the port's tree
                    pl = pl[key.key if hasattr(key, "key") else key.idx]
                # Shard r's data: the addressable shard on device r.
                (want,) = [s.data for s in jl.addressable_shards
                           if s.device == mesh_devices[r]]
                np.testing.assert_array_equal(
                    pl.numpy(), np.asarray(want),
                    err_msg=f"{name} shard {r} {jax.tree_util.keystr(path)}")

        # Replicated leaves on the params' device are shared, not copied.
        def embed(tree):
            return tree["embed"]["q8"] if int8 else tree["embed"]

        assert all(embed(s).data_ptr() == embed(params).data_ptr()
                   for s in psh)

    def test_psum_mode_is_close_not_exact_contract(self, rng):
        kw = dict(rope=True, n_heads=8, n_kv_heads=4)
        _, params = _params(kw, False, seed=3)
        tok = torch.as_tensor(_tokens(rng, 2, 16))
        ref = mtp.tp_forward(params, tok, _cfgs(**kw)[1])
        got = mtp.tp_forward(params, tok, _cfgs(tp=2, tp_mode="psum",
                                                **kw)[1], device="cpu")
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                                   atol=1e-6)

    def test_validate_tp_rejects_unsplittable_heads(self):
        kw = dict(tp=4, n_heads=8, n_kv_heads=2)
        with pytest.raises(ValueError, match="must divide"):
            mtp.tp_forward(pt.init_params(_cfgs()[1], seed=0, device="cpu"),
                           torch.zeros((1, 4), dtype=torch.long),
                           _cfgs(**kw)[1], device="cpu")

    @pytest.mark.parametrize("extra,match", [
        (dict(tp=0), "must be >= 1"),
        (dict(tp=2, tp_mode="ring"), "unknown tp_mode"),
        (dict(tp=3), "must divide"),
        (dict(tp=2, n_experts=2), "MoE"),
        (dict(tp=2, sequence_parallel=True), "sequence_parallel"),
    ], ids=["degree", "mode", "divide", "moe", "sp"])
    def test_validate_tp_refusals_match_jax(self, extra, match):
        kw = _kw()
        kw.update(extra)
        with pytest.raises(ValueError, match=match) as pe:
            pt.validate_tp(pt.TransformerConfig(**kw))
        with pytest.raises(ValueError) as je:
            jt.validate_tp(jt.TransformerConfig(**kw))
        assert str(pe.value) == str(je.value)

    @pytest.mark.parametrize("tp", [2, 4])
    def test_tp_composes_with_gqa_and_rope(self, rng, tp):
        # test_transformer.py::TestTensorParallel's composition, bitwise:
        # two query heads a KV head at tp 2, one KV head a shard at tp 4.
        kw = dict(rope=True, n_heads=4, n_kv_heads=2 if tp == 2 else 4)
        params = pt.init_params(_cfgs(**kw)[1], seed=2, device="cpu")
        tok = torch.as_tensor(_tokens(rng, 2, 16))
        ref = mtp.tp_forward(params, tok, _cfgs(**kw)[1])
        got = mtp.tp_forward(params, tok, _cfgs(tp=tp, **kw)[1],
                             device="cpu")
        assert torch.equal(got, ref)


class TestShardRunner:
    def test_shard_failure_raises_its_own_exception(self):
        sh = mtp.Sharded([torch.ones(2)] * 3, ("cpu",) * 3)

        def body(x):
            shard = mtp.current_shard()
            if shard.rank == 1:
                raise KeyError("planted in shard 1")
            return shard.all_gather(x, 0)

        t0 = time.perf_counter()
        with pytest.raises(KeyError, match="planted in shard 1"):
            mtp.run_shards(body, sh, timeout=30)
        assert time.perf_counter() - t0 < 10  # the abort, not the timeout

    def test_skipped_collective_fails_within_the_timeout(self):
        sh = mtp.Sharded([torch.ones(2)] * 2, ("cpu",) * 2)

        def body(x):
            shard = mtp.current_shard()
            if shard.rank == 0:
                return x
            return shard.all_reduce(x)

        t0 = time.perf_counter()
        with pytest.raises(mtp.ShardsOutOfStep, match="never reached"):
            mtp.run_shards(body, sh, timeout=30)
        assert time.perf_counter() - t0 < 10  # at once, not the timeout

    def test_a_shard_that_never_hands_on_fails_within_the_timeout(self):
        sh = mtp.Sharded([torch.ones(2)] * 2, ("cpu",) * 2)
        release = threading.Event()

        def body(x):
            shard = mtp.current_shard()
            if shard.rank == 0:
                release.wait(2)  # holds its turn past shard 1's timeout
                return x
            return x

        t0 = time.perf_counter()
        with pytest.raises(mtp.ShardsOutOfStep, match="waited 0.5 s"):
            mtp.run_shards(body, sh, timeout=0.5)
        assert time.perf_counter() - t0 < 10

    def test_collectives_run_in_rank_order(self):
        sh = mtp.Sharded([torch.full((1, 2), float(r)) for r in range(4)],
                         ("cpu",) * 4)

        def body(x):
            shard = mtp.current_shard()
            return [shard.all_gather(x, -1) for _ in range(5)] \
                + [shard.all_reduce(x * 10 ** shard.rank)]

        outs = mtp.run_shards(body, sh)
        want = torch.tensor([[0., 0., 1., 1., 2., 2., 3., 3.]])
        for out in outs:
            assert all(torch.equal(g, want) for g in out[:5])
            assert torch.equal(out[5], torch.full((1, 2), 3210.))

    def test_tp_outside_a_shard_run_raises(self):
        cfg = _cfgs(tp=2)[1]
        params = pt.init_params(_cfgs()[1], seed=0, device="cpu")
        with pytest.raises(RuntimeError, match="outside a shard run"):
            pt.forward(params, torch.zeros((1, 4), dtype=torch.long), cfg)

    def test_tp_devices(self):
        cpu = torch.device("cpu")
        assert mtp.tp_devices(4, "cpu") == (cpu,) * 4
        assert mtp.tp_devices(2, ["cpu", "cpu"]) == (cpu,) * 2
        assert mtp.tp_devices(1, "cpu") == (cpu,)
        with pytest.raises(ValueError, match="2 devices for tp 3"):
            mtp.tp_devices(3, ("cpu", "cpu"))
        # No fallback: a bare "cuda" needs tp cards (or CUDA at all).
        expect = ValueError if torch.cuda.is_available() else RuntimeError
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        with pytest.raises(expect):
            mtp.tp_devices(n + 1, "cuda")

    def test_shard_cache_round_trip(self, rng):
        cfg = _cfgs(tp=2, n_heads=8, n_kv_heads=4)[1]
        glob = [{"k": torch.as_tensor(rng.standard_normal((2, 8, 4, 4))),
                 "v": torch.as_tensor(rng.standard_normal((2, 8, 4, 4)))}]
        sh = mtp.shard_cache(glob, cfg, ("cpu",) * 2)
        assert sh[1][0]["k"].shape == (2, 8, 2, 4)
        assert torch.equal(sh[1][0]["v"], glob[0]["v"][:, :, 2:])
        back = mtp.gather_heads(list(sh))
        assert torch.equal(back[0]["k"], glob[0]["k"])
        assert torch.equal(back[0]["v"], glob[0]["v"])

    def test_local_extents_size_the_cache(self):
        cfg = pt.TransformerConfig(**_kw(tp=2, n_heads=8, n_kv_heads=4))
        assert (cfg.tp_heads, cfg.tp_kv_heads, cfg.tp_ff) == (4, 2, 32)
        cache = pt.init_kv_cache(cfg, 3, device="cpu")
        assert cache[0]["k"].shape == (3, 64, 2, 4)
        assert pt.tp_units(cfg) == 4
