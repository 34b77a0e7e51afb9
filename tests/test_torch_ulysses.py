"""The port's all-to-all (Ulysses) engine and the sequence-parallel
dispatch (marlin_tpu_torch/parallel/ulysses.py) against the JAX
package's, the twin of tests/test_ulysses.py.

The same seeded numpy inputs go to the JAX function on the 8-device CPU
mesh and to the port on ``("cpu",) * 8`` shards. Off the TPU the JAX
package's "auto" local kernel is its XLA attention; the port's "auto" is
its flash attention, whose plain version runs on CPU tensors. One case
runs the JAX side's ``local_kernel="flash"`` (the Pallas kernel in
interpret mode) against the port's. Tolerances: f64 1e-10 (1e-9 where
the reference holds its engines at 1e-9), f32 1e-5 relative of max abs,
bf16 one output rounding (2^-8 of max abs) between the same arithmetic
and the reference's 0.05 against the f64 oracle.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marlin_tpu.parallel import ulysses as jul
from marlin_tpu.parallel.ring import ring_self_attention as j_ring
from marlin_tpu_torch.parallel import set_default_shards
from marlin_tpu_torch.parallel import ulysses as pul
from marlin_tpu_torch.parallel.ring import ring_self_attention

F64 = dict(rtol=1e-10, atol=1e-10)


@pytest.fixture(autouse=True, scope="module")
def _cpu_shards():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    set_default_shards(("cpu",) * 8)
    yield
    set_default_shards(None)
    torch.set_num_threads(n)


def oracle_mha(q, k, v, causal=False):
    """(S, H, D) multi-head attention in float64 NumPy; k/v may carry
    fewer heads (GQA)."""
    q, k, v = (np.asarray(x, np.float64) for x in (q, k, v))
    s, h, d = q.shape
    group = h // k.shape[1]
    out = np.zeros((s, h, v.shape[2]))
    for hh in range(h):
        logits = (q[:, hh] @ k[:, hh // group].T) / np.sqrt(d)
        if causal:
            mask = np.tril(np.ones((s, k.shape[0]), bool))
            logits = np.where(mask, logits, -np.inf)
        logits -= logits.max(axis=1, keepdims=True)
        p = np.exp(logits)
        out[:, hh] = (p / p.sum(axis=1, keepdims=True)) @ v[:, hh // group]
    return out


def rand_qkv(seed, s, h, d, hk=None, dtype=np.float64):
    rng = np.random.default_rng(seed)
    hk = hk or h
    return (rng.standard_normal((s, h, d)).astype(dtype),
            rng.standard_normal((s, hk, d)).astype(dtype),
            rng.standard_normal((s, hk, d)).astype(dtype))


def both(fn_j, fn_p, q, k, v, **kw):
    """(JAX result, port result) of the same call on the same arrays."""
    got_j = np.asarray(fn_j(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **kw))
    got_p = fn_p(torch.as_tensor(q), torch.as_tensor(k),
                 torch.as_tensor(v), **kw).numpy()
    return got_j, got_p


def held(got_p, got_j, want, tol=F64):
    np.testing.assert_allclose(got_p, want, **tol)
    np.testing.assert_allclose(got_p, got_j, **tol)


class TestUlyssesAttention:
    def test_matches_oracle(self):
        q, k, v = rand_qkv(0, 64, 8, 16)
        held(*both(jul.ulysses_self_attention, pul.ulysses_self_attention,
                   q, k, v), oracle_mha(q, k, v))

    def test_causal(self):
        q, k, v = rand_qkv(1, 32, 16, 8)
        held(*both(jul.ulysses_self_attention, pul.ulysses_self_attention,
                   q, k, v, causal=True), oracle_mha(q, k, v, causal=True))

    def test_output_stays_sequence_sharded(self):
        # The JAX output is sequence-sharded over the mesh; the port's is
        # assembled on q's device, shard r's stripe at rows r * S / P.
        q, k, v = rand_qkv(2, 64, 8, 4)
        got_j = jul.ulysses_self_attention(*(jnp.asarray(x)
                                             for x in (q, k, v)))
        specs = got_j.sharding.spec
        assert specs[0] is not None and specs[1] is None
        got_p = pul.ulysses_self_attention(*(torch.as_tensor(x)
                                             for x in (q, k, v)))
        assert got_p.shape == (64, 8, 4) and got_p.device.type == "cpu"
        for shard in got_j.addressable_shards:
            np.testing.assert_allclose(got_p[shard.index].numpy(),
                                       np.asarray(shard.data), **F64)

    def test_rejects_indivisible(self):
        for seed, shape, match in ((3, (60, 8, 4), "sequence length"),
                                   (4, (64, 6, 4), "head count")):
            q, k, v = rand_qkv(seed, *shape)
            for fn, cast in ((pul.ulysses_self_attention, torch.as_tensor),
                             (jul.ulysses_self_attention, jnp.asarray)):
                with pytest.raises(ValueError, match=match):
                    fn(cast(q), cast(k), cast(v))


class TestSequenceParallelDispatch:
    def test_auto_picks_all_to_all_when_heads_divide(self):
        q, k, v = rand_qkv(5, 32, 8, 8)
        held(*both(jul.sequence_parallel_attention,
                   pul.sequence_parallel_attention, q, k, v,
                   strategy="auto"), oracle_mha(q, k, v))

    def test_auto_falls_back_to_ring_for_odd_heads(self):
        # 3 heads don't divide 8 shards -> the multi-head ring.
        q, k, v = rand_qkv(6, 32, 3, 8)
        held(*both(jul.sequence_parallel_attention,
                   pul.sequence_parallel_attention, q, k, v,
                   strategy="auto"), oracle_mha(q, k, v))

    def test_ring_and_all_to_all_agree(self):
        q, k, v = rand_qkv(7, 64, 8, 8)
        tol = dict(rtol=1e-9, atol=1e-9)
        a_j, a = both(jul.sequence_parallel_attention,
                      pul.sequence_parallel_attention, q, k, v,
                      strategy="all_to_all")
        b_j, b = both(jul.sequence_parallel_attention,
                      pul.sequence_parallel_attention, q, k, v,
                      strategy="ring")
        np.testing.assert_allclose(a, b, **tol)
        np.testing.assert_allclose(a, a_j, **F64)
        np.testing.assert_allclose(b, b_j, **F64)

    def test_causal_ring_3d(self):
        q, k, v = rand_qkv(8, 32, 2, 8)
        held(*both(jul.sequence_parallel_attention,
                   pul.sequence_parallel_attention, q, k, v,
                   strategy="ring", causal=True),
             oracle_mha(q, k, v, causal=True), dict(rtol=1e-9, atol=1e-9))

    def test_unknown_strategy(self):
        q, k, v = (torch.as_tensor(x) for x in rand_qkv(9, 32, 8, 8))
        with pytest.raises(ValueError, match="unknown"):
            pul.sequence_parallel_attention(q, k, v, strategy="spiral")
        with pytest.raises(ValueError, match="unknown"):
            jul.sequence_parallel_attention(
                *(jnp.asarray(x.numpy()) for x in (q, k, v)),
                strategy="spiral")

    def test_auto_cross_attention_falls_back_to_ring(self):
        # kv length != q length: all_to_all can't express it, ring can.
        q, _, _ = rand_qkv(10, 32, 8, 8)
        _, k, v = rand_qkv(11, 64, 8, 8)
        held(*both(jul.sequence_parallel_attention,
                   pul.sequence_parallel_attention, q, k, v,
                   strategy="auto"), oracle_mha(q, k, v),
             dict(rtol=1e-9, atol=1e-9))

    def test_multihead_ring_matches_per_head_2d(self):
        q, k, v = rand_qkv(12, 32, 3, 8)
        got = pul.sequence_parallel_attention(
            *(torch.as_tensor(x) for x in (q, k, v)), strategy="ring")
        per_head = np.stack(
            [ring_self_attention(*(torch.as_tensor(x[:, h])
                                   for x in (q, k, v))).numpy()
             for h in range(3)], axis=1)
        np.testing.assert_allclose(got.numpy(), per_head, rtol=1e-12,
                                   atol=1e-12)
        ref = np.asarray(jul.sequence_parallel_attention(
            *(jnp.asarray(x) for x in (q, k, v)), strategy="ring"))
        np.testing.assert_allclose(got.numpy(), ref, **F64)


class TestSequenceParallelGQA:
    @pytest.mark.parametrize("h,hk", [(16, 8), (8, 1)])  # GQA and MQA
    def test_ring_gqa_matches_oracle(self, h, hk):
        q, k, v = rand_qkv(0, 32, h, 8, hk)
        held(*both(j_ring, ring_self_attention, q, k, v, causal=True),
             oracle_mha(q, k, v, causal=True))

    def test_ulysses_gqa_matches_oracle(self):
        q, k, v = rand_qkv(1, 32, 16, 8, 8)
        for kernel in ("xla", "auto"):
            got_j, got_p = both(jul.ulysses_self_attention,
                                pul.ulysses_self_attention, q, k, v,
                                local_kernel=kernel)
            held(got_p, got_j, oracle_mha(q, k, v))

    def test_auto_routes_gqa_by_kv_divisibility(self, monkeypatch):
        # kv heads not divisible by the shards -> the ring.
        q, k, v = rand_qkv(2, 32, 16, 8, 2)
        held(*both(jul.sequence_parallel_attention,
                   pul.sequence_parallel_attention, q, k, v, causal=True),
             oracle_mha(q, k, v, causal=True))
        # Divisible -> both engines agree, and auto routes to all_to_all
        # (spied).
        q, k, v = rand_qkv(3, 32, 16, 8, 8)
        qt, kt, vt = (torch.as_tensor(x) for x in (q, k, v))
        a = pul.sequence_parallel_attention(qt, kt, vt,
                                            strategy="all_to_all",
                                            causal=True)
        r = pul.sequence_parallel_attention(qt, kt, vt, strategy="ring",
                                            causal=True)
        np.testing.assert_allclose(a.numpy(), r.numpy(), **F64)
        called = []
        real = pul.ulysses_self_attention
        monkeypatch.setattr(pul, "ulysses_self_attention",
                            lambda *a_, **k_: (called.append(1),
                                               real(*a_, **k_))[1])
        auto = pul.sequence_parallel_attention(qt, kt, vt, causal=True)
        assert called, "auto did not route divisible GQA to all_to_all"
        np.testing.assert_allclose(auto.numpy(), a.numpy(), **F64)
        ref = np.asarray(jul.sequence_parallel_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
        np.testing.assert_allclose(auto.numpy(), ref, **F64)

    def test_ulysses_rejects_unshardable_kv_heads(self):
        q, k, v = rand_qkv(4, 32, 16, 8, 2)  # 2 kv heads, 8 shards
        for fn, cast in ((pul.ulysses_self_attention, torch.as_tensor),
                         (jul.ulysses_self_attention, jnp.asarray)):
            with pytest.raises(ValueError, match="ring engine"):
                fn(cast(q), cast(k), cast(v))

    def test_ring_gqa_grads_match_dense(self):
        # Training path: the port's autograd through the ring against the
        # JAX package's jax.grad through its ring, and against the dense
        # broadcast-heads formulation.
        q, k, v = rand_qkv(5, 16, 4, 8, 2)

        def j_loss(q, k, v):
            return jnp.sum(j_ring(q, k, v, causal=True) ** 2)

        gj = jax.grad(j_loss, argnums=(0, 1, 2))(
            *(jnp.asarray(x) for x in (q, k, v)))
        xs = [torch.as_tensor(x).requires_grad_(True) for x in (q, k, v)]
        (ring_self_attention(*xs, causal=True) ** 2).sum().backward()

        def dense_loss(q, k, v):
            kk, vv = k.repeat_interleave(2, 1), v.repeat_interleave(2, 1)
            logits = torch.einsum("shd,thd->hst", q, kk) / np.sqrt(8)
            mask = torch.tril(torch.ones(16, 16, dtype=torch.bool))
            p = torch.softmax(logits.masked_fill(~mask, -torch.inf), -1)
            return (torch.einsum("hst,thd->shd", p, vv) ** 2).sum()

        ds = [torch.as_tensor(x).requires_grad_(True) for x in (q, k, v)]
        dense_loss(*ds).backward()
        for x, d, j in zip(xs, ds, gj):
            np.testing.assert_allclose(x.grad.numpy(), d.grad.numpy(),
                                       rtol=1e-8, atol=1e-8)
            np.testing.assert_allclose(x.grad.numpy(), np.asarray(j), **F64)

    def test_flash_local_kernel_against_the_pallas_kernel(self):
        # local_kernel="flash": the JAX package's Pallas kernel in
        # interpret mode against the port's flash attention (its plain
        # version here), f32, forward and gradients.
        q, k, v = rand_qkv(6, 32, 8, 16, 8, dtype=np.float32)
        kw = dict(causal=True, local_kernel="flash")

        def j_loss(q, k, v):
            return jnp.sum(jul.ulysses_self_attention(q, k, v, **kw) ** 2)

        jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
        got_j = np.asarray(jul.ulysses_self_attention(jq, jk, jv, **kw))
        gj = jax.grad(j_loss, argnums=(0, 1, 2))(jq, jk, jv)
        xs = [torch.as_tensor(x).requires_grad_(True) for x in (q, k, v)]
        out = pul.ulysses_self_attention(*xs, **kw)
        (out ** 2).sum().backward()
        for got, ref in [(out.detach(), got_j)] + [
                (x.grad, j) for x, j in zip(xs, gj)]:
            got, ref = got.numpy().astype(np.float64), np.asarray(
                ref, np.float64)
            assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-5


class TestBF16Inputs:
    @pytest.mark.parametrize("strategy", ["ring", "all_to_all"])
    def test_bf16_tracks_oracle(self, strategy):
        q, k, v = rand_qkv(7, 32, 8, 16, dtype=np.float32)
        got = pul.sequence_parallel_attention(
            *(torch.as_tensor(x).to(torch.bfloat16) for x in (q, k, v)),
            causal=True, strategy=strategy)
        assert got.dtype == torch.bfloat16
        got = got.to(torch.float64).numpy()
        qb, kb, vb = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float64)
                      for x in (q, k, v))
        np.testing.assert_allclose(got, oracle_mha(qb, kb, vb, causal=True),
                                   rtol=0.05, atol=0.05)
        # Against the JAX package's output (its local attention off the
        # TPU is XLA's, so the port's all_to_all runs local_kernel="xla"
        # here: the flash version prescales q in bf16, as the Pallas
        # kernel does).
        ref = np.asarray(jul.sequence_parallel_attention(
            *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=True,
            strategy=strategy), np.float64)
        if strategy == "all_to_all":
            got = pul.ulysses_self_attention(
                *(torch.as_tensor(x).to(torch.bfloat16) for x in (q, k, v)),
                causal=True, local_kernel="xla").to(torch.float64).numpy()
        assert np.abs(got - ref).max() / np.abs(ref).max() <= 2.0 ** -8
