"""The port's ring engines (marlin_tpu_torch/parallel/ring.py) against the
JAX package's, the twin of tests/test_ring.py.

The same seeded numpy inputs go to the JAX function on the 8-device CPU
mesh and to the port. ``ring_self_attention`` runs on ``("cpu",) * 8``
shards of the single-process shard axis; ``ring_matmul`` runs on the
8-rank gloo mesh of tests/torch_dist_worker.py's "gemm" suite (shared
with test_torch_gemm.py, no launch of its own). Tolerances: f64 1e-10
(summation order only), f32 1e-5 relative of max abs, and where the
reference holds two of its own paths at 1e-4, the same for that
comparison.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from marlin_tpu.parallel.ring import ring_matmul as j_ring_matmul
from marlin_tpu.parallel.ring import ring_self_attention as j_ring
from marlin_tpu.parallel.ulysses import (
    sequence_parallel_attention as j_spa)
from marlin_tpu_torch.parallel import set_default_shards
from marlin_tpu_torch.parallel.ring import ring_hops, ring_self_attention
from marlin_tpu_torch.parallel.ulysses import sequence_parallel_attention

import torch_dist_worker

INPUTS = torch_dist_worker.make_inputs()
F64 = dict(rtol=1e-10, atol=1e-10)


@pytest.fixture(autouse=True, scope="module")
def _cpu_shards():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    set_default_shards(("cpu",) * 8)
    yield
    set_default_shards(None)
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return torch_dist_worker.shared_launch("gemm", 8, INPUTS,
                                           tmp_path_factory)


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _inputs(seed, *shapes, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


def _both(fn_j, fn_p, *arrays, **kw):
    """The JAX function and the port's on the same arrays."""
    got_j = np.asarray(fn_j(*(jnp.asarray(x) for x in arrays), **kw))
    got_p = fn_p(*(torch.as_tensor(x) for x in arrays), **kw).numpy()
    return got_j, got_p


class TestRingMatmul:
    def test_matches_oracle(self, port):
        a, b = INPUTS["ring_a"], INPUTS["ring_b"]
        got = np.asarray(port.get("ring_matmul")["matches"])
        np.testing.assert_allclose(got, a @ b, **F64)
        np.testing.assert_allclose(
            got, np.asarray(j_ring_matmul(jnp.asarray(a), jnp.asarray(b))),
            **F64)

    def test_uneven_shapes_padded(self, port):
        a, b = INPUTS["ring_ua"], INPUTS["ring_ub"]
        got = np.asarray(port.get("ring_matmul")["uneven"])
        assert got.shape == (13, 7)
        np.testing.assert_allclose(got, a @ b, **F64)
        np.testing.assert_allclose(
            got, np.asarray(j_ring_matmul(jnp.asarray(a), jnp.asarray(b))),
            **F64)

    def test_mismatch_raises(self, port):
        assert port.get("ring_matmul")["mismatch"] == "ValueError"
        with pytest.raises(ValueError):
            j_ring_matmul(jnp.asarray(INPUTS["ring_ma"]),
                          jnp.asarray(INPUTS["ring_mb"]))


def _attention_oracle(q, k, v, causal=False):
    logits = (q @ k.T) / np.sqrt(q.shape[1])
    if causal:
        mask = np.tril(np.ones((q.shape[0], k.shape[0]), bool))
        logits = np.where(mask, logits, -1e30)
    w = np.exp(logits - logits.max(axis=1, keepdims=True))
    w /= w.sum(axis=1, keepdims=True)
    return w @ v


class TestRingAttention:
    def test_full_attention(self):
        q, k, v = _inputs(0, (32, 16), (64, 16), (64, 16))
        got_j, got_p = _both(j_ring, ring_self_attention, q, k, v)
        np.testing.assert_allclose(got_p, _attention_oracle(q, k, v),
                                   rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(got_p, got_j, **F64)

    def test_causal(self):
        q, k, v = _inputs(1, (64, 8), (64, 8), (64, 8))
        got_j, got_p = _both(j_ring, ring_self_attention, q, k, v,
                             causal=True)
        np.testing.assert_allclose(
            got_p, _attention_oracle(q, k, v, causal=True), rtol=1e-8,
            atol=1e-10)
        np.testing.assert_allclose(got_p, got_j, **F64)

    def test_kv_divisibility_contract(self):
        q, k, v = _inputs(2, (8, 4), (9, 4), (9, 4))
        for fn, cast in ((ring_self_attention, torch.as_tensor),
                         (j_ring, jnp.asarray)):
            with pytest.raises(ValueError, match="must divide"):
                fn(cast(q), cast(k), cast(v))


class TestAccumulatorPrecision:
    def test_bf16_inputs_accumulate_in_f32(self):
        # The online-softmax state stays f32 across the 8 hops; only the
        # output rounds to bf16. Against the f64 oracle of the bf16-rounded
        # operands, within the reference's 8e-3; against the JAX package's
        # output within one bf16 rounding (2^-8 of max abs).
        s, d = 256, 64
        q, k, v = _inputs(3, (s, d), (s, d), (s, d), dtype=np.float32)
        qb, kb, vb = (torch.as_tensor(x).to(torch.bfloat16)
                      for x in (q, k, v))
        got = ring_self_attention(qb, kb, vb)
        assert got.dtype == torch.bfloat16
        got = got.to(torch.float64).numpy()
        qf, kf, vf = (x.to(torch.float64).numpy() for x in (qb, kb, vb))
        logits = qf @ kf.T / np.sqrt(d)
        p = np.exp(logits - logits.max(1, keepdims=True))
        oracle = (p / p.sum(1, keepdims=True)) @ vf
        assert _rel(got, oracle) < 8e-3
        ref = np.asarray(j_ring(*(jnp.asarray(x, jnp.bfloat16)
                                  for x in (q, k, v))), np.float64)
        assert _rel(got, ref) <= 2.0 ** -8


def _banded(q, k, v, w):
    s_len, d = q.shape
    logits = (q @ k.T) / np.sqrt(d)
    kp = np.arange(s_len)[None, :]
    qp = np.arange(s_len)[:, None]
    logits = np.where((kp <= qp) & (kp > qp - w), logits, -1e30)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return p @ v


class TestWindowedRing:
    def test_hop_bounded_ring_matches_banded_oracle(self):
        s_len, d, w = 64, 16, 10
        q, k, v = _inputs(4, (s_len, d), (s_len, d), (s_len, d),
                          dtype=np.float32)
        got_j, got_p = _both(j_ring, ring_self_attention, q, k, v,
                             causal=True, window=w)
        np.testing.assert_allclose(got_p, _banded(*(x.astype(np.float64)
                                                    for x in (q, k, v)), w),
                                   rtol=1e-5, atol=1e-5)
        assert _rel(got_p, got_j) <= 1e-5
        assert ring_hops(8, 8, w) == 3  # stripes of 8 rows, a band of 10

    def test_windowed_ring_multihead_and_dispatch(self):
        s_len, h, d, w = 64, 8, 16, 12
        q, k, v = _inputs(5, *[(s_len, h, d)] * 3, dtype=np.float32)
        outs = {}
        for strat in ("ring", "all_to_all"):
            got_j, got_p = _both(j_spa, sequence_parallel_attention, q, k,
                                 v, causal=True, strategy=strat, window=w)
            assert _rel(got_p, got_j) <= 1e-5
            outs[strat] = got_p
        np.testing.assert_allclose(outs["ring"], outs["all_to_all"],
                                   rtol=1e-4, atol=1e-4)

    def test_window_requires_causal_and_self_lengths(self):
        q = torch.zeros((64, 8))
        with pytest.raises(ValueError, match="causal"):
            ring_self_attention(q, q, q, window=4)
        k = torch.zeros((128, 8))
        with pytest.raises(ValueError, match="self-attention"):
            ring_self_attention(q, k, k, causal=True, window=4)

    def test_negative_window_rejected(self):
        q = torch.zeros((64, 8))
        with pytest.raises(ValueError, match=">= 0"):
            ring_self_attention(q, q, q, causal=True, window=-4)

    def test_window_one_single_hop(self):
        # window=1 attends only the diagonal: one hop, output == v.
        q, v = _inputs(6, (32, 8), (32, 8), dtype=np.float32)
        got_j, got_p = _both(j_ring, ring_self_attention, q, q, v,
                             causal=True, window=1)
        np.testing.assert_allclose(got_p, v, rtol=1e-6, atol=1e-6)
        assert _rel(got_p, got_j) <= 1e-5
        assert ring_hops(8, 4, 1) == 1
