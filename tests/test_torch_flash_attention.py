"""The port's flash-attention forward (marlin_tpu_torch/ops/flash_attention)
against the JAX package's Pallas kernel, run in interpret mode on the CPU
as tests/test_flash_attention.py runs it.

On the CPU the port's wrapper takes its plain version; these tests hold
that plain version to the Pallas kernel (f32, atol/rtol 1e-5: the two
differ only in summation order and tiling), check lse against the
kernel's saved log2-sum-exp, and pin the dispatch rule: the plain version
only for CPU tensors, the kernel or an error for anything else. The
kernel itself runs only on the card: chip_smoke.py holds it against the
plain version there.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from marlin_tpu.ops.flash_attention import (_flash_hsd_impl,
                                            effective_blocks)
from marlin_tpu.ops.flash_attention import flash_attention as jax_flash
from marlin_tpu.utils.split import pad_to_multiple as jax_pad
from marlin_tpu_torch.ops import flash_attention as pfa

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One intra-op thread: these tests run beside wall-clock-timed tests
    # in the parallel suite, and their shapes are too small to need more.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# (Sq, Skv, H, Hk, D, Dv, causal, window)
CASES = {
    "causal_mha": (40, 40, 4, 4, 32, 32, True, 0),
    "causal_gqa": (40, 40, 4, 2, 32, 32, True, 0),
    "causal_mqa": (40, 40, 4, 1, 32, 32, True, 0),
    "noncausal_mha": (33, 33, 4, 4, 16, 16, False, 0),
    "ragged_gqa": (37, 37, 4, 2, 32, 32, True, 0),
    "cross_dv": (24, 50, 4, 2, 32, 16, False, 0),
    "window": (48, 48, 4, 2, 32, 32, True, 8),
}


def _inputs(seed, sq, skv, h, hk, d, dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((sq, h, d)).astype(np.float32),
            rng.standard_normal((skv, hk, d)).astype(np.float32),
            rng.standard_normal((skv, hk, dv)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_pallas_kernel(name):
    sq, skv, h, hk, d, dv, causal, window = CASES[name]
    q, k, v = _inputs(1, sq, skv, h, hk, d, dv)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal,
                               window=window))
    got = pfa.flash_attention(*_t(q, k, v), causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (sq, h, dv)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("name", ["causal_gqa", "cross_dv", "window"])
def test_lse_matches_the_kernels_saved_lse(name):
    # _flash_hsd_impl's second output is the per-row log2-sum-exp (lane 0
    # of the TPU's lane-replicated tile, trimmed to Sq); the port returns
    # it as a plain (H, Sq) f32 tensor.
    sq, skv, h, hk, d, dv, causal, window = CASES[name]
    q, k, v = _inputs(2, sq, skv, h, hk, d, dv)
    scale = 1.0 / math.sqrt(d)
    qt, kt, vt = (jax_pad(jnp.swapaxes(jnp.asarray(x), 0, 1), 2, 128)
                  for x in (q, k, v))
    bq, bk = effective_blocks(sq, skv, 1024, 1024, window)
    _, lse_ref = _flash_hsd_impl(qt, kt, vt, causal, scale, bq, bk, True,
                                 window)
    _, lse = pfa.flash_attention_fwd(*_t(q, k, v), causal, scale, window)
    assert lse.shape == (h, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), **TOL)


def test_batch_dimension_is_a_written_out_vmap():
    # (B, S, H, D) is the port's stand-in for jax.vmap: each sequence of
    # the batch equals the Pallas kernel on that sequence alone.
    sq, skv, h, hk, d, dv, causal, window = CASES["causal_gqa"]
    seqs = [_inputs(10 + i, sq, skv, h, hk, d, dv) for i in range(3)]
    q, k, v = (torch.from_numpy(np.stack([s[j] for s in seqs]))
               for j in range(3))
    got = pfa.flash_attention(q, k, v, causal=True)
    assert got.shape == (3, sq, h, dv)
    for i, (qi, ki, vi) in enumerate(seqs):
        ref = np.asarray(jax_flash(jnp.asarray(qi), jnp.asarray(ki),
                                   jnp.asarray(vi), causal=True))
        np.testing.assert_allclose(got[i].numpy(), ref, **TOL)


def test_invalid_arguments_raise():
    q, k, v = _t(*_inputs(3, 8, 8, 4, 3, 16, 16))
    with pytest.raises(ValueError, match="GQA"):
        pfa.flash_attention(q, k, v)
    q, k, v = _t(*_inputs(3, 8, 8, 4, 2, 16, 16))
    with pytest.raises(ValueError, match="requires causal"):
        pfa.flash_attention(q, k, v, window=4)
    with pytest.raises(ValueError, match="window"):
        pfa.flash_attention(q, k, v, causal=True, window=-1)
    with pytest.raises(ValueError, match="head_dim"):
        pfa.flash_attention(q, k[..., :8], v)


class TestDispatch:
    def test_cpu_tensors_take_the_plain_version(self, monkeypatch):
        def no_kernel():
            raise AssertionError("the kernel was reached for CPU tensors")

        monkeypatch.setattr(pfa, "_kernel_lib", no_kernel)
        before = pfa.launches
        out = pfa.flash_attention(*_t(*_inputs(4, 16, 16, 4, 2, 16, 16)),
                                  causal=True)
        assert torch.isfinite(out).all()
        assert pfa.launches == before  # the counter counts kernel launches

    def test_a_failing_kernel_loader_propagates(self, monkeypatch):
        # Any non-CPU tensor goes to the kernel: when the kernel cannot be
        # built or loaded, the error reaches the caller. Nothing falls
        # back to the plain version.
        def broken_loader(name):
            raise RuntimeError(f"cannot build {name}")

        monkeypatch.setattr(pfa.build, "load", broken_loader)
        q, k, v = (x.to("meta")
                   for x in _t(*_inputs(5, 16, 16, 4, 2, 64, 64)))
        with pytest.raises(RuntimeError, match="cannot build "
                           "flash_attention_fwd"):
            pfa.flash_attention(q, k, v, causal=True)

    def test_the_wrapper_refuses_what_the_kernel_does_not_take(
            self, monkeypatch):
        monkeypatch.setattr(pfa, "_kernel_lib", lambda: None)
        meta = [x.to("meta") for x in _t(*_inputs(6, 16, 16, 4, 2, 64, 64))]
        with pytest.raises(ValueError, match="CUDA tensor"):
            pfa.flash_attention(*meta, causal=True)
        with pytest.raises(ValueError, match="head dims"):
            pfa._launch(*(x[None].to("meta") for x in _t(
                *_inputs(6, 16, 16, 4, 2, 32, 32))), True, 0)
