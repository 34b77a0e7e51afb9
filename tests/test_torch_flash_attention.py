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
import re
from pathlib import Path

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


# Head dims the kernels are not built for, which the wrapper zero-pads on
# the card: (Sq, Skv, H, Hk, D, Dv, causal, window).
PADDED = {
    "d16": (40, 40, 4, 2, 16, 16, True, 0),
    "d32": (40, 40, 4, 2, 32, 32, True, 0),
    "d96": (33, 47, 4, 2, 96, 96, False, 0),
    "d32_dv16": (24, 50, 4, 2, 32, 16, False, 0),
    "d32_window": (48, 48, 4, 1, 32, 32, True, 8),
    "d160": (24, 24, 2, 1, 160, 160, True, 0),
    # Above 256, the wide kernels' widths: each dim to a multiple of 64.
    "d320": (24, 24, 2, 1, 320, 320, True, 0),
    "d384_dv128": (20, 30, 2, 2, 384, 128, False, 0),
    # DeepSeek-V3's absorbed-MLA widths (chip_smoke's mla_d576_dv512): q
    # and k 576 wide, v 512, one KV head.
    "mla_d576_dv512": (96, 96, 4, 1, 576, 512, True, 0),
}


@pytest.mark.parametrize("name", list(PADDED))
def test_padding_to_the_kernel_head_dims_changes_nothing(name):
    # _padded_fwd on the plain version: q_hat and K zero-padded to the
    # kernel head dim of D, V to that of Dv, O sliced back. Zero columns
    # add nothing to q_hat K^T or P V: within 1e-6 of the unpadded plain
    # version (f32), and within the module's TOL of the JAX package's
    # flash_attention (its Pallas kernel in interpret mode, which pads to
    # its own 128-lane tile).
    sq, skv, h, hk, d, dv, causal, window = PADDED[name]
    q, k, v = _inputs(20, sq, skv, h, hk, d, dv)
    q_hat, kt, vt = pfa._prepare(*(x[None] for x in _t(q, k, v)), causal,
                                 None, window)
    widths = []

    def plain(qp, kp, vp, c, w):
        widths.append((qp.shape[-1], kp.shape[-1], vp.shape[-1]))
        return pfa.flash_attention_reference(qp, kp, vp, c, w)

    o, lse = pfa._padded_fwd(plain, q_hat, kt, vt, causal, window)
    dp, dvp = pfa._kernel_head_dims(d, dv)
    assert widths == [(dp, dp, dvp)]
    assert dp in pfa.KERNEL_HEAD_DIMS or pfa._is_wide(dp, dvp)
    assert o.shape == (1, sq, h, dv) and o.is_contiguous()
    o_ref, lse_ref = pfa.flash_attention_reference(q_hat, kt, vt, causal,
                                                   window)
    np.testing.assert_allclose(o.numpy(), o_ref.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), atol=1e-6,
                               rtol=0)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, window=window,
                               interpret=True))
    np.testing.assert_allclose(o[0].numpy(), ref, **TOL)


@pytest.mark.parametrize("d, width", [(1, 64), (16, 64), (64, 64), (65, 128),
                                      (96, 128), (128, 128), (129, 256),
                                      (256, 256)])
def test_kernel_head_dim_is_the_smallest_that_holds(d, width):
    assert pfa._kernel_head_dim(d, "D") == width


@pytest.mark.parametrize("d", [129, 160, 256])
def test_head_dims_above_128_raise_naming_c3(d, monkeypatch):
    # The fault this test pinned (ROADMAP Queue C, C3: D in (128, 256]
    # raised on the card) is repaired: the reference pads D in (128, 256]
    # to 256, and so does the wrapper now, D and Dv together, for the
    # kernels' D = Dv = 256 instantiation; nothing raises.
    assert pfa._kernel_head_dim(d, "D") == 256
    assert pfa._kernel_head_dims(d, 64) == pfa._kernel_head_dims(64, d) \
        == (256, 256)
    seen = []

    def fake_launch(q_hat, k, v, causal, window):
        seen.append((q_hat.shape[-1], k.shape[-1], v.shape[-1]))
        b, sq, h, _ = q_hat.shape
        return (torch.empty((b, sq, h, v.shape[-1]), device=q_hat.device),
                torch.empty((b, h, sq), device=q_hat.device))

    monkeypatch.setattr(pfa, "_launch", fake_launch)
    q = torch.zeros((1, 8, 2, d), device="meta")
    v = torch.zeros((1, 8, 2, 32), device="meta")
    out = pfa.flash_attention(q, q, v, causal=True)
    assert seen == [(256, 256, 256)] and out.shape == (1, 8, 2, 32)


@pytest.mark.parametrize("d, width", [(257, 320), (320, 320), (384, 384)])
def test_head_dims_above_256_raise_naming_c4(d, width, monkeypatch):
    # The fault this test pinned (ROADMAP Queue C, C4: D or Dv above 256
    # raised on the card) is repaired: the reference pads such a head dim
    # to its 128-lane tile and takes it, and the wrapper now pads D and Dv
    # each on its own to a multiple of 64 for the wide kernels; nothing
    # raises, and the other dim keeps its own width.
    assert pfa._kernel_head_dim(d, "D") == width
    assert pfa._kernel_head_dims(64, d) == (64, width)
    assert pfa._kernel_head_dims(d, 128) == (width, 128)
    assert pfa._is_wide(*pfa._kernel_head_dims(d, 16))
    assert not pfa._is_wide(*pfa._kernel_head_dims(256, 256))
    seen = []

    def fake_launch(q_hat, k, v, causal, window):
        seen.append((q_hat.shape[-1], k.shape[-1], v.shape[-1]))
        b, sq, h, _ = q_hat.shape
        return (torch.empty((b, sq, h, v.shape[-1]), device=q_hat.device),
                torch.empty((b, h, sq), device=q_hat.device))

    monkeypatch.setattr(pfa, "_launch", fake_launch)
    q = torch.zeros((1, 8, 2, d), device="meta")
    v = torch.zeros((1, 8, 2, 32), device="meta")
    out = pfa.flash_attention(q, q, v, causal=True)
    assert seen == [(width, width, 64)] and out.shape == (1, 8, 2, 32)


def _kernel_constant(name, source="flash_attention_wide.cu"):
    text = (Path(__file__).resolve().parents[1] / "marlin_tpu_torch" / "csrc"
            / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("width", [64, 128, 320, 512, 576, 640, 704, 1024,
                                   1088, 2048])
def test_wide_column_chunks_follow_the_kernels_split(width):
    # The wide kernels' CTAs along the output's columns (out_chunks and
    # OutSplit of csrc/flash_attention_wide.cu for bf16, share_of of
    # csrc/flash_fwd_dq_f32.cuh for f32), which the wrapper sizes the
    # forward's per-CTA lse copies by: 64-column boxes, as evenly as whole
    # boxes allow. bf16: at most two consumers of kMaxBoxes boxes a CTA
    # (640 columns), one CTA up to 640 and two of 512 at 1024; each CTA's
    # first consumer takes ceil(n / 2) of its n boxes. f32: at most
    # kMaxBoxes boxes of csrc/flash_f32.cuh a CTA (512 columns), one CTA up
    # to 512 and two of 512 at 1024.
    assert pfa.WIDE_BF16_COLUMNS == 2 * _kernel_constant("kMaxBoxes") * 64
    assert pfa.F32_COLUMNS == _kernel_constant("kMaxBoxes",
                                               "flash_f32.cuh") * 64
    for dtype in (torch.bfloat16, torch.float32):
        chunks = pfa._wide_column_chunks(width, dtype)
        assert chunks[0][0] == 0
        assert all(a + n == b for (a, n), (b, _) in zip(chunks, chunks[1:]))
        assert chunks[-1][0] + chunks[-1][1] == width
        assert all(n % 64 == 0 and n > 0 for _, n in chunks)
    for dtype, most in ((torch.bfloat16, pfa.WIDE_BF16_COLUMNS),
                        (torch.float32, pfa.F32_COLUMNS)):
        cols = [n for _, n in pfa._wide_column_chunks(width, dtype)]
        assert max(cols) <= most
        assert (len(cols) == 1) == (width <= most)
        assert len(cols) == -(-width // most)
        assert max(cols) - min(cols) <= 64
    with pytest.raises(ValueError, match="multiple of 64"):
        pfa._wide_column_chunks(width + 32, torch.bfloat16)


def test_the_card_path_pads_for_the_kernel_and_slices_back(monkeypatch):
    # On a tensor that is not on the CPU the wrapper hands the kernel
    # D = 32 padded to 64 and Dv = 16 padded to 64, and returns O at
    # Dv = 16.
    seen = []

    def fake_launch(q_hat, k, v, causal, window):
        seen.append((q_hat.shape[-1], k.shape[-1], v.shape[-1]))
        b, sq, h, _ = q_hat.shape
        return (torch.empty((b, sq, h, v.shape[-1]), device=q_hat.device),
                torch.empty((b, h, sq), device=q_hat.device))

    monkeypatch.setattr(pfa, "_launch", fake_launch)
    q, k, v = (x.to("meta") for x in _t(*_inputs(21, 16, 16, 4, 2, 32, 16)))
    out = pfa.flash_attention(q, k, v, causal=True)
    assert seen == [(64, 64, 64)] and out.shape == (16, 4, 16)
