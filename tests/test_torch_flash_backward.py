"""The port's flash-attention backward (marlin_tpu_torch/ops/
flash_attention.py: flash_attention_bwd_reference and the autograd
Function FlashAttentionFunction) against the JAX package's Pallas
backward kernels, run in interpret mode on the CPU as
tests/test_flash_attention.py runs them.

The bound is the JAX tests' own: f32, max |port - JAX| / max |JAX| <= 2e-5
for each of dQ, dK and dV (the two differ only in summation order and
tiling). The CUDA kernels themselves run only on the card: chip_smoke.py
holds them against this plain backward there. Here the dispatch is
pinned with a monkeypatched launcher on meta tensors (any device but the
CPU goes to the kernels): the output of the kernel path carries an
autograd graph, its backward reaches the backward kernels, and a failing
kernel raises.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marlin_tpu.ops.flash_attention import (_flash_bwd_pallas,
                                            _flash_hsd_impl)
from marlin_tpu.ops.flash_attention import flash_attention as jax_flash
from marlin_tpu_torch.ops import flash_attention as pfa
from marlin_tpu_torch.utils import cost_model as pcm

ROOT = Path(__file__).resolve().parents[1]
RTOL = 2e-5


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
    "causal_mha": (64, 64, 4, 4, 32, 32, True, 0),
    "causal_gqa": (64, 64, 4, 2, 32, 32, True, 0),
    "causal_mqa": (64, 64, 4, 1, 32, 32, True, 0),
    "cross_dv": (48, 80, 4, 2, 32, 16, False, 0),
    "ragged_both": (45, 71, 4, 2, 32, 32, False, 0),
    "ragged_causal": (70, 70, 2, 2, 16, 16, True, 0),
    # Several 32-row blocks and a window whose q sweep overruns the last
    # block: the case of test_window_grads_multiblock_no_double_count.
    "window_multiblock": (160, 160, 2, 1, 16, 16, True, 40),
}


def _inputs(seed, sq, skv, h, hk, d, dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((sq, h, d)).astype(np.float32),
            rng.standard_normal((skv, hk, d)).astype(np.float32),
            rng.standard_normal((skv, hk, dv)).astype(np.float32),
            rng.standard_normal((sq, h, dv)).astype(np.float32))


def _rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _to_port(x_shd):
    """(H, S, D) JAX layout -> the port's batched (1, S, H, D)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.swapaxes(np.asarray(x_shd), 0, 1)))[None]


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_pallas_backward(name):
    # Both backwards get the same residuals: the Pallas forward's O and
    # lse, and the same prescaled q. JAX blocks of 32 (f32 interpret).
    sq, skv, h, hk, d, dv, causal, window = CASES[name]
    q, k, v, g = _inputs(1, sq, skv, h, hk, d, dv)
    scale = 1.0 / math.sqrt(d)
    qt, kt, vt = (jnp.swapaxes(jnp.asarray(x), 0, 1) for x in (q, k, v))
    out, lse = _flash_hsd_impl(qt, kt, vt, causal, scale, 32, 32, True,
                               window)
    gt = jnp.swapaxes(jnp.asarray(g), 0, 1)
    ref = _flash_bwd_pallas(qt, kt, vt, out, lse, gt, causal, scale, 32, 32,
                            True, window)
    q_hat, _, _ = pfa._prepare(*(torch.from_numpy(x)[None]
                                    for x in (q, k, v)), causal, scale,
                                  window)
    got = pfa.flash_attention_bwd_reference(
        q_hat, torch.from_numpy(k)[None], torch.from_numpy(v)[None],
        _to_port(out), torch.from_numpy(np.array(lse))[None],
        torch.from_numpy(g)[None], causal, window, scale)
    for label, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape[1:] == np.swapaxes(np.asarray(r), 0, 1).shape
        err = _rel_err(a[0].numpy(), np.swapaxes(np.asarray(r), 0, 1))
        assert err <= RTOL, (label, err)


@pytest.mark.parametrize("name", ["causal_gqa", "cross_dv", "ragged_both",
                                  "window_multiblock"])
def test_autograd_gradients_match_jax_vjp(name):
    # The public entry points end to end: the port's flash_attention
    # through torch.autograd against jax.vjp of the JAX flash_attention.
    sq, skv, h, hk, d, dv, causal, window = CASES[name]
    q, k, v, g = _inputs(2, sq, skv, h, hk, d, dv)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(
        a, b, c, causal=causal, window=window, interpret=True),
        *(jnp.asarray(x) for x in (q, k, v)))
    ref = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    out = pfa.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    for label, a, r in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                           ref):
        assert a.shape == r.shape and a.dtype == torch.float32
        assert _rel_err(a.numpy(), r) <= RTOL, label


# Head dims the kernels are not built for, which the wrapper zero-pads on
# the card: (Sq, Skv, H, Hk, D, Dv, causal, window).
PADDED = {
    "d16": (40, 40, 4, 2, 16, 16, True, 0),
    "d32": (48, 48, 4, 2, 32, 32, True, 0),
    "d96": (33, 47, 4, 2, 96, 96, False, 0),
    "d32_dv16": (24, 50, 4, 2, 32, 16, False, 0),
    "d32_window": (64, 64, 4, 1, 32, 32, True, 16),
    "d160": (24, 24, 2, 1, 160, 160, True, 0),
    # Above 256, the wide kernels' widths: each dim to a multiple of 64.
    "d320": (24, 24, 2, 1, 320, 320, True, 0),
    "d384_dv128": (20, 30, 2, 2, 384, 128, False, 0),
    # DeepSeek-V3's absorbed-MLA widths (chip_smoke's mla_d576_dv512): q
    # and k 576 wide, v 512, one KV head.
    "mla_d576_dv512": (96, 96, 4, 1, 576, 512, True, 0),
}


@pytest.mark.parametrize("name", list(PADDED))
def test_padding_to_the_kernel_head_dims_changes_no_gradient(name):
    # _padded_bwd on the plain backward (_bwd_reference, the plain twin of
    # _launch_bwd): q_hat and K zero-padded to the kernel head dim of D, V
    # and dO to that of Dv, dQ, dK, dV sliced back, Delta and the scale
    # those of the unpadded inputs. Within 1e-6 of the unpadded plain
    # backward (f32), and within RTOL of jax.vjp of the JAX package's
    # flash_attention (its Pallas kernels in interpret mode, which pad to
    # their own 128-lane tile).
    sq, skv, h, hk, d, dv, causal, window = PADDED[name]
    q, k, v, g = _inputs(30, sq, skv, h, hk, d, dv)
    scale = 1.0 / math.sqrt(d)
    q_hat, kt, vt = pfa._prepare(*(torch.from_numpy(x)[None]
                                   for x in (q, k, v)), causal, scale,
                                 window)
    do = torch.from_numpy(g)[None]
    o, lse = pfa.flash_attention_reference(q_hat, kt, vt, causal, window)
    delta = pfa._delta(do, o)
    widths = []

    def plain(*args):
        widths.append(tuple(x.shape[-1] for x in args[:4]))
        return pfa._bwd_reference(*args)

    got = pfa._padded_bwd(plain, q_hat, kt, vt, do, lse, delta, causal,
                          window, scale)
    dp, dvp = pfa._kernel_head_dims(d, dv)
    assert widths == [(dp, dp, dvp, dvp)]
    ref = pfa.flash_attention_bwd_reference(q_hat, kt, vt, o, lse, do,
                                            causal, window, scale)
    for label, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == r.shape and a.is_contiguous(), label
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=1e-6, rtol=0,
                                   err_msg=label)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(
        a, b, c, causal=causal, window=window, interpret=True),
        *(jnp.asarray(x) for x in (q, k, v)))
    for label, a, r in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(g))):
        assert _rel_err(a[0].numpy(), r) <= RTOL, label


def test_mla_widths_match_jax_forward_and_gradients():
    # The public flash_attention at the widths of chip_smoke's
    # mla_d576_dv512 shape (DeepSeek-V3's absorbed multi-head latent
    # attention: q and k 576 wide, v 512, one KV head), cut to 4 heads and
    # 96 positions, causal: O and, through torch.autograd, dQ, dK and dV
    # against the JAX package's flash_attention and jax.vjp (its Pallas
    # kernels in interpret mode, which pad D to 640). f32, 1e-5.
    sq, h, hk, d, dv = 96, 4, 1, 576, 512
    q, k, v, g = _inputs(41, sq, sq, h, hk, d, dv)
    ref, vjp = jax.vjp(lambda a, b, c: jax_flash(
        a, b, c, causal=True, interpret=True),
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    out = pfa.flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    out.backward(torch.from_numpy(g))
    for label, a, r in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                           vjp(jnp.asarray(g))):
        assert a.shape == r.shape, label
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=1e-5, err_msg=label)


def test_strided_incoming_gradient():
    # Autograd may hand the backward a non-contiguous gradient (here the
    # transpose of a contiguous one); the Function makes it contiguous.
    sq, skv, h, hk, d, dv, causal, window = CASES["causal_gqa"]
    q, k, v, g = _inputs(3, sq, skv, h, hk, d, dv)
    grads = []
    for strided in (False, True):
        tq = torch.from_numpy(q).requires_grad_(True)
        out = pfa.flash_attention(tq, torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True)
        gg = torch.from_numpy(g)
        if strided:
            gg = gg.transpose(0, 1).contiguous().transpose(0, 1)
            assert not gg.is_contiguous()
        out.backward(gg)
        grads.append(tq.grad)
    assert torch.equal(grads[0], grads[1])


def test_saves_no_tensor_with_two_sequence_dimensions():
    # The counterpart of test_no_s_squared_buffer_in_jaxpr: what the
    # Function keeps between forward and backward is (q_hat, k, v, o,
    # lse), none of which spans both the query and the key axis.
    sq, skv, h, hk, d, dv = 40, 56, 4, 2, 16, 16
    q, k, v, _ = _inputs(4, sq, skv, h, hk, d, dv)
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = pfa.flash_attention(tq, tk, tv, causal=True)
    assert shapes, "nothing saved: the graph did not go through autograd"
    for shape in shapes:
        assert not (sq in shape and skv in shape), shape
    out.sum().backward()  # and the backward still runs from what was kept
    assert torch.isfinite(tk.grad).all()


def test_no_grad_and_frozen_inputs_take_the_direct_path():
    q, k, v, _ = (torch.from_numpy(x)
                  for x in _inputs(5, 16, 16, 4, 2, 16, 16))
    assert pfa.flash_attention(q, k, v, causal=True).grad_fn is None
    with torch.no_grad():
        out = pfa.flash_attention(q.requires_grad_(True), k, v, causal=True)
    assert out.grad_fn is None
    o, lse = pfa.flash_attention_fwd(q, k, v, causal=True)
    assert o.grad_fn is not None and not lse.requires_grad


class TestDispatch:
    @staticmethod
    def _meta(seed, **kw):
        return [torch.from_numpy(x).to("meta").requires_grad_(True)
                for x in _inputs(seed, 16, 16, 4, 2, 64, 64)[:3]]

    @staticmethod
    def _fake_forward(q_hat, k, v, causal, window):
        b, sq, h, _ = q_hat.shape
        return (torch.empty((b, sq, h, v.shape[3]), dtype=q_hat.dtype,
                            device=q_hat.device),
                torch.empty((b, h, sq), dtype=torch.float32,
                            device=q_hat.device))

    def test_kernel_path_output_carries_a_graph_to_the_bwd_kernels(
            self, monkeypatch):
        # The repaired fault: before the autograd Function, the kernel's
        # output had no grad_fn, so loss.backward() on the card silently
        # gave wqkv no gradient through attention.
        calls = []

        def fake_bwd(q_hat, k, v, do, lse, delta, causal, window, scale):
            calls.append((tuple(delta.shape), causal, window, scale))
            return (torch.zeros_like(q_hat), torch.zeros_like(k),
                    torch.zeros_like(v))

        monkeypatch.setattr(pfa, "_launch", self._fake_forward)
        monkeypatch.setattr(pfa, "_launch_bwd", fake_bwd)
        q, k, v = self._meta(6)
        out = pfa.flash_attention(q, k, v, causal=True)
        assert out.device.type == "meta" and out.grad_fn is not None
        out.backward(torch.empty_like(out))
        assert calls == [((1, 4, 16), True, 0, 1.0 / 8.0)]
        assert q.grad.shape == q.shape and k.grad.shape == k.shape

    def test_the_card_backward_pads_for_the_kernels_and_slices_back(
            self, monkeypatch):
        # D = 32 and Dv = 16 on a tensor that is not on the CPU: the
        # backward kernels get q_hat, K, V and dO padded to 64, the scale
        # of D = 32 and Delta of the unpadded dO and O; the gradients come
        # back at the inputs' own widths. The Function saves the unpadded
        # tensors only.
        calls = []

        def fake_bwd(q_hat, k, v, do, lse, delta, causal, window, scale):
            calls.append((q_hat.shape[-1], k.shape[-1], v.shape[-1],
                          do.shape[-1], tuple(delta.shape), scale))
            return (torch.zeros_like(q_hat), torch.zeros_like(k),
                    torch.zeros_like(v))

        monkeypatch.setattr(pfa, "_launch", self._fake_forward)
        monkeypatch.setattr(pfa, "_launch_bwd", fake_bwd)
        q, k, v = (torch.from_numpy(x).to("meta").requires_grad_(True)
                   for x in _inputs(12, 16, 16, 4, 2, 32, 16)[:3])
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
            out = pfa.flash_attention(q, k, v, causal=True)
        assert out.shape == (16, 4, 16)
        assert saved and not any(64 in shape for shape in saved), saved
        out.backward(torch.empty_like(out))
        assert calls == [(64, 64, 64, 64, (1, 4, 16), 1.0 / math.sqrt(32))]
        assert (q.grad.shape, k.grad.shape, v.grad.shape) == (
            q.shape, k.shape, v.shape)

    def test_a_failing_bwd_kernel_raises(self, monkeypatch):
        def broken_loader(name):
            raise RuntimeError(f"cannot build {name}")

        monkeypatch.setattr(pfa, "_launch", self._fake_forward)
        monkeypatch.setattr(pfa.build, "load", broken_loader)
        q, k, v = self._meta(7)
        out = pfa.flash_attention(q, k, v, causal=True)
        with pytest.raises(RuntimeError,
                           match="cannot build flash_attention_bwd"):
            out.backward(torch.empty_like(out))

    def test_the_bwd_wrappers_refuse_what_the_kernels_do_not_take(
            self, monkeypatch):
        monkeypatch.setattr(pfa, "_bwd_lib", lambda: None)
        q, k, v, do = (torch.from_numpy(x)[None].to("meta")
                       for x in _inputs(8, 16, 16, 4, 2, 64, 64))
        lse = torch.empty((1, 4, 16), device="meta")
        with pytest.raises(ValueError, match="CUDA tensor"):
            pfa._launch_bwd_dq(q, k, v, do, lse, lse, True, 0, 0.125)
        with pytest.raises(ValueError, match="the kernel takes"):
            pfa._launch_bwd_dkv(q, k, v, do, lse.double(), lse, True, 0)
        with pytest.raises(ValueError, match="head dims"):
            pfa._launch_bwd_dkv(q[..., :32], k[..., :32], v, do, lse, lse,
                                True, 0)
        with pytest.raises(ValueError, match="do has shape"):
            pfa._launch_bwd_dq(q, k, v, do[:, :8], lse, lse, True, 0, 0.125)
        with pytest.raises(ValueError, match="delta has shape"):
            pfa._launch_bwd_dkv(q, k, v, do, lse, lse[..., :8], True, 0)

    def test_cpu_backward_reaches_no_kernel(self, monkeypatch):
        def no_kernel(*args):
            raise AssertionError("a kernel was reached for CPU tensors")

        monkeypatch.setattr(pfa, "_launch_bwd", no_kernel)
        monkeypatch.setattr(pfa, "_kernel_lib", no_kernel)
        before = (pfa.launches, pfa.bwd_dq_launches, pfa.bwd_dkv_launches)
        q, k, v, _ = (torch.from_numpy(x).requires_grad_(True)
                      for x in _inputs(9, 16, 16, 4, 2, 16, 16))
        pfa.flash_attention(q, k, v, causal=True).sum().backward()
        assert torch.isfinite(q.grad).all()
        assert (pfa.launches, pfa.bwd_dq_launches,
                pfa.bwd_dkv_launches) == before


def test_delta_is_rowsum_of_do_times_o_in_f32():
    rng = np.random.default_rng(10)
    do, o = (torch.from_numpy(rng.standard_normal((2, 5, 3, 8))
                              .astype(np.float32)).to(torch.bfloat16)
             for _ in range(2))
    got = pfa._delta(do, o)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 5)
    want = (do.float() * o.float()).sum(-1).transpose(1, 2)
    assert torch.equal(got, want)
    f32 = do.float()
    pfa._delta(f32, o)
    assert torch.equal(f32, do.float())  # dO itself is not modified


def _tile_constants(src, names):
    text = (ROOT / "marlin_tpu_torch" / "csrc" / src).read_text()
    return tuple(int(re.search(rf"constexpr int {n} = (\d+);", text)
                     .group(1)) for n in names)


def test_cost_model_reads_the_kernels_own_tiles():
    # KERNEL_TILES mirror each bf16 kernel's own tile constants (the
    # forward's kBM x kBN, the dQ kernel's kDqBM x kDqBN, the dK/dV
    # kernel's kDkvBM x kDkvBN), and the port's tile count keeps exactly
    # the JAX model's live pairs at each of those sizes (the CUDA kernels
    # visit only live tiles).
    from marlin_tpu.utils import cost_model as jcm

    bwd = "flash_attention_bwd.cu"
    assert _tile_constants("flash_attention_fwd.cu", ("kBM", "kBN")) \
        == pfa.KERNEL_TILES["fwd"]
    assert _tile_constants(bwd, ("kDqBM", "kDqBN")) == pfa.KERNEL_TILES["dq"]
    assert _tile_constants(bwd, ("kDkvBM", "kDkvBN")) \
        == pfa.KERNEL_TILES["dkv"]
    for bq, bk in sorted(set(pfa.KERNEL_TILES.values())) + [(64, 32)]:
        for s, w, causal in [(512, 0, True), (512, 128, True),
                             (200, 48, True), (300, 0, False),
                             (2048, 256, True)]:
            got = pcm.attention_block_counts(s, bq, bk, window=w,
                                             causal=causal)
            ref = jcm.attention_block_counts(s, bq, bk, window=w,
                                             causal=causal)
            assert got["live"] == ref["live"] == got["visited"]
            assert got["visited"] <= ref["visited"]
    # The tile accounting describes the forward kernel's loads.
    assert pcm.attention_block_counts(2048) == pcm.attention_block_counts(
        2048, *pfa.KERNEL_TILES["fwd"])
    assert pcm.flash_attention_cost(2048, 8, 128) == \
        pcm.flash_attention_cost(2048, 8, 128, *pfa.KERNEL_TILES["fwd"])
    n = 1000
    flops = pcm.transformer_step_flops(n, 2, 128, 3, 4, 32)
    attn, _ = pcm.flash_attention_cost(128, 4, 32, 64, 64)
    assert flops == 6.0 * n * 2 * 128 + 3.5 * 2 * 3 * attn
    assert attn == 4.0 * 4 * 3 * 64 * 64 * 32  # 3 live tiles of 2 x 2


def test_transformer_step_flops_counts_at_64_tiles_whatever_the_kernels():
    # chip_smoke.py's train TFLOP/s is this count over the step time. It
    # is taken at an explicit 64 x 64 tile, the count the earlier
    # mma.sync kernels reported, so the figure stays comparable across
    # kernel versions although the forward now runs 128 x 128 tiles.
    from marlin_tpu_torch.models import TransformerConfig

    cfg = TransformerConfig(vocab=32768, d_model=1024, n_heads=8,
                            n_kv_heads=2, n_layers=8, d_ff=4096,
                            max_len=2048, rope=True, dtype="bfloat16")
    n = pcm.transformer_param_count(cfg)
    assert n == 121_710_592
    flops = pcm.transformer_step_flops(n, 8, 2048, 8, 8, 128)
    assert flops == 13_948_912_926_720.0
    assert flops == pcm.transformer_step_flops(n, 8, 2048, 8, 8, 128,
                                               block_q=64, block_k=64)
    assert flops != pcm.transformer_step_flops(n, 8, 2048, 8, 8, 128,
                                               block_q=128, block_k=128)


# Each planted fault of chip_smoke.py (an edit of the first occurrence of
# its text) and the body that occurrence must lie in: the kernel it breaks
# (for the f32 dK/dV and the narrow f32 forward and dQ, the kernel whose
# own body cuts its work, or its second pass; for the wide f32 forward and
# dQ, that or the sweep of csrc/flash_fwd_dq_f32.cuh; for the f32 SpMM,
# the count of a unit's run, its second pass, or the box product of
# csrc/flash_f32.cuh that its build copies), or for the SpMM walk's
# faults the walk (struct LiveBlocks) whose part it edits only the kernels
# of its route take.
PLANTED_FAULT_KERNELS = {
    "fwd_drops_last_key_tile": ("flash_attention_fwd.cu", "flash_fwd_bf16("),
    "fwd_skips_o_rescale": ("flash_attention_fwd.cu", "flash_fwd_bf16("),
    "dq_drops_last_key_tile": ("flash_attention_bwd.cu",
                               "flash_bwd_dq_bf16("),
    "dq_reads_k_as_k_major": ("flash_attention_bwd.cu",
                              "flash_bwd_dq_bf16("),
    "dkv_drops_last_query_tile": ("flash_attention_bwd.cu",
                                  "flash_bwd_dkv_bf16("),
    "dkv_drops_last_key_tile": ("flash_attention_bwd.cu",
                                "flash_bwd_dkv_bf16("),
    "fwd256_second_half_reads_first_v_half": ("flash_attention_fwd.cu",
                                              "flash_fwd_bf16("),
    "dq256_second_half_reads_first_k_half": ("flash_attention_bwd.cu",
                                             "flash_bwd_dq_bf16("),
    "dkv256_second_share_reads_first_columns": ("flash_attention_bwd.cu",
                                                "flash_bwd_dkv_bf16("),
    "dkv_f32_drops_last_query_tile": ("flash_attention_bwd.cu",
                                      "flash_bwd_dkv_f32("),
    "dkv_f32_part_drops_last_pair": ("flash_attention_bwd.cu",
                                     "flash_bwd_dkv_f32("),
    "dkv_f32_sum_drops_last_part": ("flash_attention_bwd.cu",
                                    "flash_dkv_part_sum_f32("),
    "fwd_f32_part_drops_last_key_tile": ("flash_attention_fwd.cu",
                                         "flash_fwd_f32("),
    "fwd_f32_merge_drops_last_part": ("flash_attention_fwd.cu",
                                      "flash_fwd_merge_f32("),
    "dq_f32_part_drops_last_key_tile": ("flash_attention_bwd.cu",
                                        "flash_bwd_dq_f32("),
    "dq_f32_sum_drops_last_part": ("flash_attention_bwd.cu",
                                   "flash_dq_part_sum_f32("),
    "gather_drops_last_listed_block": ("block_sparse.cu",
                                       "struct LiveBlocks"),
    "ring_skips_last_k16_of_a_stage": ("block_sparse.cu",
                                       "spmm_ring_bf16("),
    "masked_ignores_the_mask": ("block_sparse.cu", "struct LiveBlocks"),
    "masked_count_stops_one_block_short": ("block_sparse.cu",
                                           "struct LiveBlocks"),
    "f32_part_drops_last_live_block": ("block_sparse.cu", "int unit_steps("),
    "f32_sum_drops_last_part": ("block_sparse.cu", "spmm_part_sum_f32("),
    "f32_box_product_skips_last_4_depth_columns": ("flash_f32.cuh",
                                                   "void tile_out("),
    "wide_fwd_skips_o_rescale": ("flash_attention_wide.cu",
                                 "flash_fwd_wide_bf16("),
    "wide_fwd_second_consumer_reads_first_v_columns": (
        "flash_attention_wide.cu", "flash_fwd_wide_bf16("),
    "wide_dq_drops_last_dv_chunk": ("flash_attention_wide.cu",
                                    "flash_bwd_dq_wide_bf16("),
    "wide_dq_second_consumer_reads_first_k_columns": (
        "flash_attention_wide.cu", "flash_bwd_dq_wide_bf16("),
    "wide_f32_fwd_skips_o_rescale": ("flash_fwd_dq_f32.cuh", "fwd_sweep("),
    "wide_f32_fwd_merge_drops_last_part": ("flash_attention_wide.cu",
                                           "flash_fwd_merge_f32("),
    "wide_f32_fwd_second_share_reads_first_v_columns": (
        "flash_attention_wide.cu", "flash_fwd_wide_f32("),
    "wide_f32_dq_drops_last_dv_box": ("flash_fwd_dq_f32.cuh", "dq_sweep("),
    "wide_f32_dq_sum_drops_last_part": ("flash_attention_wide.cu",
                                        "flash_dq_part_sum_f32("),
    "wide_dkv_drops_last_query_tile": ("flash_attention_wide.cu",
                                       "flash_bwd_dkv_wide_f32("),
    "wide_f32_dkv_second_share_reads_first_columns": (
        "flash_attention_wide.cu", "flash_bwd_dkv_wide_f32("),
    "wide_dkv_dk_second_consumer_reads_first_q_columns": (
        "flash_attention_wide.cu", "flash_bwd_dkv_wide_bf16("),
    "wide_dkv_dv_drops_last_query_tile": ("flash_attention_wide.cu",
                                          "flash_bwd_dkv_wide_bf16("),
    "wide_dkv_sum_drops_last_group_part": ("flash_attention_wide.cu",
                                           "flash_dkv_group_sum("),
}


@pytest.mark.parametrize("fault", sorted(PLANTED_FAULT_KERNELS))
def test_every_planted_fault_is_anchored_in_its_kernel(fault):
    import chip_smoke

    faults = {**chip_smoke.FWD_PLANTED_FAULTS, **chip_smoke.PLANTED_FAULTS,
              **chip_smoke.SPMM_PLANTED_FAULTS,
              **chip_smoke.WIDE_KERNEL_FAULTS}
    assert set(faults) == set(PLANTED_FAULT_KERNELS)
    assert set(chip_smoke.SPMM_FAULT_SHOWS) == set(
        chip_smoke.SPMM_PLANTED_FAULTS)
    assert set(chip_smoke.WIDE_KERNEL_FAULT_CHECK) == set(
        chip_smoke.WIDE_KERNEL_FAULTS)
    src_name, start = PLANTED_FAULT_KERNELS[fault]
    src = (ROOT / "marlin_tpu_torch" / "csrc" / src_name).read_text()
    old, new = faults[fault]
    assert old in src and new != old
    # The body runs to the next kernel or the end of a top-level struct.
    body = src.index(start)
    ends = [e for e in (src.find("__global__", body + len(start)),
                        src.find("\n};\n", body)) if e > 0]
    assert body < src.index(old) < min(ends, default=len(src))


def test_the_spmm_walk_faults_reach_only_their_route():
    # Both routes run one bf16 kernel, spmm_ring_bf16<BN, GATHER>: run<>
    # hands its GATHER on unchanged, so the gather entry point instantiates
    # the ring with GATHER = true and the masked one with GATHER = false,
    # which walks DepthSteps<false, kGAhead>. The routes differ only in
    # LiveBlocks: the list walk (init's GATHER branch) is the gather
    # route's; the mask test (is_live) and the mask count (n_live past its
    # GATHER return) are the masked route's. Each walk fault edits its
    # route's part, the ring fault the loop both run. The f32 kernel,
    # spmm_f32<GATHER>, walks and counts through the same LiveBlocks, so
    # the walk faults reach its route's f32 kernel too. The mma.sync path
    # and its hand-written cp.async are gone (the f32 kernel loads through
    # flash_f32.cuh's load_box).
    import chip_smoke

    faults = chip_smoke.SPMM_PLANTED_FAULTS
    src = (ROOT / "marlin_tpu_torch" / "csrc" / "block_sparse.cu").read_text()
    walk = src[src.index("struct LiveBlocks"):]
    walk = walk[:walk.index("\n};\n")]
    gather_branch = walk[walk.index("if (GATHER) {"):walk.index("} else {")]
    assert faults["gather_drops_last_listed_block"][0] in gather_branch
    is_live = walk[walk.index("bool is_live("):walk.index("void skip_dead(")]
    assert faults["masked_ignores_the_mask"][0] in is_live
    # is_live is called from the mask walk's code only: the window the
    # walk reads ahead (filled only in skip_dead's !GATHER branch) and the
    # count.
    assert walk.count("is_live(") == 3
    assert "window |= 1u << i;" in walk[walk.index("void fill_window("):]
    skip = walk[walk.index("void skip_dead("):walk.index("void init(")]
    assert skip.index("if (!GATHER) {") < skip.index("fill_window(pos);")
    assert walk.count("fill_window(") == 2
    count = walk[walk.index("int n_live("):]
    count = count[count.index("if (GATHER) return count;\n"):]
    assert faults["masked_count_stops_one_block_short"][0] in count
    assert "__syncthreads_count(k < count && is_live(k))" in count
    header = (ROOT / "marlin_tpu_torch" / "csrc" /
              "flash_f32.cuh").read_text()
    for fault in faults:
        text = src if faults[fault][0] in src else header
        assert text.count(faults[fault][0]) == 1, fault
    f32 = src[src.index("int unit_steps("):src.index("spmm_part_sum_f32(")]
    assert "blocks.n_live(flash_f32::kThreads)" in f32
    assert "LiveBlocks<GATHER, 1> p_blocks;" in f32
    ring = src[src.index("spmm_ring_bf16("):]
    ring = ring[:ring.index("__global__")]
    assert "DepthSteps<GATHER, kGAhead> steps;" in ring
    assert "steps.blocks.n_live(kGThreads) * steps.per_block" in ring
    assert faults["ring_skips_last_k16_of_a_stage"][0] in ring
    assert "run_ring_bf16<128, GATHER>(" in src
    assert "run_ring_bf16<64, GATHER>(" in src
    assert "run<true>(" in src and "run<false>(" in src
    assert "if constexpr" not in src
    for gone in ("spmm_bf16", "spmm_gather_bf16", "mma.sync",
                 'asm volatile("cp.async', "ldmatrix", "Bf16Tiles",
                 "load_stage", "run_bf16"):
        assert gone not in src, gone


@pytest.mark.parametrize("sq", [256, 250])
def test_forward_card_check_sees_a_dropped_last_key_tile(sq):
    # chip_smoke.py holds the forward kernel's O against the plain version
    # per 64-row tile (tile_rel_err) beside max |err|. A forward whose key
    # sweep drops its last tile (FWD_PLANTED_FAULTS) leaves each query
    # tile of KERNEL_TILES["fwd"] rows without its last key tile: the
    # first query tile with no key at all (O = 0, l clamped), the others
    # without their most recent keys. Emulated here with the plain
    # version, the per-tile check reads it at >= 0.3.
    import chip_smoke

    bq, bk = pfa.KERNEL_TILES["fwd"]
    q, k, v, _ = (torch.from_numpy(x)[None]
                  for x in _inputs(11, sq, sq, 4, 2, 32, 32))
    q_hat, k, v = pfa._prepare(q, k, v, True, None, 0)
    o_ref, _ = pfa.flash_attention_reference(q_hat, k, v, True, 0)
    assert chip_smoke.tile_rel_err(o_ref, o_ref) == 0.0
    o_bad = torch.zeros_like(o_ref)
    for m0 in range(0, sq, bq):
        hi = min(sq, m0 + bq)  # the causal sweep's end
        keys = (-(-hi // bk) - 1) * bk  # all of them before row m0
        if keys:
            o_bad[:, m0:m0 + bq] = pfa.flash_attention_reference(
                q_hat[:, m0:m0 + bq], k[:, :keys], v[:, :keys])[0]
    assert chip_smoke.tile_rel_err(o_bad, o_ref) >= 0.3
    assert chip_smoke.tile_rel_err(o_bad, o_ref) <= \
        chip_smoke.tile_rel_err(torch.zeros_like(o_ref), o_ref)


def test_check_launch_refuses_a_bf16_base_off_16_bytes():
    # TMA needs a 16-byte-aligned base address: a contiguous bf16 view at
    # an odd offset is refused before anything else is looked at, and an
    # aligned one gets as far as the device check.
    store = torch.zeros(1 + 2 * 8 * 64, dtype=torch.bfloat16)
    bad = store[1:].view(1, 2, 8, 64)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        pfa._check_launch({"q": bad}, 64, 64)
    good = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pfa._check_launch({"q": good}, 64, 64)


@pytest.mark.parametrize("sq", [256, 250])
def test_card_check_sees_a_dropped_tile_of_small_gradients(sq):
    # chip_smoke.py holds the backward kernels against this plain backward
    # by the worst 64-position tile (tile_rel_err). Under causal attention
    # dK and dV of the last keys are small beside those of the first, so a
    # kernel that leaves the last key tile at zero moves max |err| /
    # max |plain| well below 1 (under 0.2 here, less as S grows: ~0.005
    # at S=8192 on the card); per tile it reads 1.0. The planted faults
    # of PLANTED_FAULTS are edits of the CUDA source.
    import chip_smoke

    src = (ROOT / "marlin_tpu_torch" / "csrc" /
           "flash_attention_bwd.cu").read_text()
    for old, new in chip_smoke.PLANTED_FAULTS.values():
        assert old in src and new != old
    q, k, v, do = (torch.from_numpy(x)[None]
                   for x in _inputs(7, sq, sq, 4, 2, 32, 32))
    q_hat, k, v = pfa._prepare(q, k, v, True, None, 0)
    o, lse = pfa.flash_attention_reference(q_hat, k, v, True, 0)
    ref = pfa.flash_attention_bwd_reference(q_hat, k, v, o, lse, do, True,
                                            0, 1 / math.sqrt(32))
    assert chip_smoke.tile_rel_err(ref[1], ref[1]) == 0.0
    for i in (1, 2):
        got = ref[i].clone()
        got[:, (sq - 1) // chip_smoke.TILE * chip_smoke.TILE:] = 0
        assert chip_smoke.tile_rel_err(got, ref[i]) == pytest.approx(1.0)
        glob = (got - ref[i]).abs().max() / ref[i].abs().max()
        assert glob < 0.2
    # A bf16-sized perturbation of every value reads at its own size.
    noisy = ref[0] * (1 + 2.0 ** -9)
    assert chip_smoke.tile_rel_err(noisy, ref[0]) == pytest.approx(
        2.0 ** -9, rel=1e-3)
