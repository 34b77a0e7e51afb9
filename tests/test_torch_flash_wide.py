"""The bf16 wide dK/dV kernel's cut of its work (marlin_tpu_torch/ops/
flash_attention.py: _wide_dkv_plan, the mirror of csrc/
flash_attention_wide.cu's DkvPart and group parts) and its two-pass sum.

On the card, above head dim 256, each 64-key tile of dK/dV is cut into
parts (dK's column shares, then dV's) and, where those CTAs would not fill
two waves, each KV head's group of query heads into G equal group parts
whose f32 partial sums a second launch adds in order. The kernel runs only
on the card (chip_smoke.py holds it against the plain backward there).
Here the plan is pinned, the two-pass sum is emulated with the plain
backward (each group part's backward summed in f32 in the plan's order:
within 1e-5 of the whole group's, and of the JAX package's VJP at
DeepSeek-V3's absorbed-MLA widths), and the wrapper's call of the entry is
pinned with a fake library.
"""

import contextlib
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marlin_tpu.ops.flash_attention import flash_attention as jax_flash
from marlin_tpu_torch.ops import flash_attention as pfa

ROOT = Path(__file__).resolve().parents[1]
H100_SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One intra-op thread: these tests run beside wall-clock-timed tests
    # in the parallel suite, and their shapes are too small to need more.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kernel_constant(name):
    text = (ROOT / "marlin_tpu_torch" / "csrc"
            / "flash_attention_wide.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _shape(name):
    """(B, Skv, H, Hk, D, Dv) of chip_smoke.py's shape ``name``, with the
    kernel head dims the wrapper pads D and Dv to."""
    import chip_smoke

    _, b, _, skv, h, hk, d, dv = chip_smoke.SHAPE_BY_NAME[name][:8]
    return (b, skv, h, hk, *pfa._kernel_head_dims(d, dv))


WIDE_BF16 = ("d320", "d384_window", "d512", "d1024", "d384_dv128",
             "d64_dv320", "d512_s4096", "mla_d576_dv512")


@pytest.mark.parametrize("name", WIDE_BF16)
def test_each_column_box_is_one_parts_and_the_roles_are_in_order(name):
    # Every 64-column box of dK and of dV is covered once, by a part of
    # its own role, the dK parts first; a part holds at most the two
    # consumers' 2 * kMaxBoxes boxes.
    b, skv, h, hk, d, dv = _shape(name)
    plan = pfa._wide_dkv_plan(b, h, hk, skv, d, dv, H100_SMS)
    roles = [role for role, _, _ in plan.parts]
    assert roles == sorted(roles)  # "dk" < "dv"
    most = 2 * _kernel_constant("kMaxBoxes")
    for role, width in (("dk", d), ("dv", dv)):
        boxes = []
        for r, first, cols in plan.parts:
            assert first % 64 == 0 and cols % 64 == 0 and cols > 0
            assert cols // 64 <= most
            if r == role:
                boxes += range(first // 64, (first + cols) // 64)
        assert boxes == list(range(width // 64)), role


@pytest.mark.parametrize("b,h,hk,skv,sms", [
    (1, 16, 1, 4096, 132), (1, 4, 2, 1024, 132), (1, 12, 1, 256, 132),
    (2, 8, 8, 4096, 132), (1, 6, 1, 64, 132), (1, 16, 1, 4096, 1)])
def test_each_query_head_is_in_one_contiguous_group_part(b, h, hk, skv,
                                                         sms):
    # The group parts cut a KV head's H / Hk query heads into G equal
    # contiguous runs, in order (the order the second pass sums them); G
    # divides the group, is the least one that fills WIDE_DKV_WAVES waves
    # of one CTA an SM, else one head a part.
    plan = pfa._wide_dkv_plan(b, h, hk, skv, 512, 512, sms)
    group, g = h // hk, plan.group_parts
    assert group % g == 0
    heads = [first + i for first, n in plan.heads for i in range(n)]
    assert heads == list(range(group))
    assert len({n for _, n in plan.heads}) == 1
    ctas = b * hk * -(-skv // pfa.WIDE_DKV_KEYS) * len(plan.parts)
    fills = [n for n in range(1, group + 1)
             if group % n == 0 and ctas * n >= pfa.WIDE_DKV_WAVES * sms]
    assert g == (fills[0] if fills else group)


def test_one_group_part_at_d512_and_several_at_mla():
    # d512_s4096 fills 2048 CTAs: no group split, no workspace, no second
    # pass. mla_d576_dv512 (one KV head, 16 query heads) has 64 key tiles
    # x 2 parts = 128 CTAs on 132 SMs: four group parts of four heads, and
    # an f32 workspace of G x B x Skv x Hk x (D + Dv) x 4 bytes (71 MB).
    assert pfa.WIDE_DKV_KEYS == _kernel_constant("kDkvKeys")
    b, skv, h, hk, d, dv = _shape("d512_s4096")
    plan = pfa._wide_dkv_plan(b, h, hk, skv, d, dv, H100_SMS)
    assert (plan.group_parts, len(plan.parts)) == (1, 2)
    assert plan.workspace_bytes == 0
    b, skv, h, hk, d, dv = _shape("mla_d576_dv512")
    plan = pfa._wide_dkv_plan(b, h, hk, skv, d, dv, H100_SMS)
    assert (plan.group_parts, len(plan.parts)) == (4, 2)
    assert plan.heads == [(0, 4), (4, 4), (8, 4), (12, 4)]
    assert plan.workspace_bytes == 4 * b * skv * hk * (d + dv) * 4
    assert plan.workspace_bytes == 71_303_168


def _inputs(seed, sq, h, hk, d, dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((sq, h, d)).astype(np.float32),
            rng.standard_normal((sq, hk, d)).astype(np.float32),
            rng.standard_normal((sq, hk, dv)).astype(np.float32),
            rng.standard_normal((sq, h, dv)).astype(np.float32))


def _two_pass(q_hat, k, v, do, lse, delta, causal, window, scale, plan):
    """dK and dV as the kernel takes them with ``plan``'s group parts: the
    plain backward of each part's query heads (of every KV head), summed
    in f32 in the parts' order."""
    hk = k.shape[2]
    group = q_hat.shape[2] // hk
    total = None
    for first, n in plan.heads:
        idx = torch.tensor([j * group + first + i for j in range(hk)
                            for i in range(n)])
        _, dk, dv = pfa._bwd_reference(
            q_hat[:, :, idx], k, v, do[:, :, idx], lse[:, idx],
            delta[:, idx], causal, window, scale)
        total = (dk, dv) if total is None else (total[0] + dk,
                                                total[1] + dv)
    return total


# (Sq, H, Hk, D, Dv, causal, window): the MLA widths at a small size (one
# KV head, four query heads) and a GQA case with two KV heads and a window.
TWO_PASS = {"mla_small": (96, 4, 1, 576, 512, True, 0),
            "gqa_window": (80, 6, 2, 320, 320, True, 24)}


@pytest.mark.parametrize("name", list(TWO_PASS))
def test_two_pass_sum_matches_the_whole_groups_backward(name):
    # Each group part's plain backward, summed in f32 in the plan's order,
    # against the plain backward of the whole group: within 1e-5 relative
    # (f32; only the order of the group's sum differs). The plan splits
    # the group here, as it does on the card at mla_d576_dv512.
    sq, h, hk, d, dv, causal, window = TWO_PASS[name]
    q, k, v, g = (torch.from_numpy(x)[None]
                  for x in _inputs(50, sq, h, hk, d, dv))
    scale = 1.0 / math.sqrt(d)
    q_hat, k, v = pfa._prepare(q, k, v, causal, scale, window)
    o, lse = pfa.flash_attention_reference(q_hat, k, v, causal, window)
    delta = pfa._delta(g, o)
    plan = pfa._wide_dkv_plan(1, h, hk, sq, d, dv, H100_SMS)
    assert plan.group_parts == h // hk > 1
    got = _two_pass(q_hat, k, v, g, lse, delta, causal, window, scale, plan)
    _, *ref = pfa._bwd_reference(q_hat, k, v, g, lse, delta, causal, window,
                                 scale)
    for label, a, r in zip(("dk", "dv"), got, ref):
        err = float((a - r).abs().max() / r.abs().max())
        assert err <= 1e-5, (label, err)


def test_two_pass_sum_matches_jax_at_mla_widths():
    # The same emulation at test_mla_widths_match_jax_forward_and_gradients'
    # inputs (q and k 576 wide, v 512, one KV head, four query heads, 96
    # positions, causal) against jax.vjp of the JAX package's
    # flash_attention (its Pallas kernels in interpret mode): within that
    # test's f32 tolerance, 1e-5.
    sq, h, hk, d, dv = 96, 4, 1, 576, 512
    rng = np.random.default_rng(41)
    q, k, v, g = (rng.standard_normal(s).astype(np.float32) for s in
                  ((sq, h, d), (sq, hk, d), (sq, hk, dv), (sq, h, dv)))
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=True,
                                               interpret=True),
                     *(jnp.asarray(x) for x in (q, k, v)))
    _, jdk, jdv = vjp(jnp.asarray(g))
    scale = 1.0 / math.sqrt(d)
    q_hat, kt, vt = pfa._prepare(*(torch.from_numpy(x)[None]
                                   for x in (q, k, v)), True, scale, 0)
    o, lse = pfa.flash_attention_reference(q_hat, kt, vt, True, 0)
    do = torch.from_numpy(g)[None]
    plan = pfa._wide_dkv_plan(1, h, hk, sq, d, dv, H100_SMS)
    dk, dvv = _two_pass(q_hat, kt, vt, do, lse, pfa._delta(do, o), True, 0,
                        scale, plan)
    np.testing.assert_allclose(dk[0].numpy(), np.asarray(jdk), atol=1e-5,
                               rtol=1e-5, err_msg="dk")
    np.testing.assert_allclose(dvv[0].numpy(), np.asarray(jdv), atol=1e-5,
                               rtol=1e-5, err_msg="dv")


class _FakeWideLib:
    """Records the wide dK/dV entry's arguments and returns ``err``."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def marlin_flash_attention_bwd_dkv_wide(self, *args):
        self.calls.append(args)
        return self.err


def _fake_card(monkeypatch, lib):
    # The wrapper's view of a card, on meta tensors: the fake library, no
    # device checks, a stream of 0 and an H100's SM count.
    monkeypatch.setattr(pfa, "_wide_lib", lambda: lib)
    monkeypatch.setattr(pfa, "_check_launch", lambda *a, **kw: None)
    monkeypatch.setattr(pfa, "_sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())


def _meta_inputs(b, sq, h, hk, d, dv, dtype):
    def t(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")

    lse = torch.empty((b, h, sq), device="meta")
    return (t(b, sq, h, d), t(b, sq, hk, d), t(b, sq, hk, dv),
            t(b, sq, h, dv), lse, lse)


@pytest.mark.parametrize("name,dtype", [
    ("mla_d576_dv512", torch.bfloat16), ("d512_s4096", torch.bfloat16),
    ("mla_d576_dv512", torch.float32)])
def test_the_wrapper_hands_the_entry_its_plan(monkeypatch, name, dtype):
    # bf16: the plan's G and, for G > 1, a workspace (None for G = 1); f32:
    # the sweep parts P of _f32_dkv_plan and, for P > 1, a workspace. One
    # launch counted either way, the second pass included.
    lib = _FakeWideLib()
    _fake_card(monkeypatch, lib)
    b, skv, h, hk, d, dv = _shape(name)
    args = _meta_inputs(b, skv, h, hk, d, dv, dtype)
    before = pfa.wide_dkv_launches
    dk, dv_ = pfa._launch_bwd_dkv(*args, True, 0)
    assert pfa.wide_dkv_launches == before + 1
    assert dk.shape == args[1].shape and dv_.shape == args[2].shape
    (call,) = lib.calls
    g = (pfa._wide_dkv_plan(b, h, hk, skv, d, dv, H100_SMS).group_parts
         if dtype == torch.bfloat16 else pfa._f32_dkv_plan(
             b, h, hk, skv, skv, d, dv, True, 0, H100_SMS).parts)
    assert call[0] == pfa._KERNEL_DTYPES[dtype]
    assert call[10:19] == (b, h, hk, skv, skv, d, dv, 1, 0)
    assert call[19] == g and call[20] == 0
    assert (call[9] is None) == (g == 1)


def test_a_failing_wide_dkv_launch_raises(monkeypatch):
    _fake_card(monkeypatch, _FakeWideLib(err=1))
    before = pfa.wide_dkv_launches
    with pytest.raises(RuntimeError,
                       match="flash_attention_bwd_dkv_wide launch failed"):
        pfa._launch_bwd_dkv(*_meta_inputs(1, 128, 4, 1, 576, 512,
                                          torch.bfloat16), True, 0)
    assert pfa.wide_dkv_launches == before
