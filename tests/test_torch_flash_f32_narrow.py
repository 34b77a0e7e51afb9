"""The narrow f32 forward's and dQ's cut of their work (head dims up to 256
after the wrapper's padding to 64, 128 or 256: marlin_tpu_torch/ops/
flash_attention.py's _f32_q_plan, the mirror of csrc/flash_fwd_dq_f32.cuh's
key_tiles, share_of and launch) and their two-pass merges.

On the card, in f32 at head dims up to 256, flash_fwd_f32<NB> and
flash_bwd_dq_f32<NB> run the sweeps of csrc/flash_fwd_dq_f32.cuh, as the
wide kernels do: a CTA owns 64 query rows of one query head, all of the
output's columns (one share) and one part of the query tile's sweep over
its live key tiles (128 keys a forward tile, 64 a dQ tile); a query tile of
several parts writes f32 partials that a second launch merges in part
order. The kernels run only on the card (chip_smoke.py holds them against
the plain versions there). Here the plan is pinned against the masks it
must cover and on an H100's 132 SMs, the merges are emulated with the
plain versions (each part's keys alone, merged in the plan's order: within
1e-5 per 64-row tile of the whole sweep, and of the JAX package's Pallas
kernels in interpret mode), and the wrappers' calls of the narrow entries
are pinned with a fake library.
"""

import contextlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from marlin_tpu.ops.flash_attention import _flash_hsd_impl
from marlin_tpu.ops.flash_attention import flash_attention as jax_flash
from marlin_tpu.utils.split import pad_to_multiple as jax_pad
from marlin_tpu_torch.ops import flash_attention as pfa
from test_torch_flash_f32_wide import (_dq_two_pass, _fwd_merge,
                                       _live_key_tiles, _part_tiles,
                                       _port_inputs)

H100_SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One intra-op thread: these tests run beside wall-clock-timed tests
    # in the parallel suite, and their shapes are too small to need more.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NARROW_F32 = tuple(s[0] for s in chip_smoke.SHAPES
                   if s[8] == "float32"
                   and s[0] not in chip_smoke.WIDE_KERNEL_SHAPES)

# Small cuts beside chip_smoke.py's narrow f32 shapes, at kernel head dims:
# (B, Sq, Skv, H, Hk, D, Dv, causal, window). Causal with keys past the
# last query, a window, a cross length (non-causal), MQA with ragged ends,
# D != Dv both ways, D = Dv = 256.
SMALL = {"keys_past_queries": (1, 200, 300, 4, 2, 128, 128, True, 0),
         "window": (2, 500, 500, 4, 1, 64, 64, True, 90),
         "cross": (1, 70, 200, 2, 2, 64, 128, False, 0),
         "mqa_ragged": (1, 333, 333, 6, 1, 128, 128, True, 0),
         "d128_dv64": (1, 250, 250, 2, 1, 128, 64, True, 0),
         "d256": (1, 300, 300, 2, 1, 256, 256, True, 0)}


def _dims(case):
    """(B, Sq, Skv, H, Hk, D, Dv, causal, window) of a chip_smoke.py shape
    (at the kernel head dims the wrapper pads to) or a SMALL cut."""
    kind, name = case
    if kind == "small":
        return SMALL[name]
    _, b, sq, skv, h, hk, d, dv, _, causal, window = \
        chip_smoke.SHAPE_BY_NAME[name]
    return (b, sq, skv, h, hk, *pfa._kernel_head_dims(d, dv), causal,
            window)


def _plan(kind, dims, sms=H100_SMS, parts=None):
    b, sq, skv, h, hk, d, dv, causal, window = dims
    return pfa._f32_q_plan(kind, b, h, hk, sq, skv, d, dv, causal, window,
                           sms, parts)


CASES = [("chip", n) for n in NARROW_F32] + [("small", n) for n in SMALL]


@pytest.mark.parametrize("kind", ["fwd", "dq"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[1])
def test_a_narrow_plan_is_one_share_of_every_column(case, kind):
    # Up to 256 columns a CTA holds all of the output: O's Dv for the
    # forward, dQ's D (share_count is 1 up to 512 columns).
    dims = _dims(case)
    width = dims[6] if kind == "fwd" else dims[5]
    assert width <= 256 and _plan(kind, dims).shares == [(0, width)]


@pytest.mark.parametrize("kind", ["fwd", "dq"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[1])
def test_each_live_key_tile_of_a_query_tile_is_in_one_part_in_order(case,
                                                                    kind):
    # A query tile's parts, concatenated in the order the second pass
    # merges them, are exactly its live key tiles: every one once, each
    # part a contiguous run of at most `chunk`; key tiles at or past Skv
    # are in none. At H100's SMs and at 8 (fewer parts a query tile).
    dims = _dims(case)
    b, sq, skv, h, hk, d, dv, causal, window = dims
    keys = pfa.F32_FWD_KEYS if kind == "fwd" else pfa.F32_DQ_KEYS
    for sms in (H100_SMS, 8):
        plan = _plan(kind, dims, sms)
        assert plan.keys == keys
        assert len(plan.tiles) == -(-sq // 64) == len(plan.tile_parts)
        for t in range(len(plan.tiles)):
            want = _live_key_tiles(t * 64, sq, skv, keys, causal, window)
            parts = _part_tiles(plan, t)
            assert [x for part in parts for x in part] == want
            assert all(x * keys < skv for x in want)
            assert len(parts) == plan.tile_parts[t] <= plan.parts
            assert all(0 < len(part) <= plan.chunk for part in parts)
        assert max(plan.tile_parts) == plan.parts


def _makespan(plan, dims, kind):
    """The plan's makespan by the model the plan picks P with (a CTA's
    box-product steps, heaviest query tile first, on 132 SMs)."""
    b, sq, skv, h, hk, d, dv, causal, window = dims
    cols = dv if kind == "fwd" else d
    st = (d // 64 + 2 * -(-cols // 128) if kind == "fwd"
          else max(d, dv) // 64 + -(-cols // 128))
    cost = []
    for (_, n), tp in zip(plan.tiles[::-1], plan.tile_parts[::-1]):
        for i in range(tp):
            cost += [min(plan.chunk, n - i * plan.chunk) * st + 1
                     + (tp > 1) * cols / 256] * (b * h)
    return pfa._f32_makespan(cost, H100_SMS)


@pytest.mark.parametrize("name,kind,parts,ctas", [
    ("f32", "fwd", 2, 192), ("f32", "dq", 2, 192),
    ("d256_f32", "fwd", 3, 120), ("d256_f32", "dq", 8, 288),
    ("train_f32", "fwd", 1, 2048), ("train_f32", "dq", 1, 2048)])
def test_the_plan_at_the_table_shapes_on_an_h100(name, kind, parts, ctas):
    # PERF.md's narrow f32 table shapes on an H100: the plan's P finishes
    # soonest of every P by the makespan model. At `f32` (16 query tiles
    # of 1-8 forward or 1-16 dQ key tiles, 8 heads) P = 1 would leave the
    # heaviest query tiles' CTAs setting the time on 128 of 132 SMs; at
    # `d256_f32` (4 heads) on 64; at `train_f32` 2048 CTAs fill 15.5 waves
    # whole.
    dims = _dims(("chip", name))
    b, sq, skv, h, hk, d, dv, causal, window = dims
    plan = _plan(kind, dims)
    assert (plan.parts, b * h * sum(plan.tile_parts)) == (parts, ctas)
    best = _makespan(plan, dims, kind)
    for p in range(1, max(n for _, n in plan.tiles) + 1):
        assert best <= _makespan(_plan(kind, dims, parts=p), dims, kind)


@pytest.mark.parametrize("kind", ["fwd", "dq"])
@pytest.mark.parametrize("name", NARROW_F32)
def test_the_workspace_is_p_planes_of_the_partials(name, kind):
    # The forward: P planes of unnormalised O (B, Sq, H, Dv), then P
    # planes of m and of l (B, H, Sq), one share; dQ: P planes of dQ (B,
    # Sq, H, D). None for P = 1.
    dims = _dims(("chip", name))
    b, sq, skv, h, hk, d, dv, causal, window = dims
    for parts in (None, 1, 2, 3):
        plan = _plan(kind, dims, parts=parts)
        per = (b * sq * h * dv + 2 * b * h * sq if kind == "fwd"
               else b * sq * h * d)
        assert plan.workspace_bytes == (plan.parts * per * 4
                                        if plan.parts > 1 else 0)


@pytest.mark.parametrize("name", list(SMALL))
def test_forward_part_merge_matches_the_whole_sweep(name):
    # Each part's plain forward, merged in the plan's order, against the
    # plain forward of the whole sweep: O within 1e-5 per 64-row tile
    # (chip_smoke.py's f32 limit), O and lse within 1e-4. The plan cuts
    # query tiles into several parts on an H100.
    dims = SMALL[name]
    plan = _plan("fwd", dims)
    assert plan.parts > 1
    q_hat, k, v, _, o, lse, _, _ = _port_inputs(80, *dims)
    got_o, got_lse = _fwd_merge(q_hat, k, v, dims[7], dims[8], plan)
    assert chip_smoke.tile_rel_err(got_o, o) <= 1e-5
    assert (got_lse - lse).abs().max().item() <= 1e-4
    assert (got_o - o).abs().max().item() <= 1e-4


@pytest.mark.parametrize("name", list(SMALL))
def test_dq_two_pass_sum_matches_the_whole_sweep(name):
    # Each part's plain dQ (scale 1), summed in f32 in the plan's order and
    # then scaled, against the plain backward of the whole sweep: within
    # 1e-5 per 64-position tile.
    dims = SMALL[name]
    plan = _plan("dq", dims)
    assert plan.parts > 1
    q_hat, k, v, do, _, lse, delta, scale = _port_inputs(81, *dims)
    got = _dq_two_pass(q_hat, k, v, do, lse, delta, dims[7], dims[8], scale,
                       plan)
    ref = pfa._bwd_reference(q_hat, k, v, do, lse, delta, dims[7], dims[8],
                             scale)[0]
    assert chip_smoke.tile_rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("d,dv", [(64, 64), (128, 128), (256, 256),
                                  (64, 128), (128, 64), (16, 16), (96, 96),
                                  (160, 160)])
def test_both_merges_match_jax(d, dv):
    # The two emulations through the wrapper's padding to the kernel head
    # dims (16, 96 and 160 go to 64, 128 and 256), GQA, causal, 256
    # positions (two 128-key forward tiles at the last query tiles), the
    # plans cut for an H100 (several parts a query tile), against the JAX
    # package's Pallas kernels in interpret mode: its flash forward (O, and
    # lse from _flash_hsd_impl) within 1e-4, and jax.vjp of flash_attention
    # (dQ) within 1e-5 per 64-position tile.
    sq, h, hk = 256, 4, 2
    dp, dvp = pfa._kernel_head_dims(d, dv)
    dims = (1, sq, sq, h, hk, dp, dvp, True, 0)
    fwd, dq_plan = _plan("fwd", dims), _plan("dq", dims)
    assert fwd.parts > 1 and dq_plan.parts > 1
    assert len(fwd.shares) == len(dq_plan.shares) == 1
    rng = np.random.default_rng(82)
    q, k, v, g = (rng.standard_normal(s).astype(np.float32) for s in
                  ((sq, h, d), (sq, hk, d), (sq, hk, dv), (sq, h, dv)))
    scale = 1.0 / math.sqrt(d)
    o_jax, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=True,
                                                   interpret=True),
                         *(jnp.asarray(x) for x in (q, k, v)))
    jdq, _, _ = vjp(jnp.asarray(g))
    qt, kt, vt = (jax_pad(jnp.swapaxes(jnp.asarray(x), 0, 1), 2, 128)
                  for x in (q, k, v))
    _, lse_jax = _flash_hsd_impl(qt, kt, vt, True, scale, 128, 128, True, 0)
    q_hat, kk, vv = pfa._prepare(*(torch.from_numpy(x)[None]
                                   for x in (q, k, v)), True, scale, 0)
    o, lse = pfa._padded_fwd(
        lambda *args: _fwd_merge(*args, fwd), q_hat, kk, vv, True, 0)
    np.testing.assert_allclose(o[0].numpy(), np.asarray(o_jax), atol=1e-4,
                               rtol=1e-4, err_msg="O")
    np.testing.assert_allclose(lse[0].numpy(), np.asarray(lse_jax),
                               atol=1e-4, rtol=1e-4, err_msg="lse")
    o_ref, lse_ref = pfa.flash_attention_reference(q_hat, kk, vv, True, 0)
    do = torch.from_numpy(g)[None]
    pad = (pfa._pad_to(q_hat, dp), pfa._pad_to(kk, dp), pfa._pad_to(vv, dvp),
           pfa._pad_to(do, dvp))
    dq = _dq_two_pass(*pad, lse_ref, pfa._delta(do, o_ref), True, 0, scale,
                      dq_plan)[..., :d]
    assert chip_smoke.tile_rel_err(dq, torch.from_numpy(
        np.asarray(jdq))[None]) <= 1e-5


class _FakeLib:
    """Records the narrow forward's and dQ's entries' arguments and returns
    ``err``."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def marlin_flash_attention_fwd(self, *args):
        self.calls.append(("fwd", args))
        return self.err

    def marlin_flash_attention_bwd_dq(self, *args):
        self.calls.append(("dq", args))
        return self.err


def _fake_card(monkeypatch, lib):
    # The wrapper's view of a card, on meta tensors: the fake library for
    # both narrow sources, no device checks, a stream of 0 and an H100's
    # SMs.
    monkeypatch.setattr(pfa, "_kernel_lib", lambda: lib)
    monkeypatch.setattr(pfa, "_bwd_lib", lambda: lib)
    monkeypatch.setattr(pfa, "_check_launch", lambda *a, **kw: None)
    monkeypatch.setattr(pfa, "_sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# f32 with the plan's P, P = 1 and P = 2 forced; bf16 (no parts).
DTYPE_PARTS = [(torch.float32, None), (torch.float32, 1),
               (torch.float32, 2), (torch.bfloat16, None)]


def _counts():
    return (pfa.launches, pfa.bwd_dq_launches, pfa.wide_launches,
            pfa.wide_dq_launches)


@pytest.mark.parametrize("dtype,parts", DTYPE_PARTS)
@pytest.mark.parametrize("name", ["f32", "d32_dv16_f32", "d256_f32",
                                  "train_f32"])
def test_the_wrapper_hands_the_narrow_forward_entry_its_plan(
        monkeypatch, name, parts, dtype):
    # f32: the plan's P (or the caller's), a workspace only for P > 1 (the
    # meta tensor's address, 0; None for P = 1). bf16: P = 1 and no
    # workspace whatever the plan. One launch counted, the second pass
    # included; no wide kernel.
    lib = _FakeLib()
    _fake_card(monkeypatch, lib)
    dims = _dims(("chip", name))
    b, sq, skv, h, hk, d, dv, causal, window = dims
    f32 = dtype == torch.float32
    want = _plan("fwd", dims, parts=parts).parts if f32 else 1
    before = _counts()
    o, lse = pfa._launch(_meta(b, sq, h, d, dtype=dtype),
                         _meta(b, skv, hk, d, dtype=dtype),
                         _meta(b, skv, hk, dv, dtype=dtype), causal, window,
                         parts=parts)
    assert _counts() == (before[0] + 1, *before[1:])
    assert o.shape == (b, sq, h, dv) and lse.shape == (b, h, sq)
    ((entry, call),) = lib.calls
    assert entry == "fwd" and call[0] == int(f32)
    assert (call[6] is None) == (want == 1)
    assert call[7:16] == (b, h, hk, sq, skv, d, dv, int(causal), window)
    assert call[16:] == (want, 0)


@pytest.mark.parametrize("dtype,parts", DTYPE_PARTS)
@pytest.mark.parametrize("name", ["f32", "d32_dv16_f32", "d256_f32",
                                  "train_f32"])
def test_the_wrapper_hands_the_narrow_dq_entry_its_plan(monkeypatch, name,
                                                        parts, dtype):
    # dQ: the plan's P (or the caller's) for f32, 1 for bf16, a workspace
    # only for P > 1, the scale last before the stream, one launch counted.
    lib = _FakeLib()
    _fake_card(monkeypatch, lib)
    dims = _dims(("chip", name))
    b, sq, skv, h, hk, d, dv, causal, window = dims
    f32 = dtype == torch.float32
    want = _plan("dq", dims, parts=parts).parts if f32 else 1
    before = _counts()
    lse = _meta(b, h, sq)
    dq = pfa._launch_bwd_dq(_meta(b, sq, h, d, dtype=dtype),
                            _meta(b, skv, hk, d, dtype=dtype),
                            _meta(b, skv, hk, dv, dtype=dtype),
                            _meta(b, sq, h, dv, dtype=dtype), lse, lse,
                            causal, window, 0.125, parts)
    assert _counts() == (before[0], before[1] + 1, *before[2:])
    assert dq.shape == (b, sq, h, d)
    ((entry, call),) = lib.calls
    assert entry == "dq" and call[0] == int(f32)
    assert (call[8] is None) == (want == 1)
    assert call[9:18] == (b, h, hk, sq, skv, d, dv, int(causal), window)
    assert call[18:] == (want, 0.125, 0)


@pytest.mark.parametrize("kind", ["fwd", "dq"])
def test_a_failing_narrow_f32_launch_raises(monkeypatch, kind):
    # A CUDA error of the entry raises, names the entry and counts nothing.
    _fake_card(monkeypatch, _FakeLib(err=1))
    b, sq, skv, h, hk, d, dv, causal, window = _dims(("chip", "f32"))
    before = _counts()
    q, k, v = _meta(b, sq, h, d), _meta(b, skv, hk, d), _meta(b, skv, hk, dv)
    with pytest.raises(RuntimeError, match=f"flash_attention_(bwd_)?{kind} "
                       r"launch failed: cudaError_t 1"):
        if kind == "fwd":
            pfa._launch(q, k, v, causal, window)
        else:
            lse = _meta(b, h, sq)
            pfa._launch_bwd_dq(q, k, v, _meta(b, sq, h, dv), lse, lse, causal,
                               window, 0.125)
    assert _counts() == before
