"""The wide f32 forward's and dQ's cut of their work (marlin_tpu_torch/ops/
flash_attention.py: _f32_q_plan, the mirror of csrc/flash_fwd_dq_f32.cuh's
key_tiles, share_of and launch) and their two-pass merges.

On the card, in f32 above head dim 256, a CTA owns 64 query rows of one
query head, one share of the output's columns (at most 512) and one part
of the query tile's sweep over its live key tiles (128 keys a forward
tile, 64 a dQ tile); a query tile of several parts writes f32 partials
that a second launch merges in part order. The kernels run only on the
card (chip_smoke.py holds them against the plain versions there). Here
the plan is pinned against the masks it must cover, the merges are
emulated with the plain versions (each part's keys alone, merged in the
plan's order: within 1e-5 per 64-row tile of the whole sweep, and of the
JAX package's Pallas kernels), and the wrappers' calls of the entries are
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

import chip_smoke
from marlin_tpu.ops.flash_attention import _flash_hsd_impl
from marlin_tpu.ops.flash_attention import flash_attention as jax_flash
from marlin_tpu.utils.split import pad_to_multiple as jax_pad
from marlin_tpu_torch.ops import flash_attention as pfa

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "marlin_tpu_torch" / "csrc"
H100_SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One intra-op thread: these tests run beside wall-clock-timed tests
    # in the parallel suite, and their shapes are too small to need more.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _constant(header, name):
    text = (CSRC / header).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_the_plan_mirrors_the_kernels_constants():
    fwd_dq = "flash_fwd_dq_f32.cuh"
    assert pfa.F32_Q_ROWS == _constant(fwd_dq, "kQueries")
    assert pfa.F32_FWD_KEYS == _constant(fwd_dq, "kFwdKeys")
    assert pfa.F32_DQ_KEYS == _constant(fwd_dq, "kDqKeys")
    assert pfa.F32_COLUMNS == (_constant("flash_f32.cuh", "kMaxBoxes")
                               * _constant("flash_f32.cuh", "kBox"))


WIDE_F32 = tuple(s[0] for s in chip_smoke.SHAPES
                 if s[8] == "float32" and s[0] in chip_smoke.WIDE_KERNEL_SHAPES)

# Small cuts beside chip_smoke.py's wide f32 shapes: (B, Sq, Skv, H, Hk, D,
# Dv, causal, window). Causal with keys past the last query, a window, a
# cross length (non-causal), MQA with ragged ends, D != Dv.
SMALL = {"keys_past_queries": (1, 200, 300, 4, 2, 320, 320, True, 0),
         "window": (2, 500, 500, 4, 1, 384, 384, True, 90),
         "cross": (1, 70, 200, 2, 2, 64, 320, False, 0),
         "mqa_ragged": (1, 333, 333, 6, 1, 320, 320, True, 0),
         "d384_dv128": (1, 250, 250, 2, 1, 384, 128, True, 0)}


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


def _live_key_tiles(m0, sq, skv, keys, causal, window):
    """The tiles of ``keys`` keys holding a key that a query of the tile
    [m0, m0 + 64) sees, by brute force over the masks."""
    q = np.arange(m0, min(m0 + 64, sq))[:, None]
    k = np.arange(skv)[None, :]
    live = np.ones((q.shape[0], skv), bool)
    if causal:
        live &= k <= q
    if window:
        live &= k > q - window
    return sorted(set(np.flatnonzero(live.any(axis=0)) // keys))


def _part_tiles(plan, t):
    """Query tile ``t``'s parts in the order the second pass merges them,
    each a list of key tiles: its live key tiles in runs of ``chunk``, as
    the kernels cut them."""
    first, n = plan.tiles[t]
    tiles = list(range(first, first + n))
    return [tiles[p * plan.chunk:(p + 1) * plan.chunk]
            for p in range(plan.tile_parts[t])]


CASES = [("chip", n) for n in WIDE_F32] + [("small", n) for n in SMALL]


@pytest.mark.parametrize("kind", ["fwd", "dq"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[1])
def test_each_live_key_tile_of_a_query_tile_is_in_one_part_in_order(case,
                                                                    kind):
    # A query tile's parts, concatenated in the order the second pass
    # merges them, are exactly its live key tiles: every one once, each
    # part a contiguous run of at most `chunk`; key tiles at or past Skv
    # are in none. At H100's SMs and at 8 (more parts a query tile).
    dims = _dims(case)
    b, sq, skv, h, hk, d, dv, causal, window = dims
    for sms in (H100_SMS, 8):
        plan = _plan(kind, dims, sms)
        keys = pfa.F32_FWD_KEYS if kind == "fwd" else pfa.F32_DQ_KEYS
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
    units = [n for _, n in plan.tiles]
    cost = []
    for n, tp in zip(units[::-1], plan.tile_parts[::-1]):
        for i in range(tp):
            for _ in range(b * h):
                for _, cols in plan.shares:
                    st = (d // 64 + 2 * -(-cols // 128) if kind == "fwd"
                          else max(d, dv) // 64 + -(-cols // 128))
                    cost.append(min(plan.chunk, n - i * plan.chunk) * st + 1
                                + (tp > 1) * cols / 256)
    return pfa._f32_makespan(cost, H100_SMS)


@pytest.mark.parametrize("name,kind,parts,ctas", [
    ("d320_f32", "fwd", 4, 80), ("d320_f32", "dq", 4, 80),
    ("d1024_f32", "fwd", 4, 80), ("d1024_f32", "dq", 4, 80),
    ("d512_s2048_f32", "fwd", 1, 256), ("d512_s2048_f32", "dq", 1, 256)])
def test_the_plan_fills_an_h100_as_far_as_the_work_allows(name, kind, parts,
                                                          ctas):
    # PERF.md's wide f32 table shapes on an H100: the plan's CTAs finish
    # soonest of every P by the makespan model. At d320_f32 and d1024_f32
    # no P fills two waves of 132 SMs (8 query tiles of 1-4 forward or 1-8
    # dQ key tiles, x 4 CTAs), so the heaviest CTA sets the time: the
    # forward gives every key tile its own part (80 CTAs), dQ two of its
    # 64-key tiles (80; one a part would make 144 CTAs, past one wave). At
    # d512_s2048_f32 P = 1 (256 CTAs, 1.94 waves) beats P = 2 (384), in the
    # model and on the card (PERF.md).
    dims = _dims(("chip", name))
    b, sq, skv, h, hk, d, dv, causal, window = dims
    plan = _plan(kind, dims)
    assert (plan.parts, b * h * len(plan.shares) * sum(plan.tile_parts)) \
        == (parts, ctas)
    best = _makespan(plan, dims, kind)
    most = max(n for _, n in plan.tiles)
    for p in range(1, most + 1):
        assert best <= _makespan(_plan(kind, dims, parts=p), dims, kind)
    if name != "d512_s2048_f32":
        one_each = b * h * len(plan.shares) * sum(n for _, n in plan.tiles)
        assert one_each < pfa.F32_DKV_WAVES * H100_SMS


@pytest.mark.parametrize("kind", ["fwd", "dq"])
@pytest.mark.parametrize("name", WIDE_F32)
def test_the_workspace_is_p_planes_of_the_partials(name, kind):
    # The forward: P planes of unnormalised O (B, Sq, H, Dv), then P x
    # shares planes of m and of l (B, H, Sq); dQ: P planes of dQ (B, Sq,
    # H, D). None for P = 1.
    dims = _dims(("chip", name))
    b, sq, skv, h, hk, d, dv, causal, window = dims
    for parts in (None, 1, 3):
        plan = _plan(kind, dims, parts=parts)
        if kind == "fwd":
            per = b * sq * h * dv + 2 * len(plan.shares) * b * h * sq
        else:
            per = b * sq * h * d
        want = plan.parts * per * 4 if plan.parts > 1 else 0
        assert plan.workspace_bytes == want


@pytest.mark.parametrize("d,dv,fwd_shares,dq_shares,fwd_flops,dq_flops", [
    (320, 320, [(0, 320)], [(0, 320)], 1.0, 1.0),
    (384, 384, [(0, 384)], [(0, 384)], 1.0, 1.0),
    (512, 512, [(0, 512)], [(0, 512)], 1.0, 1.0),
    (384, 128, [(0, 128)], [(0, 384)], 1.0, 1.0),
    (64, 320, [(0, 320)], [(0, 64)], 1.0, 1.0),
    (576, 512, [(0, 512)], [(0, 256), (256, 320)], 1.0, 5504 / 3328),
    (1024, 1024, [(0, 512), (512, 512)], [(0, 512), (512, 512)], 1.5,
     5 / 3)])
def test_column_shares_and_their_flop(d, dv, fwd_shares, dq_shares,
                                      fwd_flops, dq_flops):
    # A CTA holds at most 512 output columns, as even as 64-column boxes
    # allow (share_of); each share computes the logits again: the forward
    # S (2 D FLOP a live pair) a share and P V (2 per output column), dQ
    # S and dP (2 D + 2 Dv) a share and dS K (2 per column), against the
    # counted 2 (D + Dv) and 2 (2 D + Dv).
    fwd = _plan("fwd", (1, 64, 64, 1, 1, d, dv, True, 0)).shares
    dq = _plan("dq", (1, 64, 64, 1, 1, d, dv, True, 0)).shares
    assert (fwd, dq) == (fwd_shares, dq_shares)
    assert pfa._wide_column_chunks(dv, torch.float32) == fwd_shares
    assert len(fwd) * 2 * d + 2 * dv == fwd_flops * 2 * (d + dv)
    assert len(dq) * (2 * d + 2 * dv) + 2 * d == pytest.approx(
        dq_flops * 2 * (2 * d + dv))


def _port_inputs(seed, b, sq, skv, h, hk, d, dv, causal, window):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((b, sq, h, d), (b, skv, hk, d), (b, skv, hk, dv)))
    do = torch.from_numpy(rng.standard_normal((b, sq, h, dv))
                          .astype(np.float32))
    scale = 1.0 / math.sqrt(d)
    q_hat, k, v = pfa._prepare(q, k, v, causal, scale, window)
    o, lse = pfa.flash_attention_reference(q_hat, k, v, causal, window)
    return q_hat, k, v, do, o, lse, pfa._delta(do, o), scale


def _part_span(plan, t, part, sq, skv, causal):
    """(r0, m0, m1, k0, k1): query tile t's rows [m0, m1), its part's keys
    [k0, k1), and the first row r0 of a plain call whose positions keep
    the masks' (causal: the part's first key, never past m0)."""
    m0, m1 = 64 * t, min(sq, 64 * t + 64)
    k0, k1 = part[0] * plan.keys, min(skv, (part[-1] + 1) * plan.keys)
    r0 = m0
    if causal:
        assert k0 <= m0
        r0 = k0
    return r0, m0, m1, k0, k1


def _fwd_merge(q_hat, k, v, causal, window, plan):
    """O and lse as the forward kernel takes them with ``plan``: for each
    query tile, each part's keys alone through the plain forward, merged
    in the parts' order (m = max m_p, weights 2^(m_p - m), l = sum of the
    weighted l_p, O = sum of the weighted O_p over l, lse = m + log2 l;
    here from each part's normalised O_p and lse_p = m_p + log2 l_p)."""
    b, sq, h, _ = q_hat.shape
    skv = k.shape[1]
    o = torch.zeros((b, sq, h, v.shape[3]))
    lse = torch.zeros((b, h, sq))
    for t in range(len(plan.tiles)):
        outs = []
        for part in _part_tiles(plan, t):
            r0, m0, m1, k0, k1 = _part_span(plan, t, part, sq, skv, causal)
            op, lp = pfa.flash_attention_reference(
                q_hat[:, r0:m1], k[:, k0:k1], v[:, k0:k1], causal, window)
            outs.append((op[:, m0 - r0:], lp[:, :, m0 - r0:]))
        top = outs[0][1]
        for _, lp in outs[1:]:
            top = torch.maximum(top, lp)
        weight, acc = torch.zeros_like(top), torch.zeros_like(outs[0][0])
        for op, lp in outs:
            w = torch.exp2(lp - top)
            weight += w
            acc += op * w.permute(0, 2, 1)[..., None]
        weight = weight.clamp_min(1e-30)
        o[:, m0:m1] = acc / weight.permute(0, 2, 1)[..., None]
        lse[:, :, m0:m1] = top + torch.log2(weight)
    return o, lse


def _dq_two_pass(q_hat, k, v, do, lse, delta, causal, window, scale, plan):
    """dQ as the kernel takes it with ``plan``: for each query tile, each
    part's keys alone through the plain backward (scale 1), summed in f32
    in the parts' order, then times scale."""
    b, sq, h, d = q_hat.shape
    skv = k.shape[1]
    dq = torch.zeros((b, sq, h, d))
    for t in range(len(plan.tiles)):
        acc = None
        for part in _part_tiles(plan, t):
            r0, m0, m1, k0, k1 = _part_span(plan, t, part, sq, skv, causal)
            dq_p = pfa._bwd_reference(
                q_hat[:, r0:m1], k[:, k0:k1], v[:, k0:k1], do[:, r0:m1],
                lse[:, :, r0:m1], delta[:, :, r0:m1], causal, window,
                1.0)[0][:, m0 - r0:]
            acc = dq_p if acc is None else acc + dq_p
        dq[:, m0:m1] = acc * scale
    return dq


@pytest.mark.parametrize("name,sms", [("keys_past_queries", 132),
                                      ("window", 132), ("cross", 16),
                                      ("mqa_ragged", 132),
                                      ("d384_dv128", 16)])
def test_forward_part_merge_matches_the_whole_sweep(name, sms):
    # Each part's plain forward, merged in the plan's order, against the
    # plain forward of the whole sweep: O within 1e-5 per 64-row tile
    # (chip_smoke.py's f32 limit) and lse within 1e-4 (only the order of
    # the sums differs). The plan cuts query tiles into several parts.
    dims = SMALL[name]
    plan = _plan("fwd", dims, sms)
    assert plan.parts > 1
    q_hat, k, v, _, o, lse, _, _ = _port_inputs(70, *dims)
    got_o, got_lse = _fwd_merge(q_hat, k, v, dims[7], dims[8], plan)
    assert chip_smoke.tile_rel_err(got_o, o) <= 1e-5
    assert (got_lse - lse).abs().max().item() <= 1e-4
    assert (got_o - o).abs().max().item() <= 1e-4


@pytest.mark.parametrize("name,sms", [("keys_past_queries", 132),
                                      ("window", 40), ("cross", 8),
                                      ("mqa_ragged", 132),
                                      ("d384_dv128", 8)])
def test_dq_two_pass_sum_matches_the_whole_sweep(name, sms):
    # Each part's plain dQ (scale 1), summed in f32 in the plan's order and
    # then scaled, against the plain backward of the whole sweep: within
    # 1e-5 per 64-position tile.
    dims = SMALL[name]
    plan = _plan("dq", dims, sms)
    assert plan.parts > 1
    q_hat, k, v, do, _, lse, delta, scale = _port_inputs(71, *dims)
    got = _dq_two_pass(q_hat, k, v, do, lse, delta, dims[7], dims[8], scale,
                       plan)
    ref = pfa._bwd_reference(q_hat, k, v, do, lse, delta, dims[7], dims[8],
                             scale)[0]
    assert chip_smoke.tile_rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("d", [320, 1024])
def test_both_merges_match_jax(d):
    # The two emulations at head dims 320 (one share) and 1024 (two), GQA,
    # causal, 256 positions (two 128-key forward tiles at the last query
    # tiles), the plans cut for an H100 (several parts a query tile),
    # against the JAX package's Pallas kernels in interpret mode: its flash
    # forward (O, and lse from _flash_hsd_impl) and jax.vjp of
    # flash_attention (dQ), within 1e-5.
    sq, h, hk = 256, 4, 2
    dims = (1, sq, sq, h, hk, d, d, True, 0)
    fwd, dq_plan = _plan("fwd", dims), _plan("dq", dims)
    assert fwd.parts > 1 and dq_plan.parts > 1
    assert len(fwd.shares) == len(dq_plan.shares) == (1 if d == 320 else 2)
    rng = np.random.default_rng(72)
    q, k, v, g = (rng.standard_normal(s).astype(np.float32) for s in
                  ((sq, h, d), (sq, hk, d), (sq, hk, d), (sq, h, d)))
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
    o, lse = _fwd_merge(q_hat, kk, vv, True, 0, fwd)
    np.testing.assert_allclose(o[0].numpy(), np.asarray(o_jax), atol=1e-5,
                               rtol=1e-5, err_msg="O")
    np.testing.assert_allclose(lse[0].numpy(), np.asarray(lse_jax),
                               atol=1e-5, rtol=1e-5, err_msg="lse")
    o_ref, lse_ref = pfa.flash_attention_reference(q_hat, kk, vv, True, 0)
    do = torch.from_numpy(g)[None]
    dq = _dq_two_pass(q_hat, kk, vv, do, lse_ref, pfa._delta(do, o_ref),
                      True, 0, scale, dq_plan)
    np.testing.assert_allclose(dq[0].numpy(), np.asarray(jdq), atol=1e-5,
                               rtol=1e-5, err_msg="dq")


class _FakeLib:
    """Records the wide forward's and dQ's entries' arguments and returns
    ``err``."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def marlin_flash_attention_fwd_wide(self, *args):
        self.calls.append(("fwd", args))
        return self.err

    def marlin_flash_attention_bwd_dq_wide(self, *args):
        self.calls.append(("dq", args))
        return self.err


def _fake_card(monkeypatch, lib):
    # The wrapper's view of a card, on meta tensors: the fake library, no
    # device checks, a stream of 0 and an H100's SMs.
    monkeypatch.setattr(pfa, "_wide_lib", lambda: lib)
    monkeypatch.setattr(pfa, "_check_launch", lambda *a, **kw: None)
    monkeypatch.setattr(pfa, "_sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


@pytest.mark.parametrize("name", ["d320_f32", "d1024_f32", "d64_dv320_f32",
                                  "d512_s2048_f32"])
@pytest.mark.parametrize("lse_chunks", [False, True])
def test_the_wrapper_hands_the_forward_entry_its_plan(monkeypatch, name,
                                                      lse_chunks):
    # The plan's P, a workspace only for P > 1 (the meta tensor's address,
    # 0; None for P = 1), lse copies one a column share when asked for,
    # and one launch counted, the second pass included.
    lib = _FakeLib()
    _fake_card(monkeypatch, lib)
    dims = _dims(("chip", name))
    b, sq, skv, h, hk, d, dv, causal, window = dims
    plan = _plan("fwd", dims)
    before = (pfa.wide_launches, pfa.wide_dq_launches)
    o, lse, chunks = pfa._launch_wide(_meta(b, sq, h, d), _meta(b, skv, hk, d),
                                      _meta(b, skv, hk, dv), causal, window,
                                      lse_chunks=lse_chunks)
    assert (pfa.wide_launches, pfa.wide_dq_launches) == (before[0] + 1,
                                                         before[1])
    assert o.shape == (b, sq, h, dv) and lse.shape == (b, h, sq)
    assert (chunks is None) == (not lse_chunks)
    if lse_chunks:
        assert chunks.shape == (len(plan.shares), b, h, sq)
    ((entry, call),) = lib.calls
    assert entry == "fwd" and call[0] == 1  # f32
    assert (call[6] is None) == (not lse_chunks)
    assert (call[7] is None) == (plan.parts == 1)
    assert call[8:17] == (b, h, hk, sq, skv, d, dv, int(causal), window)
    assert call[17] == plan.parts and call[18] == 0


@pytest.mark.parametrize("name", ["d320_f32", "d1024_f32", "d64_dv320_f32",
                                  "d512_s2048_f32"])
@pytest.mark.parametrize("parts", [None, 1, 2])
def test_the_wrapper_hands_the_dq_entry_its_plan(monkeypatch, name, parts):
    # dQ: the plan's P (or the caller's), a workspace only for P > 1, the
    # scale last before the stream, one launch counted.
    lib = _FakeLib()
    _fake_card(monkeypatch, lib)
    dims = _dims(("chip", name))
    b, sq, skv, h, hk, d, dv, causal, window = dims
    plan = _plan("dq", dims, parts=parts)
    before = (pfa.wide_launches, pfa.wide_dq_launches)
    lse = _meta(b, h, sq)
    dq = pfa._launch_bwd_dq(_meta(b, sq, h, d), _meta(b, skv, hk, d),
                            _meta(b, skv, hk, dv), _meta(b, sq, h, dv), lse,
                            lse, causal, window, 0.125, parts)
    assert (pfa.wide_launches, pfa.wide_dq_launches) == (before[0],
                                                         before[1] + 1)
    assert dq.shape == (b, sq, h, d)
    ((entry, call),) = lib.calls
    assert entry == "dq" and call[0] == 1
    assert (call[8] is None) == (plan.parts == 1)
    assert call[9:18] == (b, h, hk, sq, skv, d, dv, int(causal), window)
    assert call[18:] == (plan.parts, 0.125, 0)


@pytest.mark.parametrize("kind", ["fwd", "dq"])
def test_a_failing_wide_f32_launch_raises(monkeypatch, kind):
    _fake_card(monkeypatch, _FakeLib(err=1))
    b, sq, skv, h, hk, d, dv, causal, window = _dims(("chip", "d320_f32"))
    before = (pfa.wide_launches, pfa.wide_dq_launches)
    q, k, v = _meta(b, sq, h, d), _meta(b, skv, hk, d), _meta(b, skv, hk, dv)
    with pytest.raises(RuntimeError, match=f"flash_attention_(bwd_)?{kind}"
                       r"_wide launch failed: cudaError_t 1"):
        if kind == "fwd":
            pfa._launch_wide(q, k, v, causal, window)
        else:
            lse = _meta(b, h, sq)
            pfa._launch_bwd_dq(q, k, v, _meta(b, sq, h, dv), lse, lse, causal,
                               window, 0.125)
    assert (pfa.wide_launches, pfa.wide_dq_launches) == before
