"""The f32 dK/dV kernels' cut of their work (marlin_tpu_torch/ops/
flash_attention.py: _f32_dkv_plan, the mirror of csrc/flash_dkv_f32.cuh's
query_tiles, part_count, share_of and launch) and their two-pass sum.

On the card, in f32 at every head dim, a CTA owns 64 keys of one KV head,
one column share of dK and dV and one part of the key tile's sweep over
its (query head, live query tile) pairs; a key tile of several parts
writes f32 partial sums that a second launch adds in part order. The
kernels run only on the card (chip_smoke.py holds them against the plain
backward there). Here the plan is pinned against the masks it must cover,
the two-pass sum is emulated with the plain backward (each part's pairs
alone, summed in f32 in the plan's order: within 1e-5 of the whole
sweep's, and of the JAX package's VJP), and the wrappers' calls of the
entries are pinned with a fake library.
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
from marlin_tpu.ops.flash_attention import flash_attention as jax_flash
from marlin_tpu_torch.ops import flash_attention as pfa

ROOT = Path(__file__).resolve().parents[1]
H100_SMS = 132
HEADER = ROOT / "marlin_tpu_torch" / "csrc" / "flash_dkv_f32.cuh"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One intra-op thread: these tests run beside wall-clock-timed tests
    # in the parallel suite, and their shapes are too small to need more.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plan(name, sms=H100_SMS):
    """(plan, B, Sq, Skv, H, Hk, D, Dv, causal, window) of chip_smoke.py's
    shape ``name`` at the kernel head dims the wrapper pads to."""
    _, b, sq, skv, h, hk, d, dv, _, causal, window = \
        chip_smoke.SHAPE_BY_NAME[name]
    d, dv = pfa._kernel_head_dims(d, dv)
    return (pfa._f32_dkv_plan(b, h, hk, sq, skv, d, dv, causal, window, sms),
            b, sq, skv, h, hk, d, dv, causal, window)


F32_SHAPES = tuple(s[0] for s in chip_smoke.SHAPES if s[8] == "float32")


def _part_pairs(plan, t):
    """Key tile ``t``'s parts in the order the second pass sums them, each
    a list of (query head in the group, query tile) pairs: the key tile's
    pairs, head-major, in runs of ``chunk``, as the kernels cut them."""
    first, n = plan.tiles[t]
    pairs = [(g, first + i) for g in range(plan.group) for i in range(n)]
    return [pairs[p * plan.chunk:(p + 1) * plan.chunk]
            for p in range(plan.tile_parts[t])]


def test_the_plan_mirrors_the_kernels_constants():
    # The dK/dV's own constants, and the box and the most boxes a CTA of
    # the f32 kernels' shared header, flash_f32.cuh, which it includes.
    text = HEADER.read_text() + (HEADER.parent / "flash_f32.cuh").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             text).group(1))

    assert pfa.F32_DKV_KEYS == constant("kKeys")
    assert pfa.F32_DKV_QUERIES == constant("kQueries")
    assert pfa.F32_COLUMNS == constant("kMaxBoxes") * constant("kBox")


def _live_query_tiles(n0, sq, skv, causal, window):
    """The query tiles holding a query that sees a key of [n0, n0 + 64),
    by brute force over the masks."""
    q = np.arange(sq)[:, None]
    k = np.arange(n0, min(n0 + 64, skv))[None, :]
    live = np.ones((sq, k.shape[1]), bool)
    if causal:
        live &= k <= q
    if window:
        live &= k > q - window
    rows = np.flatnonzero(live.any(axis=1))
    return sorted(set(rows // 64))


# Small cuts beside chip_smoke.py's f32 shapes: cross lengths with keys
# past the last query (causal), a window, MQA, ragged ends.
SMALL = {"keys_past_queries": (1, 100, 300, 4, 2, 64, 64, True, 0),
         "window": (2, 500, 500, 4, 1, 128, 64, True, 90),
         "cross": (1, 70, 200, 2, 2, 64, 320, False, 0),
         "mqa_ragged": (1, 333, 333, 6, 1, 256, 256, True, 0)}


def _small(name, sms):
    b, sq, skv, h, hk, d, dv, causal, window = SMALL[name]
    return (pfa._f32_dkv_plan(b, h, hk, sq, skv, d, dv, causal, window, sms),
            b, sq, skv, h, hk, d, dv, causal, window)


@pytest.mark.parametrize("case", [("chip", n) for n in F32_SHAPES]
                         + [("small", n) for n in SMALL])
def test_each_live_pair_of_a_key_tile_is_in_one_part_in_order(case):
    # A key tile's parts, concatenated in the order the second pass sums
    # them, are exactly its (query head, live query tile) pairs, head-major:
    # every pair once, each part a contiguous run of at most `chunk` pairs.
    kind, name = case
    plan, b, sq, skv, h, hk, d, dv, causal, window = (
        _plan(name) if kind == "chip" else _small(name, 16))
    group = h // hk
    assert plan.group == group
    assert len(plan.tiles) == -(-skv // 64) == len(plan.tile_parts)
    for t in range(len(plan.tiles)):
        live = _live_query_tiles(t * 64, sq, skv, causal, window)
        want = [(g, i) for g in range(group) for i in live]
        parts = _part_pairs(plan, t)
        assert [p for part in parts for p in part] == want
        assert len(parts) == plan.tile_parts[t] <= plan.parts
        assert all(0 < len(part) <= plan.chunk for part in parts) or (
            want == [] and parts == [[]])
    assert max(plan.tile_parts) == plan.parts


@pytest.mark.parametrize("name", ["f32", "d256_f32", "d320_f32",
                                  "d1024_f32", "train_f32",
                                  "d512_s2048_f32"])
def test_the_plan_fills_two_waves_of_an_h100(name):
    # PERF.md's f32 table shapes and the LARGE_F32_SHAPES: B x Hk x shares
    # x the key tiles' parts CTAs fill at least two waves of one CTA an SM.
    plan, b, _, _, _, hk, *_ = _plan(name)
    ctas = b * hk * len(plan.shares) * sum(plan.tile_parts)
    assert ctas >= pfa.F32_DKV_WAVES * H100_SMS


def test_the_cut_at_the_table_shapes():
    # The flagship step's attention in f32 fills 512 CTAs of one part a key
    # tile: no workspace, no second pass. f32 (B = 1, 16 key tiles, four
    # query heads a KV head) cuts its causal triangle by live work: key
    # tile 0 (64 pairs) into P parts, the last one (4 pairs) into fewest.
    plan = _plan("train_f32")[0]
    assert (plan.parts, plan.workspace_bytes) == (1, 0)
    plan = _plan("f32")[0]
    assert plan.parts == plan.tile_parts[0] > 2 * plan.tile_parts[-1]
    assert plan.tile_parts == sorted(plan.tile_parts, reverse=True)


@pytest.mark.parametrize("name", F32_SHAPES)
def test_the_workspace_is_p_planes_of_dk_and_dv(name):
    plan, b, _, skv, _, hk, d, dv, _, _ = _plan(name)
    want = plan.parts * b * skv * hk * (d + dv) * 4
    assert plan.workspace_bytes == (want if plan.parts > 1 else 0)


@pytest.mark.parametrize("d,dv,shares,flops", [
    (128, 128, [(0, 128, 0, 128)], 1.0),
    (256, 256, [(0, 256, 0, 256)], 1.0),
    (384, 128, [(0, 384, 0, 128)], 1.0),
    (320, 320, [(0, 320, 0, 0), (0, 0, 0, 320)], 1.25),
    (512, 512, [(0, 512, 0, 0), (0, 0, 0, 512)], 1.25),
    (1024, 1024, [(0, 512, 0, 0), (512, 512, 0, 0), (0, 0, 0, 512),
                  (0, 0, 512, 512)], 2.0)])
def test_column_shares_and_their_flop(d, dv, shares, flops):
    # A CTA holds at most 512 output columns: all of dK and dV where they
    # fit, else dK's shares then dV's. Each share computes S^T (2 D FLOP a
    # pair) again; a dK share also dP^T (2 Dv); then 2 FLOP a pair per
    # output column: the source note's FLOP a live pair, against the
    # counted 4 (D + Dv).
    assert pfa._f32_dkv_shares(d, dv) == shares
    work = sum(2 * d + (2 * dv if nk else 0) + 2 * (nk + nv)
               for _, nk, _, nv in shares)
    assert work == flops * 4 * (d + dv)


def _two_pass(q_hat, k, v, do, lse, delta, causal, window, scale, plan):
    """dK and dV as the kernels take them with ``plan``: for each key tile,
    each part's pairs alone through the plain backward (dO and Delta zero
    outside them), summed in f32 in the parts' order."""
    b, sq, h, _ = q_hat.shape
    hk = k.shape[2]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for t in range(len(plan.tiles)):
        keys = slice(t * 64, (t + 1) * 64)
        for part in _part_pairs(plan, t):
            mask = torch.zeros((sq, h))
            for g, i in part:
                for j in range(hk):
                    mask[i * 64:(i + 1) * 64, j * plan.group + g] = 1
            _, pk, pv = pfa._bwd_reference(
                q_hat, k, v, do * mask[None, :, :, None], lse,
                delta * mask.T[None], causal, window, scale)
            dk[:, keys] += pk[:, keys]
            dv[:, keys] += pv[:, keys]
    return dk, dv


def _port_inputs(seed, b, sq, skv, h, hk, d, dv, causal, window):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((b, sq, h, d), (b, skv, hk, d), (b, skv, hk, dv)))
    do = torch.from_numpy(rng.standard_normal((b, sq, h, dv))
                          .astype(np.float32))
    scale = 1.0 / math.sqrt(d)
    q_hat, k, v = pfa._prepare(q, k, v, causal, scale, window)
    o, lse = pfa.flash_attention_reference(q_hat, k, v, causal, window)
    return q_hat, k, v, do, lse, pfa._delta(do, o), scale


@pytest.mark.parametrize("name,sms", [("keys_past_queries", 132),
                                      ("window", 132), ("cross", 16),
                                      ("mqa_ragged", 40)])
def test_two_pass_sum_matches_the_whole_sweep(name, sms):
    # Each part's plain backward, summed in f32 in the plan's order,
    # against the plain backward of the whole sweep: within 1e-5 per
    # 64-position tile (chip_smoke.py's f32 limit; only the order of the
    # sums differs). The plan cuts key tiles into several parts here.
    plan, b, sq, skv, h, hk, d, dv, causal, window = _small(name, sms)
    assert plan.parts > 1
    q_hat, k, v, do, lse, delta, scale = _port_inputs(
        60, b, sq, skv, h, hk, d, dv, causal, window)
    got = _two_pass(q_hat, k, v, do, lse, delta, causal, window, scale,
                    plan)
    _, *ref = pfa._bwd_reference(q_hat, k, v, do, lse, delta, causal,
                                 window, scale)
    seen = min(sq, skv) if causal else skv  # keys some query sees
    for label, a, r in zip(("dk", "dv"), got, ref):
        assert chip_smoke.tile_rel_err(a[:, :seen], r[:, :seen]) <= 1e-5, \
            label
        assert not a[:, seen:].any() and not r[:, seen:].any(), label


@pytest.mark.parametrize("d", [128, 320])
def test_two_pass_sum_matches_jax(d):
    # The emulation at head dims 128 (the narrow kernel) and 320 (the wide
    # one: a dK share and a dV share), GQA, causal, 128 positions, the plan
    # cut for a card of 8 SMs (several parts a key tile), against jax.vjp
    # of the JAX package's flash_attention (its Pallas kernels in interpret
    # mode): within 1e-5, the f32 tolerance of test_torch_flash_wide.py.
    sq, h, hk = 128, 4, 2
    plan = pfa._f32_dkv_plan(1, h, hk, sq, sq, d, d, True, 0, 8)
    assert plan.parts > 1
    assert len(plan.shares) == (1 if d == 128 else 2)
    rng = np.random.default_rng(61)
    q, k, v, g = (rng.standard_normal(s).astype(np.float32) for s in
                  ((sq, h, d), (sq, hk, d), (sq, hk, d), (sq, h, d)))
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=True,
                                               interpret=True),
                     *(jnp.asarray(x) for x in (q, k, v)))
    _, jdk, jdv = vjp(jnp.asarray(g))
    scale = 1.0 / math.sqrt(d)
    q_hat, kt, vt = pfa._prepare(*(torch.from_numpy(x)[None]
                                   for x in (q, k, v)), True, scale, 0)
    o, lse = pfa.flash_attention_reference(q_hat, kt, vt, True, 0)
    do = torch.from_numpy(g)[None]
    dk, dvv = _two_pass(q_hat, kt, vt, do, lse, pfa._delta(do, o), True, 0,
                        scale, plan)
    np.testing.assert_allclose(dk[0].numpy(), np.asarray(jdk), atol=1e-5,
                               rtol=1e-5, err_msg="dk")
    np.testing.assert_allclose(dvv[0].numpy(), np.asarray(jdv), atol=1e-5,
                               rtol=1e-5, err_msg="dv")


class _FakeLib:
    """Records both dK/dV entries' arguments and returns ``err``."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def marlin_flash_attention_bwd_dkv(self, *args):
        self.calls.append(("narrow", args))
        return self.err

    def marlin_flash_attention_bwd_dkv_wide(self, *args):
        self.calls.append(("wide", args))
        return self.err


def _fake_card(monkeypatch, lib):
    # The wrapper's view of a card, on meta tensors: the fake library for
    # both sources, no device checks, a stream of 0 and an H100's SMs.
    monkeypatch.setattr(pfa, "_bwd_lib", lambda: lib)
    monkeypatch.setattr(pfa, "_wide_lib", lambda: lib)
    monkeypatch.setattr(pfa, "_check_launch", lambda *a, **kw: None)
    monkeypatch.setattr(pfa, "_sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())


def _meta_inputs(name):
    _, b, sq, skv, h, hk, d, dv, _, causal, window = \
        chip_smoke.SHAPE_BY_NAME[name]
    d, dv = pfa._kernel_head_dims(d, dv)

    def t(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    lse = t(b, h, sq)
    return (t(b, sq, h, d), t(b, skv, hk, d), t(b, skv, hk, dv),
            t(b, sq, h, dv), lse, lse), causal, window


@pytest.mark.parametrize("name,entry", [
    ("f32", "narrow"), ("train_f32", "narrow"), ("d256_f32", "narrow"),
    ("d320_f32", "wide"), ("d1024_f32", "wide"), ("d64_dv320_f32", "wide")])
def test_the_wrapper_hands_each_f32_entry_its_plan(monkeypatch, name,
                                                   entry):
    # The narrow entry at D and Dv up to 256, the wide one above: each
    # gets the plan's P, a workspace only for P > 1 (the meta tensor's
    # address, 0; None for P = 1), and one launch is counted on its own
    # counter, the second pass included.
    lib = _FakeLib()
    _fake_card(monkeypatch, lib)
    args, causal, window = _meta_inputs(name)
    plan, b, sq, skv, h, hk, d, dv, _, _ = _plan(name)
    before = (pfa.bwd_dkv_launches, pfa.wide_dkv_launches)
    dk, dv_ = pfa._launch_bwd_dkv(*args, causal, window)
    after = (pfa.bwd_dkv_launches, pfa.wide_dkv_launches)
    assert after == ((before[0] + 1, before[1]) if entry == "narrow"
                     else (before[0], before[1] + 1))
    assert dk.shape == args[1].shape and dv_.shape == args[2].shape
    ((got_entry, call),) = lib.calls
    assert got_entry == entry and call[0] == 1  # f32
    assert call[10:19] == (b, h, hk, sq, skv, d, dv, int(causal), window)
    assert call[19] == plan.parts and call[20] == 0
    assert (call[9] is None) == (plan.parts == 1)


@pytest.mark.parametrize("name", ["f32", "d320_f32"])
def test_a_failing_f32_dkv_launch_raises(monkeypatch, name):
    _fake_card(monkeypatch, _FakeLib(err=1))
    args, causal, window = _meta_inputs(name)
    before = (pfa.bwd_dkv_launches, pfa.wide_dkv_launches)
    with pytest.raises(RuntimeError, match="flash_attention_bwd_dkv"
                       r"(_wide)? launch failed: cudaError_t 1"):
        pfa._launch_bwd_dkv(*args, causal, window)
    assert (pfa.bwd_dkv_launches, pfa.wide_dkv_launches) == before


def test_check_launch_refuses_an_f32_base_off_16_bytes():
    # The f32 dK/dV reads every operand 16 bytes at a time (cp.async): a
    # contiguous f32 view at an odd offset is refused, as a bf16 one is
    # for TMA, before anything else is looked at.
    store = torch.zeros(1 + 2 * 8 * 64, dtype=torch.float32)
    bad = store[1:].view(1, 2, 8, 64)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        pfa._check_launch({"q": bad}, 64, 64)
