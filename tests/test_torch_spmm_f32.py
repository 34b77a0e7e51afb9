"""The f32 block-sparse SpMM kernel's cut of its work (marlin_tpu_torch/ops/
block_sparse.py's _spmm_f32_plan and _spmm_f32_part_run, the mirrors of
csrc/block_sparse.cu's run_f32 and part_run) and its two-pass sum.

On the card, in f32, both routes run one kernel, spmm_f32<GATHER>: a CTA
owns a 128 x 64 output tile inside one block column and one sweep part of
it, a run of the column's live blocks in ascending k (its list, or its
mask column, counted on the card); P > 1 parts write f32 planes of a
workspace that a second launch adds in part order. P comes from the shape
alone (the masked route runs where the mask has no host value), so the
two routes cut alike and their results are bitwise equal. The kernel runs
only on the card (chip_smoke.py holds it against the plain version
there). Here the plan is pinned on an H100's 132 SMs, the cut is pinned
against the columns it must cover, the two-pass sum is emulated with the
plain version's block product (each part's run alone, added in part
order: within 1e-5 per 64 x 64 tile of the whole sweep, and of the JAX
package's Pallas kernels in interpret mode), and the wrappers' calls of
the entries are pinned with a fake library.
"""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from marlin_tpu.ops import BlockSparse as JaxBlockSparse
from marlin_tpu.ops import block_sparse_matmul as jax_block_sparse_matmul
from marlin_tpu_torch.ops import BlockSparse
from marlin_tpu_torch.ops import block_sparse as pbs

H100_SMS = 132
TILE_TOL = 1e-5  # chip_smoke.py's f32 SpMM limit, worst 64 x 64 tile
SRC = (Path(__file__).resolve().parents[1] / "marlin_tpu_torch" / "csrc" /
       "block_sparse.cu").read_text()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One intra-op thread: these tests run beside wall-clock-timed tests
    # in the parallel suite, and their shapes are too small to need more.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# chip_smoke.py's f32 SpMM shapes: name -> (M, K, N, bs).
TABLE = {s[0]: s[1:5] for s in chip_smoke.SPMM_SHAPES if s[6] == "float32"}

# Skinny outputs over a deep K, where the plan cuts columns into parts.
DEEP = {"deep_k": (256, 4096, 512, 128), "deep_k_ragged": (200, 8192, 256, 64),
        "two_tiles": (128, 4096, 128, 64)}


def _plan(dims, sms=H100_SMS, parts=None):
    return pbs._spmm_f32_plan(*dims, sms, parts)


def _tiles(m, n):
    return -(-m // pbs.SPMM_F32_ROWS) * (n // pbs.SPMM_F32_COLS)


def _makespan(dims, p):
    """The makespan model's reading of P = ``p`` at ``dims`` on 132 SMs:
    each unit's steps in grid order (a row of tiles' parts, each part's
    column tiles), one more for its stores, and the second pass."""
    m, k, n, bs = dims
    blocks = k // bs
    runs = [hi - lo for lo, hi in (pbs._spmm_f32_part_run(blocks, p, q)
                                   for q in range(p))]
    row = [r * bs // pbs.SPMM_F32_STEP + 1 for r in runs
           for _ in range(n // pbs.SPMM_F32_COLS)]
    cost = row * -(-m // pbs.SPMM_F32_ROWS)
    return (pbs._spmm_f32_makespan(cost, H100_SMS)
            + (p > 1) * (p + 1) * m * n * 4 / pbs.SPMM_F32_STEP_BYTES)


def test_the_makespan_of_the_persistent_grid():
    # Up to 132 units, one a CTA, one CTA an SM: the longest unit. Up to
    # 264, two CTAs on the busiest SMs. Past that, CTA x takes units x,
    # x + 264, ...: SM x the units of CTAs x and x + 132.
    f = pbs._spmm_f32_makespan
    assert f([3.0] * 100, H100_SMS) == 3.0
    assert f([1.0] * 99 + [7.0], H100_SMS) == 7.0
    assert f([2.0] * 264, H100_SMS) == 4.0
    assert f([2.0] * 133, H100_SMS) == 4.0
    assert f([1.0] * 265, H100_SMS) == 3.0
    cost = [float(u % 5) for u in range(1000)]
    want = max(sum(c for u, c in enumerate(cost) if u % 264 % 132 == x)
               for x in range(132))
    assert f(cost, H100_SMS) == want


def test_the_table_and_chip_smoke_agree():
    # PERF.md's f32 table is chip_smoke.py's f32 SpMM shapes, the sparse
    # bench configuration at f32 among them.
    assert tuple(TABLE) == chip_smoke.SPMM_F32_SHAPES
    assert TABLE["bench512_f32"] == (8192, 8192, 8192, 512)


@pytest.mark.parametrize("name,units,ctas", [
    ("f32", 128, 128), ("tall_m_f32", 131072, 264),
    ("wide_n_f32", 65536, 264), ("bench512_f32", 8192, 264)])
def test_the_plan_at_the_table_shapes_on_an_h100(name, units, ctas):
    # P = 1 at every table shape: `f32`'s 128 tiles of 8 blocks (all live)
    # take one SM each, and P = 2 would put two units of half the steps on
    # most SMs and add a second pass; the others fill the card 16 times
    # over or more. No workspace. The persistent grid is two CTAs an SM,
    # or one a unit where there are fewer units.
    plan = _plan(TABLE[name])
    assert plan == pbs.SpmmF32Plan(1, units, ctas, 0)
    if _tiles(*TABLE[name][::2]) < 16 * H100_SMS:
        best = _makespan(TABLE[name], 1)
        m, k, n, bs = TABLE[name]
        assert all(best <= _makespan(TABLE[name], p)
                   for p in range(2, k // bs + 1))


@pytest.mark.parametrize("name,parts", [("deep_k", 8), ("deep_k_ragged", 16),
                                        ("two_tiles", 64)])
def test_a_deep_k_over_few_tiles_is_cut_into_parts(name, parts):
    # Few output tiles over many blocks: the plan splits each column's
    # sweep, the P it picks finishing soonest of every P by the model
    # (the least among equals), its workspace P planes of C.
    dims = DEEP[name]
    m, k, n, bs = dims
    plan = _plan(dims)
    assert plan.parts == parts
    assert plan.units == plan.ctas == _tiles(m, n) * parts
    assert plan.workspace_bytes == parts * m * n * 4
    spans = {p: _makespan(dims, p) for p in range(1, k // bs + 1)}
    assert spans[parts] == min(spans.values())
    assert all(spans[p] > spans[parts] for p in range(1, parts))


@pytest.mark.parametrize("name", list(TABLE) + list(DEEP))
def test_the_workspace_is_p_planes_of_c(name):
    # (P, M, N) f32 for P > 1; none for P = 1. The units are the tiles
    # times P, whatever P the caller forces; the grid at most two CTAs an
    # SM.
    dims = {**TABLE, **DEEP}[name]
    m, k, n, bs = dims
    for parts in (None, 1, 2, 3):
        plan = _plan(dims, parts=parts)
        if parts is not None:
            assert plan.parts == parts
        assert plan.units == _tiles(m, n) * plan.parts
        assert plan.ctas == min(plan.units, 2 * H100_SMS)
        assert plan.workspace_bytes == (plan.parts * m * n * 4
                                        if plan.parts > 1 else 0)


def test_the_plan_takes_no_mask_and_follows_the_card():
    # The plan's arguments are the shape and the card: nothing of the
    # mask reaches it (the masked route has no host value to give). Fewer
    # SMs never take more parts.
    assert list(pbs._spmm_f32_plan.__wrapped__.__code__.co_varnames[:6]) == [
        "m", "k", "n", "bs", "sms", "parts"]
    for dims in DEEP.values():
        assert _plan(dims, sms=8).parts <= _plan(dims).parts


@pytest.mark.parametrize("parts", [1, 2, 3, 4, 7, 16])
def test_each_live_block_is_in_one_part_in_order(parts):
    # A column's P runs, concatenated in part order, are its live blocks in
    # ascending k, each once; near-equal (their lengths differ by at most
    # one), some empty where the column has fewer blocks than parts.
    for n in range(0, 40):
        runs = [pbs._spmm_f32_part_run(n, parts, p) for p in range(parts)]
        assert runs[0][0] == 0 and runs[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
        sizes = [hi - lo for lo, hi in runs]
        assert max(sizes) - min(sizes) <= 1


def test_the_source_cuts_as_the_plan_does():
    # csrc/block_sparse.cu's part_run, tile and persistent grid are the
    # plan's.
    body = SRC[SRC.index("void part_run("):]
    body = body[:body.index("\n}\n")]
    assert "*lo = (int)((long long)p * n / parts);" in body
    assert "*hi = (int)((long long)(p + 1) * n / parts);" in body
    for name, value in (("kFRows", pbs.SPMM_F32_ROWS),
                        ("kFCols", pbs.SPMM_F32_COLS),
                        ("kFStep", pbs.SPMM_F32_STEP),
                        ("kFCtasPerSm", pbs.SPMM_F32_CTAS_PER_SM)):
        assert re.search(rf"constexpr int {name} = {value};", SRC), name


def _live(mask, j, gather):
    """Column j's live blocks in the order a route walks them: its list
    (kidx[j, :kcnt[j]]) or its mask column scanned in ascending k."""
    if gather:
        kidx, kcnt, _ = pbs._column_block_lists(mask)
        return [int(x) for x in kidx[j, :kcnt[j]]]
    return [k for k in range(mask.shape[0]) if mask[k, j]]


def test_the_gather_and_the_mask_walks_give_the_same_runs(rng):
    # Both routes count the same blocks (kcnt[j], or n_live of the mask
    # column) and walk them in the same order, so each part takes the
    # same run on both.
    for keep in (0.0, 0.1, 0.4, 0.9, 1.0):
        mask = rng.random((24, 9)) < keep
        for j in range(mask.shape[1]):
            g, m = _live(mask, j, True), _live(mask, j, False)
            assert g == m
            for parts in (1, 2, 5, 30):
                for p in range(parts):
                    lo, hi = pbs._spmm_f32_part_run(len(g), parts, p)
                    assert g[lo:hi] == m[lo:hi]


def _two_pass(a, data, mask, bs, parts, gather=True):
    """The kernel's sum emulated with the plain version's block product:
    each part's run of each column's live blocks into its own f32 plane,
    then the planes added in part order (plane 0 first, as
    spmm_part_sum_f32 does); at P = 1 the one plane is C."""
    m, n = a.shape[0], data.shape[1]
    ws = torch.zeros((parts, m, n), dtype=torch.float32)
    for j in range(n // bs):
        live = _live(mask, j, gather)
        for p in range(parts):
            lo, hi = pbs._spmm_f32_part_run(len(live), parts, p)
            for k in live[lo:hi]:
                pbs._accumulate(ws[p], a, data, k, j, bs)
    out = ws[0].clone()
    for q in range(1, parts):
        out = out + ws[q]
    return out


# (M, K, N, bs, mask): ragged M, bs 64 and 128, an empty column and an
# all-live column among random ones.
CASES = {"ragged_bs64": (100, 512, 256, 64, "random"),
         "bs128": (72, 1024, 256, 128, "random"),
         "empty_column": (64, 512, 256, 64, "empty_column"),
         "all_live_column": (130, 512, 256, 128, "all_live_column")}


def _inputs(name):
    m, k, n, bs, kind = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 150)
    a = rng.standard_normal((m, k)).astype(np.float32)
    data = rng.standard_normal((k, n)).astype(np.float32)
    mask = rng.random((k // bs, n // bs)) < 0.4
    if kind == "empty_column":
        mask[:, 1] = False
    if kind == "all_live_column":
        mask[:, 0] = True
    data *= np.repeat(np.repeat(mask, bs, 0), bs, 1)  # zero dead blocks
    return a, data, mask, bs


def _parts_of(name):
    """The plan's P on an H100 for the case, and P = 2 and 3."""
    m, k, n, bs, _ = CASES[name]
    return sorted({_plan((m, k, n, bs)).parts, 2, 3})


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_two_pass_sum_matches_the_whole_sweep(name):
    # Every P: within 1e-5 per 64 x 64 tile of the whole sweep (the plain
    # version), exactly 0 under an empty column; P = 1 is the whole sweep
    # bit for bit; the masked walk's runs give the gather walk's result
    # bit for bit.
    a, data, mask, bs = _inputs(name)
    at, dt = torch.from_numpy(a), torch.from_numpy(data)
    kidx, kcnt, _ = pbs._column_block_lists(mask)
    whole = pbs.spmm_gather_reference(at, dt, kidx, kcnt, bs)
    assert torch.equal(_two_pass(at, dt, mask, bs, 1), whole)
    empty = np.repeat(~mask.any(axis=0), bs)
    for parts in _parts_of(name):
        got = _two_pass(at, dt, mask, bs, parts)
        assert chip_smoke.tile_rel_err_2d(got, whole) <= TILE_TOL
        assert torch.equal(got, _two_pass(at, dt, mask, bs, parts,
                                          gather=False))
        assert not got[:, torch.from_numpy(empty)].any()
    if name == "empty_column":
        assert empty.any()
    if name == "all_live_column":
        assert mask[:, 0].all()


@pytest.mark.parametrize("route", ["gather", "masked"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_the_two_pass_sum_matches_the_pallas_kernels(name, route):
    # The emulation at the plan's P (and P = 2, 3) against the JAX
    # package's Pallas kernels in interpret mode, as the parity tests of
    # test_torch_block_sparse.py run them: the gather kernel on a concrete
    # mask, the masked-grid kernel under jax.jit. Within 1e-5 per tile.
    a, data, mask, bs = _inputs(name)
    if route == "gather":
        jb = JaxBlockSparse(jnp.asarray(data), jnp.asarray(mask), bs)
        assert jb._host_mask is not None
        ref = np.asarray(jax_block_sparse_matmul(jnp.asarray(a), jb))
    else:
        @jax.jit
        def f(a, data, mask):  # the mask is a tracer: the masked kernel
            return jax_block_sparse_matmul(a, JaxBlockSparse(data, mask, bs))

        ref = np.asarray(f(jnp.asarray(a), jnp.asarray(data),
                           jnp.asarray(mask)))
    at, dt = torch.from_numpy(a), torch.from_numpy(data)
    for parts in _parts_of(name):
        got = _two_pass(at, dt, mask, bs, parts, gather=route == "gather")
        assert chip_smoke.tile_rel_err_2d(
            got, torch.from_numpy(ref.copy())) <= TILE_TOL


class _FakeLib:
    """Records the SpMM entries' arguments and returns ``err``."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def marlin_block_sparse_spmm_gather(self, *args):
        self.calls.append(("gather", args))
        return self.err

    def marlin_block_sparse_spmm_masked(self, *args):
        self.calls.append(("masked", args))
        return self.err


def _fake_card(monkeypatch, lib):
    # The wrapper's view of a card, on meta tensors: the fake library, no
    # device checks, a stream of 0 and an H100's SMs.
    monkeypatch.setattr(pbs, "_kernel_lib", lambda: lib)
    monkeypatch.setattr(pbs, "_check_launch", lambda *a, **kw: None)
    monkeypatch.setattr(pbs, "_sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _counts():
    return pbs.gather_launches, pbs.masked_launches


def _launch(route, dims, dtype, parts, max_nnz=3):
    m, k, n, bs = dims
    a, data = _meta(m, k, dtype=dtype), _meta(k, n, dtype=dtype)
    ints = dict(dtype=torch.int32)
    if route == "gather":
        return pbs._launch_gather(a, data, _meta(n // bs, max_nnz, **ints),
                                  _meta(n // bs, **ints), max_nnz, bs,
                                  parts=parts)
    return pbs._launch_masked(a, data, _meta(k // bs, n // bs, **ints), bs,
                              parts=parts)


# f32 with the plan's P, P = 1 and P = 2 forced; bf16 (one part only).
DTYPE_PARTS = [(torch.float32, None), (torch.float32, 1),
               (torch.float32, 2), (torch.bfloat16, None)]


@pytest.mark.parametrize("dtype,parts", DTYPE_PARTS)
@pytest.mark.parametrize("name", ["f32", "bench512_f32", "deep_k",
                                  "deep_k_ragged"])
@pytest.mark.parametrize("route", ["gather", "masked"])
def test_the_wrapper_hands_the_entries_the_plan(monkeypatch, route, name,
                                                dtype, parts):
    # f32: the plan's P (or the caller's) last before the stream, a
    # workspace only for P > 1 (the meta tensor's address, 0; None for
    # P = 1). bf16: P = 1 and no workspace whatever the plan. One launch
    # counted on the route, the second pass included.
    lib = _FakeLib()
    _fake_card(monkeypatch, lib)
    dims = {**TABLE, **DEEP}[name]
    m, k, n, bs = dims
    f32 = dtype == torch.float32
    want = _plan(dims, parts=parts).parts if f32 else 1
    before = _counts()
    out = _launch(route, dims, dtype, parts)
    gather = route == "gather"
    assert _counts() == (before[0] + gather, before[1] + (not gather))
    assert out.shape == (m, n) and out.dtype == dtype
    ((entry, call),) = lib.calls
    assert entry == route and call[0] == int(f32)
    ws_at = 6 if gather else 5
    assert (call[ws_at] is None) == (want == 1)
    assert call[ws_at + 1:ws_at + 5] == (m, k, n, bs)
    if gather:
        assert call[11] == 3  # max_nnz
    assert call[-2:] == (want, 0)


@pytest.mark.parametrize("name", ["f32", "deep_k", "deep_k_ragged"])
def test_both_routes_get_one_p_whatever_the_mask(monkeypatch, name, rng):
    # The same shape under two masks, through the public entry point on
    # both routes: one P for all four calls (the plan's), so the routes
    # cut every column alike.
    lib = _FakeLib()
    _fake_card(monkeypatch, lib)
    m, k, n, bs = {**TABLE, **DEEP}[name]
    for keep in (0.1, 0.9):
        for host_mask in (True, False):
            mask = rng.random((k // bs, n // bs)) < keep
            b = BlockSparse(torch.zeros((k, n)), torch.from_numpy(mask), bs)
            if not host_mask:
                b._host_mask = None
            b.data = b.data.to("meta")
            pbs.block_sparse_matmul(_meta(m, k), b)
    ps = {call[-2] for _, call in lib.calls}
    assert [e for e, _ in lib.calls] == ["gather", "masked"] * 2
    assert ps == {_plan((m, k, n, bs)).parts}


@pytest.mark.parametrize("route", ["gather", "masked"])
@pytest.mark.parametrize("parts", [None, 2])
def test_a_failing_f32_launch_raises(monkeypatch, route, parts):
    # A CUDA error of the entry raises, names the route and counts
    # nothing, at P = 1 and with a second pass.
    _fake_card(monkeypatch, _FakeLib(err=1))
    before = _counts()
    with pytest.raises(RuntimeError, match=f"block_sparse_spmm_{route} "
                       r"launch failed: cudaError_t 1"):
        _launch(route, TABLE["f32"], torch.float32, parts)
    assert _counts() == before


def test_the_entries_refuse_what_the_kernels_do_not_take():
    # The C side's own guards, read from the source: P < 1, a null
    # workspace at P > 1, bf16 with P != 1.
    body = SRC[SRC.index("cudaError_t run_f32("):]
    assert ("if (parts < 1 || (parts > 1 && ws == nullptr)) return "
            "cudaErrorInvalidValue;") in body[:body.index("\n}\n")]
    body = SRC[SRC.index("cudaError_t run(int dtype"):]
    assert "if (parts != 1) return cudaErrorInvalidValue;" in body[
        :body.index("\n}\n")]
