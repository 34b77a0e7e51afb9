"""The port's block-sparse GEMM (marlin_tpu_torch/ops/block_sparse) against
the JAX package's, whose Pallas kernels run in interpret mode on the CPU
as tests/test_block_sparse.py runs them.

On the CPU the port's wrapper takes its plain versions; these tests are
the twins of tests/test_block_sparse.py on the port, hold the plain
versions to the Pallas kernels on shared numpy inputs (the gather route
with a concrete mask, the masked-grid route under ``jax.jit`` against the
port with its host-value probe stood in for), hold the gradients to
``jax.grad``, and pin the dispatch rule: the plain versions only for CPU
tensors, a kernel or an error for anything else. The kernels themselves
run only on the card: chip_smoke.py holds them against the plain versions
there.

Tolerances. f32 parity with the Pallas kernels at atol = rtol = 1e-5: both
sides form f32 block products and sum them in f32, in different orders.
Against a float64 numpy product 1e-4, as tests/test_block_sparse.py
holds the JAX package. bf16 is held exactly on a case whose f32
accumulation is exact.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marlin_tpu.ops import BlockSparse as JaxBlockSparse
from marlin_tpu.ops import block_sparse_matmul as jax_block_sparse_matmul
from marlin_tpu_torch.ops import BlockSparse, block_sparse_matmul
from marlin_tpu_torch.ops import block_sparse as pbs

BS = 8
TOL = dict(atol=1e-5, rtol=1e-5)
ORACLE_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One intra-op thread: these tests run beside wall-clock-timed tests
    # in the parallel suite, and their shapes are too small to need more.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block_sparse_dense(rng, rows, cols, keep=0.4, bs=BS):
    arr = rng.standard_normal((rows, cols)).astype(np.float32)
    for bi in range(rows // bs):
        for bj in range(cols // bs):
            if rng.random() > keep:
                arr[bi * bs:(bi + 1) * bs, bj * bs:(bj + 1) * bs] = 0
    return arr


def _port(arr, bs=BS):
    return BlockSparse.from_dense(arr, block_size=bs, device="cpu")


class TestBlockSparse:
    def test_from_dense_mask(self, rng):
        arr = _block_sparse_dense(rng, 32, 24)
        b = _port(arr)
        assert b.mask.shape == (4, 3) and b.mask.dtype == torch.int32
        expected = np.array(
            [[np.any(arr[i * BS:(i + 1) * BS, j * BS:(j + 1) * BS])
              for j in range(3)] for i in range(4)])
        np.testing.assert_array_equal(b.mask.numpy().astype(bool), expected)
        jb = JaxBlockSparse.from_dense(arr, block_size=BS)
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(jb.mask))
        np.testing.assert_array_equal(b.data.numpy(), np.asarray(jb.data))
        assert b.block_density == pytest.approx(jb.block_density)

    def test_from_dense_pads(self, rng):
        arr = rng.standard_normal((10, 13)).astype(np.float32)
        b = _port(arr)
        assert b.shape == (16, 16)
        np.testing.assert_allclose(b.to_dense().numpy()[:10, :13], arr)
        assert not b.to_dense().numpy()[10:].any()
        assert not b.to_dense().numpy()[:, 13:].any()

    def test_matmul_matches_dense(self, rng):
        arr = _block_sparse_dense(rng, 40, 24)
        a = rng.standard_normal((16, 40)).astype(np.float32)
        out = block_sparse_matmul(torch.from_numpy(a), _port(arr))
        np.testing.assert_allclose(out.numpy(), a @ arr, **ORACLE_TOL)

    def test_matmul_uneven_m(self, rng):
        # The JAX wrapper pads M up to the block size and slices the
        # result; the port's kernels mask the ragged edge, and its plain
        # versions take any M.
        arr = _block_sparse_dense(rng, 24, 16)
        a = rng.standard_normal((11, 24)).astype(np.float32)
        out = block_sparse_matmul(torch.from_numpy(a), _port(arr))
        assert out.shape == (11, 16)
        np.testing.assert_allclose(out.numpy(), a @ arr, **ORACLE_TOL)

    def test_all_zero_matrix(self, rng):
        b = _port(np.zeros((16, 16), np.float32))
        a = rng.standard_normal((8, 16)).astype(np.float32)
        out = block_sparse_matmul(torch.from_numpy(a), b)
        assert not out.numpy().any()

    def test_matmul_with_a_mask_that_has_no_host_value(self, rng,
                                                       monkeypatch):
        # The twin of test_matmul_under_jit_tracer_mask: a mask without a
        # host value (on the card: under CUDA-graph capture; here the
        # probe is stood in for) takes the masked-grid route.
        arr = _block_sparse_dense(rng, 24, 16)
        a = rng.standard_normal((16, 24)).astype(np.float32)
        eager = _port(arr)
        monkeypatch.setattr(pbs, "_host_value", lambda mask: None)
        b = BlockSparse(eager.data, eager.mask, BS)
        assert b._host_mask is None
        monkeypatch.setattr(pbs, "spmm_gather_reference", _must_not_run)
        out = block_sparse_matmul(torch.from_numpy(a), b)
        np.testing.assert_allclose(out.numpy(), a @ arr, **ORACLE_TOL)

    def test_empty_column_blocks(self, rng):
        arr = _block_sparse_dense(rng, 32, 24, keep=1.0)
        arr[:, 8:16] = 0  # middle block-column entirely empty
        a = rng.standard_normal((8, 32)).astype(np.float32)
        out = block_sparse_matmul(torch.from_numpy(a), _port(arr))
        np.testing.assert_allclose(out.numpy(), a @ arr, **ORACLE_TOL)
        np.testing.assert_array_equal(out.numpy()[:, 8:16], 0.0)

    def test_dimension_mismatch(self):
        b = _port(np.ones((16, 16), np.float32))
        with pytest.raises(ValueError, match="dimension mismatch"):
            block_sparse_matmul(torch.ones((4, 8)), b)

    def test_mask_shape_contract(self):
        with pytest.raises(ValueError, match="block grid"):
            BlockSparse(torch.ones((16, 16)), torch.ones((3, 2)), BS)
        with pytest.raises(ValueError, match="not divisible"):
            BlockSparse(torch.ones((16, 12)), torch.ones((2, 1)), BS)

    def test_unmasked_blocks_are_zeroed_at_construction(self, rng):
        data = rng.standard_normal((16, 16)).astype(np.float32)
        mask = np.array([[1, 0], [0, 1]])
        b = BlockSparse(torch.from_numpy(data), mask, BS)
        jb = JaxBlockSparse(jnp.asarray(data), jnp.asarray(mask), BS)
        np.testing.assert_array_equal(b.data.numpy(), np.asarray(jb.data))
        assert not b.data.numpy()[:8, 8:].any()

    def test_gather_lists_match_the_jax_package_and_are_cached(self, rng):
        from marlin_tpu.ops.block_sparse import _column_block_lists

        mask = rng.random((6, 5)) < 0.4
        mask[:, 1] = False
        for got, want in zip(pbs._column_block_lists(mask),
                             _column_block_lists(mask)):
            np.testing.assert_array_equal(got, want)
        b = BlockSparse(torch.zeros((48, 40)), mask, BS)
        assert b._gather_lists() is b._gather_lists()
        assert b._gather_lists()[0].dtype == torch.int32


def _must_not_run(*args, **kwargs):
    raise AssertionError("the wrong plain version was reached")


class TestBf16Accumulation:
    def test_bf16_output_accumulates_f32_across_k(self):
        # B filled with 1 + 2^-6 (exact in bf16): each 128-wide k-block
        # contributes exactly 130.0 per output element; the exact product
        # over 8 k-blocks is 1040.0 (bf16-representable). A bf16 running
        # sum rounds intermediates and lands on 1032.0; one f32
        # accumulator across all of a column's blocks keeps every partial
        # exact.
        n, bs = 1024, 128
        b = BlockSparse(torch.full((n, n), 1.0 + 2.0 ** -6,
                                   dtype=torch.bfloat16),
                        torch.ones((n // bs, n // bs), dtype=torch.bool), bs)
        a = torch.ones((n, n), dtype=torch.bfloat16)
        out = block_sparse_matmul(a, b)
        assert out.dtype == torch.bfloat16
        out = out.double()
        assert out.min() == out.max() == 1040.0, (out.min(), out.max())

    @pytest.mark.parametrize("route", ["gather", "masked"])
    def test_bf16_exact_case_equals_the_pallas_kernel(self, route,
                                                      monkeypatch):
        # The same construction at n = 256, bs = 32: each block
        # contributes 32.5, the exact sum over 8 blocks is 260.0; a bf16
        # running sum would pass through 162.5, which bf16 cannot hold.
        n, bs = 256, 32
        val = 1.0 + 2.0 ** -6
        jb = JaxBlockSparse(jnp.full((n, n), val, jnp.bfloat16),
                            jnp.ones((n // bs, n // bs), bool), bs)
        ref = np.asarray(jax_block_sparse_matmul(
            jnp.ones((n, n), jnp.bfloat16), jb), np.float64)
        if route == "masked":
            monkeypatch.setattr(pbs, "_host_value", lambda mask: None)
        b = BlockSparse.from_numpy(np.asarray(jb.data, np.float32),
                                   np.asarray(jb.mask), bs, device="cpu",
                                   dtype=torch.bfloat16)
        out = block_sparse_matmul(torch.ones((n, n), dtype=torch.bfloat16),
                                  b).double().numpy()
        assert ref.min() == ref.max() == 260.0
        np.testing.assert_array_equal(out, ref)


# (M, K, N, block size, keep)
PARITY_CASES = {
    "square": (16, 40, 24, 8, 0.4),
    "ragged_m": (11, 24, 16, 8, 0.5),
    "wide_blocks": (40, 64, 96, 32, 0.5),
    "dense": (16, 32, 32, 8, 1.0),
    "very_sparse": (24, 64, 64, 8, 0.1),
}


def _parity_inputs(name):
    m, k, n, bs, keep = PARITY_CASES[name]
    rng = np.random.default_rng(sorted(PARITY_CASES).index(name))
    data = rng.standard_normal((k, n)).astype(np.float32)
    mask = rng.random((k // bs, n // bs)) < keep
    a = rng.standard_normal((m, k)).astype(np.float32)
    return a, data, mask, bs


class TestParityWithThePallasKernels:
    @pytest.mark.parametrize("name", sorted(PARITY_CASES))
    def test_gather_route(self, name):
        a, data, mask, bs = _parity_inputs(name)
        jb = JaxBlockSparse(jnp.asarray(data), jnp.asarray(mask), bs)
        assert jb._host_mask is not None  # the Pallas gather kernel
        ref = np.asarray(jax_block_sparse_matmul(jnp.asarray(a), jb))
        b = BlockSparse.from_numpy(np.asarray(jb.data), np.asarray(jb.mask),
                                   bs, device="cpu")
        out = block_sparse_matmul(torch.from_numpy(a), b)
        np.testing.assert_allclose(out.numpy(), ref, **TOL)

    @pytest.mark.parametrize("name", sorted(PARITY_CASES))
    def test_masked_route(self, name, monkeypatch):
        a, data, mask, bs = _parity_inputs(name)

        @jax.jit
        def f(a, data, mask):  # the mask is a tracer: the masked kernel
            return jax_block_sparse_matmul(a, JaxBlockSparse(data, mask, bs))

        ref = np.asarray(f(jnp.asarray(a), jnp.asarray(data),
                           jnp.asarray(mask)))
        monkeypatch.setattr(pbs, "_host_value", lambda mask: None)
        monkeypatch.setattr(pbs, "spmm_gather_reference", _must_not_run)
        b = BlockSparse.from_numpy(data, mask, bs, device="cpu")
        out = block_sparse_matmul(torch.from_numpy(a), b)
        np.testing.assert_allclose(out.numpy(), ref, **TOL)

    @pytest.mark.parametrize("name", sorted(PARITY_CASES))
    def test_the_two_plain_versions_are_bitwise_equal(self, name):
        a, data, mask, bs = _parity_inputs(name)
        b = BlockSparse.from_numpy(data, mask, bs, device="cpu")
        kidx, kcnt, _ = pbs._column_block_lists(mask)
        at = torch.from_numpy(a)
        assert torch.equal(
            pbs.spmm_gather_reference(at, b.data, kidx, kcnt, bs),
            pbs.spmm_masked_reference(at, b.data, b.mask, bs))

    def test_the_plain_versions_skip_dead_blocks(self, rng):
        # On a backing array that is NOT zeroed under dead blocks (which
        # BlockSparse never hands over, and chip_smoke.py uses to catch a
        # kernel that multiplies instead of skipping), both read only the
        # live blocks.
        a, data, mask, bs = _parity_inputs("square")
        kidx, kcnt, _ = pbs._column_block_lists(mask)
        at, raw = torch.from_numpy(a), torch.from_numpy(data)
        zeroed = BlockSparse(raw, mask, bs).data
        want = pbs.spmm_gather_reference(at, zeroed, kidx, kcnt, bs)
        assert torch.equal(
            pbs.spmm_gather_reference(at, raw, kidx, kcnt, bs), want)
        assert torch.equal(
            pbs.spmm_masked_reference(at, raw, torch.from_numpy(mask), bs),
            want)

    def test_float64_runs_through_the_plain_versions(self, rng):
        a, data, mask, bs = _parity_inputs("square")
        b = BlockSparse.from_numpy(data.astype(np.float64), mask, bs,
                                   device="cpu")
        out = block_sparse_matmul(torch.from_numpy(a), b)
        assert out.dtype == torch.float64
        np.testing.assert_allclose(
            out.numpy(), a.astype(np.float64) @ b.data.numpy(), rtol=1e-12,
            atol=1e-12)


class TestGradients:
    @pytest.mark.parametrize("route", ["gather", "masked"])
    def test_grads_match_jax_grad_and_the_dense_oracle(self, rng, route,
                                                       monkeypatch):
        # Forward = the kernel's plain version; backward = the closed-form
        # recompute. Against jax.grad through the JAX package's custom
        # VJP and against autograd through the dense zero-masked product:
        # dA equal, dB equal on masked blocks and zero elsewhere.
        n, bs = 128, 32
        mask = rng.random((n // bs, n // bs)) < 0.5
        data = rng.standard_normal((n, n)).astype(np.float32)
        a = rng.standard_normal((n, n)).astype(np.float32)

        jb = JaxBlockSparse(jnp.asarray(data), jnp.asarray(mask), bs)

        def jax_loss(a, d):
            bb = JaxBlockSparse.__new__(JaxBlockSparse)
            bb.data, bb.mask, bb.block_size = d, jb.mask, bs
            bb._host_mask, bb._gather_lists_cache = jb._host_mask, None
            return jnp.sum(jax_block_sparse_matmul(a, bb) ** 2)

        ja, jd = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(a), jb.data)

        if route == "masked":
            monkeypatch.setattr(pbs, "_host_value", lambda mask: None)
        at = torch.from_numpy(a).requires_grad_(True)
        dt = torch.from_numpy(data).requires_grad_(True)
        out = block_sparse_matmul(at, BlockSparse(dt, mask, bs))
        assert out.grad_fn is not None
        out.square().sum().backward()
        np.testing.assert_allclose(at.grad.numpy(), np.asarray(ja),
                                   **ORACLE_TOL)
        np.testing.assert_allclose(dt.grad.numpy(), np.asarray(jd),
                                   **ORACLE_TOL)

        ad = torch.from_numpy(a).requires_grad_(True)
        dd = torch.from_numpy(np.array(jb.data)).requires_grad_(True)
        (ad @ dd).square().sum().backward()
        bm = np.repeat(np.repeat(mask, bs, 0), bs, 1)
        np.testing.assert_allclose(at.grad.numpy(), ad.grad.numpy(),
                                   **ORACLE_TOL)
        np.testing.assert_allclose(dt.grad.numpy()[bm], dd.grad.numpy()[bm],
                                   **ORACLE_TOL)
        assert np.all(dt.grad.numpy()[~bm] == 0)

    def test_gradients_keep_the_operands_dtypes(self, rng):
        a = torch.randn((16, 32), dtype=torch.bfloat16, requires_grad=True)
        d = torch.randn((32, 16), dtype=torch.bfloat16, requires_grad=True)
        b = BlockSparse(d, torch.ones((4, 2)), 8)
        block_sparse_matmul(a, b).float().sum().backward()
        assert a.grad.dtype == d.grad.dtype == torch.bfloat16

    def test_no_graph_is_kept_when_nothing_requires_grad(self, rng):
        b = _port(_block_sparse_dense(rng, 16, 16))
        out = block_sparse_matmul(torch.ones((4, 16)), b)
        assert out.grad_fn is None and not out.requires_grad
        a = torch.ones((4, 16), requires_grad=True)
        with torch.no_grad():
            assert block_sparse_matmul(a, b).grad_fn is None


class TestDispatch:
    """CPU tensors take the plain versions; any other tensor takes a
    kernel or raises. Tensors on the ``meta`` device stand in for CUDA
    tensors on a machine without a card."""

    @staticmethod
    def _meta_operands(rng, bs=64, host_mask=True):
        arr = _block_sparse_dense(rng, 2 * bs, 2 * bs, keep=0.6, bs=bs)
        b = _port(arr, bs)
        if not host_mask:
            b._host_mask = None
        b.data = b.data.to("meta")
        return torch.empty((bs, 2 * bs), device="meta"), b

    def test_cpu_tensors_take_the_plain_version(self, rng, monkeypatch):
        def no_kernel():
            raise AssertionError("a kernel was reached for CPU tensors")

        monkeypatch.setattr(pbs, "_kernel_lib", no_kernel)
        before = pbs.gather_launches, pbs.masked_launches
        b = _port(_block_sparse_dense(rng, 16, 16))
        assert torch.isfinite(block_sparse_matmul(torch.ones((4, 16)),
                                                  b)).all()
        # The counters count kernel launches only.
        assert (pbs.gather_launches, pbs.masked_launches) == before

    @pytest.mark.parametrize("host_mask,kernel", [(True, "gather"),
                                                  (False, "masked")])
    def test_other_tensors_take_the_kernel_of_their_route(
            self, rng, monkeypatch, host_mask, kernel):
        calls = []
        monkeypatch.setattr(
            pbs, "_launch_gather",
            lambda a, data, kidx, kcnt, max_nnz, bs: calls.append("gather"))
        monkeypatch.setattr(
            pbs, "_launch_masked",
            lambda a, data, mask, bs: calls.append("masked"))
        monkeypatch.setattr(pbs, "spmm_gather_reference", _must_not_run)
        monkeypatch.setattr(pbs, "spmm_masked_reference", _must_not_run)
        a, b = self._meta_operands(rng, host_mask=host_mask)
        block_sparse_matmul(a, b)
        assert calls == [kernel]

    @pytest.mark.parametrize("host_mask,kernel", [(True, "gather"),
                                                  (False, "masked")])
    def test_a_failing_kernel_loader_propagates(self, rng, monkeypatch,
                                                host_mask, kernel):
        # When the kernel cannot be built or loaded, the error reaches
        # the caller. Nothing falls back to the plain version.
        def broken_loader(name):
            raise RuntimeError(f"cannot build {name}")

        monkeypatch.setattr(pbs.build, "load", broken_loader)
        a, b = self._meta_operands(rng, host_mask=host_mask)
        with pytest.raises(RuntimeError, match="cannot build block_sparse"):
            block_sparse_matmul(a, b)

    def test_the_wrapper_refuses_what_the_kernels_do_not_take(
            self, rng, monkeypatch):
        monkeypatch.setattr(pbs, "_kernel_lib", lambda: None)
        a, b = self._meta_operands(rng)
        with pytest.raises(ValueError, match="CUDA tensor"):
            block_sparse_matmul(a, b)
        # A block size that is not a multiple of 64, "on the card".
        a8, b8 = self._meta_operands(rng, bs=8)
        with pytest.raises(ValueError, match="multiples of 64"):
            block_sparse_matmul(a8, b8)
        # float64 "on the card": the TPU kernels never ran it on hardware.
        b.data = b.data.double()
        with pytest.raises(ValueError, match="bf16 or f32"):
            block_sparse_matmul(a, b)
        square = torch.empty((128, 128), device="meta")
        with pytest.raises(ValueError, match="int32"):
            pbs._check_launch(square, square, 64, mask=torch.ones((2, 2)))
        with pytest.raises(ValueError, match="at least one row"):
            pbs._check_launch(square[:0], square, 64)
        with pytest.raises(ValueError, match="do not form a product"):
            pbs._check_launch(a, square[:64], 64)
        ints = dict(dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="mask has shape"):
            pbs._check_launch(square, square, 64,
                              mask=torch.empty((2, 3), **ints))
        with pytest.raises(ValueError, match="kcnt has shape"):
            pbs._check_launch(square, square, 64,
                              kidx=torch.empty((2, 2), **ints),
                              kcnt=torch.empty((3,), **ints))

    @pytest.mark.parametrize("which", ["a", "b"])
    def test_check_launch_refuses_a_bf16_base_off_16_bytes(self, which):
        # The bf16 kernel's TMA loads need 16-byte-aligned bases: a
        # contiguous bf16 view at an odd offset is refused before the
        # device is looked at, and aligned operands get as far as the
        # device check.
        store = torch.zeros(1 + 128 * 128, dtype=torch.bfloat16)
        bad = store[1:].view(128, 128)
        assert bad.is_contiguous() and bad.data_ptr() % 16
        good = torch.zeros((128, 128), dtype=torch.bfloat16)
        a, b = (bad, good) if which == "a" else (good, bad)
        with pytest.raises(ValueError, match="16-byte aligned"):
            pbs._check_launch(a, b, 64)
        with pytest.raises(ValueError, match="CUDA tensor"):
            pbs._check_launch(good, good, 64)

    def test_mixed_devices_raise(self, rng):
        a, b = self._meta_operands(rng)
        with pytest.raises(ValueError, match="is on"):
            block_sparse_matmul(torch.ones((64, 128)), b)

    def test_the_probe_reads_the_host_value_outside_graph_capture(self):
        mask = torch.tensor([[1, 0], [0, 1]], dtype=torch.int32)
        np.testing.assert_array_equal(pbs._host_value(mask), mask.numpy())


class TestNoSilentCpuFallback:
    @pytest.fixture(autouse=True)
    def _no_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("CUDA is present: the default device is valid here")

    def test_constructors_default_to_cuda_and_raise(self, rng):
        arr = _block_sparse_dense(rng, 16, 16)
        with pytest.raises(RuntimeError, match="CUDA"):
            BlockSparse.from_dense(arr, block_size=BS)
        with pytest.raises(RuntimeError, match="CUDA"):
            BlockSparse.from_numpy(arr, np.ones((2, 2)), BS)
        # A tensor stays where it is; asked for explicitly, the CPU works.
        assert BlockSparse.from_dense(torch.from_numpy(arr),
                                      BS).data.device.type == "cpu"
        assert BlockSparse.from_numpy(arr, np.ones((2, 2)), BS,
                                      device="cpu").shape == (16, 16)


class TestLaunchGrid:
    """The kernels take every grid the Pallas grids (m // bm, n // bn, .)
    take: each SpMM launch is one 1-D grid of row tiles x column tiles
    (gridDim.x holds 2^31 - 1 CTAs, gridDim.y and .z 65535), decoded from
    blockIdx.x in the kernel. Read from the source: the kernels build and
    run only on the card, where chip_smoke.py drives M = 8,388,608 and
    N = 4,194,304 on every route."""

    SRC = (Path(__file__).resolve().parents[1] / "marlin_tpu_torch" /
           "csrc" / "block_sparse.cu").read_text()

    @classmethod
    def _body(cls, start):
        body = cls.SRC[cls.SRC.index(start):]
        return body[:body.index("\n}\n")]

    @pytest.mark.parametrize("kernel, decode", [
        ("spmm_ring_bf16(", ("const unsigned n_cols = N / BN;",
                             "(blockIdx.x % n_cols) * BN",
                             "(blockIdx.x / n_cols) * kGBM")),
        ("spmm_f32(", ("unsigned p_unit = blockIdx.x;",
                       "p_unit += gridDim.x;",
                       "for (unsigned u = blockIdx.x; u < g.units; "
                       "u += gridDim.x) {",
                       "const unsigned n_cols = g.N / kFCols;",
                       "const unsigned rest = u / n_cols;",
                       "(int)(rest / g.parts) * kFRows",
                       "(int)(u % n_cols) * kFCols",
                       "(int)(rest % g.parts)")),
    ])
    def test_each_kernel_decodes_its_tile_from_blockidx_x(self, kernel,
                                                          decode):
        # Both kernels keep block columns fastest (the CTAs in flight share
        # rows of A). The bf16 ring's CTA is one tile; the f32 kernel's grid
        # is persistent: CTA x takes units x, x + G, ... of row tiles x
        # sweep parts x column tiles (an unsigned count of at most
        # 2^31 - 1), each decoded by unit_of.
        body = self._body(kernel)
        if kernel == "spmm_f32(":
            body += self._body("F32Unit unit_of(")
        for text in decode:
            assert text in body, text
        assert "blockIdx.y" not in body and "blockIdx.z" not in body

    def test_no_launch_puts_a_tile_count_on_grid_y_or_z(self):
        # Three 1-D launches: the bf16 ring's grid of row tiles x column
        # tiles; the f32 kernel's persistent grid, at most two CTAs an SM,
        # over its units (row tiles x column tiles x sweep parts, counted
        # by the same guard); the f32 second pass's grid-stride loop over C.
        launches = re.findall(r"<<<([^,]+),", self.SRC)
        assert sorted(launches) == ["ctas", "grid", "sum_grid"]
        assert "dim3" not in self.SRC
        assert "gridDim.y" not in self.SRC and "gridDim.z" not in self.SRC
        for run in ("run_ring_bf16(", "run_f32("):
            body = self._body(run)
            assert "const unsigned grid = grid_1d(" in body
            assert "if (grid == 0) return cudaErrorInvalidValue;" in body
        assert ("const unsigned ctas = min(grid, (unsigned)(kFCtasPerSm * "
                "sms));") in self._body("run_f32(")
        assert "e += (long long)gridDim.x *" in self._body(
            "spmm_part_sum_f32(")
        assert "n > 0x7fffffffLL ? 0u" in self._body("inline unsigned "
                                                     "grid_1d(")

    def test_the_65535_checks_are_gone(self):
        assert "65535" not in self.SRC
        assert "N / 64 >" not in self.SRC
