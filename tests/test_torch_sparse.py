"""The port's sparse matrix types (marlin_tpu_torch/matrix/sparse) against
the JAX package's on shared numpy inputs: the single-device twins of
tests/test_sparse.py's CoordinateMatrix and SparseVecMatrix tests,
``to_block_sparse`` against the JAX one, each method that waits for the
distributed sparse ring (A4b) raising with its item named, and the
methods that take a mesh or a DenseVecMatrix against the JAX package's,
run in 2 gloo rank processes started once for the module
(tests/torch_dist_worker.py, suite "sparse_dense"). Values are compared
exactly where both sides only move and add the same numbers, and the
sparse x dense product within f32 rounding (1e-6).
"""

import numpy as np
import pytest
import torch

from marlin_tpu.matrix.sparse import CoordinateMatrix as JaxCoordinateMatrix
from marlin_tpu.matrix.sparse import SparseVecMatrix as JaxSparseVecMatrix
from marlin_tpu_torch import config as pconfig
from marlin_tpu_torch.matrix import (CoordinateMatrix, MatrixEntry,
                                     SparseVecMatrix)
from marlin_tpu_torch.ops import block_sparse_matmul

import torch_dist_worker

# Golden 4x4 sparse fixtures of tests/test_sparse.py.
S1 = np.array([[1.0, 0.0, 0.0, 2.0],
               [0.0, 3.0, 0.0, 0.0],
               [0.0, 0.0, 0.0, 0.0],
               [4.0, 0.0, 5.0, 0.0]], np.float32)
S2 = np.array([[0.0, 1.0, 0.0, 0.0],
               [2.0, 0.0, 0.0, 3.0],
               [0.0, 0.0, 4.0, 0.0],
               [5.0, 0.0, 0.0, 6.0]], np.float32)


def _random_sparse(rng, rows, cols, density=0.2):
    arr = rng.standard_normal((rows, cols)).astype(np.float32)
    return arr * (rng.random((rows, cols)) < density)


class TestCoordinateMatrix:
    def test_compute_size_by_max_index(self):
        args = ([0, 3, 1], [2, 0, 5], [1.0, 2.0, 3.0])
        cm = CoordinateMatrix(*args, device="cpu")
        assert cm.shape == (4, 6)  # max index + 1
        assert cm.shape == JaxCoordinateMatrix(*args).shape
        assert (cm.num_rows, cm.num_cols, cm.nnz) == (4, 6, 3)
        assert CoordinateMatrix(*args, shape=(9, 9),
                                device="cpu").shape == (9, 9)

    def test_entries_and_dense(self):
        args = ([0, 1], [1, 0], [2.5, 3.5])
        cm = CoordinateMatrix(*args, device="cpu")
        es = cm.entries()
        assert isinstance(es[0], MatrixEntry)
        assert (es[0].i, es[0].j, es[0].value) == (0, 1, 2.5)
        assert tuple(es[1]) == (1, 0, 3.5)
        np.testing.assert_array_equal(cm.to_numpy(), [[0, 2.5], [3.5, 0]])
        np.testing.assert_array_equal(cm.to_numpy(),
                                      JaxCoordinateMatrix(*args).to_numpy())
        assert repr(cm) == repr(JaxCoordinateMatrix(*args))

    def test_conversion_chain(self):
        args = ([0, 1, 1], [0, 0, 1], [1.0, 2.0, 3.0])
        cm = CoordinateMatrix(*args, device="cpu")
        sp = cm.to_sparse_vec_matrix()
        assert isinstance(sp, SparseVecMatrix)
        np.testing.assert_array_equal(sp.to_numpy(), cm.to_numpy())
        ref = JaxCoordinateMatrix(*args).to_sparse_vec_matrix()
        np.testing.assert_array_equal(sp.to_numpy(), ref.to_numpy())
        assert (sp.shape, sp.nnz) == (tuple(ref.shape), ref.nnz)

    def test_duplicate_indices_add(self, rng):
        rows, cols = rng.integers(0, 6, 40), rng.integers(0, 5, 40)
        vals = rng.standard_normal(40).astype(np.float32)
        cm = CoordinateMatrix(rows, cols, vals, shape=(6, 5), device="cpu")
        ref = JaxCoordinateMatrix(rows, cols, vals, shape=(6, 5))
        np.testing.assert_allclose(cm.to_numpy(), ref.to_numpy(), rtol=1e-6,
                                   atol=1e-6)  # order of the f32 adds
        np.testing.assert_allclose(cm.to_sparse_vec_matrix().to_numpy(),
                                   ref.to_numpy(), rtol=1e-6, atol=1e-6)
        coo = cm.to_sparse_coo()
        assert coo.layout == torch.sparse_coo and coo._nnz() == 40

    def test_padded_triples_are_compacted(self):
        args = ([0, 2, 0, 0], [1, 3, 0, 0], [1.5, 2.5, 0.0, 0.0])
        cm = CoordinateMatrix(*args, shape=(3, 4), padded=True,
                              device="cpu")
        ref = JaxCoordinateMatrix(*args, shape=(3, 4), padded=True)
        assert cm.nnz == ref.nnz == 2
        for got, want in zip(cm.compact_triples(), ref.compact_triples()):
            np.testing.assert_array_equal(got, want)
        assert len(cm.entries()) == 2
        assert cm.to_sparse_coo()._nnz() == ref.to_bcoo().nse == 2
        np.testing.assert_array_equal(cm.to_numpy(), ref.to_numpy())

    def test_length_mismatch_raises(self):
        with pytest.raises(ValueError, match="equal lengths"):
            CoordinateMatrix([0, 1], [0], [1.0, 2.0], device="cpu")

    def test_index_dtype_follows_the_x64_switch(self):
        assert CoordinateMatrix([0], [0], [1.0],
                                device="cpu").row_idx.dtype == torch.int32
        old = pconfig.get_config().default_dtype
        try:
            pconfig.enable_x64()
            assert CoordinateMatrix(
                [0], [0], [1.0], device="cpu").col_idx.dtype == torch.int64
        finally:
            pconfig._x64 = False
            pconfig.set_config(default_dtype=old)


class TestSparseVecMatrix:
    @pytest.mark.parametrize("arr", [S1, S2], ids=["S1", "S2"])
    def test_from_dense_array_golden(self, arr):
        sp = SparseVecMatrix.from_dense_array(arr, device="cpu")
        ref = JaxSparseVecMatrix.from_dense_array(arr)
        assert sp.nnz == ref.nnz == np.count_nonzero(arr)
        assert sp.shape == tuple(ref.shape) == (4, 4)
        assert (sp.num_rows, sp.num_cols) == (4, 4)
        assert sp.dtype == torch.float32
        np.testing.assert_array_equal(sp.to_numpy(), arr)
        np.testing.assert_array_equal(sp.to_numpy(), ref.to_numpy())
        assert repr(sp) == repr(ref)

    def test_from_coo_matches_the_jax_package(self, rng):
        arr = _random_sparse(rng, 30, 20)
        r, c = np.nonzero(arr)
        sp = SparseVecMatrix.from_coo(r, c, arr[r, c], arr.shape,
                                      device="cpu")
        ref = JaxSparseVecMatrix.from_coo(r, c, arr[r, c], arr.shape)
        assert sp.nnz == ref.nnz == r.size
        np.testing.assert_array_equal(sp.to_numpy(), ref.to_numpy())
        assert sp.coo.layout == torch.sparse_coo

    def test_from_coo_refuses_an_index_out_of_range(self):
        with pytest.raises(RuntimeError, match="size is inconsistent"):
            SparseVecMatrix.from_coo([0, 5], [1, 0], [2.5, 3.5], (2, 2),
                                     device="cpu")

    def test_a_tensor_stays_on_its_device(self):
        sp = SparseVecMatrix.from_dense_array(torch.from_numpy(S1))
        assert sp.device.type == "cpu" and sp.nnz == 5

    def test_bfloat16_values_come_back_as_float32_on_the_host(self):
        sp = SparseVecMatrix.from_dense_array(
            torch.from_numpy(S1).to(torch.bfloat16))
        assert sp.dtype == torch.bfloat16
        np.testing.assert_array_equal(sp.to_numpy(), S1)

    @pytest.mark.parametrize("block_size", [4, 8, 16])
    def test_to_block_sparse_matches_the_jax_package(self, rng, block_size):
        arr = _random_sparse(rng, 30, 20, density=0.05)
        arr[8:16] = 0  # some empty blocks at every block size
        b = SparseVecMatrix.from_dense_array(arr, device="cpu") \
            .to_block_sparse(block_size)
        ref = JaxSparseVecMatrix.from_dense_array(arr) \
            .to_block_sparse(block_size)
        assert b.block_size == ref.block_size == block_size
        assert b.shape == tuple(ref.shape)  # padded up to the block size
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(ref.mask))
        np.testing.assert_array_equal(b.data.numpy(), np.asarray(ref.data))

    def test_to_block_sparse_default_block_size(self):
        b = SparseVecMatrix.from_dense_array(S1, device="cpu") \
            .to_block_sparse()
        assert b.block_size == 128 and b.shape == (128, 128)
        assert b.mask.numpy().tolist() == [[1]]

    def test_coo_to_block_sparse_to_product(self, rng):
        # The slice as a whole: COO triples -> SparseVecMatrix ->
        # BlockSparse -> block_sparse_matmul, against the dense product.
        arr = _random_sparse(rng, 32, 24, density=0.1)
        arr[:, 8:16] = 0
        r, c = np.nonzero(arr)
        b = SparseVecMatrix.from_coo(r, c, arr[r, c], arr.shape,
                                     device="cpu").to_block_sparse(8)
        a = rng.standard_normal((10, 32)).astype(np.float32)
        out = block_sparse_matmul(torch.from_numpy(a), b)
        np.testing.assert_allclose(out.numpy(), a @ arr, rtol=1e-4,
                                   atol=1e-4)
        assert not out.numpy()[:, 8:16].any()

    def test_constructor_contracts(self):
        with pytest.raises(ValueError, match="sparse COO"):
            SparseVecMatrix(torch.ones((2, 2)))
        with pytest.raises(ValueError, match="2-D"):
            SparseVecMatrix(torch.ones((2, 2, 2)).to_sparse())


SPARSE_DENSE_CASES = ["multiply_by_dense", "sparse_to_dense_vec_matrix",
                      "from_dense", "coo_to_dense_vec_matrix",
                      "from_dense_array_mesh", "from_coo_mesh",
                      "coordinate_matrix_mesh", "to_sparse_vec_matrix_mesh"]
D45 = np.random.default_rng(11).standard_normal((4, 5)).astype(np.float32)


def _jax_cm():
    return JaxCoordinateMatrix(np.array([0, 1]), np.array([1, 0]),
                               np.array([2.5, 3.5], np.float32))


def _jax_dense(arr):
    from marlin_tpu.matrix.dense import DenseVecMatrix as JaxDenseVecMatrix

    return JaxDenseVecMatrix(arr)


SPARSE_DENSE_REFERENCE = {
    "multiply_by_dense": lambda: JaxSparseVecMatrix.from_dense_array(
        S1).multiply(_jax_dense(D45)),
    "sparse_to_dense_vec_matrix": lambda: JaxSparseVecMatrix
    .from_dense_array(S1).to_dense_vec_matrix(),
    "from_dense": lambda: JaxSparseVecMatrix.from_dense(_jax_dense(S1)),
    "coo_to_dense_vec_matrix": lambda: _jax_cm().to_dense_vec_matrix(),
    "from_dense_array_mesh": lambda: JaxSparseVecMatrix.from_dense_array(S1),
    "from_coo_mesh": lambda: JaxSparseVecMatrix.from_coo(
        np.array([0, 1]), np.array([1, 0]), np.array([2.5, 3.5],
                                                     np.float32), (2, 3)),
    "coordinate_matrix_mesh": lambda: JaxCoordinateMatrix(
        np.array([0, 2]), np.array([1, 0]),
        np.array([2.5, 3.5], np.float32)).to_dense_vec_matrix(),
    "to_sparse_vec_matrix_mesh": lambda: _jax_cm().to_sparse_vec_matrix(),
}


@pytest.fixture(scope="module")
def dense_port(tmp_path_factory):
    # One launch a session, shared with test_torch_dense_examples.py.
    inputs = torch_dist_worker.sparse_dense_inputs()
    assert (inputs["S1"] == S1).all() and (inputs["D43"] == D45).all()
    return torch_dist_worker.shared_launch("sparse_dense", 2, inputs,
                                           tmp_path_factory)


class TestDeferred:
    """What needs the distributed sparse ring raises, naming the ROADMAP
    item that ports it; what needed only the mesh works."""

    @pytest.fixture
    def sp(self):
        return SparseVecMatrix.from_dense_array(S1, device="cpu")

    @pytest.fixture
    def cm(self):
        return CoordinateMatrix([0, 1], [1, 0], [2.5, 3.5], device="cpu")

    @pytest.mark.parametrize("call", [
        lambda sp, cm: sp.multiply_sparse(sp),
        lambda sp, cm: sp.multiply(sp),
        lambda sp, cm: sp.distribute(),
        lambda sp, cm: cm.to_dist_sparse(),
        lambda sp, cm: cm.als(rank=2),
    ], ids=["multiply_sparse", "multiply_by_sparse", "distribute",
            "to_dist_sparse", "als"])
    def test_the_ring_and_als_wait_for_a4b(self, sp, cm, call):
        with pytest.raises(NotImplementedError, match="item A4b"):
            call(sp, cm)

    @pytest.mark.parametrize("call", [
        getattr(torch_dist_worker, name) for name in SPARSE_DENSE_CASES],
        ids=SPARSE_DENSE_CASES)
    def test_the_mesh_and_dense_types_wait_for_a2(self, sp, cm, call,
                                                  dense_port):
        # ROADMAP A2a lifted these refusals: a mesh places the sparse data
        # on its device, and DenseVecMatrix operands and results work. The
        # call of each id runs in the rank processes (it needs a mesh);
        # here it is held to the JAX package's value.
        name = call.__name__
        got = dense_port.get(name)
        want = SPARSE_DENSE_REFERENCE[name]()
        np.testing.assert_allclose(np.asarray(got["value"]),
                                   want.to_numpy(), rtol=1e-6, atol=1e-6)
        if "type" in got:
            assert got["type"] == type(want).__name__ == "DenseVecMatrix"
        if "device" in got:
            assert got["device"] == "cpu"
        if "mesh_size" in got:
            assert got["mesh_size"] == 2
        if "dense" in got:
            np.testing.assert_array_equal(np.asarray(got["dense"]),
                                          want.to_numpy())


class TestNoSilentCpuFallback:
    @pytest.fixture(autouse=True)
    def _no_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("CUDA is present: the default device is valid here")

    def test_constructors_default_to_cuda_and_raise(self):
        with pytest.raises(RuntimeError, match="CUDA"):
            CoordinateMatrix([0], [0], [1.0])
        with pytest.raises(RuntimeError, match="CUDA"):
            SparseVecMatrix.from_dense_array(S1)
        with pytest.raises(RuntimeError, match="CUDA"):
            SparseVecMatrix.from_coo([0], [0], [1.0], (1, 1))
