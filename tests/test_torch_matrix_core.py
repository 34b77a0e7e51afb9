"""The port's distributed matrix and vector types (marlin_tpu_torch.matrix:
base, dense, block, vector) against the JAX package, the twin of
tests/test_matrix_core.py.

The port runs in 8 gloo rank processes on the CPU, started once for this
module and tests/test_torch_mesh.py together (tests/torch_dist_worker.py,
suite "core"), on a default
mesh of the same (4, 2) shape as the JAX package's 8-device CPU mesh
(tests/conftest.py). Each test holds one case's values from rank 0 to the
JAX package's on the same seeded inputs: f64 within 1e-10 (the two differ
only in summation order), bf16 sums exactly (both accumulate in >= f32),
and the ranks' local shard shapes equal to the JAX arrays'
addressable_shards.
"""

import numpy as np
import pytest

import marlin_tpu as mt
from marlin_tpu.matrix.block import BlockMatrix
from marlin_tpu.matrix.dense import DenseVecMatrix
from marlin_tpu.matrix.vector import DistributedVector

import torch_dist_worker

INPUTS = torch_dist_worker.make_inputs()
F64 = dict(rtol=1e-10, atol=1e-10)  # f64: summation order only


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return torch_dist_worker.shared_launch("core", 8, INPUTS,
                                           tmp_path_factory)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), **F64)


def jmake(kind, arr, **kw):
    if kind == "dvm":
        return DenseVecMatrix(arr, **kw)
    return BlockMatrix(arr, blks_by_row=2, blks_by_col=2, **kw)


A4, B4 = INPUTS["A4"], INPUTS["B4"]


def test_metadata(port):
    got = port.get("metadata")
    m = DenseVecMatrix(A4)
    assert (got["rows"], got["cols"], got["count"]) == (
        m.num_rows, m.num_cols, m.elements_count())
    close(got["from_rows"], DenseVecMatrix.from_rows(
        [(0, A4[0]), (2, A4[2]), (1, A4[1]), (3, A4[3])]).to_numpy())
    assert got["empty_matrix"] == got["empty_vector"] == "ValueError"


@pytest.mark.parametrize("kind", ["dvm", "blk"])
def test_elementwise_and_scalar_ops(port, kind):
    got = port.get(f"elementwise_{kind}")
    m = jmake(kind, A4)
    want = {"add": m.add(jmake(kind, B4)), "sub": m.subtract(jmake(kind, B4)),
            "add_s": m.add(2.5), "sub_s": m.subtract(1.5),
            "mul": m.multiply(3.0), "div": m.divide(2.0),
            "div_by": m.divide_by(2.0), "sub_by": m.subtract_by(10.0),
            "transpose": m.transpose()}
    for key, w in want.items():
        close(got[key], w.to_numpy())
    close(got["sum"], m.sum())


def test_element_multiply_and_shape_mismatch(port):
    got = port.get("element_multiply_and_mismatch")
    close(got["hadamard"],
          jmake("blk", A4).element_multiply(jmake("blk", B4)).to_numpy())
    assert got["mismatch"] == "ValueError"


def test_dot_product_all_pairings(port):
    got = port.get("dot_product_all_pairings")
    for x in ("dvm", "blk"):
        for y in ("dvm", "blk"):
            close(got[f"{x}_{y}"], jmake(x, A4).dot_product(jmake(y, B4)))


def test_norms(port):
    got = port.get("norms")
    m = DenseVecMatrix(A4)
    close(got["one"], m.norm("1"))
    close(got["inf"], m.norm("inf"))
    assert got["fro"] == "ValueError"


def test_structure(port):
    got = port.get("structure")
    m = DenseVecMatrix(A4)
    close(got["c_bind"], m.c_bind(DenseVecMatrix(B4)).to_numpy())
    close(got["rows_1_2"], m.slice_by_row(1, 2).to_numpy())
    close(got["cols_0_1"], m.slice_by_column(0, 1).to_numpy())
    close(got["sub"], m.get_sub_matrix(1, 3, 2, 3).to_numpy())
    close(got["exchange"], m.row_exchange(0, 3).to_numpy())
    assert got["c_bind_bad"] == got["slice_bad"] == got["exchange_bad"] \
        == "ValueError"


def test_block_grid_and_conversions(port):
    got = port.get("block_grid")
    m = BlockMatrix(INPUTS["A35"], blks_by_row=2, blks_by_col=3)
    t = m.transpose()
    assert got["t_grid"] == [t.blks_by_row, t.blks_by_col]
    close(got["t"], t.to_numpy())
    assert tuple(got["extent"]) == m.block_extent(1, 2)
    close(got["block"], np.asarray(m.get_block(1, 2)))
    rt = DenseVecMatrix(A4).to_block_matrix(2, 2)
    assert got["rt_type"] == type(rt).__name__
    assert got["rt_grid"] == [rt.blks_by_row, rt.blks_by_col]
    close(got["rt_back"], rt.to_dense_vec_matrix().to_numpy())
    rg = jmake("blk", A4).to_block_matrix(4, 1)
    assert got["rg_grid"] == [rg.blks_by_row, rg.blks_by_col]
    close(got["rg"], rg.to_numpy())


def test_vectors(port):
    got = port.get("vectors")
    v = DistributedVector(np.arange(10.0))
    assert got["length"] == v.length
    close(got["v"], v.to_numpy())
    a, b = DistributedVector(np.arange(6.0)), DistributedVector(np.ones(6))
    close(got["sub"], a.substract(b).to_numpy())
    assert got["orient"] == [a.column_major, a.transpose().column_major]
    x, y = np.arange(1.0, 5.0), np.arange(2.0, 6.0)
    col = DistributedVector(x, column_major=True)
    row = DistributedVector(y, column_major=False)
    outer = col.multiply_vector(row, mode="dist")
    assert got["outer_type"] == type(outer).__name__
    close(got["outer"], outer.to_numpy())
    close(got["outer_local"], col.multiply_vector(row, mode="local"))
    close(got["inner"], row.multiply_vector(col))
    assert got["same_orient"] == "ValueError"


def test_bf16_reductions_accumulate_in_f32(port):
    # bf16 ones: exact only with a wide accumulator, on both sides.
    import jax.numpy as jnp

    got = port.get("bf16_accumulators")
    a = DenseVecMatrix(jnp.ones((160, 256), jnp.bfloat16))
    v = DistributedVector(jnp.ones((4096,), jnp.bfloat16))
    assert got == {"sum": a.sum(), "dot": a.dot_product(a),
                   "one": a.norm("1"), "inf": a.norm("inf"),
                   "vdot": v.dot(v)}


def _jax_shard_shapes(arr, mesh):
    """Each device's shard shape of ``arr``, by the device's flat position
    in ``mesh``."""
    devs = list(mesh.devices.flat)
    out = [None] * len(devs)
    for s in arr.addressable_shards:
        out[devs.index(s.device)] = list(s.data.shape)
    return out


@pytest.mark.parametrize("mesh_key", ["default", "asym"])
@pytest.mark.parametrize("kind", ["dvm", "blk", "vec"])
def test_uneven_shards_match_the_jax_layouts(port, mesh_key, kind):
    # 30 x 22 and a length-37 vector on the (4, 2) mesh and on the
    # asymmetric 2 x 3 mesh of __graft_entry__.py: the same padding, so
    # each rank's local shard has the shape of the JAX array's shard on
    # the device at the same mesh position (ranks outside the 2 x 3 mesh
    # hold nothing), and the values agree.
    import jax

    got = port.get("uneven_shards")
    mesh = (mt.default_mesh() if mesh_key == "default"
            else mt.create_mesh((2, 3), devices=jax.devices()[:6]))
    make = {"dvm": DenseVecMatrix, "blk": BlockMatrix,
            "vec": DistributedVector}[kind]
    arr = INPUTS["U37"] if kind == "vec" else INPUTS["U30x22"]
    m = make(arr, mesh=mesh)
    want = _jax_shard_shapes(m.data, mesh)
    shapes = got[f"{mesh_key}_{kind}_shapes"]
    assert shapes[:len(want)] == want
    assert all(s is None for s in shapes[len(want):])
    close(got[f"{mesh_key}_{kind}"], m.to_numpy())
