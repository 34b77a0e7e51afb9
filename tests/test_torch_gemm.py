"""The port's GEMM dispatch and its four engines (marlin_tpu_torch's
DenseVecMatrix.multiply, BlockMatrix.multiply and parallel/summa.py)
against the JAX package, the twin of tests/test_gemm.py.

The port runs in 8 gloo rank processes on the CPU, started once for the
module (tests/torch_dist_worker.py, suite "gemm"), on a default mesh of
the JAX package's (4, 2) shape. Each test holds one case's values from
rank 0 to the JAX package's on the same seeded f64 inputs within 1e-10
(the engines sum in other orders), the result types to the JAX types,
and the random generators by distribution (torch's Philox and JAX's
threefry draw different streams).
"""


import json

import numpy as np
import pytest

import jax.numpy as jnp

import marlin_tpu as mt
from marlin_tpu import linalg as jlinalg
from marlin_tpu.matrix.block import BlockMatrix
from marlin_tpu.matrix.dense import DenseVecMatrix
from marlin_tpu.matrix.sparse import SparseVecMatrix
from marlin_tpu.matrix.vector import DistributedVector
from marlin_tpu.parallel import summa
from marlin_tpu.utils.split import grid_for_devices

import torch_dist_worker

INPUTS = torch_dist_worker.make_inputs()
F64 = dict(rtol=1e-10, atol=1e-10)  # f64: summation order only
A, B = INPUTS["a"], INPUTS["b"]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return torch_dist_worker.launch("gemm", 8, INPUTS,
                                    tmp_path_factory.mktemp("gemm"))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), **F64)


def same_product(got, want):
    assert got["type"] == type(want).__name__
    close(got["value"], want.to_numpy())


@pytest.mark.parametrize("arm", ["broadcast", "local_matrix",
                                 "left_broadcast", "split", "local_vector"])
def test_dense_dispatch_arms(port, arm):
    got = port.get("dense_arms")
    a, b = DenseVecMatrix(A), DenseVecMatrix(B)
    want = {"broadcast": lambda: a.multiply(b),
            "local_matrix": lambda: a.multiply(B),
            "left_broadcast": lambda: a.multiply(
                b, broadcast_threshold_mb=3500 / 1e6),
            "split": lambda: a.multiply(b, broadcast_threshold_mb=1e-9),
            "local_vector": lambda: a.multiply(INPUTS["x17"])}[arm]()
    same_product(got[arm], want)


def test_dimension_mismatch_raises(port):
    assert port.get("dense_arms")["mismatch"] == "ValueError"


def test_matvec(port):
    same_product(port.get("matvec"), DenseVecMatrix(A).multiply(
        DistributedVector(INPUTS["x1_17"])))


@pytest.mark.parametrize("shape", ["tall", "deep"])
def test_carma_branch_d(port, shape):
    # m >> k, n: a (8, 1, 1) grid, the 2-D engine; k >> m, n: the grid
    # splits k and the 3-D engine runs.
    got = port.get("carma_branches")
    want = DenseVecMatrix(INPUTS[f"{shape}_a"]).multiply(
        DenseVecMatrix(INPUTS[f"{shape}_b"]), broadcast_threshold_mb=1e-9)
    same_product(got[shape], want)
    assert tuple(got["deep_grid"]) == grid_for_devices(8, 640, 8, 8)


@pytest.mark.parametrize("engine", ["summa", "gspmd", "cannon"])
def test_split_engines(port, engine):
    # cannon on the non-square (4, 2) mesh gives way to summa, as in the
    # reference.
    same_product(port.get(f"split_engine_{engine}"),
                 DenseVecMatrix(A).multiply(DenseVecMatrix(B), mode=engine))


@pytest.mark.parametrize("grid", torch_dist_worker.MKN_GRIDS,
                         ids=lambda g: "x".join(map(str, g)))
def test_explicit_mkn_splits(port, grid):
    got = port.get("explicit_mkn_splits")["x".join(map(str, grid))]
    close(got, DenseVecMatrix(A).multiply(DenseVecMatrix(B),
                                          mode=grid).to_numpy())


def test_grid_fallback_is_loud_only_when_forced(port):
    from marlin_tpu.utils.timing import metrics

    got = port.get("grid_fallback")
    before = metrics.counters["gemm.grid_fallback"]
    with pytest.warns(UserWarning, match="2-D engine"):
        want = DenseVecMatrix(A).multiply(DenseVecMatrix(B), mode=(4, 4, 4))
    assert got["forced_delta"] == \
        metrics.counters["gemm.grid_fallback"] - before == 1
    close(got["value"], want.to_numpy())
    assert got["forced_warned"] and not got["auto_warned"]


def test_cannon_square_mesh(port):
    import jax
    import jax.numpy as jnp

    mesh = mt.create_mesh((2, 2), devices=jax.devices()[:4])
    want = summa.matmul(jnp.asarray(A), jnp.asarray(B), mesh=mesh,
                        engine="cannon")
    close(port.get("cannon_square_mesh")["value"], np.asarray(want))


@pytest.mark.parametrize("op", ["block_x_block", "regrid", "broadcast_b",
                                "local", "vector", "multiply_by",
                                "dense_x_block", "block_x_dense", "scalar",
                                "tuple"])
def test_block_multiply(port, op):
    got = port.get("block_multiply")[op]
    want = {
        "block_x_block": lambda: BlockMatrix(A).multiply(BlockMatrix(B),
                                                         mode="summa"),
        "regrid": lambda: BlockMatrix(A, blks_by_row=4, blks_by_col=2)
        .multiply(BlockMatrix(B, blks_by_row=3, blks_by_col=3),
                  mode="summa"),
        "broadcast_b": lambda: BlockMatrix(A).multiply(BlockMatrix(B)),
        "local": lambda: BlockMatrix(A).multiply(B),
        "vector": lambda: BlockMatrix(A).multiply(INPUTS["ones17"]),
        "multiply_by": lambda: BlockMatrix(B).multiply_by(A),
        "dense_x_block": lambda: DenseVecMatrix(A).multiply(
            BlockMatrix(B), mode="summa"),
        "block_x_dense": lambda: BlockMatrix(A).multiply(
            DenseVecMatrix(B), mode="summa"),
        "scalar": lambda: BlockMatrix(A).multiply(2.0),
        "tuple": lambda: BlockMatrix(A).multiply(BlockMatrix(B),
                                                 mode=(2, 2, 2)),
    }[op]()
    same_product(got, want)


def test_matmul_3d_uneven_shapes(port):
    want = summa.matmul_3d(INPUTS["u13x11"], INPUTS["u11x9"], (2, 2, 2))
    close(port.get("matmul_3d_uneven")["value"], np.asarray(want))


def test_gramian(port):
    got = port.get("gramian")
    m = DenseVecMatrix(A)
    close(got["g"], m.compute_gramian_matrix())
    close(got["gv"], m.multiply_gramian_matrix_by(INPUTS["v17"]))


def test_random_generation_by_distribution(port):
    # Same seed, same matrix (also on a mesh of 4 and as a block matrix);
    # moments within the bounds the JAX package's tests set for its own
    # generators, which the JAX package's draws meet too.
    from marlin_tpu.utils import random as mrand

    got = port.get("random_generation")
    assert got["same_seed"] and got["other_seed_differs"]
    assert got["mesh_of_4_same"] and got["block_same"]
    jn = mrand.random_den_vec_matrix(200, 100, distribution="normal",
                                     seed=1).to_numpy()
    for value, ref in ((got["normal_mean"], jn.mean()),):
        assert abs(value) < 0.05 and abs(ref) < 0.05
    assert abs(got["normal_std"] - 1.0) < 0.05
    assert 0 <= got["uniform_min"] and got["uniform_max"] <= 1
    assert got["zeros_sum"] == mrand.zeros_den_vec_matrix(8, 8).sum() == 0
    assert got["ones_sum"] == mrand.ones_den_vec_matrix(8, 8).sum() == 64
    assert abs(got["poisson_mean"] - 4.0) < 0.2
    assert got["vector_length"] == 100
    assert got["ones_vector_sum"] == 10
    assert 0.05 < got["sparse_density"] < 0.15
    assert got["dtype"] == "torch.float64"


@pytest.mark.parametrize("mode", [None, "summa", "gspmd", "broadcast"])
def test_parallelism_hint_on_every_dense_arm(port, mode):
    got = port.get("parallelism_hint")[f"dense_{mode}"]
    a = DenseVecMatrix(INPUTS["p48x40"])
    out = a.multiply(DenseVecMatrix(INPUTS["p40x32"]), parallelism=2,
                     mode=mode)
    assert got["mesh_size"] == len(out.data.sharding.device_set) == 2
    close(got["value"], out.to_numpy())


@pytest.mark.parametrize("arm", ["auto_small_threshold", "block", "capped"])
def test_parallelism_hint_other_arms(port, arm):
    got = port.get("parallelism_hint")[arm]
    if arm == "auto_small_threshold":
        out = DenseVecMatrix(INPUTS["p64a"]).multiply(
            DenseVecMatrix(INPUTS["p64b"]), parallelism=4,
            broadcast_threshold_mb=1e-9)
    elif arm == "block":
        out = BlockMatrix(INPUTS["p32x24"]).multiply(
            BlockMatrix(INPUTS["p24x16"]), parallelism=2,
            broadcast_threshold_mb=1e-9)
    else:
        out = DenseVecMatrix(INPUTS["p16x8"]).multiply(
            DenseVecMatrix(INPUTS["p8x8"]), parallelism=999)
    assert got["mesh_size"] == len(out.data.sharding.device_set)
    close(got["value"], out.to_numpy())


@pytest.mark.parametrize("engine", ["summa", "gspmd", "cannon"])
def test_axis_name_override(port, engine):
    # The same mesh under swapped axis names: the engines read the
    # config's names at each call.
    import jax
    import jax.numpy as jnp

    from marlin_tpu.config import config_override

    got = port.get("axis_name_override")
    mesh = mt.create_mesh((4, 2), axis_names=("x", "y"),
                          devices=jax.devices()[:8])
    b = jnp.asarray(INPUTS["ov12x10"])
    for names, a in ((("x", "y"), "ov8x12"), (("y", "x"), "ov6x12")):
        with config_override(mesh_axis_rows=names[0],
                             mesh_axis_cols=names[1]):
            want = summa.matmul(jnp.asarray(INPUTS[a]), b, mesh=mesh,
                                engine=engine)
        close(got[f"{engine}_{''.join(names)}"], np.asarray(want))


def test_bf16_engines_accumulate_in_f32(port):
    # Ones: the exact product k is what both packages return.
    got = port.get("bf16_accumulators")
    assert got["cannon"] == got["summa"] == got["3d"] == got["n"]


@pytest.mark.parametrize("what", ["summa", "auto", "split", "gspmd",
                                  "cannon"])
def test_asymmetric_2x3_submesh(port, what):
    # __graft_entry__.py's stretch check: an asymmetric 2 x 3 mesh of 6
    # of the 8 devices, odd stripe counts and uneven block grids (30 x 22
    # x 14 through summa; 26 x 18 x 10 through the auto-dispatch, the
    # split path and the other engines; cannon gives way to summa).
    import jax
    import jax.numpy as jnp

    got = port.get("asymmetric_submesh")
    mesh6 = mt.create_mesh(shape=(2, 3), devices=jax.devices()[:6])
    if what == "summa":
        want = np.asarray(summa.matmul(jnp.asarray(INPUTS["a6"]),
                                       jnp.asarray(INPUTS["b6"]),
                                       mesh=mesh6, engine="summa"))
    else:
        a = DenseVecMatrix(INPUTS["dm6"], mesh=mesh6)
        b = DenseVecMatrix(INPUTS["dm6b"], mesh=mesh6)
        kw = {"auto": {}, "split": {"broadcast_threshold_mb": 1e-9},
              "gspmd": {"mode": "gspmd"}, "cannon": {"mode": "cannon"}}[what]
        out = a.multiply(b, **kw)
        want = out.to_numpy()
        if what == "split":
            devs = list(mesh6.devices.flat)
            shapes = [None] * 8
            for s in out.data.addressable_shards:
                shapes[devs.index(s.device)] = list(s.data.shape)
            assert got["shapes"] == shapes
    close(got[what], want)


# Each arm's whole operands, none of which any rank may hold: "left
# broadcast" puts its small operand on every rank by design, so only the
# big one and the product count there.
WHOLE = {"summa": ("g64x48", "g48x56", (64, 56)),
         "cannon_square_submesh": ("g64x48", "g48x56", (64, 56)),
         "grid_2x2x2": ("g64x48", "g48x56", (64, 56)),
         "left_broadcast": ("g48x56", (4, 56)),
         "row_to_block": ("g64x48",), "block_to_row": ("g64x48",),
         "transpose": ("g64x48",), "block_transpose": ("g64x48",),
         # The dist-mode decompositions and solves (panels of 16): their
         # square operand, factor, inverse.
         "lu_dist": ("lin64",), "cholesky_dist": ("spd64",),
         "inverse_dist": ("lin64",), "solve_dist": ("lin64",),
         "solve_spd_dist": ("spd64",),
         # The engine GSPMD's plan stands for, and the structure ops and
         # products that move windows of shards: their operands and
         # results. A sparse operand is held by every rank by design
         # (its shapes are chosen so that it could hold no whole dense
         # one).
         "gspmd": ("g64x48", "g48x56", (64, 56)),
         "norm": ("g64x48",), "c_bind": ("g64x48", (64, 96)),
         "slice_by_row": ("g64x48", (36, 48)),
         "slice_by_column": ("g64x48", (64, 28)),
         "get_sub_matrix": ("g64x48", (36, 28)),
         "row_exchange": ("g64x48",), "get_block": ("g64x48",),
         "dense_x_sparse": ("g64x48", (64, 56)),
         "sparse_x_dense": ("g48x56", (40, 56)),
         # The outer product of a 64- and a 56-vector: neither vector nor
         # the product whole on a rank.
         "vector_to_tensor": ((64,), (56,), (64, 56))}


def holds_whole(shape, whole):
    """Whether a tensor of ``shape`` is large enough to hold a ``whole``
    matrix, either way round (or, flattened, as many elements), or a
    ``whole`` vector along one of its dims."""
    if len(whole) == 1:
        return max(shape, default=1) >= whole[0]
    if len(shape) == 2:
        return any(shape[0] >= r and shape[1] >= c
                   for r, c in (whole, whole[::-1]))
    return int(np.prod(shape)) >= int(np.prod(whole))


@pytest.mark.parametrize("arm", list(WHOLE))
def test_no_rank_holds_a_whole_operand(port, arm):
    # The engines and the re-layouts move shards, never a whole matrix: no
    # op on rank 0 makes a tensor that could hold any whole operand (and
    # the arm's value is the JAX package's all the same).
    got = port.get("no_rank_holds_a_whole_operand")[arm]
    wholes = [INPUTS[w].shape if isinstance(w, str) else w
              for w in WHOLE[arm]]
    assert got["shapes"]
    assert not [(s, w) for s in got["shapes"] for w in wholes
                if holds_whole(s, w)]
    a, b = INPUTS["g64x48"], INPUTS["g48x56"]
    jd, jb = DenseVecMatrix(a), BlockMatrix(a)
    sq, spd, rhs = INPUTS["lin64"], INPUTS["spd64"], INPUTS["rhs64"]

    def dist(fn):
        def run():
            with mt.config_override(lu_base_size=16, cholesky_base_size=16):
                return np.asarray(fn())
        return run

    grid = BlockMatrix(a, blks_by_row=2, blks_by_col=3)
    masked = np.where(np.abs(b) > 1.0, b, 0.0)
    masked_left = np.where(np.abs(a[:40]) > 1.0, a[:40], 0.0)
    col = DistributedVector(a[:, 0])
    row = DistributedVector(b[0], column_major=False)
    want = {"summa": lambda: jd.multiply(DenseVecMatrix(b), mode="summa"),
            "cannon_square_submesh": lambda: jd.multiply(
                DenseVecMatrix(b), mode="cannon", parallelism=4),
            "grid_2x2x2": lambda: jd.multiply(DenseVecMatrix(b),
                                              mode=(2, 2, 2)),
            "left_broadcast": lambda: DenseVecMatrix(
                INPUTS["g4x48"]).multiply(DenseVecMatrix(b)),
            "row_to_block": jd.to_block_matrix,
            "block_to_row": jb.to_dense_vec_matrix,
            "transpose": jd.transpose, "block_transpose": jb.transpose,
            "lu_dist": dist(lambda: jlinalg.lu_factor_array(
                jnp.asarray(sq), mode="dist")[0]),
            "cholesky_dist": dist(lambda: jlinalg.cholesky_factor_array(
                jnp.asarray(spd), mode="dist")),
            "inverse_dist": dist(lambda: jlinalg.inverse(
                jnp.asarray(sq), mode="dist")),
            "solve_dist": dist(lambda: jlinalg.solve(
                jnp.asarray(sq), jnp.asarray(rhs), mode="dist")),
            "solve_spd_dist": dist(lambda: jlinalg.solve(
                jnp.asarray(spd), jnp.asarray(rhs), mode="dist",
                assume_spd=True)),
            "gspmd": lambda: jd.multiply(DenseVecMatrix(b), mode="gspmd"),
            "norm": lambda: [jd.norm("1"), jd.norm("inf"), jb.norm("1"),
                             jb.norm("inf")],
            "c_bind": lambda: [jd.c_bind(jb), jb.c_bind(jd)],
            "slice_by_row": lambda: jd.slice_by_row(5, 40),
            "slice_by_column": lambda: jd.slice_by_column(3, 30),
            "get_sub_matrix": lambda: jd.get_sub_matrix(5, 40, 3, 30),
            "row_exchange": lambda: [jd.row_exchange(50, 3),
                                     jd.row_exchange(1, 6)],
            "get_block": lambda: np.asarray(grid.get_block(1, 2)),
            "dense_x_sparse": lambda: jd.multiply(
                SparseVecMatrix.from_dense_array(masked)),
            "sparse_x_dense": lambda: SparseVecMatrix.from_dense_array(
                masked_left).multiply(DenseVecMatrix(b)),
            "vector_to_tensor": lambda: col.multiply_vector(row)}
    out = want[arm]()
    close(got["value"], [x.to_numpy() for x in out]
          if isinstance(out, list) and hasattr(out[0], "to_numpy")
          else out if isinstance(out, (np.ndarray, list))
          else out.to_numpy())
    if arm == "vector_to_tensor":
        # The vectors' own export, whole by contract, is theirs too.
        close(got["to_tensor"][0], col.to_numpy())
        close(got["to_tensor"][1], row.to_numpy())


def test_rmm_compare_example(port, capsys):
    # The port's example on 8 ranks and the JAX package's on the 8
    # virtual devices: the same JSON keys and grid (a (4, 2) mesh: no
    # Cannon ring), each arm timed.
    from marlin_tpu.examples import rmm_compare

    got = port.get("rmm_compare")
    rmm_compare.main(["32", "32", "32"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got["line"]) == set(want) == {"example", "shape", "grid",
                                             "seconds"}
    assert got["line"]["example"] == want["example"] == "RMMcompare"
    assert got["line"]["shape"] == want["shape"] == [32, 32, 32]
    assert got["line"]["grid"] == want["grid"]
    assert set(got["line"]["seconds"]) == set(want["seconds"]) == set(
        got["arms"]) == {"rmm_3d_grid", "summa_allgather"}
    assert all(t > 0 for t in got["line"]["seconds"].values())
