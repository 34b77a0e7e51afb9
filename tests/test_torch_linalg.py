"""The port's linear algebra (marlin_tpu_torch/linalg and the dense types'
lu_decompose, cholesky_decompose, compute_svd, lr and inverse) against the
JAX package's, the twin of tests/test_linalg.py class for class.

The same seeded numpy inputs go through ``marlin_tpu`` (JAX on the CPU)
and through the port on the CPU. The port's distributed cases run in 8
gloo rank processes, started once for the module (tests/torch_dist_worker
.py, suite "linalg"), on a default mesh of the JAX package's (4, 2) shape;
its tensor entry points (one process, no communication) run here.
Tolerances, stated per test: 1e-10 at f64 (the two differ in summation
order and panel blocking only) and, where f32 is the point, the graft
check's 5e-4 or about 1e-5. Pivot sequences are held equal where the JAX
test holds LAPACK's pivots.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import marlin_tpu as mt
from marlin_tpu import linalg as jl
from marlin_tpu.matrix.block import BlockMatrix as JBlock
from marlin_tpu.matrix.dense import DenseVecMatrix as JDense
from marlin_tpu_torch import config as pconfig
from marlin_tpu_torch import linalg as pl
from marlin_tpu_torch.linalg import lanczos as planczos

import torch_dist_worker

INPUTS = torch_dist_worker.make_inputs()
F64 = dict(rtol=1e-10, atol=1e-10)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return torch_dist_worker.launch("linalg", 8, INPUTS,
                                    tmp_path_factory.mktemp("linalg"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One intra-op thread: these tests run beside wall-clock-timed tests
    # in the parallel suite, and their shapes are too small to need more.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def rng(request):
    import zlib

    return np.random.default_rng(zlib.crc32(request.node.name.encode()))


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **(tol or F64))


def jax_lu(a, mode="dist", base=None):
    with mt.config_override(lu_base_size=base or 1000):
        packed, perm = jl.lu_factor_array(jnp.asarray(a), mode=mode)
    return np.asarray(packed), np.asarray(perm)


def port_lu(a, mode="dist", base=None):
    with pconfig.config_override(lu_base_size=base or 1000):
        packed, perm = pl.lu_factor_array(T(a), mode=mode)
    return packed.numpy(), perm


def same_lu(got_packed, got_perm, a, want, tol=F64):
    """A[perm] = L U, and the packed factor and the pivots the JAX
    package's."""
    l, u = pl.unpack_lu(np.asarray(got_packed))
    close(l @ u, a[np.asarray(got_perm)], **tol)
    assert sorted(np.asarray(got_perm).tolist()) == list(range(a.shape[0]))
    assert np.array_equal(np.asarray(got_perm), want[1])
    close(got_packed, want[0], **tol)


@pytest.fixture()
def spd(rng):
    a = rng.standard_normal((24, 24))
    return a @ a.T + 24 * np.eye(24)


class TestLU:
    @pytest.mark.parametrize("mode,base", [("local", None), ("dist", 7),
                                           ("dist", 8)])
    def test_factorization(self, port, mode, base):
        got = port.get("lu_modes")[f"{mode}_{base}"]
        a = INPUTS["lu20"]
        assert got["type"] == "BlockMatrix"
        same_lu(got["packed"], got["perm"], a, jax_lu(a, mode, base))

    @pytest.mark.parametrize("mode,base", [("local", None), ("dist", 7),
                                           ("dist", 8)])
    def test_tensor_factorization(self, rng, mode, base):
        a = rng.standard_normal((20, 20))
        same_lu(*port_lu(a, mode, base), a, jax_lu(a, mode, base))

    def test_api_contract(self, port):
        got = port.get("lu_modes")["breeze"]
        a = INPUTS["lu12"]
        assert got["type"] == "BlockMatrix"
        same_lu(got["packed"], got["perm"], a,
                jax_lu(a, "local"))

    def test_non_square_raises(self, port, rng):
        assert port.get("lu_modes")["non_square"] == "ValueError"
        with pytest.raises(ValueError):
            pl.lu_factor_array(T(rng.standard_normal((4, 5))))

    def test_bad_mode(self, port, rng):
        assert port.get("lu_modes")["bad_mode"] == "ValueError"
        with pytest.raises(ValueError):
            pl.lu_factor_array(T(rng.standard_normal((4, 4))), mode="gpu")

    def test_singular_leading_block_falls_back(self, rng):
        # A nonsingular matrix whose leading base x base block is
        # singular: the panel's pivot search spans every row below the
        # diagonal, so nothing divides by the zero pivot.
        n, b = 16, 4
        a = np.zeros((n, n))
        a[: n // 2, n // 2:] = np.eye(n // 2)
        a[n // 2:, : n // 2] = np.eye(n // 2)
        a += 0.01 * rng.standard_normal((n, n))
        a[:, 0] = 0.0
        a[n - 1, 0] = 1.0
        packed, perm = port_lu(a, "dist", b)
        assert np.all(np.isfinite(packed))
        l, u = pl.unpack_lu(packed)
        close(l @ u, a[perm], rtol=1e-9, atol=1e-9)
        same_lu(packed, perm, a, jax_lu(a, "dist", b), dict(rtol=1e-9,
                                                            atol=1e-9))

    def test_near_singular_leading_block_falls_back(self, rng):
        n, b = 16, 4
        a = rng.standard_normal((n, n))
        a[:b, :b] *= 1e-7
        packed, perm = port_lu(a, "dist", b)
        l, u = pl.unpack_lu(packed)
        close(l @ u, a[perm], rtol=1e-8, atol=1e-8)
        assert np.array_equal(perm, jax_lu(a, "dist", b)[1])

    def test_pivoting_needed(self):
        a = np.array([[0.0, 1.0], [1.0, 0.0]])
        packed, perm = port_lu(a, "local")
        l, u = pl.unpack_lu(packed)
        close(l @ u, a[perm])
        assert np.array_equal(perm, jax_lu(a, "local")[1])


class TestCholesky:
    @pytest.mark.parametrize("mode", ["local", "dist"])
    def test_factorization(self, port, mode):
        got = port.get("cholesky_modes")[mode]
        a = INPUTS["spd24"]
        assert got["type"] == "BlockMatrix"
        ln = np.asarray(got["value"])
        close(ln, np.tril(ln))
        close(ln @ ln.T, a, rtol=1e-10, atol=1e-8)
        with mt.config_override(cholesky_base_size=7):
            want = JDense(a).cholesky_decompose(mode=mode).to_numpy()
        close(ln, want)

    @pytest.mark.parametrize("mode,base", [("local", None), ("dist", 7),
                                           ("dist", 5)])
    def test_tensor_factorization(self, spd, mode, base):
        with pconfig.config_override(cholesky_base_size=base or 1000):
            ln = pl.cholesky_factor_array(T(spd), mode=mode).numpy()
        close(ln, np.tril(ln))
        close(ln @ ln.T, spd, rtol=1e-10, atol=1e-8)
        close(ln, np.linalg.cholesky(spd))


class TestInverse:
    def test_permutation_matrix(self, port):
        p = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
        close(port.get("inverses")["permutation"], p.T, atol=1e-12)

    @pytest.mark.parametrize("mode", ["local", "dist"])
    def test_random(self, port, mode):
        got = port.get("inverses")[mode]
        a = INPUTS["inv18"]
        assert got["type"] == "BlockMatrix"
        close(np.asarray(got["value"]) @ a, np.eye(18), atol=1e-8)
        with mt.config_override(lu_base_size=5):
            want = JDense(a).inverse(mode=mode).to_numpy()
        close(got["value"], want)

    def test_block_matrix_inverse(self, port):
        a = INPUTS["inv10"]
        got = port.get("inverses")["block"]
        close(np.asarray(got) @ a, np.eye(10), atol=1e-8)
        close(got, JBlock(a).inverse().to_numpy())

    @pytest.mark.parametrize("mode", ["local", "dist"])
    def test_tensor_inverse(self, rng, mode):
        a = rng.standard_normal((18, 18)) + 18 * np.eye(18)
        with pconfig.config_override(lu_base_size=5):
            inv = pl.inverse(T(a), mode=mode).numpy()
        close(inv @ a, np.eye(18), atol=1e-8)
        with mt.config_override(lu_base_size=5):
            close(inv, np.asarray(jl.inverse(jnp.asarray(a), mode=mode)))


class TestLanczos:
    def _same_as_jax(self, fn, n, k, **kw):
        evals, evecs = planczos.symmetric_eigs(fn, n, k, **kw)
        want, _ = jl.symmetric_eigs(fn, n, k, **kw)
        close(evals, want, rtol=1e-10, atol=1e-10)
        return evals, evecs

    def test_top_k_eigs(self, rng):
        n, k = 60, 5
        a = rng.standard_normal((n, n))
        g = a @ a.T
        evals, evecs = self._same_as_jax(lambda x: g @ x, n, k)
        expected = np.sort(np.linalg.eigvalsh(g))[::-1][:k]
        close(evals, expected, rtol=1e-8)
        for i in range(k):
            r = g @ evecs[:, i] - evals[i] * evecs[:, i]
            assert np.linalg.norm(r) < 1e-6 * max(1.0, evals[i])

    def test_k_bounds(self):
        with pytest.raises(ValueError):
            planczos.symmetric_eigs(lambda x: x, 10, 10)

    def test_identity_deflation_restart(self):
        n, k = 8, 3
        evals, evecs = self._same_as_jax(lambda v: v, n, k)
        close(evals, np.ones(k), atol=1e-10)
        close(evecs.T @ evecs, np.eye(k), atol=1e-8)

    def test_low_rank_deflation(self, rng):
        n, k = 12, 4
        u = np.linalg.qr(rng.standard_normal((n, 2)))[0]
        g = u @ np.diag([7.0, 3.0]) @ u.T
        evals, evecs = self._same_as_jax(lambda v: g @ v, n, k)
        close(evals, [7.0, 3.0, 0.0, 0.0], atol=1e-8)
        close(evecs.T @ evecs, np.eye(k), atol=1e-8)

    def test_repeated_top_eigenvalue_multiplicity(self):
        g = np.diag([10.0, 10.0, 5.0])
        evals, evecs = self._same_as_jax(lambda v: g @ v, 3, 2)
        close(evals, [10.0, 10.0], atol=1e-8)
        close(evecs.T @ evecs, np.eye(2), atol=1e-8)

    def test_equal_eigenvalue_projector(self, rng):
        q = np.linalg.qr(rng.standard_normal((10, 2)))[0]
        g = q @ q.T
        evals, _ = self._same_as_jax(lambda v: g @ v, 10, 2)
        close(evals, [1.0, 1.0], atol=1e-8)

    def test_repeated_top_with_larger_multiplicity(self):
        g = np.diag([10.0, 10.0, 10.0, 5.0, 1.0])
        evals, _ = self._same_as_jax(lambda v: g @ v, 5, 3)
        close(evals, [10.0, 10.0, 10.0], atol=1e-8)

    def test_clustered_eigenvalues(self, rng):
        n, k = 50, 3
        d = np.concatenate([[5.0, 5.0 - 1e-9, 5.0 - 2e-9],
                            rng.uniform(0, 1, n - 3)])
        q = np.linalg.qr(rng.standard_normal((n, n)))[0]
        g = q @ np.diag(d) @ q.T
        evals, evecs = self._same_as_jax(lambda v: g @ v, n, k, tol=1e-12)
        close(evals, d[:3], rtol=1e-8)
        close(evecs.T @ evecs, np.eye(k), atol=1e-6)


def _best_rank_k(a, k):
    u, s, vt = np.linalg.svd(a, full_matrices=False)
    return u[:, :k] @ np.diag(s[:k]) @ vt[:k]


class TestSVD:
    @pytest.mark.parametrize("mode", ["local-svd", "local-eigs",
                                      "dist-eigs"])
    def test_modes_match_numpy(self, port, mode):
        got = port.get("svds")[mode]
        a, k = INPUTS["svd40x12"], 4
        assert got["u_type"] == "DenseVecMatrix"
        s = np.asarray(got["s"])
        close(s, np.linalg.svd(a, compute_uv=False)[:k], rtol=1e-8)
        approx = np.asarray(got["u"]) @ np.diag(s) @ np.asarray(got["v"]).T
        close(approx, _best_rank_k(a, k), atol=1e-6)
        want = JDense(a).compute_svd(k, compute_u=True, mode=mode)
        close(s, want.s)
        close(approx, want.u.to_numpy() @ np.diag(want.s) @ want.v.T,
              atol=1e-9)

    def test_no_u(self, port):
        got = port.get("svds")["no_u"]
        assert got["u"] is None and got["s_shape"] == [3]
        assert got["v_shape"] == [12, 3]

    def test_rcond_cutoff(self, port):
        assert port.get("svds")["rcond"] == [2]

    def test_auto_mode_small(self, port):
        close(port.get("svds")["auto"],
              np.linalg.svd(INPUTS["svd40x12"], compute_uv=False)[:2],
              rtol=1e-8)


class _CountingMat:
    """Minimal ``compute_svd`` operand with per-arm call counters (the
    JAX test's): a host Gramian behind both the local
    (``compute_gramian_matrix``) and distributed
    (``multiply_gramian_matrix_by``) interfaces."""

    def __init__(self, n=200, seed=0):
        rng = np.random.default_rng(seed)
        b = rng.standard_normal((2 * n, n))
        self._g = b.T @ b
        self.num_cols = n
        self.gramian_calls = 0
        self.dist_matvecs = 0

    def compute_gramian_matrix(self):
        self.gramian_calls += 1
        return self._g

    def multiply_gramian_matrix_by(self, x):
        self.dist_matvecs += 1
        return self._g @ x


class TestSVDAutoModeConstant:
    def test_default_constant_keeps_small_n_local(self):
        m = _CountingMat()
        s = pl.compute_svd(m, 4, compute_u=False, tol=1e-8).s
        assert m.gramian_calls == 1 and m.dist_matvecs == 0
        close(s, np.sqrt(np.linalg.eigvalsh(m._g)[::-1][:4]), rtol=1e-6)
        close(s, jl.compute_svd(_CountingMat(), 4, compute_u=False,
                                tol=1e-8).s)

    def test_override_routes_to_dist_eigs(self):
        m = _CountingMat()
        with pconfig.config_override(svd_local_eigs_max=100):
            s = pl.compute_svd(m, 4, compute_u=False, tol=1e-8).s
        assert m.gramian_calls == 0 and m.dist_matvecs > 0
        close(s, np.sqrt(np.linalg.eigvalsh(m._g)[::-1][:4]), rtol=1e-6)

    def test_boundary_is_inclusive(self):
        m = _CountingMat()
        with pconfig.config_override(svd_local_eigs_max=m.num_cols):
            pl.compute_svd(m, 4, compute_u=False, tol=1e-8)
        assert m.gramian_calls == 1 and m.dist_matvecs == 0


class TestDeviceSweep:
    """The device sweep (chunks of steps on the operator's device, here
    the CPU) against the host sweep, and against the JAX package's device
    sweep."""

    def _f64(self):
        return pconfig.config_override(default_dtype=torch.float64)

    def test_matches_host_sweep(self, rng):
        n, k = 60, 5
        g = rng.standard_normal((n, n))
        g = g @ g.T
        gt = T(g)
        host = planczos.symmetric_eigs(lambda v: g @ v, n, k)
        with self._f64():
            dev = planczos.symmetric_eigs(lambda v: g @ v, n, k,
                                          matvec_device=lambda v: gt @ v,
                                          device="cpu")
        close(dev[0], host[0], rtol=1e-9, atol=0)
        for i in range(k):
            d = min(np.linalg.norm(dev[1][:, i] - host[1][:, i]),
                    np.linalg.norm(dev[1][:, i] + host[1][:, i]))
            assert d < 1e-6
        want = jl.symmetric_eigs(lambda v: g @ v, n, k,
                                 matvec_jax=lambda v: jnp.asarray(g) @ v)
        close(dev[0], want[0], rtol=1e-9, atol=0)

    def test_exact_breakdown_identity(self):
        with self._f64():
            evals, evecs = planczos.symmetric_eigs(
                lambda v: v, 16, 3, matvec_device=lambda v: v, device="cpu")
        close(evals, np.ones(3), rtol=1e-10)
        close(evecs.T @ evecs, np.eye(3), atol=1e-8)

    def test_repeated_top_eigenvalue(self):
        d = np.array([10.0, 10.0, 5.0, 2.0, 1.0, 0.5, 0.25, 0.1])
        g, gt = np.diag(d), T(np.diag(d))
        with self._f64():
            evals, _ = planczos.symmetric_eigs(
                lambda v: g @ v, len(d), 2, matvec_device=lambda v: gt @ v,
                device="cpu")
        close(evals, [10.0, 10.0], rtol=1e-8)

    def test_f32_operator_sweeps_in_f32(self, rng):
        # A protocol operator's operand sets the sweep's dtype and device.
        g = rng.standard_normal((30, 30))
        g = (g @ g.T).astype(np.float32)
        op = _Operator(T(g))
        assert planczos._sweep_dtype_device(op, None) == (
            torch.float32, torch.device("cpu"))
        evals, _ = planczos.symmetric_eigs(lambda v: g @ v, 30, 3,
                                           tol=1e-5, matvec_device=op)
        close(evals, np.sort(np.linalg.eigvalsh(g.astype(np.float64)))
              [::-1][:3], rtol=1e-5)


class _Operator:
    """A Lanczos operator with the protocol: ``apply(operand, v)``."""

    def __init__(self, g):
        self.operand = g

    def apply(self, operand, v):
        return operand @ v.to(operand.dtype)


class TestShardedDecompositions:
    """Block-sharded inputs to the dist LU and Cholesky on 8 ranks: the
    factors come back sharded over every rank, the oracles hold."""

    def test_lu_on_sharded_input_stays_sharded(self, port):
        got = port.get("sharded_decompositions")
        a = INPUTS["lu192"]
        assert all(got["holders"])
        assert got["lu"]["type"] == "BlockMatrix"
        same_lu(got["lu"]["packed"], got["lu"]["perm"], a,
                jax_lu(a, "dist", 48))

    def test_cholesky_on_sharded_input_stays_sharded(self, port):
        ln = np.asarray(port.get("sharded_decompositions")["chol"])
        a = INPUTS["spd192"]
        close(ln @ ln.T, a, rtol=1e-10, atol=1e-8)
        with mt.config_override(cholesky_base_size=48):
            want = np.asarray(jl.cholesky_factor_array(jnp.asarray(a),
                                                       mode="dist"))
        close(ln, want)

    def test_graft_dist_lu_and_cholesky(self, port):
        # __graft_entry__.py's check: f32, n = 24 x 8, base n / 3, the
        # reconstructions within 5e-4, the factors of the JAX package's
        # check on the same inputs within the same bound.
        got = port.get("graft_dist_lu_cholesky")
        a, spd = INPUTS["graft_a"], INPUTS["graft_spd"]
        n = a.shape[0]
        l, u = pl.unpack_lu(np.asarray(got["lu"]["packed"], np.float64))
        perm = np.asarray(got["lu"]["perm"])
        close(a[perm], l @ u, rtol=5e-4, atol=5e-4)
        lch = np.asarray(got["chol"], np.float64)
        close(lch @ lch.T, spd, rtol=5e-4, atol=5e-4)
        assert got["dtype"] == "torch.float32" and got["mesh_size"] == 8
        with mt.config_override(lu_base_size=n // 3,
                                cholesky_base_size=n // 3):
            jp, jperm = jl.lu_factor_array(jnp.asarray(a), mode="dist")
            jch = jl.cholesky_factor_array(jnp.asarray(spd), mode="dist")
        assert np.array_equal(perm, np.asarray(jperm))
        close(got["lu"]["packed"], np.asarray(jp), rtol=5e-4, atol=5e-4)
        close(lch, np.asarray(jch), rtol=5e-4, atol=5e-4)

    @pytest.mark.parametrize("kind", ["lu", "chol"])
    def test_no_rank_holds_a_whole_operand(self, port, kind):
        # No op on rank 0 made a tensor that could hold the n x n operand
        # (either way round, or flattened) while it factored.
        got = port.get("graft_dist_lu_cholesky")[f"{kind}_shapes"]
        n = INPUTS["graft_a"].shape[0]
        assert got
        assert not [s for s in got if (len(s) == 2 and s[0] >= n
                                       and s[1] >= n)
                    or int(np.prod(s)) >= n * n]


class TestSolve:
    def test_lu_solve_matrix_rhs(self, rng):
        n = 96
        a = rng.standard_normal((n, n)) + n * np.eye(n)
        b = rng.standard_normal((n, 5))
        with pconfig.config_override(lu_base_size=32):
            x = pl.solve(T(a), T(b), mode="dist").numpy()
        close(a @ x, b, rtol=1e-8, atol=1e-8)
        with mt.config_override(lu_base_size=32):
            close(x, np.asarray(jl.solve(jnp.asarray(a), jnp.asarray(b),
                                         mode="dist")))

    def test_vector_rhs_and_local_mode(self, rng):
        a = rng.standard_normal((12, 12)) + 12 * np.eye(12)
        b = rng.standard_normal(12)
        x = pl.solve(T(a), T(b)).numpy()
        assert x.shape == (12,)
        close(a @ x, b, rtol=1e-9, atol=1e-12)
        close(x, np.asarray(jl.solve(jnp.asarray(a), jnp.asarray(b))))

    def test_spd_route(self, rng):
        n = 64
        g = rng.standard_normal((n, n))
        a = g @ g.T + n * np.eye(n)
        b = rng.standard_normal((n, 3))
        with pconfig.config_override(cholesky_base_size=32):
            x = pl.solve(T(a), T(b), mode="dist", assume_spd=True).numpy()
        close(a @ x, b, rtol=1e-8, atol=1e-8)
        with mt.config_override(cholesky_base_size=32):
            close(x, np.asarray(jl.solve(jnp.asarray(a), jnp.asarray(b),
                                         mode="dist", assume_spd=True)))

    def test_shape_errors(self):
        with pytest.raises(ValueError):
            pl.solve(torch.zeros((3, 4)), torch.zeros(3))
        with pytest.raises(ValueError):
            pl.solve(torch.eye(3), torch.zeros(4))

    @pytest.mark.parametrize("route", ["lu", "spd"])
    def test_distributed_operand(self, port, route):
        # The 8-rank solves of a DenseVecMatrix, in panels of 16.
        got = np.asarray(port.get("dist_solves")[route])
        a = INPUTS["lin64" if route == "lu" else "spd64"]
        b = INPUTS["rhs64"] if route == "lu" else INPUTS["rhs64"][:, 0]
        with mt.config_override(lu_base_size=16, cholesky_base_size=16):
            want = np.asarray(jl.solve(jnp.asarray(a), jnp.asarray(b),
                                       mode="dist",
                                       assume_spd=route == "spd"))
        close(got, want)
        close(a @ got, b, rtol=1e-9, atol=1e-9)


class TestLinalgPrecision:
    """Every entry point runs its products inside linalg_precision_scope:
    spied through config.matmul_precision_scope, which the scope enters
    with the config's linalg_precision. Composite entry points (dist
    inverse and solve) enter it for their own sweeps besides the
    factorization's entry: the counts are the JAX test's."""

    @pytest.fixture()
    def spy(self, monkeypatch):
        seen = []
        real = pconfig.matmul_precision_scope

        def record(precision=None):
            seen.append(precision)
            return real(precision)

        monkeypatch.setattr(pconfig, "matmul_precision_scope", record)
        return seen

    def _drive(self, fn, spy, expect):
        spy.clear()
        out = fn()
        assert spy.count("highest") == expect, (
            f"expected {expect} linalg scope entries, saw {spy}")
        return out

    def test_every_entry_point_enters_scope(self, rng, spy):
        a32 = T(rng.standard_normal((16, 16)).astype(np.float32))
        spd = a32 @ a32.T + 16 * torch.eye(16)
        b = T(rng.standard_normal(16).astype(np.float32))
        sq = a32 + 16 * torch.eye(16)
        with pconfig.config_override(matmul_precision="default",
                                     lu_base_size=8, cholesky_base_size=8):
            self._drive(lambda: pl.lu_factor_array(a32, mode="dist"), spy, 1)
            self._drive(lambda: pl.lu_factor_array(a32, mode="local"), spy,
                        1)
            self._drive(lambda: pl.cholesky_factor_array(spd, mode="dist"),
                        spy, 1)
            self._drive(lambda: pl.cholesky_factor_array(spd, mode="local"),
                        spy, 1)
            self._drive(lambda: pl.inverse(sq, mode="dist"), spy, 2)
            self._drive(lambda: pl.inverse(sq, mode="local"), spy, 1)
            self._drive(lambda: pl.solve(sq, b, mode="dist"), spy, 2)
            self._drive(lambda: pl.solve(sq, b, mode="local"), spy, 1)
            self._drive(lambda: pl.solve(spd, b, mode="dist",
                                         assume_spd=True), spy, 2)

    def test_scope_respects_linalg_precision_config(self, rng, spy):
        a32 = T(rng.standard_normal((16, 16)).astype(np.float32))
        with pconfig.config_override(linalg_precision="high",
                                     lu_base_size=8):
            pl.lu_factor_array(a32, mode="dist")
        assert "high" in spy and "highest" not in spy

    def test_dist_results_match_local_under_relaxed_global(self, rng):
        a = rng.standard_normal((20, 20))
        with pconfig.config_override(matmul_precision="default",
                                     lu_base_size=5):
            packed, perm = pl.lu_factor_array(T(a), mode="dist")
        l, u = pl.unpack_lu(packed.numpy())
        close(l @ u, a[perm])


class TestLanczosOperandProtocol:
    """The Gramian operator carries the operator protocol
    (``apply(operand, v)`` and ``operand``), and the device sweep's chunk
    applies the operand it is handed at each call, not one it captured."""

    def test_operator_exposes_protocol(self, port):
        got = port.get("gramian_operator")
        assert got["has_apply"] and got["operand_is_local"]
        a = INPUTS["svd40x12"]
        want = a.T @ (a @ np.linspace(-1.0, 1.0, 12))
        close(got["apply"], want)
        close(got["call"], want)
        close(got["call"],
              JDense(a).multiply_gramian_matrix_by(np.linspace(-1, 1, 12)))

    def test_chunk_applies_the_operand_it_is_handed(self, rng):
        n = 16
        g = rng.standard_normal((n, n))
        op = _Operator(T(g @ g.T))
        f = planczos._device_chunk_fn(op, 12, 0, n, torch.float64)

        def carry():
            q = torch.zeros((13, n), dtype=torch.float64)
            q[0, 0] = 1.0
            return (q, torch.zeros(12, dtype=torch.float64),
                    torch.zeros(12, dtype=torch.float64),
                    torch.zeros((n, 0), dtype=torch.float64), 0,
                    torch.tensor(-1))

        one = f(op.operand, carry())
        two = f(2 * op.operand, carry())
        assert one[4] == two[4] == 12  # capped at m_cap steps
        close(two[1], 2 * one[1])  # every alpha doubles with the operand
        assert one[1][0].item() == pytest.approx((g @ g.T)[0, 0])

    def test_half_implemented_protocol_rejected(self):
        def op(v):
            return v

        assert planczos._operator_protocol(op) == (None, ())
        op.apply = lambda a, v: v
        with pytest.raises(TypeError, match="BOTH"):
            planczos._operator_protocol(op)
        op.operand = torch.zeros((2, 2))
        assert planczos._operator_protocol(op)[0] is op.apply
        del op.apply
        with pytest.raises(TypeError, match="BOTH"):
            planczos._operator_protocol(op)


class TestLUPanelPivoting:
    """The blocked LU's pivot search spans every row below the diagonal
    (LAPACK getrf): the cases that break pivoting local to the diagonal
    block, each held to the oracle and to the JAX package's pivots."""

    def _check(self, a, base, tol=1e-10, same_pivots=True):
        packed, perm = port_lu(a, "dist", base)
        l, u = pl.unpack_lu(packed)
        scale = max(np.max(np.abs(a)), 1e-30)
        assert np.max(np.abs(a[perm] - l @ u)) / scale < tol
        assert np.max(np.abs(np.tril(packed, -1))) <= 1.0 + 1e-12
        assert sorted(perm.tolist()) == list(range(a.shape[0]))
        if same_pivots:
            assert np.array_equal(perm, jax_lu(a, "dist", base)[1])
        return packed, perm

    def test_zero_leading_block(self, rng):
        a = rng.standard_normal((32, 32))
        a[:8, :8] = 0.0
        self._check(a, 8)

    def test_tiny_leading_block_growth_bounded(self, rng):
        a = rng.standard_normal((32, 32))
        a[:8, :8] *= 1e-12
        packed, _ = self._check(a, 8)
        assert np.max(np.abs(packed)) / np.max(np.abs(a)) < 100.0

    def test_rank_deficient_column_dgetf2_semantics(self, rng):
        a = rng.standard_normal((24, 24))
        a[:, 5] = a[:, 3] * 2.0 - a[:, 1]
        # Past the dependent column the pivots are chosen among rounding
        # noise, so they need not be the JAX package's.
        packed, _ = self._check(a, 6, tol=1e-9, same_pivots=False)
        assert np.isfinite(packed).all()

    def test_all_zero_matrix(self):
        packed, perm = port_lu(np.zeros((16, 16)), "dist", 4)
        assert np.max(np.abs(packed)) == 0.0
        assert perm.tolist() == list(range(16))

    def test_zero_pivot_route_is_dgetf2(self, rng):
        # The panel route for a getrf that leaves a non-finite value at a
        # zero pivot: column-by-column dgetf2, the library's result where
        # the library keeps the skip.
        from marlin_tpu_torch.linalg import lu as plu

        a = rng.standard_normal((24, 8))
        a[:, 2] = 0.0
        packed, piv = plu._dgetf2(T(a))
        assert packed[2, 2] == 0 and (packed[3:, 2] == 0).all()
        lu_, pv, info = torch.linalg.lu_factor_ex(T(a))
        assert int(info) > 0
        close(packed, lu_)
        assert np.array_equal(piv, pv.numpy() - 1)

    def test_pivot_choices_match_lapack(self, rng):
        import scipy.linalg as sla

        a = rng.standard_normal((24, 24))
        packed, perm = self._check(a, 6)
        lu_s, piv = sla.lu_factor(a)
        perm_s = np.arange(24)
        for i, p in enumerate(piv):
            perm_s[[i, p]] = perm_s[[p, i]]
        assert np.array_equal(perm, perm_s)
        close(packed, lu_s, rtol=0, atol=1e-9)


class TestQR:
    def _check_qr(self, a, mode):
        q, r = pl.qr_factor_array(T(a), mode=mode)
        q, r = q.numpy(), r.numpy()
        m, n = a.shape
        assert q.shape == (m, n) and r.shape == (n, n)
        close(q @ r, a, rtol=1e-8, atol=1e-8)
        close(q.T @ q, np.eye(n), atol=1e-9)
        assert np.allclose(np.tril(r, -1), 0)
        jq, jr = jl.qr_factor_array(jnp.asarray(a), mode=mode)
        close(r, np.asarray(jr), rtol=1e-8, atol=1e-8)
        close(q, np.asarray(jq), rtol=1e-8, atol=1e-8)
        return q, r

    def test_tall_tsqr_matches_numpy_up_to_sign(self, rng):
        a = rng.standard_normal((7000, 24))  # auto -> dist -> CholeskyQR2
        q, r = self._check_qr(a, "auto")
        qn, rn = np.linalg.qr(a)
        sign = np.sign(np.diag(rn)) * np.sign(np.diag(r))
        close(r * sign[:, None], rn, rtol=1e-6, atol=1e-8)

    def test_tsqr_moderately_ill_conditioned(self, rng):
        u = np.linalg.qr(rng.standard_normal((600, 12)))[0]
        self._check_qr(u * np.logspace(0, 4, 12)[None, :], "tsqr")

    def test_square_routes_local(self, rng):
        self._check_qr(rng.standard_normal((32, 32)), "auto")

    def test_tsqr_rejects_fat(self, rng):
        with pytest.raises(ValueError, match="m >= n"):
            pl.qr_factor_array(T(rng.standard_normal((4, 8))), mode="tsqr")

    def test_qr_decompose_type_roundtrip(self, port):
        got = port.get("qr_roundtrip")
        a = INPUTS["qr40x8"]
        assert got["type"] == "DenseVecMatrix"
        assert got["block_type"] == "BlockMatrix"
        close(np.asarray(got["q"]) @ np.asarray(got["r"]), a, rtol=1e-8,
              atol=1e-8)
        jq, jr = jl.qr_decompose(JDense(a), mode="tsqr")
        close(got["q"], jq.to_numpy(), rtol=1e-8, atol=1e-8)
        close(got["block_q"], jq.to_numpy(), rtol=1e-8, atol=1e-8)
        close(got["lstsq"], np.arange(1.0, 9.0), rtol=1e-8, atol=1e-8)

    def test_lstsq_matches_numpy(self, rng):
        a = rng.standard_normal((7000, 16))
        b = a @ rng.standard_normal((16, 3)) \
            + 0.01 * rng.standard_normal((7000, 3))
        x = pl.lstsq(T(a), T(b)).numpy()
        close(x, np.linalg.lstsq(a, b, rcond=None)[0], rtol=1e-6, atol=1e-8)
        close(x, np.asarray(jl.lstsq(jnp.asarray(a), jnp.asarray(b))))

    def test_lstsq_vector_rhs_and_local_route(self, rng):
        a = rng.standard_normal((40, 8))
        b = rng.standard_normal(40)
        x = pl.lstsq(T(a), T(b)).numpy()
        assert x.shape == (8,)
        close(x, np.linalg.lstsq(a, b, rcond=None)[0], rtol=1e-6, atol=1e-8)

    def test_lstsq_mode_validation_and_fat_guard(self, rng):
        a = T(rng.standard_normal((4, 8)))
        b = T(rng.standard_normal(4))
        with pytest.raises(ValueError, match="m >= n"):
            pl.lstsq(a, b, mode="tsqr")
        with pytest.raises(ValueError, match="Do not support mode"):
            pl.lstsq(a, b, mode="dist")

    def test_f32_extreme_condition_falls_back_finite(self, rng):
        u = np.linalg.qr(rng.standard_normal((7000, 8)))[0]
        a = T((u * np.logspace(0, 7, 8)[None, :]).astype(np.float32))
        q, r = pl.qr_factor_array(a, mode="tsqr")
        qn = q.numpy().astype(np.float64)
        assert np.isfinite(qn).all()
        close(qn.T @ qn, np.eye(8), atol=1e-4)
        x = pl.lstsq(a, T(rng.standard_normal(7000).astype(np.float32)))
        assert np.isfinite(x.numpy()).all()


class TestLogisticRegression:
    def test_matches_jax(self, port):
        # DenseVecMatrix.lr: 20 full-batch steps over 8 ranks' rows against
        # the JAX package's single program (f64, 1e-10).
        got = np.asarray(port.get("logistic_regression")["w"])
        data = INPUTS["logit"]
        close(got, JDense(data).lr(step_size=1.0, iters=20))
        z = got[0] + data[:, 1:] @ got[1:]
        assert ((z > 0) == (data[:, 0] > 0.5)).mean() > 0.9
        assert math.isfinite(float(np.sum(got)))
