"""Rank processes for the port's distributed tests (``marlin_tpu_torch``
on a gloo group on the CPU), in the manner of ``multihost_worker.py``.

A test module calls :func:`launch` once, from a module-scoped fixture
(or :func:`shared_launch`, when several modules read one suite): it
writes the module's seeded numpy inputs to an ``.npz`` and starts
this script, which imports torch and the port once and forks ``world``
ranks (joined through a fresh ``FileStore``, never a TCP port); it waits
at most ``timeout`` seconds and kills every rank on the timeout or on
the first rank's death. Each rank
runs every case of its suite in order, printing ``CASE <name>`` first;
rank 0 writes each case's status and values to a JSON file. Each test
then reads its own case (:meth:`Results.get`), so one wrong case fails
one test, and a crash fails each test with the case that was running.

The ranks are kept small: ``OMP_NUM_THREADS=1``, ``MKL_NUM_THREADS=1``
and ``torch.set_num_threads(1)``, at a lower scheduling priority (nice
10) than the tests around them; this script imports no jax. Nothing here
initialises a process group in the pytest process.

Usage (by :func:`launch`): python torch_dist_worker.py SUITE WORLD DIR
(DIR holds inputs.npz; the ranks write rank<r>.log there and rank 0
results.json).
"""

from __future__ import annotations

import fcntl
import json
import os
import signal
import subprocess
import sys
import traceback
import warnings
from typing import Callable, Dict

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUITES: Dict[str, Dict[str, Callable]] = {}


def case(suite: str):
    """Register a case of ``suite``: a function of the context that runs
    on every rank and returns a JSON-able dict (rank 0's is kept)."""
    def register(fn):
        SUITES.setdefault(suite, {})[fn.__name__] = fn
        return fn
    return register


# ---------------------------------------------------------------------------
# The pytest side
# ---------------------------------------------------------------------------


def make_inputs() -> dict:
    """The seeded numpy inputs every suite reads (the tests hand the same
    arrays to the JAX package)."""
    rng = np.random.default_rng(1742)

    def normal(*shape):
        return rng.standard_normal(shape)

    return {
        "A4": np.array([[1.0, 2, 3, 4], [2, 3, 4, 5], [3, 4, 5, 6],
                        [4, 5, 6, 7]]),
        "B4": np.array([[1.0, 0, 2, 0], [0, 1, 0, 2], [2, 0, 1, 0],
                        [0, 2, 0, 1]]),
        "A35": np.arange(35.0).reshape(5, 7),
        "arange48": np.arange(48.0).reshape(8, 6),
        "U30x22": normal(30, 22), "U37": normal(37),
        "a": normal(23, 17), "b": normal(17, 29),
        "x17": np.arange(17.0), "x1_17": np.arange(1.0, 18.0),
        "ones17": np.ones(17), "v17": np.linspace(-1, 1, 17),
        "tall_a": normal(640, 8), "tall_b": normal(8, 16),
        "deep_a": normal(8, 640), "deep_b": normal(640, 8),
        "u13x11": normal(13, 11), "u11x9": normal(11, 9),
        "p48x40": normal(48, 40), "p40x32": normal(40, 32),
        "p64a": normal(64, 64), "p64b": normal(64, 64),
        "p32x24": normal(32, 24), "p24x16": normal(24, 16),
        "p16x8": normal(16, 8), "p8x8": normal(8, 8),
        "ov8x12": normal(8, 12), "ov6x12": normal(6, 12),
        "ov12x10": normal(12, 10),
        # The uneven shapes of __graft_entry__.py's asymmetric 2 x 3 mesh.
        "a6": normal(30, 22), "b6": normal(22, 14),
        "dm6": normal(26, 18), "dm6b": normal(18, 10),
        "S1": np.array([[0.0, 1.5, 0], [2.0, 0, 0], [0, 0, 3.0],
                        [0, 4.0, 0]]),
        "D43": normal(3, 5),
        "g64x48": normal(64, 48), "g48x56": normal(48, 56),
        "g4x48": normal(4, 48),
    }


class Results:
    """Rank 0's results, or the reason there are none."""

    def __init__(self, cases: dict, failure: str = ""):
        self.cases = cases
        self.failure = failure

    def get(self, name: str) -> dict:
        if self.failure:
            raise AssertionError(self.failure)
        if name not in self.cases:
            raise AssertionError(f"case {name} has no result")
        got = self.cases[name]
        if got["status"] != "ok":
            raise AssertionError(f"case {name} failed on the ranks:\n"
                                 f"{got['status']}")
        return got["values"]


def launch(suite: str, world: int, inputs: dict, tmp_dir,
           timeout: float = 120.0) -> Results:
    """Run every case of ``suite`` on ``world`` gloo ranks; see the
    module docstring."""
    tmp_dir = str(tmp_dir)
    in_path = os.path.join(tmp_dir, "inputs.npz")
    out_path = os.path.join(tmp_dir, "results.json")
    np.savez(in_path, **inputs)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    # The launcher and its ranks form a session of their own, so one
    # killpg ends them all.
    with open(os.path.join(tmp_dir, "launcher.log"), "w") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), suite, str(world),
             tmp_dir], stdout=log, stderr=subprocess.STDOUT, env=env,
            cwd=tmp_dir, start_new_session=True)
    failure = ""
    try:
        proc.wait(timeout=timeout)
        if proc.returncode != 0:
            failure = f"a rank died (launcher exit {proc.returncode})"
    except subprocess.TimeoutExpired:
        failure = f"the ranks did not finish within {timeout:.0f} s"
    finally:
        if proc.poll() is None or failure:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    if not failure and not os.path.exists(out_path):
        failure = "rank 0 wrote no results"
    if failure:
        tails = []
        for rank in ["launcher"] + list(range(world)):
            path = os.path.join(tmp_dir, f"rank{rank}.log"
                                if rank != "launcher" else "launcher.log")
            text = ""
            if os.path.exists(path):
                with open(path) as f:
                    text = f.read()
            running = [ln for ln in text.splitlines()
                       if ln.startswith("CASE ")]
            tails.append(f"--- rank {rank} (last "
                         f"{running[-1] if running else 'no case'}):\n"
                         f"{text[-2000:]}")
        return Results({}, f"{suite} suite: {failure}\n" + "\n".join(tails))
    with open(out_path) as f:
        return Results(json.load(f))


def shared_launch(suite: str, world: int, inputs: dict, tmp_path_factory,
                  timeout: float = 120.0) -> Results:
    """:func:`launch` once per test session, whichever module asks first.
    The outcome is kept in the session's base temporary directory (the one
    the xdist workers share), under a file lock, so a later module (on any
    worker) reads it instead of starting the ranks again."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    run_dir = base / f"torch_dist_{suite}"
    run_dir.mkdir(exist_ok=True)
    saved = run_dir / "outcome.json"
    with open(run_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if saved.exists():
            got = json.loads(saved.read_text())
            return Results(got["cases"], got["failure"])
        run = launch(suite, world, inputs, run_dir, timeout)
        saved.write_text(json.dumps({"cases": run.cases,
                                     "failure": run.failure}))
        return run


# ---------------------------------------------------------------------------
# The rank side
# ---------------------------------------------------------------------------


class Ctx:
    """What a case sees: the module's inputs."""

    def __init__(self, inputs):
        self.inputs = inputs

    def inp(self, name: str) -> np.ndarray:
        return self.inputs[name]


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if hasattr(x, "tolist"):
        return x.tolist()
    return x


def _gather(x):
    """Every rank's ``x`` (a JSON-able value), in rank order."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, x)
    return out


def _raises(fn, exc=Exception) -> str:
    """The name of what ``fn()`` raised ("" when nothing was raised)."""
    try:
        fn()
    except exc as e:  # noqa: BLE001 - the case records it
        return type(e).__name__
    return ""


def _np(x):
    """A port matrix or vector's value, or a tensor, as an ndarray."""
    if hasattr(x, "to_numpy"):
        return x.to_numpy()
    return x.detach().cpu().numpy()


def run_rank(suite: str, rank: int, world: int, tmp_dir: str) -> int:
    """One rank: join the gloo group through the FileStore in
    ``tmp_dir``, run every case of ``suite``, and (rank 0) write the
    results."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp_dir, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    from marlin_tpu_torch import mesh as pmesh

    pmesh.set_default_mesh(pmesh.create_mesh(device="cpu"))
    ctx = Ctx(dict(np.load(os.path.join(tmp_dir, "inputs.npz"))))
    results = {}
    for name, fn in SUITES[suite].items():
        print(f"CASE {name}", flush=True)
        try:
            results[name] = {"status": "ok", "values": _jsonable(fn(ctx))}
        except Exception:  # noqa: BLE001 - recorded for the test to report
            results[name] = {"status": traceback.format_exc(), "values": {}}
            print(results[name]["status"], flush=True)
    if rank == 0:
        out_path = os.path.join(tmp_dir, "results.json")
        with open(out_path + ".tmp", "w") as f:
            json.dump(results, f)
        os.replace(out_path + ".tmp", out_path)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def main(argv) -> int:
    """The launcher: import torch and the port once, then fork the ranks
    (each writes ``rank<r>.log`` in ``tmp_dir``), so the ranks share the
    imports' pages and their seconds of CPU instead of paying them each.
    Forking is safe here because this process has one thread (checked)
    and has run no torch op. The first rank to fail ends the others."""
    suite, world, tmp_dir = argv[0], int(argv[1]), argv[2]
    import torch  # noqa: F401 - shared with the forked ranks
    import torch.distributed  # noqa: F401

    import torch.utils._python_dispatch  # noqa: F401
    import marlin_tpu_torch.matrix  # noqa: F401
    import marlin_tpu_torch.parallel  # noqa: F401
    import marlin_tpu_torch.utils.random  # noqa: F401

    if len(os.listdir("/proc/self/task")) != 1:
        raise RuntimeError("the launcher has threads: it cannot fork")
    # Below the suite's other tests in priority: several of them hold
    # wall-clock bars, and the ranks' work has no deadline but `timeout`.
    os.nice(19)
    pids = {}
    for rank in range(world):
        pid = os.fork()
        if pid == 0:
            log = os.open(os.path.join(tmp_dir, f"rank{rank}.log"),
                          os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
            os.dup2(log, 1)
            os.dup2(log, 2)
            code = 1
            try:
                code = run_rank(suite, rank, world, tmp_dir)
            except BaseException:  # noqa: BLE001 - the rank's log shows it
                traceback.print_exc()
            finally:
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(code)
        pids[pid] = rank
    status = 0
    while pids:
        pid, code = os.wait()
        pids.pop(pid, None)
        if code != 0 and status == 0:
            status = 1
            for other in pids:
                os.kill(other, signal.SIGKILL)
    return status


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------

# -- core: the mesh (twin of tests/test_mesh.py) and the matrix types (twin
# of tests/test_matrix_core.py); one launch of 8 ranks for both modules ----

LAYOUT_SHAPES = {"row": (16, 6), "block": (16, 6), "col": (6, 16),
                 "replicated": (5, 7), "vector": (24,)}


@case("core")
def default_mesh_shape(c):
    from marlin_tpu_torch import mesh as pm

    m = pm.create_mesh(device="cpu")
    return {"shape": m.shape, "axis_sizes": pm.axis_sizes(m),
            "ranks": m.ranks, "cached": pm.default_mesh() is pm.default_mesh()}


@case("core")
def explicit_shape(c):
    from marlin_tpu_torch import mesh as pm

    return {"axis_sizes": pm.axis_sizes(pm.create_mesh((2, 4), device="cpu"))}


@case("core")
def mesh_of_four(c):
    from marlin_tpu_torch import mesh as pm

    m = pm.create_mesh((2, 2), devices=range(4), device="cpu")
    return {"size": m.size, "coords": _gather(m.coordinate),
            "holds": _gather(m.holds)}


@case("core")
def shape_mismatch_raises(c):
    from marlin_tpu_torch import mesh as pm

    return {"raised": _raises(lambda: pm.create_mesh(
        (3, 2), devices=range(4), device="cpu"), ValueError)}


@case("core")
def custom_axis_names(c):
    from marlin_tpu_torch import mesh as pm

    m = pm.create_mesh((2, 2), axis_names=("a", "b"), devices=range(4),
                       device="cpu")
    return {"axis_names": list(m.axis_names)}


@case("core")
def submeshes(c):
    from marlin_tpu_torch import mesh as pm

    d = pm.default_mesh()
    s4, s6 = pm.submesh(d, 4), pm.submesh(d, 6)
    return {"cached": pm.submesh(d, 4) is s4, "whole": pm.submesh(d, 8) is d,
            "s4": s4.shape, "s6": s6.shape, "s6_ranks": s6.ranks,
            "s6_holds": _gather(s6.holds),
            "bad": _raises(lambda: pm.submesh(d, 9), ValueError)}


@case("core")
def layout_shards(c):
    from marlin_tpu_torch import mesh as pm

    out = {}
    for name, shape in LAYOUT_SHAPES.items():
        lay = getattr(pm, f"{name}_sharding")(pm.default_mesh())
        out[name] = _gather([[s.start, s.stop]
                             for s in pm.local_slices(lay, shape)])
    return out


@case("core")
def layout_round_trip(c):
    import torch

    from marlin_tpu_torch import mesh as pm
    from marlin_tpu_torch.utils.split import pad_to

    d = pm.default_mesh()
    arr = torch.from_numpy(c.inp("arange48"))
    out = {}
    for name in ("row", "block", "replicated"):
        lay = getattr(pm, f"{name}_sharding")(d)
        out[name] = bool(torch.equal(
            pm.unshard(pm.shard(arr, lay), lay, arr.shape), arr))
    row, blk = pm.row_sharding(d), pm.block_sharding(d)
    out["relayout"] = bool(torch.equal(
        pm.redistribute(pm.shard(arr, row), row, arr.shape, blk, arr.shape,
                        arr.shape, arr.dtype),
        pm.shard(arr, blk)))
    # Shard to shard between paddings and onto a 2 x 3 submesh: a 27 x 7
    # matrix padded to (8, 1) multiples under the row layout, to (2, 3) on
    # the submesh, to (4, 8) under the col layout.
    odd = torch.from_numpy(c.inp("U30x22"))[:27, :7]
    m6 = pm.create_mesh((2, 3), devices=range(6), device="cpu")
    moves = {"row_to_block6": (row, (8, 1), pm.block_sharding(m6), (2, 3)),
             "row_to_col": (row, (8, 1), pm.col_sharding(d), (4, 8)),
             "block6_to_replicated": (pm.block_sharding(m6), (2, 3),
                                      pm.replicated_sharding(d), (1, 1))}
    for name, (src, smult, dst, dmult) in moves.items():
        src_local = pm.shard(pad_to(odd, smult), src)
        got = pm.redistribute(src_local, src, pad_to(odd, smult).shape, dst,
                              pad_to(odd, dmult).shape, odd.shape, odd.dtype)
        want = pm.shard(pad_to(odd, dmult), dst)
        out[name] = _gather(None if want is None
                            else bool(torch.equal(got, want)))
    return out



def _make(kind, arr, **kw):
    from marlin_tpu_torch.matrix import BlockMatrix, DenseVecMatrix

    if kind == "dvm":
        return DenseVecMatrix(arr, **kw)
    return BlockMatrix(arr, blks_by_row=kw.pop("r", 2),
                       blks_by_col=kw.pop("c", 2), **kw)


@case("core")
def metadata(c):
    import numpy as np

    from marlin_tpu_torch.matrix import DenseVecMatrix, DistributedVector

    a4 = c.inp("A4")
    m = DenseVecMatrix(a4)
    rows = DenseVecMatrix.from_rows([(0, a4[0]), (2, a4[2]), (1, a4[1]),
                                     (3, a4[3])])
    return {"rows": m.num_rows, "cols": m.num_cols,
            "count": m.elements_count(), "from_rows": rows.to_numpy(),
            "empty_matrix": _raises(lambda: DenseVecMatrix(
                np.zeros((0, 3))), ValueError),
            "empty_vector": _raises(lambda: DistributedVector(
                np.zeros((0,))), ValueError)}


for _kind in ("dvm", "blk"):
    def _elementwise(c, kind=_kind):
        a4, b4 = c.inp("A4"), c.inp("B4")
        m = _make(kind, a4)
        return {"add": m.add(_make(kind, b4)).to_numpy(),
                "sub": m.subtract(_make(kind, b4)).to_numpy(),
                "add_s": m.add(2.5).to_numpy(),
                "sub_s": m.subtract(1.5).to_numpy(),
                "mul": m.multiply(3.0).to_numpy(),
                "div": m.divide(2.0).to_numpy(),
                "div_by": m.divide_by(2.0).to_numpy(),
                "sub_by": m.subtract_by(10.0).to_numpy(),
                "transpose": m.transpose().to_numpy(),
                "sum": m.sum()}
    _elementwise.__name__ = f"elementwise_{_kind}"
    case("core")(_elementwise)


@case("core")
def element_multiply_and_mismatch(c):
    a4, b4 = c.inp("A4"), c.inp("B4")
    return {"hadamard": _make("blk", a4).element_multiply(
        _make("blk", b4)).to_numpy(),
            "mismatch": _raises(lambda: _make("dvm", a4).add(
                _make("dvm", a4[:3])), ValueError)}


@case("core")
def dot_product_all_pairings(c):
    a4, b4 = c.inp("A4"), c.inp("B4")
    return {f"{x}_{y}": _make(x, a4).dot_product(_make(y, b4))
            for x in ("dvm", "blk") for y in ("dvm", "blk")}


@case("core")
def norms(c):
    m = _make("dvm", c.inp("A4"))
    return {"one": m.norm("1"), "inf": m.norm("inf"),
            "fro": _raises(lambda: m.norm("fro"), ValueError)}


@case("core")
def structure(c):
    a4, b4 = c.inp("A4"), c.inp("B4")
    m = _make("dvm", a4)
    return {"c_bind": m.c_bind(_make("dvm", b4)).to_numpy(),
            "c_bind_bad": _raises(lambda: m.c_bind(_make("dvm", b4[:2])),
                                  ValueError),
            "rows_1_2": m.slice_by_row(1, 2).to_numpy(),
            "cols_0_1": m.slice_by_column(0, 1).to_numpy(),
            "sub": m.get_sub_matrix(1, 3, 2, 3).to_numpy(),
            "slice_bad": _raises(lambda: m.slice_by_row(2, 4), ValueError),
            "exchange": m.row_exchange(0, 3).to_numpy(),
            "exchange_bad": _raises(lambda: m.row_exchange(1, 5),
                                    ValueError)}


@case("core")
def block_grid(c):
    from marlin_tpu_torch.matrix import BlockMatrix

    a35 = c.inp("A35")
    m = BlockMatrix(a35, blks_by_row=2, blks_by_col=3)
    t = m.transpose()
    rt = _make("dvm", c.inp("A4")).to_block_matrix(2, 2)
    rg = _make("blk", c.inp("A4")).to_block_matrix(4, 1)
    return {"t_grid": [t.blks_by_row, t.blks_by_col], "t": t.to_numpy(),
            "extent": m.block_extent(1, 2),
            "block": m.get_block(1, 2).numpy(),
            "rt_type": type(rt).__name__,
            "rt_grid": [rt.blks_by_row, rt.blks_by_col],
            "rt_back": rt.to_dense_vec_matrix().to_numpy(),
            "rg_grid": [rg.blks_by_row, rg.blks_by_col],
            "rg": rg.to_numpy()}


@case("core")
def vectors(c):
    import numpy as np

    from marlin_tpu_torch.matrix import DistributedVector

    v = DistributedVector(np.arange(10.0))
    a = DistributedVector(np.arange(6.0))
    b = DistributedVector(np.ones(6))
    x, y = np.arange(1.0, 5.0), np.arange(2.0, 6.0)
    col = DistributedVector(x, column_major=True)
    row = DistributedVector(y, column_major=False)
    outer = col.multiply_vector(row, mode="dist")
    return {"length": v.length, "v": v.to_numpy(),
            "sub": a.substract(b).to_numpy(),
            "orient": [a.column_major, a.transpose().column_major],
            "outer_type": type(outer).__name__, "outer": outer.to_numpy(),
            "outer_local": col.multiply_vector(row, mode="local"),
            "inner": row.multiply_vector(col),
            "same_orient": _raises(lambda: col.multiply_vector(col),
                                   ValueError)}


@case("core")
def bf16_accumulators(c):
    import torch

    from marlin_tpu_torch.matrix import DenseVecMatrix, DistributedVector

    a = DenseVecMatrix(torch.ones((160, 256), dtype=torch.bfloat16))
    b = DenseVecMatrix(torch.ones((160, 256), dtype=torch.bfloat16))
    v = DistributedVector(torch.ones((4096,), dtype=torch.bfloat16))
    return {"sum": a.sum(), "dot": a.dot_product(b), "one": a.norm("1"),
            "inf": a.norm("inf"), "vdot": v.dot(v)}


@case("core")
def uneven_shards(c):
    from marlin_tpu_torch import mesh as pm
    from marlin_tpu_torch.matrix import (BlockMatrix, DenseVecMatrix,
                                         DistributedVector)

    out = {}
    m6 = pm.create_mesh((2, 3), devices=range(6), device="cpu")
    for key, mesh in (("default", pm.default_mesh()), ("asym", m6)):
        for name, mat in (("dvm", DenseVecMatrix(c.inp("U30x22"), mesh=mesh)),
                          ("blk", BlockMatrix(c.inp("U30x22"), mesh=mesh)),
                          ("vec", DistributedVector(c.inp("U37"),
                                                    mesh=mesh))):
            out[f"{key}_{name}_shapes"] = _gather(
                None if mat.local is None else list(mat.local.shape))
            if mesh.holds:
                out[f"{key}_{name}"] = mat.to_numpy()
    return out


# -- gemm (twin of tests/test_gemm.py; 8 ranks) ------------------------------

def _dvm(x, **kw):
    from marlin_tpu_torch.matrix import DenseVecMatrix

    return DenseVecMatrix(x, **kw)


def _blk(x, **kw):
    from marlin_tpu_torch.matrix import BlockMatrix

    return BlockMatrix(x, **kw)


def _product(out):
    return {"type": type(out).__name__, "value": _np(out)}


@case("gemm")
def dense_arms(c):
    a, b = c.inp("a"), c.inp("b")
    return {
        "broadcast": _product(_dvm(a).multiply(_dvm(b))),
        "local_matrix": _product(_dvm(a).multiply(b)),
        "left_broadcast": _product(_dvm(a).multiply(
            _dvm(b), broadcast_threshold_mb=3500 / 1e6)),
        "split": _product(_dvm(a).multiply(_dvm(b),
                                           broadcast_threshold_mb=1e-9)),
        "local_vector": _product(_dvm(a).multiply(c.inp("x17"))),
        "mismatch": _raises(lambda: _dvm(a).multiply(_dvm(a)), ValueError),
    }


@case("gemm")
def matvec(c):
    from marlin_tpu_torch.matrix import DistributedVector

    return _product(_dvm(c.inp("a")).multiply(
        DistributedVector(c.inp("x1_17"))))


@case("gemm")
def carma_branches(c):
    from marlin_tpu_torch.utils.split import grid_for_devices

    return {
        "tall": _product(_dvm(c.inp("tall_a")).multiply(
            _dvm(c.inp("tall_b")), broadcast_threshold_mb=1e-9)),
        "deep": _product(_dvm(c.inp("deep_a")).multiply(
            _dvm(c.inp("deep_b")), broadcast_threshold_mb=1e-9)),
        "deep_grid": grid_for_devices(8, 640, 8, 8),
    }


for _engine in ("summa", "gspmd", "cannon"):
    def _split_engine(c, engine=_engine):
        return _product(_dvm(c.inp("a")).multiply(_dvm(c.inp("b")),
                                                  mode=engine))
    _split_engine.__name__ = f"split_engine_{_engine}"
    case("gemm")(_split_engine)

MKN_GRIDS = ((2, 2, 2), (8, 1, 1), (1, 8, 1), (1, 1, 8), (4, 2, 1),
             (2, 1, 4))


@case("gemm")
def explicit_mkn_splits(c):
    return {"x".join(map(str, g)): _np(_dvm(c.inp("a")).multiply(
        _dvm(c.inp("b")), mode=g)) for g in MKN_GRIDS}


@case("gemm")
def grid_fallback(c):
    from marlin_tpu_torch.utils.timing import metrics

    a, b = _dvm(c.inp("a")), _dvm(c.inp("b"))
    before = metrics.counters["gemm.grid_fallback"]
    with warnings.catch_warnings(record=True) as forced:
        warnings.simplefilter("always")
        out = a.multiply(b, mode=(4, 4, 4))
    after_forced = metrics.counters["gemm.grid_fallback"]
    with warnings.catch_warnings(record=True) as auto:
        warnings.simplefilter("always")
        a._multiply_grid(b, (4, 4, 4), forced=False)
    return {"value": _np(out), "forced_delta": after_forced - before,
            "forced_warned": any("2-D engine" in str(w.message)
                                 for w in forced),
            "auto_warned": any("2-D engine" in str(w.message) for w in auto)}


@case("gemm")
def cannon_square_mesh(c):
    import torch

    from marlin_tpu_torch import mesh as pm
    from marlin_tpu_torch.parallel import summa

    sq = pm.create_mesh((2, 2), devices=range(4), device="cpu")
    out = summa.matmul(torch.from_numpy(c.inp("a")),
                       torch.from_numpy(c.inp("b")), mesh=sq,
                       engine="cannon")
    return {"value": None if out is None else out.numpy()}


@case("gemm")
def block_multiply(c):
    a, b = c.inp("a"), c.inp("b")
    return {
        "block_x_block": _product(_blk(a).multiply(_blk(b), mode="summa")),
        "regrid": _product(_blk(a, blks_by_row=4, blks_by_col=2).multiply(
            _blk(b, blks_by_row=3, blks_by_col=3), mode="summa")),
        "broadcast_b": _product(_blk(a).multiply(_blk(b))),
        "local": _product(_blk(a).multiply(b)),
        "vector": _product(_blk(a).multiply(c.inp("ones17"))),
        "multiply_by": _product(_blk(b).multiply_by(a)),
        "dense_x_block": _product(_dvm(a).multiply(_blk(b), mode="summa")),
        "block_x_dense": _product(_blk(a).multiply(_dvm(b), mode="summa")),
        "scalar": _product(_blk(a).multiply(2.0)),
        "tuple": _product(_blk(a).multiply(_blk(b), mode=(2, 2, 2))),
    }


@case("gemm")
def matmul_3d_uneven(c):
    import torch

    from marlin_tpu_torch.parallel import summa

    out = summa.matmul_3d(torch.from_numpy(c.inp("u13x11")),
                          torch.from_numpy(c.inp("u11x9")), (2, 2, 2))
    return {"value": out.numpy()}


@case("gemm")
def gramian(c):
    m = _dvm(c.inp("a"))
    return {"g": m.compute_gramian_matrix(),
            "gv": m.multiply_gramian_matrix_by(c.inp("v17"))}


@case("gemm")
def random_generation(c):
    import torch

    from marlin_tpu_torch import mesh as pm
    from marlin_tpu_torch.utils import random as mrand

    m1 = mrand.random_den_vec_matrix(32, 16, seed=7).to_numpy()
    m2 = mrand.random_den_vec_matrix(32, 16, seed=7).to_numpy()
    m3 = mrand.random_den_vec_matrix(32, 16, seed=8).to_numpy()
    # The same seed on a mesh of 4 and as a block matrix: the same values.
    m4 = mrand.random_den_vec_matrix(
        32, 16, seed=7, mesh=pm.submesh(pm.default_mesh(), 4))
    m4 = m4.to_numpy() if m4.holds else None
    blk = mrand.random_block_matrix(32, 16, seed=7).to_numpy()
    n = mrand.random_den_vec_matrix(200, 100, distribution="normal",
                                    seed=1).to_numpy()
    u = mrand.random_block_matrix(64, 64, distribution="uniform",
                                  seed=2).to_numpy()
    p = mrand.random_den_vec_matrix(100, 100, distribution="poisson",
                                    seed=3, mean=4.0).to_numpy()
    sp = mrand.random_spa_vec_matrix(100, 100, sparsity=0.1, seed=6)
    return {"same_seed": bool((m1 == m2).all()),
            "other_seed_differs": not bool(np.allclose(m1, m3)),
            "mesh_of_4_same": None if m4 is None else bool((m4 == m1).all()),
            "block_same": bool((blk == m1).all()),
            "normal_mean": float(n.mean()), "normal_std": float(n.std()),
            "uniform_min": float(u.min()), "uniform_max": float(u.max()),
            "zeros_sum": mrand.zeros_den_vec_matrix(8, 8).sum(),
            "ones_sum": mrand.ones_den_vec_matrix(8, 8).sum(),
            "poisson_mean": float(p.mean()),
            "vector_length": mrand.random_dist_vector(100, seed=5).length,
            "ones_vector_sum": float(mrand.ones_dist_vector(10)
                                     .to_numpy().sum()),
            "sparse_density": float((sp.to_numpy() != 0).mean()),
            "dtype": str(mrand.random_den_vec_matrix(
                4, 4, seed=1, dtype=torch.float64).dtype)}


@case("gemm")
def parallelism_hint(c):
    a, b = _dvm(c.inp("p48x40")), _dvm(c.inp("p40x32"))
    out = {}
    for mode in (None, "summa", "gspmd", "broadcast"):
        r = a.multiply(b, parallelism=2, mode=mode)
        out[f"dense_{mode}"] = {"mesh_size": r.mesh.size,
                                "value": _np(r) if r.holds else None}
    sq = _dvm(c.inp("p64a")).multiply(_dvm(c.inp("p64b")), parallelism=4,
                                      broadcast_threshold_mb=1e-9)
    out["auto_small_threshold"] = {"mesh_size": sq.mesh.size,
                                   "value": _np(sq) if sq.holds else None}
    bl = _blk(c.inp("p32x24")).multiply(_blk(c.inp("p24x16")),
                                        parallelism=2,
                                        broadcast_threshold_mb=1e-9)
    out["block"] = {"mesh_size": bl.mesh.size,
                    "value": _np(bl) if bl.holds else None}
    cap = _dvm(c.inp("p16x8")).multiply(_dvm(c.inp("p8x8")),
                                        parallelism=999)
    out["capped"] = {"mesh_size": cap.mesh.size, "value": _np(cap)}
    return out


@case("gemm")
def axis_name_override(c):
    import torch

    from marlin_tpu_torch import mesh as pm
    from marlin_tpu_torch.config import config_override
    from marlin_tpu_torch.parallel import summa

    mesh = pm.create_mesh((4, 2), axis_names=("x", "y"), device="cpu")
    b = torch.from_numpy(c.inp("ov12x10"))
    out = {}
    for engine in ("summa", "gspmd", "cannon"):
        with config_override(mesh_axis_rows="x", mesh_axis_cols="y"):
            out[f"{engine}_xy"] = summa.matmul(
                torch.from_numpy(c.inp("ov8x12")), b, mesh=mesh,
                engine=engine).numpy()
        with config_override(mesh_axis_rows="y", mesh_axis_cols="x"):
            out[f"{engine}_yx"] = summa.matmul(
                torch.from_numpy(c.inp("ov6x12")), b, mesh=mesh,
                engine=engine).numpy()
    return out


@case("gemm")
def bf16_accumulators(c):
    import torch

    from marlin_tpu_torch import mesh as pm
    from marlin_tpu_torch.parallel import summa

    n = 512
    a = torch.ones((n, n), dtype=torch.bfloat16)
    sq = pm.create_mesh((2, 2), devices=range(4), device="cpu")
    out = {}
    for engine in ("cannon", "summa"):
        r = summa.matmul(a, a, mesh=sq, engine=engine)
        out[engine] = None if r is None else float(r.float().max())
    out["3d"] = float(summa.matmul_3d(a, a, (2, 2, 2)).float().max())
    out["n"] = n
    return out


@case("gemm")
def asymmetric_submesh(c):
    import torch

    from marlin_tpu_torch import mesh as pm
    from marlin_tpu_torch.parallel import summa

    m6 = pm.create_mesh((2, 3), devices=range(6), device="cpu")
    s = summa.matmul(torch.from_numpy(c.inp("a6")),
                     torch.from_numpy(c.inp("b6")), mesh=m6, engine="summa")
    a = _dvm(c.inp("dm6"), mesh=m6)
    b = _dvm(c.inp("dm6b"), mesh=m6)
    auto = a.multiply(b)
    split = a.multiply(b, broadcast_threshold_mb=1e-9)
    engines = {e: a.multiply(b, mode=e) for e in ("gspmd", "cannon")}
    return {"summa": None if s is None else s.numpy(),
            "auto": _np(auto) if auto.holds else None,
            "split": _np(split) if split.holds else None,
            **{e: _np(r) if r.holds else None for e, r in engines.items()},
            "shapes": _gather(None if split.local is None
                              else list(split.local.shape))}


def _tensor_shapes(fn):
    """(what ``fn()`` returns, the distinct shapes of the tensors that ops
    made on this rank while it ran)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Shapes(TorchDispatchMode):
        seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    self.seen.add(tuple(t.shape))
            return out

    with Shapes() as mode:
        out = fn()
    return out, sorted(mode.seen)


@case("gemm")
def no_rank_holds_a_whole_operand(c):
    a, b = _dvm(c.inp("g64x48")), _dvm(c.inp("g48x56"))
    small = _dvm(c.inp("g4x48"))
    ablk = _blk(c.inp("g64x48"))
    arms = {
        "summa": lambda: a.multiply(b, mode="summa"),
        "cannon_square_submesh": lambda: a.multiply(b, mode="cannon",
                                                    parallelism=4),
        "grid_2x2x2": lambda: a.multiply(b, mode=(2, 2, 2)),
        "left_broadcast": lambda: small.multiply(
            b, broadcast_threshold_mb=small.elements_count() * 8e-6 + 1e-9),
        "row_to_block": lambda: a.to_block_matrix(),
        "block_to_row": lambda: ablk.to_dense_vec_matrix(),
        "transpose": lambda: a.transpose(),
        "block_transpose": lambda: ablk.transpose(),
    }
    out = {}
    for name, fn in arms.items():
        got, shapes = _tensor_shapes(fn)
        out[name] = {"shapes": shapes, "value": _np(got)
                     if got.holds else None}
    return out


# -- sparse x dense: the lifted refusals of tests/test_torch_sparse.py -------

def _sp(c):
    from marlin_tpu_torch.matrix import SparseVecMatrix

    return SparseVecMatrix.from_dense_array(c.inp("S1"), device="cpu")


def _cm():
    from marlin_tpu_torch.matrix import CoordinateMatrix

    return CoordinateMatrix([0, 1], [1, 0], [2.5, 3.5], device="cpu")


@case("sparse_dense")
def multiply_by_dense(c):
    from marlin_tpu_torch.matrix import DenseVecMatrix

    out = _sp(c).multiply(DenseVecMatrix(c.inp("D43")))
    return {"type": type(out).__name__, "value": out.to_numpy()}


@case("sparse_dense")
def sparse_to_dense_vec_matrix(c):
    out = _sp(c).to_dense_vec_matrix()
    return {"type": type(out).__name__, "value": out.to_numpy()}


@case("sparse_dense")
def from_dense(c):
    from marlin_tpu_torch.matrix import DenseVecMatrix, SparseVecMatrix

    sp = SparseVecMatrix.from_dense(DenseVecMatrix(c.inp("S1")))
    return {"value": sp.to_numpy(), "mesh_size": sp.mesh.size}


@case("sparse_dense")
def coo_to_dense_vec_matrix(c):
    out = _cm().to_dense_vec_matrix()
    return {"type": type(out).__name__, "value": out.to_numpy()}


@case("sparse_dense")
def from_dense_array_mesh(c):
    from marlin_tpu_torch import mesh as pm
    from marlin_tpu_torch.matrix import SparseVecMatrix

    sp = SparseVecMatrix.from_dense_array(c.inp("S1"),
                                          mesh=pm.default_mesh())
    return {"value": sp.to_numpy(), "device": str(sp.device),
            "dense": sp.to_dense_vec_matrix().to_numpy()}


@case("sparse_dense")
def from_coo_mesh(c):
    from marlin_tpu_torch import mesh as pm
    from marlin_tpu_torch.matrix import SparseVecMatrix

    sp = SparseVecMatrix.from_coo([0, 1], [1, 0], [2.5, 3.5], (2, 3),
                                  mesh=pm.default_mesh())
    return {"value": sp.to_numpy(), "device": str(sp.device)}


@case("sparse_dense")
def coordinate_matrix_mesh(c):
    from marlin_tpu_torch import mesh as pm
    from marlin_tpu_torch.matrix import CoordinateMatrix

    cm = CoordinateMatrix([0, 2], [1, 0], [2.5, 3.5],
                          mesh=pm.default_mesh())
    return {"value": cm.to_dense_vec_matrix().to_numpy(),
            "device": str(cm.device)}


@case("sparse_dense")
def to_sparse_vec_matrix_mesh(c):
    from marlin_tpu_torch import mesh as pm

    sp = _cm().to_sparse_vec_matrix(mesh=pm.default_mesh())
    return {"value": sp.to_numpy(), "mesh_size": sp.mesh.size}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
