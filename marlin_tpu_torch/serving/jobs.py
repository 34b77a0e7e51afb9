"""Matrix-ops-as-a-service: port of ``marlin_tpu/serving/jobs.py``, the
paper's dense operations (GEMM, LU, Cholesky, SVD, SpMM, inverse) as
priced jobs on the serving driver thread, beside LLM traffic.

* A client POSTs ``/v1/matrix`` (serving/server.py) with ``op``,
  ``shapes``, ``dtype`` and a seed or a payload; :func:`validate_job`
  rejects a malformed job with a typed :class:`MatrixJobError` (a
  machine-readable ``code`` and a ``detail`` dict: the structured 400), so
  no job reaches the driver unpriced.
* Admission prices the job with ``utils/cost_model`` into round budgets:
  model units, the executor's quantum count and, once the
  ``CostCalibration`` ledger has measured seconds a unit for the op class
  (keys ``matrix_<op>_<dtype>``), a predicted wall clock.
* The frontend's driver runs the job in bounded quanta (a GEMM row panel,
  an LU panel, an SpMM chunk of COO entries, or one library call): one
  slice between decode rounds under LLM load, a larger one when the engine
  is idle.
* Progress streams as ``phase`` / ``quantum`` / ``progress`` events over
  the SSE framing of token streams; results return as dtype-tagged npz
  payloads under the serving stack's npz rules (``pages._SAVEZ_NATIVE``):
  bfloat16 goes as float32 with a ``__dtype_bfloat16`` tag, int8 results
  carry their float32 scale siblings. A payload decodes with the JAX
  package's ``tools/serving_client.py`` unchanged.

Byte-exactness within the port: every executor is a host loop over
deterministic steps on one device, and :func:`matrix_compute` runs the
same loop synchronously, so an HTTP result is the in-process call's bytes
by construction; inputs are a pure function of ``(op, shapes, dtype,
seed)``, so a job replayed after an engine crash gives the same bytes.
Against a whole-matrix product, or against the JAX package, only a
tolerance holds: a cuBLAS row's bits depend on the row count.

The device: an executor's tensors live on the service's ``device``, the
engine's (``serve`` passes it). GEMM panels run ``torch.matmul`` there;
LU runs ``linalg/lu._lu_panel_step``, the step ``lu_factor_array(a,
mode="dist", base_size=base)`` loops over, one a quantum; Cholesky,
inverse and SVD are one call of ``cholesky_factor_array``,
``inverse(mode="local")`` and ``linalg/svd.compute_svd(mode="local-svd")``
(over a one-device Gramian operand: a ``DenseVecMatrix`` would join a
process group); SpMM is the reference's host ``np.add.at`` loop. The
reference's float64 gate (jax's x64 switch) has no counterpart: torch
always has float64.

Threading mirrors the frontend: handler threads call :meth:`MatrixService.
validate` and :meth:`~MatrixService.submit`; only the driver thread calls
:meth:`~MatrixService.run_quanta` and :meth:`~MatrixService.reset_inflight`
(the results are encoded there too, so no handler thread touches a device
tensor). The job queue is guarded by ``_lock``; executor state belongs to
the driver thread.
"""

from __future__ import annotations

import dataclasses
import io
import json
import queue as _queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import linalg_precision_scope, matmul_precision_scope
from ..linalg.lu import (_lu_panel_step, _pad_identity, _Stripes,
                         lu_factor_array)
from ..matrix.base import to_host
from ..obs import metrics as obs_metrics
from ..obs.runlog import RunLog
from ..utils import cost_model as cm
from ..utils.hw import resolve_device
from . import faults
from .frontend import FrontendError, PoisonedRequest
from .pages import _SAVEZ_NATIVE
from .queue import QueueClosed, QueueFull

_EOS = object()  # closes a streaming handle's event queue

# Service-side shape bounds: a job is rejected (typed 400) before any
# array is made, so an overflow shape cannot exhaust the driver's memory.
MAX_DIM = 1 << 14        # per-dimension bound
MAX_ELEMENTS = 1 << 22   # per-operand element bound (~4M)

_OP_ARITY = {"gemm": 3, "spmm": 3, "svd": 2,
             "lu": 1, "cholesky": 1, "inverse": 1}
_FLOAT_DTYPES = ("float32", "float64")
_OP_DTYPES = {
    "gemm": ("float32", "float64", "bfloat16", "int8"),
    "spmm": _FLOAT_DTYPES,
    "lu": _FLOAT_DTYPES,
    "cholesky": _FLOAT_DTYPES,
    "svd": _FLOAT_DTYPES,
    "inverse": _FLOAT_DTYPES,
}
_ITEMSIZE = {"float32": 4, "float64": 8, "bfloat16": 2, "int8": 1}
# The npz dtype rules of the host KV tier's spill files, by name.
_NATIVE_NAMES = frozenset(str(d).replace("torch.", "")
                          for d in _SAVEZ_NATIVE)


class MatrixJobError(ValueError):
    """A malformed matrix job, rejected at validation or pricing, before
    the driver thread (the typed 400). ``code`` is the machine-readable
    class (``unknown_op`` / ``bad_shape`` / ``shape_overflow`` /
    ``bad_dtype`` / ``payload_mismatch`` / ``bad_inputs`` /
    ``bad_knob``); ``detail`` carries the offending values."""

    def __init__(self, code: str, message: str,
                 detail: Optional[dict] = None):
        super().__init__(message)
        self.code = code
        self.detail = detail or {}


@dataclasses.dataclass(frozen=True)
class MatrixJobSpec:
    """One validated matrix job: everything execution needs. Frozen: a
    replay after a crash rebuilds the executor from this spec and the
    seed."""

    op: str
    shapes: Tuple[int, ...]
    dtype: str
    seed: Optional[int]
    # Validated payload operands (payload jobs); None on seed jobs. A
    # bfloat16 operand is a torch.bfloat16 CPU tensor (numpy has no
    # bfloat16), every other one a numpy array.
    payload: Optional[Dict[str, object]]
    panel: int = 32       # gemm row-panel height
    base: int = 16        # LU panel width (linalg/lu.py base_size)
    nnz_chunk: int = 4096  # spmm COO chunk
    density: float = 0.05  # spmm seed-path density
    k: int = 4            # svd singular values


def _bf16_from_f64(x) -> torch.Tensor:
    """float64 values as bfloat16, as a CPU tensor, rounded as the
    reference's ml_dtypes cast rounds them: to float32 first, then to
    nearest even in bfloat16 (NaN stays a quiet NaN)."""
    with np.errstate(over="ignore"):  # past float32's range: inf
        f = np.ascontiguousarray(
            np.asarray(x, np.float64).astype(np.float32))
    u = f.view(np.uint32)
    u = u + (np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))
    bits = (u >> np.uint32(16)).astype(np.uint16)
    bits = np.where(np.isnan(f), np.uint16(0x7FC0), bits).astype(np.uint16)
    return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)


def _cast_operand(value, dt: str):
    """A payload operand as ``dt``: a numpy array, or for bfloat16 a
    torch.bfloat16 tensor rounded as the reference's cast rounds."""
    if dt == "bfloat16":
        return _bf16_from_f64(np.asarray(value, np.float64))
    return np.asarray(value, dtype=np.dtype(dt))


def _expected_operands(spec_op: str, shapes: Tuple[int, ...],
                       dtype: str, nnz: Optional[int] = None
                       ) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """name -> (shape, dtype name) of the operands a job consumes: the
    payload contract and the seed generator's output schema."""
    if spec_op == "gemm":
        m, k, n = shapes
        ops = {"a": ((m, k), dtype), "b": ((k, n), dtype)}
        if dtype == "int8":
            ops["a_scale"] = ((m,), "float32")
            ops["b_scale"] = ((n,), "float32")
        return ops
    if spec_op == "spmm":
        m, k, n = shapes
        nz = int(nnz) if nnz is not None else 0
        return {"a_rows": ((nz,), "int64"), "a_cols": ((nz,), "int64"),
                "a_vals": ((nz,), dtype), "b": ((k, n), dtype)}
    if spec_op == "svd":
        m, n = shapes
        return {"a": ((m, n), dtype)}
    (n,) = shapes
    return {"a": ((n, n), dtype)}


def validate_job(body: dict) -> MatrixJobSpec:
    """Validate and normalize one ``POST /v1/matrix`` body into a
    :class:`MatrixJobSpec`, raising :class:`MatrixJobError` (the typed
    400) on anything malformed. Every rejection happens here, on the
    handler thread. A float64 job needs no switch: torch always has
    float64 (the reference rejects one without jax's x64)."""
    op = body.get("op")
    if not isinstance(op, str) or op not in cm.MATRIX_JOB_OPS:
        raise MatrixJobError(
            "unknown_op", f"unknown op {op!r}; ops: "
            f"{', '.join(cm.MATRIX_JOB_OPS)}", {"op": op})
    raw_shapes = body.get("shapes")
    if not isinstance(raw_shapes, (list, tuple)) or not raw_shapes:
        raise MatrixJobError("bad_shape", "shapes must be a non-empty "
                             "list of positive ints",
                             {"shapes": raw_shapes})
    try:
        shapes = tuple(int(s) for s in raw_shapes)
    except (TypeError, ValueError):
        raise MatrixJobError("bad_shape", f"non-integer shape entry in "
                             f"{raw_shapes!r}", {"shapes": raw_shapes})
    arity = _OP_ARITY[op]
    if len(shapes) != arity:
        raise MatrixJobError(
            "bad_shape", f"op {op!r} takes {arity} shape entr"
            f"{'y' if arity == 1 else 'ies'} "
            f"({_shape_doc(op)}), got {len(shapes)}",
            {"op": op, "shapes": list(shapes)})
    if any(s <= 0 for s in shapes):
        raise MatrixJobError("bad_shape", f"non-positive dimension in "
                             f"{list(shapes)}", {"shapes": list(shapes)})
    if any(s > MAX_DIM for s in shapes) or _max_elements(op, shapes) \
            > MAX_ELEMENTS:
        raise MatrixJobError(
            "shape_overflow",
            f"shapes {list(shapes)} exceed the service bound "
            f"(max dim {MAX_DIM}, max operand elements {MAX_ELEMENTS})",
            {"shapes": list(shapes), "max_dim": MAX_DIM,
             "max_elements": MAX_ELEMENTS})
    dtype = body.get("dtype", "float32")
    if dtype not in _OP_DTYPES[op]:
        raise MatrixJobError(
            "bad_dtype", f"op {op!r} does not support dtype {dtype!r} "
            f"(supported: {', '.join(_OP_DTYPES[op])})",
            {"op": op, "dtype": dtype})
    knobs = {}
    for name, default, lo in (("panel", 32, 1), ("base", 16, 1),
                              ("nnz_chunk", 4096, 1), ("k", 4, 1)):
        val = body.get(name, default)
        try:
            val = int(val)
        except (TypeError, ValueError):
            raise MatrixJobError("bad_knob", f"{name} must be an int, "
                                 f"got {val!r}", {name: val})
        if val < lo:
            raise MatrixJobError("bad_knob", f"{name} must be >= {lo}, "
                                 f"got {val}", {name: val})
        knobs[name] = val
    density = body.get("density", 0.05)
    try:
        density = float(density)
    except (TypeError, ValueError):
        raise MatrixJobError("bad_knob", f"density must be a float, "
                             f"got {density!r}", {"density": density})
    if not 0.0 < density <= 1.0:
        raise MatrixJobError("bad_knob", f"density must be in (0, 1], "
                             f"got {density}", {"density": density})
    knobs["density"] = density
    if op == "svd" and knobs["k"] > min(shapes):
        raise MatrixJobError(
            "bad_knob", f"svd k={knobs['k']} exceeds min(shapes)="
            f"{min(shapes)}", {"k": knobs["k"], "shapes": list(shapes)})
    payload = body.get("payload")
    seed: Optional[int] = None
    if payload is None:
        try:
            seed = int(body.get("seed", 0))
        except (TypeError, ValueError):
            raise MatrixJobError("bad_inputs", f"seed must be an int, "
                                 f"got {body.get('seed')!r}",
                                 {"seed": body.get("seed")})
        return MatrixJobSpec(op=op, shapes=shapes, dtype=dtype,
                             seed=seed, payload=None, **knobs)
    if body.get("seed") is not None:
        raise MatrixJobError(
            "bad_inputs", "pass seed OR payload, not both (a payload "
            "job's replay identity is the payload itself)", {})
    if not isinstance(payload, dict):
        raise MatrixJobError("payload_mismatch", "payload must be an "
                             "object of named operand arrays", {})
    nnz = None
    if op == "spmm":
        vals = payload.get("a_vals")
        nnz = len(vals) if isinstance(vals, (list, tuple)) else None
        if nnz is None or nnz < 1 or nnz > MAX_ELEMENTS:
            raise MatrixJobError(
                "payload_mismatch", "spmm payload needs a non-empty "
                "a_vals list (COO values, bounded by the element cap)",
                {"nnz": nnz, "max_elements": MAX_ELEMENTS})
    expected = _expected_operands(op, shapes, dtype, nnz=nnz)
    if set(payload) != set(expected):
        raise MatrixJobError(
            "payload_mismatch",
            f"op {op!r} ({dtype}) payload needs exactly "
            f"{sorted(expected)}, got {sorted(payload)}",
            {"expected": sorted(expected), "got": sorted(payload)})
    arrays: Dict[str, object] = {}
    for name, (shape, dt) in expected.items():
        try:
            arr = _cast_operand(payload[name], dt)
        except (TypeError, ValueError, OverflowError) as e:
            raise MatrixJobError(
                "payload_mismatch",
                f"payload operand {name!r} is not castable to {dt}: "
                f"{e}", {"operand": name, "dtype": dt})
        if tuple(arr.shape) != shape:
            raise MatrixJobError(
                "payload_mismatch",
                f"payload operand {name!r} has shape "
                f"{list(arr.shape)}, job shapes imply {list(shape)}",
                {"operand": name, "got": list(arr.shape),
                 "expected": list(shape)})
        arrays[name] = arr
    if op == "spmm":
        m, k, _ = shapes
        if (arrays["a_rows"] < 0).any() or (arrays["a_rows"] >= m).any() \
                or (arrays["a_cols"] < 0).any() \
                or (arrays["a_cols"] >= k).any():
            raise MatrixJobError(
                "payload_mismatch", "spmm COO indices out of bounds for "
                f"A({m}, {k})", {"m": m, "k": k})
    return MatrixJobSpec(op=op, shapes=shapes, dtype=dtype, seed=None,
                         payload=arrays, **knobs)


def _shape_doc(op: str) -> str:
    return {"gemm": "[m, k, n]", "spmm": "[m, k, n]", "svd": "[m, n]",
            "lu": "[n]", "cholesky": "[n]", "inverse": "[n]"}[op]


def _max_elements(op: str, shapes: Tuple[int, ...]) -> int:
    if op in ("gemm", "spmm"):
        m, k, n = shapes
        return max(m * k, k * n, m * n)
    if op == "svd":
        m, n = shapes
        return m * n
    (n,) = shapes
    return n * n


# -- deterministic inputs ----------------------------------------------------


def generate_inputs(spec: MatrixJobSpec) -> Dict[str, object]:
    """A job's operands: the payload as it is, or (seed jobs) a pure numpy
    function of ``(op, shapes, dtype, seed)`` on a dedicated PCG stream,
    bitwise the reference's. A bfloat16 operand comes back as a
    torch.bfloat16 CPU tensor of the bits the reference's ml_dtypes cast
    gives; every other one as a numpy array."""
    if spec.payload is not None:
        return dict(spec.payload)
    rng = np.random.default_rng(
        np.random.SeedSequence([0x6D78, int(spec.seed or 0)]))

    def normal(shape):
        x = rng.standard_normal(shape, dtype=np.float64)
        return _bf16_from_f64(x) if spec.dtype == "bfloat16" \
            else x.astype(np.dtype(spec.dtype))

    if spec.op == "gemm":
        m, k, n = spec.shapes
        if spec.dtype == "int8":
            return {
                "a": rng.integers(-127, 127, size=(m, k),
                                  endpoint=True).astype(np.int8),
                "b": rng.integers(-127, 127, size=(k, n),
                                  endpoint=True).astype(np.int8),
                "a_scale": (rng.random(m) * 0.05
                            + 0.01).astype(np.float32),
                "b_scale": (rng.random(n) * 0.05
                            + 0.01).astype(np.float32),
            }
        return {"a": normal((m, k)), "b": normal((k, n))}
    dt = np.dtype(spec.dtype)
    if spec.op == "spmm":
        m, k, n = spec.shapes
        nnz = max(1, int(spec.density * m * k))
        rows = rng.integers(0, m, size=nnz)
        cols = rng.integers(0, k, size=nnz)
        vals = rng.standard_normal(nnz, dtype=np.float64).astype(dt)
        order = np.lexsort((cols, rows))  # canonical COO order
        return {"a_rows": rows[order], "a_cols": cols[order],
                "a_vals": vals[order], "b": normal((k, n))}
    if spec.op == "svd":
        return {"a": normal(spec.shapes)}
    (n,) = spec.shapes
    if spec.op == "cholesky":
        b = rng.standard_normal((n, n), dtype=np.float64)
        return {"a": ((b @ b.T) / n + np.eye(n)).astype(dt)}
    if spec.op == "inverse":
        b = rng.standard_normal((n, n), dtype=np.float64)
        return {"a": (b + n * np.eye(n)).astype(dt)}
    return {"a": normal((n, n))}  # lu


def _host(t: torch.Tensor):
    """A result tensor on the host: a numpy array, or a CPU tensor for a
    dtype numpy lacks (bfloat16)."""
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


# -- quantum executors -------------------------------------------------------
#
# Each executor is a host loop over bounded deterministic steps; the
# synchronous composition of its steps IS the in-process call
# (matrix_compute).


class _GemmExecutor:
    """Row-panel GEMM quanta: C[j0:j0 + panel] = A[j0:j0 + panel] @ B, one
    ``torch.matmul`` on the device a quantum, A zero-padded to a whole
    number of panels so every quantum has one shape. int8 jobs dequantize
    (int8 x f32 scales) into the f32 loop and requantize per output row at
    the end: the result is the int8 matrix and its float32 ``c_scale``."""

    def __init__(self, spec: MatrixJobSpec, inputs: Dict[str, object],
                 device: torch.device):
        m, k, n = spec.shapes
        self._m = m
        self._quant = spec.dtype == "int8"
        if self._quant:
            a = inputs["a"].astype(np.float32) \
                * inputs["a_scale"][:, None]
            b = inputs["b"].astype(np.float32) \
                * inputs["b_scale"][None, :]
        else:
            a, b = inputs["a"], inputs["b"]
        self.panel = min(spec.panel, m)
        mpad = -(-m // self.panel) * self.panel
        a = torch.as_tensor(a).to(device)
        if mpad != m:
            a = torch.cat([a, a.new_zeros((mpad - m, k))])
        self._a = a
        self._b = torch.as_tensor(b).to(device)
        self.n_quanta = mpad // self.panel
        self._panels: List[torch.Tensor] = []

    @property
    def done(self) -> bool:
        return len(self._panels) >= self.n_quanta

    def step(self) -> None:
        j0 = len(self._panels) * self.panel
        with linalg_precision_scope():
            cp = torch.matmul(self._a[j0:j0 + self.panel], self._b)
        self._panels.append(cp.cpu())

    def result(self) -> Dict[str, object]:
        c = _host(torch.cat(self._panels)[:self._m])
        if not self._quant:
            return {"c": c}
        scale = np.maximum(np.max(np.abs(c), axis=1),
                           np.float32(1e-30)) / np.float32(127.0)
        scale = scale.astype(np.float32)
        q = np.clip(np.rint(c / scale[:, None]), -127, 127) \
            .astype(np.int8)
        return {"c": q, "c_scale": scale}


class _LuExecutor:
    """Blocked-LU panel quanta: ``lu_factor_array(a, mode="dist",
    base_size=base)``'s exact sequence on one device (the identity-padded
    copy, an arange perm, one ``_lu_panel_step`` a panel under
    ``linalg_precision_scope``, sliced back), one panel a quantum, so the
    service's result is that call's bytes: it IS that call, paused between
    panels."""

    def __init__(self, spec: MatrixJobSpec, inputs: Dict[str, object],
                 device: torch.device):
        (n,) = spec.shapes
        self._n = n
        self.base = min(spec.base, n)
        a = torch.as_tensor(inputs["a"]).to(device)
        self._i = 0
        if self.base >= n:
            # lu_factor_array's own local route for base >= n: one
            # quantum, the same call.
            self._local_a: Optional[torch.Tensor] = a
            self.n_quanta = 1
            return
        self._local_a = None
        npad = -(-n // self.base) * self.base
        self._st = _Stripes(_pad_identity(a, npad), npad, 0, None)
        self._perm = np.arange(npad)
        self.n_quanta = npad // self.base

    @property
    def done(self) -> bool:
        return self._i >= self.n_quanta

    def step(self) -> None:
        if self._local_a is not None:
            packed, perm = lu_factor_array(self._local_a, mode="dist",
                                           base_size=self.base)
            self._out = {"lu": _host(packed), "perm": np.asarray(perm)}
        else:
            with linalg_precision_scope():
                _lu_panel_step(self._st, self._perm, self._i * self.base,
                               self.base)
        self._i += 1

    def result(self) -> Dict[str, object]:
        if self._local_a is not None:
            return self._out
        n = self._n
        return {"lu": _host(self._st.local[:n, :n].contiguous()),
                "perm": self._perm[:n]}


class _SpmmExecutor:
    """COO nnz-chunk quanta on the host: each quantum scatter-adds one
    chunk of A's entries into C with ``np.add.at``, in the canonical
    (row, col) order, so the chunked loop applies the one-shot call's
    additions in the same sequence. Priced with ``ell_product_cost``."""

    def __init__(self, spec: MatrixJobSpec, inputs: Dict[str, object],
                 device: torch.device):
        m, k, n = spec.shapes
        self._rows = np.asarray(inputs["a_rows"], np.int64)
        self._cols = np.asarray(inputs["a_cols"], np.int64)
        self._vals = inputs["a_vals"]
        self._b = inputs["b"]
        self._c = np.zeros((m, n), dtype=self._vals.dtype)
        self.chunk = spec.nnz_chunk
        self.n_quanta = max(1, -(-len(self._vals) // self.chunk))
        self._i = 0

    @property
    def done(self) -> bool:
        return self._i >= self.n_quanta

    def step(self) -> None:
        sl = slice(self._i * self.chunk, (self._i + 1) * self.chunk)
        np.add.at(self._c, self._rows[sl],
                  self._vals[sl, None] * self._b[self._cols[sl]])
        self._i += 1

    def result(self) -> Dict[str, object]:
        return {"c": self._c}


class _OneDevice:
    """The Gramian interface ``linalg/svd.compute_svd`` reads, over one
    tensor on one device: a one-rank ``DenseVecMatrix``'s arithmetic
    (``compute_gramian_matrix``, ``_multiply_broadcast``) without the
    process group a mesh would join."""

    class _Product:
        def __init__(self, t: torch.Tensor):
            self.logical = t

    def __init__(self, a: torch.Tensor):
        self._a = a

    @property
    def num_cols(self) -> int:
        return int(self._a.shape[1])

    def compute_gramian_matrix(self) -> np.ndarray:
        with linalg_precision_scope():
            g = torch.matmul(self._a.T, self._a)
        return to_host(g)

    def _multiply_broadcast(self, b: torch.Tensor,
                            precision: Optional[str] = None):
        b = b.to(device=self._a.device, dtype=self._a.dtype)
        with matmul_precision_scope(precision):
            return self._Product(torch.matmul(self._a, b))


class _LibraryCallExecutor:
    """Single-quantum ops (cholesky / svd / inverse): the quantum is the
    library call, still priced, budgeted and interleaved like any job."""

    n_quanta = 1

    def __init__(self, spec: MatrixJobSpec, inputs: Dict[str, object],
                 device: torch.device):
        self._spec = spec
        self._inputs = inputs
        self._device = device
        self._out: Optional[Dict[str, object]] = None

    @property
    def done(self) -> bool:
        return self._out is not None

    def step(self) -> None:
        spec = self._spec
        a = torch.as_tensor(self._inputs["a"]).to(self._device)
        if spec.op == "cholesky":
            from ..linalg.cholesky import cholesky_factor_array

            self._out = {"l": _host(cholesky_factor_array(a, mode="auto"))}
        elif spec.op == "inverse":
            from ..linalg.inverse import inverse

            self._out = {"inv": _host(inverse(a, mode="local"))}
        else:  # svd
            from ..linalg.svd import compute_svd

            res = compute_svd(_OneDevice(a), spec.k, compute_u=True,
                              mode="local-svd")
            self._out = {"s": np.asarray(res.s), "v": np.asarray(res.v),
                         **({"u": _host(res.u.logical)}
                            if res.u is not None else {})}

    def result(self) -> Dict[str, object]:
        return self._out


def build_executor(spec: MatrixJobSpec,
                   inputs: Optional[Dict[str, object]] = None,
                   device="cuda"):
    """Materialize the inputs (seed or payload) and the op's executor on
    ``device``."""
    device = resolve_device(device)
    if inputs is None:
        inputs = generate_inputs(spec)
    cls = {"gemm": _GemmExecutor, "lu": _LuExecutor,
           "spmm": _SpmmExecutor}.get(spec.op, _LibraryCallExecutor)
    return cls(spec, inputs, device)


def executor_quanta(spec: MatrixJobSpec) -> int:
    """The quantum count without making any array: what admission prices
    the job's units into (the executor later reports the same number)."""
    if spec.op == "gemm":
        m = spec.shapes[0]
        return -(-m // min(spec.panel, m))
    if spec.op == "lu":
        n = spec.shapes[0]
        base = min(spec.base, n)
        return 1 if base >= n else -(-n // base)
    if spec.op == "spmm":
        m, k, _ = spec.shapes
        nnz = len(spec.payload["a_vals"]) if spec.payload is not None \
            else max(1, int(spec.density * m * k))
        return max(1, -(-nnz // spec.nnz_chunk))
    return 1


def _cal_key(spec: MatrixJobSpec) -> str:
    """Calibration-ledger key, per (op, dtype): int8 gemm dequantizes
    into an f32 loop and bfloat16 runs another product, so one ``matrix_
    <op>`` EWMA would swing between dtypes."""
    return f"matrix_{spec.op}_{spec.dtype}"


def matrix_compute(body: dict, device="cuda") -> Dict[str, object]:
    """The in-process call: validate the body the HTTP endpoint takes and
    run the same executor loop synchronously on ``device``. Within the
    port, ``decode_result(http_bytes)`` is this call's result array for
    array, bit for bit."""
    spec = validate_job(dict(body))
    ex = build_executor(spec, device=device)
    while not ex.done:
        ex.step()
    return ex.result()


# -- the result wire format --------------------------------------------------


def encode_result(arrays: Dict[str, object], meta: dict) -> bytes:
    """Dtype-tagged npz payload: native dtypes as they are; another one
    (bfloat16, a numpy array or a torch tensor) as float32, which holds
    each of its values exactly, with a ``__dtype_<name>`` tag so a decoder
    casts back. ``__meta`` rides in the same npz as a JSON string."""
    data: Dict[str, np.ndarray] = {}
    for name, arr in arrays.items():
        if isinstance(arr, torch.Tensor):
            dt = str(arr.dtype).replace("torch.", "")
            arr = to_host(arr)
        else:
            arr = np.asarray(arr)
            dt = arr.dtype.name
        if dt not in _NATIVE_NAMES:
            data["__dtype_" + name] = np.array(dt)
            arr = np.asarray(arr, np.float32)
        data[name] = arr
    data["__meta"] = np.array(json.dumps(meta))
    buf = io.BytesIO()
    np.savez(buf, **data)
    return buf.getvalue()


def decode_result(payload: bytes) -> Tuple[Dict[str, object], dict]:
    """Inverse of :func:`encode_result`: (arrays, meta). A tagged
    bfloat16 array comes back as a torch.bfloat16 tensor (numpy has no
    bfloat16; the cast from float32 is exact), another tag as that numpy
    dtype."""
    arrays: Dict[str, object] = {}
    tags: Dict[str, str] = {}
    meta: dict = {}
    with np.load(io.BytesIO(payload)) as z:
        for name in z.files:
            if name == "__meta":
                meta = json.loads(str(z[name][()]))
            elif name.startswith("__dtype_"):
                tags[name[len("__dtype_"):]] = str(z[name][()])
            else:
                arrays[name] = z[name]
    for name, dt in tags.items():
        if dt == "bfloat16":
            arrays[name] = torch.from_numpy(arrays[name]).to(torch.bfloat16)
        else:
            arrays[name] = np.asarray(arrays[name], np.dtype(dt))
    return arrays, meta


# -- the service -------------------------------------------------------------


class MatrixJobHandle:
    """One job's handle, mirroring the frontend's ``FrontendRequest``:
    handler threads block on :meth:`result` or iterate :meth:`events`;
    the driver pushes through ``_push_event`` / ``_complete`` /
    ``_fail``."""

    def __init__(self, job_id: int, stream: bool, submit_time: float):
        self.job_id = job_id
        self.stream = stream
        self.submit_time = submit_time
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.result_bytes: Optional[bytes] = None
        self.meta: Optional[dict] = None
        self.abandoned = False  # SSE client hung up; the job still runs
        self._events: Optional[_queue.Queue] = \
            _queue.Queue() if stream else None

    def _raise_error(self):
        if isinstance(self.error, FrontendError):
            raise self.error
        raise FrontendError(f"driver thread failed serving matrix job "
                            f"{self.job_id}") from self.error

    def result(self, timeout: Optional[float] = None
               ) -> Tuple[bytes, dict]:
        """Block until the job finishes; returns ``(npz bytes, meta)``.
        Raises :class:`PoisonedRequest` / :class:`FrontendError` when the
        driver gave that verdict, ``TimeoutError`` after ``timeout``."""
        if not self.done.wait(timeout):
            raise TimeoutError(
                f"matrix job {self.job_id} not done after {timeout}s")
        if self.error is not None:
            self._raise_error()
        return self.result_bytes, self.meta

    def events(self, timeout: Optional[float] = None):
        """Yield progress events (dicts) in execution order, ending at
        completion; raises the handle's failure mid-iteration, and
        ``TimeoutError`` when no event comes within ``timeout``."""
        if self._events is None:
            raise ValueError("not a streaming job")
        while True:
            try:
                ev = self._events.get(timeout=timeout)
            except _queue.Empty:
                raise TimeoutError(
                    f"matrix job {self.job_id}: no event within "
                    f"{timeout}s") from None
            if ev is _EOS:
                if self.error is not None:
                    self._raise_error()
                return
            yield ev

    # -- driver-thread side ------------------------------------------------

    def _push_event(self, ev: dict) -> None:
        if self._events is not None and not self.abandoned:
            self._events.put(ev)

    def _complete(self, payload: bytes, meta: dict) -> None:
        self.result_bytes = payload
        self.meta = meta
        if self._events is not None:
            self._events.put(_EOS)
        self.done.set()

    def _fail(self, err: BaseException) -> None:
        self.error = err
        if self._events is not None:
            self._events.put(_EOS)
        self.done.set()


class _Job:
    """Driver-side job record: ``executor``, ``quanta_done`` and the
    timing belong to the driver thread; the queue around it is guarded
    by the service lock."""

    __slots__ = ("spec", "handle", "job_id", "budget", "executor",
                 "quanta_done", "crash_count", "t_exec0")

    def __init__(self, spec: MatrixJobSpec, handle: MatrixJobHandle,
                 budget: dict):
        self.spec = spec
        self.handle = handle
        self.job_id = handle.job_id
        self.budget = budget
        self.executor = None
        self.quanta_done = 0
        self.crash_count = 0
        self.t_exec0: Optional[float] = None


class MatrixService:
    """The job queue and quantum scheduler the frontend driver runs
    matrix work through (module docstring), its executors on ``device``
    (the engine's; ``EngineFrontend`` refuses another).

    ``round_budget_s`` is the mixed-traffic slice: under LLM load the
    driver grants one slice of quanta between decode rounds; idle, it
    grants ``idle_budget_s`` worth. A job in flight across
    ``poison_after`` consecutive engine crashes is quarantined with
    :class:`PoisonedRequest`; any other crash replays the job from its
    seed."""

    def __init__(self, metrics=None, runlog=None, calibration=None,
                 max_pending: int = 8, round_budget_s: float = 0.010,
                 idle_budget_s: float = 0.050, poison_after: int = 2,
                 device="cuda"):
        if max_pending < 1:
            raise ValueError(
                f"max_pending must be >= 1, got {max_pending}")
        if poison_after < 1:
            raise ValueError(
                f"poison_after must be >= 1, got {poison_after}")
        self.device = resolve_device(device)
        self.metrics = metrics if metrics is not None \
            else obs_metrics.registry
        self.runlog = runlog if runlog is not None \
            else RunLog(maxlen=1024)
        self.calibration = calibration if calibration is not None \
            else cm.CostCalibration(registry=self.metrics)
        self.max_pending = int(max_pending)
        self.round_budget_s = float(round_budget_s)
        self.idle_budget_s = float(idle_budget_s)
        self.poison_after = int(poison_after)
        self._lock = threading.Lock()
        self._pending: deque = deque()  # guarded-by: _lock
        self._running: Optional[_Job] = None  # guarded-by: _lock
        self._next_id = 0  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        self._n_done = 0  # guarded-by: _lock
        # Every serving_matrix_* series exists from construction, so a
        # scrape sees them before the first job.
        m = self.metrics
        for op in cm.MATRIX_JOB_OPS:
            m.counter("serving_matrix_jobs_total",
                      help="matrix jobs admitted, by op", op=op)
        m.counter("serving_matrix_jobs_rejected_total",
                  help="matrix jobs rejected at validation/pricing "
                       "(the typed 400s; no job reaches the driver "
                       "unpriced)")
        m.counter("serving_matrix_jobs_poisoned_total",
                  help="matrix jobs quarantined after poison_after "
                       "consecutive engine crashes")
        m.counter("serving_matrix_quanta_total",
                  help="bounded matrix work quanta executed by the "
                       "driver thread")
        m.counter("serving_matrix_result_bytes_total",
                  help="npz result bytes encoded for delivery")
        m.gauge("serving_matrix_queue_depth",
                help="matrix jobs queued + running")
        m.histogram("serving_matrix_job_seconds",
                    help="per-job execute wall clock, submit-priced "
                         "into round budgets")
        m.histogram("serving_matrix_quantum_seconds",
                    help="per-quantum wall clock — the interleave "
                         "slice decode SLOs ride on")
        m.histogram("serving_matrix_budget_rel_err",
                    buckets=(0.05, 0.1, 0.15, 0.2, 0.25, 0.5, 1.0,
                             2.5, 10.0),
                    help="|predicted - measured| / measured of the "
                         "cost-model round-budget prediction "
                         "(calibrated jobs only)")

    # -- handler-thread surface --------------------------------------------

    def validate(self, body: dict) -> MatrixJobSpec:
        """:func:`validate_job` and the rejection counter: the form the
        HTTP handler calls, so every typed 400 is counted."""
        try:
            return validate_job(body)
        except MatrixJobError:
            self.metrics.counter(
                "serving_matrix_jobs_rejected_total").inc()
            raise

    def submit(self, spec: MatrixJobSpec,
               stream: bool = False) -> MatrixJobHandle:
        """Thread-safe submit of a validated spec: price it into round
        budgets (cost-model units x the ledger's sec/unit) and queue it
        for the driver. ``QueueFull`` / ``QueueClosed`` propagate (the
        429 / 503)."""
        units, _bytes = cm.matrix_job_cost(
            spec.op, spec.shapes, itemsize=_ITEMSIZE[spec.dtype],
            density=spec.density, k_singular=spec.k)
        budget = cm.matrix_round_budget(
            units, executor_quanta(spec),
            self.calibration.sec_per_unit(_cal_key(spec)),
            self.round_budget_s)
        with self._lock:
            if self._closed:
                raise QueueClosed(
                    "matrix service draining; job refused")
            depth = len(self._pending) + (1 if self._running else 0)
            if depth >= self.max_pending:
                raise QueueFull(
                    f"matrix queue full ({depth}/{self.max_pending})")
            job_id = self._next_id
            self._next_id += 1
            handle = MatrixJobHandle(job_id, stream=stream,
                                     submit_time=time.perf_counter())
            self._pending.append(_Job(spec, handle, budget))
            self.metrics.gauge("serving_matrix_queue_depth").set(
                len(self._pending) + (1 if self._running else 0))
        self.metrics.counter("serving_matrix_jobs_total",
                             op=spec.op).inc()
        self.runlog.emit(
            "job_submit", job_id=job_id, op=spec.op,
            shapes=list(spec.shapes), dtype=spec.dtype,
            units=round(budget["units"], 1),
            n_quanta=budget["n_quanta"],
            quanta_per_round=budget["quanta_per_round"],
            predicted_rounds=budget["predicted_rounds"],
            **({"predicted_s": round(budget["predicted_s"], 6)}
               if budget["predicted_s"] is not None else {}))
        handle._push_event({"phase": "queued", "job_id": job_id,
                            "op": spec.op,
                            "n_quanta": budget["n_quanta"]})
        return handle

    def abandon_stream(self, handle: MatrixJobHandle) -> None:
        """The SSE client hung up: stop feeding its event queue; the job
        still runs to completion. Idempotent."""
        handle.abandoned = True

    # -- shared views ------------------------------------------------------

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._pending or self._running is not None)

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._closed

    def close(self) -> None:
        """Stop admissions (drain): new submits raise QueueClosed; queued
        and running jobs still run to completion."""
        with self._lock:
            self._closed = True

    def summary(self) -> dict:
        """The service's state now, for ``GET /debug/engine``."""
        with self._lock:
            running = None
            if self._running is not None:
                j = self._running
                running = {"job_id": j.job_id, "op": j.spec.op,
                           "quanta_done": j.quanta_done,
                           "n_quanta": j.budget["n_quanta"],
                           "crash_count": j.crash_count}
            out = {"pending": len(self._pending), "running": running,
                   "jobs_done": self._n_done, "closed": self._closed}
        out["calibration"] = {
            op: st for op, st in self.calibration.summary().items()
            if op.startswith("matrix_")}
        return out

    # -- driver-thread surface ---------------------------------------------

    def quanta_budget(self, idle: bool) -> int:
        """How many quanta the current slice may run: the running (or
        next) job's calibrated seconds a quantum against the round or idle
        budget; 1 while the ledger is cold."""
        budget_s = self.idle_budget_s if idle else self.round_budget_s
        with self._lock:
            job = self._running or (self._pending[0] if self._pending
                                    else None)
        if job is None:
            return 0
        spu = self.calibration.sec_per_unit(_cal_key(job.spec))
        b = cm.matrix_round_budget(job.budget["units"],
                                   job.budget["n_quanta"], spu, budget_s)
        return b["quanta_per_round"]

    def run_quanta(self, max_quanta: int, round_idx: int = 0) -> int:
        """Run up to ``max_quanta`` quanta of the current job (FIFO across
        jobs) on the calling (driver) thread; returns the count run. An
        exception, an armed ``matrix_quantum`` fault included, reaches the
        frontend's crash boundary, whose recovery replays the job from its
        seed (:meth:`reset_inflight`)."""
        executed = 0
        while executed < int(max_quanta):
            job = self._take_job()
            if job is None:
                break
            build_s = 0.0
            if job.executor is None:
                job.t_exec0 = time.perf_counter()
                job.executor = build_executor(job.spec, device=self.device)
                # Making the inputs is part of what a job costs: folded
                # into the first quantum's calibration sample.
                build_s = time.perf_counter() - job.t_exec0
                self.runlog.emit("job_phase", job_id=job.job_id,
                                 phase="execute", quantum=0,
                                 n_quanta=job.executor.n_quanta,
                                 round=round_idx)
                job.handle._push_event(
                    {"phase": "execute", "job_id": job.job_id,
                     "n_quanta": job.executor.n_quanta})
            faults.check("matrix_quantum", round_idx=round_idx,
                         request_id=job.job_id)
            t0 = time.perf_counter()
            job.executor.step()
            if self.device.type == "cuda":
                # The quantum's seconds are the device's too.
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            job.quanta_done += 1
            executed += 1
            self.calibration.record(_cal_key(job.spec),
                                    job.budget["unit_per_quantum"],
                                    dt + build_s)
            self.metrics.counter("serving_matrix_quanta_total").inc()
            self.metrics.histogram(
                "serving_matrix_quantum_seconds").observe(
                    dt, exemplar=str(job.job_id))
            job.handle._push_event(
                {"phase": "execute", "job_id": job.job_id,
                 "quantum": job.quanta_done,
                 "n_quanta": job.executor.n_quanta,
                 "progress": round(job.quanta_done
                                   / job.executor.n_quanta, 4)})
            if job.executor.done:
                self._finish_job(job, round_idx)
        return executed

    def _take_job(self) -> Optional[_Job]:
        with self._lock:
            if self._running is None and self._pending:
                self._running = self._pending.popleft()
                self.metrics.gauge("serving_matrix_queue_depth").set(
                    len(self._pending) + 1)
            return self._running

    def _finish_job(self, job: _Job, round_idx: int) -> None:
        now = time.perf_counter()
        measured_s = max(now - job.t_exec0, 1e-9)
        self.runlog.emit("job_phase", job_id=job.job_id,
                         phase="encode", quantum=job.quanta_done,
                         n_quanta=job.budget["n_quanta"],
                         round=round_idx)
        predicted_s = job.budget["predicted_s"]
        rel_err = None
        if predicted_s is not None:
            rel_err = abs(predicted_s - measured_s) / measured_s
            self.metrics.histogram(
                "serving_matrix_budget_rel_err").observe(rel_err)
        meta = {"job_id": job.job_id, "op": job.spec.op,
                "shapes": list(job.spec.shapes),
                "dtype": job.spec.dtype, "status": "done",
                "quanta": job.quanta_done,
                "units": round(job.budget["units"], 1),
                "measured_s": round(measured_s, 6),
                "predicted_s": (round(predicted_s, 6)
                                if predicted_s is not None else None),
                "budget_rel_err": (round(rel_err, 4)
                                   if rel_err is not None else None),
                "crash_count": job.crash_count}
        # Encoded here, on the driver thread: no handler thread touches
        # the executor's tensors.
        payload = encode_result(job.executor.result(), meta)
        self.metrics.counter(
            "serving_matrix_result_bytes_total").inc(len(payload))
        self.metrics.histogram("serving_matrix_job_seconds").observe(
            measured_s, exemplar=str(job.job_id))
        self.runlog.emit(
            "job_complete", job_id=job.job_id, op=job.spec.op,
            status="done", quanta=job.quanta_done,
            measured_s=round(measured_s, 6),
            result_bytes=len(payload),
            **({"predicted_s": round(predicted_s, 6),
                "budget_rel_err": round(rel_err, 4)}
               if predicted_s is not None else {}))
        job.executor = None  # its device tensors go now
        with self._lock:
            self._running = None
            self._n_done += 1
            self.metrics.gauge("serving_matrix_queue_depth").set(
                len(self._pending))
        job.handle._complete(payload, meta)

    # -- the crash boundary (EngineFrontend._recover) ----------------------

    def reset_inflight(self, exc: BaseException, now: float) -> None:
        """The driver crashed with a job mid-execution: replay it from its
        seed (its inputs are a pure function of the spec, so the replay's
        bytes are the clean run's) or, after ``poison_after`` consecutive
        crashes, quarantine it with :class:`PoisonedRequest`."""
        with self._lock:
            job = self._running
        if job is None:
            return
        job.crash_count += 1
        job.executor = None  # rebuilt from the spec at the next slice
        if job.crash_count >= self.poison_after:
            with self._lock:
                self._running = None
                self.metrics.gauge("serving_matrix_queue_depth").set(
                    len(self._pending))
            self.metrics.counter(
                "serving_matrix_jobs_poisoned_total").inc()
            self.runlog.emit(
                "job_quarantine", job_id=job.job_id,
                crash_count=job.crash_count,
                error=f"{type(exc).__name__}: {exc}")
            job.handle._fail(PoisonedRequest(
                job.job_id, job.crash_count, exc))
            return
        job.quanta_done = 0
        self.runlog.emit("job_replay", job_id=job.job_id,
                         crash_count=job.crash_count,
                         error=f"{type(exc).__name__}: {exc}")

    def abandon(self, err: BaseException) -> None:
        """The driver died for good (fail-closed or a hard stop): fail
        every queued and running handle so no waiter hangs."""
        with self._lock:
            orphans = [j.handle for j in self._pending]
            if self._running is not None:
                orphans.append(self._running.handle)
            self._pending.clear()
            self._running = None
            self.metrics.gauge("serving_matrix_queue_depth").set(0)
        for h in orphans:
            h._fail(err)
