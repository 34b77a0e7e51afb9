"""The port's dense examples (marlin_tpu_torch/examples: matrix_multiply,
blas1, blas3, matrix_lu_decompose, least_squares, logistic_regression) on
the CPU, all in one process of their own, which makes no
process group itself: the first mesh then makes a one-rank group on a
HashStore, the path a single process takes on one card. Each run prints
the JAX example's JSON line (the same keys); the values are held to the
port's own oracle, since the two packages' random generators draw
different streams."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from marlin_tpu_torch.examples import matrix_multiply

ROOT = Path(__file__).resolve().parents[1]

# (example, its arguments), each run once by the module's process.
RUNS = {
    "mm_auto": ("matrix_multiply", ["48", "40", "36", "--dtype", "float32"]),
    "mm_summa_f64": ("matrix_multiply", ["48", "40", "36", "--mode", "summa",
                                         "--dtype", "float64"]),
    "mm_cannon": ("matrix_multiply", ["48", "40", "36", "--mode", "cannon"]),
    "blas1_dist": ("blas1", ["1000", "--mode", "dist"]),
    "blas1_local": ("blas1", ["1000", "--mode", "local"]),
    "blas3": ("blas3", ["32", "24", "16", "--grid", "1", "1", "1"]),
    # The blocked LU in panels of the default 1000 columns (two panels),
    # and the one-call local route.
    "lu_dist": ("matrix_lu_decompose", ["--random", "1100", "--mode",
                                        "dist", "--check"]),
    "lu_breeze": ("matrix_lu_decompose", ["--random", "48", "--mode",
                                          "breeze", "--check"]),
    "lstsq": ("least_squares", ["7000", "16", "--rhs", "2"]),
    "lr": ("logistic_regression", ["--synthetic", "500", "5", "--iters",
                                   "50"]),
}
EXTRA = {"matrix_multiply": ["--iters", "1", "--check"]}


@pytest.fixture(scope="module")
def runs():
    code = ["import importlib, json, sys"]
    for name, (module, args) in RUNS.items():
        argv = args + EXTRA.get(module, []) + ["--device", "cpu"]
        code.append(f"importlib.import_module("
                    f"'marlin_tpu_torch.examples.{module}').main({argv!r})")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT)}
    res = subprocess.run([sys.executable, "-c", "\n".join(code)],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(x) for x in res.stdout.splitlines()
             if x.startswith("{")]
    assert len(lines) == len(RUNS)
    return dict(zip(RUNS, lines))


@pytest.mark.parametrize("run", ["mm_auto", "mm_summa_f64", "mm_cannon"])
def test_matrix_multiply(runs, run):
    out = runs[run]
    mode = RUNS[run][1][RUNS[run][1].index("--mode") + 1] \
        if "--mode" in RUNS[run][1] else "auto"
    assert {"example", "shape", "mode", "seconds", "tflops"} <= set(out)
    assert out["example"] == "MatrixMultiply"
    assert out["shape"] == [48, 40, 36] and out["mode"] == mode
    assert out["matches_oracle"] is True and out["device"] == "cpu"


def test_blas1_dist_equals_local(runs):
    d, loc = runs["blas1_dist"], runs["blas1_local"]
    assert d["example"] == loc["example"] == "BLAS1"
    # The same seeded vectors: the distributed dot and numpy's agree to
    # f32 rounding.
    np.testing.assert_allclose(d["dot"], loc["dot"], rtol=1e-5)
    assert 200 < d["dot"] < 300  # E[x y] = 1/4 for two U(0, 1)


def test_blas3_times_three_ways(runs):
    out = runs["blas3"]
    assert out["example"] == "BLAS3" and out["shape"] == [32, 24, 16]
    assert set(out["seconds"]) == {"local", "broadcast", "split"}


@pytest.mark.parametrize("run", ["lu_dist", "lu_breeze"])
def test_matrix_lu_decompose(runs, run):
    out = runs[run]
    n = int(RUNS[run][1][1])
    assert out["example"] == "MatrixLUDecompose" and out["shape"] == [n, n]
    assert {"mode", "seconds", "output"} <= set(out)
    # f32 LU with partial pivoting, held in f64: backward error of a few
    # n * eps_f32 (eps 6e-8) at most.
    assert out["reconstruction_max_err"] < 1e-4


def test_least_squares(runs):
    out = runs["lstsq"]
    assert out["example"] == "LeastSquares" and out["rows"] == 7000
    assert out["cols"] == 16 and out["mode"] == "auto"
    # Noise 0.01 over 7000 rows: the coefficients within a few 1e-4;
    # CholeskyQR2 in f32 orthogonal to a few f32 ulps.
    assert out["coef_max_err"] < 1e-2 and out["qr_orth_err"] < 1e-5


def test_logistic_regression_matches_the_jax_example(runs, capsys):
    from marlin_tpu.examples import logistic_regression as jax_lr

    out = runs["lr"]
    assert out["example"] == "LogisticRegression"
    assert out["shape"] == [500, 6] and out["iters"] == 50
    # The same numpy data: the JAX example's weights (f64) and accuracy.
    jax_lr.main(["--synthetic", "500", "5", "--iters", "50"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_allclose(out["weights_head"], want["weights_head"],
                               rtol=0, atol=2e-6)
    assert out["train_accuracy"] == want["train_accuracy"] > 0.9


@pytest.mark.parametrize("module, argv", [
    ("matrix_lu_decompose", ["a.txt", "out"]),
    ("logistic_regression", ["data.txt"])])
def test_linalg_example_file_input_waits_for_a6(module, argv):
    import importlib

    example = importlib.import_module(f"marlin_tpu_torch.examples.{module}")
    with pytest.raises(NotImplementedError, match="item A6"):
        example.main(argv + ["--device", "cpu"])


def test_matrix_multiply_file_io_waits_for_a6():
    with pytest.raises(NotImplementedError, match="item A6"):
        matrix_multiply.main(["--file-a", "a.txt", "--file-b", "b.txt",
                              "--device", "cpu"])
