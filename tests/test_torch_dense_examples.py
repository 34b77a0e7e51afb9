"""The port's dense examples (marlin_tpu_torch/examples: matrix_multiply,
blas1, blas3) on the CPU, all in one process of their own, which makes no
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


def test_matrix_multiply_file_io_waits_for_a6():
    with pytest.raises(NotImplementedError, match="item A6"):
        matrix_multiply.main(["--file-a", "a.txt", "--file-b", "b.txt",
                              "--device", "cpu"])
