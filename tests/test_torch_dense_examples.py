"""The port's dense examples (marlin_tpu_torch/examples: matrix_multiply,
blas1, blas3, matrix_lu_decompose, least_squares, logistic_regression,
neural_network) on the CPU, all in one process of their own, which makes
no process group itself: the first mesh then makes a one-rank group on a
HashStore, the path a single process takes on one card. Each run prints
the JAX example's JSON line (the same keys); the values are held to the
port's own oracle, since the two packages' random generators draw
different streams, or, where the inputs can be shared (the neural
network's weights and batches), to the JAX example's. The neural network
on two gloo ranks is a case of the "sparse_dense" suite
(tests/torch_dist_worker.py), shared with test_torch_sparse.py."""

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
# The neural network's CLI (tests/test_examples.py::test_neural_network's
# arguments; --output is added in the fixture).
NN_CLI = ["--synthetic", "256", "--d-in", "32", "--d-out", "4", "--hidden",
          "16", "--batch-size", "64", "--iterations", "30"]


def learnable(seed=0):
    """tests/test_examples.py::test_neural_network_learns's data: two
    well-separated classes of 16-dim points, (images, classes)."""
    raw = np.random.default_rng(seed).random((2048, 16))
    margin = np.abs(raw.sum(axis=1) - 8) > 0.8
    images = raw[margin][:512]
    return images, (images.sum(axis=1) > 8).astype(int)


def one_step_data():
    """Data of the one-step check: 200 samples, 32 inputs, 4 classes."""
    rng = np.random.default_rng(7)
    return rng.random((200, 32)), np.eye(4)[rng.integers(0, 4, 200)]


# Port runs of the neural network in the fixture's process, each printing
# one JSON line: the learnable mapping's accuracy, and one SGD step.
NN_CODE = """
import numpy as np
import torch
import test_torch_dense_examples as t
from marlin_tpu_torch.examples import neural_network as nn
from marlin_tpu_torch.mesh import create_mesh
mesh = create_mesh(device="cpu")
images, classes = t.learnable()
params, loss = nn.train(images, np.eye(2)[classes], hidden=16,
                        batch_size=128, iterations=300, learning_rate=2.0,
                        seed=0, mesh=mesh)
pred = nn.forward(params, torch.as_tensor(images, dtype=torch.float32))
print(json.dumps({"accuracy": float((pred.argmax(1).numpy()
                                     == classes).mean()), "loss": loss}))
images, labels = t.one_step_data()
params, loss = nn.train(images, labels, hidden=8, batch_size=64,
                        iterations=1, learning_rate=0.5, seed=4, mesh=mesh)
print(json.dumps({"loss": loss, **{k: v.tolist()
                                   for k, v in params.items()}}))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    weights = tmp_path_factory.mktemp("nn_weights") / "w"
    cli = dict(RUNS, nn_cli=("neural_network",
                             NN_CLI + ["--output", str(weights)]))
    code = ["import importlib, json, sys"]
    for name, (module, args) in cli.items():
        argv = args + EXTRA.get(module, []) + ["--device", "cpu"]
        code.append(f"importlib.import_module("
                    f"'marlin_tpu_torch.examples.{module}').main({argv!r})")
    code.append(NN_CODE)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(ROOT), str(ROOT / "tests")])}
    res = subprocess.run([sys.executable, "-c", "\n".join(code)],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(x) for x in res.stdout.splitlines()
             if x.startswith("{")]
    names = list(cli) + ["nn_learns", "nn_one_step"]
    assert len(lines) == len(names)
    return {**dict(zip(names, lines)), "nn_weights": weights}


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


# -- neural_network: the JAX example's functions on the same weights ----------

def _jax_nn_params(d_in, hidden, d_out, seed=0):
    from marlin_tpu.examples import neural_network as jnn

    return {k: np.asarray(v) for k, v in
            jnn.init_params(d_in, hidden, d_out, seed=seed).items()}


def test_neural_network_forward_and_loss_match_the_jax_example():
    import jax.numpy as jnp
    import torch

    from marlin_tpu.examples import neural_network as jnn
    from marlin_tpu_torch.examples import neural_network as nn

    params = _jax_nn_params(32, 16, 4)
    x, y = one_step_data()
    x32, y32 = x.astype(np.float32), y.astype(np.float32)
    port = nn.params_from_jax(params, device="cpu")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    np.testing.assert_allclose(
        nn.forward(port, torch.from_numpy(x32)).numpy(),
        np.asarray(jnn.forward(jp, jnp.asarray(x32))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        float(nn.loss_fn(port, torch.from_numpy(x32), torch.from_numpy(y32))),
        float(jnn.loss_fn(jp, jnp.asarray(x32), jnp.asarray(y32))),
        rtol=1e-5)


def test_neural_network_sgd_step_matches_jax_value_and_grad(runs):
    # The port's train, one step, against jax.value_and_grad of the JAX
    # example's loss_fn from the port's initial weights on the port's
    # first batch (both drawn from CPU generators, so known here).
    import jax
    import jax.numpy as jnp

    from marlin_tpu.examples import neural_network as jnn
    from marlin_tpu_torch.examples import neural_network as nn

    got = runs["nn_one_step"]
    images, labels = one_step_data()
    init = {k: jnp.asarray(v.numpy())
            for k, v in nn.init_params(32, 8, 4, seed=4, device="cpu").items()}
    idx = nn.batch_indices(len(images), 64, 1, seed=4)[0].numpy()
    x = jnp.asarray(images[idx], jnp.float32)
    y = jnp.asarray(labels[idx], jnp.float32)
    loss, grads = jax.value_and_grad(jnn.loss_fn)(init, x, y)
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    for name in ("hidden", "output"):
        want = np.asarray(init[name] - 0.5 * grads[name])
        np.testing.assert_allclose(np.asarray(got[name]), want, rtol=1e-5,
                                   atol=1e-5)


def test_neural_network_learns(runs):
    # tests/test_examples.py::test_neural_network_learns on the port.
    got = runs["nn_learns"]
    assert got["accuracy"] > 0.9, got


def test_neural_network_cli(runs):
    out = runs["nn_cli"]
    assert {"example", "samples", "hidden", "iterations", "final_loss",
            "seconds", "output"} == set(out)
    assert out["example"] == "NeuralNetwork" and out["samples"] == 256
    assert out["hidden"] == 16 and out["iterations"] == 30
    assert out["final_loss"] < 2.0
    assert (runs["nn_weights"] / "hidden.csv").exists()
    assert np.loadtxt(runs["nn_weights"] / "hidden.csv",
                      delimiter=",").shape == (32, 16)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    import torch_dist_worker

    return torch_dist_worker.shared_launch(
        "sparse_dense", 2, torch_dist_worker.sparse_dense_inputs(),
        tmp_path_factory)


def test_neural_network_on_two_ranks_equals_one(two_ranks):
    # The same index table: each rank's part of the gradient, summed by
    # one all-reduce, against one rank's whole gradient.
    got = two_ranks.get("neural_network_ranks")
    one, two = np.asarray(got["one"]), np.asarray(got["two"])
    assert one.shape == two.shape == (20,)
    np.testing.assert_allclose(two, one, rtol=1e-6, atol=0)
