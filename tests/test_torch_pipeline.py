"""The port's GPipe engine (marlin_tpu_torch/parallel/pipeline.py) against
the JAX package's, the twin of tests/test_pipeline.py.

The same seeded f64 numpy inputs go to the JAX function on the 8-device
CPU mesh and to the port on ``("cpu",) * 8`` shards, each held to the
sequential oracle and to the other within 1e-10 (summation order only);
the gradients through the schedule against ``jax.grad`` through the JAX
package's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marlin_tpu.parallel.pipeline import gpipe as j_gpipe
from marlin_tpu_torch.parallel import set_default_shards
from marlin_tpu_torch.parallel.pipeline import gpipe

F64 = dict(rtol=1e-10, atol=1e-10)
N_STAGES = 8


@pytest.fixture(autouse=True, scope="module")
def _cpu_shards():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    set_default_shards(("cpu",) * N_STAGES)
    yield
    set_default_shards(None)
    torch.set_num_threads(n)


def _mlp_stage_j(params, x):
    w, b = params
    return jnp.tanh(x @ w + b[None, :])


def _mlp_stage(params, x):
    w, b = params
    return torch.tanh(x @ w + b[None, :])


def _inputs(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) * scale for s in shapes]


class TestGPipe:
    def test_matches_sequential_oracle(self):
        batch, d = 32, 16
        ws, bs, x = _inputs(0, (N_STAGES, d, d), (N_STAGES, d), (batch, d))
        ws, bs = ws * 0.3, bs * 0.1
        got = gpipe(_mlp_stage, (torch.as_tensor(ws), torch.as_tensor(bs)),
                    torch.as_tensor(x)).numpy()
        ref = x.copy()
        for i in range(N_STAGES):
            ref = np.tanh(ref @ ws[i] + bs[i][None, :])
        np.testing.assert_allclose(got, ref, **F64)
        np.testing.assert_allclose(got, np.asarray(j_gpipe(
            _mlp_stage_j, (jnp.asarray(ws), jnp.asarray(bs)),
            jnp.asarray(x))), **F64)

    def test_microbatch_count_independent(self):
        d = 8
        ws, x = _inputs(1, (N_STAGES, d, d), (24, d))
        ws = torch.as_tensor(ws * 0.2)
        out = {m: gpipe(lambda w, xx: xx @ w, ws, torch.as_tensor(x),
                        n_microbatches=m).numpy() for m in (2, 12)}
        np.testing.assert_allclose(out[2], out[12], rtol=1e-12)
        ref = np.asarray(j_gpipe(lambda w, xx: xx @ w,
                                 jnp.asarray(ws.numpy()), jnp.asarray(x),
                                 n_microbatches=12))
        np.testing.assert_allclose(out[12], ref, **F64)

    def test_stage_params_stay_sharded(self):
        # Stage i's slice lives on shard i (here all on the CPU), and the
        # output comes back whole, on x's device.
        d = 8
        ws, x = _inputs(2, (N_STAGES, d, d), (N_STAGES * 2, d))
        seen = []

        def stage(w, xx):
            seen.append((tuple(w.shape), w.device.type))
            return xx @ w

        out = gpipe(stage, torch.as_tensor(ws), torch.as_tensor(x))
        assert out.shape == x.shape and out.device.type == "cpu"
        assert set(seen) == {((d, d), "cpu")}
        assert len(seen) == N_STAGES * N_STAGES  # M x P stage calls
        assert j_gpipe(lambda w, xx: xx @ w, jnp.asarray(ws),
                       jnp.asarray(x)).shape == x.shape

    def test_bad_leading_axis_raises(self):
        d = 8
        (ws,) = _inputs(3, (3, d, d))  # != n_stages
        with pytest.raises(ValueError, match="leading axis"):
            gpipe(lambda w, xx: xx @ w, torch.as_tensor(ws),
                  torch.zeros((8, d), dtype=torch.float64))
        with pytest.raises(ValueError, match="leading axis"):
            j_gpipe(lambda w, xx: xx @ w, jnp.asarray(ws), jnp.zeros((8, d)))

    def test_indivisible_batch_raises(self):
        d = 4
        (ws,) = _inputs(4, (N_STAGES, d, d))
        with pytest.raises(ValueError, match="microbatches"):
            gpipe(lambda w, xx: xx @ w, torch.as_tensor(ws),
                  torch.zeros((9, d), dtype=torch.float64), n_microbatches=8)
        with pytest.raises(ValueError, match="microbatches"):
            j_gpipe(lambda w, xx: xx @ w, jnp.asarray(ws), jnp.zeros((9, d)),
                    n_microbatches=8)


class TestGPipeTraining:
    def test_gradients_match_sequential(self):
        # Autograd through the schedule and the hops: the port's gradient
        # against its sequential model's and against jax.grad through the
        # JAX package's pipeline.
        d = 6
        ws, x = _inputs(5, (N_STAGES, d, d), (2 * N_STAGES, d))
        ws = ws * 0.3

        def loss_pipe(w):
            return (gpipe(lambda wi, xx: torch.tanh(xx @ wi), w,
                          torch.as_tensor(x)) ** 2).sum()

        def loss_seq(w):
            y = torch.as_tensor(x)
            for i in range(N_STAGES):
                y = torch.tanh(y @ w[i])
            return (y ** 2).sum()

        grads = []
        for fn in (loss_pipe, loss_seq):
            w = torch.as_tensor(ws).requires_grad_(True)
            fn(w).backward()
            grads.append(w.grad.numpy())
        np.testing.assert_allclose(grads[0], grads[1], rtol=1e-9,
                                   atol=1e-12)

        def j_loss(w):
            return jnp.sum(j_gpipe(lambda wi, xx: jnp.tanh(xx @ wi), w,
                                   jnp.asarray(x)) ** 2)

        gj = np.asarray(jax.jit(jax.grad(j_loss))(jnp.asarray(ws)))
        np.testing.assert_allclose(grads[0], gj, **F64)
