"""The port's expert-parallel routing (marlin_tpu_torch/parallel/expert.py)
against the JAX package's, the twin of tests/test_expert.py.

The same seeded f64 numpy inputs go to the JAX function on the 8-device
CPU mesh and to the port on ``("cpu",) * 8`` shards, each held to the
dense top-1 oracle (capacity buckets in local order, dropped tokens
passing through) and to the other within 1e-10; the gradients against
``jax.grad`` through the JAX package's engine.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marlin_tpu.parallel.expert import expert_parallel_apply as j_apply
from marlin_tpu_torch.parallel import expert, set_default_shards
from marlin_tpu_torch.parallel.expert import expert_parallel_apply

F64 = dict(rtol=1e-10, atol=1e-12)
N_EXP = 8


@pytest.fixture(autouse=True, scope="module")
def _cpu_shards():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    set_default_shards(("cpu",) * N_EXP)
    yield
    set_default_shards(None)
    torch.set_num_threads(n)


def _linear_expert(w, x):
    return x @ w


def _oracle(ws, x, gates, cap_per_bucket, n_exp):
    """Dense reference: top-1 expert scaled by gate prob; per-(source
    shard, expert) buckets overflow to identity passthrough in local
    arrival order."""
    t, d = x.shape
    t_loc = t // n_exp
    probs = np.exp(gates - gates.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    top = gates.argmax(1)
    out = x.copy()
    for shard in range(n_exp):
        counts = np.zeros(n_exp, int)
        for tk in range(shard * t_loc, (shard + 1) * t_loc):
            e = top[tk]
            if counts[e] < cap_per_bucket:
                out[tk] = (x[tk] @ ws[e]) * probs[tk, e]
            counts[e] += 1
    return out


def _both(ws, x, gates, **kw):
    """(port, JAX) outputs of the same routing, as numpy."""
    got = expert_parallel_apply(_linear_expert, torch.as_tensor(ws),
                                torch.as_tensor(x), torch.as_tensor(gates),
                                **kw).numpy()
    ref = np.asarray(j_apply(_linear_expert, jnp.asarray(ws), jnp.asarray(x),
                             jnp.asarray(gates), **kw))
    return got, ref


class TestExpertParallel:
    def test_matches_oracle_no_drops(self):
        t, d = N_EXP * 8, 16
        rng = np.random.default_rng(0)
        ws = rng.standard_normal((N_EXP, d, d)) * 0.3
        x = rng.standard_normal((t, d))
        gates = rng.standard_normal((t, N_EXP))
        got, ref = _both(ws, x, gates, capacity_factor=float(N_EXP))
        np.testing.assert_allclose(
            got, _oracle(ws, x, gates, 10**9, N_EXP), **F64)
        np.testing.assert_allclose(got, ref, **F64)

    def test_capacity_drops_pass_through(self):
        t, d = N_EXP * 4, 8
        rng = np.random.default_rng(1)
        ws = rng.standard_normal((N_EXP, d, d))
        x = rng.standard_normal((t, d))
        gates = np.full((t, N_EXP), -10.0)
        gates[:, 0] = 10.0  # every token wants expert 0: drops
        cap = max(1, int(np.ceil(t // N_EXP * 1.0 / N_EXP)))
        got, ref = _both(ws, x, gates, capacity_factor=1.0)
        np.testing.assert_allclose(got, _oracle(ws, x, gates, cap, N_EXP),
                                   **F64)
        np.testing.assert_allclose(got, ref, **F64)
        dropped = np.all(got == x, axis=1)
        assert dropped.any()  # drops happened, and passed through bitwise
        np.testing.assert_array_equal(dropped, np.all(ref == x, axis=1))

    def test_bad_shapes_raise(self):
        d = 4
        ws = np.random.default_rng(2).standard_normal((N_EXP, d, d))
        cases = [
            ("divide", ws, (N_EXP + 1, d), (N_EXP + 1, N_EXP)),
            ("gate_logits", ws, (N_EXP * 2, d), (N_EXP * 2, N_EXP + 1)),
            ("leading axis", ws[:3], (N_EXP * 2, d), (N_EXP * 2, N_EXP)),
        ]
        for match, w, xs, gs in cases:
            with pytest.raises(ValueError, match=match):
                expert_parallel_apply(_linear_expert, torch.as_tensor(w),
                                      torch.zeros(xs, dtype=torch.float64),
                                      torch.zeros(gs, dtype=torch.float64))
            with pytest.raises(ValueError, match=match):
                j_apply(_linear_expert, jnp.asarray(w), jnp.zeros(xs),
                        jnp.zeros(gs))


class TestExpertFnContract:
    def test_expert_fn_receives_flat_token_batch(self):
        # expert_fn sees the flat (n_experts * cap, d) batch, 2-D.
        d = 4
        rng = np.random.default_rng(3)
        ws = rng.standard_normal((N_EXP, d, d))
        x = rng.standard_normal((N_EXP * 2, d))
        g = rng.standard_normal((N_EXP * 2, N_EXP))
        seen = []

        def fn(w, xx):
            seen.append(tuple(xx.shape))
            return xx @ w

        expert_parallel_apply(fn, torch.as_tensor(ws), torch.as_tensor(x),
                              torch.as_tensor(g),
                              capacity_factor=float(N_EXP))
        cap = int(np.ceil(2 * float(N_EXP) / N_EXP))
        assert seen == [(N_EXP * cap, d)] * N_EXP
        with pytest.raises(ValueError, match="preserve"):
            expert_parallel_apply(lambda w, xx: xx[:1], torch.as_tensor(ws),
                                  torch.as_tensor(x), torch.as_tensor(g))

    def test_stable_fn_reuses_compile(self):
        # The JAX package keeps the compiled program on the callable;
        # torch compiles nothing, so what is left of the contract: the
        # same result on a second call, and no state kept between calls
        # (on the callable or in the module).
        d = 4
        rng = np.random.default_rng(4)
        ws, x, g = (torch.as_tensor(a) for a in (
            rng.standard_normal((N_EXP, d, d)),
            rng.standard_normal((N_EXP * 2, d)),
            rng.standard_normal((N_EXP * 2, N_EXP))))
        before = dict(vars(expert)), dict(vars(_linear_expert))
        first = expert_parallel_apply(_linear_expert, ws, x, g)
        second = expert_parallel_apply(_linear_expert, ws, x, g)
        assert torch.equal(first, second)
        assert (dict(vars(expert)), dict(vars(_linear_expert))) == before
        ref = np.asarray(j_apply(_linear_expert, jnp.asarray(ws.numpy()),
                                 jnp.asarray(x.numpy()),
                                 jnp.asarray(g.numpy())))
        np.testing.assert_allclose(first.numpy(), ref, **F64)


class TestExpertTraining:
    def test_gradients_match_dense_oracle(self):
        # Autograd through the bucketing scatter, both all-to-alls and the
        # gate-probability scaling: grads for the expert params, the
        # tokens and the gates against the dense top-1 formulation and
        # against jax.grad through the JAX package's engine.
        d, t = 6, 3 * N_EXP
        rng = np.random.default_rng(5)
        ws = rng.standard_normal((N_EXP, d, d)) * 0.4
        x = rng.standard_normal((t, d))
        g = rng.standard_normal((t, N_EXP))

        def loss_ep(ws, x, g):
            return (expert_parallel_apply(
                _linear_expert, ws, x, g,
                capacity_factor=float(N_EXP)) ** 2).sum()

        def loss_dense(ws, x, g):
            probs = torch.softmax(g, dim=-1)
            top = torch.argmax(g, dim=-1)
            out = torch.einsum("td,tde->te", x, ws[top]) * probs.gather(
                1, top[:, None])
            return (out ** 2).sum()

        grads = []
        for fn in (loss_ep, loss_dense):
            args = [torch.as_tensor(a).requires_grad_(True)
                    for a in (ws, x, g)]
            fn(*args).backward()
            grads.append([a.grad.numpy() for a in args])

        def j_loss(ws, x, g):
            return jnp.sum(j_apply(_linear_expert, ws, x, g,
                                   capacity_factor=float(N_EXP)) ** 2)

        gj = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(
            jnp.asarray(ws), jnp.asarray(x), jnp.asarray(g))
        for a, b, c in zip(grads[0], grads[1], gj):
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(a, np.asarray(c), **F64)
