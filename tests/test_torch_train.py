"""The port's training path (marlin_tpu_torch/models/transformer.py:
loss_fn, train_step, make_train_step, remat) against the JAX package's,
on the CPU.

Both sides start from the same weights (carried across by
``params_from_jax``) and the same numpy tokens. The JAX side's flash
attention runs its Pallas forward and backward kernels in interpret mode,
as its own tests run them; the port's runs the plain versions through its
autograd Function. Bounds at f32: 1e-5 of the largest magnitude, per
value and per gradient leaf (the two frameworks differ only in summation
order).
"""

import math

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from marlin_tpu.models import transformer as jt
from marlin_tpu_torch.models import convert
from marlin_tpu_torch.models import transformer as pt

VARIANTS = {
    "plain": dict(),
    "rope_gqa": dict(rope=True, n_kv_heads=2),
    "window": dict(rope=True, window=4),
    # Two heads of D = 320: the card's wrapper takes the wide kernels here.
    "head_dim_320": dict(d_model=640, n_heads=2),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # One intra-op thread: these tests run beside wall-clock-timed tests
    # in the parallel suite, and their shapes are too small to need more.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    base = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                max_len=32)
    base.update(kw)
    cfg = jt.TransformerConfig(**base)
    return cfg, pt.TransformerConfig(**cfg._asdict())


def _params(cfg, pcfg, seed=0):
    jp = jt.init_params(cfg, seed=seed)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), pcfg,
                                       device="cpu")


def _batch(seed, b, s, vocab=64):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s))
    return toks, np.roll(toks, -1, axis=1)


def _rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    top = np.abs(ref).max()
    return 0.0 if top == 0 else float(np.abs(got - ref).max() / top)


def _assert_trees_close(got, ref, rtol=1e-5):
    """Leaf by leaf over the shared layout: torch tensors against JAX
    arrays, each relative to its own largest magnitude."""
    ref_leaves = jax.tree.leaves(jax.tree.map(np.asarray, ref))
    got_leaves = jax.tree.leaves(got)  # torch tensors are leaves, keys sorted
    assert len(got_leaves) == len(ref_leaves)
    errs = [_rel_err(g.detach().numpy(), r)
            for g, r in zip(got_leaves, ref_leaves)]
    assert max(errs) <= rtol, f"worst leaf relative error {max(errs):.3e}"


def _jax_value_and_grad(cfg):
    # A fresh jit per call: loss_fn reads _CE_CHUNK while tracing, so a
    # cached trace must not outlive a monkeypatch.
    return jax.jit(jax.value_and_grad(
        lambda p, t, y: jt.loss_fn(p, t, y, cfg)))


def _port_value_and_grad(pp, toks, tgts, pcfg):
    leaves = [p.detach().requires_grad_(True) for p in pt._leaves(pp)]
    tree = pt._unflatten(pp, iter(leaves))
    loss = pt.loss_fn(tree, torch.from_numpy(toks), torch.from_numpy(tgts),
                      pcfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss, pt._unflatten(pp, iter(grads))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_grads_match_jax(variant):
    cfg, pcfg = _cfgs(**VARIANTS[variant])
    jp, pp = _params(cfg, pcfg, seed=1)
    toks, tgts = _batch(0, 2, 12)
    ref_loss, ref_grads = _jax_value_and_grad(cfg)(
        jp, jnp.asarray(toks, jnp.int32), jnp.asarray(tgts, jnp.int32))
    loss, grads = _port_value_and_grad(pp, toks, tgts, pcfg)
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * float(ref_loss)
    _assert_trees_close(grads, ref_grads)
    # Attention's own weights get a gradient through the flash backward.
    assert grads["blocks"][0]["wqkv"].abs().max() > 0


def test_chunked_cross_entropy_matches_jax(monkeypatch):
    # 3 x 7 = 21 positions in chunks of 8: two full chunks and a tail
    # padded with 3 masked positions, in both packages.
    monkeypatch.setattr(jt, "_CE_CHUNK", 8)
    monkeypatch.setattr(pt, "_CE_CHUNK", 8)
    cfg, pcfg = _cfgs(rope=True, n_kv_heads=2)
    jp, pp = _params(cfg, pcfg, seed=2)
    toks, tgts = _batch(1, 3, 7)
    ref_loss, ref_grads = _jax_value_and_grad(cfg)(
        jp, jnp.asarray(toks, jnp.int32), jnp.asarray(tgts, jnp.int32))
    loss, grads = _port_value_and_grad(pp, toks, tgts, pcfg)
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * float(ref_loss)
    _assert_trees_close(grads, ref_grads)
    # And the chunked path equals the port's own one-piece readout.
    monkeypatch.setattr(pt, "_CE_CHUNK", 2048)
    whole, _ = _port_value_and_grad(pp, toks, tgts, pcfg)
    assert abs(loss.item() - whole.item()) <= 1e-6 * whole.item()


def test_three_train_steps_match_jax():
    cfg, pcfg = _cfgs(rope=True, n_kv_heads=2)
    jp, pp = _params(cfg, pcfg, seed=3)
    toks, tgts = _batch(2, 2, 12)
    jstep = jax.jit(lambda p, t, y: jt.train_step(p, t, y, cfg))
    jt_toks, jt_tgts = (jnp.asarray(x, jnp.int32) for x in (toks, tgts))
    for _ in range(3):
        ref_loss, jp = jstep(jp, jt_toks, jt_tgts)
        loss, pp = pt.train_step(pp, torch.from_numpy(toks),
                                 torch.from_numpy(tgts), pcfg)
        assert abs(loss.item() - float(ref_loss)) <= 1e-5 * float(ref_loss)
    _assert_trees_close(pp, jp)


def test_make_train_step_with_adam_matches_optax():
    # eps = 1e-3 in both: with the default 1e-8, Adam maps a gradient
    # element that is zero up to summation order (|g| ~ 1e-9) to a step of
    # up to lr either way, which measures the frameworks' rounding, not
    # the binding. The binding (moments carried across steps, bias
    # correction, the update applied to every leaf) is what is held here.
    cfg, pcfg = _cfgs()
    jp, pp = _params(cfg, pcfg, seed=4)
    toks, tgts = _batch(3, 2, 12)
    jstep, jinit = jt.make_train_step(cfg, optax.adam(1e-3, eps=1e-3))
    jstep = jax.jit(jstep)
    jstate = jinit(jp)
    step, init = pt.make_train_step(pcfg, torch.optim.Adam, lr=1e-3,
                                    eps=1e-3)
    state = init(pp)
    jt_toks, jt_tgts = (jnp.asarray(x, jnp.int32) for x in (toks, tgts))
    losses = []
    for _ in range(3):
        ref_loss, jp, jstate = jstep(jp, jstate, jt_toks, jt_tgts)
        loss, pp, state = step(pp, state, toks, tgts)
        assert abs(loss.item() - float(ref_loss)) <= 1e-5 * float(ref_loss)
        losses.append(loss.item())
    assert losses[-1] < losses[0]
    _assert_trees_close(pp, jp)


def test_remat_equals_no_remat_bitwise():
    # Checkpointing re-runs each block's forward in the backward; on the
    # same device the recompute is the same arithmetic, so loss and every
    # gradient are bit-for-bit those of the plain run.
    _, pcfg = _cfgs(rope=True, n_kv_heads=2)
    pp = pt.init_params(pcfg, seed=5, device="cpu")
    toks, tgts = _batch(4, 2, 12)
    loss, grads = _port_value_and_grad(pp, toks, tgts, pcfg)
    loss_r, grads_r = _port_value_and_grad(pp, toks, tgts,
                                           pcfg._replace(remat=True))
    assert torch.equal(loss, loss_r)
    for g, gr in zip(pt._leaves(grads), pt._leaves(grads_r)):
        assert torch.equal(g, gr)


def test_bf16_training_keeps_f32_masters():
    _, pcfg = _cfgs(rope=True, n_kv_heads=2, dtype="bfloat16")
    pp = pt.init_params(pcfg, seed=6, device="cpu")
    toks, tgts = _batch(5, 2, 12)
    losses = []
    new = pp
    for _ in range(3):
        loss, new = pt.train_step(new, toks, tgts, pcfg)
        losses.append(loss.item())
    assert all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]
    for old, leaf in zip(pt._leaves(pp), pt._leaves(new)):
        assert leaf.dtype == torch.float32 and not leaf.requires_grad
    # The masters moved, attention's projection included, and the input
    # params were left as they were (a functional step).
    assert not torch.equal(new["blocks"][0]["wqkv"], pp["blocks"][0]["wqkv"])
    assert not pp["embed"].requires_grad


def test_serving_after_make_train_step_builds_no_graph():
    # make_train_step marks the caller's params as requiring grad. Serving
    # the same params afterwards must build no autograd graph: the
    # engine's in-place cache writes would otherwise chain one through
    # every admission and decode step for the engine's whole life. The
    # tokens are those of the same weights with grad off.
    from marlin_tpu_torch.serving import ServingEngine

    _, pcfg = _cfgs(rope=True, n_kv_heads=2, max_len=48)
    pp = pt.init_params(pcfg, seed=7, device="cpu")
    toks, tgts = _batch(6, 2, 12)
    step, init = pt.make_train_step(pcfg, torch.optim.SGD, lr=0.1)
    state = init(pp)
    step(pp, state, toks, tgts)
    assert pp["embed"].requires_grad
    eng = ServingEngine(pp, pcfg, batch=2, round_steps=4, device="cpu")
    prompts = [np.arange(5) % 64, np.arange(3, 12) % 64, np.arange(7) % 64]
    ids = {eng.submit(p, 6): p for p in prompts}
    done = {r.request_id: r for r in eng.run()}
    assert len(done) == len(prompts)
    state_tensors = [eng._buf] + [x for layer in eng._cache
                                  for x in layer.values()]
    assert all(x.grad_fn is None and not x.requires_grad
               for x in state_tensors)
    _, cache = pt.prefill(pp, torch.as_tensor(prompts[0][None]), pcfg)
    assert all(not x.requires_grad for layer in cache for x in layer.values())
    frozen = pt._tree_map(lambda p: p.detach(), pp)
    for rid, prompt in ids.items():
        out = pt.generate(pp, torch.as_tensor(prompt[None]), 6, pcfg)
        assert not out.requires_grad
        ref = pt.generate(frozen, torch.as_tensor(prompt[None]), 6, pcfg)
        np.testing.assert_array_equal(done[rid].tokens, ref.numpy()[0])
        np.testing.assert_array_equal(out.numpy()[0], ref.numpy()[0])


class TestExample:
    def test_cli_trains_and_decodes_on_the_cpu(self, capsys):
        from marlin_tpu_torch.examples import transformer_lm

        assert transformer_lm.main(["2", "2", "16", "64", "float32",
                                    "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "final loss" in out and "greedy decode 8 tokens" in out

    @pytest.mark.parametrize("flag,line", [
        ("--int8", "(int8 weights + int8 KV cache)"),
        ("--spec", "speculative decode (draft_len=4)")])
    def test_int8_and_spec_decode(self, capsys, flag, line):
        # The JAX example's decoding modes: the int8 stack, and
        # speculation, whose greedy tokens are plain greedy's.
        from marlin_tpu_torch.examples import transformer_lm

        assert transformer_lm.main(["1", "2", "16", "64", flag, "--device",
                                    "cpu"]) == 0
        out = capsys.readouterr().out
        assert line in out
        if flag == "--spec":
            plain = out.split("(KV cache): ")[1].split("-> ")[1]
            spec = out.split(line + ": ")[1].split("-> ")[1]
            assert plain.splitlines()[0] == spec.splitlines()[0]


@pytest.mark.parametrize("d_model, seq, dtype", [(64, 64, "float32"),
                                                 (128, 32, "bfloat16"),
                                                 (32, 16, "float32")])
def test_example_model_is_the_jax_examples(monkeypatch, d_model, seq, dtype):
    # The JAX example's main builds its TransformerConfig from the same
    # arguments (the config is caught as it is built, before any step);
    # the port's example trains the same model: n_heads max(2, d_model //
    # 32), so a head dim of 32 at the default width, which the flash
    # wrapper pads for the card's kernels.
    import marlin_tpu.models
    from marlin_tpu.examples import transformer_lm as jax_example
    from marlin_tpu_torch.examples import transformer_lm as port_example

    class Built(Exception):
        pass

    def catch(**kw):
        raise Built(kw)

    monkeypatch.setattr(marlin_tpu.models, "TransformerConfig", catch)
    with pytest.raises(Built) as built:
        jax_example.main(["1", "8", str(seq), str(d_model), dtype])
    want = jt.TransformerConfig(**built.value.args[0])
    got = port_example.model_config(d_model, seq, dtype)
    assert got._asdict() == want._asdict()
    assert got.n_heads == max(2, d_model // 32)
