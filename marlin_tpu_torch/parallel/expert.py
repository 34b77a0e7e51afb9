"""Expert parallelism, top-1 token routing over the shard axis (MoE
dispatch): port of ``marlin_tpu/parallel/expert.py``.

Experts live one a shard of the single-process shard axis (:mod:`.shards`;
shard e keeps only expert e's slice of the parameters), tokens travel to
their expert with one all-to-all and come back with another: the
two-reshard pattern of Ulysses attention applied to capacity-bucketed
token batches.

Semantics (standard capacity-factor MoE), the JAX package's:

* router: top-1 expert per token from caller-provided gate logits (argmax,
  the first maximum on ties), the output scaled by the softmax gate
  probability computed in at least f32;
* capacity: each (source shard, expert) bucket holds
  ``ceil(local_tokens * capacity_factor / n_experts)`` tokens, slots in
  local token order; tokens beyond a bucket's capacity are not routed and
  pass through bitwise unchanged;
* trainable as it is: autograd flows through the bucketing scatter, the
  two all-to-alls (concatenation and device copies), the expert apply
  and the un-scatter, and the gate-probability scaling carries the top-1
  router gradient.

Plain torch ops: the JAX package leaves this engine to XLA (no Pallas
kernel). Nothing is kept between calls.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from .shards import resolve_shards, tree_leaves, tree_map

def _route(gates, n_exp: int, cap: int):
    """One source shard's routing: ``(expert, slot, keep, prob)`` from its
    (t_loc, n_exp) gate logits."""
    acc_t = torch.promote_types(gates.dtype, torch.float32)
    probs = torch.softmax(gates.to(acc_t), dim=-1)
    expert = torch.argmax(gates, dim=-1)  # (t_loc,)
    prob = probs.gather(1, expert[:, None])[:, 0]
    onehot = torch.nn.functional.one_hot(expert, n_exp)  # (t_loc, E)
    pos = torch.cumsum(onehot, dim=0) * onehot  # 1-based slot, 0 elsewhere
    slot = pos.sum(dim=1) - 1  # 0-based within the bucket
    return expert, slot, slot < cap, prob


def expert_parallel_apply(expert_fn: Callable, expert_params, x, gate_logits,
                          capacity_factor: float = 1.25,
                          devices=None) -> torch.Tensor:
    """Route each token to its top-1 expert, apply, and return in place.

    ``expert_fn(params_e, tokens) -> tokens`` applies ONE expert to a
    (tokens, d) batch (here the flat ``(n_experts * cap, d)`` batch of
    every source shard's bucket); ``expert_params`` is a tree (a tensor,
    or dicts, lists and tuples of them) whose leaves have leading axis
    ``n_experts`` = the shard count of ``devices`` (default:
    :func:`.shards.default_shards`; shard e keeps expert e's slice). ``x``
    is (tokens, d) with tokens divisible by the shard count;
    ``gate_logits`` is (tokens, n_experts). Tokens over a bucket's
    capacity pass through unchanged; routed outputs are scaled by the gate
    probability. The result is assembled on x's device."""
    devices = resolve_shards(devices)
    n_exp = len(devices)
    leaves = tree_leaves(expert_params)
    if not leaves or any(leaf.shape[0] != n_exp for leaf in leaves):
        raise ValueError(
            f"expert_params leaves need leading axis {n_exp} (one expert "
            f"per device), got {[tuple(leaf.shape) for leaf in leaves]}")
    t, d = x.shape
    if t % n_exp != 0:
        raise ValueError(f"token count {t} must divide by {n_exp} devices")
    if tuple(gate_logits.shape) != (t, n_exp):
        raise ValueError(
            f"gate_logits must be ({t}, {n_exp}), got "
            f"{tuple(gate_logits.shape)}")
    t_loc = t // n_exp
    cap = max(1, int(math.ceil(t_loc * capacity_factor / n_exp)))

    # Each source shard buckets its tokens into an (E, cap, d) dispatch
    # buffer: a kept token lands at expert * cap + slot, a dropped one in
    # the spare last row, which is cut off.
    routes, dispatch = [], []
    for i in range(n_exp):
        dev = devices[i]
        xi = x[i * t_loc:(i + 1) * t_loc].to(dev)
        expert, slot, keep, prob = _route(
            gate_logits[i * t_loc:(i + 1) * t_loc].to(dev), n_exp, cap)
        flat = torch.where(keep, expert * cap + slot,
                           torch.full_like(expert, n_exp * cap))
        buf = xi.new_zeros((n_exp * cap + 1, d)).index_copy(0, flat, xi)
        dispatch.append(buf[:n_exp * cap].reshape(n_exp, cap, d))
        routes.append((xi, expert, slot, keep, prob))

    # To the experts: shard e receives every source's bucket for expert e,
    # in source order, and applies its expert to the flat batch.
    outs = []
    for e in range(n_exp):
        dev = devices[e]
        tokens_in = torch.cat([dispatch[i][e:e + 1].to(dev)
                               for i in range(n_exp)]).reshape(
                                   n_exp * cap, d)
        out = expert_fn(tree_map(lambda p, e=e, dev=dev: p[e].to(dev),
                                 expert_params), tokens_in)
        if tuple(out.shape) != tuple(tokens_in.shape):
            raise ValueError(
                f"expert_fn must preserve (tokens, d) shape, got "
                f"{tuple(out.shape)}")
        outs.append(out.reshape(n_exp, cap, d))

    # And back: source i reads its bucket of every expert, token t its own
    # slot; dropped tokens keep their input.
    results = []
    for i in range(n_exp):
        dev = devices[i]
        xi, expert, slot, keep, prob = routes[i]
        returned = torch.cat([outs[e][i:i + 1].to(dev)
                              for e in range(n_exp)]).reshape(n_exp * cap, d)
        gathered = returned[(expert * cap + slot).clamp(0, n_exp * cap - 1)]
        routed = gathered * prob[:, None].to(xi.dtype)
        results.append(torch.where(keep[:, None], routed, xi).to(x.device))
    return torch.cat(results)
