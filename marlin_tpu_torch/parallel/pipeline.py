"""Pipeline parallelism, GPipe-style microbatch streaming over the shard
axis: port of ``marlin_tpu/parallel/pipeline.py``.

Stages live one a shard of the single-process shard axis (:mod:`.shards`;
shard i keeps only stage i's parameters), activations hop stage to stage
(a rotation of the list of stage inputs, a device copy between shards),
and the schedule is the JAX package's: with P stages and M microbatches,
step t has stage i work on microbatch ``t - i`` (when 0 <= t - i < M);
after M + P - 1 steps every microbatch has crossed every stage. An
inactive step's output is zero (the JAX package computes it on every
device and zeroes it; here it is not computed), and the last stage banks
each finished microbatch.

Every stage maps activations (microbatch, d) -> (microbatch, d) with one
shared shape and dtype. The result equals applying the stages
sequentially: each microbatch meets each stage in one call of the stage
function, the same call a sequential loop over microbatches makes.
Trainable as it is: autograd runs through the schedule and the hops.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .shards import resolve_shards, rotate, tree_leaves, tree_map


def gpipe(apply_fn: Callable, stage_params, x,
          n_microbatches: Optional[int] = None,
          devices=None) -> torch.Tensor:
    """Run ``x`` through ``n_stages`` sequential stages, pipelined.

    ``apply_fn(params_i, x_mb) -> y_mb`` is one stage; ``stage_params`` is
    a tree (a tensor, or dicts, lists and tuples of them) whose leaves
    have leading axis ``n_stages`` = the shard count of ``devices``
    (default: :func:`.shards.default_shards`; shard i keeps stage i's
    slice). ``x`` is (batch, d) with batch divisible into
    ``n_microbatches`` equal microbatches (default: one a stage). Returns
    (batch, d) on x's device, equal to applying the stages
    sequentially."""
    devices = resolve_shards(devices)
    n_stages = len(devices)
    leaves = tree_leaves(stage_params)
    if not leaves or any(leaf.shape[0] != n_stages for leaf in leaves):
        raise ValueError(
            f"stage_params leaves need leading axis {n_stages} (one slice "
            f"per device), got {[tuple(leaf.shape) for leaf in leaves]}")
    batch, d = x.shape
    n_micro = n_microbatches or n_stages
    if batch % n_micro != 0:
        raise ValueError(
            f"batch {batch} must divide into {n_micro} microbatches")
    xm = x.reshape(n_micro, batch // n_micro, d)
    params = [tree_map(lambda p, i=i: p[i].to(devices[i]), stage_params)
              for i in range(n_stages)]
    zeros = [x.new_zeros((batch // n_micro, d), device=dev)
             for dev in devices]
    incoming = list(zeros)
    banked = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        outs = []
        for i in range(n_stages):
            k = t - i  # the microbatch stage i works on at step t
            if not 0 <= k < n_micro:
                outs.append(zeros[i])
                continue
            src = xm[t].to(devices[0]) if i == 0 else incoming[i]
            out = apply_fn(params[i], src)
            if i == n_stages - 1:
                banked[k] = out
            outs.append(out)
        incoming = rotate(outs, devices, +1)  # one stage forward
    return torch.cat([y.to(x.device) for y in banked])
