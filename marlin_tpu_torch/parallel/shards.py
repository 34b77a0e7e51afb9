"""The single-process shard axis of the sequence-, expert- and
pipeline-parallel engines (:mod:`.ring`, :mod:`.ulysses`, :mod:`.expert`,
:mod:`.pipeline`) and of tensor parallelism (``models/tp.py``).

The JAX package runs each engine as one ``shard_map`` program over every
device of ``default_mesh()``. The port keeps the engines in one process:
the axis is a tuple of torch devices (:func:`shard_devices`), each engine
cuts its global operands into one stripe a shard, runs its loop over the
shards in rank order on the calling thread, and reassembles a global
result. The collectives become tensor ops: ``ppermute`` a rotation of the
list of stripes, a tiled ``all_to_all`` cutting each shard's block and
concatenating in rank order, ``psum`` a sum in rank order. Every move is
an ordinary differentiable op, so autograd runs through the engines as
``jax.grad`` runs through ``shard_map``.

Why one process: NCCL refuses two ranks on one GPU, so a process a rank
could run only one shard on a one-card host, where every ring is a single
hop and every all-to-all an identity. ``("cuda:0",) * P`` puts P shards
on one card; ``("cpu",) * 8`` is the CPU counterpart of the JAX tests' 8
forced host devices.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..utils.hw import resolve_device

_default_shards: Optional[tuple] = None


def shard_devices(n: int, device="cuda", what: str = "shards") -> tuple:
    """The devices of an axis of ``n`` shards:

    * a single ``"cuda"`` (or ``"cuda:i"``) is ``n`` cards from the first
      (from card ``i``); ``ValueError`` when fewer are visible;
    * a single ``"cpu"`` is ``n`` shards on the CPU;
    * a sequence of ``n`` devices is taken as given. It is the only way
      to put several shards on one card: ``("cuda:0",) * n``.

    At ``n == 1`` a single device is resolved as everywhere in the port
    (``"cuda"`` raises without CUDA). ``what`` names the axis in the
    errors ("tp" for tensor parallelism)."""
    if isinstance(device, (list, tuple)):
        devs = tuple(resolve_device(d) for d in device)
        if len(devs) != n:
            raise ValueError(
                f"device lists {len(devs)} devices for {what} {n}")
        return devs
    if n == 1:
        return (resolve_device(device),)
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return (dev,) * n
    if dev.type != "cuda":
        raise ValueError(f"{what} on {dev} is not supported")
    resolve_device(dev)  # raises without CUDA
    first = dev.index or 0
    visible = torch.cuda.device_count()
    if first + n > visible:
        raise ValueError(
            f"{what} {n} needs {n} CUDA devices from cuda:{first}, "
            f"{visible} visible; to put several shards on one card pass "
            f"device=('cuda:{first}',) * {n} explicitly")
    return tuple(torch.device("cuda", first + r) for r in range(n))


def default_shards() -> tuple:
    """The default shard axis, the counterpart of ``default_mesh()``: the
    one :func:`set_default_shards` set, else every visible card (raises
    without CUDA: a CPU axis is asked for explicitly)."""
    if _default_shards is None:
        resolve_device("cuda")
        return shard_devices(torch.cuda.device_count(), "cuda")
    return _default_shards


def set_default_shards(devices: Optional[Sequence]) -> None:
    """Set the default shard axis (a sequence of devices; None restores
    every visible card)."""
    global _default_shards
    _default_shards = None if devices is None else shard_devices(
        len(devices), tuple(devices))


def resolve_shards(devices) -> tuple:
    """An engine's ``devices`` argument: None is :func:`default_shards`."""
    if devices is None:
        return default_shards()
    devices = tuple(devices)
    return shard_devices(len(devices), devices)


def tree_map(fn, tree):
    """``fn`` over the leaves of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def rotate(stripes: list, devices: tuple, step: int) -> list:
    """``ppermute`` around the ring: shard ``s``'s stripe moves to shard
    ``(s + step) % P`` (on that shard's device)."""
    p = len(stripes)
    return [stripes[(s - step) % p].to(devices[s]) for s in range(p)]
