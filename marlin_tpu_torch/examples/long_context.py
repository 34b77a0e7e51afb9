"""LongContext: sequence-parallel attention over the shard axis, port of
``marlin_tpu/examples/long_context.py``.

A sequence sharded across the shards of the default shard axis
(:mod:`..parallel.shards`) is attended by the ring engine (K/V stripes
stream with online-softmax accumulation; per-shard memory O(seq / P))
and by the all-to-all engine (re-shard to head-parallel, attend locally
through the flash kernels, re-shard back). The CLI runs both on the same
input, checks them against each other at 1e-4 and reports the memory a
ring step holds against the S x S logits of naive attention; it returns
1 when the engines disagree.

Usage:
  python -m marlin_tpu_torch.examples.long_context [seq] [heads]
      [head_dim] [window] [--device cpu|cuda|cuda:0 --shards N]

Without ``--device`` the default shard axis (every visible card, unless
set); ``--device D --shards N`` puts N shards on D (``cuda:0`` with N > 1
puts them all on one card). With a window the ring runs hop-bounded
(only the stripes that can intersect the band rotate), so its time drops
with the window while the all-to-all engine's does not.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..parallel.shards import default_shards, shard_devices


def _run(fn, dev):
    out = fn()  # the first call settles allocations and kernel builds
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("seq", type=int, nargs="?", default=4096)
    p.add_argument("heads", type=int, nargs="?", default=8)
    p.add_argument("head_dim", type=int, nargs="?", default=64)
    p.add_argument("window", type=int, nargs="?", default=0)
    p.add_argument("--device", default=None)
    p.add_argument("--shards", type=int, default=8)
    args = p.parse_args(argv)

    from ..parallel.ulysses import sequence_parallel_attention

    devices = (default_shards() if args.device is None
               else shard_devices(args.shards, (args.device,) * args.shards))
    n_dev = len(devices)
    seq = max(n_dev, args.seq - args.seq % n_dev)  # both want divisible seq
    heads = args.heads
    if heads % n_dev:
        heads = max(n_dev, heads - heads % n_dev)  # all_to_all shards heads
    gen = torch.Generator(device=devices[0]).manual_seed(0)
    q, k, v = (torch.randn((seq, heads, args.head_dim), generator=gen,
                           device=devices[0], dtype=torch.float32)
               for _ in range(3))

    results = {}
    for strategy in ("ring", "all_to_all"):
        out, dt = _run(lambda s=strategy: sequence_parallel_attention(
            q, k, v, devices=devices, causal=True, strategy=s,
            window=args.window), devices[0])
        results[strategy] = out
        hopnote = " (hop-bounded)" if strategy == "ring" else ""
        extra = f", window {args.window}{hopnote}" if args.window else ""
        print(f"{strategy:>10}: {dt * 1e3:8.2f} ms  (seq {seq} sharded "
              f"{n_dev}-way, {seq // n_dev} rows/device{extra})")

    a, b = results["ring"], results["all_to_all"]
    err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    ok = err < 1e-4
    logits_bytes = seq * seq * heads * 4
    per_dev = (seq // n_dev) ** 2 * 4  # one (S/P, S/P) f32 tile a hop
    verdict = "engines agree" if ok else "ENGINES DISAGREE"
    print(f"{verdict}: max rel err {err:.2e}")
    print(f"naive S x S logits would be {logits_bytes / 1e9:.2f} GB; "
          f"ring peak per device ~{per_dev / 1e6:.1f} MB per head-step")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
