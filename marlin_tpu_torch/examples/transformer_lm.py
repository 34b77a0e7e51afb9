"""TransformerLM — train the transformer on synthetic next-token data,
then greedy-decode a continuation from the trained params: the port's
counterpart of ``marlin_tpu/examples/transformer_lm.py``.

Usage:
  python -m marlin_tpu_torch.examples.transformer_lm [steps] [batch] [seq]
                                                     [d_model] [dtype]
                                                     [--device cuda|cpu]

``dtype`` (default float32) is the compute dtype; bfloat16 trains with
f32 master params and bf16 activations and attention. It runs on one
device (default ``cuda``; ``--device cpu`` runs the kernels' plain
versions). The JAX example's data-parallel mesh waits for the dense
path's mesh (ROADMAP Queue A2/A3), and its ``--int8`` and ``--spec``
decoding modes for the int8 stack and speculative decoding (ROADMAP
Queue A1).
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def model_config(d_model: int, seq: int, dtype: str):
    """The example's model: the JAX example's configuration for the same
    width, sequence length and dtype."""
    from marlin_tpu_torch.models import TransformerConfig

    return TransformerConfig(
        vocab=128, d_model=d_model, n_heads=max(2, d_model // 32),
        n_layers=2, d_ff=4 * d_model, max_len=seq, dtype=dtype,
    )


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    for flag, what in (("--int8", "the int8 serving stack"),
                       ("--spec", "speculative decoding")):
        if flag in argv:
            raise NotImplementedError(
                f"{flag}: {what} is not ported to marlin_tpu_torch yet "
                f"(ROADMAP Queue A1)")
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    steps = int(argv[0]) if len(argv) > 0 else 20
    batch = int(argv[1]) if len(argv) > 1 else 8
    seq = int(argv[2]) if len(argv) > 2 else 64
    d_model = int(argv[3]) if len(argv) > 3 else 64
    dtype = argv[4] if len(argv) > 4 else "float32"

    from marlin_tpu_torch.models import generate, init_params, train_step

    cfg = model_config(d_model, seq, dtype)
    params = init_params(cfg, seed=0, device=device)
    dev = params["embed"].device
    tokens = torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab, (batch, seq)),
        device=dev)
    targets = torch.roll(tokens, -1, dims=1)

    loss, params = train_step(params, tokens, targets, cfg)  # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss, params = train_step(params, tokens, targets, cfg)
    _sync(dev)
    dt = (time.perf_counter() - t0) / max(steps, 1)
    print(
        f"TransformerLM d={d_model} L={cfg.n_layers} B={batch} S={seq} "
        f"device={dev}: final loss {loss.item():.4f}, "
        f"{dt * 1e3:.2f} ms/step ({batch * seq / dt:.0f} tok/s)"
    )

    prompt_len = min(4, seq - 1)
    gen_steps = min(8, cfg.max_len - prompt_len)
    finite = math.isfinite(loss.item())
    if gen_steps <= 0:
        print("sequence too short for a decode demo; skipping generation")
        return 0 if finite else 1
    t0 = time.perf_counter()
    out = generate(params, tokens[:1, :prompt_len], gen_steps, cfg)
    _sync(dev)
    dt_gen = (time.perf_counter() - t0) / gen_steps
    print(f"greedy decode {gen_steps} tokens (KV cache): "
          f"{dt_gen * 1e3:.2f} ms/token -> {out[0].tolist()}")
    return 0 if finite and tuple(out.shape) == (1, gen_steps) else 1


if __name__ == "__main__":
    raise SystemExit(main())
