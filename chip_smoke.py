#!/usr/bin/env python3
"""Drive the PyTorch port (marlin_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. Device: require CUDA; print the card's name and power limit.
2. Build: compile every CUDA kernel of the port from csrc/ (one nvcc per
   source, started together) and print the build time and ptxas report.
3. Kernel vs plain: hold the flash-attention kernel against its plain
   PyTorch version on the card at the serving path's shapes and the edge
   cases (ragged, MHA, MQA, cross lengths with Dv != D, window, D=64,
   f32); time the kernel, the plain version, torch's
   scaled_dot_product_attention (a yardstick the port never calls) and
   the roofline bound.
4. Slice: serve the flagship transformer (vocab 32768, d_model 1024, 8
   heads, 2 KV heads, 8 layers, d_ff 4096, max_len 2048, RoPE, bf16;
   random weights from a seed) with ServingEngine(batch=8,
   round_steps=8): 16 requests with prompts of 64-1536 tokens and 32
   steps each, in two waves. Check every request against the port's own
   B=1 generate, and that the flash kernel ran exactly once per layer per
   admission (its launch counter is zeroed just before the run and read
   just after).

The last three lines of output are the card line from nvidia-smi, one
{"kernels": [...]} JSON object, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
PEAK_BYTES = 3.35e12

# Flagship serving configuration: README Quick start, benchlib decode bench.
FLAGSHIP = dict(vocab=32768, d_model=1024, n_heads=8, n_kv_heads=2,
                n_layers=8, d_ff=4096, max_len=2048, rope=True,
                dtype="bfloat16")

# Kernel-vs-plain shapes: (name, B, Sq, Skv, H, Hk, D, Dv, dtype, causal,
# window). "flagship" is the model's full-length prefill.
SHAPES = [
    ("flagship", 1, 2048, 2048, 8, 2, 128, 128, "bfloat16", True, 0),
    ("ragged", 1, 1000, 1000, 8, 2, 128, 128, "bfloat16", True, 0),
    ("mha", 1, 1024, 1024, 8, 8, 128, 128, "bfloat16", True, 0),
    ("mqa", 1, 1024, 1024, 8, 1, 128, 128, "bfloat16", True, 0),
    ("cross_dv64", 1, 384, 1000, 8, 2, 128, 64, "bfloat16", False, 0),
    ("window256", 1, 2048, 2048, 8, 2, 128, 128, "bfloat16", True, 256),
    ("d64", 2, 1024, 1024, 8, 2, 64, 64, "bfloat16", True, 0),
    ("f32", 1, 1000, 1000, 8, 2, 128, 128, "float32", True, 0),
]

# Tolerances of kernel vs plain version, by dtype: (O abs, lse abs).
# bf16: the kernel rounds P to bf16 before the P.V product (the plain
# version keeps P in f32), a relative error of 2^-9 per weight, and both
# round O to bf16 (one ulp of |O| ~ 1 is 7.8e-3); lse differs only by
# the f32 summation order of exact bf16 products. f32: the kernel runs
# FMA in full f32 (no TF32) against cuBLAS f32, so only summation order
# differs (~1e-6 observed scale).
TOLERANCE = {"bfloat16": (2e-2, 1e-3), "float32": (1e-4, 1e-4)}


def cuda_ms(fn, warmup: int = 3, iters: int = 10) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_flops(b, sq, skv, h, d, dv, causal, window) -> float:
    """FLOPs of Q K^T and P V over the (q, k) pairs these inputs need:
    the causal triangle and the window band only."""
    pairs = 0
    for qp in range(sq):
        hi = min(qp + 1, skv) if causal else skv
        lo = max(0, qp - window + 1) if window else 0
        pairs += max(0, hi - lo)
    return 2.0 * b * h * pairs * (d + dv)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"capability {torch.cuda.get_device_capability(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    return card


def phase_build():
    from marlin_tpu_torch.ops import build

    t0 = time.perf_counter()
    res = build.build(ptxas_verbose=True)
    secs = time.perf_counter() - t0
    for name, info in res.items():
        print(f"build: {name} nvcc {info['seconds']:.1f} s -> "
              f"{info['path']}", flush=True)
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"build: total {secs:.1f} s", flush=True)
    return secs


def phase_kernels():
    """Kernel vs plain at every shape; returns the flagship row."""
    import torch
    import torch.nn.functional as F

    from marlin_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in f32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for (name, b, sq, skv, h, hk, d, dv, dt, causal, window) in SHAPES:
        dtype = getattr(torch, dt)
        q = torch.randn((b, sq, h, d), generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype)
        k = torch.randn((b, skv, hk, d), generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype)
        v = torch.randn((b, skv, hk, dv), generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype)

        def kernel():
            return fa.flash_attention_fwd(q, k, v, causal, None, window)

        def plain():
            q_hat, kk, vv, _ = fa._prepare(q, k, v, causal, None, window)
            return fa.flash_attention_reference(q_hat, kk, vv, causal,
                                                window)

        o_k, lse_k = kernel()
        torch.cuda.synchronize()
        o_r, lse_r = plain()
        err_o = (o_k.float() - o_r.float()).abs().max().item()
        err_lse = (lse_k - lse_r).abs().max().item()
        if not (math.isfinite(err_o) and math.isfinite(err_lse)):
            fail(f"kernel {name}: non-finite output")
        tol_o, tol_lse = TOLERANCE[dt]
        if err_o > tol_o or err_lse > tol_lse:
            fail(f"kernel {name}: |O - plain| = {err_o:.3e} (tol {tol_o}), "
                 f"|lse - plain| = {err_lse:.3e} (tol {tol_lse})")
        ms = cuda_ms(kernel, iters=20)
        plain_ms = cuda_ms(plain, warmup=1, iters=3)
        lib_ms = library_ms(F, q, k, v, causal, window)
        # Bound: max(FLOPs / peak, bytes / HBM rate), reading Q, K, V once
        # and writing O and lse once.
        flops = attention_flops(b, sq, skv, h, d, dv, causal, window)
        nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, o_k)) \
            + lse_k.numel() * 4
        t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        row = dict(shape=name, B=b, Sq=sq, Skv=skv, H=h, Hk=hk, D=d, Dv=dv,
                   dtype=dt, causal=causal, window=window,
                   max_abs_err=err_o, lse_max_abs_err=err_lse, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   tflops=flops / (ms * 1e-3) / 1e12)
        rows[name] = row
        print("kernel: " + json.dumps(row), flush=True)
    return rows


def library_ms(F, q, k, v, causal, window):
    """torch's scaled_dot_product_attention on the same inputs (the
    yardstick; heads-first layout, GQA through enable_gqa). None where it
    does not take the case."""
    import torch

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kw = {"enable_gqa": q.shape[2] != k.shape[2]}
    sq, skv = q.shape[1], k.shape[1]
    if window:
        qp = torch.arange(sq, device=q.device)[:, None]
        kp = torch.arange(skv, device=q.device)[None, :]
        kw["attn_mask"] = (kp <= qp) & (kp > qp - window)
    elif causal:
        if sq != skv:
            return None
        kw["is_causal"] = True
    try:
        return cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, **kw), iters=20)
    except (RuntimeError, TypeError) as e:  # the yardstick only
        print(f"  library: scaled_dot_product_attention unavailable for "
              f"this case: {e}")
        return None


def _workload(cfg, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 1537, 16)
    lens[0], lens[1] = 64, 1536  # span the whole range
    return [(rng.integers(0, cfg.vocab, int(s)), 32) for s in lens]


def phase_slice(card: str, seed: int = 0):
    import numpy as np
    import torch

    from marlin_tpu_torch.models import TransformerConfig, generate
    from marlin_tpu_torch.models import transformer as tr
    from marlin_tpu_torch.ops import flash_attention as fa
    from marlin_tpu_torch.serving import ServingEngine
    from marlin_tpu_torch.serving.slots import (pad_prompt_len,
                                                prefill_into_row)
    from marlin_tpu_torch.utils import cost_model as cm

    cfg = TransformerConfig(**FLAGSHIP)
    params = tr.init_params(cfg, seed=seed, device="cuda")
    print(f"slice: flagship {FLAGSHIP}, "
          f"{cm.transformer_param_count(cfg) / 1e6:.1f} M params",
          flush=True)
    workload = _workload(cfg, seed)

    # Warm-up (cuBLAS handles, allocator) on a throwaway engine.
    warm = ServingEngine(params, cfg, batch=8, round_steps=8,
                         device="cuda")
    warm.submit(workload[0][0], 4)
    warm.run()
    torch.cuda.synchronize()

    eng = ServingEngine(params, cfg, batch=8, round_steps=8,
                         device="cuda")
    fa.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ids = {}
    done = []
    # Wave one fills 5 of the 8 rows; wave two arrives a round later, so
    # 3 of its requests are admitted beside rows that are mid-decode, and
    # the rest as rows free up.
    for prompt, steps in workload[:5]:
        ids[eng.submit(prompt, steps)] = (prompt, steps)
    done += eng.step()
    for prompt, steps in workload[5:]:
        ids[eng.submit(prompt, steps)] = (prompt, steps)
    done += eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated()

    done = {r.request_id: r for r in done}
    if len(done) != 16 or any(r.status != "done" for r in done.values()):
        fail(f"engine answered {len(done)} of 16 requests: "
             f"{[(r.request_id, r.status) for r in done.values()]}")
    admissions = eng.stats.n_admitted
    if launches != admissions * cfg.n_layers:
        fail(f"flash kernel launches {launches} != admissions {admissions} "
             f"x layers {cfg.n_layers}")
    tokens = sum(r.emitted for r in done.values())
    rounds = [e for e in eng.runlog.events("round")]
    steady = [e["round_s"] / e["iters"] for e in rounds
              if e["admitted"] == 0 and e["iters"]]
    iter_ms = 1e3 * float(np.median(steady)) if steady else None

    # Prefill alone, per padded prompt, timed on the card.
    cache = tr.init_kv_cache(cfg, 1, dtype=cfg.compute_dtype,
                             device="cuda")
    buf = torch.zeros((1, cfg.max_len), dtype=torch.long, device="cuda")
    run_params = tr._cast_params(params, cfg)
    prefill_ms = []
    for prompt, _ in workload:
        pt = torch.as_tensor(prompt, device="cuda")
        prefill_ms.append(cuda_ms(lambda: prefill_into_row(
            run_params, cache, buf, 0, pt, cfg), warmup=1, iters=3))

    # Every request against the port's own B=1 generate.
    agree = 0
    total = 0
    divergences = []
    for rid, (prompt, steps) in ids.items():
        ref = generate(params, torch.as_tensor(prompt[None]), steps,
                       cfg).cpu().numpy()[0]
        got = done[rid].tokens
        same = ref == got
        total += steps
        if same.all():
            agree += steps
            continue
        j = int(np.argmin(same))
        agree += j
        seq = np.concatenate([prompt, ref[:j]])[None]
        logits, _ = tr.prefill(params, torch.as_tensor(seq, device="cuda"),
                               cfg)
        lg = logits[0].float()
        top2 = torch.topk(lg, 2).values
        margin = (top2[0] - top2[1]).item()
        gap = (lg[int(ref[j])] - lg[int(got[j])]).item()
        ulp = 2.0 ** (math.floor(math.log2(abs(top2[0].item()))) - 7)
        divergences.append(dict(request=rid, prompt_len=len(prompt),
                                index=j, top2_margin=margin,
                                chosen_gap=gap, bf16_ulps=gap / ulp))
        # Four bf16 ulps: two runs whose matmuls accumulate in different
        # orders (batch 8 vs 1) differ by a few ulps after 8 layers of
        # bf16 rounding; a real fault moves logits by whole units.
        if abs(gap) > 4 * ulp:
            fail(f"request {rid} diverges from B=1 generate at token {j} "
                 f"with a logit gap of {gap:.4f} ({gap / ulp:.1f} bf16 "
                 f"ulps) — beyond bf16 noise")
    for d in divergences:
        print("slice: divergence " + json.dumps(d))
    summary = dict(
        card=card, requests=len(done), admissions=admissions,
        flash_launches=launches, tokens=tokens, wall_s=wall,
        tokens_per_s=tokens / wall, decode_iter_ms=iter_ms,
        prefill_ms_mean=float(np.mean(prefill_ms)),
        prefill_ms_max=float(np.max(prefill_ms)),
        prefill_padded_lens=[pad_prompt_len(len(p)) for p, _ in workload],
        peak_mem_gb=peak / 1e9,
        token_agreement=agree / total,
        requests_equal=sum(1 for rid, (p, s) in ids.items()
                           if not any(d["request"] == rid
                                      for d in divergences)),
        engine=eng.stats.summary())
    print("slice: " + json.dumps(summary, default=str), flush=True)
    phase_profile(params, cfg, workload)
    return launches


def phase_profile(params, cfg, workload):
    """Where a steady decode round's time goes: one round of 8 live rows
    (no admission) under torch.profiler, device-busy time against host
    wall-clock, and the round trip of the loop's one host sync per
    iteration (a (B,) bool copy to the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from marlin_tpu_torch.serving import ServingEngine

    eng = ServingEngine(params, cfg, batch=8, round_steps=8, device="cuda")
    for prompt, _ in workload[:8]:
        eng.submit(prompt[:64], 24)
    eng.step()  # admissions and the first round
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    iters = eng.runlog.events("round")[-1]["iters"]
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    done = torch.zeros(8, dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(200):
        done.cpu()
    sync_us = (time.perf_counter() - t1) / 200 * 1e6
    out = dict(
        round_iters=iters, wall_ms_per_iter=wall * 1e3 / iters,
        device_busy_ms_per_iter=busy_us / 1e3 / iters,
        device_idle_share=1.0 - busy_us / 1e6 / wall,
        kernel_launches_per_iter=sum(e.count for e in kernels) / iters,
        host_sync_us=sync_us,
        top_kernels=[dict(name=e.key[:60],
                          ms_per_iter=e.self_device_time_total / 1e3 / iters,
                          calls_per_iter=e.count / iters) for e in top])
    print("profile: " + json.dumps(out), flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    try:
        import marlin_tpu_torch  # noqa: F401
    except ImportError:
        fail("marlin_tpu_torch is not importable: run from the repo root")
    card = phase_device()
    phase_build()
    rows = phase_kernels()
    launches = phase_slice(card)
    flag = rows["flagship"]
    kernels = {"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "marlin_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "marlin_tpu/ops/flash_attention.py:134",
        "launches": launches,
        "max_abs_err": flag["max_abs_err"],
        "ms": flag["ms"],
        "plain_ms": flag["plain_ms"],
        "bound_ms": flag["bound_ms"],
        "bound_by": flag["bound_by"],
        "library_ms": flag["library_ms"],
    }]}
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
