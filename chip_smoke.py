#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mmlspark_tpu_torch) on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printing one JSON line:

1. build  — compiles every CUDA kernel from ``mmlspark_tpu_torch/ops/csrc``
   with nvcc for sm_90a into ``mmlspark_tpu_torch/_build/`` (one nvcc per
   source, all started together), with ptxas' register/spill report.
2. kernel — holds each kernel against its plain PyTorch version on the
   card at ragged, cross-attention and serving shapes (and on strided
   views of one qkv projection, as the model passes them), and times
   kernel, plain version and one PyTorch library call at the serving shape
   (CUDA events, median of 20 calls, 10 for the plain version, after
   warm-up), beside the least time the card could take for the same work.
3. slice  — the main path at full width: a DataFrame of 13 rows x 4096
   token ids -> ``TorchModel.transform`` (causal TransformerEncoder,
   d_model 512, 4 heads, 4 layers, vocab 32000, bfloat16, random weights
   from a numpy seed) -> scores. The flash kernel's launch count over that
   one transform must be layers x chunks; the scores must be finite and
   match the same model with plain-PyTorch blockwise attention.

Then the kernels line, the card's name and power limit as nvidia-smi prints
them, and last ``{"ok": true, "device": {...}}``. Any failure raises before
the last line; nothing falls back to the CPU. Without a CUDA device, or
outside a checkout of the repo, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np

SEED = 0
# the repo's long-context transformer width (bench_longcontext.py:35-38)
SLICE_CFG = {"type": "transformer", "vocab_size": 32000, "d_model": 512,
             "heads": 4, "layers": 4, "mlp_ratio": 4, "num_classes": 8,
             "causal": True, "max_len": 4096, "dtype": "bfloat16",
             "attn_impl": "flash"}
ROWS, SEQ, MINI_BATCH = 13, 4096, 8
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, float32
# outside the tensor cores, and device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
TOL_OUT = {"bfloat16": 2e-2, "float32": 1e-4}
TOL_LSE = 1e-3
TOL_SLICE = 5e-2


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok: bool, msg: str):
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def attention_bound_ms(B, H, Tq, Tk, D, causal, dtype_name) -> dict:
    """Least time for one forward: the larger of its operations over the
    card's peak for the type and its bytes (q, k, v read once, out and lse
    written once) over the memory rate. Causal work counts only the
    (query, key) pairs the top-left mask leaves visible."""
    pairs = (sum(min(i + 1, Tk) for i in range(Tq)) if causal else Tq * Tk)
    flops = 4.0 * B * H * D * pairs            # QK^T and PV, 2 FLOP per MAC
    esize = 2 if dtype_name == "bfloat16" else 4
    nbytes = esize * B * H * D * (2 * Tq + 2 * Tk) + 4 * B * H * Tq
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def phase_build(torch, env):
    from mmlspark_tpu_torch.ops import _build
    t0 = time.perf_counter()
    report = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {k: {"path": v["path"], "ptxas": v["ptxas"]}
                      for k, v in report.items()},
          "gpu": env.gpu_name_and_power_limit(),
          "torch": torch.__version__, "cuda": torch.version.cuda})


def phase_kernel(torch):
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_reference)
    # a float32 reference runs in full float32 (the card's defaults differ
    # between matmul and cuDNN); the kernel never uses TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for D in (64, 128):
            for causal in (False, True):
                cases.append((2, 1000, 1000, 2, D, causal, dtype, False))
                cases.append((1, 333, 1000, 2, D, causal, dtype, False))
                cases.append((2, 1000, 1000, 2, D, causal, dtype, True))
    cases.append((8, SEQ, SEQ, 4, 128, True, torch.bfloat16, False))  # slice
    worst = {"out": 0.0, "lse": 0.0}
    results = []
    for B, Tq, Tk, H, D, causal, dtype, packed in cases:
        def rnd(T, heads=H):
            return torch.randn((B, T, heads, D), generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
        if packed:      # strided views of one (B, T, 3H, D) projection
            q, k, v = rnd(Tq, 3 * H).split(H, dim=2)
        else:
            q, k, v = rnd(Tq), rnd(Tk), rnd(Tk)
        out, lse = flash_attention_fwd(q, k, v, causal=causal)
        ref_out, ref_lse = flash_attention_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        e_out = (out.float() - ref_out.float()).abs().max().item()
        e_lse = (lse - ref_lse).abs().max().item()
        name = str(dtype).replace("torch.", "")
        case = {"B": B, "Tq": Tq, "Tk": Tk, "H": H, "D": D,
                "causal": causal, "dtype": name, "qkv_views": packed,
                "out_err": e_out, "lse_err": e_lse}
        results.append(case)
        check(out.shape == q.shape and lse.shape == (B * H, Tq),
              f"kernel output shapes {case}")
        check(e_out <= TOL_OUT[name] and e_lse <= TOL_LSE,
              f"kernel disagrees with its plain version: {case}")
        worst["out"] = max(worst["out"], e_out)
        worst["lse"] = max(worst["lse"], e_lse)
        del q, k, v, out, lse, ref_out, ref_lse

    B, Tq, Tk, H, D, causal, dtype, _ = cases[-1]
    q, k, v = (torch.randn((B, T, H, D), generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)
               for T in (Tq, Tk, Tk))
    kernel_ms = cuda_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=True))
    plain_ms = cuda_ms(torch, lambda: flash_attention_reference(
        q, k, v, causal=True), iters=10)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(torch, lambda: sdpa(qh, kh, vh, is_causal=True))
    bound = attention_bound_ms(B, H, Tq, Tk, D, causal, "bfloat16")
    timing = {"shape": [B, Tq, H, D], "causal": causal, "dtype": "bfloat16",
              "kernel_ms": kernel_ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "library": "torch sdpa",
              "achieved_tflops": bound["flops"] / kernel_ms / 1e9, **bound}
    emit({"phase": "kernel", "cases": results, "max_out_err": worst["out"],
          "max_lse_err": worst["lse"], "timing": timing})
    return worst, timing


def slice_params(rng) -> dict:
    """Random weights of SLICE_CFG in the JAX package's flax tree shape
    (GPT-2-style init: normal, std 0.02; LayerNorm scale 1, biases 0)."""
    V, d, L = SLICE_CFG["vocab_size"], SLICE_CFG["d_model"], SLICE_CFG["layers"]
    hid, C = SLICE_CFG["mlp_ratio"] * d, SLICE_CFG["num_classes"]

    def w(*shape):
        return (rng.standard_normal(shape, dtype=np.float32) * 0.02)

    def ln():
        return {"scale": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}

    p = {"Embed_0": {"embedding": w(V, d)},
         "Embed_1": {"embedding": w(SLICE_CFG["max_len"], d)},
         "LayerNorm_0": ln(),
         "Dense_0": {"kernel": w(d, C), "bias": np.zeros(C, np.float32)}}
    for i in range(L):
        p[f"block{i}"] = {
            "LayerNorm_0": ln(), "LayerNorm_1": ln(),
            "Dense_0": {"kernel": w(d, 3 * d)},
            "Dense_1": {"kernel": w(d, d)},
            "Dense_2": {"kernel": w(d, hid), "bias": np.zeros(hid, np.float32)},
            "Dense_3": {"kernel": w(hid, d), "bias": np.zeros(d, np.float32)}}
    return {"params": p}


def device_breakdown(torch, fn, top: int = 8) -> dict:
    """One call of ``fn`` under torch.profiler: the card's busy time (the
    sum of its kernels' times) and share of the host wall clock, and the
    kernels that took most of it. The profiler slows the host, so the
    share is a floor of the unprofiled run's."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(k[1] for k in kernels)
    kernels.sort(key=lambda k: -k[1])
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "top_kernels": [{"name": n[:90], "ms": us / 1e3, "calls": c}
                            for n, us, c in kernels[:top]]}


def phase_slice(torch, env):
    from mmlspark_tpu_torch import DataFrame, TorchModel
    from mmlspark_tpu_torch.ops.flash_attention import flash_attention_fwd
    rng = np.random.default_rng(SEED)
    params = slice_params(rng)
    tokens = rng.integers(0, SLICE_CFG["vocab_size"], size=(ROWS, SEQ),
                          dtype=np.int32)
    df = DataFrame({"tokens": tokens})
    model = TorchModel(inputCol="tokens", outputCol="scores",
                       modelConfig=SLICE_CFG, modelParams=params,
                       miniBatchSize=MINI_BATCH, device="cuda")
    t0 = time.perf_counter()
    model.warmup(df)
    warmup_s = time.perf_counter() - t0

    flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    scored = model.transform(df)          # read-back synchronises the card
    first_s = time.perf_counter() - t0
    launches = flash_attention_fwd.launches
    chunks = -(-ROWS // MINI_BATCH)
    check(launches == SLICE_CFG["layers"] * chunks,
          f"flash kernel launched {launches} times in one transform, "
          f"expected layers x chunks = {SLICE_CFG['layers'] * chunks}")
    scores = np.stack(scored.col("scores"))
    check(scores.shape == (ROWS, SLICE_CFG["num_classes"]),
          f"scores shape {scores.shape}")
    check(bool(np.isfinite(scores).all()), "non-finite scores")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        model.transform(df)
        times.append(time.perf_counter() - t0)
    steady_s = statistics.median(times)
    breakdown = device_breakdown(torch, lambda: model.transform(df))

    before = flash_attention_fwd.launches
    plain = TorchModel(inputCol="tokens", outputCol="scores",
                       modelConfig=dict(SLICE_CFG, attn_impl="blockwise"),
                       modelParams=params, miniBatchSize=MINI_BATCH,
                       device="cuda")
    ref = np.stack(plain.transform(df).col("scores"))
    check(flash_attention_fwd.launches == before,
          "the blockwise reference launched the flash kernel")
    err = float(np.abs(scores - ref).max())
    check(err <= TOL_SLICE, f"flash scores differ from blockwise by {err}")
    emit({"phase": "slice", "config": SLICE_CFG, "rows": ROWS, "seq": SEQ,
          "mini_batch": MINI_BATCH, "flash_launches": launches,
          "chunks": chunks, "max_abs_err_vs_blockwise": err,
          "warmup_s": warmup_s, "first_transform_s": first_s,
          "steady_transform_s": steady_s, "rows_per_s": ROWS / steady_s,
          "tokens_per_s": ROWS * SEQ / steady_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "gpu": env.gpu_name_and_power_limit(),
          "profile_of_one_transform": breakdown})
    return launches


def main() -> int:
    try:
        import torch
        from mmlspark_tpu_torch.core import env
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout of the repo "
              f"({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 2
    check(env.gpu_name_and_power_limit() is not None,
          "nvidia-smi did not report the card's name and power limit")
    phase_build(torch, env)
    worst, timing = phase_kernel(torch)
    launches = phase_slice(torch, env)
    emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mmlspark_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "mmlspark_tpu/ops/pallas_kernels.py:45",
        "launches": launches, "max_abs_err": worst["out"],
        "max_err": worst["out"], "max_lse_err": worst["lse"],
        "ms": timing["kernel_ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"]}]})
    print(env.gpu_name_and_power_limit(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
