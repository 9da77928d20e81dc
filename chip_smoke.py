#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mmlspark_tpu_torch) on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printing one JSON line:

1. build  — compiles every CUDA kernel source in
   ``mmlspark_tpu_torch/ops/csrc`` (the flash-attention forward and the dq
   and dk/dv backward) with nvcc for sm_90a into
   ``mmlspark_tpu_torch/_build/`` (one nvcc per source, all started
   together), with ptxas' register/spill report for each.
2. kernel — holds the forward kernel against its plain PyTorch version on
   the card at ragged, cross-attention and slice shapes (and on strided
   views of one qkv projection, as the model passes them), and times
   kernel, plain version and one PyTorch library call at the slice shape
   (CUDA events, median of 20 calls, 10 for the plain version, after
   warm-up), beside the least time the card could take for the same work.
3. kernel_bwd — the same for the dq and dk/dv backward kernels over the
   same cases (per gradient, max |kernel - plain| / max(1, max |plain|)
   and ||kernel - plain||_2 / ||plain||_2), timing each kernel, the wrapper, the plain version and the backward of
   ``scaled_dot_product_attention`` at the slice shape.
4. slice  — the serving path at full width: a DataFrame of 13 rows x 4096
   token ids -> ``TorchModel.transform`` (causal TransformerEncoder,
   d_model 512, 4 heads, 4 layers, vocab 32000, bfloat16, random weights
   from a numpy seed) -> scores. The forward kernel's launch count over
   that one transform must be layers x chunks; the scores must be finite
   and match the same model with plain-PyTorch blockwise attention.
5. train  — the training path at the same width (remat on, bf16 over f32
   masters): 32 rows x 4096 tokens with numpy-seeded labels ->
   ``TorchLearner(optimizer="adam", learningRate=1e-3, batchSize=8,
   epochs=2).fit`` -> a TorchModel that serves the slice's rows. Over the
   fit the forward kernel must launch layers x steps x 2 times (remat runs
   each block's forward again in the backward) and each backward kernel
   layers x steps times; every epoch loss must be finite and within 5e-2
   of the same fit with blockwise attention, and of the same fit on the
   per-step feed path; one step's gradients must match blockwise attention
   parameter by parameter. Also one short bf16_mixed fit, step time and
   training tokens/s over epochs 2-4 of a 16-step-per-epoch fit, peak
   memory, and the profile of one step.

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
# the training slice: bench_longcontext.py:35-38 with remat, adam (:44)
TRAIN_CFG = dict(SLICE_CFG, remat=True)
TRAIN_ROWS, TRAIN_BATCH, TRAIN_EPOCHS = 32, 8, 2
TOL_TRAIN = 5e-2
# the timed fit: 16 steps per epoch, step time over epochs 2..4
TIMED_ROWS, TIMED_EPOCHS = 128, 4
# one full-width step's gradients, flash against blockwise attention, per
# parameter: ||flash - blockwise||_2 / ||blockwise||_2 (read at most
# 8.8e-3 on an H100; a zeroed dq reads 1.0 on its third of qkv)
TOL_TRAIN_GRAD = 3e-2
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, float32
# outside the tensor cores, and device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
TOL_OUT = {"bfloat16": 2e-2, "float32": 1e-4}
# the backward also on ||kernel - plain||_2 / ||plain||_2 per gradient,
# which the large gradients of early causal rows cannot swamp (read at
# most 2.3e-4 in bf16 and 2.4e-7 in f32 on an H100)
TOL_BWD_L2 = {"bfloat16": 2e-3, "float32": 2e-6}
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


def visible_pairs(Tq, Tk, causal) -> int:
    """(query, key) pairs the top-left causal mask leaves visible."""
    return sum(min(i + 1, Tk) for i in range(Tq)) if causal else Tq * Tk


def bound(flops, nbytes, dtype_name) -> dict:
    """Least time for work of ``flops`` operations that must move
    ``nbytes``: the larger of the two over the card's peak rates."""
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def attention_bound_ms(B, H, Tq, Tk, D, causal, dtype_name) -> dict:
    """Least time for one forward: its operations (QK^T and PV, 2 FLOP per
    MAC, over the visible pairs) and its bytes (q, k, v read once, out and
    lse written once)."""
    esize = 2 if dtype_name == "bfloat16" else 4
    return bound(4.0 * B * H * D * visible_pairs(Tq, Tk, causal),
                 esize * B * H * D * (2 * Tq + 2 * Tk) + 4 * B * H * Tq,
                 dtype_name)


def attention_bwd_bounds(B, H, Tq, Tk, D, causal, dtype_name) -> dict:
    """Least time for each backward kernel. Both read q, k, v, dO, lse and
    D once; dq does three products per visible pair (S, dP, dS K) and
    writes dq, dk/dv does four (S^T, dP^T, P^T dO, dS^T Q) and writes dk
    and dv."""
    esize = 2 if dtype_name == "bfloat16" else 4
    pairs = B * H * visible_pairs(Tq, Tk, causal)
    reads = esize * B * H * D * (2 * Tq + 2 * Tk) + 2 * 4 * B * H * Tq
    return {"dq": bound(6.0 * D * pairs, reads + esize * B * H * Tq * D,
                        dtype_name),
            "dkv": bound(8.0 * D * pairs,
                         reads + 2 * esize * B * H * Tk * D, dtype_name)}


def attention_cases(torch) -> list:
    """(B, Tq, Tk, H, D, causal, dtype, qkv_views): both types and head
    dims, both masks, ragged and cross-attention lengths, strided views of
    one (B, T, 3H, D) projection as the model passes them, and last the
    training and serving slices' shape."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for D in (64, 128):
            for causal in (False, True):
                cases.append((2, 1000, 1000, 2, D, causal, dtype, False))
                cases.append((1, 333, 1000, 2, D, causal, dtype, False))
                cases.append((2, 1000, 1000, 2, D, causal, dtype, True))
    cases.append((8, SEQ, SEQ, 4, 128, True, torch.bfloat16, False))
    return cases


def random_qkv(torch, gen, B, Tq, Tk, H, D, dtype, views):
    def rnd(T, heads=H):
        return torch.randn((B, T, heads, D), generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)
    if views:       # strided views of one (B, T, 3H, D) projection
        return rnd(Tq, 3 * H).split(H, dim=2)
    return rnd(Tq), rnd(Tk), rnd(Tk)


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
    cases = attention_cases(torch)
    worst = {"out": 0.0, "lse": 0.0}
    results = []
    for B, Tq, Tk, H, D, causal, dtype, packed in cases:
        q, k, v = random_qkv(torch, gen, B, Tq, Tk, H, D, dtype, packed)
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
    q, k, v = random_qkv(torch, gen, B, Tq, Tk, H, D, dtype, False)
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


def phase_kernel_bwd(torch):
    """The dq and dk/dv kernels against their plain version over the
    forward phase's cases, then timed at the training slice's shape."""
    from mmlspark_tpu_torch.ops.flash_attention import (
        _BwdLaunch, flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_fwd)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst = {"dq": 0.0, "dkv": 0.0, "dq_abs": 0.0, "dkv_abs": 0.0,
             "dq_l2": 0.0, "dkv_l2": 0.0}
    results = []
    cases = attention_cases(torch)
    for B, Tq, Tk, H, D, causal, dtype, packed in cases:
        q, k, v = random_qkv(torch, gen, B, Tq, Tk, H, D, dtype, packed)
        do = torch.randn((B, Tq, H, D), generator=gen, device="cuda",
                         dtype=torch.float32).to(dtype)
        out, lse = flash_attention_fwd(q, k, v, causal=causal)
        got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        ref = flash_attention_bwd_reference(q, k, v, out, lse, do,
                                            causal=causal)
        torch.cuda.synchronize()
        # max |kernel - plain|, and over max(1, max |plain|), per gradient
        abs_err = {n: (g.float() - r.float()).abs().max().item()
                   for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
        err = {n: abs_err[n] / max(1.0, r.float().abs().max().item())
               for n, r in zip(("dq", "dk", "dv"), ref)}
        l2 = {n: ((g.float() - r.float()).norm()
                  / r.float().norm().clamp_min(1e-30)).item()
              for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
        name = str(dtype).replace("torch.", "")
        case = {"B": B, "Tq": Tq, "Tk": Tk, "H": H, "D": D,
                "causal": causal, "dtype": name, "qkv_views": packed,
                "dq_err": err["dq"], "dk_err": err["dk"],
                "dv_err": err["dv"], "dq_l2": l2["dq"], "dk_l2": l2["dk"],
                "dv_l2": l2["dv"]}
        results.append(case)
        check(all(g.shape == x.shape and g.dtype == x.dtype
                  for g, x in zip(got, (q, k, v))),
              f"backward output shapes/types {case}")
        check(all(e <= TOL_OUT[name] for e in err.values())
              and all(e <= TOL_BWD_L2[name] for e in l2.values()),
              f"backward kernels disagree with their plain version: {case}")
        worst["dq"] = max(worst["dq"], err["dq"])
        worst["dkv"] = max(worst["dkv"], err["dk"], err["dv"])
        worst["dq_abs"] = max(worst["dq_abs"], abs_err["dq"])
        worst["dkv_abs"] = max(worst["dkv_abs"], abs_err["dk"],
                               abs_err["dv"])
        worst["dq_l2"] = max(worst["dq_l2"], l2["dq"])
        worst["dkv_l2"] = max(worst["dkv_l2"], l2["dk"], l2["dv"])
        del q, k, v, do, out, lse, got, ref

    B, Tq, Tk, H, D, causal, dtype, _ = cases[-1]
    q, k, v = random_qkv(torch, gen, B, Tq, Tk, H, D, dtype, False)
    do = torch.randn((B, Tq, H, D), generator=gen, device="cuda",
                     dtype=torch.float32).to(dtype)
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    call = _BwdLaunch(q, k, v, out, lse, do, True, 1.0 / D ** 0.5)
    dq_ms = cuda_ms(torch, call.dq_kernel)
    dkv_ms = cuda_ms(torch, call.dkv_kernel)
    total_ms = cuda_ms(torch, lambda: flash_attention_bwd(
        q, k, v, out, lse, do, causal=True))
    plain_ms = cuda_ms(torch, lambda: flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=True), iters=10)
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    oh = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh,
                                                          is_causal=True)
    doh = do.transpose(1, 2).contiguous()
    library_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        oh, (qh, kh, vh), doh, retain_graph=True))
    bounds = attention_bwd_bounds(B, H, Tq, Tk, D, causal, "bfloat16")
    timing = {"shape": [B, Tq, H, D], "causal": causal, "dtype": "bfloat16",
              "dq_ms": dq_ms, "dkv_ms": dkv_ms, "wrapper_ms": total_ms,
              "plain_ms": plain_ms, "library_ms": library_ms,
              "library": "torch sdpa backward (dq, dk, dv together)",
              "dq_bound": bounds["dq"], "dkv_bound": bounds["dkv"],
              "dq_tflops": bounds["dq"]["flops"] / dq_ms / 1e9,
              "dkv_tflops": bounds["dkv"]["flops"] / dkv_ms / 1e9}
    emit({"phase": "kernel_bwd", "cases": results,
          "max_dq_err": worst["dq"], "max_dkv_err": worst["dkv"],
          "max_dq_l2": worst["dq_l2"], "max_dkv_l2": worst["dkv_l2"],
          "timing": timing})
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


def kernel_counts():
    from mmlspark_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                        flash_attention_fwd)
    return {"fwd": flash_attention_fwd.launches,
            "dq": flash_attention_bwd.launches_dq,
            "dkv": flash_attention_bwd.launches_dkv}


def reset_kernel_counts():
    from mmlspark_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                        flash_attention_fwd)
    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches_dq = 0
    flash_attention_bwd.launches_dkv = 0


def one_step_profile(torch, tokens, labels) -> dict:
    """device_breakdown of one optimizer step of the training slice (the
    fit's step body, on the fit's first batch, after one warm-up step)."""
    from mmlspark_tpu_torch.models import trainer
    from mmlspark_tpu_torch.models.modules import build_model
    with torch.device("meta"):
        module = build_model(TRAIN_CFG)
    params = {k: v.cuda() for k, v in
              trainer.init_params(TRAIN_CFG, SEED).items()}
    tx = trainer.make_optimizer("adam", 1e-3)
    body = trainer._make_step_body(
        module, tx, trainer.make_loss("cross_entropy", per_example=True))
    xb = torch.from_numpy(tokens[:TRAIN_BATCH]).cuda()
    yb = torch.from_numpy(labels[:TRAIN_BATCH]).cuda()
    wb = torch.ones(TRAIN_BATCH, device="cuda")
    state = [params, tx.init(params)]

    def step():
        state[0], state[1], _ = body(state[0], state[1], xb, yb, wb)

    step()
    return device_breakdown(torch, step, top=10)


def step_grad_errors(torch, cfg, tokens, labels, device="cuda") -> dict:
    """One step's gradients (the fit's init, loss and batch size, on the
    first rows) through flash attention against blockwise attention, per
    parameter (the fused qkv projection by its q, k and v thirds):
    max |flash - blockwise| / max |blockwise| and
    ||flash - blockwise||_2 / ||blockwise||_2. Under ``cfg``'s remat the
    flash forward runs again inside the backward, so this holds the
    autograd wiring of the kernels, not only the kernels."""
    from mmlspark_tpu_torch.models import precision as prec
    from mmlspark_tpu_torch.models import trainer
    from mmlspark_tpu_torch.models.modules import build_model
    params = {k: v.to(device) for k, v in
              trainer.init_params(cfg, SEED).items()}
    loss_fn = trainer.make_loss("cross_entropy", per_example=True)
    xb = torch.from_numpy(tokens[:TRAIN_BATCH]).to(device)
    yb = torch.from_numpy(labels[:TRAIN_BATCH]).to(device)
    wb = torch.ones(TRAIN_BATCH, device=device)
    grads = {}
    for impl in ("flash", "blockwise"):
        with torch.device("meta"):
            module = build_model(dict(cfg, attn_impl=impl))
        _, grads[impl] = prec.value_and_grad(
            trainer._make_loss_compute(module, loss_fn), params, xb, yb, wb)
    pairs = {}
    for k, ref in grads["blockwise"].items():
        got = grads["flash"][k]
        if k.endswith("qkv.weight"):
            # the q, k and v rows apart, so a wrong dq, dk or dv shows on
            # its own third of the projection
            for part, g, r in zip("qkv", got.chunk(3), ref.chunk(3)):
                pairs[f"{k}[{part}]"] = (g, r)
        else:
            pairs[k] = (got, ref)
    errs = {}
    for k, (got, ref) in pairs.items():
        diff = got.float() - ref.float()
        errs[k] = {"max_rel": (diff.abs().max()
                               / ref.abs().max().clamp_min(1e-30)).item(),
                   "l2_rel": (diff.norm()
                              / ref.norm().clamp_min(1e-30)).item()}
    return errs


def phase_train(torch, env):
    from mmlspark_tpu_torch import DataFrame, TorchLearner
    rng = np.random.default_rng(SEED + 2)
    tokens = rng.integers(0, TRAIN_CFG["vocab_size"], size=(TRAIN_ROWS, SEQ),
                          dtype=np.int32)
    labels = rng.integers(0, TRAIN_CFG["num_classes"], size=TRAIN_ROWS,
                          dtype=np.int32)
    df = DataFrame({"tokens": tokens, "label": labels})

    def learner(**kw):
        cfg = dict(TRAIN_CFG, **kw.pop("cfg", {}))
        return TorchLearner(featuresCol="tokens", modelConfig=cfg,
                            optimizer="adam", learningRate=1e-3,
                            batchSize=TRAIN_BATCH,
                            epochs=kw.pop("epochs", TRAIN_EPOCHS), seed=SEED,
                            device="cuda", **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    t0 = time.perf_counter()
    model = learner().fit(df)
    fit_s = time.perf_counter() - t0
    launches = kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = model._fit_stats
    steps = stats["steps_per_epoch"] * TRAIN_EPOCHS
    L = TRAIN_CFG["layers"]
    check(launches["fwd"] == L * steps * 2,
          f"forward kernel launched {launches['fwd']} times in the fit, "
          f"expected layers x steps x 2 = {L * steps * 2}")
    check(launches["dq"] == launches["dkv"] == L * steps,
          f"backward kernels launched {launches['dq']} (dq) and "
          f"{launches['dkv']} (dk/dv) times, expected layers x steps = "
          f"{L * steps}")
    losses = stats["epoch_losses"]
    check(len(losses) == TRAIN_EPOCHS and all(np.isfinite(losses)),
          f"epoch losses {losses}")

    before = kernel_counts()
    ref = learner(cfg={"attn_impl": "blockwise"}).fit(df)
    check(kernel_counts() == before,
          "the blockwise reference fit launched a flash kernel")
    ref_losses = ref._fit_stats["epoch_losses"]
    loss_err = max(abs(a - b) for a, b in zip(losses, ref_losses))
    check(loss_err <= TOL_TRAIN,
          f"flash fit losses {losses} differ from blockwise {ref_losses}")

    # the feed path (pinned host batches copied from the prefetch thread)
    # draws the same batches as the scan path's per-epoch reshuffle
    feed = learner(deviceDataCap=1).fit(df)
    feed_losses = feed._fit_stats["epoch_losses"]
    check(feed._fit_stats["path"] == "feed"
          and max(abs(a - b) for a, b in zip(losses, feed_losses))
          <= TOL_TRAIN,
          f"feed-path fit losses {feed_losses} vs scan path {losses}")

    grad_errs = step_grad_errors(torch, TRAIN_CFG, tokens, labels)
    worst_grad = max(grad_errs, key=lambda k: grad_errs[k]["l2_rel"])
    emit({"phase": "train_grads", "vs": "blockwise attention",
          "per_param": grad_errs, "worst": worst_grad,
          "worst_l2_rel": grad_errs[worst_grad]["l2_rel"],
          "tol_l2_rel": TOL_TRAIN_GRAD})
    check(grad_errs[worst_grad]["l2_rel"] <= TOL_TRAIN_GRAD,
          f"one step's gradient of {worst_grad} differs from blockwise "
          f"attention's: {grad_errs[worst_grad]}")

    serve = np.random.default_rng(SEED).integers(
        0, TRAIN_CFG["vocab_size"], size=(ROWS, SEQ), dtype=np.int32)
    scores = np.stack(model.setInputCol("tokens").setMiniBatchSize(MINI_BATCH)
                      .transform(DataFrame({"tokens": serve})).col("scores"))
    check(scores.shape == (ROWS, TRAIN_CFG["num_classes"])
          and bool(np.isfinite(scores).all()),
          f"the trained model's scores: shape {scores.shape}, finite "
          f"{bool(np.isfinite(scores).all())}")

    mixed = learner(precision="bf16_mixed", epochs=1).fit(
        DataFrame({"tokens": tokens[:TRAIN_BATCH],
                   "label": labels[:TRAIN_BATCH]}))
    check(np.isfinite(mixed._final_loss), "bf16_mixed fit loss")

    # the end-to-end training metric: a 16-step-per-epoch fit, whose
    # epochs 2..4 (each ending in its one host read of the loss) are timed
    timed_rng = np.random.default_rng(SEED + 3)
    timed = learner(epochs=TIMED_EPOCHS).fit(DataFrame({
        "tokens": timed_rng.integers(0, TRAIN_CFG["vocab_size"],
                                     size=(TIMED_ROWS, SEQ), dtype=np.int32),
        "label": timed_rng.integers(0, TRAIN_CFG["num_classes"],
                                    size=TIMED_ROWS, dtype=np.int32)}))
    timed_steps = timed._fit_stats["steps_per_epoch"]
    timed_ms = [t / timed_steps * 1e3
                for t in timed._fit_stats["epoch_seconds"][1:]]
    check(all(np.isfinite(timed._fit_stats["epoch_losses"])),
          f"timed fit losses {timed._fit_stats['epoch_losses']}")
    step_ms = statistics.median(timed_ms)
    per_epoch = stats["steps_per_epoch"]
    emit({"phase": "train", "config": TRAIN_CFG, "rows": TRAIN_ROWS,
          "seq": SEQ, "batch": TRAIN_BATCH, "epochs": TRAIN_EPOCHS,
          "optimizer": "adam", "learning_rate": 1e-3, "path": stats["path"],
          "steps": steps, "launches": launches,
          "epoch_losses": losses, "blockwise_epoch_losses": ref_losses,
          "max_loss_diff_vs_blockwise": loss_err,
          "fit_s": fit_s, "epoch_seconds": stats["epoch_seconds"],
          "timed_fit": {"rows": TIMED_ROWS, "epochs": TIMED_EPOCHS,
                        "steps_per_epoch": timed_steps,
                        "step_ms_by_epoch": timed_ms},
          "step_ms": step_ms,
          "train_tokens_per_s": TRAIN_BATCH * SEQ / step_ms * 1e3,
          "max_grad_l2_rel_vs_blockwise": grad_errs[worst_grad]["l2_rel"],
          "blockwise_step_ms": ref._fit_stats["epoch_seconds"][1]
          / per_epoch * 1e3,
          "feed_epoch_losses": feed_losses,
          "feed_step_ms": feed._fit_stats["epoch_seconds"][1]
          / per_epoch * 1e3,
          "peak_mem_gb": peak_gb,
          "bf16_mixed": {"loss": mixed._final_loss,
                         "scale_state": mixed._fit_stats["scale_state"]},
          "served_rows": ROWS, "gpu": env.gpu_name_and_power_limit(),
          "profile_of_one_step": one_step_profile(torch, tokens, labels)})
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
    bwd_worst, bwd = phase_kernel_bwd(torch)
    serve_launches = phase_slice(torch, env)
    train = phase_train(torch, env)
    csrc = "mmlspark_tpu_torch/ops/csrc/"
    replaces = "mmlspark_tpu/ops/pallas_kernels.py:"
    emit({"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": csrc + "flash_attention_fwd.cu",
         "replaces": replaces + "45", "launches": train["fwd"],
         "launches_by_path": {"serve": serve_launches,
                              "train": train["fwd"]},
         "max_abs_err": worst["out"], "max_err": worst["out"],
         "max_lse_err": worst["lse"],
         "ms": timing["kernel_ms"], "plain_ms": timing["plain_ms"],
         "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
         "library_ms": timing["library_ms"]},
        # the plain and library times cover the whole backward (dq, dk and
        # dv together): no single call computes one kernel's part
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": csrc + "flash_attention_bwd.cu",
         "replaces": replaces + "107", "launches": train["dq"],
         "max_abs_err": bwd_worst["dq_abs"], "max_err": bwd_worst["dq"],
         "max_rel_l2_err": bwd_worst["dq_l2"],
         "ms": bwd["dq_ms"], "plain_ms": bwd["plain_ms"],
         "bound_ms": bwd["dq_bound"]["bound_ms"],
         "bound_by": bwd["dq_bound"]["bound_by"],
         "library_ms": bwd["library_ms"]},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": csrc + "flash_attention_bwd.cu",
         "replaces": replaces + "155", "launches": train["dkv"],
         "max_abs_err": bwd_worst["dkv_abs"], "max_err": bwd_worst["dkv"],
         "max_rel_l2_err": bwd_worst["dkv_l2"],
         "ms": bwd["dkv_ms"], "plain_ms": bwd["plain_ms"],
         "bound_ms": bwd["dkv_bound"]["bound_ms"],
         "bound_by": bwd["dkv_bound"]["bound_by"],
         "library_ms": bwd["library_ms"]}]})
    print(env.gpu_name_and_power_limit(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
