#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mmlspark_tpu_torch) on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout
    python3 chip_smoke.py --phases build,kernel_gbdt   # a rehearsal

Phases, each printing one JSON line:

1. build  — compiles every CUDA kernel source in
   ``mmlspark_tpu_torch/ops/csrc`` (the flash-attention forward, the dq
   and dk/dv backward, the GBDT histograms and the GBDT predicts) with nvcc
   for sm_90a into
   ``mmlspark_tpu_torch/_build/`` (one nvcc per source, all started
   together), with ptxas' register/spill report for each; the lines of the
   three warp-specialised wgmma kernels (the bf16 forward, dq and dk/dv,
   ``WGMMA_ENTRIES``) are printed apart and must show no spill and no
   serialised wgmma at either head dim. For the GBDT histogram library it
   prints ptxas' lines of ``hist_accumulate`` and, from ``cuobjdump
   -sass``, the atomic instructions of each of its instantiations (shared
   ``ATOMS`` and compare-and-swap forms counted apart; "not available"
   without cuobjdump). For the GBDT predict library it prints ptxas' lines
   of both kernels, which must show no spill, and each instantiation's
   SASS counts (instructions, shared loads, integer-pipe instructions,
   opcodes), the dump written to ``chiprun_out/gbdt_predict.sass``.
2. kernel — holds the forward kernel against its plain PyTorch version on
   the card at ragged, cross-attention and slice shapes (and on strided
   views of one qkv projection, as the model passes them), and in bf16 at
   the lengths where its 128-row and 128-key tiles and TMA's boxes meet
   the data (``TILE_EDGES``, both head dims and masks, views at ragged T).
   It times the kernel on contiguous operands and on qkv views, and one
   PyTorch library call, in three alternating rounds at the slice shape,
   and the plain version, beside the least time the card could take for
   the same work, the achieved TFLOP/s and the share of that bound. Every
   time in this script is CUDA events around 20 back-to-back calls (10
   for plain versions) over the count, the median of three such rounds,
   after warm-up.
3. kernel_bwd — first the two wgmma forms the bf16 backward adds, on one
   tile against ``torch.matmul`` (``wgmma_probe``); then the dq and dk/dv
   backward kernels over the same cases, with the backward's 64-row tile
   edges too (``BWD_TILE_EDGES``, views also at T = 65), per gradient
   max |kernel - plain| / max(1, max |plain|) and
   ||kernel - plain||_2 / ||plain||_2 (the latter skipped, and named, only
   for the gradients that are zero in exact arithmetic: rows that see one
   key); timing each kernel, the wrapper, the plain version and the
   backward of ``scaled_dot_product_attention`` at the slice shape, with D
   as the dq kernel writes it held against the plain row dot and a repeat
   that must give the same bits.
4. kernel_gbdt — the node histogram, the fused histogram and the quantized
   level-wise and leaf-wise predicts against their plain versions at edge
   shapes (ragged rows, odd feature counts, 1-64 nodes, out-of-range node
   ids and bins, 16/255/256 bins, combined ids to 64 x 255, the 255
   sentinel, K = 3, int8-scaled leaves, tables past shared memory (taken
   in chunks of trees), depth 0 and 7; leaf-wise also -1 no-op rounds, a
   tree that stops at round 0, R = 127 rounds and the pointer trees' edges,
   ``LW_EDGES``) and at the slices' (1M x 28 rows, 16 nodes, 100 trees of
   depth 5, 100 leaf-wise trees of 30 rounds); two launches on the same
   inputs must give the same bits, and the predicts must equal their plain
   versions bit for bit (and, on the small cases, their arithmetic in
   plain PyTorch, ``quant_*_kernel_arithmetic``). The histograms must also
   equal their fixed-point
   arithmetic in plain PyTorch bit for bit (``*_kernel_arithmetic``: the
   integer sums are exact), give the same bits on the same rows permuted,
   and give the float64 plain version's NaN/+inf/-inf on non-finite g;
   cases with all-zero g, one outlier of 1e3, one row, and the leaf-wise
   round's 2 nodes with the other rows' id out of range. Each kernel is
   timed beside its plain version, its bound and (the histograms) two
   ``torch.bincount`` calls: the predicts at the slice shape
   (``predict_timings``, with the profiler's device time of the kernel and,
   leaf-wise, the trees' path lengths), the histograms at every shape their
   paths launch (``hist_timings``), each with the profile of one call.
5. slice  — the serving path at full width: a DataFrame of 13 rows x 4096
   token ids -> ``TorchModel.transform`` (causal TransformerEncoder,
   d_model 512, 4 heads, 4 layers, vocab 32000, bfloat16, random weights
   from a numpy seed) -> scores. The forward kernel's launch count over
   that one transform must be layers x chunks; the scores must be finite
   and match the same model with plain-PyTorch blockwise attention.
6. train  — the training path at the same width (remat on, bf16 over f32
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
7. gbdt   — the GBDT slice at full size: bench_gbdt.py's 1M x 28 rows ->
   ``LightGBMClassifier(device="cuda").fit`` with default Params (depthwise
   to depth 5, 100 trees, maxBin 255) -> ``transform`` with predictImpl
   auto. The node-histogram kernel must launch 500 times per fit and the
   predict kernel once per transform; a second fit must give the same
   bits; the first 10 trees must equal those of the segment-histogram fit
   (the plain path on the card) and its training log-loss agree within
   1e-4; a 10-iteration hist_impl="pallas" fit (the fused kernel) must
   grow the segment fit's trees; the kernel's raw scores must be within
   1e-3 (relative) of the dense walk's, labels differing only where the
   margin is within that delta; training accuracy >= 0.85. Prints the
   warm fit seconds and their parts, ms per iteration, transform rows/s,
   peak memory, the profile of one boosting iteration and the predict
   kernel timed alone on the fitted trees' own tables and the fit's bins
   (``fitted_predict_timing``).

8. gbdt_leafwise — the leaf-wise GBDT slice on the same 1M x 28 rows:
   ``LightGBMClassifier(device="cuda").setGrowthPolicy("leafwise")`` (31
   leaves best-first, maxDepth 0, 100 trees, maxBin 255: native LightGBM's
   defaults) -> ``transform`` with predictImpl auto. The node histogram
   must launch 31 x 100 times per fit (2 nodes a round) and the leaf-wise
   predict kernel not at all, then once per transform; two fits give the
   same bits; the first 10 trees equal those of the segment-histogram fit
   and the training log-loss agrees within 1e-4; the kernel's raw scores
   within 1e-3 (relative) of the dense replay, labels differing only where
   the margin is within that delta; training accuracy >= 0.85. Prints the
   same timings as ``gbdt``, the fitted trees' path lengths beside the
   leaf-wise predict kernel's.
9. gbdt_efb — bench_efb.py's configuration: 200k rows x 2^16 hashed sparse
   columns (zipf 1.3, 24 per row, plus a signal token) ->
   ``LightGBMClassifier(numIterations=20, maxDenseFeatures=512)`` with
   default Params (leaf-wise through auto below 262144 rows): the tail
   columns bundle into categorical composites that reach the fit, the node
   histogram launches 31 x 20 times, two fits give the same bits, the
   transform takes the dense replay (no predict launch), training accuracy
   >= 0.95.

10. vision_ops — ``ImageTransformer`` (resize up and down, crop, flip,
   colorFormat, blur, gaussianKernel, threshold: ``VISION_CHAIN``) on 512
   images of 256 x 256 x 3 (numpy seed 0), one bucket crossing to the card
   once; the uint8 result within 1 count of the same stage on the CPU.
   Rows/s (host clock, median of 3 after warm-up, rows built included).
11. vision_serve — (a) ``ModelDownloader`` over a temporary copy of
   ``zoo/`` -> ``ResNet20_shapes10`` (sha256 checked) ->
   ``TorchModel.setModelSchema`` -> transform of ``make_shapes10(4000,
   seed=8)``: accuracy >= 0.99 and rows/s. (b) ``make_torchvision_state()``
   (ResNet-50, widths 256-2048) -> ``import_resnet50(preprocess=
   "imagenet_uint8")`` -> ``ImageFeaturizer(cutOutputLayers=1)`` in bf16 on
   1024 images of 256 x 256 resized to 224: the 2048-d features of 16 rows
   within 5e-2 (relative L2, each row) of the same rows in f32 on the CPU,
   and rows/s. (c) the BiLSTM tagger's default config on 64 x 256 tokens,
   bf16 on the card against f32 on the CPU, to the same bar; and whether
   torch's LSTM takes bf16 on the card (a probe: the port's recurrence is
   float32).
12. vision_train — (a) bench.py's shape: ``TorchLearner`` on 245,760
   uint8 32 x 32 x 3 images (numpy seed 0), CIFAR ResNet-20, batch 12288,
   momentum 0.01 / 0.9, bf16, 3 epochs of 20 steps on the scan path: step
   ms and imgs/s (median of epochs 2-3), peak memory and the profile of one
   step. (b) the zoo's shapes10 recipe (20,000 rows, 20 epochs, batch 512,
   momentum 0.05): held-out accuracy >= 0.98 on ``make_shapes10(4000,
   seed=8)``; one step's gradients (the fit's init, 512 rows) in f32 (TF32
   off) on the card within 3e-2 (relative L2, each parameter) of the same
   step in f32 on the CPU, and in bf16 a median within 3e-2 (the worst
   parameter printed: bf16 rounding alone puts a GroupNorm scale's
   gradient ~3e-2 from f32); the profile of one recipe step.
   The vision phases launch no kernel of the kernels line (checked).

Then the kernels line, the card's name and power limit as nvidia-smi prints
them, and last ``{"ok": true, "device": {...}}``. Any failure raises before
the last line; nothing falls back to the CPU. Without a CUDA device, or
outside a checkout of the repo, it exits non-zero and prints no result.
"""

from __future__ import annotations

import functools
import json
import math
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
# the wgmma probe against torch.matmul (float32 sums of the same bf16
# products; a wrong descriptor reads O(1)); D = rowsum(dO * O) as the dq
# kernel writes it against the plain row dot (the same products summed in
# another order), both max |error| over max |plain|
TOL_PROBE, TOL_DELTA = 1e-3, 1e-5
TOL_SLICE = 5e-2
# the GBDT slice: bench_gbdt.py:15-20 (1M x 28, binary, 100 trees of depth
# 5, maxBin 255), LightGBMClassifier's defaults on >= 262144 rows
GBDT_ROWS, GBDT_FEATURES, GBDT_TREES, GBDT_DEPTH = 1_000_000, 28, 100, 5
GBDT_MAX_BIN = 255
# the histogram kernels against their plain versions (scatter-adds in
# another order): |kernel - plain| <= TOL_HIST_ABS + TOL_HIST_REL * |plain|,
# as tests/test_pallas_kernels.py:212 holds the TPU kernel
TOL_HIST_REL, TOL_HIST_ABS = 1e-5, 1e-4
# the predict kernel sums the trees in the plain version's order
TOL_PREDICT = 1e-6
# the slice: final training log-loss against the segment-histogram fit;
# the quantized (bf16-leaf) scores against the dense walk, max |delta| /
# max |dense| (tests/test_gbdt.py:881-901); training accuracy (the data's
# Bayes rate is about 0.9)
TOL_GBDT_LOSS, TOL_GBDT_PREDICT, TOL_GBDT_ACCURACY = 1e-4, 1e-3, 0.85
# the leaf-wise slice: LightGBM's defaults (numLeaves 31, maxDepth 0)
GBDT_LEAVES = 31
# bench_efb.py: 200k x 2^16 hashed sparse rows, 20 iterations, the 512
# densest columns numeric and the tail bundled (EFB)
EFB_ROWS, EFB_COLS, EFB_NNZ, EFB_ITERS, EFB_DENSE = 200_000, 1 << 16, 24, 20, 512
# the width that fit gives the node histogram: 512 dense columns beside the
# 203 bundles EFB plans on that data
EFB_FIT_FEATURES = 715
TOL_EFB_ACCURACY = 0.95
# the image paths (no kernel of the table): an ImageTransformer chain on
# 512 images of 256 x 256 x 3, within 1 count of the CPU's
VISION_OPS_ROWS, VISION_OPS_HW = 512, 256
VISION_CHAIN = (("resize", (320, 320)), ("crop", (16, 16, 288, 288)),
                ("flip", (1,)), ("colorFormat", ("BGR2RGB",)),
                ("blur", (3, 5)), ("gaussianKernel", (5, 1.5)),
                ("resize", (224, 224)), ("threshold", (200.0, 255.0,
                                                       "trunc")))
TOL_VISION_COUNTS = 1
# the zoo's ResNet20_shapes10 (held-out 0.9985 when it was built,
# zoo/README.md) on make_shapes10(4000, seed=8)
ZOO_EVAL_ROWS, TOL_ZOO_ACCURACY = 4000, 0.99
# ResNet-50 (widths 256-2048) features of 1024 images of 256 x 256 resized
# to 224, bf16 on the card, against 16 rows in f32 on the CPU; the BiLSTM
# tagger's default config on 64 x 256 tokens: max relative L2 of a row
FEAT_ROWS, FEAT_HW, FEAT_CPU_ROWS = 1024, 256, 16
BILSTM_ROWS, BILSTM_SEQ = 64, 256
TOL_VISION_L2 = 5e-2
# bench.py:82-99: CIFAR ResNet-20, 20 steps of 12288 an epoch, momentum
# SGD 0.01 / 0.9, bf16
BENCH_ROWS, BENCH_BATCH, BENCH_STEPS, BENCH_EPOCHS = 245_760, 12288, 20, 3
BENCH_LR = 0.01
# the zoo's shapes10 recipe (tools/build_zoo.py:34-56, 94)
RECIPE_ROWS, RECIPE_EPOCHS, RECIPE_BATCH, RECIPE_LR = 20_000, 20, 512, 0.05
TOL_RECIPE_ACCURACY = 0.98


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok: bool, msg: str):
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3,
            rounds: int = 3) -> float:
    """Milliseconds per call of ``fn`` on the card: CUDA events around
    ``iters`` calls launched back to back, over the count; the median of
    ``rounds`` such runs, after warm-up. Back to back, the host's launch
    work overlaps the device's, as in a pipeline; timing one synchronised
    call instead adds the wrapper's host time to the kernel's."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
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


# (Tq, Tk) where the bf16 forward's 128-row query tiles, 128-key K/V tiles
# and TMA's zero-filled boxes past the last row meet the data
TILE_EDGES = ((1, 1), (1, 129), (127, 127), (128, 128), (129, 129),
              (129, 300), (300, 129))
# and where the bf16 backward's 64-row ring tiles and boxes meet it (its
# 128-row stationary tiles meet it at TILE_EDGES)
BWD_TILE_EDGES = TILE_EDGES + ((63, 63), (64, 64), (65, 65), (1, 65))


def attention_cases(torch, edges=TILE_EDGES, view_lengths=(129, 300)) -> list:
    """(B, Tq, Tk, H, D, causal, dtype, qkv_views): both types and head
    dims, both masks, ragged and cross-attention lengths, strided views of
    one (B, T, 3H, D) projection as the model passes them, in bf16 the
    (Tq, Tk) tile ``edges`` and views at the ragged self-attention
    ``view_lengths``, and last the training and serving slices' shape."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for D in (64, 128):
            for causal in (False, True):
                cases.append((2, 1000, 1000, 2, D, causal, dtype, False))
                cases.append((1, 333, 1000, 2, D, causal, dtype, False))
                cases.append((2, 1000, 1000, 2, D, causal, dtype, True))
    for D in (64, 128):
        for causal in (False, True):
            for Tq, Tk in edges:
                cases.append((2, Tq, Tk, 2, D, causal, torch.bfloat16, False))
            for T in view_lengths:
                cases.append((2, T, T, 2, D, causal, torch.bfloat16, True))
    cases.append((8, SEQ, SEQ, 4, 128, True, torch.bfloat16, False))
    return cases


def one_key_rows(Tq, Tk, causal) -> bool:
    """Whether every query row sees exactly one key: then P = 1 on it,
    dP = D, and dq and dk are zero in exact arithmetic (only rounding
    noise is left, where a relative L2 error has no meaning)."""
    return Tk == 1 or (causal and Tq == 1)


def random_qkv(torch, gen, B, Tq, Tk, H, D, dtype, views):
    def rnd(T, heads=H):
        return torch.randn((B, T, heads, D), generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)
    if views:       # strided views of one (B, T, 3H, D) projection
        return rnd(Tq, 3 * H).split(H, dim=2)
    return rnd(Tq), rnd(Tk), rnd(Tk)


def ptxas_lines(report: str, kernel: str) -> list:
    """ptxas' lines about the entry functions whose (mangled) name holds
    ``kernel``: registers, barriers, stack, spills, and any wgmma
    serialisation it reports."""
    lines, inside = [], False
    for line in report.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
        elif "Function properties for" in line:
            inside = kernel in line
        # a wgmma warning names its function: it belongs to that one alone,
        # wherever it falls among the other functions' lines
        if "wgmma" in line and "function '" in line:
            if kernel in line:
                lines.append(line.strip())
        elif inside:
            lines.append(line.strip())
    return lines


def spill_free(lines: list, entries: int) -> bool:
    """Whether ptxas reported ``entries`` entry functions in ``lines`` (one
    per head dim), none spilling and none with serialised wgmma."""
    spills = [ln for ln in lines if "spill" in ln]
    return (len(spills) == entries
            and all(" 0 bytes spill stores" in ln
                    and " 0 bytes spill loads" in ln for ln in spills)
            and not any("serialized" in ln for ln in lines))


# the warp-specialised wgmma kernels whose ptxas lines the build phase
# holds: (library, entry name), each at both head dims
WGMMA_ENTRIES = (("flash_attention_fwd", "flash_fwd_bf16"),
                 ("flash_attention_bwd", "flash_bwd_dq_bf16"),
                 ("flash_attention_bwd", "flash_bwd_dkv_bf16"))


def sass_functions(path: str):
    """``cuobjdump -sass`` of the library at ``path``: {mangled function
    name: [instruction, ...]} with each instruction's opcode and operands,
    and the raw text; a string saying why not, without cuobjdump."""
    import os
    import re
    import shutil
    import subprocess
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return "not available", ""
    r = subprocess.run([exe, "-sass", path], capture_output=True, text=True,
                       timeout=300)
    if r.returncode != 0:
        return f"not available (cuobjdump exit {r.returncode})", ""
    out, fn = {}, None
    for line in r.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = []
            continue
        m = fn and re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m:
            out[fn].append(m.group(1).strip())
    return out, r.stdout


def opcode(instruction: str) -> str:
    """An instruction's opcode with its modifiers, its predicate dropped."""
    parts = instruction.split()
    if parts and parts[0].startswith("@"):
        parts = parts[1:]
    return parts[0] if parts else ""


def sass_atomics(path: str, entry: str):
    """Per instantiation of the entry function ``entry`` in the library at
    ``path`` (named by its template arguments), the count of each atomic
    instruction in ``cuobjdump -sass``, and how many of them are shared
    (ATOMS) and compare-and-swap (CAS) forms: whether a 64-bit shared add
    is one instruction or a loop. "not available" without cuobjdump."""
    import re
    fns, _ = sass_functions(path)
    if isinstance(fns, str):
        return fns
    out = {}
    for name, body in fns.items():
        t = re.search(entry + r"ILi(\d)ELb(\d)E", name)
        if not t:
            continue
        where = "shared" if t.group(2) == "1" else "global"
        c = {}
        for ins in body:
            m = re.match(r"((?:ATOMS|ATOMG|ATOM|RED)\.?[A-Z0-9._]*)",
                         opcode(ins))
            if m:
                c[m.group(1)] = c.get(m.group(1), 0) + 1
        out[f"mode{t.group(1)}_{where}"] = {
            "instructions": c,
            "ATOMS": sum(n for k, n in c.items() if k.startswith("ATOMS")),
            "CAS": sum(n for k, n in c.items() if "CAS" in k)}
    return out


# integer-pipe opcodes (by their first word) in a predict kernel's SASS
INTEGER_OPCODES = ("IADD3", "IMAD", "ISETP", "LOP3", "SHF", "PRMT", "SEL",
                   "LEA", "IMNMX", "VIMNMX", "IABS", "BMSK", "SGXT", "FLO",
                   "POPC", "VIADD", "I2I", "IDP")


def sass_predict(path: str, dump: str = "chiprun_out/gbdt_predict.sass",
                 entries=("quant_levelwise", "quant_leafwise")):
    """Per instantiation of the predict kernels in the library at ``path``
    (its mangled name from the kernel's name on): the SASS instruction
    count, the shared loads (LDS) and integer-pipe instructions of the
    whole function, and its opcodes by count. The dump goes to ``dump``,
    for reading the walk loops by hand."""
    import os
    fns, raw = sass_functions(path)
    if isinstance(fns, str):
        return fns
    os.makedirs(os.path.dirname(dump) or ".", exist_ok=True)
    with open(dump, "w") as f:
        f.write(raw)
    out = {}
    for name, body in fns.items():
        entry = next((e for e in entries if e in name), None)
        if entry is None:
            continue
        ops = {}
        for ins in body:
            op = opcode(ins)
            ops[op] = ops.get(op, 0) + 1
        out[name[name.index(entry):][:48]] = {
            "instructions": len(body),
            "LDS": sum(n for k, n in ops.items() if k.startswith("LDS")),
            "integer": sum(n for k, n in ops.items()
                           if k.split(".")[0] in INTEGER_OPCODES),
            "opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}
    return out


def phase_build(torch, env):
    from mmlspark_tpu_torch.ops import _build
    t0 = time.perf_counter()
    report = _build.build_all()
    lines = {entry: ptxas_lines(report[lib]["ptxas"], entry)
             for lib, entry in WGMMA_ENTRIES}
    atomics = sass_atomics(report["gbdt_histogram"]["path"],
                           "hist_accumulate")
    predict_ptxas = {e: ptxas_lines(report["gbdt_predict"]["ptxas"], e)
                     for e in ("quant_levelwise", "quant_leafwise")}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {k: {"path": v["path"], "ptxas": v["ptxas"]}
                      for k, v in report.items()},
          **{f"{entry}_ptxas": ln for entry, ln in lines.items()},
          "gbdt_histogram_sass_atomics": atomics,
          "hist_accumulate_ptxas": ptxas_lines(
              report["gbdt_histogram"]["ptxas"], "hist_accumulate"),
          "gbdt_predict_ptxas": predict_ptxas,
          "gbdt_predict_sass": sass_predict(report["gbdt_predict"]["path"]),
          "gpu": env.gpu_name_and_power_limit(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    for entry, ln in lines.items():
        check(spill_free(ln, 2), f"{entry} spills, serialises its wgmma, or "
              f"was not reported at both head dims: {ln}")
    for entry, ln in predict_ptxas.items():
        spills = [x for x in ln if "spill" in x]
        check(spills and all(" 0 bytes spill stores" in x
                             and " 0 bytes spill loads" in x
                             for x in spills),
              f"{entry} spills or was not reported: {ln}")


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
    # the same shape as the model hands it over: views of one projection
    qv, kv, vv = random_qkv(torch, gen, B, Tq, Tk, H, D, dtype, True)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # kernel (contiguous, views) and library in turns, the median of three
    # rounds each, so a clock that drifts during the phase meets all three
    rounds = {"kernel": [], "views": [], "library": []}
    for _ in range(3):
        rounds["kernel"].append(cuda_ms(
            torch, lambda: flash_attention_fwd(q, k, v, causal=True),
            rounds=1))
        rounds["views"].append(cuda_ms(
            torch, lambda: flash_attention_fwd(qv, kv, vv, causal=True),
            rounds=1))
        rounds["library"].append(cuda_ms(
            torch, lambda: sdpa(qh, kh, vh, is_causal=True), rounds=1))
    kernel_ms, views_ms, library_ms = (statistics.median(rounds[n]) for n in
                                       ("kernel", "views", "library"))
    plain_ms = cuda_ms(torch, lambda: flash_attention_reference(
        q, k, v, causal=True), iters=10)
    bound = attention_bound_ms(B, H, Tq, Tk, D, causal, "bfloat16")
    timing = {"shape": [B, Tq, H, D], "causal": causal, "dtype": "bfloat16",
              "kernel_ms": kernel_ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "library": "torch sdpa",
              "achieved_tflops": bound["flops"] / kernel_ms / 1e9,
              "bound_share": bound["bound_ms"] / kernel_ms,
              "qkv_views_kernel_ms": views_ms,
              "qkv_views_achieved_tflops": bound["flops"] / views_ms / 1e9,
              "qkv_views_bound_share": bound["bound_ms"] / views_ms,
              "rounds_ms": rounds, **bound}
    emit({"phase": "kernel", "cases": results, "max_out_err": worst["out"],
          "max_lse_err": worst["lse"], "timing": timing})
    return worst, timing


def wgmma_probe(torch, gen) -> dict:
    """The two wgmma forms the bf16 backward adds, on one tile against
    torch.matmul in float32 at both head dims: s = a b^T (SS m64n64k16, as
    S = Q K^T reads its operands) and o = bf16(s) b (RS with b MN-major over
    64-row boxes, as dQ += dS K reads K). Max |error| over max |plain|."""
    from mmlspark_tpu_torch.ops.flash_attention import _wgmma_tile_probe
    errs = {}
    for D in (64, 128):
        a, b = (torch.randn((64, D), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        s, o = _wgmma_tile_probe(a, b)
        s_ref = a.float() @ b.float().T
        o_ref = s.to(torch.bfloat16).float() @ b.float()
        torch.cuda.synchronize()
        errs[D] = {n: ((x - r).abs().max() / r.abs().max()).item()
                   for n, x, r in (("s", s, s_ref), ("o", o, o_ref))}
        check(max(errs[D].values()) <= TOL_PROBE,
              f"the wgmma probe disagrees with torch.matmul at D = {D}: "
              f"{errs[D]}")
    return errs


def phase_kernel_bwd(torch):
    """The wgmma probe; the dq and dk/dv kernels against their plain version
    over the forward phase's cases and the backward's tile edges, then
    timed at the training slice's shape, with D as the dq kernel writes it
    against the plain row dot and a repeat that must give the same bits."""
    from mmlspark_tpu_torch.ops.flash_attention import (
        _BwdLaunch, _row_dot, flash_attention_bwd,
        flash_attention_bwd_reference, flash_attention_fwd)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    probe = wgmma_probe(torch, gen)
    worst = {"dq": 0.0, "dkv": 0.0, "dq_abs": 0.0, "dkv_abs": 0.0,
             "dq_l2": 0.0, "dkv_l2": 0.0}
    results = []
    cases = attention_cases(torch, edges=BWD_TILE_EDGES,
                            view_lengths=(65, 129, 300))
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
        # the relative L2 gate skips only gradients zero in exact arithmetic
        skipped = ["dq", "dk"] if one_key_rows(Tq, Tk, causal) else []
        name = str(dtype).replace("torch.", "")
        case = {"B": B, "Tq": Tq, "Tk": Tk, "H": H, "D": D,
                "causal": causal, "dtype": name, "qkv_views": packed,
                "dq_err": err["dq"], "dk_err": err["dk"],
                "dv_err": err["dv"], "dq_l2": l2["dq"], "dk_l2": l2["dk"],
                "dv_l2": l2["dv"], "l2_skipped": skipped}
        results.append(case)
        check(all(g.shape == x.shape and g.dtype == x.dtype
                  for g, x in zip(got, (q, k, v))),
              f"backward output shapes/types {case}")
        check(all(e <= TOL_OUT[name] for e in err.values())
              and all(e <= TOL_BWD_L2[name] for n, e in l2.items()
                      if n not in skipped),
              f"backward kernels disagree with their plain version: {case}")
        worst["dq"] = max(worst["dq"], err["dq"])
        worst["dkv"] = max(worst["dkv"], err["dk"], err["dv"])
        worst["dq_abs"] = max(worst["dq_abs"], abs_err["dq"])
        worst["dkv_abs"] = max(worst["dkv_abs"], abs_err["dk"],
                               abs_err["dv"])
        worst["dq_l2"] = max([worst["dq_l2"]] + [
            l2[n] for n in ("dq",) if n not in skipped])
        worst["dkv_l2"] = max([worst["dkv_l2"]] + [
            l2[n] for n in ("dk", "dv") if n not in skipped])
        del q, k, v, do, out, lse, got, ref

    B, Tq, Tk, H, D, causal, dtype, _ = cases[-1]
    q, k, v = random_qkv(torch, gen, B, Tq, Tk, H, D, dtype, False)
    do = torch.randn((B, Tq, H, D), generator=gen, device="cuda",
                     dtype=torch.float32).to(dtype)
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    call = _BwdLaunch(q, k, v, out, lse, do, True, 1.0 / D ** 0.5)
    dq_ms = cuda_ms(torch, call.dq_kernel)
    # D as the dq kernel wrote it (the dk/dv kernel reads it) against the
    # plain row dot: float32 sums of the same products in another order
    plain_delta = _row_dot(do, out)
    delta_err = ((call.delta - plain_delta).abs().max()
                 / plain_delta.abs().max()).item()
    check(delta_err <= TOL_DELTA,
          f"the dq kernel's D differs from the plain row dot: {delta_err}")
    dkv_ms = cuda_ms(torch, call.dkv_kernel)
    total_ms = cuda_ms(torch, lambda: flash_attention_bwd(
        q, k, v, out, lse, do, causal=True))
    first, second = (flash_attention_bwd(q, k, v, out, lse, do, causal=True)
                     for _ in range(2))
    repeat_same = all(torch.equal(a, b) for a, b in zip(first, second))
    check(repeat_same, "two backward calls on the same inputs differ")
    del first, second
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
              "dkv_tflops": bounds["dkv"]["flops"] / dkv_ms / 1e9,
              "dq_bound_share": bounds["dq"]["bound_ms"] / dq_ms,
              "dkv_bound_share": bounds["dkv"]["bound_ms"] / dkv_ms,
              "delta_rel_err": delta_err, "bit_identical_repeat": repeat_same}
    emit({"phase": "kernel_bwd", "wgmma_probe": probe, "cases": results,
          "max_dq_err": worst["dq"], "max_dkv_err": worst["dkv"],
          "max_dq_l2": worst["dq_l2"], "max_dkv_l2": worst["dkv_l2"],
          "timing": timing})
    return worst, timing


def hist_bound(n_rows, n_feat, in_bytes_per_cell, n_out) -> dict:
    """Least time for one histogram: the bin or id matrix, g and h (and the
    node ids, counted in ``in_bytes_per_cell`` by the caller) read once, the
    two float32 outputs written once; two float32 adds per (row, feature)."""
    return bound(2.0 * n_rows * n_feat,
                 in_bytes_per_cell * n_rows * n_feat + 8 * n_rows
                 + 2 * 4 * n_out, "float32")


def node_hist_bound(n_rows, n_feat, n_live, n_out) -> dict:
    """Least time for one node histogram whose ``n_live`` rows lie in
    [0, n_nodes): every row's node id and g/h read once, the live rows'
    bins read once, two float32 adds per live (row, feature), the two
    outputs written once."""
    return bound(2.0 * n_live * n_feat,
                 n_feat * n_live + 12 * n_rows + 2 * 4 * n_out, "float32")


def same_bits(torch, a, b) -> bool:
    """Equal bit for bit, NaN for NaN (whatever the NaN's payload)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        torch.where(na, 0.0, a).view(torch.int32),
        torch.where(nb, 0.0, b).view(torch.int32))


def leaf_pair_case(torch, gen, F, N, n_bins, live=1.0 / 3):
    """Inputs of the leaf-wise round's node histogram: ids 0 and 1 (the two
    fresh leaves) on a ``live`` share of the rows, id 2 (every other row,
    out of range at 2 nodes) on the rest."""
    bins_t = torch.randint(0, n_bins, (F, N), generator=gen, device="cuda",
                           dtype=torch.int32).to(torch.uint8)
    u = torch.rand(N, generator=gen, device="cuda")
    node = torch.where(u < live, (u < live / 2).to(torch.int32) ^ 1,
                       torch.full_like(u, 2, dtype=torch.int32)).to(
                           torch.int32)
    return (bins_t, node, torch.randn(N, generator=gen, device="cuda"),
            torch.rand(N, generator=gen, device="cuda"))


def special_values(torch, gen, kind, F, N, n_bins):
    """Node-histogram inputs with ``kind`` g: "non_finite" (NaN on every
    997th row, +inf on rows 3 and 5, -inf on row 4, rows 3 and 4 in one
    key of every feature), "zero" (all 0), "outlier" (one 1e3 among
    log-loss-sized values), "one_row" (N = 1)."""
    if kind == "one_row":
        N = 1
    bins_t = torch.randint(0, n_bins, (F, N), generator=gen, device="cuda",
                           dtype=torch.int32).to(torch.uint8)
    node = torch.randint(0, 4, (N,), generator=gen, device="cuda",
                         dtype=torch.int32)
    g = torch.randn(N, generator=gen, device="cuda") * 0.5
    h = torch.rand(N, generator=gen, device="cuda") * 0.25
    if kind == "non_finite":
        bins_t[:, 4] = bins_t[:, 3]
        node[4] = node[3]
        g[::997] = float("nan")
        g[3] = g[5] = float("inf")
        g[4] = float("-inf")
    elif kind == "zero":
        g.zero_()
    elif kind == "outlier":
        g[N // 2] = 1e3
    return bins_t, node, g, h


def host_us_per_call(torch, fn, calls: int = 200) -> float:
    """Host microseconds per call of ``fn`` over ``calls`` calls queued
    back to back (the host clock, synchronised before and after): the
    wrapper's host work where the card keeps up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def hist_timings(torch, gen) -> dict:
    """Both histogram kernels timed at every shape their paths launch,
    beside their plain versions, two ``torch.bincount`` calls and their
    bounds: row 4 at 1-16 nodes over 28 x 1M (level-wise), the leaf-wise
    round's 2 live leaves over 28 x 1M and the EFB fit's over 715 x 200k
    (one third of the rows in the two leaves; each also at 3 ids, the
    same inputs as a 3-slot caller asks, as before the leaf-wise path
    asked for the two leaves alone); row 7 at 16 x 255 ids over 28 x 1M.
    The plain versions are timed over 5 calls."""
    from mmlspark_tpu_torch.ops import gbdt_kernels as gk
    N, F, NB = GBDT_ROWS, GBDT_FEATURES, GBDT_MAX_BIN

    def entry(path, shape, fn, plain_fn, ids, gx, hx, size, bnd):
        return {"path": path, "shape": shape, "ms": cuda_ms(torch, fn),
                "profile_of_one_call": device_breakdown(torch, fn, top=5),
                "plain_ms": cuda_ms(torch, plain_fn, iters=5, warmup=1),
                "library_ms": cuda_ms(torch, lambda: (
                    torch.bincount(ids, weights=gx, minlength=size),
                    torch.bincount(ids, weights=hx, minlength=size))),
                "library": "torch.bincount(ids, weights=g|h), twice",
                **bnd}

    def node_entry(path, bins_t, node, g, h, nn):
        F_, N_ = bins_t.shape
        live = (node >= 0) & (node < nn)
        size = nn * F_ * NB
        # the rows outside the nodes, where there are any, into a discard
        # histogram past the output (size + (f, bin)): one slot for all of
        # them would serialise the library call's atomics on one address
        discard = 0 if bool(live.all()) else F_ * NB
        feat_bin = torch.arange(F_, device="cuda")[:, None] * NB \
            + bins_t.long()
        ids = torch.where(live[None, :], node.long()[None, :] * F_ * NB
                          + feat_bin, size + feat_bin).reshape(-1)
        gx, hx = g.expand(F_, N_).reshape(-1), h.expand(F_, N_).reshape(-1)
        return entry(
            path, {"F": F_, "N": N_, "n_nodes": nn, "n_bins": NB},
            lambda: gk.mxu_node_histogram(bins_t, node, g, h, n_nodes=nn,
                                          n_bins=NB),
            lambda: gk.node_histogram_reference(bins_t, node, g, h,
                                                n_nodes=nn, n_bins=NB),
            ids, gx, hx, size + discard,
            node_hist_bound(N_, F_, int(live.sum()), size))

    shapes = []
    for nn in (1, 2, 4, 8, 16):
        bins_t, node, g, h = node_hist_case(torch, gen, F, N, nn, NB, False)
        shapes.append(node_entry("level-wise", bins_t, node, g, h, nn))
    for path, F_, N_ in (("leaf-wise", F, N),
                         ("EFB", EFB_FIT_FEATURES, EFB_ROWS)):
        args = leaf_pair_case(torch, gen, F_, N_, NB)
        for nn in (2, 3):
            shapes.append(node_entry(path, *args, nn))
        del args
    # the wrappers' host time a call (host clock, not a device metric):
    # 200 calls at 28 x 4096, where the card finishes each call before
    # the host has queued the next
    small = node_hist_case(torch, gen, F, 4096, 16, NB, False)
    small_ids = fused_case(torch, gen, F, 4096, 16 * NB, False)
    host_us = {
        "node_hist": host_us_per_call(torch, lambda: gk.mxu_node_histogram(
            *small, n_nodes=16, n_bins=NB)),
        "fused": host_us_per_call(torch, lambda: gk.histogram_fused(
            *small_ids, n_bins=16 * NB)),
        "shape": {"F": F, "N": 4096, "n_nodes": 16, "n_bins": NB}}
    bins, g, h = fused_case(torch, gen, F, N, 16 * NB, False)
    ids = (torch.arange(F, device="cuda") * (16 * NB)
           + bins.long()).reshape(-1)
    gx, hx = g[:, None].expand(N, F).reshape(-1), h[:, None].expand(
        N, F).reshape(-1)
    fused = entry(
        "hist_impl=pallas", {"N": N, "F": F, "n_bins": 16 * NB},
        lambda: gk.histogram_fused(bins, g, h, n_bins=16 * NB),
        lambda: gk.histogram_fused_reference(bins, g, h, n_bins=16 * NB),
        ids, gx, hx, F * 16 * NB, hist_bound(N, F, 4, F * 16 * NB))
    return {"node_hist_shapes": shapes, "fused": fused,
            "wrapper_host_us_per_call": host_us}


def node_hist_case(torch, gen, F, N, n_nodes, n_bins, oor):
    """Inputs of mxu_node_histogram on the card: uint8 bins_t (F, N) over all
    256 values (bins >= n_bins add nothing), node ids in [0, n_nodes), or
    with ``oor`` also -1 and ids past n_nodes."""
    bins_t = torch.randint(0, 256 if oor else n_bins, (F, N), generator=gen,
                           device="cuda", dtype=torch.int32).to(torch.uint8)
    lo, hi = (-1, n_nodes + 2) if oor else (0, n_nodes)
    node = torch.randint(lo, hi, (N,), generator=gen, device="cuda",
                         dtype=torch.int32)
    g = torch.randn(N, generator=gen, device="cuda")
    h = torch.rand(N, generator=gen, device="cuda")
    return bins_t, node, g, h


def fused_case(torch, gen, F, N, n_bins, oor):
    """Inputs of histogram_fused: int32 ids (N, F), with ``oor`` also ids
    below 0 and past n_bins."""
    lo, hi = (-2, n_bins + 3) if oor else (0, n_bins)
    bins = torch.randint(lo, hi, (N, F), generator=gen, device="cuda",
                         dtype=torch.int32)
    return (bins, torch.randn(N, generator=gen, device="cuda"),
            torch.rand(N, generator=gen, device="cuda"))


def predict_case(torch, gen, T, K, depth, d, n, int8_leaves):
    """Inputs of gbdt_predict_quant_levelwise: uint8 bins_t (d, n) and
    tables, the 255 sentinel on every seventh node, bf16-rounded leaves or
    int8 leaves times a per-tree scale, widened to float32."""
    nodes = 2 ** depth - 1
    bins_t = torch.randint(0, 256, (d, n), generator=gen, device="cuda",
                           dtype=torch.int32).to(torch.uint8)
    feat = torch.randint(0, d, (T, K, nodes), generator=gen, device="cuda",
                         dtype=torch.int32).to(torch.uint8)
    thr = torch.randint(0, 256, (T, K, nodes), generator=gen, device="cuda",
                        dtype=torch.int32)
    thr.view(-1)[::7] = 255
    leaf = torch.randn((T, K, 2 ** depth), generator=gen, device="cuda")
    if int8_leaves:
        scale = leaf.abs().amax(2, keepdim=True) / 127.0
        leaf = torch.round(leaf / scale).clamp(-127, 127) * scale
    else:
        leaf = leaf.to(torch.bfloat16).float()
    return bins_t, feat, thr.to(torch.uint8), leaf


def lw_predict_case(torch, gen, T, K, R, d, n, int8_leaves):
    """Inputs of gbdt_predict_quant_leafwise: uint8 bins_t (d, n); round r
    splits a leaf in [0, r]; every fifth tree stops after 5 rounds (-1
    no-op rounds after), tree 0 of class 0 at round 0; the 255 sentinel on
    every seventh round; bf16-rounded or int8-scaled leaves."""
    bins_t = torch.randint(0, 256, (d, n), generator=gen, device="cuda",
                           dtype=torch.int32).to(torch.uint8)
    rounds = torch.arange(R, device="cuda") + 1
    split = (torch.rand((T, K, R), generator=gen, device="cuda")
             * rounds).floor().to(torch.int32)
    split[::5, :, 5:] = -1
    split[0, 0, :] = -1
    feat = torch.randint(0, d, (T, K, R), generator=gen, device="cuda",
                         dtype=torch.int32).to(torch.uint8)
    thr = torch.randint(0, 256, (T, K, R), generator=gen, device="cuda",
                        dtype=torch.int32)
    thr.view(-1)[::7] = 255
    leaf = torch.randn((T, K, R + 1), generator=gen, device="cuda")
    if int8_leaves:
        scale = leaf.abs().amax(2, keepdim=True) / 127.0
        leaf = torch.round(leaf / scale).clamp(-127, 127) * scale
    else:
        leaf = leaf.to(torch.bfloat16).float()
    return bins_t, split, feat, thr.to(torch.uint8), leaf



# the leaf-wise kernel's pointer-tree edges (lw_edge_case)
LW_EDGES = ("all_no_op", "round0_no_op", "one_leaf_again", "chain_127",
            "unmade_leaf", "all_sentinel")


def lw_edge_case(torch, gen, kind):
    """Inputs of gbdt_predict_quant_leafwise at one edge of the pointer
    trees its kernel builds, 9 trees x 2 classes over 13 x 5003 bins, R =
    30: every round a no-op; round 0 a no-op; leaf 0 split in every round;
    a 127-round chain (round r splits leaf r at threshold 0, so most rows
    walk all 127 nodes); rounds that name any leaf up to R, made yet or
    not; every threshold the 255 sentinel."""
    R = 127 if kind == "chain_127" else GBDT_LEAVES - 1
    bins_t, split, feat, thr, leaf = lw_predict_case(torch, gen, 9, 2, R, 13,
                                                     5003, False)
    if kind == "all_no_op":
        split[:] = -1
    elif kind == "round0_no_op":
        split[:, :, 0] = -1
    elif kind == "one_leaf_again":
        split[:] = 0
    elif kind == "chain_127":
        split[:] = torch.arange(R, device="cuda", dtype=torch.int32)
        thr[:] = 0
    elif kind == "unmade_leaf":
        split[:] = torch.randint(0, R + 1, split.shape, generator=gen,
                                 device="cuda", dtype=torch.int32)
    elif kind == "all_sentinel":
        thr[:] = 255
    return bins_t, split, feat, thr, leaf


def lw_path_stats(torch, bins_t, split, feat, thr) -> dict:
    """The nodes each row visits per tree of a leaf-wise ensemble: its
    replay's rounds with pos == split_leaf[r], what the kernel's walk
    steps through. The mean and max over (row, tree), the mean over (tree,
    32-row group: a warp's lanes) of the group's longest path, and the
    sum over rows and trees."""
    T, K, R = split.shape
    d, n = bins_t.shape
    dev = bins_t.device
    groups = n // 32
    total = torch.zeros((), dtype=torch.long, device=dev)
    longest = torch.zeros((), dtype=torch.long, device=dev)
    warp = torch.zeros((), dtype=torch.float64, device=dev)
    sl, fl = split.long(), feat.long()
    for t in range(T):
        for k in range(K):
            pos = torch.zeros(n, dtype=torch.long, device=dev)
            steps = torch.zeros(n, dtype=torch.long, device=dev)
            for r in range(R):
                hit = pos == sl[t, k, r]
                steps += hit
                vals = bins_t.index_select(0, fl[t, k, r:r + 1])[0]
                pos = torch.where(hit & (vals > thr[t, k, r]), r + 1, pos)
            total += steps.sum()
            longest = torch.maximum(longest, steps.max())
            if groups:
                warp += steps[:groups * 32].view(groups, 32).amax(1).double(
                    ).mean()
    total, longest, warp = total.item(), longest.item(), warp.item()
    return {"mean_path": total / (n * T * K), "max_path": longest,
            "mean_warp_longest_path": warp / (T * K) if groups else None,
            "visited_nodes": total}


def kernel_device_ms(torch, fn, match: str, calls: int = 20) -> dict:
    """torch.profiler's device time of the kernels whose name holds
    ``match`` over ``calls`` calls of ``fn`` back to back (after one
    warm-up), per launch; the wrapper's other kernels (its output's fill,
    the feature-id max) are listed apart. Unlike ``cuda_ms`` it leaves out
    the host gaps between launches: each predict wrapper reads the
    feature-id max back, which synchronises the card every call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ks = [(e.key, e.self_device_time_total, e.count)
          for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA
          and e.self_device_time_total > 0]
    mine = [k for k in ks if match in k[0]]
    us, count = sum(k[1] for k in mine), sum(k[2] for k in mine)
    return {"ms": us / count / 1e3 if count else None, "launches": count,
            "other_kernels_ms_per_call": sum(k[1] for k in ks
                                             if match not in k[0])
            / calls / 1e3}


def predict_timing(torch, args, depth=None, plain=True) -> dict:
    """One predict kernel timed on ``args`` (level-wise where ``depth`` is
    given, else leaf-wise): ``cuda_ms`` of the wrapper, the profiler's
    device time of the kernel, its plain version (unless ``plain`` is
    False), the least time the card could take (bins and tables read once,
    the output written once; a compare per level or per visited node and
    an add per row and tree) and, leaf-wise, the path lengths."""
    from mmlspark_tpu_torch.ops import gbdt_kernels as gk
    bins_t = args[0]
    d, n = bins_t.shape
    T, K = args[1].shape[:2]
    table_bytes = sum(a.numel() * a.element_size() for a in args[1:])
    if depth is not None:
        def fn():
            return gk.gbdt_predict_quant_levelwise(*args, depth=depth)

        def plain_fn():
            return gk.quant_levelwise_reference(*args, depth=depth)
        out = {"shape": {"T": T, "K": K, "depth": depth, "d": d, "n": n}}
        ops = float(n) * T * K * (depth + 1)
        match, plain_iters = "quant_levelwise", 5
    else:
        def fn():
            return gk.gbdt_predict_quant_leafwise(*args)

        def plain_fn():
            return gk.quant_leafwise_reference(*args)
        R = args[1].shape[2]
        paths = lw_path_stats(torch, *args[:4])
        out = {"shape": {"T": T, "K": K, "R": R, "d": d, "n": n},
               "paths": paths}
        ops = float(paths["visited_nodes"]) + float(n) * T * K
        match, plain_iters = "quant_leafwise", 3
    out["ms"] = cuda_ms(torch, fn)
    out["device"] = kernel_device_ms(torch, fn, match)
    if plain:
        out["plain_ms"] = cuda_ms(torch, plain_fn, iters=plain_iters,
                                  warmup=1)
    out["library_ms"] = None
    out["library"] = "none: no single PyTorch call walks an ensemble"
    out.update(bound(ops, d * n + table_bytes + 4 * n * K, "float32"))
    return out


def predict_timings(torch, gen) -> dict:
    """Both predict kernels at the synthetic slice shapes: 100 random trees
    of depth 5 and 100 random leaf-wise trees of 30 rounds over 28 x 1M
    bins."""
    N, F, T, D, R = (GBDT_ROWS, GBDT_FEATURES, GBDT_TREES, GBDT_DEPTH,
                     GBDT_LEAVES - 1)
    return {"predict": predict_timing(
                torch, predict_case(torch, gen, T, 1, D, F, N, False), D),
            "predict_lw": predict_timing(
                torch, lw_predict_case(torch, gen, T, 1, R, F, N, False))}


def fitted_predict_timing(torch, kern, bins) -> dict:
    """A fitted ensemble's predict kernel timed alone on its own quantized
    tables (bf16 leaves, widened) and the fit's 1M x 28 bins: the level-wise
    kernel for a level-wise ensemble, the leaf-wise one otherwise."""
    from mmlspark_tpu_torch.models.gbdt import engine, leafwise
    bins_t = bins.T.contiguous()
    T = int(kern.feature.shape[0])
    if isinstance(kern, leafwise.LeafwiseEnsemble):
        S, F, Th, leaf = leafwise.quantize_ensemble_lw(kern, T)
        args = (bins_t, *(x.to(bins_t.device) for x in (
            S, F, Th, engine.dequant_leaf(leaf))))
        return predict_timing(torch, args, plain=False)
    feat, thr, leaf = engine.quantize_ensemble(kern, T)
    depth = int(math.log2(leaf.shape[2]))
    args = (bins_t, *(x.to(bins_t.device) for x in (
        feat, thr, engine.dequant_leaf(leaf))))
    return predict_timing(torch, args, depth, plain=False)

def phase_kernel_gbdt(torch):
    """The four GBDT kernels against their plain versions at edge shapes
    and at the slices', two launches on the same inputs bit-identical, then
    timed at the slice shape beside their bound and one library call."""
    from mmlspark_tpu_torch.ops import gbdt_kernels as gk
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    N, F, NB = GBDT_ROWS, GBDT_FEATURES, GBDT_MAX_BIN
    worst = {"node_hist": 0.0, "fused": 0.0, "predict": 0.0,
             "predict_lw": 0.0}
    results = []

    def hold(name, case, got, ref, tol_rel, arith):
        """Two launches bit-identical, equal bit for bit to the kernel's
        fixed-point arithmetic (integer sums are exact), and within
        TOL_HIST_ABS + tol_rel * |plain| of the float64 plain version;
        NaN and the infinities where the plain version has them."""
        (g1, h1), (g2, h2), (rg, rh) = got[0], got[1], ref
        same = same_bits(torch, g1, g2) and same_bits(torch, h1, h2)
        exact = same_bits(torch, g1, arith[0]) and same_bits(torch, h1,
                                                            arith[1])
        err = excess = 0.0
        ieee = True
        for k, r in ((g1, rg), (h1, rh)):
            fin = torch.isfinite(r)
            ieee = ieee and torch.equal(fin, torch.isfinite(k)) and \
                torch.equal(torch.isnan(k), torch.isnan(r)) and \
                torch.equal(k[torch.isinf(r)], r[torch.isinf(r)])
            d = (k[fin] - r[fin]).abs()
            if d.numel():
                err = max(err, d.max().item())
                excess = max(excess,
                             (d - tol_rel * r[fin].abs()).max().item())
        case.update(kernel=name, max_abs_err=err, bit_identical_repeat=same,
                    equal_to_arithmetic=exact, ieee_non_finite=ieee)
        results.append(case)
        check(same, f"{name}: two launches on the same inputs differ {case}")
        check(exact, f"{name} differs from its fixed-point arithmetic {case}")
        check(ieee, f"{name}: NaN/inf where the plain version has none, or "
                    f"the reverse {case}")
        check(excess <= TOL_HIST_ABS,
              f"{name} disagrees with its plain version: {case}")
        worst[name] = max(worst[name], err)

    def node_case(case, args, nn, nb):
        got = [gk.mxu_node_histogram(*args, n_nodes=nn, n_bins=nb)
               for _ in range(2)]
        ref = gk.node_histogram_reference(*args, n_nodes=nn, n_bins=nb)
        arith = gk.node_histogram_kernel_arithmetic(*args, nn, nb)
        torch.cuda.synchronize()
        hold("node_hist", case, got, ref, TOL_HIST_REL, arith)
        return got[0]

    def fused_hold(case, args, nb):
        got = [gk.histogram_fused(*args, n_bins=nb) for _ in range(2)]
        ref = gk.histogram_fused_reference(*args, n_bins=nb)
        arith = gk.histogram_fused_kernel_arithmetic(*args, nb)
        torch.cuda.synchronize()
        hold("fused", case, got, ref, TOL_HIST_REL, arith)
        return got[0]

    # F x N x n_nodes x n_bins: ragged N, F off every tile, 1..64 nodes,
    # out-of-range node ids and bins, 16/255/256 bins; last the paths'
    # shapes: level-wise (16 nodes), and leaf-wise and EFB at the 3 ids
    # that the combined-id paths ask for
    for F_, N_, nn, nb, oor in ((5, 333, 3, 16, True),
                                (13, 77777, 1, 256, True),
                                (28, 100003, 2, 255, True),
                                (7, 50001, 16, 255, True),
                                (3, 12345, 64, 16, True),
                                (28, 20011, 64, 255, False),
                                (F, N, 16, NB, False),
                                (F, N, 3, NB, False),
                                (EFB_FIT_FEATURES, EFB_ROWS, 3, NB, False)):
        args = node_hist_case(torch, gen, F_, N_, nn, nb, oor)
        node_case({"F": F_, "N": N_, "n_nodes": nn, "n_bins": nb,
                   "out_of_range": oor}, args, nn, nb)
    # the leaf-wise round as cand_pair now asks: 2 nodes, id 2 (out of
    # range) on most rows, at the leaf-wise and EFB paths' widths
    for F_, N_ in ((F, N), (EFB_FIT_FEATURES, EFB_ROWS)):
        node_case({"F": F_, "N": N_, "n_nodes": 2, "n_bins": NB,
                   "third_id_rows": 0.8},
                  leaf_pair_case(torch, gen, F_, N_, NB, live=0.2), 2, NB)
    # NaN/+inf/-inf (and both infinities in one key), all-zero g, one
    # outlier of 1e3, one row
    for kind in ("non_finite", "zero", "outlier", "one_row"):
        args = special_values(torch, gen, kind, 7, 50001, NB)
        node_case({"F": 7, "N": args[1].shape[0], "n_nodes": 4,
                   "n_bins": NB, "values": kind}, args, 4, NB)
        ids = (args[1].long()[:, None] * NB + args[0].T.long()).to(
            torch.int32).contiguous()
        fused_hold({"F": 7, "N": ids.shape[0], "n_bins": 4 * NB,
                    "values": kind}, (ids, args[2], args[3]), 4 * NB)
    # the same rows in another order give the same bits
    args = node_hist_case(torch, gen, 28, 100003, 16, NB, True)
    perm = torch.randperm(100003, generator=gen, device="cuda")
    pargs = (args[0][:, perm].contiguous(), args[1][perm], args[2][perm],
             args[3][perm])
    a = node_case({"F": 28, "N": 100003, "n_nodes": 16, "n_bins": NB,
                   "rows": "in order"}, args, 16, NB)
    b = node_case({"F": 28, "N": 100003, "n_nodes": 16, "n_bins": NB,
                   "rows": "permuted"}, pargs, 16, NB)
    check(same_bits(torch, a[0], b[0]) and same_bits(torch, a[1], b[1]),
          "node_hist: a row permutation changed the bits")
    results[-1]["same_bits_as_in_order"] = True
    fargs = fused_case(torch, gen, 13, 77777, 16 * NB, True)
    perm = torch.randperm(77777, generator=gen, device="cuda")
    a = fused_hold({"F": 13, "N": 77777, "n_bins": 16 * NB,
                    "rows": "in order"}, fargs, 16 * NB)
    b = fused_hold({"F": 13, "N": 77777, "n_bins": 16 * NB,
                    "rows": "permuted"},
                   tuple(x[perm].contiguous() for x in fargs), 16 * NB)
    check(same_bits(torch, a[0], b[0]) and same_bits(torch, a[1], b[1]),
          "fused: a row permutation changed the bits")
    results[-1]["same_bits_as_in_order"] = True
    # the fused kernel's ids reach n_nodes * max_bin in the engine
    for F_, N_, nb, oor in ((5, 333, 16, True), (13, 77777, 255, True),
                            (28, 100003, 256, True),
                            (7, 50001, 16 * NB, True),
                            (3, 12345, 64 * NB, False),
                            (F, N, 16 * NB, False)):
        fused_hold({"F": F_, "N": N_, "n_bins": nb, "out_of_range": oor},
                   fused_case(torch, gen, F_, N_, nb, oor), nb)
    def predict_hold(name, case, args, kernel, plain, arith):
        """Two launches bit-identical and equal to the plain version bit
        for bit (max |delta| 0 <= TOL_PREDICT), and to the kernel's
        arithmetic in plain PyTorch where ``arith`` is given (the small
        cases)."""
        got = [kernel(*args) for _ in range(2)]
        ref = plain(*args)
        torch.cuda.synchronize()
        err = (got[0] - ref).abs().max().item() if ref.numel() else 0.0
        case.update(kernel=name, max_abs_err=err,
                    bit_identical_repeat=torch.equal(got[0], got[1]),
                    equal_to_plain=torch.equal(got[0], ref))
        if arith is not None:
            case["equal_to_arithmetic"] = torch.equal(got[0], arith(*args))
        results.append(case)
        check(case["bit_identical_repeat"], f"{name}: two launches differ "
                                            f"{case}")
        check(got[0].shape == ref.shape and case["equal_to_plain"]
              and err <= TOL_PREDICT,
              f"{name} kernel disagrees with its plain version: {case}")
        check(case.get("equal_to_arithmetic", True),
              f"{name} kernel differs from its arithmetic: {case}")
        worst[name] = max(worst[name], err)

    # T x K x depth x d x n: ragged n and d, K = 3, int8-scaled leaves,
    # depth 0 (one leaf) and depth 7 over 256 features, tables too large
    # for shared memory (taken in chunks of trees), the 255 sentinel; last
    # the slice shape
    for T, K, depth, d, n, q8 in ((7, 3, 4, 11, 777, False),
                                  (7, 3, 4, 11, 777, True),
                                  (3, 1, 1, 1, 5, False),
                                  (3, 2, 0, 5, 1001, False),
                                  (5, 2, 7, 256, 3001, True),
                                  (2000, 3, 5, 13, 4099, False),
                                  (GBDT_TREES, 1, GBDT_DEPTH, F, N, False)):
        predict_hold(
            "predict", {"T": T, "K": K, "depth": depth, "d": d, "n": n,
                        "int8_leaves": q8},
            predict_case(torch, gen, T, K, depth, d, n, q8),
            functools.partial(gk.gbdt_predict_quant_levelwise, depth=depth),
            functools.partial(gk.quant_levelwise_reference, depth=depth),
            functools.partial(gk.quant_levelwise_kernel_arithmetic,
                              depth=depth) if n < N else None)
    # T x K x R x d x n: ragged n and odd d, K = 3, int8-scaled leaves, R =
    # 127 rounds (the cap) over 256 features, tables too large for shared
    # memory, a one-round tree; then the pointer trees' edges
    # (lw_edge_case); last the leaf-wise slice shape
    lw_cases = [({"T": T, "K": K, "R": R, "d": d, "n": n, "int8_leaves": q8},
                 lw_predict_case(torch, gen, T, K, R, d, n, q8))
                for T, K, R, d, n, q8 in (
                    (7, 3, 9, 11, 777, False), (7, 3, 9, 11, 777, True),
                    (3, 1, 1, 1, 5, False), (5, 2, 127, 256, 3001, True),
                    (2000, 3, GBDT_LEAVES - 1, 13, 4099, False))]
    for kind in LW_EDGES:
        args = lw_edge_case(torch, gen, kind)
        T, K, R = args[1].shape
        lw_cases.append(({"T": T, "K": K, "R": R, "d": args[0].shape[0],
                          "n": args[0].shape[1], "edge": kind}, args))
    lw_cases.append(({"T": GBDT_TREES, "K": 1, "R": GBDT_LEAVES - 1, "d": F,
                      "n": N, "int8_leaves": False},
                     lw_predict_case(torch, gen, GBDT_TREES, 1,
                                     GBDT_LEAVES - 1, F, N, False)))
    for case, args in lw_cases:
        predict_hold("predict_lw", case, args, gk.gbdt_predict_quant_leafwise,
                     gk.quant_leafwise_reference,
                     gk.quant_leafwise_kernel_arithmetic
                     if case["T"] * case["K"] <= 100 and case["n"] < N
                     else None)
    del lw_cases

    # timing at the paths' shapes (cuda_ms: back-to-back calls, after
    # warm-up); the kernels line takes row 4 at 16 nodes
    timing = hist_timings(torch, gen)
    timing["node_hist"] = next(
        e for e in timing["node_hist_shapes"]
        if e["path"] == "level-wise" and e["shape"]["n_nodes"] == 16)
    timing.update(predict_timings(torch, gen))
    emit({"phase": "kernel_gbdt", "cases": results,
          "max_abs_err": worst, "timing": timing})
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


def gbdt_data():
    """bench_gbdt.py:15-20: 1M x 28 standard normal features from numpy
    seed 0, y = 1[2 x0 + x1 - 0.5 x2 + N(0, 0.5) > 0]."""
    rng = np.random.default_rng(0)
    n, d = GBDT_ROWS, GBDT_FEATURES
    x = rng.normal(size=(n, d)).astype(np.float32)
    logit = x[:, 0] * 2 + x[:, 1] - x[:, 2] * 0.5 + rng.normal(0, 0.5, n)
    return x, (logit > 0).astype(np.float32)


def gbdt_counts() -> dict:
    from mmlspark_tpu_torch.ops import gbdt_kernels as gk
    return {"node_hist": gk.mxu_node_histogram.launches,
            "fused": gk.histogram_fused.launches,
            "predict": gk.gbdt_predict_quant_levelwise.launches,
            "predict_lw": gk.gbdt_predict_quant_leafwise.launches}


def reset_gbdt_counts():
    from mmlspark_tpu_torch.ops import gbdt_kernels as gk
    gk.mxu_node_histogram.launches = 0
    gk.histogram_fused.launches = 0
    gk.gbdt_predict_quant_levelwise.launches = 0
    gk.gbdt_predict_quant_leafwise.launches = 0


def log_loss(raw, y) -> float:
    z = raw[:, 0].astype(np.float64)
    return float(np.mean(np.logaddexp(0.0, z) - y * z))


def same_trees(a, b) -> list:
    """Per tree: feature and threshold arrays equal."""
    fa, fb = a.feature.cpu(), b.feature.cpu()
    ta, tb = a.threshold.cpu(), b.threshold.cpu()
    return [bool((fa[t] == fb[t]).all() and (ta[t] == tb[t]).all())
            for t in range(min(len(fa), len(fb)))]


def same_trees_lw(a, b) -> list:
    """Per leaf-wise tree: split_leaf, feature, threshold, is_cat and
    cat_bitset equal."""
    pairs = [(x.cpu(), y.cpu()) for x, y in (
        (a.split_leaf, b.split_leaf), (a.feature, b.feature),
        (a.threshold, b.threshold), (a.is_cat, b.is_cat),
        (a.cat_bitset, b.cat_bitset))]
    return [all(bool((x[t] == y[t]).all()) for x, y in pairs)
            for t in range(min(len(a.feature), len(b.feature)))]


def same_state(s0, s1) -> bool:
    return s0.keys() == s1.keys() and all(
        np.array_equal(np.asarray(s0[k]), np.asarray(s1[k])) for k in s0)


def warm_fit(torch, clf, df, want: dict, what: str):
    """A first fit, then a timed warm one whose kernel launches must equal
    ``want`` and whose ensemble must be the first's, bit for bit. Returns
    (model, first_s, fit_s, launches)."""
    t0 = time.perf_counter()
    first = clf.fit(df)
    first_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_gbdt_counts()
    t0 = time.perf_counter()
    model = clf.fit(df)                  # the state's read-back syncs
    fit_s = time.perf_counter() - t0
    launches = gbdt_counts()
    check(launches == want,
          f"kernel launches over one {what} fit {launches}, expected {want}")
    check(same_state(first.getBoosterState(), model.getBoosterState()),
          f"two {what} fits of the same data gave different ensembles")
    return model, first_s, fit_s, launches


def fit_parts(torch, clf, df, p, y, same, kern, dev):
    """The warm fit's parts, each timed alone and synchronised: feature
    prep, binning, boosting on the binned matrix, whose trees must be
    ``kern``'s. Returns (bins, seconds by part)."""
    from mmlspark_tpu_torch.models.gbdt import engine, stages
    t0 = time.perf_counter()
    xp, _, _, _ = stages._prepare_fit_features(clf, df)
    prep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    edges = engine.compute_bin_edges(xp, p.max_bin)
    bins = engine.bin_data_auto(xp, edges, None, p.max_bin, dev)
    torch.cuda.synchronize()
    bin_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    boosted = engine.fit_gbdt(None, y, p, binned=(bins, edges), device=dev)
    torch.cuda.synchronize()
    boost_s = time.perf_counter() - t0
    check(same(boosted, kern) == [True] * GBDT_TREES,
          "the binned fit grew other trees")
    return bins, {"feature_prep": prep_s, "binning": bin_s,
                  "boosting": boost_s}


def check_vs_segment(same, kern, x, y, p, dev):
    """The plain path on the card: the segment scatter-add fit's first 10
    trees must be ``kern``'s and its training log-loss within
    TOL_GBDT_LOSS. Returns (segment ensemble, per-tree equality, the two
    losses)."""
    from mmlspark_tpu_torch.models.gbdt import engine
    seg = engine.fit_gbdt(x, y, p._replace(hist_impl="segment"), device=dev)
    identical = same(kern, seg)
    if not all(identical[:10]):
        t = identical.index(False)
        fields = [f for f in ("split_leaf", "feature", "threshold", "is_cat")
                  if hasattr(kern, f)]
        diff = {f: [getattr(e, f)[t].cpu().ravel().tolist()
                    for e in (kern, seg)] for f in fields}
        check(False, f"the first 10 trees differ from the segment fit: "
                     f"{identical[:10]}; tree {t} (card, segment): {diff}")
    losses = [log_loss(engine.predict_raw(e, x, predict_impl="dense"), y)
              for e in (kern, seg)]
    check(abs(losses[0] - losses[1]) <= TOL_GBDT_LOSS,
          f"training log-loss {losses[0]} vs segment fit {losses[1]}")
    return seg, identical, losses


def check_transform(model, df, y, kernel: str) -> dict:
    """Serving: after two warm-up transforms one transform must launch the
    predict ``kernel`` once and nothing else, the dense transform none;
    the kernel's raw scores within TOL_GBDT_PREDICT (relative) of the dense
    path's, labels differing only where the dense margin is within that
    delta, training accuracy >= TOL_GBDT_ACCURACY. Returns the phase's
    serving fields."""
    for _ in range(2):
        model.transform(df)
    reset_gbdt_counts()
    t0 = time.perf_counter()
    scored = model.transform(df)
    transform_s = time.perf_counter() - t0
    launches = gbdt_counts()
    want = {k: int(k == kernel) for k in launches}
    check(launches == want,
          f"launches per transform {launches}, expected {want}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        model.transform(df)
        times.append(time.perf_counter() - t0)
    steady_s = statistics.median(times)
    raw_k = np.stack(scored.col("rawPrediction"))
    reset_gbdt_counts()
    dense = model.copy().setPredictImpl("dense").transform(df)
    check(sum(gbdt_counts().values()) == 0,
          "the dense transform launched a GBDT kernel")
    raw_d = np.stack(dense.col("rawPrediction"))
    check(raw_k.shape == (len(y), 1) and bool(np.isfinite(raw_k).all()),
          f"raw scores: shape {raw_k.shape}")
    delta = float(np.abs(raw_k - raw_d).max())
    rel = delta / float(np.abs(raw_d).max())
    check(rel <= TOL_GBDT_PREDICT,
          f"kernel raw scores differ from dense by {rel} (relative)")
    pred_k = np.asarray(scored.col("prediction"))
    flips = pred_k != np.asarray(dense.col("prediction"))
    check(bool((np.abs(raw_d[flips, 0]) <= delta).all()),
          "labels differ on rows whose dense margin exceeds the raw delta")
    accuracy = float((pred_k == y).mean())
    check(accuracy >= TOL_GBDT_ACCURACY,
          f"training accuracy {accuracy} < {TOL_GBDT_ACCURACY}")
    return {"transform_launches": launches[kernel],
            "transform_s": transform_s, "steady_transform_s": steady_s,
            "transform_rows_per_s": len(y) / steady_s,
            "predict_max_abs_delta_vs_dense": delta,
            "predict_rel_delta_vs_dense": rel,
            "label_flips_vs_dense": int(flips.sum()),
            "train_accuracy": accuracy}


def phase_gbdt(torch, env, dev="cuda"):
    """The GBDT slice at full size: bench_gbdt.py's data -> DataFrame ->
    LightGBMClassifier(device=dev).fit with default Params (depthwise to
    depth 5 on 1M rows, hist_impl auto = the node-histogram kernel) ->
    transform with predictImpl auto (the predict kernel). ``dev`` is for
    rehearsing the phase on the CPU."""
    from mmlspark_tpu_torch import DataFrame, LightGBMClassifier
    from mmlspark_tpu_torch.models.gbdt import engine, stages
    x, y = gbdt_data()
    n, d = x.shape
    df = DataFrame({"features": x, "label": y})
    clf = LightGBMClassifier(device=dev)
    p = clf._engine_params("binary", 1, n_rows=n)
    check(p.num_leaves == 0 and p.max_depth == GBDT_DEPTH
          and p.num_iterations == GBDT_TREES and p.max_bin == GBDT_MAX_BIN,
          f"default Params on {n} rows did not resolve to the slice: {p}")
    model, cold_s, fit_s, fit_launches = warm_fit(
        torch, clf, df, {"node_hist": GBDT_TREES * GBDT_DEPTH, "fused": 0,
                         "predict": 0, "predict_lw": 0}, "level-wise")
    s1 = model.getBoosterState()
    kern = stages._state_to_ensemble(s1, "binary", dev)
    bins, parts = fit_parts(torch, clf, df, p, y, same_trees, kern, dev)
    seg, identical, losses = check_vs_segment(same_trees, kern, x, y, p,
                                              dev)

    # the v1 fused-histogram kernel (hist_impl="pallas") for 10 iterations
    reset_gbdt_counts()
    fused = engine.fit_gbdt(x, y, p._replace(hist_impl="pallas",
                                             num_iterations=10),
                             device=dev)
    torch.cuda.synchronize()
    fused_launches = gbdt_counts()["fused"]
    check(fused_launches == 10 * GBDT_DEPTH,
          f"fused kernel launched {fused_launches} times over 10 iterations")
    check(all(same_trees(fused, seg)),
          "the hist_impl='pallas' fit grew other trees than the segment fit")

    serving = check_transform(model, df, y, "predict")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fitted = fitted_predict_timing(torch, kern, bins)

    # the profile of one boosting iteration at the fit's shapes
    bins_t = bins.T.contiguous()
    raw = torch.full((n, 1), float(s1["base"][0]), device=dev)
    yj = torch.from_numpy(y).to(dev)
    ones_n, ones_d = torch.ones(n, device=dev), torch.ones(d, device=dev)

    def step():
        engine._boost_step_level(
            bins, bins_t, raw, yj, ones_n, ones_d, p.learning_rate, p.alpha,
            depth=p.max_depth, n_bins=p.max_bin, lambda_l2=p.lambda_l2,
            lambda_l1=p.lambda_l1, min_child_weight=p.min_child_weight,
            min_split_gain=p.min_split_gain, hist_impl="mxu",
            objective="binary", num_class=1, update_raw=True)
    step()
    emit({"phase": "gbdt", "rows": n, "features": d,
          "params": {"num_iterations": p.num_iterations,
                     "max_depth": p.max_depth, "max_bin": p.max_bin,
                     "learning_rate": p.learning_rate,
                     "lambda_l2": p.lambda_l2, "objective": p.objective},
          "launches": {"fit": fit_launches,
                       "transform": serving["transform_launches"],
                       "fit_hist_impl_pallas_10_iterations": fused_launches},
          "cold_fit_s": cold_s, "fit_s": fit_s, "fit_parts_s": parts,
          "ms_per_iteration": parts["boosting"] / GBDT_TREES * 1e3,
          "identical_trees_vs_segment": sum(identical),
          "train_log_loss": losses[0], "train_log_loss_segment": losses[1],
          **serving, "peak_mem_gb": peak_gb,
          "predict_kernel_on_fitted_trees": fitted,
          "gpu": env.gpu_name_and_power_limit(),
          "profile_of_one_iteration": device_breakdown(torch, step, top=10)})
    return {"node_hist": fit_launches["node_hist"], "fused": fused_launches,
            "predict": serving["transform_launches"]}


def phase_gbdt_leafwise(torch, env, dev="cuda"):
    """The leaf-wise GBDT slice at full size: bench_gbdt.py's data ->
    LightGBMClassifier(device=dev).setGrowthPolicy("leafwise").fit (31
    leaves best-first, the node-histogram kernel with 2 nodes a round) ->
    transform with predictImpl auto (the leaf-wise predict kernel). ``dev``
    is for rehearsing the phase on the CPU."""
    from mmlspark_tpu_torch import DataFrame, LightGBMClassifier
    from mmlspark_tpu_torch.models.gbdt import engine, stages
    x, y = gbdt_data()
    n, d = x.shape
    df = DataFrame({"features": x, "label": y})
    clf = LightGBMClassifier(device=dev).setGrowthPolicy("leafwise")
    p = clf._engine_params("binary", 1, n_rows=n)
    check(p.num_leaves == GBDT_LEAVES and p.max_depth == 0
          and p.num_iterations == GBDT_TREES and p.max_bin == GBDT_MAX_BIN,
          f"leafwise Params on {n} rows did not resolve to the slice: {p}")
    model, cold_s, fit_s, fit_launches = warm_fit(
        torch, clf, df, {"node_hist": GBDT_LEAVES * GBDT_TREES, "fused": 0,
                         "predict": 0, "predict_lw": 0}, "leaf-wise")
    s1 = model.getBoosterState()
    check(s1.get("kind") == "leafwise", "the fit was not leaf-wise")
    kern = stages._state_to_ensemble(s1, "binary", dev)
    bins, parts = fit_parts(torch, clf, df, p, y, same_trees_lw, kern, dev)
    _, identical, losses = check_vs_segment(same_trees_lw, kern, x, y, p,
                                            dev)
    serving = check_transform(model, df, y, "predict_lw")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fitted = fitted_predict_timing(torch, kern, bins)

    # the profile of one boosting iteration at the fit's shapes
    bins_t = bins.T.contiguous()
    raw = torch.full((n, 1), float(s1["base"][0]), device=dev)
    yj = torch.from_numpy(y).to(dev)
    ones_n, ones_d = torch.ones(n, device=dev), torch.ones(d, device=dev)
    no_cats = torch.zeros(d, device=dev)

    def step():
        engine._boost_step_leafwise(
            bins, bins_t, raw, yj, ones_n, ones_d, no_cats, p.learning_rate,
            p.alpha, num_leaves=p.num_leaves, n_bins=p.max_bin,
            lambda_l2=p.lambda_l2, lambda_l1=p.lambda_l1,
            min_child_weight=p.min_child_weight,
            min_split_gain=p.min_split_gain, cat_smooth=p.cat_smooth,
            max_depth=0, hist_impl="mxu", has_cats=False,
            objective="binary", num_class=1, update_raw=True)
    step()
    emit({"phase": "gbdt_leafwise", "rows": n, "features": d,
          "params": {"num_iterations": p.num_iterations,
                     "num_leaves": p.num_leaves, "max_depth": p.max_depth,
                     "max_bin": p.max_bin, "learning_rate": p.learning_rate,
                     "lambda_l2": p.lambda_l2, "objective": p.objective},
          "launches": {"fit": fit_launches,
                       "transform": serving["transform_launches"]},
          "real_splits": int((np.asarray(s1["split_leaf"]) >= 0).sum()),
          "cold_fit_s": cold_s, "fit_s": fit_s, "fit_parts_s": parts,
          "ms_per_iteration": parts["boosting"] / GBDT_TREES * 1e3,
          "identical_trees_vs_segment": sum(identical),
          "train_log_loss": losses[0], "train_log_loss_segment": losses[1],
          **serving, "peak_mem_gb": peak_gb,
          "predict_kernel_on_fitted_trees": fitted,
          "gpu": env.gpu_name_and_power_limit(),
          "profile_of_one_iteration": device_breakdown(torch, step, top=10)})
    return {"node_hist": fit_launches["node_hist"],
            "predict_lw": serving["transform_launches"]}


def efb_frame():
    """bench_efb.py:22-41: 200k rows x 2^16 columns, 24 zipf(1.3) tokens a
    row plus one signal token of 8 (numpy seed 0); the label is which half
    of the signal vocabulary the row's token is in."""
    import scipy.sparse as sp
    from mmlspark_tpu_torch import DataFrame
    from mmlspark_tpu_torch.core.utils import object_column
    rng = np.random.default_rng(0)
    n, d = EFB_ROWS, EFB_COLS
    rows = np.repeat(np.arange(n), EFB_NNZ)
    cols = (np.minimum(d - 1, rng.zipf(1.3, size=n * EFB_NNZ) - 1)
            .astype(np.int64))
    sig_ids = np.array([5000, 9000, 14000, 20000, 27000, 35000, 44000,
                        54000])
    sig_pick = rng.integers(0, len(sig_ids), n)
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, sig_ids[sig_pick]])
    x = sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                      shape=(n, d))
    y = (sig_pick % 2).astype(np.float64)
    return DataFrame({"features": object_column(list(x)), "label": y}), y


def phase_gbdt_efb(torch, env, dev="cuda"):
    """bench_efb.py's wide-sparse fit: default Params on 200k rows resolve
    to leaf-wise growth, the tail columns bundle into categorical
    composites (EFB), and the fit splits them as category sets."""
    from mmlspark_tpu_torch import LightGBMClassifier
    from mmlspark_tpu_torch.models.gbdt import stages
    t0 = time.perf_counter()
    df, y = efb_frame()
    data_s = time.perf_counter() - t0
    clf = (LightGBMClassifier(device=dev).setNumIterations(EFB_ITERS)
           .setMaxDenseFeatures(EFB_DENSE))
    p = clf._engine_params("binary", 1, n_rows=len(y))
    check(p.num_leaves == GBDT_LEAVES,
          f"default Params on {len(y)} rows did not resolve to leaf-wise "
          f"growth: {p}")
    model, first_s, fit_s, fit_launches = warm_fit(
        torch, clf, df, {"node_hist": GBDT_LEAVES * EFB_ITERS, "fused": 0,
                         "predict": 0, "predict_lw": 0}, "EFB")
    state = model.getBoosterState()
    bundles = model.getFeatureBundles() or []
    n_dense = len(model.getFeatureSelection())
    cat_features = np.asarray(state["cat_features"])
    check(len(bundles) > 0 and n_dense == EFB_DENSE
          and cat_features[n_dense:].all() and not cat_features[:n_dense].any()
          and len(cat_features) == n_dense + len(bundles)
          and len(cat_features) == EFB_FIT_FEATURES,
          f"EFB planned {len(bundles)} bundles beside {n_dense} dense "
          f"columns; categorical features {int(cat_features.sum())}; "
          f"kernel_gbdt checks the node histogram at {EFB_FIT_FEATURES}")
    cat_splits = int(np.asarray(state["is_cat"]).sum())
    # the plain path on the same bundled matrix and categorical features
    xb, _, _, bundle_cats = stages._prepare_fit_features(clf, df)
    pb = clf._engine_params("binary", 1, categorical=bundle_cats,
                            n_rows=len(y))
    kern = stages._state_to_ensemble(state, "binary", dev)
    _, identical, losses = check_vs_segment(
        same_trees_lw, kern, xb, y.astype(np.float32), pb, dev)
    del xb
    reset_gbdt_counts()
    t0 = time.perf_counter()
    scored = model.transform(df)
    transform_s = time.perf_counter() - t0
    transform_launches = gbdt_counts()
    check(sum(transform_launches.values()) == 0,
          f"the EFB transform (the dense replay) launched a GBDT kernel: "
          f"{transform_launches}")
    raw = np.stack(scored.col("rawPrediction"))
    check(raw.shape == (len(y), 1) and bool(np.isfinite(raw).all()),
          f"raw scores: shape {raw.shape}")
    accuracy = float((np.asarray(scored.col("prediction")) == y).mean())
    check(accuracy >= TOL_EFB_ACCURACY,
          f"EFB training accuracy {accuracy} < {TOL_EFB_ACCURACY}")
    emit({"phase": "gbdt_efb", "rows": len(y), "columns": EFB_COLS,
          "nnz_per_row": EFB_NNZ + 1, "num_iterations": EFB_ITERS,
          "dense_columns": n_dense, "bundles": len(bundles),
          "bundled_columns": int(sum(len(b) for b in bundles)),
          "categorical_splits": cat_splits,
          "real_splits": int((np.asarray(state["split_leaf"]) >= 0).sum()),
          "identical_trees_vs_segment": sum(identical),
          "train_log_loss": losses[0], "train_log_loss_segment": losses[1],
          "launches": {"fit": fit_launches, "transform": transform_launches},
          "data_s": data_s, "first_fit_s": first_s, "fit_s": fit_s,
          "fit_ms_per_iteration": fit_s / EFB_ITERS * 1e3,
          "transform_s": transform_s,
          "transform_rows_per_s": len(y) / transform_s,
          "train_accuracy": accuracy,
          "gpu": env.gpu_name_and_power_limit()})
    return {"node_hist": fit_launches["node_hist"]}


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


# ------------------------------------------------------------------ vision

def image_frame(x, col="image"):
    """A DataFrame of image rows (the ImageSchema struct) from NHWC uint8."""
    from mmlspark_tpu_torch import DataFrame
    from mmlspark_tpu_torch.core.schema import make_image_row
    from mmlspark_tpu_torch.core.utils import object_column
    rows = object_column([make_image_row(f"img{i}", *x[i].shape, x[i])
                          for i in range(len(x))])
    return DataFrame({col: rows})


def host_rows_per_s(torch, fn, rows: int, dev: str, repeats: int = 3):
    """Rows per second of ``fn`` by the host clock, the median of
    ``repeats`` calls after one warm-up; each call ends in its read-back,
    which waits for the card."""
    fn()
    times = []
    for _ in range(repeats):
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return rows / statistics.median(times)


def rel_l2_rows(got, want) -> float:
    """The largest ||got_i - want_i||_2 / ||want_i||_2 over rows i."""
    num = np.linalg.norm(got - want, axis=1)
    den = np.maximum(np.linalg.norm(want, axis=1), 1e-30)
    return float((num / den).max())


def phase_vision_ops(torch, env, dev="cuda"):
    """ImageTransformer's chain on VISION_OPS_ROWS images of 256 x 256 x 3
    (numpy seed 0), on the card against the same stage on the CPU."""
    from mmlspark_tpu_torch.ops.image_stages import ImageTransformer
    from mmlspark_tpu_torch.core.schema import image_to_array
    rng = np.random.default_rng(SEED)
    x = rng.integers(0, 256, size=(VISION_OPS_ROWS, VISION_OPS_HW,
                                   VISION_OPS_HW, 3), dtype=np.uint8)
    df = image_frame(x)

    def chain(device):
        t = ImageTransformer(inputCol="image", outputCol="out", device=device)
        for name, args in VISION_CHAIN:
            t = getattr(t, name)(*args)
        return t

    card = chain(dev)
    got = np.stack([image_to_array(r) for r in card.transform(df).col("out")])
    t0 = time.perf_counter()
    want = np.stack([image_to_array(r) for r in
                     chain("cpu").transform(df).col("out")])
    cpu_s = time.perf_counter() - t0
    worst = int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max())
    differ = float((got != want).mean())
    rows_s = host_rows_per_s(torch, lambda: card.transform(df),
                             VISION_OPS_ROWS, dev)
    emit({"phase": "vision_ops", "rows": VISION_OPS_ROWS,
          "in_shape": list(x.shape[1:]), "out_shape": list(got.shape[1:]),
          "chain": VISION_CHAIN, "max_count_diff_vs_cpu": worst,
          "share_of_values_differing": differ, "rows_per_s": rows_s,
          "cpu_rows_per_s": VISION_OPS_ROWS / cpu_s,
          "gpu": env.gpu_name_and_power_limit()})
    check(got.shape == want.shape, f"chain shapes {got.shape} {want.shape}")
    check(worst <= TOL_VISION_COUNTS,
          f"the image chain on the card differs from the CPU's by {worst} "
          f"counts")


def phase_vision_serve(torch, env, dev="cuda"):
    """(a) the zoo's ResNet20_shapes10 through ModelDownloader and
    TorchModel on shapes10's held-out images; (b) ImageFeaturizer over a
    full-width ResNet-50 imported from a torchvision-layout checkpoint;
    (c) the BiLSTM tagger. Each against the CPU."""
    import os
    import shutil
    import tempfile
    from mmlspark_tpu_torch import DataFrame, TorchModel
    from mmlspark_tpu_torch.models.downloader import ModelDownloader
    from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models.import_weights import import_resnet50
    from mmlspark_tpu_torch.models.trainer import init_params
    from mmlspark_tpu_torch.testing.datagen import (make_shapes10,
                                                    make_torchvision_state)
    out = {"phase": "vision_serve", "gpu": env.gpu_name_and_power_limit()}

    # (a) the zoo scorer: a copy of zoo/ as the local repository
    with tempfile.TemporaryDirectory() as tmp:
        repo = os.path.join(tmp, "zoo")
        shutil.copytree("zoo", repo)
        schema = ModelDownloader(repo).downloadByName("ResNet20", "shapes10")
        model = TorchModel(inputCol="image", device=dev).setModelSchema(
            schema)
        x, y = make_shapes10(ZOO_EVAL_ROWS, seed=8)
        df = image_frame(x)
        scores = np.stack(model.transform(df).col("scores"))
        acc = float((scores.argmax(1) == y).mean())
        out["zoo_resnet20_shapes10"] = {
            "rows": ZOO_EVAL_ROWS, "sha256": schema.hash,
            "config": model.getModelConfig(), "accuracy": acc,
            "rows_per_s": host_rows_per_s(torch, lambda: model.transform(df),
                                          ZOO_EVAL_ROWS, dev)}
    check(acc >= TOL_ZOO_ACCURACY,
          f"zoo ResNet20_shapes10 scored {acc} on shapes10's held-out rows")

    # (b) ResNet-50 features: bf16 on the card, f32 on the CPU
    t0 = time.perf_counter()
    cfg, sd = import_resnet50(make_torchvision_state(),
                              preprocess="imagenet_uint8")
    import_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 4)
    x = rng.integers(0, 256, size=(FEAT_ROWS, FEAT_HW, FEAT_HW, 3),
                     dtype=np.uint8)
    df = image_frame(x)

    def featurizer(dtype, device):
        return ImageFeaturizer(inputCol="image", cutOutputLayers=1,
                               device=device).setModel(TorchModel(
                                   modelConfig=dict(cfg, dtype=dtype),
                                   modelParams=sd))

    card = featurizer("bfloat16", dev)
    feats = np.stack(card.transform(df).col("features"))
    cpu = featurizer("float32", "cpu")
    ref = np.stack(cpu.transform(DataFrame(
        {"image": df.col("image")[:FEAT_CPU_ROWS]})).col("features"))
    feat_err = rel_l2_rows(feats[:FEAT_CPU_ROWS], ref)
    out["resnet50_featurizer"] = {
        "rows": FEAT_ROWS, "in_hw": FEAT_HW, "net_hw": cfg["height"],
        "feature_dim": int(feats.shape[1]), "cpu_rows": FEAT_CPU_ROWS,
        "max_row_rel_l2_vs_cpu_f32": feat_err, "import_s": import_s,
        "finite": bool(np.isfinite(feats).all()),
        "rows_per_s": host_rows_per_s(torch, lambda: card.transform(df),
                                      FEAT_ROWS, dev)}
    check(feats.shape == (FEAT_ROWS, cfg["widths"][-1])
          and bool(np.isfinite(feats).all()),
          f"ResNet-50 features: shape {feats.shape}, finite "
          f"{bool(np.isfinite(feats).all())}")
    check(feat_err <= TOL_VISION_L2,
          f"ResNet-50 features on the card are {feat_err} (relative L2) "
          f"from the CPU's")

    # (c) the BiLSTM tagger at its default config
    bcfg = {"type": "bilstm"}
    params = init_params(bcfg, SEED)
    tokens = rng.integers(0, 10000, size=(BILSTM_ROWS, BILSTM_SEQ),
                          dtype=np.int32)
    tdf = DataFrame({"tokens": tokens})

    def tagger(dtype, device):
        return TorchModel(inputCol="tokens", modelConfig=dict(bcfg,
                                                              dtype=dtype),
                          modelParams=params, device=device)

    bcard = tagger("bfloat16", dev)
    logits = np.stack(bcard.transform(tdf).col("scores"))
    blogits = np.stack(tagger("float32", "cpu").transform(tdf).col("scores"))
    shape = logits.shape
    lstm_err = rel_l2_rows(logits.reshape(-1, shape[-1]),
                           blogits.reshape(-1, shape[-1]))
    out["bilstm"] = {"rows": BILSTM_ROWS, "seq": BILSTM_SEQ,
                     "max_row_rel_l2_vs_cpu_f32": lstm_err,
                     "lstm_dtype": "float32",
                     "bf16_cudnn_lstm": bf16_lstm_probe(torch, dev),
                     "rows_per_s": host_rows_per_s(
                         torch, lambda: bcard.transform(tdf), BILSTM_ROWS,
                         dev)}
    emit(out)
    check(shape == (BILSTM_ROWS, BILSTM_SEQ, 8), f"BiLSTM logits {shape}")
    check(lstm_err <= TOL_VISION_L2,
          f"BiLSTM logits on the card are {lstm_err} (relative L2) from "
          f"the CPU's")


def bf16_lstm_probe(torch, dev) -> dict:
    """Whether torch's LSTM takes bfloat16 on this device (the port's runs
    in float32 either way): one small bidirectional call, and its distance
    from the same call in float32."""
    lstm = torch.nn.LSTM(16, 16, batch_first=True, bidirectional=True,
                         device=dev)
    x = torch.randn(2, 8, 16, device=dev)
    ref = lstm(x)[0]
    try:
        got = lstm.to(torch.bfloat16)(x.to(torch.bfloat16))[0]
    except RuntimeError as e:               # a probe, not a code path
        return {"runs": False, "error": str(e)[:200]}
    return {"runs": True,
            "max_abs_diff_vs_f32": (got.float() - ref).abs().max().item()}


def image_step_grads(torch, cfg, x, y, device, dtype) -> dict:
    """One step's gradients of ``cfg`` (the fit's init, seed SEED) at
    ``dtype`` on ``device``, as CPU float32 tensors."""
    from mmlspark_tpu_torch.models import precision as prec
    from mmlspark_tpu_torch.models import trainer
    from mmlspark_tpu_torch.models.modules import build_model, sized_for
    from mmlspark_tpu_torch.models.torch_model import full_precision_matmuls
    c = sized_for(dict(cfg, dtype=dtype), x.shape)
    params = {k: v.to(device) for k, v in
              trainer.init_params(c, SEED).items()}
    with torch.device("meta"):
        module = build_model(c)
    loss_fn = trainer.make_loss("cross_entropy", per_example=True)
    xb = torch.from_numpy(x).to(device)
    yb = torch.from_numpy(y.astype(np.int32)).to(device)
    wb = torch.ones(len(x), device=device)
    with full_precision_matmuls(dtype == "float32"):
        _, grads = prec.value_and_grad(
            trainer._make_loss_compute(module, loss_fn), params, xb, yb, wb)
    return {k: g.float().cpu() for k, g in grads.items()}


def grad_l2_errors(got: dict, want: dict) -> dict:
    return {k: float((got[k] - want[k]).norm()
                     / want[k].norm().clamp_min(1e-30)) for k in want}


def image_step_profile(torch, cfg, x, y, dev, lr=BENCH_LR) -> dict:
    """device_breakdown of one optimizer step of ``cfg`` (the fit's init,
    momentum, on the first batch) after one warm-up step."""
    from mmlspark_tpu_torch.models import trainer
    from mmlspark_tpu_torch.models.modules import build_model, sized_for
    c = sized_for(cfg, x.shape)
    with torch.device("meta"):
        module = build_model(c)
    params = {k: v.to(dev) for k, v in trainer.init_params(c, SEED).items()}
    tx = trainer.make_optimizer("momentum", lr, 0.9)
    body = trainer._make_step_body(
        module, tx, trainer.make_loss("cross_entropy", per_example=True))
    xb = torch.from_numpy(x).to(dev)
    yb = torch.from_numpy(y.astype(np.int32)).to(dev)
    wb = torch.ones(len(x), device=dev)
    state = [params, tx.init(params)]

    def step():
        state[0], state[1], _ = body(state[0], state[1], xb, yb, wb)

    step()
    return device_breakdown(torch, step, top=10)


def phase_vision_train(torch, env, dev="cuda"):
    """(a) bench.py's ResNet-20 training shape through TorchLearner; (b) the
    zoo's shapes10 recipe, scored on the held-out rows, and one step's
    gradients against the CPU's in float32."""
    from mmlspark_tpu_torch import TorchLearner
    from mmlspark_tpu_torch.testing.datagen import make_shapes10
    cfg = {"type": "resnet", "num_classes": 10}
    rng = np.random.default_rng(SEED)
    x = rng.integers(0, 256, size=(BENCH_ROWS, 32, 32, 3)).astype(np.uint8)
    y = rng.integers(0, 10, size=BENCH_ROWS).astype(np.int32)
    df = image_frame(x)
    df = df.withColumn("label", y)
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bench = TorchLearner(featuresCol="image", modelConfig=cfg,
                         batchSize=BENCH_BATCH, optimizer="momentum",
                         learningRate=BENCH_LR, momentum=0.9,
                         precision="bf16", epochs=BENCH_EPOCHS, seed=SEED,
                         device=dev).fit(df)
    fit_s = time.perf_counter() - t0
    stats = bench._fit_stats
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda"
               else None)
    steps = stats["steps_per_epoch"]
    step_ms = [s / steps * 1e3 for s in stats["epoch_seconds"]]
    bench_step_ms = statistics.median(step_ms[1:])
    profile = image_step_profile(torch, cfg, x[:BENCH_BATCH],
                                 y[:BENCH_BATCH], dev)
    out_a = {"config": cfg, "rows": BENCH_ROWS, "batch": BENCH_BATCH,
             "epochs": BENCH_EPOCHS, "steps_per_epoch": steps,
             "path": stats["path"], "optimizer": "momentum",
             "learning_rate": BENCH_LR, "momentum": 0.9,
             "precision": "bf16", "fit_s": fit_s,
             "epoch_losses": stats["epoch_losses"],
             "step_ms_by_epoch": step_ms, "step_ms": bench_step_ms,
             "imgs_per_s": BENCH_BATCH / bench_step_ms * 1e3,
             "peak_mem_gb": peak_gb, "profile_of_one_step": profile}
    check(stats["path"] == "scan" and steps == BENCH_STEPS,
          f"bench fit took the {stats['path']} path, {steps} steps an epoch")
    check(all(np.isfinite(stats["epoch_losses"])),
          f"bench fit losses {stats['epoch_losses']}")

    # (b) the zoo's shapes10 recipe (tools/build_zoo.py:34-56, 94)
    xs, ys = make_shapes10(RECIPE_ROWS, seed=7)
    xv, yv = make_shapes10(ZOO_EVAL_ROWS, seed=8)
    tdf = image_frame(xs).withColumn("label", ys)
    t0 = time.perf_counter()
    model = TorchLearner(featuresCol="image", modelConfig=cfg,
                         batchSize=RECIPE_BATCH, optimizer="momentum",
                         learningRate=RECIPE_LR, epochs=RECIPE_EPOCHS,
                         seed=SEED, device=dev).fit(tdf)
    recipe_s = time.perf_counter() - t0
    scores = np.stack(model.transform(image_frame(xv)).col("scores"))
    acc = float((scores.argmax(1) == yv).mean())
    xb, yb = xs[:RECIPE_BATCH], ys[:RECIPE_BATCH]
    recipe_profile = image_step_profile(torch, cfg, xb, yb, dev,
                                        lr=RECIPE_LR)
    cpu32 = image_step_grads(torch, cfg, xb, yb, "cpu", "float32")
    errs = {p: grad_l2_errors(image_step_grads(torch, cfg, xb, yb, dev, p),
                              cpu32)
            for p in ("bfloat16", "float32")}
    worst = {p: max(e, key=e.get) for p, e in errs.items()}
    rstats = model._fit_stats
    out_b = {"rows": RECIPE_ROWS, "epochs": RECIPE_EPOCHS,
             "batch": RECIPE_BATCH, "learning_rate": RECIPE_LR,
             "path": rstats["path"], "fit_s": recipe_s,
             "epoch_losses": rstats["epoch_losses"],
             "step_ms": statistics.median(rstats["epoch_seconds"][1:])
             / rstats["steps_per_epoch"] * 1e3,
             "heldout_rows": ZOO_EVAL_ROWS, "heldout_accuracy": acc,
             "profile_of_one_step": recipe_profile,
             "grad_check_rows": RECIPE_BATCH,
             "grad_l2_rel_vs_cpu_f32": {
                 p: {"worst": worst[p], "value": errs[p][worst[p]],
                     "median": statistics.median(errs[p].values())}
                 for p in errs},
             "tol_grad": TOL_TRAIN_GRAD}
    emit({"phase": "vision_train", "bench_shape": out_a,
          "shapes10_recipe": out_b, "gpu": env.gpu_name_and_power_limit()})
    check(acc >= TOL_RECIPE_ACCURACY,
          f"the shapes10 recipe scored {acc} on the held-out rows")
    check(errs["float32"][worst["float32"]] <= TOL_TRAIN_GRAD,
          f"one f32 step's gradient of {worst['float32']} on the card is "
          f"{errs['float32'][worst['float32']]} (relative L2) from the "
          f"CPU's")
    # bf16 gradients carry bf16's rounding (a GroupNorm scale's gradient
    # is a sum of many terms that mostly cancel, read up to ~3.3e-2 from
    # f32 on an H100): the gate holds their median, the worst is printed
    bf16_median = statistics.median(errs["bfloat16"].values())
    check(bf16_median <= TOL_TRAIN_GRAD,
          f"one bf16 step's gradients on the card are a median "
          f"{bf16_median} (relative L2) from the CPU's in f32")


def gbdt_entry(name, source, line, launches, by_path, err, timing) -> dict:
    """One GBDT kernel's entry of the kernels line."""
    return {"name": name, "route": "cuda",
            "source": "mmlspark_tpu_torch/ops/csrc/" + source,
            "replaces": "mmlspark_tpu/ops/pallas_kernels.py:" + line,
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": err, "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            "library_ms": timing["library_ms"]}


PHASES = ("build", "kernel", "kernel_bwd", "kernel_gbdt", "slice", "train",
          "gbdt", "gbdt_leafwise", "gbdt_efb", "vision_ops", "vision_serve",
          "vision_train")
PHASE_FNS = {
    "build": phase_build,
    "kernel": lambda torch, env: phase_kernel(torch),
    "kernel_bwd": lambda torch, env: phase_kernel_bwd(torch),
    "kernel_gbdt": lambda torch, env: phase_kernel_gbdt(torch),
    "slice": phase_slice,
    "train": phase_train,
    "gbdt": lambda torch, env: phase_gbdt(torch, env),
    "gbdt_leafwise": lambda torch, env: phase_gbdt_leafwise(torch, env),
    "gbdt_efb": lambda torch, env: phase_gbdt_efb(torch, env),
    "vision_ops": phase_vision_ops,
    "vision_serve": phase_vision_serve,
    "vision_train": phase_vision_train,
}


def phases_from_argv(argv) -> tuple:
    """``--phases a,b`` runs those phases alone (a rehearsal: it prints no
    result line); no arguments run every phase."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    names = tuple(n for n in ap.parse_args(argv).phases.split(",") if n)
    unknown = [n for n in names if n not in PHASES]
    if unknown:
        ap.error(f"unknown phases {unknown}")
    return names


def main(argv=None) -> int:
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
    chosen = phases_from_argv(argv)
    if chosen != PHASES:
        # a rehearsal of some phases: their lines, the card, no result
        for name in chosen:
            PHASE_FNS[name](torch, env)
        print(env.gpu_name_and_power_limit(), flush=True)
        return 0
    phase_build(torch, env)
    worst, timing = phase_kernel(torch)
    bwd_worst, bwd = phase_kernel_bwd(torch)
    gbdt_worst, gbdt_timing = phase_kernel_gbdt(torch)
    serve_launches = phase_slice(torch, env)
    train = phase_train(torch, env)
    gbdt = phase_gbdt(torch, env)
    leafwise = phase_gbdt_leafwise(torch, env)
    efb = phase_gbdt_efb(torch, env)
    # the image paths run on cuDNN/cuBLAS and plain PyTorch: no kernel of
    # the table may launch in them
    reset_kernel_counts()
    reset_gbdt_counts()
    phase_vision_ops(torch, env)
    phase_vision_serve(torch, env)
    phase_vision_train(torch, env)
    vision_launches = {**kernel_counts(), **gbdt_counts()}
    emit({"phase": "vision_kernel_launches", "launches": vision_launches})
    check(not any(vision_launches.values()),
          f"the vision phases launched kernels of the table: "
          f"{vision_launches}")
    hist_by_path = {"fit": gbdt["node_hist"],
                    "fit_leafwise": leafwise["node_hist"],
                    "fit_efb": efb["node_hist"]}
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
         "library_ms": bwd["library_ms"]},
        gbdt_entry("mxu_node_histogram", "gbdt_histogram.cu", "447",
                   sum(hist_by_path.values()), hist_by_path,
                   gbdt_worst["node_hist"], gbdt_timing["node_hist"]),
        gbdt_entry("gbdt_predict_quant_levelwise", "gbdt_predict.cu", "585",
                   gbdt["predict"], {"transform": gbdt["predict"]},
                   gbdt_worst["predict"], gbdt_timing["predict"]),
        gbdt_entry("gbdt_predict_quant_leafwise", "gbdt_predict.cu", "622",
                   leafwise["predict_lw"],
                   {"transform_leafwise": leafwise["predict_lw"]},
                   gbdt_worst["predict_lw"], gbdt_timing["predict_lw"]),
        gbdt_entry("histogram_fused", "gbdt_histogram.cu", "769",
                   gbdt["fused"],
                   {"fit_hist_impl_pallas_10_iterations": gbdt["fused"]},
                   gbdt_worst["fused"], gbdt_timing["fused"])]})
    print(env.gpu_name_and_power_limit(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
