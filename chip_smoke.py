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
   from a numpy seed) -> scores, after ``warmup`` (which captures the
   8-row bucket's CUDA graph: each chunk is one replay). The forward
   kernel's launch count over that one transform must be layers x chunks
   (counted across replays); the scores must be finite and match the same
   model with plain-PyTorch blockwise attention.
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
13. automl_tabular — the AutoML path on an adult-census-shaped table at
   HIGGS scale (``adult_frame``: gbdt_data's 1M x 28 draws as x0..x27,
   string categoricals education (16 levels) and workclass (8), a string
   label), split 80/20 with ``randomSplit(seed=1)``; Featurize makes 52
   columns. (a) ``TrainClassifier`` with LogisticRegression (defaults),
   NaiveBayes(modelType="gaussian"), LightGBMClassifier (defaults:
   level-wise, 100 iterations), RandomForestClassifier (50 trees) on the
   800k rows and MultilayerPerceptronClassifier(layers=(64,), batchSize
   1024, maxIter 5) on a 100k-row sample (cut: the defaults would be ~190k
   host-paced steps): fit seconds, held-out transform rows/s (median of 3
   after a warm-up), ComputeModelStatistics on the 200k held-out rows;
   every accuracy >= 0.85 but gaussian NB's >= 0.8 (its independence
   assumption does not hold for this label); LR's coefficients within 1e-3 (relative L2) and
   its held-out AUC within 1e-4 of the same fit on the CPU; gaussian NB's
   means and variances within 1e-5 of the CPU's; the LightGBM fit's first
   10 trees equal to a 10-iteration fit of its Params through the plain
   segment-histogram path on the card (after the counted run); 500
   node-histogram launches per LightGBM fit and one level-wise predict
   launch per transform, none for LR, NB and the MLP (RF's printed);
   FindBestModel(AUC) names the learner with the highest AUC. (b)
   ``TuneHyperparameters`` over [LogisticRegression, LightGBMClassifier]
   (numRuns 3, numFolds 2, parallelism 4, AUC) on a featurized 100k-row
   sample: the folds grow leaf-wise, and the launches over the search
   (its 4 threads) equal the sum of its fits' (numLeaves x numIterations
   node histograms each) and fold scorings' (one leaf-wise predict each);
   the refit model's held-out AUC within 0.01 of its CV AUC. (c) the
   reference's grid (``TRAIN_CLASSIFIER_REFERENCE_AUC`` rows of the three
   default-tier datasets, tests/test_reference_goldens.py's configs) on
   the card: train AUC >= the committed value - 0.02. No plain version of
   a table kernel runs on the card in the phase's counted run (checked).
14. automl_text — the text path on an Amazon-reviews-shaped corpus
   (``review_corpus``: 100k documents of 20-120 Zipf(1.1) tokens over
   50,000 words with 3 of notebook 201's planted words a document by
   label), 80/20. (a) TextFeaturizer (2^18 dims, IDF, stop words
   removed) -> multinomial NaiveBayes (sparse, on the host): featurize
   rows/s and accuracy >= 0.85. (b) ``TrainClassifier(LogisticRegression)``
   on the raw text (Featurize hashes it to 4096 dense columns, 1.3 GB on
   the card): fit seconds, accuracy >= 0.85, and LR on a 20k-row subset
   within 1e-3 (relative L2 of the coefficients) of the CPU's. (c)
   Word2Vec at its defaults on the 80k training documents: vocabulary,
   pairs, steps/s, LR on the document vectors >= 0.8, at least 3 planted
   positive words among ``findSynonyms("great", 5)``; one SGNS step at the
   fit's shapes within 1e-5 (relative L2: loss and both tables) of the
   CPU's, a repeat to the same bits, its time and profile. No kernel of
   the table launches (checked).

15. platform — the stages, telemetry, profiler and fault base of the port
   on the GBDT and training paths. The AutoML table (``platform_frame``:
   ``adult_frame`` with 1 % of x3 set to NaN from numpy seed SEED + 11)
   through CleanMissingData(Median) -> DataConversion(x4, double) ->
   SelectColumns -> ClassBalancer(workclass) first feeds a leaf-wise
   TrainClassifier(LightGBMClassifier, 31 leaves, 20 iterations) whose two
   transforms run under ``telemetry.profiler``: one ``gbdt.predict_quant``
   call, one row-6 launch and FLOPs and bytes > 0 each. Then the same
   stages before Profiler(Timer(logToProfiler=True)(TrainClassifier(
   LightGBMClassifier, 20 level-wise iterations))) as one Pipeline, fitted
   once; its model's transform with telemetry off, then on: exactly 20
   iterations, 20 iteration times and one bin time, the spans gbdt/fit
   holding gbdt/bin and 20 gbdt/iter/step, a predict-table gauge > 0, 100
   row-4 launches and one row-5 launch in each run, the Chrome trace
   holding the Timer's range and CUDA kernels, the predictions the same
   bits with telemetry on and off (the two transforms' seconds printed, a
   reading), SummarizeData over the scored frame. Last the training
   slice at 2 layers (``PLATFORM_LAYERS``), one step a dispatch:
   ``TorchLearner(profile=True, sloConfig=...)`` — the profiled FLOPs of a
   step within 10 % of ``train_step_flops`` (rows 1-3 included through the
   kernels' reports), one step-time observation and one profiled call a
   step, the SLO report naming its objective, the memory peak gauge equal
   to ``max_memory_allocated`` — then two clean fits and one whose 4th
   step faults once (``PLATFORM_FAULT``) and is retried: its loss and
   parameters no further from the clean fits than twice their own gap.
16. ingest — out-of-core training, checkpoints and the file ingest that
   feeds them (``INGEST_*``). (a) ``TRAIN_CFG`` at full width through
   ``TorchLearner.fitStream``: 4 batches of 8 x 4096 tokens and a ragged one
   of 5 (padded to 8, weight 0) an epoch, 3 epochs; one fit uninterrupted,
   one with epoch checkpoints killed by ``trainer.step`` faults in epoch 3
   and refitted on its directory: it resumes from epoch 2's checkpoint and
   ends on the uninterrupted fit's parameters bit for bit; that
   directory's newest checkpoint truncated, a refit skips it (counted on
   ``mmlspark_ckpt_corrupt_total``) and again ends on the same bits. The
   same 37 rows through ``fit()``'s feed path with async, 4-shard step
   checkpoints every 2 steps (2 kept), bit-equal to the fit without
   checkpoints; killed on epoch 2's last step, the refit resumes from the
   step checkpoint before it, dispatches exactly the 6 steps left and ends
   on the same bits. Rows 1-3 launch exactly 2 x layers, layers and layers
   times a dispatched step in every fit. Prints the checkpoint writes,
   their seconds, the coalesced snapshots and the step time with async
   checkpoints off and on. (b) bench.py's ResNet-20 (momentum 0.01 / 0.9,
   bf16) from 24,576 image files of 32 x 32 x 3 (PPM, BMP and, where the
   native build decodes it, PNG, written by ``io.image``'s encoders) through
   ``io.loader.device_image_batches`` in batches of 12288 (bucketed to
   16384 rows by fitStream): every device batch equal to its files' numpy
   decode bit for bit, the loader's images/s; three fitStream epochs, two
   clean fits and one killed in epoch 3 and resumed, within twice the two
   clean fits' gap (relative L2); rows 1-7 launch nothing. (c) bench_gbdt.py's
   draws at 262,144 rows as a CSV file: ``io.read_csv_matrix`` (the native
   threaded parser) bit for bit ``np.loadtxt``'s float32 parse, its MB/s;
   ``LightGBMClassifier(numIterations=20)`` on it launches row 4 exactly 100
   times and its transform row 5 once, training accuracy >= 0.85. (d)
   ``native.interleave_f32`` over the 28 columns equal to ``np.stack``. The
   native runtime (``mmlspark_tpu_torch/native``, built with g++) must have
   run the loader, the parser and the interleave (``native.calls``), with
   ``MMLSPARK_TPU_NO_NATIVE`` unset.

17. serving — the serving path (``SERVE_*``). (a) ``SLICE_CFG`` behind
   ``serve_continuous`` (``FusedServingStep``, ``BucketPolicy(max_batch=16,
   min_bucket=1)``, scores): all 5 buckets captured as CUDA graphs before
   the source opens; 256 requests of 4096 random token ids (base64 int32)
   sent by ``HTTPTransformer(concurrency=8)``; every reply within 2e-2
   (relative L2) of an eager forward of its row, its argmax equal wherever
   the eager top-two gap exceeds 5e-2; row 1 launched exactly layers x the
   dispatches (counted across replays); no cache miss; each bucket's replay
   equal to an eager forward of the same padded batch bit for bit, both
   timed; requests/s, and p50/p99 latency of closed loops of 1, 4 and 8
   clients. (b) ``save_bundle``, then ``python -m
   mmlspark_tpu_torch.io.http.worker --bundle DIR`` in a subprocess: every
   bucket warm with no nvcc run, 32 of (a)'s payloads answered with (a)'s
   replies bit for bit, no miss; the seconds from spawn to first reply.
   (c) the 13 x 4096 ``TorchModel.transform`` after ``warmup`` (one graph
   per bucket), equal to the eager model's bit for bit, its ms with graphs
   and without. (d) ``serve_pipeline`` over ingest's level-wise booster
   (262,144 rows, 20 iterations): 64 JSON requests of 28 floats, replies
   equal to ``transform``'s bit for bit, row 5 launched once per polling
   batch.
18. fusion — whole-pipeline capture (``core/capture.py``, ``FUSION_*``).
   (a) the gbdt slice's 1M x 28 draws as 28 raw float32 columns (NaN in
   every 7th row of three) through CleanMissingData -> FastVectorAssembler
   -> ``LightGBMClassifier()`` (depthwise 5, 100 trees), fitted staged and
   with ``fusePipeline``: booster states equal key for key, bit for bit,
   500 node-histogram launches in each fit, one fused dispatch per binning
   slab, no fallback; both fits' seconds and the fit-phase upload bytes.
   (b) the same leaf-wise (31 leaves): equal states, 3100 launches each.
   (c) (a)'s fused PipelineModel over the 1M rows: one segment, one
   dispatch, the level-wise predict kernel launched 0 times (the dense
   walk replaces it), a second transform a replay; columns within 1e-6 of
   the staged dense transform's, and against the staged quantized predict
   as the gbdt phase holds it; (b)'s leaf-wise booster between two
   segments: the leaf-wise predict once, outputs equal to the staged
   transform's. (d) bench.py's ResNet-20 (batch 12288) over 4 batches of
   raw uint8 CHW pixels: FastVectorAssembler(("pixels",)) ->
   ``TorchLearner(inputShape=(3, 32, 32))`` staged and fused, scan and feed
   paths, cuDNN deterministic: parameters equal bit for bit, the fused
   feature upload a quarter of the staged one on both counters, one
   capture per fused program, each path's step ms. (e) ``fitStreamCaptured``
   over the raw batches equal to ``fitStream`` over the staged ones. (f)
   (a)'s booster behind an assembler over one 28-wide wire column as
   ``FusedServingStep.from_pipeline`` (buckets 1..16) behind
   ``serve_continuous``: 256 requests at concurrency 8, replies equal to the
   pipeline's transform, no kernel of the table launched, every bucket's
   replay equal to eager bit for bit; requests/s, p50/p99 of a closed loop
   of 8 clients; ``save_bundle`` -> a restarted worker warm with 0 captures
   and 0 nvcc runs.
19. parallel — ``parallel/`` and the MoE transformer (``MOE_CFG``:
   SLICE_CFG with 4 experts, top-2, capacity 1.25, ``PAR_*``). (a)
   ``TorchModel.transform`` of ROWS x SEQ at MINI_BATCH after ``warmup``:
   row 1 launched layers x chunks times, the scores within TOL_SLICE of the
   plain version on the card (blockwise attention, the one-hot dispatch of
   ``moe.moe_one_hot``), the replay equal to the eager model bit for bit;
   rows/s, tokens/s, peak memory, the profile of one transform. (b) One MoE
   layer at PAR_DISPATCH_ROWS x SEQ tokens: the index dispatch's expert
   buffer equal to the one-hot einsum's bit for bit, the combine within
   TOL_DISPATCH; each form's ms and peak bytes. (c) ``TorchLearner`` on
   MOE_CFG (no remat, adam, ``moeAuxWeight``), PAR_TRAIN_BATCH x SEQ a
   step: finite losses, rows 1-3 layers times each a step, one step's
   gradients flash against blockwise attention within TOL_TRAIN_GRAD; step
   ms, tokens/s, peak memory. (d) A one-rank NCCL group over a TCPStore on
   127.0.0.1 (``parallel.distributed``): the barrier, an object gather, a
   PAR_NCCL_LAYERS-layer fit equal to the same fit with no group bit for
   bit, a transform through ``_transform_multihost`` equal to the plain
   one bit for bit, and tensor/sequence/expert/pipeline parallelism 2 each
   raising the JAX package's ValueError on one rank.
20. gbdt_parallel — the sharded GBDT builders (``fit_gbdt`` with a mesh)
   over a one-rank NCCL group on the gbdt slice's 1M x 28 rows: level-wise
   ``tree_learner="data"`` and ``"feature"`` at the stage's defaults (500
   row-4 launches each), a ``hist_impl="pallas"`` data fit of
   GBDT_PAR_PALLAS_ITERS iterations (row 7, 5 a iteration) and a leaf-wise
   data fit of 31 leaves (3100 row-4 launches); every ensemble bit for bit
   the no-group fit's (the gbdt and gbdt_leafwise phases' states) with the
   same launches; the level-wise data ensemble scored through row 5 and the
   leaf-wise one through row 6, once each, equal to the no-group scores;
   each fit's seconds, and the data and leaf-wise fits traced once more
   with telemetry on: the ``gbdt/iter/{grad,build,apply}`` span totals
   beside the traced no-group fit's ``gbdt/iter/step`` (the distributed
   path's overhead on one card). The AutoML merges need two ranks, which
   NCCL refuses on one card: they run in the CPU tests only.

Then the kernels line, the card's name and power limit as nvidia-smi prints
them, and last ``{"ok": true, "device": {...}}``. Any failure raises before
the last line; nothing falls back to the CPU. Without a CUDA device, or
outside a checkout of the repo, it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gc
import json
import math
import os
import statistics
import sys
import threading
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
# the AutoML path: an adult-census-shaped table at HIGGS scale (gbdt_data's
# 1M x 28 draws, two string categoricals, a string label), 80/20; the MLP
# and the tuning search on 100k-row samples of the 800k training rows
AUTOML_ROWS, AUTOML_SAMPLE = GBDT_ROWS, 100_000
EDUCATION = ("Bachelors", "Some-college", "11th", "HS-grad", "Prof-school",
             "Assoc-acdm", "Assoc-voc", "9th", "7th-8th", "12th", "Masters",
             "1st-4th", "10th", "Doctorate", "5th-6th", "Preschool")
WORKCLASS = ("Private", "Self-emp-not-inc", "Self-emp-inc", "Federal-gov",
             "Local-gov", "State-gov", "Without-pay", "Never-worked")
# the MLP's cut: batch 1024 and 5 epochs on the sample (the defaults, batch
# 128 for 30 epochs over 800k rows, are ~190k host-paced steps)
AUTOML_MLP = {"layers": (64,), "batchSize": 1024, "maxIter": 5}
# two folds, not three: the search's 4 threads (ROADMAP.md Queue 3, F1)
# take the longest of any step, and the script must end inside its limit
AUTOML_TUNE = {"numRuns": 3, "numFolds": 2, "parallelism": 4, "seed": 0}
TOL_AUTOML_ACCURACY = 0.85
# gaussian NB alone: given the label, x0..x2 are correlated (the label is a
# linear mix of them), which its independence assumption cannot model; it
# reads 0.82785 held out on 100k rows of this table (split seed 1) in both
# packages on the CPU (tests/test_torch_automl.py::
# test_gaussian_nb_on_the_chip_smoke_table) and 0.81926 on the card on the
# whole table
TOL_AUTOML_ACCURACY_NB = 0.8
# card against the CPU: LR coefficients (relative L2) and held-out AUC;
# gaussian NB means and variances (relative L2 of each array)
TOL_AUTOML_LR_COEF, TOL_AUTOML_LR_AUC, TOL_AUTOML_NB = 1e-3, 1e-4, 1e-5
# the tuned model's held-out AUC against its cross-validation metric
TOL_TUNE_GAP = 0.01
# the reference grid (tests/test_reference_goldens.py:108-164): the three
# default-tier datasets, train AUC >= the committed value - 0.02
GRID_DATASETS = ("PimaIndian.csv", "data_banknote_authentication.csv",
                 "transfusion.csv")
TOL_GRID = 0.02
# the text path: an Amazon-reviews-shaped corpus (notebook 201's planted
# words in documents of 20-120 Zipf(1.1) tokens over 50,000 words), 80/20
# cut: 100k documents, the lever the two phases' ~150 s budget names
# (200k added ~110 s and passed the same gates, PERF.md); they still add
# ~222 s, most of it the tuning search's 4 threads (ROADMAP.md Queue 3)
TEXT_DOCS, TEXT_VOCAB, TEXT_ZIPF, TEXT_LENGTHS = 100_000, 50_000, 1.1, (20, 120)
TEXT_POSITIVE = ("great", "wonderful", "loved", "excellent", "gripping")
TEXT_NEGATIVE = ("boring", "awful", "hated", "dull", "tedious")
TEXT_PLANTED = 3
TEXT_LR_SUBSET = 20_000
# the platform phase: the AutoML table with 1 % of x3 set to NaN; the
# pipeline's LightGBMClassifier (level-wise) and the leaf-wise fit at 20
# iterations; the training slice at 2 layers, one step a dispatch, its 4th
# step faulted once; the profiled FLOPs of a step within 10 % of the
# analytic count; a step-time budget no step reaches
PLATFORM_NAN_SHARE, PLATFORM_ITERATIONS, PLATFORM_LAYERS = 0.01, 20, 2
PLATFORM_FAULT = "trainer.step:error:1.0:3:1"
TOL_PLATFORM_FLOPS, PLATFORM_STEP_BUDGET_S = 0.10, 10.0
TOL_TEXT_ACCURACY, TOL_W2V_ACCURACY = 0.85, 0.8
# one SGNS step on the card against the CPU's (relative L2 of the loss and
# of each table), and LR on the hashed text against the CPU's (coefficients)
TOL_SGNS_STEP, TOL_TEXT_LR_COEF = 1e-5, 1e-3
# the ingest phase; each INGEST_KILL_* is the dispatches that pass before
# every later one faults. (1) TRAIN_CFG at full width through fitStream: 4
# batches of 8 x 4096 tokens and a ragged one of 5 an epoch, 3 epochs (5
# steps an epoch: killed on the 12th dispatch, epoch 3's second step);
# fit()'s feed path on the same 37 rows, 4 steps of 8 an epoch, a step
# checkpoint every 2 steps (async, 4 shards, 2 kept), killed on the 8th
# dispatch, epoch 2's last step. (2) bench.py's ResNet-20 and batch
# (bench.py:82-99) from 24,576 image files, 2 steps an epoch, 3 epochs,
# killed on epoch 3's first dispatch; the resumed fit within twice the gap of two clean fits
# (relative L2 of all parameters; twice, for the spread of that gap when
# cuDNN's backward is not deterministic). (3) bench_gbdt.py's draws
# (bench_gbdt.py:15-20) at 262,144 rows as a CSV file into
# LightGBMClassifier(numIterations=20): depthwise at that row count, 5
# node histograms a tree and one level-wise predict. (4) 28 float32
# columns of those rows through interleave_f32.
INGEST_STREAM_BATCHES, INGEST_RAGGED_ROWS, INGEST_EPOCHS = 4, 5, 3
INGEST_KILL_STREAM, INGEST_KILL_FEED = 11, 7
INGEST_IMAGES, INGEST_IMAGE_HW, INGEST_KILL_IMAGES = 24_576, 32, 4
INGEST_CSV_ROWS, INGEST_GBDT_ITERS = 262_144, 20
TOL_INGEST_IMAGE_GAP = 2.0
# the serving phase: SLICE_CFG behind serve_continuous with buckets 1..16;
# 256 requests of 4096 token ids sent 8 at a time; closed loops of 1, 4 and
# 8 clients over 64 of them; 32 of them again to the restarted worker;
# ingest's booster (262,144 rows, 20 iterations) behind serve_pipeline, 64
# JSON requests. A reply within 2e-2 (relative L2) of an eager forward of
# its row (bf16: TOL_OUT), its argmax equal where the eager top-two gap
# exceeds 5e-2
SERVE_MAX_BATCH, SERVE_REQUESTS, SERVE_CONCURRENCY = 16, 256, 8
SERVE_CLIENTS, SERVE_LATENCY_REQS, SERVE_RESTART_REQS = (1, 4, 8), 64, 32
SERVE_GBDT_ROWS, SERVE_GBDT_REQUESTS = INGEST_CSV_ROWS, 64
TOL_SERVE_L2, TOL_SERVE_GAP = 2e-2, 5e-2
# the fusion phase (core/capture.py): the GBDT slice's 1M x 28 draws as 28
# raw float32 columns f0..f27, NaN in every 7th row of FUSION_NAN_COLS,
# through CleanMissingData -> FastVectorAssembler -> LightGBMClassifier
# (default Params: depthwise 5, 100 trees; and leaf-wise 31 leaves), fitted
# staged and fused; the fused level-wise transform's columns within
# TOL_FUSED_DENSE (absolute) of the staged dense walk's and, against the
# staged quantized predict (bf16 leaves), TOL_GBDT_PREDICT as the gbdt
# phase holds it. bench.py's ResNet-20 (batch 12288) over FUSION_BATCHES
# batches of raw uint8 CHW pixels, FUSION_EPOCHS epochs, scan and feed
# paths, with cuDNN held to deterministic algorithms so fused and staged
# fits can be compared bit for bit. The pipeline composite: buckets 1..16,
# 256 requests sent 8 at a time, a closed loop of 8 clients over 64, 32
# again to the restarted worker
# the parallel phase (parallel/, models/moe.py): SLICE_CFG with 4 experts
# (top-2, capacity 1.25: the repo's MoE choice, __graft_entry__.py:96),
# served at ROWS x SEQ and trained at PAR_TRAIN_BATCH x SEQ a step
# (PAR_TRAIN_ROWS rows, PAR_TRAIN_EPOCHS epochs, adam, no remat: MoE
# refuses it); one MoE layer's dispatch at PAR_DISPATCH_ROWS x SEQ tokens,
# the index form against the one-hot einsums; the one-rank NCCL fit at
# PAR_NCCL_LAYERS layers on PAR_NCCL_ROWS rows
MOE_CFG = dict(SLICE_CFG, num_experts=4, expert_top_k=2,
               capacity_factor=1.25)
PAR_TRAIN_ROWS, PAR_TRAIN_BATCH, PAR_TRAIN_EPOCHS = 16, 8, 2
PAR_MOE_AUX = 0.01
PAR_DISPATCH_ROWS = 2
PAR_NCCL_LAYERS, PAR_NCCL_ROWS = 2, 16
# the gbdt_parallel phase's hist_impl="pallas" fit (row 7)
GBDT_PAR_PALLAS_ITERS = 10
# the elastic phase (resilience/elastic.py): (a) TRAIN_CFG at TRAIN_BATCH x
# SEQ a step through TorchLearner(elastic=True, elasticHosts=4) over
# ELASTIC_TRAIN_ROWS rows (16 steps an epoch), ELASTIC_EPOCHS epochs, an
# async step checkpoint every ELASTIC_CKPT_EVERY steps, shuffle off; host2's
# heartbeat killed once the first step checkpoint commits, each step paced by
# an ELASTIC_PACE_S trainer.step delay; heartbeats every ELASTIC_HB_S, death
# after ELASTIC_GRACE_S of silence. (b) the gbdt phase's 1M x 28 rows and
# default Params through elasticConfig over 4 hosts, host2 killed after 2
# iterations, each iteration paced by an ELASTIC_GBDT_PACE_S elastic.step
# delay. (c) a one-process NCCL world through elastic_initialize: the
# training slice at PAR_NCCL_LAYERS layers on PAR_NCCL_ROWS rows, in
# generation 1 and again in generation 2 after teardown_for_rendezvous
ELASTIC_TRAIN_ROWS, ELASTIC_EPOCHS, ELASTIC_CKPT_EVERY = 128, 2, 2
ELASTIC_HOSTS, ELASTIC_GRACE_S, ELASTIC_HB_S = 4, 0.3, 0.05
ELASTIC_PACE_S, ELASTIC_GBDT_PACE_S = 0.1, 0.03
# the index dispatch's combined output against the one-hot einsums': the
# gate rounds to bf16 in both, the sums of two products round once in f32
# here and in the einsum's accumulator there (max |delta| / max |ref|)
TOL_DISPATCH = 1e-2
FUSION_NAN_COLS = (3, 11, 19)
FUSION_BATCHES, FUSION_EPOCHS = 4, 2
FUSION_SERVE_LATENCY_REQS, FUSION_SERVE_CLIENTS = 64, 8
TOL_FUSED_DENSE = 1e-6


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

    build = functools.partial(
        engine._build_tree_multi, depth=p.max_depth, n_bins=p.max_bin,
        lambda_l2=p.lambda_l2, lambda_l1=p.lambda_l1,
        min_child_weight=p.min_child_weight, min_split_gain=p.min_split_gain,
        hist_impl="mxu")

    def step():
        engine._boost_step(
            build, bins, bins_t, raw, yj, ones_n, ones_d, p.learning_rate,
            p.alpha, objective="binary", num_class=1, update_raw=True)
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
            "predict": serving["transform_launches"], "state": s1,
            "fused_state": stages._ensemble_to_state(fused)}


def phase_gbdt_leafwise(torch, env, dev="cuda"):
    """The leaf-wise GBDT slice at full size: bench_gbdt.py's data ->
    LightGBMClassifier(device=dev).setGrowthPolicy("leafwise").fit (31
    leaves best-first, the node-histogram kernel with 2 nodes a round) ->
    transform with predictImpl auto (the leaf-wise predict kernel). ``dev``
    is for rehearsing the phase on the CPU."""
    from mmlspark_tpu_torch import DataFrame, LightGBMClassifier
    from mmlspark_tpu_torch.models.gbdt import engine, stages
    from mmlspark_tpu_torch.models.gbdt.leafwise import build_tree_leafwise_multi
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

    build = functools.partial(
        build_tree_leafwise_multi, cat_feats=no_cats,
        num_leaves=p.num_leaves, n_bins=p.max_bin, lambda_l2=p.lambda_l2,
        lambda_l1=p.lambda_l1, min_child_weight=p.min_child_weight,
        min_split_gain=p.min_split_gain, cat_smooth=p.cat_smooth,
        max_depth=0, hist_impl="mxu", has_cats=False)

    def step():
        engine._boost_step(
            build, bins, bins_t, raw, yj, ones_n, ones_d, p.learning_rate,
            p.alpha, objective="binary", num_class=1, update_raw=True,
            mode="leafwise")
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
            "predict_lw": serving["transform_launches"], "state": s1}


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


def adult_frame(n: int = None):
    """An adult-census-shaped table at HIGGS scale from numpy seed 0:
    gbdt_data()'s draws (its 28 N(0, 1) columns as x0..x27, then its label
    noise N(0, 0.5)), then education (16 levels) and workclass (8) from the
    same generator, and the string label income = ">50K" where 2 x0 + x1 -
    0.5 x2 + 0.8 * 1{education among its first 4 levels} + noise > 0, else
    "<=50K"."""
    from mmlspark_tpu_torch import DataFrame
    n = n or AUTOML_ROWS
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, GBDT_FEATURES)).astype(np.float32)
    noise = rng.normal(0, 0.5, n)
    edu = rng.integers(0, len(EDUCATION), n)
    work = rng.integers(0, len(WORKCLASS), n)
    logit = x[:, 0] * 2 + x[:, 1] - x[:, 2] * 0.5 + 0.8 * (edu < 4) + noise
    cols = {f"x{j}": x[:, j] for j in range(GBDT_FEATURES)}
    cols["education"] = np.array(EDUCATION, dtype=object)[edu]
    cols["workclass"] = np.array(WORKCLASS, dtype=object)[work]
    cols["income"] = np.where(logit > 0, ">50K", "<=50K").astype(object)
    return DataFrame(cols)


def sample_rows(df, n: int, seed: int):
    """``n`` rows of ``df`` drawn without replacement, in their order."""
    keep = np.zeros(df.count(), dtype=bool)
    keep[np.random.default_rng(seed).permutation(df.count())[:n]] = True
    return df.filter(keep)


#: the plain versions of the GBDT kernels (ops/gbdt_kernels.py)
GBDT_PLAIN = ("node_histogram_reference", "histogram_fused_reference",
              "segment_histogram", "compare_reduce_histogram",
              "quant_levelwise_reference", "quant_leafwise_reference")


@contextlib.contextmanager
def plain_versions_counted():
    """Counts, by name, the calls of the GBDT kernels' plain versions on CUDA
    tensors while the block runs (from any thread); the CPU's are not
    counted."""
    from mmlspark_tpu_torch.ops import gbdt_kernels as gk
    counts = dict.fromkeys(GBDT_PLAIN, 0)
    lock = threading.Lock()
    saved = {name: getattr(gk, name) for name in GBDT_PLAIN}

    def counted(name, fn):
        @functools.wraps(fn)
        def call(first, *args, **kwargs):
            if getattr(first, "is_cuda", False):
                with lock:
                    counts[name] += 1
            return fn(first, *args, **kwargs)
        return call
    for name, fn in saved.items():
        setattr(gk, name, counted(name, fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(gk, name, fn)


def counted_call(fn):
    """(result, the table's launches in the call): every count set to 0
    just before, read just after."""
    reset_gbdt_counts()
    reset_kernel_counts()
    out = fn()
    return out, {**gbdt_counts(), **kernel_counts()}


def launches_of(**want) -> dict:
    """The launch counts of a call that launches ``want`` and nothing else."""
    return {**dict.fromkeys(("node_hist", "fused", "predict", "predict_lw",
                             "fwd", "dq", "dkv"), 0), **want}


def check_launches(got: dict, want: dict, what: str, dev: str):
    """The exact-count gate (on the card; on the CPU nothing launches)."""
    if dev == "cuda":
        check(got == want, f"{what}: launches {got}, expected {want}")


def model_stats(scored, label: str) -> dict:
    from mmlspark_tpu_torch.automl import ComputeModelStatistics
    stats = ComputeModelStatistics(labelCol=label,
                                   evaluationMetric="classification") \
        .transform(scored)
    return {k: float(stats.col(k)[0]) for k in ("accuracy", "AUC")}


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def synchronize(torch, dev: str):
    if dev == "cuda":
        torch.cuda.synchronize()


def automl_learners(dev: str) -> dict:
    """The learners of (a), each made for ``dev``, by name."""
    from mmlspark_tpu_torch import LightGBMClassifier
    from mmlspark_tpu_torch.models import (LogisticRegression,
                                           MultilayerPerceptronClassifier,
                                           NaiveBayes, RandomForestClassifier)
    return {
        "LogisticRegression": lambda d=dev: LogisticRegression(device=d),
        "NaiveBayes_gaussian": lambda d=dev: NaiveBayes(modelType="gaussian",
                                                        device=d),
        "LightGBMClassifier": lambda d=dev: LightGBMClassifier(device=d),
        "RandomForestClassifier": lambda d=dev: RandomForestClassifier(
            device=d),
        "MultilayerPerceptronClassifier":
            lambda d=dev: MultilayerPerceptronClassifier(device=d,
                                                         **AUTOML_MLP),
    }


def automl_learner_runs(torch, train, test, mlp_train, dev) -> dict:
    """(a): each learner through TrainClassifier: fit seconds and launches,
    held-out transform rows/s (median of 3 after a warm-up) and launches,
    ComputeModelStatistics on the held-out rows."""
    from mmlspark_tpu_torch.automl import TrainClassifier
    runs = {}
    for name, make in automl_learners(dev).items():
        frame = mlp_train if name.startswith("Multilayer") else train
        synchronize(torch, dev)
        t0 = time.perf_counter()
        model, fit_launches = counted_call(
            lambda: TrainClassifier(labelCol="income", model=make()).fit(frame))
        synchronize(torch, dev)
        fit_s = time.perf_counter() - t0
        rows_s = host_rows_per_s(torch, lambda: model.transform(test),
                                 test.count(), dev)
        scored, transform_launches = counted_call(
            lambda: model.transform(test))
        stats = model_stats(scored, "income")
        if name == "LightGBMClassifier":
            check_launches(fit_launches,
                           launches_of(node_hist=GBDT_TREES * GBDT_DEPTH),
                           f"{name} fit", dev)
            check_launches(transform_launches, launches_of(predict=1),
                           f"{name} transform", dev)
        elif name != "RandomForestClassifier":
            check_launches(fit_launches, launches_of(), f"{name} fit", dev)
            check_launches(transform_launches, launches_of(),
                           f"{name} transform", dev)
        bar = (TOL_AUTOML_ACCURACY_NB if name == "NaiveBayes_gaussian"
               else TOL_AUTOML_ACCURACY)
        check(stats["accuracy"] >= bar,
              f"{name}: held-out accuracy {stats['accuracy']} < {bar}")
        runs[name] = {"model": model, "fit_rows": frame.count(),
                      "fit_s": fit_s, "transform_rows_per_s": rows_s,
                      "launches": {"fit": fit_launches,
                                   "transform": transform_launches},
                      **stats}
    return runs


def automl_cpu_checks(torch, train, test, runs) -> dict:
    """The card's LR and gaussian NB fits against the same stages on the
    CPU (the same frame): LR coefficients and held-out AUC, NB means and
    variances."""
    from mmlspark_tpu_torch.automl import TrainClassifier
    from mmlspark_tpu_torch.models import LogisticRegression, NaiveBayes

    def cpu_fit(est):
        t0 = time.perf_counter()
        model = TrainClassifier(labelCol="income", model=est).fit(train)
        return model, time.perf_counter() - t0

    lr_cpu, lr_s = cpu_fit(LogisticRegression(device="cpu"))
    lr_card = runs["LogisticRegression"]["model"].getInnerModel()
    coef_err = rel_l2(lr_card.getCoefficients(),
                      lr_cpu.getInnerModel().getCoefficients())
    auc_cpu = model_stats(lr_cpu.transform(test), "income")["AUC"]
    auc_gap = abs(runs["LogisticRegression"]["AUC"] - auc_cpu)
    check(coef_err <= TOL_AUTOML_LR_COEF,
          f"LR coefficients {coef_err} (relative L2) from the CPU's")
    check(auc_gap <= TOL_AUTOML_LR_AUC,
          f"LR held-out AUC {auc_gap} from the CPU's")
    nb_cpu, nb_s = cpu_fit(NaiveBayes(modelType="gaussian", device="cpu"))
    nb_card = runs["NaiveBayes_gaussian"]["model"].getInnerModel()
    nb_err = {k: rel_l2(getattr(nb_card, "get" + k)(),
                        getattr(nb_cpu.getInnerModel(), "get" + k)())
              for k in ("Means", "Variances")}
    check(max(nb_err.values()) <= TOL_AUTOML_NB,
          f"gaussian NB moments from the CPU's: {nb_err}")
    return {"lr_coef_rel_l2": coef_err, "lr_auc_cpu": auc_cpu,
            "lr_auc_gap": auc_gap, "nb_moments_rel_l2": nb_err,
            "cpu_fit_s": {"LogisticRegression": lr_s,
                          "NaiveBayes_gaussian": nb_s}}


def automl_trees_vs_segment(torch, train, trained, dev) -> dict:
    """The LightGBM learner's first 10 trees against a 10-iteration fit of
    the same Params on the same featurized rows through the plain
    segment-histogram path on the card, as the gbdt phase holds its fit
    (a CPU fit took 436 s for 10 iterations at this size: the CPU's
    compare-path histograms)."""
    from mmlspark_tpu_torch import LightGBMClassifier
    from mmlspark_tpu_torch.models.gbdt import engine, stages
    t0 = time.perf_counter()
    levels = trained.getLabelLevels()
    index = {v: i for i, v in enumerate(levels)}
    y = np.array([index[v] for v in train.col("income")], dtype=np.float32)
    x = stages._features_matrix(
        trained.getFeaturizeModel().transform(train), "features")
    p = LightGBMClassifier(device=dev)._engine_params("binary", 1,
                                                      n_rows=len(x))
    seg = engine.fit_gbdt(x, y, p._replace(hist_impl="segment",
                                           num_iterations=10), device=dev)
    state = trained.getInnerModel().getBoosterState()
    kern = stages._state_to_ensemble(state, "binary", dev)
    same = same_trees(kern, seg)
    check(all(same), f"the first 10 trees differ from the segment "
                     f"fit's: {same}")
    leaf = float(np.abs(np.asarray(state["leaf"])[:10]
                        - seg.leaf.cpu().numpy()).max())
    return {"trees_equal_of_10": sum(same), "leaf_max_abs_diff": leaf,
            "seconds": time.perf_counter() - t0}


def tuning_input(train, test):
    """The search's input: the label indexed and the table featurized as
    fitted on ``train``, then a 100k-row sample of ``train`` and all of
    ``test``, each as (features, income)."""
    from mmlspark_tpu_torch.automl import Featurize, ValueIndexer
    vim = ValueIndexer(inputCol="income", outputCol="income").fit(train)
    fm = Featurize(outputCol="features",
                   excludeCols=("income",)).fit(vim.transform(train))

    def featurized(frame):
        return fm.transform(vim.transform(frame)).select("features", "income")
    return (featurized(sample_rows(train, AUTOML_SAMPLE, seed=2)),
            featurized(test))


def automl_tuning(torch, train, test, dev) -> dict:
    """(b): TuneHyperparameters over LR and LightGBM on a featurized
    100k-row sample (leaf-wise folds: rows 4 and 6), on 4 threads. The
    launches over the search must be the sum of its fits' and scorings'
    (numLeaves x numIterations node histograms a leaf-wise fit, one
    leaf-wise predict a fold's scoring, the refit's)."""
    from mmlspark_tpu_torch import LightGBMClassifier
    from mmlspark_tpu_torch.automl import tune
    from mmlspark_tpu_torch.models import LogisticRegression
    sample, held = tuning_input(train, test)
    models = (LogisticRegression(device=dev), LightGBMClassifier(device=dev))
    search = tune.TuneHyperparameters(models=models, labelCol="income",
                                      evaluationMetric="AUC", **AUTOML_TUNE)
    # the settings the search draws first from its seed
    cands = tune._sample_candidates(
        models, AUTOML_TUNE["numRuns"],
        np.random.default_rng(AUTOML_TUNE["seed"]))
    synchronize(torch, dev)
    t0 = time.perf_counter()
    tuned, launches = counted_call(lambda: search.fit(sample))
    synchronize(torch, dev)
    search_s = time.perf_counter() - t0
    best = tuned.getBestSetting()
    best_est = next(e for e, s in cands if s == best)
    t0 = time.perf_counter()
    best_est.copy(dict(best, labelCol="income")).fit(sample)
    synchronize(torch, dev)
    refit_s = time.perf_counter() - t0
    per_fit = [s["numLeaves"] * s["numIterations"] for e, s in cands
               if isinstance(e, LightGBMClassifier)]
    lgbm_best = isinstance(best_est, LightGBMClassifier)
    want = launches_of(
        node_hist=AUTOML_TUNE["numFolds"] * sum(per_fit)
        + (best["numLeaves"] * best["numIterations"] if lgbm_best else 0),
        predict_lw=AUTOML_TUNE["numFolds"] * len(per_fit))
    check_launches(launches, want, "the tuning search", dev)
    scored, held_launches = counted_call(lambda: tuned.transform(held))
    check_launches(held_launches, launches_of(predict_lw=int(lgbm_best)),
                   "the tuned model's held-out transform", dev)
    held_auc = model_stats(scored, "income")["AUC"]
    gap = abs(held_auc - tuned.getBestMetric())
    check(gap <= TOL_TUNE_GAP,
          f"the tuned model's held-out AUC {held_auc} is {gap} from its "
          f"cross-validation AUC {tuned.getBestMetric()}")
    return {"rows": sample.count(), **AUTOML_TUNE,
            "candidates": [[type(e).__name__, s] for e, s in cands],
            "best_estimator": type(best_est).__name__, "best_setting": best,
            "cv_auc": tuned.getBestMetric(), "held_out_auc": held_auc,
            "search_s": search_s, "refit_s": refit_s,
            "fold_fits_s": search_s - refit_s,
            "launches": launches, "launches_expected": want,
            "held_out_launches": held_launches}


def grid_learners(dev: str) -> dict:
    """tests/test_reference_goldens.py:108-124's configs, for ``dev``, and
    whether its AUC reads probability scores or scored labels."""
    from mmlspark_tpu_torch.models import (DecisionTreeClassifier,
                                           GBTClassifier, LogisticRegression,
                                           MultilayerPerceptronClassifier,
                                           NaiveBayes, RandomForestClassifier)
    return {
        "LogisticRegression": (
            lambda: LogisticRegression(device=dev).setMaxIter(80), "scores"),
        "DecisionTreeClassification": (
            lambda: DecisionTreeClassifier(device=dev).setMaxBin(63),
            "scores"),
        "RandomForestClassification": (
            lambda: RandomForestClassifier(device=dev).setNumIterations(20)
            .setMaxBin(63), "scores"),
        "GradientBoostedTreesClassification": (
            lambda: GBTClassifier(device=dev).setNumIterations(20)
            .setMaxBin(63), "labels"),
        "NaiveBayesClassifier": (lambda: NaiveBayes(device=dev), "labels"),
        "MultilayerPerceptronClassifier": (
            lambda: MultilayerPerceptronClassifier(device=dev)
            .setMaxIter(120), "labels"),
    }


def automl_grid(dev: str) -> list:
    """(c): each TRAIN_CLASSIFIER_REFERENCE_AUC row of GRID_DATASETS on
    ``dev``: train AUC >= the committed value - TOL_GRID."""
    from mmlspark_tpu_torch.automl import TrainClassifier
    from mmlspark_tpu_torch.automl.metrics import auc_score
    from mmlspark_tpu_torch.testing.reference_datasets import (
        REFERENCE_DATASETS, TRAIN_CLASSIFIER_REFERENCE_AUC)
    learners = grid_learners(dev)
    rows = []
    for (dataset, algo), want in sorted(
            TRAIN_CLASSIFIER_REFERENCE_AUC.items()):
        if dataset not in GRID_DATASETS:
            continue
        gen, label = REFERENCE_DATASETS[dataset]
        df = gen()
        vals = np.asarray(df.col(label))
        uniq = sorted(set(vals.tolist()))
        y = (vals == uniq[1]).astype(np.int64)
        make, mode = learners[algo]
        t0 = time.perf_counter()
        out = TrainClassifier(labelCol=label, model=make()).fit(df) \
            .transform(df)
        seconds = time.perf_counter() - t0
        score = (np.stack(out.col("probability"))[:, 1] if mode == "scores"
                 else (np.asarray(out.col("scored_labels"))
                       == uniq[1]).astype(float))
        auc = auc_score(y, score)
        rows.append({"dataset": dataset, "algorithm": algo, "auc_from": mode,
                     "train_auc": auc, "reference": want, "seconds": seconds})
        check(auc >= want - TOL_GRID,
              f"{dataset} {algo}: train AUC {auc} < {want} - {TOL_GRID}")
    return rows


def phase_automl_tabular(torch, env, dev="cuda"):
    """The AutoML path on an adult-census-shaped table at HIGGS scale: (a)
    five learners through TrainClassifier -> transform ->
    ComputeModelStatistics -> FindBestModel, held against the CPU; (b)
    TuneHyperparameters on 4 threads; (c) the reference's grid. Returns the
    table kernels' launches by path."""
    from mmlspark_tpu_torch.automl import FindBestModel
    t_phase = time.perf_counter()
    df = adult_frame()
    train, test = df.randomSplit([0.8, 0.2], seed=1)
    mlp_train = sample_rows(train, AUTOML_SAMPLE, seed=3)
    with plain_versions_counted() as plain:
        runs = automl_learner_runs(torch, train, test, mlp_train, dev)
        cpu = automl_cpu_checks(torch, train, test, runs)
        aucs = {name: r["AUC"] for name, r in runs.items()}
        best = FindBestModel(models=[r["model"] for r in runs.values()],
                             labelCol="income",
                             evaluationMetric="AUC").fit(test)
        picked = next(n for n, r in runs.items()
                      if r["model"] is best.getBestModel())
        check(picked == max(aucs, key=aucs.get),
              f"FindBestModel picked {picked}; the highest AUC is "
              f"{max(aucs, key=aucs.get)} ({aucs})")
        tuning = automl_tuning(torch, train, test, dev)
        grid, grid_launches = counted_call(lambda: automl_grid(dev))
    check(not any(plain.values()),
          f"plain versions of the table's kernels ran on the card: {plain}")
    # the plain path on the card, after the main path's count was read
    cpu["lightgbm_vs_segment"] = automl_trees_vs_segment(
        torch, train, runs["LightGBMClassifier"]["model"], dev)
    emit({"phase": "automl_tabular", "rows": df.count(),
          "train_rows": train.count(), "test_rows": test.count(),
          "features": int(len(runs["LogisticRegression"]["model"]
                              .getFeaturizeModel().transform(test.limit(1))
                              .col("features")[0])),
          "learners": {n: {k: v for k, v in r.items() if k != "model"}
                       for n, r in runs.items()},
          "vs_cpu": cpu, "find_best_model": {"picked": picked,
                                             "auc": best.getBestModelMetrics()},
          "tuning": tuning, "reference_grid": grid,
          "reference_grid_launches": grid_launches,
          "plain_versions_on_card": plain,
          "gpu": env.gpu_name_and_power_limit(),
          "seconds": time.perf_counter() - t_phase})
    fit_hist = sum(runs[n]["launches"]["fit"]["node_hist"]
                   for n in ("LightGBMClassifier", "RandomForestClassifier"))
    return {"node_hist_fit": fit_hist,
            "node_hist_tune": tuning["launches"]["node_hist"],
            "predict": sum(runs[n]["launches"]["transform"]["predict"]
                           for n in runs),
            "predict_lw": tuning["launches"]["predict_lw"]
            + tuning["held_out_launches"]["predict_lw"]}


def review_corpus(n: int = None):
    """An Amazon-reviews-shaped corpus from numpy seed 0: n documents of
    TEXT_LENGTHS tokens drawn from TEXT_VOCAB words ("w0", "w1", ...) with
    Zipf(TEXT_ZIPF) frequencies, a label per document (fair coin), and
    TEXT_PLANTED of the label's notebook-201 words (TEXT_POSITIVE or
    TEXT_NEGATIVE) written over random positions. Returns (texts, labels)."""
    n = n or TEXT_DOCS
    rng = np.random.default_rng(0)
    p = np.arange(1, TEXT_VOCAB + 1, dtype=np.float64) ** -TEXT_ZIPF
    p /= p.sum()
    lengths = rng.integers(TEXT_LENGTHS[0], TEXT_LENGTHS[1] + 1, n)
    labels = (rng.random(n) < 0.5).astype(np.int64)
    ids = rng.choice(TEXT_VOCAB, size=int(lengths.sum()), p=p)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    slots = rng.integers(0, lengths[:, None], (n, TEXT_PLANTED))
    which = rng.integers(0, len(TEXT_POSITIVE), (n, TEXT_PLANTED))
    ids[starts[:, None] + slots] = (TEXT_VOCAB + labels[:, None]
                                    * len(TEXT_NEGATIVE) + which)
    words = np.array([f"w{i}" for i in range(TEXT_VOCAB)]
                     + list(TEXT_NEGATIVE) + list(TEXT_POSITIVE),
                     dtype=object)[ids]
    texts = np.array([" ".join(words[s:s + k])
                      for s, k in zip(starts.tolist(), lengths.tolist())],
                     dtype=object)
    return texts, labels


def accuracy_of(model, frame) -> float:
    pred = np.asarray(model.transform(frame).col("prediction"))
    return float((pred == np.asarray(frame.col("label"))).mean())


def sgns_step_checks(torch, w2v, dev) -> dict:
    """One SGNS step at the fit's shapes (the fitted vectors, random output
    table and mid-run Adam state, random pairs and negatives): the card's
    against the CPU's, a repeat on the card to the same bits, its time
    (CUDA events) and its profile."""
    from mmlspark_tpu_torch.ops.word2vec import _sgns_step
    vecs = np.asarray(w2v.getWordVectors())
    v, d = vecs.shape
    b, k = w2v.getBatchSize(), w2v.getNegativeSamples()
    rng = np.random.default_rng(3)
    host = {"e_in": vecs,
            "e_out": (rng.normal(size=(v, d)) * 0.1).astype(np.float32),
            "mu_in": (rng.normal(size=(v, d)) * 1e-3).astype(np.float32),
            "mu_out": (rng.normal(size=(v, d)) * 1e-3).astype(np.float32),
            "nu_in": (rng.random((v, d)) * 1e-5).astype(np.float32),
            "nu_out": (rng.random((v, d)) * 1e-5).astype(np.float32),
            "c": rng.integers(0, v, b), "t": rng.integers(0, v, b),
            "negs": rng.integers(0, v, (b, k))}

    def step_on(device):
        t = {n: torch.from_numpy(a).to(device) for n, a in host.items()}
        state = {"count": torch.tensor(3, dtype=torch.int32, device=device),
                 "mu": {"in": t["mu_in"], "out": t["mu_out"]},
                 "nu": {"in": t["nu_in"], "out": t["nu_out"]}}
        return lambda: _sgns_step(t["e_in"], t["e_out"], state, t["c"],
                                  t["t"], t["negs"], 0.025)

    card, cpu = step_on(dev), step_on("cpu")
    got, want = card(), cpu()
    errs = {n: rel_l2(g.cpu().numpy(), w.numpy())
            for n, g, w in (("loss", got[3], want[3]),
                            ("emb_in", got[0], want[0]),
                            ("emb_out", got[1], want[1]))}
    again = card()
    repeat = all(torch.equal(a, b) for a, b in zip(got[:2] + got[3:],
                                                    again[:2] + again[3:]))
    check(max(errs.values()) <= TOL_SGNS_STEP,
          f"one SGNS step on the card vs the CPU (relative L2): {errs}")
    check(repeat, "two SGNS steps on the same inputs gave other bits")
    out = {"shape": {"vocab": v, "dim": d, "batch": b, "negatives": k},
           "rel_l2_vs_cpu": errs, "repeat_same_bits": repeat}
    if dev == "cuda":
        out["step_ms"] = cuda_ms(torch, card, iters=20, rounds=3)
        out["profile_of_one_step"] = device_breakdown(torch, card)
    return out


def phase_automl_text(torch, env, dev="cuda"):
    """The text path on an Amazon-reviews-shaped corpus: (a) TextFeaturizer
    -> multinomial NB (sparse, on the host); (b) TrainClassifier(LR) on the
    raw text column (Featurize hashes it to 4096 dense columns on the card);
    (c) Word2Vec -> document vectors -> LR, findSynonyms, one SGNS step
    against the CPU. No kernel of the table launches."""
    from mmlspark_tpu_torch import DataFrame
    from mmlspark_tpu_torch.automl import TrainClassifier
    from mmlspark_tpu_torch.models import LogisticRegression, NaiveBayes
    from mmlspark_tpu_torch.ops import TextFeaturizer, Word2Vec
    t_phase = time.perf_counter()
    reset_gbdt_counts()
    reset_kernel_counts()
    texts, labels = review_corpus()
    df = DataFrame({"text": texts, "label": labels})
    train, test = df.randomSplit([0.8, 0.2], seed=1)
    corpus_s = time.perf_counter() - t_phase

    # (a) TextFeaturizer's defaults (2^18 dims, IDF) with stop words removed
    t0 = time.perf_counter()
    tfm = TextFeaturizer(inputCol="text", outputCol="features",
                         useStopWordsRemover=True).fit(train)
    tf_fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ftrain = tfm.transform(train)
    featurize_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nb = NaiveBayes(device=dev).fit(ftrain)
    nb_fit_s = time.perf_counter() - t0
    acc_a = accuracy_of(nb, tfm.transform(test))
    check(acc_a >= TOL_TEXT_ACCURACY,
          f"TextFeaturizer + NaiveBayes accuracy {acc_a}")

    # (b) LR through TrainClassifier on the raw text
    synchronize(torch, dev)
    t0 = time.perf_counter()
    tc = TrainClassifier(labelCol="label",
                         model=LogisticRegression(device=dev)).fit(train)
    synchronize(torch, dev)
    tc_fit_s = time.perf_counter() - t0
    scored = tc.transform(test)
    acc_b = float((np.asarray(scored.col("scored_labels"))
                   == np.asarray(test.col("label"))).mean())
    check(acc_b >= TOL_TEXT_ACCURACY,
          f"TrainClassifier(LogisticRegression) accuracy {acc_b}")
    sub = tc.getFeaturizeModel().transform(train.limit(TEXT_LR_SUBSET))
    lr_card = LogisticRegression(device=dev).fit(sub)
    lr_cpu = LogisticRegression(device="cpu").fit(sub)
    lr_err = rel_l2(lr_card.getCoefficients(), lr_cpu.getCoefficients())
    check(lr_err <= TOL_TEXT_LR_COEF,
          f"LR on the hashed text: coefficients {lr_err} (relative L2) "
          f"from the CPU's")

    # (c) Word2Vec at its defaults
    synchronize(torch, dev)
    t0 = time.perf_counter()
    w2v = Word2Vec(inputCol="text", outputCol="features",
                   device=dev).fit(train)
    w2v_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vtrain = w2v.transform(train)
    vectors_s = time.perf_counter() - t0
    acc_c = accuracy_of(LogisticRegression(device=dev).fit(vtrain),
                        w2v.transform(test))
    check(acc_c >= TOL_W2V_ACCURACY,
          f"Word2Vec document vectors + LR accuracy {acc_c}")
    syn = list(w2v.findSynonyms(TEXT_POSITIVE[0], 5).col("word"))
    n_pos = sum(w in TEXT_POSITIVE for w in syn)
    check(n_pos >= 3, f"findSynonyms({TEXT_POSITIVE[0]!r}, 5) = {syn}")
    step = sgns_step_checks(torch, w2v, dev)
    launches = {**gbdt_counts(), **kernel_counts()}
    check(not any(launches.values()),
          f"the text path launched kernels of the table: {launches}")
    stats = w2v_pairs_and_steps(w2v, train)
    check(stats["vocabulary"] == len(w2v.getVocabulary()),
          f"Word2Vec's vocabulary {len(w2v.getVocabulary())} words, the "
          f"host code's {stats['vocabulary']}")
    emit({"phase": "automl_text", "docs": df.count(),
          "train_docs": train.count(), "corpus_s": corpus_s,
          "text_featurizer": {"num_features": tfm.getNumFeatures(),
                              "fit_s": tf_fit_s,
                              "featurize_rows_per_s": train.count()
                              / featurize_s,
                              "naive_bayes_fit_s": nb_fit_s,
                              "accuracy": acc_a},
          "train_classifier_lr": {"fit_s": tc_fit_s, "accuracy": acc_b,
                                  "features": int(len(sub.col("features")[0])),
                                  "coef_rel_l2_vs_cpu_subset": lr_err,
                                  "subset_rows": sub.count()},
          "word2vec": {"vocabulary": len(w2v.getVocabulary()),
                       "pairs_per_epoch": stats["pairs_per_epoch"],
                       "steps": stats["steps"], "fit_s": w2v_s,
                       "fit_steps_per_s": stats["steps"] / w2v_s,
                       "transform_rows_per_s": train.count() / vectors_s,
                       "lr_accuracy": acc_c,
                       "synonyms": {TEXT_POSITIVE[0]: syn,
                                    "planted_positive": n_pos},
                       "step": step},
          "launches": launches, "gpu": env.gpu_name_and_power_limit(),
          "seconds": time.perf_counter() - t_phase})


def w2v_pairs_and_steps(model, df) -> dict:
    """The vocabulary, skip-gram pairs per epoch and SGNS steps of
    ``Word2Vec.fit`` on ``df`` with ``model``'s Params: its host code run
    again, with the seeded generator drawn as the fit draws it (the
    embedding init, then per epoch the pairs' windows and their order)."""
    from mmlspark_tpu_torch.ops import word2vec as w
    docs = w._tokenized(df.col(model.getInputCol()))
    vocab, _ = w._build_vocab(docs, model.getMinCount())
    rng = np.random.default_rng(model.getSeed())
    rng.random((len(vocab), model.getVectorSize()), dtype=np.float32)
    ids, docm = w._corpus_ids(docs, {t: i for i, t in enumerate(vocab)})
    pairs = []
    for _ in range(model.getMaxIter()):
        n = len(w._skipgram_pairs(ids, docm, model.getWindowSize(), rng)[0])
        if n == 0:
            break
        pairs.append(n)
        rng.permutation(n)
    bs = model.getBatchSize()
    return {"vocabulary": len(vocab), "pairs_per_epoch": pairs,
            "steps": sum(-(-n // bs) for n in pairs)}


# ---------------------------------------------------------------- platform

def platform_frame():
    """adult_frame() with PLATFORM_NAN_SHARE of x3's rows set to NaN, the
    rows drawn from numpy seed SEED + 11."""
    df = adult_frame()
    x3 = df.col("x3").copy()
    rng = np.random.default_rng(SEED + 11)
    x3[rng.choice(len(x3), int(len(x3) * PLATFORM_NAN_SHARE),
                  replace=False)] = np.nan
    return df.withColumn("x3", x3)


def platform_pipeline(trace_dir: str, dev: str):
    """CleanMissingData(Median) -> DataConversion -> SelectColumns ->
    ClassBalancer -> Profiler(Timer(TrainClassifier(LightGBMClassifier,
    PLATFORM_ITERATIONS iterations, level-wise))). TrainClassifier takes
    no weight column, so ClassBalancer weighs workclass (drawn apart from
    the label) and its column rides along as a feature: a weight of the
    label would leak it."""
    from mmlspark_tpu_torch import LightGBMClassifier, Pipeline
    from mmlspark_tpu_torch.automl import TrainClassifier
    from mmlspark_tpu_torch.stages import (ClassBalancer, CleanMissingData,
                                           DataConversion, Profiler,
                                           SelectColumns, Timer)
    train = TrainClassifier(labelCol="income", model=LightGBMClassifier(
        device=dev, numIterations=PLATFORM_ITERATIONS,
        growthPolicy="depthwise"))
    keep = tuple(f"x{j}" for j in range(GBDT_FEATURES - 1)) + (
        "education", "workclass", "income")
    return Pipeline(stages=(
        CleanMissingData(inputCols=("x3",), cleaningMode="Median"),
        DataConversion(cols=("x4",), convertTo="double"),
        SelectColumns(cols=keep),
        ClassBalancer(inputCol="workclass", outputCol="workclass_weight"),
        Profiler(traceDir=trace_dir, stage=Timer(
            logToProfiler=True, logToConsole=False, stage=train))))


def same_frames(a, b) -> bool:
    """The same columns, dtypes and values, bit for bit (vector cells
    element by element, NaN where NaN)."""
    if a.columns != b.columns or a.count() != b.count():
        return False
    for c in a.columns:
        x, y = a.col(c), b.col(c)
        if x.dtype != y.dtype:
            return False
        if x.dtype != object:
            if not np.array_equal(x, y, equal_nan=x.dtype.kind == "f"):
                return False
        elif not all(np.array_equal(np.asarray(u), np.asarray(v))
                     for u, v in zip(x, y)):
            return False
    return True


def nested_spans(events, outer: str, prefix: str) -> dict:
    """The spans named ``prefix``* by name, and whether each lies in time
    inside one ``outer`` span."""
    outs = [e for e in events if e["name"] == outer]
    inner = [e for e in events if e["name"].startswith(prefix)
             and e["name"] != outer]
    inside = all(any(o["ts"] <= e["ts"]
                     and e["ts"] + e["dur"] <= o["ts"] + o["dur"]
                     for o in outs) for e in inner)
    return {"outer": len(outs), "names": dict(collections.Counter(
        e["name"] for e in inner)), "nested": bool(outs) and inside}


def trace_summary(path: str, dev: str) -> dict:
    """From a torch.profiler Chrome trace: whether it holds the Timer's
    range, its CUDA kernel events, and those of the node histogram."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return {"events": len(events),
            "timer_ranges": sum(e.get("name") == "Timer/TrainClassifier"
                                for e in events),
            "kernel_events": len(kernels),
            "hist_accumulate_events": sum("hist_accumulate" in
                                          e.get("name", "")
                                          for e in kernels)}


def platform_gbdt(torch, df, dev: str) -> dict:
    """D.1: the pipeline fitted once, its model's transform with telemetry
    off, then on (the leaf-wise part ran first and warmed the host paths
    and the kernels; a one-op profile warms the profiler's own start-up);
    the on run's metrics, spans, launches and trace; its predictions
    against the off run's, bit for bit. The transform runs the
    TrainClassifier's fit and transform inside the Profiler and the Timer
    (the Timer's seconds beside it)."""
    import os
    import shutil
    from torch.profiler import ProfilerActivity, profile
    from mmlspark_tpu_torch import telemetry
    from mmlspark_tpu_torch.stages import SummarizeData
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev == "cuda" else [])):
        torch.ones(1, device=dev).add_(1)
    model = platform_pipeline("", dev).fit(df)
    profiler_stage = model.getStages()[-1]
    runs = {}
    for mode in ("off", "on"):
        trace_dir = f"chiprun_out/platform_trace_{mode}"
        shutil.rmtree(trace_dir, ignore_errors=True)
        profiler_stage.setTraceDir(trace_dir)
        telemetry.registry.reset()
        telemetry.trace.clear()
        if mode == "on":
            telemetry.enable()
        synchronize(torch, dev)
        t0 = time.perf_counter()
        scored, launches = counted_call(lambda: model.transform(df))
        synchronize(torch, dev)
        seconds = time.perf_counter() - t0
        telemetry.disable()
        (trace,) = os.listdir(trace_dir)
        path = os.path.join(trace_dir, trace)
        runs[mode] = {"scored": scored, "seconds": seconds,
                      "timer_s": profiler_stage.getStage()._last_seconds,
                      "launches": launches, "trace": trace_summary(path, dev),
                      "trace_bytes": os.path.getsize(path),
                      "snapshot": telemetry.snapshot(),
                      "events": telemetry.trace.events()}
        if mode == "off":
            shutil.rmtree(trace_dir, ignore_errors=True)
    on, off = runs["on"], runs["off"]
    snap = on["snapshot"]
    one = lambda name, key: snap[name]["series"][0][key]  # noqa: E731
    metrics = {"iterations": one("mmlspark_gbdt_iterations", "value"),
               "iter_seconds_count": one("mmlspark_gbdt_iter_seconds",
                                         "count"),
               "bin_seconds_count": one("mmlspark_gbdt_bin_seconds",
                                        "count"),
               "predict_table_bytes": one(
                   "mmlspark_gbdt_predict_table_bytes", "value")}
    spans = nested_spans(on["events"], "gbdt/fit", "gbdt/")
    check(metrics["iterations"] == PLATFORM_ITERATIONS
          and metrics["iter_seconds_count"] == PLATFORM_ITERATIONS
          and metrics["bin_seconds_count"] == 1,
          f"GBDT metrics with telemetry on: {metrics}")
    check(metrics["predict_table_bytes"] > 0,
          "mmlspark_gbdt_predict_table_bytes is 0 after the transform")
    check(spans["outer"] == 1 and spans["nested"]
          and spans["names"].get("gbdt/bin") == 1
          and spans["names"].get("gbdt/iter/step") == PLATFORM_ITERATIONS,
          f"GBDT spans: {spans}")
    want = launches_of(node_hist=PLATFORM_ITERATIONS * GBDT_DEPTH,
                       predict=1)
    for mode in runs:
        check_launches(runs[mode]["launches"], want,
                       f"the pipeline's {mode} run", dev)
    check(off["events"] == [] and not any(
        s.get("value", s.get("count")) for fam in off["snapshot"].values()
        for s in fam["series"]), "telemetry off recorded something")
    check(on["trace"]["timer_ranges"] >= 1,
          f"the Chrome trace lacks Timer/TrainClassifier: {on['trace']}")
    if dev == "cuda":
        check(on["trace"]["kernel_events"] > 0,
              f"the Chrome trace holds no CUDA kernel: {on['trace']}")
    same = same_frames(on["scored"], off["scored"])
    check(same, "the pipeline's predictions differ with telemetry on")
    scored = on["scored"]
    scalar = [c for c in scored.columns if scored.col(c).dtype != object
              or isinstance(scored.col(c)[0], str)]
    summary = SummarizeData().transform(scored.select(*scalar))
    rows = {r["Feature"]: r for r in summary.collect()}
    check(rows["x3"]["Missing Value Count"] == 0
          and rows["x3"]["Count"] == df.count(),
          f"SummarizeData of the scored x3: {rows['x3']}")
    accuracy = float(np.mean(scored.col("scored_labels")
                             == scored.col("income")))
    check(accuracy >= TOL_AUTOML_ACCURACY,
          f"the pipeline's training accuracy {accuracy}")
    return {"metrics": metrics, "spans": spans,
            "launches": {m: runs[m]["launches"] for m in runs},
            "trace": on["trace"], "trace_bytes": on["trace_bytes"],
            "bit_identical_predictions": same,
            "pipeline_transform_s": {m: runs[m]["seconds"] for m in runs},
            "timer_s": {m: runs[m]["timer_s"] for m in runs},
            "accuracy": accuracy, "summary_columns": len(rows),
            "x3_median_fill": float(rows["x3"]["Median"])}


def platform_leafwise(torch, df, dev: str) -> dict:
    """D.2: a leaf-wise fit, then two transforms under the profiler: one
    gbdt.predict_quant call and one row-6 launch each, FLOPs and bytes
    counted."""
    from mmlspark_tpu_torch import LightGBMClassifier, Pipeline, telemetry
    from mmlspark_tpu_torch.automl import TrainClassifier
    prep = platform_pipeline("", dev).getStages()[:-1]
    frame = Pipeline(stages=prep).fit(df).transform(df)
    model = TrainClassifier(labelCol="income", model=LightGBMClassifier(
        device=dev, numIterations=PLATFORM_ITERATIONS,
        numLeaves=GBDT_LEAVES, growthPolicy="leafwise")).fit(frame)
    telemetry.registry.reset()
    telemetry.profiler.reset()
    telemetry.profiler.enable()
    reports = []
    try:
        for _ in range(2):
            _, launches = counted_call(lambda: model.transform(frame))
            rep = telemetry.profiler.report()["functions"].get(
                "gbdt.predict_quant", {})
            reports.append({"launches": launches, **rep})
    finally:
        telemetry.profiler.disable()
        telemetry.disable()
    compiles = sum(s["value"] for s in telemetry.snapshot()[
        "mmlspark_profiler_compiles"]["series"]
        if s["labels"]["fn"] == "gbdt.predict_quant")
    for r in reports:
        check_launches(r["launches"], launches_of(predict_lw=1),
                       "a profiled leaf-wise transform", dev)
        if dev == "cuda":
            check(r.get("calls") == 1 and r["flops_per_call"] > 0
                  and r["bytes_per_call"] > 0,
                  f"gbdt.predict_quant's profile of a transform: {r}")
    return {"transforms": reports, "predict_quant_signatures": compiles}


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """The analytic FLOPs of one training step of the transformer: 6 x the
    dense parameters x the tokens (each block's qkv, proj, fc1 and fc2,
    and the head on the pooled rows); remat's second forward of each
    block, which stops before fc2 (torch's non-reentrant checkpoint
    recomputes until every tensor the backward saved is back, and nothing
    saved needs fc2's output); the attention forward, twice under remat,
    and the dq and dk/dv backward, from attention_bound_ms and
    attention_bwd_bounds."""
    d, L, C = cfg["d_model"], cfg["layers"], cfg["num_classes"]
    H = cfg["heads"]
    hidden = cfg["mlp_ratio"] * d
    tokens = batch * seq
    block = 2.0 * tokens * (3 * d * d + d * d + 2 * d * hidden)
    fc2 = 2.0 * tokens * hidden * d
    remat = bool(cfg.get("remat"))
    fwd = attention_bound_ms(batch, H, seq, seq, d // H, cfg["causal"],
                             "bfloat16")["flops"]
    bwd = attention_bwd_bounds(batch, H, seq, seq, d // H, cfg["causal"],
                               "bfloat16")
    per_layer = (3 * block + (block - fc2 if remat else 0.0)
                 + fwd * (2 if remat else 1)
                 + bwd["dq"]["flops"] + bwd["dkv"]["flops"])
    return L * per_layer + 6.0 * batch * d * C


def platform_training(torch, dev: str) -> dict:
    """D.3: the training slice at PLATFORM_LAYERS layers, one step a
    dispatch: a fit with profile=True and sloConfig; two clean fits; a fit
    whose 4th step faults once and is retried."""
    from mmlspark_tpu_torch import DataFrame, TorchLearner, telemetry
    from mmlspark_tpu_torch.resilience import faults
    cfg = dict(TRAIN_CFG, layers=PLATFORM_LAYERS)
    rng = np.random.default_rng(SEED + 2)
    tokens = rng.integers(0, cfg["vocab_size"], size=(TRAIN_ROWS, SEQ),
                          dtype=np.int32)
    labels = rng.integers(0, cfg["num_classes"], size=TRAIN_ROWS,
                          dtype=np.int32)
    df = DataFrame({"tokens": tokens, "label": labels})

    def learner(**kw):
        return TorchLearner(featuresCol="tokens", modelConfig=cfg,
                            optimizer="adam", learningRate=1e-3,
                            batchSize=TRAIN_BATCH, epochs=TRAIN_EPOCHS,
                            seed=SEED, device=dev, stepsPerDispatch=1, **kw)

    telemetry.registry.reset()
    telemetry.profiler.reset()
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    profiled = learner(profile=True, sloConfig={
        "stepTimeBudget": PLATFORM_STEP_BUDGET_S, "windows": [5.0, 30.0]})
    try:
        t0 = time.perf_counter()
        model, launches = counted_call(lambda: profiled.fit(df))
        fit_s = time.perf_counter() - t0
        peak_now = (torch.cuda.max_memory_allocated() if dev == "cuda"
                    else None)
        rep = telemetry.profiler.report()
        snap = telemetry.snapshot()
    finally:
        telemetry.profiler.disable()
    fn = rep["functions"]["trainer.scan_epoch"]
    steps = model._fit_stats["steps_per_epoch"] * TRAIN_EPOCHS
    step_count = snap["mmlspark_trainer_step_seconds"]["series"][0]["count"]
    analytic = train_step_flops(cfg, TRAIN_BATCH, SEQ)
    flops_err = abs(fn["flops_per_call"] - analytic) / analytic
    slo = profiled._last_slo_report
    L = cfg["layers"]
    check_launches(launches, launches_of(fwd=L * steps * 2, dq=L * steps,
                                         dkv=L * steps),
                   "the profiled fit", dev)
    check(step_count == steps and fn["calls"] == steps
          and fn["compiles"] == 1,
          f"{step_count} step-time observations and {fn['calls']} profiled "
          f"calls ({fn['compiles']} signatures) for {steps} steps")
    check("fit-step-time" in slo["objectives"],
          f"the fit's SLO report: {slo}")
    if dev == "cuda":
        check(flops_err <= TOL_PLATFORM_FLOPS,
              f"profiled FLOPs of a step {fn['flops_per_call']:.6g} vs "
              f"analytic {analytic:.6g} ({flops_err:.3%})")
        check(rep["live_buffer_peak_bytes"] == peak_now,
              f"the memory peak gauge {rep['live_buffer_peak_bytes']} vs "
              f"max_memory_allocated {peak_now}")

    def fit_once(spec=None):
        telemetry.registry.reset()
        if spec:
            faults.configure(spec, seed=0)
        try:
            m = learner().fit(df)
            plan = faults.snapshot()
        finally:
            faults.clear()
        retries = sum(s["value"] for s in telemetry.snapshot()[
            "mmlspark_retry_attempts_total"]["series"]
            if s["labels"]["policy"] == "trainer.step")
        return m, plan, retries

    telemetry.enable()
    try:
        clean_a, _, _ = fit_once()
        clean_b, _, _ = fit_once()
        faulted, plan, retries = fit_once(PLATFORM_FAULT)
    finally:
        telemetry.disable()

    def gaps(a, b):
        pa, pb = a.getModelParams(), b.getModelParams()
        return {"loss": abs(a._final_loss - b._final_loss),
                "params": max(float((pa[k] - pb[k]).abs().max())
                              for k in pa)}
    clean = gaps(clean_a, clean_b)
    retry = {k: min(gaps(faulted, clean_a)[k], gaps(faulted, clean_b)[k])
             for k in clean}
    check(plan["trainer.step"][0]["injected"] == 1 and retries == 1,
          f"the fault plan {plan} and {retries} retries")
    check(all(retry[k] <= 2 * clean[k] for k in clean),
          f"the retried fit is {retry} from the clean fits, which are "
          f"{clean} apart")
    return {"layers": L, "steps": steps, "launches": launches,
            "fit_s": fit_s, "flops_per_step": fn["flops_per_call"],
            "analytic_flops_per_step": analytic, "flops_rel_err": flops_err,
            "bytes_per_step": fn["bytes_per_call"],
            "achieved_tflops": fn["achieved_flops_per_sec"] / 1e12,
            "roofline_share": fn["roofline_utilization"],
            "peak_flops": fn["peak_flops"],
            "last_step_s": fn["last_call_seconds"],
            "count_s": fn["compile_seconds"],
            "step_seconds_count": step_count,
            "memory_peak_gauge": rep["live_buffer_peak_bytes"],
            "max_memory_allocated": peak_now,
            "slo": {k: {kk: vv for kk, vv in v.items()
                        if isinstance(vv, (int, float, str, bool))}
                    for k, v in slo["objectives"].items()},
            "slo_breached": slo["breached"],
            "fault": PLATFORM_FAULT, "retries": retries,
            "clean_gap": clean, "retry_gap": retry,
            "final_loss": {"clean_a": clean_a._final_loss,
                           "clean_b": clean_b._final_loss,
                           "retried": faulted._final_loss}}


def phase_platform(torch, env, dev="cuda"):
    """The stages, telemetry, profiler and fault base on the GBDT and
    training paths: the profiled leaf-wise transforms, the pipeline with
    telemetry off and on, the profiled and faulted training fits; returns
    the phase's launches."""
    from mmlspark_tpu_torch import telemetry
    t_phase = time.perf_counter()
    df = platform_frame()
    parts = {"frame": time.perf_counter() - t_phase}
    try:
        t0 = time.perf_counter()
        leafwise = platform_leafwise(torch, df, dev)
        parts["leafwise"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        gbdt = platform_gbdt(torch, df, dev)
        parts["pipeline"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        training = platform_training(torch, dev)
        parts["training"] = time.perf_counter() - t0
    finally:
        telemetry.disable()
        telemetry.profiler.disable()
    emit({"phase": "platform", "rows": df.count(),
          "nan_share_x3": PLATFORM_NAN_SHARE, "gbdt_pipeline": gbdt,
          "leafwise_profiled": leafwise, "training": training,
          "gpu": env.gpu_name_and_power_limit(), "parts_s": parts,
          "seconds": time.perf_counter() - t_phase})
    return {"gbdt": gbdt["launches"]["on"],
            "leafwise": [r["launches"] for r in leafwise["transforms"]],
            "training": training["launches"]}


# ------------------------------------------------------------------ ingest

def same_params(a, b) -> bool:
    """Two fitted models' parameters equal bit for bit."""
    import torch
    pa, pb = a.getModelParams(), b.getModelParams()
    return set(pa) == set(pb) and all(torch.equal(pa[k], pb[k]) for k in pa)


def params_rel_l2(a, b) -> float:
    """||a - b||_2 / ||b||_2 over all of two models' parameters."""
    pa, pb = a.getModelParams(), b.getModelParams()
    return rel_l2(np.concatenate([pa[k].numpy().ravel() for k in sorted(pa)]),
                  np.concatenate([pb[k].numpy().ravel() for k in sorted(pb)]))


def killed(fit, after: int):
    """Run ``fit`` with every trainer.step after the first ``after``
    faulted: the retry is spent and the fit dies there."""
    from mmlspark_tpu_torch.resilience import faults
    faults.configure(f"trainer.step:error:1.0:{after}", seed=0)
    try:
        fit()
    except ConnectionError:
        return
    finally:
        faults.clear()
    check(False, f"faults after dispatch {after} did not stop the fit")


def attention_launches(steps: int) -> dict:
    """Rows 1-3 over ``steps`` transformer steps with remat."""
    L = TRAIN_CFG["layers"]
    return launches_of(fwd=2 * L * steps, dq=L * steps, dkv=L * steps)


def metric(telemetry, name: str, key: str = "value"):
    series = telemetry.snapshot()[name]["series"]
    return series[0][key] if series else 0


def ingest_stream(torch, tmp: str, dev: str) -> dict:
    """(1) The transformer at full width: fitStream killed in epoch 3 and
    resumed from epoch 2's checkpoint; that directory's newest checkpoint
    truncated and resumed past; fit()'s feed path with async, sharded step
    checkpoints killed mid-epoch and resumed from the newest step
    checkpoint. Every resumed fit ends on the uninterrupted fit's bits."""
    from mmlspark_tpu_torch import DataFrame, TorchLearner, telemetry
    rng = np.random.default_rng(SEED + 12)
    rows = INGEST_STREAM_BATCHES * TRAIN_BATCH + INGEST_RAGGED_ROWS
    tokens = rng.integers(0, TRAIN_CFG["vocab_size"], size=(rows, SEQ),
                          dtype=np.int32)
    labels = rng.integers(0, TRAIN_CFG["num_classes"], size=rows,
                          dtype=np.int32)

    def stream():
        for lo in range(0, rows, TRAIN_BATCH):
            yield tokens[lo:lo + TRAIN_BATCH], labels[lo:lo + TRAIN_BATCH]

    def learner(**kw):
        return TorchLearner(featuresCol="tokens", modelConfig=TRAIN_CFG,
                            optimizer="adam", learningRate=1e-3,
                            batchSize=TRAIN_BATCH, epochs=INGEST_EPOCHS,
                            seed=SEED, device=dev, **kw)

    per_epoch = INGEST_STREAM_BATCHES + 1
    out = {"rows": rows, "seq": SEQ, "epochs": INGEST_EPOCHS,
           "stream_steps_per_epoch": per_epoch}
    a, la = counted_call(lambda: learner().fitStream(stream))
    check_launches(la, attention_launches(per_epoch * INGEST_EPOCHS),
                   "the uninterrupted fitStream", dev)
    check(all(np.isfinite(a._fit_stats["epoch_losses"])),
          f"fitStream losses {a._fit_stats['epoch_losses']}")
    ck = os.path.join(tmp, "stream")
    _, lb = counted_call(lambda: killed(
        lambda: learner(checkpointDir=ck).fitStream(stream),
        INGEST_KILL_STREAM))
    check_launches(lb, attention_launches(INGEST_KILL_STREAM),
                   "the killed fitStream", dev)
    resumer = learner(checkpointDir=ck)
    check(resumer._latest_checkpoint() == (INGEST_EPOCHS - 2, None),
          f"the killed stream left {sorted(os.listdir(ck))}")
    r, lr = counted_call(lambda: resumer.fitStream(stream))
    check_launches(lr, attention_launches(per_epoch),
                   "the resumed fitStream", dev)
    check(same_params(r, a), "the resumed fitStream's parameters differ "
          "from the uninterrupted fit's")
    # (c) the newest checkpoint truncated: skipped, counted, and the fit
    # resumes from the one before
    newest = os.path.join(ck, f"ckpt_{INGEST_EPOCHS - 1:05d}.msgpack")
    size = os.path.getsize(newest)
    with open(newest, "r+b") as f:
        f.truncate(size // 2)
    telemetry.enable()
    telemetry.registry.reset()
    try:
        t, lt = counted_call(lambda: learner(checkpointDir=ck)
                             .fitStream(stream))
        corrupt = metric(telemetry, "mmlspark_ckpt_corrupt_total")
    finally:
        telemetry.disable()
    check(corrupt >= 1, "the truncated checkpoint was not counted corrupt")
    check_launches(lt, attention_launches(per_epoch),
                   "the fit resumed past the truncated checkpoint", dev)
    check(same_params(t, a), "the fit resumed past the truncated "
          "checkpoint differs from the uninterrupted fit")
    out["stream"] = {"launches": {"uninterrupted": la, "killed": lb,
                                  "resumed": lr, "past_truncated": lt},
                     "epoch_losses": a._fit_stats["epoch_losses"],
                     "resumed_bit_exact": True,
                     "truncated_bytes": [size, size // 2],
                     "corrupt_counted": corrupt}

    # (b) fit()'s feed path, async sharded step checkpoints
    df = DataFrame({"tokens": tokens, "label": labels})
    opts = dict(deviceDataCap=1, checkpointEverySteps=2,
                asyncCheckpoint=True, checkpointKeepSteps=2,
                checkpointShards=4)
    t0 = time.perf_counter()
    off = learner(deviceDataCap=1).fit(df)
    t1 = time.perf_counter()
    on = learner(checkpointDir=os.path.join(tmp, "on"), **opts).fit(df)
    fit_s = {"off": t1 - t0, "on": time.perf_counter() - t1}
    check(same_params(on, off), "checkpointing changed the feed fit")
    per = off._fit_stats["steps_per_epoch"]
    step_ms = {name: [s / per * 1e3 for s in m._fit_stats["epoch_seconds"]]
               for name, m in (("off", off), ("on", on))}
    ck = os.path.join(tmp, "feed")
    telemetry.enable()
    telemetry.registry.reset()
    try:
        killed(lambda: learner(checkpointDir=ck, **opts).fit(df),
               INGEST_KILL_FEED)
        resumer = learner(checkpointDir=ck, **opts)
        pos = resumer._latest_checkpoint()
        writes = telemetry.snapshot()["mmlspark_ckpt_write_seconds"]
        coalesced = metric(telemetry, "mmlspark_ckpt_coalesced_total")
        shards = metric(telemetry, "mmlspark_ckpt_shards_written_total")
        telemetry.registry.reset()
        res, lres = counted_call(lambda: resumer.fit(df))
        dispatched = metric(telemetry, "mmlspark_trainer_step_seconds",
                            "count")
    finally:
        telemetry.disable()
    # killed on epoch K // per's last step: its step-1 checkpoint is the
    # newest
    check(pos == (INGEST_KILL_FEED // per, 1),
          f"the killed feed fit's newest checkpoint is {pos}")
    left = per * INGEST_EPOCHS - pos[0] * per - pos[1] - 1
    check(dispatched == left, f"the resumed feed fit dispatched "
          f"{dispatched} steps, {left} were left")
    check_launches(lres, attention_launches(left), "the resumed feed fit",
                   dev)
    check(same_params(res, off), "the resumed feed fit's parameters differ "
          "from the uninterrupted fit's")
    series = writes["series"][0] if writes["series"] else {}
    out["feed"] = {"steps_per_epoch": per, "resumed_from": list(pos),
                   "steps_left": left, "steps_dispatched": dispatched,
                   "resumed_launches": lres, "resumed_bit_exact": True,
                   "ckpt_writes": series.get("count", 0),
                   "ckpt_write_seconds_sum": series.get("sum", 0.0),
                   "ckpt_coalesced": coalesced, "ckpt_shards_written": shards,
                   "step_ms_by_epoch": step_ms, "fit_s": fit_s,
                   "step_ms_async_off": statistics.median(step_ms["off"][1:]),
                   "step_ms_async_on": statistics.median(step_ms["on"][1:])}
    return out


# the numpy decode of the files ingest_images writes (PPM, 24-bit BMP and
# 8-bit RGB PNG with filter 0 on every row: io.image's encoders)
def numpy_decode(path: str) -> np.ndarray:
    import struct
    import zlib
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"P6":
        magic, dims, maxval, raster = data.split(b"\n", 3)
        w, h = map(int, dims.split())
        return np.frombuffer(raster, np.uint8).reshape(h, w, 3)[:, :, ::-1]
    if data[:2] == b"BM":
        off, = struct.unpack_from("<I", data, 10)
        w, h = struct.unpack_from("<ii", data, 18)
        row = (w * 3 + 3) & ~3
        px = np.frombuffer(data[off:off + row * h], np.uint8)
        return px.reshape(h, row)[::-1, :w * 3].reshape(h, w, 3)
    w, h = struct.unpack_from(">II", data, 16)
    idat, pos = b"", 8
    while pos < len(data):
        n, = struct.unpack_from(">I", data, pos)
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    check(not rows[:, 0].any(), f"{path}: a PNG row with a filter")
    return rows[:, 1:].reshape(h, w, 3)[:, :, ::-1]


def ingest_images(torch, tmp: str, dev: str) -> dict:
    """(2) bench.py's ResNet-20 and batch, fed from image files: every
    device batch equal to its files' numpy decode; fitStream killed in
    epoch 3 and resumed, within twice the gap of two clean fits; rows 1-7
    launch nothing."""
    from mmlspark_tpu_torch import TorchLearner, native
    from mmlspark_tpu_torch.io.image import ENCODERS
    from mmlspark_tpu_torch.io.loader import device_image_batches
    fmts = ["ppm", "bmp"] + (["png"] if "png" in native.formats() else [])
    rng = np.random.default_rng(SEED + 13)
    n, hw, bs = INGEST_IMAGES, INGEST_IMAGE_HW, BENCH_BATCH
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    imgs = rng.integers(0, 64, size=(n, hw, hw, 3), dtype=np.uint8)
    band = max(1, hw // 10)
    for c in range(10):       # class c: a bright band in channel c % 3
        imgs[labels == c, c * band:(c + 1) * band, :, c % 3] += 160
    t0 = time.perf_counter()
    paths = []
    for i in range(n):
        fmt = fmts[i % len(fmts)]
        paths.append(os.path.join(tmp, f"img_{i:06d}.{fmt}"))
        with open(paths[-1], "wb") as f:
            f.write(ENCODERS[fmt](imgs[i]))
    write_s = time.perf_counter() - t0

    def batches():
        return device_image_batches(paths, bs, hw, hw, device=dev)

    t0 = time.perf_counter()
    seen = sum(count for _b, _ok, count in batches())
    synchronize(torch, dev)
    load_s = time.perf_counter() - t0
    check(seen == n, f"the loader gave {seen} of {n} images")
    decode_s = 0.0          # one Python thread: open, read, numpy decode
    for bi, (b, ok, count) in enumerate(batches()):
        got = b[:count].cpu().numpy()
        t0 = time.perf_counter()
        want = np.stack([numpy_decode(p)
                         for p in paths[bi * bs:bi * bs + count]])
        decode_s += time.perf_counter() - t0
        check(bool(ok[:count].all()) and np.array_equal(got, want)
              and np.array_equal(got, imgs[bi * bs:bi * bs + count]),
              f"device batch {bi} differs from its files' decode")

    def stream():
        for bi, (b, _ok, count) in enumerate(batches()):
            yield b[:count], labels[bi * bs:bi * bs + count]

    def learner(**kw):
        return TorchLearner(modelConfig={"type": "resnet", "num_classes": 10},
                            optimizer="momentum", learningRate=BENCH_LR,
                            momentum=0.9, precision="bf16",
                            epochs=INGEST_EPOCHS, seed=SEED, device=dev, **kw)

    ck = os.path.join(tmp, "ckpt")
    reset_kernel_counts()
    reset_gbdt_counts()
    clean = [learner().fitStream(stream) for _ in range(2)]
    killed(lambda: learner(checkpointDir=ck).fitStream(stream),
           INGEST_KILL_IMAGES)
    resumer = learner(checkpointDir=ck)
    check(resumer._latest_checkpoint() == (INGEST_EPOCHS - 2, None),
          f"the killed image fit left {sorted(os.listdir(ck))}")
    resumed = resumer.fitStream(stream)
    launches = {**kernel_counts(), **gbdt_counts()}
    check(not any(launches.values()),
          f"the ResNet stream fits launched kernels of the table: {launches}")
    clean_gap = params_rel_l2(clean[1], clean[0])
    resume_gap = params_rel_l2(resumed, clean[0])
    check(resume_gap <= TOL_INGEST_IMAGE_GAP * clean_gap,
          f"the resumed image fit is {resume_gap} (relative L2) from a "
          f"clean fit; two clean fits are {clean_gap} apart")
    losses = clean[0]._fit_stats["epoch_losses"]
    check(all(np.isfinite(losses)), f"image fit losses {losses}")
    steps = -(-n // bs)
    step_ms = [s / steps * 1e3 for s in clean[0]._fit_stats["epoch_seconds"]]
    return {"images": n, "hw": hw, "formats": fmts, "batch": bs,
            "steps_per_epoch": steps, "write_s": write_s,
            "loader_images_per_s": n / load_s,
            "numpy_decode_files_per_s": n / decode_s,
            "batches_equal_numpy_decode": True,
            "epoch_losses": losses, "step_ms_by_epoch": step_ms,
            "step_ms": statistics.median(step_ms[1:]),
            "clean_gap_rel_l2": clean_gap, "resume_gap_rel_l2": resume_gap,
            "launches": launches}


def ingest_csv(torch, tmp: str, dev: str) -> dict:
    """(3) bench_gbdt.py's draws as a CSV file -> read_csv_matrix (bit for
    bit numpy's parse) -> LightGBMClassifier(numIterations=20) ->
    transform; (4) interleave_f32 over its 28 columns."""
    from mmlspark_tpu_torch import DataFrame, LightGBMClassifier, native
    from mmlspark_tpu_torch.io import read_csv_matrix
    rng = np.random.default_rng(0)
    n, d = INGEST_CSV_ROWS, GBDT_FEATURES
    x = rng.normal(size=(n, d)).astype(np.float32)
    logit = x[:, 0] * 2 + x[:, 1] - x[:, 2] * 0.5 + rng.normal(0, 0.5, n)
    y = (logit > 0).astype(np.float32)
    mat = np.concatenate([x, y[:, None]], axis=1)
    path = os.path.join(tmp, "higgs.csv")
    # %.9g gives each float32 back exactly from a correctly rounded parse
    with open(path, "w") as f:
        f.write((",".join(["%.9g"] * (d + 1)) + "\n") * n
                % tuple(mat.ravel().tolist()))
    t0 = time.perf_counter()
    got = read_csv_matrix(path)
    parse_s = time.perf_counter() - t0
    want = np.loadtxt(path, delimiter=",", dtype=np.float32)
    check(got.dtype == np.float32 and np.array_equal(got, want)
          and np.array_equal(got, mat),
          "read_csv_matrix differs from numpy's parse of the file")
    df = DataFrame({"features": got[:, :d], "label": got[:, d]})
    clf = LightGBMClassifier(numIterations=INGEST_GBDT_ITERS, device=dev)
    model, lf = counted_call(lambda: clf.fit(df))
    check_launches(lf, launches_of(node_hist=INGEST_GBDT_ITERS * GBDT_DEPTH),
                   "the CSV booster's fit", dev)
    scored, ls = counted_call(lambda: model.transform(df))
    check_launches(ls, launches_of(predict=1), "the CSV booster's transform",
                   dev)
    accuracy = float((np.asarray(scored.col("prediction")) == y).mean())
    check(accuracy >= TOL_GBDT_ACCURACY,
          f"the CSV booster's training accuracy {accuracy}")
    cols = [np.ascontiguousarray(x[:, j]) for j in range(d)]
    inter = np.empty((n, d), np.float32)
    t0 = time.perf_counter()
    check(native.interleave_f32(cols, inter),
          "interleave_f32 did not run natively")
    inter_s = time.perf_counter() - t0
    check(np.array_equal(inter, np.stack(cols, axis=1)),
          "interleave_f32 differs from np.stack")
    size = os.path.getsize(path)
    return {"rows": n, "features": d, "csv_bytes": size,
            "parse_s": parse_s, "parse_mb_per_s": size / parse_s / 1e6,
            "fit_launches": lf, "transform_launches": ls,
            "train_accuracy": accuracy, "interleave_bit_exact": True,
            "interleave_s": inter_s}


def phase_ingest(torch, env, dev="cuda"):
    """Out-of-core training: fitStream, checkpoints and bit-exact resume,
    fed from files. (1) the transformer stream and feed fits, (2) ResNet-20
    from image files, (3) a CSV file into a booster, (4) the Arrow
    bridge's C++ half, ``interleave_f32`` (``io/arrow.py`` itself needs
    pyarrow, which the card's machine lacks: the CPU tests hold it). The
    native runtime is built and used: ``MMLSPARK_TPU_NO_NATIVE`` must be
    unset, and ``native.calls`` must show the loader, the parser and the
    interleave at work."""
    import tempfile
    from mmlspark_tpu_torch import native
    t_phase = time.perf_counter()
    check(not os.environ.get("MMLSPARK_TPU_NO_NATIVE"),
          "MMLSPARK_TPU_NO_NATIVE is set: the phase needs the native runtime")
    t0 = time.perf_counter()
    lib_path = str(native.build())
    native.get_lib()
    build_s = time.perf_counter() - t0
    before = dict(native.calls)
    parts = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        stream = ingest_stream(torch, os.path.join(tmp, "s"), dev)
        parts["transformer"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        os.makedirs(os.path.join(tmp, "i"))
        images = ingest_images(torch, os.path.join(tmp, "i"), dev)
        parts["images"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        csv = ingest_csv(torch, tmp, dev)
        parts["csv"] = time.perf_counter() - t0
    used = {k: native.calls.get(k, 0) - before.get(k, 0)
            for k in ("loader_batches", "csv", "interleave")}
    check(all(used.values()), f"the native runtime was bypassed: {used}")
    emit({"phase": "ingest", "config": TRAIN_CFG, "native_library": lib_path,
          "host_cpus": os.cpu_count(),
          "native_formats": list(native.formats()), "native_build_s": build_s,
          "native_calls": used, "transformer": stream, "images": images,
          "csv": csv, "parts_s": parts,
          "gpu": env.gpu_name_and_power_limit(),
          "seconds": time.perf_counter() - t_phase})


def b64_rows(rows) -> list:
    import base64
    return [base64.b64encode(np.ascontiguousarray(r).tobytes()).decode()
            for r in rows]


def post_replies(url: str, payloads, concurrency: int) -> list:
    """The reply bodies of ``payloads`` POSTed to ``url`` through the
    port's ``HTTPTransformer`` (every one must answer 200)."""
    from mmlspark_tpu_torch import DataFrame
    from mmlspark_tpu_torch.core.utils import object_column
    from mmlspark_tpu_torch.io.http import HTTPTransformer
    reqs = [{"url": url, "method": "POST", "body": p} for p in payloads]
    out = (HTTPTransformer(concurrency=concurrency, timeout=120.0)
           .setInputCol("req").setOutputCol("resp")
           .transform(DataFrame({"req": object_column(reqs)})).col("resp"))
    codes = [r["statusCode"] for r in out]
    check(all(c == 200 for c in codes),
          f"replies with status {sorted(set(codes))}: "
          f"{[r for r in out if r['statusCode'] != 200][:2]}")
    return [r["body"] for r in out]


def closed_loop(url: str, payloads, clients: int) -> dict:
    """``clients`` threads, each sending its share of ``payloads`` one
    after another (a closed loop): per-request latency p50/p99 and the
    requests/s of the whole run, and the reply of each payload."""
    from mmlspark_tpu_torch.io.http.transformer import request
    lat = [0.0] * len(payloads)
    bodies = [None] * len(payloads)

    def client(k):
        for i in range(k, len(payloads), clients):
            t0 = time.perf_counter()
            r = request("POST", url, data=payloads[i], timeout=120.0)
            lat[i] = time.perf_counter() - t0
            check(r.status_code == 200, f"status {r.status_code}: {r.text}")
            bodies[i] = r.text

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    ms = np.sort(np.asarray(lat)) * 1e3
    return {"clients": clients, "requests": len(payloads),
            "requests_per_s": len(payloads) / wall,
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)), "bodies": bodies}


def serve_buckets(torch, step, dev: str) -> dict:
    """Each bucket's graph replay against an eager forward of the same
    padded batch (bit for bit), and both timed."""
    rng = np.random.default_rng(SEED + 20)
    out = {}
    for b in step.policy.buckets:
        xb = torch.from_numpy(rng.integers(
            0, SLICE_CFG["vocab_size"], size=(b, SEQ), dtype=np.int32)).to(dev)
        ex = step.executable(b)
        check(ex is not None, f"bucket {b} was not captured")
        before = ex.replays
        got, want = ex(xb), step.forward(xb)
        check(ex.replays == before + 1, "the executable did not replay")
        same = bool(torch.equal(got, want))
        entry = {"bit_equal": same, "rel_l2": rel_l2(got.cpu(), want.cpu())}
        check(same, f"bucket {b}: the replay differs from an eager forward "
              f"(relative L2 {entry['rel_l2']})")
        if dev == "cuda":
            entry["replay_ms"] = cuda_ms(torch, lambda: ex(xb))
            entry["eager_ms"] = cuda_ms(torch, lambda: step.forward(xb))
        out[str(b)] = entry
    return out


def serve_worker(torch, bundle: str, payloads, want: list, dev: str) -> dict:
    """(b) ``python -m mmlspark_tpu_torch.io.http.worker --bundle DIR`` in
    a subprocess: warm from the bundle with no nvcc run, the replies of
    (a) bit for bit, no cache miss. The process is killed at the end."""
    import subprocess
    from mmlspark_tpu_torch.io.http.transformer import request
    env = dict(os.environ, MMLSPARK_TPU_TELEMETRY="1",
               PYTHONPATH=os.getcwd())
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "mmlspark_tpu_torch.io.http.worker",
         "--bundle", bundle, "--device", dev],
        stdout=subprocess.PIPE, text=True, env=env)
    try:
        ports = json.loads(proc.stdout.readline())   # after load_bundle
        ports_s = time.perf_counter() - t0
        url = f"http://127.0.0.1:{ports['port']}/"
        ctl = f"http://127.0.0.1:{ports['control']}"
        bodies = []
        for p in payloads:
            r = request("POST", url, data=p, timeout=120.0)
            check(r.status_code == 200, f"worker status {r.status_code}")
            if not bodies:
                first_s = time.perf_counter() - t0
            bodies.append(r.text)
        health = json.loads(request("GET", ctl + "/healthz").text)
        metrics = request("GET", ctl + "/metrics").text
    finally:
        proc.kill()
        proc.wait(timeout=30)
    counts = {}
    for name in ("mmlspark_serving_exec_cache_misses_total",
                 "mmlspark_serving_exec_cache_hits_total",
                 "mmlspark_serving_bundle_execs_loaded_total"):
        vals = [float(ln.split()[-1]) for ln in metrics.splitlines()
                if ln.startswith(name)]
        counts[name] = sum(vals)
    serving = health["serving"]
    check(serving["warm_buckets"] == serving["buckets"],
          f"the worker came up with warm buckets {serving['warm_buckets']}")
    check(serving["compiles"] == 0 and serving["nvcc_builds"] == 0,
          f"the worker captured or built on traffic: {serving}")
    check(counts["mmlspark_serving_exec_cache_misses_total"] == 0
          and counts["mmlspark_serving_exec_cache_hits_total"] > 0,
          f"the worker's cache counters {counts}")
    same = bodies == want
    check(same, "the restarted worker's replies differ from (a)'s")
    return {"spawn_to_first_reply_s": first_s,
            "spawn_to_ports_s": ports_s, "requests": len(payloads),
            "replies_bit_equal": same, "serving": serving,
            "counters": counts}


def serve_transform_graphs(torch, params, dev: str) -> dict:
    """(c) the 13 x 4096 TorchModel.transform after warmup (one graph per
    bucket) against the same model with no graph, bit for bit, both
    timed."""
    from mmlspark_tpu_torch import DataFrame, TorchModel
    from mmlspark_tpu_torch.ops.flash_attention import flash_attention_fwd
    rng = np.random.default_rng(SEED + 21)
    df = DataFrame({"tokens": rng.integers(
        0, SLICE_CFG["vocab_size"], size=(ROWS, SEQ), dtype=np.int32)})

    def model():
        return TorchModel(inputCol="tokens", outputCol="scores",
                          modelConfig=SLICE_CFG, modelParams=params,
                          miniBatchSize=MINI_BATCH, device=dev)

    graphs, eager = model().warmup(df), model()
    if dev == "cuda":
        (pf,) = graphs._graphs.values()      # one output layer, one bucket
        (ex,) = pf._execs.values()
        replays = ex.replays
    flash_attention_fwd.launches = 0
    got = np.stack(graphs.transform(df).col("scores"))
    launches = flash_attention_fwd.launches
    chunks = -(-ROWS // MINI_BATCH)
    if dev == "cuda":
        check(launches == SLICE_CFG["layers"] * chunks,
              f"the graph transform counted {launches} flash launches")
        check(ex.replays - replays == chunks,
              f"the transform replayed {ex.replays - replays} graphs for "
              f"{chunks} chunks")
    want = np.stack(eager.transform(df).col("scores"))
    same = bool(np.array_equal(got, want))
    check(same, f"the graph transform differs from the eager one by "
          f"{float(np.abs(got - want).max())}")
    out = {"rows": ROWS, "seq": SEQ, "chunks": chunks,
           "flash_launches": launches, "bit_equal_eager": same}
    times = {"graphs": [], "eager": []}
    for name in ("graphs", "eager", "eager", "graphs") * 3:   # in turns
        m = graphs if name == "graphs" else eager
        t0 = time.perf_counter()
        m.transform(df)
        times[name].append(time.perf_counter() - t0)
    for name, ts in times.items():
        out[f"{name}_ms"] = statistics.median(ts) * 1e3
        out[f"{name}_ms_calls"] = [t * 1e3 for t in ts]
    return out


class BoosterReplies:
    """value (a JSON list of 28 floats) -> the booster's prediction and
    probability; counts the polling batches it scored."""

    def __init__(self, model):
        self.model = model
        self.batches = 0

    def transform(self, df):
        from mmlspark_tpu_torch.core.utils import object_column
        x = np.stack([np.asarray(json.loads(v), np.float32)
                      for v in df.col("value")])
        self.batches += 1
        scored = self.model.transform(df.withColumn(
            "features", object_column(list(x))))
        return df.withColumn("reply", object_column(booster_replies(scored)))


def booster_replies(scored) -> list:
    return [json.dumps({"prediction": float(p),
                        "probability": np.asarray(q).tolist()})
            for p, q in zip(scored.col("prediction"),
                            scored.col("probability"))]


def serve_booster(torch, dev: str) -> dict:
    """(d) serve_pipeline over a level-wise booster fitted on
    bench_gbdt.py's draws at SERVE_GBDT_ROWS rows: JSON requests of 28
    floats, replies equal to transform's bit for bit, row 5 launched once
    per polling batch."""
    from mmlspark_tpu_torch import DataFrame, LightGBMClassifier
    from mmlspark_tpu_torch.core.utils import object_column
    from mmlspark_tpu_torch.io.http import serve_pipeline
    rng = np.random.default_rng(0)
    n, d = SERVE_GBDT_ROWS, GBDT_FEATURES
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = ((x[:, 0] * 2 + x[:, 1] - x[:, 2] * 0.5 + rng.normal(0, 0.5, n))
         > 0).astype(np.float32)
    t0 = time.perf_counter()
    model = LightGBMClassifier(numIterations=INGEST_GBDT_ITERS,
                               device=dev).fit(DataFrame({"features": x,
                                                          "label": y}))
    fit_s = time.perf_counter() - t0
    rows = x[:SERVE_GBDT_REQUESTS]
    want = booster_replies(model.transform(DataFrame(
        {"features": object_column(list(rows))})))
    replier = BoosterReplies(model)
    source, loop = serve_pipeline(replier, max_batch=SERVE_MAX_BATCH)
    try:
        reset_gbdt_counts()
        reset_kernel_counts()
        t0 = time.perf_counter()
        got = post_replies(source.url, [json.dumps(r.tolist())
                                        for r in rows], SERVE_CONCURRENCY)
        serve_s = time.perf_counter() - t0
        launches = {**gbdt_counts(), **kernel_counts()}
    finally:
        loop.stop()
        source.close()
    check(got == want, "the booster's replies differ from transform's")
    check_launches(launches, launches_of(predict=replier.batches),
                   "the booster behind serve_pipeline", dev)
    return {"rows": n, "iterations": INGEST_GBDT_ITERS, "fit_s": fit_s,
            "requests": len(rows), "batches": replier.batches,
            "launches": launches, "replies_bit_equal": True,
            "requests_per_s": len(rows) / serve_s}


def phase_serving(torch, env, dev="cuda"):
    """The serving path: (a) SLICE_CFG through serve_continuous with every
    bucket captured before the source opens, (b) a warm restart of the
    worker from the bundle, (c) TorchModel.transform over graphs, (d)
    serve_pipeline over a level-wise booster."""
    import tempfile
    from mmlspark_tpu_torch import telemetry
    from mmlspark_tpu_torch.io.serving import (BucketPolicy,
                                               FusedServingStep,
                                               save_bundle, serve_continuous)
    from mmlspark_tpu_torch.ops.flash_attention import flash_attention_fwd
    t_phase = time.perf_counter()
    params = slice_params(np.random.default_rng(SEED))
    step = FusedServingStep(
        SLICE_CFG, params, row_shape=(SEQ,), in_dtype=np.int32,
        output="scores", device=dev,
        policy=BucketPolicy(max_batch=SERVE_MAX_BATCH, min_bucket=1))
    telemetry.enable()
    telemetry.registry.reset()
    try:
        t0 = time.perf_counter()
        source, loop = serve_continuous(step)    # captures, then opens
        capture_s = time.perf_counter() - t0
        check(step.warm_buckets() == step.policy.buckets == [1, 2, 4, 8, 16]
              and step.compiles() == 5,
              f"warm buckets {step.warm_buckets()} after serve_continuous")
        try:
            rng = np.random.default_rng(SEED + 22)
            rows = rng.integers(0, SLICE_CFG["vocab_size"],
                                size=(SERVE_REQUESTS, SEQ), dtype=np.int32)
            payloads = b64_rows(rows)
            replays0 = {b: step.executable(b).replays
                        for b in step.policy.buckets}
            flash_attention_fwd.launches = 0
            t0 = time.perf_counter()
            bodies = post_replies(source.url, payloads, SERVE_CONCURRENCY)
            traffic_s = time.perf_counter() - t0
            launches = flash_attention_fwd.launches
            dispatches = {b: step.executable(b).replays - replays0[b]
                          for b in step.policy.buckets}
            misses = metric(telemetry,
                            "mmlspark_serving_exec_cache_misses_total")
            loops = [closed_loop(source.url, payloads[:SERVE_LATENCY_REQS],
                                 c) for c in SERVE_CLIENTS]
        finally:
            loop.stop()
            source.close()
    finally:
        telemetry.disable()
    n_disp = sum(dispatches.values())
    if dev == "cuda":
        check(launches == SLICE_CFG["layers"] * n_disp,
              f"row 1 launched {launches} times over {n_disp} dispatches")
    check(misses == 0, f"{misses} cache misses under traffic")
    scores = np.array([json.loads(b)["scores"] for b in bodies])
    check(scores.shape == (SERVE_REQUESTS, SLICE_CFG["num_classes"])
          and bool(np.isfinite(scores).all()), "reply scores")
    eager = np.concatenate([
        step.forward(torch.from_numpy(rows[lo:lo + SERVE_MAX_BATCH])
                     .to(dev)).float().cpu().numpy()
        for lo in range(0, SERVE_REQUESTS, SERVE_MAX_BATCH)])
    worst = max(rel_l2(s, e) for s, e in zip(scores, eager))
    check(worst <= TOL_SERVE_L2, f"a reply is {worst} (relative L2) from "
          f"an eager forward of its row")
    top2 = np.sort(eager, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > TOL_SERVE_GAP
    check(bool((scores.argmax(1) == eager.argmax(1))[clear].all()),
          "a reply's argmax differs where the eager top-two gap is clear")
    buckets = serve_buckets(torch, step, dev)
    with tempfile.TemporaryDirectory() as tmp:
        save_bundle(tmp, step)
        restart = serve_worker(torch, tmp, payloads[:SERVE_RESTART_REQS],
                               loops[0]["bodies"][:SERVE_RESTART_REQS], dev)
    graphs = serve_transform_graphs(torch, params, dev)
    booster = serve_booster(torch, dev)
    for lp in loops:
        lp.pop("bodies")
    emit({"phase": "serving", "config": SLICE_CFG, "seq": SEQ,
          "policy": {"max_batch": SERVE_MAX_BATCH, "min_bucket": 1},
          "capture_s": capture_s, "requests": SERVE_REQUESTS,
          "concurrency": SERVE_CONCURRENCY, "traffic_s": traffic_s,
          "requests_per_s": SERVE_REQUESTS / traffic_s,
          "dispatches_by_bucket": dispatches, "flash_launches": launches,
          "cache_misses": misses, "worst_rel_l2_vs_eager": worst,
          "closed_loop": loops, "buckets": buckets,
          "warm_restart": restart, "transform_graphs": graphs,
          "booster": booster, "gpu": env.gpu_name_and_power_limit(),
          "seconds": time.perf_counter() - t_phase})
    return {"fwd": launches, "transform_graphs": graphs["flash_launches"],
            "predict": booster["launches"]["predict"]}


def fusion_frame():
    """gbdt_data()'s rows as 28 raw float32 columns with NaN gaps, the
    label, and the same rows as the 28-wide matrix."""
    from mmlspark_tpu_torch import DataFrame
    x, y = gbdt_data()
    for j in FUSION_NAN_COLS:
        x[::7, j] = np.nan
    cols = {f"f{j}": np.ascontiguousarray(x[:, j])
            for j in range(x.shape[1])}
    return DataFrame({**cols, "label": y}), [*cols], x, y


def fusion_pipeline(feats, booster):
    from mmlspark_tpu_torch.core.pipeline import Pipeline
    from mmlspark_tpu_torch.stages.basic import FastVectorAssembler
    from mmlspark_tpu_torch.stages.data_stages import CleanMissingData
    return Pipeline(stages=(CleanMissingData(inputCols=feats),
                            FastVectorAssembler(inputCols=feats,
                                                outputCol="features"),
                            booster))


def fusion_fits(torch, df, feats, make, want_hist: int, what: str,
                dev: str, warm: bool = False):
    """(a)/(b): the pipeline fitted staged, then fused (and, ``warm``, fused
    once more: the first fused fit of the process also pays its one-time
    costs); each fit's row 4 launches must be ``want_hist``, the booster
    states equal key for key, bit for bit, each fused fit one dispatch a
    binning slab and no fallback. Each fit's span times (ms by span name)
    say where its seconds went. Returns the fused PipelineModel and the
    phase's fields."""
    from mmlspark_tpu_torch import telemetry
    from mmlspark_tpu_torch.core import capture as capturelib
    from mmlspark_tpu_torch.models.gbdt import engine
    out = {}
    runs = [("staged", False), ("fused", True)] + (
        [("fused_warm", True)] if warm else [])
    telemetry.enable()
    try:
        for key, fuse in runs:
            telemetry.registry.reset()
            telemetry.trace.clear()
            reset_gbdt_counts()
            reset_kernel_counts()
            synchronize(torch, dev)
            t0 = time.perf_counter()
            pm = fusion_pipeline(feats, make()).setFusePipeline(fuse).fit(df)
            state = pm.getStages()[-1].getBoosterState()   # read back
            seconds = time.perf_counter() - t0
            spans = collections.Counter()
            for ev in telemetry.trace.events():
                if ev.get("ph") == "X" and not ev["name"].startswith(
                        "gbdt/iter"):
                    spans[ev["name"]] += ev["dur"] / 1e3
            out[key] = {"pm": pm, "state": state, "fit_s": seconds,
                        "span_ms": dict(spans),
                        "launches": {**gbdt_counts(), **kernel_counts()},
                        "fit_dispatches": capturelib._m_fit_fused.value,
                        "fit_fallbacks": capturelib._m_fit_fallbacks.value,
                        "fit_h2d_bytes": capturelib._m_transfer.labels(
                            direction="in", phase="fit").value,
                        "fit_d2h_bytes": capturelib._m_transfer.labels(
                            direction="out", phase="fit").value}
    finally:
        telemetry.disable()
    slabs = -(-len(df) // engine._BIN_SLAB)
    for key, fuse in runs:
        f = out[key]
        check_launches(f["launches"], launches_of(node_hist=want_hist),
                       f"the {what} {key} fit", dev)
        check(f["fit_dispatches"] == (slabs if fuse else 0)
              and f["fit_fallbacks"] == 0,
              f"{what} {key} fit: {f['fit_dispatches']} fused dispatches "
              f"for {slabs} slabs, {f['fit_fallbacks']} fallbacks")
        check(same_state(out["staged"]["state"], f["state"]),
              f"the {what} {key} fit's booster state differs from the "
              f"staged fit's")
    fields = {k: {f2: v for f2, v in out[k].items()
                  if f2 not in ("pm", "state")} for k in out}
    fields["slabs"] = slabs
    fields["booster_state_bit_equal"] = True
    return out["fused"]["pm"], fields


def fusion_transform(torch, pm, df, y, dev: str) -> dict:
    """(c) the fused level-wise PipelineModel over the 1M rows: one
    segment, one dispatch, row 5 not launched, a second transform a
    replay; its columns against the staged dense walk (TOL_FUSED_DENSE)
    and the staged quantized predict (TOL_GBDT_PREDICT, labels differing
    only within the raw delta)."""
    from mmlspark_tpu_torch import telemetry
    from mmlspark_tpu_torch.core.pipeline import PipelineModel
    stages = pm.getStages()
    telemetry.enable()
    telemetry.registry.reset()
    try:
        reset_gbdt_counts()
        reset_kernel_counts()
        t0 = time.perf_counter()
        fused = pm.transform(df)
        first_s = time.perf_counter() - t0
        launches = {**gbdt_counts(), **kernel_counts()}
        segments = metric(telemetry, "mmlspark_pipeline_segments")
        dispatches = metric(telemetry,
                            "mmlspark_pipeline_fused_dispatches_total")
        (entry,) = pm._seg_cache.values()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            pm.transform(df)
            times.append(time.perf_counter() - t0)
        pf = entry["pf"]
    finally:
        telemetry.disable()
    check(segments == 1 and dispatches == 1,
          f"the fused transform ran {segments} segments, {dispatches} "
          f"dispatches")
    check_launches(launches, launches_of(), "the fused level-wise transform",
                   dev)
    check(pf.compiles == 1 and pf.calls == 4,
          f"the segment captured {pf.compiles} times over {pf.calls} calls")
    booster = stages[-1]
    dense_pm = PipelineModel(stages=stages[:-1] + (
        booster.copy().setPredictImpl("dense"),))
    t0 = time.perf_counter()
    dense = dense_pm.transform(df)
    dense_s = time.perf_counter() - t0
    worst = {}
    for c in ("rawPrediction", "probability", "prediction"):
        a = np.stack(fused.col(c)) if fused.col(c).dtype == object \
            else fused.col(c)
        b = np.stack(dense.col(c)) if dense.col(c).dtype == object \
            else dense.col(c)
        worst[c] = float(np.abs(a.astype(np.float64)
                                - b.astype(np.float64)).max())
        check(fused.col(c).dtype == dense.col(c).dtype,
              f"fused {c} dtype {fused.col(c).dtype}")
    check(max(worst.values()) <= TOL_FUSED_DENSE,
          f"the fused transform differs from the staged dense walk: {worst}")
    reset_gbdt_counts()
    reset_kernel_counts()
    t0 = time.perf_counter()
    auto = PipelineModel(stages=stages).transform(df)
    auto_s = time.perf_counter() - t0
    auto_launches = {**gbdt_counts(), **kernel_counts()}
    check_launches(auto_launches, launches_of(predict=1),
                   "the staged transform", dev)
    raw_f = np.stack(fused.col("rawPrediction"))
    raw_a = np.stack(auto.col("rawPrediction"))
    delta = float(np.abs(raw_f - raw_a).max())
    rel = delta / float(np.abs(raw_f).max())
    check(rel <= TOL_GBDT_PREDICT,
          f"fused vs staged quantized raw scores: {rel} (relative)")
    flips = np.asarray(fused.col("prediction")) \
        != np.asarray(auto.col("prediction"))
    check(bool((np.abs(raw_f[flips, 0]) <= delta).all()),
          "labels differ on rows whose margin exceeds the raw delta")
    return {"rows": len(df), "segments": segments,
            "fused_dispatches": dispatches, "launches": launches,
            "captures": pf.compiles, "calls": pf.calls,
            "first_fused_s": first_s,
            "fused_s": statistics.median(times), "fused_s_calls": times,
            "staged_dense_s": dense_s, "staged_auto_s": auto_s,
            "staged_auto_launches": auto_launches,
            "max_abs_vs_staged_dense": worst,
            "raw_rel_delta_vs_staged_auto": rel,
            "label_flips_vs_staged_auto": int(flips.sum())}


def fusion_transform_split(torch, pm, df, dev: str) -> dict:
    """(c) the leaf-wise booster, which does not capture, between two
    segments: [CleanMissingData, FastVectorAssembler] | booster (staged,
    row 6 once) | [RenameColumn, DropColumns]; outputs equal to the
    staged transform's."""
    from mmlspark_tpu_torch import telemetry
    from mmlspark_tpu_torch.core.pipeline import PipelineModel
    from mmlspark_tpu_torch.stages.basic import DropColumns, RenameColumn
    stages = pm.getStages() + (
        RenameColumn(inputCol="prediction", outputCol="yhat"),
        DropColumns(cols=("rawPrediction",)))
    split = PipelineModel(stages=stages, device=dev, fusePipeline=True)
    telemetry.enable()
    telemetry.registry.reset()
    try:
        reset_gbdt_counts()
        reset_kernel_counts()
        t0 = time.perf_counter()
        fused = split.transform(df)
        fused_s = time.perf_counter() - t0
        launches = {**gbdt_counts(), **kernel_counts()}
        segments = metric(telemetry, "mmlspark_pipeline_segments")
        dispatches = metric(telemetry,
                            "mmlspark_pipeline_fused_dispatches_total")
    finally:
        telemetry.disable()
    check(segments == 2 and dispatches == 2,
          f"the split transform ran {segments} segments, {dispatches} "
          f"dispatches")
    check_launches(launches, launches_of(predict_lw=1),
                   "the split leaf-wise transform", dev)
    t0 = time.perf_counter()
    staged = PipelineModel(stages=stages).transform(df)
    staged_s = time.perf_counter() - t0
    # the booster's outputs and the features bit for bit; the imputed
    # columns hold the fill in float32 (the device dtype) where the staged
    # stage keeps float64: equal within float32 rounding
    check(fused.columns == staged.columns, "the split transform's columns")
    worst_fill = 0.0
    for c in fused.columns:
        a, b = fused.col(c), staged.col(c)
        check(a.dtype == b.dtype, f"{c}: dtype {a.dtype}, staged {b.dtype}")
        if a.dtype == object:
            a, b = np.stack(a), np.stack(b)
        if c in ("features", "probability", "yhat", "label"):
            check(np.array_equal(a, b), f"{c} differs from the staged {c}")
        else:
            worst_fill = max(worst_fill, float(np.nanmax(
                np.abs(a - b) / np.maximum(np.abs(b), 1e-30))))
    check(worst_fill <= 2.0 ** -24,
          f"imputed columns {worst_fill} (relative) from the staged ones")
    return {"segments": segments, "fused_dispatches": dispatches,
            "launches": launches, "outputs_equal": True,
            "imputed_rel_delta": worst_fill,
            "fused_s": fused_s, "staged_s": staged_s}


def fusion_image_data():
    """bench.py's ResNet-20 inputs (bench.py:82-99): FUSION_BATCHES x
    12288 rows of uint8 pixels, flat in CHW order, and 10-class labels."""
    rng = np.random.default_rng(SEED + 30)
    n = FUSION_BATCHES * BENCH_BATCH
    pixels = rng.integers(0, 256, size=(n, 3 * 32 * 32), dtype=np.uint8)
    labels = rng.integers(0, 10, size=n).astype(np.int64)
    return pixels, labels


def fusion_learner(dev: str, **kw):
    from mmlspark_tpu_torch import TorchLearner
    return TorchLearner(modelConfig={"type": "resnet", "num_classes": 10},
                        inputShape=(3, 32, 32), batchSize=BENCH_BATCH,
                        optimizer="momentum", learningRate=BENCH_LR,
                        momentum=0.9, precision="bf16",
                        epochs=FUSION_EPOCHS, seed=SEED, device=dev, **kw)


@contextlib.contextmanager
def deterministic_cudnn(torch):
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def fusion_trainer(torch, dev: str) -> dict:
    """(d) FastVectorAssembler(("pixels",)) -> TorchLearner(ResNet-20,
    inputShape (3, 32, 32)) at bench.py's batch, staged and fused, on the
    scan and the feed path: equal parameters, the fused feature upload
    exactly a quarter of the staged one (uint8 against float32) on the
    trainer's counter and on the fit-phase pipeline counter, one capture
    per fused program; (e) fitStreamCaptured over the raw batches against
    fitStream over the staged ones."""
    from mmlspark_tpu_torch import DataFrame, telemetry
    from mmlspark_tpu_torch.core import capture as capturelib
    from mmlspark_tpu_torch.core.pipeline import Pipeline
    from mmlspark_tpu_torch.models import trainer as trainerlib
    from mmlspark_tpu_torch.stages.basic import FastVectorAssembler
    pixels, labels = fusion_image_data()
    n = len(labels)
    df = DataFrame({"pixels": pixels, "label": labels})
    asm = FastVectorAssembler(inputCols=("pixels",), outputCol="features")
    out = {"rows": n, "batch": BENCH_BATCH, "epochs": FUSION_EPOCHS,
           "config": {"type": "resnet", "num_classes": 10}}
    row_bytes = pixels.shape[1]
    telemetry.enable()
    try:
        with deterministic_cudnn(torch):
            for path, kw in (("scan", {}), ("feed", {"deviceDataCap": 1})):
                fits = {}
                for fuse in (False, True):
                    telemetry.registry.reset()
                    lr = fusion_learner(dev, **kw)
                    t0 = time.perf_counter()
                    pm = Pipeline(stages=(asm, lr),
                                  fusePipeline=fuse).fit(df)
                    fit_s = time.perf_counter() - t0
                    model = pm.getStages()[-1]
                    stats = model._fit_stats
                    steps = stats["steps_per_epoch"]
                    fits[fuse] = {
                        "model": model, "fit_s": fit_s,
                        "path": stats["path"],
                        "step_ms": stats["epoch_seconds"][-1] / steps * 1e3,
                        "trainer_bytes": trainerlib._m_transfer_bytes.value,
                        "fit_h2d_bytes": capturelib._m_transfer.labels(
                            direction="in", phase="fit").value,
                        "fit_dispatches": capturelib._m_fit_fused.value,
                        "captures": [pf.compiles for pf in getattr(
                            lr, "_fused_programs", {}).values()]}
                staged, fused = fits[False], fits[True]
                check(staged["path"] == fused["path"] == path,
                      f"{path}: the fits took the {staged['path']} and "
                      f"{fused['path']} paths")
                equal = same_params(staged["model"], fused["model"])
                check(equal, f"{path}: the fused ResNet-20 fit's parameters "
                      f"differ from the staged fit's (relative L2 "
                      f"{params_rel_l2(fused['model'], staged['model'])})")
                # the label column (int32) ships alike: the feature bytes
                # are what is left
                rows_up = fused["trainer_bytes"] / (row_bytes + 4)
                feat_staged = staged["trainer_bytes"] - 4 * rows_up
                feat_fused = fused["trainer_bytes"] - 4 * rows_up
                check(feat_staged == 4 * feat_fused
                      and fused["fit_h2d_bytes"] == fused["trainer_bytes"],
                      f"{path}: feature upload {feat_fused} fused against "
                      f"{feat_staged} staged (trainer counter), "
                      f"{fused['fit_h2d_bytes']} on the fit-phase counter")
                check(fused["captures"] == [1],
                      f"{path}: fused program captures {fused['captures']}")
                check(fused["fit_dispatches"] == steps * FUSION_EPOCHS,
                      f"{path}: {fused['fit_dispatches']} fused dispatches")
                out[path] = {
                    "params_bit_equal": equal,
                    "staged": {k: v for k, v in staged.items()
                               if k != "model"},
                    "fused": {k: v for k, v in fused.items()
                              if k != "model"},
                    "feature_bytes_staged": feat_staged,
                    "feature_bytes_fused": feat_fused}
            out["stream"] = fusion_stream(torch, pixels, labels, asm, dev)
    finally:
        telemetry.disable()
    return out


def fusion_stream(torch, pixels, labels, asm, dev: str) -> dict:
    """(e) fitStreamCaptured over raw (pixels, label) batches against
    fitStream over the staged float32 NHWC batches: equal parameters."""
    from mmlspark_tpu_torch import DataFrame
    from mmlspark_tpu_torch.core.capture import compose_fit_capture
    bs = BENCH_BATCH
    spans = [(lo, lo + bs) for lo in range(0, len(labels), bs)]

    def staged():
        for lo, hi in spans:
            x = pixels[lo:hi].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            yield np.ascontiguousarray(x, dtype=np.float32), labels[lo:hi]

    def raw():
        for lo, hi in spans:
            yield pixels[lo:hi], labels[lo:hi]

    plan = compose_fit_capture(
        [asm], DataFrame({"pixels": pixels[:2], "label": labels[:2]}),
        "features", "label")
    check(plan is not None, "no capture plan for the stream")
    t0 = time.perf_counter()
    want = fusion_learner(dev).fitStream(staged)
    staged_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = fusion_learner(dev).fitStreamCaptured(raw, plan)
    fused_s = time.perf_counter() - t0
    equal = same_params(want, got)
    check(equal, f"fitStreamCaptured's parameters differ from fitStream's "
          f"(relative L2 {params_rel_l2(got, want)})")
    return {"batches": len(spans), "params_bit_equal": equal,
            "fit_stream_s": staged_s, "fit_stream_captured_s": fused_s}


def fusion_serving(torch, booster, x, dev: str) -> dict:
    """(f) the pipeline composite: (a)'s booster behind a
    FastVectorAssembler over one 28-wide wire column ("features";
    from_pipeline serves one wire column, and (a)'s pipeline reads 28) as
    FusedServingStep.from_pipeline, buckets 1..16, behind
    serve_continuous: every bucket's replay equal to eager bit for bit,
    the replies equal to the PipelineModel's transform, no kernel of the
    table launched, a restarted worker warm from the bundle with 0
    captures and 0 nvcc runs."""
    import tempfile
    from mmlspark_tpu_torch import DataFrame, telemetry
    from mmlspark_tpu_torch.core.pipeline import PipelineModel
    from mmlspark_tpu_torch.core.utils import object_column
    from mmlspark_tpu_torch.io.serving import (BucketPolicy,
                                               FusedServingStep,
                                               save_bundle, serve_continuous)
    from mmlspark_tpu_torch.stages.basic import FastVectorAssembler
    served = PipelineModel(stages=(
        FastVectorAssembler(inputCols=("features",), outputCol="assembled"),
        booster.copy().setFeaturesCol("assembled")), device=dev)
    step = FusedServingStep.from_pipeline(
        served, input_col="features", row_shape=(x.shape[1],),
        in_dtype=np.float32, device=dev,
        policy=BucketPolicy(max_batch=SERVE_MAX_BATCH, min_bucket=1))
    rows = x[:SERVE_REQUESTS]
    payloads = b64_rows(rows)
    frame = DataFrame({"features": object_column(list(rows))})
    want_labels = served.copy().setFusePipeline(True).transform(frame) \
        .col("prediction").astype(int).tolist()
    dense = PipelineModel(stages=(served.getStages()[0], served.getStages()[1]
                                  .copy().setPredictImpl("dense")))
    check(dense.transform(frame).col("prediction").astype(int).tolist()
          == want_labels, "the fused and the staged dense transforms of the "
          "composite's pipeline disagree")
    telemetry.enable()
    telemetry.registry.reset()
    try:
        t0 = time.perf_counter()
        source, loop = serve_continuous(step)    # captures, then opens
        capture_s = time.perf_counter() - t0
        check(step.warm_buckets() == step.policy.buckets == [1, 2, 4, 8, 16]
              and step.compiles() == 5,
              f"warm buckets {step.warm_buckets()} after serve_continuous")
        try:
            reset_gbdt_counts()
            reset_kernel_counts()
            t0 = time.perf_counter()
            bodies = post_replies(source.url, payloads, SERVE_CONCURRENCY)
            traffic_s = time.perf_counter() - t0
            launches = {**gbdt_counts(), **kernel_counts()}
            lat = closed_loop(source.url,
                              payloads[:FUSION_SERVE_LATENCY_REQS],
                              FUSION_SERVE_CLIENTS)
            misses = metric(telemetry,
                            "mmlspark_serving_exec_cache_misses_total")
        finally:
            loop.stop()
            source.close()
    finally:
        telemetry.disable()
    got = [json.loads(b)["label"] for b in bodies]
    check(got == want_labels, "the composite's replies differ from the "
          "pipeline's transform")
    check(misses == 0, f"{misses} cache misses under traffic")
    check_launches(launches, launches_of(), "the pipeline composite", dev)
    buckets = {}
    rng = np.random.default_rng(SEED + 31)
    for b in step.policy.buckets:
        xb = torch.from_numpy(x[rng.choice(len(x), b)]).to(dev)
        ex = step.executable(b)
        same = bool(torch.equal(ex(xb), step.forward(xb)))
        check(same, f"bucket {b}: the replay differs from eager")
        buckets[str(b)] = {"bit_equal": same}
        if dev == "cuda":
            buckets[str(b)].update(
                replay_ms=cuda_ms(torch, lambda: ex(xb)),
                eager_ms=cuda_ms(torch, lambda: step.forward(xb)))
    lat.pop("bodies")
    with tempfile.TemporaryDirectory() as tmp:
        save_bundle(tmp, step)
        restart = serve_worker(torch, tmp, payloads[:SERVE_RESTART_REQS],
                               bodies[:SERVE_RESTART_REQS], dev)
    return {"requests": len(rows), "concurrency": SERVE_CONCURRENCY,
            "capture_s": capture_s, "traffic_s": traffic_s,
            "requests_per_s": len(rows) / traffic_s,
            "replies_equal_transform": True, "launches": launches,
            "cache_misses": misses, "closed_loop": lat,
            "buckets": buckets, "warm_restart": restart}


def phase_fusion(torch, env, dev="cuda"):
    """Whole-pipeline capture (core/capture.py) on the slices' shapes: (a)
    and (b) the fused featurize -> bin GBDT fits, (c) the fused transforms,
    (d) and (e) the fused ResNet-20 fits, (f) the pipeline serving
    composite."""
    from mmlspark_tpu_torch import LightGBMClassifier
    t_phase = time.perf_counter()
    df, feats, x, y = fusion_frame()
    pm_lvl, fit_lvl = fusion_fits(
        torch, df, feats, lambda: LightGBMClassifier(device=dev),
        GBDT_TREES * GBDT_DEPTH, "level-wise", dev, warm=True)
    pm_lw, fit_lw = fusion_fits(
        torch, df, feats,
        lambda: LightGBMClassifier(device=dev).setGrowthPolicy("leafwise"),
        GBDT_LEAVES * GBDT_TREES, "leaf-wise", dev)
    transform = fusion_transform(torch, pm_lvl, df, y, dev)
    split = fusion_transform_split(torch, pm_lw, df, dev)
    trainer = fusion_trainer(torch, dev)
    serving = fusion_serving(torch, pm_lvl.getStages()[-1], x, dev)
    emit({"phase": "fusion", "rows": len(df), "nan_columns": FUSION_NAN_COLS,
          "fit_levelwise": fit_lvl, "fit_leafwise": fit_lw,
          "transform": transform, "transform_split": split,
          "trainer": trainer, "serving": serving,
          "gpu": env.gpu_name_and_power_limit(),
          "seconds": time.perf_counter() - t_phase})
    return {"fit": fit_lvl["staged"]["launches"]["node_hist"],
            "fit_fused": fit_lvl["fused"]["launches"]["node_hist"],
            "fit_leafwise": fit_lw["staged"]["launches"]["node_hist"],
            "fit_fused_leafwise": fit_lw["fused"]["launches"]["node_hist"],
            "transform_fused": transform["launches"]["predict"],
            "transform_staged": transform["staged_auto_launches"]["predict"],
            "transform_fused_split": split["launches"]["predict_lw"],
            "serve_hist": serving["launches"]["node_hist"],
            "serve_predict": serving["launches"]["predict"]}


# ---------------------------------------------------------------- parallel

def moe_params(rng) -> dict:
    """Random weights of MOE_CFG in the JAX package's flax tree shape:
    slice_params' blocks with the FFN swapped for ``MoEMLP_0`` (gate and
    expert stacks normal, std 0.02; expert biases 0)."""
    base = slice_params(rng)["params"]
    d, E = MOE_CFG["d_model"], MOE_CFG["num_experts"]
    hid = MOE_CFG["mlp_ratio"] * d
    for i in range(MOE_CFG["layers"]):
        blk = base[f"block{i}"]
        del blk["Dense_2"], blk["Dense_3"]
        blk["MoEMLP_0"] = {
            "gate": rng.standard_normal((d, E), dtype=np.float32) * 0.02,
            "expert_w1": rng.standard_normal((E, d, hid),
                                             dtype=np.float32) * 0.02,
            "expert_b1": np.zeros((E, hid), np.float32),
            "expert_w2": rng.standard_normal((E, hid, d),
                                             dtype=np.float32) * 0.02,
            "expert_b2": np.zeros((E, d), np.float32)}
    return {"params": base}


@contextlib.contextmanager
def one_hot_moe():
    """Every MoE block runs the plain version: the JAX body's dense (S, E,
    C) one-hot dispatch and combine (``moe.moe_one_hot``)."""
    from mmlspark_tpu_torch.models import moe
    orig = moe.MoEMLP.forward

    def plain(self, x, row_mask=None, aux=None):
        y, a = moe.moe_one_hot(self, x, row_mask)
        if aux is not None:
            aux.append(a)
        return y
    moe.MoEMLP.forward = plain
    try:
        yield
    finally:
        moe.MoEMLP.forward = orig


def parallel_serve(torch, dev):
    """(a) MoE serving at full width: TorchModel.transform of ROWS x SEQ
    at MINI_BATCH after warmup (one graph per bucket), against the plain
    version (blockwise attention, one-hot dispatch) and the eager model."""
    from mmlspark_tpu_torch import DataFrame, TorchModel
    rng = np.random.default_rng(SEED + 21)
    params = moe_params(rng)
    tokens = rng.integers(0, MOE_CFG["vocab_size"], size=(ROWS, SEQ),
                          dtype=np.int32)
    df = DataFrame({"tokens": tokens})

    def model(cfg):
        return TorchModel(inputCol="tokens", outputCol="scores",
                          modelConfig=cfg, modelParams=params,
                          miniBatchSize=MINI_BATCH, device=dev)
    served = model(MOE_CFG)
    served.warmup(df)
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    scores = np.stack(served.transform(df).col("scores"))
    launches = kernel_counts()
    chunks = -(-ROWS // MINI_BATCH)
    L = MOE_CFG["layers"]
    if dev == "cuda":
        check(launches == {"fwd": L * chunks, "dq": 0, "dkv": 0},
              f"MoE serving launched {launches}, expected "
              f"{L} x {chunks} forward launches")
    check(scores.shape == (ROWS, MOE_CFG["num_classes"])
          and bool(np.isfinite(scores).all()), "MoE scores")
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" else 0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        served.transform(df)
        times.append(time.perf_counter() - t0)
    steady = statistics.median(times)
    breakdown = (device_breakdown(torch, lambda: served.transform(df))
                 if dev == "cuda" else None)
    eager = np.stack(model(MOE_CFG).transform(df).col("scores"))
    check(np.array_equal(eager, scores),
          "MoE graph replay differs from the eager model's bits")
    before = kernel_counts()
    with one_hot_moe():
        plain = np.stack(model(dict(MOE_CFG, attn_impl="blockwise"))
                         .transform(df).col("scores"))
    check(kernel_counts() == before, "the plain MoE model launched a kernel")
    err = float(np.abs(scores - plain).max())
    check(err <= TOL_SLICE, f"MoE scores differ from the plain version "
                            f"(blockwise, one-hot dispatch) by {err}")
    return {"rows": ROWS, "seq": SEQ, "mini_batch": MINI_BATCH,
            "launches": launches, "max_abs_err_vs_plain": err,
            "replay_equals_eager": True, "steady_transform_s": steady,
            "rows_per_s": ROWS / steady, "tokens_per_s": ROWS * SEQ / steady,
            "peak_mem_gb": peak, "profile_of_one_transform": breakdown}


def parallel_dispatch(torch, dev):
    """(b) One MoE layer at PAR_DISPATCH_ROWS x SEQ tokens: the index
    dispatch's xin equal to the one-hot einsum's bit for bit, the combined
    output within TOL_DISPATCH; each form's ms and peak bytes."""
    from mmlspark_tpu_torch.models.moe import MoEMLP, moe_one_hot
    rng = np.random.default_rng(SEED + 22)
    d, E = MOE_CFG["d_model"], MOE_CFG["num_experts"]
    hid = MOE_CFG["mlp_ratio"] * d
    layer = MoEMLP(E, hid, top_k=MOE_CFG["expert_top_k"],
                   capacity_factor=MOE_CFG["capacity_factor"],
                   dtype=torch.bfloat16, d_model=d).to(dev)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(
                tuple(p.shape), dtype=np.float32) * 0.02))
    x = torch.from_numpy(rng.standard_normal(
        (PAR_DISPATCH_ROWS, SEQ, d), dtype=np.float32)).to(dev).to(
            torch.bfloat16)
    out = {}
    with torch.inference_mode():
        y, xin = layer(x), layer.dispatch(x)[0]
        y_ref, _, xin_ref = moe_one_hot(layer, x, return_xin=True)
        cb = xin.shape[1]
        check(torch.equal(xin, xin_ref[:, :cb])
              and not bool(xin_ref[:, cb:].any()),
              "the index dispatch's xin differs from the one-hot einsum's")
        err = ((y.float() - y_ref.float()).abs().max()
               / y_ref.float().abs().max()).item()
        check(err <= TOL_DISPATCH,
              f"index combine differs from the one-hot einsum by {err}")
        for name, fn in (("index", lambda: layer(x)),
                         ("one_hot", lambda: moe_one_hot(layer, x))):
            if dev == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                fn()
                torch.cuda.synchronize()
                out[f"{name}_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                             - base)
                out[f"{name}_ms"] = cuda_ms(torch, fn, iters=5)
    C = int(MOE_CFG["capacity_factor"] * PAR_DISPATCH_ROWS * SEQ
            * MOE_CFG["expert_top_k"] / E)
    return dict(out, tokens=PAR_DISPATCH_ROWS * SEQ, capacity=C,
                buffer_slots=cb, max_rel_err_combine=err,
                xin_bit_equal=True)


def parallel_train(torch, dev):
    """(c) MoE training at full width: TorchLearner, adam, moeAuxWeight,
    PAR_TRAIN_BATCH x SEQ tokens a step, no remat: finite losses, rows 1-3
    launched layers times each a step, one step's gradients flash against
    blockwise attention."""
    from mmlspark_tpu_torch import DataFrame, TorchLearner
    rng = np.random.default_rng(SEED + 23)
    tokens = rng.integers(0, MOE_CFG["vocab_size"],
                          size=(PAR_TRAIN_ROWS, SEQ), dtype=np.int32)
    labels = rng.integers(0, MOE_CFG["num_classes"], size=PAR_TRAIN_ROWS,
                          dtype=np.int32)
    df = DataFrame({"tokens": tokens, "label": labels})
    learner = TorchLearner(featuresCol="tokens", modelConfig=MOE_CFG,
                           optimizer="adam", learningRate=1e-3,
                           batchSize=PAR_TRAIN_BATCH,
                           epochs=PAR_TRAIN_EPOCHS, seed=SEED,
                           moeAuxWeight=PAR_MOE_AUX, device=dev)
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    model = learner.fit(df)
    launches = kernel_counts()
    stats = model._fit_stats
    steps = stats["steps_per_epoch"] * PAR_TRAIN_EPOCHS
    L = MOE_CFG["layers"]
    if dev == "cuda":
        check(launches == {"fwd": L * steps, "dq": L * steps,
                           "dkv": L * steps},
              f"MoE training launched {launches}, expected {L} x {steps} "
              f"each")
    losses = stats["epoch_losses"]
    check(all(np.isfinite(losses)), f"MoE epoch losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" else 0
    step_ms = stats["epoch_seconds"][-1] / stats["steps_per_epoch"] * 1e3
    errs = step_grad_errors(torch, MOE_CFG, tokens, labels, device=dev)
    worst = max(errs, key=lambda k: errs[k]["l2_rel"])
    check(errs[worst]["l2_rel"] <= TOL_TRAIN_GRAD,
          f"MoE step gradient of {worst} differs from blockwise "
          f"attention's: {errs[worst]}")
    return {"rows": PAR_TRAIN_ROWS, "batch": PAR_TRAIN_BATCH,
            "steps": steps, "launches": launches, "epoch_losses": losses,
            "step_ms": step_ms,
            "train_tokens_per_s": PAR_TRAIN_BATCH * SEQ / step_ms * 1e3,
            "peak_mem_gb": peak, "worst_grad": worst,
            "worst_grad_l2_rel_vs_blockwise": errs[worst]["l2_rel"]}


def parallel_one_rank(torch, dev):
    """(d) A one-rank process group (NCCL on the card, over a TCPStore on
    127.0.0.1): the barrier, an object gather, a small-depth DP fit equal
    to the same fit with no group bit for bit, a transform through
    ``_transform_multihost`` equal to the plain transform, and
    tensor/sequence/expert/pipeline parallelism 2 each raising the JAX
    package's ValueError on one rank."""
    import socket

    import torch.distributed as tdist
    from mmlspark_tpu_torch import DataFrame, TorchLearner
    from mmlspark_tpu_torch.parallel import dataplane, distributed
    cfg = dict(SLICE_CFG, layers=PAR_NCCL_LAYERS)
    rng = np.random.default_rng(SEED + 24)
    tokens = rng.integers(0, cfg["vocab_size"], size=(PAR_NCCL_ROWS, SEQ),
                          dtype=np.int32)
    labels = rng.integers(0, cfg["num_classes"], size=PAR_NCCL_ROWS,
                          dtype=np.int32)
    df = DataFrame({"tokens": tokens, "label": labels})

    def learner(**kw):
        return TorchLearner(featuresCol="tokens", modelConfig=cfg,
                            optimizer="adam", learningRate=1e-3,
                            batchSize=MINI_BATCH, epochs=1, seed=SEED,
                            device=dev, **kw)
    plain = learner().fit(df)
    plain_scores = np.stack(plain.setMiniBatchSize(MINI_BATCH)
                            .transform(df).col("scores"))
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    t0 = time.perf_counter()
    distributed.initialize(f"127.0.0.1:{port}", 1, 0, init_timeout=60,
                           device=dev)
    init_s = time.perf_counter() - t0
    try:
        check(tdist.get_backend() == ("nccl" if dev == "cuda" else "gloo"),
              f"the group's backend is {tdist.get_backend()}")
        distributed.process_barrier("parallel")
        check(dataplane.allgather_pyobj({"rank": 0}) == [{"rank": 0}],
              "object gather")
        reset_kernel_counts()
        group_fit = learner().fit(df)
        fit_launches = kernel_counts()
        check(group_fit._fit_stats["path"] == plain._fit_stats["path"],
              "the one-rank fit took another path")
        a, b = plain.getModelParams(), group_fit.getModelParams()
        check(a.keys() == b.keys()
              and all(torch.equal(a[k], b[k]) for k in a),
              "the one-rank NCCL fit differs from the no-group fit")
        scores = np.stack(group_fit.setMiniBatchSize(MINI_BATCH)
                          .transform(df).col("scores"))
        check(np.array_equal(scores, plain_scores),
              "the one-rank transform (_transform_multihost) differs from "
              "the plain transform")
        refusals = {}
        for knob in ("tensorParallel", "sequenceParallel", "expertParallel",
                     "pipelineParallel"):
            try:
                learner(**{knob: 2}).fit(df)
            except ValueError as e:
                refusals[knob] = str(e)
        check(len(refusals) == 4, f"one rank ran a 2-way axis: {refusals}")
    finally:
        distributed.shutdown()
    return {"backend": "nccl" if dev == "cuda" else "gloo",
            "init_s": init_s, "fit_bit_equal": True,
            "transform_bit_equal": True, "fit_launches": fit_launches,
            "fit_path": group_fit._fit_stats["path"],
            "refusals": refusals}


def phase_parallel(torch, env, dev="cuda"):
    """parallel/ and models/moe.py on the card: (a) MoE serving, (b) the
    MoE dispatch, (c) MoE training, each at full width, and (d) a one-rank
    NCCL process group. Returns each path's kernel launches."""
    t_phase = time.perf_counter()
    serve = parallel_serve(torch, dev)
    dispatch = parallel_dispatch(torch, dev)
    train = parallel_train(torch, dev)
    one_rank = parallel_one_rank(torch, dev)
    emit({"phase": "parallel", "config": MOE_CFG, "serve_moe": serve,
          "dispatch": dispatch, "train_moe": train, "one_rank": one_rank,
          "gpu": env.gpu_name_and_power_limit(),
          "seconds": time.perf_counter() - t_phase})
    return {"serve_moe": serve["launches"], "train_moe": train["launches"]}


def timed_fit(torch, fit, dev):
    """(ensemble, seconds, launches) of one synchronised fit, every GBDT
    count set to 0 just before."""
    synchronize(torch, dev)
    reset_gbdt_counts()
    t0 = time.perf_counter()
    ens = fit()
    synchronize(torch, dev)
    return ens, time.perf_counter() - t0, gbdt_counts()


def gbdt_span_totals(torch, fit, dev) -> dict:
    """``fit`` run once with telemetry on: its seconds and, per
    ``gbdt/iter/*`` span, the count and the summed seconds (each span waits
    for its device work)."""
    from mmlspark_tpu_torch import telemetry
    telemetry.enable()
    telemetry.trace.clear()
    try:
        synchronize(torch, dev)
        t0 = time.perf_counter()
        fit()
        synchronize(torch, dev)
        fit_s = time.perf_counter() - t0
        events = telemetry.trace.events()
    finally:
        telemetry.disable()
        telemetry.trace.clear()
    spans = {}
    for ev in events:
        if ev["name"].startswith("gbdt/iter/"):
            one = spans.setdefault(ev["name"], {"count": 0, "s": 0.0})
            one["count"] += 1
            one["s"] += ev["dur"] / 1e6
    return {"fit_s": fit_s, "spans": spans}


def phase_gbdt_parallel(torch, env, dev="cuda", no_group=None):
    """The sharded GBDT builders on one card: a one-rank process group (NCCL
    on the card, over a TCPStore on 127.0.0.1) and ``fit_gbdt`` with a mesh
    over it on the gbdt slice's 1M x 28 rows — level-wise
    ``tree_learner="data"`` (histograms and leaf sums all-reduced) and
    ``"feature"`` (split candidates all-gathered) at the stage's defaults,
    a ``hist_impl="pallas"`` data fit of GBDT_PAR_PALLAS_ITERS iterations,
    and a leaf-wise data fit of 31 leaves. Each ensemble must equal the
    no-group fit's bit for bit (``no_group``: the gbdt and gbdt_leafwise
    phases' states, else fitted here) with the same kernel launches; the
    level-wise data ensemble is scored through row 5 and the leaf-wise one
    through row 6, each once, equal to the no-group ensemble's scores.
    Prints each fit's seconds and, for the data and leaf-wise fits traced
    with telemetry on, the ``gbdt/iter/{grad,build,apply}`` span totals
    beside the traced no-group fit's ``gbdt/iter/step``. Returns the
    launches of the fits and scorings."""
    import socket

    import torch.distributed as tdist
    from mmlspark_tpu_torch import LightGBMClassifier
    from mmlspark_tpu_torch.models.gbdt import engine, stages
    from mmlspark_tpu_torch.parallel import distributed
    from mmlspark_tpu_torch.parallel import mesh as meshlib
    t_phase = time.perf_counter()
    no_group = dict(no_group or {})
    x, y = gbdt_data()
    n = len(x)
    # the gbdt phase's Params (its auto policy is depthwise at 1M rows)
    level = LightGBMClassifier(device=dev).setGrowthPolicy(
        "depthwise")._engine_params("binary", 1, n_rows=n)
    leaf = LightGBMClassifier(device=dev).setGrowthPolicy(
        "leafwise")._engine_params("binary", 1, n_rows=n)
    pallas_iters = GBDT_PAR_PALLAS_ITERS
    gbdt_keys = ("node_hist", "fused", "predict", "predict_lw")

    def only(**want):
        return {**dict.fromkeys(gbdt_keys, 0), **want}
    # name -> (params, the no-group state's key, the launches of one fit)
    fits = {"data": (level, "levelwise",
                     only(node_hist=GBDT_TREES * GBDT_DEPTH)),
            "feature": (level._replace(tree_learner="feature"), "levelwise",
                        only(node_hist=GBDT_TREES * GBDT_DEPTH)),
            "pallas": (level._replace(hist_impl="pallas",
                                      num_iterations=pallas_iters),
                       "pallas", only(fused=pallas_iters * GBDT_DEPTH)),
            "leafwise": (leaf, "leafwise",
                         only(node_hist=GBDT_LEAVES * GBDT_TREES))}
    no_group_s = {}
    for name, (p, key, want) in fits.items():
        if key not in no_group:
            ens, no_group_s[key], got = timed_fit(
                torch, lambda: engine.fit_gbdt(x, y, p, device=dev), dev)
            check_launches(got, want, f"the no-group {name} fit", dev)
            no_group[key] = stages._ensemble_to_state(ens)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    t0 = time.perf_counter()
    distributed.initialize(f"127.0.0.1:{port}", 1, 0, init_timeout=60,
                           device=dev)
    init_s = time.perf_counter() - t0
    out, group_states, launches = {}, {}, dict.fromkeys(gbdt_keys, 0)
    try:
        backend = tdist.get_backend()
        check(backend == ("nccl" if dev == "cuda" else "gloo"),
              f"the group's backend is {backend}")
        mesh = meshlib.create_mesh()
        check(mesh.distributed and mesh.group("data") is not None,
              f"{mesh} has no data group")
        for name, (p, key, want) in fits.items():
            ens, fit_s, got = timed_fit(
                torch, lambda: engine.fit_gbdt(x, y, p, mesh=mesh,
                                               device=dev), dev)
            check_launches(got, want, f"the one-rank {name} fit", dev)
            state = stages._ensemble_to_state(ens)
            check(same_state(state, no_group[key]),
                  f"the one-rank {name} fit differs from the no-group fit")
            group_states[name] = state
            for c in gbdt_keys:
                launches[c] += got[c]
            out[name] = {"tree_learner": p.tree_learner,
                         "hist_impl": p.hist_impl,
                         "iterations": p.num_iterations, "fit_s": fit_s,
                         "no_group_fit_s": no_group_s.get(key),
                         "launches": got, "bit_equal_to_no_group": True}
        for name, kernel in (("data", "predict"), ("leafwise", "predict_lw")):
            ens = stages._state_to_ensemble(group_states[name], "binary",
                                            dev)
            raw, _, got = timed_fit(
                torch, lambda: engine.predict_raw(ens, x), dev)
            check_launches(got, only(**{kernel: 1}),
                           f"scoring the one-rank {name} ensemble", dev)
            launches[kernel] += got[kernel]
            want = engine.predict_raw(stages._state_to_ensemble(
                no_group[fits[name][1]], "binary", dev), x)
            check(np.array_equal(raw, want),
                  f"the one-rank {name} ensemble scores differ")
            out[name]["score_launches"] = got
        for name in ("data", "leafwise"):
            p = fits[name][0]
            group = gbdt_span_totals(torch, lambda: engine.fit_gbdt(
                x, y, p, mesh=mesh, device=dev), dev)
            plain = gbdt_span_totals(torch, lambda: engine.fit_gbdt(
                x, y, p, device=dev), dev)
            check({k: v["count"] for k, v in group["spans"].items()}
                  == dict.fromkeys(("gbdt/iter/grad", "gbdt/iter/build",
                                    "gbdt/iter/apply"), p.num_iterations),
                  f"the one-rank {name} fit's spans {group['spans']}")
            check({k: v["count"] for k, v in plain["spans"].items()}
                  == {"gbdt/iter/step": p.num_iterations},
                  f"the no-group {name} fit's spans {plain['spans']}")
            out[name]["traced"] = {"group": group, "no_group": plain}
    finally:
        distributed.shutdown()
    emit({"phase": "gbdt_parallel", "rows": n, "features": x.shape[1],
          "backend": backend, "init_s": init_s, "fits": out,
          "launches": launches, "gpu": env.gpu_name_and_power_limit(),
          "seconds": time.perf_counter() - t_phase})
    return launches


@contextlib.contextmanager
def captured_coordinators():
    """The ElasticFitCoordinator objects whose recovery loop starts while
    the block runs (a stage makes its own), in start order."""
    from mmlspark_tpu_torch.resilience import elastic
    seen = []
    orig = elastic.ElasticFitCoordinator.run

    def run(self, attempt_fn):
        seen.append(self)
        return orig(self, attempt_fn)
    elastic.ElasticFitCoordinator.run = run
    try:
        yield seen
    finally:
        elastic.ElasticFitCoordinator.run = orig


def gbdt_launches(**want) -> dict:
    """timed_fit's counts of a call that launches ``want`` and nothing
    else."""
    return {**dict.fromkeys(("node_hist", "fused", "predict",
                             "predict_lw"), 0), **want}


def run_with(target, fn, *args):
    """``fn()`` while ``target(*args, done)`` runs on a thread; the thread
    is stopped and joined after."""
    done = threading.Event()
    t = threading.Thread(target=target, args=args + (done,), daemon=True)
    t.start()
    try:
        return fn()
    finally:
        done.set()
        t.join(timeout=10)


def kill_host2_at_step_checkpoint(coords, ck, copies, done):
    """Copy every checkpoint file as it lands (the epoch-final save prunes
    the step ones) and kill host2's beacon once a step checkpoint has."""
    killed = False
    while not done.is_set():
        for f in os.listdir(ck) if os.path.isdir(ck) else []:
            if f.startswith("ckpt_") and f.endswith(".msgpack") \
                    and f not in copies:
                try:
                    with open(os.path.join(ck, f), "rb") as fh:
                        copies[f] = fh.read()
                except OSError:
                    continue
                if not killed and "_s" in f and coords:
                    coords[0].heartbeats["host2"].kill()
                    killed = True
        time.sleep(0.005)


def elastic_train(torch, tmp: str, dev: str) -> dict:
    """(a) The training slice through TorchLearner(elastic=True) over
    ELASTIC_HOSTS simulated hosts of the card, every fit with the same
    async step checkpoints: a non-elastic fit (the feed path), a clean
    elastic fit (the heartbeats' and the step checks' cost: epoch 2's step
    ms), and an elastic fit with host2 killed at the first step checkpoint.
    Each ends on the non-elastic fit's parameters bit for bit; the killed
    fit commits every step, resumes with the digest of the checkpoint file
    it resumed from, and launches rows 1-3 exactly (committed + replayed
    steps) times a step's count, within the clean fit's peak memory."""
    from mmlspark_tpu_torch import DataFrame, TorchLearner
    from mmlspark_tpu_torch.models.downloader import read_flax_msgpack
    from mmlspark_tpu_torch.models.trainer import _params_digest
    from mmlspark_tpu_torch.resilience import elastic, faults
    rng = np.random.default_rng(SEED + 30)
    tokens = rng.integers(0, TRAIN_CFG["vocab_size"],
                          size=(ELASTIC_TRAIN_ROWS, SEQ), dtype=np.int32)
    labels = rng.integers(0, TRAIN_CFG["num_classes"],
                          size=ELASTIC_TRAIN_ROWS, dtype=np.int32)
    df = DataFrame({"tokens": tokens, "label": labels})
    steps = ELASTIC_TRAIN_ROWS // TRAIN_BATCH

    def learner(name, **kw):
        return TorchLearner(featuresCol="tokens", modelConfig=TRAIN_CFG,
                            optimizer="adam", learningRate=1e-3,
                            batchSize=TRAIN_BATCH, epochs=ELASTIC_EPOCHS,
                            seed=SEED, shuffle=False, deviceDataCap=1,
                            checkpointDir=os.path.join(tmp, name),
                            checkpointEverySteps=ELASTIC_CKPT_EVERY,
                            asyncCheckpoint=True, device=dev, **kw)

    def peak_fit(fit):
        # an earlier fit's cyclic garbage would count against this one
        gc.collect()
        synchronize(torch, dev)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        model = fit()
        synchronize(torch, dev)
        peak = (torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda"
                else 0.0)
        return model, peak

    def step_ms(model):
        return model._fit_stats["epoch_seconds"][-1] / steps * 1e3

    plain, plain_peak = peak_fit(lambda: learner("plain").fit(df))
    clean, clean_peak = peak_fit(lambda: learner(
        "clean", elastic=True, elasticHosts=ELASTIC_HOSTS,
        elasticGraceSeconds=ELASTIC_GRACE_S).fit(df))
    check(same_params(clean, plain),
          "the clean elastic fit differs from the non-elastic fit")

    ck = os.path.join(tmp, "killed")
    chaos = learner("killed")
    faults.configure(f"trainer.step:delay:1.0:{ELASTIC_PACE_S}", seed=0)
    copies = {}
    coord = elastic.ElasticFitCoordinator(
        chaos, n_hosts=ELASTIC_HOSTS, grace=ELASTIC_GRACE_S,
        heartbeat_interval=ELASTIC_HB_S)
    at_start, peaks = [], []

    def attempt(devices, ctx):
        # device memory held when each attempt starts (a re-entry must
        # find the failed attempt's state released) and each attempt's
        # peak
        if dev == "cuda":
            at_start.append(torch.cuda.memory_allocated() / 1e9)
            torch.cuda.reset_peak_memory_stats()
        try:
            return chaos._fit(df, elastic_ctx=ctx)
        finally:
            if dev == "cuda":
                torch.cuda.synchronize()
                peaks.append(torch.cuda.max_memory_allocated() / 1e9)
    try:
        (model, killed_peak), launches = counted_call(
            lambda: run_with(kill_host2_at_step_checkpoint,
                             lambda: peak_fit(lambda: coord.run(attempt)),
                             [coord], ck, copies))
    finally:
        faults.clear()
    # the journal's recovery_s is the value the coordinator observes into
    # mmlspark_elastic_recovery_seconds (telemetry stays off: its spans
    # would wait on the stream and change what is compared)
    recovery = [a["recovery_s"] for a in coord.attempts if "recovery_s" in a]
    replayed = sum(a.get("replayed", 0) for a in coord.attempts)
    check(coord.supervisor.dead_hosts() == {"host2"},
          f"dead hosts {coord.supervisor.dead_hosts()}")
    check(len(coord.attempts) >= 2, f"attempts {coord.attempts}")
    check(set(coord.committed) >= {(e, s) for e in range(ELASTIC_EPOCHS)
                                   for s in range(steps)},
          f"committed {coord.committed}")
    final = coord.attempts[-1]
    epoch, step = final["resume_pos"]
    name = (f"ckpt_{epoch:05d}.msgpack" if step is None
            else f"ckpt_{epoch:05d}_s{step:07d}.msgpack")
    check(name in copies and _params_digest(
        read_flax_msgpack(copies[name])["params"])
        == final["resume_digest"],
          f"the resumed params' digest is not {name}'s")
    check(same_params(model, plain),
          "the killed elastic fit differs from the non-elastic fit")
    executed = len(coord.committed)
    check_launches(launches, attention_launches(executed),
                   f"the killed elastic fit ({executed} steps run)", dev)
    check(max(peaks, default=killed_peak) <= clean_peak * 1.05 + 1e-9,
          f"an attempt's peak memory {peaks} GB (whole fit {killed_peak}) "
          f"grew past the clean elastic fit's {clean_peak} GB; allocated "
          f"at each attempt's start {at_start} GB")
    return {"rows": ELASTIC_TRAIN_ROWS, "steps_per_epoch": steps,
            "epochs": ELASTIC_EPOCHS, "hosts": ELASTIC_HOSTS,
            "attempts": [{k: v for k, v in a.items()
                          if k != "resume_digest"} for a in coord.attempts],
            "steps_committed": len(set(coord.committed)),
            "steps_run": executed, "steps_replayed": replayed,
            "recovery_s": recovery, "launches": launches,
            "bit_equal_to_non_elastic": True, "resume_digest_equal": True,
            "step_ms_non_elastic": step_ms(plain),
            "step_ms_elastic_clean": step_ms(clean),
            "peak_gb_non_elastic": plain_peak,
            "peak_gb_elastic_clean": clean_peak,
            "peak_gb_killed": killed_peak, "peak_gb_by_attempt": peaks,
            "allocated_gb_at_attempt_start": at_start}


def elastic_gbdt(torch, tmp: str, no_elastic, dev: str) -> dict:
    """(b) The gbdt phase's level-wise fit through ``elasticConfig`` over
    ELASTIC_HOSTS simulated hosts: a clean run timed against the plain
    stage fit, then host2 killed after 2 iterations. Each ensemble equals
    the no-elastic state bit for bit; the killed fit launches row 4
    exactly (iterations + replayed) x GBDT_DEPTH times, and its ensemble
    scored once through row 5 gives the no-elastic scores."""
    from mmlspark_tpu_torch import DataFrame, LightGBMClassifier
    from mmlspark_tpu_torch.models.gbdt import engine, stages
    from mmlspark_tpu_torch.resilience import faults
    x, y = gbdt_data()
    df = DataFrame({"features": x, "label": y})

    def clf(ck=None):
        kw = {} if ck is None else {"elasticConfig": {
            "checkpointDir": os.path.join(tmp, ck), "hosts": ELASTIC_HOSTS,
            "graceSeconds": ELASTIC_GRACE_S}}
        return LightGBMClassifier(device=dev, growthPolicy="depthwise", **kw)

    plain, plain_s, _ = timed_fit(torch, lambda: clf().fit(df), dev)
    if no_elastic is None:
        no_elastic = plain.getBoosterState()
    check(same_state(plain.getBoosterState(), no_elastic),
          "the plain stage fit differs from the gbdt phase's")
    clean, clean_s, got = timed_fit(torch, lambda: clf("clean").fit(df),
                                    dev)
    check_launches(got, gbdt_launches(node_hist=GBDT_TREES * GBDT_DEPTH),
                   "the clean elastic GBDT fit", dev)
    check(same_state(clean.getBoosterState(), no_elastic),
          "the clean elastic GBDT fit differs from the no-elastic fit")

    def killer(coords, done):
        while not done.is_set():
            if coords and len(coords[0].committed) >= 2:
                coords[0].heartbeats["host2"].kill()
                return
            time.sleep(0.002)

    faults.configure(f"elastic.step:delay:1.0:{ELASTIC_GBDT_PACE_S}",
                     seed=0)
    try:
        with captured_coordinators() as coords:
            model, killed_s, got = timed_fit(
                torch, lambda: run_with(killer, lambda: clf("killed").fit(df),
                                        coords), dev)
    finally:
        faults.clear()
    coord = coords[0]
    check(coord.supervisor.dead_hosts() == {"host2"}
          and len(coord.attempts) >= 2,
          f"the GBDT kill: dead {coord.supervisor.dead_hosts()}, attempts "
          f"{coord.attempts}")
    iters = [it for _e, it in coord.committed]
    check(set(iters) == set(range(GBDT_TREES)),
          f"committed iterations {sorted(set(iters))}")
    check_launches(got, gbdt_launches(node_hist=len(iters) * GBDT_DEPTH),
                   f"the killed elastic GBDT fit ({len(iters)} iterations "
                   f"run)", dev)
    state = model.getBoosterState()
    check(same_state(state, no_elastic),
          "the killed elastic GBDT fit differs from the no-elastic fit")
    ens = stages._state_to_ensemble(state, "binary", dev)
    raw, _, scored = timed_fit(torch, lambda: engine.predict_raw(ens, x),
                               dev)
    check_launches(scored, gbdt_launches(predict=1),
                   "scoring the elastic ensemble", dev)
    want = engine.predict_raw(stages._state_to_ensemble(
        no_elastic, "binary", dev), x)
    check(np.array_equal(raw, want),
          "the elastic ensemble's scores differ from the no-elastic ones")
    return {"rows": len(x), "iterations": GBDT_TREES,
            "hosts": ELASTIC_HOSTS, "attempts": coord.attempts,
            "iterations_run": len(iters),
            "iterations_replayed": len(iters) - GBDT_TREES,
            "launches": {"fit": got["node_hist"],
                         "score": scored["predict"]},
            "bit_equal_to_no_elastic": True,
            "fit_s_plain": plain_s, "fit_s_elastic_clean": clean_s,
            "fit_s_killed": killed_s,
            "pace_s_per_iteration": ELASTIC_GBDT_PACE_S}


def elastic_nccl(torch, tmp: str, dev: str) -> dict:
    """(c) A one-process world through ``elastic_initialize`` (NCCL on the
    card; the launcher contract set for one process): generation 1, an
    elastic fit through the rendezvous-armed path (its attempt on a watched
    thread) bit-equal to the no-group fit; then teardown_for_rendezvous
    (no collective: the communicator is aborted) and generation 2 on the
    same device, whose fit is bit-equal again with no growth of device
    memory."""
    import socket

    import torch.distributed as tdist
    from mmlspark_tpu_torch import DataFrame, TorchLearner
    from mmlspark_tpu_torch.parallel import distributed
    cfg = dict(TRAIN_CFG, layers=PAR_NCCL_LAYERS)
    rng = np.random.default_rng(SEED + 31)
    tokens = rng.integers(0, cfg["vocab_size"], size=(PAR_NCCL_ROWS, SEQ),
                          dtype=np.int32)
    labels = rng.integers(0, cfg["num_classes"], size=PAR_NCCL_ROWS,
                          dtype=np.int32)
    df = DataFrame({"tokens": tokens, "label": labels})

    def learner(**kw):
        return TorchLearner(featuresCol="tokens", modelConfig=cfg,
                            optimizer="adam", learningRate=1e-3,
                            batchSize=TRAIN_BATCH, epochs=1, seed=SEED,
                            shuffle=False, deviceDataCap=1, device=dev, **kw)

    plain = learner().fit(df)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    contract = {"MMLTPU_COORDINATOR": f"127.0.0.1:{port}",
                "MMLTPU_NUM_PROCESSES": "1", "MMLTPU_PROCESS_ID": "0",
                "MMLTPU_HOST_ADDRESS": "127.0.0.1"}
    saved = {k: os.environ.get(k) for k in contract}
    os.environ.update(contract)
    gens, allocated = [], []
    try:
        t0 = time.perf_counter()
        check(distributed.elastic_initialize(os.path.join(tmp, "rdzv"),
                                             device=dev),
              "elastic_initialize did not join a generation")
        init_s = time.perf_counter() - t0
        rdzv = distributed.rendezvous_coordinator()
        check(rdzv.generation == 1, f"generation {rdzv.generation}")
        for gen in (1, 2):
            if gen == 2:
                t0 = time.perf_counter()
                distributed.teardown_for_rendezvous()
                check(not tdist.is_initialized(),
                      "teardown left the process group up")
                rdzv.join(rdzv.propose(["host0"]))
                rejoin_s = time.perf_counter() - t0
                check(rdzv.generation == 2, f"generation {rdzv.generation}")
            backend = tdist.get_backend()
            check(backend == ("nccl" if dev == "cuda" else "gloo"),
                  f"generation {gen}'s backend is {backend}")
            gc.collect()      # the earlier fits' cyclic garbage goes first
            synchronize(torch, dev)
            if dev == "cuda":
                torch.cuda.reset_peak_memory_stats()
            model = learner(checkpointDir=os.path.join(tmp, f"ck{gen}"),
                            elastic=True).fit(df)
            synchronize(torch, dev)
            check(same_params(model, plain),
                  f"generation {gen}'s elastic fit differs from the "
                  f"no-group fit")
            model = None
            gc.collect()
            if dev == "cuda":
                allocated.append(torch.cuda.memory_allocated())
                gens.append(torch.cuda.max_memory_allocated() / 1e9)
            else:
                allocated.append(0)
                gens.append(0.0)
        check(allocated[1] <= allocated[0] and gens[1] <= gens[0] * 1.01,
              f"device memory grew across generations: allocated "
              f"{allocated}, peak GB {gens}")
    finally:
        distributed.teardown_for_rendezvous()
        if distributed._rdzv_coordinator is not None:
            distributed._rdzv_coordinator.heartbeat.stop()
            distributed._rdzv_coordinator = None
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"backend": "nccl" if dev == "cuda" else "gloo",
            "generations": 2, "init_s": init_s, "rejoin_s": rejoin_s,
            "fit_bit_equal": True, "peak_gb_by_generation": gens,
            "allocated_bytes_after_fit": allocated}


def phase_elastic(torch, env, dev="cuda", no_elastic_gbdt=None):
    """resilience/elastic.py on the card: (a) the training slice, (b) the
    GBDT slice (``no_elastic_gbdt``: the gbdt phase's state, else fitted
    here) and (c) a one-process NCCL world over two generations. Returns
    the launches of (a)'s killed fit and (b)'s killed fit and scoring."""
    import tempfile
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.abspath(".")) as tmp:
        t0 = time.perf_counter()
        train = elastic_train(torch, tmp, dev)
        train["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        gbdt = elastic_gbdt(torch, tmp, no_elastic_gbdt, dev)
        gbdt["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        nccl = elastic_nccl(torch, tmp, dev)
        nccl["seconds"] = time.perf_counter() - t0
    emit({"phase": "elastic", "config": TRAIN_CFG, "train": train,
          "gbdt": gbdt, "one_process_world": nccl,
          "gpu": env.gpu_name_and_power_limit(),
          "seconds": time.perf_counter() - t_phase})
    return {"train": train["launches"],
            "node_hist": gbdt["launches"]["fit"],
            "predict": gbdt["launches"]["score"]}


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
          "vision_train", "automl_tabular", "automl_text", "platform",
          "ingest", "serving", "fusion", "parallel", "gbdt_parallel",
          "elastic")
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
    "automl_tabular": phase_automl_tabular,
    "automl_text": phase_automl_text,
    "platform": phase_platform,
    "ingest": phase_ingest,
    "serving": phase_serving,
    "fusion": phase_fusion,
    "parallel": phase_parallel,
    "gbdt_parallel": phase_gbdt_parallel,
    "elastic": phase_elastic,
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
    automl = phase_automl_tabular(torch, env)
    phase_automl_text(torch, env)
    phase_platform(torch, env)
    phase_ingest(torch, env)
    serving = phase_serving(torch, env)
    fusion = phase_fusion(torch, env)
    parallel = phase_parallel(torch, env)
    gbdt_par = phase_gbdt_parallel(
        torch, env, no_group={"levelwise": gbdt["state"],
                              "pallas": gbdt["fused_state"],
                              "leafwise": leafwise["state"]})
    el = phase_elastic(torch, env, no_elastic_gbdt=gbdt["state"])
    hist_by_path = {"fit": gbdt["node_hist"],
                    "fit_leafwise": leafwise["node_hist"],
                    "fit_efb": efb["node_hist"],
                    "automl_fit": automl["node_hist_fit"],
                    "automl_tune": automl["node_hist_tune"],
                    "fit_staged_pipeline": fusion["fit"],
                    "fit_fused": fusion["fit_fused"],
                    "fit_staged_pipeline_leafwise": fusion["fit_leafwise"],
                    "fit_fused_leafwise": fusion["fit_fused_leafwise"],
                    "serve_pipeline_composite": fusion["serve_hist"],
                    "gbdt_parallel": gbdt_par["node_hist"],
                    "gbdt_elastic": el["node_hist"]}
    predict_by_path = {"transform": gbdt["predict"],
                       "automl_transform": automl["predict"],
                       "serve_pipeline": serving["predict"],
                       "transform_fused": fusion["transform_fused"],
                       "transform_staged_pipeline":
                           fusion["transform_staged"],
                       "serve_pipeline_composite": fusion["serve_predict"],
                       "gbdt_parallel": gbdt_par["predict"],
                       "gbdt_elastic": el["predict"]}
    predict_lw_by_path = {"transform_leafwise": leafwise["predict_lw"],
                          "automl_tune": automl["predict_lw"],
                          "transform_fused_split":
                              fusion["transform_fused_split"],
                          "gbdt_parallel": gbdt_par["predict_lw"]}
    csrc = "mmlspark_tpu_torch/ops/csrc/"
    replaces = "mmlspark_tpu/ops/pallas_kernels.py:"
    emit({"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": csrc + "flash_attention_fwd.cu",
         "replaces": replaces + "45", "launches": train["fwd"],
         "launches_by_path": {"serve": serve_launches,
                              "train": train["fwd"],
                              "serve_continuous": serving["fwd"],
                              "transform_graphs":
                                  serving["transform_graphs"],
                              "serve_moe": parallel["serve_moe"]["fwd"],
                              "train_moe": parallel["train_moe"]["fwd"],
                              "train_elastic": el["train"]["fwd"]},
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
         "launches_by_path": {"train": train["dq"],
                              "train_moe": parallel["train_moe"]["dq"],
                              "train_elastic": el["train"]["dq"]},
         "max_abs_err": bwd_worst["dq_abs"], "max_err": bwd_worst["dq"],
         "max_rel_l2_err": bwd_worst["dq_l2"],
         "ms": bwd["dq_ms"], "plain_ms": bwd["plain_ms"],
         "bound_ms": bwd["dq_bound"]["bound_ms"],
         "bound_by": bwd["dq_bound"]["bound_by"],
         "library_ms": bwd["library_ms"]},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": csrc + "flash_attention_bwd.cu",
         "replaces": replaces + "155", "launches": train["dkv"],
         "launches_by_path": {"train": train["dkv"],
                              "train_moe": parallel["train_moe"]["dkv"],
                              "train_elastic": el["train"]["dkv"]},
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
                   sum(predict_by_path.values()), predict_by_path,
                   gbdt_worst["predict"], gbdt_timing["predict"]),
        gbdt_entry("gbdt_predict_quant_leafwise", "gbdt_predict.cu", "622",
                   sum(predict_lw_by_path.values()), predict_lw_by_path,
                   gbdt_worst["predict_lw"], gbdt_timing["predict_lw"]),
        gbdt_entry("histogram_fused", "gbdt_histogram.cu", "769",
                   gbdt["fused"] + gbdt_par["fused"],
                   {"fit_hist_impl_pallas_10_iterations": gbdt["fused"],
                    "gbdt_parallel": gbdt_par["fused"]},
                   gbdt_worst["fused"], gbdt_timing["fused"])]})
    print(env.gpu_name_and_power_limit(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
