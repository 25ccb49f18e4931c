#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of the repository, on a host with one CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each:

1. env     the card (``nvidia-smi``), torch and CUDA versions; TF32 pinned off.
2. build   every kernel of the port built from ``ops/csrc`` with ``nvcc``,
           one compiler process per source, all started together.
3. kernel  each kernel against its plain PyTorch version on the card, at the
           shapes the main paths give it and at edge shapes (flash: GQA,
           ragged non-causal at head dim 64, causal ragged, q/k/v as strided
           views of one packed tensor, f32, and Llama-3-8B's B 1, S 8192,
           32/8 heads; each bf16 row of out within ``BF16_ROW_ULPS`` ulps of
           its largest value as well; fused dense: ragged with 16-byte
           rows, ragged with odd rows; in f32 the ResNet head, split across a
           thread-block cluster, BERT's mlp_in without a split, both on the
           bf16 tensor cores with x and w in three parts each (bound by six
           bf16 passes; the f32 CUDA-core bound beside it), the head's output
           checked bitwise equal over two calls, and a ragged shape on the
           CUDA cores; int8-weight
           dense: BERT's mlp_in with a bf16 and with an f32 x on the bf16
           tensor cores, ragged M and K with 16-byte rows, and a ragged shape
           on the CUDA cores; bound by the design's arithmetic, one bf16
           pass for a bf16 x and three for an f32 x), with the variant
           the launcher reported for the row's launch, its time beside the
           plain version's, the PyTorch library call that computes the same
           function (timed here only as a yardstick; the port never calls
           it) and the bound.  ``kernel_ms``, ``plain_ms`` and ``library_ms``
           are CUDA-event times a call, the host's share included;
           ``device_ms`` and ``library_device_ms`` are the device time alone
           (``torch.profiler``), ``host_ms`` and ``library_host_ms`` the
           host's time to issue one call.
           Then the flash crossover: the kernel against the materialised-
           score attention the model takes below ``FLASH_CROSSOVER_SEQ``, at
           the m435 heads and sequence lengths 512 to 4096 with the tokens
           per call held equal, forward alone and forward plus backward.
4. grad    autograd through ``FlashAttention`` and ``FusedDenseFunction``
           (kernel forward + torch backward) against autograd through the
           plain references.
5. slice   the Llama path: ``examples.llama_train.main`` at the m435
           shape, seq 2048, batch 8, six adamw steps; the launch counters
           are zeroed just before and read just after, and every kernel of
           the path must have launched, each launch in the wgmma variant.  Then one forward with the kernel
           against one with the plain flash forward, on the same weights.
6. learn   six steps on one repeated batch at the same shape must lower the
           loss (the main path's synthetic tokens are uniform over the vocab,
           so its loss starts at the entropy floor and cannot fall); the last
           two steps are profiled by kernel.
6b. moe    ``examples.llama_train.main`` at m435, seq 2048, batch 8, with
           ``--experts 8`` (top-2, capacity factor 1.25, aux weight 0.01),
           six adamw steps: the losses finite, ``moe_aux_loss`` reported, flash
           launched in its wgmma variant as often a step as in ``slice``; step
           time, tokens/s, MFU on the active parameters, peak memory.  Then
           one f32 forward of the MoE model with the kernel (its f32 variant)
           against one with the plain flash forward, on the same weights
           (the logits' largest and mean error gated); one bf16 forward at
           the step's shape, every layer's kernel output (wgmma variant)
           against the plain flash forward on the same q, k, v; two steps
           profiled.
6c. adafactor  ``llama_train.main --size 3b --optimizer adafactor``, seq
           2048, batch 4, four steps: losses finite, flash 2 a block and step;
           the optimizer state's bytes (reckoned) beside AdamW's.
6d. mesh   a one-rank NCCL process group; the m435 step with
           ``strategy="fsdp"`` over ``build_mesh(MeshSpec(fsdp=1))`` (FSDP2:
           every parameter the specs shard a DTensor; the model's tp and sp
           collectives built from the mesh at size 1) for four steps on one
           repeated batch (a loss that falls), against the same steps without
           a mesh: losses and final parameters, beside the numbers a planted
           run that never updates would give, which the limits must catch.
6e. llama_captured  ``multi_step_fn(4)`` of the m435 AdamW step captured as
           one CUDA graph: its losses and final parameters against four eager
           steps from the same state on one repeated batch, held as in
           ``mesh``, then two replays timed, beside the eager step.
7. bert    the BERT path: ``examples.bert_pretrain.main`` at BERT-base, seq
           128, batch 32, ``--use_pallas_mlp``, forty adamw steps; the launch
           counters are zeroed just before and read just after, the
           fused-dense kernel must have launched 24 times a step, all in its
           wgmma variants (ping-pong at mlp_in, 128 x 192 at mlp_out), and
           the loss must fall.  The same run on the plain cuBLAS MLP beside it;
           one forward with the kernel against one with the plain fused
           dense, on the same weights; two steps of each path profiled by
           kernel.
8. serve   the serving path at Llama-3-8B's widths (``LlamaConfig.llama3_8b``),
           random weights drawn on the card from a seed.  In f32 at two
           layers: the ``ContinuousBatchingEngine``'s greedy tokens, one
           request admitted mid-flight, equal to ``generate``'s, and
           teacher-forced paged decode logits within 1e-4 of the forward.
           In bf16 at full depth: one decode step replayed from the engine's
           captured CUDA graph against the eager step on a copy of the pool
           (tokens and pool bytes equal), both timed (device time, events,
           the host's time) beside the step's bound (weights and resident
           K/V over the memory rate) and profiled by kernel; then 16
           requests in one burst on the wall clock through 8 slots, every
           completion its requested length, every page recycled, one
           capture, no kernel of the port launched (the path's attention is
           plain torch, as the JAX package's is plain XLA); decode tokens/s,
           TTFT and inter-token latency, prefill time, memory.
9. resnet  ResNet-50 training at bench.py's configuration: bf16, batch 128,
           224 x 224, uint8 images from a pool of 4 synthetic batches
           normalised in the step, label smoothing 0.1, Nesterov momentum at
           lr 0.1.  In f32, on one batch of one state, the kernel head's
           logits and head gradients against the plain fused dense's.  Then
           the example a user runs, ``examples.resnet_imagenet.main`` at
           ResNet-50, batch 128, 224 x 224, bf16, ``--use_pallas_head``, on
           its own f32 synthetic stream with two prefetch producers: 3 steps
           and one held-out eval batch, the launch counters zeroed just
           before and read just after (one split-K launch a step and one for
           the eval batch).  Then for each head (the f32 fused-dense kernel, and the plain cuBLAS
           product): 2 + 8 eager steps through ``Trainer.fit`` with two
           prefetch producers (the launch counters zeroed just before and
           read just after: the kernel head launches once a step, split-K),
           the loss finite and falling, step time, images/s, MFU (analytic
           FLOPs from ``FlopCounterMode`` over 989 TFLOP/s), memory, the
           pipeline's counters; two steps profiled by kernel;
           ``multi_step_fn(4)`` captured as one CUDA graph, its 4 losses
           against 4 eager steps from the same state, then 3 replays timed
           (a replay launches no wrapper, so the counters show the warm-up
           and the capture only); and ``evaluate`` on 2 held-out batches.

10. checkpoint  save and resume (``train/checkpoint.Checkpointer`` on
           ``torch.distributed.checkpoint``), checkpoints under a temporary
           directory removed at the end.  m435 (seq 2048, batch 8, AdamW,
           full depth) on 8 synthetic batches: 8 steps straight; 4 steps, a
           synchronous save, then in a fresh trainer from another seed a
           restore (every tensor of the state bitwise the saved one: no
           weight moved on the way in) and the straight run's batches 5-8:
           losses and the whole final state bitwise the straight run's, the
           flash kernel launched 2 a block and step; a planted control (the
           model restored, the optimizer fresh) that must land past
           ``PARAM_GAP_MAX``.  The saving run goes on through ``fit`` with
           async saves every 2 steps (steps 7 and 8 update the state in
           place while step 6 is written): each checkpoint bitwise the
           parameters of its step, the losses the straight run's; bytes,
           save, staging, restore and write times, the steps' times with
           and without the saves.  ResNet-50 at the ``resnet`` phase's
           configuration, the kernel head, cuDNN deterministic: 2 + 2 steps
           across a restore bitwise 4 straight (losses, parameters, BatchNorm
           statistics, momentum traces), the f32 fused dense launched once a
           resumed step; ``multi_step_fn(2)`` captured on one state, a
           restore into it, a replay: equal to eager steps from the restored
           state.  Then ``examples.llama_train.main`` (m435) and
           ``examples.resnet_imagenet.main`` (ResNet-50, kernel head), each
           run twice with ``--checkpoint_dir``: the second resumes at the
           first's last step.
11. detection  RetinaNet-R50-FPN with the prototype-mask head at the JAX
           configuration's widths (ResNet-50, FPN 256, 80 classes, 9 anchors
           a cell, 16 prototypes), 256 px (12,276 anchors), max_boxes 10, on
           the synthetic detection stream.  ``detection_parity``: the f32
           forward on the card against the same weights on the CPU at batch
           2 (every BatchNorm's variables drawn at random), the largest and
           mean error of the class logits, box deltas, coefficients and
           prototypes gated; then ``predict`` on the card against ``predict``
           on the CPU on the same head outputs (classes and valid slots
           equal, scores within 1e-6, boxes within a few f32 ulps).  ``detection``:
           bf16, batch 32, momentum lr 0.01, clip 10, 2 + 8 steps through
           ``fit`` (a readback each step): step time, images/s, MFU
           (``FlopCounterMode`` FLOPs over the card's bf16 peak), peak memory,
           the four loss terms finite with ``num_pos`` and ``mask_slots`` over
           0; a ``profile`` line.  ``detection_learn``: 20 steps on one
           repeated batch, the loss below 0.7 of its start.
           ``detection_eval``: ``predict`` and ``DetectionAccumulator`` over 2
           held-out batches (mAP and mask mAP gate nothing).
           ``detection_example``: a ResNet-50 classifier saved by one
           ``resnet_imagenet`` step, then ``examples.detection_train.main
           --masks --backbone_ckpt`` (3 steps, one eval batch, batch 8): every
           backbone tensor transferred, the losses finite.
12. cifar10  ``examples.cifar10_train.main`` (VGG-11, batch 64, 20 steps, 2
           eval batches) and ``examples.lenet_mnist.main`` (20 steps): step
           time and images/s, the losses finite.
13. records  the record-backed input plane, sources written from seeds under
           a temporary directory (removed at the end) and converted by the
           port's ``cli convert``; every run's loaders must be the native
           loader (``train/native_loader.py``, built by ``g++`` from
           ``native/dataloader``), its launch counters zeroed just before and
           read just after.  ``records_resnet``: 1,024 JPEGs of 16 classes
           converted with ``--format imagefolder --margin 32`` (stored at 256
           px) and 256 at 224 px as ``val``; ``examples.resnet_imagenet.main``
           at ResNet-50, bf16, batch 128, ``--use_pallas_head``,
           ``--augment_crop --augment_flip`` (the 224-px window and the flip
           on the card), two prefetch producers, 10 steps under
           ``--profile``, then ``--full_eval`` over the whole val split: step
           time, images/s, MFU, the ``data_wait`` and ``h2d`` shares of the
           step (over the run, from the profile; and steady, the medians of
           the journaled per-step breakdowns over steps 2..10), the
           prefetcher's counters, 256 held-out records scored, the f32 dense
           once a step and once an eval batch (split-K).
           ``records_llama``: the tree's own ``deeplearning_cfn_tpu/**/*.py``
           (sorted, one text) converted byte-level at seq 2048, m435, batch
           8, 8 steps: the mean of the last two losses below the first, flash
           2 a block and step (wgmma).  ``records_bert``: the same text at
           seq 128, BERT-base ``--use_pallas_mlp``, batch 32, 20 steps at lr
           1e-4: 24 fused-dense launches a step (wgmma), mask id 257.
           ``records_small``: VGG-11 on converted CIFAR-10 pickles with
           ``--eval_data_dir --full_eval`` (256 held out), and
           ``detection_train --masks`` on 64 ``instance_spec(256, 10)``
           records for 4 steps: finite losses, no kernel launched.
14. llama8b  Llama-3-8B (``LlamaConfig.llama3_8b``: untied, 32 q and 8 kv
           heads, full remat a layer) on one card; the flash kernel's row at
           its shape is phase 3's.  ``llama_memory.validate_on_device`` (batch 1, seq 8192, two
           adafactor steps): the peak at or below ``memory_report``'s
           prediction.  The main path: ``examples.llama_train.main --size 8b
           --optimizer adafactor --seq_len 8192 --global_batch_size 2
           --grad_accum 2 --steps 3`` (JAX's memory-lean program, batch 8
           with accumulation 8, cut to 2 and 2: the same microbatch), the
           counters zeroed just before: the losses finite, the peak at or
           below the prediction and the error printed, flash launched
           2 x 32 x 2 x 3 = 384 times in its wgmma variant; step time,
           tokens/s, MFU; one more step profiled by kernel.  An HF-layout
           state dict at
           ``expected_hf_shapes(llama3_8b)`` drawn in bf16 on the card from
           seeds through ``llama_import.from_hf_state_dict``: every tensor
           its source transposed, the source dict emptied, the peak within
           1.1 x (one model + its largest tensor).  ``TrainerConfig.remat``
           off, on (nested over the preset's "dots" remat a block) and on
           without the block remat, one m435 step each: the gradients
           agree, and the peak with remat on is at most the peak without.

15. pp_layout  JAX's stage-stacked m435 (``pp_stages`` 2, ``pp_microbatches``
           4): weights drawn on the card from a seed, laid out as the JAX
           tree (``[pp, L/pp, ...]`` by ``parallel.pipeline.stack_stages``) and
           carried into the model through ``interop``.  One rank has no pp
           axis, so the stage-stacked model runs its 24 layers in sequence
           (JAX's fallback; the whole batch is the one microbatch): its
           logits and 4 AdamW steps on one repeated batch bitwise those of
           the unstaged model on the same weights, flash 2 a block and step.
           GPipe across ranks needs send/recv, which gloo refuses for CUDA
           tensors (``tools/gloo_cuda_probe.py``): it runs on CPU gloo ranks
           (``tests/test_torch_pipeline.py``).
16. two_ranks  two processes of this script on the one card, a gloo group
           over CUDA tensors (host-staged), ``DEEPLEARNING_SLICES_COUNT=2``:
           the mesh is ``hybrid_mesh_for_slices(2)``, dp 2 over the "DCN"
           axis.  m435, seq 2048, batch 8 a rank, 4 AdamW steps on the same
           batches each: hookless DDP; ``comms_overlap`` (f32 buckets),
           bitwise the hookless run (losses and parameters); a planted
           control (the bucketed run with its first bucket left unsynced),
           which the bitwise check must fail; ``overlap_compress`` (int8 with
           error feedback), its losses within ``INT8_RTOL``/``INT8_ATOL`` of
           the f32 run's.  Step ms (gloo, host-staged: not NVLink times),
           bytes a rank sends a step, each process's peak memory, flash 2 a
           block and step in every run.
17. mesh_captured  ``multi_step_fn(4)`` of the m435 step with ``strategy
           "fsdp"`` over ``build_mesh(MeshSpec(fsdp=1))`` on a one-rank NCCL
           group (the ``mesh`` phase's mesh; FSDP2's collectives in the
           graph): its losses and parameters bitwise four eager steps over
           that mesh, with the planted no-update control, then replays
           timed.  (DDP does not capture: ``tools/gloo_cuda_probe.py``.)

The f32 fused-dense rows and the int8-weight rows with an f32 x also hold
the kernel and f32 ``addmm`` (TF32 off; for the int8 kernel on the
dequantised weight) against the float64 product, and the tensor-core
variants must be within twice ``addmm``'s error.
The variants are read from the launch counters, which count each launch
under the variant its C launcher reports.
The flash row of the kernels line counts the launches of every Llama path
(``slice``, ``moe``, ``adafactor``, ``mesh``, ``llama_captured``, the resumed
m435 run of ``checkpoint``, the m435 run of ``records``, the 8B run of
``llama8b``, ``pp_layout``, both processes' runs of ``two_ranks`` and
``mesh_captured``; by path in ``launches_by_path``), each counted from zero just
before its run, with the 8B shape's row beside it (``llama8b_shape``); the bf16
fused dense's row those of the ``bert`` and ``records`` runs; the f32 fused
dense's those of the ``resnet`` phase's eager kernel-head run, the resumed
ResNet-50 run of ``checkpoint`` and the ResNet-50 run of ``records``.  The
``detection`` and ``cifar10`` phases launch no kernel of the port (the JAX
models they port are plain XLA): each kernel's ``launches_by_path`` reports
them as 0, and a launch there fails the run.
Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power
limit, and last ``{"ok": true, "device": {...}}``.  Any failed check raises,
and the script exits non-zero without the last line; with no CUDA card, or
outside the repository, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import pickle
import statistics
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

STEPS = 6
SLICE_ARGS = [
    "--size", "435m", "--seq_len", "2048", "--global_batch_size", "8",
    "--steps", str(STEPS), "--log_every", "1", "--optimizer", "adamw",
    "--weight_decay", "0.1", "--device", "cuda",
]
# Tolerances, kernel against its plain version on the same inputs:
# bf16 out: both round p to bf16 for p @ v, at different blockings (the
# kernel's running max moves every 64 keys, the reference's every 512), and
# round out to bf16, so they may differ by two bf16 ulps of |out| <= 1.
BF16_OUT_ATOL = 2e-2
# ... and, since |out| shrinks as the keys grow (about sqrt(e/n) over n keys
# of random scores: 0.018 at n = 8192, near BF16_OUT_ATOL itself), each bf16
# row (its D values) within BF16_ROW_ULPS ulps of its own largest |value|:
# the two sides' p roundings give under one, their out roundings one more.
BF16_ROW_ULPS = 4
# lse and f32 out: f32 sums of up to 2048 terms in another order, and
# another exp/log.
LSE_ATOL = 1e-3
F32_OUT_ATOL = 1e-5
# f32 gradients through the torch backward: the same backward on forwards
# that differ by f32 rounding.
F32_GRAD_ATOL = 1e-4
# Fused dense against its plain version (an f32 product of the same stored
# values): bf16 out, both round an f32 sum of the same products, taken in
# another order, so an output next to a rounding boundary may land one bf16
# ulp apart (2**-7 relative covers one ulp in any binade).  f32 out: two f32
# sums of up to 2048 terms in another order, each within a few 1e-6 of the
# float64 product on O(1) outputs (the f32 rows print both errors).
DENSE_TOL = {"bfloat16": (2**-7, 1e-5), "float32": (1e-5, 1e-5)}  # (rtol, atol)
# The int8-weight dense: as the fused dense (with an f32 x, each K chunk's
# products are summed apart and added on the CUDA cores, so it sums as an f32
# product does; its f32 rows print the float64 errors beside addmm's).
QUANT_TOL = {"bfloat16": DENSE_TOL["bfloat16"], "float32": DENSE_TOL["float32"]}
# Gradients through FusedDenseFunction, kernel forward against plain forward:
# the same torch backward on forwards that differ by f32 rounding, and dw
# sums 512 products of the gelu derivative at those forwards: 1e-4 in f32.
GRAD_TOL = {"bfloat16": DENSE_TOL["bfloat16"], "float32": (1e-4, 1e-4)}
# Logits of the m435 model, kernel path against the plain flash forward:
# each layer's attention output differs by up to two bf16 ulps, carried
# through 24 residual layers into bf16 logits of magnitude about 1 at random
# init (ulp 2**-7), so a max of 8 ulps and a mean of 1e-2.
LOGITS_MAX_ATOL = 0.0625
LOGITS_MEAN_ATOL = 1e-2
BERT_STEPS = 40
BERT_BATCH, BERT_SEQ = 32, 128
BERT_ARGS = [
    "--seq_len", str(BERT_SEQ), "--global_batch_size", str(BERT_BATCH),
    "--steps", str(BERT_STEPS), "--log_every", "1", "--device", "cuda",
]
# BERT-base logits, fused-dense kernel against the plain fused dense: each
# MLP output may differ by one bf16 ulp where its f32 sum lies next to a
# rounding boundary, carried through 12 layers into bf16 logits of magnitude
# below 8 at random init (ulp at most 2**-5): a max of four ulps there, and a
# mean of 1e-2.
BERT_LOGITS_MAX_ATOL = 0.125
BERT_LOGITS_MEAN_ATOL = 1e-2
# The f32 fused dense's variants: split across a cluster, and not.
F32_SPLITK = "wgmma_tma_bf16x6_splitk_128x192"
F32_COOP = "wgmma_tma_bf16x6_128x192"
# Flash crossover: sequence lengths at the m435 heads, tokens per call held
# at the Llama path's batch 8 x seq 2048.
CROSSOVER_SEQS = (512, 1024, 2048, 4096)
CROSSOVER_TOKENS = 8 * 2048
# Serving: Llama-3-8B at full width and depth, bf16, random weights from a
# seed; 8 slots of 64 pages of 16 tokens (a 512-page pool, 1 GiB), prompts
# padded to 512; 16 requests in one burst, so 8 run and 8 queue.
SERVE_SLOTS = dict(num_slots=8, block_size=16, blocks_per_slot=64, prefill_len=512)
SERVE_TRAFFIC = dict(requests=16, seed=0, prompt_len_range=(128, 512),
                     output_len_range=(64, 256))
# The f32 parity check at 8B widths: two layers, two 64-token prompts, 32 new
# tokens each (max_context = 64 + 32, generate's extent).  Teacher-forced
# paged decode logits against Llama.forward: f32 sums of up to 14336 terms in
# another order through two layers, on logits of O(1), a few 1e-6; 1e-4.
PARITY_LAYERS, PARITY_PROMPT, PARITY_NEW = 2, 64, 32
SERVE_LOGITS_ATOL = 1e-4
# ResNet-50, bench.py's training configuration: bf16, batch 128, 224 x 224,
# uint8 images from a pool of 4 synthetic batches normalised in the step,
# label smoothing 0.1, Nesterov momentum at lr 0.1; 2 + 8 eager steps a head,
# multi_step_fn(4) captured and replayed 3 times a head.
RESNET_BATCH, RESNET_IMAGE, RESNET_POOL = 128, 224, 4
RESNET_WARMUP, RESNET_STEPS = 2, 8
RESNET_K, RESNET_REPLAYS = 4, 3
RESNET_EXAMPLE_STEPS = 3
# Captured steps against eager ones from the same state: the same kernels on
# the same inputs, but cuDNN's backward may sum in another order from run to
# run (atomics), so the losses agree to 1e-3 relative, not always bitwise.
RESNET_CAPTURE_RTOL = 1e-3
# The parallelism slice's Llama paths (phases 6b-6e).  moe: the m435 shape at
# full depth and width with 8 experts (JAX's defaults: top-2, capacity factor
# 1.25, aux weight 0.01); adafactor: the 3b rung; mesh: MeshSpec(fsdp=1) on a
# one-rank NCCL group against the same steps without a mesh; llama_captured:
# multi_step_fn(LLAMA_K) of the m435 AdamW step against as many eager steps.
MOE_STEPS = 6
MOE_ARGS = SLICE_ARGS[:SLICE_ARGS.index("--steps")] + [
    "--steps", str(MOE_STEPS), "--log_every", "1", "--experts", "8", "--device", "cuda"]
ADAFACTOR_STEPS = 4
ADAFACTOR_ARGS = ["--size", "3b", "--optimizer", "adafactor", "--seq_len", "2048",
                  "--global_batch_size", "4", "--steps", str(ADAFACTOR_STEPS), "--log_every", "1",
                  "--device", "cuda"]
MESH_STEPS = 4
LLAMA_K, LLAMA_REPLAYS = 4, 2
# The MoE path's attention, kernel against plain: every layer's flash call
# in one bf16 forward of the MoE model at the step's shape (batch 8, seq
# 2048, the wgmma variant) is recorded, and the plain flash forward runs on
# the recorded q, k, v.  Routing never enters: the inputs are the same.  The
# kernel rows hold outputs of |out| <= 1 at BF16_OUT_ATOL, two bf16 ulps
# there; down the residual stream the outputs grow (past 4 in later layers)
# and their ulps with them, so each layer is held at BF16_OUT_ATOL times its
# largest |out| (when above 1): the same two ulps, at that layer's scale.
# MoE logits, kernel path against the plain flash forward, in f32 (the
# kernel's f32 variant), batch 2: in f32 each layer's attention output agrees
# to a few 1e-7 and the logits, of O(1), to 2.1e-6 at most and 2.4e-7 on
# the mean (H100, 700 W).  A routing flip (a token whose two best experts'
# scores lie within that rounding of each other) would move that token's
# logits by O(0.1); at these seeds none happens, and the run is deterministic,
# so the limits sit ten and four times above the readings and a flip fails.
MOE_LOGITS_ATOL, MOE_LOGITS_MEAN_ATOL = 2e-5, 1e-6
# The mesh run against the unsharded run, and the captured steps against
# eager ones, on one repeated batch, whose loss falls (10.39 to 9.87 in four
# steps), so a run that never updates shows: its losses sit 5.2e-2 from the
# sound run's, and its parameters a whole run's travel (a gap of 1.0 below).
# Losses: relative; parameters: the worst parameter's
# ||p_a - p_b|| / ||p_b - p_0||, the gap over the distance travelled.  Sound
# runs differ only by rounding: both pairs were bitwise equal (H100, 700 W),
# but the backward may sum in another order from run to run (captured losses
# 1.9e-6 apart on uniform tokens), and a bf16 weight near 0.03 takes steps of
# ~2.5 ulps, so one rounding flip moves an element by ~40% of its step: an
# AdamW that rounded differently on one side gave losses 2.0e-5 and a
# parameter gap of 0.049 apart.  The limits sit five and four times above
# that, and the planted no-update run past them by NO_UPDATE_MARGIN at least.
MESH_LOSS_RTOL = 1e-4
LLAMA_CAPTURE_RTOL = 1e-4
PARAM_GAP_MAX = 0.2
NO_UPDATE_MARGIN = 4
# Checkpoint and resume (phase 10): the m435 AdamW run over CKPT_STEPS
# batches, saved at half of them; every checkpoint is written under a
# temporary directory, which must have CKPT_DISK_BYTES free (at most three
# m435 checkpoints of ~2.6 GB at once, one of them in flight).
CKPT_STEPS, CKPT_EXAMPLE_STEPS = 8, 2
CKPT_DISK_BYTES = 10 * 10**9
# Detection (phase 11): the JAX RetinaNet configuration at full width --
# ResNet-50, FPN 256, 80 classes, 9 anchors a cell, 16 prototypes, masks,
# bf16 -- at the JAX example's 256 px (12,276 anchors), max_boxes 10, batch
# 32, momentum lr 0.01, clip 10.  Parity: the f32 forward on the card against
# the same weights on the CPU at batch 2, eval mode, every BatchNorm's
# variables drawn at random.  cuDNN and the CPU sum the convolutions in
# other orders (TF32 off), so each output is held at DET_PARITY_RTOL of its
# largest entry (at most) and DET_PARITY_MEAN_RTOL of it (on the mean).
# predict on the card against predict on the CPU on the CPU's head outputs:
# classes and valid slots equal, scores within 1e-6, boxes within DET_BOX_RTOL
# of their coordinate and DET_BOX_ATOL px (decoded through exp, which the
# card and the CPU may round differently in the last place; decoded boxes
# reach past the image, to ~2,000 px, where an f32 ulp is 1.2e-4).
DET_ARCH = dict(num_classes=80, backbone_stages=(3, 4, 6, 3), fpn_channels=256,
                with_masks=True, num_prototypes=16)
DET_BATCH, DET_IMAGE, DET_MAX_BOXES = 32, 256, 10
DET_WARMUP, DET_STEPS, DET_LEARN_STEPS, DET_EVAL_BATCHES = 2, 8, 20, 2
DET_PARITY_RTOL, DET_PARITY_MEAN_RTOL = 1e-3, 1e-5
DET_SCORE_ATOL, DET_BOX_RTOL, DET_BOX_ATOL = 1e-6, 2e-6, 1e-4
DET_LEARN_RATIO = 0.7
DET_EXAMPLE_ARGS = ["--masks", "--steps", "3", "--eval_steps", "1", "--global_batch_size", "8",
                    "--log_every", "1", "--device", "cuda"]
# CIFAR (phase 12): cifar10_train at VGG-11, batch 64, 20 steps, 2 eval
# batches; lenet_mnist for 20 steps.
CIFAR_ARGS = ["--model", "vgg11", "--global_batch_size", "64", "--steps", "20",
              "--eval_steps", "2", "--log_every", "1", "--device", "cuda"]
LENET_ARGS = ["--steps", "20", "--log_every", "1", "--device", "cuda"]
# Records (phase 13): sources written from seeds under a temporary directory,
# converted by the port's converters, trained through the examples.
# a. ImageNet-layout JPEGs of REC_CLASSES classes (class-dependent blocks plus
# noise), REC_SRC_PX square: 1,024 for training, stored at 224 + 32 px; 256
# held out at 224 px.  ResNet-50 as the resnet phase's, from the records.
REC_CLASSES, REC_TRAIN_PER_CLASS, REC_VAL_PER_CLASS, REC_SRC_PX = 16, 64, 16, 288
REC_MARGIN, REC_RESNET_STEPS = 32, 10
REC_RESNET_ARGS = ["--depth", "50", "--global_batch_size", str(RESNET_BATCH), "--image_size",
                   str(RESNET_IMAGE), "--steps", str(REC_RESNET_STEPS), "--log_every", "1",
                   "--augment_crop", "--augment_flip", "--use_pallas_head", "--eval_steps", "1",
                   "--full_eval", "--prefetch_workers", "2", "--profile", "--device", "cuda"]
# b. The tree's own deeplearning_cfn_tpu/**/*.py, sorted by path, one text,
# byte-level at seq 2048: m435, batch 8, 8 adamw steps.  c. The same text at
# seq 128: BERT-base with the kernel MLP, batch 32, 20 steps at lr 1e-4.
REC_LLAMA_STEPS, REC_BERT_STEPS = 8, 20
REC_LLAMA_ARGS = ["--size", "435m", "--seq_len", "2048", "--global_batch_size", "8", "--steps",
                  str(REC_LLAMA_STEPS), "--log_every", "1", "--device", "cuda"]
REC_BERT_ARGS = ["--use_pallas_mlp", "--seq_len", str(BERT_SEQ), "--global_batch_size",
                 str(BERT_BATCH), "--steps", str(REC_BERT_STEPS), "--learning_rate", "1e-4",
                 "--log_every", "1", "--device", "cuda"]
# d. CIFAR-10 pickles in the public layout (two data batches of 640, a test
# batch of 256) for VGG-11; 64 detection records of instance_spec(256, 10).
REC_CIFAR_PER_BATCH, REC_CIFAR_TEST, REC_DET_RECORDS, REC_DET_STEPS = 640, 256, 64, 4

# Llama-3-8B (phase 14): JAX's memory-lean single-chip program (adafactor,
# seq 8192, full remat a layer) with batch 2 and accumulation 2 in place of 8
# and 8: the same microbatch, so the same peak.
L8B_SEQ, L8B_BATCH, L8B_ACCUM, L8B_STEPS, L8B_VALIDATE_STEPS = 8192, 2, 2, 3, 2
L8B_ARGS = ["--size", "8b", "--optimizer", "adafactor", "--seq_len", str(L8B_SEQ),
            "--global_batch_size", str(L8B_BATCH), "--grad_accum", str(L8B_ACCUM), "--steps",
            str(L8B_STEPS), "--log_every", "1", "--device", "cuda"]
# The import's peak: one model plus its largest tensor, with this margin.
IMPORT_PEAK_MARGIN = 1.1
# remat on against off, one m435 step (bf16; the recomputation repeats the
# same kernels on the same inputs): the gradients' largest difference over
# the tensor's largest value.
REMAT_GRAD_RTOL = 1e-2

# The rest of the parallelism slice (phases 15-17), m435 at seq 2048.
# pp_layout: JAX's stage-stacked m435 at 2 stages and 4 microbatches.
PP_STAGES, PP_MICROBATCHES, PP_STEPS, PP_BATCH = 2, 4, 4, 8
# two_ranks: two processes on the one card, a gloo group, per-rank batch 8.
TWO_RANK_BATCH, TWO_RANK_STEPS, TWO_RANK_TIMEOUT = 8, 4, 600
# JAX's test_int8_error_feedback_tracks_the_f32_curve.
INT8_RTOL, INT8_ATOL = 5e-3, 1e-3
# mesh_captured: multi_step_fn(MESH_K) over the mesh phase's one-rank mesh.
MESH_K, MESH_REPLAYS = 4, 2


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _row_ulps(torch, out, ref) -> float:
    """The largest error of ``out`` against ``ref`` in each row (the last
    dim), in bf16 ulps of that row's largest ``|ref|``; the worst row's."""
    ref = ref.float()
    err = (out.float() - ref).abs().amax(-1)
    top = ref.abs().amax(-1).clamp_min(2.0**-126)
    return (err / torch.exp2(torch.floor(torch.log2(top)) - 7)).max().item()


def _time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Device time of one call of ``fn``: the summed time of the kernels and
    copies it ran on the card (``torch.profiler``), over ``iters`` calls.
    The host's time between launches (Python, the wrapper, ctypes) is not in
    it; :func:`_time_ms` has it.  A trace without device time fails the run
    (the kernel rows are taken in phase 3, before the long phases)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0 and not getattr(e, "is_user_annotation", False))
    _require(total_us > 0, "the profiler saw no device time")
    return total_us / 1e3 / iters


def _variants(counts: dict, kernel: str) -> dict:
    """Launches of ``kernel`` by variant, from the launch counters."""
    return {k.split("/", 1)[1]: n for k, n in counts.items() if k.startswith(kernel + "/")}


def _launched_variant(kernels_mod, kernel: str, call):
    """Run ``call`` (one launch of ``kernel``) with the counters zeroed and
    return its result and the variant the launcher reported."""
    kernels_mod.reset_launch_counts()
    result = call()
    launched = _variants(kernels_mod.launch_counts, kernel)
    _require(list(launched.values()) == [1], f"{kernel}: one launch expected, got {launched}")
    return result, next(iter(launched))


def _host_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Host time of one call of ``fn``: the wall time to issue ``iters``
    calls back to back, without waiting for the card (its launch queue holds
    far more than ``iters`` launches), then a wait for it to catch up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return host_ms


def _attention_work(B, Sq, Sk, Hq, Hkv, D, causal, elt) -> tuple[float, float]:
    """(operations, bytes) one flash forward must do and move: two products
    per valid (query, key) pair, 2*D operations each; q, k, v read once,
    out and lse written once."""
    pairs = sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk
    flops = 4.0 * B * Hq * D * pairs
    nbytes = elt * (2 * B * Sq * Hq * D + 2 * B * Sk * Hkv * D) + 4 * B * Hq * Sq
    return flops, nbytes


def _dense_work(M, K, N, x_bytes, w_bytes, peak_ops, peak_bw) -> dict:
    """The bound of one fused dense: 2*M*N*K operations at ``peak_ops``
    against x, w, the bias (and the int8 path's f32 scale) read once and the
    output written once."""
    flops = 2.0 * M * N * K
    nbytes = x_bytes * (M * K + N + M * N) + w_bytes * K * N + (4 * N if w_bytes == 1 else 0)
    t_ops, t_bytes = flops / peak_ops * 1e3, nbytes / peak_bw * 1e3
    return {"gflop": flops / 1e9, "mbytes": nbytes / 1e6, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _profile(torch, step, n: int) -> dict:
    """Run ``step()`` ``n`` times under the profiler: device time per step
    by kernel name, the wall time per step, and the idle share."""
    torch.cuda.synchronize()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    prof.stop()
    # Device time of kernels and copies; a user annotation (such as the
    # optimizer's "Optimizer.step#AdamW.step" range) spans kernels already counted.
    kernels = [(e.key, e.self_device_time_total / 1e3 / n, e.count // n)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    kernels.sort(key=lambda r: -r[1])
    device_ms = sum(ms for _, ms, _ in kernels)
    return {"steps": n, "wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
            "idle_share": 1 - device_ms / wall_ms if device_ms else None,
            "top": [{"name": k[:120], "ms_per_step": ms, "calls_per_step": c}
                    for k, ms, c in kernels[:25]]}


def _run_summary(result, batch: int, tokens: int) -> dict:
    """Steady step time (median over steps 2..), rate and MFU of a training run."""
    steady = result["history"][1:]  # the first step includes one-time set-up
    rate = statistics.median(h["examples_per_sec"] for h in steady)
    return {"losses": [h["loss"] for h in result["history"]],
            "step_ms": [batch / h["examples_per_sec"] * 1e3 for h in result["history"]],
            "steady_step_ms": batch / rate * 1e3, "examples_per_s": rate,
            "tokens_per_s": rate * tokens / batch,
            "mfu": statistics.median(h["mfu"] for h in steady),
            "first_step_s": result["first_step_s"], "params": result["params"]}


def _llama_on_card(torch, llama, cfg, seed: int):
    """The port's Llama with random weights drawn on the card: built on the
    meta device, then every matrix filled with normal / sqrt(fan_in), as
    ``init_model`` draws them on the CPU, from a seeded CUDA generator, and
    the norms with ones.  (At 8B, ``init_model`` would take some 8e9 draws
    on the host.)"""
    with torch.device("meta"):
        model = llama.Llama(cfg)
    model = model.to_empty(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if pname.endswith("norm"):
                p.fill_(1.0)
            else:  # the fan-in: [in, out] matrices, [E, in, out] expert banks
                p.normal_(generator=gen).mul_(p.shape[-2] ** -0.5)
    return model


def _flash_check(launches: dict, steps: int, per_step: float, what: str) -> dict:
    """Flash launches of a Llama run: every one in the wgmma variant, at
    ``per_step`` a step (the ``slice`` phase's count a block and step — one
    forward and one remat recompute — times the run's blocks)."""
    n = launches.get("flash_attention_fwd", 0)
    variants = _variants(launches, "flash_attention_fwd")
    _require(variants == {"wgmma_tma": n} and n > 0,
             f"{what}: the Llama path launched flash variants {variants}")
    _require(n == per_step * steps, f"{what}: flash launched {n} times in {steps} steps, "
             f"expected {per_step} a step")
    return {"flash_launches": n, "flash_launches_per_step": n / steps, "flash_variants": variants}


def _adafactor_state_bytes(llama, optimizers, cfg, elt: int = 2) -> int:
    """The Adafactor state of ``cfg``'s JAX leaves, in the parameter dtype:
    row plus column means for a factored leaf (per layer when stacked),
    the full second moment otherwise."""
    leaves = [(cfg.vocab_size, cfg.dim), (cfg.dim,)]
    leaves += [(cfg.n_layers, *shape) for shape in llama.layer_param_shapes(cfg).values()]
    total = 0
    for shape in leaves:
        dims = optimizers.factored_dims(shape)
        n = math.prod(shape)
        total += n if dims is None else n // shape[dims[1]] + n // shape[dims[0]]
    return total * elt


def _param_copy(model) -> dict:
    """Each parameter's local values (a DTensor's shard: the whole tensor on
    one rank), copied."""
    from deeplearning_cfn_tpu_torch.train.optimizers import local_part

    return {n: local_part(p).detach().clone() for n, p in model.named_parameters()}


def _param_gap(a: dict, b: dict, p0: dict) -> dict:
    """The worst parameter's ``||a - b|| / ||b - p0||``, the gap between two
    runs from ``p0`` over the distance run ``b`` travelled: 0 for equal
    runs, 1 for a run ``a`` that never moved."""
    gaps = {}
    for n in b:
        gap = (a[n].float() - b[n].float()).norm().item()
        travelled = (b[n].float() - p0[n].float()).norm().item()
        gaps[n] = gap / travelled if travelled else (0.0 if gap == 0 else math.inf)
    worst = max(gaps, key=gaps.get)
    return {"param_gap_max": gaps[worst], "param_gap_worst": worst,
            "param_gap_median": statistics.median(gaps.values())}


def _held_runs(losses: list, ref_losses: list, gap: dict, p0_gap: dict, rtol: float) -> dict:
    """A run's losses and parameter ``gap`` against the reference run's, and
    the same numbers for a planted run that never updates: its losses all
    the reference's first, its parameters ``p0`` (``p0_gap``)."""
    return {"max_rel_loss_diff": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
            "rtol": rtol, **gap, "param_gap_limit": PARAM_GAP_MAX,
            "no_update_control": {
                "max_rel_loss_diff": max(abs(ref_losses[0] - b) / abs(b) for b in ref_losses),
                "param_gap_max": p0_gap["param_gap_max"]}}


def _check_held(what: str, row: dict) -> None:
    """The run within the limits, and the planted no-update run
    ``NO_UPDATE_MARGIN`` times past them (so the limits can catch it)."""
    control = row["no_update_control"]
    _require(control["max_rel_loss_diff"] > NO_UPDATE_MARGIN * row["rtol"]
             and control["param_gap_max"] > NO_UPDATE_MARGIN * row["param_gap_limit"],
             f"{what}: the limits would pass a run that never updates: {control}")
    _require(row["max_rel_loss_diff"] <= row["rtol"],
             f"{what}: losses {row['max_rel_loss_diff']} apart, relative")
    _require(row["param_gap_max"] <= row["param_gap_limit"],
             f"{what}: parameter {row['param_gap_worst']} {row['param_gap_max']} apart")


def _slice5a_phases(torch, kernels_mod, smi: str, flash_per_block: float,
                    peak_flops: float) -> dict:
    """Phases 6b-6e: ``moe``, ``adafactor``, ``mesh`` and ``llama_captured``
    (see the module docstring).  Returns each path's flash launches."""
    import socket

    import torch.distributed as dist

    from deeplearning_cfn_tpu_torch.examples import llama_train
    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.parallel import sharding
    from deeplearning_cfn_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from deeplearning_cfn_tpu_torch.train import optimizers
    from deeplearning_cfn_tpu_torch.train.data import (
        SyntheticTokenDataset,
        device_put_batch,
        stack_batches,
    )
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    launches_by_path = {}

    def run_example(name, args, steps, batch, n_layers):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        result = llama_train.main(args)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(kernels_mod.launch_counts)
        launches_by_path[name] = launches.get("flash_attention_fwd", 0)
        tokens = batch * 2048
        run = {"phase": name, "args": args, **_run_summary(result, tokens, tokens),
               "active_params": result["active_params"], "wall_s": wall_s,
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
               "launches": launches,
               **_flash_check(launches, steps, flash_per_block * n_layers, name),
               "nvidia_smi": smi}
        _require(len(run["losses"]) == steps and all(math.isfinite(v) for v in run["losses"]),
                 f"{name}: non-finite loss {run['losses']}")
        return result, run

    # 6b. moe: the m435 shape at full depth and width with 8 experts, top-2.
    cfg = llama.LlamaConfig.m435(seq_len=2048)
    flash_per_step = flash_per_block * cfg.n_layers
    result, run = run_example("moe", MOE_ARGS, MOE_STEPS, 8, cfg.n_layers)
    run["moe_aux_loss"] = result["moe_aux_loss"]
    _emit(run)
    _require(math.isfinite(run["moe_aux_loss"]) and run["moe_aux_loss"] > 0,
             f"moe: the aux loss {run['moe_aux_loss']}")
    mcfg = dataclasses.replace(cfg, n_experts=8, dtype=torch.float32)
    model = _llama_on_card(torch, llama, mcfg, seed=0)
    tokens = torch.from_numpy(next(SyntheticTokenDataset(
        seq_len=2048, vocab_size=cfg.vocab_size, batch_size=2).batches(1)).x).cuda()
    kernels_mod.reset_launch_counts()
    with torch.no_grad():
        logits_kernel = llama.forward(model, tokens)
        with llama.force_attention_kind("flash_reference"):
            logits_plain = llama.forward(model, tokens)
    f32_variants = _variants(kernels_mod.launch_counts, "flash_attention_fwd")
    diff = (logits_kernel - logits_plain).abs()
    row = {"phase": "logits", "path": "moe", "flash_variants": f32_variants, "dtype": "float32", "B": 2, "S": 2048,
           "max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
           "atol": MOE_LOGITS_ATOL, "mean_atol": MOE_LOGITS_MEAN_ATOL,
           "logits_max_abs": logits_plain.abs().max().item(),
           "finite": bool(torch.isfinite(logits_kernel).all())}
    _emit(row)
    _require(row["finite"], "moe: non-finite logits")
    _require(f32_variants == {"simt": mcfg.n_layers}, f"moe: f32 forward launched {f32_variants}")
    _require(row["max_abs_err"] <= MOE_LOGITS_ATOL, "moe: logits max error")
    _require(row["mean_abs_err"] <= MOE_LOGITS_MEAN_ATOL, "moe: logits mean error")
    del model, logits_kernel, logits_plain, diff, result
    torch.cuda.empty_cache()
    # Two steps of the same bf16 MoE step profiled by kernel, after two
    # warm-up steps, on weights drawn on the card.
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer

    mcfg = dataclasses.replace(cfg, n_experts=8)
    trainer = Trainer(lambda gen: _llama_on_card(torch, llama, mcfg, seed=0), TrainerConfig(
        optimizer="adamw", learning_rate=3e-4, weight_decay=0.1, grad_clip_norm=1.0),
        loss_fn=llama.causal_lm_loss, device="cuda")
    state = trainer.init(seed=0)
    x, y = device_put_batch(next(SyntheticTokenDataset(
        seq_len=2048, vocab_size=cfg.vocab_size, batch_size=8).batches(1)), torch.device("cuda"))

    # Every layer's attention in one bf16 forward at the step's shape: the
    # kernel's output against the plain flash forward on the same q, k, v.
    kernel_flash, errs = llama.flash_attention, []

    def checked_flash(q, k, v, causal, **kw):
        out = kernel_flash(q, k, v, causal=causal, **kw)
        ref = llama.flash_attention_reference(q, k, v, causal=causal)[0]
        errs.append(torch.stack([(out.float() - ref.float()).abs().max(),
                                 ref.float().abs().max()]))
        return out

    kernels_mod.reset_launch_counts()
    llama.flash_attention = checked_flash
    try:
        with torch.no_grad():
            llama.forward(state.model, x)
    finally:
        llama.flash_attention = kernel_flash
    errs, scales = torch.stack(errs).T.tolist()
    limits = [BF16_OUT_ATOL * max(1.0, m) for m in scales]
    row = {"phase": "attention", "path": "moe", "dtype": "bfloat16", "B": 8, "S": 2048,
           "flash_variants": _variants(kernels_mod.launch_counts, "flash_attention_fwd"),
           "max_abs_err_by_layer": errs, "max_abs_out_by_layer": scales,
           "atol_by_layer": limits}
    _emit(row)
    _require(row["flash_variants"] == {"wgmma_tma": mcfg.n_layers},
             f"moe: the bf16 forward launched {row['flash_variants']}")
    _require(all(e <= lim for e, lim in zip(errs, limits)),
             f"moe: attention off the plain forward by {errs}, limits {limits}")

    def moe_step():
        nonlocal state
        state, _ = trainer.train_step(state, x, y)

    for _ in range(2):
        moe_step()
    _emit({"phase": "profile", "path": "moe", **_profile(torch, moe_step, 2)})
    del trainer, state, x, y

    # 6c. adafactor: the 3b rung with the memory-lean optimizer.
    bcfg = llama.LlamaConfig.b3(seq_len=2048)
    result, run = run_example("adafactor", ADAFACTOR_ARGS, ADAFACTOR_STEPS, 4, bcfg.n_layers)
    run["optimizer_state_bytes"] = _adafactor_state_bytes(llama, optimizers, bcfg)
    run["adamw_state_bytes"] = 2 * 2 * llama.param_count(bcfg)  # mu and nu in bf16
    run["param_bytes"] = 2 * llama.param_count(bcfg)
    _emit(run)
    del result

    # 6d. mesh: a one-rank NCCL group, the m435 path with strategy "fsdp"
    # over build_mesh(MeshSpec(fsdp=1)) (FSDP2, every parameter a DTensor),
    # against the same steps on one repeated batch without a mesh.
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        mesh = build_mesh(MeshSpec(fsdp=1))
        tcfg = TrainerConfig(strategy="fsdp", optimizer="adamw", learning_rate=3e-4,
                             weight_decay=0.1, grad_clip_norm=1.0, log_every=1)
        batch = device_put_batch(next(SyntheticTokenDataset(
            seq_len=2048, vocab_size=cfg.vocab_size, batch_size=8).batches(1)), torch.device("cuda"))
        batches = [batch] * MESH_STEPS
        runs, finals = {}, {}
        for path, m in (("mesh", mesh), ("no_mesh", None)):
            trainer = llama.make_trainer(cfg, tcfg, device="cuda", mesh=m)
            state = trainer.init(seed=0)
            if m is None:
                p0 = _param_copy(state.model)
            dtensors = sum(hasattr(p, "placements") for p in state.model.parameters())
            torch.cuda.synchronize()
            kernels_mod.reset_launch_counts()
            losses, step_ms = [], []
            for x, y in batches:
                t0 = time.perf_counter()
                state, metrics = trainer.train_step(state, x, y)
                losses.append(metrics["loss"].item())
                step_ms.append((time.perf_counter() - t0) * 1e3)
            launches = dict(kernels_mod.launch_counts)
            mp = llama.model_parallel(state.model)
            runs[path] = {"losses": losses, "step_ms": step_ms,
                          "steady_step_ms": statistics.median(step_ms[1:]),
                          "dtensor_params": dtensors, "launches": launches,
                          "model_tp_sp": [mp.tp, mp.sp],
                          **_flash_check(launches, MESH_STEPS, flash_per_step, f"mesh ({path})")}
            if m is not None:
                launches_by_path["mesh"] = launches["flash_attention_fwd"]
            finals[path] = _param_copy(state.model)
            del trainer, state
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    row = {"phase": "mesh", "mesh": "MeshSpec(fsdp=1), one NCCL rank", "steps": MESH_STEPS,
           **{f"{k}_{p}": v for p, r in runs.items() for k, v in r.items()},
           **_held_runs(runs["mesh"]["losses"], runs["no_mesh"]["losses"],
                        _param_gap(finals["mesh"], finals["no_mesh"], p0),
                        _param_gap(p0, finals["no_mesh"], p0), MESH_LOSS_RTOL),
           "nvidia_smi": smi}
    _emit(row)
    # FSDP2 holds every parameter the specs shard; the norms stay whole.
    n_sharded = sum(sharding.fsdp_dim(spec) is not None for spec in llama.param_specs(cfg).values())
    _require(runs["mesh"]["dtensor_params"] == n_sharded and runs["no_mesh"]["dtensor_params"] == 0,
             f"mesh: {runs['mesh']['dtensor_params']} parameters sharded, expected {n_sharded}")
    _require(all(math.isfinite(v) for v in runs["mesh"]["losses"]), "mesh: non-finite loss")
    _require(runs["mesh"]["model_tp_sp"] == [1, 1], f"mesh: tp, sp {runs['mesh']['model_tp_sp']}")
    _check_held("mesh", row)
    del batches, batch, finals

    # 6e. llama_captured: multi_step_fn(LLAMA_K) of the m435 AdamW step as one
    # CUDA graph, against as many eager steps from the same state, on one
    # repeated batch.
    trainer = llama.make_trainer(cfg, TrainerConfig(
        optimizer="adamw", learning_rate=3e-4, weight_decay=0.1, grad_clip_norm=1.0,
        log_every=1), device="cuda")
    one = next(SyntheticTokenDataset(seq_len=2048, vocab_size=cfg.vocab_size, batch_size=8).batches(1))
    xs, ys = device_put_batch(next(stack_batches(iter([one] * LLAMA_K), LLAMA_K)),
                              torch.device("cuda"))
    eager_state = trainer.init(seed=0)
    p0 = _param_copy(eager_state.model)
    eager, eager_ms = [], []
    for i in range(LLAMA_K):
        t0 = time.perf_counter()
        eager_state, m = trainer.train_step(eager_state, xs[i], ys[i])
        eager.append(m["loss"].item())
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    eager_final = _param_copy(eager_state.model)
    del eager_state, m
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init(seed=0)
    kfn = trainer.multi_step_fn(LLAMA_K)
    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    state, captured = kfn(state, xs, ys)
    captured = captured.tolist()
    capture_s = time.perf_counter() - t0
    held = _held_runs(captured, eager, _param_gap(_param_copy(state.model), eager_final, p0),
                      _param_gap(p0, eager_final, p0), LLAMA_CAPTURE_RTOL)
    del p0, eager_final
    launches = dict(kernels_mod.launch_counts)
    launches_by_path["llama_captured"] = launches.get("flash_attention_fwd", 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LLAMA_REPLAYS):
        state, losses = kfn(state, xs, ys)
        losses.tolist()
    step_ms = (time.perf_counter() - t0) * 1e3 / (LLAMA_REPLAYS * LLAMA_K)
    flops = llama.train_flops_per_token(cfg, 2048) * 8 * 2048
    row = {"phase": "llama_captured", "k": LLAMA_K, "replays": LLAMA_REPLAYS,
           "eager_losses": eager, "captured_losses": captured, **held,
           "bitwise_equal": captured == eager,
           "first_call_s": capture_s, "captures": kfn.captures,
           "step_ms": step_ms, "eager_step_ms": eager_ms,
           "eager_steady_step_ms": statistics.median(eager_ms[1:]),
           "tokens_per_s": 8 * 2048 / step_ms * 1e3, "mfu": flops / (step_ms / 1e3) / peak_flops,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "launches_in_warmup_and_capture": launches,
           "replay_launches": "not counted: a replay launches no wrapper", "nvidia_smi": smi}
    _emit(row)
    _require(kfn.captures == 1, f"llama_captured: {kfn.captures} captures")
    _check_held("llama_captured", row)
    _flash_check(launches, 1 + LLAMA_K, flash_per_step, "llama_captured (warm-up + capture)")
    del trainer, state, kfn, xs, ys
    torch.cuda.empty_cache()
    return launches_by_path


def _serve_phase(torch, kernels_mod, smi: str, peak_bw: float) -> dict:
    """Phase 8: the serving path at Llama-3-8B (see the module docstring).
    Emits the ``serve_parity``, ``serve_graph``, ``profile`` and ``serve``
    lines; returns the ``serve`` line."""
    from deeplearning_cfn_tpu_torch.models import llama, llama_decode
    from deeplearning_cfn_tpu_torch.serve import (
        ContinuousBatchingEngine,
        ServeConfig,
        ServeRequest,
        TrafficConfig,
        generate_traffic,
    )
    from deeplearning_cfn_tpu_torch.serve import engine as serve_engine
    from deeplearning_cfn_tpu_torch.serve.paged_cache import PagedKVCache, init_paged_cache

    base = llama.LlamaConfig.llama3_8b()

    # 1. Parity in f32 (TF32 off since phase 1), 8B widths at two layers:
    # the engine's greedy tokens, one request admitted mid-flight, against
    # generate; then teacher-forced paged decode logits against the forward.
    cfg32 = dataclasses.replace(base, n_layers=PARITY_LAYERS, dtype=torch.float32)
    model32 = _llama_on_card(torch, llama, cfg32, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg32.vocab_size, (2, PARITY_PROMPT), device="cuda",
                            generator=gen, dtype=torch.int32)
    ref = llama_decode.generate(model32, prompts, max_new_tokens=PARITY_NEW)
    bs = SERVE_SLOTS["block_size"]
    pcfg = ServeConfig(num_slots=2, block_size=bs, prefill_len=PARITY_PROMPT,
                       blocks_per_slot=(PARITY_PROMPT + PARITY_NEW) // bs)
    host = prompts.cpu().numpy()
    engine = ContinuousBatchingEngine(model32, pcfg, clock=time.monotonic, journal=False,
                                      name="parity")
    engine.submit(ServeRequest("p0", host[0], PARITY_NEW))
    done, i = {}, 0
    while i <= 3 or engine.pending():
        if i == 3:  # joins the in-flight batch
            engine.submit(ServeRequest("p1", host[1], PARITY_NEW))
        for c in engine.step():
            done[c.request_id] = c
        i += 1
    tokens_equal = [done["p0"].tokens, done["p1"].tokens] == ref.cpu().tolist()
    seq = torch.cat([prompts[:1], ref[:1]], dim=1)  # [1, 96]
    with torch.no_grad():
        full = llama.forward(model32, seq)[0]
    cache = init_paged_cache(cfg32, pcfg.blocks_per_slot, bs, "cuda")
    table = torch.arange(pcfg.blocks_per_slot, device="cuda")
    serve_engine.paged_prefill(model32, cache, seq[:, :PARITY_PROMPT], PARITY_PROMPT, table)
    errs = []
    for pos in range(PARITY_PROMPT, PARITY_PROMPT + PARITY_NEW):
        logits = serve_engine.paged_decode_logits(
            model32, cache, seq[0, pos : pos + 1], torch.tensor([pos], device="cuda"),
            table[None], torch.tensor([True], device="cuda"))
        errs.append((logits[0] - full[pos]).abs().max().item())
    parity = {"phase": "serve_parity", "dtype": "float32", "layers": PARITY_LAYERS,
              "prompt": PARITY_PROMPT, "new_tokens": PARITY_NEW, "mid_flight_admission": True,
              "decode_captures": engine.decode_captures, "tokens_equal_generate": tokens_equal,
              "teacher_forced_max_abs_err": max(errs), "atol": SERVE_LOGITS_ATOL,
              "logits_max_abs": full.abs().max().item()}
    _emit(parity)
    _require(tokens_equal, "serve: the engine's greedy tokens differ from generate's")
    _require(max(errs) <= SERVE_LOGITS_ATOL, f"serve: teacher-forced logits error {max(errs)}")
    del model32, engine, cache, full, seq
    torch.cuda.empty_cache()

    # 2. Llama-3-8B in bf16 at full depth: one decode step by graph replay
    # against the eager step on a copy of the pool, same inputs.
    model = _llama_on_card(torch, llama, base, seed=0)
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    scfg = ServeConfig(**SERVE_SLOTS)
    traffic = generate_traffic(TrafficConfig(vocab_size=base.vocab_size, **SERVE_TRAFFIC))

    def fresh(requests):
        return [ServeRequest(r.request_id, r.prompt.copy(), r.max_new_tokens) for r in requests]

    t0 = time.perf_counter()
    check = ContinuousBatchingEngine(model, scfg, clock=time.monotonic, journal=False,
                                     name="graph-check")
    capture_s = time.perf_counter() - t0
    for r in fresh(traffic[: scfg.num_slots]):
        check.submit(r)
    for _ in range(2):  # admit (prefill) all slots, two replayed steps
        check.step()
    inputs = check.decode_inputs()
    tensors = [torch.from_numpy(a).to("cuda") for a in inputs]
    eager_cache = PagedKVCache(k=check.cache.k.clone(), v=check.cache.v.clone())
    eager_tokens, _ = serve_engine.paged_decode_step(model, eager_cache, *tensors)
    replay_tokens = check.decode(inputs)
    torch.cuda.synchronize()
    graph = {"phase": "serve_graph", "dtype": "bfloat16", "layers": base.n_layers,
             "active_slots": int(inputs[3].sum()), "capture_s": capture_s,
             "tokens_equal": eager_tokens.cpu().tolist() == replay_tokens.tolist(),
             "pool_equal": bool(torch.equal(check.cache.k, eager_cache.k)
                                and torch.equal(check.cache.v, eager_cache.v))}
    # Every step rewrites the same positions with the same values from here.
    replay = lambda: check.captured(*inputs)  # noqa: E731
    eager = lambda: serve_engine.paged_decode_logits(model, eager_cache, *tensors)  # noqa: E731
    kv_bytes = (int((inputs[1] + 1)[inputs[3]].sum()) * base.n_layers * 2
                * base.n_kv_heads * base.head_dim * 2)
    gathered_bytes = (scfg.num_slots * scfg.max_context * base.n_layers * 2
                      * base.n_kv_heads * base.head_dim * 2)
    step_weight_bytes = (weight_bytes - model.embed.numel() * model.embed.element_size()
                         + scfg.num_slots * base.dim * 2)
    # The host's clock around a whole engine decode: inputs copied in, the
    # replay, sampling, the tokens back on the host.
    t0 = time.perf_counter()
    for _ in range(10):
        check.decode(inputs)
    host_ms = (time.perf_counter() - t0) * 1e3 / 10
    graph.update({
        "decode_step_ms": _device_ms(torch, replay, iters=10),
        "decode_step_event_ms": _time_ms(torch, replay, iters=10),
        "decode_step_host_ms": host_ms,
        "eager_step_ms": _time_ms(torch, eager, iters=5, warmup=1),
        "eager_step_device_ms": _device_ms(torch, eager, iters=5, warmup=1),
        "eager_step_host_ms": _host_ms(torch, eager, iters=5, warmup=1),
        "decode_weight_bytes": step_weight_bytes, "decode_kv_bytes": kv_bytes,
        "decode_kv_gathered_bytes": gathered_bytes,
        "decode_bound_ms": (step_weight_bytes + kv_bytes) / peak_bw * 1e3,
        "decode_bound_by": "bytes",
    })
    _emit(graph)
    _require(graph["tokens_equal"] and graph["pool_equal"],
             "serve: the replayed decode step differs from the eager step")
    _emit({"phase": "profile", "path": "serve_decode_replay",
           **_profile(torch, lambda: check.decode(inputs), 5)})
    _emit({"phase": "profile", "path": "serve_decode_eager", **_profile(torch, eager, 2)})
    del check, eager_cache, tensors
    torch.cuda.empty_cache()

    # 3. The serving run: 16 requests in one burst on the wall clock.
    engine = ContinuousBatchingEngine(model, scfg, clock=time.monotonic, journal=False,
                                      name="serve0")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels_mod.reset_launch_counts()
    requests = fresh(traffic)
    for r in requests:
        engine.submit(r)
    t0 = time.monotonic()
    done, decode_s, decode_tokens = {}, 0.0, 0
    while engine.pending():
        prefills, active = engine.prefills, engine.active_slots
        ts = time.perf_counter()
        for c in engine.step():
            done[c.request_id] = c
        if engine.prefills == prefills:  # a decode-only step
            decode_s += time.perf_counter() - ts
            decode_tokens += active
    wall_s = time.monotonic() - t0
    launches = dict(kernels_mod.launch_counts)
    snap = engine.snapshot()
    peak_mem = torch.cuda.max_memory_allocated()
    row = {"phase": "serve", "model": "llama3_8b", "layers": base.n_layers, "dtype": "bfloat16",
           "serve_config": SERVE_SLOTS, "traffic": SERVE_TRAFFIC, "nvidia_smi": smi,
           "completed": len(done), "steps": snap["steps"], "wall_s": wall_s,
           "tokens_out": snap["tokens_out"], "tokens_per_s": snap["tokens_per_s"],
           "decode_tokens_per_s": decode_tokens / decode_s if decode_s else None,
           "ttft_ms": snap["ttft_ms"], "itl_ms": snap["itl_ms"],
           "free_blocks": snap["free_blocks"], "recycled_blocks": snap["recycled_blocks"],
           "decode_captures": snap["decode_captures"], "launches": launches,
           "max_memory_allocated_bytes": peak_mem, "weights_gb": weight_bytes / 1e9,
           "pool_gb": (engine.cache.k.nbytes + engine.cache.v.nbytes) / 1e9}
    row.update({k: graph[k] for k in (
        "decode_step_ms", "decode_step_event_ms", "decode_step_host_ms", "eager_step_ms",
        "eager_step_device_ms", "eager_step_host_ms", "decode_bound_ms", "decode_bound_by")})
    # Every prompt is padded to prefill_len, so one prefill costs the same at
    # any prompt length: timed on the first request's prompt, into free pages.
    first = traffic[0]
    padded = torch.zeros((1, scfg.prefill_len), dtype=torch.int32)
    padded[0, : first.prompt.size] = torch.from_numpy(first.prompt)
    padded = padded.cuda()
    blocks = torch.arange(scfg.blocks_per_slot, device="cuda")
    prefill = lambda: serve_engine.paged_prefill(  # noqa: E731
        model, engine.cache, padded, int(first.prompt.size), blocks)
    row["prefill_ms"] = _time_ms(torch, prefill, iters=3, warmup=1)
    row["prefill_device_ms"] = _device_ms(torch, prefill, iters=3, warmup=1)
    _emit(row)
    _require(row["completed"] == len(traffic), f"serve: {row['completed']} of {len(traffic)} done")
    _require(all(len(done[r.request_id].tokens) == r.max_new_tokens for r in traffic),
             "serve: a completion has another token count than requested")
    _require(all(0 <= t < base.vocab_size for c in done.values() for t in c.tokens),
             "serve: a token outside the vocabulary")
    _require(row["free_blocks"] == scfg.resolved_num_blocks, "serve: pages not recycled")
    _require(row["decode_captures"] == 1, f"serve: {row['decode_captures']} decode captures")
    _require(sum(launches.get(k, 0) for k in kernels_mod._KERNELS) == 0,
             f"serve: the serving path launched a kernel of the port: {launches}")
    del engine, model
    torch.cuda.empty_cache()
    return row


def _resnet_phase(torch, kernels_mod, smi: str, peak_flops: float) -> dict:
    """Phase 9: ResNet-50 training (see the module docstring).  Emits the
    ``resnet_parity``, ``resnet_example``, ``resnet`` (one a head), ``profile``,
    ``resnet_captured``, ``resnet_prefetch`` and ``resnet_eval`` lines;
    returns the fused-dense launches of the kernel head's eager run."""
    from deeplearning_cfn_tpu_torch.examples import resnet_imagenet
    from deeplearning_cfn_tpu_torch.models import resnet
    from deeplearning_cfn_tpu_torch.ops import fused_dense as fd
    from deeplearning_cfn_tpu_torch.train.data import (
        SyntheticDataset,
        device_put_batch,
        stack_batches,
    )
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig

    ds = SyntheticDataset.imagenet_like(batch_size=RESNET_BATCH, image_size=RESNET_IMAGE,
                                        dtype="uint8", pool_batches=RESNET_POOL)
    cfg = TrainerConfig(learning_rate=0.1, has_train_arg=True, label_smoothing=0.1,
                        input_stats=ds.input_stats, log_every=1)
    shape = (RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3)

    def make(pallas: bool, dtype=torch.bfloat16) -> Trainer:
        arch = dict(stage_sizes=(3, 4, 6, 3), dtype=dtype, use_pallas_head=pallas)
        return Trainer(lambda gen: resnet.ResNet(**arch, generator=gen), cfg, device="cuda",
                       analytic_flops_fn=lambda x: resnet.train_flops(arch, x.shape))

    pool = list(ds.batches(RESNET_POOL))
    x0, y0 = device_put_batch(pool[0], torch.device("cuda"))

    # 1. Parity in f32 (TF32 off since phase 1), one batch, the same state:
    # the kernel head's logits and head gradients against the plain fused
    # dense's (force_reference), in eval mode (no statistic moves).
    trainer = make(True, torch.float32)
    state = trainer.init(seed=0)
    model = state.model
    grads, logits = {}, {}
    for path in ("kernel", "plain"):
        model.zero_grad(set_to_none=True)
        with fd.force_reference() if path == "plain" else contextlib.nullcontext():
            out = model(trainer._normalize_input(x0), train=False)
            torch.nn.functional.cross_entropy(out, y0.long()).backward()
        logits[path] = out.detach()
        grads[path] = {n: getattr(model.head, n).grad.clone() for n in ("kernel", "bias")}
    rtol, atol = DENSE_TOL["float32"]
    grtol, gatol = GRAD_TOL["float32"]
    err = (logits["kernel"] - logits["plain"]).abs()
    gerr = {n: (grads["kernel"][n] - grads["plain"][n]).abs() for n in grads["kernel"]}
    parity = {"phase": "resnet_parity", "dtype": "float32", "B": RESNET_BATCH,
              "logits_max_abs_err": err.max().item(), "rtol": rtol, "atol": atol,
              "logits_within": bool((err <= atol + rtol * logits["plain"].abs()).all()),
              "grad_max_abs_err": {n: e.max().item() for n, e in gerr.items()},
              "grad_rtol": grtol, "grad_atol": gatol,
              "grad_within": all(bool((gerr[n] <= gatol + grtol * grads["plain"][n].abs()).all())
                                 for n in gerr),
              "logits_max_abs": logits["plain"].abs().max().item()}
    _emit(parity)
    _require(parity["logits_within"], "resnet: kernel-head logits off the plain head's")
    _require(parity["grad_within"], "resnet: kernel-head gradients off the plain head's")
    del trainer, state, model, grads, logits, out, err, gerr
    torch.cuda.empty_cache()

    # 2. The example, as a user runs it, with the kernel head: its own
    # synthetic stream (f32 images, as the JAX example's), its trainer, fit
    # with two producers, then one held-out eval batch.
    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    result = resnet_imagenet.main([
        "--depth", "50", "--global_batch_size", str(RESNET_BATCH),
        "--image_size", str(RESNET_IMAGE), "--steps", str(RESNET_EXAMPLE_STEPS),
        "--log_every", "1", "--eval_steps", "1", "--prefetch_workers", "2",
        "--use_pallas_head", "--device", "cuda"])
    torch.cuda.synchronize()
    launches = dict(kernels_mod.launch_counts)
    example = {"phase": "resnet_example", "args": "--depth 50 --use_pallas_head",
               "steps": result["steps"], "final_loss": result["final_loss"],
               "losses": [h["loss"] for h in result["history"]],
               "step_ms": [RESNET_BATCH / h["examples_per_sec"] * 1e3 for h in result["history"]],
               "eval": result["eval"], "params": result["params"],
               "first_step_s": result["first_step_s"], "wall_s": time.perf_counter() - t0,
               "launches": launches}
    _emit(example)
    _require(result["steps"] == RESNET_EXAMPLE_STEPS
             and all(math.isfinite(v) for v in example["losses"])
             and math.isfinite(result["eval"]["loss"]), f"resnet example: {example}")
    _require(_variants(launches, "fused_dense") == {F32_SPLITK: RESNET_EXAMPLE_STEPS + 1},
             f"resnet example: the kernel head launched {launches}, expected one "
             f"{F32_SPLITK} a step and one for the eval batch")
    del result
    torch.cuda.empty_cache()

    # 3. Eager training, kernel head then plain head, through fit (prefetcher
    # with two producers over the pooled uint8 stream; a readback each step,
    # so each logged step time is the step's whole time).
    runs, kernel_launches = {}, {}
    steps = RESNET_WARMUP + RESNET_STEPS
    for path, pallas in (("kernel", True), ("plain", False)):
        trainer = make(pallas)
        state = trainer.init(seed=0)
        logger = trainer.throughput_logger(pool[0].x, RESNET_BATCH, name="resnet50", log_every=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        state, losses = trainer.fit(state, ds.batches(steps), steps=steps, logger=logger,
                                    prefetch_workers=2)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(kernels_mod.launch_counts)
        steady = logger.history[RESNET_WARMUP:]
        rate = statistics.median(h["examples_per_sec"] for h in steady)
        run = {"phase": "resnet", "head": path, "model": "resnet50", "dtype": "bfloat16",
               "batch": RESNET_BATCH, "image": RESNET_IMAGE, "steps": steps,
               "losses": losses, "step_ms": [RESNET_BATCH / h["examples_per_sec"] * 1e3
                                             for h in logger.history],
               "steady_step_ms": RESNET_BATCH / rate * 1e3, "images_per_s": rate,
               "mfu": statistics.median(h["mfu"] for h in steady),
               "flops_per_step": logger.flops_per_step, "peak_flops": peak_flops,
               "first_step_s": trainer.first_step_seconds, "wall_s": wall_s,
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
               "launches": launches,
               "fused_dense_launches_per_step": launches["fused_dense"] / steps,
               "pipeline": trainer.last_pipeline_stats.snapshot(), "nvidia_smi": smi}
        _emit(run)
        _require(len(losses) == steps and all(math.isfinite(v) for v in losses),
                 f"resnet ({path}): non-finite loss")
        _require(statistics.mean(losses[-3:]) < statistics.mean(losses[:3]),
                 f"resnet ({path}): the loss did not fall: {losses}")
        if pallas:
            kernel_launches = launches
            _require(launches["fused_dense"] == steps
                     and _variants(launches, "fused_dense") == {F32_SPLITK: steps},
                     f"resnet: the kernel head launched {launches}, expected one "
                     f"{F32_SPLITK} a step")
            _require(run["pipeline"]["batches"] == steps, "resnet: prefetcher batch count")
            _emit({"phase": "resnet_prefetch", "workers": 2, **run["pipeline"]})
        else:
            _require(launches["fused_dense"] == 0, "resnet: the plain head ran the kernel")
        x, y = device_put_batch(pool[1], torch.device("cuda"))

        def step():
            nonlocal state
            state, _ = trainer.train_step(state, x, y)

        _emit({"phase": "profile", "path": "resnet50", "head": path, **_profile(torch, step, 2)})
        runs[path] = run
        if not pallas:
            # 4. Eval on two held-out batches, eval mode, running statistics.
            held_out = SyntheticDataset(shape=shape[1:], num_classes=1000,
                                        batch_size=RESNET_BATCH, seed=10_000, template_seed=0,
                                        dtype="uint8")
            ev = trainer.evaluate(state, held_out.batches(2), steps=2)
            _emit({"phase": "resnet_eval", **ev})
            _require(math.isfinite(ev["loss"]) and 0.0 <= ev["accuracy"] <= 1.0
                     and ev["examples"] == 2 * RESNET_BATCH, f"resnet eval: {ev}")
        del trainer, state, logger, x, y
        torch.cuda.empty_cache()

    # 5. multi_step_fn(RESNET_K) captured as one CUDA graph, against as many
    # eager steps from the same state on the same stacked batches; then
    # replays timed on the host's clock (each call ends in a readback).
    stack = next(stack_batches(iter(pool), RESNET_K))
    xs, ys = device_put_batch(stack, torch.device("cuda"))
    for path, pallas in (("kernel", True), ("plain", False)):
        trainer = make(pallas)
        eager_state = trainer.init(seed=0)
        eager = []
        for i in range(RESNET_K):
            eager_state, m = trainer.train_step(eager_state, xs[i], ys[i])
            eager.append(m["loss"])
        eager = torch.stack(eager).tolist()
        del eager_state
        torch.cuda.empty_cache()
        state = trainer.init(seed=0)
        kfn = trainer.multi_step_fn(RESNET_K)
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        state, captured = kfn(state, xs, ys)
        captured = captured.tolist()
        capture_s = time.perf_counter() - t0
        launches = dict(kernels_mod.launch_counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RESNET_REPLAYS):
            state, losses = kfn(state, xs, ys)
            losses.tolist()
        step_ms = (time.perf_counter() - t0) * 1e3 / (RESNET_REPLAYS * RESNET_K)
        rel = max(abs(a - b) / abs(b) for a, b in zip(captured, eager))
        row = {"phase": "resnet_captured", "head": path, "k": RESNET_K,
               "replays": RESNET_REPLAYS, "eager_losses": eager, "captured_losses": captured,
               "max_rel_diff": rel, "rtol": RESNET_CAPTURE_RTOL,
               "bitwise_equal": captured == eager, "first_call_s": capture_s,
               "captures": kfn.captures, "step_ms": step_ms,
               "images_per_s": RESNET_BATCH / step_ms * 1e3,
               "mfu": runs[path]["flops_per_step"] / (step_ms / 1e3) / peak_flops,
               "launches_in_warmup_and_capture": launches,
               "replay_launches": "not counted: a replay launches no wrapper"}
        _emit(row)
        _require(rel <= RESNET_CAPTURE_RTOL, f"resnet ({path}): captured losses {captured} "
                 f"off the eager {eager}")
        _require(kfn.captures == 1, f"resnet ({path}): {kfn.captures} captures")
        if pallas:
            _require(_variants(launches, "fused_dense") == {F32_SPLITK: 1 + RESNET_K},
                     f"resnet: the captured kernel head launched {launches}, expected one "
                     f"warm-up and {RESNET_K} captured {F32_SPLITK} launches")
        runs[path]["captured"] = row
        del trainer, state, kfn
        torch.cuda.empty_cache()
    del xs, ys, x0, y0
    torch.cuda.empty_cache()
    return kernel_launches


def _state_copy(state) -> dict:
    """Every tensor of a TrainState's state dict (parameters, buffers,
    optimizer state, step), copied, by path."""
    out = {}

    def walk(prefix, t):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(f"{prefix}.{k}" if prefix else str(k), v)
        elif hasattr(t, "detach"):
            out[prefix] = t.detach().clone()

    walk("", state.state_dict())
    return out


def _unequal(a: dict, b: dict) -> list:
    """The paths whose tensors are not bitwise equal (or missing)."""
    return sorted(k for k in a.keys() | b.keys()
                  if k not in a or k not in b or a[k].dtype != b[k].dtype
                  or not bool((a[k] == b[k]).all()))


class _StepClock:
    """A ``fit`` logger that times each step on the host's clock (fit calls
    it after each step, before that step's checkpoint save; the loss
    readback is the sync), and copies the parameters at the steps asked."""

    def __init__(self, model, copies=()):
        self.model, self.at, self.copies, self.ms = model, set(copies), {}, []
        self._t = time.perf_counter()

    def step(self, step: int, loss) -> None:
        float(loss)
        now = time.perf_counter()
        self.ms.append((now - self._t) * 1e3)
        if step in self.at:
            self.copies[step] = _param_copy(self.model)
        self._t = time.perf_counter()


def _checkpoint_phase(torch, kernels_mod, smi: str) -> dict:
    """Phase 10: checkpoint and resume (see the module docstring).  Emits
    ``checkpoint_llama``, ``checkpoint_async``, ``checkpoint_resnet``,
    ``checkpoint_captured`` and ``checkpoint_example`` (one an example);
    returns the launches of the resumed runs, by kernel."""
    import itertools
    import shutil
    import tempfile

    from deeplearning_cfn_tpu_torch.examples import llama_train, resnet_imagenet
    from deeplearning_cfn_tpu_torch.models import llama, resnet
    from deeplearning_cfn_tpu_torch.train.checkpoint import Checkpointer
    from deeplearning_cfn_tpu_torch.train.data import (
        SyntheticDataset,
        SyntheticTokenDataset,
        device_put_batch,
        stack_batches,
    )
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig, _make_optimizer

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt-"))
    launches: dict = {}
    try:
        free = shutil.disk_usage(root).free
        _emit({"phase": "checkpoint_disk", "dir": str(root), "free_bytes": free})
        _require(free > CKPT_DISK_BYTES, f"checkpoint: {free} bytes free under {root}, "
                 f"the phase writes up to {CKPT_DISK_BYTES}")

        # (a) Llama m435 across a synchronous save and a restore into a fresh
        # trainer from another seed, fed the straight run's batches 5-8.
        cfg = llama.LlamaConfig.m435(seq_len=2048)
        tcfg = TrainerConfig(strategy="fsdp", optimizer="adamw", learning_rate=3e-4,
                             weight_decay=0.1, grad_clip_norm=1.0, log_every=1)
        batches = list(SyntheticTokenDataset(seq_len=2048, vocab_size=cfg.vocab_size,
                                             batch_size=8).batches(CKPT_STEPS))
        half = CKPT_STEPS // 2

        def run(state, trainer, part, ckpt=None, copies=()):
            """fit over ``part`` (a readback a step): the losses, each step's
            wall time (a checkpoint saved after a step is in the next one's),
            and the parameters copied at the steps in ``copies``."""
            clock = _StepClock(state.model, copies)
            state, losses = trainer.fit(state, iter(part), steps=len(part), logger=clock,
                                        checkpointer=ckpt, prefetch=0)
            return state, losses, clock.ms, clock.copies

        trainer = llama.make_trainer(cfg, tcfg, device="cuda")
        state = trainer.init(seed=0)
        p0 = _param_copy(state.model)
        state, straight, straight_ms, _ = run(state, trainer, batches)
        straight_state = _state_copy(state)
        del state, trainer
        torch.cuda.empty_cache()

        trainer = llama.make_trainer(cfg, tcfg, device="cuda")
        state = trainer.init(seed=0)
        state, first, _, _ = run(state, trainer, batches[:half])
        at_half = _state_copy(state)
        sync = Checkpointer(root / "llama", interval_s=None, async_save=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sync.save(state.step, state)
        save_ms = (time.perf_counter() - t0) * 1e3
        saved = sync.last_save
        del state, trainer, sync
        torch.cuda.empty_cache()

        # (b) The same run through fit with async saves every 2 steps; the
        # parameters copied at steps 6 and 8 (before their saves), which
        # steps 7 and 8 then update in place while step 6 is written.
        trainer = llama.make_trainer(cfg, tcfg, device="cuda")
        state = trainer.init(seed=0)
        ck = Checkpointer(root / "llama_async", interval_s=None, every_steps=2, max_to_keep=2,
                          async_save=True)
        saves = []
        record = ck.save  # each save's record, completed when it commits

        def save(step, st):
            record(step, st)
            saves.append(ck.last_save)

        ck.save = save
        state, async_losses, async_ms, copies = run(state, trainer, batches, ck, copies=(6, 8))
        t0 = time.perf_counter()
        ck.wait()
        tail_wait_ms = (time.perf_counter() - t0) * 1e3
        row_async = {"phase": "checkpoint_async", "every_steps": 2, "steps": CKPT_STEPS,
                     "saves": saves, "tail_wait_ms": tail_wait_ms,
                     "step_ms_with_async": async_ms, "step_ms_without": straight_ms,
                     "median_step_ms_with_async": statistics.median(async_ms[1:]),
                     "median_step_ms_without": statistics.median(straight_ms[1:]),
                     "losses_bitwise_equal_straight": async_losses == straight}
        at_6, at_8 = copies[6], copies[8]
        del state, trainer, ck, copies
        torch.cuda.empty_cache()

        # The fresh trainer, from another seed: restore, check that no weight
        # moved on the way in (nothing but the load may write them), 4 steps.
        trainer = llama.make_trainer(cfg, tcfg, device="cuda")
        state = trainer.init(seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, step = Checkpointer(root / "llama").restore_latest(state)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        restored_unequal = _unequal(_state_copy(state), at_half)
        kernels_mod.reset_launch_counts()
        state, rest, rest_ms, _ = run(state, trainer, batches[half:])
        launches["flash_attention_fwd"] = kernels_mod.launch_counts.get("flash_attention_fwd", 0)
        flash = _flash_check(dict(kernels_mod.launch_counts), CKPT_STEPS - half,
                             2 * cfg.n_layers, "checkpoint (resumed m435)")
        resumed_unequal = _unequal(_state_copy(state), straight_state)
        resumed_final = _param_copy(state.model)
        del state, trainer
        torch.cuda.empty_cache()

        # The planted control: the model restored alone, a fresh optimizer.
        trainer = llama.make_trainer(cfg, tcfg, device="cuda")
        state = trainer.init(seed=2)
        Checkpointer(root / "llama").restore_latest(state)
        state.optimizer = _make_optimizer(state.model, tcfg, trainer._leaves(state.model))
        state, control, _, _ = run(state, trainer, batches[half:])
        control_gap = _param_gap(_param_copy(state.model), resumed_final, p0)
        del state, trainer
        torch.cuda.empty_cache()
        row = {"phase": "checkpoint_llama", "model": "m435", "seq": 2048, "batch": 8,
               "optimizer": "adamw", "steps": [half, CKPT_STEPS - half],
               "straight_losses": straight, "resumed_losses": first + rest,
               "losses_bitwise_equal": first + rest == straight,
               "restored_state_unequal": restored_unequal,
               "final_state_unequal": resumed_unequal, "restored_step": step,
               "bytes": saved.get("bytes"), "staged_bytes": saved["staged_bytes"],
               "save_ms": save_ms, "save_staging_ms": saved["staging_ms"],
               "save_write_s": saved["write_s"], "restore_ms": restore_ms,
               "first_save_of_a_checkpointer": "staging allocates its pinned host buffers",
               "step_ms_straight": straight_ms, "step_ms_resumed": rest_ms, **flash,
               "control": {"what": "the model restored, the optimizer fresh",
                           "losses": first + control,
                           "max_rel_loss_diff": max(abs(a - b) / abs(b) for a, b in
                                                    zip(control, straight[half:])),
                           **control_gap},
               "nvidia_smi": smi}
        _emit(row)
        _require(step == half and not restored_unequal,
                 f"checkpoint: the restored m435 state differs at {restored_unequal[:5]}")
        _require(row["losses_bitwise_equal"] and not resumed_unequal,
                 f"checkpoint: the resumed m435 run differs from the straight one at "
                 f"{resumed_unequal[:5]}: {first + rest} against {straight}")
        _require(control_gap["param_gap_max"] > PARAM_GAP_MAX,
                 f"checkpoint: the planted control (fresh optimizer) lies within "
                 f"{PARAM_GAP_MAX} of the resumed run: {control_gap}")
        del straight_state, at_half, resumed_final, p0

        # (b)'s gate: each async checkpoint holds the parameters of its step.
        ck = Checkpointer(root / "llama_async")
        row_async["committed_steps"] = ck.all_steps()
        unequal = {}
        for step, want in ((6, at_6), (8, at_8)):
            t0 = time.perf_counter()
            sd, _ = ck.restore_raw(step)
            row_async.setdefault("raw_restore_ms", []).append((time.perf_counter() - t0) * 1e3)
            unequal[step] = sorted(n for n, w in want.items()
                                   if not torch.equal(sd["model"][n], w.cpu()))
            del sd
        row_async["params_unequal"] = unequal
        row_async["nvidia_smi"] = smi
        _emit(row_async)
        _require(row_async["committed_steps"] == [6, 8], f"checkpoint async: {row_async}")
        _require(not unequal[6] and not unequal[8],
                 f"checkpoint async: a checkpoint differs from its step's parameters: {unequal}")
        _require(row_async["losses_bitwise_equal_straight"],
                 "checkpoint async: the run with saves differs from the straight run")
        del at_6, at_8, ck
        shutil.rmtree(root / "llama")
        shutil.rmtree(root / "llama_async")
        torch.cuda.empty_cache()

        # (c) ResNet-50 at bench.py's configuration, the kernel head: 2 + 2
        # steps across a restore against 4 straight.  cuDNN deterministic, so
        # that two runs of the same steps may be held bitwise.
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            ds = SyntheticDataset.imagenet_like(batch_size=RESNET_BATCH, image_size=RESNET_IMAGE,
                                                dtype="uint8", pool_batches=RESNET_POOL)
            rcfg = TrainerConfig(learning_rate=0.1, has_train_arg=True, label_smoothing=0.1,
                                 input_stats=ds.input_stats, log_every=1)
            arch = dict(stage_sizes=(3, 4, 6, 3), dtype=torch.bfloat16, use_pallas_head=True)

            def make():
                return Trainer(lambda gen: resnet.ResNet(**arch, generator=gen), rcfg,
                               device="cuda")

            t = make()
            state, straight = t.fit(t.init(seed=0), ds.batches(4), steps=4)
            straight_state = _state_copy(state)
            del state, t
            t = make()
            state, first = t.fit(t.init(seed=0), ds.batches(2), steps=2)
            at_2 = _state_copy(state)
            sync = Checkpointer(root / "resnet", interval_s=None, async_save=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sync.save(state.step, state)
            rsave_ms = (time.perf_counter() - t0) * 1e3
            rsaved = dict(sync.last_save)
            del state, t
            t = make()
            state = t.init(seed=1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            Checkpointer(root / "resnet").restore_latest(state)
            torch.cuda.synchronize()
            rrestore_ms = (time.perf_counter() - t0) * 1e3
            kernels_mod.reset_launch_counts()
            state, rest = t.fit(state, itertools.islice(ds.batches(4), 2, None), steps=2)
            head = dict(kernels_mod.launch_counts)
            launches["fused_dense_f32"] = sum(_variants(head, "fused_dense").values())
            unequal = _unequal(_state_copy(state), straight_state)
            del state, t
            row = {"phase": "checkpoint_resnet", "model": "resnet50", "dtype": "bfloat16",
                   "batch": RESNET_BATCH, "image": RESNET_IMAGE, "steps": [2, 2],
                   "straight_losses": straight, "resumed_losses": first + rest,
                   "losses_bitwise_equal": first + rest == straight,
                   "final_state_unequal": unequal,
                   "batchnorm_statistics": sum(k.endswith((".mean", ".var"))
                                               for k in straight_state),
                   "momentum_traces": sum("momentum_buffer" in k for k in straight_state),
                   "bytes": rsaved.get("bytes"), "staged_bytes": rsaved["staged_bytes"],
                   "save_ms": rsave_ms, "restore_ms": rrestore_ms, "launches": head,
                   "nvidia_smi": smi}
            _emit(row)
            _require(row["losses_bitwise_equal"] and not unequal,
                     f"checkpoint: the resumed ResNet-50 run differs at {unequal[:5]}")
            _require(_variants(head, "fused_dense") == {F32_SPLITK: 2},
                     f"checkpoint: the resumed ResNet-50 head launched {head}")

            # Capture, restore, replay: the graph captured on a state before
            # a restore replays on the restored values (in place), equal to
            # eager steps from the restored state.
            pool = list(ds.batches(2 * 2))
            stacks = [device_put_batch(s, torch.device("cuda"))
                      for s in stack_batches(iter(pool), 2)]
            t = make()
            state = t.init(seed=3)
            kfn = t.multi_step_fn(2)
            state, _ = kfn(state, *stacks[0])  # the capture, on the seed-3 state
            Checkpointer(root / "resnet").restore_latest(state)
            restored_ok = not _unequal(_state_copy(state), at_2)
            state, replayed = kfn(state, *stacks[1])
            replayed = replayed.tolist()
            replay_state = _state_copy(state)
            del state
            state = t.init(seed=4)
            Checkpointer(root / "resnet").restore_latest(state)
            eager = []
            for i in range(2):
                state, m = t.train_step(state, stacks[1][0][i], stacks[1][1][i])
                eager.append(m["loss"].item())
            unequal = _unequal(replay_state, _state_copy(state))
            row = {"phase": "checkpoint_captured", "k": 2, "captures": kfn.captures,
                   "restored_in_place_equal": restored_ok, "replayed_losses": replayed,
                   "eager_losses": eager, "losses_bitwise_equal": replayed == eager,
                   "final_state_unequal": unequal, "nvidia_smi": smi}
            _emit(row)
            _require(kfn.captures == 1 and restored_ok, f"checkpoint captured: {row}")
            _require(replayed == eager and not unequal,
                     f"checkpoint: the replay after a restore differs from eager steps from the "
                     f"restored state at {unequal[:5]}: {replayed} against {eager}")
            del state, t, kfn, stacks, pool, straight_state, at_2
        finally:
            torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(root / "resnet")
        torch.cuda.empty_cache()

        # (d) The examples, as a user runs them twice with --checkpoint_dir.
        for name, main, argv in (
                ("llama_train", llama_train.main, SLICE_ARGS[:SLICE_ARGS.index("--steps")]
                 + ["--steps", str(CKPT_EXAMPLE_STEPS), "--log_every", "1", "--device", "cuda"]),
                ("resnet_imagenet", resnet_imagenet.main,
                 ["--depth", "50", "--global_batch_size", str(RESNET_BATCH), "--image_size",
                  str(RESNET_IMAGE), "--steps", str(CKPT_EXAMPLE_STEPS), "--log_every", "1",
                  "--use_pallas_head", "--device", "cuda"])):
            d = root / name
            runs = []
            for _ in range(2):
                t0 = time.perf_counter()
                result = main(argv + ["--checkpoint_dir", str(d)])
                torch.cuda.synchronize()
                runs.append({"start_step": result["start_step"], "end_step": result["end_step"],
                             "losses": [h["loss"] for h in result["history"]],
                             "wall_s": time.perf_counter() - t0})
                torch.cuda.empty_cache()
            row = {"phase": "checkpoint_example", "example": name, "args": argv,
                   "runs": runs, "committed_steps": Checkpointer(d).all_steps()}
            _emit(row)
            n = CKPT_EXAMPLE_STEPS
            _require([r["start_step"] for r in runs] == [0, n]
                     and [r["end_step"] for r in runs] == [n, 2 * n]
                     and row["committed_steps"] == [n, 2 * n]
                     and all(math.isfinite(v) for r in runs for v in r["losses"]),
                     f"checkpoint example {name}: {row}")
            shutil.rmtree(d)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches



def _kernel_free(counts: dict, what: str) -> None:
    """No kernel of the port launched (these paths run none)."""
    _require(not any(counts.values()), f"{what}: kernels launched {counts}")


def _random_norms(torch, model, seed: int) -> None:
    """Every BatchNorm's scale, bias, mean and variance drawn from a seeded
    generator (the initial zero ``bn3`` scales would hide each block's
    residual branch)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            scope, _, leaf = name.rpartition(".")
            if not scope.rpartition(".")[2].startswith("bn"):
                continue
            if leaf in ("weight", "var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            else:
                t.copy_(0.2 * torch.randn(t.shape, generator=gen))


def _detection_phase(torch, kernels_mod, smi: str, peak_flops: float) -> dict:
    """Phase 11: RetinaNet-R50-FPN with the mask head (see the module
    docstring).  Emits ``detection_parity``, ``detection``, ``profile``,
    ``detection_learn``, ``detection_eval`` and ``detection_example``;
    returns the launches of the port's kernels over the phase (none)."""
    import argparse
    import copy
    import shutil
    import tempfile

    from deeplearning_cfn_tpu_torch.examples import detection_train, resnet_imagenet
    from deeplearning_cfn_tpu_torch.models import retinanet
    from deeplearning_cfn_tpu_torch.train.data import SyntheticDetectionDataset, device_put_batch
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig

    cuda = torch.device("cuda")
    launches: dict = {}

    def count(what: str) -> None:
        got = dict(kernels_mod.launch_counts)
        _kernel_free(got, what)
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n

    def stream(batch: int, **kw):
        return SyntheticDetectionDataset(image_size=DET_IMAGE, num_classes=80,
                                         max_boxes=DET_MAX_BOXES, batch_size=batch,
                                         with_masks=True, **kw)

    anchors_cpu = torch.from_numpy(retinanet.generate_anchors(DET_IMAGE))
    anchors = anchors_cpu.to(cuda)

    # 1. Parity in f32 (TF32 off since phase 1): the card's forward against
    # the CPU's on the same weights, then predict on the same head outputs.
    kernels_mod.reset_launch_counts()
    cpu_model = retinanet.RetinaNet(**DET_ARCH, generator=torch.Generator().manual_seed(0))
    _random_norms(torch, cpu_model, 1)
    card_model = copy.deepcopy(cpu_model).to(cuda)
    x = torch.from_numpy(next(iter(stream(2, seed=3).batches(1))).x)
    with torch.no_grad():
        ref = cpu_model(x, train=False)
        got = [t.cpu() for t in card_model(x.to(cuda), train=False)]
    parity = {"phase": "detection_parity", "dtype": "float32", "B": 2, "image": DET_IMAGE,
              "anchors": int(anchors.shape[0]), "rtol_of_max": DET_PARITY_RTOL,
              "mean_rtol_of_max": DET_PARITY_MEAN_RTOL, "outputs": {}}
    for name, r, g in zip(("cls_logits", "box_deltas", "coeffs", "protos"), ref, got):
        err, scale = (g - r).abs(), max(1.0, r.abs().max().item())
        parity["outputs"][name] = {
            "shape": list(r.shape), "max_abs": r.abs().max().item(),
            "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
            "within": err.max().item() <= DET_PARITY_RTOL * scale
            and err.mean().item() <= DET_PARITY_MEAN_RTOL * scale}
    # The class logits moved up by 3 so that many anchors pass the 0.05
    # score threshold (at the prior's bias almost none would).
    head = [ref[0] + 3.0, ref[1], ref[2], ref[3]]
    want = retinanet.predict(head[0], head[1], anchors_cpu, coeffs=head[2], protos=head[3])
    card_head = [t.to(cuda) for t in head]

    def card_predict():
        return retinanet.predict(card_head[0], card_head[1], anchors, coeffs=card_head[2],
                                 protos=card_head[3])

    have = {k: v.cpu() for k, v in card_predict().items()}
    parity["predict"] = {
        "max_detections": 100, "valid_slots": int(want["valid"].sum()),
        "classes_equal": torch.equal(have["classes"], want["classes"]),
        "valid_equal": torch.equal(have["valid"], want["valid"]),
        "score_max_abs_err": (have["scores"] - want["scores"]).abs().max().item(),
        "box_max_abs_err": (have["boxes"] - want["boxes"]).abs().max().item(),
        "box_max_abs": want["boxes"].abs().max().item(),
        "boxes_within": torch.allclose(have["boxes"], want["boxes"], rtol=DET_BOX_RTOL,
                                       atol=DET_BOX_ATOL),
        "mask_pixels_differing": int((have["masks"] != want["masks"]).sum()),
        "score_atol": DET_SCORE_ATOL, "box_rtol": DET_BOX_RTOL, "box_atol": DET_BOX_ATOL,
        "card_ms": _time_ms(torch, card_predict, iters=3)}
    _emit(parity)
    count("detection parity")
    pp = parity["predict"]
    _require(all(o["within"] for o in parity["outputs"].values()),
             f"detection: the card's forward off the CPU's: {parity['outputs']}")
    _require(pp["classes_equal"] and pp["valid_equal"] and pp["valid_slots"] > 0
             and pp["score_max_abs_err"] <= DET_SCORE_ATOL and pp["boxes_within"],
             f"detection: predict on the card off the CPU's: {pp}")
    del cpu_model, card_model, ref, got, head, card_head, want, have
    torch.cuda.empty_cache()

    # 2. Training at full width, bf16, through fit (two producers), a
    # readback each step.
    arch = dict(DET_ARCH, dtype=torch.bfloat16)

    def loss_fn(model, x, y):
        return retinanet.detection_loss_with_masks(*model(x, train=True), anchors, y["boxes"],
                                                   y["classes"], y["masks"], 80)

    trainer = Trainer(lambda g: retinanet.RetinaNet(**arch, generator=g),
                      TrainerConfig(learning_rate=0.01, has_train_arg=True, grad_clip_norm=10.0,
                                    log_every=1),
                      loss_fn=loss_fn, device="cuda",
                      analytic_flops_fn=lambda x: retinanet.train_flops(arch, x.shape))
    state = trainer.init(seed=0)
    first = next(iter(stream(DET_BATCH).batches(1)))
    logger = trainer.throughput_logger(first.x, DET_BATCH, name="detection", log_every=1)
    steps = DET_WARMUP + DET_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    state, losses = trainer.fit(state, stream(DET_BATCH).batches(steps), steps=steps,
                                logger=logger, prefetch_workers=2)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    count("detection")
    terms = {k: float(v) for k, v in trainer.last_metrics.items()}
    step_ms = [DET_BATCH / h["examples_per_sec"] * 1e3 for h in logger.history]
    steady_ms = statistics.median(step_ms[DET_WARMUP:])
    run = {"phase": "detection", "model": "retinanet_r50_fpn_masks", "dtype": "bfloat16",
           "batch": DET_BATCH, "image": DET_IMAGE, "anchors": int(anchors.shape[0]),
           "steps": steps, "losses": losses, "step_ms": step_ms, "steady_step_ms": steady_ms,
           "images_per_s": DET_BATCH / steady_ms * 1e3,
           "flops_per_step": logger.flops_per_step, "peak_flops": peak_flops,
           "mfu": logger.flops_per_step / (steady_ms / 1e3) / peak_flops,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "last_step_terms": terms, "first_step_s": trainer.first_step_seconds,
           "wall_s": wall_s, "pipeline": trainer.last_pipeline_stats.snapshot(),
           "params": sum(p.numel() for p in state.model.parameters()), "nvidia_smi": smi}
    _emit(run)
    _require(len(losses) == steps and all(math.isfinite(v) for v in losses)
             and all(math.isfinite(v) for v in terms.values())
             and terms["num_pos"] > 0 and terms["mask_slots"] > 0,
             f"detection: losses {losses}, terms {terms}")
    x, y = device_put_batch(first, cuda)

    def step():
        nonlocal state
        state, _ = trainer.train_step(state, x, y)

    kernels_mod.reset_launch_counts()
    _emit({"phase": "profile", "path": "detection", **_profile(torch, step, 2)})
    count("detection profile")

    # 3. Learning: DET_LEARN_STEPS steps from a fresh state on one repeated batch.
    del state
    torch.cuda.empty_cache()
    state = trainer.init(seed=0)
    kernels_mod.reset_launch_counts()
    learn = []
    for _ in range(DET_LEARN_STEPS):
        state, m = trainer.train_step(state, x, y)
        learn.append(m["loss"])
    learn = torch.stack(learn).tolist()
    count("detection learn")
    _emit({"phase": "detection_learn", "steps": DET_LEARN_STEPS, "losses": learn,
           "ratio": learn[-1] / learn[0], "limit": DET_LEARN_RATIO})
    _require(all(math.isfinite(v) for v in learn) and learn[-1] < DET_LEARN_RATIO * learn[0],
             f"detection: the loss on one repeated batch did not fall below "
             f"{DET_LEARN_RATIO} of its start: {learn}")

    # 4. Eval: predict and DetectionAccumulator over held-out batches.
    args = argparse.Namespace(masks=True, image_size=DET_IMAGE, num_classes=80,
                              max_boxes=DET_MAX_BOXES)
    kernels_mod.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = detection_train.evaluate_map(trainer, state, anchors, args, DET_BATCH,
                                      steps=DET_EVAL_BATCHES)
    eval_s = time.perf_counter() - t0
    count("detection eval")
    _emit({"phase": "detection_eval", "batches": DET_EVAL_BATCHES, "batch": DET_BATCH,
           "ms_per_batch": eval_s * 1e3 / DET_EVAL_BATCHES, "images": ev["images"],
           "mAP": ev["mAP"], "mask_mAP": ev["mask_mAP"],
           "mask_mAP_stride": ev["mask_mAP_stride"]})
    _require(ev["images"] == DET_EVAL_BATCHES * DET_BATCH
             and all(0.0 <= ev[k] <= 1.0 for k in ("mAP", "mask_mAP", "mask_mAP_stride")),
             f"detection eval: {ev}")
    del trainer, state, x, y
    torch.cuda.empty_cache()

    # 5. The example a user runs, from a ResNet-50 classifier's checkpoint.
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_det-"))
    try:
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        resnet_imagenet.main(["--depth", "50", "--global_batch_size", "8", "--image_size", "64",
                              "--steps", "1", "--checkpoint_dir", str(root / "cls"),
                              "--device", "cuda"])
        result = detection_train.main(DET_EXAMPLE_ARGS + ["--backbone_ckpt", str(root / "cls")])
        torch.cuda.synchronize()
        count("detection example")
        with torch.device("meta"):  # the example's default backbone, ResNet-50
            backbone_tensors = len(retinanet.RetinaNet(
                backbone_stages=detection_train.BACKBONES["resnet50"]).backbone.state_dict())
        row = {"phase": "detection_example", "args": DET_EXAMPLE_ARGS + ["--backbone_ckpt"],
               "steps": result["steps"], "losses": [h["loss"] for h in result["history"]],
               "backbone_tensors_transferred": result["backbone_tensors_transferred"],
               "backbone_tensors": backbone_tensors,
               "eval": {k: result["eval"][k] for k in ("mAP", "mask_mAP", "mask_mAP_stride")},
               "first_step_s": result["first_step_s"], "wall_s": time.perf_counter() - t0}
        _emit(row)
        _require(result["steps"] == 3 and all(math.isfinite(v) for v in row["losses"])
                 and row["backbone_tensors_transferred"] == backbone_tensors,
                 f"detection example: {row}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def _cifar_phase(torch, kernels_mod, smi: str) -> dict:
    """Phase 12: ``cifar10_train`` (VGG-11) and ``lenet_mnist`` as a user
    runs them.  Emits one ``cifar10`` line an example; returns the launches
    of the port's kernels over the phase (none)."""
    from deeplearning_cfn_tpu_torch.examples import cifar10_train, lenet_mnist

    launches: dict = {}
    for name, main, argv in (("cifar10_train", cifar10_train.main, CIFAR_ARGS),
                             ("lenet_mnist", lenet_mnist.main, LENET_ARGS)):
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        result = main(argv)
        torch.cuda.synchronize()
        got = dict(kernels_mod.launch_counts)
        _kernel_free(got, name)
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        batch = 64
        rate = statistics.median(h["examples_per_sec"] for h in result["history"][1:])
        row = {"phase": "cifar10", "example": name, "args": argv, "steps": result["steps"],
               "losses": [h["loss"] for h in result["history"]],
               "step_ms": [batch / h["examples_per_sec"] * 1e3 for h in result["history"]],
               "steady_step_ms": batch / rate * 1e3, "images_per_s": rate,
               "first_step_s": result["first_step_s"], "wall_s": time.perf_counter() - t0,
               "eval": result.get("eval"), "nvidia_smi": smi}
        _emit(row)
        _require(result["steps"] == 20 and all(math.isfinite(v) for v in row["losses"]),
                 f"{name}: {row}")
        if name == "cifar10_train":
            _require(math.isfinite(result["eval"]["loss"]) and result["eval"]["examples"] == 128,
                     f"{name} eval: {result['eval']}")
        torch.cuda.empty_cache()
    return launches

@contextlib.contextmanager
def _opened_loaders():
    """The record loaders opened in the block, by class name."""
    from deeplearning_cfn_tpu_torch.train import native_loader

    opened: list[str] = []
    saved = {cls: cls.__post_init__ for cls in (native_loader.NativeRecordLoader,
                                                native_loader.PythonRecordLoader)}

    def recording(init):
        def post_init(self):
            opened.append(type(self).__name__)
            init(self)
        return post_init

    for cls, init in saved.items():
        cls.__post_init__ = recording(init)
    try:
        yield opened
    finally:
        for cls, init in saved.items():
            cls.__post_init__ = init


def _convert(argv: list) -> dict:
    """``cli convert`` as a user runs it; its JSON summary, parsed."""
    import io

    from deeplearning_cfn_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["convert", *argv])
    _require(rc == 0, f"cli convert {argv}: exit {rc}")
    return json.loads(out.getvalue())


def _records_phase(torch, kernels_mod, smi: str, flash_per_block: float) -> dict:
    """Phase 13: the record-backed input plane (see the module docstring).
    Emits ``records_convert``, ``records_resnet``, ``records_llama``,
    ``records_bert`` and ``records_small``; returns the launches of the
    port's kernels over the phase."""
    import shutil
    import tempfile

    import numpy as np
    from PIL import Image

    from deeplearning_cfn_tpu_torch.examples import (
        bert_pretrain,
        cifar10_train,
        detection_train,
        llama_train,
        resnet_imagenet,
    )
    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.obs.profiler import PHASES
    from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder
    from deeplearning_cfn_tpu_torch.train.data import SyntheticDetectionDataset
    from deeplearning_cfn_tpu_torch.train.datasets import instance_spec
    from deeplearning_cfn_tpu_torch.train.records import write_records

    t_phase = time.perf_counter()
    launches: dict = {}

    def run(main, argv):
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        with _opened_loaders() as opened:
            result = main(argv)
        torch.cuda.synchronize()
        got = dict(kernels_mod.launch_counts)
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        return result, got, opened, time.perf_counter() - t0

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_records_"))
    try:
        # a. ImageNet-layout sources -> cli convert (margin records + a val split).
        t0 = time.perf_counter()
        rng = np.random.default_rng(0)
        blocks = rng.integers(0, 256, (REC_CLASSES, 8, 8, 3)).astype(np.int16)
        cell = REC_SRC_PX // 8
        for split, per_class in (("train", REC_TRAIN_PER_CLASS), ("val", REC_VAL_PER_CLASS)):
            for c in range(REC_CLASSES):
                d = tmp / "imagenet" / split / f"n{c:08d}"
                d.mkdir(parents=True)
                base = np.kron(blocks[c], np.ones((cell, cell, 1), np.int16))
                for i in range(per_class):
                    noise = rng.integers(-40, 41, base.shape, dtype=np.int16)
                    img = np.clip(base + noise, 0, 255).astype(np.uint8)
                    Image.fromarray(img).save(d / f"{split}_{c}_{i}.JPEG", quality=90)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        image_dir = tmp / "imagenet" / "records"
        train_out = _convert(["--format", "imagefolder", "--src", str(tmp / "imagenet" / "train"),
                              "--out", str(image_dir), "--size", str(RESNET_IMAGE),
                              "--margin", str(REC_MARGIN)])
        val_out = _convert(["--format", "imagefolder", "--src", str(tmp / "imagenet" / "val"),
                            "--out", str(image_dir), "--size", str(RESNET_IMAGE),
                            "--split", "val"])
        convert_s = time.perf_counter() - t0
        stored = RESNET_IMAGE + REC_MARGIN
        _emit({"phase": "records_convert", "route": "cli convert --format imagefolder",
               "train": train_out, "val": val_out, "write_sources_s": write_s,
               "convert_s": convert_s,
               "train_bytes": (image_dir / "train.dlc").stat().st_size,
               "val_bytes": (image_dir / "val.dlc").stat().st_size})
        _require(train_out["records"] == {"train": REC_CLASSES * REC_TRAIN_PER_CLASS}
                 and train_out["stored_px"] == stored
                 and val_out["records"] == {"val": REC_CLASSES * REC_VAL_PER_CLASS},
                 f"records: conversions {train_out} {val_out}")

        # ResNet-50 from the records, through the native loader and the
        # prefetcher, the steps profiled; then the whole val split.
        argv = REC_RESNET_ARGS + ["--data_dir", str(image_dir)]
        result, got, opened, wall_s = run(resnet_imagenet.main, argv)
        steady = result["history"][1:]
        rate = statistics.median(h["examples_per_sec"] for h in steady)
        prof = result["profile"]
        step_mean = prof["step_ms"]["mean"]
        # The journaled step_time events hold each step's critical phases
        # only (the producers' overlapped copies are in the profile's h2d):
        # their medians over steps 2.. are the steady step's breakdown.
        per_step = [e for e in get_recorder().tail(4096)
                    if e["kind"] == "step_time" and e.get("profiler") == prof["name"]]
        per_step = per_step[-REC_RESNET_STEPS:][1:]
        breakdown = {f"{p}_ms": statistics.median(e.get(f"{p}_ms", 0.0) for e in per_step)
                     for p in (*PHASES, "total")}
        n_eval = -(-REC_CLASSES * REC_VAL_PER_CLASS // RESNET_BATCH)
        row = {"phase": "records_resnet", "args": argv, "steps": result["steps"],
               "losses": [h["loss"] for h in result["history"]],
               "step_ms": [RESNET_BATCH / h["examples_per_sec"] * 1e3 for h in result["history"]],
               "steady_step_ms": RESNET_BATCH / rate * 1e3, "images_per_s": rate,
               "mfu": statistics.median(h["mfu"] for h in steady),
               "profile": prof, "steady_breakdown": breakdown,
               "steady_data_wait_share": breakdown["data_wait_ms"] / breakdown["total_ms"],
               "steady_h2d_share": breakdown["h2d_ms"] / breakdown["total_ms"],
               "data_wait_share": prof["data_wait_ms"] / step_mean,
               "h2d_share": prof["h2d_ms"] / step_mean,
               "pipeline": result["pipeline"], "eval": result["eval"], "loaders": opened,
               "launches": got, "first_step_s": result["first_step_s"], "wall_s": wall_s,
               "nvidia_smi": smi}
        _emit(row)
        _require(result["steps"] == REC_RESNET_STEPS
                 and all(math.isfinite(v) for v in row["losses"]), f"records_resnet: {row}")
        _require(opened and set(opened) == {"NativeRecordLoader"},
                 f"records_resnet: loaders {opened}, expected the native loader only")
        _require(result["eval"]["split"] == "heldout-full"
                 and result["eval"]["examples"] == REC_CLASSES * REC_VAL_PER_CLASS
                 and math.isfinite(result["eval"]["loss"]), f"records_resnet eval: {result['eval']}")
        _require(_variants(got, "fused_dense") == {F32_SPLITK: REC_RESNET_STEPS + n_eval},
                 f"records_resnet: the kernel head launched {got}, expected one {F32_SPLITK} "
                 f"a step and one an eval batch")
        del result
        torch.cuda.empty_cache()

        # b. The tree's own Python sources, one text file -> byte-level token
        # records at seq 2048 and 128.
        corpus = tmp / "corpus"
        corpus.mkdir()
        root = Path(__file__).resolve().parent
        sources = sorted((root / "deeplearning_cfn_tpu").rglob("*.py"))
        with open(corpus / "corpus.txt", "wb") as f:
            for src in sources:
                f.write(src.read_bytes())
        text = {}
        for seq in (2048, BERT_SEQ):
            text[seq] = _convert(["--format", "text", "--src", str(corpus), "--out",
                                  str(tmp / f"tokens{seq}"), "--seq-len", str(seq)])
        _emit({"phase": "records_text", "files": len(sources),
               "bytes": (corpus / "corpus.txt").stat().st_size, "converted": text})

        argv = REC_LLAMA_ARGS + ["--data_dir", str(tmp / "tokens2048")]
        result, got, opened, wall_s = run(llama_train.main, argv)
        cfg = llama.LlamaConfig.m435(seq_len=2048)
        losses = [h["loss"] for h in result["history"]]
        row = {"phase": "records_llama", "args": argv, **_run_summary(result, 8 * 2048, 8 * 2048),
               "loaders": opened, "launches": got, "wall_s": wall_s,
               **_flash_check(got, REC_LLAMA_STEPS, flash_per_block * cfg.n_layers,
                              "records_llama")}
        _emit(row)
        _require(len(losses) == REC_LLAMA_STEPS and all(math.isfinite(v) for v in losses),
                 f"records_llama: {losses}")
        _require(statistics.mean(losses[-2:]) < losses[0],
                 f"records_llama: the loss on text records did not fall: {losses}")
        _require(set(opened) == {"NativeRecordLoader"}, f"records_llama: loaders {opened}")
        del result
        torch.cuda.empty_cache()

        # c. BERT-base with the kernel MLP on the seq-128 records.
        argv = REC_BERT_ARGS + ["--data_dir", str(tmp / f"tokens{BERT_SEQ}")]
        result, got, opened, wall_s = run(bert_pretrain.main, argv)
        losses = [h["loss"] for h in result["history"]]
        variants = _variants(got, "fused_dense")
        row = {"phase": "records_bert", "args": argv,
               **_run_summary(result, BERT_BATCH, BERT_BATCH * BERT_SEQ),
               "mask_token": result.get("mask_token"), "loaders": opened, "launches": got,
               "fused_dense_launches_per_step": got["fused_dense"] / REC_BERT_STEPS,
               "wall_s": wall_s}
        _emit(row)
        _require(len(losses) == REC_BERT_STEPS and all(math.isfinite(v) for v in losses),
                 f"records_bert: {losses}")
        _require(result.get("mask_token") == 257, f"records_bert: mask id {row['mask_token']}")
        _require(got["fused_dense"] == 24 * REC_BERT_STEPS
                 and sum(n for v, n in variants.items() if v.startswith("wgmma_tma"))
                 == got["fused_dense"], f"records_bert: fused-dense launches {variants}, "
                 f"expected 24 a step in the wgmma variants")
        _require(set(opened) == {"NativeRecordLoader"}, f"records_bert: loaders {opened}")
        del result
        torch.cuda.empty_cache()

        # d. VGG-11 from converted CIFAR-10 pickles, with the held-out split
        # scored whole; RetinaNet with masks from instance records.
        cifar = tmp / "cifar" / "cifar-10-batches-py"
        cifar.mkdir(parents=True)
        crng = np.random.default_rng(1)
        templates = crng.integers(0, 256, (10, 3072)).astype(np.int16)
        for name, n in (("data_batch_1", REC_CIFAR_PER_BATCH),
                        ("data_batch_2", REC_CIFAR_PER_BATCH), ("test_batch", REC_CIFAR_TEST)):
            labels = crng.integers(0, 10, n)
            data = np.clip(templates[labels] + crng.integers(-60, 61, (n, 3072)), 0, 255)
            with open(cifar / name, "wb") as f:
                pickle.dump({b"data": data.astype(np.uint8), b"labels": labels.tolist()}, f)
        cifar_out = _convert(["--format", "cifar10", "--src", str(tmp / "cifar"), "--out",
                              str(tmp / "cifar_records")])
        det_dir = tmp / "detection"
        spec = instance_spec(DET_IMAGE, DET_MAX_BOXES)
        det = SyntheticDetectionDataset(image_size=DET_IMAGE, num_classes=80,
                                        max_boxes=DET_MAX_BOXES, batch_size=8, seed=5,
                                        with_masks=True)
        recs = []
        for b in det.batches(REC_DET_RECORDS // 8):
            x = np.clip(np.rint(b.x * 80.0), 0, 255).astype(np.uint8)
            recs += [spec.encode(x=x[i], boxes=b.y["boxes"][i], classes=b.y["classes"][i],
                                 masks=b.y["masks"][i]) for i in range(len(x))]
        write_records(det_dir / "train.dlc", spec, recs)
        small = {}
        for name, main, argv in (
                ("cifar10_train", cifar10_train.main,
                 CIFAR_ARGS + ["--full_eval", "--data_dir", str(tmp / "cifar_records"),
                               "--eval_data_dir", str(tmp / "cifar_records")]),
                ("detection_train", detection_train.main,
                 ["--masks", "--steps", str(REC_DET_STEPS), "--global_batch_size", "8",
                  "--log_every", "1", "--data_dir", str(det_dir), "--device", "cuda"])):
            result, got, opened, wall_s = run(main, argv)
            losses = [h["loss"] for h in result["history"]]
            small[name] = {"args": argv, "losses": losses, "eval": result.get("eval"),
                           "loaders": opened, "launches": got, "wall_s": wall_s}
            _kernel_free(got, f"records {name}")
            _require(losses and all(math.isfinite(v) for v in losses),
                     f"records {name}: {losses}")
            _require(set(opened) == {"NativeRecordLoader"}, f"records {name}: loaders {opened}")
            torch.cuda.empty_cache()
        ev = small["cifar10_train"]["eval"]
        _require(ev["split"] == "heldout-full" and ev["examples"] == REC_CIFAR_TEST
                 and math.isfinite(ev["loss"]), f"records cifar10_train eval: {ev}")
        _emit({"phase": "records_small", "cifar_converted": cifar_out, **small})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _emit({"phase": "records_done", "wall_s": time.perf_counter() - t_phase,
           "launches": launches})
    return launches


def _llama8b_phase(torch, kernels_mod, smi: str) -> dict:
    """Phase 14: Llama-3-8B on one card (see the module docstring).  Returns
    the example's launches (the flash kernel's row at the 8B shape is phase
    3's)."""
    from deeplearning_cfn_tpu_torch.examples import llama_train
    from deeplearning_cfn_tpu_torch.models import llama, llama_import, llama_memory
    from deeplearning_cfn_tpu_torch.train.data import SyntheticTokenDataset, device_put_batch
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    gib = 1024**3
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), use_flash_attention=True)
    _emit({"phase": "llama8b_start", "memory_allocated_bytes": torch.cuda.memory_allocated(),
           "params": llama.param_count(cfg)})

    # b. llama_memory.validate_on_device: two steps at batch 1.
    val = llama_memory.validate_on_device(cfg, batch_global=1, seq_len=L8B_SEQ,
                                          steps=L8B_VALIDATE_STEPS, cfg_name="llama3_8b",
                                          optimizer="adafactor")
    _emit({"phase": "llama8b_validate", **val, "nvidia_smi": smi})
    _require(all(math.isfinite(v) for v in val["losses"]), f"llama8b_validate: {val['losses']}")
    _require(val["measured_peak_gib"] <= val["predicted_gib"],
             f"llama8b_validate: peak {val['measured_peak_gib']} GiB over the prediction "
             f"{val['predicted_gib']}")
    torch.cuda.empty_cache()

    # c. The example a user runs: the main path, counters zeroed just before.
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    result = llama_train.main(L8B_ARGS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(kernels_mod.launch_counts)
    peak = torch.cuda.max_memory_allocated() - base
    predicted = llama_memory.memory_report(cfg, {"fsdp": 1}, L8B_BATCH, L8B_SEQ,
                                           optimizer="adafactor", cfg_name="llama3_8b",
                                           grad_accum=L8B_ACCUM)
    tokens = L8B_BATCH * L8B_SEQ
    run = {"phase": "llama8b", "args": L8B_ARGS, **_run_summary(result, tokens, tokens),
           "flops_per_step": llama.train_flops_per_token(cfg, L8B_SEQ) * tokens,
           "wall_s": wall_s, "measured_peak_gib": peak / gib,
           "predicted_gib": predicted.total_gib, "predicted": vars(predicted),
           "prediction_error_pct": 100.0 * (predicted.total_gib - peak / gib) / (peak / gib),
           "launches": launches,
           **_flash_check(launches, L8B_STEPS, 2 * cfg.n_layers * L8B_ACCUM, "llama8b"),
           "nvidia_smi": smi}
    _emit(run)
    _require(len(run["losses"]) == L8B_STEPS and all(math.isfinite(v) for v in run["losses"]),
             f"llama8b: losses {run['losses']}")
    _require(peak / gib <= predicted.total_gib,
             f"llama8b: peak {peak / gib} GiB over the prediction {predicted.total_gib}")
    del result
    torch.cuda.empty_cache()
    # One more step of the same program, profiled by kernel.
    trainer = llama.make_trainer(cfg, TrainerConfig(
        optimizer="adafactor", learning_rate=1e-2, weight_decay=0.1, grad_clip_norm=1.0,
        grad_accum_steps=L8B_ACCUM), device="cuda")
    state = trainer.init(seed=0, draw_on_device=True)
    x, y = device_put_batch(next(SyntheticTokenDataset(
        seq_len=L8B_SEQ, vocab_size=cfg.vocab_size, batch_size=L8B_BATCH).batches(1)),
        torch.device("cuda"))

    def step():
        nonlocal state
        state, _ = trainer.train_step(state, x, y)

    step()
    _emit({"phase": "profile", "path": "llama8b", **_profile(torch, step, 1)})
    del trainer, state, x, y
    torch.cuda.empty_cache()

    # d. An HF-layout state dict at Llama-3-8B's shapes, drawn in bf16 on the
    # card (tensor i from seed i), through the importer.
    shapes = llama_import.expected_hf_shapes(cfg)

    def source(i, shape):
        g = torch.Generator(device="cuda").manual_seed(i)
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    sd = {key: source(i, shape) for i, (key, shape) in enumerate(shapes.items())}
    model_bytes = sum(t.nbytes for t in sd.values())
    largest = max(t.nbytes for t in sd.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    imported = llama_import.from_hf_state_dict(cfg, sd)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    import_peak = torch.cuda.max_memory_allocated() - base
    hf_to_port = {"model.embed_tokens.weight": "embed", "model.norm.weight": "final_norm",
                  "lm_head.weight": "output"}
    for i in range(cfg.n_layers):
        for hf, ours, _ in llama_import.HF_LAYER_KEYS:
            hf_to_port[f"model.layers.{i}.{hf}"] = f"layers.{i}.{ours}"
    mismatched = []
    for i, (key, shape) in enumerate(shapes.items()):
        want = source(i, shape)
        if len(shape) == 2 and key != "model.embed_tokens.weight":
            want = want.T
        got = imported[hf_to_port[key]]
        if got.shape != want.shape or not torch.equal(got.float(), want.float()):
            mismatched.append(key)
    row = {"phase": "llama8b_import", "tensors": len(shapes), "model_bytes": model_bytes,
           "largest_tensor_bytes": largest, "import_s": import_s, "peak_bytes": import_peak,
           "peak_bound_bytes": IMPORT_PEAK_MARGIN * (model_bytes + largest),
           "source_left": len(sd), "mismatched": mismatched, "nvidia_smi": smi}
    _emit(row)
    _require(not mismatched and not sd, f"llama8b_import: {len(mismatched)} tensors differ, "
             f"{len(sd)} left in the source")
    _require(import_peak <= row["peak_bound_bytes"],
             f"llama8b_import: peak {import_peak} B over {row['peak_bound_bytes']}")
    del imported, sd
    torch.cuda.empty_cache()

    # e. TrainerConfig.remat on one m435 step, against the same step without.
    mcfg = llama.LlamaConfig.m435(seq_len=2048)
    x, y = device_put_batch(next(SyntheticTokenDataset(
        seq_len=2048, vocab_size=mcfg.vocab_size, batch_size=8).batches(1)), torch.device("cuda"))
    grads, remat_runs = {}, {}
    # remat off; on, nested over the preset's "dots" remat a block; on alone.
    for remat in ("off", "on", "on_without_block_remat"):
        trainer = llama.make_trainer(
            mcfg if remat != "on_without_block_remat" else dataclasses.replace(mcfg, remat=False),
            TrainerConfig(optimizer="sgd", learning_rate=1e-3, remat=remat != "off"),
            device="cuda")
        state = trainer.init(seed=0, draw_on_device=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, x, y)
        loss = metrics["loss"].item()
        remat_runs[remat] = {"loss": loss, "step_s": time.perf_counter() - t0,
                             "peak_bytes": torch.cuda.max_memory_allocated() - base,
                             "flash_launches": kernels_mod.launch_counts["flash_attention_fwd"]}
        grads[remat] = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
        del trainer, state
        torch.cuda.empty_cache()
    worst = max((grads[r][n].float() - g.float()).abs().max().item()
                / max(g.float().abs().max().item(), 1e-30)
                for r in ("on", "on_without_block_remat") for n, g in grads["off"].items())
    row = {"phase": "llama8b_remat", "model": "m435", "B": 8, "S": 2048, **remat_runs,
           "grad_max_rel_diff": worst, "grad_rtol": REMAT_GRAD_RTOL,
           "bitwise_equal": all(torch.equal(grads[r][n], g) for r in ("on", "on_without_block_remat")
                                for n, g in grads["off"].items()),
           "nvidia_smi": smi}
    _emit(row)
    _require(worst <= REMAT_GRAD_RTOL, f"llama8b_remat: gradients {worst} apart")
    _require(remat_runs["on"]["peak_bytes"] <= remat_runs["off"]["peak_bytes"],
             f"llama8b_remat: the peak with remat on, {remat_runs['on']['peak_bytes']} B, over "
             f"the peak without it, {remat_runs['off']['peak_bytes']} B")
    del grads, x, y
    torch.cuda.empty_cache()
    return {"launches": launches}


def _pp_layout_phase(torch, kernels_mod, smi: str, flash_per_block: float) -> int:
    """Phase 15 (see the module docstring).  Returns its flash launches."""
    import numpy as np

    from deeplearning_cfn_tpu_torch import interop
    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.parallel import pipeline
    from deeplearning_cfn_tpu_torch.train.data import SyntheticTokenDataset, device_put_batch
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    cfg = llama.LlamaConfig.m435(seq_len=2048)
    pcfg = dataclasses.replace(cfg, pp_stages=PP_STAGES, pp_microbatches=PP_MICROBATCHES)
    # The JAX tree of weights drawn on the card: [L, ...] layers stacked into
    # [pp, L/pp, ...] stages, on the host in f32 (bf16 values, exactly).
    t0 = time.perf_counter()
    drawn = _llama_on_card(torch, llama, cfg, seed=0).state_dict()
    host = {k: v.float().cpu().numpy() for k, v in drawn.items()}
    del drawn
    names = llama.layer_param_shapes(cfg)
    tree = {"embed": host["embed"], "final_norm": host["final_norm"],
            "layers": pipeline.stack_stages(
                {n: np.stack([host[f"layers.{i}.{n}"] for i in range(cfg.n_layers)])
                 for n in names}, PP_STAGES)}
    del host
    weights = {"stage_stacked": interop.llama_params_from_jax(pcfg, tree),
               "unstacked": interop.llama_params_from_jax(
                   cfg, {**tree, "layers": pipeline.unstack_stages(tree["layers"])})}
    layout_s = time.perf_counter() - t0
    stacked_shape = list(tree["layers"]["wq"].shape)
    del tree
    x, y = device_put_batch(next(SyntheticTokenDataset(
        seq_len=2048, vocab_size=cfg.vocab_size, batch_size=PP_BATCH).batches(1)),
        torch.device("cuda"))
    tcfg = TrainerConfig(optimizer="adamw", learning_rate=3e-4, weight_decay=0.1,
                         grad_clip_norm=1.0, log_every=1)
    runs, logits, finals = {}, {}, {}
    for path, c in (("stage_stacked", pcfg), ("unstacked", cfg)):
        with torch.device("meta"):
            model = llama.Llama(c)
        model = model.to_empty(device="cuda")
        model.load_state_dict(weights[path])
        trainer = llama.make_trainer(c, tcfg, device="cuda")
        state = trainer.init_from(model)
        with torch.no_grad():
            logits[path] = llama.forward(state.model, x[:2])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels_mod.reset_launch_counts()
        losses, step_ms = [], []
        for _ in range(PP_STEPS):
            t0 = time.perf_counter()
            state, metrics = trainer.train_step(state, x, y)
            losses.append(metrics["loss"].item())
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = dict(kernels_mod.launch_counts)
        runs[path] = {"losses": losses, "step_ms": step_ms,
                      "steady_step_ms": statistics.median(step_ms[1:]),
                      "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                      "blocks": len(state.model.blocks()), "pipelined": state.model.pipelined,
                      "launches": launches,
                      **_flash_check(launches, PP_STEPS, flash_per_block * c.n_layers,
                                     f"pp_layout ({path})")}
        finals[path] = _param_copy(state.model)
        del trainer, state, model
        torch.cuda.empty_cache()
    del weights
    logits_equal = torch.equal(logits["stage_stacked"], logits["unstacked"])
    params_equal = all(torch.equal(finals["stage_stacked"][n], p)
                       for n, p in finals["unstacked"].items())
    row = {"phase": "pp_layout", "model": "m435", "pp_stages": PP_STAGES,
           "pp_microbatches": PP_MICROBATCHES, "B": PP_BATCH, "S": 2048,
           "jax_layers_wq_shape": stacked_shape, "layout_s": layout_s,
           "runs_at_pp": 1, "microbatches_run": 1,
           "gpipe_across_ranks": "CPU gloo ranks (tests/test_torch_pipeline.py): gloo's "
                                 "send/recv refuses CUDA tensors (tools/gloo_cuda_probe.py)",
           **{f"{k}_{p}": v for p, r in runs.items() for k, v in r.items()},
           "logits_bitwise_equal": logits_equal,
           "losses_bitwise_equal": runs["stage_stacked"]["losses"] == runs["unstacked"]["losses"],
           "params_bitwise_equal": params_equal, "nvidia_smi": smi}
    _emit(row)
    _require(all(math.isfinite(v) for v in runs["stage_stacked"]["losses"]),
             "pp_layout: non-finite loss")
    _require(runs["stage_stacked"]["blocks"] == cfg.n_layers
             and not runs["stage_stacked"]["pipelined"], "pp_layout: the layout at pp 1")
    _require(logits_equal and row["losses_bitwise_equal"] and params_equal,
             "pp_layout: the stage-stacked model is not the unstaged one")
    del logits, finals, x, y
    torch.cuda.empty_cache()
    return runs["stage_stacked"]["flash_launches"]


def _two_ranks_worker(rank: int, port: int, out: str) -> int:
    """One of ``two_ranks``' processes (``chip_smoke.py --two-ranks-worker
    RANK PORT OUT``): the runs of phase 16 on this rank's half of the
    batches, its results as JSON in ``OUT.rank<RANK>``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.ops import _kernels
    from deeplearning_cfn_tpu_torch.parallel import overlap
    from deeplearning_cfn_tpu_torch.parallel.mesh import hybrid_mesh_for_slices, mesh_spec
    from deeplearning_cfn_tpu_torch.train.data import SyntheticTokenDataset, device_put_batch
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    class Unsynced(overlap.BucketedGradSync):
        """The planted control: the first bucket keeps each rank's own
        gradient (never all-reduced)."""

        def _issue(self, b):
            if b:
                return super()._issue(b)
            self.issued.append(b)
            self._runs.append(overlap._Run(b, self._flat(b) * self.nd))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    mesh = hybrid_mesh_for_slices(int(os.environ["DEEPLEARNING_SLICES_COUNT"]))
    cfg = llama.LlamaConfig.m435(seq_len=2048)
    batches = [device_put_batch(b, torch.device("cuda")) for b in SyntheticTokenDataset(
        seq_len=2048, vocab_size=cfg.vocab_size,
        batch_size=2 * TWO_RANK_BATCH).batches(TWO_RANK_STEPS)]
    runs, finals = {}, {}
    for name, kw in (("hookless", {}), ("overlap", {"comms_overlap": True}),
                     ("control", {"comms_overlap": True}),
                     ("int8", {"comms_overlap": True, "overlap_compress": True})):
        trainer = llama.make_trainer(cfg, TrainerConfig(
            strategy="dp", optimizer="adamw", learning_rate=3e-4, weight_decay=0.1,
            grad_clip_norm=1.0, log_every=1, **kw), device="cuda", mesh=mesh)
        state = trainer.init(seed=0, draw_on_device=True)
        if name == "control":
            old = state.grad_sync
            old.remove()
            state.grad_sync = Unsynced(old.members, old.group, old.nd)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        losses, step_ms = [], []
        for x, y in batches:
            t0 = time.perf_counter()
            state, metrics = trainer.train_step(state, x, y)
            losses.append(metrics["loss"].item())
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = dict(_kernels.launch_counts)
        sync = state.grad_sync
        if sync is None:  # DDP's ring all-reduce of every gradient
            sent = sum(2 * (2 - 1) / 2 * p.numel() * p.element_size()
                       for p in state.model.parameters())
        else:
            sent = sync.wire_bytes
        runs[name] = {"losses": losses, "step_ms": step_ms,
                      "steady_step_ms": statistics.median(step_ms[1:]),
                      "bytes_sent_per_step": sent,
                      "buckets": None if sync is None else len(sync.members),
                      "issued_last_step": None if sync is None else list(sync.issued),
                      "ddp": state.runner is not None,
                      "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                      "flash_launches": launches.get("flash_attention_fwd", 0),
                      "flash_variants": _variants(launches, "flash_attention_fwd")}
        finals[name] = [p.detach().clone() for p in state.model.parameters()]
        del trainer, state, sync
        torch.cuda.empty_cache()
    base = finals["hookless"]
    result = {"rank": rank, "mesh": mesh_spec(mesh).axis_sizes(), "mesh_grid": mesh.mesh.tolist(),
              "runs": runs,
              **{f"{n}_bitwise_hookless": runs[n]["losses"] == runs["hookless"]["losses"]
                 and all(torch.equal(p, q) for p, q in zip(finals[n], base))
                 for n in ("overlap", "control", "int8")}}
    dist.destroy_process_group()
    Path(f"{out}.rank{rank}").write_text(json.dumps(result))
    return 0


def _two_ranks_phase(torch, smi: str, flash_per_block: float) -> int:
    """Phase 16 (see the module docstring): two processes of this script on
    the card.  Returns the flash launches of both processes' runs."""
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    n_layers = 24
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "two_ranks")
        env = dict(os.environ, DEEPLEARNING_SLICES_COUNT="2")
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                   "--two-ranks-worker", str(r), str(port), out],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for r in range(2)]
        errs = []
        try:
            for p in procs:
                _, err = p.communicate(timeout=TWO_RANK_TIMEOUT)
                errs.append(err)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall_s = time.perf_counter() - t0
        for p, err in zip(procs, errs):
            _require(p.returncode == 0, f"two_ranks: a process failed:\n{err[-3000:]}")
        ranks = [json.loads(Path(f"{out}.rank{r}").read_text()) for r in range(2)]
    runs = {name: {"losses": ranks[0]["runs"][name]["losses"],
                   "losses_rank1": ranks[1]["runs"][name]["losses"],
                   **{k: [r["runs"][name][k] for r in ranks] for k in (
                       "steady_step_ms", "step_ms", "bytes_sent_per_step", "buckets",
                       "max_memory_allocated_bytes", "flash_launches", "flash_variants")},
                   "issued_last_step": ranks[0]["runs"][name]["issued_last_step"]}
            for name in ranks[0]["runs"]}
    f32, int8 = runs["overlap"]["losses"], runs["int8"]["losses"]
    int8_gap = max(abs(a - b) - INT8_RTOL * abs(b) for a, b in zip(int8, f32))
    row = {"phase": "two_ranks", "processes": 2, "device": "cuda:0 for both",
           "backend": "gloo over CUDA tensors (host-staged)", "slices": 2,
           "mesh": ranks[0]["mesh"], "model": "m435", "S": 2048, "batch_per_rank": TWO_RANK_BATCH,
           "steps": TWO_RANK_STEPS, "times": "gloo, host-staged: not NVLink times",
           "wall_s": wall_s, "runs": runs,
           "overlap_bitwise_hookless": [r["overlap_bitwise_hookless"] for r in ranks],
           "control_bitwise_hookless": [r["control_bitwise_hookless"] for r in ranks],
           "int8_vs_f32_max_excess": int8_gap, "int8_rtol": INT8_RTOL, "int8_atol": INT8_ATOL,
           "nvidia_smi": smi}
    _emit(row)
    for name, run in runs.items():
        _require(all(math.isfinite(v) for v in run["losses"] + run["losses_rank1"]),
                 f"two_ranks ({name}): non-finite loss")
        per_step = flash_per_block * n_layers
        _require(all(n == per_step * TWO_RANK_STEPS for n in run["flash_launches"])
                 and all(v == {"wgmma_tma": per_step * TWO_RANK_STEPS}
                         for v in run["flash_variants"]),
                 f"two_ranks ({name}): flash launched {run['flash_variants']}")
    _require(ranks[0]["mesh"]["dp"] == 2, f"two_ranks: mesh {ranks[0]['mesh']}")
    _require(runs["hookless"]["losses"] == runs["hookless"]["losses_rank1"],
             "two_ranks: the ranks disagree on the hookless losses")
    _require(all(row["overlap_bitwise_hookless"]),
             "two_ranks: the bucketed f32 sync is not bitwise the hookless DDP step")
    _require(not any(row["control_bitwise_hookless"]),
             "two_ranks: the check passed the planted control (a bucket left unsynced)")
    _require(int8_gap <= INT8_ATOL, f"two_ranks: int8 losses {int8} off the f32 curve {f32}")
    return sum(sum(run["flash_launches"]) for run in runs.values())


def _mesh_captured_phase(torch, kernels_mod, smi: str, flash_per_block: float) -> int:
    """Phase 17 (see the module docstring).  Returns the flash launches of
    the warm-up and the capture."""
    import socket

    import torch.distributed as dist

    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from deeplearning_cfn_tpu_torch.train.data import (
        SyntheticTokenDataset,
        device_put_batch,
        stack_batches,
    )
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        cfg = llama.LlamaConfig.m435(seq_len=2048)
        trainer = llama.make_trainer(cfg, TrainerConfig(
            strategy="fsdp", optimizer="adamw", learning_rate=3e-4, weight_decay=0.1,
            grad_clip_norm=1.0, log_every=1), device="cuda", mesh=build_mesh(MeshSpec(fsdp=1)))
        one = next(SyntheticTokenDataset(seq_len=2048, vocab_size=cfg.vocab_size,
                                         batch_size=8).batches(1))
        xs, ys = device_put_batch(next(stack_batches(iter([one] * MESH_K), MESH_K)),
                                  torch.device("cuda"))
        eager_state = trainer.init(seed=0, draw_on_device=True)
        p0 = _param_copy(eager_state.model)
        eager, eager_ms = [], []
        for i in range(MESH_K):
            t0 = time.perf_counter()
            eager_state, m = trainer.train_step(eager_state, xs[i], ys[i])
            eager.append(m["loss"].item())
            eager_ms.append((time.perf_counter() - t0) * 1e3)
        eager_final = _param_copy(eager_state.model)
        del eager_state, m
        torch.cuda.empty_cache()
        state = trainer.init(seed=0, draw_on_device=True)
        kfn = trainer.multi_step_fn(MESH_K)
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        state, captured = kfn(state, xs, ys)
        captured = captured.tolist()
        capture_s = time.perf_counter() - t0
        launches = dict(kernels_mod.launch_counts)
        final = _param_copy(state.model)
        held = _held_runs(captured, eager, _param_gap(final, eager_final, p0),
                          _param_gap(p0, eager_final, p0), LLAMA_CAPTURE_RTOL)
        params_equal = all(torch.equal(final[n], p) for n, p in eager_final.items())
        dtensors = sum(hasattr(p, "placements") for p in state.model.parameters())
        del p0, eager_final, final
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH_REPLAYS):
            state, losses = kfn(state, xs, ys)
            losses.tolist()
        step_ms = (time.perf_counter() - t0) * 1e3 / (MESH_REPLAYS * MESH_K)
        row = {"phase": "mesh_captured", "mesh": "MeshSpec(fsdp=1), one NCCL rank",
               "strategy": "fsdp (FSDP2)", "k": MESH_K, "replays": MESH_REPLAYS,
               "dtensor_params": dtensors, "eager_losses": eager, "captured_losses": captured,
               **held, "losses_bitwise_equal": captured == eager,
               "params_bitwise_equal": params_equal, "first_call_s": capture_s,
               "captures": kfn.captures, "step_ms": step_ms, "eager_step_ms": eager_ms,
               "eager_steady_step_ms": statistics.median(eager_ms[1:]),
               "launches_in_warmup_and_capture": launches, "nvidia_smi": smi}
        _emit(row)
        _require(kfn.captures == 1 and dtensors > 0, f"mesh_captured: {kfn.captures} captures, "
                 f"{dtensors} DTensor parameters")
        _check_held("mesh_captured", row)
        _require(row["losses_bitwise_equal"] and params_equal,
                 "mesh_captured: the captured steps are not bitwise the eager ones")
        _flash_check(launches, 1 + MESH_K, flash_per_block * cfg.n_layers,
                     "mesh_captured (warm-up + capture)")
        del trainer, state, kfn, xs, ys
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return launches.get("flash_attention_fwd", 0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch.nn.functional as F

    from deeplearning_cfn_tpu_torch.examples import bert_pretrain, llama_train
    from deeplearning_cfn_tpu_torch.models import bert, llama
    from deeplearning_cfn_tpu_torch.ops import _kernels
    from deeplearning_cfn_tpu_torch.ops import fused_dense as fd
    from deeplearning_cfn_tpu_torch.ops.attention import dot_product_attention
    from deeplearning_cfn_tpu_torch.ops.flash_attention import (
        FlashAttention,
        flash_attention,
        flash_attention_reference,
    )
    from deeplearning_cfn_tpu_torch.ops.quant import dequantize_weight, quantize_weight
    from deeplearning_cfn_tpu_torch.train.data import (
        SyntheticMLMDataset,
        SyntheticTokenDataset,
        device_put_batch,
    )
    from deeplearning_cfn_tpu_torch.train.metrics import (
        peak_f32_flops_per_chip,
        peak_flops_per_chip,
        peak_hbm_bytes_per_chip,
    )
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    # 1. env
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = peak_flops_per_chip(name), peak_hbm_bytes_per_chip(name)
    peak_f32 = peak_f32_flops_per_chip(name)
    _require(peak_flops is not None, f"no peak rates known for {name!r}")
    _emit({"phase": "env", "nvidia_smi": smi, "device": name, "torch": torch.__version__,
           "cuda": torch.version.cuda, "python": sys.version.split()[0],
           "peak_bf16_flops": peak_flops, "peak_f32_flops": peak_f32,
           "peak_hbm_bytes_per_s": peak_bw})

    # 2. build
    sources = ["flash_attn_fwd", "fused_dense"]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(_kernels.build, sources))
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for lib in libs for ln in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln or "arning" in ln]
    _emit({"phase": "build", "seconds": build_s, "libraries": [p.name for p in libs],
           "ptxas": ptxas})

    # 3. kernel vs plain, on the card
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(B, S, Hq, Hkv, D, dtype):
        return [torch.randn(B, S, h, D, device="cuda", generator=gen, dtype=torch.float32).to(dtype)
                for h in (Hq, Hkv, Hkv)]

    shapes = {  # name: (B, S, Hq, Hkv, D, causal, dtype, packed)
        "slice": (8, 2048, 8, 8, 128, True, torch.bfloat16, False),
        "gqa": (1, 2048, 32, 8, 128, True, torch.bfloat16, False),
        "ragged-full": (2, 1000, 8, 8, 64, False, torch.bfloat16, False),
        # The diagonal and Sk-edge masks on one tile, with TMA's zero fill.
        "causal-ragged": (2, 1000, 8, 8, 128, True, torch.bfloat16, False),
        # q, k and v as views of one [B, S, 3, H, D] tensor: the tensor maps' strides.
        "strided": (2, 2048, 8, 8, 128, True, torch.bfloat16, True),
        "f32": (1, 300, 4, 2, 64, True, torch.float32, False),
        # Llama-3-8B's attention at seq 8192 (phase 14's main path).
        "llama8b": (1, L8B_SEQ, 32, 8, 128, True, torch.bfloat16, False),
    }
    kernel_rows = {}
    for label, (B, S, Hq, Hkv, D, causal, dtype, packed) in shapes.items():
        if packed:
            qkv_packed = torch.randn(B, S, 3, Hq, D, device="cuda", generator=gen).to(dtype)
            q, k, v = (qkv_packed[:, :, i] for i in range(3))
        else:
            q, k, v = qkv(B, S, Hq, Hkv, D, dtype)
        scale = D**-0.5
        (out, lse), variant = _launched_variant(_kernels, "flash_attention_fwd", lambda: (
            _kernels.flash_attn_fwd(q, k, v, causal=causal, sm_scale=scale)))
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_reference(q, k, v, causal=causal, sm_scale=scale)
        out_err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        out_tol = BF16_OUT_ATOL if dtype == torch.bfloat16 else F32_OUT_ATOL
        row = {"phase": "kernel", "kernel": "flash_attention_fwd", "shape": label, "B": B, "S": S,
               "Hq": Hq, "Hkv": Hkv, "D": D, "causal": causal,
               "dtype": str(dtype).replace("torch.", ""), "packed_qkv": packed,
               "variant": variant,
               "out_max_abs_err": out_err, "out_atol": out_tol,
               "lse_max_abs_err": lse_err, "lse_atol": LSE_ATOL,
               "finite": bool(torch.isfinite(out).all())}
        if dtype == torch.bfloat16:
            row["out_row_ulps"] = _row_ulps(torch, out, ref_out)
            row["out_row_ulps_limit"] = BF16_ROW_ULPS
        if dtype == torch.bfloat16:
            flops, nbytes = _attention_work(B, S, S, Hq, Hkv, D, causal, q.element_size())
            t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            kernel = lambda: _kernels.flash_attn_fwd(q, k, v, causal=causal, sm_scale=scale)  # noqa: E731
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal, scale=scale, enable_gqa=Hq != Hkv)
            row.update({
                "kernel_ms": _time_ms(torch, kernel, iters=20),
                "device_ms": _device_ms(torch, kernel, iters=20),
                "plain_ms": _time_ms(torch, lambda: flash_attention_reference(
                    q, k, v, causal=causal, sm_scale=scale), iters=3, warmup=1),
                "library_ms": _time_ms(torch, library, iters=20),
                "library_device_ms": _device_ms(torch, library, iters=20),
                "host_ms": _host_ms(torch, kernel, iters=20),
                "library_host_ms": _host_ms(torch, library, iters=20),
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            })
            row["tflops"] = flops / row["kernel_ms"] / 1e9
        _emit(row)
        _require(row["finite"], f"{label}: non-finite kernel output")
        _require(out_err <= out_tol, f"{label}: out error {out_err} > {out_tol}")
        _require(lse_err <= LSE_ATOL, f"{label}: lse error {lse_err} > {LSE_ATOL}")
        _require(row.get("out_row_ulps", 0) <= BF16_ROW_ULPS,
                 f"{label}: out error {row.get('out_row_ulps')} ulps of its row > {BF16_ROW_ULPS}")
        _require(row["variant"] == ("wgmma_tma" if dtype == torch.bfloat16 else "simt"),
                 f"{label}: flash variant {row['variant']}")
        kernel_rows[label] = row
        del q, k, v, out, lse, ref_out, ref_lse
    torch.cuda.synchronize()

    # Flash crossover: the kernel against the materialised-score path the
    # model takes below FLASH_CROSSOVER_SEQ, at equal tokens per call.
    Hc, Dc = 8, 128
    for S in CROSSOVER_SEQS:
        B = CROSSOVER_TOKENS // S
        q, k, v = qkv(B, S, Hc, Hc, Dc, torch.bfloat16)
        g = torch.randn(B, S, Hc, Dc, device="cuda", generator=gen).to(torch.bfloat16)
        grads = [x.detach().requires_grad_() for x in (q, k, v)]

        def fwd_bwd(attn):
            attn(*grads).backward(g)

        flash = lambda *t: flash_attention(*t, causal=True)  # noqa: E731
        plain = lambda *t: dot_product_attention(*t, causal=True)  # noqa: E731
        with torch.no_grad():
            row = {"phase": "crossover", "B": B, "S": S, "Hq": Hc, "D": Dc, "causal": True,
                   "tokens": B * S,
                   "flash_fwd_ms": _time_ms(torch, lambda: flash(q, k, v), iters=10),
                   "materialised_fwd_ms": _time_ms(torch, lambda: plain(q, k, v), iters=10)}
        row["flash_fwd_bwd_ms"] = _time_ms(torch, lambda: fwd_bwd(flash), iters=3, warmup=1)
        row["materialised_fwd_bwd_ms"] = _time_ms(torch, lambda: fwd_bwd(plain), iters=3, warmup=1)
        _emit(row)
        del q, k, v, g, grads
    torch.cuda.synchronize()

    def dense_operands(M, K, N, dtype):
        x = torch.randn(M, K, device="cuda", generator=gen).to(dtype)
        w = (torch.randn(K, N, device="cuda", generator=gen) / K**0.5).to(dtype)
        b = (0.1 * torch.randn(N, device="cuda", generator=gen)).to(dtype)
        return x, w, b

    def dense_check(label, kernel_name, got, ref, dtype, tols=DENSE_TOL) -> dict:
        rtol, atol = tols[str(dtype).replace("torch.", "")]
        err = (got.float() - ref.float()).abs()
        within = bool((err <= atol + rtol * ref.float().abs()).all())
        return {"phase": "kernel", "kernel": kernel_name, "shape": label,
                "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err.max().item(),
                "rtol": rtol, "atol": atol, "within_tolerance": within,
                "finite": bool(torch.isfinite(got).all())}

    library_act = {None: lambda z: z, "relu": torch.relu,
                   "gelu": lambda z: F.gelu(z, approximate="tanh")}

    def f64_errors(got, x, w, b, act, library) -> dict:
        """The kernel's and the library call's largest errors against the
        float64 product, with the same bias and activation in float64."""
        exact = library_act[act](x.double() @ w.double() + b.double())
        kernel_err = (got.double() - exact).abs().max().item()
        library_err = (library().double() - exact).abs().max().item()
        return {"f64_kernel_max_abs_err": kernel_err, "f64_library_max_abs_err": library_err,
                "f64_kernel_over_library": kernel_err / library_err}
    dense_shapes = {  # name: (M, K, N, dtype, activation)
        "mlp_in": (BERT_BATCH * BERT_SEQ, 768, 3072, torch.bfloat16, "gelu"),
        "mlp_out": (BERT_BATCH * BERT_SEQ, 3072, 768, torch.bfloat16, None),
        # Ragged M, K and N with 16-byte rows: TMA's zero fill, the epilogue's guards.
        "aligned-ragged": (1000, 200, 304, torch.bfloat16, "relu"),
        "ragged": (1000, 200, 300, torch.bfloat16, "relu"),
        "resnet_head": (128, 2048, 1000, torch.float32, None),
        "mlp_in-f32": (BERT_BATCH * BERT_SEQ, 768, 3072, torch.float32, "gelu"),
        # N not a multiple of 4: rows TMA cannot read.
        "ragged-f32": (1000, 200, 301, torch.float32, "relu"),
    }
    # The launcher's choice on an H100 (132 SMs): bf16, ping-pong where there
    # are two 128 x 128 tiles or more an SM, else cooperative 128 x 192, and
    # mma.sync for rows TMA cannot read; f32, six bf16 products of parts, K
    # split across a cluster where 128 x 192 tiles leave half the SMs idle
    # (the head: 6 tiles, 16 CTAs each), without a split otherwise, and CUDA cores for
    # rows TMA cannot read.
    dense_variants = {"mlp_in": "wgmma_tma_pingpong_128x128", "mlp_out": "wgmma_tma_128x192",
                      "aligned-ragged": "wgmma_tma_128x192", "ragged": "mma_sync",
                      "resnet_head": F32_SPLITK, "mlp_in-f32": F32_COOP, "ragged-f32": "simt"}
    dense_rows = {}
    for label, (M, K, N, dtype, act) in dense_shapes.items():
        x, w, b = dense_operands(M, K, N, dtype)
        got, variant = _launched_variant(_kernels, "fused_dense", lambda: (
            _kernels.fused_dense(x, w, b, activation=act)))
        torch.cuda.synchronize()
        row = dense_check(label, "fused_dense", got, fd.fused_dense_reference(x, w, b, act), dtype)
        row.update({"M": M, "K": K, "N": N, "activation": act, "variant": variant})
        # The bound of the design's arithmetic: bf16 products at the bf16
        # peak, one pass for bf16 operands and six for f32 ones split in
        # three; an f32 product on the CUDA cores at the f32 peak, which
        # stays beside the others for the record.
        if dtype == torch.bfloat16:
            peak_ops, basis = peak_flops, "bf16 tensor cores x1"
        elif variant == "simt":
            peak_ops, basis = peak_f32, "f32 CUDA cores"
        else:
            peak_ops, basis = peak_flops / 6, "bf16 tensor cores x6"
        row.update(_dense_work(M, K, N, x.element_size(), w.element_size(), peak_ops, peak_bw))
        row["bound_basis"] = basis
        if dtype == torch.float32:
            row["bound_f32_cuda_cores_ms"] = _dense_work(
                M, K, N, 4, 4, peak_f32, peak_bw)["bound_ms"]
            row["splits"] = _kernels.fused_dense_f32_splits(M, N, K) if variant == F32_SPLITK else 1
            # The cluster sums its partial tiles in rank order: the same bits each call.
            again = _kernels.fused_dense(x, w, b, activation=act)
            torch.cuda.synchronize()
            row["bitwise_repeatable"] = bool(torch.equal(again, got))
            _require(row["bitwise_repeatable"], f"fused_dense {label}: two calls differ")
        kernel = lambda: _kernels.fused_dense(x, w, b, activation=act)  # noqa: E731
        library = lambda: library_act[act](torch.addmm(b, x, w))  # noqa: E731
        if dtype == torch.float32:
            # Against float64, the kernel sums as f32 addmm (TF32 off) does.
            row.update(f64_errors(got, x, w, b, act, library))
            if variant != "simt":
                _require(row["f64_kernel_over_library"] <= 2,
                         f"fused_dense {label}: float64 error {row['f64_kernel_max_abs_err']} "
                         f"over twice addmm's {row['f64_library_max_abs_err']}")
        row.update({
            "kernel_ms": _time_ms(torch, kernel, iters=50),
            "device_ms": _device_ms(torch, kernel, iters=50),
            "plain_ms": _time_ms(torch, lambda: fd.fused_dense_reference(x, w, b, act), iters=10),
            "library_ms": _time_ms(torch, library, iters=50),
            "library_device_ms": _device_ms(torch, library, iters=50),
            "host_ms": _host_ms(torch, kernel, iters=50),
            "library_host_ms": _host_ms(torch, library, iters=50),
        })
        row["tflops"] = row["gflop"] / row["kernel_ms"]
        _emit(row)
        _require(row["finite"] and row["within_tolerance"], f"fused_dense {label}: {row}")
        _require(row["variant"] == dense_variants[label],
                 f"fused_dense {label}: variant {row['variant']}")
        dense_rows[label] = row

    quant_shapes = {  # name: (M, K, N, x dtype, activation)
        "mlp_in": (BERT_BATCH * BERT_SEQ, 768, 3072, torch.bfloat16, "gelu"),
        "mlp_in-f32": (BERT_BATCH * BERT_SEQ, 768, 3072, torch.float32, "gelu"),
        # Ragged M and K chunk with 16-byte rows: TMA's zero fill in all three parts.
        "aligned-ragged": (1000, 200, 304, torch.float32, "relu"),
        "ragged": (1000, 200, 300, torch.float32, "relu"),
    }
    # The launcher's choice: bf16 tensor cores (128 x 192 tiles) where TMA
    # can read the rows, one bf16 part of x for a bf16 x and three (h, m, l)
    # for an f32 x; CUDA cores where N is off 16 bytes of int8.
    quant_variants = {"mlp_in": "wgmma_tma_bf16x1_128x192",
                      "mlp_in-f32": "wgmma_tma_bf16x3_128x192",
                      "aligned-ragged": "wgmma_tma_bf16x3_128x192", "ragged": "simt"}
    quant_rows = {}
    for label, (M, K, N, dtype, act) in quant_shapes.items():
        x, w, b = dense_operands(M, K, N, dtype)
        wq, scale = quantize_weight(w.float())
        got, variant = _launched_variant(_kernels, "fused_dense_quantized", lambda: (
            _kernels.fused_dense_quantized(x, wq, scale, b, activation=act)))
        torch.cuda.synchronize()
        ref = fd._quant_reference(x, wq, scale, b, act, dtype)
        row = dense_check(label, "fused_dense_quantized", got, ref, dtype, QUANT_TOL)
        row.update({"M": M, "K": K, "N": N, "activation": act, "variant": variant})
        # The bound of the design's arithmetic: bf16 products at the bf16
        # peak, one pass for a bf16 x and three for an f32 x; an f32 product
        # on the CUDA cores at the f32 peak.
        if variant == "simt":
            peak_ops, basis = peak_f32, "f32 CUDA cores"
        else:
            parts = 1 if dtype == torch.bfloat16 else 3
            peak_ops, basis = peak_flops / parts, f"bf16 tensor cores x{parts}"
        row.update(_dense_work(M, K, N, x.element_size(), 1, peak_ops, peak_bw))
        row["bound_basis"] = basis
        x32, b32, w32 = x.float(), b.float(), dequantize_weight(wq, scale)
        kernel = lambda: _kernels.fused_dense_quantized(x, wq, scale, b, activation=act)  # noqa: E731
        library = lambda: library_act[act](torch.addmm(b32, x32, w32))  # noqa: E731
        if dtype == torch.float32:
            # Against x @ (wq * scale) in float64; addmm on the dequantised weight.
            row.update(f64_errors(got, x32, wq.double() * scale.double(), b32, act, library))
            if variant != "simt":
                _require(row["f64_kernel_over_library"] <= 2,
                         f"fused_dense_quantized {label}: float64 error "
                         f"{row['f64_kernel_max_abs_err']} over twice addmm's "
                         f"{row['f64_library_max_abs_err']}")
        row.update({
            "kernel_ms": _time_ms(torch, kernel, iters=50),
            "device_ms": _device_ms(torch, kernel, iters=50),
            "plain_ms": _time_ms(torch, lambda: fd._quant_reference(x, wq, scale, b, act, dtype),
                                 iters=10),
            "library_ms": _time_ms(torch, library, iters=50),
            "library_device_ms": _device_ms(torch, library, iters=50),
            "host_ms": _host_ms(torch, kernel, iters=50),
            "library_host_ms": _host_ms(torch, library, iters=50),
        })
        if dtype == torch.bfloat16:
            # A floor for information only: a bf16 product on the widened
            # weight, without the scale, bias or activation.
            wq16 = wq.to(torch.bfloat16)
            bf16_mm = lambda: torch.mm(x, wq16)  # noqa: E731
            row["library_bf16_mm_ms"] = _time_ms(torch, bf16_mm, iters=50)
            row["library_bf16_mm_device_ms"] = _device_ms(torch, bf16_mm, iters=50)
        row["tflops"] = row["gflop"] / row["kernel_ms"]
        _emit(row)
        _require(row["finite"] and row["within_tolerance"], f"fused_dense_quantized {label}: {row}")
        _require(row["variant"] == quant_variants[label],
                 f"fused_dense_quantized {label}: variant {row['variant']}")
        quant_rows[label] = row
    del x, w, b, wq, scale, got, ref, x32, b32, w32

    # 4. grad: FlashAttention (kernel forward + torch backward) vs the reference's autograd
    B, S, Hq, Hkv, D = 2, 256, 4, 2, 64
    base = qkv(B, S, Hq, Hkv, D, torch.float32)
    w = torch.randn(B, S, Hq, D, device="cuda", generator=gen)
    kq, kk, kv = (x.clone().requires_grad_() for x in base)
    rq, rk, rv = (x.clone().requires_grad_() for x in base)
    (FlashAttention.apply(kq, kk, kv, True, D**-0.5) * w).sum().backward()
    (flash_attention_reference(rq, rk, rv, causal=True)[0] * w).sum().backward()
    grad_err = max((a.grad - b.grad).abs().max().item() for a, b in ((kq, rq), (kk, rk), (kv, rv)))
    _emit({"phase": "grad", "B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "D": D, "dtype": "float32",
           "max_abs_err": grad_err, "atol": F32_GRAD_ATOL})
    _require(grad_err <= F32_GRAD_ATOL, f"grad error {grad_err} > {F32_GRAD_ATOL}")
    # FusedDenseFunction: the backward reads only x, w, b and g, so the kernel
    # forward and the plain one must give the same gradients.
    for dtype in (torch.float32, torch.bfloat16):
        M, K, N = 512, 768, 640
        base = dense_operands(M, K, N, dtype)
        r = torch.randn(M, N, device="cuda", generator=gen)
        kx, kw, kb = (t.clone().requires_grad_() for t in base)
        px, pw, pb = (t.clone().requires_grad_() for t in base)
        (fd.FusedDenseFunction.apply(kx, kw, kb, "gelu").float() * r).sum().backward()
        (fd.fused_dense_reference(px, pw, pb, "gelu").float() * r).sum().backward()
        rtol, atol = GRAD_TOL[str(dtype).replace("torch.", "")]
        errs = {n: (a.grad.float() - p.grad.float()).abs() for n, a, p in
                (("dx", kx, px), ("dw", kw, pw), ("db", kb, pb))}
        within = all(bool((errs[n] <= atol + rtol * p.grad.float().abs()).all())
                     for n, p in (("dx", px), ("dw", pw), ("db", pb)))
        _emit({"phase": "grad", "kernel": "fused_dense", "M": M, "K": K, "N": N,
               "dtype": str(dtype).replace("torch.", ""), "activation": "gelu",
               "max_abs_err": {n: e.max().item() for n, e in errs.items()},
               "rtol": rtol, "atol": atol, "within_tolerance": within})
        _require(within, f"fused_dense gradients ({dtype}) outside tolerance")

    # 5. slice: the Llama path, through the entry point a user calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = llama_train.main(SLICE_ARGS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    llama_launches = dict(_kernels.launch_counts)
    peak_mem = torch.cuda.max_memory_allocated()
    tokens_per_step = 8 * 2048
    cfg = llama.LlamaConfig.m435(seq_len=2048)
    run = _run_summary(result, tokens_per_step, tokens_per_step)
    losses = run["losses"]
    slice_variants = _variants(llama_launches, "flash_attention_fwd")
    _emit({"phase": "slice", "args": SLICE_ARGS, **run, "wall_s": wall_s,
           "max_memory_allocated_bytes": peak_mem, "launches": llama_launches,
           "flash_launches_per_step": llama_launches["flash_attention_fwd"] / STEPS,
           "flash_variants": slice_variants})
    _require(slice_variants == {"wgmma_tma": llama_launches["flash_attention_fwd"]},
             f"the Llama path launched flash variants {slice_variants}")
    _require(len(losses) == STEPS and all(math.isfinite(x) for x in losses), "non-finite loss")
    _require(llama_launches["flash_attention_fwd"] >= cfg.n_layers * STEPS,
             f"flash kernel launched {llama_launches['flash_attention_fwd']} times, "
             f"expected >= {cfg.n_layers} per step")

    # Same weights as the trainer started from (seed 0), one forward each way.
    model = llama.init_model(cfg, seed=0, device="cuda")
    tokens = torch.from_numpy(
        next(SyntheticTokenDataset(seq_len=2048, vocab_size=cfg.vocab_size, batch_size=2).batches(1)).x
    ).cuda()
    with torch.no_grad():
        logits_kernel = llama.forward(model, tokens)
        with llama.force_attention_kind("flash_reference"):
            logits_plain = llama.forward(model, tokens)
    diff = (logits_kernel - logits_plain).abs()
    logits_row = {"phase": "logits", "B": 2, "S": 2048, "max_abs_err": diff.max().item(),
                  "mean_abs_err": diff.mean().item(), "max_atol": LOGITS_MAX_ATOL,
                  "mean_atol": LOGITS_MEAN_ATOL, "logits_max_abs": logits_plain.abs().max().item(),
                  "finite": bool(torch.isfinite(logits_kernel).all())}
    _emit(logits_row)
    _require(logits_row["finite"], "non-finite logits")
    _require(logits_row["max_abs_err"] <= LOGITS_MAX_ATOL, "logits max error")
    _require(logits_row["mean_abs_err"] <= LOGITS_MEAN_ATOL, "logits mean error")
    del model, logits_kernel, logits_plain, diff

    # 6. learn: the synthetic tokens are uniform over the vocab, so the main
    # path's loss starts at the entropy floor ln(32000) = 10.373 and cannot
    # fall.  Learning is checked by overfitting one batch at the same shape
    # through the same trainer; its last two steps are profiled.
    trainer = llama.make_trainer(cfg, TrainerConfig(
        optimizer="adamw", learning_rate=3e-4, weight_decay=0.1, grad_clip_norm=1.0,
        strategy="fsdp", log_every=1), device="cuda")
    state = trainer.init(seed=0)
    batch = next(SyntheticTokenDataset(seq_len=2048, vocab_size=cfg.vocab_size, batch_size=8).batches(1))
    x, y = device_put_batch(batch, torch.device("cuda"))
    fit_losses = []

    def llama_step():
        nonlocal state
        state, metrics = trainer.train_step(state, x, y)
        fit_losses.append(metrics["loss"])

    for _ in range(STEPS - 2):
        llama_step()
    llama_profile = _profile(torch, llama_step, 2)
    fit_losses = torch.stack(fit_losses).tolist()
    _emit({"phase": "learn", "losses": fit_losses})
    _require(all(math.isfinite(v) for v in fit_losses), "non-finite loss on one batch")
    _require(fit_losses[-1] < fit_losses[0], f"loss on one repeated batch did not fall: {fit_losses}")
    _emit({"phase": "profile", "path": "llama", **llama_profile})
    del state, trainer, x, y

    # 6b-6e. The parallelism slice's Llama paths: MoE, adafactor, the mesh,
    # the captured AdamW step.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    flash_per_block = llama_launches["flash_attention_fwd"] / STEPS / cfg.n_layers
    flash_by_path = {"slice": llama_launches["flash_attention_fwd"],
                     **_slice5a_phases(torch, _kernels, smi, flash_per_block, peak_flops)}

    # 7. bert: the BERT path, through the entry point a user calls
    bert_launches, bert_runs = {}, {}
    for path, extra in (("kernel", ["--use_pallas_mlp"]), ("plain", [])):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        result = bert_pretrain.main(BERT_ARGS + extra)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(_kernels.launch_counts)
        run = {"phase": "bert", "mlp": path, "args": BERT_ARGS + extra,
               **_run_summary(result, BERT_BATCH, BERT_BATCH * BERT_SEQ),
               "wall_s": wall_s, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
               "launches": launches,
               "fused_dense_launches_per_step": launches["fused_dense"] / BERT_STEPS}
        _emit(run)
        losses = run["losses"]
        _require(len(losses) == BERT_STEPS and all(math.isfinite(v) for v in losses),
                 f"bert ({path}): non-finite loss")
        # Mean of the last ten steps against the first ten: at the example's
        # learning rate (1e-4, no warmup) the loss falls by a few hundredths
        # in twenty steps, about as much as one batch's loss differs from the
        # next one's.  (At 1e-3 it falls faster, then diverges within twenty
        # steps.)
        _require(statistics.mean(losses[-10:]) < statistics.mean(losses[:10]),
                 f"bert ({path}): the MLM loss did not fall: {losses}")
        bert_runs[path] = run
        if path == "kernel":
            bert_launches = launches
    bcfg = dataclasses.replace(bert.BertConfig.base(), use_pallas_mlp=True)
    _require(bert_launches["fused_dense"] >= 2 * bcfg.n_layers * BERT_STEPS,
             f"fused_dense launched {bert_launches['fused_dense']} times, expected >= "
             f"{2 * bcfg.n_layers} per step")
    _require(bert_runs["plain"]["launches"]["fused_dense"] == 0, "plain BERT path ran the kernel")
    # Every launch of the kernel path in a wgmma variant: ping-pong at mlp_in
    # (768 tiles of 128 x 128), cooperative 128 x 192 at mlp_out (128 tiles).
    bert_variants = _variants(bert_launches, "fused_dense")
    _require(sum(bert_variants.values()) == bert_launches["fused_dense"]
             and bert_variants.get("wgmma_tma_pingpong_128x128", 0) >= bcfg.n_layers * BERT_STEPS
             and bert_variants.get("wgmma_tma_128x192", 0) >= bcfg.n_layers * BERT_STEPS
             and sum(n for v, n in bert_variants.items() if not v.startswith("wgmma_tma")) == 0,
             f"the BERT path launched fused-dense variants {bert_variants}")

    # Same weights as the trainer started from (seed 0), one forward each way.
    model = bert.BertEncoder(bcfg, torch.Generator().manual_seed(0)).to("cuda")
    batch = next(SyntheticMLMDataset(seq_len=BERT_SEQ, vocab_size=bcfg.vocab_size,
                                     batch_size=BERT_BATCH).batches(1))
    x, y = device_put_batch(batch, torch.device("cuda"))
    with torch.no_grad():
        logits_kernel = model(x)
        with fd.force_reference():
            logits_plain = model(x)
    diff = (logits_kernel - logits_plain).abs()
    logits_row = {"phase": "logits", "path": "bert", "B": BERT_BATCH, "S": BERT_SEQ,
                  "max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
                  "max_atol": BERT_LOGITS_MAX_ATOL, "mean_atol": BERT_LOGITS_MEAN_ATOL,
                  "logits_max_abs": logits_plain.abs().max().item(),
                  "finite": bool(torch.isfinite(logits_kernel).all())}
    _emit(logits_row)
    _require(logits_row["finite"], "non-finite BERT logits")
    _require(logits_row["max_abs_err"] <= BERT_LOGITS_MAX_ATOL, "BERT logits max error")
    _require(logits_row["mean_abs_err"] <= BERT_LOGITS_MEAN_ATOL, "BERT logits mean error")
    del model, logits_kernel, logits_plain, diff

    for path, pallas in (("kernel", True), ("plain", False)):
        trainer = bert.make_trainer(
            dataclasses.replace(bcfg, use_pallas_mlp=pallas),
            TrainerConfig(optimizer="adamw", learning_rate=1e-4, weight_decay=0.01,
                          grad_clip_norm=1.0, log_every=1),
            device="cuda")
        state = trainer.init(seed=0)

        def bert_step():
            nonlocal state
            state, _ = trainer.train_step(state, x, y)

        for _ in range(2):
            bert_step()
        _emit({"phase": "profile", "path": "bert", "mlp": path, **_profile(torch, bert_step, 2)})
        del state, trainer
    del x, y

    # 8. serve: the serving path at Llama-3-8B, through the engine a user builds
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _serve_phase(torch, _kernels, smi, peak_bw)

    # 9. resnet: ResNet-50 training, the head through the f32 fused dense
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resnet_launches = _resnet_phase(torch, _kernels, smi, peak_flops)

    # 10. checkpoint: save and resume on the Llama and ResNet-50 paths
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ckpt_launches = _checkpoint_phase(torch, _kernels, smi)
    flash_by_path["checkpoint"] = ckpt_launches["flash_attention_fwd"]

    # 11. detection: RetinaNet-R50-FPN with the mask head (no kernel of the port)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    new_paths = {"detection": _detection_phase(torch, _kernels, smi, peak_flops)}

    # 12. cifar10: cifar10_train (VGG-11) and lenet_mnist (no kernel of the port)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    new_paths["cifar10"] = _cifar_phase(torch, _kernels, smi)

    # 13. records: ResNet-50, m435 and BERT-base (and VGG, detection) trained
    # from converted records through the native loader
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    new_paths["records"] = _records_phase(torch, _kernels, smi, flash_per_block)
    for path, counts in new_paths.items():
        flash_by_path[path] = counts.get("flash_attention_fwd", 0)

    # 14. llama8b: Llama-3-8B training on one card, its memory prediction,
    # the HF import, and TrainerConfig.remat
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    l8b = _llama8b_phase(torch, _kernels, smi)
    flash_by_path["llama8b"] = l8b["launches"].get("flash_attention_fwd", 0)

    # 15-17. The rest of the parallelism slice: the stage-stacked layout, two
    # ranks on the one card, a captured step over a mesh.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    flash_by_path["pp_layout"] = _pp_layout_phase(torch, _kernels, smi, flash_per_block)
    flash_by_path["two_ranks"] = _two_ranks_phase(torch, smi, flash_per_block)
    flash_by_path["mesh_captured"] = _mesh_captured_phase(torch, _kernels, smi, flash_per_block)

    def on_new_paths(key: str, variants=None) -> dict:
        """Launches of ``key`` on the phases after ``checkpoint``; with
        ``variants``, only those variants' launches."""
        if variants is None:
            return {path: counts.get(key, 0) for path, counts in new_paths.items()}
        return {path: sum(n for v, n in _variants(counts, key).items() if v in variants)
                for path, counts in new_paths.items()}

    def kernel_entry(name, source, replaces, launches, max_abs_err, row):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": max_abs_err, "ms": row["kernel_ms"],
                "device_ms": row["device_ms"], "host_ms": row["host_ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "variant": row["variant"], "shape": row["shape"]}

    csrc = "deeplearning_cfn_tpu_torch/ops/csrc/"
    # The fused dense by operand dtype: bf16 on the BERT paths; f32 on the
    # ResNet-50 paths (their kernel heads' eager runs).
    f32_variants = (F32_SPLITK, F32_COOP, "simt")
    bf16_variants = set(_kernels._VARIANTS["fused_dense"].values()) - set(f32_variants)
    dense_launches = {"bf16": 0, "f32": ckpt_launches["fused_dense_f32"]}
    for counts in (llama_launches, bert_launches, resnet_launches, new_paths["records"]):
        for v, n in _variants(counts, "fused_dense").items():
            dense_launches["f32" if v in f32_variants else "bf16"] += n
    bf16_rows = [r for r in dense_rows.values() if r["dtype"] == "bfloat16"]
    f32_rows = [r for r in dense_rows.values() if r["dtype"] == "float32"]
    _emit({"kernels": [
        {**kernel_entry("flash_attention_fwd", csrc + "flash_attn_fwd.cu",
                        "deeplearning_cfn_tpu/ops/pallas_attention.py:222",
                        sum(flash_by_path.values()),
                        max(r["out_max_abs_err"] for r in kernel_rows.values()),
                        kernel_rows["slice"]),
         "launches_by_path": flash_by_path,
         "llama8b_shape": {k: kernel_rows["llama8b"][k] for k in (
             "B", "S", "Hq", "Hkv", "D", "variant", "out_max_abs_err", "kernel_ms", "device_ms",
             "host_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}},
        {**kernel_entry("fused_dense", csrc + "fused_dense.cu",
                        "deeplearning_cfn_tpu/ops/pallas_fused.py:135",
                        dense_launches["bf16"],
                        max(r["max_abs_err"] for r in bf16_rows), dense_rows["mlp_in"]),
         "launches_by_path": on_new_paths("fused_dense", bf16_variants)},
        {**kernel_entry("fused_dense_f32", csrc + "fused_dense.cu",
                        "deeplearning_cfn_tpu/ops/pallas_fused.py:135", dense_launches["f32"],
                        max(r["max_abs_err"] for r in f32_rows), dense_rows["resnet_head"]),
         "launches_by_path": on_new_paths("fused_dense", f32_variants)},
        {**kernel_entry("fused_dense_quantized", csrc + "fused_dense.cu",
                        "deeplearning_cfn_tpu/ops/pallas_fused.py:292",
                        bert_launches["fused_dense_quantized"],
                        max(r["max_abs_err"] for r in quant_rows.values()), quant_rows["mlp_in"]),
         "launches_by_path": on_new_paths("fused_dense_quantized")},
    ]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                   "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--two-ranks-worker":
        sys.exit(_two_ranks_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
