"""Drive the PyTorch / CUDA port (anyref_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure exits non-zero before the result line):
  1. print the card's name and power limit; build the CUDA kernels from
     anyref_tpu_torch/csrc with nvcc (sm_90a, one process per source, all
     started together) and print each kernel's ptxas registers and spills;
  2. hold each of the twelve kernels against its plain PyTorch version on
     the card, in bf16, at the shapes the main path gives it (batch 2 at
     anyref_7b) and at one small odd shape, and time kernel, plain version
     and one library call (CUDA events, L2 flushed before every launch,
     median); for the four fused SAM layers, where no one library call
     computes the function, time instead the unfused chain of the same
     layer (the rel-pos / LayerNorm kernels plus cuBLAS matmuls), and for
     fused_window_block also the split pair fused_window_attn +
     fused_mlp_stream; for int8_matmul, torch.matmul by the bf16 weight it
     was quantised from (and its decode body, M <= 16, run twice on the
     same inputs must give the same bits); for the training attention, its
     forward (O and LSE) and its backward (dq, dk, dv), against SDPA's
     forward and forward plus backward; for the two rel-pos wrappers, SDPA
     given the bias precomputed and SDPA with the bias built inside the
     timed call, at
     grids on both sides of the split by length (the window kernel up to
     256 tokens, where one call must run exactly one CUDA kernel under
     torch.profiler; the global kernel above, where a call must run the
     factor einsums' kernels plus exactly one); rms_norm_fused (bf16
     scale), layer_norm_fused (bf16 scale and bias) and flash_attention_qkv
     (CLIP-L's fused QKV) must each run exactly one CUDA kernel a call, and
     the fused SAM layers at SAM-H's shapes with bf16 weights their own
     chains only (fused_window_attn 4, fused_mlp_stream 3,
     fused_window_block 7, fused_global_tail 5 plus the factor einsums');
     the fused layers' GEMM (csrc/gemm.cuh) at each SAM-H shape, QKV, proj,
     fc1 (GELU) and fc2 at M = 9800 and the fp32-residual forms at M =
     8192, held against an fp32 product and timed beside torch.matmul
     (timed only), with both rates in TFLOP/s, and the LayerNorm row pass
     (csrc/norms.cu) on bf16 and fp32 rows, with and without the pad mask;
     torch.library.opcheck of each of the 13 anyref:: ops through which
     every kernel but the all-reduce launches (ops/flash.py OPS; the
     all-reduce, an op over a group of ranks, in phase 11(0)) on bf16 CUDA
     tensors, and
     each op's host cost a call against a direct call of its CUDA
     implementation (each call timed alone, the launch queue empty);
  3. check the slice on the card against the same weights and inputs on the
     CPU (whose plain versions the CPU tests hold against the JAX package):
     "unfused" and "unfused_qkv" at anyref_tiny(), "fused" and "fused_block"
     at anyref_tiny() with a 512-pixel SAM image and windows of 8, where
     both fused SAM gates open, the int8 decoder at anyref_tiny(); "fused"
     at rephrase_weight=0.1, greedy and speculative, with lm_head's [SEG]
     column scaled so that a row's first [SEG] comes at k >= 1 (ids equal
     to the CPU's); a crop, a box and a text + audio batch, greedy and
     speculative, on "unfused" and "fused" (ids equal to the CPU's); and
     one train step's losses and gradients at anyref_tiny();
  4. quantise the decoder for the int8 runs below and run phase 10(b) on
     these weights (the last run on the [in, out] layout); then for each
     encoder path, "fused" (the default), "fused_block",
     "unfused_qkv" and "unfused": serve 4 text requests at anyref_7b width
     and depth (random weights from a seed) through Server -> Predictor ->
     generate with speculative decode, max_batch 2, and check every answer
     and each kernel's launch count on that path; then serve them again,
     warm, under torch.profiler for the wall time, the device's busy share
     and the top kernels. Then the references on "fused": a crop, an audio,
     a box and a text request (batches [crop, audio] and [box, text]),
     answers, callbacks, launch counts (flash_attention_qkv 46 in the
     crop's batch, 23 in the other), encode_roi bit-equal to the CPU,
     encode_ref_images, encode_audio and the mel clips against the CPU
     plain path, assemble_embeds' placeholder and text rows bit for bit; a
     warm profiled round (the audio tower's and the crop CLIP pass's
     kernels between marker kernels) and each part timed alone. Then
     rephrase pooling on "fused": the [SEG] column
     rescaled so that answers emit tokens before [SEG], the 4 requests
     served at rephrase 0 and 0.1 (each request with a callback that must
     fire once, a counted round, Server.reset_stats, a profiled round), and
     generate's pooled term held against an fp32 recomputation from
     llama.forward (relative L2 <= 1e-2). Then the int8 decoder: time a
     greedy decode step on the bf16 decoder (in the serving layout by
     then), swap in the int8 decoder quantised at the phase's start, free
     the bf16 decoder, time the step again, and
     serve the 4 requests greedy
     (Server(speculative=False)) on the default path, answers, launch
     counts (int8_matmul per decoder pass) and peak memory checked; the
     int8 step's profile must show one CUDA kernel of int8_matmul.cu a
     product (the decode body, no second launch), its kernel time a step
     printed beside the bytes bound of the int8 weights;
  5. train LoRA at anyref_7b (random bf16 weights from a seed) with the
     Trainer, whose step on the card is compiled (one CUDA graph a batch
     key, the micro-steps a WHILE node): 8 synthetic samples, batch 2, 2
     micro-steps per step, 4 steps (the first eager, then its capture, then
     3 replays), per-layer checkpointing, the fused encoder path; check the
     losses, the moved LoRA weights, the untouched frozen weights and each
     kernel's launch count (the loop's condition kernel 3 times a replay);
     then one more replay under torch.profiler (busy time "not measured"
     where the profile lost the loop's records; CUDA events bound idle);
     then make_train_step's step from the host on the recorded batches,
     twice from the same seed: each step's losses, trainables and Adam
     moments of the compiled run bit-equal to the first eager run's where
     the two eager runs are, else within twice their spread; print
     step_fn's return time against the step's device time, the step wall
     eager against compiled, the idle bound, the capture seconds, the
     graph pool's bytes and the working memory of both;
  6. write the reference's artifacts at anyref_7b width (LLaMA cut to 2
     layers) to a temporary directory: a merged LLaVA .safetensors shard, a
     PEFT adapter, a SAM .pth; assemble_pretrained on the card and on the
     CPU (bit-equal), the conversion CLI with the adapter (its file
     bit-equal to the CPU build), and the 4 requests served on the
     assembled tree with the SentencePiece fixture tokenizer at rephrase
     0.1; print the cuts, the times and the peak memory;
  7. the segmentation eval (write_eval_root writes the data roots in a
     temporary directory): (a) evaluate_referseg, evaluate_reason,
     evaluate_coco20i (split 0) and evaluate_avs (S4, one 5-frame video) at
     anyref_tiny on "unfused" and at its 512-pixel SAM variant on "fused",
     on the card and on the CPU plain path from the same seeded weights
     ([SEG] column x EVAL_TINY_SEG_SCALE): ids equal, each mask different only
     where the CPU's logit is near 0, metrics within EVAL_METRIC_TOL, a
     non-empty mask in every harness, launch counts per predict call; the
     eval CLI in a subprocess on those weights saved with save_params must
     print the in-process result; (b), run in phase 4 on its anyref_7b
     weights before the int8 decoder replaces the bf16 one ([SEG] column x
     EVAL_SEG_SCALE_7B, rephrase 0.1): evaluate_referseg on "fused" over 16
     refs on 8 640 x 480 JPEGs, refs/s, the wall split between loader wait,
     predict and host scoring, launch counts, n, cIoU and gIoU, a non-empty
     mask, result.txt, then the pass warm under torch.profiler (busy,
     idle, kernels per ref between marker kernels), and rle.native();
  8. training from the reference's datasets and the region-caption eval
     (write_train_root writes the training readers' layouts, write_eval_root
     the eval's, in a temporary directory): (a) at anyref_tiny, the Trainer
     with no dataset (it builds the registry's mix, TRAIN_MIX: refCOCO text
     refs, COCO classes, ADE20K instances and classes, ReasonSeg and the
     inverse task's crops) on the card, 2 steps of 2 micro-batches of 2,
     "fused", remat, its batches recorded and replayed through
     make_train_step on the CPU (every loss term within SLICE_REL_TOL),
     then the same over refer_seg_inv_refcoco with roi and no_mask (boxes
     into encode_roi, no mask); evaluate_refer_inverse on "unfused" with
     crops and with boxes, card against the CPU from the same seeded
     weights (ids, so captions and every metric, equal; launch counts); the
     training CLI in a subprocess on tiny reference artifacts
     (reference_state_dicts), whose merged.pt must equal
     assemble_pretrained of the same artifacts (the first step's learning
     rate is 0); (b) at anyref_7b, the Trainer with no dataset on random
     bf16 weights from a seed over TRAIN_MIX from 640 x 480 JPEGs, "fused",
     batch 2 x 2 micro-steps, 2 steps, warmup 1, remat: finite losses, the
     LoRA weights moved and the frozen ones not, metrics.jsonl, each
     kernel's launches against the recorded batches (CLIP twice a
     micro-step where the step's batch carries crops), the step wall, the
     peak memory and the registry's lengths printed; and, run in phase 4
     on its weights before the int8 decoder replaces the bf16 one (the
     [SEG] column at its drawn values), evaluate_refer_inverse on "fused",
     greedy, INV_MNT new tokens, INV_REFS refs with crops and INV_REFS with
     boxes over 8 640 x 480 JPEGs: n, BLEU-4 and CIDEr-D finite in [0, 10],
     METEOR and SPICE NaN exactly where nltk is missing, two lines in
     inv_result.txt, launches a ref (flash_attention_qkv 46 with a crop, 23
     with a box), refs/s and the wall split;
  9. SAM alone, prompted by points, boxes and a grid (SamPredictor,
     SamAutomaticMaskGenerator, export_sam_decoder, the demo and
     AVS-refinement CLIs): (a) at anyref_tiny on "unfused" and at its
     512-pixel SAM on "fused", bf16 SAM weights from seed 0 (sam.init) on
     the card and on the CPU plain path: set_image's launches (one SAM
     encode), predict on a box, on points (labels 1 and 0) and on both,
     multimask on and off (iou and low-res logits within SLICE_REL_TOL,
     masks different only near 0, no launch), generate at 4 points a side
     in chunks of 6 with every mask kept (records paired by point, scores
     within SLICE_REL_TOL, masks different only near 0 and stability
     scores within what that allows, against the CPU's logits of every
     grid point), the exported decoder loaded on the card against the
     unexported function; the demo CLI and convert_avs_masks (a tiny SAM
     .pth of the reference's layout on a synthetic AVSBench root) in
     subprocesses, each printing and writing what its main does in
     process; (b), run in phase 4 on its SAM-H weights: set_image on a 640
     x 480 JPEG on each encoder path (launches those of phase 4's SAM
     encode, first and warm walls, kernel time under the profiler),
     predict on a box warm, generate at the defaults on "fused" (records,
     the wall split between encode, decode, stability and the host, the
     device's busy and idle share under the profiler), export_sam_decoder
     at SAM-H's decoder against the unexported function. Phase 2 also
     holds the encoder kernels at the SAM-alone path's batch-1 SAM-H
     shapes;
 10. the decoder's serving layouts and the exported generate: (a) at
     anyref_tiny on "unfused" and at its 512-pixel SAM on "fused", seeded
     bf16 weights ([SEG] column x TINY_SEG_SCALE) on the card and on the
     CPU: a speculative Predictor at rephrase 0.1 converts each tree in
     place (ids, [SEG] slots and masks card vs CPU); export_generate of the
     card tree and of the unfused tree's decoder quantised by
     quantize_llama (nothing launched while tracing) and the export CLI's
     generate choice in a subprocess; a fresh interpreter loads each
     program and runs it on two prompts (ids and [SEG] slots equal to eager
     generate on the card, masks bit-equal, the same launches, no JAX
     module); (b), run in phase 4 on its anyref_7b weights before
     its first Server: speculative generate at batch 2 called directly on
     the [in, out] tree and on the same tree converted in place (ids,
     decode passes, busy time and idle share under the profiler, product
     calls and GEMM kernels a layer, prefill and verify-chunk device time;
     the prefill states within the bf16 floor measured in the same call,
     a differing id only at a near tie), then export_generate on "fused"
     of the tree cut to EXPORT_LAYERS_7B decoder layers at full width
     (free disk checked; export and load seconds, artifact bytes, the
     graph's write bytes; the program against eager generate on two
     requests: ids, [SEG] slots and masks bit-equal, the same launches,
     wall and device time). Phase 2 also holds flash_causal_attention at
     one rank's heads under a "model" axis of 2 ([2, 16, 640, 128]);
 11. multi-device serving on torch.distributed, ranks on the one card
     (spawned processes, gloo for the host, a collective timeout, the
     kernels built by this process first; the card time-slices the ranks'
     contexts): (0) the all-reduce kernel over "model" (csrc/all_reduce.cu)
     on two ranks at (1, 2): a 4-byte sum first, opcheck of its op, then
     fp32 and bf16 sums from one element through the programs' shapes at
     anyref_7b (a decode pass's, a verify chunk's, a prefill's and
     training's hidden rows, the logits) bit-equal to gloo's all_reduce on
     the CPU copies and the same bits on both ranks, one call captured
     into a CUDA graph and replayed ALL_REDUCE_REPLAYS times (each equal,
     each counted), the mesh closed and a second made, summed over and
     closed (the library's exchange bytes back to 0 each time, the closed
     key raising), and, in two new ranks, a run where rank 1 never
     arrives (rank 0 must fail within the kernel's wait bound and a
     margin); each rank's task closes its mesh before it returns (the
     other phases' too); each case's time (CUDA
     events) against its bytes bound, the plain version's and gloo's on
     the card tensors; (a) anyref_tiny's seed-0 bf16 weights sharded at
     (1, 2) and at (2, 2) (four ranks), greedy and speculative generate on
     "unfused" (ids equal to the single-rank port's on the CPU, masks
     within SLICE_REL_TOL), then the Predictor compiled on every rank on a
     text and a crop key (the replay's ids and [SEG] slots the CPU
     Predictor's, masks within SLICE_REL_TOL and bit-equal to the key's
     eager first call, as many all-reduces launched; the model ranks of a
     data coordinate the same bits); (b) anyref_7b at full width and
     depth, seed-0 bf16 weights made on the card with the [SEG] column x
     1000: the 4 requests in pinned pairs through a single-process Server
     (speculative, "fused", max_batch 2), and again with the decoder's
     input embeddings moved by one bf16 ulp (the bf16 floor of the low-res
     logits), then (c)'s rounds and window through a compiled
     single-process Server; then two ranks at (1, 2), each making the same
     weights and keeping its blocks (parallel/partition.py shard_params),
     each key compiled on both: rank 0's leader Server and rank 1's
     follower serve a warm and a checked round of pinned pairs and a
     window of 50 more (ids equal to the single process's, low-res logits
     within PARALLEL_FLOOR_FACTOR x the floor, the plain layout kept, each
     kernel's launches as phase 4 counts them on "fused" on both ranks,
     flash_causal_attention at [2, 16, 640, 128], each replay's card
     launches the key's eager call's, the all-reduce kernel as often on
     both ranks); each rank prints predict_async's return time against its
     device span (CUDA events), the capture, the pool, its peak memory, the
     exchange area, its all-reduces a prefill and a decode pass and the
     window's q/s and pair spread against the single process's; (c) the
     same weights at (2, 1), each rank's Predictor compiled (one row a
     rank of each batch, the rows gathered in complete()): the same rounds
     and window, 6 batches of one key, ids equal to the single process's,
     low-res logits within PARALLEL_FLOOR_FACTOR x (b)'s floor, each
     request's rows bit-equal across its batches, each replay's card
     launches the eager batch's, the same prints;
 12. multi-device LoRA training on torch.distributed, ranks on the one
     card (spawned as in phase 11, the parent holding no model tensor
     while they run), the Trainer compiled on every rank: (a)
     anyref_tiny's seed-0 bf16 weights at mesh (1, 2), (2, 1) and (2, 2),
     2 steps of 2 micro-batches of 2 a data rank ("fused", remat, warmup
     0, a checkpoint every step): the second step a replay, bit-equal to
     make_train_step's eager mesh step (gradients, trainables, moments,
     count, losses) and launching what the first launched; the first
     step's loss terms and reduced gradient, gathered, within
     TRAIN_LOSS_TOL and TRAIN_GRAD_TOL (the CPU tests' limits) of a single
     process on the card on the same global batch, every rank's losses
     the logged ones, metrics.jsonl written once, and the (1, 2) run's
     checkpoint-1 resumed by a single-process Trainer; (b) anyref_7b at
     full width and depth at (1, 2), seed-0 bf16 weights made on the card
     by each rank, which keeps its blocks, and (c) at (2, 1), each rank
     holding the whole tree, the decoder cut to TRAIN_7B_DATA_LAYERS
     layers: the Trainer for TRAIN_7B_STEPS steps of 2
     micro-batches of 2 (the first from the host and captured, then
     replays; at (2, 1) two graphs with the host's data gradient sum
     between them), remat, "fused", after a single process's first step
     on the same global batch: each step's gradients, trainables, moments,
     count and losses bit-equal to the eager mesh step (twice from the
     same seed, where the two eager runs are), the logged losses, each
     rank's, step 1's within TRAIN_LOSS_TOL of the single process's, LoRA
     moved and the frozen weights untouched, each kernel's launches those
     of phase 5 a micro-step, flash_causal_attention_diff only at the
     rank's heads ([2, 16, 768, 128] at (1, 2)), each replay's card
     launches the first step's; each rank prints the step walls against
     the eager step's, the capture, the pool, the exchange area, the
     all-reduce launches a step, the host's data sum and its peak memory.
     Phase 2 also holds the training attention at [2, 16, 768, 128];
 13. the Predictor's compiled request program (one CUDA graph a shape key,
     the decode loop a WHILE conditional node whose predicate the kernel of
     csrc/graph_loop.cu sets on the device): (a) at anyref_tiny, seed-0 bf16
     weights on the card and on the CPU, a Predictor greedy on "unfused"
     with text, crop, box and audio keys in one graph pool (the pool after
     each capture against each key's pool alone), speculative on "fused"
     at the 512-pixel SAM with force_accept and max_accept and without
     (text and crop keys), and greedy on the int8 decoder: each key's first
     call (eager, then the capture) and second call (a replay, under
     set_sync_debug_mode("error"), capturing nothing, raising each
     wrapper's count as the eager run did), the replay's ids, [SEG] slots
     and decode passes equal to the CPU Predictor's host loop, its masks
     within SLICE_REL_TOL, capture seconds and graph nodes printed; (b),
     run in phase 4 on its anyref_7b weights (speculative, "fused") and on
     its int8 decoder (greedy): one batch through the serving Predictor
     against the same Predictor code on a 1 x 1 mesh (eager): ids, [SEG]
     slots and decode passes equal, low-res logits bit-equal or within
     PARALLEL_FLOOR_FACTOR x the bf16 floor measured in the same call,
     the wrappers' launches phase 4's a batch, the replay's device
     records of the port's kernels the eager run's and the condition
     kernel once a pass and once more; predict_async's return time
     against the batch's device time, capture seconds, nodes and pool
     bytes; then the 4 requests through a speculative Server of
     pipeline_depth 3 beside one on a 1 x 1 mesh: the first round's ids
     equal, GRAPH_ROUNDS_7B rounds at once warm (eager, graph, graph,
     eager), the batches in flight at a dispatch, wall, q/s and, under
     torch.profiler, the device's idle share;
 14. print {"kernels": [...]} and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# bf16 tolerance of a kernel against its plain version: |a - b| <= ATOL +
# RTOL * |b|, and a relative L2 error of at most DIFF_REL_L2 (below). One
# bf16 ulp is 2^-8 relative (0.4%); the kernels round P to bf16 at a
# different running max than the plain version, and sum in another order.
ATOL = RTOL = 2e-2
# The training attention against its plain versions, per output: |a - b| <=
# DIFF_ATOL_RMS * rms(b) + RTOL * |b| element by element, and a relative L2
# error of at most DIFF_REL_L2. Its gradients are small on most rows (dq_i
# and dk_j fall as 1/sqrt(row)), so a fixed ATOL would be as large as the
# values it checks. The gradients add TERM_TOL x the size of their terms
# (see term_sizes): dS is rounded to bf16 in both versions, at values that
# differ in their last fp32 bits, and P^T in the dv kernel only, so each
# term may differ by one bf16 ulp (at most 2^-7 relative) of its rounded
# factor; where terms cancel, that sets the error, not the gradient's size.
DIFF_ATOL_RMS = 1e-2
DIFF_REL_L2 = 1e-2
TERM_TOL = 2.0 ** -7
# The tiny slice on the card against the CPU: bf16 through two layers of
# each tower, relative to the largest magnitude of the reference.
SLICE_REL_TOL = 5e-2
# lm_head's [SEG] column scalings under which random weights answer a few
# tokens before their first [SEG], so that rephrase pooling has a span. On
# the H100's machine (torch 2.11; another torch's CPU generator draws other
# weights): anyref_tiny with a 512-pixel SAM, seed 0, gives the same ids on
# the CPU from -2.6 to -5, row 0's first [SEG] at 3 and none in row 1;
# anyref_7b, seed 0, gives the same first [SEG]s from 6 to 6.5: at 0, 3,
# none and 0 served two to a batch (serve_rephrase), at 0, 3, 2 and 0 all
# four in one batch (check_pooled_term).
TINY_SEG_SCALE = -4.0
SEG_SCALE_7B = 6.0
# generate's rephrase pooling at anyref_7b against its fp32 recomputation
# from generate's own inputs to the pooling (check_pooled_term), relative
# L2 over the answers with a span, for the attention row, the pooled
# vector and the term as it reaches seg_embeddings. An index fault (a
# wrong slot, span or pad) is O(1).
POOLED_REL_L2 = 1e-2
# The same pooling recomputed from llama.forward's states instead, a second
# reading: llama.forward's bf16 states differ from prefill's and decode's
# by 1.8% after 32 layers (a span of one state, where pooling is the
# identity), and the term with its sum in fp32 differs from generate's,
# which rounds the sum to the bf16 [SEG] state as the reference does (2%
# of the term at anyref_tiny); so SLICE_REL_TOL, the phase's bf16 limit.
FORWARD_REL_L2 = SLICE_REL_TOL
H100_BYTES_PER_S = 3.35e12    # HBM3, NVIDIA data sheet (SXM)
H100_BF16_OPS_PER_S = 989e12  # dense bf16 tensor cores
H100_FP32_OPS_PER_S = 67e12   # fp32 outside the tensor cores
SPIN_CYCLES = 1_000_000       # ~0.5 ms at the H100's ~1.98 GHz
# decode_step_ms: steps timed back to back, and steps profiled
DECODE_ITERS = 10
PROFILED_STEPS = 3
# kernels_per_call: profiler sessions to try before giving up on one that
# kept every case's device records; the marker kernel between two cases
# (torch.cuda._sleep's), by a part of its name, and its length
COUNT_SESSIONS = 3
MARKER = "spin_kernel"
MARKER_CYCLES = 1000
# the launch counter's kernel (csrc/launch_count.cu)
COUNTER_KERNEL = "anyref_count_kernel"
# rel-pos attention cases of phase 2, (B, H, W, heads, head width): SAM-H's
# windows and global layers, the window kernel's upper edge (16 x 16), a
# grid past it (20 x 20, the global kernel, W not dividing 128), an odd head
# width (9 x 9, 36: unvectorised loads; 17 x 19, 36: the global kernel on
# heads the wrapper zero-pads to 40), non-square grids (8 x 12; 5 x 64, the
# global kernel's W = 64 path with a ragged last key tile; for the
# split-head wrapper every non-square grid is read as the unfused path
# reads it, heads permuted out of a fused QKV in place) and the fused QKV
# of SAM-H's global layers ([2, 4096, 3840])
RELPOS_SPLIT_CASES = ((50, 14, 14, 16, 80), (2, 64, 64, 16, 80),
                      (3, 16, 16, 2, 32), (3, 20, 20, 2, 32),
                      (3, 8, 12, 2, 32), (2, 17, 19, 2, 36),
                      (1, 5, 64, 2, 64))
RELPOS_QKV_CASES = ((50, 14, 14, 16, 80), (3, 9, 9, 2, 36),
                    (3, 16, 16, 2, 32), (3, 8, 12, 2, 32), (3, 20, 20, 2, 32),
                    (2, 64, 64, 16, 80), (2, 17, 19, 2, 36))
# SAM-H at batch 1, the SAM-alone path's shapes (SamPredictor.set_image,
# SamAutomaticMaskGenerator.generate): 25 windows of 14 x 14 and one 64 x 64
# global grid, 16 heads of 80, for both rel-pos wrappers; their inputs come
# from a generator of their own (batch1_rnd), so every other case keeps its
# inputs
BATCH1_RELPOS_CASES = ((25, 14, 14, 16, 80), (1, 64, 64, 16, 80))

TEXTS = (
    "the small brown dog that is sitting on the left side of the wooden "
    "bench next to the old man reading a newspaper",
    "the red car parked behind the blue truck at the far end of the street, "
    "partly hidden by the tall green hedge",
    "the woman in the yellow raincoat holding an umbrella while she waits "
    "for the bus at the corner of the square",
    "the largest of the three ceramic bowls on the kitchen shelf, the one "
    "with the painted flowers around its rim",
)
IMAGE_SIZES = ((224, 224), (224, 320), (288, 224), (224, 480))
# the reference requests of phases 3 and 4, all on the 224 x 480 image: a
# 224 x 224 crop of it (so neither CLIP preprocess resizes), a fixed RoI box
# (pixel xyxy) and 5 s of audio at 16 kHz from the seed
REF_CROP_XYXY = (128, 0, 352, 224)
REF_ROI_XYXY = (60.0, 30.0, 300.0, 200.0)
AUDIO_SECONDS = 5.0
# encode_ref_images and encode_audio on the card against the CPU plain path
# on the same bf16 weights, relative L2, at most REF_FLOOR_FACTOR times the
# bf16 floor: the CPU's bf16 result against its fp32 result from the same
# weights. Two bf16 computations that round at other points (the card's
# kernels and cuBLAS, the CPU's plain ops) each stray from fp32 by about the
# floor, so from each other by at most twice it; a wrong weight, row or
# pooling is O(1)
REF_FLOOR_FACTOR = 2.0
# phase 11(b): the 2-rank low-res logits against the single process's, in
# units of the bf16 floor measured in the same call
PARALLEL_FLOOR_FACTOR = 2.0
# the mel clips, card (cuFFT) against CPU, after (x - mean) / std: the CPU
# tests' limit against the reference (tests/test_torch_references.py)
MEL_ATOL = 2e-3 / 9.138


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------
class Timer:
    """Median device time of one call, CUDA events around each launch. The
    L2 cache (50 MB) is flushed before every launch by READING a 256 MB
    buffer: a write would leave the cache full of dirty lines whose
    write-back the timed call would pay. A spin kernel of ~0.5 ms then keeps
    the card busy while the host enqueues the start event, the call and the
    end event, so a wrapper's host work (ctypes, allocation) is not timed as
    device idle between the events."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.ones(64 << 20, dtype=torch.float32, device="cuda")

    def ms(self, fn, iters: int) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            self.flush.amax()
            torch.cuda._sleep(SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))


def bound(nbytes: float, ops: float, ops_rate: float):
    """Least time (ms) the card could take, and what sets it."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def causal_ops(L: int, hd: int, nh: int, kv_start) -> float:
    """Operations the data needs: 4*hd per kept (query, key) pair; each
    fully masked (left-pad) row needs only the mean of V, 2*hd*L once per
    (row of the batch, head)."""
    total = 0.0
    for pad in kv_start:
        kept = sum(q - pad + 1 for q in range(pad, L))
        total += nh * (4 * hd * kept + (2 * hd * L if pad else 0))
    return total


def kept_pairs(L: int, kv_start) -> int:
    """(query, key) pairs the causal and pad mask keep, over the batch."""
    return sum(sum(q - pad + 1 for q in range(pad, L)) for pad in kv_start)


# ---------------------------------------------------------------------------
# the registered ops (ops/flash.py OPS): sample calls, opcheck, dispatch cost
# ---------------------------------------------------------------------------
def op_cases(torch, flash, device, dtype) -> dict:
    """{op name: its arguments} for each anyref:: op but those over a group
    of ranks (flash.GROUP_OPS), at small shapes its kernel takes (heads
    of 64, widths multiples of 8, windows of 8 x 8, a 16 x 16 global
    grid), the float tensors in ``dtype`` (bf16 for the kernels, fp32 on
    the CPU), from seed 0. The training backward gets the log-sum-exp and
    delta of its forward on the same inputs."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, scale=1.0, dt=None):
        t = torch.randn(*shape, generator=g) * scale
        return t.to(device=device, dtype=dt or dtype)

    C, nh, hd, ws = 256, 4, 64, 8
    ln = (r(C, scale=0.1) + 1, r(C, scale=0.1))
    qkv_p = (r(C, 3 * C, scale=C ** -0.5), r(3 * C, scale=0.1))
    proj = (r(C, C, scale=C ** -0.5), r(C, scale=0.1))
    mlp = (*ln, r(C, 4 * C, scale=C ** -0.5), r(4 * C, scale=0.1),
           r(4 * C, C, scale=(4 * C) ** -0.5), r(C, scale=0.1))
    tab = (r(ws * ws, hd, scale=0.1), r(ws * ws, hd, scale=0.1))
    heads = [r(2, nh, 256, hd) for _ in range(4)]
    kv_start = torch.tensor([0, 37], device=device)
    out, lse = flash.causal_attention_diff_fwd_plain(*heads[:3], kv_start)
    delta = flash.causal_delta(heads[3], out)
    w = r(C, 2 * C, scale=C ** -0.5, dt=torch.float32)
    scale = w.abs().amax(0).clamp_min(1e-8) / 127.0
    w_q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    window = [r(2, nh, ws * ws, hd) for _ in range(3)]
    grid = (14, 14)          # 2 x 2 windows of 8 over a 14 x 14 grid
    return {
        "layer_norm_fused": (r(4, 37, C), *ln, 1e-6),
        "rms_norm_fused": (r(2, 19, 2 * C), r(2 * C, scale=0.1) + 1, 1e-6),
        "flash_relpos_attention": (*window, r(ws, ws, hd, scale=0.1),
                                   r(ws, ws, hd, scale=0.1), [ws, ws]),
        "flash_causal_attention": (*heads[:3], kv_start),
        "causal_attention_diff_fwd": (*heads[:3], kv_start),
        "causal_attention_diff_bwd": (*heads, lse, delta, kv_start),
        "fused_window_attn": (r(4, ws * ws, C), *ln, *qkv_p, *tab, *proj,
                              [ws, ws], nh, list(grid), 2, 1e-6),
        "fused_window_block": (r(4, ws * ws, C), *ln, *qkv_p, *tab, *proj,
                               *mlp, [ws, ws], nh, list(grid), 2, 1e-6),
        "fused_mlp_stream": (r(300, C), *mlp, 1e-6),
        "fused_global_tail": (r(1, 256, C), r(1, 256, 3 * C),
                              r(16, 16, hd, scale=0.1),
                              r(16, 16, hd, scale=0.1), *proj, *mlp,
                              [16, 16], nh, 1e-6),
        "flash_relpos_attention_qkv": (r(2, ws * ws, 3 * C),
                                       r(ws, ws, hd, scale=0.1),
                                       r(ws, ws, hd, scale=0.1), [ws, ws],
                                       nh),
        "flash_attention_qkv": (r(2, 257, 3 * C), nh, None),
        "int8_matmul": (r(3, C), w_q, scale),
    }


# op calls timed for the dispatch cost: pairs of one call each way
DISPATCH_PAIRS = 101


def check_ops(torch, flash) -> dict:
    """Phase 2's check of the registered ops: torch.library.opcheck of each
    anyref:: op on bf16 CUDA tensors (op_cases: its schema, its fake
    implementation's shapes, dtypes and strides against the kernel's
    outputs, its trace under AOT dispatch); then each op's host cost a
    call. Each call is timed alone on the host's clock, the card
    synchronised before it (an empty launch queue, so the time is the
    host's enqueue and nothing waits on the card; op_cases' small shapes
    keep any device work far below it) and after it (not timed):
    DISPATCH_PAIRS pairs of torch.ops.anyref.<op> and a direct call of its
    CUDA implementation (flash.OPS), the pair's order swapped each time.
    -> {op: {"op_us", "direct_us" (medians), "overhead_us" (the median of
    the pairs' differences), "overhead_iqr_us" (its quartiles)}}."""
    t0 = time.time()
    cases = op_cases(torch, flash, "cuda", torch.bfloat16)
    # an op over a group of ranks is opchecked on its ranks (phase 11(0))
    if set(cases) != set(flash.OPS) - set(flash.GROUP_OPS):
        fail(f"op cases {sorted(cases)} for ops {sorted(flash.OPS)}")
    for name, args in cases.items():
        op = getattr(torch.ops.anyref, name).default
        result = torch.library.opcheck(op, args)
        if set(result.values()) != {"SUCCESS"}:
            fail(f"opcheck of anyref::{name} on the card: {result}")
    log(f"[ops] torch.library.opcheck on bf16 CUDA tensors: all "
        f"{len(cases)} anyref:: ops pass (schema, fake tensors, AOT "
        f"dispatch) in {time.time() - t0:.1f} s")

    def host_us(fn, args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        us = (time.perf_counter() - t0) * 1e6
        torch.cuda.synchronize()
        return us
    out = {}
    for name, args in cases.items():
        op = getattr(torch.ops.anyref, name).default
        direct = flash.OPS[name]
        for _ in range(5):
            host_us(op, args)
            host_us(direct, args)
        pairs = []
        for i in range(DISPATCH_PAIRS):
            if i % 2:
                d = host_us(direct, args)
                pairs.append((host_us(op, args), d))
            else:
                pairs.append((host_us(op, args), host_us(direct, args)))
        pairs = np.asarray(pairs)
        diff = pairs[:, 0] - pairs[:, 1]
        q1, q3 = (float(x) for x in np.percentile(diff, [25, 75]))
        out[name] = {"op_us": float(np.median(pairs[:, 0])),
                     "direct_us": float(np.median(pairs[:, 1])),
                     "overhead_us": float(np.median(diff)),
                     "overhead_iqr_us": [q1, q3]}
        r = out[name]
        log(f"[ops] {name}: {r['op_us']:8.2f} us a call through "
            f"torch.ops.anyref, {r['direct_us']:8.2f} us calling its CUDA "
            f"implementation (host, queue empty, medians of "
            f"{DISPATCH_PAIRS}); dispatch {r['overhead_us']:+7.2f} us "
            f"(quartiles {q1:+.2f} .. {q3:+.2f})")
    return out


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------
def check_kernels(torch, F, flash, port):
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(1234)
    # the rel-pos cases added beside the first slices' draw from their own
    # generator, so every other case keeps its inputs
    g_extra = torch.Generator(device="cuda").manual_seed(4321)

    def rnd(*shape, scale=1.0, gen=g):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(
            torch.bfloat16)

    def rnd_extra(*shape, scale=1.0):
        return rnd(*shape, scale=scale, gen=g_extra)

    per_call = kernels_per_call(torch, flash, rnd_extra)
    torch.cuda.empty_cache()
    causal = {k: per_call[("causal", k)] for k in
              ("forward", "prefill", "backward", "delta")}
    log(f"[kernel] causal kernels, CUDA kernels a call (torch.profiler): "
        f"{json.dumps(causal)}")
    if (causal["forward"], causal["prefill"]) != (1, 1) or \
            causal["backward"] != causal["delta"] + 2 or causal["delta"] < 1:
        fail(f"causal kernels: {json.dumps(causal)} CUDA kernels a call, "
             "want 1 a forward or prefill call and the delta op's plus 2 a "
             "backward call")

    def compare(name, got, want):
        """-> (max abs err, relative L2 err): every element within ATOL +
        RTOL |plain|, and the whole within DIFF_REL_L2 of the plain
        version's norm, so that outputs much smaller than ATOL (attention
        averages) are held to their own size too."""
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        if got.shape != want.shape:
            fail(f"{name}: kernel output {tuple(got.shape)}, plain "
                 f"{tuple(want.shape)}")
        if not bool(torch.isfinite(got).all()):
            fail(f"{name}: non-finite kernel output")
        err = (got - want).abs()
        rel_l2 = float(err.norm() / want.norm().clamp_min(1e-30))
        if not bool((err <= ATOL + RTOL * want.abs()).all()) or \
                rel_l2 > DIFF_REL_L2:
            fail(f"{name}: kernel disagrees with its plain version, max abs "
                 f"err {err.max().item()}, relative L2 err {rel_l2:.4g} "
                 f"(limit {DIFF_REL_L2})")
        return float(err.max().item()), rel_l2

    def compare_scaled(name, got, want, term_tol=None):
        """-> (max abs err, relative L2 err) under diff_errors' limits."""
        torch.cuda.synchronize()
        if got.shape != want.shape:
            fail(f"{name}: kernel output {tuple(got.shape)}, plain "
                 f"{tuple(want.shape)}")
        if not bool(torch.isfinite(got).all()):
            fail(f"{name}: non-finite kernel output")
        err, rel_l2, bad = diff_errors(got, want, term_tol)
        if bad or rel_l2 > DIFF_REL_L2:
            fail(f"{name}: kernel disagrees with its plain version: {bad} "
                 f"elements over {DIFF_ATOL_RMS} x rms + {RTOL} x |plain| "
                 f"(+ term limit), max abs err {err}, relative L2 err "
                 f"{rel_l2:.4g} (limit {DIFF_REL_L2})")
        return err, rel_l2

    one_kernel = {}
    for key, what in ((("rms_norm_fused", "1280x4096"), "bf16 scale"),
                      (("layer_norm_fused", "9800x1280"),
                       "bf16 scale and bias"),
                      (("flash_attention_qkv", "2x257x3072"), "CLIP-L")):
        n = one_kernel[key[0]] = per_call[key]
        log(f"[kernel] {key[0]} {key[1]}, {what}: {n:g} CUDA kernel(s) a "
            "call (torch.profiler)")
        if n != 1:
            fail(f"{key[0]} {key[1]}: {n:g} CUDA kernels a call, want 1")
    results = {"causal_per_call": causal, "one_kernel_per_call": one_kernel,
               "fused_per_call": check_fused_per_call(per_call)}

    def run_case(kname, shape_desc, kernel, plain, library, nbytes, ops,
                 ops_rate, iters=10, plain_iters=5, others=None, extra=None):
        """library: one PyTorch call computing the same function, or None;
        others: {name: fn} of other chains timed beside it as <name>_ms
        (for the fused SAM layers, where there is no library call, the
        unfused chain of the same layer, for fused_window_block the split
        pair, for rel-pos attention SDPA with the bias built in the call);
        extra: more keys of the row."""
        err, rel_l2 = compare(f"{kname} {shape_desc}", kernel(), plain())
        row = {"shape": shape_desc, **(extra or {}),
               "max_abs_err": err, "rel_l2_err": rel_l2,
               "ms": timer.ms(kernel, iters),
               "plain_ms": timer.ms(plain, plain_iters),
               "library_ms": None if library is None else
               timer.ms(library, iters)}
        for name, fn in (others or {}).items():
            row[f"{name}_ms"] = timer.ms(fn, iters)
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops, ops_rate)
        other = "".join(f" {name} {row[f'{name}_ms']:.4f} ms"
                        for name in (others or {}))
        lib = ("" if library is None else
               f" library {row['library_ms']:.4f} ms")
        log(f"[kernel] {kname} {shape_desc}: max_abs_err {err} relative L2 "
            f"err {rel_l2:.3g} kernel "
            f"{row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms{lib}{other} "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        results.setdefault(kname, []).append(row)
        return row

    # LayerNorm: SAM LN1/LN2 rows at batch 2 (window run with pad rows,
    # then global layers), bf16 weights as anyref_7b's; then a width that
    # is not a multiple of 8 (the element-by-element path), drawn from a
    # generator of its own so that the other cases keep their inputs
    g_odd = torch.Generator(device="cuda").manual_seed(8642)
    for N, C in ((9800, 1280), (8192, 1280), (777, 1283)):
        r = rnd if C == 1280 else (lambda *sh, scale=1.0: rnd(
            *sh, scale=scale, gen=g_odd))
        x, s, b = r(N, C, scale=2.0), r(C), r(C)
        run_case("layer_norm_fused", f"{N}x{C}",
                 lambda: flash.layer_norm_fused(x, s, b, 1e-6),
                 lambda: flash.layer_norm_plain(x, s, b, 1e-6),
                 lambda: F.layer_norm(x, (C,), s, b, 1e-6),
                 2 * N * C * 2 + 2 * C * 2, 8 * N * C, H100_FP32_OPS_PER_S)
    # RMSNorm: LLaMA prefill rows at batch 2, L = 640
    N, C = 1280, 4096
    x, s = rnd(N, C), rnd(C)
    run_case("rms_norm_fused", f"{N}x{C}",
             lambda: flash.rms_norm_fused(x, s, 1e-6),
             lambda: flash.rms_norm_plain(x, s, 1e-6),
             lambda: F.rms_norm(x, (C,), s, 1e-6),
             2 * N * C * 2 + C * 2, 5 * N * C, H100_FP32_OPS_PER_S)
    # rel-pos attention, RELPOS_SPLIT_CASES (SAM-H's two shapes from the
    # main generator, the added ones from their own)
    for B, H, W, nh, hd in RELPOS_SPLIT_CASES:
        r = rnd if B == 50 or H == 64 else rnd_extra
        label, q, k, v, th, tw = relpos_split_case(r, B, H, W, nh, hd)
        relpos_case(torch, F, flash, run_case, "flash_relpos_attention",
                    label,
                    lambda: flash.flash_relpos_attention(q, k, v, th, tw,
                                                         (H, W)),
                    lambda: flash.relpos_attention_plain(q, k, v, th, tw,
                                                         (H, W)),
                    q, k, v, th, tw, (H, W), flash._relpos_route(H * W, hd),
                    per_call[("flash_relpos_attention", label)],
                    per_call.get(("factors", "flash_relpos_attention",
                                  label)))
    # causal prefill: LLaMA-7B, batch 2, prompt bucket 385 -> L 640, one
    # row left-padded by 200
    B, nh, L, hd = 2, 32, 640, 128
    q, k, v = (rnd(B, nh, L, hd) for _ in range(3))
    ks = torch.tensor([0, 200], dtype=torch.int32, device="cuda")
    pos = torch.arange(L, device="cuda")
    keep = ((pos[None, :] <= pos[:, None])[None]
            & (pos[None, None, :] >= ks[:, None, None]))[:, None]
    run_case("flash_causal_attention", f"{B}x{nh}x{L}x{hd}",
             lambda: flash.flash_causal_attention(q, k, v, ks),
             lambda: flash.causal_attention_plain(q, k, v, ks),
             lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep),
             4 * B * nh * L * hd * 2 + B * 4,
             causal_ops(L, hd, nh, (0, 200)), H100_BF16_OPS_PER_S)
    # the same prefill at one rank's heads under a "model" axis of 2 (phase
    # 11), drawn from a generator of its own
    g_local = torch.Generator(device="cuda").manual_seed(2020)
    nh_local = nh // 2
    q, k, v = (rnd(B, nh_local, L, hd, gen=g_local) for _ in range(3))
    run_case("flash_causal_attention", f"{B}x{nh_local}x{L}x{hd}",
             lambda: flash.flash_causal_attention(q, k, v, ks),
             lambda: flash.causal_attention_plain(q, k, v, ks),
             lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep),
             4 * B * nh_local * L * hd * 2 + B * 4,
             causal_ops(L, hd, nh_local, (0, 200)), H100_BF16_OPS_PER_S)
    del q, k, v, keep
    check_causal_diff(torch, F, flash, timer, rnd, compare_scaled, results)
    check_causal_diff_wrapper(torch, F, flash, port["attention"], rnd,
                              compare_scaled)
    check_gemm_and_row_pass(torch, F, flash, run_case)
    check_fused_kernels(torch, F, flash, port, rnd, run_case)
    check_relpos_qkv_and_int8(torch, F, flash, port["quant"], rnd, rnd_extra,
                              run_case, per_call)
    check_batch1(torch, F, flash, port, run_case, per_call)
    del timer
    torch.cuda.empty_cache()
    return results


def check_causal_diff(torch, F, flash, timer, rnd, compare, results):
    """The training attention at LLaMA-7B training (batch 2, L = 512 + 255
    padded to 768, no pad), then at [2, 4, 200 -> 256, 32] with kv_start
    [0, 50], the cotangent zero on left-pad and right-pad rows as the
    slice and the reference's test give it, at a ragged [1, 2, 300, 64],
    and at one rank's heads under a "model" axis of 2 (phase 12(b): [2,
    16, 768, 128]). Forward: O and LSE; backward:
    delta = rowsum(dO * O), dq and dk/dv from the forward's O and LSE, each
    side from its own forward."""
    # the ragged case and one rank's heads under a "model" axis of 2 draw
    # from generators of their own, so the others and the wrapper check
    # after them keep their inputs
    def own_draw(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)

        def draw(*shape, scale=1.0):
            return (torch.randn(shape, generator=g, device="cuda")
                    * scale).to(torch.bfloat16)
        return draw

    for B, nh, L, Lp, hd, pads, draw in (
            (2, 32, 768, 768, 128, None, rnd),
            (2, 4, 200, 256, 32, (0, 50), rnd),
            (1, 2, 300, 300, 64, None, own_draw(4242)),
            (*TRAIN_RANK_CAUSAL_SHAPE[:2], 768, 768, 128, None,
             own_draw(4343))):
        q, k, v = (torch.nn.functional.pad(draw(B, nh, L, hd, scale=0.5),
                                           (0, 0, 0, Lp - L))
                   for _ in range(3))
        ks = (None if pads is None else
              torch.tensor(pads, dtype=torch.int32, device="cuda"))
        rows = torch.arange(Lp, device="cuda")[None, None, :, None]
        live = rows < L
        if ks is not None:
            live = live & (rows >= ks[:, None, None, None])
        do = torch.where(live, draw(B, nh, Lp, hd), 0).to(torch.bfloat16)
        desc = f"{B}x{nh}x{L}->{Lp}x{hd}" + ("" if ks is None else
                                             f" kv_start {list(pads)}")
        o, lse = flash.causal_attention_diff_fwd(q, k, v, ks)
        po, plse = flash.causal_attention_diff_fwd_plain(q, k, v, ks)
        grads = flash.causal_attention_diff_bwd(q, k, v, o, lse, do, ks)

        def plain_bwd():
            delta = flash.causal_delta(do, po)
            return (flash.causal_attention_dq_plain(q, k, v, do, plse, delta,
                                                    ks),
                    *flash.causal_attention_dkv_plain(q, k, v, do, plse,
                                                      delta, ks))
        terms = term_sizes(torch, flash, q, k, v, do, po, plse, ks)
        errs, rel_l2 = {}, {}
        for n, a, b in zip(("o", "lse", "dq", "dk", "dv"), (o, lse, *grads),
                           (po, plse, *plain_bwd())):
            errs[n], rel_l2[n] = compare(
                f"flash_causal_attention_diff {desc} {n}", a, b,
                terms.get(n))
        del terms
        del grads
        qg, kg, vg = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        mask = None if ks is None else flash._causal_keep(Lp, ks, "cuda")

        def sdpa():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=mask is None)

        def sdpa_fwd_bwd():
            qg.grad = kg.grad = vg.grad = None
            out = F.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=mask, is_causal=mask is None)
            out.backward(do)

        n_el = B * nh * Lp * hd
        kept = kept_pairs(Lp, pads or (0,) * B)
        fwd_ops = causal_ops(Lp, hd, nh, pads or (0,) * B)
        row = {"shape": desc, "max_abs_err": max(errs.values()),
               "max_abs_err_by_output": errs, "rel_l2_err_by_output": rel_l2,
               "ms": timer.ms(lambda: flash.causal_attention_diff_fwd(
                   q, k, v, ks), 10),
               "plain_ms": timer.ms(lambda: flash.causal_attention_diff_fwd_plain(
                   q, k, v, ks), 3),
               "library_ms": timer.ms(sdpa, 10),
               "backward_ms": timer.ms(lambda: flash.causal_attention_diff_bwd(
                   q, k, v, o, lse, do, ks), 10),
               "backward_plain_ms": timer.ms(plain_bwd, 3),
               "delta_ms": timer.ms(lambda: flash.causal_delta(do, o), 10),
               "library_fwd_bwd_ms": timer.ms(sdpa_fwd_bwd, 10)}
        row["bound_ms"], row["bound_by"] = bound(
            4 * n_el * 2 + B * nh * Lp * 4, fwd_ops, H100_BF16_OPS_PER_S)
        row["backward_bound_ms"], row["backward_bound_by"] = bound(
            8 * n_el * 2 + B * nh * Lp * 4,
            10 * hd * nh * kept + 2 * n_el, H100_BF16_OPS_PER_S)
        log(f"[kernel] flash_causal_attention_diff {desc}: max_abs_err "
            f"{json.dumps(errs)}, relative L2 err {json.dumps(rel_l2)}; "
            f"forward kernel {row['ms']:.4f} ms plain "
            f"{row['plain_ms']:.4f} ms SDPA {row['library_ms']:.4f} ms bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}); backward kernel "
            f"{row['backward_ms']:.4f} ms (of which the delta op "
            f"{row['delta_ms']:.4f} ms) plain {row['backward_plain_ms']:.4f}"
            f" ms, SDPA forward+backward {row['library_fwd_bwd_ms']:.4f} ms, "
            f"bound {row['backward_bound_ms']:.4f} ms "
            f"({row['backward_bound_by']})")
        results.setdefault("flash_causal_attention_diff", []).append(row)
        del q, k, v, qg, kg, vg, o, lse, po, plse, do


def diff_errors(got, want, term_tol=None):
    """The training attention's output against its plain version ->
    (max abs err, relative L2 err, number of elements over DIFF_ATOL_RMS x
    rms(want) + RTOL x |want| + term_tol)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    lim = DIFF_ATOL_RMS * want.square().mean().sqrt() + RTOL * want.abs()
    if term_tol is not None:
        lim = lim + term_tol.float()
    rel_l2 = float(err.norm() / want.norm().clamp_min(1e-30))
    return float(err.max()), rel_l2, int((err > lim).sum())


def term_sizes(torch, flash, q, k, v, do, o, lse, kv_start):
    """{output: TERM_TOL x the size of the terms each of its elements sums}
    for o, dq, dk and dv: P |V| / sum(P), |dS| |K|, |dS|^T |Q| and P^T |dO|,
    from the plain versions' P and dS (P = exp(S - lse) where kept, which
    is the forward's exp(S - m) / sum; dS = P (dP - delta) scale). Both
    versions round P (o, dv) or dS (dq, dk) to bf16 at values that differ
    in their last fp32 bits (o: P at another running max), so each term may
    differ by one bf16 ulp of its rounded factor."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bnqd,bnkd->bnqk", q.float(), k.float()) * scale
    p = torch.where(flash._causal_keep(q.shape[2], kv_start, q.device),
                    torch.exp(s - lse[..., None]), 0.0)
    del s
    dof = do.float()
    delta = flash.causal_delta(do, o)
    dp = torch.einsum("bnqd,bnkd->bnqk", dof, v.float())
    ds = (p * (dp - delta[..., None]) * scale).abs()
    del dp
    # a fully masked row's P is the uniform 1 / L over every key, not 0
    pf = torch.where(p.sum(-1, keepdim=True) > 0, p, 1.0 / q.shape[2])
    return dict(zip(("o", "dq", "dk", "dv"), (TERM_TOL * t for t in (
        torch.einsum("bnqk,bnkd->bnqd", pf, v.float().abs())
        / pf.sum(-1, keepdim=True),
        torch.einsum("bnqk,bnkd->bnqd", ds, k.float().abs()),
        torch.einsum("bnqk,bnqd->bnkd", ds, q.float().abs()),
        torch.einsum("bnqk,bnqd->bnkd", p, dof.abs())))))


def o_against_fp64(torch, flash, q, k, v, o_kernel, o_plain):
    """The training forward's o from the kernel and from the plain version
    (their first rows), each against the exact o in fp64 (unrounded P =
    exp(s - m), the causal mask and the float32.min rule, the sum clamped
    at 1e-20) of q/k/v [B, nh, L, hd] without a left pad. -> {kernel /
    plain max abs err, their largest and their root-mean-square error
    relative to the size of o's terms P |V| / sum(P), the number of
    elements where the kernel is further from fp64 than the plain version
    plus one bf16 ulp of |o|, and the other way round}."""
    s = torch.einsum("bnqd,bnkd->bnqk", q.double(), k.double()) * \
        q.shape[-1] ** -0.5
    s = torch.where(flash._causal_keep(q.shape[2], None, q.device), s,
                    float(torch.finfo(torch.float32).min))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    del s
    den = p.sum(-1, keepdim=True).clamp_min(1e-20)
    rows = o_kernel.shape[2]
    exact = (torch.einsum("bnqk,bnkd->bnqd", p, v.double()) / den)[:, :, :rows]
    size = (torch.einsum("bnqk,bnkd->bnqd", p, v.double().abs())
            / den)[:, :, :rows]
    del p
    ek = (o_kernel.double() - exact).abs()
    ep = (o_plain.double() - exact).abs()
    ulp = torch.ldexp(torch.ones_like(exact),
                      torch.frexp(exact.abs().float())[1] - 8).double()
    rk, rp = ek / size, ep / size
    return {"kernel_max_abs_err": float(ek.max()),
            "plain_max_abs_err": float(ep.max()),
            "kernel_max_err_over_term_size": float(rk.max()),
            "plain_max_err_over_term_size": float(rp.max()),
            "kernel_rms_err_over_term_size": float(rk.square().mean().sqrt()),
            "plain_rms_err_over_term_size": float(rp.square().mean().sqrt()),
            "kernel_worse_than_plain_plus_ulp": int((ek > ep + ulp).sum()),
            "plain_worse_than_kernel_plus_ulp": int((ep > ek + ulp).sum()),
            "elements": ek.numel()}


def check_causal_diff_wrapper(torch, F, flash, attention, rnd, compare):
    """The training attention as the decoder calls it:
    ops.attention.causal_attention(differentiable=True) at L = 767 on
    head-transposed views of [2, 767, 32, 128] leaves, then .backward of a
    seeded dO through the 128-pad and the slice, on three draws: the next
    of the phase's generator and two of generators of their own. O and
    dq/dk/dv against the plain versions on the explicitly padded inputs,
    under the limits of compare with each output's term limit
    (term_sizes); the wrapper must launch its forward and backward once
    each. Each draw's O, kernel and plain, is also held against the exact
    O in fp64 (o_against_fp64), and the numbers are logged."""
    B, L, nh, hd, Lp = 2, 767, 32, 128, 768
    diff = flash.flash_causal_attention_diff
    desc = f"{B}x{nh}x{L}x{hd}"
    for draw in range(3):
        if draw == 0:
            r = rnd
        else:
            g = torch.Generator(device="cuda").manual_seed(draw)

            def r(*shape, scale=1.0, g=g):
                return (torch.randn(shape, generator=g, device="cuda")
                        * scale).to(torch.bfloat16)
        leaves = [r(B, L, nh, hd, scale=0.5).requires_grad_(True)
                  for _ in range(3)]
        q, k, v = (t.transpose(1, 2) for t in leaves)
        do = r(B, nh, L, hd)
        zero_launches(flash)
        o = attention.causal_attention(q, k, v, differentiable=True)
        o.backward(do)
        counts = flash.launch_counts()
        fwd_bwd = (counts[diff.__name__],
                   counts["flash_causal_attention_diff_backward"])
        if fwd_bwd != (1, 1):
            fail(f"causal_attention(differentiable=True): {fwd_bwd[0]} "
                 f"forward and {fwd_bwd[1]} backward launches, want 1 each")
        with torch.no_grad():
            qp, kp, vp, dop = (F.pad(t.detach(), (0, 0, 0, Lp - L))
                               for t in (q, k, v, do))
            po, plse = flash.causal_attention_diff_fwd_plain(qp, kp, vp)
            delta = flash.causal_delta(dop, po)
            want = (po, flash.causal_attention_dq_plain(qp, kp, vp, dop,
                                                        plse, delta),
                    *flash.causal_attention_dkv_plain(qp, kp, vp, dop, plse,
                                                      delta))
            terms = term_sizes(torch, flash, qp, kp, vp, dop, po, plse, None)
            exact = o_against_fp64(torch, flash, qp, kp, vp, o.detach(),
                                   po[:, :, :L])
        errs = {}
        for n, a, b in zip(("o", "dq", "dk", "dv"),
                           (o.detach(), *(t.grad.transpose(1, 2)
                                          for t in leaves)), want):
            errs[n] = compare(
                f"causal_attention(differentiable=True) {desc} draw {draw} "
                f"{n}", a, b[:, :, :L], terms[n][:, :, :L])
        # o's elements over the limit without its term part, as it was
        exact["o_over_limit_without_term"] = diff_errors(o.detach(),
                                                         po[:, :, :L])[2]
        log(f"[kernel] flash_causal_attention_diff through "
            f"ops.attention.causal_attention(differentiable=True) {desc}, "
            f"draw {draw}, autograd backward: (max abs err, relative L2 err) "
            f"{json.dumps(errs)}; O against fp64 {json.dumps(exact)}")
        del leaves, q, k, v, do, o, qp, kp, vp, dop, po, plse, delta, want, \
            terms


# The fused layers' GEMM at SAM-H's shapes, (name, M, K, N, epilogue,
# residual dtype, output dtype): the four products of a window layer at M =
# 9800 (50 windows of 196 at batch 2) as fused_window_attn and
# fused_mlp_stream launch them, then the fp32 residual x1 of
# fused_window_block and fused_global_tail at M = 8192 (the global layers):
# written by proj, read by fc2.
GEMM_SHAPES = (("qkv", 9800, 1280, 3840, "bias", None, "bf16"),
               ("proj", 9800, 1280, 1280, "residual", "bf16", "bf16"),
               ("fc1", 9800, 1280, 5120, "gelu", None, "bf16"),
               ("fc2", 9800, 5120, 1280, "residual", "bf16", "bf16"),
               ("proj_x1", 8192, 1280, 1280, "residual", "bf16", "fp32"),
               ("fc2_x1", 8192, 5120, 1280, "residual", "fp32", "bf16"))


def check_gemm_and_row_pass(torch, F, flash, run_case):
    """Each GEMM_SHAPES product through flash._gemm against the same
    product in fp32 (bias, GELU and residual added in fp32, rounded once),
    timed beside torch.matmul of the same bf16 operands (timed only), both
    rates printed in TFLOP/s; then the LayerNorm row pass against
    layer_norm_rows_plain at SAM-H's window rows (bf16, with the pad mask
    of 50 windows of 14 over the 64 x 64 grid padded to 70), the fp32 x1
    of the global layers (no mask) and of the windows (with it), and C 128
    with windows of 8 over a 20 x 20 grid. Inputs from a generator of
    their own, so that every other case keeps its inputs."""
    g = torch.Generator(device="cuda").manual_seed(9753)
    dt = {"bf16": torch.bfloat16, "fp32": torch.float32}
    size = {"bf16": 2, "fp32": 4}
    epis = {"bias": flash._E_BIAS, "gelu": flash._E_GELU,
            "residual": flash._E_RES}

    def r(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(
            dtype)

    for name, M, K, N, epi, rdt, odt in GEMM_SHAPES:
        a, w, b = r(M, K), r(K, N, scale=K ** -0.5), r(N, scale=0.02)
        res = None if rdt is None else r(M, N, dtype=dt[rdt])

        def plain():
            y = a.float() @ w.float() + b.float()
            if epi == "gelu":
                y = flash.gelu_exact_plain(y)
            if res is not None:
                y = y + res.float()
            return y.to(dt[odt])

        ops = 2 * M * N * K
        row = run_case(
            "gemm", f"{name} {M}x{K}x{N}",
            lambda: flash._gemm(a, w, b, epis[epi], res=res,
                                out_dtype=dt[odt]),
            plain, lambda: torch.matmul(a, w),
            a.numel() * 2 + w.numel() * 2 + N * 2 + M * N * (
                size[odt] + (0 if rdt is None else size[rdt])),
            ops, H100_BF16_OPS_PER_S, iters=20, plain_iters=2,
            extra={"epilogue": epi, "residual": rdt, "out": odt})
        row["tflop_s"] = ops / row["ms"] / 1e9
        row["library_tflop_s"] = ops / row["library_ms"] / 1e9
        log(f"[kernel] gemm {name} {M}x{K}x{N}: {row['tflop_s']:.1f} TFLOP/s, "
            f"torch.matmul {row['library_tflop_s']:.1f} TFLOP/s")
        del a, w, b, res
    for M, C, xdt, win in ((9800, 1280, "bf16", (196, 25, 5, 14, 64, 64)),
                           (8192, 1280, "fp32", None),
                           (9800, 1280, "fp32", (196, 25, 5, 14, 64, 64)),
                           (1152, 128, "bf16", (64, 9, 3, 8, 20, 20))):
        x = r(M, C, scale=2.0, dtype=dt[xdt])
        ln = {"scale": 1 + r(C, scale=0.1), "bias": r(C, scale=0.05)}
        keep = None if win is None else flash.window_pad_mask(
            M // win[0], win[0], win[3], win[2], win[1], win[4:],
            "cuda").reshape(M, 1)
        run_case("layer_norm_rows", f"{M}x{C} {xdt}"
                 + (" masked" if win else ""),
                 lambda: flash._ln_rows(x, ln, 1e-6, win),
                 lambda: flash.layer_norm_rows_plain(x, ln["scale"],
                                                     ln["bias"], 1e-6, keep),
                 None, x.numel() * x.element_size() + M * C * 2 + 4 * C,
                 9 * M * C, H100_FP32_OPS_PER_S)
        del x


# check_fused_kernels' cases: the window layers (B, C, heads, window, grid),
# the global layers (B, H, W, C, heads) and CLIP's attention (B, L, heads,
# head width): the main path's shapes (SAM-H and CLIP-L at batch 2), then
# one small odd shape each
FUSED_WINDOW_CASES = ((2, 1280, 16, 14, 64), (2, 128, 4, 8, 20))
FUSED_GLOBAL_CASES = ((2, 64, 64, 1280, 16), (2, 16, 64, 64, 2))
CLIP_QKV_CASES = ((2, 257, 16, 64), (2, 77, 4, 36))


def check_fused_kernels(torch, F, flash, port, rnd, run_case,
                        window_cases=FUSED_WINDOW_CASES,
                        global_cases=FUSED_GLOBAL_CASES,
                        clip_cases=CLIP_QKV_CASES):
    """The four kernels of the fused encoder path, at the main path's shapes
    (SAM-H at batch 2: C 1280, 16 heads of 80, MLP 5120, windows of 14 on
    the 64 x 64 grid padded to 70, global grid 64 x 64; CLIP-L: [2, 257,
    3072], 16 heads of 64) and at one small odd shape each, or at the cases
    given."""
    enc, common = port["image_encoder"], port["common"]
    eps = 1e-6

    def lin(i, o):
        return {"w": rnd(i, o, scale=i ** -0.5), "b": rnd(o, scale=0.02)}

    def ln(d):
        return {"scale": (1 + 0.1 * rnd(d).float()).to(torch.bfloat16),
                "bias": rnd(d, scale=0.05)}

    def gemm_ops(M, *kn):
        return sum(2 * M * k * n for k, n in kn)

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    # fused_window_attn / fused_mlp_stream / fused_window_block: 7B
    # windows, then C 128 (4 heads of 32) with windows of 8 on a 20 x 20
    # grid (edge windows overhang)
    for B, C, nh, ws, G in window_cases:
        hd = C // nh
        p = {"norm1": ln(C), "norm2": ln(C),
             "attn": {"qkv": lin(C, 3 * C), "proj": lin(C, C),
                      "rel_pos_h": rnd(2 * ws - 1, hd, scale=0.1),
                      "rel_pos_w": rnd(2 * ws - 1, hd, scale=0.1)},
             "mlp": {"lin1": lin(C, 4 * C), "lin2": lin(4 * C, C)}}
        x = rnd(B, G, G, C)
        xw4, pad_hw = enc._window_partition(x, ws)
        mask, _ = enc._window_partition(
            torch.ones(B, G, G, 1, dtype=x.dtype, device="cuda"), ws)
        NW, L = xw4.shape[0], ws * ws
        nwc = pad_hw[1] // ws
        xw = xw4.reshape(NW, L, C)
        tht = enc._get_rel_pos_table(ws, p["attn"]["rel_pos_h"]).reshape(L, -1)
        twt = enc._get_rel_pos_table(ws, p["attn"]["rel_pos_w"]).reshape(L, -1)
        args = (xw, p["norm1"], p["attn"]["qkv"], tht, twt, p["attn"]["proj"],
                (ws, ws), nh, (G, G), nwc, eps)

        def unfused_attn():
            h = common.layer_norm(p["norm1"], xw4, eps, fused=True) * mask
            return xw4 + enc._attn_block(p["attn"], h, nh, (ws, ws))

        M = NW * L
        run_case("fused_window_attn", f"{NW}x{L}x{C}",
                 lambda: flash.fused_window_attn(*args),
                 lambda: flash.fused_window_attn_plain(*args), None,
                 nbytes(xw, p["attn"]["qkv"]["w"], p["attn"]["proj"]["w"],
                        tht, twt) + M * C * 2,
                 gemm_ops(M, (C, 3 * C), (C, C))
                 + NW * nh * (4 * L * L * hd + 2 * L * 2 * ws * hd),
                 H100_BF16_OPS_PER_S, plain_iters=3,
                 others={"unfused": unfused_attn})
        xf = xw.reshape(M, C) if C == 1280 else rnd(700, C)
        mlp = (xf, p["norm2"], p["mlp"]["lin1"], p["mlp"]["lin2"], eps)

        def unfused_mlp():
            h = common.layer_norm(p["norm2"], xf, eps, fused=True)
            return xf + common.linear(p["mlp"]["lin2"], common.gelu(
                common.linear(p["mlp"]["lin1"], h)))

        run_case("fused_mlp_stream", f"{xf.shape[0]}x{C}",
                 lambda: flash.fused_mlp_stream(*mlp),
                 lambda: flash.fused_mlp_stream_plain(*mlp), None,
                 nbytes(xf, p["mlp"]["lin1"]["w"], p["mlp"]["lin2"]["w"])
                 + xf.numel() * 2,
                 gemm_ops(xf.shape[0], (C, 4 * C), (4 * C, C)),
                 H100_BF16_OPS_PER_S, plain_iters=3,
                 others={"unfused": unfused_mlp})
        blk = (xw, p["norm1"], p["attn"]["qkv"], tht, twt, p["attn"]["proj"],
               p["norm2"], p["mlp"]["lin1"], p["mlp"]["lin2"], (ws, ws), nh,
               (G, G), nwc, eps)

        def split_pair():
            x1 = flash.fused_window_attn(*args)
            return flash.fused_mlp_stream(x1.reshape(M, C), p["norm2"],
                                          p["mlp"]["lin1"], p["mlp"]["lin2"],
                                          eps)

        def unfused_block():
            x1 = unfused_attn()
            h = common.layer_norm(p["norm2"], x1, eps, fused=True)
            return x1 + common.linear(p["mlp"]["lin2"], common.gelu(
                common.linear(p["mlp"]["lin1"], h)))

        run_case("fused_window_block", f"{NW}x{L}x{C}",
                 lambda: flash.fused_window_block(*blk),
                 lambda: flash.fused_window_block_plain(*blk), None,
                 nbytes(xw, p["attn"]["qkv"]["w"], p["attn"]["proj"]["w"],
                        p["mlp"]["lin1"]["w"], p["mlp"]["lin2"]["w"], tht,
                        twt) + M * C * 2,
                 gemm_ops(M, (C, 3 * C), (C, C), (C, 4 * C), (4 * C, C))
                 + NW * nh * (4 * L * L * hd + 2 * L * 2 * ws * hd),
                 H100_BF16_OPS_PER_S, plain_iters=2,
                 others={"split_pair": split_pair, "unfused": unfused_block})
        del xw4, mask, xw, xf, mlp, args, blk, p

    # fused_global_tail: the 7B global layer, then a 16 x 64 grid of 2
    # heads of 32
    for B, H, W, C, nh in global_cases:
        hd, L = C // nh, H * W
        p = {"norm2": ln(C), "proj": lin(C, C), "lin1": lin(C, 4 * C),
             "lin2": lin(4 * C, C)}
        x, qkv = rnd(B, L, C), rnd(B, L, 3 * C)
        tht = enc._get_rel_pos_table(H, rnd(2 * H - 1, hd, scale=0.1))
        twt = enc._get_rel_pos_table(W, rnd(2 * W - 1, hd, scale=0.1))
        args = (x, qkv, tht, twt, p["proj"], p["norm2"], p["lin1"],
                p["lin2"], (H, W), nh, eps)

        def unfused_tail():
            q, k, v = qkv.reshape(B, L, 3, nh, hd).permute(2, 0, 3, 1, 4)
            o = flash.flash_relpos_attention(q, k, v, tht, twt, (H, W))
            x1 = x + common.linear(p["proj"], o.transpose(1, 2).reshape(
                B, L, C))
            h = common.layer_norm(p["norm2"], x1, eps, fused=True)
            return x1 + common.linear(p["lin2"], common.gelu(
                common.linear(p["lin1"], h)))

        run_case("fused_global_tail", f"{B}x{L}x{C}",
                 lambda: flash.fused_global_tail(*args),
                 lambda: flash.fused_global_tail_plain(*args), None,
                 nbytes(x, qkv, p["proj"]["w"], p["lin1"]["w"],
                        p["lin2"]["w"], tht, twt) + x.numel() * 2,
                 B * nh * (4 * L * L * hd + 2 * L * (H + W) * hd)
                 + gemm_ops(B * L, (C, C), (C, 4 * C), (4 * C, C)),
                 H100_BF16_OPS_PER_S, plain_iters=2,
                 others={"unfused": unfused_tail})
        del x, qkv, args, p

    # flash_attention_qkv: CLIP-L at batch 2, then L 77 with 4 heads of 36
    # (a head width the wrapper zero-pads to 40 for the kernel's TMA loads)
    for B, L, nh, hd in clip_cases:
        C = nh * hd
        qkv = rnd(B, L, 3 * C)
        q, k, v = (qkv[..., i * C:(i + 1) * C].view(B, L, nh, hd)
                   .transpose(1, 2) for i in range(3))
        run_case("flash_attention_qkv", f"{B}x{L}x{3 * C}",
                 lambda: flash.flash_attention_qkv(qkv, nh),
                 lambda: flash.attention_qkv_plain(qkv, nh),
                 lambda: F.scaled_dot_product_attention(q, k, v),
                 B * L * 4 * C * 2, 4 * B * nh * L * L * hd,
                 H100_BF16_OPS_PER_S)


def relpos_split_case(rnd, B, H, W, nh, hd):
    """(label, q, k, v, th, tw) of a split-head rel-pos case."""
    L = H * W
    if H != W:
        q, k, v = rnd(B, L, 3, nh, hd).permute(2, 0, 3, 1, 4)
    else:
        q, k, v = (rnd(B, nh, L, hd) for _ in range(3))
    th, tw = rnd(H, H, hd, scale=0.1), rnd(W, W, hd, scale=0.1)
    label = f"{B}x{nh}x{L}x{hd}" + (" permuted" if H != W else "")
    return label, q, k, v, th, tw


def relpos_qkv_case(rnd, B, H, W, nh, hd):
    """(label, qkv, th, tw) of a fused-QKV rel-pos case."""
    C, L = nh * hd, H * W
    qkv = rnd(B, L, 3 * C)
    th, tw = rnd(H, H, hd, scale=0.1), rnd(W, W, hd, scale=0.1)
    return (f"{B}x{L}x{3 * C}" + ("" if H == W else f" ({H}x{W})"), qkv, th,
            tw)


def kernels_per_call(torch, flash, rnd, calls: int = 3) -> dict:
    """{(wrapper, label): CUDA kernels one call runs} for every case of
    count_cases, counted in a torch.profiler session at the start of phase
    2 (profiled_counts). A session that lost device records (a case with
    none, or with a count that `calls` does not divide: every call runs
    the same work) is made again, at most COUNT_SESSIONS in all."""
    cases = count_cases(torch, flash, rnd)
    for fn in cases.values():
        fn()
    torch.cuda.synchronize()
    for session in range(1, COUNT_SESSIONS + 1):
        counts = profiled_counts(torch, cases, calls)
        if counts is None:
            what = "a marker"
        else:
            lost = {"/".join(key): n for key, n in counts.items()
                    if n == 0 or n % calls}
            if not lost:
                return {key: n / calls for key, n in counts.items()}
            what = (f"records of {len(lost)} of {len(cases)} cases (device "
                    f"records over {calls} calls: {lost})")
        log(f"[kernel] kernels_per_call: profiler session {session} of "
            f"{COUNT_SESSIONS} lost {what}")
    fail(f"kernels_per_call: {COUNT_SESSIONS} profiler sessions each lost "
         "device records")


def count_cases(torch, flash, rnd) -> dict:
    """{(wrapper, label): call} for every rel-pos case (inputs from rnd; on
    the global routes also ("factors", wrapper, label): relpos_factors
    alone on the same q view, made contiguous as the wrapper makes them),
    for rms_norm_fused at the 7B prefill's [1280, 4096] with a bf16 scale,
    for the causal kernels at the 7B shapes (inputs from a generator of
    their own): the training forward and the prefill, the training
    backward and, alone, its delta op, and (from the same generator) for
    layer_norm_fused at SAM-H's [9800, 1280] with bf16 scale and bias,
    flash_attention_qkv at CLIP-L's [2, 257, 3072] and the four fused SAM
    layers at SAM-H's shapes with bf16 weights, as anyref_7b's
    (fused_layer_cases)."""
    cases = {}
    for shape in RELPOS_SPLIT_CASES:
        label, q, k, v, th, tw = relpos_split_case(rnd, *shape)
        cases[("flash_relpos_attention", label)] = (
            lambda q=q, k=k, v=v, th=th, tw=tw, hw=shape[1:3]:
            flash.flash_relpos_attention(q, k, v, th, tw, hw))
        if shape[1] * shape[2] > flash.WINDOW_MAX_L:
            cases[("factors", "flash_relpos_attention", label)] = (
                lambda q=q, th=th, tw=tw, hw=shape[1:3]:
                [t.contiguous() for t in flash.relpos_factors(q, th, tw,
                                                              hw)])
    for shape in RELPOS_QKV_CASES:
        label, qkv, th, tw = relpos_qkv_case(rnd, *shape)
        cases[("flash_relpos_attention_qkv", label)] = (
            lambda qkv=qkv, th=th, tw=tw, hw=shape[1:3], nh=shape[3]:
            flash.flash_relpos_attention_qkv(qkv, th, tw, hw, nh))
        if shape[1] * shape[2] > flash.WINDOW_MAX_L:
            cases[("factors", "flash_relpos_attention_qkv", label)] = (
                lambda qkv=qkv, th=th, tw=tw, hw=shape[1:3], nh=shape[3]:
                [t.contiguous() for t in flash.relpos_factors(
                    flash._split_qkv(qkv, nh)[0], th, tw, hw)])
    x, s = rnd(1280, 4096), rnd(4096)
    cases[("rms_norm_fused", "1280x4096")] = (
        lambda: flash.rms_norm_fused(x, s, 1e-6))
    g = torch.Generator(device="cuda").manual_seed(2468)
    q, k, v, do = (torch.randn(2, 32, 768, 128, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = flash.causal_attention_diff_fwd(q, k, v)
    qp, kp, vp = (torch.randn(2, 32, 640, 128, generator=g, device="cuda")
                  .to(torch.bfloat16) for _ in range(3))
    ks = torch.tensor([0, 200], dtype=torch.int32, device="cuda")
    cases[("causal", "forward")] = lambda: flash.causal_attention_diff_fwd(
        q, k, v)
    cases[("causal", "prefill")] = lambda: flash.flash_causal_attention(
        qp, kp, vp, ks)
    cases[("causal", "backward")] = lambda: flash.causal_attention_diff_bwd(
        q, k, v, o, lse, do)
    cases[("causal", "delta")] = lambda: flash.causal_delta(do, o)
    xl, sl, bl = (torch.randn(shape, generator=g, device="cuda")
                  .to(torch.bfloat16) for shape in ((9800, 1280), (1280,),
                                                    (1280,)))
    cases[("layer_norm_fused", "9800x1280")] = (
        lambda: flash.layer_norm_fused(xl, sl, bl, 1e-6))
    qkv = torch.randn(2, 257, 3072, generator=g, device="cuda").to(
        torch.bfloat16)
    cases[("flash_attention_qkv", "2x257x3072")] = (
        lambda: flash.flash_attention_qkv(qkv, 16))
    cases.update(fused_layer_cases(torch, flash, g))
    cases.update(batch1_count_cases(torch, flash))
    return cases


def batch1_count_cases(torch, flash) -> dict:
    """count_cases' entries of the rel-pos wrappers at BATCH1_RELPOS_CASES
    (their factor einsums alone on the global route), inputs from
    batch1_rnd. A function of its own: count_cases' calls read its locals
    when they run."""
    cases = {}
    r1 = batch1_rnd(torch)
    for shape in BATCH1_RELPOS_CASES:
        glob = shape[1] * shape[2] > flash.WINDOW_MAX_L
        label, q, k, v, th, tw = relpos_split_case(r1, *shape)
        cases[("flash_relpos_attention", label)] = (
            lambda q=q, k=k, v=v, th=th, tw=tw, hw=shape[1:3]:
            flash.flash_relpos_attention(q, k, v, th, tw, hw))
        if glob:
            cases[("factors", "flash_relpos_attention", label)] = (
                lambda q=q, th=th, tw=tw, hw=shape[1:3]:
                [t.contiguous() for t in flash.relpos_factors(q, th, tw,
                                                              hw)])
        label, qkv, th, tw = relpos_qkv_case(r1, *shape)
        cases[("flash_relpos_attention_qkv", label)] = (
            lambda qkv=qkv, th=th, tw=tw, hw=shape[1:3], nh=shape[3]:
            flash.flash_relpos_attention_qkv(qkv, th, tw, hw, nh))
        if glob:
            cases[("factors", "flash_relpos_attention_qkv", label)] = (
                lambda qkv=qkv, th=th, tw=tw, hw=shape[1:3], nh=shape[3]:
                [t.contiguous() for t in flash.relpos_factors(
                    flash._split_qkv(qkv, nh)[0], th, tw, hw)])
    return cases


def batch1_rnd(torch):
    """rnd of the batch-1 cases: bf16 normals from a generator of their
    own."""
    g = torch.Generator(device="cuda").manual_seed(1357)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(
            torch.bfloat16)
    return rnd


def profiled_counts(torch, cases: dict, calls: int):
    """{case: device records over `calls` calls} from one torch.profiler
    session, or None where it lost a marker. Each case's calls follow a
    marker kernel (torch.cuda._sleep) on the one stream they all run on,
    and a last marker closes the session: a case's records (kernels,
    memsets, copies) are those between its marker and the next in the
    device's own order. No device timestamp is compared with a host one
    (matched to host ranges by time, one run counted no kernel for calls
    that each ran one) and no launch needs the profiler's link to a host
    op (the port's kernels, launched from its C library, have none). The
    launch counter's kernel (csrc/launch_count.cu, one after each
    wrapper's launch) is bookkeeping, not the call's work: not counted."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in cases.values():
            torch.cuda._sleep(MARKER_CYCLES)
            for _ in range(calls):
                fn()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    records = sorted((e for e in prof.events() if e.device_type == cuda
                      and COUNTER_KERNEL not in e.name),
                     key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(records) if MARKER in e.name]
    if len(marks) != len(cases) + 1:
        return None
    return {key: marks[n + 1] - marks[n] - 1
            for n, key in enumerate(cases)}


# The CUDA kernels one call of each fused SAM layer runs at SAM-H's shapes
# with bf16 weights: its own chain and nothing else (the LayerNorm row pass,
# the GEMMs, the attention; the global tail's attention also runs the
# factor einsums of its grid, counted apart).
FUSED_KERNELS_PER_CALL = {"fused_window_attn": 4, "fused_mlp_stream": 3,
                          "fused_window_block": 7, "fused_global_tail": 5}


def fused_layer_cases(torch, flash, g) -> dict:
    """{(wrapper, label): call} of the four fused SAM layers at SAM-H's
    batch-2 shapes (50 windows of 14 x 14 on the 64 x 64 grid, 16 heads of
    80, MLP 5120; the global layers' [2, 4096, 1280]), every weight bf16 as
    in anyref_7b, inputs from the generator g."""
    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(
            torch.bfloat16)

    C, nh, hd, ws = 1280, 16, 80, 14

    def lin(i, o):
        return {"w": r(i, o, scale=i ** -0.5), "b": r(o, scale=0.02)}

    def ln():
        return {"scale": 1 + r(C, scale=0.1), "bias": r(C, scale=0.05)}

    ln1, ln2, qkv_p, proj = ln(), ln(), lin(C, 3 * C), lin(C, C)
    fc1, fc2 = lin(C, 4 * C), lin(4 * C, C)
    xw = r(50, ws * ws, C)
    tht, twt = r(ws * ws, hd, scale=0.1), r(ws * ws, hd, scale=0.1)
    x, qkv = r(2, 4096, C), r(2, 4096, 3 * C)
    th, tw = r(64, 64, hd, scale=0.1), r(64, 64, hd, scale=0.1)
    win = ((ws, ws), nh, (64, 64), 5, 1e-6)
    return {
        ("fused_window_attn", "50x196x1280"): lambda: flash.fused_window_attn(
            xw, ln1, qkv_p, tht, twt, proj, *win),
        ("fused_mlp_stream", "9800x1280"): lambda: flash.fused_mlp_stream(
            xw.view(-1, C), ln2, fc1, fc2, 1e-6),
        ("fused_window_block", "50x196x1280"):
            lambda: flash.fused_window_block(xw, ln1, qkv_p, tht, twt, proj,
                                             ln2, fc1, fc2, *win),
        ("fused_global_tail", "2x4096x1280"): lambda: flash.fused_global_tail(
            x, qkv, th, tw, proj, ln2, fc1, fc2, (64, 64), nh, 1e-6),
    }


def check_fused_per_call(per_call) -> dict:
    """Fail unless each fused layer ran its own chain only (the global tail
    also the factor einsums counted for [2, 4096, 3840] off a fused QKV);
    -> {wrapper: CUDA kernels a call}."""
    factors = per_call[("factors", "flash_relpos_attention_qkv",
                        "2x4096x3840")]
    got = {}
    for key, n in per_call.items():
        name, label = key[0], key[-1]
        if len(key) == 2 and name in FUSED_KERNELS_PER_CALL:
            want = FUSED_KERNELS_PER_CALL[name] + (
                factors if name == "fused_global_tail" else 0)
            got[name] = n
            log(f"[kernel] {name} {label}, bf16 weights: {n:g} CUDA kernels "
                f"a call (torch.profiler), want {want:g}")
            if n != want:
                fail(f"{name} {label}: {n:g} CUDA kernels a call, want "
                     f"{want:g}")
    return got


def relpos_case(torch, F, flash, run_case, kname, shape_desc, kernel, plain,
                q, k, v, th, tw, size_hw, route, per_call, factors):
    """One rel-pos attention case: the kernel against its plain version,
    timed beside SDPA given the bias precomputed in bf16 (library) and SDPA
    with the bias built inside the timed call (relpos_factors, the
    expansion to [L, L], SDPA: library_with_factors). A call must run
    exactly one CUDA kernel on the window route, and the `factors` kernels
    of relpos_factors plus exactly one on the "global" route (per_call and
    factors, counted by kernels_per_call; "global_pad8" adds its copies)."""
    H, W = size_hw
    B, nh, L, hd = q.shape

    def bias_of(qq):
        rh, rw = flash.relpos_factors(qq, th, tw, size_hw)
        return (rh[..., :, None] + rw[..., None, :]).reshape(
            B, nh, L, L).to(torch.bfloat16)

    bias = bias_of(q)
    row = run_case(kname, shape_desc, kernel, plain,
             lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias),
             4 * B * nh * L * hd * 2 + (H * H + W * W) * hd * 2,
             B * nh * (4 * L * L * hd + 2 * L * (H + W) * hd),
             H100_BF16_OPS_PER_S, plain_iters=3,
             others={"library_with_factors": lambda:
                     F.scaled_dot_product_attention(q, k, v,
                                                    attn_mask=bias_of(q))},
             extra={"route": route})
    row["cuda_per_call"] = per_call
    row["factor_kernels_per_call"] = factors
    log(f"[kernel] {kname} {shape_desc}: route {route}, {per_call:g} CUDA "
        f"kernel(s) a call, of which the factor einsums' {factors or 0:g}")
    want = {"window": 1, "global": (factors or 0) + 1}.get(route)
    if want is not None and per_call != want:
        fail(f"{kname} {shape_desc}: {per_call:g} CUDA kernels a call on the "
             f"{route} route, want {want:g}")


def check_batch1(torch, F, flash, port, run_case, per_call):
    """The encoder kernels at SAM-H's batch-1 shapes, those of the SAM-alone
    path (SamPredictor.set_image, SamAutomaticMaskGenerator.generate), each
    against its plain version and timed: layer_norm_fused on 25 windows of
    196 rows and on the 64 x 64 global grid, both rel-pos wrappers at
    BATCH1_RELPOS_CASES (one CUDA kernel a call on the window route, the
    factor einsums' plus one on "global"), and the fused layers on one
    image (25 windows; one [1, 4096, 1280] global layer), inputs from
    batch1_rnd."""
    r1 = batch1_rnd(torch)
    for N in (4900, 4096):
        x, s, b = r1(N, 1280, scale=2.0), r1(1280), r1(1280)
        run_case("layer_norm_fused", f"{N}x1280",
                 lambda: flash.layer_norm_fused(x, s, b, 1e-6),
                 lambda: flash.layer_norm_plain(x, s, b, 1e-6),
                 lambda: F.layer_norm(x, (1280,), s, b, 1e-6),
                 2 * N * 1280 * 2 + 2 * 1280 * 2, 8 * N * 1280,
                 H100_FP32_OPS_PER_S)
    for B, H, W, nh, hd in BATCH1_RELPOS_CASES:
        label, q, k, v, th, tw = relpos_split_case(r1, B, H, W, nh, hd)
        relpos_case(torch, F, flash, run_case, "flash_relpos_attention",
                    label,
                    lambda: flash.flash_relpos_attention(q, k, v, th, tw,
                                                         (H, W)),
                    lambda: flash.relpos_attention_plain(q, k, v, th, tw,
                                                         (H, W)),
                    q, k, v, th, tw, (H, W), flash._relpos_route(H * W, hd),
                    per_call[("flash_relpos_attention", label)],
                    per_call.get(("factors", "flash_relpos_attention",
                                  label)))
        label, qkv, th, tw = relpos_qkv_case(r1, B, H, W, nh, hd)
        C = nh * hd
        q, k, v = (qkv[..., i * C:(i + 1) * C].view(B, H * W, nh, hd)
                   .transpose(1, 2) for i in range(3))
        relpos_case(torch, F, flash, run_case, "flash_relpos_attention_qkv",
                    label,
                    lambda: flash.flash_relpos_attention_qkv(qkv, th, tw,
                                                             (H, W), nh),
                    lambda: flash.relpos_attention_qkv_plain(qkv, th, tw,
                                                             (H, W), nh),
                    q, k, v, th, tw, (H, W), flash._relpos_route(H * W, hd),
                    per_call[("flash_relpos_attention_qkv", label)],
                    per_call.get(("factors", "flash_relpos_attention_qkv",
                                  label)))
        del q, k, v, qkv
    check_fused_kernels(torch, F, flash, port, r1, run_case,
                        window_cases=((1, 1280, 16, 14, 64),),
                        global_cases=((1, 64, 64, 1280, 16),), clip_cases=())


def check_relpos_qkv_and_int8(torch, F, flash, quant, rnd, rnd_extra,
                              run_case, per_call):
    """flash_relpos_attention_qkv at SAM-H's windows ([50, 196, 3840], 16
    heads of 80), then 3 grids of 9 x 9 with 2 heads of 36 (unvectorised
    loads), of 16 x 16 (the window kernel's upper edge), of 8 x 12 and of
    20 x 20 (the global kernel) with 2 heads of 32, SAM-H's global layers
    ([2, 4096, 3840]) and 2 grids of 17 x 19 with 2 heads of 36 (the global
    kernel on heads zero-padded to 40); int8_matmul at the 7B decoder's
    shapes (a decode step at batch 2, the lm_head, the three products of a
    prefill of 2 x 640 rows) and at
    two odd shapes, one per body: 3 rows (the decode body) and 77 rows
    (wgmma: M and K not multiples of 64, N % 16 != 0, so W goes by
    cp.async), then the decode body at 1 row (4096 x 4096), at 16 rows
    (4096 x 11008: two 8-row blocks of x) and at 16 rows of the odd shape
    (W by cp.async, a K tail of 8 rows), against torch.matmul by the bf16
    weight it was quantised from. Each decode-body case (M <= 16) runs
    twice and the two outputs must be equal bit for bit (the split sum's
    fixed order); its share of the bytes bound is printed."""
    for B, H, W, nh, hd in RELPOS_QKV_CASES:
        r = rnd if (B, H, W) in ((50, 14, 14), (3, 9, 9)) else rnd_extra
        label, qkv, th, tw = relpos_qkv_case(r, B, H, W, nh, hd)
        C = nh * hd
        q, k, v = (qkv[..., i * C:(i + 1) * C].view(B, H * W, nh, hd)
                   .transpose(1, 2) for i in range(3))
        relpos_case(torch, F, flash, run_case, "flash_relpos_attention_qkv",
                    label,
                    lambda: flash.flash_relpos_attention_qkv(qkv, th, tw,
                                                             (H, W), nh),
                    lambda: flash.relpos_attention_qkv_plain(qkv, th, tw,
                                                             (H, W), nh),
                    q, k, v, th, tw, (H, W), flash._relpos_route(H * W, hd),
                    per_call[("flash_relpos_attention_qkv", label)],
                    per_call.get(("factors", "flash_relpos_attention_qkv",
                                  label)))
        del qkv, q, k, v
    vocab = 32128   # anyref_7b's padded vocabulary
    for M, K, N in ((2, 4096, 4096), (2, 4096, 11008), (2, 11008, 4096),
                    (2, 4096, vocab), (1280, 4096, 4096),
                    (1280, 4096, 11008), (1280, 11008, 4096), (3, 264, 200),
                    (77, 264, 200), (1, 4096, 4096), (16, 4096, 11008),
                    (16, 264, 200)):
        x = rnd(M, K)
        w = rnd(K, N, scale=K ** -0.5)
        wq = quant.quantize_int8(w)
        extra = None
        if M <= 16:
            a = flash.int8_matmul(x, wq["w_q"], wq["scale"])
            b = flash.int8_matmul(x, wq["w_q"], wq["scale"])
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                fail(f"int8_matmul {M}x{K}x{N}: two calls on the same "
                     f"inputs differ (max {float((a - b).abs().max())})")
            plan = flash._int8_decode_plan(M, N, K, flash._num_sms(0))
            extra = {"repeat_bit_identical": True,
                     "plan": plan._asdict()}
            del a, b
        row = run_case(
            "int8_matmul", f"{M}x{K}x{N}",
            lambda: flash.int8_matmul(x, wq["w_q"], wq["scale"]),
            lambda: flash.int8_matmul_plain(x, wq["w_q"], wq["scale"]),
            lambda: torch.matmul(x, w),
            M * K * 2 + K * N + N * 4 + M * N * 2, 2 * M * N * K,
            H100_BF16_OPS_PER_S, iters=20, plain_iters=3, extra=extra)
        if M <= 16:
            row["bound_share"] = row["bound_ms"] / row["ms"]
            log(f"[kernel] int8_matmul {M}x{K}x{N}: decode body, "
                f"{row['bound_share']:.1%} of the bytes bound, repeat bit "
                f"for bit identical, plan {json.dumps(extra['plan'])}")
        del x, w, wq


# ---------------------------------------------------------------------------
# phase 3: the tiny slice on the card against the CPU
# ---------------------------------------------------------------------------
def check_tiny_slice(torch, cfg, encoder_path, tparams, anyref_mod,
                     quant=None, flash=None):
    """Greedy generate on the card and on the CPU from the same weights;
    with ``quant``, on the int8 decoder (quantize_llama on the CPU), which
    must have launched int8_matmul (prefill rows > 16, decode rows 2: both
    of its bodies)."""
    p_cpu = tparams.init(cfg, torch.Generator().manual_seed(0),
                         torch.bfloat16, device="cpu")
    if quant is not None:
        p_cpu["llama"] = quant.quantize_llama(p_cpu["llama"])
        n0 = read_launches(flash)["int8_matmul"]
    p_gpu = _to_device(p_cpu, "cuda")
    batch = tiny_batch(cfg)
    want = anyref_mod.generate(p_cpu, cfg, batch, max_new_tokens=4,
                               device="cpu", encoder_path=encoder_path)
    got = anyref_mod.generate(p_gpu, cfg, batch, max_new_tokens=4,
                              device="cuda", encoder_path=encoder_path)
    torch.cuda.synchronize()
    m_got = got.low_res_masks.float().cpu()
    m_want = want.low_res_masks.float()
    if m_got.shape != m_want.shape or not bool(torch.isfinite(m_got).all()):
        fail("tiny slice: masks of the wrong shape or not finite")
    rel = float((m_got - m_want).abs().max() / m_want.abs().max())
    same = int((got.output_ids.cpu() == want.output_ids).sum())
    decoder = "int8 decoder" if quant is not None else "bf16"
    log(f"[slice-tiny] {encoder_path} path, SAM {cfg.sam.image_size} px, "
        f"windows of {cfg.sam.window_size}, {decoder}, card vs CPU: mask max "
        f"rel err {rel:.4g} (limit {SLICE_REL_TOL}), ids equal {same}/"
        f"{want.output_ids.numel()}")
    if quant is not None and read_launches(flash)["int8_matmul"] == n0:
        fail("tiny slice, int8 decoder: int8_matmul was never launched")
    if rel > SLICE_REL_TOL:
        fail(f"tiny slice ({encoder_path}) on the card disagrees with the "
             f"CPU: {rel}")


def tiny_batch(cfg) -> dict:
    """Two left-padded prompts of random byte tokens (200 and 150 of a
    257-token bucket), one <image> each, and random normalised images."""
    rng = np.random.default_rng(0)
    ids = np.zeros((2, 257), np.int64)
    for b, n in enumerate((200, 150)):
        ids[b, 257 - n:] = rng.integers(3, 259, n)
        ids[b, 257 - n + 5] = cfg.tokens.image
    return {"input_ids": ids,
            "clip_images": rng.standard_normal(
                (2, 3, 224, 224)).astype(np.float32),
            "sam_images": rng.standard_normal(
                (2, 3, cfg.sam.image_size, cfg.sam.image_size)
            ).astype(np.float32)}


def first_seg(ids, seg: int) -> list:
    """Each row's output index of its first [SEG] (None where it has
    none)."""
    out = []
    for row in np.asarray(ids).tolist():
        out.append(row.index(seg) if seg in row else None)
    return out


def check_tiny_rephrase(torch, cfg, tparams, anyref_mod):
    """generate at rephrase_weight=0.1 on the "fused" path, greedy and
    speculative, on the card and on the CPU from the same weights, with
    lm_head's [SEG] column scaled by TINY_SEG_SCALE: ids equal, masks and
    seg_embeddings within SLICE_REL_TOL of the CPU's largest magnitude, and
    a row whose first [SEG] comes at output index k >= 1 (a pooled span)."""
    cfg = cfg.scaled(rephrase_weight=0.1)
    p_cpu = tparams.init(cfg, torch.Generator().manual_seed(0),
                         torch.bfloat16, device="cpu")
    p_cpu["llama"]["lm_head"][:, cfg.tokens.seg] *= TINY_SEG_SCALE
    p_gpu = _to_device(p_cpu, "cuda")
    batch = tiny_batch(cfg)
    for spec in (False, True):
        kw = dict(max_new_tokens=4, encoder_path="fused", speculative=spec)
        want = anyref_mod.generate(p_cpu, cfg, batch, device="cpu", **kw)
        got = anyref_mod.generate(p_gpu, cfg, batch, device="cuda", **kw)
        torch.cuda.synchronize()
        name = "speculative" if spec else "greedy"
        ids = got.output_ids.cpu()
        ks = first_seg(ids, cfg.tokens.seg)
        rels = {}
        for field in ("low_res_masks", "seg_embeddings"):
            a = getattr(got, field).float().cpu()
            b = getattr(want, field).float()
            if a.shape != b.shape or not bool(torch.isfinite(a).all()):
                fail(f"tiny rephrase ({name}): {field} of the wrong shape "
                     "or not finite")
            rels[field] = float((a - b).abs().max() / b.abs().max())
        log(f"[slice-tiny] fused path, SAM {cfg.sam.image_size} px, "
            f"rephrase 0.1, {name}, lm_head[:, tokens.seg] x "
            f"{TINY_SEG_SCALE}, card vs CPU: ids {ids.tolist()} (first [SEG]"
            f" at {ks}), mask max rel err {rels['low_res_masks']:.4g}, "
            f"seg_embeddings max rel err {rels['seg_embeddings']:.4g} "
            f"(limit {SLICE_REL_TOL})")
        if not torch.equal(ids, want.output_ids):
            fail(f"tiny rephrase ({name}): ids {ids.tolist()} on the card, "
                 f"{want.output_ids.tolist()} on the CPU")
        if max(rels.values()) > SLICE_REL_TOL:
            fail(f"tiny rephrase ({name}) on the card disagrees with the "
                 f"CPU: {rels}")
        if not any(k is not None and k >= 1 for k in ks):
            fail(f"tiny rephrase ({name}): no row's first [SEG] at k >= 1, "
                 f"so no span was pooled: {ids.tolist()}")


def reference_waveform():
    """AUDIO_SECONDS of a 440 Hz tone and noise at 16 kHz, from seed 0."""
    rng = np.random.default_rng(0)
    t = np.arange(int(AUDIO_SECONDS * 16000)) / 16000
    return (0.1 * rng.standard_normal(t.shape)
            + 0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)


def reference_batches(cfg, mods, bucket: int = 257) -> dict:
    """{kind: a left-padded generate batch of two rows} for "crop" (a crop
    and a text row), "box" (a box and a text row, RoI mode) and
    "text_audio" (a text and an audio row), all on request_images()[3],
    made by the port's make_sample and Collator."""
    image = request_images()[3]
    h, w = image.shape[:2]
    ds, tok = mods["SegDataset"](cfg), mods["AnyRefTokenizer"]()
    q_img, q_txt = mods["img_ref_question"](), mods["seg_question"]("the dog")
    crop = mods["crop_box_np"](image, np.asarray(REF_CROP_XYXY))
    box = (np.asarray(REF_ROI_XYXY, np.float32)
           / np.asarray([w, h, w, h], np.float32))
    mels = mods["mel"].audio_to_mel_clips(reference_waveform(),
                                          device="cpu").numpy()
    samples = {
        "crop": [ds.make_sample(image, q_img, None, None, ref_image=crop),
                 ds.make_sample(image, q_txt, None, None)],
        "box": [ds.make_sample(image, q_img, None, None, ref_bbox=box),
                ds.make_sample(image, q_txt, None, None)],
        "text_audio": [ds.make_sample(image, q_txt, None, None),
                       ds.make_sample(image, mods["audio_ref_question"](),
                                      None, None, audio_mels=mels)]}
    out = {}
    for kind, rows in samples.items():
        b = mods["Collator"](tok, cfg, roi=kind == "box")(rows)
        ids = np.zeros((2, bucket), np.int64)
        for r in range(2):
            n = int(b["prompt_lens"][r])
            ids[r, bucket - n:] = b["input_ids"][r, :n]
        out[kind] = {"input_ids": ids, **{
            k: b[k] for k in ("clip_images", "sam_images", "ref_images",
                              "ref_valid", "roi_boxes", "audio_mels",
                              "audio_valid") if k in b}}
    return out


def check_tiny_references(torch, cfg, encoder_path, mods):
    """generate on a crop, a box and a text + audio batch (reference_batches),
    greedy and speculative, on the card and on the CPU from the same bf16
    weights: ids equal to the CPU plain path's, masks within SLICE_REL_TOL
    of its largest magnitude. Every disagreement is listed before the
    phase fails."""
    anyref = mods["anyref"]
    p_cpu = mods["tparams"].init(cfg, torch.Generator().manual_seed(0),
                                 torch.bfloat16, device="cpu")
    p_gpu = _to_device(p_cpu, "cuda")
    bad = []
    for kind, batch in reference_batches(cfg, mods).items():
        for spec in (False, True):
            kw = dict(max_new_tokens=4, encoder_path=encoder_path,
                      speculative=spec)
            want = anyref.generate(p_cpu, cfg, batch, device="cpu", **kw)
            got = anyref.generate(p_gpu, cfg, batch, device="cuda", **kw)
            torch.cuda.synchronize()
            ids = got.output_ids.cpu()
            m_got = got.low_res_masks.float().cpu()
            m_want = want.low_res_masks.float()
            name = f"{kind}, {'speculative' if spec else 'greedy'}"
            if m_got.shape != m_want.shape or \
                    not bool(torch.isfinite(m_got).all()):
                fail(f"tiny references ({encoder_path}, {name}): masks of "
                     "the wrong shape or not finite")
            rel = float((m_got - m_want).abs().max() / m_want.abs().max())
            log(f"[slice-tiny refs] {encoder_path} path, SAM "
                f"{cfg.sam.image_size} px, {name}, card vs CPU: ids "
                f"{ids.tolist()} (CPU {want.output_ids.tolist()}), mask max "
                f"rel err {rel:.4g} (limit {SLICE_REL_TOL})")
            if not torch.equal(ids, want.output_ids):
                bad.append(f"{name}: ids {ids.tolist()} on the card, "
                           f"{want.output_ids.tolist()} on the CPU")
            if rel > SLICE_REL_TOL:
                bad.append(f"{name}: mask max rel err {rel}")
    if bad:
        fail(f"tiny references ({encoder_path}) on the card disagree with "
             f"the CPU: {bad}")


def train_samples(cfg, mods, texts, images, seed: int):
    """Collator-ready training samples: the given images (shortest edge 224,
    so CLIP needs no resize), the answer seg_answer(text), one rectangle
    mask each."""
    ds = mods["SegDataset"](cfg)
    out = []
    for i, (text, (h, w)) in enumerate(zip(texts, images)):
        rng = np.random.default_rng(seed + i)
        mask = np.zeros((h, w), np.uint8)
        y0, x0 = int(rng.integers(0, h // 2)), int(rng.integers(0, w // 2))
        mask[y0:y0 + h // 3, x0:x0 + w // 3] = 1
        out.append(ds.make_sample(
            rng.integers(0, 256, (h, w, 3), np.uint8),
            mods["seg_question"](text), mods["seg_answer"](text), mask[None],
            file_name=f"{i}.jpg"))
    return out


def check_tiny_train(torch, cfg, mods):
    """One train step's losses and gradients at anyref_tiny() (bf16
    weights, per-layer checkpointing, the fused encoder path), on the card
    and on the CPU from the same weights, LoRA draw and batch: every loss
    term and every trainable leaf's gradient within SLICE_REL_TOL of the
    CPU's largest magnitude."""
    step, lora = mods["step"], mods["lora"]
    p_cpu = mods["tparams"].init(cfg, torch.Generator().manual_seed(0),
                                 torch.bfloat16, device="cpu")
    batch = step.device_batch(mods["Collator"](
        mods["AnyRefTokenizer"](), cfg, train=True)(train_samples(
            cfg, mods, ("the cat", "the red mug"), ((224, 300), (280, 224)),
            seed=5)))
    lcfg = lora.LoraConfig()
    out = {}
    for dev in ("cpu", "cuda"):
        params = p_cpu if dev == "cpu" else _to_device(p_cpu, dev)
        state, frozen = step.init_state(torch.Generator().manual_seed(1),
                                        params, lcfg, step.make_optimizer())
        g = torch.Generator().manual_seed(2)
        with torch.no_grad():   # B != 0, so A gets a gradient too
            for layer in state.lora["layers"]:
                for t in layer.values():
                    t["b"].copy_(0.02 * torch.randn(t["b"].shape,
                                                    generator=g))
        out[dev] = step.value_and_grad(state.lora, state.dense, frozen, cfg,
                                       lcfg, batch, encoder_path="fused",
                                       remat=True)
    torch.cuda.synchronize()
    (_, m_cpu, g_cpu), (_, m_gpu, g_gpu) = out["cpu"], out["cuda"]
    worst = 0.0
    for k in m_cpu:
        rel = abs(m_gpu[k].item() - m_cpu[k].item()) / abs(m_cpu[k].item())
        worst = max(worst, rel)
    leaves = list(zip(step.tree_leaves(g_gpu), step.tree_leaves(g_cpu)))
    worst_grad = 0.0
    for a, b in leaves:
        a, b = a.float().cpu(), b.float()
        if not bool(torch.isfinite(a).all()):
            fail("tiny train step: non-finite gradient on the card")
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        worst_grad = max(worst_grad, err / scale if scale else err)
    log(f"[train-tiny] anyref_tiny, bf16, remat, fused path, card vs CPU: "
        f"loss {m_gpu['loss'].item():.5f} vs {m_cpu['loss'].item():.5f}, "
        f"worst loss-term rel err {worst:.4g}, worst gradient err "
        f"{worst_grad:.4g} of its leaf's largest magnitude over "
        f"{len(leaves)} leaves (limit {SLICE_REL_TOL})")
    if worst > SLICE_REL_TOL or worst_grad > SLICE_REL_TOL:
        fail("tiny train step on the card disagrees with the CPU")


def _to_device(tree, *to):
    """Every tensor of ``tree`` through .to(*to): a device, a dtype or
    both."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_device(v, *to) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, *to) for v in tree]
    return tree.to(*to)


# ---------------------------------------------------------------------------
# phase 5: LoRA training at anyref_7b
# ---------------------------------------------------------------------------
TRAIN_DIR = os.path.join(ROOT, "anyref_tpu_torch", "build", "train_smoke")


# phase 5: replays of the compiled step after the key's first step (eager,
# then its capture), before one more under the profiler
TRAIN_REPLAYS_7B = 3


class MelThread:
    """While open, and until ``done()``, another thread runs the mel front
    end on the card (ops/mel.py, as the AVS readers do in the Trainer's
    loader threads) on its own stream, and counts its calls: a capture on
    the Trainer's side stream, in thread_local mode, must hold."""

    def __init__(self, torch, mods, done):
        import threading
        self.calls, self.error = 0, None
        wav = reference_waveform()

        def run():
            try:
                while not done() and not self.stop.is_set():
                    mods["mel"].audio_to_mel_clips(
                        wav, device="cuda").cpu().numpy()
                    self.calls += 1
            except Exception as e:   # reported by __exit__
                self.error = e
        self.stop = threading.Event()
        self.thread = threading.Thread(target=run, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=60)
        if self.thread.is_alive() or self.error is not None:
            fail(f"the mel thread: {self.error or 'did not stop'}")


class StepRecorder:
    """Wraps ``trainer.step_fn``; for each step, in ``steps``: a host copy
    of its batch, the seconds step_fn took to return, the device span from
    just before the call to just after it on the Trainer's stream (CUDA
    events), the wall from the call to the card's synchronize, its metrics,
    the launches the card counted in it (every counter of flash.COUNTED)
    and a host copy of every trainable leaf and Adam moment after it (the
    count included), taken after the wall was read. The card is
    synchronised before each step, so each is timed alone."""

    def __init__(self, torch, flash, step, trainer):
        self.steps = []
        inner = trainer.step_fn

        def step_fn(state, frozen, batch):
            kept = {k: np.array(v, copy=True) for k, v in batch.items()}
            before = flash.launch_counts()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            t0 = time.perf_counter()
            state, metrics = inner(state, frozen, batch)
            ret = time.perf_counter() - t0
            e1.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = flash.launch_counts()
            self.steps.append({
                "batch": kept, "return_s": ret, "wall_s": wall,
                "device_ms": e0.elapsed_time(e1),
                "launches": {k: after[k] - before[k] for k in after},
                "metrics": {k: float(v) for k, v in metrics.items()},
                "state": [t.detach().cpu() for t in step.tree_leaves(
                    (state.lora, state.dense, state.opt_state))]})
            return state, metrics
        trainer.step_fn = step_fn


def train_7b(torch, flash, mods):
    """The Trainer at anyref_7b on random bf16 weights, its step compiled:
    1 + TRAIN_REPLAYS_7B optimizer steps of 2 micro-steps of batch 2
    (warmup 1, so steps 2 on move the weights), the first run from the
    host and captured, the rest replays; one more replay under the
    profiler; then train_eager_reference on the recorded batches. Returns
    the training attention's launch counts over the counted steps and the
    compiled step's figures."""
    t_phase = time.time()
    cfg = mods["anyref_7b"]()
    step = mods["step"]
    params = mods["tparams"].init(
        cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16)
    samples = train_samples(cfg, mods, TEXTS * 2, IMAGE_SIZES * 2, seed=0)
    tok = mods["AnyRefTokenizer"]()
    lens = [len(mods["tokenize_conversation"](tok, s["question"],
                                              s["answer"]).input_ids)
            for s in samples]
    if max(lens) > cfg.max_text_len:
        fail(f"conversations of {lens} tokens > max_text_len")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    n_steps = 1 + TRAIN_REPLAYS_7B
    tc = mods["TrainConfig"](
        output_dir=TRAIN_DIR, per_device_batch_size=2, grad_accum_steps=2,
        max_steps=n_steps, warmup_steps=1, save_steps=10 ** 9, log_steps=1,
        resume=False, remat=True, encoder_path="fused",
        profile_dir=os.path.join(TRAIN_DIR, "profile"))
    trainer = mods["Trainer"](cfg, tc, params, dataset=samples)
    if trainer.step_fn != trainer._compiled_step:
        fail("the Trainer on the card does not compile its step")
    frozen = [t.cpu() for t in step.tree_leaves(trainer.frozen)]
    lora0 = [t.detach().clone() for t in step.tree_leaves(trainer.state.lora)]
    rec = StepRecorder(torch, flash, step, trainer)
    zero_launches(flash)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with MelThread(torch, mods, lambda: len(rec.steps) > 0) as mel:
        state = trainer.train()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = flash.launch_counts()
    launches = read_launches(flash)
    backward = counts["flash_causal_attention_diff_backward"]
    peak = torch.cuda.max_memory_allocated()

    with open(os.path.join(TRAIN_DIR, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if state.step != n_steps or [r["step"] for r in recs] != list(
            range(1, n_steps + 1)):
        fail(f"trainer ended at step {state.step}, logged "
             f"{[r['step'] for r in recs]}")
    if not all(np.isfinite(r[k]) for r in recs for k in step.METRICS):
        fail(f"non-finite losses {recs}")
    bs = [layer[t]["b"] for layer in state.lora["layers"] for t in layer]
    if not all(bool(b.detach().abs().max() > 0) for b in bs):
        fail(f"a LoRA B is still zero after {n_steps} steps")
    if all(torch.equal(a.detach(), b) for a, b in
           zip(step.tree_leaves(state.lora), lora0)):
        fail("the LoRA weights did not move")
    if not all(torch.equal(a.cpu(), b) for a, b in
               zip(step.tree_leaves(trainer.frozen), frozen)):
        fail("a frozen weight changed")
    del frozen, lora0
    if len(trainer.programs) != 1:
        fail(f"{len(trainer.programs)} compiled programs for one batch key")
    program = next(iter(trainer.programs.values()))

    micro = tc.max_steps * tc.grad_accum_steps
    per_micro = train_launches_per_micro(cfg)
    check_train_launches(launches, backward, cfg, micro, "training")
    conditions = counts["loop_condition"]
    if conditions != TRAIN_REPLAYS_7B * (tc.grad_accum_steps + 1):
        fail(f"the loop's condition kernel ran {conditions} times over "
             f"{TRAIN_REPLAYS_7B} replays of {tc.grad_accum_steps} "
             f"micro-steps, want {tc.grad_accum_steps + 1} a replay")

    # every sequence is padded to max_seq_len; the real (non-pad) positions
    # of a sample are its text tokens plus the image's expansion
    per_step = tc.per_device_batch_size * tc.grad_accum_steps
    padded = per_step * cfg.max_seq_len
    real = per_step * float(np.mean(lens)) + per_step * (
        cfg.max_seq_len - cfg.max_text_len)
    replays = rec.steps[1:]
    med = float(np.median([r["wall_s"] for r in replays]))
    log(f"[train] anyref_7b LoRA, compiled step, batch "
        f"{tc.per_device_batch_size} x {tc.grad_accum_steps} micro-steps, L "
        f"{cfg.max_seq_len}, remat, fused encoder path: {n_steps} steps in "
        f"{wall:.2f} s (the first from the host, then its capture in "
        f"{program.capture_s:.3f} s); losses "
        + "; ".join(f"step {r['step']}: loss {r['loss']:.4f} lm "
                    f"{r['lm_loss']:.4f} bce {r['bce_loss']:.4f} dice "
                    f"{r['dice_loss']:.4f}" for r in recs))
    log(f"[train] step walls {[round(r['wall_s'], 4) for r in rec.steps]} "
        f"s (first: host run and capture); median of the {len(replays)} "
        f"replays {med:.4f} s -> {padded / med:.1f} padded positions/s "
        f"({padded} per step), {real / med:.1f} real tokens/s ({real:.1f} "
        f"real positions per step on average: text tokens {lens} per sample "
        f"plus {cfg.max_seq_len - cfg.max_text_len} image positions); peak "
        f"memory allocated {peak / 2**30:.2f} GiB (the first step and the "
        f"capture included)")
    log(f"[train] kernel launches over {micro} micro-steps "
        f"{json.dumps(launches)}, flash_causal_attention_diff backward "
        f"{backward}, the loop's condition kernel {conditions} (card counts; "
        f"per micro-step {json.dumps(per_micro)})")

    # one more replay under the profiler (after the counts were read)
    tc.max_steps, tc.profile_steps = n_steps + 1, (n_steps, n_steps)
    mark = launch_mark(flash, "loop_condition")
    t0 = time.time()
    trainer.train()
    torch.cuda.synchronize()
    pwall = time.time() - t0
    lost = loop_records_lost(torch, flash, trainer.profiler, mark)
    by_name = {}
    for e in trainer.profiler.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    busy_ms = sum(by_name.values()) / 1e3
    busy = (lost if lost else
            f"kernels busy {busy_ms:.1f} ms -> device idle "
            f"{100 * (1 - busy_ms / 1e3 / pwall):.1f}% of the wall; the "
            f"profiler's host cost stretches the wall")
    log(f"[train-profile] step {n_steps + 1}, a replay, under "
        f"torch.profiler: {pwall:.3f} s wall, {busy} (the trace is kept "
        f"in {tc.profile_dir})")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"[train-profile]   {us / 1e3:9.3f} ms  {name[:90]}")
    # each replay's card counts: the first (eager) step's, and the loop's
    # condition kernel once before the loop and once after each micro-step
    first = rec.steps[0]["launches"]
    if first["loop_condition"] != 0:
        fail(f"the first (eager) step ran the loop's condition kernel "
             f"{first['loop_condition']} times")
    want = {**first, "loop_condition": tc.grad_accum_steps + 1}
    for i, r in enumerate(rec.steps[1:], 2):
        if r["launches"] != want:
            fail(f"step {i}, a replay, launched {r['launches']} on the card, "
                 f"want the eager step's {want}")
    # the program alone: CUDA events just around the launch of a replay,
    # its batch staged before (more optimizer steps, after every check of
    # the Trainer's state)
    from anyref_tpu_torch.utils.graphs import stage
    spans = []
    for _ in range(3):
        stage(program.inputs, rec.steps[-1]["batch"])
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        trainer.graphs.launch(program.exec)
        e1.record()
        torch.cuda.synchronize()
        spans.append(e0.elapsed_time(e1))
    program_s = float(np.median(spans)) / 1e3
    compiled = {
        "program_ms": spans, "mel_calls_during_first_step": mel.calls,
        "capture_s": program.capture_s,
        "pool_bytes": trainer.graph_pool_bytes(),
        "return_s": [r["return_s"] for r in replays],
        "device_ms": [r["device_ms"] for r in replays],
        "wall_s": [r["wall_s"] for r in replays],
        "idle_min": [1 - program_s / r["wall_s"] for r in replays],
        "peak_gib": peak / 2**30, "profile_lost": lost,
        "profiled_busy_ms": None if lost else busy_ms}
    eager = train_eager_reference(torch, mods, cfg, tc, params, rec, n_steps)
    # the eager step runs the program's kernels (the card counts of each
    # replay are the eager step's), so the program's span bounds their
    # busy time from above, and an eager step's idle share from below
    eager["idle_min"] = [1 - program_s / w for w in eager["wall_s"]]
    log(f"[train-graph] step_fn returns in "
        f"{[round(1e3 * t, 2) for t in compiled['return_s']]} ms against "
        f"{[round(t, 1) for t in compiled['device_ms']]} ms of device work "
        f"a replay (the CUDA-event span of the call, the batch's staging "
        f"included; eager step_fn returns after "
        f"{[round(1e3 * t, 1) for t in eager['return_s']]} ms); the program "
        f"alone spans {[round(t, 1) for t in spans]} ms on the card; step "
        f"wall, median: compiled {med:.4f} s, eager "
        f"{float(np.median(eager['wall_s'])):.4f} s (walls "
        f"{[round(t, 4) for t in compiled['wall_s']]} against "
        f"{[round(t, 4) for t in eager['wall_s']]}); device idle at least "
        f"{[round(100 * x, 1) for x in compiled['idle_min']]}% of a replay's "
        f"wall, at least {[round(100 * x, 1) for x in eager['idle_min']]}% "
        f"of an eager step's (the program's span over the wall: CUDA "
        f"events); capture {program.capture_s:.3f} s, the mel front end "
        f"run {mel.calls} times on the card by another thread meanwhile; "
        f"graph pool {compiled['pool_bytes'] / 2**30:.3f} GiB against an "
        f"eager step's working memory (its peak over what was allocated "
        f"before it) {eager['work_gib']:.3f} GiB; peak allocated over the "
        f"compiled run {peak / 2**30:.2f} GiB; {mods['card']}")
    if mel.calls < 1:
        fail("the mel thread ran no call during the first step and its "
             "capture")
    # the wrappers of step_fn hold the Trainer, and its pool, in a cycle
    del trainer, state, params, rec
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[phase 5] in {time.time() - t_phase:.1f} s")
    return {"launches": launches["flash_causal_attention_diff"],
            "backward_launches": backward, "steps": n_steps,
            "compiled": compiled, "eager": eager}


def _state_diff(torch, a: list, b: list) -> list:
    """For each pair of tensors (a's on b's device), None where bit-equal,
    else the largest absolute difference over b's largest magnitude."""
    out = []
    for x, y in zip(a, b):
        x = x.to(y.device)
        if torch.equal(x, y):
            out.append(None)
            continue
        d = (x.float() - y.float()).abs().max().item()
        scale = y.float().abs().max().item()
        out.append(d / scale if scale else d)
    return out


class GradHook:
    """Wraps step.AdamW.update: for each call made outside a capture (a
    step run from the host), ``calls`` counts it and ``last`` holds a copy
    of its gradient leaves on their device (the gradients the update
    reads, before the clip; a copy on the card keeps the step's wall)."""

    def __init__(self, torch, step):
        self.calls, self.last = 0, None
        inner = step.AdamW.update

        def update(opt, grads, *a, **kw):
            if not torch.cuda.is_current_stream_capturing():
                self.calls += 1
                self.last = [g.detach().clone()
                             for g in step.tree_leaves(grads)]
            return inner(opt, grads, *a, **kw)
        step.AdamW.update = update


def train_eager_reference(torch, mods, cfg, tc, params, rec,
                          total_steps: int, mesh=None, grads=None) -> dict:
    """make_train_step's step run from the host, twice from the state the
    Trainer started from (the same seed; the LoRA draw is made on the CPU),
    in lockstep on the first ``total_steps`` batches the compiled Trainer
    recorded (its optimizer's length, the Trainer's max_steps when it was
    built): after each
    step, each loss term and every trainable leaf and Adam moment (the
    count included) of the compiled run against the first eager run's, and
    the first eager run's against the second's (the spread of two eager
    steps in this call); with ``grads`` (the compiled run's gradient leaves
    of each step, as the update read them) the eager runs' too (GradHook).
    ``mesh``: the step on this rank's rows of a mesh (every rank runs this
    in lockstep). Fails unless each is bit-equal where the two eager
    runs are, and otherwise within twice their spread (the compiled run and
    the second eager run are two draws about the first). Returns the first
    eager run's step walls, return times, idle bounds (CUDA events) and
    the working memory of its second step."""
    step, lora = mods["step"], mods["lora"]
    lcfg = lora.LoraConfig()
    hook = GradHook(torch, step) if grads is not None else None
    runs = []
    for _ in range(2):
        opt = step.make_optimizer(lr=tc.learning_rate, warmup=tc.warmup_steps,
                                  total_steps=total_steps)
        state, frozen = step.init_state(torch.Generator().manual_seed(tc.seed),
                                        params, lcfg, opt)
        fn = step.make_train_step(cfg, lcfg, opt, remat=tc.remat,
                                  grad_accum=tc.grad_accum_steps,
                                  encoder_path=tc.encoder_path, mesh=mesh)
        runs.append([state, frozen, fn])
    out = {"wall_s": [], "return_s": [], "idle_min": [], "work_gib": None}
    worst = {"compiled": 0.0, "spread": 0.0}
    bits = {"compiled": 0, "spread": 0, "items": 0}
    bad = []
    for k, recorded in enumerate(rec.steps[:total_steps]):
        got = []
        for j, run in enumerate(runs):
            state, frozen, fn = run
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            t0 = time.perf_counter()
            state, metrics = fn(state, frozen, recorded["batch"])
            ret = time.perf_counter() - t0
            e1.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run[0] = state
            if j == 0:
                out["wall_s"].append(wall)
                out["return_s"].append(ret)
                out["idle_min"].append(1 - e0.elapsed_time(e1) / 1e3 / wall)
                if k == 1:
                    out["work_gib"] = (torch.cuda.max_memory_allocated()
                                       - before) / 2**30
            loss = torch.stack([metrics[m].float() for m in step.METRICS])
            got.append([loss, *[t.detach() for t in step.tree_leaves(
                (state.lora, state.dense, state.opt_state))],
                *([] if hook is None else hook.last)])
        want = torch.tensor([recorded["metrics"][m] for m in step.METRICS],
                            dtype=torch.float32, device="cuda")
        # the compiled run's losses came back as floats: compare them as
        # the fp32 values they were
        compiled = [want, *recorded["state"],
                    *([] if grads is None else grads[k])]
        spread = _state_diff(torch, got[1], got[0])
        diff = _state_diff(torch, compiled, got[0])
        for i, (sp, d) in enumerate(zip(spread, diff)):
            bits["items"] += 1
            bits["spread"] += sp is None
            bits["compiled"] += d is None
            worst["spread"] = max(worst["spread"], sp or 0.0)
            worst["compiled"] = max(worst["compiled"], d or 0.0)
            if d is not None and (sp is None or d > 2 * sp):
                what = "losses" if i == 0 else f"state item {i - 1}"
                bad.append(f"step {k + 1} {what}: compiled {d:.4g} from the "
                           f"first eager run, the eager runs "
                           f"{'bit-equal' if sp is None else f'{sp:.4g}'}")
    log(f"[train-graph] the compiled Trainer's first {total_steps} steps "
        f"against make_train_step's step from the host (twice, from the "
        f"same seed, on the recorded batches"
        f"{'' if mesh is None else f', on the {mesh.shape} mesh, rank {mesh.rank}'}"
        f"): of {bits['items']} items (each step's loss terms, each "
        f"trainable leaf, Adam moment and the count"
        f"{'' if grads is None else ', each gradient leaf'}), bit-equal "
        f"compiled vs eager {bits['compiled']}, eager vs "
        f"eager {bits['spread']}; largest difference (over the item's "
        f"largest magnitude) compiled {worst['compiled']:.4g}, eager spread "
        f"{worst['spread']:.4g}")
    if bad:
        fail(f"the compiled step disagrees with the eager step: {bad[:8]}")
    del runs
    torch.cuda.empty_cache()
    return {**out, "bit_equal": bits, "worst": worst}


def train_launches_per_micro(cfg) -> dict:
    """Each kernel's launches a training micro-step on "fused" with
    per-layer checkpointing: the training attention's forward twice a
    layer (the pass and the recompute), the towers' kernels once."""
    s, l, c = cfg.sam, cfg.llama, cfg.clip
    n_global = len(s.encoder_global_attn_indexes)
    return {"flash_causal_attention_diff": 2 * l.num_layers,
            "fused_window_attn": s.encoder_depth - n_global,
            "fused_mlp_stream": s.encoder_depth - n_global,
            "fused_global_tail": n_global,
            "layer_norm_fused": n_global,
            "flash_attention_qkv": c.num_layers + c.select_layer + 1,
            "flash_relpos_attention": 0, "rms_norm_fused": 0,
            "flash_causal_attention": 0,
            "flash_relpos_attention_qkv": 0, "fused_window_block": 0,
            "int8_matmul": 0}


def check_train_launches(launches: dict, backward: int, cfg, micro: int,
                         what: str) -> None:
    """Fail unless ``micro`` training micro-steps launched each kernel
    train_launches_per_micro times, and the training attention's backward
    once a layer."""
    for name, n in train_launches_per_micro(cfg).items():
        if launches[name] != n * micro:
            fail(f"{what}: {name} {launches[name]} launches, want {n} per "
                 f"micro-step x {micro}")
    if backward != cfg.llama.num_layers * micro:
        fail(f"{what}: flash_causal_attention_diff {backward} backward "
             f"launches, want {cfg.llama.num_layers} x {micro}")


# ---------------------------------------------------------------------------
# phase 4: the main path at anyref_7b
# ---------------------------------------------------------------------------
PATHS = ("fused", "fused_block", "unfused_qkv", "unfused")


def serve_7b(torch, flash, mods):
    """The four encoder paths at anyref_7b on one set of weights, then the
    int8 decoder quantised from the same weights; returns the launch counts
    of each counted run ("int8" for the last), serve_int8's step numbers
    phase 10(b)'s and phase 13(b)'s. The decoder is quantised, and phase
    10(b) compares
    the two layouts, before the first Server: its speculative Predictor
    converts the tree to the serving layout in place, so every run after
    it (the Servers, eval, the inverse eval, serve_int8's bf16 step) is on
    the fused layout, and quantize_llama refuses that layout."""
    cfg = mods["anyref_7b"]()
    t0 = time.time()
    params = mods["tparams"].init(
        cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16)
    torch.cuda.synchronize()
    log(f"[slice] params.init(anyref_7b) on the card: "
        f"{time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    # Random weights almost never emit [SEG]; scale the [SEG] column of the
    # fp32 lm_head by 1000 so [SEG] wins wherever its logit is positive and
    # the mask path runs.
    seg_col = params["llama"]["lm_head"][:, cfg.tokens.seg].clone()
    params["llama"]["lm_head"][:, cfg.tokens.seg] *= 1000.0
    log("[slice] lm_head[:, tokens.seg] scaled by 1000 so [SEG] is emitted "
        "(random weights)")

    tok = mods["AnyRefTokenizer"]()
    lens = [len(mods["tokenize_prompt"](tok, mods["seg_question"](t)))
            for t in TEXTS]
    if not all(257 < n <= 385 for n in lens):
        fail(f"prompt lengths {lens} miss the 385 bucket")

    # before any profiler session: the wall of a bf16 decode step
    wall, busy, n, _, _ = decode_step_ms(torch, mods["llama"],
                                         params["llama"], cfg)
    log(f"[slice] greedy decode step (batch 2, 656-slot cache, lm_head, "
        f"argmax), bf16 decoder, before any other profiler session: "
        f"{wall:.4f} ms wall back to back, {busy:.4f} ms of kernels, {n:.0f} "
        f"kernels a step")

    images = request_images()
    # the int8 decoder, quantised now from the [in, out] weights (after the
    # [SEG] column scaling, which serve_rephrase puts back as it found it)
    t0 = time.time()
    int8_llama = mods["quant"].quantize_llama(params["llama"])
    torch.cuda.synchronize()
    quantize_s = time.time() - t0
    # phase 10(b): both layouts, then the exported generate on the fused one
    phase10 = {"layouts": layouts_7b(torch, mods, params, cfg, images)}
    phase10["export"] = export_7b(torch, flash, mods, params, cfg, images)
    torch.cuda.empty_cache()
    per_batch = launches_per_batch(flash, cfg)
    launches = {}
    for path in PATHS:
        server = mods["Server"](params, cfg, max_batch=2, speculative=True,
                                max_new_tokens=8, encoder_path=path)
        launches[path] = serve_path(torch, flash, mods, server, path, images,
                                    per_batch[path])
    serve_references(torch, flash, mods, params, cfg, per_batch["fused"])
    serve_rephrase(torch, flash, mods, params, cfg, images,
                   per_batch["fused"], seg_col)
    # phase 13(b) on these weights (the serving layout by now)
    phase13 = {"speculative": graph_7b(torch, flash, mods, params, cfg,
                                       per_batch["fused"])}
    # phase 7(b) on these weights, before the int8 decoder replaces the bf16
    launches["eval"] = eval_7b(torch, flash, mods, params, cfg, seg_col,
                               per_batch["fused"])
    # phase 8(b)'s inverse eval, on the same weights
    launches["inverse"] = eval_inverse_7b(torch, flash, mods, params, cfg,
                                          seg_col, per_batch["fused"])
    # phase 9(b), SAM alone, on the same SAM weights
    launches.update(sam_alone_7b(torch, flash, mods, params, cfg))
    launches["int8"], int8_step, phase13["int8"] = serve_int8(
        torch, flash, mods, params, cfg, images, dict(per_batch["fused"]),
        int8_llama, quantize_s)
    return launches, int8_step, phase10, phase13


def launches_per_batch(flash, cfg) -> dict:
    """{encoder path: {kernel: launches a served batch}} at ``cfg``."""
    s, l, c = cfg.sam, cfg.llama, cfg.clip
    n_global = len(s.encoder_global_attn_indexes)
    n_window = s.encoder_depth - n_global
    n_clip = c.num_layers + c.select_layer + 1
    zero = {k.__name__: 0 for k in flash.KERNELS}
    decoder = dict(rms_norm_fused=2 * l.num_layers,
                   flash_causal_attention=l.num_layers)
    fused_global = dict(fused_global_tail=n_global, layer_norm_fused=n_global,
                        flash_attention_qkv=n_clip)
    return {
        "fused": dict(zero, **decoder, **fused_global,
                      fused_window_attn=n_window, fused_mlp_stream=n_window),
        "fused_block": dict(zero, **decoder, **fused_global,
                            fused_window_block=n_window),
        "unfused_qkv": dict(zero, **decoder,
                            layer_norm_fused=2 * s.encoder_depth,
                            flash_relpos_attention_qkv=n_window,
                            flash_relpos_attention=n_global,
                            flash_attention_qkv=n_clip),
        "unfused": dict(zero, **decoder,
                        layer_norm_fused=2 * s.encoder_depth,
                        flash_relpos_attention=s.encoder_depth),
    }


def request_images() -> list:
    """The 4 requests' images (IMAGE_SIZES, uint8 RGB from seed 0)."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (h, w, 3), np.uint8) for h, w in IMAGE_SIZES]


def serve_references(torch, flash, mods, params, cfg, per_batch):
    """The reference round at anyref_7b on "fused", speculative: a crop, an
    audio, a box and a text request, in that order, through Server with
    max_batch 2 and one preprocess worker, so the batches are [crop, audio]
    and [box, text], all on request_images()[3]. Checks every answer, each
    callback once, the launches (flash_attention_qkv n_clip more in the
    crop's batch, the rest as for text), then the encoders on the card
    against the CPU plain path (check_reference_encoders); then the same
    round warm under torch.profiler, the audio tower's and the crop's CLIP
    pass's kernels each between two marker kernels (as profiled_counts
    finds a call's: the Server's device thread runs no host range the
    profiler records), and each part timed alone
    (reference_parts_alone)."""
    from torch.profiler import ProfilerActivity, profile
    Request, anyref = mods["Request"], mods["anyref"]
    image = request_images()[3]
    crop = mods["crop_box_np"](image, np.asarray(REF_CROP_XYXY))
    wave = reference_waveform()
    server = mods["Server"](params, cfg, max_batch=2, speculative=True,
                            max_new_tokens=8, encoder_path="fused",
                            preprocess_workers=1, fill_wait_ms=5000.0)
    qkv = flash.flash_attention_qkv
    per_call = []
    run = server.predictor.predict_async
    bracketed_calls, call_brackets = [], []

    def counted(batch):
        n0, b0 = launch_mark(flash, qkv.__name__), len(bracketed_calls)
        out = run(batch)
        per_call.append(("ref_images" in batch, "roi_boxes" in batch,
                         "audio_mels" in batch,
                         (n0, launch_mark(flash, qkv.__name__))))
        call_brackets.append(bracketed_calls[b0:])
        return out
    server.predictor.predict_async = counted
    fired = {}
    kinds = ("crop", "audio", "box", "text")
    fields = {"crop": {"ref_image": crop}, "audio": {"audio_waveform": wave},
              "box": {"roi_xyxy": np.asarray(REF_ROI_XYXY)},
              "text": {"text": TEXTS[3]}}

    def round_(tag):
        reqs = []
        for i, kind in enumerate(kinds):
            fired[tag, i] = 0

            def cb(result, key=(tag, i)):
                fired[key] += 1
            reqs.append(server.submit(Request(image=image, callback=cb,
                                              **fields[kind])))
        return [r.result(timeout=600) for r in reqs]

    encoders = {"encode_audio": anyref.encode_audio,
                "encode_ref_images": anyref.encode_ref_images}
    # the encoders between marker kernels from the first round on: each
    # key's first call runs them eagerly and its capture records them, so
    # the warm round's replays run the markers where its eager run did
    for name, fn in encoders.items():
        def bracketed(*a, _fn=fn, _name=name, **k):
            bracketed_calls.append(_name)
            torch.cuda._sleep(MARKER_CYCLES)
            out = _fn(*a, **k)
            torch.cuda._sleep(MARKER_CYCLES)
            return out
        setattr(anyref, name, bracketed)
    try:
        zero_launches(flash)
        t0 = time.time()
        results = round_("counted")
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_launches(flash)
        stats = dict(server.stats)
        counted_calls = [(*c[:3], int(c[3][1] - c[3][0])) for c in per_call]
        server.reset_stats()
        # a key's first call ran them in its eager run, then in the same
        # order in its capture
        eager_calls = [c for calls in call_brackets[:len(counted_calls)]
                       for c in calls[:len(calls) // 2]]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.time()
            again = round_("profiled")
            torch.cuda.synchronize()
            warm_wall = time.time() - t1
    finally:
        for name, fn in encoders.items():
            setattr(anyref, name, fn)
        server.shutdown()
    deadline = time.time() + 30
    while sorted(fired.values()) != [1] * 2 * len(kinds) and \
            time.time() < deadline:
        time.sleep(0.01)
    if sorted(fired.values()) != [1] * 2 * len(kinds):
        fail(f"references: callbacks fired {fired}, want each exactly once")
    h, w = image.shape[:2]
    for i, r in enumerate(results + again):
        kind = kinds[i % len(kinds)]
        if not r or "error" in r:
            fail(f"references, {kind} request: {r}")
        ml = r["mask_logits"]
        if ml is None or ml.shape[-2:] != (h, w) or \
                not np.isfinite(ml).all() or r["mask"].shape != (h, w):
            fail(f"references, {kind} request: ids "
                 f"{r['output_ids'].tolist()}, mask logits "
                 f"{None if ml is None else ml.shape}")
    for i, kind in enumerate(kinds):
        log(f"[slice refs] {kind} request: ids "
            f"{results[i]['output_ids'].tolist()}, on-pixels "
            f"{int(results[i]['mask'].sum())}")
    c = cfg.clip
    n_clip = c.num_layers + c.select_layer + 1
    want_calls = [(True, False, True, 2 * n_clip),
                  (False, True, False, n_clip)]
    if counted_calls != want_calls:
        fail(f"references: batches (crop, box, audio, flash_attention_qkv "
             f"launches) {counted_calls}, want {want_calls}")
    want = {name: 2 * n for name, n in per_batch.items()}
    want["flash_attention_qkv"] += n_clip
    if launches != want:
        fail(f"references: kernel launches {launches}, want {want}")
    log(f"[slice refs] anyref_7b, fused, speculative: 4 requests (crop, "
        f"audio, box, text) in {stats['batches']} batches, {wall:.2f} s "
        f"wall (first run); flash_attention_qkv {counted_calls[0][3]} in the "
        f"crop's batch, {counted_calls[1][3]} in the box's; launches "
        f"{json.dumps(launches)}; callbacks once each")

    check_reference_encoders(torch, mods, params, cfg, image, crop, wave)

    cuda = torch.autograd.DeviceType.CUDA
    records = sorted((e for e in prof.events() if e.device_type == cuda),
                     key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(records) if MARKER in e.name]
    ranges = {}
    if len(marks) == 2 * len(eager_calls):
        for n, name in enumerate(eager_calls):
            inside = records[marks[2 * n] + 1:marks[2 * n + 1]]
            ms, k = ranges.get(name, (0.0, 0))
            ranges[name] = (ms + sum(e.device_time_total
                                     for e in inside) / 1e3,
                            k + len(inside))
    else:
        log(f"[slice-warm refs] {len(marks)} marker kernels for the calls "
            f"{eager_calls}: the ranges are not read")
    by_name = {}
    for e in records:
        if MARKER not in e.name:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.device_time_total / 1e3
    busy = sum(by_name.values())
    log(f"[slice-warm refs] the 4 reference requests again under "
        f"torch.profiler: {warm_wall:.3f} s wall, kernels busy {busy:.3f} "
        f"ms -> device idle {100 * (1 - busy / 1e3 / warm_wall):.1f}% of the "
        f"wall; {mods['card']}")
    for name, (ms, n) in sorted(ranges.items()):
        log(f"[slice-warm refs]   {name}: {ms:.3f} ms of kernels in {n} "
            f"kernels (inside the served round)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[slice-warm refs]   {ms:9.3f} ms  {name[:90]}")
    reference_parts_alone(torch, mods, params, cfg, crop, wave)


def profiled_kernels(torch, fn):
    """(kernel ms, kernel count) of one warm call of fn under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.device_time_total for e in ev) / 1e3, len(ev)


def reference_parts_alone(torch, mods, params, cfg, crop, wave):
    """The served batches' reference work, each part alone, warm: the audio
    tower + projector on the audio batch's 2 rows (6 clips), the crop's
    CLIP pass + pooling at batch 2, and the mel front end of one
    AUDIO_SECONDS waveform (kernel time under the profiler; wall time
    synchronised, median of 10)."""
    anyref, mel = mods["anyref"], mods["mel"]
    mels = mel.audio_to_mel_clips(wave, device="cuda")
    mels = torch.stack([torch.zeros_like(mels), mels])
    px = torch.from_numpy(mods["preprocess_clip_np"](crop, 224)).cuda()
    px = torch.stack([px, px])
    parts = {
        "audio tower + projector, 2 rows x 3 clips": lambda: (
            anyref.encode_audio(params, cfg, mels)),
        "crop CLIP pass + pooling, batch 2": lambda: (
            anyref.encode_ref_images(params, cfg, px, "fused")),
        f"mel front end, {AUDIO_SECONDS:g} s": lambda: (
            mel.audio_to_mel_clips(wave, device="cuda"))}
    with torch.inference_mode():
        for name, fn in parts.items():
            ms, n = profiled_kernels(torch, fn)
            walls = []
            for _ in range(10):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            log(f"[refs-alone] {name}: {ms:.4f} ms of kernels in {n} "
                f"kernels, {float(np.median(walls)):.3f} ms wall "
                f"(synchronised, median of 10); {mods['card']}")


def check_reference_encoders(torch, mods, params, cfg, image, crop, wave):
    """The encoders on the card against the CPU plain path on the same
    weights, moved to the CPU: encode_roi bit-equal, encode_ref_images and
    encode_audio within REF_FLOOR_FACTOR times their bf16 floor (relative
    L2), the mel clips within MEL_ATOL; and assemble_embeds on the card:
    the placeholder rows equal to the encoded features bit for bit, every
    other row equal to the text path's."""
    anyref, mel = mods["anyref"], mods["mel"]
    keys = ("clip", "mm_projector", "audio_encoder", "audio_projector",
            "roi_embed")
    p_cpu = {k: _to_device(params[k], "cpu") for k in keys}
    p_f32 = {k: _to_device(v, torch.float32) for k, v in p_cpu.items()}
    h, w = image.shape[:2]
    boxes = torch.tensor(np.stack([
        np.asarray(REF_ROI_XYXY) / np.asarray([w, h, w, h]),
        [0.125, 0.375, 0.625, 0.875], [-0.1, 0.005, 0.995, 1.2]]),
        dtype=torch.float32)
    px = torch.from_numpy(np.stack([
        mods["preprocess_clip_np"](crop, 224),
        mods["preprocess_clip_np"](image, 224)]))
    tok = mods["AnyRefTokenizer"]()
    with torch.inference_mode():
        mels_cpu = mel.audio_to_mel_clips(wave, device="cpu")
        mels_gpu = mel.audio_to_mel_clips(wave, device="cuda")
        mel_err = float((mels_gpu.cpu() - mels_cpu).abs().max())
        mels = mels_cpu[None]
        roi_gpu = anyref.encode_roi(params, boxes.cuda()).cpu()
        roi_cpu = anyref.encode_roi(p_cpu, boxes)
        ref_gpu = anyref.encode_ref_images(params, cfg, px.cuda(), "fused")
        ref_cpu = anyref.encode_ref_images(p_cpu, cfg, px, "fused")
        aud_gpu = anyref.encode_audio(params, cfg, mels.cuda())
        aud_cpu = anyref.encode_audio(p_cpu, cfg, mels)
        ref_f32 = anyref.encode_ref_images(p_f32, cfg, px, "fused")
        aud_f32 = anyref.encode_audio(p_f32, cfg, mels)

        def rel_l2(a, b):
            a, b = a.float().cpu(), b.float()
            return float((a - b).norm() / b.norm())
        errs = {"encode_ref_images": rel_l2(ref_gpu, ref_cpu),
                "encode_audio": rel_l2(aud_gpu, aud_cpu)}
        floors = {"encode_ref_images": rel_l2(ref_cpu, ref_f32),
                  "encode_audio": rel_l2(aud_cpu, aud_f32)}
        card_f32 = {"encode_ref_images": rel_l2(ref_gpu, ref_f32),
                    "encode_audio": rel_l2(aud_gpu, aud_f32)}
        # assemble_embeds on the card: row 0 carries the reference, row 1
        # (not valid) keeps its placeholders' token embeddings
        clip = anyref.encode_clip_images(params, cfg, px.cuda(), "fused")
        valid = torch.tensor([True, False], device="cuda")
        splice = {}
        for kind, q, feats, slot in (
                ("crop", mods["img_ref_question"](), ref_gpu,
                 cfg.tokens.img_ref),
                ("audio", mods["audio_ref_question"](),
                 aud_gpu.expand(2, -1, -1), cfg.tokens.audio_ref)):
            ids = torch.from_numpy(np.stack(
                [mods["tokenize_prompt"](tok, q)] * 2)).long().cuda()
            args = (feats, valid, None, None) if kind == "crop" else \
                (None, None, feats, valid)
            emb, exp_ids, _ = anyref.assemble_embeds(params, cfg, ids, clip,
                                                     *args)
            text, _, _ = anyref.assemble_embeds(params, cfg, ids, clip)
            at = exp_ids == slot
            at[1] = False
            n_slots = int(at[0].sum())
            rows_ok = torch.equal(emb[0][at[0]],
                                  feats[0, :n_slots].to(emb.dtype))
            rest_ok = torch.equal(emb[~at], text[~at])
            splice[kind] = (n_slots, rows_ok, rest_ok)
    torch.cuda.synchronize()
    enc = "; ".join(
        f"{k} rel L2 {errs[k]:.4g} (limit {REF_FLOOR_FACTOR:g} x the bf16 "
        f"floor {floors[k]:.4g}; the card against the CPU's fp32 "
        f"{card_f32[k]:.4g})" for k in errs)
    log(f"[refs card-vs-cpu] encode_roi bit-equal "
        f"{torch.equal(roi_gpu, roi_cpu)} ({tuple(roi_cpu.shape)}); {enc}; "
        f"mel clips max abs err {mel_err:.3g} (limit {MEL_ATOL:.3g}); "
        f"assemble_embeds (slots, placeholder rows bit-equal, other rows "
        f"bit-equal to text) {splice}")
    if not torch.equal(roi_gpu, roi_cpu):
        fail("encode_roi on the card differs from the CPU gather")
    if any(errs[k] > REF_FLOOR_FACTOR * floors[k] for k in errs):
        fail(f"reference encoders on the card disagree with the CPU: {errs}, "
             f"bf16 floors {floors}")
    if mel_err > MEL_ATOL:
        fail(f"mel clips on the card disagree with the CPU: {mel_err}")
    want_slots = {"crop": 4, "audio": 3}
    for kind, (n, rows_ok, rest_ok) in splice.items():
        if n != want_slots[kind] or not rows_ok or not rest_ok:
            fail(f"assemble_embeds on the card, {kind}: {n} slots, "
                 f"placeholder rows equal {rows_ok}, other rows equal "
                 f"{rest_ok}")


def serve_rephrase(torch, flash, mods, params, cfg, images, per_batch,
                   seg_col, scale=None):
    """Rephrase pooling at anyref_7b on "fused", speculative: lm_head's
    [SEG] column set to ``scale`` (SEG_SCALE_7B) times its drawn values, so
    that answers emit tokens before their first [SEG]; the 4 requests
    served at rephrase 0 and at 0.1 (serve_rephrase_run), the same ids
    from both, at least one first [SEG] at k >= 1; then generate's pooled
    term held against its fp32 recomputation (check_pooled_term). The
    column is put back to 1000 times its values for the runs after."""
    scale = SEG_SCALE_7B if scale is None else scale
    lm = params["llama"]["lm_head"]
    lm[:, cfg.tokens.seg] = seg_col * scale
    runs = {w: serve_rephrase_run(torch, flash, mods, params,
                                  cfg.scaled(rephrase_weight=w), images,
                                  per_batch) for w in (0.0, 0.1)}
    if runs[0.0]["ids"] != runs[0.1]["ids"]:
        fail(f"rephrase changed the answers: {runs[0.0]['ids']} at 0, "
             f"{runs[0.1]['ids']} at 0.1")
    ks = first_seg(runs[0.1]["ids"], cfg.tokens.seg)
    if not any(k is not None and k >= 1 for k in ks):
        fail(f"rephrase at anyref_7b: no answer's first [SEG] at k >= 1 "
             f"(lm_head[:, tokens.seg] x {scale}), ids {runs[0.1]['ids']}")
    r0, r1 = runs[0.0], runs[0.1]
    log(f"[slice rephrase] anyref_7b, fused, speculative, lm_head[:, "
        f"tokens.seg] x {scale}: first [SEG] of each answer at {ks}; warm "
        f"round under torch.profiler after Server.reset_stats: rephrase 0.1 "
        f"kernels busy {r1['busy_ms']:.3f} ms ({r1['wall_s']:.3f} s wall, "
        f"{r1['passes']} decode passes), rephrase 0 {r0['busy_ms']:.3f} ms "
        f"({r0['wall_s']:.3f} s wall, {r0['passes']} passes): "
        f"rephrase adds {r1['busy_ms'] - r0['busy_ms']:.3f} ms of kernels; "
        f"{mods['card']}")
    delta = {k: r1["by_name"].get(k, 0.0) - r0["by_name"].get(k, 0.0)
             for k in set(r0["by_name"]) | set(r1["by_name"])}
    for k, ms in sorted(delta.items(), key=lambda kv: -abs(kv[1]))[:6]:
        log(f"[slice rephrase]   {ms:+9.3f} ms at 0.1  {k[:90]}")
    check_pooled_term(torch, mods, params, cfg, images)
    lm[:, cfg.tokens.seg] = seg_col * 1000.0


def serve_rephrase_run(torch, flash, mods, params, cfg, images, per_batch):
    """The 4 requests through Server, each with a callback: a counted
    warm-up round (answers and launch counts checked), Server.reset_stats,
    then the same round under torch.profiler, whose stats must count only
    it; every callback fires exactly once."""
    from torch.profiler import ProfilerActivity, profile
    Request = mods["Request"]
    # one preprocess worker: requests 0 + 1 and 2 + 3 share the batches in
    # both runs, so that the runs' decode work is the same
    server = mods["Server"](params, cfg, max_batch=2, speculative=True,
                            max_new_tokens=8, encoder_path="fused",
                            preprocess_workers=1)
    fired = {}

    def round_(tag):
        reqs = []
        for i, (im, t) in enumerate(zip(images, TEXTS)):
            fired[tag, i] = 0

            def cb(result, key=(tag, i)):
                fired[key] += 1
            reqs.append(server.submit(Request(image=im, text=t,
                                              callback=cb)))
        return [r.result(timeout=600) for r in reqs]

    try:
        zero_launches(flash)
        results = round_("warm-up")
        torch.cuda.synchronize()
        launches = read_launches(flash)
        n_batches = server.stats["batches"]
        server.reset_stats()
        p = server.predictor
        if any(server.stats.values()) or p.completed_batches or \
                p.h2d_bytes_total or p.d2h_bytes_total:
            fail(f"Server.reset_stats left {server.stats}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            again = round_("profiled")
            torch.cuda.synchronize()
            wall = time.time() - t0
        stats = dict(server.stats)
    finally:
        server.shutdown()
    if stats["rows"] != len(TEXTS) or \
            p.completed_batches != stats["batches"]:
        fail(f"stats after reset_stats count more than the profiled round: "
             f"{stats}, {p.completed_batches} batches completed")
    if sorted(fired.values()) != [1] * 2 * len(TEXTS):
        fail(f"request callbacks fired {fired}, want each exactly once")
    ids = []
    for i, (r, (h, w)) in enumerate(zip(results + again, IMAGE_SIZES * 2)):
        if not r or "error" in r:
            fail(f"rephrase {cfg.rephrase_weight}, request {i}: {r}")
        ml = r["mask_logits"]
        has_seg = cfg.tokens.seg in r["output_ids"].tolist()
        if (ml is None) == has_seg or r["mask"].shape != (h, w) or (
                ml is not None and (ml.shape[-2:] != (h, w)
                                    or not np.isfinite(ml).all())):
            fail(f"rephrase {cfg.rephrase_weight}, request {i}: ids "
                 f"{r['output_ids'].tolist()}, mask logits "
                 f"{None if ml is None else ml.shape}")
        ids.append(r["output_ids"].tolist())
    if ids[:len(TEXTS)] != ids[len(TEXTS):]:
        fail(f"rephrase {cfg.rephrase_weight}: the warm round answered "
             f"{ids[len(TEXTS):]}, the first {ids[:len(TEXTS)]}")
    want = {name: n * n_batches for name, n in per_batch.items()}
    if launches != want:
        fail(f"rephrase {cfg.rephrase_weight}: kernel launches {launches}, "
             f"want {want}")
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.device_time_total / 1e3
    busy = sum(by_name.values())
    log(f"[slice rephrase {cfg.rephrase_weight}] ids {ids[:len(TEXTS)]}; "
        f"launches as \"fused\" ({n_batches} batches); callbacks once "
        f"each; stats after reset_stats {json.dumps(stats)}")
    return {"ids": ids[:len(TEXTS)], "busy_ms": busy, "wall_s": wall,
            "by_name": by_name, "passes": p.decode_passes_total}


def check_pooled_term(torch, mods, params, cfg, images):
    """generate's rephrase pooling at anyref_7b (the same 4 prompts in one
    batch, speculative, "fused"), for each answer whose first [SEG] is at
    k >= 1, against a plain fp32 recomputation from generate's own inputs
    to it, observed by wrapping _last_layer_attn_row, _span_pool and
    project_seg_hidden: the final layer's residual input at the query and
    its roped keys (cache.k[-1]) give the row (RMSNorm, q, rope, a
    per-head softmax over the causal row from the left pad, the head
    mean); renormalised over the k states before the query (the last
    prompt state and k - 1 answer states, at cache slots q_slot - k ..
    q_slot - 1), it pools the states generate pooled. Held, relative L2
    over those answers <= POOLED_REL_L2: (1) the row; (2) the pooled
    vector; (3) the term as it reaches the output, seg_embeddings at 0.1
    less at 0 (slot 0), against project(h + 0.1 pooled) - project(h) in
    fp32, h generate's [SEG]-emitting state at rephrase 0 and the sum
    rounded to h's dtype (bf16) as generate and the reference form it.
    Printed beside them: the term with the sum left in fp32, and a second
    reading from llama.forward(return_last_input=True) over the prompt's
    real tokens and the k answer tokens before [SEG], the whole pooling
    recomputed in fp32 from its states, held <= FORWARD_REL_L2, with its
    floor (llama.forward's [SEG]-emitting state against generate's).
    Answers without a span must keep their embedding exactly."""
    anyref_mod, llama = mods["anyref"], mods["llama"]
    batch = bucket_batch(torch, mods, cfg, images, TEXTS, 385)
    seen = {"row": [], "pool": [], "state": []}
    attn_row, span_pool = anyref_mod._last_layer_attn_row, anyref_mod._span_pool
    project = anyref_mod.project_seg_hidden

    def observed_row(p, c, q_in, k_roped, q_pos, q_slot, kv_start=None,
                     group=None):
        row = attn_row(p, c, q_in, k_roped, q_pos, q_slot, kv_start, group)
        seen["row"].append((q_in.clone(), k_roped.clone(), q_pos, q_slot,
                            kv_start, row))
        return row

    def observed_pool(row, hidden, span):
        seen["pool"].append((row, hidden, span_pool(row, hidden, span)))
        return seen["pool"][-1][-1]

    def observed_project(p, hidden):
        seen["state"].append(hidden)
        return project(p, hidden)
    out = {}
    for w in (0.0, 0.1):
        anyref_mod._last_layer_attn_row = observed_row
        anyref_mod._span_pool = observed_pool
        anyref_mod.project_seg_hidden = observed_project
        try:
            out[w] = anyref_mod.generate(
                params, cfg.scaled(rephrase_weight=w), batch,
                max_new_tokens=8, speculative=True, encoder_path="fused")
        finally:
            anyref_mod._last_layer_attn_row = attn_row
            anyref_mod._span_pool = span_pool
            anyref_mod.project_seg_hidden = project
    if not torch.equal(out[0.0].output_ids, out[0.1].output_ids) or \
            len(seen["row"]) != 1 or len(seen["pool"]) != 1:
        fail("rephrase changed generate's ids, or pooled other than once")
    seg_state = seen["state"][0][:, 0]        # rephrase 0, slot 0
    term = (out[0.1].seg_embeddings[:, 0] - out[0.0].seg_embeddings[:, 0])
    ks = first_seg(out[0.1].output_ids.cpu(), cfg.tokens.seg)
    c = cfg.llama
    nh, hd = c.num_heads, c.head_dim
    lp = params["llama"]
    layer = lp["layers"][-1]
    inv = 1.0 / c.rope_theta ** (torch.arange(
        0, hd, 2, device="cuda").float() / hd)

    def rope(t, a):
        t1, t2 = t[..., :hd // 2], t[..., hd // 2:]
        return torch.cat([t1 * a.cos() - t2 * a.sin(),
                          t2 * a.cos() + t1 * a.sin()], -1)

    def rms_norm(x):
        return (x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                                + c.rms_norm_eps)
                * layer["input_norm"]["scale"].float())

    def softmax_row(q, k, valid):
        """Head-mean softmax row; q [nh, hd], k [nh, T, hd] fp32."""
        s = torch.einsum("hd,htd->ht", q, k) * hd ** -0.5
        return torch.softmax(s.masked_fill(~valid, float("-inf")),
                             -1).mean(0)

    def fp32_term(h, pooled, rounded):
        s = h + (0.1 * pooled).to(h.dtype) if rounded else \
            h.float() + 0.1 * pooled
        return (anyref_mod.project_seg_hidden(params, s)
                - anyref_mod.project_seg_hidden(params, h))

    q_in, keys, q_pos, q_slot, kv_start, row = seen["row"][0]
    _, hidden, pooled = seen["pool"][0]
    # [in, out] in fp32, in either layout of the decoder
    wq, wk = (p["w"].float() if "w" in p else p["w_t"].float().T
              for p in (llama.attn_proj(layer["attn"], n, c) for n in "qk"))
    names = ("row", "pooled", "term", "term_fp32_sum", "forward_pooled",
             "forward_term", "floor")
    err = {name: [0.0, 0.0] for name in names}

    def add(name, got, want):
        err[name][0] += float((got.float() - want).square().sum())
        err[name][1] += float(want.square().sum())
    rows = []
    with torch.inference_mode():
        clip = anyref_mod.encode_clip_images(params, cfg,
                                             batch["clip_images"], "fused")
        embeds, _, _ = anyref_mod.assemble_embeds(params, cfg,
                                                  batch["input_ids"], clip)
        pad = (batch["input_ids"] != 0).to(torch.uint8).argmax(1)
        for b, k in enumerate(ks):
            if k is None or k == 0:
                if float(term[b].abs().max()) != 0.0 or \
                        float(pooled[b].abs().max()) != 0.0:
                    fail(f"rephrase: answer {b} has no span (first [SEG] "
                         f"at {k}) but its embedding moved")
                continue
            # (1)-(3): from generate's own inputs to the pooling
            q = (rms_norm(q_in[b].float()) @ wq).reshape(nh, hd)
            q = rope(q, q_pos[b].float() * inv)
            kb = keys[b].float().repeat_interleave(nh // c.num_kv_heads, 0)
            t = torch.arange(kb.shape[1], device="cuda")
            want_row = softmax_row(q, kb, (t <= q_slot[b])
                                   & (t >= kv_start[b]))
            # the states pooled sit at cache slots q_slot - k .. q_slot - 1
            first = int(q_slot[b]) - k
            w = want_row[first:first + k]
            want_pool = (w / w.sum()) @ hidden[b, :k].float()
            add("row", row[b], want_row)
            add("pooled", pooled[b], want_pool)
            add("term", term[b], fp32_term(seg_state[b], want_pool, True))
            add("term_fp32_sum", term[b],
                fp32_term(seg_state[b], want_pool, False))
            # the second reading: llama.forward over prompt and answer
            gen = llama.embed(lp, out[0.1].output_ids[b:b + 1, :k])
            seq = torch.cat([embeds[b:b + 1, int(pad[b]):], gen], 1)
            fwd_hidden, last_in = llama.forward(lp, c, seq,
                                                return_last_input=True)
            n = seq.shape[1]
            hn = rms_norm(last_in[0].float())
            q = rope((hn[n - 1] @ wq).reshape(nh, hd), (n - 1) * inv)
            kk = (hn @ wk).reshape(n, c.num_kv_heads, hd).transpose(0, 1)
            ang = torch.arange(n, device="cuda").float()[:, None] * inv
            kk = rope(kk, ang).repeat_interleave(nh // c.num_kv_heads, 0)
            w = softmax_row(q, kk, torch.arange(n, device="cuda") < n)
            w = w[n - 1 - k:n - 1]
            fwd_pool = (w / w.sum()) @ fwd_hidden[0, n - 1 - k:n - 1].float()
            h = fwd_hidden[0, n - 1].float()
            add("forward_pooled", pooled[b], fwd_pool)
            add("forward_term", term[b], fp32_term(h, fwd_pool, False))
            add("floor", h, seg_state[b].float())
            rows.append(b)
    if not rows:
        fail(f"rephrase: no answer's first [SEG] at k >= 1 in generate: {ks}")
    rel = {name: (num / den) ** 0.5 for name, (num, den) in err.items()}
    log(f"[slice rephrase] generate's rephrase pooling against its fp32 "
        f"recomputation from its own inputs, answers {rows} (first [SEG] "
        f"at {ks}), relative L2: the row {rel['row']:.4g}, the pooled "
        f"vector {rel['pooled']:.4g}, the term in seg_embeddings (at 0.1 "
        f"less at 0) {rel['term']:.4g}, its norm {err['term'][1] ** 0.5:.4g} "
        f"(limit {POOLED_REL_L2} each); the term against the sum left in "
        f"fp32 {rel['term_fp32_sum']:.4g}")
    log(f"[slice rephrase] the same against the fp32 recomputation from "
        f"llama.forward: pooled vector {rel['forward_pooled']:.4g}, the "
        f"term {rel['forward_term']:.4g} (limit {FORWARD_REL_L2} each); "
        f"floor: the [SEG]-emitting state of llama.forward against "
        f"generate's {rel['floor']:.4g}")
    if max(rel["row"], rel["pooled"], rel["term"]) > POOLED_REL_L2 or \
            max(rel["forward_pooled"], rel["forward_term"]) > FORWARD_REL_L2:
        fail(f"rephrase: generate's pooling is off its fp32 recomputation: "
             f"{rel}")


def decode_step_ms(torch, llama, lp, cfg):
    """One greedy decode step (decoder at batch 2 over a 656-slot cache,
    lm_head, argmax) on decoder tree ``lp`` -> (wall ms, device-busy ms,
    kernels per step, the 5 kernels that take most of it as (name, ms per
    step), {kernel name: (launches per step, ms per step)}). One step to
    warm up, then wall: CUDA events around DECODE_ITERS steps back to back,
    over DECODE_ITERS; busy: the summed kernel time of PROFILED_STEPS
    steps under torch.profiler, over PROFILED_STEPS (the step's device
    time whatever the host does)."""
    from torch.profiler import ProfilerActivity, profile
    B, L = 2, 640
    cache = llama.init_cache(cfg.llama, B, L + 16)
    g = torch.Generator(device="cuda").manual_seed(3)
    emb = (torch.randn(B, 1, cfg.llama.hidden_size, generator=g,
                       device="cuda") * 0.02).to(torch.bfloat16)
    pad = torch.tensor([0, 200], device="cuda")
    slot = torch.tensor(L, device="cuda")

    def step():
        h, _ = llama.decode_step(lp, cfg.llama, emb, slot, cache,
                                 pad_len=pad)
        return llama.logits(lp, h[:, 0]).argmax(-1)

    with torch.inference_mode():
        step()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(DECODE_ITERS):
            step()
        b.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED_STEPS):
                step()
            torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name, count = {}, {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
        count[e.name] = count.get(e.name, 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    n = PROFILED_STEPS
    return (a.elapsed_time(b) / DECODE_ITERS, sum(by_name.values()) / 1e3 / n,
            len(kernels) / n, [(k[:80], us / 1e3 / n) for k, us in top],
            {k: (count[k] / n, us / 1e3 / n) for k, us in by_name.items()})


def serve_int8(torch, flash, mods, params, cfg, images, per_batch,
               int8_llama, quantize_s):
    """The int8 decoder: a decode step timed on the bf16 decoder (by now in
    the serving layout), then ``int8_llama``, quantize_llama of the same
    weights on the card in ``quantize_s`` s before the layout conversion
    (after the [SEG] column scaling, which the column's scale absorbs),
    replaces it, the bf16 decoder freed, the
    step timed again, and the 4 requests served greedy (Server(speculative=
    False)) on the default encoder path, every answer and launch count
    checked: int8_matmul 224 products per decoder pass (7 per layer) plus
    one lm_head call per pass. The int8 steps must launch int8_matmul once
    a product (its wrapper's count), and their profile must show at most
    one CUDA kernel of csrc/int8_matmul.cu a product, all of the decode
    body: torch.profiler drops device records late in a long process (the
    same int8 step was seen with 2392 and with 2381 kernels), so a profile
    can undercount but never overcount. The step's kernel time is printed
    against the bytes bound of the decoder's int8 weights and scales.
    Then phase 13(b)'s one int8 greedy batch (graph_vs_eager). Returns
    (launch counts, that step's int8 numbers, phase 13(b)'s)."""
    llama = mods["llama"]
    steps = {"bf16 (serving layout)": decode_step_ms(torch, llama,
                                                     params["llama"], cfg)}
    params["llama"] = int8_llama
    q_s = quantize_s
    torch.cuda.empty_cache()
    zero_launches(flash)
    steps["int8"] = decode_step_ms(torch, llama, params["llama"], cfg)
    launched = read_launches(flash)["int8_matmul"]
    log(f"[slice int8] quantize_llama(anyref_7b decoder) on the card "
        f"{q_s:.2f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated after freeing the bf16 decoder")
    for name, (wall, busy, n, top, _) in steps.items():
        log(f"[slice int8] greedy decode step (batch 2, 656-slot cache, "
            f"lm_head, argmax), {name} decoder: {wall:.4f} ms wall back to "
            f"back, {busy:.4f} ms of kernels, {n:.0f} kernels a step")
        for kname, ms in top:
            log(f"[slice int8]   {name} step {ms:8.4f} ms  {kname}")
    layer = params["llama"]["layers"][0]
    per_layer = sum("w_q" in p for part in ("attn", "mlp")
                    for p in layer[part].values())
    per_pass = per_layer * cfg.llama.num_layers + 1
    i8 = {k: v for k, v in steps["int8"][4].items() if "anyref_i8" in k}
    n_i8 = sum(c for c, _ in i8.values())
    step = {"int8_kernels_a_step": n_i8,
            "int8_ms_a_step": sum(t for _, t in i8.values()),
            "int8_bytes_bound_ms": int8_bytes(params["llama"]) /
            H100_BYTES_PER_S * 1e3, "kernels": sorted(i8)}
    n_steps = 1 + DECODE_ITERS + PROFILED_STEPS
    log(f"[slice int8] int8 decode step: int8_matmul launched "
        f"{launched / n_steps:g} times a step over {n_steps} steps; under "
        f"torch.profiler {n_i8:g} CUDA kernels of int8_matmul.cu a step for "
        f"{per_pass} products ({', '.join(sorted(i8))}), "
        f"{step['int8_ms_a_step']:.4f} ms a step against the bytes bound of "
        f"the int8 weights and scales {step['int8_bytes_bound_ms']:.4f} ms")
    if launched != n_steps * per_pass or n_i8 > per_pass or not i8 or \
            any("decode_kernel" not in k for k in i8):
        fail(f"int8 decode step: {launched} int8_matmul launches in "
             f"{n_steps} steps, want {n_steps * per_pass}; {n_i8:g} CUDA "
             f"kernels of int8_matmul.cu a step ({sorted(i8)}), want at most "
             f"{per_pass}, one decode_kernel a product")
    torch.cuda.reset_peak_memory_stats()
    server = mods["Server"](params, cfg, max_batch=2, speculative=False,
                            max_new_tokens=8)
    launches = serve_path(torch, flash, mods, server, "int8", images,
                          per_batch, int8_per_pass=per_pass)
    log(f"[slice int8] peak memory allocated while serving "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # phase 13(b) on the int8 decoder: one greedy batch
    batch = graph_batches(cfg, mods, ("text",))["text"]
    graph = graph_vs_eager(torch, flash, mods, params, cfg, batch,
                           "fused, int8 greedy", per_batch,
                           speculative=False, int8_per_pass=per_pass)
    return launches, step, graph


def int8_bytes(tree) -> int:
    """Bytes of the int8 weights and their fp32 scales in a tree."""
    if isinstance(tree, dict):
        if "w_q" in tree:
            return tree["w_q"].numel() + 4 * tree["scale"].numel()
        return sum(int8_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(int8_bytes(v) for v in tree)
    return 0


def serve_path(torch, flash, mods, server, path, images, per_batch,
               int8_per_pass=None):
    """Serve the 4 requests on one server: counted run (every answer and
    every kernel's launch count checked), then a warm run under the
    profiler. ``int8_per_pass``: int8_matmul launches per decoder pass
    (prefill or decode step), whose count follows the passes."""
    zero_launches(flash)
    t0 = time.time()
    reqs = [server.submit(mods["Request"](image=im, text=t))
            for im, t in zip(images, TEXTS)]
    results = [r.result(timeout=600) for r in reqs]
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches(flash)
    stats = dict(server.stats)
    passes = server.predictor.decode_passes_total
    warm = profile_warm_round(torch, flash, server, mods["Request"], images)
    server.shutdown()

    for i, (r, (h, w)) in enumerate(zip(results, IMAGE_SIZES)):
        if not r:
            fail(f"request {i}: no answer within the time limit")
        if "error" in r:
            fail(f"request {i}: {r['error']}")
        ml = r["mask_logits"]
        if ml is None:
            fail(f"request {i}: no [SEG] emitted, ids {r['output_ids']}")
        if ml.shape[-2:] != (h, w) or not np.isfinite(ml).all():
            fail(f"request {i}: mask logits {ml.shape} (want {(h, w)}) or "
                 "not finite")
        if r["mask"].shape != (h, w):
            fail(f"request {i}: mask {r['mask'].shape}, want {(h, w)}")
        log(f"[slice {path}] request {i} {h}x{w}: ids "
            f"{r['output_ids'].tolist()} mask {ml.shape[-2:]} on-pixels "
            f"{int(r['mask'].sum())}")

    n_batches = stats["batches"]
    want = {name: n * n_batches for name, n in per_batch.items()}
    if int8_per_pass is not None:
        # one decoder pass for each prefill and each greedy decode step
        want["int8_matmul"] = int8_per_pass * (n_batches + passes)
    for name, n in want.items():
        if launches[name] != n or (per_batch.get(name) and not n):
            fail(f"{name}: {launches[name]} launches on the {path} path, "
                 f"want {n} ({per_batch.get(name)} per batch x {n_batches} "
                 f"batches)")
    log(f"[slice {path}] anyref_7b, 4 requests in {n_batches} batches "
        f"({stats['rows']} rows), {wall:.2f} s wall -> "
        f"{len(TEXTS) / wall:.3f} q/s (first run, nothing warmed but the "
        f"kernels); decode passes {passes}")
    log(f"[slice {path}] kernel launches {json.dumps(launches)} (want "
        f"{json.dumps(want)})")
    log(f"[slice {path}] Server.stats {json.dumps(stats)}")
    busy = (f"{warm['lost']} (the profile holds {warm['busy_ms']:.1f} ms); "
            f"the batches' device spans (CUDA events) {warm['span_s']:.4f} "
            f"s -> device idle at least "
            f"{100 * (1 - warm['span_s'] / warm['wall_s']):.1f}%"
            if warm["lost"] else
            f"{warm['busy_ms']:.1f} ms -> device idle "
            f"{100 * (1 - warm['busy_ms'] / 1e3 / warm['wall_s']):.1f}% of "
            f"the wall")
    log(f"[slice-warm {path}] the same 4 requests again under torch.profiler: "
        f"{warm['wall_s']:.3f} s wall -> {len(TEXTS) / warm['wall_s']:.3f} q/s; "
        f"kernels busy {busy}")
    for name, ms in warm["top"]:
        log(f"[slice-warm {path}]   {ms:9.3f} ms  {name}")
    return launches


class DispatchSpans:
    """While open, each predict_async of ``pred`` is bracketed by two CUDA
    events on its stream; ``seconds()`` (after a synchronize) sums the
    spans: the device time from each batch's first op to its last, gaps
    inside a batch included, so at least its busy time."""

    def __init__(self, torch, pred):
        self.torch, self.pred, self.spans = torch, pred, []

    def __enter__(self):
        inner = self.pred.predict_async

        def predict_async(batch):
            e0 = self.torch.cuda.Event(enable_timing=True)
            e1 = self.torch.cuda.Event(enable_timing=True)
            e0.record()
            out = inner(batch)
            e1.record()
            self.spans.append((e0, e1))
            return out
        self.inner = inner
        self.pred.predict_async = predict_async
        return self

    def __exit__(self, *exc):
        self.pred.predict_async = self.inner

    def seconds(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.spans) / 1e3


def profile_warm_round(torch, flash, server, Request, images):
    """Serve the same requests a second time, warm, under torch.profiler:
    wall time, summed kernel time (one stream, so the device's busy time;
    with "lost" the reason it is not measured, where the profile lost
    records of a compiled loop: loop_records_lost), the batches' device
    spans (DispatchSpans) and the kernels that take most of it. Runs after
    the launch counts of the main path were read."""
    from torch.profiler import ProfilerActivity, profile
    mark = launch_mark(flash, "loop_condition")
    with DispatchSpans(torch, server.predictor) as spans, \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        reqs = [server.submit(Request(image=im, text=t))
                for im, t in zip(images, TEXTS)]
        results = [r.result(timeout=600) for r in reqs]
        torch.cuda.synchronize()
        wall = time.time() - t0
    if not all(r and "error" not in r for r in results):
        fail("warm round: a request failed")
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_s": wall, "busy_ms": busy_ms,
            "lost": loop_records_lost(torch, flash, prof, mark),
            "span_s": spans.seconds(),
            "top": [(n[:90], us / 1e3) for n, us in top]}


# ---------------------------------------------------------------------------
# phase 6: the reference's checkpoint layouts, assembled and served
# ---------------------------------------------------------------------------
def reference_state_dicts(cfg, rand, llama_layers=None) -> dict:
    """Synthetic state dicts in the reference's layouts, every leaf drawn by
    ``rand(*shape)``: "sam" (sam_vit_h_4b8939.pth), "clip" (HF
    CLIPVisionModel, "vision_model."), "llama" (HF LlamaForCausalLM, the
    first ``llama_layers`` layers), "mm_projector" and "heads" (LLaVA's and
    AnyRef's, "model." prefix), "audio" (imagebind_huge.pth, audio branch)
    and "adapter" (a PEFT LoRA adapter, r = 8 on q_proj and v_proj)."""
    def lin(sd, name, i, o, bias=True):
        sd[name + ".weight"] = rand(o, i)
        if bias:
            sd[name + ".bias"] = rand(o)

    def ln(sd, name, d):
        sd[name + ".weight"] = rand(d)
        sd[name + ".bias"] = rand(d)

    s, c, l, a = cfg.sam, cfg.clip, cfg.llama, cfg.audio
    out = {}
    sam = {}
    d, P, g = s.encoder_embed_dim, s.prompt_embed_dim, s.embedding_size
    hd = d // s.encoder_num_heads
    ie = "image_encoder."
    sam[ie + "patch_embed.proj.weight"] = rand(d, 3, s.patch_size,
                                               s.patch_size)
    sam[ie + "patch_embed.proj.bias"] = rand(d)
    sam[ie + "pos_embed"] = rand(1, g, g, d)
    for i in range(s.encoder_depth):
        b = f"{ie}blocks.{i}."
        size = g if i in s.encoder_global_attn_indexes else s.window_size
        ln(sam, b + "norm1", d)
        lin(sam, b + "attn.qkv", d, 3 * d)
        lin(sam, b + "attn.proj", d, d)
        sam[b + "attn.rel_pos_h"] = rand(2 * size - 1, hd)
        sam[b + "attn.rel_pos_w"] = rand(2 * size - 1, hd)
        ln(sam, b + "norm2", d)
        lin(sam, b + "mlp.lin1", d, int(d * s.mlp_ratio))
        lin(sam, b + "mlp.lin2", int(d * s.mlp_ratio), d)
    sam[ie + "neck.0.weight"] = rand(P, d, 1, 1)
    ln(sam, ie + "neck.1", P)
    sam[ie + "neck.2.weight"] = rand(P, P, 3, 3)
    ln(sam, ie + "neck.3", P)
    pe = "prompt_encoder."
    sam[pe + "pe_layer.positional_encoding_gaussian_matrix"] = rand(2, P // 2)
    for i in range(4):
        sam[f"{pe}point_embeddings.{i}.weight"] = rand(1, P)
    sam[pe + "not_a_point_embed.weight"] = rand(1, P)
    sam[pe + "no_mask_embed.weight"] = rand(1, P)
    for idx, (o, i, k) in {0: (4, 1, 2), 3: (16, 4, 2), 6: (P, 16, 1)}.items():
        sam[f"{pe}mask_downscaling.{idx}.weight"] = rand(o, i, k, k)
        sam[f"{pe}mask_downscaling.{idx}.bias"] = rand(o)
    ln(sam, pe + "mask_downscaling.1", 4)
    ln(sam, pe + "mask_downscaling.4", 16)
    md = "mask_decoder."
    nm = s.num_multimask_outputs + 1

    def attn(prefix, di):
        for k in ("q", "k", "v"):
            lin(sam, f"{prefix}.{k}_proj", P, di)
        lin(sam, prefix + ".out_proj", di, P)

    for i in range(s.mask_decoder_depth):
        t = f"{md}transformer.layers.{i}."
        attn(t + "self_attn", P)
        attn(t + "cross_attn_token_to_image", P // 2)
        attn(t + "cross_attn_image_to_token", P // 2)
        lin(sam, t + "mlp.lin1", P, s.mask_decoder_mlp_dim)
        lin(sam, t + "mlp.lin2", s.mask_decoder_mlp_dim, P)
        for n in range(1, 5):
            ln(sam, f"{t}norm{n}", P)
    attn(md + "transformer.final_attn_token_to_image", P // 2)
    ln(sam, md + "transformer.norm_final_attn", P)
    sam[md + "iou_token.weight"] = rand(1, P)
    sam[md + "mask_tokens.weight"] = rand(nm, P)
    sam[md + "output_upscaling.0.weight"] = rand(P, P // 4, 2, 2)
    sam[md + "output_upscaling.0.bias"] = rand(P // 4)
    ln(sam, md + "output_upscaling.1", P // 4)
    sam[md + "output_upscaling.3.weight"] = rand(P // 4, P // 8, 2, 2)
    sam[md + "output_upscaling.3.bias"] = rand(P // 8)
    for m in range(nm):
        for li, (i, o) in enumerate(((P, P), (P, P), (P, P // 8))):
            lin(sam, f"{md}output_hypernetworks_mlps.{m}.layers.{li}", i, o)
    h = s.iou_head_hidden_dim
    for li, (i, o) in enumerate(((P, h), (h, h), (h, nm))):
        lin(sam, f"{md}iou_prediction_head.layers.{li}", i, o)
    out["sam"] = sam

    clip = {}
    e = "vision_model.embeddings."
    clip[e + "class_embedding"] = rand(c.hidden_size)
    clip[e + "patch_embedding.weight"] = rand(c.hidden_size, 3, c.patch_size,
                                              c.patch_size)
    clip[e + "position_embedding.weight"] = rand(c.num_patches + 1,
                                                 c.hidden_size)
    ln(clip, "vision_model.pre_layrnorm", c.hidden_size)
    for i in range(c.num_layers):
        b = f"vision_model.encoder.layers.{i}."
        ln(clip, b + "layer_norm1", c.hidden_size)
        for k in ("q", "k", "v", "out"):
            lin(clip, f"{b}self_attn.{k}_proj", c.hidden_size, c.hidden_size)
        ln(clip, b + "layer_norm2", c.hidden_size)
        lin(clip, b + "mlp.fc1", c.hidden_size, c.intermediate_size)
        lin(clip, b + "mlp.fc2", c.intermediate_size, c.hidden_size)
    out["clip"] = clip

    n_layers = l.num_layers if llama_layers is None else llama_layers
    D, qd = l.hidden_size, l.num_heads * l.head_dim
    kvd = l.num_kv_heads * l.head_dim
    llama = {"model.embed_tokens.weight": rand(l.vocab_size, D),
             "model.norm.weight": rand(D),
             "lm_head.weight": rand(l.vocab_size, D)}
    adapter = {}
    for i in range(n_layers):
        b = f"model.layers.{i}."
        llama[b + "input_layernorm.weight"] = rand(D)
        llama[b + "post_attention_layernorm.weight"] = rand(D)
        for k, (fi, fo) in {"q": (D, qd), "k": (D, kvd), "v": (D, kvd),
                            "o": (qd, D)}.items():
            lin(llama, f"{b}self_attn.{k}_proj", fi, fo, bias=False)
        for k, (fi, fo) in {"gate": (D, l.intermediate_size),
                            "up": (D, l.intermediate_size),
                            "down": (l.intermediate_size, D)}.items():
            lin(llama, f"{b}mlp.{k}_proj", fi, fo, bias=False)
        for k, fo in (("q", qd), ("v", kvd)):
            base = f"base_model.model.{b}self_attn.{k}_proj"
            adapter[base + ".lora_A.weight"] = rand(8, D)
            adapter[base + ".lora_B.weight"] = rand(fo, 8)
    out["llama"] = llama
    out["adapter"] = adapter
    out["mm_projector"] = {"model.mm_projector.weight": rand(D, c.hidden_size),
                           "model.mm_projector.bias": rand(D)}
    heads = {}
    lin(heads, "model.text_hidden_fcs.0.0", D, D)
    lin(heads, "model.text_hidden_fcs.0.2", D, cfg.out_dim)
    heads["model.loc_embeddings.weight"] = rand(cfg.tokens.num_loc,
                                                cfg.out_dim)
    if a is not None:
        lin(heads, "model.audio_projector", a.out_embed_dim, D)
    out["heads"] = heads

    if a is not None:
        audio = {}
        pre, tr = "modality_preprocessors.audio.", "modality_trunks.audio."
        ad = a.embed_dim
        gh = (a.mel_bins - a.kernel_size) // a.stride + 1
        gw = (a.target_len - a.kernel_size) // a.stride + 1
        audio[pre + "rgbt_stem.proj.weight"] = rand(ad, 1, a.kernel_size,
                                                    a.kernel_size)
        ln(audio, pre + "rgbt_stem.norm_layer", ad)
        audio[pre + "cls_token"] = rand(1, 1, ad)
        audio[pre + "pos_embedding_helper.pos_embed"] = rand(1, gh * gw + 1,
                                                             ad)
        for i in range(a.num_blocks):
            b = f"{tr}blocks.{i}."
            ln(audio, b + "norm_1", ad)
            audio[b + "attn.in_proj_weight"] = rand(3 * ad, ad)
            audio[b + "attn.in_proj_bias"] = rand(3 * ad)
            audio[b + "attn.bias_k"] = rand(1, 1, ad)
            audio[b + "attn.bias_v"] = rand(1, 1, ad)
            lin(audio, b + "attn.out_proj", ad, ad)
            ln(audio, b + "norm_2", ad)
            lin(audio, b + "mlp.fc1", ad, 4 * ad)
            lin(audio, b + "mlp.fc2", 4 * ad, ad)
        ln(audio, "modality_heads.audio.0", ad)
        audio["modality_heads.audio.2.weight"] = rand(a.out_embed_dim, ad)
        out["audio"] = audio
    return out


def merged_llava(sds: dict) -> dict:
    """One merged reference checkpoint (merge_lora.py's output): LLaMA,
    mm_projector, the CLIP tower under "model.vision_tower.", SAM under
    "model.visual_model." and the AnyRef heads."""
    return {**sds["llama"], **sds["mm_projector"], **sds["heads"],
            **{"model.vision_tower." + k: v for k, v in sds["clip"].items()},
            **{"model.visual_model." + k: v for k, v in sds["sam"].items()}}


def write_safetensors(torch, path: str, sd: dict) -> None:
    """A .safetensors file: 8-byte little-endian header length, the JSON
    header (padded to 8 bytes), the raw little-endian buffers."""
    names = {torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16", torch.int8: "I8", torch.int32: "I32",
             torch.int64: "I64"}
    header, bufs, off = {}, [], 0
    for k, t in sd.items():
        raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
        header[k] = {"dtype": names[t.dtype], "shape": list(t.shape),
                     "data_offsets": [off, off + raw.numel()]}
        off += raw.numel()
        bufs.append(raw)
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(len(h).to_bytes(8, "little"))
        f.write(h)
        for raw in bufs:
            f.write(raw.numpy().data)


# The checkpoint phase's depth cut: a 32-layer bf16 LLaMA is 13.5 GB of disk
# a run; CLIP-L and SAM-H keep their full depth.
CKPT_LLAMA_LAYERS = 2


def checkpoint_phase(torch, flash, mods) -> dict:
    """The reference's artifacts at anyref_7b width, LLaMA cut to
    CKPT_LLAMA_LAYERS layers, drawn from a seeded generator into a temporary
    directory: a merged LLaVA directory as one .safetensors shard (bf16:
    LLaMA, mm_projector, the CLIP-L tower, SAM-H, the AnyRef heads), a PEFT
    adapter (r = 8 on q and v) and a sam_vit_h .pth (fp32). Then
    assemble_pretrained on the card and on the CPU (every leaf bit-equal),
    the conversion CLI on the card with the adapter (the preset anyref_7b,
    its decoder as deep as the state dict; load_params of its file
    bit-equal to the CLI's tree built on the CPU, the LoRA-merged leaves
    changed and everything else equal to the assembly), and the 4 requests
    served on the assembled tree with the SentencePiece fixture tokenizer at
    rephrase 0.1 (finite answers, "fused" launch counts at this depth)."""
    import dataclasses
    import tempfile

    from anyref_tpu_torch import checkpoint
    from anyref_tpu_torch.tools import convert_checkpoint as cli
    base = mods["anyref_7b"]()
    cfg = base.scaled(llama=dataclasses.replace(
        base.llama, num_layers=CKPT_LLAMA_LAYERS))
    log(f"[ckpt] cuts: LLaMA {CKPT_LLAMA_LAYERS} of {base.llama.num_layers} "
        f"layers (widths, vocab, CLIP-L {cfg.clip.num_layers} layers and "
        f"SAM-H {cfg.sam.encoder_depth} layers kept); no ImageBind file "
        "(its tree is drawn from the seed)")
    g = torch.Generator(device="cuda").manual_seed(7)

    def rand(*shape, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device="cuda") * 0.02).to(
            dtype).cpu()

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        sds = reference_state_dicts(cfg, rand, CKPT_LLAMA_LAYERS)
        llava, lora = os.path.join(tmp, "llava"), os.path.join(tmp, "lora")
        os.makedirs(llava)
        os.makedirs(lora)
        write_safetensors(torch, os.path.join(llava, "model.safetensors"),
                          merged_llava(sds))
        with open(os.path.join(lora, "adapter_config.json"), "w") as f:
            json.dump({"lora_alpha": 16, "r": 8}, f)
        torch.save(sds["adapter"], os.path.join(lora, "adapter_model.bin"))
        sam_pth = os.path.join(tmp, "sam_vit_h_4b8939.pth")
        torch.save({k: rand(*v.shape, dtype=torch.float32)
                    for k, v in sds["sam"].items()}, sam_pth)
        del sds
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in
                   os.walk(tmp) for f in fs)
        log(f"[ckpt] wrote {size / 2**30:.2f} GiB of reference artifacts in "
            f"{time.time() - t0:.1f} s")

        kw = dict(llava_dir=llava, sam_ckpt=sam_pth, dtype=torch.bfloat16)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.time()
        tree = checkpoint.assemble_pretrained(cfg, device="cuda", **kw)
        torch.cuda.synchronize()
        t_gpu = time.time() - t0
        peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
        t0 = time.time()
        on_cpu = checkpoint.assemble_pretrained(cfg, device="cpu", **kw)
        t_cpu = time.time() - t0
        n = check_same_tree(torch, tree, on_cpu, "assemble_pretrained "
                            "card vs CPU")
        del on_cpu

        out = os.path.join(tmp, "anyref_7b_cut.pt")
        cmd = [sys.executable, "-m", "anyref_tpu_torch.tools."
               "convert_checkpoint", "--out", out, "--llava_dir", llava,
               "--sam_ckpt", sam_pth, "--lora_dir", lora, "--device", "cuda"]
        t0 = time.time()
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           env=dict(os.environ, PYTHONPATH=ROOT))
        t_cli = time.time() - t0
        if r.returncode:
            fail(f"conversion CLI: {r.stdout[-2000:]} {r.stderr[-2000:]}")
        t0 = time.time()
        loaded = checkpoint.load_params(out, device="cuda")
        torch.cuda.synchronize()
        t_load = time.time() - t0
        merged_cpu = cli.build_params(cfg, lora_dir=lora, device="cpu", **kw)
        check_same_tree(torch, loaded, merged_cpu, "the CLI's file (card) "
                        "vs its tree built on the CPU")
        del merged_cpu
        adapted = 0
        for path, a, b in tree_pairs(loaded, tree):
            lora_leaf = path.startswith("/llama/layers/") and (
                "/attn/q/" in path or "/attn/v/" in path)
            adapted += lora_leaf
            if lora_leaf == torch.equal(a, b):
                fail(f"the CLI's {path} is "
                     f"{'un' if lora_leaf else ''}changed by the adapter")
        del loaded
        log(f"[ckpt] assemble_pretrained(anyref_7b cut) on the card "
            f"{t_gpu:.2f} s (peak {peak:.2f} GiB allocated above the "
            f"{base_mem / 2**30:.2f} GiB held before), on the CPU "
            f"{t_cpu:.2f} s: {n} leaves bit-equal; conversion CLI with the "
            f"adapter on the card {t_cli:.2f} s (process included), "
            f"load_params {t_load:.2f} s, bit-equal to the CPU build, "
            f"{adapted} LoRA-merged leaves; {mods['card']}")

    tok = mods["AnyRefTokenizer"].from_pretrained(
        os.path.join(ROOT, "tests", "fixtures", "sp_tokenizer"))
    rcfg = cfg.scaled(rephrase_weight=0.1)
    server = mods["Server"](tree, rcfg, tokenizer=tok, max_batch=2,
                            speculative=True, max_new_tokens=8,
                            encoder_path="fused")
    zero_launches(flash)
    try:
        reqs = [server.submit(mods["Request"](image=im, text=t))
                for im, t in zip(request_images(), TEXTS)]
        results = [r.result(timeout=600) for r in reqs]
        torch.cuda.synchronize()
        n_batches = server.stats["batches"]
    finally:
        server.shutdown()
    for i, (r, (h, w)) in enumerate(zip(results, IMAGE_SIZES)):
        if not r or "error" in r:
            fail(f"checkpoint phase, request {i}: {r}")
        ml = r["mask_logits"]
        if r["mask"].shape != (h, w) or (ml is not None and (
                ml.shape[-2:] != (h, w) or not np.isfinite(ml).all())):
            fail(f"checkpoint phase, request {i}: mask {r['mask'].shape}, "
                 f"logits {None if ml is None else ml.shape}")
        log(f"[ckpt] request {i}: {r['text']!r} ids "
            f"{r['output_ids'].tolist()}")
    launches = read_launches(flash)
    want = {k: v * n_batches
            for k, v in launches_per_batch(flash, cfg)["fused"].items()}
    if launches != want:
        fail(f"checkpoint phase: launches {launches}, want {want}")
    log(f"[ckpt] served the 4 requests on the assembled tree, SentencePiece "
        f"fixture tokenizer, rephrase 0.1, {n_batches} batches: launches "
        f"those of \"fused\" at {CKPT_LLAMA_LAYERS} decoder layers")
    return {"assemble_s": t_gpu, "load_s": t_load, "peak_gib": peak}


# ---------------------------------------------------------------------------
# phase 7: the segmentation eval
# ---------------------------------------------------------------------------
# the data roots (write_eval_root): (a) two images of EVAL_TINY_SIZE, (b) 8
# COCO-sized images, each with two refs; the decode budget of both
EVAL_TINY_SIZE = (96, 128)
EVAL_TINY_IMAGES = 2
EVAL_7B_SIZE = (480, 640)
EVAL_7B_IMAGES = 8
EVAL_MNT = 8
# lm_head's [SEG] column scalings under which the seed-0 weights answer
# [SEG], and so give masks, on the eval roots' prompts: a scan on the
# H100's machine (torch 2.11) found none at TINY_SEG_SCALE or SEG_SCALE_7B
# on them. At x 6, anyref_tiny's first [SEG] comes at 2-7 on 12 of 13
# prompts (the decoder's weights do not depend on the SAM size);
# anyref_7b at x 20 gives 15 of 16 refs a non-empty mask, first [SEG]s at
# 0-6, one ref with none.
EVAL_TINY_SEG_SCALE = 6.0
EVAL_SEG_SCALE_7B = 20.0
# the harnesses' metrics (cIoU, gIoU, mIoU, F), card against the CPU: a
# pixel may flip only where the CPU's logit is within SLICE_REL_TOL of 0
# (compare_eval_calls), and a flip moves an IoU by 1 / union
EVAL_METRIC_TOL = 1e-2
ADJECTIVES = ("small", "large", "dark", "bright", "striped", "old")
PLACES = ("on the left", "on the right", "in the middle", "at the back",
          "in front")


def star_polygon(rng, h: int, w: int, frac: float, x_span=None) -> list:
    """[x0, y0, x1, y1, ...]: a 12-vertex star-shaped polygon of about
    ``frac`` of an h x w image (less where it must shrink to fit), its
    center drawn inside ``x_span`` (default the whole width)."""
    lo, hi = x_span or (0, w)
    ang = np.sort(rng.uniform(0, 2 * np.pi, 12))
    rad = rng.uniform(0.75, 1.0, 12)
    x, y = np.cos(ang) * rad, np.sin(ang) * rad
    unit = 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    r = min(np.sqrt(frac * h * w / unit), 0.49 * min(h, hi - lo))
    cx = rng.uniform(lo + r, hi - r)
    cy = rng.uniform(r, h - r)
    return np.stack([cx + r * x, cy + r * y], 1).reshape(-1).tolist()


def write_image(path: str, rng, h: int, w: int) -> None:
    """Noise over a color gradient, as PNG or JPEG by the name."""
    from PIL import Image
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([255 * xx / w, 255 * yy / h, 128 + 0 * xx], -1)
    img = np.clip(base + rng.normal(0, 40, (h, w, 3)), 0, 255)
    Image.fromarray(img.astype(np.uint8)).save(path)


def write_wave(path: str, rng, seconds: float = AUDIO_SECONDS) -> None:
    import wave
    t = np.arange(int(seconds * 16000)) / 16000
    sig = 0.1 * rng.standard_normal(t.shape) + 0.3 * np.sin(
        2 * np.pi * rng.uniform(200, 800) * t)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((sig * 32767).astype(np.int16).tobytes())


def write_coco(root: str, rng, size, n_images: int, split: str) -> str:
    """COCO train2017 under ``root``: ``n_images`` JPEGs of ``size`` (h, w),
    two annotations an image, no class twice: the first a COCO-20i split-0
    class over 12-40% of the image, the second another class over 5-40%;
    image 0's second annotation has two polygons, image 1's is a compressed
    RLE. refCOCO: a ref of ``split`` for each annotation, two sentences.
    Returns the annotation file."""
    import pickle

    from anyref_tpu_torch.data import rle
    from anyref_tpu_torch.data.categories import COCO_THING_CLASSES
    from anyref_tpu_torch.data.coco20i import coco20i_split_ids
    h, w = size
    split_ids = coco20i_split_ids(0)
    others = [c for c in COCO_THING_CLASSES if c not in split_ids]
    img_dir = os.path.join(root, "coco", "train2017")
    ann_dir = os.path.join(root, "coco", "annotations")
    ref_dir = os.path.join(root, "refcoco")
    for d in (img_dir, ann_dir, ref_dir):
        os.makedirs(d)
    images, anns, refs = [], [], []
    for i in range(n_images):
        iid = i + 1
        name = f"{iid:012d}.jpg"
        write_image(os.path.join(img_dir, name), rng, h, w)
        images.append({"id": iid, "height": h, "width": w,
                       "file_name": name})
        for j, cat in enumerate((split_ids[i], others[i])):
            if j == 1 and i == 0:
                frac = rng.uniform(0.1, 0.4)
                seg = [star_polygon(rng, h, w, frac / 2, (0, w / 2)),
                       star_polygon(rng, h, w, frac / 2, (w / 2, w))]
            else:
                seg = [star_polygon(rng, h, w, rng.uniform(
                    0.12 if j == 0 else 0.05, 0.4))]
            mask = rle.annotation_to_mask(seg, h, w)
            enc = rle.encode(mask)
            if j == 1 and i == 1:
                seg = {"size": [h, w], "counts":
                       rle.counts_to_string(enc["counts"]).decode()}
            aid = len(anns) + 1
            anns.append({"id": aid, "image_id": iid, "category_id": cat,
                         "segmentation": seg, "iscrowd": 0,
                         "area": float(mask.sum()),
                         "bbox": rle.to_bbox(enc).tolist()})
            sents = [f"the {rng.choice(ADJECTIVES)} "
                     f"{COCO_THING_CLASSES[cat]} {rng.choice(PLACES)}"
                     for _ in range(2)]
            refs.append({"ref_id": aid - 1, "ann_id": aid, "image_id": iid,
                         "category_id": cat, "split": split,
                         "file_name": name,
                         "sentences": [{"sent": s, "raw": s,
                                        "tokens": s.split(),
                                        "sent_id": 2 * aid + k}
                                       for k, s in enumerate(sents)],
                         "sent_ids": [2 * aid, 2 * aid + 1]})
    coco = {"images": images, "annotations": anns,
            "categories": [{"id": c, "name": n}
                           for c, n in COCO_THING_CLASSES.items()]}
    ann_file = os.path.join(ann_dir, "instances_train2017.json")
    for path in (ann_file, os.path.join(ref_dir, "instances.json")):
        with open(path, "w") as f:
            json.dump(coco, f)
    with open(os.path.join(ref_dir, "refs(unc).p"), "wb") as f:
        pickle.dump(refs, f)
    return ann_file


def write_eval_root(root: str, size, n_images: int, seed: int = 0) -> int:
    """The four harnesses' layouts under ``root`` from ``seed`` (PIL writes
    the images, ``wave`` the audio); returns the number of refCOCO refs.

    COCO train2017 and refCOCO val (write_coco: two annotations an image, a
    ref for each, the harness reads the last of its two sentences).
    COCO-20i: the split-0 list of every image and the reference index
    (build_ref_index: one entry a class, so the loader's threads draw the
    same reference crop in any order). ReasonSeg val: two images, one
    sentence each, the first with an ignore region. AVSBench: the S4 and
    MS3 test splits, one 5-frame video each (the harness scores whole
    5-frame groups) with 5 s of audio; one MS3 frame has no object."""
    from PIL import Image

    from anyref_tpu_torch.data import rle
    from anyref_tpu_torch.data.coco import build_ref_index
    rng = np.random.default_rng(seed)
    h, w = size
    ann_file = write_coco(root, rng, size, n_images, "val")
    img_dir = os.path.join(root, "coco", "train2017")
    fss_dir = os.path.join(root, "coco_20i", "lists", "coco", "fss_list",
                           "val")
    os.makedirs(fss_dir)
    with open(os.path.join(fss_dir, "data_list_0.txt"), "w") as f:
        for i in range(n_images):
            f.write(f"COCO_train2014_{i + 1:012d}.jpg lbl\n")
    build_ref_index(img_dir, ann_file,
                    os.path.join(root, "samples_0.05_0.25.json"),
                    box_img_threshold=0.05, mask_box_threshold=0.25)

    reason = os.path.join(root, "reason", "val")
    os.makedirs(reason)
    for k in range(2):
        write_image(os.path.join(reason, f"r{k}.jpg"), rng, h, w)
        poly = np.reshape(star_polygon(rng, h, w, 0.3), (-1, 2)).tolist()
        shapes = [{"label": "target", "points": poly}]
        if k == 0:
            shapes.append({"label": "ignore", "points": np.reshape(
                star_polygon(rng, h, w, 0.05), (-1, 2)).tolist()})
        with open(os.path.join(reason, f"r{k}.json"), "w") as f:
            json.dump({"text": [f"the thing {PLACES[k]} that holds water"],
                       "is_sentence": k == 0, "shapes": shapes}, f)

    for sub, video, frames, audio, masks, csv in (
            ("Single-source", "v1",
             "s4_data/visual_frames_original_resolution/test/dog_barking/v1",
             "s4_data/audio_wav/test/dog_barking",
             "s4_data/gt_masks/test/dog_barking/v1",
             ("s4_meta_data.csv", "name,vid,category,split\n"
              "v1,1,dog_barking,test\n")),
            ("Multi-sources", "m1", "ms3_data/visual_frames/m1",
             "ms3_data/audio_wav", "ms3_data/gt_masks/m1",
             ("ms3_meta_data.csv", "name,split\nm1,test\n"))):
        base = os.path.join(root, "avsbench", sub)
        for d in (frames, audio, masks):
            os.makedirs(os.path.join(base, d))
        with open(os.path.join(base, csv[0]), "w") as f:
            f.write(csv[1])
        write_wave(os.path.join(base, audio, f"{video}.wav"), rng)
        for k in range(1, 6):
            write_image(os.path.join(base, frames, f"{video}_{k}.png"), rng,
                        h, w)
            m = np.zeros((h, w), np.uint8)
            if not (video == "m1" and k == 3):
                m = rle.annotation_to_mask(
                    [star_polygon(rng, h, w, rng.uniform(0.05, 0.4))], h, w)
            Image.fromarray(m * 255).save(
                os.path.join(base, masks, f"{video}_{k}.png"))
    return 2 * n_images


def write_avs_refine_root(root: str, size, seed: int = 0) -> int:
    """An AVSBench S4 train split for tools/convert_avs_masks.py under
    ``root``: one video of 4 ground-truth masks of ``size`` (h, w), frames
    beside the first 3 (mask 3 empty, so skipped; mask 4 has no frame, so
    skipped with a warning). Returns the masks the tool refines (2)."""
    from PIL import Image

    from anyref_tpu_torch.data import rle
    rng = np.random.default_rng(seed)
    h, w = size
    frames = os.path.join(root, "s4_data", "visual_frames_original_resolution",
                          "train", "dog_barking", "v1")
    masks = os.path.join(root, "s4_data", "gt_masks", "train", "dog_barking",
                         "v1")
    os.makedirs(frames)
    os.makedirs(masks)
    for k in range(1, 5):
        if k < 4:
            write_image(os.path.join(frames, f"v1_{k}.png"), rng, h, w)
        m = np.zeros((h, w), np.uint8)
        if k != 3:
            m = rle.annotation_to_mask(
                [star_polygon(rng, h, w, rng.uniform(0.1, 0.4))], h, w)
        Image.fromarray(m * 255).save(os.path.join(masks, f"v1_{k}.png"))
    return 2


def write_train_root(root: str, size, n_images: int, seed: int = 0) -> dict:
    """The training readers' layouts under ``root`` from ``seed`` (PIL
    writes the images); returns {layout: items}.

    COCO train2017 and refCOCO train (write_coco: two annotations an image,
    a ref for each with two sentences) and the reference index
    (build_ref_index). ADE20K training: two images of ``size``, each with
    an instance PNG (channel 0 the category, channel 1 the instance: two
    classes, the first with up to three instances, so an answer carries
    several [SEG]s, and one instance under the readers' 1% area filter)
    and a semantic PNG of two classes and one under 1%. ReasonSeg train:
    two images, two sentences each, and their answers. PhraseCut
    (VGPhraseCut_v0): two images and a train task file of three tasks, one
    of two polygon groups and one of a degenerate polygon only (a bad
    sample)."""
    from PIL import Image

    from anyref_tpu_torch.data import rle
    from anyref_tpu_torch.data.categories import ADE_INSTANCE_CLASSES
    from anyref_tpu_torch.data.coco import build_ref_index
    rng = np.random.default_rng(seed)
    h, w = size
    ann_file = write_coco(root, rng, size, n_images, "train")
    build_ref_index(os.path.join(root, "coco", "train2017"), ann_file,
                    os.path.join(root, "samples_0.05_0.25.json"),
                    box_img_threshold=0.05, mask_box_threshold=0.25)

    def blob(frac):
        return rle.annotation_to_mask([star_polygon(rng, h, w, frac)], h, w)

    ade = os.path.join(root, "ADEChallengeData2016")
    dirs = [os.path.join(ade, d, "training") for d in
            ("images", "annotations_instance", "annotations")]
    for d in dirs:
        os.makedirs(d)
    inst_classes = sorted(ADE_INSTANCE_CLASSES)
    for k in range(2):
        name = f"ADE_train_{k + 1:08d}"
        write_image(os.path.join(dirs[0], f"{name}.jpg"), rng, h, w)
        inst = np.zeros((h, w, 3), np.uint8)
        classes = rng.choice(inst_classes, 2, replace=False)
        n = 1
        for c, count in zip(classes, (int(rng.integers(2, 4)), 1)):
            for _ in range(count):
                m = blob(rng.uniform(0.04, 0.15)).astype(bool)
                inst[m, 0], inst[m, 1] = c, n
                n += 1
        m = blob(0.004).astype(bool)        # under the 1% area filter
        inst[m, 0], inst[m, 1] = classes[1], n
        Image.fromarray(inst).save(os.path.join(dirs[1], f"{name}.png"))
        sem = np.zeros((h, w), np.uint8)
        for c, frac in zip(rng.choice(np.arange(1, 151), 3, replace=False),
                           (rng.uniform(0.1, 0.3), rng.uniform(0.05, 0.2),
                            0.004)):
            sem[blob(frac).astype(bool)] = c
        Image.fromarray(sem).save(os.path.join(dirs[2], f"{name}.png"))

    reason = os.path.join(root, "reason", "train")
    os.makedirs(reason)
    for k in range(2):
        write_image(os.path.join(reason, f"t{k}.jpg"), rng, h, w)
        poly = np.reshape(star_polygon(rng, h, w, 0.25), (-1, 2)).tolist()
        with open(os.path.join(reason, f"t{k}.json"), "w") as f:
            json.dump({"text": [f"the thing {PLACES[k]} that holds water",
                                f"what keeps the rain {PLACES[k + 1]} off"],
                       "is_sentence": k == 0,
                       "shapes": [{"label": "target", "points": poly}]}, f)
    with open(os.path.join(root, "reason", "reason_answer_train.txt"),
              "w") as f:
        f.write("a bucket\nan umbrella\n")

    pc = os.path.join(root, "VGPhraseCut_v0")
    os.makedirs(os.path.join(pc, "images"))
    tasks = []
    for k, image_id in enumerate((11, 12)):
        write_image(os.path.join(pc, "images", f"{image_id}.jpg"), rng, h, w)
        groups = [[np.reshape(star_polygon(rng, h, w, 0.1), (-1, 2)).tolist()]
                  for _ in range(1 + k)]
        tasks.append({"task_id": f"t{k}", "image_id": image_id,
                      "phrase": f"{ADJECTIVES[k]} thing {PLACES[k]}",
                      "Polygons": groups})
    tasks.append({"task_id": "t2", "image_id": 11, "phrase": "a line",
                  "Polygons": [[[[1, 1], [5, 5]]]]})
    with open(os.path.join(pc, "refer_train.json"), "w") as f:
        json.dump(tasks, f)
    return {"coco": n_images, "refcoco": 2 * n_images, "ade": 2,
            "reason": 2, "phrasecut": len(tasks)}


class RecordingPredictor:
    """Hands a harness's batches to ``predictor`` and keeps each call's ids
    and mask logits, in order."""

    def __init__(self, predictor):
        self.inner = predictor
        self.cfg = predictor.cfg
        self.device = getattr(predictor, "device", None)  # the JAX one's: none
        self.calls = []

    def predict(self, batch):
        ids, masks = self.inner.predict(batch)
        self.calls.append((ids, masks))
        return ids, masks


def mask_stats(calls) -> tuple:
    """(refs with a non-empty mask, refs) over a RecordingPredictor's calls:
    a mask's pixels are those the harness scores (binary_mask)."""
    from anyref_tpu_torch.eval.runner import binary_mask
    nonempty = refs = 0
    for _, masks in calls:
        for m in masks:
            refs += 1
            if m is not None:
                nonempty += bool(binary_mask(m, *m.shape[-2:]).any())
    return nonempty, refs


def compare_eval_calls(got, want, what: str) -> int:
    """A harness's calls on the card against the CPU's: ids equal, the
    same refs with a mask, and each mask (binary_mask, as scored) differs
    only at pixels where the CPU's logit lies within SLICE_REL_TOL of its
    largest magnitude of 0. Returns the pixels that differ."""
    from anyref_tpu_torch.eval.runner import binary_mask
    if len(got) != len(want):
        fail(f"{what}: {len(got)} predict calls on the card, {len(want)} on "
             "the CPU")
    flips = 0
    for n, ((gi, gm), (wi, wm)) in enumerate(zip(got, want)):
        if not np.array_equal(gi, wi):
            fail(f"{what}, call {n}: ids {gi.tolist()} on the card, "
                 f"{wi.tolist()} on the CPU")
        for a, b in zip(gm, wm):
            if (a is None) != (b is None):
                fail(f"{what}, call {n}: a mask on one side only")
            if a is None:
                continue
            h, w = b.shape[-2:]
            diff = binary_mask(a, h, w) != binary_mask(b, h, w)
            near = np.abs(b[0]) <= SLICE_REL_TOL * np.abs(b[0]).max()
            if (diff & ~near).any():
                fail(f"{what}, call {n}: {int((diff & ~near).sum())} mask "
                     f"pixels differ where the CPU's logit is beyond "
                     f"{SLICE_REL_TOL} of its largest magnitude from 0")
            flips += int(diff.sum())
    return flips


# the rephrase weight the CLI gives each harness (tools/eval.py)
EVAL_REPHRASE = {"referseg": 0.1, "reason": 0.0, "coco20i": 0.1, "avs": 0.0}


def eval_harnesses(make, tok, data: str, out_root: str, flash=None) -> dict:
    """The four harnesses as the CLI runs them, each on its own
    RecordingPredictor ``make(rephrase_weight)``: {harness: (result,
    predict calls, kernel launches)}. With ``flash`` the launch counts are
    set to 0 just before each harness and read just after."""
    from anyref_tpu_torch.eval.harnesses import (evaluate_avs,
                                                 evaluate_coco20i,
                                                 evaluate_reason)
    from anyref_tpu_torch.eval.referseg import evaluate_referseg
    runs = {
        "referseg": lambda p: evaluate_referseg(
            p, tok, data, "refcoco_val", out_root)["refcoco_val"],
        "reason": lambda p: evaluate_reason(p, tok, data, out_root),
        "coco20i": lambda p: evaluate_coco20i(p, tok, data, out_root,
                                              splits=(0,))[0],
        "avs": lambda p: evaluate_avs(p, tok, data, "object", "test",
                                      out_root),
    }
    out = {}
    for name, run in runs.items():
        predictor = make(EVAL_REPHRASE[name])
        if flash:
            zero_launches(flash)
        result = run(predictor)
        launches = read_launches(flash) if flash else {}
        out[name] = (result, predictor.calls, launches)
    return out


def eval_tiny(torch, flash, mods, tiny, tiny512) -> None:
    """Phase 7(a): the four harnesses (eval_harnesses) at anyref_tiny on
    "unfused" and at its 512-pixel SAM variant on "fused", bf16 weights from
    seed 0 with lm_head's [SEG] column x EVAL_TINY_SEG_SCALE, on the card and
    on the CPU plain path: the calls compared (compare_eval_calls), the metrics
    within EVAL_METRIC_TOL, n equal, a non-empty mask in every harness, each
    kernel's launches those of a served batch a predict call (CLIP twice in a
    COCO-20i batch, which carries a crop); then the CLI in a subprocess on the
    "unfused" weights saved with save_params, which must print the in-process
    referseg result."""
    import tempfile

    from anyref_tpu_torch import checkpoint
    from anyref_tpu_torch.eval.runner import Predictor
    tok = mods["AnyRefTokenizer"]()
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        n_refs = write_eval_root(data, EVAL_TINY_SIZE, EVAL_TINY_IMAGES)
        log(f"[eval-tiny] data root: {n_refs} refCOCO refs on "
            f"{EVAL_TINY_IMAGES} images of {EVAL_TINY_SIZE}, 2 ReasonSeg "
            f"images, COCO-20i split 0 ({EVAL_TINY_IMAGES} queries), AVS S4 "
            f"and MS3 (one 5-frame video each)")
        for path, cfg in (("unfused", tiny), ("fused", tiny512)):
            p_cpu = mods["tparams"].init(cfg, torch.Generator().manual_seed(0),
                                         torch.bfloat16, device="cpu")
            p_cpu["llama"]["lm_head"][:, cfg.tokens.seg] *= \
                EVAL_TINY_SEG_SCALE
            per_batch = launches_per_batch(flash, cfg)[path]
            runs = {}
            p_gpu = _to_device(p_cpu, "cuda")
            for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
                def make(weight, p=p, dev=dev):
                    return RecordingPredictor(Predictor(
                        p, cfg.scaled(rephrase_weight=weight),
                        max_new_tokens=EVAL_MNT, device=dev,
                        encoder_path=path))
                t0 = time.time()
                runs[dev] = eval_harnesses(
                    make, tok, data, os.path.join(tmp, f"{path}-{dev}"),
                    flash if dev == "cuda" else None)
                log(f"[eval-tiny] {path}, {dev}: the four harnesses in "
                    f"{time.time() - t0:.1f} s")
            for name, (got, calls, launches) in runs["cuda"].items():
                want, want_calls, _ = runs["cpu"][name]
                what = f"eval {name} ({path}, SAM {cfg.sam.image_size} px)"
                flips = compare_eval_calls(calls, want_calls, what)
                deltas = {k: abs(got[k] - want[k]) for k in got if k != "n"}
                nonempty, refs = mask_stats(calls)
                crop = 2 if name == "coco20i" else 1
                want_launches = {
                    k: n * len(calls) * (crop if k == "flash_attention_qkv"
                                         else 1)
                    for k, n in per_batch.items()}
                log(f"[eval-tiny] {what}: card {got}, CPU {want}; "
                    f"{nonempty} of {refs} refs with a non-empty mask, "
                    f"{flips} mask pixels differ; launches "
                    f"{json.dumps({k: v for k, v in launches.items() if v})}")
                if got["n"] != want["n"] or \
                        max(deltas.values()) > EVAL_METRIC_TOL:
                    fail(f"{what}: card {got}, CPU {want} (limit "
                         f"{EVAL_METRIC_TOL})")
                if not nonempty:
                    fail(f"{what}: no ref has a non-empty mask, so the "
                         f"comparison is of empty masks")
                if launches != want_launches:
                    fail(f"{what}: launches {launches}, want {want_launches}")
            if path == "unfused":
                eval_cli(checkpoint, p_cpu, data, tmp,
                         runs["cuda"]["referseg"][0])


def eval_cli(checkpoint, params, data: str, tmp: str, want: dict) -> None:
    """The eval CLI in a subprocess on ``params`` saved with save_params
    (preset tiny, "unfused", the CLI's referseg defaults): it must print
    ``want``, the in-process result."""
    ckpt = os.path.join(tmp, "tiny.pt")
    checkpoint.save_params(ckpt, params)
    cmd = [sys.executable, "-m", "anyref_tpu_torch.tools.eval", "referseg",
           "--ckpt", ckpt, "--data_root", data,
           "--out_root", os.path.join(tmp, "cli"), "--preset", "tiny",
           "--device", "cuda", "--encoder_path", "unfused",
           "--max_new_tokens", str(EVAL_MNT)]
    t0 = time.time()
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=ROOT), timeout=600)
    printed = repr({"refcoco_val": want})
    if r.returncode != 0 or printed not in r.stdout.splitlines():
        fail(f"eval CLI (exit {r.returncode}) did not print {printed}:\n"
             f"{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
    log(f"[eval-tiny] CLI `python -m anyref_tpu_torch.tools.eval referseg "
        f"--preset tiny --device cuda --encoder_path unfused` on the saved "
        f"weights: {time.time() - t0:.1f} s (process included), printed "
        f"the in-process result {printed}")


# profiled_span's kernels before its first marker and after its last: late
# in a long process a session loses its first few device records (9 in
# phase 7(b), the first marker among them), never a marker well inside
SPAN_PAD_KERNELS = 256


def profiled_span(torch, fn, flash=None):
    """(fn's wall s, device records, their device ms, the s from the end of
    the session to the records read) of one call of fn under
    torch.profiler, the records read between the marker kernels
    before and after it (profiled_counts' rule); None where a session lost
    a marker COUNT_SESSIONS times. The records are read from the
    profiler's raw results: building its event objects for the ~10^6
    records of a pass of 8 decode steps a ref takes minutes. With
    ``flash``, the device ms are None (and the reason logged) where the
    span's records of the loop's condition kernel are not the card's
    count of its runs (loop_records_lost's rule)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(COUNT_SESSIONS):
        pad = torch.zeros(1, device="cuda")
        mark = None if flash is None else launch_mark(flash,
                                                      "loop_condition")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(SPAN_PAD_KERNELS):
                pad.add_(1)
            torch.cuda.synchronize()
            time.sleep(0.1)
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            wall = time.time() - t0
            torch.cuda._sleep(MARKER_CYCLES)
            for _ in range(SPAN_PAD_KERNELS):
                pad.add_(1)
            torch.cuda.synchronize()
            t_end = time.time()
        records = sorted((e for e in prof.profiler.kineto_results.events()
                          if e.device_type() == cuda),
                         key=lambda e: e.start_ns())
        marks = [i for i, e in enumerate(records) if MARKER in e.name()]
        if len(marks) == 2:
            span = records[marks[0] + 1:marks[1]]
            busy = sum(e.duration_ns() for e in span) / 1e6
            if mark is not None:
                ran = int(launch_mark(flash, "loop_condition") - mark)
                kept = sum(1 for e in span
                           if "anyref_loop_condition" in e.name())
                if kept != ran:
                    log(f"[profiler] busy not measured: the span holds "
                        f"{kept} records of the loop's condition kernel, "
                        f"the card counted {ran} runs")
                    busy = None
            return wall, len(span), busy, time.time() - t_end
        log(f"[profiler] a session kept {len(records)} device records and "
            f"{len(marks)} of its 2 marker kernels, at {marks}; the first "
            f"records {[e.name()[:40] for e in records[:3]]}, the last "
            f"{[e.name()[:40] for e in records[-3:]]}")
    return None


def eval_7b(torch, flash, mods, params, cfg, seg_col, per_batch) -> dict:
    """Phase 7(b), run on phase 4's weights before the int8 decoder replaces
    their bf16 one: lm_head's [SEG] column at EVAL_SEG_SCALE_7B x its drawn
    values, evaluate_referseg on "fused" at rephrase 0.1 (the CLI's referseg
    default), EVAL_MNT new tokens, over a refCOCO val split of 16 refs on 8
    COCO-sized images (write_eval_root): refs/s and the wall split (loader
    wait, predict, host scoring), launches per ref those of a served batch, n,
    both metrics in [0, 1], a non-empty mask, result.txt; then the same pass
    warm under torch.profiler (busy and idle, kernels per ref between marker
    kernels). The column is put back to 1000 x its values. Returns the counted
    pass's launches."""
    import tempfile

    from anyref_tpu_torch.data import rle
    from anyref_tpu_torch.eval.referseg import evaluate_referseg
    from anyref_tpu_torch.eval.runner import Predictor
    lm = params["llama"]["lm_head"]
    lm[:, cfg.tokens.seg] = seg_col * EVAL_SEG_SCALE_7B
    rcfg = cfg.scaled(rephrase_weight=0.1)
    tok = mods["AnyRefTokenizer"]()
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        t0 = time.time()
        n_refs = write_eval_root(data, EVAL_7B_SIZE, EVAL_7B_IMAGES)
        log(f"[eval-7b] data root: {n_refs} refCOCO val refs on "
            f"{EVAL_7B_IMAGES} JPEGs of {EVAL_7B_SIZE[1]} x {EVAL_7B_SIZE[0]} "
            f"in {time.time() - t0:.1f} s (polygons of 5-40% of an image, "
            f"one of two parts, one compressed RLE); rle.native() = "
            f"{rle.native()}")

        def run(out):
            pred = RecordingPredictor(Predictor(
                params, rcfg, max_new_tokens=EVAL_MNT, encoder_path="fused"))
            timings = {}
            res = evaluate_referseg(pred, tok, data, "refcoco_val",
                                    os.path.join(tmp, out),
                                    timings=timings)["refcoco_val"]
            return res, pred, timings

        zero_launches(flash)
        t0 = time.time()
        res, pred, timings = run("counted")
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_launches(flash)
        nonempty, refs = mask_stats(pred.calls)
        want = {k: n * len(pred.calls) for k, n in per_batch.items()}
        result_txt = os.path.join(tmp, "counted", "refcoco", "val",
                                  "result.txt")
        ids = [row.tolist() for ids, _ in pred.calls for row in ids]
        log(f"[eval-7b] anyref_7b, fused, rephrase 0.1, lm_head[:, "
            f"tokens.seg] x {EVAL_SEG_SCALE_7B}, {EVAL_MNT} new tokens: "
            f"{res}; "
            f"{refs / wall:.3f} refs/s ({wall:.2f} s wall: loader wait "
            f"{timings['loader_s']:.3f} s, predict {timings['predict_s']:.3f}"
            f" s, host scoring {timings['score_s']:.3f} s); {nonempty} of "
            f"{refs} refs with a non-empty mask; {mods['card']}")
        log(f"[eval-7b] ids {ids}")
        log(f"[eval-7b] launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})} "
            f"({len(pred.calls)} predict calls)")
        if res["n"] != n_refs or refs != n_refs or not (
                0 <= res["ciou"] <= 1 and 0 <= res["giou"] <= 1):
            fail(f"eval at anyref_7b: {res} over {refs} refs, want n = "
                 f"{n_refs} and both metrics in [0, 1]")
        if not nonempty:
            fail("eval at anyref_7b: no ref has a non-empty mask")
        if not os.path.exists(result_txt):
            fail(f"eval at anyref_7b: no {result_txt}")
        if launches != want:
            fail(f"eval at anyref_7b: launches {launches}, want {want}")

        warm = {}
        span = profiled_span(torch, lambda: warm.update(zip(
            ("res", "pred", "timings"), run("profiled"))), flash)
        if span is None:
            fail("eval at anyref_7b: the profiler lost a marker kernel "
                 f"{COUNT_SESSIONS} times")
        pwall, n_kernels, busy, read_s = span
        busy_s = ("not measured" if busy is None else
                  f"{busy:.3f} ms -> device idle "
                  f"{100 * (1 - busy / 1e3 / pwall):.1f}%")
        t = warm["timings"]
        log(f"[eval-7b] the same pass warm under torch.profiler: "
            f"{pwall:.3f} s wall -> {n_refs / pwall:.3f} refs/s (loader wait"
            f" {t['loader_s']:.3f} s, predict {t['predict_s']:.3f} s, host "
            f"scoring {t['score_s']:.3f} s); kernels busy {busy_s}; "
            f"{n_kernels} device records between the markers, "
            f"{n_kernels / n_refs:.1f} a ref, read {read_s:.1f} s after the "
            f"session; {warm['res']}")
        if warm["res"] != res:
            fail(f"eval at anyref_7b: the warm pass gave {warm['res']}, the "
                 f"first {res}")
    lm[:, cfg.tokens.seg] = seg_col * 1000.0
    return launches


# ---------------------------------------------------------------------------
# phase 8: training from the reference's datasets, the region-caption eval
# ---------------------------------------------------------------------------
# the registry's mix of every kind of training sample the slice runs: text
# refs, COCO classes, ADE20K instances (several [SEG]s) and classes,
# ReasonSeg, and the inverse task's crops
TRAIN_MIX = ("refer_seg_refcoco,coco_instance,ade_instance,ade_semantic,"
             "reason,refer_seg_inv_refcoco")
# (b): COCO-sized images (write_train_root), 4 of them with 8 refCOCO refs
TRAIN_7B_IMAGES = 4
# the inverse eval: greedy new tokens, and refs of each kind at anyref_7b
INV_MNT = 16
INV_REFS = 8


def record_steps(trainer) -> list:
    """Wraps ``trainer.step_fn``; the returned list gains, for each step,
    a host copy of the batch it was given and its metrics as floats."""
    steps = []
    inner = trainer.step_fn

    def step_fn(state, frozen, batch):
        kept = {k: np.array(v, copy=True) for k, v in batch.items()}
        state, metrics = inner(state, frozen, batch)
        steps.append((kept, {k: float(v) for k, v in metrics.items()}))
        return state, metrics
    trainer.step_fn = step_fn
    return steps


def replay_on_cpu(torch, mods, cfg, tc, params, steps) -> list:
    """The recorded batches through make_train_step on the CPU, from the
    state the Trainer starts from (the same seed, the LoRA draw made on the
    CPU in both): each step's metrics."""
    step, lora = mods["step"], mods["lora"]
    lcfg = lora.LoraConfig()
    opt = step.make_optimizer(lr=tc.learning_rate, warmup=tc.warmup_steps,
                              total_steps=tc.max_steps)
    state, frozen = step.init_state(torch.Generator().manual_seed(tc.seed),
                                    params, lcfg, opt)
    fn = step.make_train_step(cfg, lcfg, opt, remat=tc.remat,
                              grad_accum=tc.grad_accum_steps,
                              encoder_path=tc.encoder_path)
    out = []
    for batch, _ in steps:
        state, m = fn(state, frozen, batch)
        out.append({k: float(v) for k, v in m.items()})
    return out


def train_tiny_from_disk(torch, mods, cfg, data: str, out: str, what: str,
                         n_steps: int, **kw) -> list:
    """Phase 8(a), training: Trainer(dataset=None) at ``cfg`` on the card
    (bf16 weights from seed 0, remat, "fused", batch 2 x 2 micro-steps,
    ``n_steps`` steps, warmup 1) builds the registry's mix from ``kw``
    (train_datasets, roi, no_mask) under ``data``; its batches are recorded
    and replayed through make_train_step on the CPU: every loss term of
    every step within SLICE_REL_TOL of the CPU's (check_tiny_train's
    limit). Returns the recorded steps."""
    p_cpu = mods["tparams"].init(cfg, torch.Generator().manual_seed(0),
                                 torch.bfloat16, device="cpu")
    tc = mods["TrainConfig"](
        data_root=data, output_dir=out, per_device_batch_size=2,
        grad_accum_steps=2, max_steps=n_steps, warmup_steps=1,
        save_steps=10 ** 9, log_steps=1, resume=False, remat=True,
        encoder_path="fused", **kw)
    trainer = mods["Trainer"](cfg, tc, _to_device(p_cpu, "cuda"))
    datasets = getattr(trainer.loader.dataset, "datasets",
                       [trainer.loader.dataset])
    lengths = {type(d).__name__: len(d) for d in datasets}
    steps = record_steps(trainer)
    trainer.train()
    torch.cuda.synchronize()
    cpu = replay_on_cpu(torch, mods, cfg, tc, p_cpu, steps)
    worst = 0.0
    for (_, m_gpu), m_cpu in zip(steps, cpu):
        for k, v in m_cpu.items():
            if not np.isfinite(m_gpu[k]):
                fail(f"{what}: non-finite {k} on the card: {m_gpu}")
            worst = max(worst, abs(m_gpu[k] - v) / max(abs(v), 1e-6))
    refs = [(sorted(k for k in b if k in ("ref_images", "roi_boxes")),
             int(b["ref_valid"].sum()) if "ref_valid" in b else 0,
             int(b["mask_valid"].sum())) for b, _ in steps]
    log(f"[train-disk] {what}: registry {json.dumps(lengths)}; {n_steps} "
        f"steps of {tc.grad_accum_steps} micro-batches of "
        f"{tc.per_device_batch_size}, (references, valid rows, masks) a "
        f"step {refs}; card {[m for _, m in steps]}, CPU on the recorded "
        f"batches {cpu}; worst loss-term rel err {worst:.4g} (limit "
        f"{SLICE_REL_TOL})")
    if len(steps) != n_steps or worst > SLICE_REL_TOL:
        fail(f"{what}: the card's step disagrees with the CPU's on the same "
             f"batch ({len(steps)} steps, worst rel err {worst})")
    return steps


def same_result(a: dict, b: dict) -> bool:
    """Equal result dicts, a NaN equal to a NaN."""
    def same(x, y):
        return x == y or (isinstance(x, float) and isinstance(y, float)
                          and np.isnan(x) and np.isnan(y))
    return set(a) == set(b) and all(same(a[k], b[k]) for k in a)


# the tiny inverse eval on the CPU follows the card's greedy ids: where
# the CPU would pick another token, its largest logit may exceed the logit
# of the card's pick by at most this share of the step's largest magnitude
# (a near tie, which the two devices' bf16 roundings break apart)
INV_LOGIT_TOL = 1e-2


class FollowIds:
    """Stands in for llama.logits while the CPU predicts: each call keeps
    the CPU's logits and lifts the card's token of that step (``ids`` of the
    current predict call, set by ``start``) to the top, so the CPU's greedy
    decode emits the card's ids. ``gaps`` gains, for each step of a row not
    yet ended, the CPU's largest logit less the card's pick's, over the
    step's largest magnitude (0 where both pick the same token)."""

    def __init__(self, torch, real):
        self.torch, self.real = torch, real
        self.gaps = []
        self.ids = None
        self.step = 0

    def start(self, ids):
        self.ids = self.torch.as_tensor(ids).long()
        self.step = 0

    def __call__(self, params, hidden, group=None):
        out = self.real(params, hidden, group)
        j = self.step
        self.step += 1
        B, mnt = self.ids.shape
        if j >= mnt:
            return out
        tgt = self.ids[:, j]
        tgt = self.torch.cat([tgt, tgt[:1].expand(out.shape[0] - B)])
        top = out.max(-1).values
        rows = self.torch.arange(out.shape[0])
        live = (self.ids[:, :j] != 2).all(1)
        scale = out.abs().max(-1).values
        for b in range(B):
            if live[b]:
                self.gaps.append(float((top[b] - out[b, tgt[b]]) / scale[b]))
        out = out.clone()
        out[rows, tgt] = top + 1.0
        return out


def inverse_tiny(torch, flash, mods, cfg, data: str, tmp: str) -> None:
    """Phase 8(a), the region-caption eval: evaluate_refer_inverse over
    refCOCO val (write_eval_root) on "unfused" at ``cfg``, crops and then
    boxes, on the card, then on the CPU from the same seeded bf16 weights
    following the card's greedy ids (FollowIds): the CPU's own pick agrees
    with the card's, or lies within INV_LOGIT_TOL of it; the result dicts
    are equal, the masks as compare_eval_calls holds them; each kernel's
    launches on the card those of a served batch a predict call."""
    from anyref_tpu_torch.eval.harnesses import evaluate_refer_inverse
    from anyref_tpu_torch.eval.runner import Predictor
    from anyref_tpu_torch.models import llama
    tok = mods["AnyRefTokenizer"]()
    p_cpu = mods["tparams"].init(cfg, torch.Generator().manual_seed(0),
                                 torch.bfloat16, device="cpu")
    p_gpu = _to_device(p_cpu, "cuda")
    per_batch = launches_per_batch(flash, cfg)["unfused"]
    rcfg = cfg.scaled(rephrase_weight=0.0)
    for roi in (False, True):
        card = RecordingPredictor(Predictor(
            p_gpu, rcfg, max_new_tokens=EVAL_MNT, encoder_path="unfused"))
        zero_launches(flash)
        got = evaluate_refer_inverse(card, tok, data, "refcoco", "val",
                                     roi=roi, out_root=os.path.join(
                                         tmp, "inv-cuda"))
        launches = read_launches(flash)
        follow = FollowIds(torch, llama.logits)
        cpu = RecordingPredictor(Predictor(
            p_cpu, rcfg, max_new_tokens=EVAL_MNT, device="cpu",
            encoder_path="unfused"))
        ids = iter([i for i, _ in card.calls])
        inner = cpu.predict

        def predict(batch):
            follow.start(next(ids))
            return inner(batch)
        cpu.predict = predict
        llama.logits = follow
        try:
            want = evaluate_refer_inverse(cpu, tok, data, "refcoco", "val",
                                          roi=roi, out_root=os.path.join(
                                              tmp, "inv-cpu"))
        finally:
            llama.logits = follow.real
        what = f"inverse eval (roi={roi}, unfused, anyref_tiny)"
        compare_eval_calls(card.calls, cpu.calls, what)
        want_launches = {k: n * len(card.calls) for k, n in per_batch.items()}
        apart = [g for g in follow.gaps if g > 0]
        log(f"[inv-tiny] {what}: card {got}, CPU following the card's ids "
            f"{want}; the CPU's own pick is the card's at "
            f"{len(follow.gaps) - len(apart)} of {len(follow.gaps)} steps, "
            f"elsewhere its top logit lies {sorted(apart)} of the step's "
            f"largest magnitude above the card's pick (limit "
            f"{INV_LOGIT_TOL}); launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})}")
        if not same_result(got, want) or got["n"] != len(card.calls) or \
                not got["n"] or max(follow.gaps) > INV_LOGIT_TOL:
            fail(f"{what}: card {got}, CPU {want}, gaps {follow.gaps}")
        if launches != want_launches:
            fail(f"{what}: launches {launches}, want {want_launches}")


def train_cli_tiny(torch, mods, data: str, tmp: str) -> None:
    """Phase 8(a), the training CLI: tiny artifacts in the reference's
    layouts (reference_state_dicts: a merged LLaVA .safetensors, a SAM
    .pth), then `python -m anyref_tpu_torch.tools.train --preset tiny
    --device cuda` in a subprocess, one step on refer_seg_refcoco: exit 0,
    and a merged.pt that load_params reads, equal leaf for leaf to
    assemble_pretrained of the same artifacts on the CPU (the first step's
    learning rate is 0, so neither the LoRA nor a dense weight moved)."""
    from anyref_tpu_torch import checkpoint
    tiny = mods["anyref_tiny"]()
    g = torch.Generator().manual_seed(11)

    def rand(*shape, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g) * 0.02).to(dtype)

    sds = reference_state_dicts(tiny, rand)
    llava = os.path.join(tmp, "llava")
    os.makedirs(llava)
    write_safetensors(torch, os.path.join(llava, "model.safetensors"),
                      merged_llava(sds))
    sam_pth = os.path.join(tmp, "sam.pth")
    torch.save({k: v.float() for k, v in sds["sam"].items()}, sam_pth)
    out = os.path.join(tmp, "train-cli")
    cmd = [sys.executable, "-m", "anyref_tpu_torch.tools.train",
           "--preset", "tiny", "--device", "cuda",
           "--train_datasets", "refer_seg_refcoco", "--data_root", data,
           "--output_dir", out, "--max_steps", "1", "--grad_accum_steps",
           "1", "--per_device_batch_size", "1", "--save_steps", "1",
           "--warmup_steps", "1", "--llava_dir", llava, "--sam_ckpt",
           sam_pth, "--imagebind_ckpt", os.path.join(tmp, "none.pth")]
    t0 = time.time()
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=ROOT), timeout=600)
    merged = os.path.join(out, "merged.pt")
    if r.returncode or f"wrote {merged}" not in r.stdout.splitlines():
        fail(f"training CLI (exit {r.returncode}):\n{r.stdout[-2000:]}\n"
             f"{r.stderr[-2000:]}")
    t_cli = time.time() - t0
    got = checkpoint.load_params(merged, device="cpu")
    want = checkpoint.assemble_pretrained(
        tiny.scaled(rephrase_weight=0.0, audio=None), llava_dir=llava,
        sam_ckpt=sam_pth, device="cpu")
    n = check_same_tree(torch, got, want, "the training CLI's merged.pt vs "
                        "assemble_pretrained on the CPU")
    log(f"[train-cli] `python -m anyref_tpu_torch.tools.train --preset tiny "
        f"--device cuda` on tiny reference artifacts: {t_cli:.1f} s "
        f"(process included), printed {r.stdout.splitlines()[-1]!r}; "
        f"merged.pt: {n} leaves equal to the assembly (step 1's learning "
        f"rate is 0)")


def phase8_tiny(torch, flash, mods, tiny) -> None:
    """Phase 8(a) at anyref_tiny: write_train_root and write_eval_root in a
    temporary directory, the Trainer from disk on TRAIN_MIX and on the
    inverse task's boxes without masks (roi, no_mask), card against the CPU
    on the recorded batches; the inverse eval card against the CPU; the
    training CLI."""
    import tempfile
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "train")
        sizes = write_train_root(data, EVAL_TINY_SIZE, EVAL_TINY_IMAGES)
        log(f"[train-disk] training root at {EVAL_TINY_SIZE}: "
            f"{json.dumps(sizes)}")
        steps = train_tiny_from_disk(torch, mods, tiny, data,
                                     os.path.join(tmp, "mix"), "the mix", 2,
                                     train_datasets=TRAIN_MIX)
        if not all(b["mask_valid"].any() for b, _ in steps):
            fail("a step of the mix has no mask")
        steps = train_tiny_from_disk(
            torch, mods, tiny, data, os.path.join(tmp, "roi"),
            "refer_seg_inv_refcoco, roi, no_mask", 1,
            train_datasets="refer_seg_inv_refcoco", roi=True, no_mask=True)
        batch = steps[0][0]
        if "roi_boxes" not in batch or "ref_images" in batch or \
                not batch["ref_valid"].all() or batch["mask_valid"].any():
            fail(f"roi, no_mask: batch keys {sorted(batch)}, ref_valid "
                 f"{batch.get('ref_valid')}, mask_valid "
                 f"{batch['mask_valid']}")
        ev = os.path.join(tmp, "eval")
        write_eval_root(ev, EVAL_TINY_SIZE, EVAL_TINY_IMAGES)
        inverse_tiny(torch, flash, mods, tiny, ev, tmp)
        train_cli_tiny(torch, mods, data, tmp)
    log(f"[phase 8] (a) in {time.time() - t0:.1f} s")


def fingerprint(t) -> tuple:
    """A frozen leaf's fingerprint: its sum and its sum of magnitudes in
    fp64."""
    d = t.detach().double()
    return (d.sum().item(), d.abs().sum().item())


def train_7b_from_disk(torch, flash, mods) -> dict:
    """Phase 8(b), training: Trainer(dataset=None) at anyref_7b on random
    bf16 weights from seed 0, TRAIN_MIX from write_train_root's COCO-sized
    JPEGs, "fused", batch 2 x 2 micro-steps, 2 optimizer steps, warmup 1,
    remat. Checks the losses finite, the LoRA weights moved and the frozen
    ones not (fp64 fingerprints), metrics.jsonl, and each kernel's
    launches against what the recorded batches imply (CLIP twice a
    micro-step in a step whose batch carries crops); prints the step wall,
    the peak memory, the registry's lengths and the crop rows."""
    import tempfile
    t_phase = time.time()
    cfg = mods["anyref_7b"]()
    step = mods["step"]
    params = mods["tparams"].init(
        cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "train")
        t0 = time.time()
        sizes = write_train_root(data, EVAL_7B_SIZE, TRAIN_7B_IMAGES)
        log(f"[train-disk-7b] training root of {EVAL_7B_SIZE[1]} x "
            f"{EVAL_7B_SIZE[0]} JPEGs in {time.time() - t0:.1f} s: "
            f"{json.dumps(sizes)}")
        out = os.path.join(tmp, "out")
        tc = mods["TrainConfig"](
            train_datasets=TRAIN_MIX, data_root=data, output_dir=out,
            per_device_batch_size=2, grad_accum_steps=2, max_steps=2,
            warmup_steps=1, save_steps=10 ** 9, log_steps=1, resume=False,
            remat=True, encoder_path="fused")
        trainer = mods["Trainer"](cfg, tc, params)
        lengths = [(type(d).__name__, len(d))
                   for d in trainer.loader.dataset.datasets]
        frozen = [fingerprint(t) for t in step.tree_leaves(trainer.frozen)]
        lora0 = [t.detach().clone()
                 for t in step.tree_leaves(trainer.state.lora)]
        steps = record_steps(trainer)
        zero_launches(flash)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        state = trainer.train()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_launches(flash)
        backward = flash.launch_counts()[
            "flash_causal_attention_diff_backward"]
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(out, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]

    if state.step != 2 or [r["step"] for r in recs] != [1, 2]:
        fail(f"trainer from disk ended at step {state.step}, logged "
             f"{[r['step'] for r in recs]}")
    if not all(np.isfinite(r[k]) for r in recs for k in step.METRICS):
        fail(f"trainer from disk: non-finite losses {recs}")
    if all(torch.equal(a.detach(), b) for a, b in
           zip(step.tree_leaves(state.lora), lora0)):
        fail("trainer from disk: the LoRA weights did not move")
    if [fingerprint(t) for t in step.tree_leaves(trainer.frozen)] != frozen:
        fail("trainer from disk: a frozen weight changed")
    s, l, c = cfg.sam, cfg.llama, cfg.clip
    n_global = len(s.encoder_global_attn_indexes)
    n_clip = c.num_layers + c.select_layer + 1
    want = dict.fromkeys(launches, 0)
    crops = 0
    for batch, _ in steps:
        clip_passes = 2 if "ref_images" in batch else 1
        crops += int(batch["ref_valid"].sum()) if "ref_valid" in batch else 0
        for k, n in (("flash_causal_attention_diff", 2 * l.num_layers),
                     ("fused_window_attn", s.encoder_depth - n_global),
                     ("fused_mlp_stream", s.encoder_depth - n_global),
                     ("fused_global_tail", n_global),
                     ("layer_norm_fused", n_global),
                     ("flash_attention_qkv", n_clip * clip_passes)):
            want[k] += n * tc.grad_accum_steps
    micro = tc.max_steps * tc.grad_accum_steps
    if launches != want or backward != l.num_layers * micro:
        fail(f"trainer from disk: launches {launches}, backward {backward};"
             f" want {want}, backward {l.num_layers * micro}")
    text = [int((b["labels"] != -100).sum(-1).max()) for b, _ in steps]
    longest = max(int((b["input_ids"] != 0).sum(-1).max()) for b, _ in steps)
    step_s = [1.0 / r["steps_per_s"] for r in recs]
    log(f"[train-disk-7b] anyref_7b LoRA from disk, registry {lengths}, "
        f"batch {tc.per_device_batch_size} x {tc.grad_accum_steps} "
        f"micro-steps, L {cfg.max_seq_len}, remat, fused: {tc.max_steps} "
        f"steps in {wall:.2f} s, step wall {[round(t, 4) for t in step_s]}"
        f" s, peak memory allocated {peak / 2**30:.2f} GiB; {crops} crop "
        f"rows; longest conversation {longest} of {cfg.max_text_len} "
        f"tokens, answer tokens at most {max(text)} a row; losses "
        + "; ".join(f"step {r['step']}: loss {r['loss']:.4f} lm "
                    f"{r['lm_loss']:.4f} bce {r['bce_loss']:.4f} dice "
                    f"{r['dice_loss']:.4f}" for r in recs)
        + f"; {mods['card']}")
    ref_keys = [sorted(k for k in b if k.startswith("ref"))
                for b, _ in steps]
    log(f"[train-disk-7b] launches {json.dumps(launches)}, "
        f"flash_causal_attention_diff backward {backward} (the recorded "
        f"batches' reference keys: {ref_keys})")
    del trainer, state, params
    torch.cuda.empty_cache()
    log(f"[phase 8] (b) training in {time.time() - t_phase:.1f} s")
    return {"steps": 2, "wall_s": wall, "peak_gib": peak / 2**30}


def eval_inverse_7b(torch, flash, mods, params, cfg, seg_col,
                    per_batch) -> dict:
    """Phase 8(b), the region-caption eval, run in phase 4 on its weights
    before the int8 decoder replaces their bf16 one, with lm_head's [SEG]
    column at its drawn values: evaluate_refer_inverse on "fused", greedy,
    INV_MNT new tokens, rephrase 0 (the CLI's refer_inv default), over
    refCOCO val of write_eval_root's 8 COCO-sized JPEGs: INV_REFS refs with
    crops, then INV_REFS with boxes. Checks n, BLEU-4 and CIDEr-D finite in
    [0, 10], METEOR and SPICE NaN exactly where nltk is missing, two lines
    in inv_result.txt, and the launches a ref (flash_attention_qkv 2 x
    CLIP's layers with a crop); prints refs/s and the wall split. The
    column is put back to 1000 x its values. Returns the crop pass's
    launches."""
    import importlib.util
    import tempfile

    from anyref_tpu_torch.eval.harnesses import evaluate_refer_inverse
    from anyref_tpu_torch.eval.runner import Predictor
    t_phase = time.time()
    lm = params["llama"]["lm_head"]
    lm[:, cfg.tokens.seg] = seg_col
    rcfg = cfg.scaled(rephrase_weight=0.0)
    tok = mods["AnyRefTokenizer"]()
    has_nltk = importlib.util.find_spec("nltk") is not None
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        write_eval_root(data, EVAL_7B_SIZE, EVAL_7B_IMAGES)
        out_root = os.path.join(tmp, "out")
        for roi in (False, True):
            pred = RecordingPredictor(Predictor(
                params, rcfg, max_new_tokens=INV_MNT, encoder_path="fused"))
            zero_launches(flash)
            timings = {}
            t0 = time.time()
            res = evaluate_refer_inverse(pred, tok, data, "refcoco", "val",
                                         roi=roi, out_root=out_root,
                                         limit=INV_REFS, timings=timings)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = read_launches(flash)
            kind = "boxes" if roi else "crops"
            want = {k: n * len(pred.calls) * (
                2 if k == "flash_attention_qkv" and not roi else 1)
                for k, n in per_batch.items()}
            caps = [tok.decode([t for t in ids[0].tolist() if t != 2],
                               skip_special=True) for ids, _ in pred.calls]
            log(f"[inv-7b] anyref_7b, fused, greedy, {INV_MNT} new tokens, "
                f"{INV_REFS} refs with {kind}: {res}; "
                f"{res['n'] / wall:.3f} refs/s ({wall:.2f} s wall: loader "
                f"wait {timings['loader_s']:.3f} s, predict "
                f"{timings['predict_s']:.3f} s, decoding and scoring "
                f"{timings['score_s']:.3f} s); nltk "
                f"{'present' if has_nltk else 'absent'}; {mods['card']}")
            log(f"[inv-7b] {kind}: captions {caps[:3]}... (ids "
                f"{pred.calls[0][0][0].tolist()}); launches "
                f"{json.dumps({k: v for k, v in launches.items() if v})}")
            nan = [np.isnan(res[k]) for k in ("meteor", "spice")]
            if res["n"] != INV_REFS or len(pred.calls) != INV_REFS or not \
                    all(np.isfinite(res[k]) and 0 <= res[k] <= 10
                        for k in ("bleu4", "cider")) or \
                    nan != [not has_nltk] * 2:
                fail(f"inverse eval at anyref_7b ({kind}): {res}, "
                     f"{len(pred.calls)} predict calls, nltk {has_nltk}")
            if launches != want:
                fail(f"inverse eval at anyref_7b ({kind}): launches "
                     f"{launches}, want {want}")
            out[kind] = launches
        with open(os.path.join(out_root, "refcoco", "val",
                               "inv_result.txt")) as f:
            lines = f.read().splitlines()
        if len(lines) != 2:
            fail(f"inverse eval at anyref_7b: inv_result.txt holds {lines}")
    lm[:, cfg.tokens.seg] = seg_col * 1000.0
    log(f"[phase 8] (b) inverse eval in {time.time() - t_phase:.1f} s")
    return out["crops"]


# ---------------------------------------------------------------------------
# phase 9: SAM alone (SamPredictor, the automatic mask generator, the
# exported mask decoder, the demo and AVS-refinement CLIs)
# ---------------------------------------------------------------------------
# the mask decoder's last hypernetwork layer x SAM_HYPER_SCALE in 9(a):
# random weights then give mask logits of O(10), so the stability score
# spreads (tests/test_torch_sam_prompts.py's AMG_HYPER_SCALE)
SAM_HYPER_SCALE = 30.0
# 9(a)'s image (non-square: the resized frame leaves a bottom pad) and the
# prompts in its pixels: two points (labels 1 and 0) and a box
SAM_TINY_HW = (96, 128)
SAM_PROMPTS = {
    "box": {"box": np.asarray([20.0, 10.0, 120.0, 80.0])},
    "points": {"point_coords": np.asarray([[40.0, 40.0], [100.0, 60.0]]),
               "point_labels": np.asarray([1, 0])},
    "points+box": {"point_coords": np.asarray([[40.0, 40.0],
                                               [100.0, 60.0]]),
                   "point_labels": np.asarray([1, 0]),
                   "box": np.asarray([20.0, 10.0, 120.0, 80.0])}}
# the generator in 9(a): 4 points a side in chunks of 6 (the last chunk of
# 4 zero-padded), every mask kept (no score or stability filter, no NMS:
# the CPU tests hold those host steps against the JAX package; the card
# adds the decode and the stability score). Each point's records are
# paired with the CPU's by the pairing that flips the fewest pixels, then
# held as compare_predict holds masks (compare_amg), against the CPU's own
# logits of every grid point (amg_reference)
SAM_AMG_TINY = dict(points_per_side=4, points_per_batch=6,
                    pred_iou_thresh=-1e9, stability_score_thresh=0.0,
                    box_nms_thresh=1.0)
# the exported decoder's prompts: the ONNX wrapper's labels, a positive
# point, a box's two corners, a padding point and a negative point
EXPORT_LABELS = (1.0, 2.0, 3.0, -1.0, 0.0)
# 9(b): COCO's image size, as a JPEG; warm repeats of set_image and predict
SAM_H_HW = (480, 640)
SAM_REPEATS = 5


def zero_launches(flash) -> None:
    flash.reset_launch_counts()


def read_launches(flash) -> dict:
    """{kernel: launches}, read from the card's counters (it waits)."""
    counts = flash.launch_counts()
    return {k.__name__: counts[k.__name__] for k in flash.KERNELS}


def launch_mark(flash, name: str):
    """A copy of ``name``'s launch counter, queued on the card without
    waiting: the launches between two marks are ``int(later - earlier)``,
    read once the card got there."""
    return flash.launch_counter(name, "cuda").clone()


def by_shape(marks) -> dict:
    """{shape: launches} of (shape, mark before, mark after) triples."""
    shapes = {}
    for shape, n0, n1 in marks:
        n = int(n1 - n0)
        if n:
            shapes[shape] = shapes.get(shape, 0) + n
    return shapes


def sam_encode_launches(flash, cfg, path: str) -> dict:
    """{kernel: launches} of one SAM image encode on ``path``: a served
    batch's (launches_per_batch) without the decoder's and CLIP's."""
    want = dict(launches_per_batch(flash, cfg)[path])
    for name in ("rms_norm_fused", "flash_causal_attention",
                 "flash_attention_qkv"):
        want[name] = 0
    return want


def check_set_image(torch, flash, pred, image, want: dict, what: str):
    """pred.set_image(image) with the counts at 0 just before and read just
    after: -> (wall s, launches), failing unless they are ``want``."""
    zero_launches(flash)
    t0 = time.time()
    pred.set_image(image)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches(flash)
    if launches != want:
        fail(f"{what}: set_image launched {launches}, want {want}")
    return wall, launches


def compare_predict(got, want, input_hw, image_size: int, what: str):
    """SamPredictor.predict on the card against the CPU: iou and low-res
    logits within SLICE_REL_TOL of the CPU's largest magnitude, the masks
    different only where the CPU's logit lies within SLICE_REL_TOL of its
    largest magnitude of 0. -> (iou rel err, logit rel err, flipped
    pixels)."""
    from anyref_tpu_torch.ops.resize import postprocess_low_res_np
    (gm, gi, gl), (wm, wi, wl) = got, want
    if gm.shape != wm.shape or gi.shape != wi.shape or \
            gl.shape != wl.shape or not np.isfinite(gl).all():
        fail(f"{what}: card {gm.shape} {gi.shape} {gl.shape}, CPU "
             f"{wm.shape} {wi.shape} {wl.shape}, or not finite")
    rel_iou = float(np.abs(gi - wi).max() / max(np.abs(wi).max(), 1e-30))
    rel_low = float(np.abs(gl - wl).max() / np.abs(wl).max())
    logits = postprocess_low_res_np(wl, image_size, input_hw, wm.shape[-2:])
    diff = gm != wm
    near = np.abs(logits) <= SLICE_REL_TOL * np.abs(logits).max()
    if (diff & ~near).any():
        fail(f"{what}: {int((diff & ~near).sum())} mask pixels differ where "
             f"the CPU's logit is beyond {SLICE_REL_TOL} of its largest "
             "magnitude from 0")
    if rel_iou > SLICE_REL_TOL or rel_low > SLICE_REL_TOL:
        fail(f"{what}: iou rel err {rel_iou:.4g}, low-res rel err "
             f"{rel_low:.4g} (limit {SLICE_REL_TOL})")
    return rel_iou, rel_low, int(diff.sum())


def amg_reference(mods, p, s, image, path: str, gen) -> dict:
    """{point (x, y) in the original image: (iou [3], low-res logits [3,
    4g, 4g], logits at the original size [3, H, W])} of every grid point of
    ``gen`` from the CPU plain path on SAM weights ``p``, and the low-res
    extent the stability score counts (under key "valid_hw")."""
    import torch

    from anyref_tpu_torch.models.sam import amg, predictor
    from anyref_tpu_torch.ops.resize import postprocess_masks_np
    h, w = image.shape[:2]
    emb, (nh, nw) = predictor.encode_resized(p, s, image, "cpu", path)
    coords = gen.grid * np.asarray([nw, nh])
    with torch.inference_mode():
        low, iou = amg._batched_point_decode(
            p, s, emb, torch.from_numpy(coords.astype(np.float32)))
    low, iou = low.float().numpy(), iou.float().numpy()
    lg = low.shape[-1]
    ref = {"valid_hw": (-(-nh * lg // s.image_size),
                        -(-nw * lg // s.image_size))}
    for j, c in enumerate(coords):
        ref[(float(c[0] * w / nw), float(c[1] * h / nh))] = (
            iou[j], low[j], postprocess_masks_np(low[j], (nh, nw), (h, w)))
    return ref


def compare_amg(got: list, want: list, ref: dict, offset: float,
                what: str) -> dict:
    """The generator's records on the card against the CPU's: the same
    number at each grid point, paired by the permutation that flips the
    fewest pixels; a pair's score within SLICE_REL_TOL of the largest
    |score| of the grid, its mask different only where the CPU's logit lies
    within SLICE_REL_TOL of its largest magnitude of 0, and its stability
    score inside the range the same rule allows: the counts above +offset
    and -offset may move by the low-res pixels within that distance of
    +offset and -offset. -> the largest differences."""
    import itertools

    from anyref_tpu_torch.data import rle
    if len(got) != len(want):
        fail(f"{what}: {len(got)} records on the card, {len(want)} on the "
             "CPU")
    by_point = {}
    for side, recs in (("got", got), ("want", want)):
        for r in recs:
            by_point.setdefault(tuple(r["point_coords"][0]), {}).setdefault(
                side, []).append((r, rle.decode(r["segmentation"]) > 0))
    vh, vw = ref.pop("valid_hw")
    iou_scale = max(float(np.abs(v[0]).max()) for v in ref.values())
    worst = {"iou": 0.0, "stability": 0.0, "box_px": 0.0, "area_rel": 0.0,
             "flipped_px": 0}
    for point, sides in by_point.items():
        g, w = sides.get("got", []), sides.get("want", [])
        if len(g) != len(w):
            fail(f"{what}: point {point}: {len(g)} records on the card, "
                 f"{len(w)} on the CPU")
        iou, low, full = ref[point]
        pairing = min(itertools.permutations(g), key=lambda perm: sum(
            int((a[1] != b[1]).sum()) for a, b in zip(perm, w)))
        for (a, ma), (b, mb) in zip(pairing, w):
            # the CPU mask's index: its logits give exactly its pixels
            m = int(np.argmin([((f > 0) != mb).sum() for f in full]))
            near = np.abs(full[m]) <= SLICE_REL_TOL * np.abs(full[m]).max()
            flips = ma != mb
            d_iou = abs(a["predicted_iou"] - b["predicted_iou"])
            lm = low[m][:vh, :vw]
            delta = SLICE_REL_TOL * np.abs(low[m]).max()
            hi, lo = (lm > offset).sum(), (lm > -offset).sum()
            n_hi = (np.abs(lm - offset) <= delta).sum()
            n_lo = (np.abs(lm + offset) <= delta).sum()
            st = a["stability_score"]
            st_min = max(hi - n_hi, 0) / max(lo + n_lo, 1)
            st_max = (hi + n_hi) / max(lo - n_lo, 1)
            if (flips & ~near).any() or \
                    d_iou > SLICE_REL_TOL * iou_scale or \
                    not st_min - 1e-6 <= st <= st_max + 1e-6:
                fail(f"{what}: point {point}, mask {m}: "
                     f"{int((flips & ~near).sum())} pixels differ beyond "
                     f"{SLICE_REL_TOL} of the largest logit from 0; score "
                     f"{a['predicted_iou']} vs {b['predicted_iou']}; "
                     f"stability {st} outside [{st_min}, {st_max}]")
            d = {"iou": d_iou,
                 "stability": abs(st - b["stability_score"]),
                 "box_px": float(np.abs(np.subtract(a["bbox"],
                                                    b["bbox"])).max()),
                 "area_rel": abs(a["area"] - b["area"]) / max(b["area"], 1),
                 "flipped_px": int(flips.sum())}
            worst = {k: max(worst[k], d[k]) for k in worst}
    return worst


def export_inputs(torch, s, embedding, seed: int):
    """(embedding, point_coords [1, 5, 2], point_labels [1, 5]) on the card,
    the coordinates drawn in the image_size frame."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, s.image_size, (1, len(EXPORT_LABELS), 2))
    return (embedding,
            torch.tensor(coords, dtype=torch.float32, device="cuda"),
            torch.tensor([EXPORT_LABELS], dtype=torch.float32,
                         device="cuda"))


def check_export(torch, flash, mods, p, s, embedding, tmp: str,
                 what: str) -> dict:
    """export_sam_decoder on the card, loaded and run against the unexported
    sam_decoder_fn on the same inputs (outputs within SLICE_REL_TOL of the
    unexported's largest magnitude; bit equality printed); neither may
    launch a kernel. -> the export's numbers."""
    export = mods["export"]
    path = os.path.join(tmp, f"sam_decoder_{s.image_size}.pt2")
    t0 = time.time()
    export.export_sam_decoder(p, s, path, num_points=len(EXPORT_LABELS))
    t_export = time.time() - t0
    loaded = export.load_exported(path)
    live = export.sam_decoder_fn(p, s)
    args = export_inputs(torch, s, embedding, 0)
    zero_launches(flash)
    with torch.inference_mode():
        got, want = loaded(*args), live(*args)
        torch.cuda.synchronize()
        if any(read_launches(flash).values()):
            fail(f"{what}: the mask decoder launched {read_launches(flash)}")
        errs = [float((a.float() - b.float()).abs().max()
                      / b.float().abs().max()) for a, b in zip(got, want)]
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        times = {}
        for name, fn in (("exported", loaded), ("unexported", live)):
            walls = []
            for _ in range(SAM_REPEATS):
                t0 = time.time()
                fn(*args)
                torch.cuda.synchronize()
                walls.append(time.time() - t0)
            times[name] = float(np.median(walls)) * 1e3
    shapes = [tuple(t.shape) for t in got]
    if shapes != [tuple(t.shape) for t in want] or \
            not all(bool(torch.isfinite(t).all()) for t in got) or \
            max(errs) > SLICE_REL_TOL:
        fail(f"{what}: exported {shapes}, rel errs {errs} (limit "
             f"{SLICE_REL_TOL})")
    out = {"export_s": t_export, "bytes": os.path.getsize(path),
           "rel_err": max(errs), "bit_equal": equal,
           "exported_ms": times["exported"],
           "unexported_ms": times["unexported"], "shapes": shapes}
    log(f"[sam] {what}: export_sam_decoder {t_export:.1f} s, "
        f"{out['bytes']} bytes; loaded on the card against the unexported "
        f"function: outputs {shapes}, rel err {max(errs):.3g}, bit-equal "
        f"{equal}; a call {times['exported']:.3f} ms exported, "
        f"{times['unexported']:.3f} ms unexported (wall, median of "
        f"{SAM_REPEATS})")
    return out


def sam_alone_tiny(torch, flash, mods, tiny, tiny512) -> None:
    """Phase 9(a): SamPredictor, the generator and the exported decoder at
    anyref_tiny on "unfused" and at its 512-pixel SAM on "fused", bf16 SAM
    weights from seed 0 (sam.init, the last hypernetwork layer x
    SAM_HYPER_SCALE) on the card and on the CPU plain path: set_image's
    launches (one SAM encode), predict on SAM_PROMPTS with multimask on and
    off (compare_predict; predict launches nothing), generate (compare_amg;
    one encode's launches), the export (check_export); then the demo and
    AVS-refinement CLIs (sam_clis_tiny)."""
    import tempfile
    t_phase = time.time()
    image = np.random.default_rng(9).integers(0, 256, (*SAM_TINY_HW, 3),
                                              np.uint8)
    for path, cfg in (("unfused", tiny), ("fused", tiny512)):
        s = cfg.sam
        what = f"SAM alone ({path}, {s.image_size} px)"
        p_cpu = mods["sam"].init(s, torch.Generator().manual_seed(0),
                                 torch.bfloat16, device="cpu")
        p_cpu["mask_decoder"]["hyper_mlps"][2]["w"] *= SAM_HYPER_SCALE
        p_gpu = _to_device(p_cpu, "cuda")
        encode = sam_encode_launches(flash, cfg, path)
        preds = {}
        for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
            preds[dev] = mods["SamPredictor"](p, s, encoder_path=path,
                                              device=dev)
        check_set_image(torch, flash, preds["cuda"], image, encode, what)
        preds["cpu"].set_image(image)
        worst = [0.0, 0.0, 0]
        for name, kw in SAM_PROMPTS.items():
            for multimask in (True, False):
                zero_launches(flash)
                got = preds["cuda"].predict(multimask_output=multimask, **kw)
                if any(read_launches(flash).values()):
                    fail(f"{what}: predict launched {read_launches(flash)}")
                want = preds["cpu"].predict(multimask_output=multimask, **kw)
                errs = compare_predict(
                    got, want, preds["cpu"]._input_hw, s.image_size,
                    f"{what}, predict {name}, multimask {multimask}")
                worst = [max(a, b) for a, b in zip(worst, errs)]
        log(f"[sam-tiny] {what}: set_image launches "
            f"{json.dumps({k: v for k, v in encode.items() if v})}; predict "
            f"on {', '.join(SAM_PROMPTS)}, multimask on and off, card vs "
            f"CPU: iou rel err <= {worst[0]:.3g}, low-res rel err <= "
            f"{worst[1]:.3g} (limit {SLICE_REL_TOL}), {worst[2]} mask pixels "
            f"flipped near 0 in all")
        gens = {dev: mods["SamAutomaticMaskGenerator"](
            p, s, encoder_path=path, device=dev, **SAM_AMG_TINY)
            for dev, p in (("cpu", p_cpu), ("cuda", p_gpu))}
        zero_launches(flash)
        got = gens["cuda"].generate(image)
        torch.cuda.synchronize()
        if read_launches(flash) != encode:
            fail(f"{what}: generate launched {read_launches(flash)}, want "
                 f"one encode's {encode}")
        want = gens["cpu"].generate(image)
        ref = amg_reference(mods, p_cpu, s, image, path, gens["cpu"])
        diffs = compare_amg(got, want, ref, gens["cpu"].st_offset,
                            f"{what}, generate")
        log(f"[sam-tiny] {what}: generate, 16 points in chunks of 6 (the "
            f"last padded): {len(got)} records on the card and the CPU, "
            f"largest card-vs-CPU differences {json.dumps(diffs)}")
        with tempfile.TemporaryDirectory() as tmp:
            check_export(torch, flash, mods, p_gpu, s,
                         preds["cuda"]._embedding, tmp, what)
    sam_clis_tiny(torch, flash, mods, tiny)
    log(f"[phase 9] (a) in {time.time() - t_phase:.1f} s")


def run_cli(module: str, args: list, what: str) -> list:
    """``python -m module args`` in a subprocess from the repository root;
    -> its stdout lines (fails on a non-zero exit)."""
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", module] + args, cwd=ROOT,
                       capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=ROOT), timeout=600)
    if r.returncode != 0:
        fail(f"{what} (exit {r.returncode}):\n{r.stdout[-2000:]}\n"
             f"{r.stderr[-2000:]}")
    log(f"[sam-cli] {what}: {time.time() - t0:.1f} s (process included)")
    return r.stdout.splitlines()


def in_process(fn, argv):
    """fn(argv) with its stdout captured: -> (its return, stdout lines)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    return out, buf.getvalue().splitlines()


def same_pngs(a: str, b: str) -> int:
    """Fail unless the PNG files under directories a and b have the same
    relative paths and pixels; -> their count."""
    from PIL import Image
    names = {}
    for root in (a, b):
        names[root] = sorted(os.path.relpath(os.path.join(d, f), root)
                             for d, _, fs in os.walk(root) for f in fs)
    if names[a] != names[b]:
        fail(f"PNG files differ: {names[a]} and {names[b]}")
    for rel in names[a]:
        with Image.open(os.path.join(a, rel)) as x, \
                Image.open(os.path.join(b, rel)) as y:
            if not np.array_equal(np.asarray(x), np.asarray(y)):
                fail(f"{rel} differs between {a} and {b}")
    return len(names[a])


def sam_clis_tiny(torch, flash, mods, tiny) -> None:
    """The demo CLI (anyref_tiny, "unfused", seed-0 bf16 weights with the
    [SEG] column x EVAL_TINY_SEG_SCALE, saved with save_params) and
    convert_avs_masks (a tiny SAM .pth of the reference's layout on
    write_avs_refine_root's root, every mask kept) in subprocesses on the
    card: each prints what the same CLI's main prints in this process on
    the card and writes the same PNGs; the in-process AVS run launches
    one SAM encode a refined mask."""
    import tempfile

    from anyref_tpu_torch import checkpoint
    from anyref_tpu_torch.tools import convert_avs_masks, demo
    with tempfile.TemporaryDirectory() as tmp:
        p = mods["tparams"].init(tiny, torch.Generator().manual_seed(0),
                                 torch.bfloat16, device="cpu")
        p["llama"]["lm_head"][:, tiny.tokens.seg] *= EVAL_TINY_SEG_SCALE
        ckpt = os.path.join(tmp, "tiny.pt")
        checkpoint.save_params(ckpt, p)
        img = os.path.join(tmp, "image.png")
        write_image(img, np.random.default_rng(3), *EVAL_TINY_SIZE)
        masks = {k: os.path.join(tmp, k) for k in ("sub", "in")}
        for d in masks.values():
            os.makedirs(d)
        args = ["--ckpt", ckpt, "--image", img, "--text", "the bowl",
                "--preset", "tiny", "--max_new_tokens", str(EVAL_MNT),
                "--device", "cuda", "--encoder_path", "unfused"]
        printed = run_cli("anyref_tpu_torch.tools.demo", args + [
            "--out", os.path.join(masks["sub"], "mask.png")],
            "demo CLI, --text, tiny, unfused")
        (_, mask), want = in_process(demo.main, args + [
            "--out", os.path.join(masks["in"], "mask.png")])
        if printed != [line.replace(masks["in"], masks["sub"])
                       for line in want]:
            fail(f"demo CLI printed {printed}, in process {want}")
        same_pngs(masks["sub"], masks["in"])
        log(f"[sam-cli] demo CLI: {printed[0]!r}, a mask of "
            f"{int(mask.sum())} pixels, the same PNG as in process")

        g = torch.Generator().manual_seed(0)
        sd = reference_state_dicts(tiny, lambda *shape: torch.randn(
            shape, generator=g) * 0.1)["sam"]
        pth = os.path.join(tmp, "sam_tiny.pth")
        torch.save(sd, pth)
        roots = {k: os.path.join(tmp, f"avs-{k}") for k in ("sub", "in")}
        for r in roots.values():
            n = write_avs_refine_root(r, EVAL_TINY_SIZE)
        args = ["--sam_ckpt", pth, "--iou_threshold", "0.0", "--preset",
                "tiny", "--device", "cuda", "--encoder_path", "unfused"]
        printed = run_cli("anyref_tpu_torch.tools.convert_avs_masks",
                          args + ["--avs_root", roots["sub"]],
                          "convert_avs_masks, tiny, unfused")
        zero_launches(flash)
        kept, want = in_process(convert_avs_masks.main,
                                args + ["--avs_root", roots["in"]])
        torch.cuda.synchronize()
        encode = sam_encode_launches(flash, tiny, "unfused")
        launches = read_launches(flash)
        if launches != {k: n * v for k, v in encode.items()}:
            fail(f"convert_avs_masks: launched {launches}, want {n} x "
                 f"{encode}")
        line = f"refined {n}/{n} masks (IoU >= 0.0)"
        if kept != (n, n) or printed[-1] != line or printed != [
                w.replace(roots["in"], roots["sub"]) for w in want]:
            fail(f"convert_avs_masks printed {printed}, in process {want} "
                 f"(kept {kept}), want the last line {line!r}")
        sub = os.path.join("s4_data", "gt_masks_sam")
        count = same_pngs(os.path.join(roots["sub"], sub),
                          os.path.join(roots["in"], sub))
        log(f"[sam-cli] convert_avs_masks: {printed[-1]!r}, {count} PNGs, "
            f"the same as in process")


def sam_alone_7b(torch, flash, mods, params, cfg) -> dict:
    """Phase 9(b), run in phase 4 on its SAM-H weights: set_image on a 640 x
    480 JPEG on each encoder path (launches one SAM encode's, the first
    call's wall, warm walls and the kernels under the profiler), predict on
    a box warm, generate at the defaults on "fused" (records, the wall
    split between encode, decode, stability and the host's filters and
    RLE, then under the profiler: the device's busy and idle share), and
    export_sam_decoder at SAM-H's decoder against the unexported function.
    -> {"sam_set_image_<path>": launches}."""
    import tempfile

    from anyref_tpu_torch.data.base import load_image_rgb
    t_phase = time.time()
    sam, s = params["sam"], cfg.sam
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        jpg = os.path.join(tmp, "image.jpg")
        write_image(jpg, np.random.default_rng(11), *SAM_H_HW)
        image = load_image_rgb(jpg)
        preds = {}
        for path in PATHS:
            pred = preds[path] = mods["SamPredictor"](sam, s,
                                                      encoder_path=path)
            encode = sam_encode_launches(flash, cfg, path)
            first, out[f"sam_set_image_{path}"] = check_set_image(
                torch, flash, pred, image, encode, f"SAM-H set_image {path}")
            walls = []
            for _ in range(SAM_REPEATS):
                walls.append(check_set_image(
                    torch, flash, pred, image, encode,
                    f"SAM-H set_image {path}, warm")[0])
            span = profiled_span(torch, lambda: pred.set_image(image))
            kern = ("not measured (the profiler lost a marker)" if span is None
                    else f"{span[2]:.3f} ms of kernels in {span[1]} device "
                    f"records, wall {span[0] * 1e3:.2f} ms profiled")
            log(f"[sam-7b] set_image {path}, {SAM_H_HW[1]} x {SAM_H_HW[0]} "
                f"JPEG: first call {first:.3f} s, warm "
                f"{np.median(walls) * 1e3:.2f} ms wall (median of "
                f"{SAM_REPEATS}); {kern}; launches "
                f"{json.dumps({k: v for k, v in encode.items() if v})}")
        pred = preds["fused"]
        box = np.asarray([120.0, 80.0, 400.0, 360.0])
        zero_launches(flash)
        masks, iou, low = pred.predict(box=box)
        if any(read_launches(flash).values()):
            fail(f"SAM-H predict launched {read_launches(flash)}")
        g4 = 4 * s.embedding_size
        if masks.shape != (3, *SAM_H_HW) or iou.shape != (3,) or \
                low.shape != (3, g4, g4) or not np.isfinite(low).all():
            fail(f"SAM-H predict: {masks.shape} {iou.shape} {low.shape}")
        walls = []
        for _ in range(2 * SAM_REPEATS):
            t0 = time.time()
            pred.predict(box=box)
            walls.append(time.time() - t0)
        span = profiled_span(torch, lambda: pred.predict(box=box))
        kern = ("not measured" if span is None else
                f"{span[2]:.3f} ms of kernels in {span[1]} device records")
        log(f"[sam-7b] predict, a box, multimask, fused: "
            f"{np.median(walls) * 1e3:.2f} ms wall (median of "
            f"{2 * SAM_REPEATS}, the host's upscale to {SAM_H_HW} "
            f"included); {kern}; iou {iou.tolist()}, mask pixels "
            f"{masks.sum((1, 2)).tolist()}")

        gen = mods["SamAutomaticMaskGenerator"](sam, s, encoder_path="fused")
        encode = sam_encode_launches(flash, cfg, "fused")
        for run in ("first", "warm"):
            zero_launches(flash)
            timings = {}
            t0 = time.time()
            recs = gen.generate(image, timings=timings)
            wall = time.time() - t0
            if read_launches(flash) != encode:
                fail(f"SAM-H generate launched {read_launches(flash)}, want "
                     f"one encode's {encode}")
            for r in recs:
                x, y, w, h = r["bbox"]
                if not (0 < r["area"] <= SAM_H_HW[0] * SAM_H_HW[1]) or \
                        x < 0 or y < 0 or x + w > SAM_H_HW[1] or \
                        y + h > SAM_H_HW[0] or r["predicted_iou"] < 0.88 or \
                        r["stability_score"] < 0.95:
                    fail(f"SAM-H generate: a record out of bounds or below "
                         f"the thresholds: {r['bbox']} {r['area']} "
                         f"{r['predicted_iou']} {r['stability_score']}")
            log(f"[sam-7b] generate ({run}), fused, 32 x 32 points in 16 "
                f"chunks of 64 (x 3 masks), thresholds 0.88 / 0.95 / NMS 0.7:"
                f" {len(recs)} records, {wall:.3f} s wall: "
                + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items()))
        span = profiled_span(torch, lambda: gen.generate(image))
        if span is None:
            log("[sam-7b] generate under the profiler: not measured (the "
                "profiler lost a marker)")
        else:
            wall, n_rec, busy, _ = span
            log(f"[sam-7b] generate under the profiler: {wall:.3f} s wall, "
                f"{busy:.2f} ms of kernels in {n_rec} device records -> "
                f"device busy {100 * busy / 1e3 / wall:.1f}%, idle "
                f"{100 * (1 - busy / 1e3 / wall):.1f}% of the wall")
        check_export(torch, flash, mods, sam, s, pred._embedding, tmp,
                     "SAM-H's decoder")
    log(f"[phase 9] (b) in {time.time() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 10: the decoder's serving layouts and the exported generate
# ---------------------------------------------------------------------------
# 10(a): the prompts' bucket (tiny_batch's), the exported programs' steps
EXPORT_PROMPT_LEN_TINY = 257
EXPORT_MNT_TINY = 4
# 10(b): the exported generate at anyref_7b width, cut to this many decoder
# layers (the artifact carries the whole tree, ~0.4 GB a layer beside the
# ~2.7 GB of the rest, written, read back and loaded inside the run's
# limit), greedy, batch 1, in the 385 bucket of phase 4's prompts
EXPORT_LAYERS_7B = 2
EXPORT_MNT_7B = 8
EXPORT_PROMPT_LEN_7B = 385


def left_padded(fb, bucket: int) -> list:
    """Each prompt of a collated batch alone, left-padded into ``bucket``:
    [(input_ids [1, bucket] int32, clip_images [1, ...], sam_images
    [1, ...])] as numpy arrays."""
    out = []
    for b in range(fb["input_ids"].shape[0]):
        n = int(fb["prompt_lens"][b])
        ids = np.zeros((1, bucket), np.int32)
        ids[0, bucket - n:] = fb["input_ids"][b, :n]
        out.append((ids, fb["clip_images"][b:b + 1],
                    fb["sam_images"][b:b + 1]))
    return out


def batched(prompts: list) -> dict:
    """Left-padded prompts of one bucket as one generate batch."""
    return {k: np.concatenate([p[i] for p in prompts])
            for i, k in enumerate(("input_ids", "clip_images",
                                   "sam_images"))}


def tiny_requests(cfg) -> dict:
    """tiny_batch's prompts as a collated batch (each prompt at the front
    of its row, its length in prompt_lens), which the Predictor pads back
    into the 257 bucket: the inputs on which phase 3's rephrase check
    finds a first [SEG] at k >= 1."""
    batch = tiny_batch(cfg)
    ids = batch["input_ids"]
    B, T = ids.shape
    lens = (ids != 0).sum(1)
    front = np.zeros_like(ids)
    for b in range(B):
        front[b, :lens[b]] = ids[b, T - lens[b]:]
    S = cfg.sam.image_size
    return {"input_ids": front, "prompt_lens": lens,
            "clip_images": batch["clip_images"],
            "sam_images": batch["sam_images"],
            "sam_resized_sizes": np.full((B, 2), S),
            "_meta": [{"height": S, "width": S}] * B}


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, in fp32."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def predict_speculative(torch, mods, params, cfg, fb, device, path):
    """A speculative Predictor at rephrase 0.1 on ``params`` (which it
    converts) -> (ids, seg_valid, the low-res mask logits of every [SEG]
    slot as fetched, the original-size masks)."""
    pred = mods["Predictor"](params, cfg.scaled(rephrase_weight=0.1),
                             max_new_tokens=EXPORT_MNT_TINY,
                             speculative=True, device=device,
                             encoder_path=path)
    layer = params["llama"]["layers"][0]
    if set(layer["attn"]) != {"qkv", "o"} or \
            set(layer["mlp"]) != {"gate_up", "down"}:
        fail(f"speculative Predictor ({device}): the tree was not "
             f"converted: {sorted(layer['attn'])}, {sorted(layer['mlp'])}")
    handle = pred.predict_async(fb)
    (meta, low), _, B = handle
    seg_valid = meta[:B, pred.mnt:-1].cpu().numpy()
    low = low[:B].float().cpu().numpy()
    ids, masks = pred.complete(handle)
    return ids, seg_valid, low, masks


def serving_tiny(torch, flash, mods, tiny, tiny512) -> None:
    """Phase 10(a): at anyref_tiny on "unfused" and at its 512-pixel SAM on
    "fused" (serving_tiny_path each), and the int8 decoder (int8_tiny).
    Beside the fused path's checks, the export CLI's generate choice in a
    subprocess (tiny preset, "unfused", on the unfused path's tree); beside
    the CLI, a fresh interpreter that imports no JAX loads the three
    programs of export_generate and runs each on both prompts; then this
    process runs the CLI's program. Each: ids, [SEG] slots and masks
    bit-equal to eager generate on the card, and the same launches of each
    kernel as eager generate made."""
    import tempfile
    t_phase = time.time()
    env = dict(os.environ, PYTHONPATH=ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        jobs, want, procs = {}, {}, []
        try:
            jobs["unfused"], want["unfused"], tree = serving_tiny_path(
                torch, flash, mods, tiny, "unfused", tmp)
            ckpt = os.path.join(tmp, "tiny.pt")
            mods["checkpoint"].save_params(ckpt, tree)
            cli_art = os.path.join(tmp, "generate-cli.pt2")
            t0 = time.time()
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "anyref_tpu_torch.tools.export",
                 "generate", "--ckpt", ckpt, "--out", cli_art, "--preset",
                 "tiny", "--device", "cuda", "--prompt_len",
                 str(EXPORT_PROMPT_LEN_TINY), "--max_new_tokens",
                 str(EXPORT_MNT_TINY), "--encoder_path", "unfused"],
                cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE))
            jobs["fused"], want["fused"], _ = serving_tiny_path(
                torch, flash, mods, tiny512, "fused", tmp)
            jobs["int8"], want["int8"] = int8_tiny(torch, flash, mods, tiny,
                                                   tmp)
            jobs_file = os.path.join(tmp, "jobs.pt")
            out_file = os.path.join(tmp, "outs.pt")
            torch.save(jobs, jobs_file)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", LOADER, jobs_file, out_file],
                cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE))
            ends = [p.communicate(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for p, (out, err), what in zip(procs, ends, (
                "tools.export generate",
                "the exported programs in a fresh interpreter")):
            if p.returncode != 0:
                fail(f"{what} (exit {p.returncode}):\n{out[-2000:]}\n"
                     f"{err[-3000:]}")
        if f"wrote {cli_art}" not in ends[0][0]:
            fail(f"tools.export generate printed {ends[0][0][-2000:]}")
        log(f"[layout-tiny] tools.export generate and a fresh interpreter "
            f"(no JAX module loaded) in subprocesses: "
            f"{time.time() - t0:.1f} s (processes included, beside the "
            "fused path's checks)")
        check_programs(torch, torch.load(out_file), want,
                       "a fresh interpreter")
        check_programs(torch, run_programs(torch, flash, mods["export"], {
            "cli": (cli_art, jobs["unfused"][1])}), {"cli": want["unfused"]},
            "this process")
    log(f"[phase 10] (a) in {time.time() - t_phase:.1f} s")


def serving_tiny_path(torch, flash, mods, cfg, path: str, tmp: str):
    """Phase 10(a) on one path: seeded bf16 weights with lm_head's [SEG]
    column x TINY_SEG_SCALE on the card and on the CPU; a speculative
    Predictor at rephrase 0.1 converts each tree in place (ids, [SEG] slots,
    every slot's low-res logits and the masks, card against CPU); then
    export_generate of the converted card tree into ``tmp`` (nothing
    launched while tracing) and eager generate on the card on each prompt
    alone. -> ((artifact, prompts), [((ids, masks, seg_valid), launches)
    of eager generate a prompt], the card tree)."""
    p_cpu = mods["tparams"].init(cfg, torch.Generator().manual_seed(0),
                                 torch.bfloat16, device="cpu")
    p_cpu["llama"]["lm_head"][:, cfg.tokens.seg] *= TINY_SEG_SCALE
    p_gpu = _to_device(p_cpu, "cuda")
    fb = tiny_requests(cfg)
    got = predict_speculative(torch, mods, p_gpu, cfg, fb, "cuda", path)
    ref = predict_speculative(torch, mods, p_cpu, cfg, fb, "cpu", path)
    if not np.array_equal(got[0], ref[0]) or \
            not np.array_equal(got[1], ref[1]):
        fail(f"speculative Predictor, {path}: ids {got[0].tolist()} / [SEG] "
             f"slots {got[1].tolist()} on the card, {ref[0].tolist()} / "
             f"{ref[1].tolist()} on the CPU")
    # every slot's low-res logits (a slot without [SEG] decodes the last
    # prompt state), then the masks of the valid slots
    rels = [rel_err(got[2], ref[2])]
    for a, b in zip(got[3], ref[3]):
        if (a is None) != (b is None):
            fail(f"speculative Predictor, {path}: a mask on one side only")
        if a is not None:
            rels.append(rel_err(a, b))
    ks = first_seg(got[0], cfg.tokens.seg)
    if max(rels) > SLICE_REL_TOL or not any(k is not None and k >= 1
                                            for k in ks):
        fail(f"speculative Predictor, {path}: low-res logits and masks "
             f"{rels} (limit {SLICE_REL_TOL}); first [SEG]s {ks} (a span "
             "at k >= 1 wanted, so that rephrase pools)")
    log(f"[layout-tiny] {path}, SAM {cfg.sam.image_size} px, speculative "
        f"Predictor at rephrase 0.1 on the converted tree (qkv, gate_up), "
        f"card vs CPU: ids {got[0].tolist()} (first [SEG] at {ks}), [SEG] "
        f"slots {got[1].tolist()} equal, low-res logits max rel err "
        f"{rels[0]:.4g}, {len(rels) - 1} masks "
        f"{max(rels[1:], default=0.0):.4g} (limit {SLICE_REL_TOL})")

    job, eager = export_and_eager(torch, flash, mods, p_gpu, cfg, path,
                                  left_padded(fb, EXPORT_PROMPT_LEN_TINY),
                                  os.path.join(tmp, f"generate-{path}.pt2"))
    return job, eager, p_gpu


def int8_tiny(torch, flash, mods, cfg, tmp: str):
    """Phase 10(a)'s int8 case: the seeded tiny tree ([SEG] column x
    TINY_SEG_SCALE) with its decoder quantised by quantize_llama on the
    card (int8 products through anyref::int8_matmul, lm_head None beside
    lm_head_q), exported on "unfused" -> export_and_eager's result."""
    p = _to_device(mods["tparams"].init(
        cfg, torch.Generator().manual_seed(0), torch.bfloat16,
        device="cpu"), "cuda")
    p["llama"]["lm_head"][:, cfg.tokens.seg] *= TINY_SEG_SCALE
    p["llama"] = mods["quant"].quantize_llama(p["llama"])
    if p["llama"]["lm_head"] is not None:
        fail("quantize_llama kept a float lm_head")
    prompts = left_padded(tiny_requests(cfg), EXPORT_PROMPT_LEN_TINY)
    job, eager = export_and_eager(torch, flash, mods, p, cfg, "unfused",
                                  prompts,
                                  os.path.join(tmp, "generate-int8.pt2"))
    if not all(e[1]["int8_matmul"] for e in eager):
        fail("int8 eager generate launched no int8_matmul")
    return job, eager


def export_and_eager(torch, flash, mods, params, cfg, path: str, prompts,
                     art: str):
    """export_generate of ``params`` on ``path`` into ``art`` (nothing
    launched while tracing), then eager generate on the card on each
    prompt alone -> ((art, prompts as tensors), [((ids, masks, seg_valid),
    launches) of eager generate a prompt])."""
    before = read_launches(flash)
    t0 = time.time()
    mods["export"].export_generate(
        params, cfg, art, prompt_len=EXPORT_PROMPT_LEN_TINY,
        max_new_tokens=EXPORT_MNT_TINY, device="cuda", encoder_path=path)
    export_s = time.time() - t0
    name = os.path.basename(art)
    if read_launches(flash) != before:
        fail(f"export_generate ({name}) launched kernels while tracing")
    eager = []
    for prompt in prompts:
        zero_launches(flash)
        out = mods["anyref"].generate(
            params, cfg, dict(zip(("input_ids", "clip_images",
                                   "sam_images"), prompt)),
            max_new_tokens=EXPORT_MNT_TINY, device="cuda",
            encoder_path=path)
        torch.cuda.synchronize()
        eager.append(((out.output_ids.cpu(), out.low_res_masks.cpu(),
                       out.seg_valid.cpu()), read_launches(flash)))
    log(f"[layout-tiny] export_generate({name}, {path}, prompt_len "
        f"{EXPORT_PROMPT_LEN_TINY}, max_new_tokens {EXPORT_MNT_TINY}) on "
        f"the card: {export_s:.1f} s, {os.path.getsize(art)} bytes; eager "
        f"ids {[e[0][0].tolist() for e in eager]}")
    return ((art, [tuple(torch.from_numpy(a) for a in p) for p in prompts]),
            eager)


def run_programs(torch, flash, export, jobs: dict) -> dict:
    """Load each program of ``jobs`` ({name: (artifact, prompts)}) and run
    it on each prompt on the card -> {name: {"outs": [((ids, masks,
    seg_valid) on the CPU, launches)], "load_s": seconds}}."""
    res = {}
    for name, (art, prompts) in jobs.items():
        t0 = time.time()
        program = export.load_exported(art)
        load_s = time.time() - t0
        outs = []
        for prompt in prompts:
            zero_launches(flash)
            out = program(*(a.cuda() for a in prompt))
            torch.cuda.synchronize()
            outs.append((tuple(t.cpu() for t in out), read_launches(flash)))
        res[name] = {"outs": outs, "load_s": load_s}
    return res


# phase 10(a)'s fresh interpreter: imports the port's export module (the op
# registrations), no JAX
LOADER = """
import json, sys, torch
import chip_smoke
from anyref_tpu_torch import export
from anyref_tpu_torch.ops import flash
res = chip_smoke.run_programs(torch, flash, export, torch.load(sys.argv[1]))
torch.save(res, sys.argv[2])
bad = [n for n in sys.modules if n.split(".")[0] in
       ("jax", "jaxlib", "anyref_tpu")]
print(json.dumps({"jax_modules": bad}))
sys.exit(1 if bad else 0)
"""


def check_programs(torch, res: dict, want: dict, where: str) -> None:
    """Hold run_programs' results against ``want`` ({name: per prompt
    ((ids, masks, seg_valid), launches)} of eager generate)."""
    for name, got in res.items():
        for i, ((ids, masks, valid), launches) in enumerate(got["outs"]):
            (w_ids, w_masks, w_valid), w_launches = want[name][i]
            ran = {k: n for k, n in launches.items() if n}
            w_ran = {k: n for k, n in w_launches.items() if n}
            if not torch.equal(ids, w_ids) or not torch.equal(valid,
                                                              w_valid):
                fail(f"exported program {name}, prompt {i}: ids "
                     f"{ids.tolist()} / [SEG] {valid.tolist()}, eager "
                     f"{w_ids.tolist()} / {w_valid.tolist()}")
            if not torch.equal(masks, w_masks) or launches != w_launches \
                    or not ran:
                fail(f"exported program {name}, prompt {i}: masks differ "
                     f"from eager by up to "
                     f"{rel_err(masks.float(), w_masks.float())} of the "
                     f"largest (bit equality wanted); launches {ran}, "
                     f"eager {w_ran}")
            log(f"[layout-tiny] exported {name}, prompt {i}, in {where} "
                f"(loaded in {got['load_s']:.1f} s): ids {ids.tolist()}, "
                f"[SEG] slots and masks bit-equal to eager generate on the "
                f"card, launches {json.dumps(ran)} as eager")


def bucket_batch(torch, mods, cfg, images, texts, bucket: int) -> dict:
    """The requests' prompts left-padded into ``bucket`` as one generate
    batch on the card (the Predictor's padding, by hand)."""
    ds = mods["SegDataset"](cfg)
    fb = mods["Collator"](mods["AnyRefTokenizer"](), cfg)(
        [ds.make_sample(im, mods["seg_question"](t), None, None)
         for im, t in zip(images, texts)])
    return {k: torch.from_numpy(v).cuda()
            for k, v in batched(left_padded(fb, bucket)).items()}


def profiled_busy(torch, fn):
    """One call of fn under torch.profiler, after a synchronize: (its
    result, wall s, kernel ms, the kernels by name {name: (count, ms)})."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, ms = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, ms + e.device_time_total / 1e3)
    return out, wall, sum(ms for _, ms in by_name.values()), by_name


GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")


def layout_numbers(torch, mods, params, cfg, batch) -> dict:
    """The speculative generate at batch 2 on ``params`` as it stands
    (warm, then under the profiler), the decoder's product calls and GEMM
    kernels a layer in one verify chunk of draft_len + 1 = 32 tokens, and
    the device time of one prefill and of that chunk."""
    anyref_mod, llama = mods["anyref"], mods["llama"]
    lp, lc = params["llama"], cfg.llama

    def gen():
        return anyref_mod.generate(params, cfg, batch, max_new_tokens=8,
                                   speculative=True, encoder_path="fused")
    gen()
    out, wall, busy, _ = profiled_busy(torch, gen)
    with torch.inference_mode():
        clip = anyref_mod.encode_clip_images(params, cfg,
                                             batch["clip_images"], "fused")
        embeds, _, _ = anyref_mod.assemble_embeds(params, cfg,
                                                  batch["input_ids"], clip)
        pad = (batch["input_ids"] != 0).to(torch.uint8).argmax(1)
        B, L, _ = embeds.shape
        cache = llama.init_cache(lc, B, L + 48)

        def prefill():
            return llama.prefill(lp, lc, embeds, cache, pad_len=pad)[0]
        chunk = embeds[:, -32:].contiguous()

        slot = torch.tensor(L, device="cuda")

        def verify():
            return llama.decode_chunk(lp, lc, chunk, slot, cache,
                                      pad_len=pad)[0]
        hidden = prefill()
        verify()
        _, _, prefill_ms, _ = profiled_busy(torch, prefill)
        _, _, chunk_ms, kernels = profiled_busy(torch, verify)
        calls = [0]
        linear = llama.linear

        def counted(p, x):
            calls[0] += 1
            return linear(p, x)
        llama.linear = counted
        try:
            verify()
        finally:
            llama.linear = linear
    gemms = sum(n for name, (n, _) in kernels.items()
                if any(g in name.lower() for g in GEMM_NAMES))
    return {"ids": out.output_ids.cpu(), "passes": int(out.decode_passes),
            "wall_s": wall, "busy_ms": busy,
            "idle": 1 - busy / 1e3 / wall,
            "products_per_layer": calls[0] / lc.num_layers,
            "gemm_kernels_per_layer": gemms / lc.num_layers,
            "prefill_ms": prefill_ms, "chunk_ms": chunk_ms,
            "hidden": hidden, "embeds": embeds, "pad": pad}


def row_rel_l2(a, b, pad) -> list:
    """Relative L2 of a against b [B, L, D] per row, over its real (not
    left-pad) positions, in fp32."""
    out = []
    for r in range(a.shape[0]):
        x = a[r, int(pad[r]):].float()
        y = b[r, int(pad[r]):].float()
        out.append(float((x - y).norm() / y.norm()))
    return out


def teacher_forced_logits(torch, mods, lp, cfg, numbers, ids, row: int,
                          j: int):
    """The logits that choose output j of ``row``: prefill over the row's
    prompt and its outputs 0 .. j-1 (the ids both layouts agreed on), the
    last position's logits in fp32."""
    llama = mods["llama"]
    with torch.inference_mode():
        emb = numbers["embeds"][row:row + 1]
        if j:
            toks = ids[row:row + 1, :j].cuda()
            emb = torch.cat([emb, llama.embed(lp, toks, dtype=emb.dtype)], 1)
        cache = llama.init_cache(cfg.llama, 1, -(-emb.shape[1] // 16) * 16)
        h, _ = llama.prefill(lp, cfg.llama, emb, cache,
                             pad_len=numbers["pad"][row:row + 1])
        return llama.logits(lp, h[:, -1])[0]


# 10(b): rounds of prefill and verify chunk on the two layouts in turns
LAYOUT_TURNS = 9


def layout_turns(torch, mods, lp, cfg, numbers) -> dict:
    """Prefill and 32-token verify-chunk kernel time on both layouts,
    LAYOUT_TURNS rounds with the two in turns (plain first in even rounds,
    fused first in odd ones), on layout_numbers' embeddings of the plain
    run. The fused decoder is built beside the plain one (about 13 GB more
    on the card, freed after) by fuse_for_serving(transpose_for_serving) of
    a copy of the tree's dicts, which leaves ``lp`` as it was. Each time is
    the summed device time of the call's kernels under the profiler, and
    its GEMM kernels' share; the prefill's kernels by name are summed over
    the rounds. -> {"plain" | "fused": {"prefill_ms", "prefill_gemm_ms",
    "chunk_ms", "chunk_gemm_ms": [one per round], "prefill_by_name":
    {kernel: ms a prefill, the mean over the rounds}}}."""
    llama, lc = mods["llama"], cfg.llama
    copy = dict(lp, layers=[{k: dict(v) if isinstance(v, dict) else v
                             for k, v in layer.items()}
                            for layer in lp["layers"]])
    trees = {"plain": lp, "fused": llama.fuse_for_serving(
        llama.transpose_for_serving(copy))}
    if "qkv" in lp["layers"][0]["attn"]:
        fail("layout_turns converted the plain tree")
    embeds, pad = numbers["embeds"], numbers["pad"]
    B, L, _ = embeds.shape
    chunk = embeds[:, -32:].contiguous()
    out = {name: {k: [] for k in ("prefill_ms", "prefill_gemm_ms",
                                  "chunk_ms", "chunk_gemm_ms")}
           for name in trees}
    with torch.inference_mode():
        cache = llama.init_cache(lc, B, L + 48)
        slot = torch.tensor(L, device="cuda")
        calls = {name: {
            "prefill": lambda t=t: llama.prefill(t, lc, embeds, cache,
                                                 pad_len=pad),
            "chunk": lambda t=t: llama.decode_chunk(t, lc, chunk, slot,
                                                    cache, pad_len=pad)}
            for name, t in trees.items()}
        for fns in calls.values():
            for fn in fns.values():
                fn()
        for r in range(LAYOUT_TURNS):
            for name in (("plain", "fused") if r % 2 == 0
                         else ("fused", "plain")):
                for what, fn in calls[name].items():
                    _, _, ms, kernels = profiled_busy(torch, fn)
                    gemm = sum(m for k, (_, m) in kernels.items()
                               if any(g in k.lower() for g in GEMM_NAMES))
                    out[name][f"{what}_ms"].append(ms)
                    out[name][f"{what}_gemm_ms"].append(gemm)
                    if what == "prefill":
                        by = out[name].setdefault("prefill_by_name", {})
                        for k, (_, m) in kernels.items():
                            by[k] = by.get(k, 0.0) + m / LAYOUT_TURNS
    del calls, trees, copy
    torch.cuda.empty_cache()
    return out


def layouts_7b(torch, mods, params, cfg, images) -> dict:
    """Phase 10(b), the two layouts, run in phase 4 on its anyref_7b
    weights before its first Server: speculative generate at batch 2
    (requests 0 and 1 in the 385 bucket, "fused" encoders, 8 new tokens)
    called directly, on the [in, out] tree, then on the same tree
    converted in place (transpose_for_serving, fuse_for_serving: what the
    Servers' Predictors would do). For each: ids, decode passes, busy time
    and idle share under the profiler, the decoder's product calls (7 and
    4) and GEMM kernels a layer in a verify chunk, prefill and verify-chunk
    device time; then prefill and verify chunk again on both layouts in
    turns (layout_turns). The fused prefill's post-norm states are held
    against the
    plain layout's within the bf16 floor measured in the same call (the
    plain layout at batch 1 against batch 2, or one bf16 ulp, 2^-8,
    whichever is larger), relative L2 over each row's real positions; an
    id that differs must sit at a near tie: the top-two logit gap there
    (teacher-forced over the agreed prefix, on the converted tree) at most
    twice the logit floor (the last position's logits, batch 1 against
    batch 2 on the plain layout) plus one bf16 ulp of the top logit."""
    llama = mods["llama"]
    t_phase = time.time()
    batch = bucket_batch(torch, mods, cfg, images[:2], TEXTS[:2],
                         EXPORT_PROMPT_LEN_7B)
    lp = params["llama"]
    plain = layout_numbers(torch, mods, params, cfg, batch)
    with torch.inference_mode():
        floor_h, floor_logit = [], 0.0
        for r in range(2):
            cache = llama.init_cache(cfg.llama, 1, plain["embeds"].shape[1])
            h1, _ = llama.prefill(lp, cfg.llama, plain["embeds"][r:r + 1],
                                  cache, pad_len=plain["pad"][r:r + 1])
            floor_h += row_rel_l2(h1, plain["hidden"][r:r + 1],
                                  plain["pad"][r:r + 1])
            floor_logit = max(floor_logit, float(
                (llama.logits(lp, h1[:, -1])
                 - llama.logits(lp, plain["hidden"][r:r + 1, -1])
                 ).abs().max()))
    turns = layout_turns(torch, mods, lp, cfg, plain)
    for what in ("prefill", "chunk"):
        p_ms, f_ms = (np.asarray(turns[n][f"{what}_ms"])
                      for n in ("plain", "fused"))
        p_g, f_g = (np.asarray(turns[n][f"{what}_gemm_ms"])
                    for n in ("plain", "fused"))
        diff = f_ms - p_ms
        log(f"[layout-7b] {what}, {LAYOUT_TURNS} rounds in turns, ms of "
            f"kernels: plain median {np.median(p_ms):.3f} (min "
            f"{p_ms.min():.3f}, max {p_ms.max():.3f}; GEMMs "
            f"{np.median(p_g):.3f}), fused median {np.median(f_ms):.3f} "
            f"(min {f_ms.min():.3f}, max {f_ms.max():.3f}; GEMMs "
            f"{np.median(f_g):.3f}); fused - plain by round: median "
            f"{np.median(diff):+.3f} ({100 * np.median(diff / p_ms):+.2f}%),"
            f" min {diff.min():+.3f}, max {diff.max():+.3f}; all "
            f"{[round(float(x), 3) for x in diff]}")
    by_p, by_f = (turns[n]["prefill_by_name"] for n in ("plain", "fused"))
    moved = sorted(((by_f.get(k, 0.0) - by_p.get(k, 0.0), k)
                    for k in set(by_p) | set(by_f)), reverse=True)
    log(f"[layout-7b] prefill kernels by name, fused - plain, ms a "
        f"prefill (mean of {LAYOUT_TURNS} rounds), most up: "
        + "; ".join(f"{d:+.3f} {k[:90]}" for d, k in moved[:6])
        + "; most down: "
        + "; ".join(f"{d:+.3f} {k[:90]}" for d, k in moved[-4:]))
    torch.cuda.synchronize()
    t0 = time.time()
    params["llama"] = llama.fuse_for_serving(llama.transpose_for_serving(lp))
    torch.cuda.synchronize()
    convert_s = time.time() - t0
    lp = params["llama"]
    fused = layout_numbers(torch, mods, params, cfg, batch)
    diff_h = row_rel_l2(fused["hidden"], plain["hidden"], plain["pad"])
    floor = max(max(floor_h), 2.0 ** -8)
    log(f"[layout-7b] speculative generate, batch 2 (385 bucket, fused "
        f"encoders, 8 new tokens), [in, out] tree then converted in place "
        f"in {convert_s:.2f} s; {mods['card']}")
    for name, n in (("plain", plain), ("fused", fused)):
        log(f"[layout-7b] {name}: ids {n['ids'].tolist()}, {n['passes']} "
            f"decode passes; under the profiler {n['wall_s']:.3f} s wall, "
            f"kernels busy {n['busy_ms']:.1f} ms, device idle "
            f"{100 * n['idle']:.1f}%; products a layer "
            f"{n['products_per_layer']:g}, GEMM kernels a layer in a "
            f"32-token verify chunk {n['gemm_kernels_per_layer']:g}; "
            f"prefill (batch 2, {n['embeds'].shape[1]} tokens) "
            f"{n['prefill_ms']:.3f} ms, verify chunk {n['chunk_ms']:.3f} ms "
            "of kernels")
    log(f"[layout-7b] prefill post-norm states, fused against plain, rel "
        f"L2 by row {[f'{x:.3g}' for x in diff_h]}; floor (plain, batch 1 "
        f"against 2) {[f'{x:.3g}' for x in floor_h]}, held at "
        f"{floor:.3g}; last-position logit floor {floor_logit:.4g}")
    if plain["products_per_layer"] != 7 or fused["products_per_layer"] != 4:
        fail(f"decoder products a layer: {plain['products_per_layer']} "
             f"plain, {fused['products_per_layer']} fused (want 7, 4)")
    if max(diff_h) > floor:
        fail(f"the fused layout's prefill states differ from the plain "
             f"layout's by {diff_h}, past the bf16 floor {floor}")
    ties = []
    for r in range(2):
        a, b = plain["ids"][r].tolist(), fused["ids"][r].tolist()
        if a == b:
            continue
        j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        logits = teacher_forced_logits(torch, mods, lp, cfg, plain,
                                       plain["ids"], r, j)
        top = logits.topk(2).values
        gap = float(top[0] - top[1])
        ties.append((r, j, gap))
        log(f"[layout-7b] row {r} differs at output {j} ({a[j]} plain, "
            f"{b[j]} fused): top-two logit gap there {gap:.4g} "
            f"(teacher-forced on the converted tree), logit floor "
            f"{floor_logit:.4g}")
        if gap > 2 * floor_logit + 2.0 ** -8 * float(top[0].abs()):
            fail(f"layouts: row {r} output {j} differs at a logit gap of "
                 f"{gap}, not a near tie (floor {floor_logit})")
    log(f"[phase 10] (b) layouts in {time.time() - t_phase:.1f} s")
    return {"plain": {k: v for k, v in plain.items()
                      if k not in ("hidden", "embeds", "pad", "ids")},
            "fused": {k: v for k, v in fused.items()
                      if k not in ("hidden", "embeds", "pad", "ids")},
            "ties": ties, "prefill_rel_l2": diff_h, "floor": floor,
            "turns": {n: {k: v for k, v in d.items()
                          if k != "prefill_by_name"}
                      for n, d in turns.items()}}


def cache_write_bytes(program) -> dict:
    """The bytes the exported graph's writes move: the destinations of its
    in-place copies (an in-place index_copy_, a decode slot's cache write,
    its source), and the whole outputs of any functional scatter or
    index_copy (a write made functional copies its whole buffer)."""
    total = {"copy_": 0, "scatter": 0}
    for node in program.graph.nodes:
        if node.op != "call_function":
            continue
        name = str(node.target)
        in_place = name.endswith("copy_.default")
        if "index_copy" in name:
            val = (node.args[3] if in_place else node).meta.get("val")
        elif "copy_" in name:
            val = node.args[0].meta.get("val")
        else:
            val = node.meta.get("val")
        if val is None or not hasattr(val, "numel"):
            continue
        nbytes = val.numel() * val.element_size()
        if "copy_" in name and in_place:
            total["copy_"] += nbytes
        elif "scatter" in name or "index_put" in name or \
                "index_copy" in name:
            total["scatter"] += nbytes
    return total


def export_7b(torch, flash, mods, params, cfg, images) -> dict:
    """Phase 10(b), the exported generate, run in phase 4 on its anyref_7b
    weights after layouts_7b converted them: export_generate on "fused",
    greedy, EXPORT_MNT_7B new tokens, batch 1 in the 385 bucket, of the
    tree cut to EXPORT_LAYERS_7B decoder layers at full width (the free
    disk space checked first), to a temporary directory deleted after;
    export seconds, artifact bytes, load seconds, the graph's write bytes;
    then on requests 0 and 1 the program against eager generate on the
    same cut tree: ids, [SEG] slots and masks bit-equal, the same launches, and each one's wall and device time warm."""
    import tempfile
    t_phase = time.time()
    n = EXPORT_LAYERS_7B
    lcfg = dataclasses.replace(cfg.llama, num_layers=n)
    cut_cfg = dataclasses.replace(cfg, llama=lcfg)
    cut = dict(params, llama=dict(params["llama"],
                                  layers=params["llama"]["layers"][:n]))
    nbytes = tensor_bytes(cut)
    prompts = [{k: v[r:r + 1] for k, v in bucket_batch(
        torch, mods, cfg, images[:2], TEXTS[:2],
        EXPORT_PROMPT_LEN_7B).items()} for r in range(2)]
    with tempfile.TemporaryDirectory() as tmp:
        free = shutil.disk_usage(tmp).free
        log(f"[export-7b] the tree cut to {n} of {cfg.llama.num_layers} "
            f"decoder layers at full width: {nbytes / 2**30:.2f} GiB of "
            f"tensors; {free / 2**30:.1f} GiB free on the temporary "
            "directory's disk")
        if free < 1.5 * nbytes:
            fail(f"export_generate at anyref_7b: {free} bytes free for "
                 f"{nbytes} bytes of weights")
        art = os.path.join(tmp, "generate-7b.pt2")
        before = read_launches(flash)
        t0 = time.time()
        mods["export"].export_generate(
            cut, cut_cfg, art, prompt_len=EXPORT_PROMPT_LEN_7B,
            max_new_tokens=EXPORT_MNT_7B, device="cuda",
            encoder_path="fused")
        export_s = time.time() - t0
        if read_launches(flash) != before:
            fail("export_generate at anyref_7b launched kernels while "
                 "tracing")
        size = os.path.getsize(art)
        t0 = time.time()
        program = torch.export.load(art)
        module = program.module()
        torch.cuda.synchronize()
        load_s = time.time() - t0
        writes = cache_write_bytes(program)
        del program
        rows = []
        for r, prompt in enumerate(prompts):
            args = (prompt["input_ids"].int(), prompt["clip_images"],
                    prompt["sam_images"])

            def eager():
                return mods["anyref"].generate(
                    cut, cut_cfg, prompt, max_new_tokens=EXPORT_MNT_7B,
                    encoder_path="fused")
            zero_launches(flash)
            want = eager()
            torch.cuda.synchronize()
            w_launch = read_launches(flash)
            zero_launches(flash)
            got = module(*args)
            torch.cuda.synchronize()
            g_launch = read_launches(flash)
            rel = rel_err(got[1].float().cpu(),
                          want.low_res_masks.float().cpu())
            if not torch.equal(got[0].cpu(), want.output_ids.cpu()) or \
                    not torch.equal(got[2].cpu(), want.seg_valid.cpu()) or \
                    not torch.equal(got[1], want.low_res_masks) or \
                    g_launch != w_launch:
                fail(f"exported generate at anyref_7b, request {r}: ids "
                     f"{got[0].tolist()} / {want.output_ids.tolist()}, "
                     f"[SEG] {got[2].tolist()} / {want.seg_valid.tolist()}, "
                     f"masks {rel} apart (bit equality wanted), launches "
                     f"{g_launch} / {w_launch}")
            _, e_wall, e_busy, _ = profiled_busy(torch, eager)
            _, p_wall, p_busy, _ = profiled_busy(torch, lambda: module(*args))
            rows.append({"ids": got[0].tolist(),
                         "eager_wall_s": e_wall, "eager_busy_ms": e_busy,
                         "program_wall_s": p_wall, "program_busy_ms": p_busy,
                         "eager_decode_passes": int(want.decode_passes)})
            log(f"[export-7b] request {r}: ids {got[0].tolist()}, [SEG] "
                f"slots and masks bit-equal to eager generate, launches as "
                f"eager "
                f"({json.dumps({k: v for k, v in g_launch.items() if v})}); "
                f"warm under the profiler: program {p_wall:.3f} s wall, "
                f"{p_busy:.1f} ms of kernels ({EXPORT_MNT_7B} steps); eager "
                f"{e_wall:.3f} s wall, {e_busy:.1f} ms of kernels "
                f"({int(want.decode_passes)} steps, early exit)")
        del module
    steps = EXPORT_MNT_7B
    log(f"[export-7b] export_generate(anyref_7b cut to {n} layers, "
        f"\"fused\", prompt_len {EXPORT_PROMPT_LEN_7B}, max_new_tokens "
        f"{steps}): {export_s:.1f} s, {size} bytes ({size / 2**30:.2f} GiB); "
        f"torch.export.load + module() {load_s:.1f} s; the graph's writes: "
        f"in-place copies {writes['copy_']} bytes, functional scatters "
        f"{writes['scatter']} bytes a run; {mods['card']}")
    log(f"[phase 10] (b) export in {time.time() - t_phase:.1f} s")
    return {"layers": n, "export_s": export_s, "bytes": size,
            "load_s": load_s, "writes": writes, "rows": rows}


# ---------------------------------------------------------------------------
# phase 13: the Predictor's compiled request program (one CUDA graph a key)
# ---------------------------------------------------------------------------
# (a): anyref_tiny's decode budget; the speculative case's acceptance cap
GRAPH_MNT_TINY = 4
GRAPH_MAX_ACCEPT = 3
# (b): the 4 requests served this many times through each steady Server
GRAPH_ROUNDS_7B = 3
GRAPH_PIPELINE_DEPTH = 3


def graph_batches(cfg, mods, kinds) -> dict:
    """{kind: the Server's collation (uint8 images) of two requests}:
    "text" (TEXTS[0:2] on request_images()[0:2]), "crop", "box" and
    "audio" (a crop, a box or an audio request beside a text one, on
    request_images()[3])."""
    images = request_images()
    image = images[3]
    h, w = image.shape[:2]
    ds = mods["SegDataset"](cfg, uint8_images=True)
    tok = mods["AnyRefTokenizer"]()
    q_img = mods["img_ref_question"]()

    def text(i, im=None):
        return ds.make_sample(images[i] if im is None else im,
                              mods["seg_question"](TEXTS[i]), None, None)
    rows = {
        "text": lambda: [text(0), text(1)],
        "crop": lambda: [ds.make_sample(image, q_img, None, None,
                                        ref_image=mods["crop_box_np"](
                                            image, np.asarray(REF_CROP_XYXY))),
                         text(3)],
        "box": lambda: [ds.make_sample(
            image, q_img, None, None,
            ref_bbox=np.asarray(REF_ROI_XYXY, np.float32)
            / np.asarray([w, h, w, h], np.float32)), text(3)],
        "audio": lambda: [text(3), ds.make_sample(
            image, mods["audio_ref_question"](), None, None,
            audio_mels=mods["mel"].audio_to_mel_clips(
                reference_waveform(), device="cpu").numpy())]}
    return {k: mods["Collator"](tok, cfg, roi=k == "box")(rows[k]())
            for k in kinds}


def fetched(pred, handle) -> dict:
    """A handle's fetched results (ids, [SEG] slots, decode passes, the
    real rows' low-res logits in fp32), then complete()."""
    (meta, low), _, B = handle
    m = meta.cpu().numpy()
    out = {"ids": m[:B, :pred.mnt], "seg": m[:B, pred.mnt:-1],
           "passes": int(m[:, -1].max()),
           "low": low[:B].float().cpu().numpy()}
    pred.complete(handle)
    return out


def same_tokens(a: dict, b: dict) -> bool:
    return (np.array_equal(a["ids"], b["ids"])
            and np.array_equal(a["seg"], b["seg"])
            and a["passes"] == b["passes"])


def mask_rel(a: dict, b: dict) -> float:
    """Largest |a - b| over b's largest magnitude (the slice's measure)."""
    return float(np.abs(a["low"] - b["low"]).max()
                 / max(np.abs(b["low"]).max(), 1e-30))


def graph_key(torch, flash, pred, batch, what: str) -> dict:
    """A key's first call on the card Predictor (the eager run that
    warms it, then the capture) and its second (a replay): the replay
    makes no read from the device (set_sync_debug_mode("error")), captures
    nothing, launches every kernel as many times as the eager run did, and
    runs the loop's condition kernel once before the loop and once after
    each pass: all counted on the card (ops/flash.py launch_counts)."""
    zero_launches(flash)
    n_keys = len(pred.programs)
    first = fetched(pred, pred.predict_async(batch))
    eager_launches = read_launches(flash)
    eager_reduces = flash.launch_counts()["all_reduce"]
    if len(pred.programs) != n_keys + 1:
        fail(f"{what}: the first call of a key captured "
             f"{len(pred.programs) - n_keys} programs, want 1")
    programs = dict(pred.programs)
    zero_launches(flash)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = pred.predict_async(batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    again = fetched(pred, handle)
    graph_launches = read_launches(flash)
    counts = flash.launch_counts()
    cond = counts["loop_condition"]
    if pred.programs != programs or any(
            pred.programs[k] is not programs[k] for k in programs):
        fail(f"{what}: the second call of a key captured again")
    if graph_launches != eager_launches or \
            counts["all_reduce"] != eager_reduces:
        fail(f"{what}: the replay launched {graph_launches} and "
             f"{counts['all_reduce']} all-reduces, the eager run "
             f"{eager_launches} and {eager_reduces}")
    if cond != again["passes"] + 1:
        fail(f"{what}: the replay ran the loop's condition kernel {cond} "
             f"times for {again['passes']} passes, want passes + 1")
    if not same_tokens(again, first):
        fail(f"{what}: the replay gave ids {again['ids'].tolist()}, [SEG] "
             f"{again['seg'].tolist()}, {again['passes']} passes; the eager "
             f"run {first['ids'].tolist()}, {first['seg'].tolist()}, "
             f"{first['passes']}")
    return {"eager": first, "graph": again, "launches": graph_launches,
            "conditions": cond,
            "all_reduces": (eager_reduces, counts["all_reduce"])}


def following(torch, mods, pred, batch, ids, speculative: bool):
    """``pred``'s results on ``batch`` with its greedy picks lifted to the
    card's ``ids`` (FollowIds; on a speculative Predictor only the first
    token, which the prefill's logits choose, the verify chunks' picks its
    own), and each lifted step's logit gap (FollowIds.gaps)."""
    llama = mods["llama"]
    follow = FollowIds(torch, llama.logits)
    follow.start(ids)

    def first_only(params, hidden, group=None):
        if hidden.dim() == 2:
            return follow(params, hidden, group)
        return follow.real(params, hidden, group)
    llama.logits = first_only if speculative else follow
    try:
        return fetched(pred, pred.predict_async(batch)), follow.gaps
    finally:
        llama.logits = follow.real


def graph_tiny_case(torch, flash, mods, cfg, what: str, kinds, quant=None,
                    **kw) -> None:
    """One Predictor on the card (seed-0 bf16 weights, or their int8
    decoder with ``quant``) against a Predictor of the same weights on the
    CPU, whose decode loop is the host loop, key by key (graph_key): ids,
    [SEG] slots and decode passes equal, masks within SLICE_REL_TOL. Where
    the ids differ, the CPU runs again with its picks lifted to the card's
    (``following``), and each pick it did not make itself must lie within
    INV_LOGIT_TOL of its top logit (a near tie, which the two devices' bf16
    roundings break apart), as phase 8 holds the inverse eval. Prints each
    key's capture seconds, and the pool's bytes after each capture against
    each key's pool alone."""
    def tree(device):
        p = mods["tparams"].init(cfg, torch.Generator().manual_seed(0),
                                 torch.bfloat16, device="cpu")
        if quant is not None:
            p["llama"] = quant.quantize_llama(p["llama"])
        return p if device == "cpu" else _to_device(p, device)

    def predictor(params, device):
        return mods["Predictor"](params, cfg, max_new_tokens=GRAPH_MNT_TINY,
                                 device=device, **kw)
    card, cpu = predictor(tree("cuda"), "cuda"), predictor(tree("cpu"), "cpu")
    batches = graph_batches(cfg, mods, kinds)
    pools, bad = [], []
    for kind, batch in batches.items():
        res = graph_key(torch, flash, card, batch, f"{what}, {kind}")
        want = fetched(cpu, cpu.predict_async(batch))
        got = res["graph"]
        ties = ""
        if not np.array_equal(got["ids"], want["ids"]):
            own = want["ids"].tolist()
            want, gaps = following(torch, mods, cpu, batch, got["ids"],
                                   kw.get("speculative", False))
            ties = (f" (the CPU's own ids {own}; following the card's, its "
                    f"largest logit gap at a lifted pick {max(gaps):.4g}, "
                    f"limit {INV_LOGIT_TOL})")
            if max(gaps) > INV_LOGIT_TOL:
                bad.append(f"{kind}: the card's ids {got['ids'].tolist()} "
                           f"differ from the CPU's {own} at a logit gap of "
                           f"{max(gaps)}, not a near tie")
        rel = mask_rel(got, want)
        bits = np.array_equal(got["low"], res["eager"]["low"])
        pools.append(card.graph_pool_bytes())
        prog = list(card.programs.values())[-1]
        log(f"[graph-tiny] {what}, {kind}: ids {got['ids'].tolist()}, [SEG] "
            f"{got['seg'].tolist()}, {got['passes']} decode passes, equal to "
            f"the CPU host loop's: {same_tokens(got, want)}{ties}; masks "
            f"against the CPU max rel err {rel:.4g} (limit "
            f"{SLICE_REL_TOL}), against the eager run on the card bit-equal "
            f"{bits}; launches {sum(res['launches'].values())} (the eager "
            f"run's), condition kernel {res['conditions']} runs; capture "
            f"{prog.capture_s:.3f} s, pool {pools[-1]} bytes")
        if not same_tokens(got, want):
            bad.append(f"{kind}: ids {got['ids'].tolist()} / "
                       f"{want['ids'].tolist()}, [SEG] {got['seg'].tolist()}"
                       f" / {want['seg'].tolist()}, passes {got['passes']} / "
                       f"{want['passes']}")
        if rel > SLICE_REL_TOL or not np.isfinite(got["low"]).all():
            bad.append(f"{kind}: mask max rel err {rel}")
    if bad:
        fail(f"graph program ({what}) on the card against the CPU: {bad}")
    # one more replay under torch.profiler: did the profile keep every run
    # of the loop's condition kernel the card counted (printed, not held)
    from torch.profiler import ProfilerActivity, profile
    mark = launch_mark(flash, "loop_condition")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fetched(card, card.predict_async(next(iter(batches.values()))))
        torch.cuda.synchronize()
    lost = loop_records_lost(torch, flash, prof, mark)
    log(f"[graph-tiny] {what}: one replay under torch.profiler, busy "
        f"{lost or 'measured: it kept every condition kernel run'}")
    if len(batches) > 1:
        alone = []
        for kind, batch in batches.items():
            p = predictor(tree("cuda"), "cuda")
            fetched(p, p.predict_async(batch))
            alone.append(p.graph_pool_bytes())
            del p
        log(f"[graph-tiny] {what}: one pool for {len(batches)} keys, "
            f"{pools} bytes after each capture; each key's pool alone "
            f"{alone} (largest {max(alone)}, sum {sum(alone)})")
        if pools[-1] >= sum(alone):
            fail(f"{what}: the shared pool holds {pools[-1]} bytes, the "
                 f"keys' pools alone {alone}: not shared")


def graph_tiny(torch, flash, mods, tiny, tiny512) -> None:
    """Phase 13(a): the compiled program at anyref_tiny, greedy on
    "unfused" (text, crop, box and audio keys in one Predictor), speculative
    with force_accept and max_accept on "fused" at the 512-pixel SAM, and
    greedy on the int8 decoder."""
    t0 = time.time()
    graph_tiny_case(torch, flash, mods, tiny, "unfused, greedy",
                    ("text", "crop", "box", "audio"),
                    encoder_path="unfused")
    graph_tiny_case(torch, flash, mods, tiny512,
                    "fused, speculative, force_accept",
                    ("text",), encoder_path="fused", speculative=True,
                    max_accept=GRAPH_MAX_ACCEPT, force_accept=True)
    graph_tiny_case(torch, flash, mods, tiny512, "fused, speculative",
                    ("text", "crop"), encoder_path="fused", speculative=True)
    graph_tiny_case(torch, flash, mods, tiny, "fused, int8 greedy",
                    ("text",), quant=mods["quant"], encoder_path="fused")
    log(f"[phase 13] (a) in {time.time() - t0:.1f} s")


def eager_generate(torch, mods, pred, batch):
    """``pred``'s program on ``batch`` run eagerly, as a key's first call
    runs it before its capture: the same upload, anyref.generate's prefix
    (generate_program, through the Predictor's device normalisation), its
    host loop (run_loop) and its suffix with the Predictor's packing.
    Returns a handle for pred.complete(); captures nothing."""
    host, _, B = pred._inputs(batch)
    dev = {k: torch.from_numpy(v).to(pred.device) for k, v in host.items()}
    with torch.inference_mode():
        loop, finish = pred._program(dev)
        return finish(mods["anyref"].run_loop(loop)), batch, B


def eager_server(torch, mods, server):
    """``server`` with its Predictor running eager_generate on every batch:
    the same Server, batches and Predictor code without the compiled
    program, so host hooks inside generate run on every batch."""
    pred = server.predictor
    pred.predict_async = lambda batch: eager_generate(torch, mods, pred,
                                                      batch)
    return server


def loop_records_lost(torch, flash, prof, mark):
    """None where the profile ``prof`` holds one record for each run of
    the loop's condition kernel since ``mark`` (launch_mark of
    "loop_condition", taken before the profile began), else why its busy
    time is not measured: torch.profiler can lose or repeat the records of
    a compiled program's loop (a CUDA graph's conditional node), and the
    card's count of the condition kernel shows it."""
    ran = int(launch_mark(flash, "loop_condition") - mark)
    kept = sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "anyref_loop_condition" in e.name)
    if kept == ran:
        return None
    return (f"not measured: the profile holds {kept} records of the "
            f"loop's condition kernel, the card counted {ran} runs, so its "
            f"records of the compiled loop are not the card's")


def timed_dispatch(torch, pred, batch, dispatch) -> tuple:
    """(s for ``dispatch(batch)`` to return, ms of the batch's device work
    from the dispatch's first to its last op on the stream: CUDA
    events)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    t0 = time.perf_counter()
    handle = dispatch(batch)
    ret = time.perf_counter() - t0
    e1.record()
    torch.cuda.synchronize()
    fetched(pred, handle)
    return ret, e0.elapsed_time(e1)


def serve_rounds(torch, flash, server, Request, images, rounds: int,
                 profiled: bool = False) -> dict:
    """The 4 requests submitted ``rounds`` times at once: wall, q/s, the
    batches' device spans (DispatchSpans: "span_s", and the idle share
    they leave at least, "idle_min") and, under torch.profiler, the
    device's busy and idle share (None, with the reason in "lost", where
    the profile lost records of a compiled loop: loop_records_lost)."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
        if profiled else None
    mark = launch_mark(flash, "loop_condition")
    if prof is not None:
        prof.__enter__()
    try:
        with DispatchSpans(torch, server.predictor) as spans:
            t0 = time.time()
            reqs = [server.submit(Request(image=im, text=t))
                    for _ in range(rounds) for im, t in zip(images, TEXTS)]
            results = [r.result(timeout=600) for r in reqs]
            torch.cuda.synchronize()
            wall = time.time() - t0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    if not all(r and "error" not in r for r in results):
        fail(f"graph serving: a request failed: "
             f"{[r.get('error') for r in results if r and 'error' in r]}")
    out = {"wall_s": wall, "qps": len(reqs) / wall, "results": results,
           "span_s": spans.seconds(), "idle_min": 1 - spans.seconds() / wall}
    if prof is not None:
        busy = sum(e.device_time_total for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
        lost = loop_records_lost(torch, flash, prof, mark)
        out.update(busy_s=None if lost else busy,
                   idle=None if lost else 1 - busy / wall, lost=lost)
    return out


def graph_vs_eager(torch, flash, mods, params, cfg, batch, what: str,
                   per_batch, speculative: bool, int8_per_pass=None) -> dict:
    """One batch at anyref_7b through a serving Predictor on "fused": its
    compiled program (graph_key) against eager generate on the same tree
    (eager_generate): ids, [SEG] slots and decode passes equal; the
    low-res logits bit-equal, or within PARALLEL_FLOOR_FACTOR x the bf16
    floor (eager generate with the decoder's inputs moved by one ulp)
    measured here; the replay's launches, counted on the card, those of
    phase 4 a batch (int8_matmul int8_per_pass a decoder pass: the prefill
    and each pass of the loop). Prints predict_async's return time against
    the batch's device time, beside eager generate's, the capture seconds
    and the pool's bytes."""
    kw = dict(max_batch=2, speculative=speculative, max_new_tokens=8,
              encoder_path="fused")
    pred = mods["serving_predictor"](params, cfg, **kw)
    res = graph_key(torch, flash, pred, batch, what)
    got = res["graph"]
    prog = next(iter(pred.programs.values()))

    def eager(b):
        return eager_generate(torch, mods, pred, b)
    want = fetched(pred, eager(batch))
    if not same_tokens(got, want):
        fail(f"{what}: the program gave ids {got['ids'].tolist()}, [SEG] "
             f"{got['seg'].tolist()}, {got['passes']} passes; eager "
             f"generate {want['ids'].tolist()}, {want['seg'].tolist()}, "
             f"{want['passes']}")
    bits = np.array_equal(got["low"], want["low"])
    rel = rel_l2(got["low"], want["low"])
    floor = None
    if not bits:
        inner = mods["anyref"].assemble_embeds
        mods["anyref"].assemble_embeds = nudged(torch, inner)
        try:
            moved = fetched(pred, eager(batch))
        finally:
            mods["anyref"].assemble_embeds = inner
        floor = max(rel_l2(moved["low"], want["low"]), 2.0 ** -8)
        if rel > PARALLEL_FLOOR_FACTOR * floor:
            fail(f"{what}: the program's low-res logits are {rel} from "
                 f"eager, past {PARALLEL_FLOOR_FACTOR} x the floor {floor}")
    want_launches = dict(per_batch)
    if int8_per_pass is not None:
        want_launches["int8_matmul"] = int8_per_pass * (1 + got["passes"])
    if res["launches"] != want_launches:
        fail(f"{what}: the replay launched {res['launches']} a batch, want "
             f"{want_launches}")
    g_ret, g_dev = timed_dispatch(torch, pred, batch, pred.predict_async)
    e_ret, e_dev = timed_dispatch(torch, pred, batch, eager)
    out = {"ids": got["ids"].tolist(), "passes": got["passes"],
           "masks_bit_equal": bits, "mask_rel_l2": rel, "floor": floor,
           "capture_s": prog.capture_s,
           "pool_bytes": pred.graph_pool_bytes(),
           "return_s": g_ret, "device_ms": g_dev,
           "eager_return_s": e_ret, "eager_device_ms": e_dev,
           "launches": sum(res["launches"].values()),
           "conditions": res["conditions"]}
    by_pass = " (int8_matmul by decoder pass)" if int8_per_pass else ""
    log(f"[graph-7b] {what}: ids {out['ids']} and [SEG] slots equal to "
        f"eager generate, {got['passes']} decode passes in both; low-res "
        f"logits bit-equal {bits} (rel L2 {rel:.4g}"
        f"{'' if floor is None else f', floor {floor:.4g}'}); the replay "
        f"launched those of phase 4 a batch{by_pass}, {out['launches']} "
        f"launches of the port's kernels, the condition kernel "
        f"{res['conditions']} times (card counts); "
        f"predict_async returns in {1e3 * g_ret:.3f} ms against "
        f"{g_dev:.3f} ms of device work (eager generate: "
        f"{1e3 * e_ret:.3f} ms, {e_dev:.3f} ms); capture "
        f"{prog.capture_s:.3f} s, pool "
        f"{out['pool_bytes'] / 2**30:.3f} GiB; {mods['card']}")
    del pred
    torch.cuda.empty_cache()
    return out


def graph_7b(torch, flash, mods, params, cfg, per_batch) -> dict:
    """Phase 13(b), run in phase 4 on its weights (speculative, "fused",
    the serving layout): graph_vs_eager on the first two requests, then
    the 4 requests through a Server of pipeline_depth 3: a first round
    (each key's eager run and capture), ids equal to eager, then
    GRAPH_ROUNDS_7B rounds at once, warm, beside the same rounds through
    a Server whose Predictor runs eager generate (eager_server): wall, q/s,
    the batches in flight at each dispatch, then both again under
    torch.profiler for the device's idle share."""
    t_phase = time.time()
    Server, Request = mods["Server"], mods["Request"]
    images = request_images()
    batch = graph_batches(cfg, mods, ("text",))["text"]
    one = graph_vs_eager(torch, flash, mods, params, cfg, batch,
                         "fused, speculative", per_batch, speculative=True)
    kw = dict(max_batch=2, speculative=True, max_new_tokens=8,
              encoder_path="fused", pipeline_depth=GRAPH_PIPELINE_DEPTH)
    servers = {"graph": Server(params, cfg, **kw),
               "eager": eager_server(torch, mods, Server(params, cfg, **kw))}
    flight = {"dispatched": 0, "completed": 0, "most": 0, "queued": 0}
    pred = servers["graph"].predictor
    inner_pa, inner_c = pred.predict_async, pred.complete

    def predict_async(b):
        out = inner_pa(b)
        flight["dispatched"] += 1
        flight["most"] = max(flight["most"],
                             flight["dispatched"] - flight["completed"])
        flight["queued"] = max(flight["queued"],
                               servers["graph"]._fin_q.qsize())
        return out

    def complete(handle):
        out = inner_c(handle)
        flight["completed"] += 1
        return out
    pred.predict_async, pred.complete = predict_async, complete
    runs, idle_min = {}, {}
    try:
        first = {k: serve_rounds(torch, flash, s, Request, images, 1)
                 for k, s in servers.items()}
        for i, (a, b) in enumerate(zip(first["graph"]["results"],
                                       first["eager"]["results"])):
            if not np.array_equal(a["output_ids"], b["output_ids"]) or \
                    (a["mask_logits"] is None) != (b["mask_logits"] is None):
                fail(f"graph Server, request {i}: ids "
                     f"{a['output_ids'].tolist()}, eager "
                     f"{b['output_ids'].tolist()}")
        for k, s in servers.items():
            s.reset_stats()
        flight.update(dispatched=0, completed=0, most=0, queued=0)
        for k in ("eager", "graph", "graph", "eager"):
            r = serve_rounds(torch, flash, servers[k], Request, images,
                             GRAPH_ROUNDS_7B)
            runs.setdefault(k, []).append(r["wall_s"])
            idle_min.setdefault(k, []).append(r["idle_min"])
        stats = {k: dict(s.stats) for k, s in servers.items()}
        prof = {k: serve_rounds(torch, flash, s, Request, images,
                                GRAPH_ROUNDS_7B, profiled=True)
                for k, s in servers.items()}
    finally:
        for s in servers.values():
            s.shutdown()
    n = GRAPH_ROUNDS_7B * len(TEXTS)
    out = {"one_batch": one, "in_flight_most": flight["most"],
           "queued_most": flight["queued"],
           "first_round_s": {k: v["wall_s"] for k, v in first.items()}}
    for k in servers:
        out[k] = {"wall_s": runs[k], "qps": [n / w for w in runs[k]],
                  "profiled_wall_s": prof[k]["wall_s"],
                  "busy_s": prof[k]["busy_s"], "idle": prof[k]["idle"],
                  "profile_lost": prof[k]["lost"],
                  "idle_min": idle_min[k],
                  "dispatch_ms": stats[k]["dispatch_ms"] / stats[k]["batches"],
                  "fetch_ms": stats[k]["fetch_ms"] / stats[k]["batches"]}
        busy = (prof[k]["lost"] if prof[k]["lost"] else
                 f"{prof[k]['busy_s']:.3f} s -> device idle "
                 f"{100 * prof[k]['idle']:.1f}%")
        log(f"[graph-7b] {k} Server (pipeline_depth "
            f"{GRAPH_PIPELINE_DEPTH}), {n} requests a round, "
            f"{stats[k]['rows']} rows in {stats[k]['batches']} batches over "
            f"its two rounds, warm: walls {[round(w, 3) for w in runs[k]]} "
            f"s -> "
            f"{[round(q, 3) for q in out[k]['qps']]} q/s, device idle at "
            f"least {[round(100 * x, 1) for x in idle_min[k]]}% (the "
            f"batches' CUDA-event spans); dispatch "
            f"{out[k]['dispatch_ms']:.2f} ms a batch, fetch "
            f"{out[k]['fetch_ms']:.2f} ms; under torch.profiler "
            f"{prof[k]['wall_s']:.3f} s wall, kernels busy {busy}; "
            f"{mods['card']}")
    log(f"[graph-7b] the graph Server's batches in flight at a dispatch: "
        f"at most {flight['most']} (dispatched, not yet completed), the "
        f"completion queue holding at most {flight['queued']} of them "
        f"(pipeline_depth {GRAPH_PIPELINE_DEPTH}); first round (eager "
        f"warm-up and capture "
        f"of the key) {first['graph']['wall_s']:.2f} s, eager Server "
        f"{first['eager']['wall_s']:.2f} s")
    if flight["most"] < 2:
        fail(f"graph Server: at most {flight['most']} batch in flight at a "
             f"dispatch: predict_async did not return before its batch ran")
    log(f"[phase 13] (b) in {time.time() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 11: multi-device serving on torch.distributed
# ---------------------------------------------------------------------------
# each rank's collective timeout; the phase's ranks are joined within
# PARALLEL_JOIN_S
PARALLEL_TIMEOUT_S = 240.0
PARALLEL_JOIN_S = 400.0
PARALLEL_MNT = 8
# one rank's prefill attention under a "model" axis of 2: batch 2, 16 of
# LLaMA-7B's 32 heads, the 385 bucket + 255 image tokens
PARALLEL_CAUSAL_SHAPE = (2, 16, 640, 128)


def run_ranks(task: str, world: int, timeout_s: float = PARALLEL_TIMEOUT_S,
              **kw) -> list:
    """``task`` on ``world`` spawned ranks of cuda:0 over gloo (a FileStore
    in a temporary directory, ``timeout_s`` on every collective and on the
    all-reduce kernel's waits); every rank's result in rank order. A rank
    that fails, or no result within PARALLEL_JOIN_S, fails the run; every
    rank is joined or killed before this returns."""
    import multiprocessing as mp
    import queue
    import tempfile
    import torch
    # the ranks share the card with this process: free what it caches
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[ranks] {task}: this process holds "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB of the card "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="anyref_ranks_")
    procs = [ctx.Process(target=parallel_rank,
                         args=(r, world, os.path.join(tmp, "store"), task, kw,
                               q, timeout_s), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, error = {}, None
    try:
        deadline = time.time() + PARALLEL_JOIN_S
        while len(results) < world and error is None:
            try:
                rank, ok, out = q.get(timeout=max(1.0, deadline - time.time()))
            except queue.Empty:
                error = (f"{task}: no result from ranks "
                         f"{sorted(set(range(world)) - set(results))} within "
                         f"{PARALLEL_JOIN_S} s")
                break
            if ok:
                results[rank] = out
            else:
                error = f"{task}, rank {rank}:\n{out}"
    finally:
        for p in procs:
            p.join(timeout=30 if error is None else 1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    if error is not None:
        fail(error)
    return [results[r] for r in range(world)]


def parallel_rank(rank, world, store, task, kw, q, timeout_s):
    """A spawned rank: joins the process group (``timeout_s`` on its
    collectives), runs the task, puts (rank, ok, result or traceback)."""
    import traceback
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    try:
        from anyref_tpu_torch.parallel.mesh import init_process_group
        init_process_group(rank, world, f"file://{store}", "gloo",
                           timeout_s=timeout_s)
        fn = {"all_reduce": all_reduce_rank,
              "all_reduce_timeout": absent_rank,
              "tiny": parallel_tiny_rank, "7b": parallel_7b_rank,
              "7b_data": parallel_7b_data_rank,
              "train_tiny": train_tiny_rank, "train_7b": train_7b_rank}[task]
        # each task closes its mesh (Mesh.close) before it returns
        out = fn(torch, rank, **kw)
        q.put((rank, True, out))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# phase 11(0): the all-reduce kernel (csrc/all_reduce.cu) on two ranks
# ---------------------------------------------------------------------------
# the kernel phase's collective timeout (the kernel's waits trap after it)
ALL_REDUCE_TIMEOUT_S = 60.0
# launches timed back to back a case, plain and library calls timed
ALL_REDUCE_ITERS, ALL_REDUCE_HOST_ITERS = 20, 3
# replays of one captured call, each checked
ALL_REDUCE_REPLAYS = 100
# the run where rank 1 never arrives: the kernel's wait bound, and the
# margin past it within which rank 0 must have failed (the trap, its
# report at the synchronize, the other context's time slices)
ALL_REDUCE_TRAP_S, ALL_REDUCE_TRAP_MARGIN_S = 5.0, 15.0
# the case the kernels line leads with: a prefill's row-parallel sum
ALL_REDUCE_HEAD = ("prefill", "float32")


def all_reduce_cases(vocab: int) -> tuple:
    """(name, shape): one element, then the sums the programs issue at
    anyref_7b, batch 2: a decode pass's and a verify chunk's hidden rows
    (of 32 draft tokens), a prefill's (the 385 bucket + 255 image tokens),
    training's (512 + 255 tokens), a decode pass's logits and training's
    (the largest the programs issue; ``vocab`` the padded vocabulary)."""
    return (("one element", (1,)), ("decode pass", (2, 1, 4096)),
            ("verify chunk", (2, 32, 4096)), ("prefill", (2, 640, 4096)),
            ("training", (2, 767, 4096)), ("decode logits", (2, 1, vocab)),
            ("training logits", (2, 767, vocab)))


def all_reduce_rank(torch, rank):
    """Phase 11(0), one of two ranks on cuda:0 at mesh (1, 2): a 4-byte
    all-reduce first (1 + 2 on both ranks); opcheck of anyref::all_reduce;
    then each case of all_reduce_cases in fp32 and bf16, a draw of this
    rank's own: the kernel's sum against gloo's on the CPU copies (the
    plain version), its bits' digest, the kernel's time a call (CUDA
    events over ALL_REDUCE_ITERS launches back to back), the plain
    version's and gloo's on the card tensors (torch.distributed through
    the host, the port's route before this kernel; host clock, the card
    synchronised around each); then one call captured into a CUDA graph
    and replayed ALL_REDUCE_REPLAYS times, each replay's output against
    the eager call's, and the launch counter after the replays; then the
    mesh closed and a second one made, summed over and closed
    (mesh_cycle)."""
    import hashlib
    import torch.distributed as dist
    from anyref_tpu_torch.config import anyref_7b
    from anyref_tpu_torch.ops import flash
    from anyref_tpu_torch.parallel.mesh import make_mesh
    torch.cuda.set_device(0)
    mesh = make_mesh(1, 2, device="cuda:0", timeout_s=ALL_REDUCE_TIMEOUT_S)
    group = mesh.group("model")
    key = flash.group_key(group)
    x = torch.full((1,), float(rank + 1), device="cuda:0")
    first = float(flash.all_reduce(x, key).item())
    opcheck = torch.library.opcheck(torch.ops.anyref.all_reduce.default,
                                    (x, key))
    cases = []
    for name, shape in all_reduce_cases(anyref_7b().llama.padded_vocab_size):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda:0").manual_seed(
                1000 * rank + len(cases))
            x = torch.randn(shape, generator=g, device="cuda:0").to(dtype)
            got = flash.all_reduce(x, key).cpu()
            want = x.cpu()
            t0 = time.perf_counter()
            dist.all_reduce(want, group=group)
            first_plain = time.perf_counter() - t0
            err = float((got.float() - want.float()).abs().max())
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            e0.record()
            for _ in range(ALL_REDUCE_ITERS):
                flash.all_reduce(x, key)
            e1.record()
            torch.cuda.synchronize()
            plain, library = [first_plain], []
            for _ in range(ALL_REDUCE_HOST_ITERS):
                c = x.cpu()
                t0 = time.perf_counter()
                dist.all_reduce(c, group=group)
                plain.append(time.perf_counter() - t0)
                c = x.clone()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dist.all_reduce(c, group=group)
                torch.cuda.synchronize()
                library.append(time.perf_counter() - t0)
            cases.append({
                "name": name, "dtype": str(dtype).split(".")[-1],
                "shape": list(shape), "bytes": x.numel() * x.element_size(),
                "equal": bool(torch.equal(got, want)), "max_abs_err": err,
                "digest": hashlib.sha1(got.view(torch.uint8).numpy()
                                       ).hexdigest(),
                "ms": e0.elapsed_time(e1) / ALL_REDUCE_ITERS,
                "plain_ms": 1e3 * float(np.median(plain)),
                "library_ms": 1e3 * float(np.median(library))})
    # one call captured, replayed
    g = torch.Generator(device="cuda:0").manual_seed(7 + rank)
    x = torch.randn(2, 640, 4096, generator=g, device="cuda:0")
    ref = flash.all_reduce(x, key)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = flash.all_reduce(x, key)
    flash.reset_launch_counts()
    equal = 0
    for _ in range(ALL_REDUCE_REPLAYS):
        y.zero_()
        graph.replay()
        equal += bool(torch.equal(y, ref))
    counted = flash.launch_counts()["all_reduce"]
    return {"first": first, "opcheck": sorted(set(opcheck.values())),
            "held_bytes": mesh.exchange.held_bytes, "cases": cases,
            "replays_equal": equal, "replays_counted": counted,
            "cycle": mesh_cycle(torch, mesh, key)}


def mesh_cycle(torch, mesh, key) -> dict:
    """Phase 11(0)'s close: the library's exchange bytes with the mesh
    open, after Mesh.close, with a second (1, 2) mesh open (its 4-byte sum)
    and after its close; whether the closed key raised."""
    from anyref_tpu_torch.ops import flash
    from anyref_tpu_torch.parallel.mesh import make_mesh
    held = [flash.exchange_held_bytes()]
    mesh.close()
    held.append(flash.exchange_held_bytes())
    x = torch.full((1,), float(mesh.coords["model"] + 1), device="cuda:0")
    try:
        flash.all_reduce(x, key)
        stale = None
    except ValueError as e:
        stale = str(e)
    again = make_mesh(1, 2, device="cuda:0", timeout_s=ALL_REDUCE_TIMEOUT_S)
    held.append(flash.exchange_held_bytes())
    second = float(flash.all_reduce(
        x, flash.group_key(again.group("model"))).item())
    again.close()
    held.append(flash.exchange_held_bytes())
    return {"held": held, "stale_key": stale, "second": second}


def absent_rank(torch, rank, trap_s) -> dict:
    """Phase 11(0)'s run where rank 1 never arrives, in ranks of its own
    (rank 0's context is lost after it, and freeing a CUDA tensor there
    aborts the process): both ranks of a new group make their exchange
    with a wait bound of ``trap_s`` and open each other's; rank 0 launches
    one all-reduce and synchronises (the seconds until that raised, and
    its error), rank 1 launches none; both then meet at a host barrier, so
    rank 1's area stays mapped."""
    import torch.distributed as dist
    from anyref_tpu_torch.ops import flash
    torch.cuda.set_device(0)
    group = dist.new_group([0, 1])
    exchange = flash.DeviceExchange(rank, 2, "cuda:0", trap_s)
    handles = [None, None]
    dist.all_gather_object(handles, exchange.handle)
    exchange.open(handles)
    key = flash.register_group(group, exchange)
    out = {"error": None, "seconds": None}
    if rank == 0:
        x = torch.ones(1, device="cuda:0")
        torch.cuda.synchronize()
        t0 = time.time()
        try:
            flash.all_reduce(x, key)
            torch.cuda.synchronize()
        except RuntimeError as e:
            out["error"] = str(e).strip().splitlines()[0]
        out["seconds"] = time.time() - t0
    dist.barrier()
    return out


def check_all_reduce(torch, mods) -> dict:
    """Phase 11(0): two ranks on cuda:0. The 4-byte sum first (3.0 on both
    ranks), opcheck, every case bit-equal to gloo's sum and the same bits
    on both ranks, every captured replay equal to the eager call and
    counted on the card, the mesh closed and a second one made and closed
    with the library's exchange bytes back to 0 each time and the closed
    key raising; then, in two new ranks, the run where rank 1 never
    arrives: rank 0 must fail within ALL_REDUCE_TRAP_S +
    ALL_REDUCE_TRAP_MARGIN_S. Prints
    each case's time against its bytes bound, the plain version's and
    gloo's. Returns the kernels line's entry (launches filled in later)."""
    t0 = time.time()
    ranks = run_ranks("all_reduce", 2, timeout_s=ALL_REDUCE_TIMEOUT_S)
    for rank, res in enumerate(ranks):
        what = f"phase 11(0): rank {rank}"
        if res["first"] != 3.0:
            fail(f"{what}: the 4-byte all-reduce of 1 and 2 gave "
                 f"{res['first']}")
        if res["opcheck"] != ["SUCCESS"]:
            fail(f"{what}: opcheck of anyref::all_reduce {res['opcheck']}")
        bad = [c for c in res["cases"] if not c["equal"]]
        if bad:
            fail(f"{what}: the kernel's sum differs from gloo's: "
                 f"{[(c['name'], c['dtype'], c['max_abs_err']) for c in bad]}")
        if res["replays_equal"] != ALL_REDUCE_REPLAYS or \
                res["replays_counted"] != ALL_REDUCE_REPLAYS:
            fail(f"{what}: {res['replays_equal']} of {ALL_REDUCE_REPLAYS} "
                 f"replays equal to the eager call, "
                 f"{res['replays_counted']} counted")
        cycle, held = res["cycle"], res["held_bytes"]
        if cycle["held"] != [held, 0, held, 0] or cycle["second"] != 3.0 \
                or "closed" not in (cycle["stale_key"] or ""):
            fail(f"{what}: exchange bytes open / closed / a second mesh "
                 f"open / closed {cycle['held']} (want [{held}, 0, {held}, "
                 f"0]), the second mesh's sum {cycle['second']}, the closed"
                 f" key: {cycle['stale_key']}")
    for a, b in zip(*(r["cases"] for r in ranks)):
        if a["digest"] != b["digest"]:
            fail(f"phase 11(0): {a['name']} {a['dtype']}: the ranks' sums "
                 "differ")
    rows = []
    for c0, c1 in zip(*(r["cases"] for r in ranks)):
        nbytes = 2 * (3 + 2) * c0["bytes"]
        b_ms, b_by = bound(nbytes, 2 * np.prod(c0["shape"]),
                           H100_FP32_OPS_PER_S)
        row = {**{k: c0[k] for k in ("name", "dtype", "shape", "bytes",
                                     "max_abs_err")},
               "ms": c0["ms"], "ms_rank1": c1["ms"],
               "plain_ms": c0["plain_ms"], "library_ms": c0["library_ms"],
               "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        log(f"[all-reduce] {c0['name']} {c0['shape']} {c0['dtype']}: "
            f"{c0['ms']:.4f} ms a call (rank 1 {c1['ms']:.4f}; "
            f"{ALL_REDUCE_ITERS} back to back, CUDA events), bound "
            f"{b_ms:.4f} ms ({b_by}: 2 ranks x 5 x {c0['bytes']} B through "
            f"one card's HBM); plain (gloo on the CPU copies) "
            f"{c0['plain_ms']:.4f} ms, gloo on the card tensors "
            f"{c0['library_ms']:.4f} ms; bit-equal to gloo's sum on both "
            f"ranks")
    trap = run_ranks("all_reduce_timeout", 2, trap_s=ALL_REDUCE_TRAP_S)[0]
    if trap["error"] is None or \
            trap["seconds"] > ALL_REDUCE_TRAP_S + ALL_REDUCE_TRAP_MARGIN_S:
        fail(f"phase 11(0): with rank 1 absent, rank 0's all-reduce "
             f"{'returned' if trap['error'] is None else 'failed'} after "
             f"{trap['seconds']:.2f} s (bound {ALL_REDUCE_TRAP_S} s + "
             f"{ALL_REDUCE_TRAP_MARGIN_S} s): {trap['error']}")
    log(f"[all-reduce] rank 1 absent: rank 0 failed after "
        f"{trap['seconds']:.2f} s (wait bound {ALL_REDUCE_TRAP_S} s, margin "
        f"{ALL_REDUCE_TRAP_MARGIN_S} s): {trap['error']}")
    held = ranks[0]["held_bytes"]
    log(f"[phase 11] (0) the all-reduce kernel on two ranks of cuda:0 (one "
        f"card's contexts by time slices): 4-byte sum 3.0, opcheck, "
        f"{len(rows)} cases bit-equal to gloo and across ranks, "
        f"{ALL_REDUCE_REPLAYS} graph replays equal and counted, the mesh "
        f"closed (exchange bytes {ranks[0]['cycle']['held']}: open, closed, "
        f"a second mesh open, closed), the absent rank's trap; {held} "
        f"bytes of exchange area a rank; {mods['card']}; in "
        f"{time.time() - t0:.1f} s")
    head = next(r for r in rows if (r["name"], r["dtype"]) == ALL_REDUCE_HEAD)
    return {"name": "all_reduce", "route": "cuda",
            "source": "anyref_tpu_torch/csrc/all_reduce.cu",
            "replaces": "none: the all-reduce over \"model\" that XLA "
                        "compiles into anyref_tpu/eval/runner.py:192 and "
                        "anyref_tpu/train/trainer.py:84",
            "launches": None, "shape": head["shape"],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
            "exchange_bytes": held, "trap_s": trap["seconds"],
            "other_shapes": rows}


def parallel_tiny_rank(torch, rank, data, model, batches):
    """Phase 11(a), one rank: anyref_tiny's seed-0 bf16 weights (made on
    the CPU, as phase 3's) sharded at (data, model) on cuda:0; greedy and
    speculative generate on tiny_batch on "unfused" (this rank's rows);
    then a greedy and a speculative Predictor on "unfused", each key of
    ``batches`` (text, crop) compiled: its first call eager and captured,
    its second a replay (graph_key: no read, the eager run's launches, ids
    and passes). Returns the mesh coordinates, the exchange's bytes, the
    generated rows and each key's eager and replayed results."""
    from anyref_tpu_torch import params as tparams
    from anyref_tpu_torch.config import anyref_tiny
    from anyref_tpu_torch.eval.runner import Predictor
    from anyref_tpu_torch.models import anyref
    from anyref_tpu_torch.ops import flash
    from anyref_tpu_torch.parallel.mesh import make_mesh
    from anyref_tpu_torch.parallel.partition import shard_batch, shard_params
    cfg = anyref_tiny()
    torch.cuda.set_device(0)
    mesh = make_mesh(data, model, device="cuda:0",
                     timeout_s=PARALLEL_TIMEOUT_S)
    p = _to_device(tparams.init(cfg, torch.Generator().manual_seed(0),
                                torch.bfloat16, device="cpu"), "cuda:0")
    sp = shard_params(p, mesh, cfg)
    batch = shard_batch(tiny_batch(cfg), mesh)
    out = {"coords": mesh.coords, "exchange_bytes": mesh.exchange.held_bytes}
    for name, kw in TINY_DECODES:
        g = anyref.generate(sp, cfg, batch, max_new_tokens=4,
                            encoder_path="unfused", mesh=mesh, **kw)
        out[name] = (g.output_ids.cpu().numpy(),
                     g.low_res_masks.float().cpu().numpy())
    for name, kw in TINY_DECODES:
        pred = Predictor(sp, cfg, max_new_tokens=GRAPH_MNT_TINY,
                         encoder_path="unfused", mesh=mesh, **kw)
        for kind, b in batches.items():
            res = graph_key(torch, flash, pred, b,
                            f"phase 11(a) at ({data}, {model}), rank {rank},"
                            f" {name}, {kind}")
            out[("program", name, kind)] = {
                "eager": res["eager"], "graph": res["graph"],
                "all_reduces": res["all_reduces"],
                "capture_s": list(pred.programs.values())[-1].capture_s}
    mesh.close()
    return out


# phase 11(a)'s decodes: greedy, and speculative with drafts of 3
TINY_DECODES = (("greedy", {}), ("speculative", {"speculative": True,
                                                 "draft_len": 3}))
# phase 11(a)'s meshes: two ranks, and four on the one card
TINY_MESHES = ((1, 2), (2, 2))


def parallel_tiny(torch, mods) -> None:
    """Phase 11(a): anyref_tiny at (1, 2) and (2, 2) on cuda:0 (gloo for
    the host, the all-reduce kernel over "model"), against the single-rank
    port on the CPU from the same weights, each rank's rows against the
    CPU's rows of its data coordinate: generate greedy and speculative (ids
    equal, masks within SLICE_REL_TOL, phase 3's limit); the Predictor
    compiled on every rank, greedy and speculative, on a text and a crop
    key: the replay's ids and [SEG] slots equal to the CPU Predictor's,
    its masks within SLICE_REL_TOL and bit-equal to the key's first call,
    which launched as many all-reduces as the replay; the model ranks of
    one data coordinate the same bits."""
    t0 = time.time()
    cfg = mods["anyref_tiny"]()

    def cpu_tree():
        return mods["tparams"].init(cfg, torch.Generator().manual_seed(0),
                                    torch.bfloat16, device="cpu")
    want = mods["anyref"].generate(cpu_tree(), cfg, tiny_batch(cfg),
                                   max_new_tokens=4, device="cpu",
                                   encoder_path="unfused")
    w_ids, w_low = want.output_ids.numpy(), want.low_res_masks.float().numpy()
    batches = graph_batches(cfg, mods, ("text", "crop"))
    want_prog = {}
    for name, kw in TINY_DECODES:
        cpu = mods["Predictor"](cpu_tree(), cfg, max_new_tokens=GRAPH_MNT_TINY,
                                device="cpu", encoder_path="unfused", **kw)
        for kind, b in batches.items():
            want_prog[(name, kind)] = fetched(cpu, cpu.predict_async(b))
    for data, model in TINY_MESHES:
        ranks = run_ranks("tiny", data * model, data=data, model=model,
                          batches=batches)
        what = f"phase 11(a) at ({data}, {model})"
        for rank, res in enumerate(ranks):
            d = res["coords"]["data"]
            rows = slice(d * 2 // data, (d + 1) * 2 // data)
            for name, _ in TINY_DECODES:
                ids, low = res[name]
                rel = float(np.abs(low - w_low[rows]).max()
                            / np.abs(w_low[rows]).max())
                log(f"[parallel-tiny] ({data}, {model}) rank {rank} {name} "
                    f"generate: ids {ids.tolist()} (CPU single rank "
                    f"{w_ids[rows].tolist()}), mask max rel err {rel:.4g} "
                    f"(limit {SLICE_REL_TOL})")
                if not np.array_equal(ids, w_ids[rows]):
                    fail(f"{what}: rank {rank} {name} ids {ids.tolist()} "
                         f"differ from the CPU single rank's "
                         f"{w_ids[rows].tolist()}")
                if not np.isfinite(low).all() or rel > SLICE_REL_TOL:
                    fail(f"{what}: rank {rank} {name} masks off by {rel}")
                for kind in batches:
                    got = res[("program", name, kind)]
                    g, w = got["graph"], want_prog[(name, kind)]
                    w = {"ids": w["ids"][rows], "seg": w["seg"][rows],
                         "low": w["low"][rows]}
                    rel = mask_rel(g, w)
                    bits = np.array_equal(g["low"], got["eager"]["low"])
                    log(f"[parallel-tiny] ({data}, {model}) rank {rank} "
                        f"{name} Predictor, {kind} key compiled (capture "
                        f"{got['capture_s']:.3f} s): replay ids "
                        f"{g['ids'].tolist()}, [SEG] {g['seg'].tolist()}, "
                        f"{g['passes']} passes (CPU {w['ids'].tolist()}); "
                        f"masks max rel err {rel:.4g}, bit-equal to the "
                        f"first call {bits}; all-reduces {got['all_reduces']}"
                        f" a call")
                    if not (np.array_equal(g["ids"], w["ids"])
                            and np.array_equal(g["seg"], w["seg"])):
                        fail(f"{what}: rank {rank} {name} {kind}: the "
                             f"compiled Predictor's ids {g['ids'].tolist()} "
                             f"[SEG] {g['seg'].tolist()}, the CPU's "
                             f"{w['ids'].tolist()} {w['seg'].tolist()}")
                    if not bits or rel > SLICE_REL_TOL or \
                            not np.isfinite(g["low"]).all():
                        fail(f"{what}: rank {rank} {name} {kind}: masks off "
                             f"by {rel}, bit-equal to the first call {bits}")
                    if not got["all_reduces"] or \
                            got["all_reduces"][0] != got["all_reduces"][1]:
                        fail(f"{what}: rank {rank} {name} {kind}: "
                             f"all-reduces eager, replay "
                             f"{got['all_reduces']}")
            first = ranks[d * model]
            for key, val in res.items():
                if key not in ("coords", "exchange_bytes") and not \
                        same_result_bits(val, first[key]):
                    fail(f"{what}: rank {rank} differs from rank {d * model}"
                         f" at {key}")
        log(f"[phase 11] (a) anyref_tiny at ({data}, {model}) on cuda:0, "
            f"{data * model} ranks by time slices, the all-reduce kernel "
            f"over \"model\" ({ranks[0]['exchange_bytes']} bytes of exchange"
            f" area a rank), in {time.time() - t0:.1f} s")


def same_result_bits(a, b) -> bool:
    """Whether two nests of dicts, tuples and arrays hold the same bits
    (floats, such as capture seconds, are not compared)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(
            same_result_bits(a[k], b[k]) for k in a if k != "capture_s")
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_result_bits(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return isinstance(a, float) or a == b


def params_7b(torch, mods, cfg):
    """anyref_7b's seed-0 bf16 weights on the card with the [SEG] column x
    1000 (phase 4's)."""
    params = mods["tparams"].init(
        cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16)
    params["llama"]["lm_head"][:, cfg.tokens.seg] *= 1000.0
    return params


def record_seg_states(anyref) -> list:
    """Wrap anyref.project_seg_hidden to keep each generate's or training
    forward's [SEG] states (fp32, on the host), in order; a capture
    records nothing."""
    inner, got = anyref.project_seg_hidden, []

    def project(params, hidden):
        import torch
        if not (hidden.is_cuda and
                torch.cuda.is_current_stream_capturing()):
            got.append(hidden.detach().float().cpu().numpy())
        return inner(params, hidden)

    anyref.project_seg_hidden = project
    return got


def nudged(torch, assemble_embeds):
    """assemble_embeds with every nonzero bf16 embedding moved by one ulp,
    up or down in magnitude by a draw from a seeded generator (the same
    draws in every run)."""
    gen = torch.Generator(device="cuda").manual_seed(11)

    def assemble(*a, **kw):
        embeds, ids, labels = assemble_embeds(*a, **kw)
        step = torch.randint(0, 2, embeds.shape, generator=gen,
                             device=embeds.device, dtype=torch.int16) * 2 - 1
        moved = (embeds.view(torch.int16) + step).view(embeds.dtype)
        return torch.where(embeds != 0, moved, embeds), ids, labels

    return assemble


def request_rows(batch) -> list:
    """The request (index into TEXTS and request_images) of each row of a
    collated batch, by its image's size (IMAGE_SIZES are distinct): the
    Server's preprocess threads may hand it a pair in either order."""
    return [IMAGE_SIZES.index((int(m["height"]), int(m["width"])))
            for m in batch["_meta"]]


def record_low_res(server) -> dict:
    """Wrap the Server's Predictor.complete to keep each request's fetched
    low-res logits (fp32, on the host), by request (request_rows)."""
    pred = server.predictor
    inner, got = pred.complete, {}

    def complete(handle):
        (_, low), batch, B = handle
        for row, req in zip(low[:B].float().cpu().numpy(),
                            request_rows(batch)):
            got[req] = row
        return inner(handle)

    pred.complete = complete
    return got


def by_request(got: dict) -> np.ndarray:
    """record_low_res's rows stacked in request order."""
    return np.stack([got[i] for i in range(len(TEXTS))])


def serve_in_pairs(server, Request, images) -> list:
    """The 4 requests in pinned pairs (a pair submitted once the previous
    one was answered), so every server coalesces the same batches."""
    out = []
    for i in range(0, len(TEXTS), 2):
        reqs = [server.submit(Request(image=im, text=t))
                for im, t in zip(images[i:i + 2], TEXTS[i:i + 2])]
        out.extend(r.result(timeout=600) for r in reqs)
    for i, r in enumerate(out):
        if not r or "error" in r:
            fail(f"phase 11: request {i}: {r}")
    return out


class OpMeter:
    """Counts a rank's calls of the all-reduce op (ops/flash.py
    ``all_reduce``) by region ("prefill", "decode": the decode loop,
    "other": the prompt's embedding and the first token's logits) and
    their bytes, on the host, outside a capture: a key's eager first call
    (a replay runs no host code, and launches what the eager call
    launched); the host broadcasts of the Server apart."""

    def __init__(self, torch, dist, flash, llama, anyref):
        self.region = "other"
        self.calls, self.bytes = {}, {}
        self.host_calls = 0
        inner_ar, inner_bc = flash.all_reduce, dist.broadcast_object_list
        inner_pf, inner_loop = llama.prefill, anyref.run_loop

        def all_reduce(x, key):
            if not torch.cuda.is_current_stream_capturing():
                r = self.region
                self.calls[r] = self.calls.get(r, 0) + 1
                self.bytes[r] = self.bytes.get(r, 0) + (
                    x.numel() * x.element_size())
            return inner_ar(x, key)

        def broadcast_object_list(*a, **kw):
            self.host_calls += 1
            return inner_bc(*a, **kw)

        def within(region, fn):
            def wrapped(*a, **kw):
                self.region = region
                try:
                    return fn(*a, **kw)
                finally:
                    self.region = "other"
            return wrapped

        flash.all_reduce = all_reduce
        dist.broadcast_object_list = broadcast_object_list
        llama.prefill = within("prefill", inner_pf)
        anyref.run_loop = within("decode", inner_loop)


def parallel_7b_rank(torch, rank, images):
    """Phase 11(b), one rank: anyref_7b's weights made on the card (seed
    0, [SEG] x 1000), sharded at (1, 2) on cuda:0; rank 0 serves
    WARM_PATTERN's, DATA_PATTERN's, then WINDOW_PATTERN's pairs through
    the leader Server (speculative, "fused", max_batch 2, each pair
    submitted once the last was answered), rank 1 follows. Both
    Predictors compile each key: its first batch eager and captured, the
    rest replays, whose sums over "model" are launches of the all-reduce
    kernel inside the graph. Host hooks see the eager first calls only
    (OpMeter, the causal kernel's shapes, the decode passes, the [SEG]
    states); BatchRecorder the batches before the window; the card's
    counters the whole run. Returns those, the answers and the window's
    ids and pair walls (rank 0), the keys' capture seconds, the pool, the
    exchange area's bytes, the walls and the peak memory."""
    import torch.distributed as dist
    from anyref_tpu_torch import params as tparams
    from anyref_tpu_torch import serve as serve_mod
    from anyref_tpu_torch.config import anyref_7b
    from anyref_tpu_torch.models import anyref, llama
    from anyref_tpu_torch.ops import flash
    from anyref_tpu_torch.parallel.mesh import make_mesh
    from anyref_tpu_torch.parallel.partition import shard_params
    cfg = anyref_7b()
    mesh = make_mesh(1, 2, device="cuda:0", timeout_s=PARALLEL_TIMEOUT_S)
    torch.cuda.set_device(0)
    t0 = time.time()
    sp = shard_params(params_7b(torch, {"tparams": tparams}, cfg), mesh, cfg)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    held = torch.cuda.memory_allocated()
    build_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    meter = OpMeter(torch, dist, flash, llama, anyref)
    causal_marks = []
    inner_causal = llama.causal_attention

    def causal(q, *a, **kw):
        if torch.cuda.is_current_stream_capturing():
            return inner_causal(q, *a, **kw)
        n0 = launch_mark(flash, "flash_causal_attention")
        out = inner_causal(q, *a, **kw)
        causal_marks.append((tuple(q.shape), n0,
                             launch_mark(flash, "flash_causal_attention")))
        return out

    llama.causal_attention = causal
    seg_states = record_seg_states(anyref)
    passes = []
    inner_loop = anyref.run_loop

    def run_loop(loop, *a, **kw):
        carry = inner_loop(loop, *a, **kw)
        passes.append(int(carry["n_pass"]))
        return carry

    anyref.run_loop = run_loop
    rec = BatchRecorder(torch, flash, len(WARM_PATTERN + DATA_PATTERN))
    preds, inner_sp = [], serve_mod.serving_predictor

    def serving_predictor(*a, **kw):
        pred = inner_sp(*a, **kw)
        rec.attach(pred)
        preds.append(pred)
        return pred
    serve_mod.serving_predictor = serving_predictor
    kw = dict(max_batch=2, speculative=True, max_new_tokens=PARALLEL_MNT,
              encoder_path="fused", mesh=mesh)
    answers, window_ids, window_s, pair_s = None, None, None, None
    zero_launches(flash)
    t0 = time.time()
    if rank == 0:
        server = serve_mod.Server(sp, cfg, **kw)
        results = []
        for pattern in (WARM_PATTERN, DATA_PATTERN):
            results += serve_pattern(server, serve_mod.Request, images,
                                     pattern)[0]
        window, window_s, pair_s = serve_pattern(
            server, serve_mod.Request, images, WINDOW_PATTERN)
        server.shutdown()
        answers = [{"ids": r["output_ids"], "mask": r["mask"]}
                   for r in results]
        window_ids = [r["output_ids"] for r in window]
        batches = server.stats["batches"]
    else:
        batches = serve_mod.follow(sp, cfg)
    torch.cuda.synchronize()
    wall = time.time() - t0
    mesh.close()
    launches = read_launches(flash)
    counts = flash.launch_counts()
    pred = preds[0]
    return {"answers": answers, "window_ids": window_ids,
            "window_s": window_s, "pair_s": pair_s, "batches": batches,
            "total_launches": launches, "all_reduces": counts["all_reduce"],
            "conditions": counts["loop_condition"],
            "causal_shapes": by_shape(causal_marks),
            "passes": passes, "wall_s": wall, "build_s": build_s,
            "init_peak_gib": init_peak / 2**30, "held_gib": held / 2**30,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "calls": meter.calls, "bytes": meter.bytes,
            "host_broadcasts": meter.host_calls,
            "layout": sorted(sp["llama"]["layers"][0]["attn"]),
            "seg_states": seg_states, "keys": len(pred.programs),
            "capture_s": [p.capture_s for p in pred.programs.values()],
            "pool_bytes": pred.graph_pool_bytes(),
            "exchange_bytes": mesh.exchange.held_bytes,
            **rec.summary()}


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# phase 11(c)'s batches: pairs of the 4 requests (pair 0: requests 0 and
# 1, pair 1: requests 2 and 3), a warm round, then a checked one (each
# batch's rows and card launches recorded); the first batch of a key runs
# eagerly and is captured, the later ones are replays. Then the throughput
# window: 50 more pairs, timed at (2, 1) and at (1, 1), unrecorded
WARM_PATTERN, DATA_PATTERN = (0, 1), (0, 1, 0, 1)
WINDOW_PATTERN = (0, 1) * 25


def serve_pattern(server, Request, images, pattern) -> tuple:
    """``pattern``'s pairs through ``server``, each submitted once the last
    was answered: (the answers in order, the seconds from the first submit
    to the last answer, each pair's seconds from its submit to its last
    answer)."""
    out, pairs = [], []
    t0 = time.time()
    for pair in pattern:
        i = 2 * pair
        t1 = time.time()
        reqs = [server.submit(Request(image=im, text=t))
                for im, t in zip(images[i:i + 2], TEXTS[i:i + 2])]
        out.extend(r.result(timeout=600) for r in reqs)
        pairs.append(time.time() - t1)
    wall = time.time() - t0
    for i, r in enumerate(out):
        if not r or "error" in r:
            fail(f"phase 11: answer {i}: {r}")
    return out, wall, pairs


class BatchRecorder:
    """Attached to a Predictor: for each of the first ``limit``
    predict_async calls, its return time, two CUDA events around it on the
    stream (the batch's device span) and the launch counters queued before
    and after it without waiting (the card's launches of the batch); for
    each of the first ``limit`` fetches, the whole batch's fetched rows on
    the host (after the gather of a data mesh; a follower of a mesh
    without one fetches nothing, and its batches' outputs are read at
    ``summary``). Later calls pass through."""

    def __init__(self, torch, flash, limit):
        self.torch, self.flash, self.limit = torch, flash, limit
        self.batches, self.fetched, self.rows = [], [], []
        self.outputs = []

    def _marks(self) -> dict:
        return {n: launch_mark(self.flash, n) for n in self.flash.COUNTED}

    def attach(self, pred):
        inner_pa, inner_fetch = pred.predict_async, pred.fetch
        torch = self.torch

        def predict_async(batch):
            if len(self.batches) >= self.limit:
                return inner_pa(batch)
            key = pred._inputs(batch)[1]
            replay = key in pred.programs
            self.rows.append(request_rows(batch))
            m0 = self._marks()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            t0 = time.perf_counter()
            handle = inner_pa(batch)
            ret = time.perf_counter() - t0
            e1.record()
            self.batches.append((ret, e0, e1, m0, self._marks(), key,
                                 replay))
            self.outputs.append(handle[0])
            return handle

        def fetch(handle):
            meta, low = inner_fetch(handle)
            if len(self.fetched) >= self.limit:
                return meta, low
            self.fetched.append((meta.numpy().copy(),
                                 low.float().numpy().copy()))
            return meta, low

        pred.predict_async, pred.fetch = predict_async, fetch

    def summary(self) -> dict:
        """After a synchronize: each batch's return seconds, device span
        (ms), launches, key (its index among the keys met), whether it was
        a replay and its rows' requests (request_rows), and the fetched
        rows."""
        keys = list(dict.fromkeys(b[5] for b in self.batches))
        fetched = self.fetched or [(meta.cpu().numpy(),
                                    low.float().cpu().numpy())
                                   for meta, low in self.outputs]
        return {"return_s": [b[0] for b in self.batches],
                "device_ms": [b[1].elapsed_time(b[2]) for b in self.batches],
                "launches": [{n: int(b[4][n] - b[3][n]) for n in b[3]}
                             for b in self.batches],
                "key": [keys.index(b[5]) for b in self.batches],
                "replay": [b[6] for b in self.batches],
                "requests": self.rows, "fetched": fetched}


def parallel_7b_data_rank(torch, rank, images):
    """Phase 11(c), one rank: anyref_7b's weights made on the card (seed
    0, [SEG] x 1000) on a (2, 1) mesh on cuda:0 (each rank the whole tree);
    rank 0 serves WARM_PATTERN's, DATA_PATTERN's, then WINDOW_PATTERN's
    pairs through the leader Server (speculative, "fused", max_batch 2:
    one row a rank), rank 1 follows.
    Both Predictors compile each key (BatchRecorder attached to the
    batches before the window). Returns the answers (rank 0), the window's
    ids and seconds, the recorded batches, the keys' capture seconds, the
    pool, the walls and the peak memory."""
    from anyref_tpu_torch import params as tparams
    from anyref_tpu_torch import serve as serve_mod
    from anyref_tpu_torch.config import anyref_7b
    from anyref_tpu_torch.ops import flash
    from anyref_tpu_torch.parallel.mesh import make_mesh
    from anyref_tpu_torch.parallel.partition import shard_params
    cfg = anyref_7b()
    mesh = make_mesh(2, 1, device="cuda:0", timeout_s=PARALLEL_TIMEOUT_S)
    torch.cuda.set_device(0)
    t0 = time.time()
    sp = shard_params(params_7b(torch, {"tparams": tparams}, cfg), mesh, cfg)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rec = BatchRecorder(torch, flash, len(WARM_PATTERN + DATA_PATTERN))
    preds, inner = [], serve_mod.serving_predictor

    def serving_predictor(*a, **kw):
        pred = inner(*a, **kw)
        rec.attach(pred)
        preds.append(pred)
        return pred
    serve_mod.serving_predictor = serving_predictor
    kw = dict(max_batch=2, speculative=True, max_new_tokens=PARALLEL_MNT,
              encoder_path="fused", mesh=mesh)
    answers, window_ids, window_s, pair_s = None, None, None, None
    t0 = time.time()
    if rank == 0:
        server = serve_mod.Server(sp, cfg, **kw)
        results = []
        for pattern in (WARM_PATTERN, DATA_PATTERN):
            results += serve_pattern(server, serve_mod.Request, images,
                                     pattern)[0]
        window, window_s, pair_s = serve_pattern(
            server, serve_mod.Request, images, WINDOW_PATTERN)
        server.shutdown()
        answers = [{"ids": r["output_ids"], "mask": r["mask"]}
                   for r in results]
        window_ids = [r["output_ids"] for r in window]
        batches = server.stats["batches"]
    else:
        batches = serve_mod.follow(sp, cfg)
    torch.cuda.synchronize()
    wall = time.time() - t0
    mesh.close()
    pred = preds[0]
    return {"answers": answers, "window_ids": window_ids,
            "window_s": window_s, "pair_s": pair_s, "batches": batches,
            "wall_s": wall, "build_s": build_s, "held_gib": held / 2**30,
            "keys": len(pred.programs),
            "capture_s": [p.capture_s for p in pred.programs.values()],
            "pool_bytes": pred.graph_pool_bytes(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            **rec.summary()}


def check_compiled_batches(res, what: str, ident, row: int) -> None:
    """A rank's recorded batches of WARM_PATTERN + DATA_PATTERN, then
    WINDOW_PATTERN's unrecorded, through a compiled Predictor (BatchRecorder
    and the keys' programs in ``res``): one program a key, a key's first
    batch eager (no run of the loop's condition kernel) and the rest
    replays, at least two a key; each request's fetched row bit-equal to
    its first (request_rows: the Server may order a pair either way); each
    batch's card launches those of the first batch in which the rank ran
    the same work (``ident`` of the batch's requests; where that was the
    key's eager run, the loop's condition kernel passes + 1 times more,
    the passes read from fetched row ``row``)."""
    n_b = len(WARM_PATTERN + DATA_PATTERN)
    if res["batches"] != n_b + len(WINDOW_PATTERN) or \
            len(res["fetched"]) != n_b or len(res["launches"]) != n_b:
        fail(f"{what} ran {res['batches']} batches, recorded "
             f"{len(res['fetched'])}, want {n_b} and "
             f"{len(WINDOW_PATTERN)} more")
    n_keys = len(set(res["key"]))
    if res["keys"] != n_keys or res["replay"] != [
            res["key"].index(k) != i for i, k in enumerate(res["key"])]:
        fail(f"{what}: {res['keys']} programs for {n_keys} keys, replays "
             f"{res['replay']} of keys {res['key']}")
    if sum(res["replay"]) < 2 * n_keys:
        fail(f"{what}: {sum(res['replay'])} replays of {n_keys} keys")
    own = [ident(reqs) for reqs in res["requests"]]
    seen = {}
    for i, (meta, low) in enumerate(res["fetched"]):
        for r_i, req in enumerate(res["requests"][i]):
            j, r = seen.setdefault(req, (i, r_i))
            meta_j, low_j = res["fetched"][j]
            if not (np.array_equal(meta[r_i], meta_j[r])
                    and np.array_equal(low[r_i], low_j[r])):
                fail(f"{what}: request {req} in batch {i} differs from "
                     f"batch {j}: meta {meta[r_i].tolist()} against "
                     f"{meta_j[r].tolist()}, low-res off by "
                     f"{rel_l2(low[r_i], low_j[r])}")
        got = res["launches"][i]
        if not res["replay"][i] and got["loop_condition"] != 0:
            fail(f"{what}: the eager batch {i} ran the loop's condition "
                 f"kernel {got['loop_condition']} times")
        j = own.index(own[i])
        if i == j:
            continue
        want = res["launches"][j]
        if not res["replay"][j]:     # the key's eager run
            want = {**want, "loop_condition": int(meta[row, -1]) + 1}
        if got != want:
            fail(f"{what}: batch {i}, a replay, launched {got}, want "
                 f"{want} (batch {j}'s, of the same requests)")


def compiled_summary(res) -> str:
    """The keys, capture, return times against device spans, a replay's
    launches, the pool and the peak memory of check_compiled_batches'
    ``res``, for a log line."""
    rets = [round(1e3 * t, 2) for t in res["return_s"]]
    devs = [round(t, 1) for t in res["device_ms"]]
    return (f"keys {res['key']}; the first of each key eager, then captured "
            f"in {[round(c, 3) for c in res['capture_s']]} s), "
            f"{res['wall_s']:.2f} s wall; predict_async returns in {rets} ms "
            f"against device spans {devs} ms (CUDA events around the call); "
            f"each request bit-equal to its first batch, a replay launching "
            f"(card counts) {json.dumps(res['launches'][-1])}; graph pool "
            f"{res['pool_bytes'] / 2**30:.3f} GiB; peak memory "
            f"{res['peak_gib']:.2f} GiB")


def window_summary(n_win: int, seconds: float, pairs: list) -> str:
    """q/s over a window and the spread of its pairs' seconds."""
    q = np.quantile(pairs, [0, 0.5, 1])
    return (f"{n_win / seconds:.3f} q/s ({seconds:.3f} s; a pair "
            f"{q[0]:.4f} / {q[1]:.4f} / {q[2]:.4f} s min / median / max)")


def check_served(lead, single, low_single, floor, solo, what: str,
                 side: str) -> list:
    """Rank 0's answers of WARM_PATTERN + DATA_PATTERN and the window's
    against the single process's ids (``single``: the 4 requests through
    the eager Server; ``solo``: the answers before the window, the
    window's ids, its seconds and its pairs' of a compiled single-process
    Server, whose ids must agree too); the warm batches' fetched low-res
    logits within PARALLEL_FLOOR_FACTOR x ``floor`` of ``low_single``.
    Returns those relative L2 errors."""
    pattern = WARM_PATTERN + DATA_PATTERN
    answers = lead["answers"]
    for k, pair in enumerate(pattern):
        for j in range(2):
            a, r = answers[2 * k + j], single[2 * pair + j]
            if not np.array_equal(a["ids"], r["output_ids"]):
                fail(f"{what}: batch {k} request {2 * pair + j} ids "
                     f"{a['ids'].tolist()} at {side}, "
                     f"{r['output_ids'].tolist()} on one process")
    errs = []
    for k in range(len(WARM_PATTERN)):
        low = lead["fetched"][k][1]
        for row, req in enumerate(lead["requests"][k]):
            err = rel_l2(low[row], low_single[req])
            errs.append(err)
            if not np.isfinite(low[row]).all() or \
                    err > PARALLEL_FLOOR_FACTOR * floor:
                fail(f"{what}: request {req} low-res logits off by {err}, "
                     f"past {PARALLEL_FLOOR_FACTOR} x the floor {floor}")
    for a, r in zip(answers, solo[0]):
        if not np.array_equal(a["ids"], r["output_ids"]):
            fail(f"{what}: the {side} answers differ from the compiled "
                 "single process's")
    for k, pair in enumerate(WINDOW_PATTERN):
        for j in range(2):
            want = single[2 * pair + j]["output_ids"]
            for where, got in ((side, lead["window_ids"][2 * k + j]),
                               ("(1, 1)", solo[1][2 * k + j])):
                if not np.array_equal(got, want):
                    fail(f"{what}: window pair {k} request {2 * pair + j} "
                         f"ids {got.tolist()} at {where}, {want.tolist()} "
                         "on one process")
    return errs


def parallel_7b_data(torch, mods, images, single, low_single, floor,
                     solo) -> None:
    """Phase 11(c): two ranks at (2, 1) on cuda:0 over gloo, each key
    compiled on both: rank 0's ids equal the single process's (phase
    11(b)'s eager run, and a compiled single-process Server's), its
    low-res logits within PARALLEL_FLOOR_FACTOR x phase 11(b)'s floor; on
    each rank one program a key, a key's first batch eager (no run of the
    loop's condition kernel) and the rest replays; each request's fetched
    row bit-equal to its first (request_rows: the Server may order a
    pair either way), and each batch's card launches those of the first
    batch in which the rank ran the same request (where that was the
    key's eager run, the loop's condition kernel passes + 1 times more).
    The window's answers' ids equal the single process's too. Prints each
    rank's predict_async return time against its device span, the
    Server's q/s over the window against the same requests at (1, 1)
    (``solo``: the answers before the window, the window's answers and
    its seconds, of a compiled single-process Server), the pool and each
    rank's peak memory."""
    t0 = time.time()
    ranks = run_ranks("7b_data", 2, images=images)
    spawn_s = time.time() - t0
    pattern = WARM_PATTERN + DATA_PATTERN
    for rank, res in enumerate(ranks):
        check_compiled_batches(res, f"phase 11(c): rank {rank}",
                               lambda reqs, r=rank: reqs[r], row=rank)
        log(f"[parallel-7b-data] rank {rank}: weights made in "
            f"{res['build_s']:.2f} s ({res['held_gib']:.2f} GiB held); "
            f"{len(pattern)} batches of one row a rank (pairs "
            f"{list(pattern)}, {compiled_summary(res)}")
    lead = ranks[0]
    errs = check_served(lead, single, low_single, floor, solo,
                        "phase 11(c)", "(2, 1)")
    n_win = 2 * len(WINDOW_PATTERN)
    log(f"[parallel-7b-data] ids equal to the single process's on all "
        f"{2 * len(pattern)} checked answers and the window's {n_win} at "
        f"(2, 1) and (1, 1); low-res rel L2 {[f'{e:.4g}' for e in errs]} "
        f"(limit {PARALLEL_FLOOR_FACTOR} x {floor:.4g}); throughput window "
        f"of {n_win} requests, {len(WINDOW_PATTERN)} pairs, each submitted "
        f"once the last was answered, every key warm: the Server at (2, 1) "
        f"{window_summary(n_win, lead['window_s'], lead['pair_s'])} against "
        f"{window_summary(n_win, solo[2], solo[3])} at (1, 1) (a compiled "
        f"single-process Server); {mods['card']}; gloo gathers the rows "
        f"through the host: these are no NCCL figures")
    log(f"[phase 11] (c) anyref_7b at (2, 1), two ranks on cuda:0 over gloo,"
        f" compiled, in {time.time() - t0:.1f} s (ranks {spawn_s:.1f} s)")


def parallel_7b(torch, flash, mods) -> dict:
    """Phase 11(b): the single-process run first (the same weights: the 4
    requests in pinned pairs through a Server at max_batch 2, then again
    with every input embedding of the decoder moved by one bf16 ulp for
    the bf16 floor: the low-res logits' relative L2 of the two runs, over
    the requests whose ids agree, or 2^-8, whichever is larger), its
    weights freed; phase 11(c)'s batches and window through a compiled
    single-process Server; then two ranks on the card at (1, 2), each key
    compiled on both (parallel_7b_rank). Rank 0's ids must equal the
    single process's (eager and compiled), its low-res logits within
    PARALLEL_FLOOR_FACTOR x the floor; on both ranks every kernel of the
    "fused" path launched as many times a batch as phase 4 counts, the
    causal kernel at PARALLEL_CAUSAL_SHAPE, each replay launching what the
    key's eager call launched (check_compiled_batches), the all-reduce
    kernel as often on both. Then phase 11(c). Returns rank 0's launch
    counts of 11(b), the all-reduce's among them."""
    t_phase = time.time()
    cfg = mods["anyref_7b"]()
    images = request_images()
    Server, Request = mods["Server"], mods["Request"]
    params = params_7b(torch, mods, cfg)
    inner_project = mods["anyref"].project_seg_hidden
    segs = record_seg_states(mods["anyref"])
    # the single process through eager generate (eager_server), as the
    # ranks run: the recorded [SEG] states and the nudged embeddings are
    # host hooks inside generate, which a captured program would bypass
    t0 = time.time()
    server = eager_server(torch, mods, Server(
        params, cfg, max_batch=2, speculative=True,
        max_new_tokens=PARALLEL_MNT, encoder_path="fused"))
    lows2 = record_low_res(server)
    single = serve_in_pairs(server, Request, images)
    server.shutdown()
    single_s = time.time() - t0
    segs2 = np.concatenate(segs)
    segs.clear()
    # the floor: the same run with every input embedding of the decoder
    # moved by one bf16 ulp (up or down, drawn from a seed)
    inner_assemble = mods["anyref"].assemble_embeds
    mods["anyref"].assemble_embeds = nudged(torch, inner_assemble)
    server = eager_server(torch, mods, Server(
        params, cfg, max_batch=2, speculative=True,
        max_new_tokens=PARALLEL_MNT, encoder_path="fused"))
    lows1 = record_low_res(server)
    alone = serve_in_pairs(server, Request, images)
    server.shutdown()
    segs1 = np.concatenate(segs)
    mods["anyref"].project_seg_hidden = inner_project
    mods["anyref"].assemble_embeds = inner_assemble
    # phase 11(c)'s batches through a compiled single-process Server
    server = Server(params, cfg, max_batch=2, speculative=True,
                    max_new_tokens=PARALLEL_MNT, encoder_path="fused")
    warm = serve_pattern(server, Request, images, WARM_PATTERN)[0]
    timed = serve_pattern(server, Request, images, DATA_PATTERN)[0]
    window, solo_s, solo_pairs = serve_pattern(server, Request, images,
                                               WINDOW_PATTERN)
    solo = (warm + timed, [r["output_ids"] for r in window], solo_s,
            solo_pairs)
    server.shutdown()
    del params, server
    torch.cuda.empty_cache()
    low2, low1 = by_request(lows2), by_request(lows1)
    agree = [i for i in range(len(TEXTS)) if np.array_equal(
        alone[i]["output_ids"], single[i]["output_ids"])]
    floor = max([rel_l2(low1[i], low2[i]) for i in agree] + [2.0 ** -8])
    log(f"[parallel-7b] single process, 4 requests in pinned pairs in "
        f"{single_s:.2f} s: ids {[r['output_ids'].tolist() for r in single]}"
        f"; the decoder's inputs moved by one bf16 ulp: ids agree for "
        f"requests {agree}, low-res rel L2 "
        f"{[f'{rel_l2(low1[i], low2[i]):.3g}' for i in range(len(TEXTS))]}"
        f" -> floor {floor:.4g}")

    t0 = time.time()
    ranks = run_ranks("7b", 2, images=images)
    spawn_s = time.time() - t0
    lead = ranks[0]
    per_batch = launches_per_batch(flash, cfg)["fused"]
    n_win = 2 * len(WINDOW_PATTERN)
    for rank, res in enumerate(ranks):
        what = f"phase 11(b): rank {rank}"
        check_compiled_batches(res, what, lambda reqs: tuple(sorted(reqs)),
                               row=0)
        n_b, n_eager = res["batches"], res["keys"]
        for name, n in per_batch.items():
            if res["total_launches"][name] != n * n_b:
                fail(f"{what} {name}: {res['total_launches'][name]} "
                     f"launches, want {n * n_b}")
        want_shapes = {PARALLEL_CAUSAL_SHAPE: cfg.llama.num_layers * n_eager}
        if res["causal_shapes"] != want_shapes:
            fail(f"{what}: causal kernel shapes (the eager first calls) "
                 f"{res['causal_shapes']}, want {want_shapes}")
        if res["layout"] != ["k", "o", "q", "v"]:
            fail(f"{what}: layout {res['layout']}: the sharded tree must "
                 "keep the plain layout")
        passes = sum(res["passes"])
        per = {r: (res["calls"].get(r, 0), res["bytes"].get(r, 0))
               for r in ("prefill", "decode", "other")}
        if not res["all_reduces"] or res["all_reduces"] != \
                lead["all_reduces"] or not per["prefill"][0] or \
                not per["decode"][0]:
            fail(f"{what}: {res['all_reduces']} all-reduce launches on the "
                 f"card (rank 0 {lead['all_reduces']}), {per} on the host: "
                 "the sums over \"model\" did not run through the kernel")
        log(f"[parallel-7b] rank {rank}: weights made and sharded in "
            f"{res['build_s']:.2f} s (peak {res['init_peak_gib']:.2f} GiB, "
            f"{res['held_gib']:.2f} GiB held after; exchange area "
            f"{res['exchange_bytes']} bytes); {n_b} batches (pairs "
            f"{list(WARM_PATTERN + DATA_PATTERN)}, then the window's "
            f"{len(WINDOW_PATTERN)}), {compiled_summary(res)}; the eager "
            f"first calls' decode passes {res['passes']}, all-reduces a "
            f"prefill {per['prefill'][0] / n_eager:g} "
            f"({per['prefill'][1] / n_eager / 2**20:.2f} MiB), a decode pass "
            f"{per['decode'][0] / passes:g} "
            f"({per['decode'][1] / passes / 2**20:.3f} MiB), other "
            f"{per['other'][0] / n_eager:g} a batch "
            f"({per['other'][1] / n_eager / 2**20:.3f} MiB); the card's "
            f"all-reduce launches {res['all_reduces']} over {n_b} batches "
            f"({res['all_reduces'] / n_b:g} a batch), loop condition "
            f"{res['conditions']}; host broadcasts {res['host_broadcasts']}"
            f"; flash_causal_attention "
            f"{json.dumps({str(list(k)): v for k, v in res['causal_shapes'].items()})}")
    errs = check_served(lead, single, low2, floor, solo, "phase 11(b)",
                        "(1, 2)")
    # the [SEG] states of the eager first calls, by request
    eager_rows = [reqs for reqs, replay in zip(lead["requests"],
                                               lead["replay"]) if not replay]
    seg_tp = {req: st for reqs, states in zip(eager_rows, lead["seg_states"])
              for req, st in zip(reqs, states)}
    log(f"[parallel-7b] [SEG] states of the eager first calls, rel L2 by "
        f"request: 2 ranks against the single process "
        f"{ {i: f'{rel_l2(seg_tp[i], segs2[i]):.3g}' for i in seg_tp} }"
        f", inputs moved by one ulp "
        f"{[f'{rel_l2(segs1[i], segs2[i]):.3g}' for i in range(len(TEXTS))]}")
    log(f"[parallel-7b] ids equal to the single process's on all "
        f"{len(lead['answers'])} checked answers and the window's {n_win} at "
        f"(1, 2) and (1, 1); low-res rel L2 {[f'{e:.4g}' for e in errs]} "
        f"(limit {PARALLEL_FLOOR_FACTOR} x {floor:.4g}); throughput window "
        f"of {n_win} requests, {len(WINDOW_PATTERN)} pairs, each submitted "
        f"once the last was answered, every key warm: the Server at (1, 2) "
        f"{window_summary(n_win, lead['window_s'], lead['pair_s'])} against "
        f"{window_summary(n_win, solo[2], solo[3])} at (1, 1) (a compiled "
        f"single-process Server); {mods['card']}; two ranks share the card "
        f"by time slices of their contexts: no figure of several cards")
    log(f"[phase 11] (b) anyref_7b at (1, 2), two ranks on cuda:0, compiled, "
        f"the all-reduce kernel over \"model\", in "
        f"{time.time() - t_phase:.1f} s (ranks {spawn_s:.1f} s)")
    parallel_7b_data(torch, mods, images, single, low2, floor, solo)
    return {**lead["total_launches"], "all_reduce": lead["all_reduces"]}


# ---------------------------------------------------------------------------
# phase 12: multi-device LoRA training on torch.distributed
# ---------------------------------------------------------------------------
# one rank's training attention under a "model" axis of 2 at anyref_7b:
# batch 2, 16 of LLaMA-7B's 32 heads, L = 512 + 255 padded to 768
TRAIN_RANK_CAUSAL_SHAPE = (2, 16, 768, 128)
# the CPU tests' limits (tests/test_torch_parallel_train.py): loss terms
# relative, gradients of each leaf's largest magnitude. The decoder's
# trainables (LoRA, embed_tokens, lm_head) are held to the second; the
# mask path's (text_hidden_fcs, the mask decoder) to the larger of it and
# PARALLEL_FLOOR_FACTOR x the bf16 floor measured in the same call (the
# single process against itself with the decoder's inputs moved by one
# bf16 ulp, phase 11's floor): at anyref_tiny's bf16 weights the mask
# decoder's activations and gradient leaves are bf16 too, so two
# arrangements of the same sums move its gradients by several % of a
# leaf's largest (3.8% at (1, 2) and 5.9-10.2% at (2, 1) against one
# process on an H100 80GB HBM3 at 700 W; 4.2% card against CPU in phase 3)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-3, 2e-2
# text_hidden_fcs units whose ReLU gate may differ between 2 ranks and one
# process on a valid [SEG] slot, each within KINK_REL of the largest
# pre-activation (the CPU tests' rule): at most 5% of the units
KINK_UNITS, KINK_REL = 6, 1e-2
# the ranks' losses, each the global batch's, computed apart on each rank
RANK_LOSS_TOL = 1e-6
# phase 12(a)'s synthetic samples: answers of different lengths, so the
# data ranks hold different numbers of answer tokens
TRAIN_TINY_TEXTS = ("the cat", "the small red mug on the left", "a dog",
                    "the tall lamp near the open window", "a hat",
                    "the blue car", "the striped towel on the rail",
                    "a bowl")
TRAIN_TINY_SIZES = IMAGE_SIZES * 2
# phase 12(a)'s meshes: four ranks at (2, 2)
TRAIN_TINY_MESHES = ((1, 2), (2, 1), (2, 2))


def train_config(mods, out: str, **kw):
    """The TrainConfig of phase 12: batch 2 a data rank, 2 micro-steps,
    remat, "fused", a line of metrics every step."""
    return mods["TrainConfig"](
        output_dir=out, per_device_batch_size=2, grad_accum_steps=2,
        log_steps=1, resume=False, remat=True, encoder_path="fused", **kw)


def rank_mods():
    """The modules a spawned rank of phase 12 uses."""
    from anyref_tpu_torch import params as tparams
    from anyref_tpu_torch.config import anyref_7b, anyref_tiny
    from anyref_tpu_torch.models import anyref
    from anyref_tpu_torch.ops import flash
    from anyref_tpu_torch.parallel import partition
    from anyref_tpu_torch.parallel.mesh import make_mesh
    from anyref_tpu_torch.train import lora, step
    from anyref_tpu_torch.train.trainer import TrainConfig, Trainer
    return {"tparams": tparams, "anyref_7b": anyref_7b,
            "anyref_tiny": anyref_tiny, "anyref": anyref, "flash": flash,
            "partition": partition, "make_mesh": make_mesh, "lora": lora,
            "step": step, "TrainConfig": TrainConfig, "Trainer": Trainer}


def to_numpy(torch, tree):
    """A tree of tensors as fp32 numpy on the host (None kept)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_numpy(torch, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(torch, v) for v in tree]
    return tree.detach().float().cpu().numpy()


def first_grads(step) -> list:
    """Wraps step.AdamW.update: the list gains the gradient tree its first
    call is given, the first step's reduced gradient (a (lora, dense)
    pair of this rank's blocks, before the clip)."""
    inner, got = step.AdamW.update, []

    def update(self, grads, *a, **kw):
        if not got:
            got.append(grads)
        return inner(self, grads, *a, **kw)
    step.AdamW.update = update
    return got


class CompiledSteps:
    """Attached to a compiled Trainer (train/trainer.py ``_compiled_step``)
    before it trains: StepRecorder on every step, and each step's gradient
    as the update read it (GradHook on a step from the host; after a
    replay the fp32 sums of the prefix's carry, which a hook on the
    Trainer's GraphPool.capture keeps: the update rounds them in place);
    the cache of the first step's working memory is released before the
    capture. ``results`` after training: the walls, return times,
    metrics, launches a step, the program's keys, graphs, capture and pool;
    ``eager`` then runs train_eager_reference on the same mesh."""

    def __init__(self, torch, m, trainer):
        self.torch, self.m, self.trainer = torch, m, trainer
        step = m["step"]
        inner_capture, inner_graph = trainer._capture, trainer.graphs.capture
        carries = []

        def capture(program):
            torch.cuda.empty_cache()
            return inner_capture(program)

        def graph_capture(fn):
            g, out = inner_graph(fn)
            if isinstance(out, dict) and "flat" in out:   # the prefix's carry
                carries.append(out)
            return g, out
        trainer._capture, trainer.graphs.capture = capture, graph_capture
        self.hook = GradHook(torch, step)
        self.rec = StepRecorder(torch, m["flash"], step, trainer)
        self.grads = []
        hook, grads, inner_step = self.hook, self.grads, trainer.step_fn

        def step_fn(state, frozen, batch):
            n = hook.calls
            out_ = inner_step(state, frozen, batch)
            if hook.calls > n:        # a step from the host
                grads.append([g.cpu() for g in hook.last])
            else:                     # a replay: the sums the update read
                leaves = step.tree_leaves((state.lora, state.dense))
                parts = carries[-1]["flat"].split([t.numel() for t in leaves])
                grads.append([g.view(t.shape).to(t.dtype).cpu()
                              for g, t in zip(parts, leaves)])
            return out_
        trainer.step_fn = step_fn

    def results(self) -> dict:
        trainer, rec = self.trainer, self.rec
        program = next(iter(trainer.programs.values()))
        counts = self.m["flash"].launch_counts()
        return {"metrics": [r["metrics"] for r in rec.steps],
                "walls": [r["wall_s"] for r in rec.steps],
                "return_s": [r["return_s"] for r in rec.steps],
                "conditions": counts["loop_condition"],
                "step_launches": [r["launches"] for r in rec.steps],
                "keys": len(trainer.programs),
                "graphs": len(program.graphs) + (program.then is not None),
                "split": program.then is not None,
                "capture_s": program.capture_s,
                "pool_bytes": trainer.graph_pool_bytes(),
                "exchange_bytes": (None if trainer.mesh.exchange is None
                                   else trainer.mesh.exchange.held_bytes)}

    def eager(self, cfg, tc, params, steps: int, mesh) -> dict:
        """train_eager_reference on ``mesh`` over the recorded steps, once
        the Trainer (which the wrappers hold, in a cycle) is dropped:
        {"eager_walls", "bit_equal", "worst"}."""
        torch, rec, grads = self.torch, self.rec, self.grads
        self.trainer = None
        gc.collect()
        torch.cuda.empty_cache()
        eager = train_eager_reference(torch, self.m, cfg, tc, params, rec,
                                      steps, mesh=mesh, grads=grads)
        return {"eager_walls": eager["wall_s"],
                "bit_equal": eager["bit_equal"], "worst": eager["worst"]}


def check_compiled_steps(res, steps: int, what: str) -> None:
    """A rank's compiled Trainer (CompiledSteps' results): one program of
    three graphs (four with a data sum between them), the first step from
    the host, each later one a replay that ran the loop's condition kernel
    3 times (2 micro-steps) and otherwise launched what the first step
    launched; every item bit-equal to the eager mesh step where the two
    eager runs are (train_eager_reference)."""
    graphs = 4 if res["split"] else 3
    if res["keys"] != 1 or res["graphs"] != graphs:
        fail(f"{what}: {res['keys']} programs of {res['graphs']} graphs, "
             f"want 1 of {graphs}")
    if res["conditions"] != (steps - 1) * 3:
        fail(f"{what}: the loop's condition kernel ran {res['conditions']} "
             f"times, want 3 a replay")
    first = res["step_launches"][0]
    for i, got in enumerate(res["step_launches"][1:], 2):
        if got != {**first, "loop_condition": 3}:
            fail(f"{what}: step {i}, a replay, launched {got}, the first "
                 f"step {first}")
    bits = res["bit_equal"]
    if bits["compiled"] != bits["items"]:
        fail(f"{what}: {bits['compiled']} of {bits['items']} items "
             f"bit-equal to the eager mesh step")


def compiled_steps_summary(res) -> str:
    """The walls, capture, pool, exchange area and the comparison with the
    eager mesh step of a compiled Trainer's rank, for a log line."""
    med = float(np.median(res["walls"][1:]))
    eager = float(np.median(res["eager_walls"]))
    return (f"step walls {[round(w, 4) for w in res['walls']]} s (the first "
            f"from the host, then the capture in {res['capture_s']:.3f} s); "
            f"median of the {len(res['walls']) - 1} replays {med:.4f} s "
            f"against {eager:.4f} s for the eager mesh step (median of "
            f"{len(res['eager_walls'])}); step_fn returns in "
            f"{[round(t, 4) for t in res['return_s']]} s; graph pool "
            f"{res['pool_bytes'] / 2**30:.3f} GiB; exchange area "
            f"{res['exchange_bytes']} bytes; peak memory "
            f"{res['peak_gib']:.2f} GiB; against the eager mesh step: "
            f"{json.dumps(res['bit_equal'])} bit-equal, worst "
            f"{json.dumps(res['worst'])}")


def train_tiny_rank(torch, rank, data, model, out, samples):
    """Phase 12(a), one rank: anyref_tiny's seed-0 bf16 weights (made on
    the CPU) on cuda:0 at mesh (data, model), the Trainer compiled for 2
    steps (warmup 0, a checkpoint every step; the first from the host,
    the second a replay; CompiledSteps), then the eager mesh step on the
    same batches. Returns each step's batch and metrics, the first step's
    reduced gradient gathered to whole leaves, the [SEG] states of the
    first step, whether this rank wrote the log, and CompiledSteps'
    results."""
    m = rank_mods()
    cfg = m["anyref_tiny"]()
    torch.cuda.set_device(0)
    mesh = m["make_mesh"](data, model, device="cuda:0",
                          timeout_s=PARALLEL_TIMEOUT_S)
    params = _to_device(m["tparams"].init(
        cfg, torch.Generator().manual_seed(0), torch.bfloat16,
        device="cpu"), "cuda:0")
    tc = train_config(m, out, max_steps=2, warmup_steps=0, save_steps=1)
    # the Trainer cuts a "model" axis's blocks out of ``params`` in place:
    # the eager reference starts from the same tree
    trainer = m["Trainer"](cfg, tc, params, dataset=samples, mesh=mesh)
    if trainer.step_fn != trainer._compiled_step:
        fail(f"phase 12(a) at ({data}, {model}): the Trainer does not "
             "compile its step")
    grads = first_grads(m["step"])
    probe = CompiledSteps(torch, m, trainer)
    project = m["anyref"].project_seg_hidden
    seg = record_seg_states(m["anyref"])
    inner_capture = trainer._capture

    def capture(program):
        # a capture runs no host hook: the first step, from the host,
        # recorded the states
        m["anyref"].project_seg_hidden = project
        return inner_capture(program)
    trainer._capture = capture
    torch.cuda.reset_peak_memory_stats()
    trainer.train()
    torch.cuda.synchronize()
    g = grads[0]
    whole = m["partition"].gather_tree(
        list(g), m["partition"].trainable_spec(g), mesh)
    res = {"steps": [(r["batch"], r["metrics"]) for r in probe.rec.steps],
           "writer": trainer.writer, "seg": seg[:2],
           "grads": to_numpy(torch, whole) if rank == 0 else None,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           **probe.results()}
    del trainer, capture, inner_capture
    res.update(probe.eager(cfg, tc, params, 2, mesh))
    mesh.close()
    return res


def global_batch(rank_batches: list) -> dict:
    """The data ranks' [accum, B, ...] batches joined in data-rank order
    along the batch axis."""
    return {k: np.concatenate([b[k] for b in rank_batches], 1)
            for k in rank_batches[0]}


def single_step_grads(torch, mods, cfg, params, batch, accum: int,
                      nudge: bool = False):
    """A single process's value_and_grad on the card on ``batch``, from the
    Trainer's initial state (seed 0): (metrics as floats, gradient, the
    [SEG] states of each micro-step). ``nudge``: the decoder's input
    embeddings moved by one bf16 ulp (``nudged``)."""
    step, lora, anyref = mods["step"], mods["lora"], mods["anyref"]
    lcfg = lora.LoraConfig()
    state, frozen = step.init_state(torch.Generator().manual_seed(0), params,
                                    lcfg, step.make_optimizer())
    project, assemble = anyref.project_seg_hidden, anyref.assemble_embeds
    seg = record_seg_states(anyref)
    if nudge:
        anyref.assemble_embeds = nudged(torch, assemble)
    try:
        _, metrics, grads = step.value_and_grad(
            state.lora, state.dense, frozen, cfg, lcfg, batch,
            encoder_path="fused", remat=True, grad_accum=accum)
    finally:
        anyref.project_seg_hidden = project
        anyref.assemble_embeds = assemble
    torch.cuda.synchronize()
    return {k: float(v) for k, v in metrics.items()}, grads, seg


def kink_units(seg, want_seg, valid, lin1, what: str) -> np.ndarray:
    """The text_hidden_fcs units whose ReLU gate differs between two runs'
    [SEG] states on a valid slot of some micro-step; fails unless each
    sits at the kink (|pre-activation| within KINK_REL of the largest in
    both runs) and there are at most KINK_UNITS."""
    w, b = (t.detach().float().cpu().numpy() for t in lin1)
    pre, want = (np.concatenate([(h @ w + b)[np.asarray(v, bool)]
                                 for h, v in zip(x, valid)])
                 for x in (seg, want_seg))
    flip = (pre > 0) != (want > 0)
    units = np.flatnonzero(flip.any(0))
    if len(units) > KINK_UNITS or any(
            not (np.abs(a)[flip] <= KINK_REL * np.abs(a).max()).all()
            for a in (pre, want)):
        fail(f"{what}: text_hidden_fcs gates {units.tolist()} differ from "
             f"the single process's, not all at the kink")
    return units


def check_step_metrics(got: dict, want: dict, what: str) -> float:
    worst = max(abs(got[k] - want[k]) / abs(want[k]) for k in want)
    if not all(np.isfinite(v) for v in got.values()) or \
            worst > TRAIN_LOSS_TOL:
        fail(f"{what}: losses {got} against the single process's {want}")
    return worst


def train_parallel_tiny(torch, mods) -> None:
    """Phase 12(a): anyref_tiny at (1, 2), (2, 1) and (2, 2) on cuda:0
    (gloo for the host and the data sum, the all-reduce kernel over
    "model"), the Trainer compiled for 2 steps of 2 micro-batches of 2 a
    data rank: the second step a replay bit-equal to the eager mesh step
    and launching what the first launched (check_compiled_steps). The
    first step's loss terms and reduced gradient (gathered) against a
    single process on the card on the same global batch; metrics.jsonl
    written once; the (1, 2) run's checkpoint-1 resumed by a single-process
    Trainer."""
    import tempfile
    t0 = time.time()
    cfg = mods["anyref_tiny"]()
    samples = train_samples(cfg, mods, TRAIN_TINY_TEXTS, TRAIN_TINY_SIZES,
                            seed=12)
    tmp = tempfile.mkdtemp(prefix="anyref_train12_")
    try:
        for data, model in TRAIN_TINY_MESHES:
            out = os.path.join(tmp, f"run{data}{model}")
            ranks = run_ranks("train_tiny", data * model, data=data,
                              model=model, out=out, samples=samples)
            with open(os.path.join(out, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            if [r["step"] for r in recs] != [1, 2] or \
                    [r["writer"] for r in ranks] != [True] + [False] * (
                        data * model - 1):
                fail(f"phase 12(a) at ({data}, {model}): metrics.jsonl "
                     f"steps {[r['step'] for r in recs]}, writers "
                     f"{[r['writer'] for r in ranks]}")
            for rank, res in enumerate(ranks):
                for i, (_, m) in enumerate(res["steps"]):
                    rel = max(abs(m[k] - recs[i][k]) / abs(recs[i][k])
                              for k in m)
                    if rel > RANK_LOSS_TOL:
                        fail(f"phase 12(a): rank {rank} step {i + 1} losses "
                             f"{m}, rank 0 logged {recs[i]}")
            for rank, res in enumerate(ranks):
                check_compiled_steps(res, 2, f"phase 12(a) at ({data}, "
                                     f"{model}), rank {rank}")
                if res["split"] != (data > 1):
                    fail(f"phase 12(a) at ({data}, {model}): rank {rank}'s "
                         f"program split {res['split']}")
                log(f"[train-parallel-tiny] ({data}, {model}) rank {rank}: "
                    f"{compiled_steps_summary(res)}")
            firsts = [res["steps"][0][0] for res in ranks]
            batch = global_batch(firsts[::model])
            params = _to_device(mods["tparams"].init(
                cfg, torch.Generator().manual_seed(0), torch.bfloat16,
                device="cpu"), "cuda")
            want_m, want_g, want_seg = single_step_grads(
                torch, mods, cfg, params, batch, 2)
            _, floor_g, _ = single_step_grads(torch, mods, cfg, params,
                                              batch, 2, nudge=True)
            what = f"phase 12(a) at ({data}, {model})"
            worst = check_step_metrics(ranks[0]["steps"][0][1], want_m, what)
            seg = [np.concatenate([ranks[d * model]["seg"][i]
                                   for d in range(data)]) for i in range(2)]
            kink = kink_units(seg, want_seg, batch["mask_valid"],
                              (params["text_hidden_fcs"]["lin1"]["w"],
                               params["text_hidden_fcs"]["lin1"]["b"]), what)
            errs = []      # (side, path, err / scale, floor err / scale)
            for (path, a, b), (_, n, _) in zip(
                    tree_pairs(ranks[0]["grads"],
                               to_numpy(torch, list(want_g))),
                    tree_pairs(to_numpy(torch, list(floor_g)),
                               to_numpy(torch, list(want_g)))):
                if a is None:
                    continue
                if not np.isfinite(a).all():
                    fail(f"{what}: non-finite gradient {path}")
                if "/text_hidden_fcs/lin1/" in path:
                    keep = np.setdiff1d(np.arange(a.shape[-1]), kink)
                    a, b, n = a[..., keep], b[..., keep], n[..., keep]
                scale = float(np.abs(b).max()) or 1.0
                errs.append(("decoder" if path.startswith(("/0/",
                                                           "/1/llama/"))
                             else "mask path", path,
                             float(np.abs(a - b).max()) / scale,
                             float(np.abs(n - b).max()) / scale))
            floor = max(max(f for side, p, _, f in errs
                            if side == "mask path"
                            and "/lin1/" not in p), 2.0 ** -8)
            limits = {"decoder": TRAIN_GRAD_TOL, "mask path": max(
                TRAIN_GRAD_TOL, PARALLEL_FLOOR_FACTOR * floor)}
            worst_g = {side: max((e, p) for s_, p, e, _ in errs
                                 if s_ == side) for side in limits}
            log(f"[train-parallel-tiny] ({data}, {model}): step losses "
                f"{[round(r['loss'], 5) for r in recs]}; step 1 against a "
                f"single process on the card: worst loss-term rel err "
                f"{worst:.3g} (limit {TRAIN_LOSS_TOL}); worst gradient err "
                f"of a leaf's largest {json.dumps(worst_g)}, limits "
                f"{json.dumps(limits)} (the mask path's bf16 floor "
                f"{floor:.4g}: the single process with the decoder's inputs "
                f"moved by one ulp); text_hidden_fcs units at the kink left "
                f"out of lin1: {kink.tolist()}; metrics.jsonl written once "
                f"by rank 0")
            for side, path, e, _ in errs:
                if e > limits[side]:
                    fail(f"{what}: gradient {path} off by {e:.4g} of its "
                         f"largest (limit {limits[side]:.4g})")
            del params, want_g, floor_g
        # the (1, 2) run's checkpoint resumed by one process
        resume = os.path.join(tmp, "resume11")
        shutil.copytree(os.path.join(tmp, "run12", "checkpoint-1"),
                        os.path.join(resume, "checkpoint-1"))
        saved = mods["checkpoint"].restore_train_state(
            os.path.join(resume, "checkpoint-1"))
        params = _to_device(mods["tparams"].init(
            cfg, torch.Generator().manual_seed(0), torch.bfloat16,
            device="cpu"), "cuda")
        tc = train_config(mods, resume, max_steps=2, warmup_steps=0,
                          save_steps=10 ** 9)
        tc.resume = True
        trainer = mods["Trainer"](cfg, tc, params, dataset=samples)
        if trainer.state.step != 1:
            fail(f"phase 12(a): resumed at step {trainer.state.step}")
        check_same_tree(torch, to_cpu(trainer.state.lora), saved["lora"],
                        "phase 12(a): the resumed LoRA weights")
        state = trainer.train()
        with open(os.path.join(resume, "metrics.jsonl")) as f:
            rec = [json.loads(line) for line in f]
        if state.step != 2 or not np.isfinite(rec[-1]["loss"]):
            fail(f"phase 12(a): the resumed run {rec}")
        del trainer, state, params
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[phase 12] (a) anyref_tiny at {list(TRAIN_TINY_MESHES)} on "
        f"cuda:0, compiled, the all-reduce kernel over \"model\", the (1, 2) "
        f"checkpoint resumed in one process, in {time.time() - t0:.1f} s")


def to_cpu(tree):
    """A tree of tensors detached on the CPU (None kept)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_cpu(v) for v in tree]
    return tree.detach().cpu()


class AxisMeter:
    """Counts a rank's all-reduces by the mesh axis of their group
    ("model", "data", else "other"), their bytes and the seconds they take
    (the card synchronised before and after each), for the step named by
    ``self.step`` (None: not counted)."""

    def __init__(self, torch, dist, mesh):
        self.step = None
        self.calls, self.bytes, self.seconds = {}, {}, {}
        axes = {id(mesh.group(a)): a for a in ("data", "model")
                if mesh.group(a) is not None}
        inner = dist.all_reduce

        def all_reduce(t, *a, group=None, **kw):
            if self.step is None:
                return inner(t, *a, group=group, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(t, *a, group=group, **kw)
            torch.cuda.synchronize()
            key = (self.step, axes.get(id(group), "other"))
            self.seconds[key] = self.seconds.get(key, 0.0) + (
                time.perf_counter() - t0)
            self.calls[key] = self.calls.get(key, 0) + 1
            self.bytes[key] = self.bytes.get(key, 0) + (
                t.numel() * t.element_size())
            return out
        dist.all_reduce = all_reduce

    def by_step(self, step: int) -> dict:
        return {axis: {"calls": self.calls[k], "mib": self.bytes[k] / 2**20,
                       "s": round(self.seconds[k], 4)}
                for k in sorted(self.calls) if k[0] == step
                for axis in (k[1],)}


def train_7b_rank(torch, rank, data, model, out, samples, steps, layers):
    """Phase 12(b) and (c), one rank: anyref_7b's seed-0 bf16 weights, at
    ``layers`` decoder layers, made
    on the card at mesh (data, model) (each rank makes the whole tree; at
    model 2 the Trainer keeps its blocks, cut in place), the Trainer
    compiled for ``steps`` steps of 2 micro-batches of 2 (warmup 1, remat,
    "fused"): the first from the host and captured, the rest replays
    (CompiledSteps; at data 2 two graphs with the host's data sum between
    them, AxisMeter on steps 2 on). Then train_eager_reference on the
    mesh. Returns CompiledSteps' results and the eager comparison, the
    all-reduces by axis, every kernel's launches, the training attention's
    shapes on the first step, the frozen and LoRA checks, the walls and
    the peak memory."""
    import torch.distributed as dist
    m = rank_mods()
    cfg = at_depth(m["anyref_7b"](), layers)
    step, flash = m["step"], m["flash"]
    torch.cuda.set_device(0)
    mesh = m["make_mesh"](data, model, device="cuda:0",
                          timeout_s=PARALLEL_TIMEOUT_S)
    what = f"phase 12 at ({data}, {model})"
    t0 = time.time()
    params = m["tparams"].init(
        cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16)
    tc = train_config(m, out, max_steps=steps, warmup_steps=1,
                      save_steps=10 ** 9)
    trainer = m["Trainer"](cfg, tc, params, dataset=samples, mesh=mesh)
    if trainer.step_fn != trainer._compiled_step:
        fail(f"{what}: the Trainer does not compile its step")
    torch.cuda.synchronize()
    build_s = time.time() - t0
    held = torch.cuda.memory_allocated() / 2**30
    frozen = [fingerprint(t) for t in step.tree_leaves(trainer.frozen)[::7]]
    lora0 = [t.detach().clone() for t in step.tree_leaves(trainer.state.lora)]
    causal_marks = []   # the training attention's forward calls, step 1's
    inner_fwd = flash.causal_attention_diff_fwd

    def causal_fwd(q, *a, **kw):
        if torch.cuda.is_current_stream_capturing():
            return inner_fwd(q, *a, **kw)
        n0 = launch_mark(flash, "flash_causal_attention_diff")
        out_ = inner_fwd(q, *a, **kw)
        causal_marks.append((tuple(q.shape), n0, launch_mark(
            flash, "flash_causal_attention_diff")))
        return out_
    flash.causal_attention_diff_fwd = causal_fwd
    probe = CompiledSteps(torch, m, trainer)
    meter = AxisMeter(torch, dist, mesh)
    inner_step, n_steps = trainer.step_fn, [0]

    def step_fn(state, frozen_, batch):
        n_steps[0] += 1
        meter.step = n_steps[0] if n_steps[0] > 1 else None
        out_ = inner_step(state, frozen_, batch)
        meter.step = None
        return out_
    trainer.step_fn = step_fn
    zero_launches(flash)
    torch.cuda.reset_peak_memory_stats()
    state = trainer.train()
    torch.cuda.synchronize()
    flash.causal_attention_diff_fwd = inner_fwd
    res = {**probe.results(),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": read_launches(flash),
           "backward": flash.launch_counts()[
               "flash_causal_attention_diff_backward"],
           "all_reduces": flash.launch_counts()["all_reduce"],
           "collectives": {k: meter.by_step(k) for k in range(2, steps + 1)},
           "causal_shapes": by_shape(causal_marks),
           "lora_moved": not all(torch.equal(a.detach(), b) for a, b in zip(
               step.tree_leaves(state.lora), lora0)),
           "frozen_untouched": frozen == [
               fingerprint(t) for t in step.tree_leaves(trainer.frozen)[::7]],
           "trainable_values": sum(t.numel() for t in step.tree_leaves(
               (state.lora, state.dense))),
           "build_s": build_s, "held_gib": held, "writer": trainer.writer}
    # the wrappers of step_fn and _capture hold the Trainer, in a cycle
    del trainer, state, inner_step, step_fn
    res.update(probe.eager(cfg, tc, params, steps, mesh))
    mesh.close()
    return res


TRAIN_7B_STEPS = 4   # the first from the host and captured, then replays
# phase 12(c)'s decoder layers (of 32), cut for the script's time limit;
# 12(b), the "model" axis, runs all 32
TRAIN_7B_DATA_LAYERS = 8


def at_depth(cfg, layers: int):
    """``cfg`` with its decoder cut to ``layers`` layers."""
    return dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, num_layers=layers))


def first_step_batch(mods, cfg, samples, data: int) -> dict:
    """The global batch of the Trainer's first step at ``data`` data
    ranks: each rank's first 2 batches of 2 from its shard (the loader's
    seeded shuffle), stacked, joined in data-rank order."""
    from anyref_tpu_torch.data.loader import DataLoader
    col = mods["Collator"](mods["AnyRefTokenizer"](), cfg, train=True)
    ranks = []
    for d in range(data):
        it = iter(DataLoader(samples, col, batch_size=2, shuffle=True,
                             num_workers=0, seed=0, drop_last=True,
                             process_index=d, process_count=data))
        ranks.append(mods["step"].stack_microbatches([next(it), next(it)]))
    return global_batch(ranks)


def train_parallel_7b(torch, mods, data: int, model: int) -> dict:
    """Phase 12(b) (data 1, model 2: the sums over "model" launches of the
    all-reduce kernel inside the graphs) and (c) (data 2, model 1: the
    host's data sum over gloo between two graphs): the single process's
    first step on the mesh's first global batch (its weights freed before
    the ranks start), then two ranks on cuda:0, the Trainer compiled on
    both (train_7b_rank). On each rank the program and its replays as
    check_compiled_steps holds them (bit-equal to the eager mesh step),
    finite losses equal on both ranks and in metrics.jsonl, step 1's
    within TRAIN_LOSS_TOL of the single process's, LoRA moved, frozen
    weights untouched, every kernel's launches those of phase 5 a
    micro-step, the training attention at the rank's heads, the
    all-reduce kernel launched on a "model" axis only."""
    import tempfile
    t_phase = time.time()
    tag = "b" if model == 2 else "c"
    what = f"phase 12({tag})"
    cfg = mods["anyref_7b"]()
    if data > 1:
        cfg = at_depth(cfg, TRAIN_7B_DATA_LAYERS)
    steps = TRAIN_7B_STEPS
    samples = train_samples(cfg, mods, TEXTS * 2, IMAGE_SIZES * 2, seed=0)
    params = mods["tparams"].init(
        cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    want, grads, _ = single_step_grads(torch, mods, cfg, params,
                                       first_step_batch(mods, cfg, samples,
                                                        data), 2)
    single_s = time.time() - t0
    single_peak = torch.cuda.max_memory_allocated() / 2**30
    del params, grads
    torch.cuda.empty_cache()
    out = tempfile.mkdtemp(prefix="anyref_train7b_")
    try:
        t0 = time.time()
        ranks = run_ranks("train_7b", 2, data=data, model=model, out=out,
                          samples=samples, steps=steps,
                          layers=cfg.llama.num_layers)
        spawn_s = time.time() - t0
        with open(os.path.join(out, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    if [r["step"] for r in recs] != list(range(1, steps + 1)) or \
            [r["writer"] for r in ranks] != [True, False]:
        fail(f"{what}: metrics.jsonl steps {[r['step'] for r in recs]}, "
             f"writers {[r['writer'] for r in ranks]}")
    worst = check_step_metrics({k: recs[0][k] for k in want}, want,
                               f"{what}, step 1")
    lcfg = cfg.llama
    want_shape = (2, lcfg.num_heads // model, -(-cfg.max_seq_len // 128) * 128,
                  lcfg.head_dim)
    for rank, res in enumerate(ranks):
        where = f"{what}: rank {rank}"
        for i, rec in enumerate(recs):
            m = res["metrics"][i]
            rel = max(abs(m[k] - rec[k]) / abs(rec[k]) for k in want)
            if not all(np.isfinite(m[k]) for k in want) or \
                    rel > RANK_LOSS_TOL:
                fail(f"{where}: step {i + 1} logged {rec}, returned {m}")
        check_compiled_steps(res, steps, where)
        check_train_launches(res["launches"], res["backward"], cfg,
                             steps * 2, where)
        if res["split"] != (data > 1) or \
                bool(res["all_reduces"]) != (model > 1):
            fail(f"{where}: program split {res['split']}, "
                 f"{res['all_reduces']} all-reduce launches")
        if not res["lora_moved"] or not res["frozen_untouched"]:
            fail(f"{where}: LoRA moved {res['lora_moved']}, frozen untouched"
                 f" {res['frozen_untouched']}")
        # the first step's, from the host: its micro-steps' passes and
        # recomputes
        if res["causal_shapes"] != {want_shape: 2 * lcfg.num_layers * 2}:
            fail(f"{where}: training attention shapes "
                 f"{res['causal_shapes']}, want {want_shape}")
        log(f"[train-parallel-7b] ({data}, {model}) rank {rank}: weights "
            f"made in {res['build_s']:.2f} s ({res['held_gib']:.2f} GiB held "
            f"by the Trainer), {res['trainable_values']} trainable values; "
            f"{compiled_steps_summary(res)}; all-reduce kernel launches "
            f"{res['all_reduces']} ({res['all_reduces'] / steps:g} a step); "
            f"host all-reduces of the replays by axis (card synchronised "
            f"around each) {json.dumps(res['collectives'])}; "
            f"flash_causal_attention_diff step 1 "
            f"{json.dumps({str(list(k)): v for k, v in res['causal_shapes'].items()})}"
            f", backward {res['backward']}")
    log(f"[train-parallel-7b] ({data}, {model}): logged losses "
        f"{[round(r['loss'], 5) for r in recs]}, each both ranks' own; step "
        f"1 against the single process on the same global batch "
        f"({2 * data} rows x 2 micro-steps; {single_s:.2f} s, peak "
        f"{single_peak:.2f} GiB): worst loss-term rel err {worst:.3g} (limit "
        f"{TRAIN_LOSS_TOL}); {mods['card']}; two ranks share the card by "
        f"time slices of their contexts: no figure of several cards")
    log(f"[phase 12] ({tag}) anyref_7b at ({data}, {model}), "
        f"{cfg.llama.num_layers} decoder layers, two ranks on "
        f"cuda:0, compiled, in {time.time() - t_phase:.1f} s (ranks "
        f"{spawn_s:.1f} s)")
    return {k: [r[k] for r in ranks] for k in (
        "walls", "eager_walls", "collectives", "capture_s", "pool_bytes",
        "peak_gib", "all_reduces")}


def tensor_bytes(tree) -> int:
    """Bytes of the tensors in a tree."""
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    return 0 if tree is None else tree.numel() * tree.element_size()


def tree_pairs(a, b, path=""):
    """(path, leaf of a, leaf of b) of two trees of one structure."""
    if isinstance(a, dict):
        if set(a) != set(b):
            fail(f"trees differ at {path}: {sorted(a)} vs {sorted(b)}")
        return [p for k in a for p in tree_pairs(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, list):
        if len(a) != len(b):
            fail(f"trees differ at {path}: {len(a)} vs {len(b)} entries")
        return [p for i, (x, y) in enumerate(zip(a, b))
                for p in tree_pairs(x, y, f"{path}/{i}")]
    return [(path, a, b)]


def check_same_tree(torch, a, b, what: str) -> int:
    """Every leaf of ``a`` bit-equal to ``b``'s (dtype and shape too)."""
    pairs = tree_pairs(a, b)
    for path, x, y in pairs:
        if x.dtype != y.dtype or x.shape != y.shape or \
                not torch.equal(x.cpu(), y.cpu()):
            fail(f"{what}: {path} differs")
    return len(pairs)


def log_ptxas(src: str, text: str) -> None:
    """One line per compiled kernel of a ptxas -v report: its (mangled)
    name, registers and spill bytes."""
    name = spill = None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.split("stack frame, ")[-1].strip()
        elif "registers" in line and name:
            regs = line.split("Used ")[1].split(",")[0]
            log(f"[build] {src} {name}: {regs}, {spill}")
            name = None


# the sources of the warp-specialised wgmma kernels, whose ptxas report
# must show no spill and no serialised wgmma
WGMMA_SOURCES = ("causal_attention.cu", "causal_attention_bwd.cu",
                 "fused_layers.cu", "int8_matmul.cu", "relpos_global.cu")


def check_wgmma_build(src: str, text: str) -> None:
    """Fail on a spill or on a wgmma that ptxas serialised (C7510-C7520:
    a register operand reused while in flight, too few registers, a
    compiler-inserted warpgroup arrive) in a wgmma source's ptxas report."""
    for line in text.splitlines():
        if ("spill stores" in line and not line.split("stack frame, ")[-1]
                .startswith("0 bytes spill stores")) or \
                any(f"C75{n}" in line for n in range(10, 21)):
            fail(f"ptxas, {src}: {line.strip()}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import torch.nn.functional as F
        from anyref_tpu_torch import params as tparams
        from anyref_tpu_torch.config import anyref_7b, anyref_tiny
        from anyref_tpu_torch.data.base import SegDataset
        from anyref_tpu_torch.data.collator import Collator
        from anyref_tpu_torch.data.preprocess import (crop_box_np,
                                                      preprocess_clip_np)
        from anyref_tpu_torch.models import anyref as anyref_mod
        from anyref_tpu_torch import checkpoint, export
        from anyref_tpu_torch.eval.runner import Predictor
        from anyref_tpu_torch.models import llama, sam
        from anyref_tpu_torch.models.sam import image_encoder
        from anyref_tpu_torch.models.sam.amg import SamAutomaticMaskGenerator
        from anyref_tpu_torch.models.sam.predictor import SamPredictor
        from anyref_tpu_torch.ops import attention, common, flash, mel, quant
        from anyref_tpu_torch.serve import Request, Server, serving_predictor
        from anyref_tpu_torch.tokenizer import (AnyRefTokenizer,
                                                audio_ref_question,
                                                img_ref_question, seg_answer,
                                                seg_question,
                                                tokenize_conversation,
                                                tokenize_prompt)
        from anyref_tpu_torch.train import lora, step
        from anyref_tpu_torch.train.trainer import TrainConfig, Trainer
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    t_run = time.time()

    def stamp(what: str) -> None:
        log(f"[time] {what} done at {time.time() - t_run:.1f} s")

    # phase 1
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    log(card)
    t0 = time.time()
    lib = flash.build()
    log(f"[build] {lib.name} in {time.time() - t0:.1f} s")
    for src in flash.SOURCES:
        tag = lib.stem.rsplit("-", 1)[1]
        logf = flash.BUILD_DIR / f"{src.rsplit('.', 1)[0]}-{tag}.log"
        if logf.exists():
            log_ptxas(src, logf.read_text())
            if src in WGMMA_SOURCES:
                check_wgmma_build(src, logf.read_text())

    # phase 2
    results = check_kernels(torch, F, flash, {"image_encoder": image_encoder,
                                              "common": common,
                                              "attention": attention,
                                              "quant": quant})
    dispatch = check_ops(torch, flash)
    stamp("phases 1-2")
    mods = {"anyref_7b": anyref_7b, "anyref_tiny": anyref_tiny,
            "tparams": tparams, "Server": Server,
            "Request": Request, "AnyRefTokenizer": AnyRefTokenizer,
            "seg_question": seg_question, "seg_answer": seg_answer,
            "tokenize_prompt": tokenize_prompt,
            "tokenize_conversation": tokenize_conversation,
            "SegDataset": SegDataset, "Collator": Collator, "lora": lora,
            "step": step, "TrainConfig": TrainConfig, "Trainer": Trainer,
            "llama": llama, "quant": quant, "anyref": anyref_mod,
            "mel": mel, "img_ref_question": img_ref_question,
            "audio_ref_question": audio_ref_question,
            "crop_box_np": crop_box_np,
            "preprocess_clip_np": preprocess_clip_np, "card": card,
            "sam": sam, "SamPredictor": SamPredictor,
            "SamAutomaticMaskGenerator": SamAutomaticMaskGenerator,
            "export": export, "Predictor": Predictor,
            "serving_predictor": serving_predictor,
            "checkpoint": checkpoint}
    # phase 3: "unfused" and "unfused_qkv" at anyref_tiny, "fused" and
    # "fused_block" where both fused SAM gates open (64 <= ws^2 and a 32 x
    # 32 global grid), the int8 decoder at anyref_tiny, and one train step
    tiny = anyref_tiny()
    tiny512 = dataclasses.replace(tiny, sam=dataclasses.replace(
        tiny.sam, image_size=512, window_size=8))
    check_tiny_slice(torch, tiny, "unfused", tparams, anyref_mod)
    check_tiny_slice(torch, tiny512, "fused", tparams, anyref_mod)
    check_tiny_slice(torch, tiny, "unfused_qkv", tparams, anyref_mod)
    check_tiny_slice(torch, tiny512, "fused_block", tparams, anyref_mod)
    check_tiny_slice(torch, tiny, "fused", tparams, anyref_mod, quant=quant,
                     flash=flash)
    check_tiny_rephrase(torch, tiny512, tparams, anyref_mod)
    check_tiny_references(torch, tiny, "unfused", mods)
    check_tiny_references(torch, tiny512, "fused", mods)
    check_tiny_train(torch, tiny, mods)
    stamp("phase 3")
    # phase 4
    launches, int8_step, phase10, phase13 = serve_7b(torch, flash, mods)
    torch.cuda.empty_cache()
    stamp("phase 4 (with 7(b), 8(b)'s eval, 9(b), 10(b), 13(b))")
    # phase 5
    trained = train_7b(torch, flash, mods)
    torch.cuda.empty_cache()
    stamp("phase 5")
    # phase 6
    checkpoint_phase(torch, flash, mods)
    stamp("phase 6")
    # phase 7(a); 7(b) ran in phase 4, on its weights
    eval_tiny(torch, flash, mods, tiny, tiny512)
    stamp("phase 7(a)")
    # phase 8(a), and (b)'s training (its inverse eval ran in phase 4)
    phase8_tiny(torch, flash, mods, tiny)
    train_7b_from_disk(torch, flash, mods)
    torch.cuda.empty_cache()
    stamp("phase 8")
    # phase 9(a); (b) ran in phase 4, on its SAM weights
    sam_alone_tiny(torch, flash, mods, tiny, tiny512)
    stamp("phase 9(a)")
    # phase 10(a); (b) ran in phase 4, on its weights before its first Server
    serving_tiny(torch, flash, mods, tiny, tiny512)
    stamp("phase 10(a)")
    # phase 13(a); (b) ran in phase 4, on its weights
    graph_tiny(torch, flash, mods, tiny, tiny512)
    stamp("phase 13(a)")
    # phase 11: ranks on the one card; (0) the all-reduce kernel first
    all_reduce_entry = check_all_reduce(torch, mods)
    parallel_tiny(torch, mods)
    launches["parallel"] = parallel_7b(torch, flash, mods)
    torch.cuda.empty_cache()
    stamp("phase 11")
    # phase 12: training on two ranks of the one card
    train_parallel_tiny(torch, mods)
    phase12 = {"(1, 2)": train_parallel_7b(torch, mods, 1, 2),
               "(2, 1)": train_parallel_7b(torch, mods, 2, 1)}
    stamp("phase 12")

    # phase 14
    meta = {
        "layer_norm_fused": ("anyref_tpu_torch/csrc/norms.cu",
                             "anyref_tpu/ops/flash.py:615"),
        "rms_norm_fused": ("anyref_tpu_torch/csrc/norms.cu",
                           "anyref_tpu/ops/flash.py:651"),
        "flash_relpos_attention": ("anyref_tpu_torch/csrc/window_attention.cu",
                                   "anyref_tpu/ops/flash.py:192"),
        "flash_causal_attention": ("anyref_tpu_torch/csrc/causal_attention.cu",
                                   "anyref_tpu/ops/flash.py:323"),
        "fused_window_attn": ("anyref_tpu_torch/csrc/fused_layers.cu",
                              "anyref_tpu/ops/flash.py:989"),
        "fused_mlp_stream": ("anyref_tpu_torch/csrc/fused_layers.cu",
                             "anyref_tpu/ops/flash.py:1109"),
        "fused_global_tail": ("anyref_tpu_torch/csrc/fused_layers.cu",
                              "anyref_tpu/ops/flash.py:1226"),
        "flash_attention_qkv": ("anyref_tpu_torch/csrc/relpos_global.cu",
                                "anyref_tpu/ops/flash.py:1395"),
        "fused_window_block": ("anyref_tpu_torch/csrc/fused_layers.cu",
                               "anyref_tpu/ops/flash.py:855"),
        "flash_relpos_attention_qkv": (
            "anyref_tpu_torch/csrc/window_attention.cu",
            "anyref_tpu/ops/flash.py:1336"),
        "int8_matmul": ("anyref_tpu_torch/csrc/int8_matmul.cu",
                        "anyref_tpu/ops/quant.py:73"),
    }
    # the rel-pos wrappers' global kernel, which takes grids of more than
    # 256 tokens (the 7B global layers), as it takes fused_global_tail's
    # attention
    long_source = {
        "flash_relpos_attention": "anyref_tpu_torch/csrc/relpos_global.cu",
        "flash_relpos_attention_qkv":
            "anyref_tpu_torch/csrc/relpos_global.cu"}
    # the run of the path each kernel serves ("fused", the default, for the
    # rest)
    own_path = {"flash_relpos_attention": "unfused",
                "flash_relpos_attention_qkv": "unfused_qkv",
                "fused_window_block": "fused_block", "int8_matmul": "int8"}
    kernels = []
    diff = results["flash_causal_attention_diff"]
    kernels.append({
        "name": "flash_causal_attention_diff", "route": "cuda",
        "source": "anyref_tpu_torch/csrc/causal_attention_bwd.cu",
        "forward_source": "anyref_tpu_torch/csrc/causal_attention.cu",
        "replaces": "anyref_tpu/ops/flash.py:566",
        # forward calls over the 3 train steps (the recompute of each
        # checkpointed layer included), and per step
        "launches": trained["launches"],
        "launches_per_train_step": trained["launches"] / trained["steps"],
        "backward_launches": trained["backward_launches"],
        "shape": diff[0]["shape"],
        "max_abs_err": max(r["max_abs_err"] for r in diff),
        **{k: diff[0][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "backward_ms", "backward_plain_ms", "backward_bound_ms",
            "backward_bound_by", "library_fwd_bwd_ms", "delta_ms",
            "max_abs_err_by_output", "rel_l2_err_by_output")},
        "other_shapes": diff[1:],
        "cuda_per_call": {"forward": results["causal_per_call"]["forward"],
                          "backward": results["causal_per_call"]["backward"]},
        "dispatch_us": {"forward": dispatch["causal_attention_diff_fwd"],
                        "backward": dispatch["causal_attention_diff_bwd"]},
    })
    for name, (src, replaces) in meta.items():
        rows = results[name]
        head = rows[0]
        by_path = {path: n[name] for path, n in launches.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": by_path[own_path.get(name, "fused")],
            "launches_by_path": by_path,
            "shape": head["shape"],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "rel_l2_err": max(r["rel_l2_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            **({"long_source": long_source[name],
                "library_with_factors_ms": head["library_with_factors_ms"],
                "cuda_per_call": head["cuda_per_call"]}
               if name in long_source else {}),
            **({"cuda_per_call": results["causal_per_call"]["prefill"]}
               if name == "flash_causal_attention" else {}),
            **({"cuda_per_call": results["one_kernel_per_call"][name]}
               if name in results["one_kernel_per_call"] else {}),
            **({"attention_source": "anyref_tpu_torch/csrc/relpos_global.cu"}
               if name == "fused_global_tail" else {}),
            **({"attention_source":
                "anyref_tpu_torch/csrc/window_attention.cu"}
               if name in ("fused_window_attn", "fused_window_block") else {}),
            **({"gemm_source": "anyref_tpu_torch/csrc/gemm.cuh",
                "row_pass_source": "anyref_tpu_torch/csrc/norms.cu",
                "cuda_per_call": results["fused_per_call"][name],
                "gemm": results["gemm"],
                "row_pass": results["layer_norm_rows"]}
               if name in results["fused_per_call"] else {}),
            **({"decode_step": int8_step} if name == "int8_matmul" else {}),
            "unfused_ms": head.get("unfused_ms"),
            "split_pair_ms": head.get("split_pair_ms"),
            "dispatch_us": dispatch[name],
            "other_shapes": rows[1:],
        })
    # the all-reduce over "model": its launches on phase 11(b)'s path, the
    # (1, 2) Server's rank 0
    kernels.append({**all_reduce_entry,
                    "launches": launches["parallel"]["all_reduce"]})
    log(f"[phase 5] {json.dumps({k: trained[k] for k in ('compiled', 'eager')})}")
    log(f"[phase 10] (b) {json.dumps(phase10)}")
    log(f"[phase 12] {json.dumps(phase12)}")
    log(f"[phase 13] (b) {json.dumps(phase13)}")
    log(f"[card] {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
