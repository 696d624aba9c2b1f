#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``dlrover_tpu_torch``) on one card.

Drives the port's main paths with random weights drawn on the card
from ``--seed``, through the hand-written CUDA kernels built from
``dlrover_tpu_torch/csrc/``:

- serving: ``GenerationServer`` → ``Scheduler`` → ``ServingEngine`` →
  ``Decoder`` paged prefill/decode → ``ops.paged_attention``, with
  llama3-8b at full width and depth; then with speculative decoding
  (``spec_k=4``: ``Decoder.verify_chunk_paged`` → the kernel's verify
  variant) and prefix sharing;
- training: ``TrainStepBuilder.build()`` → ``loss_fn`` → ``forward`` →
  the layers (``ops.norm`` fused norms, ``ops.flash_attention``) →
  ``fused_linear_ce`` → backward (the flash and norm backward kernels)
  → AdamW, at batch 8 × seq 1024 and full width and depth, with
  llama-1.4b (24 layers, heads of 128: the flash kernels that hold one
  head a block, rmsnorm) and gpt2-1.5b (48 layers, 25 heads of 64: the
  packed flash kernels, two heads a block, the last block one;
  layernorm with bias, learned positions, the tied 50304-vocab head);
  then glm-10b at full width and 4 layers with a prefix-LM mask per
  sequence (packed kernels with the prefix); then ``Trainer`` with
  Flash Checkpoint;
- elastic training: the launcher (``dlrover_tpu_torch.agent.launcher``:
  a local job master, the elastic agent and its checkpoint saver)
  restarting a crashed llama-1.4b worker
  (``dlrover_tpu_torch.examples.train_gpt_elastic``) on the card, its
  batches from the master's data-shard service; then four ranks of the
  worker on the card with ZeRO update sharding, two of them evicted
  mid-run and the optimizer state live-resharded onto the other two;
- sequence parallelism: ``TrainStepBuilder`` over ``MeshConfig(dp=1,
  sp=4)`` → ``loss_fn(mesh=...)`` → ``ring_attention`` (the flash
  kernels with ring offsets on its window-partial and prefix-only
  blocks) or ``ulysses_attention``, four ranks on the one card;
- fully sharded data and tensor parallelism, four ranks on the card,
  and ZeRO on those meshes: the elastic example's ``--hosts-per-slice
  2 --zero1`` (dp 2 × fsdp 2), dp 2 × tp 2, and dp 4 over four slices
  on the int8 and bf16 gradient wires;
- sequence parallelism with tensor parallelism
  (``Trainer(mesh=MeshConfig(sp=2, tp=2))``, the ring) and tensor
  parallelism over a head count tp does not divide (gpt2-1.5b's 25
  heads on fsdp 2 × tp 2: each rank's ``wq`` columns moved over tp to
  its whole heads and back), four ranks on the card.

Phases, one JSON line each; any failure exits nonzero and prints no
result:

1. device: the card (``nvidia-smi`` name and power limit) and the
   kernel builds from source (one ``nvcc`` per source, all at once);
   library: the library backwards timed as yardsticks, each captured in
   a CUDA graph, replayed once under the profiler, which must list the
   library's kernels;
2. kernel: every paged-attention case against its plain PyTorch
   version at llama3-8b's attention shapes (H 32, Hkv 8, D 128, page
   16): decode at B=8 (ragged positions up to 2047, a free slot) and at
   B=1 (position 2047: the walk split over the most blocks), chunk at
   C=256 (at 1536), C=200 (800 rows, a ragged row tile) and B=2 (starts
   1536 and 700), bf16 and int8 pools, window 0 and 512, a shuffled
   page assignment with -1 columns; the chunk kernel (on the tensor
   cores, ``csrc/attn_fwd_core.cuh``, its walk split across blocks: each
   case records the split count) under the flash kernels'
   element-wise bound (``chunk_bound``), the decode and verify kernel
   (``paged_decode_split_kernel``) under 2^-8 relative + 1e-5; each
   case's largest |Δ|/bound is printed; with the kernel's time, the
   plain version's, ``F.scaled_dot_product_attention`` on pre-gathered
   dense K/V (the gather excluded), each on the card alone (``graph_ms``:
   calls captured in a CUDA graph and replayed), and the byte/operation
   bound. Each case also runs a planted fault (a held page dropped, or
   the window edge moved by one key) that the bound must catch. Then the
   verify variant (``verify_cases``): B 8 × C 5 (a spec_k=4 chunk),
   starts up to 2043, a free slot, and B 1 at the end of the context,
   stale rows in the cells from each start on, with two planted faults
   (an in-flight key row replaced; the plain version that sees the stale
   rows);
3. model: one ``verify_chunk_paged``, one ``decode_step_paged`` and one
   ``prefill_chunk_paged`` on the same pools, through the kernel and
   through the plain attention, and through the kernel with one held
   page dropped. In f32 (full width, 4 layers) the logits must agree
   within the stated tolerance and the planted fault must exceed it; in
   bf16 (full depth) the logits must be finite, and the differences are
   reported;
4. serve: 16 requests (prompts 64–1536 tokens, 32 new tokens, half
   greedy, half temperature 0.8 / top-p 0.9) through ``GenerationServer``
   with int8 pools, then 4 through bf16 pools; every output is checked
   and the kernel's launch counts on that path must be above zero;
   spec_serve (spec-off, spec_k=4 with prompt-lookup drafts, spec_k=4
   with an oracle draft) and prefix_serve (sharing off/on at spec_k 0
   and 4), in bf16 (reported, at half the new tokens:
   ``MEASURE_NEW_TOKENS``) and again with llama3-8b in f32 at full
   depth (serve_f32, gated: streams equal but at near-ties, the
   oracle's drafts accepted above 0.9, prefix hits and COW pages);
5. profile: the decode step, a prefill chunk and a verify step at the
   serve shapes, 4 of each, timed (CUDA events and wall) and traced
   (``torch.profiler``): kernel time by class (the paged-attention
   class also on its own), launches per step, the device's busy share;
6. train_kernel: the flash kernels (forward, dq, dkv; a head a block,
   and two heads of 64 packed a block; every bf16 kernel on wgmma,
   ``flash_fwd_wgmma_kernel``, ``flash_bwd_dq_wgmma_kernel``,
   ``flash_bwd_dkv_wgmma_kernel``, ``flash_fwd_packed_wgmma_kernel``,
   ``flash_bwd_dq_packed_wgmma_kernel`` and
   ``flash_bwd_dkv_packed_wgmma_kernel``) and the norm kernels (forward and
   backward, which spread a wide row over several warps; the backward
   keeps its column sums in registers) against their
   plain versions run in f32 on the same bf16 values, at the train steps'
   shapes (llama-1.4b: flash B 8, S 1024, H 16, D 128, norm rows [8192,
   2048] rmsnorm; gpt2-1.5b: packed flash B 8, S 1024, H 25, D 64, norm
   rows [8192, 1600] layernorm with bias; glm-10b: norm rows [8192, 4096]
   layernorm with bias; norms with and without the residual, each norm
   record with the plans its kernels ran) and in extra cases (GQA, a
   window, D 64 unpacked, ragged S; packed: 16 heads, glm-10b's 64 heads
   at S 2048 with a prefix per sequence of 0, 700 and past the end,
   non-causal bert-base, 25 heads at S 1000; the prefix in the unpacked
   kernels at D 128; a reshard rank's shapes: llama-1.4b's flash at B 2
   and its norm rows [2048, 2048]), each under an
   element-wise bound and each with a planted fault the bound must catch
   (a key row replaced; the prefix shifted by one key; at 25 heads the
   last pack's second head written into head 24, where the ragged path
   must also equal the zero-padded path bit for bit); with each kernel's
   time, its bound, the plain version's time and the library call's
   (``F.scaled_dot_product_attention``, ``F.rms_norm``, ``F.layer_norm``,
   timed only), all on the card alone (``graph_ms``), each kernel in
   turns with its library call, the library backwards through autograd
   captured whole in the graph (``library_backward``; the kernels one
   replay of each runs, by the profiler, in the ``library`` phase right
   after the build), and at gpt2-1.5b's shape the unpacked D 64 kernels'
   times beside the packed;
7. train_model, train_model_gpt2, train_model_glm: ``loss_fn`` and every
   gradient of an f32 model through the kernels against the plain paths
   (``mha_reference``, the plain norm): llama-1.4b and gpt2-1.5b cut to
   4 layers at b8, glm-10b at full width and 4 layers at b2 with
   ``prefix_len`` (317, 700); a layer whose attention sees one future
   key (glm: ``prefix_len + 1``) must exceed the bound;
8. train, train_gpt2: llama-1.4b and gpt2-1.5b, full depth, 6 steps of
   ``TrainStepBuilder`` on one fixed batch: finite, falling loss and the
   exact launches of every training kernel (the config's flash kernels
   once a layer, the other pack's never, each norm kernel 2·layers + 1
   times a step); step time, tokens/s, model-FLOPs share, peak memory;
   then train_glm: bf16 glm-10b, 4 layers, 3 steps with a ``prefix_len``
   per sequence: finite loss, exact launches;
9. train_profile, train_gpt2_profile: one step under ``torch.profiler``:
   kernel time by class, launches per step, the device's busy share;
10. trainer: ``Trainer`` with Flash Checkpoint, llama-1.4b at full width
   and 2 layers (b8 × s1024, f32 params and moments, fixed batches from
   ``--seed``; the depth keeps the run's disk writes under 45 GiB):
   (a) 10 steps, staging to shared memory every 2 and persisting every 4
   over the first 8 (two persists of the 2.8 GB pack), exact launches;
   (b) a new Trainer resumes from the memory tier to a state equal to
   the saved one bit for bit and repeats (a)'s last losses; (d) a byte
   flipped in the staged pack shows in that leaf alone; (c) the segment
   unlinked, the same from storage (``step_8/``); (e) ``block_k=4`` over
   the same batches gives (a)'s losses, its first block under
   ``torch.cuda.set_sync_debug_mode("error")``; each save, persist and
   restore beside its bound from the pinned copy and disk rates measured
   in the phase. The batches are the elastic worker's
   (``synthetic_batch``, keyed by the step);
11. elastic: ``python -m dlrover_tpu_torch.agent.launcher --nnodes 1
   --nproc 1 --max-restarts 1 -- python -m
   dlrover_tpu_torch.examples.train_gpt_elastic`` in a subprocess under
   ``timeout``: the worker forms an NCCL group (world 1) from the sealed
   rendezvous, loads the kernels built above, trains llama-1.4b at full
   width and depth (b8 × s1024, f32 params and moments: the 16.4 GB
   pack) staging to the agent-served shared memory every 2 steps and to
   disk every 4, and crashes right after step 5 on its first run; the
   agent sees the exit, persists the staged step 4 from its own process,
   re-rendezvouses and respawns; the new worker resumes from the memory
   tier at step 4, checks the staged pack against the committed
   ``step_4/`` byte for byte and trains to step 8. First, the same run
   uninterrupted and without checkpoints in this process (the same seed,
   batches and optimizer) gives the reference. Gated: the order exit →
   round 2 → success and launcher exit 0; NCCL world 1 rank 0 on CUDA;
   no kernel rebuilt in a worker; both runs' losses equal the
   reference's bit for bit; step 4 committed before the respawn, and
   step 8 last; the committed pack's payload the reference's; every
   step's batch from the master's shard of that step, the resumed run's
   dataset position put back from the restored pack; exact launches
   every step; no segment or socket left. Read from the run's
   trace files (agent and workers): the crash to the agent seeing it,
   the agent's persists against the disk yardstick, rendezvous and
   respawn, the worker's start, group, kernel load and memory restore,
   the crash to the first step back, the steady step against the
   reference's, and any step stalled during a persist;
11b. reshard: the same launcher with ``--nproc 4`` runs the worker on
   four ranks of the one card over gloo (``--one-card``), llama-1.4b at
   full width and 2 layers (as ``trainer``), b8 × s1024, ``--zero1``
   (the zero2 mode: the moments are each rank's columns of the flat
   bucket stream; 64 MB buckets), the data from the master's shard
   service, no checkpoint. After step 4 of 6 ranks 2 and 3 are evicted:
   the master's reshard directive, the migration of the flat moments
   to the survivors, the departing ranks' exit 0, the survivors' new
   gloo group at ``grad_accum`` 2. Gated: both survivors' ``[reshard]
   done`` live with dp 4->2 and all five phases ok, no storage restore;
   each survivor's migrated columns (moments and packed parameters) equal
   the ``reshard_flat`` repack of the state gathered before the eviction
   bit for bit; the first loss after it within 1.0 of the last before,
   every loss finite; every rank's loss and grad norm of every step
   within 1e-5 and 1e-4 (relative) of a replicated run in this process
   on the same global batches (grad_accum 4 micro-batches of a rank's 2
   rows), and a second launcher run of 2 steps whose every gradient
   exchange has its middle bucket zeroed (``--zero-fault-worker``)
   outside them; rank 0's shards cover [0, 6 × 8) once and the
   master counts 6 completed; the departing ranks' exit; K1, K2 and the
   norm kernels launched on every rank every step as the layers and the
   accumulation imply; the two runs' disk writes under 3 GiB. Read: the
   phase's seconds, each reshard phase's, the recovery, the step at dp 4
   and at dp 2, peak memory a rank;
12. ring, ulysses, ring_glm: four processes on the card in a gloo group
   (asked for: NCCL refuses two ranks on one GPU; the ring shifts and
   all-to-alls stage their CUDA tensors through page-locked host
   memory), ``MeshConfig(dp=1, sp=4)``: mistral-7b at full width and 2
   layers, b1 × s8192 (blocks of 2048, window 4096: ranks 2 and 3 each
   meet a window-partial block, the offsets, a dense and a diagonal one,
   rank 3 also an empty one), over the ring and over Ulysses
   (``attn_impl="auto"``); glm-10b at full width and 2 layers, b2 ×
   s2048, prefixes 0 and one past the first block (prefix-only blocks)
   over the ring. Each: f32 loss and first-layer gradients within 1e-3 of
   one process's flash step on the same batch and weights, a planted
   fault (the ring's k_off on one rank; Ulysses' window or prefix on one
   rank's heads) beyond it, bf16 within 2e-3 (loss) and 5e-2
   (gradients), then 1 bf16 step: finite losses, each rank's launches
   (the offset ones apart) exactly those of its block map, no kernel
   rebuilt in a worker, each rank's peak memory. The train_kernel phase
   also holds the six flash kernels with ring offsets against their
   plain versions at these blocks' shapes (bf16 and f32, the fault k_off
   off by one key), timed beside themselves without offsets;
13. fsdp_tp: four processes on the card over gloo, ``MeshConfig(fsdp=2,
   tp=2)``, llama-1.4b at full width and 2 layers, 2 steps at b8 ×
   s1024: every rank's loss and grad norm within 1e-4 (relative) of a
   one-process replicated run, a run without the tp sum of ``wk``/``wv``'s
   gradients outside it, exact launches, each rank's state under 0.3 of
   the replicated one;
14. hybrid_zero: llama-1.4b at full width and 2 layers, four ranks on the
   card over gloo, b8 × s1024, 3 steps in (a), 2 in (b) and (c): (a)
   the elastic example
   with ``--hosts-per-slice 2 --zero1`` under the launcher (dp 2 × fsdp
   2 over two slices, zero2), (b) dp 2 × tp 2 zero1, then one step on
   each mesh with a planted fault (a leaf's gradient from one fsdp
   peer's shard only; the columns' square sums over the world), (c) dp
   4 over ``num_slices=4`` on the int8 dcn wire and on the bf16 wire,
   a step on the f32 wire, and an int8 step with a planted wire fault
   (the middle bucket decoded without one peer's rows). Gated: (a) and
   (b) every rank's loss and grad norm of every step within 1e-4 of a
   one-process replicated run on the same global batches, the faults
   outside; (c) within ``HYBRID_WIRE_RTOL`` and not the f32 stream, the
   wire fault outside; the bytes each rank sends a step equal to the
   plan's count; exact launches; no kernel rebuilt; (a) writes nothing
   to disk. Read: a step's wall s a rank and its share in the
   collectives (in the exchange for (a), from its ``zero.exchange``
   spans), state bytes and peak memory a rank, the phase's seconds.
   The train_kernel phase holds K1/K2 at a rank's B 2 × H 16 and K3/K4
   at [2048, 2048];
15. mesh4d: four processes on the card over gloo. (a) mistral-7b at
   full width and 2 layers on ``Trainer(mesh=MeshConfig(sp=2, tp=2))``,
   ring attention, b1 × s8192 (a rank's 16 query and 4 KV heads over a
   4096 block; sp rank 1's window-partial block carries the offsets);
   (b) gpt2-1.5b at full width and 2 layers on ``MeshConfig(fsdp=2,
   tp=2)``, b8 × s1024 (each tp rank's 800 ``wq`` columns moved to its
   13 or 12 whole heads: K1p/K2p). Each: 2 f32 steps whose every rank's
   loss and grad norm must be within 1e-4 of a one-process replicated
   f32 run on the same global batches, a planted fault step outside it
   ((a) no sp sum of the wk/wv gradients; (b) the q move's backward
   dropping the straddling head's returned half), 2 bf16 steps with
   exact launches a rank (the offset ones too), finite losses; no kernel
   rebuilt. Read: a bf16 step's wall s, peak memory and state bytes a
   rank. The train_kernel phase holds K1/K2 at (a)'s shapes (the
   diagonal and the offsets block), K1p/K2p at 13 and 12 heads, K3/K4 at
   [4096, 4096] and [4096, 1600].

The lines before the last are the card's name and power limit and a
``{"kernels": [...]}`` summary (the chunk kernel's entry also gives its
split count; it and ``flash_fwd`` give their bytes and the share of
their bound they reach); the last line is
``{"ok": true, "device": {...}}``. Run: ``python3 chip_smoke.py``.
"""

import argparse
import concurrent.futures
import gc
import contextlib
import dataclasses
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_OPS_PER_S = 989e12    # dense bf16 tensor-core peak
H100_F32_OPS_PER_S = 67e12      # f32 on the CUDA cores
PAGED_SRC = "dlrover_tpu_torch/csrc/paged_attention.cu"
PAGED_REPLACES = "dlrover_tpu/ops/pallas_paged.py:300"
FLASH_SRC = "dlrover_tpu_torch/csrc/flash_attention.cu"
NORM_SRC = "dlrover_tpu_torch/csrc/fused_norm.cu"
# the training kernels: (name, source, the TPU kernel it replaces, the CUDA
# kernel the bf16 train steps launch)
TRAIN_KERNELS = (
    ("flash_fwd", FLASH_SRC, "dlrover_tpu/ops/pallas_attention.py:213",
     "flash_fwd_wgmma_kernel"),
    ("flash_bwd_dq", FLASH_SRC, "dlrover_tpu/ops/pallas_attention.py:369",
     "flash_bwd_dq_wgmma_kernel"),
    ("flash_bwd_dkv", FLASH_SRC, "dlrover_tpu/ops/pallas_attention.py:423",
     "flash_bwd_dkv_wgmma_kernel"),
    ("flash_fwd_packed", FLASH_SRC,
     "dlrover_tpu/ops/pallas_attention.py:278",
     "flash_fwd_packed_wgmma_kernel"),
    ("flash_bwd_dq_packed", FLASH_SRC,
     "dlrover_tpu/ops/pallas_attention.py:484",
     "flash_bwd_dq_packed_wgmma_kernel"),
    ("flash_bwd_dkv_packed", FLASH_SRC,
     "dlrover_tpu/ops/pallas_attention.py:546",
     "flash_bwd_dkv_packed_wgmma_kernel"),
    ("norm_fwd", NORM_SRC, "dlrover_tpu/ops/pallas_norm.py:95",
     "norm_fwd_kernel"),
    ("norm_bwd", NORM_SRC, "dlrover_tpu/ops/pallas_norm.py:126",
     "norm_bwd_kernel"),
)
# Kernel vs plain version, per element of the attention output. The
# plain version runs in f32 on the very values the kernel reads (bf16 q
# and pools upcast exactly; int8 pages dequantized through the codec to
# bf16, as the kernel rounds its in-register dequant). The decode and
# verify kernels keep f32 throughout, so the two differ only by f32
# summation order (far below 1e-5 at these shapes) and the kernel's one
# rounding of its output to bf16 (at most 2^-9 relative): the bound is
# twice that rounding plus 1e-5. The bf16 chunk kernel (on the tensor
# cores) also rounds each unnormalized probability p to bf16 before P·V,
# as the flash kernels do, while l sums the unrounded p: that adds at most
# 2^-8 of M = sum_j p_j·|v_j| / l, the attention of the same rows over
# |V|, which the check computes in f32 from magnitudes; its chunk bound is
# the flash kernels' (2^-8·|plain| + (2^-8 + 2^-12)·M) plus 1e-5. Against
# the plain version in bf16 the difference is only reported: its chunk
# variant rounds the normalized probabilities to bf16 before P·V (as
# mha_reference does).
KERNEL_ATOL = 1e-5
KERNEL_RTOL = 2.0 ** -8
# speculative decoding: drafts per verify step (a verify chunk is
# SPEC_K + 1 rows: the last committed token and the drafts)
SPEC_K = 4
# Model logits, kernel vs plain attention, max |Δ| over max |logit|. In
# f32 (full width, depth cut to 4) the two attentions differ by
# summation order only, so the logits must agree to 1e-3 of the largest
# logit, and one dropped page must move them by more. The bf16 run at
# full depth is a report: every layer rounds its residual stream to
# bf16, and a random-weight network carries one-ulp differences of the
# attention output forward into logit differences of the same order as
# a dropped page's. The same tolerance decides a near-tie in the served
# streams: where a spec-on (or prefix-hit) stream leaves the spec-off
# (or cold) stream, the two tokens' scores there, re-scored
# teacher-forced, must lie within MODEL_REL_TOL of the largest |logit|.
# That is gated with llama3-8b in f32 at full depth, where the two runs
# differ by f32 rounding only; in bf16 it is reported: the verify step
# runs its matmuls on 5x the rows of a decode step, cuBLAS sums in
# another order, and one-ulp bf16 differences grow through 32 layers to
# gaps of ~1% of max |logit| (PERF.md, section 6).
MODEL_REL_TOL = 1e-3
F32_CHECK_LAYERS = 4
# the bf16 spec and prefix runs measure (their streams are not gated):
# they generate half the tokens of the gated f32 runs, which keeps the
# whole script inside its time limit (one run on a slow host took 1199 s
# of the 1200 with 64 and 32)
MEASURE_NEW_TOKENS = 32
# Training kernels vs their plain versions run in f32 on the same bf16
# values, per element. bf16 keeps 8 significant bits, so one rounding is
# at most 2^-8 relative. A bf16 kernel rounds (a) its output once, and
# (b) the probabilities p (forward, dV) or ds (dQ, dK) before the
# products that consume them, at most 2^-8 · M in all, where M is the
# same product on magnitudes (sum_j p_j·|v_j| for the forward, P^T·|dO|
# for dV, |dS|·|K| for dQ, |dS|^T·|Q| for dK), which the check computes
# in f32. The f32 sums of the two sides differ in order only: 2^-12 · M
# more covers that with room to spare. One difference is not relative to
# M: ds = p·(dp − delta)·scale subtracts two f32 dot products of D terms
# computed in another order on each side, which cancel where a query
# sees few keys; each is off by at most D·2^-24 ≤ 2^-16 of its terms'
# magnitudes, so dQ and dK take 2^-16 · C more, with C the product of
# p·scale·(|dO|·|V|^T + rowsum(|dO|·|O|)) with |K| (dQ) or |Q| (dK).
# Bound: 2^-8·|plain| + (2^-8 + 2^-12)·M (+ 2^-16·C for dQ, dK).
FLASH_ROUND = 2.0 ** -8
FLASH_SLACK = 2.0 ** -12
FLASH_DOT = 2.0 ** -16
# Norms: the kernel rounds its output once (2^-8 relative); its f32 row
# sums differ from the plain version's in order only, far below 2^-16 of
# the terms' magnitudes (M = |x·r·s| forward; |r·g·s| + |r³·dot·h| for
# dx; layernorm: M = |xhat·s| forward, r·(|g·s| + mean|g·s| +
# |xhat|·mean|g·s·xhat|) for dx, whose two row means are f32 sums in
# another order). Bound: 2^-8·|plain| + 2^-16·M + 1e-6. dscale and dbias
# (f32 column sums of 8192 rows): 1e-5 of the sum of magnitudes.
NORM_ROUND = 2.0 ** -8
NORM_SLACK = 2.0 ** -16
# The f32 train_model check: max |Δ| over max |value| of the loss and of
# every gradient leaf, kernels (f32 instantiations) against the plain
# paths, TF32 off; the two differ in summation order only.
TRAIN_MODEL_REL_TOL = 1e-3
TRAIN_STEPS = 6
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
# glm-10b at full width, depth cut to 4 layers: steps of the bf16 run, and
# the batch of the f32 check
GLM_LAYERS, GLM_STEPS, GLM_CHECK_BATCH = 4, 3, 2

_failures = []
#: each phase's seconds on the host clock, in the order they ran, and
#: when the script's imports were done
_phase_seconds = {}
_START = time.monotonic()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def phase(name):
    t0 = time.monotonic()
    try:
        yield
    except Exception as exc:  # noqa: BLE001 — report and go on to fail
        _failures.append(f"{name}: {exc!r}")
        emit({"phase": name, "ok": False, "error": repr(exc),
              "seconds": time.monotonic() - t0})
    finally:
        _phase_seconds[name] = time.monotonic() - t0


def cuda_ms(fn, iters, warmup=3):
    """Mean ms per call over ``iters`` calls, CUDA events, warmed up."""
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


_capture = []


def capture_stream():
    """The one stream every CUDA graph of this script is captured on.
    Autograd runs a backward's kernels on the stream its forward ran on,
    so a library backward whose forward ran here (``library_backward``)
    is captured whole, as ``torch.cuda.make_graphed_callables`` captures
    one."""
    if not _capture:
        _capture.append(torch.cuda.Stream())
    return _capture[0]


def library_backward(fwd, inputs, grad):
    """A call of the library's backward of ``fwd`` (``torch.autograd.grad``
    of ``fwd(*inputs)`` against ``grad``, every input a leaf) that
    ``graph_ms`` can capture: the forward runs once, on the capture
    stream."""
    leaves = [x.detach().requires_grad_() for x in inputs]
    stream = capture_stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = fwd(*leaves)
    torch.cuda.current_stream().wait_stream(stream)
    return lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True)


def graph_kernels(fn):
    """The device kernels of one replay of ``fn`` captured in a CUDA graph,
    by the profiler: what a graph-timed library call runs."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=capture_stream()):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    del graph
    return sorted({e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def graph_ms(fn, iters, warmup=3):
    """Mean device ms per call over ``iters`` calls captured in one CUDA
    graph and replayed, CUDA events around the replays: the card's time
    alone. A paged kernel takes a few microseconds on the card while its
    Python wrapper takes tens on the host, so ``cuda_ms`` would time the
    host there; a library backward through autograd likewise."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=capture_stream()):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * iters)
    del graph
    return ms


def in_turns_ms(fns, iters):
    """``graph_ms`` of each of ``fns``, timed in turns (first to last, then
    last to first) and averaged, so that a drift of the card's clocks
    during the timings (as after the flash cases' tensor-core load) weighs
    on each alike: a kernel and its yardstick are compared so."""
    ms = [0.0] * len(fns)
    for i in list(range(len(fns))) + list(range(len(fns)))[::-1]:
        ms[i] += graph_ms(fns[i], iters) / 2
    return ms


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernel cases
# ---------------------------------------------------------------------------


def _fill_pools(geom, gen, dev):
    """Pools of ``geom`` holding random K/V rows (int8 rows go through
    the real codec)."""
    from dlrover_tpu_torch.ops import quant
    from dlrover_tpu_torch.serving import kv_cache as kvc

    pools = kvc.init_pools(geom, dev)
    g = geom
    rows = (g.n_layers, g.n_pages, g.page_size, g.row_elems)
    for name in ("k", "v"):
        x = torch.randn(rows, generator=gen, device=dev, dtype=torch.float32)
        if g.mode == "bf16":
            pools[name].copy_(x.reshape(pools[name].shape))
        else:
            q, s = quant.kv_encode_rows(x, g.kv_block)
            pools[name + "_q"].copy_(q)
            pools[name + "_scale"].copy_(s)
    return pools


def _fragmented_tables(n_slots, width, lens, page_size, rng):
    """Block tables over a shuffled page order: slot i holds the pages
    covering ``lens[i]`` tokens, the rest of its row is -1."""
    perm = list(rng.permutation(np.arange(1, 1 + n_slots * width)))
    tab = np.full((n_slots, width), -1, np.int32)
    for i, n in enumerate(lens):
        need = -(-int(n) // page_size)
        for j in range(need):
            tab[i, j] = perm.pop()
    return tab


def _pages_bucket(tables: np.ndarray) -> int:
    """The page-walk width the engine would use for these tables: the
    next power of two of the most pages a slot holds, 4 at least."""
    held = int((tables >= 0).sum(1).max())
    bucket = 4
    while bucket < held:
        bucket *= 2
    return min(bucket, tables.shape[1])


def _bound(bytes_moved, ops):
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_BF16_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def _work(q, tables, pos_rows, geom, window, max_pages):
    """Bytes the call must move and operations it must do for THIS
    data: q read, out written, positions/tables read, and every page
    holding a key some query may see read once (payload + scales); 4·D
    operations per (query head, visible key) pair (QK and PV)."""
    b, c, h, d = q.shape
    ps = geom.page_size
    row_bytes = (geom.row_elems * 2 if geom.mode == "bf16"
                 else geom.row_elems + 4 * geom.n_blocks)
    pages = 0
    pairs = 0
    tab = tables.cpu().numpy()
    pos = pos_rows.cpu().numpy()
    for i in range(b):
        lo, hi = int(pos[i].min()), int(pos[i].max())
        for j in range(max_pages):
            first = j * ps
            if tab[i, j] < 0 or first > hi:
                continue
            if window and first + ps - 1 <= lo - window:
                continue
            pages += 1
        for p in pos[i]:
            n_keys = int(p) + 1
            if window:
                n_keys = min(n_keys, window)
            # keys on -1 pages do not exist (free slots see none)
            held = int((tab[i] >= 0).sum()) * ps
            pairs += min(n_keys, held)
    kv_bytes = 2 * pages * ps * row_bytes
    io_bytes = 2 * q.numel() * q.element_size() + pos.size * 4 + b * max_pages * 4
    return kv_bytes + io_bytes, 4 * d * h * pairs


def _f32_pools(pools, geom):
    """One layer's pools as the kernel reads them, in f32: bf16 pools
    upcast; int8 pages dequantized through the codec to bf16 (what the
    kernel computes in registers), then upcast."""
    from dlrover_tpu_torch.ops import quant

    if geom.mode == "bf16":
        return {"k": pools["k"].float(), "v": pools["v"].float()}
    shape = (geom.n_pages, geom.page_size, geom.kv_heads, geom.head_dim)
    return {n: quant.kv_decode_rows(pools[n + "_q"], pools[n + "_scale"],
                                    torch.bfloat16).float().reshape(shape)
            for n in ("k", "v")}


def _held(out, ref, active, bound=None):
    """(max |out - ref|, elements over the bound, max |out - ref| / bound)
    over the active slots; the bound is KERNEL_ATOL + KERNEL_RTOL·|ref|
    unless one is given (``chunk_bound``)."""
    o, r = out.float()[active], ref.float()[active]
    diff = (o - r).abs()
    b = (KERNEL_ATOL + KERNEL_RTOL * r.abs() if bound is None
         else bound[active])
    return float(diff.max()), int((diff > b).sum()), float((diff / b).max())


def chunk_bound(q, pools_f32, tables, positions, **kw):
    """The bf16 chunk kernel's element-wise bound against the f32 plain
    version (``paged_attention_reference`` on ``q.float()`` and
    ``pools_f32``, the values the kernel reads): FLASH_ROUND·|plain| +
    (FLASH_ROUND + FLASH_SLACK)·M + KERNEL_ATOL, where M is the same
    attention over |V| (sum_j p_j·|v_j| / l), in f32. Returns (plain,
    bound)."""
    from dlrover_tpu_torch.ops import paged_attention as pa

    q32 = q.float()
    ref = pa.paged_attention_reference(q32, pools_f32, tables, positions,
                                       **kw)
    mag = pa.paged_attention_reference(
        q32, {"k": pools_f32["k"], "v": pools_f32["v"].abs()}, tables,
        positions, **kw)
    return ref, (FLASH_ROUND * ref.abs() + (FLASH_ROUND + FLASH_SLACK) * mag
                 + KERNEL_ATOL)


def _sdpa_ms(q, pools, tables, pos_rows, geom, scale, window, max_pages):
    """``F.scaled_dot_product_attention`` on K/V gathered to dense
    tensors beforehand (the gather is not timed): the yardstick."""
    import torch.nn.functional as F
    from dlrover_tpu_torch.ops.paged_attention import gather_pages

    b, c, h, d = q.shape
    k, v = gather_pages(pools, tables, kv_heads=geom.kv_heads,
                        max_pages=max_pages, dtype=q.dtype)
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = kpos[None, None, :] <= pos_rows[:, :, None]
    if window:
        mask = mask & (kpos[None, None, :] > pos_rows[:, :, None] - window)
    mask = mask[:, None]

    def call():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True)
    return graph_ms(call, 32)


# (B, C, starts, timed) of the chunk cases: one 256-token chunk of a
# prompt at 1536, as the engine runs it (timed: the kernels line's shape);
# the ragged C 200 of prefix_serve's prefill_chunk (800 rows, a last row
# tile of 32); two slots at other starts
CHUNK_SHAPES = ((1, 256, (1536,), True), (1, 200, (1536,), False),
                (2, 256, (1536, 700), False))


def kernel_cases(cfg, seed, dev):
    from dlrover_tpu_torch.ops import paged_attention as pa
    from dlrover_tpu_torch.serving import kv_cache as kvc

    results = []
    n_layers = 8  # timing rotates over 8 layers' pools: a cold L2 per call
    d = cfg.head_dim
    scale = d ** -0.5
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    geom_cfg = dataclasses.replace(cfg, n_layer=n_layers)
    # decode: 8 ragged slots (the kernels line's case), and one slot alone
    # at 2047, whose walk the split kernel spreads over the most blocks
    shapes = [("decode", 8, 1, None, True), ("decode", 1, 1, None, True)] + [
        ("chunk", b, c, starts, timed)
        for b, c, starts, timed in CHUNK_SHAPES]
    for mode in ("bf16", "int8"):
        geom = kvc.make_geometry(geom_cfg, n_slots=8, max_len=2048,
                                 page_size=16, mode=mode)
        pools = _fill_pools(geom, gen, dev)
        width = geom.max_pages_per_slot
        for variant, b, c, starts, timed in shapes:
            for window in (0, 512):
                if variant == "decode":
                    # ragged positions up to 2047, slot 7 free (pos 0, no
                    # pages); B 1: the slot at 2047 alone
                    pos = rng.integers(1, 2047, size=b)
                    pos[0] = 2047
                    lens = pos + 1
                    if b == 8:
                        pos[7] = 0
                        lens[7] = 0
                    pos_rows = torch.as_tensor(pos[:, None], dtype=torch.int32,
                                               device=dev)
                    call_pos = pos_rows[:, 0].contiguous()
                else:
                    lens = np.asarray(starts) + c
                    pos_rows = (torch.as_tensor(starts, dtype=torch.int32,
                                                device=dev)[:, None]
                                + torch.arange(c, device=dev,
                                               dtype=torch.int32))
                    call_pos = pos_rows
                tab_np = _fragmented_tables(b, width, lens, 16, rng)
                tables = torch.as_tensor(tab_np, device=dev)
                max_pages = _pages_bucket(tab_np)
                q = torch.randn((b, c, cfg.n_head, d), generator=gen,
                                device=dev).to(torch.bfloat16)
                kw = dict(scale=scale, window=window, kv_heads=cfg.kv_heads,
                          max_pages=max_pages, variant=variant)
                layer0 = kvc.layer_pools(pools, 0)
                f32 = _f32_pools(layer0, geom)
                out = pa.paged_attention(q, layer0, tables, call_pos, **kw)
                torch.cuda.synchronize()
                kernel = pa.kernel_for(c, cfg.n_head, cfg.kv_heads)
                if kernel == "chunk":
                    ref, bound = chunk_bound(q, f32, tables, call_pos, **kw)
                else:
                    ref = pa.paged_attention_reference(
                        q.float(), f32, tables, call_pos, **kw)
                    bound = None
                same = pa.paged_attention_reference(q, layer0, tables,
                                                    call_pos, **kw)
                active = torch.as_tensor(lens > 0, device=dev)
                err, over, ratio = _held(out, ref, active, bound)
                same_err = _held(out, same, active)[0]
                free_zero = bool(torch.all(out[~active] == 0)) if bool(
                    (~active).any()) else True
                finite = bool(torch.isfinite(out.float()).all())
                # planted fault: the window edge one key late, or slot 0's
                # middle held page dropped; the bound must catch it
                if window:
                    fault = "window_edge"
                    bad = pa.paged_attention(q, layer0, tables, call_pos,
                                             **dict(kw, window=window + 1))
                else:
                    fault = "page_dropped"
                    bad_tab = tables.clone()
                    bad_tab[0, int((tab_np[0] >= 0).sum()) // 2] = -1
                    bad = pa.paged_attention(q, layer0, bad_tab, call_pos,
                                             **kw)
                bad_err, bad_over, _ = _held(bad, ref, active, bound)
                control = {"fault": fault, "max_abs_err": bad_err,
                           "over_bound": bad_over, "caught": bad_over > 0}
                cuda = pa.cuda_kernel(kernel, q.dtype, d)
                case = {
                    "phase": "kernel", "kernel": f"paged_attention.{kernel}",
                    "cuda_kernel": cuda,
                    "variant": variant, "mode": mode, "window": window,
                    "B": b, "C": c, "max_pages": max_pages,
                    "splits": pa.call_splits(
                        kernel, cuda, b, c, cfg.n_head, cfg.kv_heads,
                        max_pages, 16, torch.cuda.get_device_properties(
                            dev).multi_processor_count),
                    "max_abs_err": err, "over_bound": over,
                    "max_err_over_bound": ratio,
                    "bound": ("chunk: 2^-8|plain| + (2^-8 + 2^-12) M + 1e-5"
                              if bound is not None else
                              f"{KERNEL_ATOL} + {KERNEL_RTOL}|plain|"),
                    "same_dtype_max_abs_err": same_err, "control": control,
                    "free_slot_zero": free_zero, "finite": finite,
                    "timed": timed,
                    "ok": (over == 0 and control["caught"] and free_zero
                           and finite),
                }
                if timed:
                    layers = itertools.cycle(
                        [kvc.layer_pools(pools, i) for i in range(n_layers)])

                    def run_kernel():
                        pa.paged_attention(q, next(layers), tables, call_pos,
                                           **kw)

                    def run_plain():
                        pa.paged_attention_reference(q, next(layers), tables,
                                                     call_pos, **kw)

                    moved, ops = _work(q, tables, pos_rows, geom, window,
                                       max_pages)
                    bound_ms, bound_by = _bound(moved, ops)
                    case.update(
                        ms=graph_ms(run_kernel, 64),
                        plain_ms=graph_ms(run_plain, 8),
                        library_ms=_sdpa_ms(q, layer0, tables, pos_rows,
                                            geom, scale, window, max_pages),
                        bound_ms=bound_ms, bound_by=bound_by, bytes=moved,
                        ops=ops)
                emit(case)
                if not case["ok"]:
                    _failures.append(f"kernel case {case}")
                results.append(case)
        del pools
    return results


def _verify_work(q, tables, pos_rows, geom, window, max_pages):
    """Bytes and operations of a verify call for THIS data: q, the
    in-flight K/V rows, positions and tables read, out written, and
    every held page below the chunk's start that holds a key some row
    may see read once; 4·D operations per (query head, visible key)
    pair, held keys below the start and in-flight keys at or before the
    row's position, both inside the window."""
    b, c, h, d = q.shape
    ps = geom.page_size
    row_bytes = (geom.row_elems * 2 if geom.mode == "bf16"
                 else geom.row_elems + 4 * geom.n_blocks)
    tab = tables.cpu().numpy()
    pos = pos_rows.cpu().numpy()
    pages = pairs = 0
    for i in range(b):
        start, lo_row, hi_row = int(pos[i, 0]), int(pos[i].min()), \
            int(pos[i].max())
        held = np.zeros(max_pages * ps, bool)
        for j in range(max_pages):
            first = j * ps
            if tab[i, j] < 0 or first >= start or first > hi_row:
                continue
            if window and first + ps - 1 <= lo_row - window:
                continue
            pages += 1
            held[first:first + ps] = True
        held[start:] = False
        for r, p in enumerate(pos[i]):
            lo = max(int(p) - window + 1, 0) if window else 0
            pairs += int(held[lo:int(p) + 1].sum())
            pairs += int((pos[i, :r + 1] >= lo).sum())
    kv_bytes = 2 * pages * ps * row_bytes
    extra_bytes = 2 * b * c * geom.kv_heads * d * q.element_size()
    io_bytes = (2 * q.numel() * q.element_size() + pos.size * 4
                + b * max_pages * 4)
    return kv_bytes + extra_bytes + io_bytes, 4 * d * h * pairs


def _verify_dense(q, pools, tables, pos_rows, ek, ev, geom, window,
                  max_pages, committed_below_start=True):
    """Dense K/V for a verify call (the held pages gathered, the in-flight
    rows appended) and its [B, C, keys] mask: held keys below the chunk's
    start (or, with ``committed_below_start=False``, every held key at or
    before the row — the stale rows at the chunk's own positions
    visible), in-flight keys at or before the row, both inside the
    window."""
    from dlrover_tpu_torch.ops.paged_attention import gather_pages

    b = q.shape[0]
    k, v = (x.to(q.dtype) for x in gather_pages(
        pools, tables, kv_heads=geom.kv_heads, max_pages=max_pages,
        dtype=q.dtype))
    s_len = k.shape[1]
    kpos = torch.arange(s_len, device=q.device).expand(b, s_len)
    key_pos = torch.cat([kpos, pos_rows], 1)
    mask = key_pos[:, None, :] <= pos_rows[:, :, None]
    if committed_below_start:
        held = torch.cat([kpos < pos_rows[:, :1],
                          torch.ones_like(pos_rows, dtype=torch.bool)], 1)
        mask = mask & held[:, None, :]
    if window:
        mask = mask & (key_pos[:, None, :] > pos_rows[:, :, None] - window)
    return (torch.cat([k, ek.to(k.dtype)], 1), torch.cat([v, ev.to(v.dtype)],
                                                         1), mask)


def _verify_stale_visible(q, pools, tables, pos_rows, ek, ev, geom, scale,
                          window, max_pages):
    """The control of the verify cases: the plain verify math in f32 with
    the held keys masked at ``kpos <= pos`` instead of ``kpos < start``,
    so the stale rows planted in the pool cells at the chunk's own
    positions are seen beside the in-flight rows."""
    b, c, h, d = q.shape
    k, v, mask = _verify_dense(q, pools, tables, pos_rows, ek, ev, geom,
                               window, max_pages,
                               committed_below_start=False)
    hkv = k.shape[2]
    qg = q.reshape(b, c, hkv, h // hkv, d)
    s = torch.einsum("bckgd,bskd->bckgs", qg, k) * scale
    s = torch.where(mask[:, :, None, None, :], s, -1e30)
    out = torch.einsum("bckgs,bskd->bckgd", torch.softmax(s, -1), v)
    return out.reshape(b, c, h, d)


def verify_cases(cfg, seed, dev):
    """The verify variant at llama3-8b's attention shapes and a spec_k=4
    chunk: B 8 slots, C 5 rows, ragged starts up to 2043 and a free slot
    (no pages, start 0), bf16 and int8 pools, window 0 and 512. Every
    slot's table covers its chunk and 32 cells more (the engine reserves
    the whole generation), so the cells at and past the start hold other
    rows — the stale rows of an earlier tenant or a copy-on-write donor.
    Each case is held against the plain version in f32 under the kernel
    bound, with two planted faults: in-flight K row 2 replaced (rows 2..4
    must move past the bound), and the control, the plain version that
    sees the stale rows, which must lie past the bound too."""
    from dlrover_tpu_torch.ops import paged_attention as pa
    from dlrover_tpu_torch.serving import kv_cache as kvc

    results = []
    n_layers = 8
    d = cfg.head_dim
    scale = d ** -0.5
    c = SPEC_K + 1
    rng = np.random.default_rng(seed + 20)
    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    geom_cfg = dataclasses.replace(cfg, n_layer=n_layers)
    for mode in ("bf16", "int8"):
        geom = kvc.make_geometry(geom_cfg, n_slots=8, max_len=2048,
                                 page_size=16, mode=mode)
        pools = _fill_pools(geom, gen, dev)
        width = geom.max_pages_per_slot
        for b, window in ((8, 0), (8, 512), (1, 0), (1, 512)):
            # B 8: ragged starts, slot 7 free; B 1: one slot at the end of
            # the context
            start = rng.integers(1, 2044 - c, size=b)
            start[0] = 2048 - c
            lens = np.minimum(start + c + 32, 2048)
            if b == 8:
                start[7] = 0
                lens[7] = 0
            tab_np = _fragmented_tables(b, width, lens, 16, rng)
            tables = torch.as_tensor(tab_np, device=dev)
            max_pages = _pages_bucket(tab_np)
            pos_rows = torch.as_tensor(
                start[:, None] + np.arange(c)[None, :], dtype=torch.int32,
                device=dev)

            def rnd(*shape):
                return torch.randn(shape, generator=gen, device=dev).to(
                    torch.bfloat16)

            q = rnd(b, c, cfg.n_head, d)
            ek, ev = rnd(b, c, cfg.kv_heads, d), rnd(b, c, cfg.kv_heads, d)
            kw = dict(scale=scale, window=window, kv_heads=cfg.kv_heads,
                      max_pages=max_pages, variant="verify")
            layer0 = kvc.layer_pools(pools, 0)
            out = pa.paged_attention(q, layer0, tables, pos_rows,
                                     extra_k=ek, extra_v=ev, **kw)
            torch.cuda.synchronize()
            p32 = _f32_pools(layer0, geom)
            ref = pa.paged_attention_reference(
                q.float(), p32, tables, pos_rows, extra_k=ek.float(),
                extra_v=ev.float(), **kw)
            same = pa.paged_attention_reference(q, layer0, tables, pos_rows,
                                                extra_k=ek, extra_v=ev, **kw)
            every = torch.ones(b, dtype=torch.bool, device=dev)
            err, over, ratio = _held(out, ref, every)
            same_err = _held(out, same, every)[0]
            finite = bool(torch.isfinite(out.float()).all())
            bad_k = ek.clone()
            bad_k[:, 2] = rnd(b, cfg.kv_heads, d)
            bad = pa.paged_attention(q, layer0, tables, pos_rows,
                                     extra_k=bad_k, extra_v=ev, **kw)
            bad_over = _held(bad, ref, every)[1]
            early_over = _held(bad[:, :2], ref[:, :2], every)[1]
            stale_ref = _verify_stale_visible(
                q.float(), p32, tables, pos_rows, ek.float(), ev.float(),
                geom, scale, window, max_pages)
            stale_err, stale_over, _ = _held(out, stale_ref, every)
            faults = {
                "inflight_k_row_2": {"over_bound": bad_over,
                                     "over_bound_rows_0_1": early_over,
                                     "caught": bad_over > 0
                                     and early_over == 0},
                "stale_rows_visible": {"max_abs_err": stale_err,
                                       "over_bound": stale_over,
                                       "caught": stale_over > 0},
            }
            layers = itertools.cycle(
                [kvc.layer_pools(pools, i) for i in range(n_layers)])

            def run_kernel():
                pa.paged_attention(q, next(layers), tables, pos_rows,
                                   extra_k=ek, extra_v=ev, **kw)

            def run_plain():
                pa.paged_attention_reference(q, next(layers), tables,
                                             pos_rows, extra_k=ek,
                                             extra_v=ev, **kw)

            ms = graph_ms(run_kernel, 64)
            plain_ms = graph_ms(run_plain, 8)
            lib_ms = _sdpa_verify_ms(q, layer0, tables, pos_rows, ek, ev,
                                     geom, scale, window, max_pages)
            moved, ops = _verify_work(q, tables, pos_rows, geom, window,
                                      max_pages)
            bound_ms, bound_by = _bound(moved, ops)
            case = {
                "phase": "kernel", "kernel": "paged_attention.verify",
                "cuda_kernel": pa.cuda_kernel("verify", q.dtype, d),
                "variant": "verify", "mode": mode, "window": window,
                "B": b, "C": c, "max_pages": max_pages,
                "starts": [int(x) for x in start],
                "max_abs_err": err, "over_bound": over,
                "max_err_over_bound": ratio,
                "atol": KERNEL_ATOL, "rtol": KERNEL_RTOL,
                "same_dtype_max_abs_err": same_err, "faults": faults,
                "finite": finite, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "bytes": moved, "ops": ops,
                "ok": (over == 0 and finite
                       and all(f["caught"] for f in faults.values())),
            }
            emit(case)
            if not case["ok"]:
                _failures.append(f"verify kernel case {case}")
            results.append(case)
        del pools
    return results


def _sdpa_verify_ms(q, pools, tables, pos_rows, ek, ev, geom, scale, window,
                    max_pages):
    """``F.scaled_dot_product_attention`` over the verify call's keys
    gathered to dense tensors beforehand (held pages, then the in-flight
    rows) under the verify mask: the yardstick, the gather not timed."""
    import torch.nn.functional as F

    k, v, mask = _verify_dense(q, pools, tables, pos_rows, ek, ev, geom,
                               window, max_pages)
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()
    mask = mask[:, None]

    def call():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True)
    return graph_ms(call, 32)


# ---------------------------------------------------------------------------
# phase 3: model-level check
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_attention():
    """Route the decoder's attention through the plain PyTorch version
    for the duration (the comparison run only)."""
    from dlrover_tpu_torch.models import decoder
    from dlrover_tpu_torch.ops import paged_attention as pa

    saved = decoder.paged_attention
    decoder.paged_attention = pa.paged_attention_reference
    try:
        yield
    finally:
        decoder.paged_attention = saved


def model_check(model, cfg, seed, dev):
    from dlrover_tpu_torch.serving import kv_cache as kvc

    rng = np.random.default_rng(seed + 1)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    geom = kvc.make_geometry(cfg, n_slots=8, max_len=2048, page_size=16,
                             mode="int8")
    base = _fill_pools(geom, gen, dev)
    # slot 0 decodes at 1535, then prefills the chunk 1536..1791, so its
    # table covers 1792 tokens; the other slots hold pos + 1
    pos = rng.integers(64, 2047, size=8)
    pos[0] = 1535
    lens = pos + 1
    lens[0] = 1792
    tab = torch.as_tensor(
        _fragmented_tables(8, geom.max_pages_per_slot, lens, 16, rng),
        device=dev)
    tokens = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=8),
                             device=dev)
    chunk_tok = torch.as_tensor(
        rng.integers(1, cfg.vocab_size, size=(1, 256)), device=dev)
    posd = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    valid = torch.ones(8, dtype=torch.bool, device=dev)
    start = torch.tensor([1536], device=dev)
    # a spec_k=4 verify chunk per slot ending at its decode position: the
    # cells from its start on hold random (stale) rows the step must not see
    vstart = posd - SPEC_K
    vtok = torch.as_tensor(
        rng.integers(1, cfg.vocab_size, size=(8, SPEC_K + 1)), device=dev)
    # the planted fault: slot 0 (the decode row and the chunk's slot)
    # loses one held page from the middle of its table
    bad_tab = tab.clone()
    bad_tab[0, int((tab[0] >= 0).sum()) // 2] = -1
    out = {}
    for name, ctx, tables in (
            ("kernel", contextlib.nullcontext(), tab),
            ("plain", plain_attention(), tab),
            ("page_dropped", contextlib.nullcontext(), bad_tab)):
        pools = {k: v.clone() for k, v in base.items()}
        with ctx:
            ver, _, _ = model.verify_chunk_paged(vtok, pools, tables, vstart,
                                                 max_pages=128)
            dec, _ = model.decode_step_paged(tokens, pools, tables, posd,
                                             valid, max_pages=128)
            ch, _ = model.prefill_chunk_paged(
                chunk_tok, pools, tables[:1], start,
                torch.tensor([256], device=dev), max_pages=128)
        torch.cuda.synchronize()
        out[name] = (dec, ch, ver)
        del pools
    gate = cfg.dtype == "float32"
    rec = {"phase": "model", "dtype": cfg.dtype, "n_layer": cfg.n_layer,
           "gate": gate, "tol_rel": MODEL_REL_TOL}
    ok = True
    for i, step in enumerate(("decode_step_paged", "prefill_chunk_paged",
                              "verify_chunk_paged")):
        a, b, bad = (out[n][i] for n in ("kernel", "plain", "page_dropped"))
        scale = float(b.abs().max())
        rel = float((a - b).abs().max()) / scale
        bad_rel = float((bad - b).abs().max()) / scale
        finite = bool(torch.isfinite(a).all())
        rec[step] = {
            "shape": list(a.shape), "max_abs_logit": scale,
            "max_rel_err": rel, "page_dropped_max_rel_err": bad_rel,
            "argmax_agree": float((a.argmax(-1) == b.argmax(-1))
                                  .float().mean()),
            "finite": finite,
        }
        ok = ok and finite
        if gate:
            ok = ok and rel <= MODEL_REL_TOL < bad_rel
    rec["ok"] = ok
    emit(rec)
    if not ok:
        _failures.append(f"model check {rec}")


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------


def _oracle_draft(streams):
    """A draft model that proposes the continuation of ``streams`` (the
    spec-off outputs): every draft is right while a stream follows them."""
    from dlrover_tpu_torch.serving.engine import DraftModel

    class Oracle(DraftModel):
        def propose(self, history, k):
            hist = [int(t) for t in history]
            for ref in streams:
                if len(ref) > len(hist) and ref[:len(hist)] == hist:
                    return ref[len(hist):len(hist) + k]
            return []

    return Oracle()


def _serve_run(model, cfg, dev, prompts, samplings, new, *, staged=0,
               **engine_kw):
    """Serve ``prompts`` through ``GenerationServer`` (8 slots, page 16,
    int8 pools unless ``engine_kw`` says otherwise) with the launch
    counts set to 0 just before; the first ``staged`` requests are
    submitted alone and the rest once each of those has its first token.
    Returns (outputs, record)."""
    from dlrover_tpu_torch.ops import paged_attention as pa
    from dlrover_tpu_torch.serving.server import GenerationServer

    kw = dict(n_slots=8, max_len=2048, page_size=16, mode="int8",
              prefill_chunk=256)
    kw.update(engine_kw)
    server = GenerationServer(model, cfg, device=dev, **kw)
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launches()
    t0 = time.monotonic()
    server.start()
    try:
        reqs = [server.submit(p, new, sampling=s)
                for p, s in zip(prompts[:staged], samplings[:staged])]
        while not all(r.first_token_t or r.future.done() for r in reqs):
            if server.error is not None or time.monotonic() - t0 > 600:
                raise RuntimeError(f"staged requests stalled: "
                                   f"{server.error!r}")
            time.sleep(0.005)
        reqs += [server.submit(p, new, sampling=s)
                 for p, s in zip(prompts[staged:], samplings[staged:])]
        outs = [r.future.result(timeout=600) for r in reqs]
        wall = time.monotonic() - t0
    finally:
        server.stop()
    torch.cuda.synchronize()
    launches = dict(pa.LAUNCHES)
    es = server.engine.stats()
    lat = server.scheduler.latency_summary()
    ok = all(len(o) == len(p) + new and o[:len(p)] == p
             and all(0 <= t < cfg.vocab_size for t in o[len(p):])
             for p, o in zip(prompts, outs))
    ttft = [(r.first_token_t - r.submit_t) * 1e3 for r in reqs]
    rec = {
        "spec_k": es["spec_k"], "prefix_sharing": kw.get("prefix_sharing",
                                                         False),
        "mode": kw["mode"], "requests": len(prompts),
        "prompt_tokens": sum(len(p) for p in prompts),
        "new_tokens_per_request": new, "wall_s": wall,
        "generated_tokens": es["tokens_generated"],
        "tokens_per_s": es["tokens_generated"] / wall,
        "ttft_p50_ms": lat["ttft_p50_ms"], "ttft_p99_ms": lat["ttft_p99_ms"],
        "tpot_p50_ms": lat["tpot_p50_ms"], "tpot_p99_ms": lat["tpot_p99_ms"],
        "e2e_p50_ms": lat["p50"], "e2e_p99_ms": lat["p99"], "ttft_ms": ttft,
        "step_time_s": es["step_time_s"], "host_time_s": es["host_time_s"],
        "draft_tokens": es["draft_tokens"],
        "accepted_tokens": es["accepted_tokens"],
        "spec_accept_rate": es["spec_accept_rate"],
        "verify_steps": es["verify_steps"],
        "tokens_per_verify_step": (es["verify_tokens"] / es["verify_steps"]
                                   if es["verify_steps"] else 0.0),
        "prefill_chunks": es["prefill_chunks"],
        "prefill_tokens": es["prefill_tokens"],
        "prefill_tokens_saved": es["prefill_tokens_saved"],
        "prefix_hit_rate": es["prefix_hit_rate"],
        "cow_pages": es["cow_pages"], "peak_dedup": es["peak_dedup_ratio"],
        "kv_pool_bytes": server.engine.resident_kv_bytes(),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches, "outputs_ok": ok,
    }
    return outs, rec


def _rescore(model, cfg, dev, stream, mode):
    """Teacher-forced logits ``[V]`` f32 that predict the token after
    ``stream``: the stream prefilled in 256-token chunks (as the engine
    prefills a prompt) into fresh one-slot pools."""
    from dlrover_tpu_torch.serving import kv_cache as kvc

    geom = kvc.make_geometry(cfg, n_slots=1, max_len=2048, page_size=16,
                             mode=mode)
    pools = kvc.init_pools(geom, dev)
    tables = torch.arange(1, 1 + geom.max_pages_per_slot, dtype=torch.int32,
                          device=dev)[None]
    n, chunk = len(stream), 256
    logits = None
    for s0 in range(0, n, chunk):
        clen = min(chunk, n - s0)
        tok = torch.zeros((1, chunk), dtype=torch.int64, device=dev)
        tok[0, :clen] = torch.as_tensor(stream[s0:s0 + clen], device=dev)
        lg, _ = model.prefill_chunk_paged(
            tok, pools, tables, torch.tensor([s0], device=dev),
            torch.tensor([clen], device=dev),
            max_pages=-(-(s0 + chunk) // 16))
        logits = lg[0, clen - 1]
    del pools
    return logits.float()


def _divergences(model, cfg, dev, ref_outs, outs, samplings, mode):
    """Each stream's first departure from its reference stream, with the
    reference side re-scored teacher-forced at that position: the gap
    between the scores of the two tokens there (the logits for a greedy
    request; the warped logits plus the position's Gumbel noise, the
    quantity the draw maximizes, for a sampled one), and whether it is a
    near-tie: at most MODEL_REL_TOL of the largest |logit| (over the
    temperature when sampled)."""
    from dlrover_tpu_torch.models.generate import gumbel_noise, warp_logits

    found = []
    for i, (a, b) in enumerate(zip(ref_outs, outs)):
        if a == b:
            continue
        t = next(j for j in range(min(len(a), len(b))) if a[j] != b[j])
        logits = _rescore(model, cfg, dev, a[:t], mode)
        sp = samplings[i]
        tol = MODEL_REL_TOL * float(logits.abs().max())
        score = logits
        if sp.temperature > 0:
            tol /= sp.temperature
            score = warp_logits(logits[None], sp.temperature, sp.top_k,
                                sp.top_p)[0] + gumbel_noise(
                torch.tensor([sp.seed], device=dev),
                torch.tensor([t], device=dev), logits.shape[0])[0]
        gap = float(score[a[t]] - score[b[t]])
        top2 = torch.topk(score, 2).indices.tolist()
        found.append({"request": i, "position": t, "ref_token": a[t],
                      "token": b[t], "top2": top2, "gap": gap, "tol": tol,
                      "near_tie": abs(gap) <= tol})
    return found


def _repeating_prompts(rng, vocab, n, lo, hi, span=128):
    """``n`` prompts of ``lo``..``hi`` tokens, each a random ``span``-token
    stretch repeated: text that prompt-lookup drafting can match."""
    return [list(map(int, np.resize(rng.integers(1, vocab, size=span),
                                    int(rng.integers(lo, hi + 1)))))
            for _ in range(n)]


def _samplings(seed, n):
    from dlrover_tpu_torch.serving.scheduler import SamplingParams

    return [SamplingParams() if i % 2 == 0 else
            SamplingParams(temperature=0.8, top_p=0.9, seed=seed * 1000 + i)
            for i in range(n)]


def serve(model, cfg, seed, dev, mode, n_requests, lengths):
    rng = np.random.default_rng(seed + 2)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, size=int(n))))
               for n in lengths[:n_requests]]
    _, run = _serve_run(model, cfg, dev, prompts,
                        _samplings(seed, len(prompts)), 32, mode=mode)
    ok = (run["outputs_ok"] and run["launches"]["decode"] > 0
          and run["launches"]["chunk"] > 0)
    rec = {"phase": "serve", **run, "ok": ok}
    emit(rec)
    if not ok:
        _failures.append(f"serve {mode}: {rec}")
    return rec


def spec_serve(model, cfg, seed, dev, gate):
    """16 requests (prompts of 512-1536 tokens repeating a 128-token span,
    64 new tokens with ``gate``, else ``MEASURE_NEW_TOKENS`` of them, half
    greedy and half sampled, int8 pools, 8 slots)
    served three times: spec-off, ``spec_k=4`` with prompt-lookup drafts
    (the default) and ``spec_k=4`` with an oracle draft that proposes the
    spec-off continuation. The verify kernel must launch in both spec
    runs. With ``gate`` (the f32 model) the oracle's drafts must also be
    accepted above 0.9, and each spec-on stream must equal the spec-off
    stream or leave it only at a near-tie (``_divergences``); in bf16
    the divergences are reported (see MODEL_REL_TOL). Returns the
    prompt-lookup run's launch counts."""
    rng = np.random.default_rng(seed + 7)
    prompts = _repeating_prompts(rng, cfg.vocab_size, 16, 512, 1536)
    samplings = _samplings(seed, 16)
    new = 64 if gate else MEASURE_NEW_TOKENS
    off, r_off = _serve_run(model, cfg, dev, prompts, samplings, new)
    runs = {"spec_off": r_off}
    ok = r_off["outputs_ok"]
    for name, draft in (("prompt_lookup", None),
                        ("oracle", _oracle_draft(off))):
        outs, rec = _serve_run(model, cfg, dev, prompts, samplings, new,
                               spec_k=SPEC_K, draft=draft)
        rec["divergences"] = _divergences(model, cfg, dev, off, outs,
                                          samplings, "int8")
        runs[name] = rec
        ok = ok and rec["outputs_ok"] and rec["launches"]["verify"] > 0
        if gate:
            ok = ok and all(d["near_tie"] for d in rec["divergences"])
    if gate:
        ok = ok and runs["oracle"]["spec_accept_rate"] > 0.9
    rec = {"phase": "spec_serve", "dtype": cfg.dtype, "n_layer": cfg.n_layer,
           "gate": gate, "tol_rel": MODEL_REL_TOL, "runs": runs, "ok": ok}
    emit(rec)
    if not ok:
        _failures.append(f"spec_serve: {rec}")
    return runs["prompt_lookup"]["launches"]


def prefix_serve(model, cfg, seed, dev, gate):
    """16 requests in 4 groups whose prompts share a 1000-token prefix
    (not page-aligned: 62.5 pages of 16) and end in 16-512 tokens of
    their own; 32 new tokens (``MEASURE_NEW_TOKENS // 2`` without
    ``gate``), half greedy and half sampled, int8 pools,
    8 slots, 200-token prefill chunks (resume points at 1000 fall inside
    a page, so the straddling page is copied on write). One request per
    group is submitted first; the other 12 once those have their first
    token. Served with sharing off and on, each at ``spec_k`` 0 and 4,
    with prefix hits and COW pages; with ``gate`` (the f32 model) the
    sharing-on streams must equal the sharing-off streams or leave them
    only at a near-tie, in bf16 the divergences are reported."""
    rng = np.random.default_rng(seed + 8)
    prefixes = [list(map(int, rng.integers(1, cfg.vocab_size, size=1000)))
                for _ in range(4)]
    order = list(range(4)) + [g for _ in range(3) for g in range(4)]
    prompts = [prefixes[g] + list(map(int, rng.integers(
        1, cfg.vocab_size, size=int(rng.integers(16, 513)))))
        for g in order]
    samplings = _samplings(seed + 1, 16)
    new = 32 if gate else MEASURE_NEW_TOKENS // 2
    runs, ok = {}, True
    for spec_k in (0, SPEC_K):
        streams = {}
        for sharing in (False, True):
            outs, rec = _serve_run(
                model, cfg, dev, prompts, samplings, new, staged=4,
                spec_k=spec_k, prefix_sharing=sharing, max_len=2000,
                prefill_chunk=200)
            streams[sharing] = outs
            rec["follower_ttft_p50_ms"] = float(np.median(rec["ttft_ms"][4:]))
            runs[f"spec{spec_k}_sharing_{'on' if sharing else 'off'}"] = rec
            ok = ok and rec["outputs_ok"]
        on = runs[f"spec{spec_k}_sharing_on"]
        off = runs[f"spec{spec_k}_sharing_off"]
        on["divergences"] = _divergences(model, cfg, dev, streams[False],
                                         streams[True], samplings, "int8")
        on["prefill_chunks_saved"] = (off["prefill_chunks"]
                                      - on["prefill_chunks"])
        ok = ok and on["prefix_hit_rate"] > 0 and on["cow_pages"] > 0
        if gate:
            ok = ok and all(d["near_tie"] for d in on["divergences"])
        if spec_k:
            ok = ok and on["launches"]["verify"] > 0
    rec = {"phase": "prefix_serve", "dtype": cfg.dtype,
           "n_layer": cfg.n_layer, "gate": gate, "tol_rel": MODEL_REL_TOL,
           "runs": runs, "ok": ok}
    emit(rec)
    if not ok:
        _failures.append(f"prefix_serve: {rec}")


# ---------------------------------------------------------------------------
# phase 5: where a model step's time goes
# ---------------------------------------------------------------------------


def _kernel_class(name: str) -> str:
    low = name.lower()
    if "paged_" in low:
        return "paged_attention"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "gemv", "nvjet")):
        return "matmul"
    return "other"


def profile_steps(model, cfg, seed, dev, steps=4):
    """Time the two model steps of the serve phase at its shapes — a
    decode of 8 slots and one 256-token prefill chunk over int8 pools —
    with CUDA events (device time) and the host clock (wall), and trace
    them with ``torch.profiler``: kernel time by class and the device's
    busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from dlrover_tpu_torch.serving import kv_cache as kvc

    rng = np.random.default_rng(seed + 4)
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    geom = kvc.make_geometry(cfg, n_slots=8, max_len=2048, page_size=16,
                             mode="int8")
    pools = _fill_pools(geom, gen, dev)
    pos = rng.integers(64, 1536, size=8)
    pos[0] = 1023
    lens = pos + 1
    lens[0] = 1024 + 256
    tab = torch.as_tensor(
        _fragmented_tables(8, geom.max_pages_per_slot, lens, 16, rng),
        device=dev)
    bucket = _pages_bucket(tab.cpu().numpy())
    tokens = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=8),
                             device=dev)
    posd = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    valid = torch.ones(8, dtype=torch.bool, device=dev)
    chunk = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(1, 256)),
                            device=dev)
    start = torch.tensor([1024], device=dev)
    clen = torch.tensor([256], device=dev)
    vtok = torch.as_tensor(
        rng.integers(1, cfg.vocab_size, size=(8, SPEC_K + 1)), device=dev)
    calls = {
        "decode_step_paged": lambda: model.decode_step_paged(
            tokens, pools, tab, posd, valid, max_pages=bucket),
        "prefill_chunk_paged": lambda: model.prefill_chunk_paged(
            chunk, pools, tab[:1], start, clen, max_pages=bucket),
        "verify_chunk_paged": lambda: model.verify_chunk_paged(
            vtok, pools, tab, posd - SPEC_K, max_pages=bucket),
    }
    for name, fn in calls.items():
        device_ms = cuda_ms(fn, steps)
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3 / steps
        by_class, by_name, n_by_class = {}, {}, {}
        for evt in prof.events():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms = evt.device_time / 1e3 / steps
            cls = _kernel_class(evt.name)
            n_by_class[cls] = n_by_class.get(cls, 0) + 1 / steps
            by_class[cls] = by_class.get(cls, 0.0) + ms
            by_name[evt.name] = by_name.get(evt.name, 0.0) + ms
        busy = sum(by_class.values())
        if not busy or not n_by_class.get("paged_attention"):
            raise RuntimeError(f"profile of {name}: the trace holds no "
                               f"device time for the paged kernel "
                               f"({n_by_class})")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        emit({"phase": "profile", "step": name, "steps": steps,
              "max_pages": bucket, "wall_ms": wall_ms,
              "device_ms": device_ms, "traced_wall_ms": traced_ms,
              "kernel_ms": busy,
              "paged_attention_ms": by_class["paged_attention"],
              "kernels_per_step": sum(n_by_class.values()),
              "kernels_per_step_by_class": n_by_class,
              "device_busy_share": busy / traced_ms,
              "kernel_ms_by_class": by_class,
              "top_kernels_ms": [[n[:80], t] for n, t in top]})
    del pools


# ---------------------------------------------------------------------------
# phase 1: build every kernel source, one nvcc each, all at once
# ---------------------------------------------------------------------------


def build_all():
    from dlrover_tpu_torch.ops import _build

    names = list(_build.sources())
    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        secs = dict(zip(names, ex.map(_build.build, names)))
    per = {}
    for name in names:
        log = _build.build_log(name)
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spill = sum(int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log))
        per[name] = {"compile_s": secs[name], "kernels": len(regs),
                     "max_registers": max(regs, default=0),
                     "spill_bytes": spill}
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "sources": per})


def library_check(seed, dev):
    """The library backwards the kernels line times, captured in a CUDA
    graph as ``graph_ms`` captures them (``library_backward``): one replay
    of each under the profiler must run the library's kernels (not only
    memsets). Run before any other phase has profiled: later in the
    process the profiler was seen to list no kernel of a replayed graph.
    SDPA's backward at llama-1.4b's attention, ``F.rms_norm``'s at its
    [8192, 2048] rows, ``F.layer_norm``'s at glm-10b's [8192, 4096]."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(seed + 11)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    q, k, v, g = (rnd(TRAIN_BATCH, TRAIN_SEQ, 16, 128) for _ in range(4))
    x, gx, w = rnd(8192, 2048), rnd(8192, 2048), rnd(2048)
    y, gy, wy, by = rnd(8192, 4096), rnd(8192, 4096), rnd(4096), rnd(4096)
    calls = {
        "sdpa_backward": _sdpa_train(q, k, v, g, True, 128 ** -0.5)[1],
        "rms_norm_backward": library_backward(
            lambda a, s_: F.rms_norm(a, (2048,), s_, 1e-6), (x, w), gx),
        "layer_norm_backward": library_backward(
            lambda a, s_, b_: F.layer_norm(a, (4096,), s_, b_, 1e-5),
            (y, wy, by), gy),
    }
    kernels = {name: graph_kernels(fn) for name, fn in calls.items()}
    rec = {"phase": "library", "timer": "graph", "kernels": kernels,
           "ok": all(any(not n.startswith("Memset") for n in names)
                     for names in kernels.values())}
    emit(rec)
    if not rec["ok"]:
        _failures.append(f"library: {rec}")


# ---------------------------------------------------------------------------
# phase 6: the training kernels
# ---------------------------------------------------------------------------


def _over(out, ref, bound):
    """(max |out − ref|, elements over ``bound``, max |out − ref| / bound;
    an exact 0 where the bound is 0, as for a key no query sees, counts
    0)."""
    diff = (out.float() - ref.float()).abs()
    ratio = torch.where(diff == 0, 0.0, diff / bound)
    return (float(diff.max()), int((diff > bound).sum()), float(ratio.max()))


def _flash_magnitudes(q, k, v, out, lse, g, causal, scale, window,
                      prefix=None, offsets=None):
    """The magnitude products of the flash bounds, in f32, one batch
    element at a time: sum_j p_j·|v_j| (forward), P^T·|dO| (dV),
    |dS|·|K| (dQ) and |dS|^T·|Q| (dK), and the cancellation terms C of
    dQ and dK; dK/dV magnitudes summed over each KV head's query-head
    group. Returns (fwd, dq, dk, dv, dq_c, dk_c)."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    mask = fa._allowed(sq, sk, causal, window, prefix, offsets, q.device)
    fwd_m = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dq_m = torch.empty_like(fwd_m)
    dk_m = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv_m = torch.empty_like(dk_m)
    dq_c, dk_c = torch.empty_like(dq_m), torch.empty_like(dk_m)

    def kv_sum(x):  # [H, Sk, D] → [Sk, Hkv, D], summed over each group
        return x.reshape(hkv, rep, sk, d).sum(1).transpose(0, 1)

    for i in range(b):
        qi = q[i].float().transpose(0, 1)
        ki = k[i].float().transpose(0, 1).repeat_interleave(rep, 0)
        vi = v[i].float().transpose(0, 1).repeat_interleave(rep, 0)
        gi = g[i].float().transpose(0, 1)
        oi = out[i].float().transpose(0, 1)
        s = torch.einsum("hqd,hkd->hqk", qi, ki) * scale
        if mask is not None:
            s = torch.where(mask[i if mask.shape[0] > 1 else 0], s, -1e30)
        p = torch.exp(s - lse[i].float()[..., None])
        fwd_m[i] = torch.einsum("hqk,hkd->hqd", p, vi.abs()).transpose(0, 1)
        dp = torch.einsum("hqd,hkd->hqk", gi, vi)
        ds = (p * (dp - (gi * oi).sum(-1)[..., None]) * scale).abs()
        dq_m[i] = torch.einsum("hqk,hkd->hqd", ds, ki.abs()).transpose(0, 1)
        dk_m[i] = kv_sum(torch.einsum("hqk,hqd->hkd", ds, qi.abs()))
        dv_m[i] = kv_sum(torch.einsum("hqk,hqd->hkd", p, gi.abs()))
        c = p * scale * (torch.einsum("hqd,hkd->hqk", gi.abs(), vi.abs())
                         + (gi.abs() * oi.abs()).sum(-1)[..., None])
        dq_c[i] = torch.einsum("hqk,hkd->hqd", c, ki.abs()).transpose(0, 1)
        dk_c[i] = kv_sum(torch.einsum("hqk,hqd->hkd", c, qi.abs()))
        del s, p, dp, ds, c
    return fwd_m, dq_m, dk_m, dv_m, dq_c, dk_c


def _visible_pairs(s, causal, window, prefix=0):
    """(query, key) pairs one head of one sequence attends over; with a
    prefix p every query i sees max(i + 1, p) keys."""
    if not causal:
        return s * s
    if not window:
        p = min(max(int(prefix), 0), s)
        return p * p + (s * (s + 1) - p * (p + 1)) // 2
    return sum(min(i + 1, window) for i in range(s))


def _flash_work(kernel, b, s, h, hkv, d, causal, window, prefix=None,
                pairs=None):
    """(bytes, operations) of one flash kernel's share of the work for
    this call: bf16 tensors read and written once (lse/delta f32), and
    2·D FLOP per visible pair for each product (forward: QK^T, PV). The
    backward's least work is five products (10·D per pair, the FA2
    minimum) and one read of q, k, v, dO, lse, delta; the work the two
    backward kernels share (the reads, QK^T and dO·V^T) is counted once,
    in dkv (QK^T, dO·V^T, P^T·dO, dS^T·Q, every read, the dk/dv writes),
    so dq holds only dS·K and its dq write, and the two bounds add up to
    the backward's. The split kernels execute 14·D per pair: both
    recompute QK^T and dO·V^T. ``pairs``: the visible (query, key) pairs
    of every head, counted from the mask (a ring block's offsets), else
    from the mask rule."""
    q_bytes, kv_bytes, row = b * s * h * d * 2, b * s * hkv * d * 2, b * h * s * 4
    if pairs is None:
        pairs = h * sum(_visible_pairs(s, causal, window, p)
                        for p in (prefix if prefix is not None else [0] * b))
    if kernel.startswith("flash_fwd"):
        moved, ops = 2 * q_bytes + 2 * kv_bytes + row, 4 * d * pairs
    elif kernel.startswith("flash_bwd_dq"):
        moved, ops = q_bytes, 2 * d * pairs
    else:
        moved, ops = 2 * q_bytes + 4 * kv_bytes + 2 * row, 8 * d * pairs
    return moved, ops


def _bwd_kernel_fn(which, q, k, v, g, lse, delta, *, causal, scale,
                   window, pack=1, prefix=None, offsets=None):
    """One backward kernel alone (1: dq, 2: dkv; the one
    ``bwd_cuda_kernel`` picks for ``q.dtype`` at ``pack``), launched
    through the C entry, to time it: its outputs are thrown away and its
    launch count is not touched."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    name = fa.bwd_cuda_kernel(q.dtype, pack)[which - 1]
    kernel = fa.BWD_CUDA_KERNELS.index(name)
    outs = [torch.empty_like(x) for x in (q, k, v)]
    q_off, k_off = fa.host_offsets(offsets, sq, sk, window)
    args = ([x.data_ptr() for x in (q, k, v, g, lse, delta, *outs)]
            + [None if prefix is None else prefix.data_ptr()]
            + [b, sq, sk, h, hkv, d, float(scale), int(causal), int(window),
               q_off, k_off, fa._DTYPE_CODE[q.dtype]])

    def run():
        # the stream current at the call: graph_ms captures on its own
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fa._lib()["bwd"](kernel, *args, stream)
        if err:
            raise RuntimeError(f"{name}: cudaError {err}")
        return outs

    return run


def _sdpa_train(q, k, v, g, causal, scale):
    """The yardsticks on the same bf16 tensors, two calls that ``graph_ms``
    captures: ``F.scaled_dot_product_attention``'s forward, and its
    backward through autograd (dq, dk and dv; ``library_backward``)."""
    import torch.nn.functional as F

    qt, kt, vt, gt = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    gqa = q.shape[2] != k.shape[2]

    def fwd(a, b_, c):
        return F.scaled_dot_product_attention(a, b_, c, is_causal=causal,
                                              scale=scale, enable_gqa=gqa)

    return (lambda: fwd(qt, kt, vt)), library_backward(fwd, (qt, kt, vt), gt)


def _sdpa_masked(q, k, v, g, mask, scale):
    """``_sdpa_train`` with an explicit boolean mask ``[B or 1, Sq, Sk]``:
    the library call that computes a ring block's attention (a row that
    sees no key gives NaN there; only its time is read)."""
    import torch.nn.functional as F

    qt, kt, vt, gt = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    gqa = q.shape[2] != k.shape[2]
    m = mask[:, None]

    def fwd(a, b_, c):
        return F.scaled_dot_product_attention(a, b_, c, attn_mask=m,
                                              scale=scale, enable_gqa=gqa)

    return (lambda: fwd(qt, kt, vt)), library_backward(fwd, (qt, kt, vt), gt)


def _zero_head(x):
    """``x`` ``[B, S, H, D]`` with one zero head appended."""
    return torch.cat([x, torch.zeros_like(x[:, :, :1])], 2).contiguous()


def flash_case(name, b, s, h, hkv, d, causal, window, gen, dev, timed,
               pack=1, prefix=None, fault="key", sk=None, offsets=None,
               dtype=torch.bfloat16):
    """The flash kernels (``pack`` 2: the packed ones) at one shape (``s``
    queries, ``sk`` keys, ``s`` by default) against their plain versions,
    with a planted fault: ``key`` (key row min(Sq, Sk)/2 of every KV
    head replaced), ``prefix`` (the prefix shifted by one key), ``k_off``
    (the ring offsets' k_off off by one key) or ``last_pack`` (odd H: the
    last pack's second head, run on the zero-padded inputs, written into
    head H - 1; the ragged path's heads must also equal the padded path's
    bit for bit). ``offsets``: a ring block's ``(q_off, k_off)``; the
    rows that see no key of the block are compared as the ring router
    reads them (their cotangent 0, their lse at or below -1e27, their
    output unread), and the timed case is also timed without offsets on
    the same inputs (the cost of the shift). ``dtype`` float32 runs the
    f32 kernels under the same bound (their arithmetic rounds nothing to
    bf16, so they sit far inside it)."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    scale = d ** -0.5
    names = fa.PACKED if pack == 2 else fa.UNPACKED

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    sk = s if sk is None else sk
    q, k, v, g = rnd(b, s, h, d), rnd(b, sk, hkv, d), rnd(b, sk, hkv, d), \
        rnd(b, s, h, d)
    pref = (None if prefix is None
            else torch.tensor(prefix, dtype=torch.int32, device=dev))
    kw = dict(causal=causal, scale=scale, window=window)
    mask = fa._allowed(s, sk, causal, window, pref, offsets, dev)
    seen = None
    if offsets is not None:
        seen = mask.any(-1).expand(b, s)      # rows that see a key
        g = torch.where(seen[:, :, None, None], g, 0).to(g.dtype)

    def run(q, k, v, g, pref, offs=offsets):
        out, lse = fa.flash_fwd_cuda(q, k, v, prefix=pref, pack=pack,
                                     offsets=offs, **kw)
        delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1)
        grads = fa.flash_bwd_cuda(q, k, v, g, lse, delta.contiguous(),
                                  prefix=pref, pack=pack, offsets=offs, **kw)
        res = dict(zip(("out", "lse", "dq", "dk", "dv"), (out, lse, *grads)))
        if seen is not None:   # the rows the ring merge reads
            res["out"] = torch.where(seen[:, :, None, None], out, 0)
            res["lse"] = torch.where(seen[:, None, :], lse, 0)
        return res

    got = run(q, k, v, g, pref)
    out, lse = got["out"], got["lse"]
    raw_lse = None
    torch.cuda.synchronize()
    f32 = [x.float() for x in (q, k, v)]
    ref_out, ref_lse = fa.flash_fwd_reference(*f32, prefix=pref,
                                              offsets=offsets, **kw)
    if seen is not None:
        # the kernel's own lse, which its backward read
        raw_lse = fa.flash_fwd_cuda(q, k, v, prefix=pref, pack=pack,
                                    offsets=offsets, **kw)[1]
        ref_out = torch.where(seen[:, :, None, None], ref_out, 0)
        ref_lse = torch.where(seen[:, None, :], ref_lse, 0)
    bwd_lse = lse if raw_lse is None else raw_lse
    rdq, rdk, rdv = fa.flash_bwd_reference(*f32, out.float(), bwd_lse,
                                           g.float(), prefix=pref,
                                           offsets=offsets, **kw)
    fm, dqm, dkm, dvm, dqc, dkc = _flash_magnitudes(
        q, k, v, out, bwd_lse, g, causal, scale, window, pref, offsets)

    def bound(ref, m, c=0.0):
        return (FLASH_ROUND * ref.abs() + (FLASH_ROUND + FLASH_SLACK) * m
                + FLASH_DOT * c)

    bounds = {"out": bound(ref_out, fm), "dq": bound(rdq, dqm, dqc),
              "dk": bound(rdk, dkm, dkc), "dv": bound(rdv, dvm)}
    refs = {"out": ref_out, "dq": rdq, "dk": rdk, "dv": rdv}
    checks = {n: _over(got[n], refs[n], bounds[n]) for n in refs}
    checks["lse"] = _over(lse, ref_lse, 1e-5 * (1 + ref_lse.abs()))
    extra = {}
    if seen is not None:
        # a row that sees no key: an lse the merge's guard drops
        extra["dark_rows_lse_low"] = bool(
            (raw_lse.transpose(1, 2)[~seen] <= -1e27).all())
    if fault == "k_off":
        # (a prefix-only block's q_off, at the kernels' range already,
        # moves with it: its causal term stays dead)
        label = "k_off off by one key"
        bad = run(q, k, v, g, pref,
                  (offsets[0] + (offsets[0] < 0), offsets[1] + 1))
    elif fault == "key":
        label = "key row min(Sq, Sk)/2 replaced"  # a key some query sees
        kb = k.clone()
        kb[:, min(s, sk) // 2] = rnd(b, hkv, d)
        bad = run(q, kb, v, g, pref)
    elif fault == "prefix":
        label = "prefix shifted by one key"
        bad = run(q, k, v, g, pref + 1)
    else:
        label = "the last pack's second head written into head H-1"
        padded = run(*(_zero_head(x) for x in (q, k, v, g)), pref)
        extra["ragged_equals_padded"] = all(
            bool(torch.equal(padded[n][:, :h] if n == "lse"
                             else padded[n][:, :, :h], got[n]))
            for n in got)
        bad = {}
        for n in refs:
            x = padded[n][:, :, :h].clone()
            x[:, :, h - 1] = padded[n][:, :, h]
            bad[n] = x
    torch.cuda.synchronize()
    faults = {n: _over(bad[n], refs[n], bounds[n])[1] for n in refs}
    rec = {"phase": "train_kernel", "case": name, "op": "flash",
           "kernels": list(names), "B": b, "S": s, "Sk": sk, "H": h,
           "Hkv": hkv, "dtype": str(q.dtype).replace("torch.", ""),
           "D": d, "causal": causal, "window": window, "pack": pack,
           "prefix": prefix, "offsets": offsets,
           "dark_rows": None if seen is None else int((~seen).sum()),
           "max_abs_err": {n: c[0] for n, c in checks.items()},
           "over_bound": {n: c[1] for n, c in checks.items()},
           "max_err_over_bound": {n: c[2] for n, c in checks.items()},
           "fault": label, "fault_over_bound": faults, **extra,
           "finite": bool(all(torch.isfinite(t.float()).all()
                              for t in got.values()))}
    rec["ok"] = (rec["finite"] and all(c[1] == 0 for c in checks.values())
                 and all(n > 0 for n in faults.values())
                 and all(extra.values()))
    if timed:
        # on the card alone (graph_ms), each kernel in turns with its
        # library call: the forward with SDPA's, dq and dkv with SDPA's
        # backward (dq, dk and dv) through autograd
        pkw = dict(kw, prefix=pref)
        okw = dict(pkw, offsets=offsets)
        fwd_plain = graph_ms(lambda: fa.flash_fwd_reference(q, k, v, **okw),
                             3)
        bwd_plain = graph_ms(lambda: fa.flash_bwd_reference(
            q, k, v, out, bwd_lse, g, **okw), 3)
        if offsets is not None:
            sdpa_fwd, sdpa_bwd = _sdpa_masked(q, k, v, g, mask, scale)
        else:
            sdpa_fwd, sdpa_bwd = (
                (None, None) if window or prefix is not None or sk != s
                else _sdpa_train(q, k, v, g, causal, scale))
        delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1) \
            .contiguous()

        def kernel_ms(p, fwd_yard=None, bwd_yard=None, offs=offsets):
            """ms of the forward, dq and dkv kernels at pack ``p`` (with
            ``offs``), then of the yardsticks given: the forward in turns
            with ``fwd_yard``, dq and dkv with ``bwd_yard``."""
            fwd = [lambda: fa.flash_fwd_cuda(q, k, v, pack=p, offsets=offs,
                                             **pkw)]
            bwd = [_bwd_kernel_fn(w, q, k, v, g, bwd_lse, delta, pack=p,
                                  offsets=offs, **pkw)
                   for w in (1, 2)]
            fwd_ms = (in_turns_ms(fwd + [fwd_yard], 20) if fwd_yard
                      else [graph_ms(fwd[0], 20)])
            bwd_ms = (in_turns_ms(bwd + [bwd_yard], 20) if bwd_yard
                      else [graph_ms(f, 20) for f in bwd])
            return fwd_ms[:1] + bwd_ms[:2] + fwd_ms[1:] + bwd_ms[2:]

        ms = kernel_ms(pack, sdpa_fwd, sdpa_bwd)
        lib_fwd, lib_bwd = ms[3:] if sdpa_fwd else (None, None)

        twin = kernel_ms(pack, offs=None) if offsets is not None else None
        rec["timing"] = {}
        for i, (kernel, t, plain, lib) in enumerate(zip(
                names, ms[:3], (fwd_plain, bwd_plain, bwd_plain),
                (lib_fwd, lib_bwd, lib_bwd))):
            moved, ops = _flash_work(
                kernel, b, s, h, hkv, d, causal, window, prefix,
                None if offsets is None else h * int(mask.expand(
                    b, s, sk).sum()))
            bound_ms, by = _bound(moved, ops)
            rec["timing"][kernel] = {
                "ms": t, "plain_ms": plain, "library_ms": lib,
                "bound_ms": bound_ms, "bound_by": by, "bytes": moved,
                "timer": "graph",
                "library_timer": None if lib is None else "graph"}
            if twin is not None:   # the same inputs without the offsets
                rec["timing"][kernel]["no_offsets_ms"] = twin[i]
        if pack == 2:
            # what packing buys: the unpacked D 64 kernels, same inputs
            rec["unpacked_ms"] = dict(zip(fa.UNPACKED, kernel_ms(1)))
    emit(rec)
    if not rec["ok"]:
        _failures.append(f"train_kernel {name}: {rec}")
    return rec


def _norm_bound(kernel, n, d, residual):
    """(bound ms, by what): bf16 rows read and written once (f32 scale
    and dscale once); the f32 arithmetic per element over the CUDA
    cores' f32 rate (forward 4 + the add; backward 10)."""
    rows = 2 * n * d
    if kernel == "norm_fwd":
        moved = rows * (2 + 2 * residual) + 4 * d
        ops = (4 + residual) * n * d
    else:
        moved = rows * (3 + residual) + 8 * d
        ops = 10 * n * d
    t_bytes = moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def norm_case(name, n, d, residual, gen, dev, timed, kind="rmsnorm"):
    import torch.nn.functional as F

    from dlrover_tpu_torch.ops import norm as nm

    rms = kind == "rmsnorm"
    eps = nm.RMS_EPS if rms else nm.LN_EPS

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    x, g = rnd(n, d), rnd(n, d)
    r = rnd(n, d) if residual else None
    gh = rnd(n, d) if residual else None
    scale = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    bias = None if rms else 0.1 * torch.randn(d, generator=gen, device=dev)
    out, h = nm.norm_fwd_cuda(x, scale, bias, r, kind, eps)
    dx, ds, db = nm.norm_bwd_cuda(g, h, scale, gh, kind, eps, not rms)
    torch.cuda.synchronize()
    h_ref = x + r if residual else x  # bf16 add: the f32 sum rounded once
    h32, g32 = h_ref.float(), g.float()
    ref = nm._reference(h32, scale, bias, kind, eps, None)
    rdx, rds, rdb = nm.norm_bwd_reference(
        g32, h32, scale, None if gh is None else gh.float(), kind, eps,
        not rms)
    gx = g32 * scale
    if rms:
        rr = torch.rsqrt((h32 * h32).mean(-1, keepdim=True) + eps)
        xhat = h32 * rr
        dot = (gx * h32).mean(-1, keepdim=True)
        m_dx = (rr * gx).abs() + (rr ** 3 * dot * h32).abs()
    else:
        mean = h32.mean(-1, keepdim=True)
        var = ((h32 * h32).mean(-1, keepdim=True) - mean * mean).clamp(0)
        rr = torch.rsqrt(var + eps)
        xhat = (h32 - mean) * rr
        m_dx = rr * (gx.abs() + gx.abs().mean(-1, keepdim=True)
                     + xhat.abs() * (gx * xhat).abs().mean(-1, keepdim=True))
    fwd_bound = NORM_ROUND * ref.abs() + NORM_SLACK * (xhat * scale).abs() \
        + 1e-6
    dx_bound = NORM_ROUND * rdx.abs() + NORM_SLACK * m_dx + 1e-6
    checks = {"out": _over(out, ref, fwd_bound),
              "dx": _over(dx, rdx, dx_bound),
              "dscale": _over(ds, rds, 1e-5 * (g32 * xhat).abs().sum(0)
                              + 1e-6)}
    if not rms:
        checks["dbias"] = _over(db, rdb, 1e-5 * g32.abs().sum(0) + 1e-6)
    h_exact = bool(torch.equal(h, h_ref))
    # planted faults: row 17 of x (forward) and of g (backward) replaced
    # by row 18
    xb, gb = x.clone(), g.clone()
    xb[17], gb[17] = x[18], g[18]
    out_b, _ = nm.norm_fwd_cuda(xb, scale, bias, r, kind, eps)
    dx_b, _, _ = nm.norm_bwd_cuda(gb, h, scale, gh, kind, eps, not rms)
    torch.cuda.synchronize()
    faults = {"out": _over(out_b, ref, fwd_bound)[1],
              "dx": _over(dx_b, rdx, dx_bound)[1]}
    # the plans the kernels ran: the forward's and the backward's warps a
    # row and vectors a lane, and the backward's grid (its partial rows)
    bwd_plan = nm.bwd_plan(d, x.dtype, residual)
    plans = {
        "fwd": dict(zip(("warps_per_row", "vectors_per_lane"),
                        nm.fwd_plan(d, x.dtype, residual))),
        "bwd": dict(zip(("warps_per_row", "vectors_per_lane"), bwd_plan),
                    blocks=nm._lib()["bwd_blocks"](
                        n, d, int(rms), int(residual), int(not rms),
                        nm._DTYPE_CODE[x.dtype], *bwd_plan))}
    rec = {"phase": "train_kernel", "case": name, "op": "norm",
           "kernels": list(nm.KERNELS), "rows": n, "d": d,
           "residual": residual, "kind": kind, "bias": not rms,
           "plans": plans,
           "max_abs_err": {k: c[0] for k, c in checks.items()},
           "over_bound": {k: c[1] for k, c in checks.items()},
           "max_err_over_bound": {k: c[2] for k, c in checks.items()},
           "h_bitwise": h_exact, "fault": "row 17 replaced by row 18",
           "fault_over_bound": faults}
    rec["ok"] = (h_exact and all(c[1] == 0 for c in checks.values())
                 and all(v > 0 for v in faults.values()))
    if timed:
        w16 = scale.to(torch.bfloat16)
        b16 = None if rms else bias.to(torch.bfloat16)

        def lib(a, w, b_):
            return (F.rms_norm(a, (d,), w, eps) if rms
                    else F.layer_norm(a, (d,), w, b_, eps))

        lib_bwd = None if residual else library_backward(
            (lambda a, w: lib(a, w, None)) if rms else lib,
            (x, w16) if rms else (x, w16, b16), g)
        # on the card alone (graph_ms), each kernel in turns with its
        # library call (the backward's through autograd)
        fwd = [lambda: nm.norm_fwd_cuda(x, scale, bias, r, kind, eps)]
        if not residual:
            fwd.append(lambda: lib(x, w16, b16))
        fwd_ms = in_turns_ms(fwd, 50)
        bwd = [lambda: nm.norm_bwd_cuda(g, h, scale, gh, kind, eps, not rms)]
        if lib_bwd:
            bwd.append(lib_bwd)
        bwd_ms = in_turns_ms(bwd, 50)
        rec["timing"] = {
            "norm_fwd": {
                "ms": fwd_ms[0],
                "plain_ms": graph_ms(lambda: nm._reference(
                    x, scale, bias, kind, eps, r), 20),
                "library_ms": None if residual else fwd_ms[1],
                "timer": "graph",
                "library_timer": None if residual else "graph"},
            "norm_bwd": {
                "ms": bwd_ms[0],
                "plain_ms": graph_ms(lambda: nm.norm_bwd_reference(
                    g, h, scale, gh, kind, eps, not rms), 20),
                "library_ms": None if residual else bwd_ms[1],
                "timer": "graph",
                "library_timer": None if residual else "graph"},
        }
        for kernel, t in rec["timing"].items():
            t["bound_ms"], t["bound_by"] = _norm_bound(kernel, n, d,
                                                       residual)
    emit(rec)
    if not rec["ok"]:
        _failures.append(f"train_kernel {name}: {rec}")
    return rec


#: the ring blocks that carry offsets at the ring phases' shapes (local
#: S 2048 for mistral-7b at s8192, 512 for glm-10b at s2048, sp 4)
MISTRAL_BOUNDARY = (6144, 2048)    # rank 3 against rank 1's block
PREFIX_ONLY = (-(1 << 30), 0)


def offsets_cases(gen, dev):
    """The flash kernels with ring offsets, each against its plain version
    with the k_off fault, in bf16 (timed, and beside the same kernels
    without offsets) and in f32: mistral-7b's window-boundary block (the
    one-head kernels, GQA, D 128), glm-10b's prefix-only block (the packed
    kernels; block prefixes 200 and 512, then 0 and 200: a sequence no
    prefix reaches), a D 64 window block of the one-head kernels."""
    f32 = torch.float32
    return [
        flash_case("mistral-7b-boundary", 1, 2048, 32, 8, 128, True, 4096,
                   gen, dev, True, offsets=MISTRAL_BOUNDARY, fault="k_off"),
        flash_case("mistral-7b-boundary-f32", 1, 2048, 32, 8, 128, True,
                   4096, gen, dev, False, offsets=MISTRAL_BOUNDARY,
                   fault="k_off", dtype=f32),
        flash_case("glm-10b-prefix-only", 2, 512, 64, 64, 64, True, 0, gen,
                   dev, True, pack=2, prefix=(200, 512),
                   offsets=PREFIX_ONLY, fault="k_off"),
        flash_case("glm-10b-prefix-only-dark", 2, 512, 64, 64, 64, True, 0,
                   gen, dev, False, pack=2, prefix=(0, 200),
                   offsets=PREFIX_ONLY, fault="k_off"),
        flash_case("glm-10b-prefix-only-f32", 2, 512, 64, 64, 64, True, 0,
                   gen, dev, False, pack=2, prefix=(0, 512),
                   offsets=PREFIX_ONLY, fault="k_off", dtype=f32),
        flash_case("window-d64-boundary", 1, 1024, 8, 2, 64, True, 700, gen,
                   dev, False, offsets=(2048, 1024), fault="k_off"),
        flash_case("window-d64-boundary-f32", 1, 1024, 8, 2, 64, True, 700,
                   gen, dev, False, offsets=(2048, 1024), fault="k_off",
                   dtype=f32),
    ]


def sp_shape_cases(gen, dev):
    """The kernels at the other shapes the sp phases launch them (offsets
    0), each against its plain version: mistral-7b's Ulysses attention
    (the whole 8192 sequence, 32/4 query and 8/4 KV heads a rank, window
    4096), its ring's dense block (non-causal) and diagonal block (causal,
    window 4096) at one 2048 block, glm-10b's dense and diagonal blocks
    (the packed kernels; the diagonal with the block's prefixes, one 0),
    and mistral-7b's rmsnorm rows (a rank's 2048 rows of d 4096, plain
    and with the residual)."""
    return [
        flash_case("mistral-7b-ulysses", 1, 8192, 8, 2, 128, True, 4096,
                   gen, dev, False),
        flash_case("mistral-7b-ring-dense", 1, 2048, 32, 8, 128, False, 0,
                   gen, dev, False),
        flash_case("mistral-7b-ring-diagonal", 1, 2048, 32, 8, 128, True,
                   4096, gen, dev, False),
        flash_case("glm-10b-ring-dense", 2, 512, 64, 64, 64, False, 0, gen,
                   dev, False, pack=2),
        flash_case("glm-10b-ring-diagonal", 2, 512, 64, 64, 64, True, 0,
                   gen, dev, False, pack=2, prefix=(0, 300),
                   fault="prefix"),
        norm_case("mistral-7b", 2048, 4096, False, gen, dev, False),
        norm_case("mistral-7b+residual", 2048, 4096, True, gen, dev, False),
    ]


def reshard_shape_cases(gen, dev):
    """The kernels at the shapes a rank of the reshard phase launches
    them, each against its plain version with its planted fault:
    llama-1.4b's attention at a rank's 2 rows (b8 over dp 4, and over dp
    2 in 2 micro-batches), causal, no window, no prefix; its rmsnorm rows
    (2048 of d 2048, plain and with the residual)."""
    return [
        flash_case("llama-1.4b-reshard", 2, 1024, 16, 16, 128, True, 0,
                   gen, dev, False),
        norm_case("llama-1.4b-reshard", 2048, 2048, False, gen, dev, False),
        norm_case("llama-1.4b-reshard+residual", 2048, 2048, True, gen, dev,
                  False),
    ]


def train_kernel_cases(seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    cases = [
        # llama-1.4b's attention in the train step: timed
        flash_case("llama-1.4b", 8, 1024, 16, 16, 128, True, 0, gen, dev,
                   True),
        flash_case("gqa", 2, 1024, 16, 4, 128, True, 0, gen, dev, False),
        flash_case("window", 2, 1024, 16, 16, 128, True, 256, gen, dev,
                   False),
        flash_case("d64", 2, 1024, 16, 16, 64, True, 0, gen, dev, False),
        flash_case("ragged", 2, 1000, 8, 2, 128, False, 0, gen, dev, False),
        # the packed kernels: gpt2-1.5b's attention in the train step,
        # timed beside the unpacked D 64 kernels (25 heads: the last pack
        # holds one)
        flash_case("gpt2-1.5b", 8, 1024, 25, 25, 64, True, 0, gen, dev,
                   True, pack=2, fault="last_pack"),
        flash_case("gpt2-355m", 2, 1024, 16, 16, 64, True, 0, gen, dev,
                   False, pack=2),
        # glm-10b's heads with a prefix per sequence: none, mid-tile, and
        # past the end
        flash_case("glm-10b", 3, 2048, 64, 64, 64, True, 0, gen, dev, False,
                   pack=2, prefix=(0, 700, 2148), fault="prefix"),
        flash_case("bert-base", 2, 512, 12, 12, 64, False, 0, gen, dev,
                   False, pack=2),
        flash_case("packed-ragged", 2, 1000, 25, 25, 64, True, 0, gen, dev,
                   False, pack=2),
        # the prefix in the unpacked kernels
        flash_case("prefix-d128", 2, 1024, 16, 16, 128, True, 0, gen, dev,
                   False, prefix=(513, 1500), fault="prefix"),
    ]
    cases += offsets_cases(gen, dev)
    cases += sp_shape_cases(gen, dev)
    cases += reshard_shape_cases(gen, dev)
    cases += fsdp_tp_shape_cases(gen, dev)
    cases += hybrid_shape_cases(gen, dev)
    cases += mesh4d_shape_cases(gen, dev)
    cases += [
        # the train steps' norms: [B·S, d_model] rows, timed
        norm_case("llama-1.4b", 8192, 2048, False, gen, dev, True),
        norm_case("llama-1.4b+residual", 8192, 2048, True, gen, dev, True),
        norm_case("gpt2-1.5b", 8192, 1600, False, gen, dev, True,
                  "layernorm"),
        norm_case("gpt2-1.5b+residual", 8192, 1600, True, gen, dev, True,
                  "layernorm"),
        # glm-10b's rows in train_glm: layernorm with bias at d 4096 (a
        # row over 8 warps in both kernels)
        norm_case("glm-10b", 8192, 4096, False, gen, dev, True, "layernorm"),
        norm_case("glm-10b+residual", 8192, 4096, True, gen, dev, True,
                  "layernorm"),
    ]
    return cases


# ---------------------------------------------------------------------------
# phase 7: the f32 training check
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def future_key_attention(layer: int):
    """The planted fault: attention call ``layer`` (the layer's index in a
    forward) runs through the kernels with every query one position
    later, so query i also sees key i + 1 — the causal edge off by one."""
    from dlrover_tpu_torch.models import decoder

    saved = decoder.flash_attention
    calls = [0]

    def attn(q, k, v, **kw):
        i = calls[0]
        calls[0] += 1
        if i != layer:
            return saved(q, k, v, **kw)
        q1 = torch.cat([torch.zeros_like(q[:, :1]), q], 1)
        k1 = torch.cat([k, k[:, -1:]], 1)
        v1 = torch.cat([v, v[:, -1:]], 1)
        return saved(q1, k1, v1, **kw)[:, 1:]

    decoder.flash_attention = attn
    try:
        yield
    finally:
        decoder.flash_attention = saved


def _train_batch(cfg, rng, b, dev, prefix=None):
    tok = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(b, TRAIN_SEQ + 1)), device=dev)
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    if prefix is not None:
        batch["prefix_len"] = torch.as_tensor(prefix, dtype=torch.int32,
                                              device=dev)
    return batch


def train_model_check(cfg, seed, dev, name="train_model", b=TRAIN_BATCH,
                      prefix=None):
    """``loss_fn`` and every gradient through the kernels against the
    plain paths (f32). The planted fault: without a prefix, layer 1's
    attention sees one future key; with one, ``prefix_len + 1``."""
    from dlrover_tpu_torch.models import decoder

    model = decoder.init(cfg, seed=seed, device=dev, trainable=True)
    batch = _train_batch(cfg, np.random.default_rng(seed + 5), b, dev,
                         prefix)
    names = [n for n, _ in model.named_parameters()]
    leaves = [p for _, p in model.named_parameters()]

    def run(run_cfg, attn_impl, ctx, batch):
        with ctx:
            loss, _ = decoder.loss_fn(model, batch, run_cfg,
                                      attn_impl=attn_impl)
            grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return [loss.detach()] + list(grads)

    kern = run(cfg, "auto", contextlib.nullcontext(), batch)
    plain = run(dataclasses.replace(cfg, fused_norm=False), "reference",
                contextlib.nullcontext(), batch)
    if prefix is None:
        label = "layer 1 attention sees one future key"
        fault = run(cfg, "auto", future_key_attention(1), batch)
    else:
        label = "prefix_len + 1"
        fault = run(cfg, "auto", contextlib.nullcontext(),
                    dict(batch, prefix_len=batch["prefix_len"] + 1))

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    labels = ["loss"] + names
    sound = {n: rel(a, b) for n, a, b in zip(labels, kern, plain)}
    planted = {n: rel(a, b) for n, a, b in zip(labels, fault, plain)}
    worst = max(sound, key=sound.get)
    caught = max(planted, key=planted.get)
    rec = {"phase": name, "config": cfg.name, "dtype": cfg.dtype,
           "n_layer": cfg.n_layer, "batch": b, "seq": TRAIN_SEQ,
           "prefix_len": prefix, "tol_rel": TRAIN_MODEL_REL_TOL,
           "loss": float(kern[0]), "loss_plain": float(plain[0]),
           "leaves": len(names), "max_rel_err": sound[worst],
           "max_rel_err_leaf": worst, "loss_rel_err": sound["loss"],
           "fault": label, "fault_max_rel_err": planted[caught],
           "fault_leaf": caught, "fault_loss_rel_err": planted["loss"],
           "finite": all(bool(torch.isfinite(t).all()) for t in kern)}
    rec["ok"] = (rec["finite"] and sound[worst] <= TRAIN_MODEL_REL_TOL
                 < planted[caught])
    emit(rec)
    if not rec["ok"]:
        _failures.append(f"{name}: {rec}")
    del model, kern, plain, fault


# ---------------------------------------------------------------------------
# phases 8-9: llama-1.4b trains; where a step's time goes
# ---------------------------------------------------------------------------


def _train_launches():
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import norm as nm

    return {**fa.LAUNCHES, **nm.LAUNCHES}


def _reset_train_launches():
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import norm as nm

    fa.reset_launches()
    nm.reset_launches()


def train_run(cfg, seed, dev, name="train", steps=TRAIN_STEPS,
              prefix=None, falling=True):
    """``steps`` steps of ``TrainStepBuilder`` on one fixed batch of
    TRAIN_BATCH × TRAIN_SEQ (with ``prefix`` as its ``prefix_len``):
    finite loss, falling when ``falling``, and exactly one launch of each
    flash kernel of the config's pack per layer and 2·layers + 1 of each
    norm kernel per step, none of the other pack's."""
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.train.optimizer import make_optimizer
    from dlrover_tpu_torch.train.train_step import (
        TrainStepBuilder,
        init_train_state,
    )

    opt = make_optimizer(learning_rate=1e-4, warmup_steps=10,
                         decay_steps=1000)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    state = init_train_state(seed, cfg, opt, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    step = TrainStepBuilder(cfg, opt, device=dev).build()
    batch = _train_batch(cfg, np.random.default_rng(seed + 6), TRAIN_BATCH,
                         dev, prefix)
    losses, grad_norms, device_ms, wall_ms = [], [], [], []
    _reset_train_launches()
    for _ in range(steps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        e0.record()
        state, m = step(state, batch)
        e1.record()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t) * 1e3)
        device_ms.append(e0.elapsed_time(e1))
        losses.append(float(m["loss"]))
        grad_norms.append(float(m["grad_norm"]))
    launches = _train_launches()
    pack = fa.head_pack_for(cfg.n_head, cfg.kv_heads, cfg.head_dim,
                            cfg.attn_head_pack)
    flash = fa.PACKED if pack == 2 else fa.UNPACKED
    expected = {k: cfg.n_layer * (k in flash) for k in fa.KERNELS}
    expected.update(norm_fwd=2 * cfg.n_layer + 1, norm_bwd=2 * cfg.n_layer + 1)
    expected = {k: v * steps for k, v in expected.items()}
    steady = sorted(device_ms[1:])[len(device_ms[1:]) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    rec = {"phase": name, "config": cfg.name, "n_layer": cfg.n_layer,
           "params": sum(p.numel() for p in state["params"].parameters()),
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": steps,
           "head_pack": pack, "prefix_len": prefix,
           "init_s": init_s, "losses": losses, "grad_norms": grad_norms,
           "step_device_ms": device_ms, "step_wall_ms": wall_ms,
           "steady_step_ms": steady, "tokens_per_s": tokens / steady * 1e3,
           "mfu": cfg.flops_per_token(TRAIN_SEQ) * tokens / (steady / 1e3)
           / H100_BF16_OPS_PER_S,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": launches, "launches_expected": expected}
    rec["ok"] = (all(math.isfinite(x) for x in losses + grad_norms)
                 and (losses[-1] < losses[0] or not falling)
                 and launches == expected)
    emit(rec)
    if not rec["ok"]:
        _failures.append(f"{name}: {rec}")
    return state, step, batch, rec, opt


def _train_kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_fwd_" in low or "flash_bwd_" in low:
        return "flash"
    if any(k in low for k in ("norm_fwd_kernel", "norm_bwd_kernel",
                              "norm_bwd_colsum_kernel")):
        return "norm"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "gemv", "nvjet")):
        return "matmul"
    if "foreach" in low or "multi_tensor" in low:
        return "optimizer"
    return "elementwise"


def _phase_ms(state, batch, cfg, opt):
    """One more step run in its pieces under CUDA events: forward (loss),
    backward, the optimizer update, and the same update by the fused
    AdamW (``fused_adamw``, one ``_foreach`` walk) on the same grads."""
    from dlrover_tpu_torch.models import decoder
    from dlrover_tpu_torch.train.optimizer import fused_adamw

    model = state["params"]
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    loss, _ = decoder.loss_fn(model, batch, cfg)
    ev[1].record()
    loss.backward()
    ev[2].record()
    grads = {n: p.grad for n, p in params.items()}
    opt.update_(params, grads, state["opt_state"])
    ev[3].record()
    fused = fused_adamw(opt.learning_rate, b1=opt.b1, b2=opt.b2,
                        eps=opt.eps, weight_decay=opt.weight_decay,
                        grad_clip=opt.grad_clip)
    fused.update_(params, grads, state["opt_state"])
    ev[4].record()
    torch.cuda.synchronize()
    for p in params.values():
        p.grad = None
    names = ("forward_ms", "backward_ms", "optimizer_ms",
             "fused_optimizer_ms")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def train_profile(state, step, batch, cfg, opt, name="train_profile"):
    from torch.profiler import ProfilerActivity, profile

    _reset_train_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    by_class, n_by_class, by_name = {}, {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.device_time / 1e3
        cls = _train_kernel_class(evt.name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        n_by_class[cls] = n_by_class.get(cls, 0) + 1
        by_name[evt.name] = by_name.get(evt.name, 0.0) + ms
    busy = sum(by_class.values())
    if not busy or not n_by_class.get("flash") or not n_by_class.get("norm"):
        raise RuntimeError(f"train profile: the trace holds no device time "
                           f"for the flash or norm kernels ({n_by_class})")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit({"phase": name, "config": cfg.name, "traced_wall_ms": traced_ms,
          "untraced_step_ms": _phase_ms(state, batch, cfg, opt),
          "kernel_ms": busy, "device_busy_share": busy / traced_ms,
          "kernels_per_step": sum(n_by_class.values()),
          "kernels_per_step_by_class": n_by_class,
          "kernel_ms_by_class": by_class,
          "launches": _train_launches(),
          "top_kernels_ms": [[n[:80], t] for n, t in top]})


# ---------------------------------------------------------------------------
# phase 10: the Trainer with Flash Checkpoint
# ---------------------------------------------------------------------------

# run (a): TRAINER_STEPS steps, the checkpoint cadences over the first
# TRAINER_SAVED (memory every 2, disk every 4: two persists of the pack),
# the last two with the cadences off, the reference the resumed runs
# repeat; run (e) takes the same batches TRAINER_BLOCK_K steps a dispatch
TRAINER_STEPS, TRAINER_SAVED = 10, 8
TRAINER_MEMORY_EVERY, TRAINER_DISK_EVERY, TRAINER_BLOCK_K = 2, 4, 4
# a run writes about 38 GiB to disk, under the 45 GiB cap of a host that
# does not take freed blocks back: the elastic phase's two persists of
# the full-size 16.4 GB pack, and here two of a 2.8 GB pack (llama-1.4b
# at TRAINER_LAYERS layers) and the disk yardstick
TRAINER_LAYERS = 2
YARDSTICK_BYTES, DISK_YARDSTICK_GIB = 1 << 30, 2


def _trainer_batches(cfg, seed, n):
    """``n`` fixed host batches (numpy) of TRAIN_BATCH × TRAIN_SEQ: the
    elastic worker's (``synthetic_batch`` keyed by the step), so the
    ``elastic`` phase's losses hold against an in-process run's."""
    from dlrover_tpu_torch.examples.train_gpt_elastic import synthetic_batch

    return [synthetic_batch(seed, step, 0, TRAIN_BATCH, TRAIN_SEQ,
                            cfg.vocab_size) for step in range(1, n + 1)]


def _bits(t):
    """``t`` as integers of its width: bitwise equality, NaNs included."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _leaves_diff(got, ref):
    """The paths of ``got``'s leaves whose bits differ from ``ref``'s."""
    def same(x, y):
        return torch.equal(_bits(x), _bits(y).to(x.device))

    return [a.path for a, b in zip(got, ref)
            if a.path != b.path or not all(
                same(x.tensor, y.tensor) for x, y in zip(a.shards, b.shards))]


def _snapshot(leaves):
    """A copy of a state's leaves, on the card, to hold a restore against."""
    from dlrover_tpu_torch.checkpoint import core

    return [core.Leaf(leaf.path, leaf.dtype, leaf.global_shape,
                      [core.Shard(s.index, s.tensor.clone(), s.transposed)
                       for s in leaf.shards]) for leaf in leaves]


def yardsticks(dev, out_dir):
    """The rates a checkpoint's times are held against, measured here:
    pinned device → host and host → device copies of 1 GiB (CUDA events,
    the mean of 3), and a write of DISK_YARDSTICK_GIB GiB to ``out_dir``'s
    disk as the engine's storage writes (one file, fsync)."""
    d = torch.empty(YARDSTICK_BYTES, dtype=torch.uint8, device=dev)
    h = torch.empty(YARDSTICK_BYTES, dtype=torch.uint8, pin_memory=True)
    rates = {}
    for name, dst, src in (("pinned_d2h", h, d), ("pinned_h2d", d, h)):
        ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True), 3, warmup=1)
        rates[name + "_gbps"] = YARDSTICK_BYTES / (ms / 1e3) / 1e9
    path = os.path.join(out_dir, "yardstick.bin")
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        for _ in range(DISK_YARDSTICK_GIB):
            f.write(memoryview(h.numpy()))
        f.flush()
        os.fsync(f.fileno())
    rates["disk_write_gbps"] = DISK_YARDSTICK_GIB * YARDSTICK_BYTES / (
        time.perf_counter() - t0) / 1e9
    os.unlink(path)
    return rates


class _Watch:
    """Callback: each step's loss, device ms and end (host clock); at
    ``on_train_begin`` the state's leaves against ``ref`` (the paths that
    differ)."""

    def __init__(self, ref=None):
        self.ref, self.diff = ref, None
        self.losses, self.device_ms, self.end_at = {}, {}, {}

    def on_train_begin(self, trainer, control):
        if self.ref is not None:
            self.diff = _leaves_diff(trainer.state_leaves(), self.ref)

    def on_step_end(self, trainer, step, metrics, control):
        self.losses[step] = metrics["loss"]
        self.device_ms[step] = trainer.timer.last_device_ms
        self.end_at[step] = time.perf_counter()

    def __getattr__(self, hook):  # the other hooks: nothing to do
        if hook.startswith("on_"):
            return lambda *a, **k: None
        raise AttributeError(hook)


def _guarded_builder(cfg, opt, dev):
    """A ``TrainStepBuilder`` whose first block runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a host sync inside a
    block (an ``.item()``, a host branch on a device value) raises."""
    from dlrover_tpu_torch.train.train_step import TrainStepBuilder

    class Guarded(TrainStepBuilder):
        guarded = 0

        def block_fn(self, state, batches):
            if self.guarded:
                return super().block_fn(state, batches)
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = super().block_fn(state, batches)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            self.guarded = len(batches)
            return out

    return Guarded(cfg, opt, device=dev)


def trainer_check(cfg, seed, dev, name="trainer"):
    """``Trainer`` with Flash Checkpoint (llama-1.4b at TRAINER_LAYERS
    layers, full width): (a) TRAINER_STEPS
    steps with the cadences over the first TRAINER_SAVED, exact kernel
    launches; (b) a new Trainer resumes from the memory tier to a state
    equal bit for bit to the one saved and repeats (a)'s last losses;
    (d) a byte flipped in the staged pack must show in that leaf alone;
    (c) the segment unlinked, a new Trainer resumes from storage
    (``step_8/``), the same; (e) ``block_k`` TRAINER_BLOCK_K over the same
    batches gives (a)'s losses, its first block with no host sync. Every
    save, persist and restore time beside its bound, from the yardsticks
    measured in the phase."""
    import shutil
    import tempfile

    from dlrover_tpu_torch.checkpoint import core
    from dlrover_tpu_torch.checkpoint.engine import (
        CheckpointEngine,
        shm_name,
    )
    from dlrover_tpu_torch.common.multi_process import attach_shared_memory
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.train.optimizer import make_optimizer
    from dlrover_tpu_torch.train.trainer import Trainer, TrainerArgs

    os.environ["DLROVER_TPU_RUN_ID"] = f"chip_smoke_{os.getpid()}"
    out = tempfile.mkdtemp(prefix="dlrover_trainer_")
    ckpt_dir = os.path.join(out, "checkpoints")
    batches = _trainer_batches(cfg, seed, TRAINER_STEPS)

    from dlrover_tpu_torch.examples import train_gpt_elastic as ex

    def opt():  # the elastic worker's
        return make_optimizer(learning_rate=ex.LR, warmup_steps=ex.WARMUP,
                              decay_steps=ex.DECAY)

    def args(**kw):
        base = dict(output_dir=out, max_steps=TRAINER_STEPS, save_interval=0,
                    log_interval=0, seed=seed, prefetch=2)
        return TrainerArgs(**dict(base, **kw))

    pack = fa.head_pack_for(cfg.n_head, cfg.kv_heads, cfg.head_dim,
                            cfg.attn_head_pack)
    flash = fa.PACKED if pack == 2 else fa.UNPACKED
    per_step = {k: cfg.n_layer * (k in flash) for k in fa.KERNELS}
    per_step.update(norm_fwd=2 * cfg.n_layer + 1,
                    norm_bwd=2 * cfg.n_layer + 1)
    rec = {"phase": name, "config": cfg.name, "n_layer": cfg.n_layer,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAINER_STEPS,
           "shm_free_bytes": _shm_free(), "mem_available_bytes":
           _mem_available()}
    try:
        rec["yardsticks"] = rates = yardsticks(dev, out)
        # (a) the cadences over the first TRAINER_SAVED steps, then the
        # last steps with them off
        watch_a = _Watch()
        t_a = time.perf_counter()
        a = Trainer(cfg, args(max_steps=TRAINER_SAVED,
                              save_interval=TRAINER_DISK_EVERY,
                              memory_save_interval=TRAINER_MEMORY_EVERY),
                    batches, opt(), callbacks=[watch_a], device=dev)
        _reset_train_launches()
        t0 = time.perf_counter()
        a.train()
        rec["a_cadence_s"] = time.perf_counter() - t0
        ref = _snapshot(a.state_leaves())
        a.args.max_steps = TRAINER_STEPS
        a.args.save_interval = a.args.memory_save_interval = 0
        a.train()
        rec["launches"] = _train_launches()
        rec["launches_expected"] = {k: v * TRAINER_STEPS
                                    for k, v in per_step.items()}
        losses = [watch_a.losses[s] for s in range(1, TRAINER_STEPS + 1)]
        rec["losses_a"] = losses
        rec["step_device_ms_a"] = [watch_a.device_ms[s]
                                   for s in range(1, TRAINER_STEPS + 1)]
        # the host clock from (a)'s start: each step's end, each save's and
        # persist's start, to read a persist's overlap with the steps
        rec["step_end_s_a"] = [watch_a.end_at[s] - t_a
                               for s in range(1, TRAINER_STEPS + 1)]
        timings = [dict(t, at=t["at"] - t_a) if "at" in t else t
                   for t in a.checkpointer.engine.timings]
        nbytes = max(t.get("nbytes", 0) for t in timings)
        rec["pack_bytes"] = nbytes
        rec["saves"] = [dict(t, bound_s=t["nbytes"] / (
            rates["pinned_d2h_gbps"] * 1e9)) if "nbytes" in t else t
            for t in timings if t["kind"] in ("save_memory", "save_storage",
                                              "skipped")]
        rec["persists"] = [dict(t, bound_s=t["nbytes"] / (
            rates["disk_write_gbps"] * 1e9))
            for t in timings if t["kind"] == "persist"]
        a.checkpointer.close()
        del a
        torch.cuda.empty_cache()

        def restore_rec(trainer):
            t = [x for x in trainer.checkpointer.engine.timings
                 if x["kind"] == "restore"][-1]
            return dict({k: v for k, v in t.items() if k != "at"},
                        nbytes=nbytes, bound_s=nbytes / (
                            rates["pinned_h2d_gbps"] * 1e9))

        # (b) the memory tier
        watch_b = _Watch(ref)
        b = Trainer(cfg, args(), batches[TRAINER_SAVED:], opt(),
                    callbacks=[watch_b], device=dev)
        b.train()
        rec["restore_memory"] = restore_rec(b)
        rec["b_state_diff"] = watch_b.diff
        rec["losses_b"] = [watch_b.losses.get(s) for s in
                           range(TRAINER_SAVED + 1, TRAINER_STEPS + 1)]
        # (d) a planted fault: one byte flipped in a staged leaf
        shm = attach_shared_memory(shm_name())
        raw = torch.frombuffer(shm.buf, dtype=torch.uint8)
        doc = core.read_header(raw)
        leaf = next(x for x in doc["leaves"]
                    if x["path"] == "params/layers/attn/wq")
        at = _payload_start(raw) + leaf["shards"][0]["offset"] + 1
        raw[at] ^= 0x40
        del raw
        shm.close()
        leaves_b = b.state_leaves()
        b.checkpointer.load_checkpoint(leaves_b)
        rec["fault_diff"] = _leaves_diff(leaves_b, ref)
        b.checkpointer.close()
        del b, leaves_b
        torch.cuda.empty_cache()
        # (c) the storage tier
        rec["segment_unlinked"] = CheckpointEngine.unlink_segment()
        watch_c = _Watch(ref)
        c = Trainer(cfg, args(), batches[TRAINER_SAVED:], opt(),
                    callbacks=[watch_c], device=dev)
        c.train()
        rec["restore_storage"] = restore_rec(c)
        c.checkpointer.close()
        rec["c_state_diff"] = watch_c.diff
        rec["losses_c"] = [watch_c.losses.get(s) for s in
                           range(TRAINER_SAVED + 1, TRAINER_STEPS + 1)]
        del c, ref
        torch.cuda.empty_cache()
        # (e) the fused loop over the same batches
        watch_e = _Watch()
        opt_e = opt()
        builder = _guarded_builder(cfg, opt_e, dev)
        e = Trainer(cfg, args(block_k=TRAINER_BLOCK_K, resume=False,
                              output_dir=os.path.join(out, "block")),
                    batches, opt_e, callbacks=[watch_e],
                    step_builder=builder, device=dev)
        _reset_train_launches()
        t0 = time.perf_counter()
        e.train()
        rec["e_seconds"] = time.perf_counter() - t0
        rec["e_launches"] = _train_launches()
        rec["e_guarded_block_steps"] = builder.guarded
        rec["losses_e"] = [watch_e.losses.get(s)
                           for s in range(1, TRAINER_STEPS + 1)]
        rec["step_device_ms_e"] = [watch_e.device_ms.get(s)
                                   for s in range(1, TRAINER_STEPS + 1)]
        del e
    finally:
        CheckpointEngine.unlink_segment()
        shutil.rmtree(out, ignore_errors=True)
        torch.cuda.empty_cache()
    tail = losses[TRAINER_SAVED:]
    steady = sorted(rec["step_device_ms_a"][1:])
    rec["steady_step_device_ms"] = steady[len(steady) // 2]
    rec["checks"] = checks = {
        "finite": all(math.isfinite(x) for x in losses),
        "launches_exact": rec["launches"] == rec["launches_expected"]
        and rec["e_launches"] == rec["launches_expected"],
        "two_persists": len(rec["persists"]) == 2,
        "memory_tier": rec["restore_memory"]["tier"] == "memory"
        and rec["restore_memory"]["step"] == TRAINER_SAVED,
        "memory_state_equal": rec["b_state_diff"] == [],
        "memory_losses_equal": rec["losses_b"] == tail,
        "fault_caught": rec["fault_diff"] == ["params/layers/attn/wq"],
        "storage_tier": rec["restore_storage"]["tier"] == "storage"
        and rec["restore_storage"]["step"] == TRAINER_SAVED,
        "storage_state_equal": rec["c_state_diff"] == [],
        "storage_losses_equal": rec["losses_c"] == tail,
        "block_losses_equal": rec["losses_e"] == losses,
        "block_no_host_sync": rec["e_guarded_block_steps"]
        == TRAINER_BLOCK_K,
    }
    rec["ok"] = all(checks.values())
    emit(rec)
    if not rec["ok"]:
        _failures.append(f"{name}: {[k for k, v in checks.items() if not v]}")
    return rec


# the elastic phase: the worker's 8 steps, memory saves every 2, disk
# saves every 4 (two persists: steps 4 and 8; a third would take the
# run past the disk's 45 GiB), a crash right after step 5 of the first
# run; the launcher's time limit
ELASTIC_STEPS, ELASTIC_CKPT_EVERY, ELASTIC_CRASH_AT = 8, 2, 5
ELASTIC_TIMEOUT_S = 540
_STEP_LINE = re.compile(r"\[worker\] step=(\d+) loss=(\S+) rank=\d+ "
                        r"device_ms=(\S+) at=(\S+) launches=(\{.*\})")
_SHARD_LINE = re.compile(r"\[worker\] shard step=(\d+) \[(\d+), (\d+)\)")


def _trace_events(trace_dir):
    """Every event of the run's trace files: {role: [[events of one
    process, in order], ...]}, processes in the order they started."""
    out = {}
    for name in sorted(os.listdir(trace_dir)):
        role = name.split("-")[1]
        with open(os.path.join(trace_dir, name)) as f:
            evs = [json.loads(line) for line in f if line.strip()]
        if evs:
            out.setdefault(role, []).append(evs)
    for procs in out.values():
        procs.sort(key=lambda evs: evs[0]["ts"])
    return out


def _ev(evs, name, nth=0):
    hits = [e for e in evs if e["name"] == name]
    return hits[nth] if len(hits) > nth else None


def _s(ev, end=False):
    """An event's time on the shared clock (s); a span's end with
    ``end``."""
    return (ev["ts"] + (ev.get("dur", 0.0) if end else 0.0)) / 1e6


def _elastic_reference(cfg, seed, dev):
    """The elastic worker's run uninterrupted, in this process and with
    no checkpoint (the same seed, batches and optimizer): its losses, its
    steady step (device ms) and its state's payload bytes (a pack less
    its header)."""
    import shutil
    import tempfile

    from dlrover_tpu_torch.checkpoint import core
    from dlrover_tpu_torch.examples import train_gpt_elastic as ex
    from dlrover_tpu_torch.train.optimizer import make_optimizer
    from dlrover_tpu_torch.train.trainer import Trainer, TrainerArgs

    out = tempfile.mkdtemp(prefix="dlrover_elastic_ref_")
    watch = _Watch()
    try:
        t = Trainer(cfg, TrainerArgs(output_dir=out, max_steps=ELASTIC_STEPS,
                                     save_interval=0, log_interval=0,
                                     seed=seed, prefetch=2),
                    _trainer_batches(cfg, seed, ELASTIC_STEPS),
                    make_optimizer(learning_rate=ex.LR,
                                   warmup_steps=ex.WARMUP,
                                   decay_steps=ex.DECAY),
                    callbacks=[watch], device=dev)
        t.train()
        payload = core.plan_pack(t.state_leaves())[1]
        t.checkpointer.close()
        del t
    finally:
        shutil.rmtree(out, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    steps = range(1, ELASTIC_STEPS + 1)
    steady = sorted(watch.device_ms[s] for s in steps[1:]
                    if watch.device_ms[s] is not None)
    return {"losses": [watch.losses[s] for s in steps],
            "steady_step_device_ms": (steady[len(steady) // 2]
                                      if steady else None),
            "payload_bytes": payload}


def elastic_check(cfg, seed, ref, name="elastic", device="cuda",
                  overrides=()):
    """The elastic control plane on the card: the port's launcher (a
    local job master, the agent and its checkpoint saver) runs the
    elastic worker (``examples/train_gpt_elastic.py``: llama-1.4b at full
    width and depth through ``Trainer``) in a subprocess; the worker
    crashes right after step ELASTIC_CRASH_AT, the agent persists the
    staged step from its own process, re-rendezvouses and respawns, and
    the new worker resumes from the agent-served memory tier. Its losses
    (and the first run's) must equal bit for bit those of the same run
    uninterrupted, in this process first (``_elastic_reference``).
    Readings from the run's trace files (agent and workers); the persists
    against the disk yardstick of ``ref`` (the ``trainer`` phase's
    record). ``device`` and ``overrides`` (``--override`` items of the
    worker's config) serve a rehearsal on the CPU at a cut size."""
    import shutil
    import tempfile

    from dlrover_tpu_torch.common.multi_process import (
        attach_shared_memory,
        unlink_shared_memory,
    )
    from dlrover_tpu_torch.checkpoint.storage import PosixStorage, read_tracker
    from dlrover_tpu_torch.examples.train_gpt_elastic import launches
    from dlrover_tpu_torch.ops import flash_attention as fa

    out = tempfile.mkdtemp(prefix="dlrover_elastic_")
    run_id = f"chip_smoke_elastic_{os.getpid()}"
    trace_dir = os.path.join(out, "trace")
    sock_dir = os.path.join(out, "sock")
    ckpt_dir = os.path.join(out, "run")
    env = dict(os.environ, DLROVER_TPU_RUN_ID=run_id,
               DLROVER_TPU_COORDINATOR_PORT="0",
               DLROVER_TPU_TRACE_DIR=trace_dir,
               DLROVER_TPU_SOCK_DIR=sock_dir)
    env.pop("DLROVER_TPU_MASTER_ADDR", None)
    cmd = ["timeout", "-k", "10", str(ELASTIC_TIMEOUT_S), sys.executable,
           "-m", "dlrover_tpu_torch.agent.launcher", "--nnodes", "1",
           "--nproc", "1", "--max-restarts", "1", "--monitor-interval",
           "0.2", "--", sys.executable, "-m",
           "dlrover_tpu_torch.examples.train_gpt_elastic", "--model",
           cfg.name, "--steps", str(ELASTIC_STEPS), "--batch",
           str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--seed", str(seed),
           "--ckpt-dir", ckpt_dir, "--ckpt-every", str(ELASTIC_CKPT_EVERY),
           "--crash-at", str(ELASTIC_CRASH_AT), "--check-committed",
           "--device", device]
    for item in overrides:
        cmd += ["--override", item]
    per_step = {k: 0 for k in launches()}
    per_step.update({k: cfg.n_layer for k in fa.UNPACKED},
                    norm_fwd=2 * cfg.n_layer + 1, norm_bwd=2 * cfg.n_layer + 1)
    rec = {"phase": name, "config": cfg.name, "n_layer": cfg.n_layer,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": ELASTIC_STEPS,
           "crash_at": ELASTIC_CRASH_AT, "command": cmd[4:],
           "card": nvidia_smi_line()}
    runs = []
    try:
        t0 = time.perf_counter()
        rec["reference"] = reference = _elastic_reference(
            cfg, seed, torch.device(device))
        rec["reference_s"] = time.perf_counter() - t0
        rec["parent_reserved_bytes"] = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        rec["seconds"] = time.perf_counter() - t0
        rec["launcher_rc"] = proc.returncode
        log = proc.stdout
        # the launcher's whole log, too long for the record (gitignored)
        log_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "build", "chip_smoke")
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "elastic_log.txt"), "w") as f:
            f.write(log)
        lines = log.splitlines()

        def first(pattern, start=0):
            for i in range(start, len(lines)):
                if re.search(pattern, lines[i]):
                    return i
            return -1

        i_exit = first(r"worker exited rc=17")
        i_round2 = first(r"rendezvous round 2:", max(i_exit, 0))
        i_ok = first(r"worker succeeded", max(i_round2, 0))
        rec["log_order"] = [i_exit, i_round2, i_ok]
        runs, cur = [], None
        for line in lines:
            if "[worker] process group" in line:
                cur = {"group": line.split("[worker] ")[1], "steps": {},
                       "kernels": None}
                runs.append(cur)
            elif cur is None:
                continue
            elif "[worker] kernels " in line:
                cur["kernels"] = json.loads(line.split("kernels ", 1)[1])
            elif "[worker] resumed from step" in line:
                cur["resumed"] = line.split("[worker] ", 1)[1]
            elif "[worker] committed pack check" in line:
                cur["pack_check"] = json.loads(line.split("check ", 1)[1])
            m = _STEP_LINE.search(line)
            if m:
                cur["steps"][int(m.group(1))] = {
                    "loss": float(m.group(2)),
                    "device_ms": (None if m.group(3) == "None"
                                  else float(m.group(3))),
                    "at": float(m.group(4)),
                    "launches": json.loads(m.group(5))}
        rec["runs"] = [{k: v for k, v in r.items() if k != "steps"}
                       for r in runs]
        a = runs[0]["steps"] if runs else {}
        b = runs[1]["steps"] if len(runs) > 1 else {}
        rec["losses_first"] = [a[s]["loss"] for s in sorted(a)]
        rec["losses_resumed"] = [b[s]["loss"] for s in sorted(b)]
        rec["resumed_steps"] = sorted(b)
        rec["launches_per_step_ok"] = all(
            st["launches"] == per_step for r in runs
            for st in r["steps"].values())
        rec["launches"] = {k: sum(st["launches"].get(k, 0) for r in runs
                                  for st in r["steps"].values())
                           for k in per_step}
        steady = sorted(st["device_ms"] for r in runs
                        for s, st in r["steps"].items()
                        if st["device_ms"] is not None and s != min(
                            r["steps"]))
        rec["steady_step_device_ms"] = (steady[len(steady) // 2]
                                        if steady else None)
        rec["reference_steady_step_device_ms"] = reference[
            "steady_step_device_ms"]
        pack = runs[1].get("pack_check", {}) if len(runs) > 1 else {}
        rec["pack_check"] = pack
        ck = os.path.join(ckpt_dir, "checkpoints")
        rec["shard_steps"] = [(int(n), int(a), int(b))
                              for n, a, b in _SHARD_LINE.findall(log)]
        rec["dataset_restored"] = "[worker] dataset position restored" in log
        rec["committed_step_4"] = os.path.exists(os.path.join(
            ck, f"step_{ELASTIC_CRASH_AT - 1}", "done", "host_0.done"))
        rec["last_committed_step"] = read_tracker(ck, PosixStorage())
        i_commit4 = first(r"committed checkpoint step "
                          f"{ELASTIC_CRASH_AT - 1} ")
        rec["commit_before_respawn"] = 0 <= i_commit4 < i_round2
        rec["emergency_wrote"] = 0 <= first(
            r"emergency checkpoint persist done") < i_round2
        try:
            rec.update(_elastic_readings(trace_dir, runs, ref))
        except Exception as exc:  # noqa: BLE001 — a missing mark: fail
            rec["readings_error"] = repr(exc)
    finally:
        leftovers = [f for f in os.listdir("/dev/shm") if run_id in f]
        for f in leftovers:
            unlink_shared_memory(attach_shared_memory(f))
        socks = os.listdir(sock_dir) if os.path.isdir(sock_dir) else []
        rec["left_behind"] = leftovers + socks
        shutil.rmtree(out, ignore_errors=True)
    tail = rec.get("reference", {}).get("losses", [])
    rec["checks"] = checks = {
        "launcher_rc_0": rec.get("launcher_rc") == 0,
        "exit_then_round2_then_success": -1 not in rec.get("log_order", [-1])
        and rec["log_order"] == sorted(rec["log_order"]),
        "two_runs": len(runs) == 2,
        "nccl_world_1_rank_0_cuda": all(
            r["group"].startswith("process group nccl world 1 rank 0 "
                                  "device cuda") for r in runs)
        and bool(runs),
        "no_rebuild": all(r["kernels"] and r["kernels"]["compiled_s"] == 0
                          for r in runs),
        "resumed_from_memory": len(runs) == 2 and runs[1].get(
            "resumed", "").startswith(
            f"resumed from step {ELASTIC_CRASH_AT - 1} (tier memory"),
        "first_run_losses_equal": rec.get("losses_first")
        == tail[:ELASTIC_CRASH_AT],
        "resumed_losses_equal": rec.get("resumed_steps") == list(
            range(ELASTIC_CRASH_AT, ELASTIC_STEPS + 1))
        and rec["losses_resumed"] == tail[ELASTIC_CRASH_AT - 1:],
        "committed_step_4_before_respawn": rec.get("committed_step_4")
        and rec.get("commit_before_respawn"),
        # and the pack holds the whole state: the reference's payload
        "committed_pack_equals_staged": rec.get("pack_check", {}).get(
            "equal") is True
        and rec["pack_check"].get("payload_bytes")
        == rec["reference"]["payload_bytes"],
        "final_save_committed": rec.get("last_committed_step")
        == ELASTIC_STEPS,
        # every step's batch from the master's shard of it; the resumed
        # run's dataset position put back to the restored step's
        "shards_from_the_service": bool(rec.get("shard_steps"))
        and all(a == (n - 1) * TRAIN_BATCH and b == n * TRAIN_BATCH
                for n, a, b in rec["shard_steps"])
        and sorted({n for n, _, _ in rec["shard_steps"]})
        == list(range(1, ELASTIC_STEPS + 1))
        and rec.get("dataset_restored") is True,
        "launches_exact": rec.get("launches_per_step_ok") is True,
        "readings": "readings_error" not in rec,
        "nothing_left_behind": rec["left_behind"] == [],
    }
    rec["ok"] = all(checks.values())
    emit(rec)
    if not rec["ok"]:
        _failures.append(f"{name}: {[k for k, v in checks.items() if not v]}")
    return rec


def _elastic_readings(trace_dir, runs, ref):
    """The recovery's phases from the trace files, on the shared clock:
    the crash to the agent seeing it, the agent's persist (against the
    disk yardstick of the ``trainer`` phase), rendezvous, respawn, the
    worker's start, kernel load and memory-tier restore, the crash to the
    first step back; and whether a step stalled during a persist."""
    ev = _trace_events(trace_dir)
    agent = ev["agent"][0]
    w1, w2 = ev["worker"][0], ev["worker"][1]
    crash = _ev(w1, "worker.crash")
    seen = _ev(agent, "failover.worker_exit")
    emergency = _ev(agent, "failover.ckpt_persist")
    rdzv2 = _ev(agent, "failover.rendezvous", 1)
    spawn2 = _ev(agent, "failover.spawn", 1)
    restore = _ev(w2, "failover.restore")
    back = _ev(w2, "failover.first_step")
    persists = [{"step": e["args"].get("step"), "start_s": _s(e),
                 "seconds": e["dur"] / 1e6, "nbytes": e["args"]["nbytes"]}
                for e in agent if e["name"] == "ckpt.persist"]
    rate = ref["yardsticks"]["disk_write_gbps"] * 1e9
    for p in persists:
        p["bound_s"] = p["nbytes"] / rate
    r = {
        "crash_to_seen_s": _s(seen) - _s(crash),
        "emergency_persist_s": emergency["dur"] / 1e6,
        "persists": persists,
        "rendezvous_s": rdzv2["dur"] / 1e6,
        "seen_to_spawn_s": _s(spawn2) - _s(seen),
        "spawn_to_worker_start_s": _s(_ev(w2, "worker.start")) - _s(spawn2),
        "worker_group_s": _s(_ev(w2, "worker.group"))
        - _s(_ev(w2, "worker.start")),
        "kernel_load_s": [r["kernels"] and r["kernels"]["seconds"]
                          for r in runs],
        "restore_s": restore["dur"] / 1e6,
        "restore_tier": restore["args"].get("tier"),
        "crash_to_first_step_back_s": _s(back) - _s(crash),
    }
    # each step's host interval from the previous step's end; those
    # after a boundary with no save (and not after a run's first step,
    # which the resumed run's pack check follows) set the baseline, and
    # one of them over it by more than 0.5 s while a persist runs is a
    # stall
    gaps = []
    for run in runs:
        steps = sorted(run["steps"])
        for prev, s in zip(steps, steps[1:]):
            t1, t2 = run["steps"][prev]["at"], run["steps"][s]["at"]
            gaps.append({
                "step": s, "host_s": t2 - t1,
                "after_save": prev % ELASTIC_CKPT_EVERY == 0
                or prev == steps[0],
                "during_persist": any(
                    p["start_s"] < t2 and t1 < p["start_s"] + p["seconds"]
                    for p in persists)})
    plain = sorted(g["host_s"] for g in gaps if not g["after_save"])
    base = plain[len(plain) // 2] if plain else 0.0
    r["step_host_gaps"] = gaps
    r["baseline_step_host_s"] = base
    r["stalled_during_persist"] = [
        dict(g, stall_s=g["host_s"] - base) for g in gaps
        if g["during_persist"] and not g["after_save"]
        and g["host_s"] > base + 0.5]
    return r


def _payload_start(raw):
    from dlrover_tpu_torch.checkpoint import core

    n = int.from_bytes(raw[:core.HEADER_LEN_BYTES].numpy().tobytes(),
                       "little")
    return (core.HEADER_LEN_BYTES + n + core.ALIGN - 1) \
        // core.ALIGN * core.ALIGN


def _shm_free():
    st = os.statvfs("/dev/shm")
    return st.f_bavail * st.f_frsize


def _mem_available():
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return None

# ---------------------------------------------------------------------------
# phase 11b: the live reshard, four ranks on the one card
# ---------------------------------------------------------------------------

# 6 steps, 2 after the eviction (8 before the mesh4d phase joined the
# script)
RESHARD_LAYERS, RESHARD_STEPS, RESHARD_EVICT_AT = 2, 6, 4
RESHARD_RANKS, RESHARD_LOST = 4, (2, 3)
RESHARD_BUCKET_MB = 64.0
RESHARD_TIMEOUT_S = 480
RESHARD_DISK_CAP = 3 << 30
# the ZeRO stream against the replicated one, relative. The CPU tests
# hold f32 streams of 3 steps at 1e-5 (losses) and 1e-4 (norms); here
# the steps run the bf16 kernels for 6 steps, where another summation
# order of the same gradients alone moves both by some 1e-5 (the
# ``order_spread`` reading: the replicated run against itself with its
# micro-batches reversed). A dropped bucket moves the norm by percents,
# a wrong divide by grad_accum by a factor.
RESHARD_RTOL_LOSS, RESHARD_RTOL_NORM = 1e-4, 1e-4
# the planted fault: a run of this many steps at dp 4 whose every
# gradient exchange returns its middle bucket zeroed (llama-1.4b at 2
# layers has 14 of 64 MB: bucket 7, MLP weights of both layers)
RESHARD_FAULT_STEPS = 2
_RANK_STEP = re.compile(r"\[worker\] step=(\d+) loss=(\S+) rank=(\d+) "
                        r"grad_norm=(\S+) device_ms=(\S+) at=(\S+) "
                        r"launches=(\{.*\})")


def _write_bytes():
    """Bytes this process and its reaped children caused to be written to
    storage (``/proc/self/io``)."""
    with open("/proc/self/io") as f:
        return int(next(line.split()[1] for line in f
                        if line.startswith("write_bytes:")))


def zero_fault_worker(argv):
    """The elastic example's worker (``argv`` its arguments) with the
    middle bucket of every gradient exchange's result zeroed: the reshard
    phase's planted fault, which its step gate must catch."""
    from dlrover_tpu_torch.examples import train_gpt_elastic as ex
    from dlrover_tpu_torch.parallel import sharding as shd

    exchange = shd.exchange_buckets

    def dropped(g, plan, group=None, **kw):
        out = exchange(g, plan, group, **kw)
        out[plan.n_buckets // 2] = 0
        return out

    shd.exchange_buckets = dropped
    return ex.main(argv)


def _reshard_launch(cfg, seed, device, overrides, steps, flags, worker,
                    log_name, trace=False):
    """One run of the port's launcher: the elastic worker (``worker``: the
    command that starts one) on ``RESHARD_RANKS`` ranks of one node, all
    on card 0 over gloo, ``--zero1`` with ``RESHARD_BUCKET_MB`` buckets,
    ``steps`` steps at b``TRAIN_BATCH`` × s``TRAIN_SEQ``, no checkpoint,
    ``flags`` added. Returns (its record, its log). ``trace``: the run
    traced, and the record's ``exchange_spans`` each worker process's
    ``zero.exchange`` span seconds, in order."""
    import shutil
    import tempfile

    from dlrover_tpu_torch.common.multi_process import (
        attach_shared_memory,
        unlink_shared_memory,
    )

    out = tempfile.mkdtemp(prefix="dlrover_reshard_")
    run_id = f"chip_smoke_{log_name}_{os.getpid()}"
    sock_dir = os.path.join(out, "sock")
    env = dict(os.environ, DLROVER_TPU_RUN_ID=run_id,
               DLROVER_TPU_COORDINATOR_PORT="0",
               DLROVER_TPU_SOCK_DIR=sock_dir)
    env.pop("DLROVER_TPU_MASTER_ADDR", None)
    env.pop("DLROVER_TPU_TRACE_DIR", None)
    trace_dir = os.path.join(out, "trace")
    if trace:
        os.makedirs(trace_dir)
        env["DLROVER_TPU_TRACE_DIR"] = trace_dir
    cmd = ["timeout", "-k", "10", str(RESHARD_TIMEOUT_S), sys.executable,
           "-m", "dlrover_tpu_torch.agent.launcher", "--nnodes", "1",
           "--nproc", str(RESHARD_RANKS), "--max-restarts", "0",
           "--monitor-interval", "0.2", "--", *worker, "--model",
           cfg.name, "--override", f"n_layer={cfg.n_layer}",
           "--steps", str(steps), "--batch", str(TRAIN_BATCH),
           "--seq", str(TRAIN_SEQ), "--seed", str(seed), "--ckpt-dir",
           os.path.join(out, "run"), "--ckpt-every", "0", "--zero1",
           "--bucket-mb", str(RESHARD_BUCKET_MB), *flags, "--one-card",
           "--device", device]
    for item in overrides:
        cmd += ["--override", item]
    rec = {"command": cmd[4:]}
    log = ""
    try:
        w0 = _write_bytes()
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        rec["seconds"] = time.perf_counter() - t0
        rec["disk_write_bytes"] = _write_bytes() - w0
        rec["launcher_rc"] = proc.returncode
        log = proc.stdout
        log_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "build", "chip_smoke")
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, f"{log_name}_log.txt"), "w") as f:
            f.write(log)
        if trace:
            rec["exchange_spans"] = [
                [e["dur"] / 1e6 for e in evs if e["name"] == "zero.exchange"]
                for evs in _trace_events(trace_dir).get("worker", [])]
    finally:
        leftovers = [f for f in os.listdir("/dev/shm") if run_id in f]
        for f in leftovers:
            unlink_shared_memory(attach_shared_memory(f))
        socks = os.listdir(sock_dir) if os.path.isdir(sock_dir) else []
        rec["left_behind"] = leftovers + socks
        shutil.rmtree(out, ignore_errors=True)
    return rec, log


def _rank_steps(log):
    """step -> rank -> its loss, grad norm, wall time and launches."""
    steps = {}
    for m in _RANK_STEP.finditer(log):
        steps.setdefault(int(m.group(1)), {})[int(m.group(3))] = {
            "loss": float(m.group(2)), "grad_norm": float(m.group(4)),
            "at": float(m.group(6)), "launches": json.loads(m.group(7))}
    return steps


def reshard_reference(cfg, seed, dev, steps, overrides=(), reverse=False):
    """The replicated stream the ZeRO run is held to: one process, each
    step's global batch (the dp ranks' rows in dp order: the
    ``RESHARD_RANKS`` ranks' through step ``RESHARD_EVICT_AT``, the
    survivors' after) in micro-batches of a rank's ``TRAIN_BATCH /
    RESHARD_RANKS`` rows, the worker's optimizer and config (its
    ``overrides``); ``reverse``: the micro-batches in the reverse order.
    [(loss, grad_norm)] a step."""
    from dlrover_tpu_torch.examples import train_gpt_elastic as ex
    from dlrover_tpu_torch.models.config import get_config
    from dlrover_tpu_torch.train.optimizer import make_optimizer
    from dlrover_tpu_torch.train.train_step import (
        TrainStepBuilder,
        init_train_state,
    )

    fields = dict(n_layer=cfg.n_layer)
    for item in overrides:
        key, _, value = item.partition("=")
        fields[key] = json.loads(value)
    cfg = get_config(cfg.name, max_seq=TRAIN_SEQ, **fields)
    opt = make_optimizer(learning_rate=ex.LR, warmup_steps=ex.WARMUP,
                         decay_steps=ex.DECAY)
    state = init_train_state(seed, cfg, opt, device=dev)
    micro = TRAIN_BATCH // RESHARD_RANKS
    accum = TRAIN_BATCH // micro
    step = TrainStepBuilder(cfg, opt, grad_accum=accum, device=dev).build()
    out = []
    for s in range(1, steps + 1):
        dp = (RESHARD_RANKS if s <= RESHARD_EVICT_AT
              else RESHARD_RANKS - len(RESHARD_LOST))
        parts = [ex.synthetic_batch(seed, s, i, TRAIN_BATCH // dp,
                                    TRAIN_SEQ, cfg.vocab_size)
                 for i in range(dp)]
        batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        if reverse:
            batch = {k: v.reshape((accum, micro) + v.shape[1:])[::-1]
                     .reshape(v.shape) for k, v in batch.items()}
        state, m = step(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _stream_errors(steps, ref):
    """The largest relative error of every rank's loss and grad norm
    against ``ref``'s over the steps they ran, and whether both are
    within ``RESHARD_RTOL_LOSS`` and ``RESHARD_RTOL_NORM``."""
    loss = norm = 0.0
    for s, ranks in steps.items():
        if not 1 <= s <= len(ref):
            return {"loss": None, "grad_norm": None, "within": False}
        want_loss, want_norm = ref[s - 1]
        for r in ranks.values():
            loss = max(loss, abs(r["loss"] - want_loss) / abs(want_loss))
            norm = max(norm, abs(r["grad_norm"] - want_norm) / abs(want_norm))
    return {"loss": loss, "grad_norm": norm,
            "within": loss <= RESHARD_RTOL_LOSS and norm <= RESHARD_RTOL_NORM}


def reshard_check(cfg, seed, name="reshard", device="cuda", overrides=()):
    """The live reshard on the card: the port's launcher runs the elastic
    worker on ``RESHARD_RANKS`` ranks of one node, all on card 0 over
    gloo (``--one-card``), with ZeRO update sharding (``--zero1``: the
    zero2 mode) and the data from the master's shard service; after step
    ``RESHARD_EVICT_AT`` ranks ``RESHARD_LOST`` are evicted: the master
    issues the reshard directive, the ranks migrate the flat optimizer
    state, the departing ones exit 0 and the survivors train on at dp 2,
    ``grad_accum`` 2. No checkpoint is saved (``--ckpt-every 0``): the
    phase persists nothing. Every rank's loss and grad norm of every step
    are held to ``reshard_reference``'s replicated stream, and so are a
    second run's with one bucket of each exchange zeroed
    (``zero_fault_worker``), which must fall outside."""
    from dlrover_tpu_torch.examples.train_gpt_elastic import launches
    from dlrover_tpu_torch.ops import flash_attention as fa

    survivors = [r for r in range(RESHARD_RANKS) if r not in RESHARD_LOST]
    dp_new = len(survivors)
    accum_new = -(-TRAIN_BATCH // (TRAIN_BATCH // RESHARD_RANKS * dp_new))

    def per_step(accum):
        want = {k: 0 for k in launches()}
        want.update({k: cfg.n_layer * accum for k in fa.UNPACKED},
                    norm_fwd=(2 * cfg.n_layer + 1) * accum,
                    norm_bwd=(2 * cfg.n_layer + 1) * accum)
        return want

    rec = {"phase": name, "config": cfg.name, "n_layer": cfg.n_layer,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": RESHARD_STEPS,
           "ranks": RESHARD_RANKS, "evict_at": RESHARD_EVICT_AT,
           "lost": list(RESHARD_LOST), "bucket_mb": RESHARD_BUCKET_MB,
           "grad_accum_after": accum_new, "card": nvidia_smi_line()}
    module = [sys.executable, "-m",
              "dlrover_tpu_torch.examples.train_gpt_elastic"]
    run, log = _reshard_launch(
        cfg, seed, device, overrides, RESHARD_STEPS,
        ["--evict-at", str(RESHARD_EVICT_AT), "--evict-dp-ranks",
         ",".join(map(str, RESHARD_LOST)), "--check-migration"],
        module, name)
    rec.update(run)
    fault, fault_log = _reshard_launch(
        cfg, seed, device, overrides, RESHARD_FAULT_STEPS, [],
        [sys.executable, os.path.abspath(__file__), "--zero-fault-worker"],
        f"{name}_fault")
    t0 = time.perf_counter()
    ref = reshard_reference(cfg, seed, torch.device(device), RESHARD_STEPS,
                            overrides)
    rec["reference_s"] = time.perf_counter() - t0
    reverse = reshard_reference(cfg, seed, torch.device(device),
                                RESHARD_STEPS, overrides, reverse=True)
    lines = log.splitlines()

    def tagged(tag):
        return [line.split(tag, 1)[1] for line in lines if tag in line]

    steps = _rank_steps(log)
    fault_steps = _rank_steps(fault_log)
    done = [json.loads(x) for x in tagged("[reshard] done ")]
    checks_m = [json.loads(x) for x in tagged("[reshard] migration check ")]
    events = [json.loads(x)["d"] for x in tagged("[event] ")]
    shards = sorted((int(a), int(b)) for _, a, b in _SHARD_LINE.findall(log))
    peaks = {}
    for line in lines:
        m = re.search(r"\[worker\] (?:done at step \d+|evicted) rank (\d+) "
                      r"peak_bytes=(\S+)", line)
        if m:
            peaks[int(m.group(1))] = (None if m.group(2) == "None"
                                      else int(m.group(2)))
    completed = re.search(r"dataset train: (\d+) shards completed", log)
    losses = [steps[s][0]["loss"] for s in sorted(steps) if 0 in steps[s]]
    rank0 = {s: v[0]["at"] for s, v in steps.items() if 0 in v}

    def step_s(lo, hi):
        gaps = sorted(rank0[s] - rank0[s - 1] for s in range(lo, hi + 1)
                      if s in rank0 and s - 1 in rank0)
        return gaps[len(gaps) // 2] if gaps else None

    phase_ok = {e["kind"]: e["detail"] for e in events
                if e["kind"].startswith("reshard_")}
    rec.update({
        "losses": losses,
        "grad_norms": [steps[s][0]["grad_norm"] for s in sorted(steps)
                       if 0 in steps[s]],
        "reference": ref, "errors": _stream_errors(steps, ref),
        "order_spread": _stream_errors(
            {s: {0: {"loss": x, "grad_norm": n}}
             for s, (x, n) in enumerate(reverse, 1)}, ref),
        "fault": {"bucket": "n_buckets // 2",
                  "launcher_rc": fault.get("launcher_rc"),
                  "seconds": fault.get("seconds"),
                  "disk_write_bytes": fault.get("disk_write_bytes"),
                  "left_behind": fault["left_behind"],
                  "steps": sorted(fault_steps),
                  "errors": _stream_errors(fault_steps, ref)},
        "tolerances": {"loss": RESHARD_RTOL_LOSS,
                       "grad_norm": RESHARD_RTOL_NORM},
        "reshard": done, "migration_checks": checks_m,
        "shards": shards, "completed_shards": (int(completed.group(1))
                                               if completed else None),
        "peak_bytes_by_rank": peaks,
        "step_s_dp4": step_s(2, RESHARD_EVICT_AT),
        "step_s_dp2": step_s(RESHARD_EVICT_AT + 2, RESHARD_STEPS),
        "events": [(e["kind"], e["detail"]) for e in events
                   if e["kind"].startswith("reshard_")],
        "launches": {k: sum(r["launches"].get(k, 0) for v in steps.values()
                            for r in v.values()) for k in launches()}})
    launches_ok = sorted(steps) == list(range(1, RESHARD_STEPS + 1)) and all(
        sorted(steps[s]) == (list(range(RESHARD_RANKS))
                             if s <= RESHARD_EVICT_AT else survivors)
        and all(r["launches"] == per_step(1 if s <= RESHARD_EVICT_AT
                                          else accum_new)
                for r in steps[s].values())
        for s in steps)
    evict_loss = steps.get(RESHARD_EVICT_AT, {}).get(0, {}).get("loss")
    first_loss = steps.get(RESHARD_EVICT_AT + 1, {}).get(0, {}).get("loss")
    rec["checks"] = checks = {
        "launcher_rc_0": rec.get("launcher_rc") == 0,
        "live_4_to_2": len(done) == dp_new and all(
            d["path"] == "live" and d["dp"] == f"{RESHARD_RANKS}->{dp_new}"
            and d["grad_accum"] == accum_new for d in done),
        "five_phases_ok": len(done) == dp_new and all(
            sorted(d["phases"]) == sorted(["detect", "replan", "migrate",
                                           "rebuild", "first_step"])
            for d in done) and all(
            f"reshard_{p}" in phase_ok and "ok=True" in phase_ok[
                f"reshard_{p}"] for p in ("detect", "replan", "migrate",
                                          "rebuild", "first_step")),
        "no_storage_restore": "resumed from step" not in log
        and "falling back" not in log,
        "migrated_bitwise": checks_m == [{"m": True, "v": True,
                                          "params": True}] * dp_new,
        "continuation": evict_loss is not None and first_loss is not None
        and abs(first_loss - evict_loss) < 1.0
        and all(math.isfinite(x) for x in losses),
        "matches_replicated": sorted(steps) == list(
            range(1, RESHARD_STEPS + 1)) and rec["errors"]["within"],
        "fault_caught": fault.get("launcher_rc") == 0
        and sorted(fault_steps) == list(range(1, RESHARD_FAULT_STEPS + 1))
        and not rec["fault"]["errors"]["within"],
        "data_once": shards == [(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
                                for i in range(RESHARD_STEPS)]
        and rec["completed_shards"] == RESHARD_STEPS,
        "departing_exit": sorted(r for r in peaks if r in RESHARD_LOST)
        == list(RESHARD_LOST) and log.count("donated, exiting") == len(
            RESHARD_LOST),
        "launches_exact": launches_ok,
        "disk_under_3gib": rec.get("disk_write_bytes", 1 << 62)
        + fault.get("disk_write_bytes", 1 << 62) < RESHARD_DISK_CAP,
        "readings": rec["step_s_dp4"] is not None
        and rec["step_s_dp2"] is not None and len(peaks) == RESHARD_RANKS,
        "nothing_left_behind": rec["left_behind"] == []
        and fault["left_behind"] == [],
    }
    rec["ok"] = all(checks.values())
    emit(rec)
    if not rec["ok"]:
        _failures.append(f"{name}: {[k for k, v in checks.items() if not v]}")
    return rec


# ---------------------------------------------------------------------------
# phase 12: sequence parallelism, four ranks on the one card
# ---------------------------------------------------------------------------

SP = 4
# 1 bf16 step a phase (3 before the mesh4d phase joined the script: its
# time comes from here, FSDP_TP_STEPS and RESHARD_STEPS)
SP_LAYERS, SP_STEPS = 2, 1
# mistral-7b at b1 x s8192 (blocks of 2048, window 4096), glm-10b at
# b2 x s2048 (blocks of 512)
SP_SHAPES = {"mistral-7b": (1, 8192), "glm-10b": (2, 2048)}
# Ring (or Ulysses) against one process's flash step, on the same batch
# and weights: the loss, relative, and the first layer's gradients, max
# |Δ| over max |value|. In f32 the two differ by summation order (the
# ring's merge, the all-reduce): 1e-3, the train_model gate. In bf16 the
# ring rounds each block's output to bf16 before its f32 merge where one
# process rounds once, and the difference grows through the layers: the
# loss within 2e-3, the gradients within 5e-2 (a CPU rehearsal at test
# size read 1.8e-2).
SP_F32_TOL = 1e-3
SP_BF16_LOSS_TOL, SP_BF16_GRAD_TOL = 2e-3, 5e-2
SP_TIMEOUT_S = 600


def _sp_batch(shape, cfg, seed, dev):
    """The phase's global batch of ``shape`` (B, S): tokens from ``seed``;
    with a prefix-LM, the prefixes 0 and one that reaches past the first
    ring block but not into the last."""
    b, s = shape
    rng = np.random.default_rng(seed + 21)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(b, s + 1)),
                          device=dev)
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    if cfg.prefix_lm:
        blk = s // SP
        batch["prefix_len"] = torch.tensor(
            [0, int(rng.integers(blk + 1, s - blk))], dtype=torch.int32,
            device=dev)
    return batch


def _first_layer_grads(model):
    return {n: p.grad.detach().float().cpu()
            for n, p in model.named_parameters() if n.startswith("layers.0.")}


def _rel(got, ref):
    """max |got − ref| / max |ref| over a dict of tensors (or scalars)."""
    if isinstance(ref, dict):
        return max(_rel(got[k], ref[k]) for k in ref)
    ref = torch.as_tensor(ref, dtype=torch.float64)
    got = torch.as_tensor(got, dtype=torch.float64)
    return float((got - ref).abs().max() / max(float(ref.abs().max()),
                                               1e-30))


def _sp_reference(cfg_name, overrides, shape, seed, dev, out_path):
    """One process's flash loss and first-layer gradients, bf16 and f32,
    on the phase's batch and weights, saved for the comparison."""
    from dlrover_tpu_torch.models import decoder
    from dlrover_tpu_torch.models.config import get_config

    ref = {}
    for dt in ("bfloat16", "float32"):
        cfg = get_config(cfg_name, **dict(overrides, dtype=dt))
        model = decoder.init(cfg, seed=seed, device=dev, trainable=True)
        batch = _sp_batch(shape, cfg, seed, dev)
        loss, _ = decoder.loss_fn(model, batch, cfg, attn_impl="flash")
        loss.backward()
        ref[dt] = {"loss": float(loss.detach()),
                   "grads": _first_layer_grads(model)}
        del model, loss
        torch.cuda.empty_cache()
    torch.save(ref, out_path)
    return ref


def _sp_expected(cfg, s_l, rank, impl, prefix):
    """The flash launches of one rank in SP_STEPS steps, from its ring
    block map (``sequence.block_case``): each non-empty block launches the
    forward once, and in the backward its recompute (the checkpointed
    step), dq and dkv; Ulysses one forward, dq and dkv a layer. Returns
    (launches by kernel, offset launches by kernel, the block map)."""
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.parallel import sequence

    pack = fa.head_pack_for(cfg.n_head, cfg.kv_heads, cfg.head_dim,
                            cfg.attn_head_pack)
    fwd, dq, dkv = fa.PACKED if pack == 2 else fa.UNPACKED
    blocks = []
    if impl == "ring":
        for step in range(SP):
            src = (rank - step) % SP
            blocks.append(sequence.block_case(
                rank * s_l, src * s_l, s_l, s_l, cfg.causal, cfg.attn_window,
                prefix))
        live = sum(c != sequence.EMPTY for c in blocks)
        shifted = sum(c in (sequence.WINDOW_PARTIAL, sequence.PREFIX_ONLY)
                      for c in blocks)
        per = {fwd: 2 * live, dq: live, dkv: live}
        off = {fwd: 2 * shifted, dq: shifted, dkv: shifted}
    else:
        per = {fwd: 1, dq: 1, dkv: 1}
        off = {}
    n = cfg.n_layer * SP_STEPS
    launches = {k: n * per.get(k, 0) for k in fa.KERNELS}
    launches.update(norm_fwd=(2 * cfg.n_layer + 1) * SP_STEPS,
                    norm_bwd=(2 * cfg.n_layer + 1) * SP_STEPS)
    return launches, {k: n * off.get(k, 0) for k in fa.KERNELS}, blocks


def _fault_rank(cfg, s_l, impl, prefix):
    """The rank that plants the fault: the last whose ring blocks carry
    offsets (Ulysses: the last)."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    if impl != "ring":
        return SP - 1
    return max(r for r in range(SP) if any(
        _sp_expected(cfg, s_l, r, impl, prefix)[1][k] for k in fa.KERNELS))


@contextlib.contextmanager
def _planted(impl, rank, fault_rank, s_l):
    """The planted fault, on ``fault_rank`` alone: the ring's offset
    blocks with k_off moved by a quarter block (on a prefix-only block
    q_off with it: its q_off sits at the kernels' range already, and the
    causal term stays dead); Ulysses' attention over its share of the
    heads with the window moved by a quarter block (mistral-7b) or the
    prefixes by as much (glm-10b)."""
    from dlrover_tpu_torch.parallel import sequence

    if rank != fault_rank:
        yield
        return
    if impl == "ring":
        orig = sequence.flash_attention_with_lse

        def shifted(*a, offsets=None, **kw):
            if offsets is not None:
                d = s_l // 4
                offsets = (offsets[0] + d * (offsets[0] < 0),
                           offsets[1] + d)
            return orig(*a, offsets=offsets, **kw)

        sequence.flash_attention_with_lse = shifted
        try:
            yield
        finally:
            sequence.flash_attention_with_lse = orig
        return
    orig = sequence.ulysses_attention

    def moved(q, k, v, mesh, *, attn_fn=None, prefix_len=None, window=0,
              **kw):
        def inner(q, k, v, prefix_len=None, window=0):
            if window:
                window += s_l // 4
            if prefix_len is not None:
                prefix_len = prefix_len + s_l // 4
            kws = {}
            if prefix_len is not None:
                kws["prefix_len"] = prefix_len
            if window:
                kws["window"] = window
            return attn_fn(q, k, v, **kws)
        return orig(q, k, v, mesh, attn_fn=inner, prefix_len=prefix_len,
                    window=window, **kw)

    sequence.ulysses_attention = moved
    try:
        yield
    finally:
        sequence.ulysses_attention = orig


def _sp_grads(model, cfg, batch, mesh, impl):
    """Loss and first-layer gradients of the sp step on this rank's block:
    the global mask sum, the backward, then the loss and the first layer's
    gradients all-reduced (the step's reduction, cut to what the check
    reads)."""
    from dlrover_tpu_torch.models import decoder
    from dlrover_tpu_torch.parallel.collectives import all_reduce_
    from dlrover_tpu_torch.train.data_utils import sequence_block

    for p in model.parameters():
        p.grad = None
    blk = sequence_block(batch, mesh)
    count = torch.tensor(float(blk["targets"].numel()),
                         device=batch["tokens"].device)
    all_reduce_(count)
    loss, _ = decoder.loss_fn(model, blk, cfg, attn_impl=impl,
                              denom=count, mesh=mesh)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()
             if n.startswith("layers.0.")}
    flat = torch.cat([g.reshape(-1).float() for g in grads.values()]
                     + [loss.detach().reshape(1).float()])
    all_reduce_(flat)
    at, out = 0, {}
    for n, g in grads.items():
        out[n] = flat[at: at + g.numel()].view(g.shape).cpu()
        at += g.numel()
    for p in model.parameters():
        p.grad = None
    return float(flat[-1]), out


def sp_worker(spec_path, rank):
    """One rank of an sp phase (a subprocess of ``sp_check``): a gloo group
    of SP ranks on card 0 (asked for: NCCL refuses two ranks on one
    GPU), the mesh ``MeshConfig(dp=1, sp=SP)``; for each ``attn_impl``:
    the f32 loss and first-layer gradients, again with the planted fault,
    the bf16 ones, then SP_STEPS bf16 steps of ``TrainStepBuilder`` with
    the launch counts read around them. Writes its record and the values
    the parent compares."""
    from dlrover_tpu_torch.models import decoder
    from dlrover_tpu_torch.models.config import get_config
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.parallel.collectives import all_reduce_
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.train.distributed import (
        init_distributed,
        shutdown_distributed,
    )
    from dlrover_tpu_torch.train.optimizer import make_optimizer
    from dlrover_tpu_torch.train.train_step import TrainStepBuilder

    spec = json.loads(open(spec_path).read())
    dev = torch.device(spec["device"])
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.monotonic()
    init_distributed(coordinator=f"127.0.0.1:{spec['port']}", world_size=SP,
                     rank=rank, device=dev.type, backend="gloo",
                     device_index=0 if cuda else None,
                     timeout_s=SP_TIMEOUT_S)
    group_s = time.monotonic() - t0
    rebuilt = []
    real_build = _build.build

    def counted(name):  # a compile here would have cost the phase minutes
        secs = real_build(name)
        if secs > 0:
            rebuilt.append(name)
        return secs

    _build.build = counted
    out = {"rank": rank, "group_s": group_s, "impls": {}}
    vals = {}
    try:
        mesh = build_mesh(MeshConfig(dp=1, sp=SP))
        name, seed, over = spec["config"], spec["seed"], spec["overrides"]
        shape = tuple(spec["shape"])
        s_l = shape[1] // SP
        for impl in spec["impls"]:
            rec = {}
            cfg32 = get_config(name, **dict(over, dtype="float32"))
            model = decoder.init(cfg32, seed=seed, device=dev,
                                 trainable=True)
            batch = _sp_batch(shape, cfg32, seed, dev)
            prefix = (batch["prefix_len"].tolist()
                      if "prefix_len" in batch else None)
            vals[(impl, "float32")] = _sp_grads(model, cfg32, batch, mesh,
                                                impl)
            fault_rank = _fault_rank(cfg32, s_l, impl, prefix)
            rec["fault_rank"] = fault_rank
            with _planted(impl, rank, fault_rank, s_l):
                vals[(impl, "fault")] = _sp_grads(model, cfg32, batch, mesh,
                                                  impl)
            del model
            cfg = get_config(name, **over)
            opt = make_optimizer(learning_rate=1e-4, warmup_steps=10,
                                 decay_steps=1000)
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            model = decoder.init(cfg, seed=seed, device=dev, trainable=True)
            vals[(impl, "bfloat16")] = _sp_grads(model, cfg, batch, mesh,
                                                 impl)
            state = {"params": model,
                     "opt_state": opt.init(dict(model.named_parameters())),
                     "step": 0}
            step = TrainStepBuilder(cfg, opt, attn_impl=impl, device=dev,
                                    mesh=mesh).build()
            losses, wall_ms = [], []
            _reset_train_launches()
            for _ in range(SP_STEPS):
                t = time.perf_counter()
                state, m = step(state, batch)
                if cuda:
                    torch.cuda.synchronize()
                wall_ms.append((time.perf_counter() - t) * 1e3)
                losses.append(float(m["loss"]))
            launches = _train_launches()
            offset_launches = dict(fa.OFFSET_LAUNCHES)
            peak = torch.cuda.max_memory_allocated() if cuda else None
            want, want_off, blocks = _sp_expected(cfg, s_l, rank, impl,
                                                  prefix)
            # the step's gradient all-reduce alone (its flat f32 buffer,
            # host-staged over gloo): what it takes of a step
            flat = torch.zeros(sum(p.numel() for p in model.parameters()),
                               device=dev)
            t = time.perf_counter()
            all_reduce_(flat)
            if cuda:
                torch.cuda.synchronize()
            rec["allreduce_ms"] = (time.perf_counter() - t) * 1e3
            del flat
            rec.update(
                losses=losses, step_wall_ms=wall_ms, blocks=blocks,
                launches=launches, launches_expected=want,
                offset_launches=offset_launches,
                offset_launches_expected=want_off,
                max_memory_allocated=peak,
                finite=all(math.isfinite(x) for x in losses))
            out["impls"][impl] = rec
            del state, model, step, m
            if cuda:
                torch.cuda.empty_cache()
        out["rebuilt"] = len(rebuilt)
    finally:
        shutdown_distributed()
    if rank == 0:
        torch.save(vals, spec["values"])
    with open(spec["out"].format(rank=rank), "w") as f:
        json.dump(out, f)


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def sp_check(cfg_name, impls, names, seed, dev, overrides=None,
             shape=None):
    """The sp phases of one config: the one-process references here (then
    freed), SP worker processes on card 0 (``sp_worker``), each gated:
    f32 loss and first-layer gradients within SP_F32_TOL of one process's,
    the planted fault beyond it, bf16 within SP_BF16_LOSS_TOL /
    SP_BF16_GRAD_TOL, finite losses, every rank's launches (the offset
    ones apart) equal to its block map's, no kernel rebuilt in a worker.
    ``names``: the phase name of each impl. ``overrides`` (default: the
    depth cut to SP_LAYERS) and ``shape`` (default SP_SHAPES') size a
    rehearsal. Returns the records."""
    overrides = dict(n_layer=SP_LAYERS) if overrides is None else overrides
    shape = SP_SHAPES[cfg_name] if shape is None else shape
    out_dir = os.path.join("build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    ref = _sp_reference(cfg_name, overrides, shape, seed, dev,
                        os.path.join(out_dir, f"sp_ref_{cfg_name}.pt"))
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    spec = {"config": cfg_name, "seed": seed, "impls": list(impls),
            "device": str(dev), "overrides": overrides, "shape": shape,
            "port": _free_port(),
            "values": os.path.join(out_dir, f"sp_values_{cfg_name}.pt"),
            "out": os.path.join(out_dir, f"sp_{cfg_name}_{{rank}}.json")}
    spec_path = os.path.join(out_dir, f"sp_spec_{cfg_name}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    log_path = os.path.join(out_dir, f"sp_log_{cfg_name}.txt")
    t0 = time.monotonic()
    with open(log_path, "w") as log:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sp-worker",
             spec_path, "--rank", str(r)], stdout=log,
            stderr=subprocess.STDOUT) for r in range(SP)]
        try:
            rcs = [p.wait(timeout=SP_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    seconds = time.monotonic() - t0
    if any(rcs):
        with open(log_path) as f:
            tail = f.read()[-6000:]
        for name in names.values():
            _failures.append(f"{name}: worker exit codes {rcs}\n{tail}")
        emit({"phase": "sp_" + cfg_name, "ok": False, "exit_codes": rcs,
              "log_tail": tail})
        return {}
    ranks = []
    for r in range(SP):
        with open(spec["out"].format(rank=r)) as f:
            ranks.append(json.load(f))
    vals = torch.load(spec["values"], weights_only=False)
    recs = {}
    for impl, name in names.items():
        f32_loss, f32_grads = vals[(impl, "float32")]
        bad_loss, bad_grads = vals[(impl, "fault")]
        bf_loss, bf_grads = vals[(impl, "bfloat16")]
        r32, rbf = ref["float32"], ref["bfloat16"]
        per_rank = [x["impls"][impl] for x in ranks]
        err = {"f32_loss": _rel(f32_loss, r32["loss"]),
               "f32_grads": _rel(f32_grads, r32["grads"]),
               "fault_loss": _rel(bad_loss, r32["loss"]),
               "fault_grads": _rel(bad_grads, r32["grads"]),
               "bf16_loss": _rel(bf_loss, rbf["loss"]),
               "bf16_grads": _rel(bf_grads, rbf["grads"]),
               "bf16_step1_loss": _rel(per_rank[0]["losses"][0], rbf["loss"])}
        gates = {
            "f32_within": max(err["f32_loss"], err["f32_grads"]) <= SP_F32_TOL,
            "fault_caught": max(err["fault_loss"], err["fault_grads"])
            > SP_F32_TOL,
            "bf16_within": (err["bf16_loss"] <= SP_BF16_LOSS_TOL
                            and err["bf16_step1_loss"] <= SP_BF16_LOSS_TOL
                            and err["bf16_grads"] <= SP_BF16_GRAD_TOL),
            "finite": all(x["finite"] for x in per_rank),
            "launches_exact": all(
                x["launches"] == x["launches_expected"]
                and {k: v for k, v in x["offset_launches"].items()}
                == x["offset_launches_expected"] for x in per_rank),
            "offsets_ran": (impl != "ring" or sum(
                sum(x["offset_launches"].values()) for x in per_rank) > 0),
            "no_rebuild": all(x["rebuilt"] == 0 for x in ranks),
        }
        b, s = shape
        rec = {"phase": name, "config": cfg_name,
               "n_layer": overrides.get("n_layer"),
               "attn_impl": impl, "sp": SP, "batch": b, "seq": s,
               "backend": "gloo (host-staged), 4 ranks on cuda:0",
               "steps": SP_STEPS, "errors": err,
               "tolerances": {"f32": SP_F32_TOL, "bf16_loss":
                              SP_BF16_LOSS_TOL, "bf16_grads":
                              SP_BF16_GRAD_TOL},
               "fault": (f"rank {per_rank[0]['fault_rank']}: "
                         + ("its offset blocks' k_off + S_l/4"
                            if impl == "ring" else
                            "its heads' window/prefix + S_l/4")),
               "ranks": [{k: x[k] for k in (
                   "blocks", "losses", "step_wall_ms", "allreduce_ms",
                   "fault_rank",
                   "max_memory_allocated", "launches", "offset_launches")}
                   for x in per_rank],
               "group_s": [x["group_s"] for x in ranks],
               "phase_s": seconds, "gates": gates}
        rec["ok"] = all(gates.values())
        emit(rec)
        if not rec["ok"]:
            _failures.append(f"{name}: {rec['gates']} {rec['errors']}")
        recs[name] = rec
    return recs


# ---------------------------------------------------------------------------
# phase 13: fsdp x tp, four ranks on the one card
# ---------------------------------------------------------------------------

FSDP_TP_MESH = {"fsdp": 2, "tp": 2}
FSDP_TP_RANKS = 4
# 2 steps (8 before the mesh4d phase joined the script)
FSDP_TP_LAYERS, FSDP_TP_STEPS, FSDP_TP_FAULT_STEPS = 2, 2, 2
FSDP_TP_TIMEOUT_S = 480
# every rank's loss and grad norm against the one-process replicated run
# on the same global batches, relative: ``RESHARD_RTOL_*``'s bound (the
# sharded step rounds its fsdp rows' and tp blocks' partial products to
# bf16 where one process rounds once; ``order_spread`` reads what a
# reordering alone moves)
FSDP_TP_RTOL_LOSS, FSDP_TP_RTOL_NORM = 1e-4, 1e-4
#: the planted fault: the step skips the tp sum of these gradients
FSDP_TP_FAULT_LEAVES = ("layers/attn/wk", "layers/attn/wv")
# the sharded state against the replicated one: params, grads and AdamW's
# two moments, f32. A quarter, and wk/wv (cut over fsdp only) a half:
# 0.27 at llama-1.4b's widths; the gate allows 0.3
FSDP_TP_STATE_SHARE = 0.3


def fsdp_tp_shape_cases(gen, dev):
    """The kernels at the shapes a rank of the fsdp_tp phase launches
    them, each against its plain version with its planted fault:
    llama-1.4b's attention at a rank's 4 rows (b8 over fsdp 2) and 8 of
    its 16 heads (tp 2), causal; its rmsnorm rows (4096 of d 2048, the
    whole d on every tp rank; plain and with the residual)."""
    return [
        flash_case("llama-1.4b-fsdp-tp", 4, 1024, 8, 8, 128, True, 0,
                   gen, dev, False),
        norm_case("llama-1.4b-fsdp-tp", 4096, 2048, False, gen, dev, False),
        norm_case("llama-1.4b-fsdp-tp+residual", 4096, 2048, True, gen, dev,
                  False),
    ]


def _fsdp_tp_opt():
    from dlrover_tpu_torch.examples import train_gpt_elastic as ex
    from dlrover_tpu_torch.train.optimizer import make_optimizer

    return make_optimizer(learning_rate=ex.LR, warmup_steps=ex.WARMUP,
                          decay_steps=ex.DECAY)


def _fsdp_tp_batch(cfg, seed, step, b, s):
    """Global step ``step``'s batch, [b, s] tokens and targets, from
    ``seed``: the same for every rank and for the reference."""
    rng = np.random.default_rng([seed, 31, step])
    tok = rng.integers(0, cfg.vocab_size, size=(b, s + 1))
    return {"tokens": tok[:, :-1], "targets": tok[:, 1:]}


def _state_bytes(model):
    """Params, gradients and AdamW's two moments, all f32: 16 B a
    parameter this rank holds."""
    return 16 * sum(p.numel() for p in model.parameters())


def fsdp_tp_reference(cfg, seed, dev, steps, b, s, reverse=False):
    """The one-process replicated stream the sharded run is held to: each
    step's global batch in 2 micro-batches, an fsdp rank's rows each
    (``reverse``: the second first), from the same init (every layout
    draws the same global weights). Returns ([(loss, grad_norm)] a step,
    its record: peak memory, the state's bytes, the median step's wall
    s)."""
    from dlrover_tpu_torch.train.train_step import (
        TrainStepBuilder,
        init_train_state,
    )

    cuda = dev.type == "cuda"
    opt = _fsdp_tp_opt()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state = init_train_state(seed, cfg, opt, device=dev)
    accum = FSDP_TP_MESH["fsdp"]
    step = TrainStepBuilder(cfg, opt, grad_accum=accum, device=dev).build()
    out, walls = [], []
    for i in range(1, steps + 1):
        batch = _fsdp_tp_batch(cfg, seed, i, b, s)
        if reverse:
            batch = {k: np.concatenate(np.split(v, accum)[::-1])
                     for k, v in batch.items()}
        t = time.perf_counter()
        state, m = step(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
        walls.append(time.perf_counter() - t)
    rec = {"peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
           "state_bytes": _state_bytes(state["params"]),
           "step_s": sorted(walls[1:])[len(walls[1:]) // 2]}
    del state, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out, rec


class _Clock:
    """Wall seconds spent inside the collectives a step runs (each timed
    from a synchronized card, so a host-staged copy does not count the
    compute queued before it)."""

    def __init__(self, cuda):
        self.cuda, self.seconds, self.calls = cuda, 0.0, 0

    def wrap(self, fn):
        def timed(*args, **kw):
            if self.cuda:
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            if self.cuda:
                torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t
            self.calls += 1
            return out
        return timed


def fsdp_tp_worker(spec_path, rank):
    """One rank of the fsdp_tp phase (a subprocess of ``fsdp_tp_check``):
    a gloo group of FSDP_TP_RANKS ranks on card 0, the mesh
    ``MeshConfig(fsdp=2, tp=2)``, ``init_train_state`` and
    ``TrainStepBuilder`` on it for FSDP_TP_STEPS steps, each on this
    rank's rows of the global batch, the launch counts and the time in
    the collectives read around each step; then FSDP_TP_FAULT_STEPS steps
    from the same init with the planted fault. Writes its record."""
    from dlrover_tpu_torch.models.config import get_config
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.parallel import collectives
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.train import train_step as ts
    from dlrover_tpu_torch.train.data_utils import dp_rows
    from dlrover_tpu_torch.train.distributed import (
        init_distributed,
        shutdown_distributed,
    )

    spec = json.loads(open(spec_path).read())
    dev = torch.device(spec["device"])
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.monotonic()
    init_distributed(coordinator=f"127.0.0.1:{spec['port']}",
                     world_size=FSDP_TP_RANKS, rank=rank, device=dev.type,
                     backend="gloo", device_index=0 if cuda else None,
                     timeout_s=FSDP_TP_TIMEOUT_S)
    out = {"rank": rank, "group_s": time.monotonic() - t0}
    rebuilt = []
    real_build = _build.build

    def counted(name):  # a compile here would have cost the phase minutes
        secs = real_build(name)
        if secs > 0:
            rebuilt.append(name)
        return secs

    _build.build = counted
    clock = _Clock(cuda)
    for name in ("all_gather_dim", "reduce_scatter_dim", "all_reduce_"):
        setattr(collectives, name, clock.wrap(getattr(collectives, name)))
    ts.all_reduce_ = collectives.all_reduce_
    try:
        cfg = get_config(spec["config"], **spec["overrides"])
        mesh = build_mesh(MeshConfig(**FSDP_TP_MESH))
        out["mesh"] = dict(mesh.shape)
        b, s = spec["shape"]

        def run(steps, fault):
            opt = _fsdp_tp_opt()
            state = ts.init_train_state(spec["seed"], cfg, opt, device=dev,
                                        mesh=mesh)
            builder = ts.TrainStepBuilder(cfg, opt, device=dev, mesh=mesh)
            if fault:
                for n, shard in builder.layout.items():
                    if shard.path in FSDP_TP_FAULT_LEAVES:
                        builder.reduce_axes[n] = tuple(
                            a for a in builder.reduce_axes[n] if a != "tp")
            rec = {"losses": [], "grad_norms": [], "step_s": [],
                   "collective_s": [], "collective_calls": [],
                   "launches": [],
                   "state_bytes": _state_bytes(state["params"])}
            for i in range(1, steps + 1):
                batch = dp_rows(_fsdp_tp_batch(cfg, spec["seed"], i, b, s),
                                mesh)
                _reset_train_launches()
                clock.seconds, clock.calls = 0.0, 0
                t = time.perf_counter()
                state, m = builder.step_fn(state, batch)
                loss, norm = float(m["loss"]), float(m["grad_norm"])
                if cuda:
                    torch.cuda.synchronize()
                rec["step_s"].append(time.perf_counter() - t)
                rec["launches"].append(_train_launches())
                rec["collective_s"].append(clock.seconds)
                rec["collective_calls"].append(clock.calls)
                rec["losses"].append(loss)
                rec["grad_norms"].append(norm)
            del state, builder
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
            return rec

        if cuda:
            torch.cuda.reset_peak_memory_stats()
        out["run"] = run(FSDP_TP_STEPS, False)
        out["peak_bytes"] = (torch.cuda.max_memory_allocated() if cuda
                             else None)
        out["fault"] = run(FSDP_TP_FAULT_STEPS, True)
        out["rebuilt"] = len(rebuilt)
    finally:
        shutdown_distributed()
    with open(spec["out"].format(rank=rank), "w") as f:
        json.dump(out, f)


def fsdp_tp_check(cfg_name, seed, dev, name="fsdp_tp", overrides=None,
                  shape=None):
    """The fsdp_tp phase: llama-1.4b at full width and FSDP_TP_LAYERS
    layers on ``MeshConfig(fsdp=2, tp=2)``, FSDP_TP_RANKS worker
    processes on card 0 over gloo (``fsdp_tp_worker``), FSDP_TP_STEPS
    steps at b``TRAIN_BATCH`` × s``TRAIN_SEQ``; then, in this process,
    the replicated reference and its micro-batches reversed
    (``order_spread``). Gated: every rank's loss and grad norm of every
    step within FSDP_TP_RTOL_* of the reference, the planted fault (no
    tp sum of ``wk``/``wv``'s gradients) beyond them, finite losses,
    exact launches a rank a step, each rank's state under
    FSDP_TP_STATE_SHARE of the replicated one, no kernel rebuilt. Writes
    nothing but its log and records under ``build/chip_smoke``.
    ``overrides`` and ``shape`` size a rehearsal."""
    from dlrover_tpu_torch.models.config import get_config
    from dlrover_tpu_torch.ops import flash_attention as fa

    overrides = (dict(n_layer=FSDP_TP_LAYERS) if overrides is None
                 else overrides)
    b, s = shape or (TRAIN_BATCH, TRAIN_SEQ)
    cfg = get_config(cfg_name, **dict(overrides, max_seq=s))
    out_dir = os.path.join("build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    spec = {"config": cfg_name, "seed": seed, "device": str(dev),
            "overrides": dict(overrides, max_seq=s), "shape": [b, s],
            "port": _free_port(),
            "out": os.path.join(out_dir, f"{name}_{{rank}}.json")}
    spec_path = os.path.join(out_dir, f"{name}_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    log_path = os.path.join(out_dir, f"{name}_log.txt")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    with open(log_path, "w") as log:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--fsdp-tp-worker",
             spec_path, "--rank", str(r)], stdout=log,
            stderr=subprocess.STDOUT) for r in range(FSDP_TP_RANKS)]
        try:
            rcs = [p.wait(timeout=FSDP_TP_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    seconds = time.monotonic() - t0
    if any(rcs):
        with open(log_path) as f:
            tail = f.read()[-6000:]
        _failures.append(f"{name}: worker exit codes {rcs}\n{tail}")
        emit({"phase": name, "ok": False, "exit_codes": rcs,
              "log_tail": tail})
        return {"launches": {}, "ranks": []}
    ranks = []
    for r in range(FSDP_TP_RANKS):
        with open(spec["out"].format(rank=r)) as f:
            ranks.append(json.load(f))
    t1 = time.monotonic()
    ref, ref_rec = fsdp_tp_reference(cfg, seed, dev, FSDP_TP_STEPS, b, s)
    reverse, _ = fsdp_tp_reference(cfg, seed, dev, FSDP_TP_STEPS, b, s,
                                   reverse=True)
    ref_rec["seconds"] = time.monotonic() - t1

    def steps_of(key):
        return {i + 1: {x["rank"]: {"loss": x[key]["losses"][i],
                                    "grad_norm": x[key]["grad_norms"][i]}
                        for x in ranks}
                for i in range(len(ranks[0][key]["losses"]))}

    def errors(steps):
        e = _stream_errors(steps, ref)
        e["within"] = (e["loss"] is not None
                       and e["loss"] <= FSDP_TP_RTOL_LOSS
                       and e["grad_norm"] <= FSDP_TP_RTOL_NORM)
        return e

    want = {k: 0 for k in _train_launches()}
    want.update({k: cfg.n_layer for k in fa.UNPACKED},
                norm_fwd=2 * cfg.n_layer + 1, norm_bwd=2 * cfg.n_layer + 1)
    run = [x["run"] for x in ranks]
    share = [x["state_bytes"] / ref_rec["state_bytes"] for x in run]

    def median(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2]

    rec = {"phase": name, "config": cfg_name, "n_layer": cfg.n_layer,
           "d_model": cfg.d_model, "n_head": cfg.n_head,
           "mesh": FSDP_TP_MESH, "batch": b, "seq": s,
           "steps": FSDP_TP_STEPS,
           "backend": "gloo (host-staged), 4 ranks on cuda:0",
           "card": nvidia_smi_line() if dev.type == "cuda" else None,
           "losses": run[0]["losses"], "grad_norms": run[0]["grad_norms"],
           "reference": ref, "errors": errors(steps_of("run")),
           "order_spread": _stream_errors(
               {i: {0: {"loss": x, "grad_norm": n}}
                for i, (x, n) in enumerate(reverse, 1)}, ref),
           "fault": {"what": "no tp sum of the wk/wv gradients",
                     "steps": FSDP_TP_FAULT_STEPS,
                     "errors": errors(steps_of("fault"))},
           "tolerances": {"loss": FSDP_TP_RTOL_LOSS,
                          "grad_norm": FSDP_TP_RTOL_NORM},
           "step_s_by_rank": [median(x["step_s"][1:]) for x in run],
           "collective_s_by_rank": [median(x["collective_s"][1:])
                                    for x in run],
           "collective_calls_a_step": run[0]["collective_calls"][-1],
           "peak_bytes_by_rank": [x["peak_bytes"] for x in ranks],
           "state_bytes_by_rank": [x["state_bytes"] for x in run],
           "state_share": share, "reference_run": ref_rec,
           "group_s": [x["group_s"] for x in ranks], "phase_s": seconds,
           "launches": {k: sum(step[k] for x in run
                               for step in x["launches"])
                        for k in _train_launches()}}
    rec["collective_share"] = [c / t for c, t in zip(
        rec["collective_s_by_rank"], rec["step_s_by_rank"])]
    rec["checks"] = checks = {
        "mesh": all({k: v for k, v in x["mesh"].items() if v > 1}
                    == FSDP_TP_MESH for x in ranks),
        "matches_replicated": rec["errors"]["within"],
        "fault_caught": not rec["fault"]["errors"]["within"],
        "finite": all(math.isfinite(v) for x in run for v in x["losses"]),
        "launches_exact": all(step == want for x in run
                              for step in x["launches"]),
        "state_sharded": all(v < FSDP_TP_STATE_SHARE for v in share),
        "no_rebuild": all(x["rebuilt"] == 0 for x in ranks),
    }
    rec["ok"] = all(checks.values())
    emit(rec)
    if not rec["ok"]:
        _failures.append(f"{name}: {[k for k, v in checks.items() if not v]}"
                         f" {rec['errors']} {rec['fault']['errors']}")
    return rec


# ---------------------------------------------------------------------------
# phase 14: hybrid sharded data parallelism and the gradient wires, four
# ranks on the one card
# ---------------------------------------------------------------------------

HYBRID_RANKS = 4
# (a) 3 steps (its step time is read between steps 2 and 3), (b) and (c)
# 2, the f32 and fault runs 1: at 6 and 4 a run the whole script took
# 1040 and 1060 s on one H100 80GB HBM3 at 700 W, 87-88% of its 1200 s
# limit, and at 3 a run 1199 s on a slow host
HYBRID_LAYERS, HYBRID_STEPS, HYBRID_FAULT_STEPS, HYBRID_F32_STEPS = 2, 3, 1, 1
HYBRID_WORKER_STEPS = 2
HYBRID_TIMEOUT_S = 480
# (a) and (b) against the one-process replicated run: the fsdp_tp and
# reshard phases' bound
HYBRID_RTOL_LOSS, HYBRID_RTOL_NORM = 1e-4, 1e-4
# (c) the quantized wires against the same run, relative. First stated
# from a CPU rehearsal (int8 1e-3 loss, 1e-2 norm; bf16 1e-3, 5e-3), then
# cut towards what the card read at full width (H100 80GB HBM3, 700 W; the
# streams are deterministic: every run read the same): int8 at most
# 1.47e-5 (loss) and 9.22e-5 (norm), bf16 1.95e-5 and 1.36e-5. int8's
# norm bound is some 3 times its largest reading; the rest is the (a)/(b)
# bound. The planted wire fault (``wire_rows``) must fall outside
HYBRID_WIRE_RTOL = {"int8": {"loss": 1e-4, "grad_norm": 3e-4},
                    "bfloat16": {"loss": 1e-4, "grad_norm": 1e-4}}
# the worker's runs: (name, mesh, CommConfig, steps, planted fault)
HYBRID_RUNS = (
    ("tp", dict(dp=2, tp=2), dict(update_sharding="zero1"),
     HYBRID_WORKER_STEPS, None),
    ("fault_fsdp", dict(dp=2, fsdp=2), dict(update_sharding="zero2"),
     HYBRID_FAULT_STEPS, "unassembled"),
    ("fault_tp", dict(dp=2, tp=2), dict(update_sharding="zero1"),
     HYBRID_FAULT_STEPS, "norm_world"),
    ("int8", dict(dp=4, num_slices=4),
     dict(update_sharding="zero2", wire_dtype_dcn="int8"),
     HYBRID_WORKER_STEPS, None),
    ("bf16", dict(dp=4, num_slices=4),
     dict(update_sharding="zero2", wire_dtype="bfloat16"),
     HYBRID_WORKER_STEPS, None),
    ("f32", dict(dp=4, num_slices=4), dict(update_sharding="zero2"),
     HYBRID_F32_STEPS, None),
    ("fault_wire", dict(dp=4, num_slices=4),
     dict(update_sharding="zero2", wire_dtype_dcn="int8"),
     HYBRID_FAULT_STEPS, "wire_rows"),
)
#: the unassembled fault's leaf: laid into the gradient stream from this
#: rank's shard alone, the other fsdp peer's left out
HYBRID_FAULT_LEAF = "layers/mlp/w_up"


def hybrid_shape_cases(gen, dev):
    """The kernels at the shapes a rank of the hybrid_zero phase launches
    them that no earlier case covers, each against its plain version with
    its planted fault: llama-1.4b's attention at a rank's 2 rows (b8 over
    dp 2 × fsdp 2, or dp 4) and all 16 heads, causal; its rmsnorm rows
    (2048 of d 2048; plain and with the residual). dp 2 × tp 2 runs the
    fsdp_tp shapes (B 4 × H 8, [4096, 2048])."""
    return [
        flash_case("llama-1.4b-hybrid", 2, 1024, 16, 16, 128, True, 0,
                   gen, dev, False),
        norm_case("llama-1.4b-hybrid", 2048, 2048, False, gen, dev, False),
        norm_case("llama-1.4b-hybrid+residual", 2048, 2048, True, gen, dev,
                  False),
    ]


def _hybrid_batch(cfg, seed, step, s):
    """Global step ``step``'s batch: the elastic example's rows of its
    ``HYBRID_RANKS`` data ranks (``synthetic_batch``, ``TRAIN_BATCH /
    HYBRID_RANKS`` rows each), in rank order: what run (a) trains, and
    what every mesh of the phase cuts its rows from."""
    from dlrover_tpu_torch.examples import train_gpt_elastic as ex

    parts = [ex.synthetic_batch(seed, step, r, TRAIN_BATCH // HYBRID_RANKS,
                                s, cfg.vocab_size)
             for r in range(HYBRID_RANKS)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def hybrid_reference(cfg, seed, dev, steps, s):
    """The one-process replicated stream the phase is held to: each step's
    global batch in ``HYBRID_RANKS`` micro-batches of a data rank's rows,
    the example's optimizer, the same init
    (every layout draws the same global weights). ([(loss, grad_norm)] a
    step, its record: peak memory, state bytes, the median step's wall
    s)."""
    from dlrover_tpu_torch.train.train_step import (
        TrainStepBuilder,
        init_train_state,
    )

    cuda = dev.type == "cuda"
    opt = _fsdp_tp_opt()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state = init_train_state(seed, cfg, opt, device=dev)
    accum = HYBRID_RANKS
    step = TrainStepBuilder(cfg, opt, grad_accum=accum, device=dev).build()
    out, walls = [], []
    for i in range(1, steps + 1):
        batch = _hybrid_batch(cfg, seed, i, s)
        t = time.perf_counter()
        state, m = step(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
        walls.append(time.perf_counter() - t)
    rec = {"peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
           "state_bytes": _state_bytes(state["params"]),
           "step_s": sorted(walls[1:])[len(walls[1:]) // 2]}
    del state, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out, rec


def _plant_hybrid_fault(builder, fault):
    """``norm_world``: the columns' square sums added over the whole world
    (every fsdp × tp peer's copy counted again); ``unassembled``:
    ``HYBRID_FAULT_LEAF``'s gradient laid into the stream from this
    rank's shard alone; ``wire_rows``: the int8 wire's decode-sum of the
    middle bucket leaves out the last peer's rows. Returns what undoes a
    fault planted outside the builder."""
    from dlrover_tpu_torch.parallel import sharding as shd
    from dlrover_tpu_torch.parallel.mesh import data_axes

    mesh = builder.mesh
    if fault == "norm_world":
        builder._zero_sums = lambda stats, sq: (
            builder._sum(stats, data_axes()),
            builder._sum(sq, ("dp", "fsdp", "tp")))
        return lambda: None
    if fault == "wire_rows":
        real_sum, n = shd.wire_decode_sum, builder.plan.n_buckets
        calls = [0]

        def short(q, scale):  # the buckets go from the last down
            bucket = n - 1 - calls[0] % n
            calls[0] += 1
            if bucket == n // 2:
                q, scale = q[:-1], scale[:-1]
            return real_sum(q, scale)

        shd.wire_decode_sum = short
        return lambda: setattr(shd, "wire_decode_sum", real_sum)
    own = mesh.ranks(("fsdp", "tp")).index(mesh.rank)
    names = [n for n, sh in builder.layout.items()
             if sh.path == HYBRID_FAULT_LEAF]
    real, real_grads = shd.pack_shards, builder._grad_stream

    def own_only(cfg, peers, layouts, plan):
        peers = [p if i == own else dict(p, **{
            n: torch.zeros_like(p[n]) for n in names})
            for i, p in enumerate(peers)]
        return real(cfg, peers, layouts, plan)

    def grad_stream(params):
        shd.pack_shards = own_only
        try:
            return real_grads(params)
        finally:
            shd.pack_shards = real

    builder._grad_stream = grad_stream
    return lambda: None


def hybrid_worker(spec_path, rank):
    """One rank of the hybrid_zero phase (a subprocess of
    ``hybrid_check``): a gloo group of HYBRID_RANKS ranks on card 0, then
    each of ``HYBRID_RUNS``: its mesh (``build_mesh``), its
    ``CommConfig``, ``init_train_state`` and ``TrainStepBuilder`` for its
    steps, each on this rank's rows of the global batch, the launch
    counts, the bytes on the wire (``sharding.WIRE``) and the time in the
    collectives read around each step. Writes its record."""
    from dlrover_tpu_torch.models.config import get_config
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.parallel import collectives
    from dlrover_tpu_torch.parallel import sharding as shd
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.train import train_step as ts
    from dlrover_tpu_torch.train.data_utils import dp_rows
    from dlrover_tpu_torch.train.distributed import (
        init_distributed,
        shutdown_distributed,
    )

    spec = json.loads(open(spec_path).read())
    dev = torch.device(spec["device"])
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.monotonic()
    init_distributed(coordinator=f"127.0.0.1:{spec['port']}",
                     world_size=HYBRID_RANKS, rank=rank, device=dev.type,
                     backend="gloo", device_index=0 if cuda else None,
                     timeout_s=HYBRID_TIMEOUT_S)
    out = {"rank": rank, "group_s": time.monotonic() - t0, "runs": {}}
    rebuilt = []
    real_build = _build.build

    def counted(name):  # a compile here would have cost the phase minutes
        secs = real_build(name)
        if secs > 0:
            rebuilt.append(name)
        return secs

    _build.build = counted
    clock = _Clock(cuda)
    for name in ("all_gather_dim", "reduce_scatter_dim", "all_reduce_"):
        setattr(collectives, name, clock.wrap(getattr(collectives, name)))
    ts.all_reduce_ = collectives.all_reduce_
    ts.all_gather_dim = collectives.all_gather_dim
    # the exchange (encode, all-to-alls or reduce-scatters, decode) and
    # the columns' all-gather
    shd._exchange = clock.wrap(shd._exchange)
    shd.all_gather_columns = clock.wrap(shd.all_gather_columns)
    try:
        cfg = get_config(spec["config"], **spec["overrides"])
        s = spec["seq"]
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        for name, mesh_kw, comm_kw, steps, fault in HYBRID_RUNS:
            mesh = build_mesh(MeshConfig(**mesh_kw))
            opt = _fsdp_tp_opt()
            comm = shd.CommConfig(bucket_mb=spec["bucket_mb"], **comm_kw)
            state = ts.init_train_state(spec["seed"], cfg, opt, device=dev,
                                        comm=comm, mesh=mesh)
            builder = ts.TrainStepBuilder(cfg, opt, device=dev, mesh=mesh,
                                          comm=comm)
            if not builder.update_sharding:
                raise RuntimeError(
                    f"{name}: update sharding did not resolve: "
                    f"{builder.update_sharding_reason}")
            undo = _plant_hybrid_fault(builder, fault) if fault else None
            plan = builder.plan
            held = sum(p.numel() for p in state["params"].parameters())
            rec = {"mesh": {k: v for k, v in mesh.shape.items() if v > 1},
                   "num_slices": mesh.num_slices, "wire": builder.wire,
                   "mesh_axes": list(plan.mesh_axes),
                   "plan_wire_bytes": shd.wire_bytes(plan, builder.wire),
                   "losses": [], "grad_norms": [], "step_s": [],
                   "collective_s": [], "collective_calls": [],
                   "wire_bytes": [], "launches": [],
                   # params and gradients (this rank's shards) and the
                   # moments (its dp columns), f32
                   "state_bytes": 8 * held + 8 * plan.shard_elems}
            for i in range(1, steps + 1):
                batch = dp_rows(_hybrid_batch(cfg, spec["seed"], i, s), mesh)
                _reset_train_launches()
                clock.seconds, clock.calls = 0.0, 0
                sent = shd.WIRE["bytes"]
                t = time.perf_counter()
                state, m = builder.step_fn(state, batch)
                loss, norm = float(m["loss"]), float(m["grad_norm"])
                if cuda:
                    torch.cuda.synchronize()
                rec["step_s"].append(time.perf_counter() - t)
                rec["launches"].append(_train_launches())
                rec["collective_s"].append(clock.seconds)
                rec["collective_calls"].append(clock.calls)
                rec["wire_bytes"].append(shd.WIRE["bytes"] - sent)
                rec["losses"].append(loss)
                rec["grad_norms"].append(norm)
            if undo:
                undo()
            out["runs"][name] = rec
            del state, builder
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
        out["peak_bytes"] = (torch.cuda.max_memory_allocated() if cuda
                             else None)
        out["rebuilt"] = len(rebuilt)
    finally:
        shutdown_distributed()
    with open(spec["out"].format(rank=rank), "w") as f:
        json.dump(out, f)


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def hybrid_check(cfg_name, seed, dev, name="hybrid_zero", overrides=None,
                 launch_overrides=()):
    """The hybrid_zero phase: llama-1.4b at full width and HYBRID_LAYERS
    layers, four ranks on card 0 over gloo, b``TRAIN_BATCH`` ×
    s``TRAIN_SEQ``:

    (a) ``train_gpt_elastic --hosts-per-slice 2 --zero1`` under the
        port's launcher (``_reshard_launch``, its trace on): the slice
        mesh dp 2 × fsdp 2, zero2, HYBRID_STEPS steps from the master's
        shard service; the ``zero.exchange`` spans give each rank's time
        in the exchange;
    (b) in ``hybrid_worker``'s processes: dp 2 × tp 2, zero1, then one
        planted-fault step on each mesh; (c) dp 4 over ``num_slices=4``
        with ``wire_dtype_dcn="int8"``, with ``wire_dtype="bfloat16"``,
        and HYBRID_F32_STEPS steps on the f32 wire, then one int8 step
        with a planted wire fault.

    Held to ``hybrid_reference``'s replicated run on the same global
    batches: (a) and (b) every rank's loss and grad norm of every step
    within HYBRID_RTOL_*, each fault outside; (c) within
    HYBRID_WIRE_RTOL and not the f32 stream, the wire fault outside. The
    bytes a rank sends a step equal the plan's count
    (``sharding.wire_bytes``); launches exact a rank a step; no kernel
    rebuilt; finite losses; the run (a) writes under 256 MiB to disk.
    ``overrides`` and ``launch_overrides`` (the same fields as the
    example's ``--override`` items) size a
    rehearsal."""
    from dlrover_tpu_torch.examples.train_gpt_elastic import launches
    from dlrover_tpu_torch.models.config import get_config
    from dlrover_tpu_torch.ops import flash_attention as fa

    overrides = (dict(n_layer=HYBRID_LAYERS) if overrides is None
                 else overrides)
    b, s = TRAIN_BATCH, TRAIN_SEQ
    cfg = get_config(cfg_name, **dict(overrides, max_seq=s))
    out_dir = os.path.join("build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    t_phase = time.monotonic()
    # (a): the example, through the launcher
    run_a, log_a = _reshard_launch(
        cfg, seed, dev.type, list(launch_overrides), HYBRID_STEPS,
        ["--hosts-per-slice", "2"],
        [sys.executable, "-m", "dlrover_tpu_torch.examples.train_gpt_elastic"],
        f"{name}_a", trace=True)
    # (b), (c): the worker
    spec = {"config": cfg_name, "seed": seed, "device": str(dev),
            "overrides": dict(overrides, max_seq=s), "seq": s,
            "bucket_mb": RESHARD_BUCKET_MB, "port": _free_port(),
            "out": os.path.join(out_dir, f"{name}_{{rank}}.json")}
    spec_path = os.path.join(out_dir, f"{name}_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    log_path = os.path.join(out_dir, f"{name}_log.txt")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    with open(log_path, "w") as log:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--hybrid-worker",
             spec_path, "--rank", str(r)], stdout=log,
            stderr=subprocess.STDOUT) for r in range(HYBRID_RANKS)]
        try:
            rcs = [p.wait(timeout=HYBRID_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    worker_s = time.monotonic() - t0
    if any(rcs):
        with open(log_path) as f:
            tail = f.read()[-6000:]
        _failures.append(f"{name}: worker exit codes {rcs}\n{tail}")
        emit({"phase": name, "ok": False, "exit_codes": rcs,
              "log_tail": tail, "run_a": run_a})
        return {"launches": {}}
    ranks = []
    for r in range(HYBRID_RANKS):
        with open(spec["out"].format(rank=r)) as f:
            ranks.append(json.load(f))
    t1 = time.monotonic()
    ref, ref_rec = hybrid_reference(cfg, seed, dev, HYBRID_STEPS, s)
    ref_rec["seconds"] = time.monotonic() - t1

    def steps_of(run):
        return {i + 1: {x["rank"]: {"loss": x["runs"][run]["losses"][i],
                                    "grad_norm":
                                        x["runs"][run]["grad_norms"][i]}
                        for x in ranks}
                for i in range(len(ranks[0]["runs"][run]["losses"]))}

    def errors(steps, tol=None):
        e = _stream_errors(steps, ref)
        tol = tol or {"loss": HYBRID_RTOL_LOSS, "grad_norm": HYBRID_RTOL_NORM}
        e["within"] = (e["loss"] is not None and e["loss"] <= tol["loss"]
                       and e["grad_norm"] <= tol["grad_norm"])
        return e

    per_step = {k: 0 for k in launches()}
    per_step.update({k: cfg.n_layer for k in fa.UNPACKED},
                    norm_fwd=2 * cfg.n_layer + 1, norm_bwd=2 * cfg.n_layer + 1)
    # (a) from the launcher's log and the workers' traces
    steps_a = _rank_steps(log_a)
    rank0 = {st: v[0]["at"] for st, v in steps_a.items() if 0 in v}
    gaps = [rank0[st] - rank0[st - 1] for st in range(3, HYBRID_STEPS + 1)
            if st in rank0 and st - 1 in rank0]
    spans = run_a.pop("exchange_spans", [])
    kernels_a = [json.loads(x) for x in re.findall(
        r"\[worker\] kernels (\{.*\})", log_a)]
    peaks_a = [int(x) for x in re.findall(
        r"\[worker\] done at step \d+ rank \d+ peak_bytes=(\d+)", log_a)]
    rec_a = {
        "command": run_a["command"], "seconds": run_a.get("seconds"),
        "launcher_rc": run_a.get("launcher_rc"),
        "disk_write_bytes": run_a.get("disk_write_bytes"),
        "left_behind": run_a["left_behind"],
        "mesh": "dp 2 x fsdp 2 (num_slices 2), zero2, f32 wire",
        "losses": [steps_a[st][0]["loss"] for st in sorted(steps_a)
                   if 0 in steps_a[st]],
        "grad_norms": [steps_a[st][0]["grad_norm"] for st in sorted(steps_a)
                       if 0 in steps_a[st]],
        "errors": errors(steps_a),
        "step_s": _median(gaps),
        "exchange_s_by_rank": [_median(x[1:]) for x in spans],
        "peak_bytes_by_rank": peaks_a,
        "launches": {k: sum(r["launches"].get(k, 0)
                            for v in steps_a.values() for r in v.values())
                     for k in launches()}}
    rec_a["exchange_share_by_rank"] = [
        x / rec_a["step_s"] if x is not None and rec_a["step_s"] else None
        for x in rec_a["exchange_s_by_rank"]]
    runs = {}
    for run, mesh_kw, comm_kw, steps, fault in HYBRID_RUNS:
        xs = [x["runs"][run] for x in ranks]
        tol = (HYBRID_WIRE_RTOL[xs[0]["wire"]]
               if xs[0]["wire"] in HYBRID_WIRE_RTOL else None)
        runs[run] = {
            "mesh": xs[0]["mesh"], "num_slices": xs[0]["num_slices"],
            "wire": xs[0]["wire"], "mesh_axes": xs[0]["mesh_axes"],
            "fault": fault, "losses": xs[0]["losses"],
            "grad_norms": xs[0]["grad_norms"],
            "errors": errors(steps_of(run), tol),
            "step_s_by_rank": [_median(x["step_s"][1:] or x["step_s"])
                               for x in xs],
            "collective_s_by_rank": [
                _median(x["collective_s"][1:] or x["collective_s"])
                for x in xs],
            "collective_calls_a_step": xs[0]["collective_calls"][-1],
            "wire_bytes_a_step": xs[0]["wire_bytes"],
            "plan_wire_bytes": xs[0]["plan_wire_bytes"],
            "state_bytes_by_rank": [x["state_bytes"] for x in xs]}
        runs[run]["collective_share"] = [
            c / t for c, t in zip(runs[run]["collective_s_by_rank"],
                                  runs[run]["step_s_by_rank"])]
    f32 = runs["f32"]

    def quantized(run):
        return any((a, b) != (c, d) for a, b, c, d in zip(
            runs[run]["losses"], runs[run]["grad_norms"], f32["losses"],
            f32["grad_norms"]))

    rec = {"phase": name, "config": cfg_name, "n_layer": cfg.n_layer,
           "d_model": cfg.d_model, "n_head": cfg.n_head, "batch": b,
           "seq": s, "steps": HYBRID_STEPS,
           "bucket_mb": RESHARD_BUCKET_MB,
           "backend": "gloo (host-staged), 4 ranks on cuda:0",
           "card": nvidia_smi_line() if dev.type == "cuda" else None,
           "reference": ref, "reference_run": ref_rec,
           "tolerances": {"a_b": {"loss": HYBRID_RTOL_LOSS,
                                  "grad_norm": HYBRID_RTOL_NORM},
                          "c": HYBRID_WIRE_RTOL},
           "a": rec_a, "runs": runs,
           "peak_bytes_by_rank": [x["peak_bytes"] for x in ranks],
           "group_s": [x["group_s"] for x in ranks], "worker_s": worker_s,
           "phase_s": time.monotonic() - t_phase,
           "launches": {k: rec_a["launches"][k] + sum(
               st.get(k, 0) for x in ranks for r in x["runs"].values()
               for st in r["launches"]) for k in launches()}}
    worker_launches = all({k: st.get(k, 0) for k in per_step} == per_step
                          for x in ranks for r in x["runs"].values()
                          for st in r["launches"])
    rec["checks"] = checks = {
        "a_launcher_rc_0": run_a.get("launcher_rc") == 0,
        "a_slice_mesh": log_a.count(
            "[worker] slice mesh: num_slices=2 dp=2 fsdp=2") == HYBRID_RANKS,
        "a_matches_replicated": sorted(steps_a) == list(
            range(1, HYBRID_STEPS + 1)) and all(
            sorted(v) == list(range(HYBRID_RANKS))
            for v in steps_a.values()) and rec_a["errors"]["within"],
        "b_matches_replicated": runs["tp"]["errors"]["within"],
        "faults_caught": not runs["fault_fsdp"]["errors"]["within"]
        and not runs["fault_tp"]["errors"]["within"],
        "wire_fault_caught": not runs["fault_wire"]["errors"]["within"]
        and runs["fault_wire"]["wire"] == "int8",
        "c_within_bound": runs["int8"]["errors"]["within"]
        and runs["bf16"]["errors"]["within"]
        and runs["int8"]["wire"] == "int8"
        and runs["bf16"]["wire"] == "bfloat16",
        "c_quantized": quantized("int8") and quantized("bf16")
        and f32["errors"]["within"],
        "wire_bytes_exact": all(
            b == x["runs"][run]["plan_wire_bytes"] for x in ranks
            for run in x["runs"] for b in x["runs"][run]["wire_bytes"]),
        "finite": all(math.isfinite(v) for v in rec_a["losses"])
        and all(math.isfinite(v) for r in runs.values()
                for v in r["losses"]),
        "launches_exact": all(r["launches"] == per_step
                              for v in steps_a.values()
                              for r in v.values()) and worker_launches,
        "no_rebuild": all(x["rebuilt"] == 0 for x in ranks)
        and len(kernels_a) == HYBRID_RANKS
        and all(k["compiled_s"] == 0 for k in kernels_a),
        "a_no_disk": run_a.get("disk_write_bytes", 1 << 62) < (256 << 20),
        "nothing_left_behind": run_a["left_behind"] == [],
    }
    rec["ok"] = all(checks.values())
    emit(rec)
    if not rec["ok"]:
        _failures.append(f"{name}: {[k for k, v in checks.items() if not v]}"
                         f" a {rec_a['errors']} "
                         + str({k: r["errors"] for k, r in runs.items()}))
    return rec


# ---------------------------------------------------------------------------
# phase 15: sp with fsdp and tp, and tp over a head count it does not
# divide, four ranks on the one card
# ---------------------------------------------------------------------------

MESH4D_RANKS = 4
MESH4D_LAYERS = 2
# a run's bf16 steps (launches, times), f32 gate steps and fault steps
MESH4D_STEPS, MESH4D_F32_STEPS, MESH4D_FAULT_STEPS = 2, 2, 1
MESH4D_TIMEOUT_S = 540
# every rank's f32 loss and grad norm against the one-process replicated
# f32 run on the same global batches, relative: the fsdp_tp bound
MESH4D_RTOL_LOSS, MESH4D_RTOL_NORM = 1e-4, 1e-4
#: the runs: config (full width, MESH4D_LAYERS layers), mesh, global
#: batch (B, S), attn_impl, whether through ``Trainer``, planted fault
MESH4D_RUNS = {
    "a": dict(config="mistral-7b", mesh={"sp": 2, "tp": 2}, shape=[1, 8192],
              attn_impl="ring", trainer=True, fault="kv_no_sp"),
    "b": dict(config="gpt2-1.5b", mesh={"fsdp": 2, "tp": 2},
              shape=[8, 1024], attn_impl="auto", trainer=False,
              fault="reshard_drop"),
}
MESH4D_FAULTS = {
    "kv_no_sp": "the wk/wv gradients not summed over sp",
    "reshard_drop": "the q columns' move to the heads, its backward "
                    "dropping the straddling head's half returned to "
                    "another rank",
}
#: the leaves of the kv_no_sp fault. Not the norm scales: at d 4096 they
#: hold too small a share of the gradient's square norm for their missing
#: sp sum to move the grad norm past MESH4D_RTOL_NORM
#: (tests/test_torch_mesh4d.py plants that one at test size)
MESH4D_KV = ("layers/attn/wk", "layers/attn/wv")


def mesh4d_shape_cases(gen, dev):
    """The kernels at the shapes a rank of the mesh4d phase launches them
    that no earlier case covers, each against its plain version with its
    planted fault: (a) mistral-7b on sp 2 × tp 2, a rank's 16 query and
    4 KV heads over a 4096 block, window 4096: the diagonal block and
    sp rank 1's window-partial block against rank 0's (the offsets),
    its rmsnorm rows ([4096, 4096], plain and with the residual); (b)
    gpt2-1.5b on fsdp 2 × tp 2, a rank's 4 rows and its 13 or 12 heads
    of 64 (the packed kernels; 13: the last pack one head), its
    layernorm rows ([4096, 1600], plain and with the residual)."""
    return [
        flash_case("mistral-7b-sp2tp2-diagonal", 1, 4096, 16, 4, 128, True,
                   4096, gen, dev, False),
        flash_case("mistral-7b-sp2tp2-boundary", 1, 4096, 16, 4, 128, True,
                   4096, gen, dev, False, offsets=(4096, 0), fault="k_off"),
        flash_case("gpt2-1.5b-tp2-13", 4, 1024, 13, 13, 64, True, 0, gen,
                   dev, False, pack=2, fault="last_pack"),
        flash_case("gpt2-1.5b-tp2-12", 4, 1024, 12, 12, 64, True, 0, gen,
                   dev, False, pack=2),
        norm_case("mistral-7b-sp2tp2", 4096, 4096, False, gen, dev, False),
        norm_case("mistral-7b-sp2tp2+residual", 4096, 4096, True, gen, dev,
                  False),
        norm_case("gpt2-1.5b-fsdp2tp2", 4096, 1600, False, gen, dev, False,
                  "layernorm"),
        norm_case("gpt2-1.5b-fsdp2tp2+residual", 4096, 1600, True, gen, dev,
                  False, "layernorm"),
    ]


def _mesh4d_batch(cfg, seed, run, step, b, s):
    """Run ``run``'s global batch of step ``step``: the same for every
    rank and for the reference."""
    return _fsdp_tp_batch(cfg, seed + 1000 * (ord(run) - ord("a") + 1),
                          step, b, s)


def _mesh4d_cfg(conf, overrides, s, dtype=None):
    from dlrover_tpu_torch.models.config import get_config

    over = dict(n_layer=MESH4D_LAYERS, max_seq=s, **overrides)
    if dtype:
        over["dtype"] = dtype
    return get_config(conf["config"], **over)


def _mesh4d_expected(cfg, sizes, s, rank):
    """(launches, offset launches) of the flash and norm kernels a step on
    ``rank``: its heads from its ``TpPlan`` (the pack as the kernels pick
    it); under sp the ring's block map (``sequence.block_case``): each
    live block its forward and, in the backward, its recompute, dq and
    dkv; without sp one of each a layer (none for a rank with no heads).
    Each norm kernel 2 · layers + 1 times."""
    from dlrover_tpu_torch.models import decoder
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.parallel import sequence
    from dlrover_tpu_torch.parallel.mesh import Mesh

    plan = decoder.tp_plan(cfg, Mesh(sizes, rank), "cpu")
    heads, kv = ((plan.heads, plan.kv_heads) if plan is not None
                 else (cfg.n_head, cfg.kv_heads))
    pack = fa.head_pack_for(heads, kv, cfg.head_dim, cfg.attn_head_pack)
    fwd, dq, dkv = fa.PACKED if pack == 2 else fa.UNPACKED
    sp = sizes["sp"]
    per, off = {}, {}
    if sp > 1:
        s_l, c = s // sp, Mesh(sizes, rank).coord("sp")
        blocks = [sequence.block_case(c * s_l, ((c - i) % sp) * s_l, s_l,
                                      s_l, cfg.causal, cfg.attn_window)
                  for i in range(sp)]
        live = sum(x != sequence.EMPTY for x in blocks)
        shifted = sum(x == sequence.WINDOW_PARTIAL for x in blocks)
        per = {fwd: 2 * live, dq: live, dkv: live}
        off = {fwd: 2 * shifted, dq: shifted, dkv: shifted}
    elif heads:
        per = {fwd: 1, dq: 1, dkv: 1}
    launches = {k: cfg.n_layer * per.get(k, 0) for k in fa.KERNELS}
    launches.update(norm_fwd=2 * cfg.n_layer + 1,
                    norm_bwd=2 * cfg.n_layer + 1)
    return launches, {k: cfg.n_layer * off.get(k, 0) for k in fa.KERNELS}


@contextlib.contextmanager
def _mesh4d_fault(fault, builder, cols):
    """A run's planted fault while the block runs (``MESH4D_FAULTS``):
    ``kv_no_sp`` drops sp from ``wk``'s and ``wv``'s ``reduce_axes``;
    ``reshard_drop`` zeroes, in the backward of the q columns' move to
    the heads (``collectives.tp_reshard`` from ``cols``), the gradient
    a rank returns to another."""
    import torch.distributed as dist

    from dlrover_tpu_torch.parallel import collectives

    if fault is None:
        yield
        return
    if fault == "kv_no_sp":
        for n, shard in builder.layout.items():
            if shard.path in MESH4D_KV:
                builder.reduce_axes[n] = tuple(
                    a for a in builder.reduce_axes[n] if a != "sp")
        yield
        return
    real = collectives._TpReshard.backward

    def backward(ctx, g):
        src, dst, group = ctx.args
        if src == cols:
            r = dist.get_rank(group)
            at = torch.arange(*dst[r], device=g.device)
            own = (at >= src[r][0]) & (at < src[r][1])
            g = torch.where(own, g, torch.zeros_like(g))
        return real(ctx, g)

    collectives._TpReshard.backward = staticmethod(backward)
    try:
        yield
    finally:
        collectives._TpReshard.backward = staticmethod(real)


def _mesh4d_steps(run, conf, spec, rank, dev, dtype, steps, fault):
    """``steps`` steps of one run on this rank, through ``Trainer`` or
    ``TrainStepBuilder`` as the run says, each on this rank's rows of
    the global batch, with the launches and the wall s read around each
    step; ``dtype`` float32 for the gate and fault runs, None for the
    config's bf16."""
    from dlrover_tpu_torch.models import decoder
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.parallel.mesh import Mesh, MeshConfig, build_mesh
    from dlrover_tpu_torch.train import train_step as ts
    from dlrover_tpu_torch.train.data_utils import dp_rows

    cuda = dev.type == "cuda"
    b, s = conf["shape"]
    cfg = _mesh4d_cfg(conf, spec["overrides"].get(run, {}), s, dtype)
    mesh_cfg = MeshConfig(**conf["mesh"])
    layout = Mesh(mesh_cfg.resolved_sizes(MESH4D_RANKS), rank)
    plan = decoder.tp_plan(cfg, layout, "cpu")
    batches = [dp_rows(_mesh4d_batch(cfg, spec["seed"], run, i, b, s),
                       layout) for i in range(1, steps + 1)]
    opt = _fsdp_tp_opt()
    rec = {"losses": [], "grad_norms": [], "step_s": [], "launches": [],
           "offset_launches": []}

    def timed(step_fn):
        def step(state, batch):
            _reset_train_launches()
            t = time.perf_counter()
            state, m = step_fn(state, batch)
            loss, norm = float(m["loss"]), float(m["grad_norm"])
            if cuda:
                torch.cuda.synchronize()
            rec["step_s"].append(time.perf_counter() - t)
            rec["launches"].append(_train_launches())
            rec["offset_launches"].append(dict(fa.OFFSET_LAUNCHES))
            rec["losses"].append(loss)
            rec["grad_norms"].append(norm)
            return state, m
        return step

    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cols = plan.cols if plan is not None else None
    if conf["trainer"]:
        from dlrover_tpu_torch.train.trainer import Trainer, TrainerArgs

        args = TrainerArgs(
            output_dir=os.path.join(spec["out_dir"], f"trainer_{rank}"),
            max_steps=steps, save_interval=0, log_interval=0, resume=False,
            detect_loss_spikes=False, report_to_master=False,
            seed=spec["seed"], attn_impl=conf["attn_impl"])
        t = Trainer(cfg, args, batches, opt, mesh=mesh_cfg, device=dev)
        t._step_fn = timed(t._builder.build())
        with _mesh4d_fault(fault, t._builder, cols):
            t.train()
        state, mesh = t.state, t.mesh
        del t
    else:
        mesh = build_mesh(mesh_cfg)
        state = ts.init_train_state(spec["seed"], cfg, opt, device=dev,
                                    mesh=mesh)
        builder = ts.TrainStepBuilder(cfg, opt, attn_impl=conf["attn_impl"],
                                      device=dev, mesh=mesh)
        step = timed(builder.step_fn)
        with _mesh4d_fault(fault, builder, cols):
            for batch in batches:
                state, _ = step(state, batch)
        del builder
    rec.update(mesh=dict(mesh.shape), state_bytes=_state_bytes(
        state["params"]), peak_bytes=(torch.cuda.max_memory_allocated()
                                      if cuda else None),
               heads=None if plan is None else [plan.mode, plan.heads,
                                                plan.kv_heads])
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return rec


def mesh4d_worker(spec_path, rank):
    """One rank of the mesh4d phase (a subprocess of ``mesh4d_check``): a
    gloo group of MESH4D_RANKS ranks on card 0; for each run of
    MESH4D_RUNS its f32 gate steps, its fault steps and its bf16 steps.
    Writes its record."""
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.train.distributed import (
        init_distributed,
        shutdown_distributed,
    )

    spec = json.loads(open(spec_path).read())
    dev = torch.device(spec["device"])
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.monotonic()
    init_distributed(coordinator=f"127.0.0.1:{spec['port']}",
                     world_size=MESH4D_RANKS, rank=rank, device=dev.type,
                     backend="gloo", device_index=0 if cuda else None,
                     timeout_s=MESH4D_TIMEOUT_S)
    out = {"rank": rank, "group_s": time.monotonic() - t0, "runs": {}}
    rebuilt = []
    real_build = _build.build

    def counted(name):  # a compile here would have cost the phase minutes
        secs = real_build(name)
        if secs > 0:
            rebuilt.append(name)
        return secs

    _build.build = counted
    try:
        for run, conf in spec["runs"].items():
            out["runs"][run] = {
                "f32": _mesh4d_steps(run, conf, spec, rank, dev, "float32",
                                     MESH4D_F32_STEPS, None),
                "fault": _mesh4d_steps(run, conf, spec, rank, dev,
                                       "float32", MESH4D_FAULT_STEPS,
                                       conf["fault"]),
                "bf16": _mesh4d_steps(run, conf, spec, rank, dev, None,
                                      MESH4D_STEPS, None)}
        out["rebuilt"] = len(rebuilt)
    finally:
        shutdown_distributed()
    with open(spec["out"].format(rank=rank), "w") as f:
        json.dump(out, f)


def mesh4d_reference(run, conf, seed, dev, overrides=None):
    """The one-process replicated f32 stream run ``run`` is held to: each
    step's global batch in one micro-batch a data rank (dp × fsdp), the
    same init (every layout draws the same global weights). Returns
    ([(loss, grad_norm)] a step, the state's bytes)."""
    from dlrover_tpu_torch.train.train_step import (
        TrainStepBuilder,
        init_train_state,
    )

    b, s = conf["shape"]
    cfg = _mesh4d_cfg(conf, overrides or {}, s, "float32")
    opt = _fsdp_tp_opt()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    state = init_train_state(seed, cfg, opt, device=dev)
    accum = conf["mesh"].get("dp", 1) * conf["mesh"].get("fsdp", 1)
    step = TrainStepBuilder(cfg, opt, grad_accum=accum, device=dev).build()
    out = []
    for i in range(1, MESH4D_F32_STEPS + 1):
        state, m = step(state, _mesh4d_batch(cfg, seed, run, i, b, s))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    nbytes = _state_bytes(state["params"])
    del state, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out, nbytes


def mesh4d_check(seed, dev, name="mesh4d", overrides=None, shapes=None):
    """The mesh4d phase: MESH4D_RANKS worker processes on card 0 over gloo
    (``mesh4d_worker``) run (a) mistral-7b at full width and
    MESH4D_LAYERS layers on ``Trainer(mesh=MeshConfig(sp=2, tp=2))``,
    ring attention, b1 × s8192 (sp rank 1's window-partial block carries
    the offsets), and (b) gpt2-1.5b at full width and MESH4D_LAYERS
    layers on ``MeshConfig(fsdp=2, tp=2)``, b8 × s1024 (each tp rank's
    800 ``wq`` columns, 12.5 heads, moved to its 13 or 12 whole heads:
    K1p/K2p); then, in this process, each run's one-process replicated
    f32 reference. Gated, each run: every rank's f32 loss and grad norm
    within MESH4D_RTOL_* of the reference, its planted fault outside,
    finite bf16 losses, exact launches a rank a bf16 step (the offset
    ones too), no kernel rebuilt. Records each rank's bf16 step wall s,
    peak memory and state bytes. Writes nothing but its log and
    records under ``build/chip_smoke``. ``overrides`` ({run: config
    overrides}) and ``shapes`` ({run: [B, S]}) size a rehearsal."""
    runs = {k: dict(v, shape=(shapes or {}).get(k, v["shape"]))
            for k, v in MESH4D_RUNS.items()}
    overrides = overrides or {}
    out_dir = os.path.join("build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    spec = {"runs": runs, "seed": seed, "device": str(dev),
            "overrides": overrides, "port": _free_port(), "out_dir": out_dir,
            "out": os.path.join(out_dir, f"{name}_{{rank}}.json")}
    spec_path = os.path.join(out_dir, f"{name}_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    log_path = os.path.join(out_dir, f"{name}_log.txt")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    with open(log_path, "w") as log:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh4d-worker",
             spec_path, "--rank", str(r)], stdout=log,
            stderr=subprocess.STDOUT) for r in range(MESH4D_RANKS)]
        try:
            rcs = [p.wait(timeout=MESH4D_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    seconds = time.monotonic() - t0
    if any(rcs):
        with open(log_path) as f:
            tail = f.read()[-6000:]
        _failures.append(f"{name}: worker exit codes {rcs}\n{tail}")
        emit({"phase": name, "ok": False, "exit_codes": rcs,
              "log_tail": tail})
        return {"launches": {}, "offset_launches": {}}
    ranks = []
    for r in range(MESH4D_RANKS):
        with open(spec["out"].format(rank=r)) as f:
            ranks.append(json.load(f))

    def median(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2]

    rec = {"phase": name, "backend": "gloo (host-staged), 4 ranks on cuda:0",
           "card": nvidia_smi_line() if dev.type == "cuda" else None,
           "tolerances": {"loss": MESH4D_RTOL_LOSS,
                          "grad_norm": MESH4D_RTOL_NORM},
           "workers_s": seconds, "group_s": [x["group_s"] for x in ranks],
           "runs": {}, "launches": {}, "offset_launches": {}}
    checks = {"no_rebuild": all(x["rebuilt"] == 0 for x in ranks)}
    t1 = time.monotonic()
    for run, conf in runs.items():
        b, s = conf["shape"]
        ref, ref_bytes = mesh4d_reference(run, conf, seed, dev,
                                          overrides.get(run))
        got = [x["runs"][run] for x in ranks]

        def errors(key):
            steps = {i + 1: {r: {"loss": g[key]["losses"][i],
                                 "grad_norm": g[key]["grad_norms"][i]}
                             for r, g in enumerate(got)}
                     for i in range(len(got[0][key]["losses"]))}
            e = _stream_errors(steps, ref)
            e["within"] = (e["loss"] is not None
                           and e["loss"] <= MESH4D_RTOL_LOSS
                           and e["grad_norm"] <= MESH4D_RTOL_NORM)
            return e

        cfg = _mesh4d_cfg(conf, overrides.get(run, {}), s)
        sizes = {a: 1 for a in ("dp", "pp", "ep", "fsdp", "sp", "tp")}
        sizes.update(conf["mesh"])
        want = [_mesh4d_expected(cfg, sizes, s, r)
                for r in range(MESH4D_RANKS)]
        bf = [g["bf16"] for g in got]
        run_rec = {
            "config": conf["config"], "n_layer": cfg.n_layer,
            "d_model": cfg.d_model, "n_head": cfg.n_head,
            "n_kv_head": cfg.kv_heads, "mesh": conf["mesh"], "batch": b,
            "seq": s, "attn_impl": conf["attn_impl"],
            "through": "Trainer" if conf["trainer"] else "TrainStepBuilder",
            "steps": {"bf16": MESH4D_STEPS, "f32": MESH4D_F32_STEPS,
                      "fault": MESH4D_FAULT_STEPS},
            "heads_by_rank": [g["bf16"]["heads"] for g in got],
            "reference": ref, "errors": errors("f32"),
            "fault": {"what": MESH4D_FAULTS[conf["fault"]],
                      "errors": errors("fault")},
            "bf16_losses": bf[0]["losses"],
            "step_s_by_rank": [x["step_s"][-1] for x in bf],
            "peak_bytes_by_rank": [x["peak_bytes"] for x in bf],
            "state_bytes_by_rank": [x["state_bytes"] for x in bf],
            "reference_state_bytes": ref_bytes,
            "launches_a_step_by_rank": [x["launches"][-1] for x in bf],
            "offset_launches_a_step_by_rank": [x["offset_launches"][-1]
                                               for x in bf]}
        run_rec["checks"] = {
            "mesh": all({k: v for k, v in g[key]["mesh"].items() if v > 1}
                        == conf["mesh"] for g in got
                        for key in ("f32", "fault", "bf16")),
            "matches_replicated": run_rec["errors"]["within"],
            "fault_caught": not run_rec["fault"]["errors"]["within"],
            "finite": all(math.isfinite(v) for x in bf for v in x["losses"]),
            "launches_exact": all(
                step == want[r][0] and off == want[r][1]
                for r, x in enumerate(bf)
                for step, off in zip(x["launches"], x["offset_launches"])),
            "offsets_ran": (conf["mesh"].get("sp", 1) == 1 or any(
                sum(off.values()) for x in bf
                for off in x["offset_launches"])),
        }
        checks.update({f"{run}_{k}": v
                       for k, v in run_rec["checks"].items()})
        rec["runs"][run] = run_rec
        for x in bf:
            for step in x["launches"]:
                for k, n in step.items():
                    rec["launches"][k] = rec["launches"].get(k, 0) + n
            for off in x["offset_launches"]:
                for k, n in off.items():
                    rec["offset_launches"][k] = (
                        rec["offset_launches"].get(k, 0) + n)
    rec["reference_s"] = time.monotonic() - t1
    rec["phase_s"] = time.monotonic() - t0
    rec["checks"] = checks
    rec["ok"] = all(checks.values())
    emit(rec)
    if not rec["ok"]:
        _failures.append(f"{name}: {[k for k, v in checks.items() if not v]}"
                         f" {[r['errors'] for r in rec['runs'].values()]}")
    return rec


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--zero-fault-worker"]:  # a rank of the fault run
        return zero_fault_worker(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sp-worker", default=None,
                    help="run one rank of an sp phase (internal)")
    ap.add_argument("--fsdp-tp-worker", default=None,
                    help="run one rank of the fsdp_tp phase (internal)")
    ap.add_argument("--hybrid-worker", default=None,
                    help="run one rank of the hybrid_zero phase (internal)")
    ap.add_argument("--mesh4d-worker", default=None,
                    help="run one rank of the mesh4d phase (internal)")
    ap.add_argument("--rank", type=int, default=0)
    args = ap.parse_args(argv)
    if args.sp_worker:  # on the device its spec names
        sp_worker(args.sp_worker, args.rank)
        return 0
    if args.fsdp_tp_worker:
        fsdp_tp_worker(args.fsdp_tp_worker, args.rank)
        return 0
    if args.hybrid_worker:
        hybrid_worker(args.hybrid_worker, args.rank)
        return 0
    if args.mesh4d_worker:
        mesh4d_worker(args.mesh4d_worker, args.rank)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from dlrover_tpu_torch.models import decoder
    from dlrover_tpu_torch.models.config import get_config
    from dlrover_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    emit({"phase": "device", "kind": kind, "count": count,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    with phase("build"):
        build_all()
    with phase("library"):
        library_check(args.seed, dev)
    if _failures:
        print("\n".join(_failures), file=sys.stderr)
        return 1

    cfg = get_config("llama3-8b")
    cases = []
    with phase("kernel"):
        cases = kernel_cases(cfg, args.seed, dev)
        cases += verify_cases(cfg, args.seed, dev)
    with phase("model_init"):
        t0 = time.monotonic()
        model = decoder.init(cfg, seed=args.seed, device=dev)
        torch.cuda.synchronize()
        emit({"phase": "model_init", "config": cfg.name,
              "n_layer": cfg.n_layer, "d_model": cfg.d_model,
              "params": sum(p.numel() for p in model.parameters()),
              "seconds": time.monotonic() - t0})
    if _failures:
        print("\n".join(_failures), file=sys.stderr)
        return 1
    with phase("model"):
        model_check(model, cfg, args.seed, dev)
    with phase("model_f32"):
        cfg32 = get_config("llama3-8b", n_layer=F32_CHECK_LAYERS,
                           dtype="float32")
        model32 = decoder.init(cfg32, seed=args.seed, device=dev)
        model_check(model32, cfg32, args.seed, dev)
        del model32
    rng = np.random.default_rng(args.seed + 3)
    lengths = rng.integers(64, 1537, size=16)
    main_launches = {}
    with phase("serve"):
        rec = serve(model, cfg, args.seed, dev, "int8", 16, lengths)
        main_launches = rec["launches"]
    with phase("serve_bf16"):
        serve(model, cfg, args.seed, dev, "bf16", 4, lengths)
    with phase("spec_serve"):
        main_launches["verify"] = spec_serve(model, cfg, args.seed, dev,
                                             False)["verify"]
    with phase("prefix_serve"):
        prefix_serve(model, cfg, args.seed, dev, False)
    with phase("profile"):
        profile_steps(model, cfg, args.seed, dev)
    del model
    torch.cuda.empty_cache()
    # the gated spec/prefix checks: llama3-8b at full width and depth in
    # f32, where spec-on and spec-off differ by f32 rounding only
    with phase("serve_f32"):
        cfg32 = get_config("llama3-8b", dtype="float32")
        model32 = decoder.init(cfg32, seed=args.seed, device=dev)
        spec_serve(model32, cfg32, args.seed, dev, True)
        prefix_serve(model32, cfg32, args.seed, dev, True)
    model32 = None
    torch.cuda.empty_cache()

    train_cases = []
    with phase("train_kernel"):
        train_cases = train_kernel_cases(args.seed, dev)
    with phase("train_model"):
        train_model_check(get_config("llama-1.4b", n_layer=F32_CHECK_LAYERS,
                                     dtype="float32"), args.seed, dev)
    torch.cuda.empty_cache()
    with phase("train_model_gpt2"):
        train_model_check(get_config("gpt2-1.5b", n_layer=F32_CHECK_LAYERS,
                                     dtype="float32"), args.seed, dev,
                          "train_model_gpt2")
    torch.cuda.empty_cache()
    with phase("train_model_glm"):
        train_model_check(get_config("glm-10b", n_layer=GLM_LAYERS,
                                     dtype="float32"), args.seed, dev,
                          "train_model_glm", b=GLM_CHECK_BATCH,
                          prefix=(317, 700))
    torch.cuda.empty_cache()
    # the main training paths: llama-1.4b (unpacked flash kernels, rmsnorm)
    # and gpt2-1.5b (packed flash kernels, layernorm with bias), each at
    # full width and depth; their launches, read right after each run
    train_launches = {}
    for name, cfg_name in (("train", "llama-1.4b"), ("train_gpt2",
                                                     "gpt2-1.5b")):
        state = None
        cfg = get_config(cfg_name)
        with phase(name):
            state, step, batch, rec, opt = train_run(cfg, args.seed, dev,
                                                     name)
            train_launches[name] = rec["launches"]
        if state is not None:
            with phase(name + "_profile"):
                train_profile(state, step, batch, cfg, opt,
                              name + "_profile")
        del state
        step = batch = opt = None
        torch.cuda.empty_cache()
    # glm-10b at full width, 4 layers, bf16, with a prefix per sequence
    with phase("train_glm"):
        rng = np.random.default_rng(args.seed + 7)
        train_run(get_config("glm-10b", n_layer=GLM_LAYERS), args.seed, dev,
                  "train_glm", steps=GLM_STEPS, falling=False,
                  prefix=[int(p) for p in rng.integers(
                      0, TRAIN_SEQ + 1, size=TRAIN_BATCH)])
    torch.cuda.empty_cache()
    # the Trainer with Flash Checkpoint, llama-1.4b at full width
    trainer_rec = None
    with phase("trainer"):
        trainer_rec = trainer_check(
            get_config("llama-1.4b", n_layer=TRAINER_LAYERS), args.seed, dev)
        train_launches["trainer"] = trainer_rec["launches"]
    # the elastic control plane: the launcher, agent and a crashed worker
    # restarted, llama-1.4b at full size in the worker; this process
    # frees its cached card memory first
    gc.collect()
    torch.cuda.empty_cache()
    if trainer_rec is not None:
        with phase("elastic"):
            rec = elastic_check(get_config("llama-1.4b"), args.seed,
                                trainer_rec)
            train_launches["elastic"] = rec["launches"]
    # the live reshard: four ranks on this card over gloo, ZeRO update
    # sharding, two ranks evicted mid-run
    gc.collect()
    torch.cuda.empty_cache()
    with phase("reshard"):
        rec = reshard_check(get_config("llama-1.4b",
                                       n_layer=RESHARD_LAYERS), args.seed)
        train_launches["reshard"] = rec["launches"]
    # sequence parallelism (sp 4, four ranks on this card over gloo):
    # mistral-7b over the ring (window-partial blocks: the offsets) and
    # Ulysses, glm-10b over the ring (prefix-only blocks)
    gc.collect()
    torch.cuda.empty_cache()
    sp_recs = {}
    with phase("sp_mistral"):
        sp_recs.update(sp_check("mistral-7b", ("ring", "auto"),
                                {"ring": "ring", "auto": "ulysses"},
                                args.seed, dev))
    with phase("sp_glm"):
        sp_recs.update(sp_check("glm-10b", ("ring",), {"ring": "ring_glm"},
                                args.seed, dev))
    # fsdp x tp (fsdp 2, tp 2: four ranks on this card over gloo),
    # llama-1.4b at full width
    gc.collect()
    torch.cuda.empty_cache()
    with phase("fsdp_tp"):
        rec = fsdp_tp_check("llama-1.4b", args.seed, dev)
        train_launches["fsdp_tp"] = rec["launches"]
    # hybrid sharded data parallelism and the gradient wires (four ranks
    # on this card over gloo): the example's --hosts-per-slice 2 --zero1,
    # dp 2 x tp 2 ZeRO, dp 4 over four slices on the int8 and bf16 wires
    gc.collect()
    torch.cuda.empty_cache()
    with phase("hybrid_zero"):
        rec = hybrid_check("llama-1.4b", args.seed, dev)
        train_launches["hybrid_zero"] = rec["launches"]
    # sp with tp (mistral-7b, sp 2 x tp 2, the ring through Trainer) and
    # tp over 25 heads (gpt2-1.5b, fsdp 2 x tp 2), four ranks on this card
    # over gloo
    gc.collect()
    torch.cuda.empty_cache()
    offset_launches = {}
    with phase("mesh4d"):
        rec = mesh4d_check(args.seed, dev)
        train_launches["mesh4d"] = rec["launches"]
        offset_launches.update(rec["offset_launches"])
    for name, rec in sp_recs.items():
        for r, x in enumerate(rec["ranks"]):
            train_launches[f"{name}_rank{r}"] = x["launches"]
            for k, n in x["offset_launches"].items():
                offset_launches[k] = offset_launches.get(k, 0) + n
    if _failures:
        print("\n".join(_failures), file=sys.stderr)
        return 1

    kernels = []
    for kernel in pa.KERNELS:
        name = f"paged_attention.{kernel}"
        mine = [c for c in cases if c["kernel"] == name]
        # the timed case over int8 pools without a window: decode B 8
        # ragged to 2047, chunk B 1 x C 256 at 1536, verify B 8 x C 5
        head = next(c for c in mine if c["mode"] == "int8"
                    and not c["window"] and "ms" in c
                    and c["B"] == (1 if kernel == "chunk" else 8))
        kernels.append({
            "name": name, "kernel": head["cuda_kernel"], "route": "cuda",
            "source": PAGED_SRC, "replaces": PAGED_REPLACES,
            "launches": main_launches[kernel],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
        })
        if kernel == "chunk":  # the split walk: its splits, bytes, share
            kernels[-1].update(splits=head["splits"], bytes=head["bytes"],
                               bound_share=head["bound_ms"] / head["ms"])
    outputs = {"fwd": ("out", "lse"), "bwd_dq": ("dq",),
               "bwd_dkv": ("dk", "dv"), "norm_fwd": ("out",),
               "norm_bwd": ("dx",)}
    for kernel, src, replaces, cuda_kernel in TRAIN_KERNELS:
        mine = [c for c in train_cases if kernel in c["kernels"]]
        # the timed case at the train step's shapes (the first of its
        # kernel: llama-1.4b's for the unpacked flash kernels and the
        # norms, gpt2-1.5b's for the packed)
        t = next(c for c in mine if "timing" in c)["timing"][kernel]
        out_key = kernel.replace("flash_", "").replace("_packed", "")
        kernels.append({
            "name": kernel, "kernel": cuda_kernel, "route": "cuda",
            "source": src, "replaces": replaces,
            "launches": sum(n[kernel] for n in train_launches.values()),
            "max_abs_err": max(c["max_abs_err"][o] for c in mine
                               for o in outputs[out_key]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
        if kernel == "flash_fwd":  # K1: its bytes, the share of its bound
            kernels[-1].update(bytes=t["bytes"],
                               bound_share=t["bound_ms"] / t["ms"])
        # the same kernel with ring offsets (a window-partial or
        # prefix-only block), timed beside itself without them
        shifted = [c for c in mine if c.get("offsets") is not None]
        if not shifted:
            continue
        t = next(c for c in shifted if "timing" in c)["timing"][kernel]
        kernels.append({
            "name": kernel + "+offsets", "kernel": cuda_kernel,
            "route": "cuda", "source": src, "replaces": replaces,
            "launches": offset_launches.get(kernel, 0),
            "max_abs_err": max(c["max_abs_err"][o] for c in shifted
                               for o in outputs[out_key]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "no_offsets_ms": t["no_offsets_ms"]})
    emit({"phase_seconds": _phase_seconds,
          "total_s": time.monotonic() - _START})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
