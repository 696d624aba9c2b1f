#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``dlrover_tpu_torch``) on one card.

Drives the port's main paths with random weights drawn on the card
from ``--seed``, through the hand-written CUDA kernels built from
``dlrover_tpu_torch/csrc/``:

- serving: ``GenerationServer`` → ``Scheduler`` → ``ServingEngine`` →
  ``Decoder`` paged prefill/decode → ``ops.paged_attention``, with
  llama3-8b at full width and depth; then with speculative decoding
  (``spec_k=4``: ``Decoder.verify_chunk_paged`` → the kernel's verify
  variant) and prefix sharing; then a disaggregated fleet (prefill and
  decode replicas behind ``ReplicaRouter``, live KV-page migration,
  the serving autoscaler);
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
  batches from the master's data-shard service; then two nodes'
  launchers under a standalone master, one of the nodes lost to a card
  fault, diagnosed, relaunched and restored from its peer's memory (the
  replica ring), its batches from the elastic sampler; then four ranks of the
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
  its whole heads and back), four ranks on the card;
- the master's planning loop: a Brain process, the launcher's local
  master in cluster mode (``JobAutoScaler`` over a ``BrainClient``), the
  elastic worker's ``ElasticTrainer`` loop grown from one node to two on
  the card by the auto-scaler's ``ScalePlan``, and a Brain tuning
  revision applied at a step boundary (``autoscale_check``).

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
   fleet: the disaggregated fleet in bf16 (``fleet_serve``: a port
   master in-process, 1 prefill + 2 decode ``ServingReplica``s sharing
   the model behind a ``ReplicaRouter`` with the handoff coordinator and
   a ``ServingMigrator``): spec_serve's 16 requests, a decode replica
   killed holding 4 slots mid-decode and migrated live, the serving
   autoscaler scaling the prefill pool out onto a warm replica and in
   again, a decode replica retuned to spec_k=4; by role tokens/s, TTFT,
   TPOT, handoff ms and rates, the migration's phases, the decisions,
   launches held to the engines' steps; fleet_f32 (in serve_f32, gated,
   ``fleet_f32``): runs a-d against the spec-off f32 streams, d a
   fragment staged one page off that the gate must catch;
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
   (``synthetic_batch``, keyed by the step). Run (a) has the health
   sentinels on and its step 7 profiled (``profile_interval``): gated,
   every ``sent_*`` key present and finite each step, no non-finite
   gradient or loss, no anomaly, the losses those of the sentinels-off
   run (e) bit for bit, the sampled breakdown naming K1, K2 dq, K2 dkv,
   K3 and K4 with device time, and (a)'s launches the plan's (the
   sentinels launch no K kernel); read, the sampled step's wall time
   against the unsampled ones'. A probe as ``bench.py``'s (the
   replicated step with the sentinels and without, in turns on their
   own states over the same batches): ``sentinel_overhead_frac`` from
   the steps' device ms, the losses equal bit for bit. (f) a planted
   fault: 4 steps whose step 2 multiplies its loss by NaN; gated,
   ``sent_nonfinite`` > 0 and ``sent_loss_nonfinite`` 1 at step 2 and
   neither before, one ``nan_grads`` AnomalyRecord on the hub at step 2
   with its capture path, the capture file under the capture directory
   holding the forced sample of step 3 (a breakdown of device kernels),
   and the later NaN steps, inside ``min_capture_interval_s``, writing
   no second capture;
11. elastic: ``python -m dlrover_tpu_torch.agent.launcher --nnodes 1
   --nproc 1 --max-restarts 1 -- python -m
   dlrover_tpu_torch.examples.train_gpt_elastic`` in a subprocess under
   ``timeout``: the worker forms an NCCL group (world 1) from the sealed
   rendezvous, loads the kernels built above, trains llama-1.4b at full
   width and 2 layers (b8 × s1024, f32 params and moments: the 2.81 GB
   pack; full depth, 16.4 GB, before the node_loss phase joined) staging
   to the agent-served shared memory every 2 steps and to
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
   reference's, and any step stalled during a persist. The local
   master's metrics endpoint (``/json`` and ``/metrics``, its port from
   the launcher's log) is read every 0.25 s until the launcher exits:
   gated on the last reading, a goodput in (0, 1), lost seconds at
   least the crash to the first step back less 1 s and at most the
   phase's wall time, and ``node_failures_total`` 0 (a worker crash
   under a living agent is no node failure);
11a. node_loss: a standalone master (``python -m
   dlrover_tpu_torch.master.main --num-workers 2``) and two nodes'
   launchers (``--nnodes 2 --node-id N --nproc 1``; a run id, socket
   directory and staging segment of their own each, as two hosts; one
   wire token; the heartbeat at 1 s) run the elastic worker with
   ``--data sampler --replicate --one-card``: llama-1.4b at full width and
   2 layers, dp 2 over gloo on the card, b8 × s1024 from
   ``ElasticDataLoader(sampler=ElasticDistributedSampler(...))``, a memory
   save every 2 steps backed up by each node's agent to the ring peer
   (the agents hold the peers' 2.81 GB packs). After step 3, once node 0
   holds its staged step 2, node 1's worker writes a CUDA hardware error
   and exits 1; the master classifies it, node 1's agent reports,
   respawns and, told by the next heartbeat, exits 2. Acting as the
   platform, the phase reads node 1's staged pack, unlinks the segment
   and starts a replacement launcher for node 1. Gated: the master's
   ``hardware_error`` → ``relaunch_node``; node 1's agent rc 2; node 1's
   replacement restores step 2 through the replica tier from holder 0
   and node 0 through memory; the sampler resumes at the saved position;
   the re-run steps' losses equal the first run's bit for bit on both
   ranks; the restored pack's digest equals the staged pack's, and a
   copy with one byte flipped in its first tensor does not; every step's
   launches exact (K1 2, K2 2 pairs, K3/K4 5 each a rank); no kernel
   rebuilt; both nodes done; disk writes under 1 GiB (the checkpoint
   directory on /dev/shm); nothing left behind. Read: failure to first
   step back, split into detect, diagnosis, relaunch, rendezvous, start,
   replica fetch, restore and first step; the fetch's bytes and rate;
   the step at dp 2; each node's peak host RSS; the phase's disk bytes.
   The standalone master's metrics endpoint (its port from the master's
   log), read as in ``elastic``: a goodput in (0, 1), lost seconds at
   least the failure to the first step back less 1 s and at most the
   phase's wall time, ``node_failures_total`` 1 (node 1's agent reports
   its node failed when it exits for the relaunch);
11b. reshard: the same launcher with ``--nproc 4`` runs the worker on
   four ranks of the one card over gloo (``--one-card``), llama-1.4b at
   full width and 2 layers (as ``trainer``), b8 × s1024, ``--zero1``
   (the zero2 mode: the moments are each rank's columns of the flat
   bucket stream; 64 MB buckets), the data from the master's shard
   service, no checkpoint. After step 3 of 5 ranks 2 and 3 are evicted:
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
12. sp (records ring, ulysses, ring_glm): one group of four processes
   on the card in a gloo group, both configs in turn
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
   rebuilt in a worker, each rank's peak memory and the time of the
   step's all-reduces. The train_kernel phase
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
16. autoscale: a Brain process and the launcher's local master in
   cluster mode over llama-1.4b at full width and 2 layers, remat
   "full", b8 × s1024 through ``ElasticTrainer`` (micro-batch 4, the
   replicated step, gloo on the card): 3 steps at dp 1, the Brain's
   plan (2, clamped to [1, 2]) to this script's scaler, which starts a
   second node's agent; both restart into dp 2 (the accumulation
   re-derived) and, after the first dp-2 step, a planted OOM given to a
   ``BrainTuner`` halves the micro-batch: the master versions the
   revision, the agents' config tuners carry it and each worker
   rebuilds its step once at the same step boundary. Gated: the plan's
   target 2, the second worker's join, the accumulation at every step,
   one ``brain.tuning_replan`` span a worker at the master's version,
   every step's loss and grad norm within 1e-4 of one process's at the
   same global batches, K1–K4 launched every step. Read: plan → first
   dp-2 step s, revision → first step at the new batch s, what the
   Brain planned after dp 2, the step wall s at each shape, and the
   cold-start planner's memory estimate for llama-1.4b b8 × s1024 beside
   the train phase's measured peak.

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
import threading
import time
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler

# the interpreter's setting as this process was started (startup_probe)
_STARTED_ENV = {k: os.environ[k] for k in ("PYTHONDONTWRITEBYTECODE",)
                if k in os.environ}
if __name__ == "__main__":
    # One bytecode cache in the checkout's build directory for this run
    # and every process it starts (workers, agents, launchers). Where the
    # interpreter runs with PYTHONDONTWRITEBYTECODE and site-packages
    # holds no bytecode, every process compiles all it imports again: an
    # `import torch` took 8.4-12.2 s on the card's machine, 7.7-8.0 s from
    # a written cache (scratch probe, PERF.md section 6). Set before torch
    # is imported, so this process writes the cache the others read.
    os.environ.setdefault("PYTHONPYCACHEPREFIX", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "pycache"))
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"]
    sys.dont_write_bytecode = False

import numpy as np  # noqa: E402
import torch  # noqa: E402

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


_emit_lock = threading.Lock()


def emit(obj) -> None:
    line = json.dumps(obj) + "\n"
    with _emit_lock:  # whole lines, also from the build's thread
        sys.stdout.write(line)
        sys.stdout.flush()


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
    prompt-lookup run's launch counts and the spec-off streams."""
    prompts, samplings = _spec_prompts(cfg, seed)
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
    return runs["prompt_lookup"]["launches"], off


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
# phase 4b: the disaggregated fleet (prefill/decode replicas, live KV-page
# migration, the serving autoscaler, the master's serving directives)
# ---------------------------------------------------------------------------

# every fleet replica: 8 slots x 2048 tokens, page 16, int8 pools, chunks
# of 256 (the unified serve runs' geometry, so a stream is comparable)
FLEET_KW = dict(n_slots=8, max_len=2048, page_size=16, mode="int8",
                prefill_chunk=256, idle_sleep=0.001)
FLEET_TIMEOUT_S = 600


def _spec_prompts(cfg, seed):
    """spec_serve's traffic: 16 prompts of 512-1536 tokens repeating a
    128-token span, half greedy and half sampled."""
    rng = np.random.default_rng(seed + 7)
    return (_repeating_prompts(rng, cfg.vocab_size, 16, 512, 1536),
            _samplings(seed, 16))


# a fleet with one decode replica serves 16 requests on 8 lanes: the
# handoffs past the first 8 reserve their pages in the decode replicas'
# slack (another slot set of pages) and wait for a lane (the
# coordinator's ``commit_wait_s``: 120.5 s at 12 attempts) rather than
# degrading
FLEET_SLACK_PAGES = 8 * 128
FLEET_COMMIT_ATTEMPTS = 12
# the planted fault of fleet_f32 (d) needs one request; 4 are served
FLEET_FAULT_REQUESTS = 4


def _fleet(model, cfg, dev, roles, *, master=None, faults=None,
           prefix="fleet"):
    """Start replicas of ``roles`` sharing ``model`` (each with its own
    pools; a decode replica with ``FLEET_SLACK_PAGES`` more), registered
    with ``master`` when given, and a router with a migrator threaded
    through the master. Returns (replicas, router)."""
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.serving.migration import ServingMigrator
    from dlrover_tpu_torch.serving.replica import (
        ReplicaRouter, ServingReplica,
    )

    addr = master.addr if master is not None else None
    reps = [ServingReplica(f"{prefix}-{role[0]}{i}", model, cfg,
                           node_id=10 + i, role=role,
                           master_addr=addr, device=dev,
                           slack_pages=(FLEET_SLACK_PAGES
                                        if role == "decode" else 0),
                           **FLEET_KW).start()
            for i, role in enumerate(roles)]
    client = MasterClient(addr, node_id=1) if addr else None
    router = ReplicaRouter(reps, migrator=ServingMigrator(
        master_client=client), faults=faults)
    router.coordinator.reserve_attempts = FLEET_COMMIT_ATTEMPTS
    return reps, router


def _close_fleet(reps, router):
    router.close()
    for r in reps:
        r.stop()


def _submit_all(router, prompts, samplings, new):
    return [router.submit(p, new, sampling=s)
            for p, s in zip(prompts, samplings)]


def _results(reqs, timeout=FLEET_TIMEOUT_S):
    return [r.future.result(timeout=timeout) for r in reqs]


def _pct(xs):
    xs = sorted(xs)
    if not xs:
        return {"p50": 0.0, "p99": 0.0, "n": 0}
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99)), "n": len(xs)}


def _role_latency(reps, roles):
    """Latency percentiles a role, from the role's replicas' merged
    histograms: TTFT is recorded where the first token is drawn (the
    prefill replicas), TPOT, end to end and the handoff where a request
    completes (the decode replicas)."""
    from dlrover_tpu_torch.observability.histogram import merge_histograms

    out = {}
    for role in sorted(set(roles)):
        per = [r.server.scheduler.histograms()
               for r, ro in zip(reps, roles) if ro == role]
        out[role] = {}
        for k in ("ttft", "tpot", "e2e", "handoff", "queue_wait"):
            h = merge_histograms(p[k] for p in per)
            if h is not None and h.n:
                out[role][k] = {"p50": h.percentile(50.0),
                                "p99": h.percentile(99.0), "n": h.n}
    return out


def _fleet_launches(reps, cfg, launches):
    """The kernels' launches against the engines' own step counts: one
    launch a layer a step (chunk a prefill chunk, decode a decode step,
    verify a verify step)."""
    stats = [r.server.engine.stats() for r in reps]
    want = {"chunk": sum(s["prefill_chunks"] for s in stats),
            "decode": sum(s["decode_steps"] for s in stats),
            "verify": sum(s["verify_steps"] for s in stats)}
    want = {k: v * cfg.n_layer for k, v in want.items()}
    return want, {k: launches.get(k, 0) for k in want} == want


def _page_bytes(geom):
    """Stored bytes of one page across every layer, K and V."""
    g = geom
    row = g.row_elems * (2 if g.mode == "bf16" else 1) + (
        0 if g.mode == "bf16" else 4 * g.n_blocks)
    return 2 * g.n_layers * g.page_size * row


def _handoff_record(coord, geom):
    """Handoff ms a request (export on the loop thread to staged, per
    fragment) and the card → host and host → card rates."""
    log = coord.fragment_log
    pb = _page_bytes(geom)
    moved = sum(f["pages"] for f in log) * pb
    export_s = sum(f["export_ms"] for f in log) / 1e3
    stage_s = sum(f["stage_ms"] for f in log) / 1e3
    return {"fragments": len(log), "fragment_ms": _pct([f["ms"] for f in
                                                        log]),
            "export_ms": _pct([f["export_ms"] for f in log]),
            "wire_ms": _pct([f["wire_ms"] for f in log]),
            "stage_ms": _pct([f["stage_ms"] for f in log]),
            "page_bytes": moved, "wire_bytes": sum(f["bytes"] for f in log),
            "export_gbps": moved / export_s / 1e9 if export_s else 0.0,
            "stage_gbps": moved / stage_s / 1e9 if stage_s else 0.0,
            "retried": coord.retried, "degraded": coord.degraded,
            "committed": coord.completed}


def _kill_mid_decode(victim, min_slots, timeout=FLEET_TIMEOUT_S):
    """Kill ``victim`` once it holds ``min_slots`` slots mid-decode (a
    token drawn, the request open), parked at a step boundary to check.
    Returns the generated lengths of its slots at the kill."""
    deadline = time.monotonic() + timeout

    def ready(eng):
        live = [s for s in eng.slots if s is not None and s.phase ==
                "decode" and s.generated and not s.req.future.done()]
        return len(live) >= min_slots, [len(s.generated) for s in live]

    while time.monotonic() < deadline:
        if ready(victim.server.engine)[0]:
            with victim.server.paused() as eng:
                ok, lens = ready(eng)
                if ok:
                    victim.kill()
                    return lens
        time.sleep(0.002)
    raise RuntimeError(f"{victim.name} never held {min_slots} slots "
                       "mid-decode")


def _stage_one_page_off(eng):
    """The planted fault of fleet_f32 (d): the first fragment this engine
    stages lands one page past its place (the real first page stays
    stale)."""
    orig = eng.stage_pages
    done = []

    def stage(tag, page_start, pages):
        n = next(iter(pages.values())).shape[1]
        if not done and n and page_start + 1 + n <= len(
                eng.alloc.reservation(tag)):
            done.append(tag)
            return orig(tag, page_start + 1, pages)
        return orig(tag, page_start, pages)

    eng.stage_pages = stage
    return done


def fleet_serve(model, cfg, seed, dev):
    """The disaggregated fleet in bf16: a port master in-process, one
    prefill and two decode replicas sharing ``model``, a ReplicaRouter
    with the handoff coordinator and a ServingMigrator threaded through
    the master. (1) spec_serve's 16 requests disaggregated; (2) decode
    replica 1 killed while it holds 4 slots mid-decode, its slots
    migrated live to decode replica 2 by ``poll``; (3) the serving
    autoscaler stepped here (cooldown 0) with a TTFT target below (1)'s
    p99: it must scale the prefill pool out onto a warm replica, which
    takes dispatches, and after the clear windows in again over
    ``remove_replica``; (4) decode replica 2 retuned to spec_k=4 at a
    step boundary, the verify kernel launching on the decode role.
    Returns the phase's launches (counts set to 0 at its start)."""
    from dlrover_tpu_torch.master.master import JobMaster
    from dlrover_tpu_torch.master.serving_autoscaler import (
        ServingAutoScaler, ServingScalerConfig,
    )
    from dlrover_tpu_torch.ops import paged_attention as pa
    from dlrover_tpu_torch.serving.replica import ServingReplica

    prompts, samplings = _spec_prompts(cfg, seed)
    new = MEASURE_NEW_TOKENS
    rng = np.random.default_rng(seed + 9)
    master = JobMaster(port=0, num_workers=1)
    master.prepare()
    roles = ["prefill", "decode", "decode"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    pa.reset_launches()
    reps, router = _fleet(model, cfg, dev, roles, master=master)
    p0, d1, d2 = reps
    spare = None
    rec = {"phase": "fleet", "dtype": cfg.dtype, "n_layer": cfg.n_layer,
           "roles": dict(zip([r.name for r in reps], roles)),
           "kv_pool_bytes_per_replica": p0.server.engine.resident_kv_bytes()}
    ok = True
    try:
        registered = {n.name: n.role for n in
                      master.job_manager.serving_nodes()}
        ok = ok and sorted(registered.values()) == sorted(roles)
        # (1) the 16 requests, disaggregated
        t0 = time.monotonic()
        reqs = _submit_all(router, prompts, samplings, new)
        outs = _results(reqs)
        wall = time.monotonic() - t0
        stats = {r.name: r.server.engine.stats() for r in reps}
        ttfts = [(r.first_token_t - r.submit_t) * 1e3 for r in reqs]
        rec["serve"] = {
            "requests": len(reqs), "new_tokens_per_request": new,
            "wall_s": wall,
            "tokens_per_s_by_role": {
                role: sum(stats[r.name]["tokens_generated"] for r, ro in
                          zip(reps, roles) if ro == role) / wall
                for role in ("prefill", "decode")},
            "tokens_per_s": sum(len(o) - len(p) for o, p in
                                zip(outs, prompts)) / wall,
            "latency_ms_by_role": _role_latency(reps, roles),
            "handoff": _handoff_record(router.coordinator,
                                       p0.server.engine.geom),
            "handoff_bytes_per_request": (
                stats[p0.name]["handoff_bytes"]
                / max(1, stats[p0.name]["handoffs_out"])),
        }
        ttft_p99 = float(np.percentile(ttfts, 99))
        ok = ok and all(len(o) == len(p) + new and o[:len(p)] == p
                        for p, o in zip(prompts, outs))
        ok = ok and stats[p0.name]["handoffs_out"] == len(prompts)
        # (2) decode replica 1 killed holding 4 slots mid-decode
        # 8 prompts of one length: the coordinator places them on the
        # decode replica with the most free pages, alternately, so each
        # takes 4 and the survivor has lanes for the victim's 4
        kill_prompts = _repeating_prompts(rng, cfg.vocab_size, 8, 640, 640)
        kill_sps = _samplings(seed + 2, 8)
        base = {r.name: r.server.engine.stats()["prefill_tokens"]
                for r in reps}
        t_step = time.monotonic()
        kreqs = _submit_all(router, kill_prompts, kill_sps, 2 * new)
        at_kill = _kill_mid_decode(d1, 4)
        t_kill = time.monotonic()
        router.poll()
        report = router.reports[-1] if router.reports else None
        kouts = _results(kreqs)
        t_back = time.monotonic() - t_kill
        rec["migration"] = {
            "slots_at_kill": at_kill,
            "path": report.path if report else None,
            "placements": len(report.placements) if report else 0,
            "re_prefilled": len(report.re_prefilled) if report else 0,
            "phase_s": report.outcome.phase_seconds if report else {},
            "recovery_s": report.outcome.recovery_s if report else 0.0,
            "bytes": report.bytes_moved if report else 0,
            "tokens_saved": report.tokens_saved if report else 0,
            "directive_version": report.directive_version if report else 0,
            "tokens_re_prefilled": sum(
                r.server.engine.stats()["prefill_tokens"] - base[r.name]
                for r in (d1, d2)),
            "kill_to_done_s": t_back,
            "wall_s": time.monotonic() - t_step,
        }
        m = rec["migration"]
        ok = ok and (m["path"] == "live" and m["placements"] >= 4
                     and m["re_prefilled"] == 0
                     and m["tokens_re_prefilled"] == 0
                     and m["directive_version"] >= 1
                     and master.job_manager.get_serving_reshard()[
                         "victim"] == d1.name)
        ok = ok and all(len(o) == len(p) + 2 * new
                        for p, o in zip(kill_prompts, kouts))
        # (3) the autoscaler: a TTFT target below (1)'s p99
        t_step = time.monotonic()
        spare = ServingReplica("fleet-p3", model, cfg, node_id=13,
                               role="prefill", master_addr=master.addr,
                               device=dev, **FLEET_KW).start()
        target = 0.5 * ttft_p99
        scaler = ServingAutoScaler(
            router, ServingScalerConfig(
                ttft_target_ms=target, cooldown_s=0.0, min_window_n=0,
                min_replicas=1, max_replicas=2, shrink_after_clear=2),
            provision_fn=lambda role: spare, job_manager=master.job_manager)
        t_breach = time.monotonic()
        out_rec = scaler.step()
        scale_prompts = _repeating_prompts(rng, cfg.vocab_size, 4, 256, 768)
        sreqs = _submit_all(router, scale_prompts, _samplings(seed + 3, 4),
                            new)
        _results(sreqs)
        spare_first = [r.first_token_t for r in sreqs
                       if r.rid.startswith(spare.name + "/")
                       and r.first_token_t]
        trail = [scaler.step() for _ in range(4)]
        decisions = [d for d in [out_rec] + trail if d is not None]
        rec["autoscale"] = {
            "ttft_p99_ms": ttft_p99, "ttft_target_ms": target,
            "decisions": [{"role": d.role, "direction": d.direction,
                           "signal": d.signal, "value": d.value,
                           "n_before": d.n_before, "n_after": d.n_after,
                           "version": d.version, "replica": d.replica,
                           "reason": d.reason} for d in decisions],
            "spare_dispatches": spare.server.scheduler.admitted,
            "breach_to_first_token_s": (min(spare_first) - t_breach
                                        if spare_first else None),
            "master_scale": master.job_manager.get_serving_scale("prefill"),
            "wall_s": time.monotonic() - t_step,
        }
        dirs = [(d.role, d.direction) for d in decisions if d.direction]
        ok = ok and dirs == [("prefill", "out"), ("prefill", "in")]
        ok = ok and bool(spare_first) and out_rec.version >= 1
        ok = ok and len(router.live_replicas("prefill")) == 1
        # (4) decode replica 2 retuned to spec_k=4 at a step boundary
        t_step = time.monotonic()
        with d2.server.paused() as eng:
            retuned = eng.retune(spec_k=SPEC_K)
        v0 = d2.server.engine.stats()["verify_steps"]
        spec_prompts = _repeating_prompts(rng, cfg.vocab_size, 4, 512, 1024)
        vreqs = _submit_all(router, spec_prompts, _samplings(seed + 4, 4),
                            new)
        _results(vreqs)
        rec["retune"] = {"result": retuned,
                         "verify_steps": d2.server.engine.stats()[
                             "verify_steps"] - v0,
                         "spec_accept_rate": d2.server.engine.stats()[
                             "spec_accept_rate"],
                         "wall_s": time.monotonic() - t_step}
        ok = ok and retuned["applied"] == {"spec_k": SPEC_K}
        ok = ok and rec["retune"]["verify_steps"] > 0
    finally:
        all_reps = reps + ([spare] if spare is not None else [])
        _close_fleet(all_reps, router)
        master.stop()
    torch.cuda.synchronize()
    launches = dict(pa.LAUNCHES)
    want, exact = _fleet_launches(all_reps, cfg, launches)
    stats = {r.name: r.server.engine.stats() for r in all_reps}
    rec.update({
        "launches": launches, "launches_from_steps": want,
        "launches_exact": exact,
        "engines": {n: {k: s[k] for k in (
            "role", "prefill_chunks", "decode_steps", "verify_steps",
            "prefill_tokens", "handoffs_in", "handoffs_out", "migrated_in",
            "migrated_out", "tokens_generated", "handoff_bytes")}
            for n, s in stats.items()},
        "reserved_pages": {r.name: r.server.engine.alloc.reserved_pages
                           for r in all_reps},
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "memory_over_model": torch.cuda.max_memory_allocated() - mem0,
    })
    decode_names = [r.name for r in (d1, d2)]
    # the killed replica's allocator died with it (its reservations for
    # handoffs in flight were restarted elsewhere)
    ok = (ok and exact and all(launches[k] > 0 for k in
                               ("chunk", "decode", "verify"))
          and all(stats[n]["prefill_chunks"] == 0 for n in decode_names)
          and all(v == 0 for n, v in rec["reserved_pages"].items()
                  if n != d1.name))
    rec["ok"] = ok
    emit(rec)
    if not ok:
        _failures.append(f"fleet: {rec}")
    return launches


def _fleet_run(model, cfg, dev, prompts, samplings, new, roles, *,
               faults=None, kill=False, shift=False, name=""):
    """One gated fleet_f32 run: serve ``prompts`` on a fleet of
    ``roles``; ``kill`` kills decode replica 1 once it holds a slot
    mid-decode, ``shift`` plants the staged-one-page-off fault on every
    decode replica. Returns (outputs, record)."""
    from dlrover_tpu_torch.ops import paged_attention as pa

    pa.reset_launches()
    reps, router = _fleet(model, cfg, dev, roles, faults=faults,
                          prefix=f"f32{name}")
    shifted = []
    try:
        if shift:
            for r, role in zip(reps, roles):
                if role == "decode":
                    shifted.append(_stage_one_page_off(r.server.engine))
        t0 = time.monotonic()
        reqs = _submit_all(router, prompts, samplings, new)
        base = None
        if kill:
            victim = reps[roles.index("decode")]
            _kill_mid_decode(victim, 1)
            base = {r.name: r.server.engine.stats()["prefill_tokens"]
                    for r in reps}
            router.poll()
        outs = router.wait_all(timeout=FLEET_TIMEOUT_S)
        wall = time.monotonic() - t0
        coord = router.coordinator
        torch.cuda.synchronize()
        launches = dict(pa.LAUNCHES)
        stats = {r.name: r.server.engine.stats() for r in reps}
        rec = {
            "roles": roles, "wall_s": wall,
            "handoff": _handoff_record(coord, reps[0].server.engine.geom),
            "migrations": [{"path": m.path, "placements": len(m.placements),
                            "re_prefilled": len(m.re_prefilled),
                            "phase_s": m.outcome.phase_seconds,
                            "bytes": m.bytes_moved}
                           for m in router.reports],
            "completed": {n: r.server.scheduler.completed
                          for n, r in zip(stats, reps)},
            "reserved_pages": {r.name: r.server.engine.alloc.reserved_pages
                               for r in reps},
            "prefill_tokens": {n: s["prefill_tokens"]
                               for n, s in stats.items()},
            "launches": launches,
            "shifted": [t for s in shifted for t in s],
        }
        rec["launches_from_steps"], exact = _fleet_launches(reps, cfg,
                                                            launches)
        dec = [n for n, ro in zip(stats, roles) if ro == "decode"]
        killed = [r.name for r in reps if not r.alive] if kill else []
        gates = {
            "completed_once": (sum(rec["completed"].values()) == len(prompts)
                               and all(r.future.done() for r in reqs)),
            "no_degrade": rec["handoff"]["degraded"] == 0,
            "all_live": all(m["path"] == "live" and not m["re_prefilled"]
                            for m in rec["migrations"]),
            "no_reserved": all(v == 0 for n, v in
                               rec["reserved_pages"].items()
                               if n not in killed),
            "decode_no_prefill": all(stats[n]["prefill_tokens"] == 0
                                     and stats[n]["prefill_chunks"] == 0
                                     for n in dec),
            "launches_exact": exact,
            "kernels_ran": launches["chunk"] > 0 and launches["decode"] > 0,
        }
        if kill:
            gates["migrated"] = bool(rec["migrations"]) and all(
                stats[n]["prefill_tokens"] == base[n] for n in dec)
        rec["gates"] = gates
        return outs, rec
    finally:
        _close_fleet(reps, router)


def fleet_f32(model, cfg, seed, dev, ref_outs):
    """The gated fleet runs on the f32 model, against ``ref_outs`` (the
    spec-off streams of spec_serve's gated run, 64 new tokens): (a) one
    prefill and one decode replica, the 16 requests; (b) one prefill and
    two decode, one decode replica killed mid-decode, 8 of them; (c) a
    torn fragment planted at ``serving.handoff`` (retried), 8; (d) a
    fragment staged one page off, which the gate must catch, 4. In (a)-(c) every stream equals its
    reference or leaves it only at a near-tie, every migration is live
    and grew no survivor's prefill tokens, (c) retried, each request
    completed once, no engine holds a reservation, the decode replicas
    ran no prefill and the chunk kernel launched only on prefill
    replicas; in (d) a stream must leave its reference where it is not
    a near-tie."""
    from dlrover_tpu_torch.elastic.faults import FaultInjector, FaultSpec

    prompts, samplings = _spec_prompts(cfg, seed)
    new = 64
    runs, ok = {}, True
    inj = FaultInjector()
    inj.install(FaultSpec("drop_page", point="serving.handoff", times=1))
    # (a) serves all 16 requests, (b) and (c) the first 8 (the kill
    # comes at the victim's first decoding slot; the one torn fragment is
    # the first), (d) the first 4 (its fault the first fragment staged):
    # each against the reference's streams of those
    for name, roles, n, kw in (
            ("a", ["prefill", "decode"], 16, {}),
            ("b", ["prefill", "decode", "decode"], 8, {"kill": True}),
            ("c", ["prefill", "decode"], 8, {"faults": inj}),
            ("d", ["prefill", "decode"], FLEET_FAULT_REQUESTS,
             {"shift": True})):
        outs, rec = _fleet_run(model, cfg, dev, prompts[:n],
                               samplings[:n], new, roles, name=name, **kw)
        rec["divergences"] = _divergences(model, cfg, dev, ref_outs[:n],
                                          outs, samplings[:n], "int8")
        ties = all(d["near_tie"] for d in rec["divergences"])
        if name == "d":
            rec["gates"]["fault_caught"] = bool(rec["shifted"]) and any(
                not d["near_tie"] for d in rec["divergences"])
        else:
            rec["gates"]["streams"] = ties
        if name == "c":
            rec["gates"]["retried"] = rec["handoff"]["retried"] >= 1
        if name == "b":
            rec["gates"]["killed"] = len(rec["migrations"]) >= 1
        runs[name] = rec
        ok = ok and all(rec["gates"].values())
    out = {"phase": "fleet_f32", "dtype": cfg.dtype, "n_layer": cfg.n_layer,
           "tol_rel": MODEL_REL_TOL, "runs": runs, "ok": ok}
    emit(out)
    if not ok:
        _failures.append(f"fleet_f32: {out}")


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
# run (a)'s profiled step (profile_interval): one of its 10 steps, off
# the save steps; the sentinel probe's untimed and timed steps a side;
# the planted fault run's steps and its NaN step
TRAINER_PROFILE_EVERY = 7
SENTINEL_PROBE_WARMUP, SENTINEL_PROBE_STEPS = 2, 6
NAN_RUN_STEPS, NAN_AT = 4, 2
# the device kernels of the trainer's main path: K1, K2 dq and dkv, K3, K4
PROFILED_KERNELS = ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                    "flash_bwd_dkv_wgmma_kernel", "norm_fwd_kernel",
                    "norm_bwd_kernel")
SENT_KEYS = ("sent_nonfinite", "sent_ovf_f16", "sent_und_f16",
             "sent_ovf_bf16", "sent_und_bf16", "sent_update_ratio",
             "sent_loss_nonfinite")


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
    """Callback: each step's loss, device ms, wall s and end (host
    clock); at ``on_train_begin`` the state's leaves against ``ref`` (the
    paths that differ)."""

    def __init__(self, ref=None):
        self.ref, self.diff = ref, None
        self.losses, self.device_ms, self.end_at = {}, {}, {}
        self.wall_s = {}

    def on_train_begin(self, trainer, control):
        if self.ref is not None:
            self.diff = _leaves_diff(trainer.state_leaves(), self.ref)

    def on_step_end(self, trainer, step, metrics, control):
        self.losses[step] = metrics["loss"]
        self.device_ms[step] = trainer.timer.last_device_ms
        self.wall_s[step] = trainer.timer.last_s
        self.end_at[step] = time.perf_counter()

    def __getattr__(self, hook):  # the other hooks: nothing to do
        if hook.startswith("on_"):
            return lambda *a, **k: None
        raise AttributeError(hook)


def _observed(trainer):
    """Each step's host metrics as ``trainer``'s watchdog sees them (the
    step's one read: the loss, the sentinels, the rest), by step."""
    seen = {}
    real = trainer.watchdog.observe

    def observe(step, metrics, **kw):
        seen[step] = dict(metrics)
        return real(step, metrics, **kw)

    trainer.watchdog.observe = observe
    return seen


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def sentinel_probe(cfg, seed, dev, batches, opt):
    """``bench.py``'s sentinel probe: the replicated step without and with
    the sentinels, each on its own state from ``seed``, in turns over the
    same batches; every step timed by CUDA events around the step alone,
    then its metrics read. Returns the device ms a step of each, the
    losses of each (to hold bit for bit) and ``t_on / t_off - 1`` over
    the medians of the timed steps."""
    from dlrover_tpu_torch.train.train_step import (
        TrainStepBuilder,
        init_train_state,
    )

    runs = {}
    for on in (False, True):
        tx = opt()
        runs[on] = {"state": init_train_state(seed, cfg, tx, device=dev),
                    "step": TrainStepBuilder(cfg, tx, device=dev,
                                             health_sentinels=on).build(),
                    "ms": [], "losses": []}
    n = SENTINEL_PROBE_WARMUP + SENTINEL_PROBE_STEPS
    for i in range(n):
        batch = batches[i % len(batches)]
        for on in (False, True):
            r = runs[on]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            r["state"], m = r["step"](r["state"], batch)
            end.record()
            end.synchronize()
            r["ms"].append(start.elapsed_time(end))
            r["losses"].append(float(m["loss"]))
    out = {"warmup": SENTINEL_PROBE_WARMUP,
           "steps": SENTINEL_PROBE_STEPS}
    for on, key in ((False, "off"), (True, "on")):
        out[f"{key}_ms"] = runs[on]["ms"]
        out[f"{key}_losses"] = runs[on]["losses"]
    t_on = _median(out["on_ms"][SENTINEL_PROBE_WARMUP:])
    t_off = _median(out["off_ms"][SENTINEL_PROBE_WARMUP:])
    out["median_on_ms"], out["median_off_ms"] = t_on, t_off
    out["sentinel_overhead_frac"] = t_on / t_off - 1.0
    runs.clear()
    return out


def _poisoned_builder(cfg, opt, dev):
    """A ``TrainStepBuilder`` with the sentinels whose step NAN_AT
    multiplies its loss by NaN (the gradients of every leaf go NaN, as a
    corrupt batch's would)."""
    from dlrover_tpu_torch.train.train_step import TrainStepBuilder

    class Poisoned(TrainStepBuilder):
        calls = 0

        def step_fn(self, state, batch):
            self.calls += 1
            return super().step_fn(state, batch)

        def _loss(self, model, batch, denom=None):
            loss, m = super()._loss(model, batch, denom)
            if self.calls == NAN_AT:
                loss = loss * float("nan")
            return loss, m

    return Poisoned(cfg, opt, device=dev, health_sentinels=True)


def nan_fault_run(cfg, seed, dev, batches, opt, out_dir):
    """The planted fault: a ``Trainer`` with the health sentinels over
    NAN_RUN_STEPS steps whose step NAN_AT is poisoned. Returns each
    step's observed metrics, the AnomalyRecords the hub carried, the
    capture directory's files and the capture's document."""
    from dlrover_tpu_torch.observability import telemetry
    from dlrover_tpu_torch.train.trainer import Trainer, TrainerArgs

    published = []
    hub = telemetry.configure_hub()
    sink = hub.subscribe(published.append, types=("AnomalyRecord",))
    tx = opt()
    try:
        t = Trainer(cfg, TrainerArgs(
            output_dir=out_dir, max_steps=NAN_RUN_STEPS, save_interval=0,
            log_interval=0, seed=seed, resume=False, health_sentinels=True,
            detect_loss_spikes=False), batches, tx,
            step_builder=_poisoned_builder(cfg, tx, dev), device=dev)
        seen = _observed(t)
        t.train()
        cap_dir = t.watchdog.cfg.capture_dir
        min_interval = t.watchdog.cfg.min_capture_interval_s
        del t
    finally:
        hub.remove_sink(sink)
        telemetry.reset_hub()
    files = sorted(os.listdir(cap_dir)) if os.path.isdir(cap_dir) else []
    doc = {}
    if files:
        with open(os.path.join(cap_dir, files[0])) as f:
            doc = json.load(f)
    return {"steps": {s: {k: m.get(k) for k in SENT_KEYS + ("loss",)}
                      for s, m in seen.items()},
            "anomalies": [{"kind": r.kind, "step": r.step,
                           "capture": r.capture, "detail": r.detail}
                          for r in published],
            "capture_dir": cap_dir, "capture_files": files,
            "min_capture_interval_s": min_interval,
            "capture": {"anomaly": doc.get("anomaly"),
                        "captured_step": doc.get("captured_step"),
                        "n_ops": len(doc.get("ops", [])),
                        "ops": doc.get("ops", [])[:12]}}


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
        # last steps with them off; the health sentinels on, one step
        # profiled (every kernel of it kept in the breakdown)
        watch_a = _Watch()
        t_a = time.perf_counter()
        a = Trainer(cfg, args(max_steps=TRAINER_SAVED,
                              save_interval=TRAINER_DISK_EVERY,
                              memory_save_interval=TRAINER_MEMORY_EVERY,
                              health_sentinels=True,
                              profile_interval=TRAINER_PROFILE_EVERY),
                    batches, opt(), callbacks=[watch_a], device=dev)
        a.runtime_timer.top_k = 0
        seen_a = _observed(a)
        _reset_train_launches()
        t0 = time.perf_counter()
        a.train()
        rec["a_cadence_s"] = time.perf_counter() - t0
        rec["sampled_at"] = a.runtime_timer.sampled_at
        rec["breakdown"] = [
            {"op": o.name, "us": o.total_us, "count": o.count}
            for o in a.runtime_timer.breakdown]
        ref = _snapshot(a.state_leaves())
        a.args.max_steps = TRAINER_STEPS
        a.args.save_interval = a.args.memory_save_interval = 0
        a.train()
        rec["launches"] = _train_launches()
        rec["sentinels_a"] = {s: {k: m.get(k) for k in SENT_KEYS}
                              for s, m in sorted(seen_a.items())}
        rec["anomalies_a"] = [(r.kind, r.step)
                              for r in a.watchdog.anomalies]
        rec["step_wall_s_a"] = [watch_a.wall_s[s]
                                for s in range(1, TRAINER_STEPS + 1)]
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
        torch.cuda.empty_cache()
        # the sentinels' cost, and (f) the planted fault
        rec["sentinel_probe"] = sentinel_probe(
            cfg, seed, dev, batches, opt)
        torch.cuda.empty_cache()
        rec["nan_fault"] = nan_fault_run(cfg, seed, dev,
                                         batches[:NAN_RUN_STEPS], opt,
                                         os.path.join(out, "nan"))
    finally:
        CheckpointEngine.unlink_segment()
        shutil.rmtree(out, ignore_errors=True)
        torch.cuda.empty_cache()
    tail = losses[TRAINER_SAVED:]
    steady = sorted(rec["step_device_ms_a"][1:])
    rec["steady_step_device_ms"] = steady[len(steady) // 2]
    sampled = rec["sampled_at"]
    rec["sampled_step_wall_s"] = rec["step_wall_s_a"][sampled - 1]
    rec["unsampled_step_wall_s"] = _median(
        w for s, w in enumerate(rec["step_wall_s_a"], 1)
        if s not in (1, sampled))
    probe = rec["sentinel_probe"]
    rec["sentinel_overhead_frac"] = probe["sentinel_overhead_frac"]
    profiled = {k: sum(o["us"] for o in rec["breakdown"] if k in o["op"])
                for k in PROFILED_KERNELS}
    rec["profiled_kernel_us"] = profiled
    rec["breakdown_kernels"] = sum(o["count"] for o in rec["breakdown"])
    nan = rec["nan_fault"]
    before = [nan["steps"].get(s, {}) for s in range(1, NAN_AT)]
    at = nan["steps"].get(NAN_AT, {})
    first = [r for r in nan["anomalies"] if r["step"] == NAN_AT]
    sent = rec["sentinels_a"]
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
        # the health sentinels (run a; run e and the probe without them)
        "sentinels_every_step_finite": sorted(sent)
        == list(range(1, TRAINER_STEPS + 1))
        and all(v.get(k) is not None and math.isfinite(v[k])
                for v in sent.values() for k in SENT_KEYS),
        "sentinels_nonfinite_0": all(
            v["sent_nonfinite"] == 0 and v["sent_loss_nonfinite"] == 0
            for v in sent.values()),
        "no_anomaly": rec["anomalies_a"] == [],
        "sentinels_change_no_bit": rec["losses_e"] == losses
        and probe["on_losses"] == probe["off_losses"],
        "sampled_breakdown_names_k1_to_k4":
        sampled == TRAINER_PROFILE_EVERY
        and all(us > 0 for us in profiled.values()),
        # (f) the planted fault
        "nan_counted_at_its_step": all(
            v.get("sent_nonfinite") == 0
            and v.get("sent_loss_nonfinite") == 0 for v in before)
        and (at.get("sent_nonfinite") or 0) > 0
        and at.get("sent_loss_nonfinite") == 1,
        "nan_grads_published_once_at_its_step": len(first) == 1
        and first[0]["kind"] == "nan_grads"
        and nan["anomalies"][0]["step"] == NAN_AT
        and bool(first[0]["capture"]),
        "capture_written_with_kernels": nan["capture_files"] == [
            os.path.basename(first[0]["capture"]) if first else None]
        and nan["capture"]["captured_step"] == NAN_AT + 1
        and nan["capture"]["n_ops"] > 0,
        "capture_budget_holds": len(nan["anomalies"]) > 1
        and all(r["capture"] == "" for r in nan["anomalies"][1:]),
    }
    rec["ok"] = all(checks.values())
    emit(rec)
    if not rec["ok"]:
        _failures.append(f"{name}: {[k for k, v in checks.items() if not v]}")
    return rec


# the elastic phase: the worker's 8 steps, memory saves every 2, disk
# saves every 4 (two persists: steps 4 and 8), a crash right after step 5
# of the first run; the launcher's time limit
ELASTIC_STEPS, ELASTIC_CKPT_EVERY, ELASTIC_CRASH_AT = 8, 2, 5
# llama-1.4b at full width and 2 layers (a 2.81 GB pack): 24 layers (16.37
# GB) until the node_loss phase joined the script and needed its time
ELASTIC_LAYERS = 2
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


class _MasterMetrics:
    """Reads a job master's metrics endpoint while the master runs: its
    port from the line the master logs at start (``log_path``), then
    ``/json`` and ``/metrics`` every ``interval_s`` until ``stop``. The
    last reading is the last taken before the master exited."""

    def __init__(self, log_path, interval_s=0.25):
        self._log_path = log_path
        self._interval = interval_s
        self.port = None
        self.json = self.text = None
        self.reads = 0
        self._halt = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _get(self, path):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{self.port}{path}", timeout=2) as r:
            return r.read().decode()

    def _run(self):
        while not self._halt.wait(self._interval):
            if self.port is None:
                try:
                    with open(self._log_path, errors="replace") as f:
                        m = re.search(r"metrics endpoint on port (\d+)",
                                      f.read())
                except OSError:
                    m = None
                if m is None:
                    continue
                self.port = int(m.group(1))
            try:
                doc, text = json.loads(self._get("/json")), self._get(
                    "/metrics")
            except (OSError, ValueError):
                continue  # not up yet, or gone
            self.json, self.text = doc, text
            self.reads += 1

    def stop(self) -> dict:
        """The last reading: goodput, its lost and wall seconds, the
        counters, and the Prometheus text's goodput and failure lines."""
        self._halt.set()
        self._thread.join(10)
        doc = self.json or {}
        lines = (self.text or "").splitlines()
        return {"port": self.port, "reads": self.reads,
                "goodput": doc.get("goodput"),
                "goodput_lost_seconds": doc.get("goodput_lost_seconds"),
                "goodput_wall_seconds": doc.get("goodput_wall_seconds"),
                "counters": doc.get("counters"),
                "prometheus": [x for x in lines if x.startswith((
                    "dlrover_tpu_goodput", "dlrover_tpu_node_failures"))]}


def _goodput_checks(metrics, failure_to_back_s, wall_s, node_failures):
    """The endpoint's gates: a goodput in (0, 1) in both its JSON and its
    Prometheus text, lost seconds that cover the recovery (the failure to
    the first step back, less 1 s for the report's way to the master)
    and no more than the phase's wall time, the node failures the phase
    caused."""
    gp = metrics.get("goodput")
    lost = metrics.get("goodput_lost_seconds")
    counters = metrics.get("counters") or {}
    # the text is read a moment after the JSON: its own values
    text = {x.split()[0]: float(x.split()[1])
            for x in metrics.get("prometheus", [])}
    tgp = text.get("dlrover_tpu_goodput")
    return {
        "goodput_in_0_1": gp is not None and 0.0 < gp < 1.0
        and tgp is not None and 0.0 < tgp < 1.0,
        "goodput_lost_covers_recovery": lost is not None
        and failure_to_back_s is not None
        and failure_to_back_s - 1.0 <= lost <= wall_s,
        "node_failures_counted": counters.get("node_failures_total")
        == node_failures
        == text.get("dlrover_tpu_node_failures_total"),
    }


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
           cfg.name, "--override", f"n_layer={cfg.n_layer}",
           "--steps", str(ELASTIC_STEPS), "--batch",
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
        # the launcher's whole log, too long for the record (gitignored);
        # the local master's endpoint read from it while it runs
        log_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "build", "chip_smoke")
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(log_dir, "elastic_log.txt")
        t0 = time.perf_counter()
        with open(log_path, "w") as f:
            proc = subprocess.Popen(
                cmd, env=env, stdout=f, stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__)))
            watch = _MasterMetrics(log_path)
            try:
                proc.wait()
            finally:
                rec["master_metrics"] = watch.stop()
        rec["seconds"] = time.perf_counter() - t0
        rec["launcher_rc"] = proc.returncode
        with open(log_path, errors="replace") as f:
            log = f.read()
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
        # the master's endpoint: a worker crash under a living agent is
        # no node failure
        **_goodput_checks(rec.get("master_metrics", {}),
                          rec.get("crash_to_first_step_back_s"),
                          rec.get("seconds", 0.0), 0),
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
# phase 11a: a lost node restores from its peer's memory
# ---------------------------------------------------------------------------

# two nodes of one worker each (dp 2 over gloo on card 0); llama-1.4b at
# full width and 2 layers, b8 x s1024; a memory save every 2 steps, each
# backed up to the ring peer; node 1 goes after step 3 (its saved step 2
# held by node 0), its replacement and node 0 resume step 2 and train to
# step 4; the heartbeat at 1 s (the drill's: the default is 15)
NODE_LOSS_LAYERS, NODE_LOSS_STEPS, NODE_LOSS_AT = 2, 4, 2
NODE_LOSS_TIMEOUT_S = 420
NODE_LOSS_HEARTBEAT_S = 1.0
_NODE_STEP = re.compile(r"\[worker\] step=(\d+) loss=(\S+) rank=(\d+) "
                        r"device_ms=(\S+) at=(\S+) launches=(\{.*\})")


def _node_loss_runs(text):
    """Each worker start's lines in a launcher's log: its group line, kernel
    load, restore record, sampler position, steps and last line."""
    runs, cur = [], None
    for line in text.splitlines():
        if "[worker] process group" in line:
            cur = {"group": line.split("[worker] ")[1], "steps": {},
                   "kernels": None, "restore": None, "sampler": None,
                   "rss": None}
            runs.append(cur)
        elif cur is None:
            continue
        elif "[worker] kernels " in line:
            cur["kernels"] = json.loads(line.split("kernels ", 1)[1])
        elif "[worker] restore " in line:
            cur["restore"] = json.loads(line.split("restore ", 1)[1])
        elif "[worker] sampler position restored " in line:
            cur["sampler"] = json.loads(line.split("restored ", 1)[1])
        m = re.search(r"peak_rss_bytes=(\d+)", line)
        if m and "[worker]" in line:
            cur["rss"] = int(m.group(1))
        m = _NODE_STEP.search(line)
        if m:
            cur["steps"][int(m.group(1))] = {
                "loss": m.group(2), "rank": int(m.group(3)),
                "device_ms": (None if m.group(4) == "None"
                              else float(m.group(4))),
                "at": float(m.group(5)), "launches": json.loads(m.group(6))}
    return runs


def _staged_pack(name):
    """The pack in segment ``name``: its step, bytes and digest, and the
    digest of a copy with one byte flipped in the middle of its first
    tensor."""
    from dlrover_tpu_torch.checkpoint import core
    from dlrover_tpu_torch.common.multi_process import attach_shared_memory
    from dlrover_tpu_torch.examples.train_gpt_elastic import (
        chunk_digests,
        pack_digest,
    )

    shm = attach_shared_memory(name)
    try:
        n = core.pack_length(shm.buf)
        view = shm.buf[:n]
        doc = core.read_header(view)
        hdr = int.from_bytes(bytes(view[:core.HEADER_LEN_BYTES]), "little")
        first = doc["leaves"][0]["shards"][0]
        flip = (core.payload_start(bytes(view[core.HEADER_LEN_BYTES:
                                              core.HEADER_LEN_BYTES + hdr]))
                + first["offset"] + first["nbytes"] // 2)
        t0 = time.perf_counter()
        parts = chunk_digests(view)
        out = {"step": doc["step"], "nbytes": n,
               "digest": pack_digest(parts=parts), "flip_at": flip,
               "flipped_digest": pack_digest(view, parts, flip)}
        out["digest_s"] = time.perf_counter() - t0
        del view
        return out
    finally:
        shm.close()


def node_loss_check(cfg, seed, name="node_loss", device="cuda",
                    overrides=()):
    """A node lost and restored from its peer's memory, on the card: a
    standalone job master and two nodes' launchers (a run id, a socket
    directory and a staging segment of their own each, as two hosts; one
    wire token) run the elastic example with ``--data sampler
    --replicate --one-card``: each worker's staged pack is backed up by
    its node's agent to the ring peer. Node 1's worker, once node 0 holds
    its saved step, runs a further step, writes a CUDA hardware error and
    exits 1; the master classifies it and prescribes a relaunch, node 1's
    agent (after reporting and respawning, the JAX order) exits 2. Acting
    as the platform, this reads node 1's staged pack, unlinks the segment
    (a fresh host has none) and starts a replacement launcher. The
    checkpoint directory is on /dev/shm (tmpfs: off the disk). Readings
    from the trace files, the logs and ``/proc/self/io``. ``device`` and
    ``overrides`` serve a rehearsal on the CPU at a cut size."""
    import glob
    import shutil
    import tempfile

    from dlrover_tpu_torch.common.multi_process import (
        attach_shared_memory,
        unlink_shared_memory,
    )
    from dlrover_tpu_torch.examples.train_gpt_elastic import launches
    from dlrover_tpu_torch.ops import flash_attention as fa

    here = os.path.dirname(os.path.abspath(__file__))
    log_dir = os.path.join(here, "build", "chip_smoke")
    os.makedirs(log_dir, exist_ok=True)
    out = tempfile.mkdtemp(prefix="dlrover_node_loss_")
    ckpt_dir = tempfile.mkdtemp(prefix="dlrover_node_loss_ckpt_",
                                dir="/dev/shm")
    run = f"chip_smoke_node_loss_{os.getpid()}"
    trace_dir = os.path.join(out, "trace")
    env = dict(os.environ, DLROVER_TPU_COORDINATOR_PORT="0",
               DLROVER_TPU_WIRE_TOKEN=f"{run}_token",
               DLROVER_TPU_REPLICA_HOST="127.0.0.1",
               DLROVER_TPU_CTX_HEARTBEAT_INTERVAL_S=str(
                   NODE_LOSS_HEARTBEAT_S),
               DLROVER_TPU_TRACE_DIR=trace_dir, TMPDIR=out)
    env.pop("DLROVER_TPU_MASTER_ADDR", None)
    per_step = {k: 0 for k in launches()}
    per_step.update({k: cfg.n_layer for k in fa.UNPACKED},
                    norm_fwd=2 * cfg.n_layer + 1,
                    norm_bwd=2 * cfg.n_layer + 1)
    rec = {"phase": name, "config": cfg.name, "n_layer": cfg.n_layer,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "dp": 2,
           "steps": NODE_LOSS_STEPS, "lose_after_saved_step": NODE_LOSS_AT,
           "heartbeat_s": NODE_LOSS_HEARTBEAT_S, "card": nvidia_smi_line()}
    procs, files, logs = [], [], {}
    addr = watch = None

    def launch(node, tag):
        cmd = ["timeout", "-k", "10", str(NODE_LOSS_TIMEOUT_S),
               sys.executable, "-m", "dlrover_tpu_torch.agent.launcher",
               "--nnodes", "2", "--node-id", str(node), "--nproc", "1",
               "--max-restarts", "3", "--monitor-interval", "0.2",
               "--master-addr", addr, "--", sys.executable, "-m",
               "dlrover_tpu_torch.examples.train_gpt_elastic", "--model",
               cfg.name, "--override", f"n_layer={cfg.n_layer}",
               "--steps", str(NODE_LOSS_STEPS), "--batch", str(TRAIN_BATCH),
               "--seq", str(TRAIN_SEQ), "--seed", str(seed), "--ckpt-dir",
               ckpt_dir, "--ckpt-every", "2", "--data", "sampler",
               "--replicate", "--lose-node-at", str(NODE_LOSS_AT),
               "--hash-restored", "--one-card", "--device", device]
        for item in overrides:
            cmd += ["--override", item]
        rec.setdefault("commands", {})[tag] = cmd[4:]
        logs[tag] = os.path.join(log_dir, f"{name}_{tag}.txt")
        f = open(logs[tag], "w")
        files.append(f)
        p = subprocess.Popen(
            cmd, cwd=here, stdout=f, stderr=subprocess.STDOUT,
            env=dict(env, DLROVER_TPU_RUN_ID=f"{run}_n{node}",
                     DLROVER_TPU_SOCK_DIR=os.path.join(out, f"sock{node}")))
        procs.append(p)
        return p

    def wait(ps, deadline):
        for p in ps:
            try:
                p.wait(max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    w0 = _write_bytes()
    t0 = time.perf_counter()
    deadline = time.monotonic() + NODE_LOSS_TIMEOUT_S + 60
    try:
        logs["master"] = os.path.join(log_dir, f"{name}_master.txt")
        f = open(logs["master"], "w")
        files.append(f)
        master = subprocess.Popen(
            ["timeout", "-k", "10", str(NODE_LOSS_TIMEOUT_S + 30),
             sys.executable, "-m", "dlrover_tpu_torch.master.main",
             "--num-workers", "2"], cwd=here, stdout=subprocess.PIPE,
            stderr=f, text=True,
            env=dict(env, DLROVER_TPU_TRACE_ROLE="master"))
        procs.append(master)
        watch = _MasterMetrics(logs["master"])
        addr = master.stdout.readline().strip().split("=", 1)[1]
        n0, n1 = launch(0, "n0"), launch(1, "n1")
        wait([n1], deadline)
        rec["node1_rc"] = n1.returncode
        rec["node1_exit_s"] = time.perf_counter() - t0
        # the platform: what node 1 staged, then a fresh host without it
        segs = [os.path.basename(p) for p in
                glob.glob(f"/dev/shm/*{run}_n1_*")]
        rec["node1_segments"] = segs
        if segs:
            rec["staged"] = _staged_pack(segs[0])
        for s in segs:
            unlink_shared_memory(attach_shared_memory(s))
        rec["replacement_at_s"] = time.perf_counter() - t0
        n1b = launch(1, "n1b")
        wait([n0, n1b], deadline)
        rec["rcs"] = [n0.returncode, n1b.returncode]
        wait([master], time.monotonic() + 30)
        rec["master_metrics"] = watch.stop()
        rec["seconds"] = time.perf_counter() - t0
        rec["disk_write_bytes"] = _write_bytes() - w0
        text = {k: open(v).read() for k, v in logs.items()}
        runs = {k: _node_loss_runs(v) for k, v in text.items()
                if k != "master"}
        rec["runs"] = {k: [{x: y for x, y in r.items() if x != "steps"}
                           for r in v] for k, v in runs.items()}
        rec["diagnosed"] = re.findall(r"diagnosed node \d+ failure as \S+ "
                                      r"→ \S+", text["master"])
        rec["agent_peak_rss_bytes"] = {
            k: [int(m) for m in re.findall(
                r"agent of node \d+ exits \(rc -?\d+\): peak_rss_bytes=(\d+)",
                v)] for k, v in text.items() if k != "master"}
        every = [r for v in runs.values() for r in v]
        losses = {}
        for r in every:
            for s, st in r["steps"].items():
                losses.setdefault(f"{st['rank']}:{s}", []).append(st["loss"])
        rec["losses"] = losses
        rec["launches"] = {k: sum(st["launches"].get(k, 0) for r in every
                                  for st in r["steps"].values())
                           for k in per_step}
        rec["launches_per_step_ok"] = all(
            st["launches"] == per_step for r in every
            for st in r["steps"].values())
        final = {"n0": runs["n0"][-1] if runs.get("n0") else {},
                 "n1b": runs["n1b"][-1] if runs.get("n1b") else {}}
        rec["final_restores"] = {k: r.get("restore") for k, r in
                                 final.items()}
        rec["final_samplers"] = {k: r.get("sampler") for k, r in
                                 final.items()}
        try:
            rec.update(_node_loss_readings(trace_dir, runs, rec))
        except Exception as exc:  # noqa: BLE001 — a missing mark: fail
            rec["readings_error"] = repr(exc)
    finally:
        if watch is not None:
            watch.stop()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
        leftovers = [f for f in os.listdir("/dev/shm") if run in f]
        for f in leftovers:
            unlink_shared_memory(attach_shared_memory(f))
        socks = [s for d in glob.glob(os.path.join(out, "sock*"))
                 for s in os.listdir(d)]
        rec["left_behind"] = leftovers + socks
        shutil.rmtree(out, ignore_errors=True)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    n0r = (rec.get("final_restores") or {}).get("n0") or {}
    n1r = (rec.get("final_restores") or {}).get("n1b") or {}
    staged = rec.get("staged", {})
    groups = [r["group"] for v in rec.get("runs", {}).values() for r in v]
    rerun = [k for k, v in rec.get("losses", {}).items() if len(v) > 1]
    want_sampler = NODE_LOSS_AT * TRAIN_BATCH
    rec["checks"] = checks = {
        "diagnosed_hardware_relaunch": rec.get("diagnosed", [])[:1] == [
            "diagnosed node 1 failure as hardware_error → relaunch_node"],
        "node1_agent_rc_2": rec.get("node1_rc") == 2,
        "node1_segment_unlinked_and_replaced": len(
            rec.get("node1_segments", [])) == 1
        and staged.get("step") == NODE_LOSS_AT,
        "node1_replica_from_holder_0": n1r.get("tier") == "replica"
        and n1r.get("holder") == 0,
        "node0_memory": n0r.get("tier") == "memory",
        "same_step": n0r.get("step") == n1r.get("step") == NODE_LOSS_AT,
        "restored_pack_is_the_staged": staged.get("digest") is not None
        and n1r.get("digest") == staged["digest"]
        and n1r.get("fetch_nbytes") == staged["nbytes"],
        "flipped_byte_caught": staged.get("flipped_digest") not in (
            None, staged.get("digest")),
        "sampler_resumed": len(rec.get("final_samplers") or {}) == 2
        and all((s or {}).get("completed") == want_sampler
                for s in rec["final_samplers"].values()),
        "reruns_bit_for_bit": all(len(set(v)) == 1
                                  for v in rec.get("losses", {}).values())
        and {f"0:{NODE_LOSS_AT + 1}", f"1:{NODE_LOSS_AT + 1}"} <= set(rerun),
        "gloo_world_2_on_the_device": bool(groups) and all(
            g.startswith("process group gloo world 2 rank ")
            and f"device {device}" in g for g in groups),
        "no_rebuild": all(r["kernels"] and r["kernels"]["compiled_s"] == 0
                          for v in rec.get("runs", {}).values() for r in v),
        "launches_exact": rec.get("launches_per_step_ok") is True,
        "both_done": rec.get("rcs") == [0, 0],
        "disk_writes_under_1_gib": rec.get("disk_write_bytes", 1 << 40)
        < (1 << 30),
        "readings": "readings_error" not in rec,
        "nothing_left_behind": rec["left_behind"] == [],
        # the master's endpoint: node 1 lost once
        **_goodput_checks(rec.get("master_metrics", {}),
                          rec.get("failure_to_first_step_back_s"),
                          rec.get("seconds", 0.0), 1),
    }
    rec["ok"] = all(checks.values())
    emit(rec)
    if not rec["ok"]:
        _failures.append(f"{name}: {[k for k, v in checks.items() if not v]}")
    return rec


def _node_loss_readings(trace_dir, runs, rec):
    """The recovery's phases on the shared clock, from the failure (node
    1's ``worker.crash``) to the replacement's first step: detect (node
    1's agent sees the exit), diagnosis (the master's verdict reaches the
    agent by heartbeat), relaunch (the agent acts, exits; the platform
    reads and unlinks the segment and starts the replacement, which
    registers), rendezvous, start (spawn to the restore: process start,
    card, group, kernels, model), replica fetch, restore (the rest of
    it), first step; the fetch's bytes and rate; the step at dp 2; peak
    host RSS a node."""
    ev = _trace_events(trace_dir)
    agents = ev.get("agent", [])
    workers = ev.get("worker", [])
    crash = next(_ev(w, "worker.crash") for w in workers
                 if _ev(w, "worker.crash"))
    node1 = [a for a in agents
             if any(e.get("args", {}).get("node") == 1 for e in a)]
    lost, repl = node1[0], node1[-1]
    seen = next(e for e in lost if e["name"] == "failover.worker_exit")
    told = next(e for e in lost if e["name"] == "failover.action"
                and e["args"].get("action") == "relaunch_node")
    acted = _ev(lost, "failover.relaunch")
    rdzv = _ev(repl, "failover.rendezvous")
    w_repl = next(w for w in workers
                  if (_ev(w, "failover.restore") or {}).get(
                      "args", {}).get("tier") == "replica")
    restore = _ev(w_repl, "failover.restore")
    fetch = _ev(w_repl, "ckpt.replica_fetch")
    first = min(st["at"] for st in runs["n1b"][-1]["steps"].values())
    diagnosed = next((e for m in ev.get("master", []) for e in m
                      if e["name"] == "failover.diagnosed"), None)
    marks = [("detect_s", _s(crash), _s(seen)),
             ("diagnosis_s", _s(seen), _s(told)),
             ("relaunch_s", _s(told), _s(rdzv)),
             ("rendezvous_s", _s(rdzv), _s(rdzv, end=True)),
             ("start_s", _s(rdzv, end=True), _s(restore)),
             ("replica_fetch_s", _s(restore), _s(fetch, end=True)),
             ("restore_s", _s(fetch, end=True), _s(restore, end=True)),
             ("first_step_s", _s(restore, end=True), first)]
    r = {"recovery": {k: b - a for k, a, b in marks},
         "failure_to_first_step_back_s": first - _s(crash),
         "agent_acted_after_told_s": _s(acted) - _s(told),
         "diagnosed_after_seen_s": (_s(diagnosed) - _s(seen)
                                    if diagnosed else None)}
    fetched = runs["n1b"][-1]["restore"]
    r["fetch_nbytes"] = fetched["fetch_nbytes"]
    r["fetch_s"] = fetched["fetch_s"]
    r["fetch_gbps"] = fetched["fetch_nbytes"] / fetched["fetch_s"] / 1e9
    # the step at dp 2: host gaps between steps not after a save, and the
    # device ms (CUDA events) of every step but a run's first
    gaps, dev = [], []
    for v in runs.values():
        for run in v:
            steps = sorted(run["steps"])
            for prev, s in zip(steps, steps[1:]):
                if prev % 2:
                    gaps.append(run["steps"][s]["at"]
                                - run["steps"][prev]["at"])
            dev += [run["steps"][s]["device_ms"] for s in steps[1:]
                    if run["steps"][s]["device_ms"] is not None]
    r["step_wall_s"] = sorted(gaps)
    r["step_device_ms"] = sorted(dev)
    r["peak_rss_bytes"] = {
        k: {"agents": rec["agent_peak_rss_bytes"].get(k, []),
            "workers": [run["rss"] for run in v]}
        for k, v in runs.items()}
    return r


# ---------------------------------------------------------------------------
# phase 11b: the live reshard, four ranks on the one card
# ---------------------------------------------------------------------------

# 5 steps, 2 after the eviction (8 before the mesh4d phase joined the
# script, 6 before the autoscale phase did)
RESHARD_LAYERS, RESHARD_STEPS, RESHARD_EVICT_AT = 2, 5, 3
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
# time comes from here, FSDP_TP_STEPS and RESHARD_STEPS); 1 layer (2
# before the fleet phases joined it: every ring block, offset and fault
# is a layer's, so one layer carries them all)
SP_LAYERS, SP_STEPS = 1, 1
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


def _rel(got, ref, dev="cpu"):
    """max |got − ref| / max |ref| over a dict of tensors (or scalars), in
    f64 on ``dev`` (the card gives the host's result, without its ~1.5 s
    a first layer's gradients of mistral-7b)."""
    if isinstance(ref, dict):
        return max(_rel(got[k], ref[k], dev) for k in ref)
    ref = torch.as_tensor(ref).to(dev, torch.float64)
    got = torch.as_tensor(got).to(dev, torch.float64)
    return float((got - ref).abs().max() / max(float(ref.abs().max()),
                                               1e-30))


def _sp_reference(cfg_name, overrides, shape, seed, dev):
    """One process's flash loss and first-layer gradients, bf16 and f32,
    on the phase's batch and weights, for the comparison."""
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
    """One rank of the sp phase (a subprocess of ``sp_check``): a gloo
    group of SP ranks on card 0 (asked for: NCCL refuses two ranks on one
    GPU), the mesh ``MeshConfig(dp=1, sp=SP)``; for each config of the
    spec and each of its ``attn_impl``s: the f32 loss and first-layer
    gradients, again with the planted fault, the bf16 ones, then SP_STEPS
    bf16 steps of ``TrainStepBuilder`` with the launch counts read around
    them. Writes its record and the values the parent compares."""
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
    from dlrover_tpu_torch.train import train_step as ts
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
    out = {"rank": rank, "group_s": group_s, "configs": {}}
    seed = spec["seed"]
    try:
        mesh = build_mesh(MeshConfig(dp=1, sp=SP))
        for run in spec["runs"]:
            name, over = run["config"], run["overrides"]
            shape = tuple(run["shape"])
            s_l = shape[1] // SP
            vals, impls = {}, out["configs"].setdefault(name, {})
            for impl in run["impls"]:
                rec = {}
                cfg32 = get_config(name, **dict(over, dtype="float32"))
                model = decoder.init(cfg32, seed=seed, device=dev,
                                     trainable=True)
                batch = _sp_batch(shape, cfg32, seed, dev)
                prefix = (batch["prefix_len"].tolist()
                          if "prefix_len" in batch else None)
                vals[(impl, "float32")] = _sp_grads(model, cfg32, batch,
                                                    mesh, impl)
                fault_rank = _fault_rank(cfg32, s_l, impl, prefix)
                rec["fault_rank"] = fault_rank
                with _planted(impl, rank, fault_rank, s_l):
                    vals[(impl, "fault")] = _sp_grads(model, cfg32, batch,
                                                      mesh, impl)
                del model
                cfg = get_config(name, **over)
                opt = make_optimizer(learning_rate=1e-4, warmup_steps=10,
                                     decay_steps=1000)
                if cuda:
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                model = decoder.init(cfg, seed=seed, device=dev,
                                     trainable=True)
                vals[(impl, "bfloat16")] = _sp_grads(model, cfg, batch, mesh,
                                                     impl)
                state = {"params": model,
                         "opt_state": opt.init(dict(model.named_parameters())),
                         "step": 0}
                step = TrainStepBuilder(cfg, opt, attn_impl=impl, device=dev,
                                        mesh=mesh).build()
                losses, wall_ms = [], []
                # the steps' all-reduces (the flat f32 gradients with the
                # loss, the mask sum; host-staged over gloo), timed inside
                # the steps: what they take of a step
                clock = _Clock(cuda)
                ts.all_reduce_ = clock.wrap(all_reduce_)
                _reset_train_launches()
                try:
                    for _ in range(SP_STEPS):
                        t = time.perf_counter()
                        state, m = step(state, batch)
                        if cuda:
                            torch.cuda.synchronize()
                        wall_ms.append((time.perf_counter() - t) * 1e3)
                        losses.append(float(m["loss"]))
                finally:
                    ts.all_reduce_ = all_reduce_
                launches = _train_launches()
                offset_launches = dict(fa.OFFSET_LAUNCHES)
                peak = torch.cuda.max_memory_allocated() if cuda else None
                want, want_off, blocks = _sp_expected(cfg, s_l, rank, impl,
                                                      prefix)
                rec.update(
                    losses=losses, step_wall_ms=wall_ms, blocks=blocks,
                    allreduce_ms=clock.seconds * 1e3 / SP_STEPS,
                    launches=launches, launches_expected=want,
                    offset_launches=offset_launches,
                    offset_launches_expected=want_off,
                    max_memory_allocated=peak,
                    finite=all(math.isfinite(x) for x in losses))
                impls[impl] = rec
                del state, model, step, m
                if cuda:
                    torch.cuda.empty_cache()
            if rank == 0:
                torch.save(vals, run["values"])
        out["rebuilt"] = len(rebuilt)
    finally:
        shutdown_distributed()
    with open(spec["out"].format(rank=rank), "w") as f:
        json.dump(out, f)


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def sp_check(configs, seed, dev, overrides=None, shapes=None):
    """The sp phase: for each config of ``configs`` ({config: {attn_impl:
    its phase name}}) the one-process references here (then freed), then
    one group of SP worker processes on card 0 (``sp_worker``) that runs
    every config in turn, each impl gated: f32 loss and first-layer
    gradients within SP_F32_TOL of one process's, the planted fault beyond
    it, bf16 within SP_BF16_LOSS_TOL / SP_BF16_GRAD_TOL, finite losses,
    every rank's launches (the offset ones apart) equal to its block map's,
    no kernel rebuilt in a worker. ``overrides`` (default: the depth cut
    to SP_LAYERS) and ``shapes`` (default SP_SHAPES), by config, size a
    rehearsal. Returns the records by phase name."""
    import shutil
    import tempfile

    out_dir = os.path.join("build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    # the workers' values (GBs of first-layer gradients) pass through
    # memory, not the disk
    vals_dir = tempfile.mkdtemp(prefix="chip_smoke_sp_", dir=(
        "/dev/shm" if os.path.isdir("/dev/shm") else None))
    try:
        return _sp_run(configs, seed, dev, overrides, shapes, out_dir,
                       vals_dir)
    finally:
        shutil.rmtree(vals_dir, ignore_errors=True)


def _sp_run(configs, seed, dev, overrides, shapes, out_dir, vals_dir):
    """``sp_check``'s references, workers and gates; the workers' values
    in ``vals_dir``."""
    runs, refs = [], {}
    for cfg_name, names in configs.items():
        over = ((overrides or {}).get(cfg_name)
                or dict(n_layer=SP_LAYERS))
        shape = (shapes or {}).get(cfg_name) or SP_SHAPES[cfg_name]
        refs[cfg_name] = _sp_reference(cfg_name, over, shape, seed, dev)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        runs.append({"config": cfg_name, "impls": list(names),
                     "overrides": over, "shape": list(shape),
                     "values": os.path.join(vals_dir,
                                            f"sp_values_{cfg_name}.pt")})
    spec = {"seed": seed, "device": str(dev), "runs": runs,
            "port": _free_port(),
            "out": os.path.join(out_dir, "sp_{rank}.json")}
    spec_path = os.path.join(out_dir, "sp_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    log_path = os.path.join(out_dir, "sp_log.txt")
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
        for names in configs.values():
            for name in names.values():
                _failures.append(f"{name}: worker exit codes {rcs}\n{tail}")
        emit({"phase": "sp", "ok": False, "exit_codes": rcs,
              "log_tail": tail})
        return {}
    ranks = []
    for r in range(SP):
        with open(spec["out"].format(rank=r)) as f:
            ranks.append(json.load(f))
    recs = {}
    for run in runs:
        cfg_name = run["config"]
        vals = torch.load(run["values"], weights_only=False)
        ref = refs[cfg_name]
        for impl, name in configs[cfg_name].items():
            f32_loss, f32_grads = vals[(impl, "float32")]
            bad_loss, bad_grads = vals[(impl, "fault")]
            bf_loss, bf_grads = vals[(impl, "bfloat16")]
            r32, rbf = ref["float32"], ref["bfloat16"]
            per_rank = [x["configs"][cfg_name][impl] for x in ranks]
            err = {"f32_loss": _rel(f32_loss, r32["loss"]),
                   "f32_grads": _rel(f32_grads, r32["grads"], dev),
                   "fault_loss": _rel(bad_loss, r32["loss"]),
                   "fault_grads": _rel(bad_grads, r32["grads"], dev),
                   "bf16_loss": _rel(bf_loss, rbf["loss"]),
                   "bf16_grads": _rel(bf_grads, rbf["grads"], dev),
                   "bf16_step1_loss": _rel(per_rank[0]["losses"][0],
                                           rbf["loss"])}
            gates = {
                "f32_within": (max(err["f32_loss"], err["f32_grads"])
                               <= SP_F32_TOL),
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
                    sum(x["offset_launches"].values()) for x in per_rank)
                    > 0),
                "no_rebuild": all(x["rebuilt"] == 0 for x in ranks),
            }
            b, s = run["shape"]
            rec = {"phase": name, "config": cfg_name,
                   "n_layer": run["overrides"].get("n_layer"),
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
                       "max_memory_allocated", "launches",
                       "offset_launches")}
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
# 2 steps (8 before the mesh4d phase joined the script); the fault 1
# (2 before the fleet phases joined it)
FSDP_TP_LAYERS, FSDP_TP_STEPS, FSDP_TP_FAULT_STEPS = 2, 2, 1
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
# 1 (2 before the fleet phases joined the script), the f32 and fault runs
# 1: at 6 and 4 a run the whole script took 1040 and 1060 s on one H100
# 80GB HBM3 at 700 W, 87-88% of its 1200 s limit, and at 3 a run 1199 s
# on a slow host
HYBRID_LAYERS, HYBRID_STEPS, HYBRID_FAULT_STEPS, HYBRID_F32_STEPS = 2, 3, 1, 1
HYBRID_WORKER_STEPS = 1
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
# a run's bf16 steps (launches, times), f32 gate steps (2 before the
# fleet phases joined the script) and fault steps
MESH4D_STEPS, MESH4D_F32_STEPS, MESH4D_FAULT_STEPS = 2, 1, 1
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


# ---------------------------------------------------------------------------
# phase 16: the master's planning loop under the operator: the operator
# process runs the job's pods on a kubelet double behind an HTTP API
# server double; the auto-scaler, driven by the Brain, grows the job from
# one node to two through a ScalePlan CRD, each node passes the network
# check on the card, and a Brain tuning revision is applied at a step
# boundary
# ---------------------------------------------------------------------------

# 8 steps: 3 at dp 1, the job held after step 3 (staged) until it grows,
# then 5 at dp 2, the revision applied after the first of them
AUTOSCALE_LAYERS, AUTOSCALE_STEPS, AUTOSCALE_GROW_AT = 2, 8, 3
AUTOSCALE_MICRO = 4          # the job's micro-batch; the revision halves it
AUTOSCALE_TIMEOUT_S = 420
AUTOSCALE_INTERVAL_S = 1.0   # the auto-scaler's period in the drill
AUTOSCALE_POLL_S = 0.5       # the agents' ParalConfigTuner period
AUTOSCALE_TEARDOWN_S = 30.0  # the deleted job's pods and the operator gone
KUBE_TOKEN_ENV = "DLROVER_TPU_KUBE_TOKEN"  # the master pod's API token
_ELASTIC_STEP = re.compile(r"\[worker\] elastic step=(\d+) rank=(\d+) "
                           r"world=(\d+) micro=(\d+) accum=(\d+) "
                           r"tuning=(\d+)")
_TUNED = re.compile(r"\[worker\] tuning v(\d+) applied before step (\d+): "
                    r"rank=(\d+) micro=(\d+) accum=(\d+) remat=(\S+) "
                    r"at=(\S+)")
_SCALE_PLAN = re.compile(r"\[master\] scale plan (\S+) worker_num=(\S+) "
                         r"launch=(\d+) at=(\S+) posted=(\S+)")
_NODE_CHECK = re.compile(r"node check ok: matmul=(\S+)s \((\d+)x\d+ bf16, "
                         r"(\d+) iterations\)")
_PLURALS = {"pods": "Pod", "services": "Service", "configmaps": "ConfigMap",
            "secrets": "Secret", "events": "Event",
            "elasticjobs": "ElasticJob", "scaleplans": "ScalePlan"}
_KUBE_PATH = re.compile(
    r"^/(?:api/v1|apis/[^/]+/[^/]+)/namespaces/(?P<ns>[^/]+)/"
    r"(?P<plural>[^/?]+)(?:/(?P<name>[^/?]+?))?(?P<sub>/status)?$")


class _KubeHandler(BaseHTTPRequestHandler):
    """The Kubernetes REST protocol over the server's ``fake`` store (the
    port's ``FakeKubeApi``): JSON bodies, ``labelSelector`` queries, the
    ``/status`` subresource, 401/404/409/410 statuses and chunked
    ``?watch=1`` streams with resourceVersions. The server's attributes
    can play an API server's other behaviours: ``expire_below_rv`` (a
    history window: an older watch resume point gets 410 Gone),
    ``rv_prefix`` (opaque, non-numeric rvs), ``send_bookmarks``,
    ``drop_streams`` and ``drop_after_each`` (streams cut at once or
    after each event); ``seen_watch_kind_rvs`` lists the resume points
    watches asked for."""

    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _send(self, code, obj):
        raw = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _route(self):
        """(kind, namespace, name, query, selector, status subresource),
        or None once an error is sent."""
        if self.headers.get("Authorization") != f"Bearer {self.server.token}":
            self._send(401, {"kind": "Status", "code": 401})
            return None
        parsed = urllib.parse.urlparse(self.path)
        m = _KUBE_PATH.match(parsed.path)
        if not m or m.group("plural") not in _PLURALS:
            self._send(404, {"kind": "Status", "code": 404})
            return None
        q = {k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()}
        sel = (dict(pair.split("=", 1)
                    for pair in q["labelSelector"].split(","))
               if "labelSelector" in q else None)
        return (_PLURALS[m.group("plural")], m.group("ns"), m.group("name"),
                q, sel, bool(m.group("sub")))

    def _body(self, kind):
        n = int(self.headers.get("Content-Length", 0))
        manifest = json.loads(self.rfile.read(n))
        manifest["kind"] = kind
        return manifest

    def _rv_out(self, rv):
        return f"{getattr(self.server, 'rv_prefix', '')}{rv}"

    def _rv_in(self, raw):
        prefix = getattr(self.server, "rv_prefix", "")
        if prefix and raw.startswith(prefix):
            raw = raw[len(prefix):]
        return int(raw) if raw.isdigit() else 0

    def _chunk(self, payload):
        raw = (json.dumps(payload) + "\n").encode()
        self.wfile.write(f"{len(raw):x}\r\n".encode() + raw + b"\r\n")
        self.wfile.flush()

    def do_GET(self):  # noqa: N802
        route = self._route()
        if route is None:
            return
        kind, ns, name, q, sel, _ = route
        fake = self.server.fake
        if name:
            obj = fake.get(kind, name, ns)
            if obj is None:
                self._send(404, {"kind": "Status", "code": 404})
            else:
                self._send(200, obj)
            return
        if q.get("watch") == "1":
            self._watch(kind, ns, sel, q.get("resourceVersion", "0"))
            return
        items = fake.list(kind, ns, label_selector=sel)
        for it in items:  # list items come without their kind
            it.pop("kind", None)
        self._send(200, {"kind": f"{kind}List", "items": items,
                         "metadata": {"resourceVersion":
                                      self._rv_out(fake.latest_rv())}})

    def _watch(self, kind, ns, sel, raw_rv):
        server = self.server
        server.seen_watch_kind_rvs.append((kind, raw_rv))
        since = self._rv_in(raw_rv)
        if getattr(server, "expire_below_rv", 0) > since > 0:
            self._send(410, {"kind": "Status", "code": 410})
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        if getattr(server, "drop_streams", False):
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
            return
        stop = _Either(threading.Event(), server.closing)
        try:
            for ev in server.fake.watch(kind=kind, namespace=ns,
                                        label_selector=sel, since_rv=since,
                                        stop=stop, poll_s=0.05):
                obj = dict(ev.obj)
                obj.setdefault("metadata", {})["resourceVersion"] = (
                    self._rv_out(ev.resource_version))
                obj.pop("kind", None)
                self._chunk({"type": ev.type, "object": obj})
                if getattr(server, "send_bookmarks", False):
                    self._chunk({"type": "BOOKMARK", "object": {"metadata": {
                        "resourceVersion": self._rv_out(
                            ev.resource_version)}}})
                if getattr(server, "drop_after_each", False):
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                    return
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            stop.first.set()

    def do_POST(self):  # noqa: N802
        route = self._route()
        if route is None:
            return
        try:
            out = self.server.fake.create(self._body(route[0]))
        except ValueError:
            self._send(409, {"kind": "Status", "code": 409})
            return
        self._send(201, out)

    def do_PUT(self):  # noqa: N802
        route = self._route()
        if route is None:
            return
        kind, ns, name, _, _, sub = route
        manifest = self._body(kind)
        fake = self.server.fake
        if sub:  # the status subresource persists .status alone
            out = fake.update_status(kind, name, manifest.get("status") or {},
                                     ns)
        else:
            try:
                out = fake.update(manifest)
            except KeyError:
                out = None
        if out is None:
            self._send(404, {"kind": "Status", "code": 404})
        else:
            self._send(200, out)

    def do_DELETE(self):  # noqa: N802
        route = self._route()
        if route is None:
            return
        kind, ns, name, _, _, _ = route
        self.server.fake.delete(kind, name, ns)
        self._send(200, {"kind": "Status", "status": "Success"})


class _Either:
    """A stop flag set when either event is."""

    def __init__(self, first, second):
        self.first, self.second = first, second

    def is_set(self):
        return self.first.is_set() or self.second.is_set()


class KubeFacade:
    """An API server double: the port's ``FakeKubeApi`` behind the
    Kubernetes REST protocol (``_KubeHandler``) on 127.0.0.1, taking the
    bearer ``token``. ``start()`` returns its URL; ``stop()`` ends it and
    every watch stream it serves."""

    def __init__(self, token, fake=None):
        from http.server import ThreadingHTTPServer

        from dlrover_tpu_torch.cluster.kube import FakeKubeApi

        self.fake = fake or FakeKubeApi()
        self.server = ThreadingHTTPServer(("127.0.0.1", 0), _KubeHandler)
        self.server.daemon_threads = True
        self.server.fake = self.fake
        self.server.token = token
        self.server.closing = threading.Event()
        self.server.seen_watch_kind_rvs = []
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.url

    def stop(self):
        self.server.closing.set()
        self.server.shutdown()
        self.server.server_close()


class Kubelet:
    """The kubelet double of the autoscale phase: it watches the ``api``
    store's Pods, runs each new pod's container command as a process
    with the pod's environment (``secretKeyRef`` values read from the
    Secret in the store, a Service's ``<name>.<namespace>.svc`` resolved
    to 127.0.0.1), sets the pod ``Running`` when the process starts and
    ``Succeeded`` or ``Failed`` (reason ``Completed``/``Error``) when it
    exits, and stops a deleted pod's process. One host stands in for
    many here, so each pod also gets what its own filesystem would give
    it: its own socket directory, parallel-config document and run id
    (the operator gives every pod the job's name, and segments named
    after it would collide), and its own address. Every line a pod
    prints goes to ``lines`` as (time, line, pod) and to ``log`` with
    the pod's name; the kubelet's own lines start with ``[kubelet]``.
    ``pods`` records each pod: its node id, when it was added, started,
    exited and deleted, and its exit code."""

    def __init__(self, api, workdir, env, lines, log, deadline_s,
                 namespace="default"):
        self.api, self.workdir, self.env = api, workdir, env
        self.lines, self.log, self.ns = lines, log, namespace
        self.deadline_s = deadline_s
        self.pods = {}
        self._procs = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = []

    def say(self, text):
        line = f"[kubelet] {text} at={time.time():.6f}\n"
        self._emit(line, "kubelet")

    def _emit(self, line, pod):
        with self._lock:
            self.lines.append((time.time(), line, pod))
            self.log.write(line if pod == "kubelet" else f"[{pod}] {line}")
            self.log.flush()

    def start(self):
        t = threading.Thread(target=self._watch, name="kubelet", daemon=True)
        t.start()
        self._threads.append(t)

    def _watch(self):
        for ev in self.api.watch(kind="Pod", namespace=self.ns, since_rv=0,
                                 stop=self._stop, poll_s=0.05):
            name = ev.name
            if ev.type == "ADDED" and name not in self.pods:
                self._run_pod(ev.obj)
            elif ev.type == "DELETED" and name in self.pods:
                self.pods[name]["deleted_at"] = time.time()
                self.say(f"pod {name} deleted")
                proc = self._procs.get(name)
                if proc is not None and proc.poll() is None:
                    proc.terminate()

    def _resolve_env(self, pod):
        env = dict(self.env)
        cont = pod["spec"]["containers"][0]
        for e in cont.get("env") or []:
            ref = (e.get("valueFrom") or {}).get("secretKeyRef")
            if ref is None:
                env[e["name"]] = str(e.get("value", ""))
                continue
            secret = self.api.get("Secret", ref["name"], self.ns)
            if secret is None:
                raise KeyError(f"secret {ref['name']} not found")
            if ref["key"] in (secret.get("stringData") or {}):
                env[e["name"]] = secret["stringData"][ref["key"]]
            else:
                import base64

                env[e["name"]] = base64.b64decode(
                    secret["data"][ref["key"]]).decode()
        hosts = [f"{s['metadata']['name']}.{self.ns}.svc"
                 for s in self.api.list("Service", self.ns)]
        cmd = list(cont["command"])
        for host in hosts:
            env = {k: v.replace(host, "127.0.0.1") for k, v in env.items()}
            cmd = [a.replace(host, "127.0.0.1") for a in cmd]
        name = pod["metadata"]["name"]
        own = os.path.join(self.workdir, name)
        os.makedirs(own, exist_ok=True)
        env.update(DLROVER_TPU_SOCK_DIR=os.path.join(own, "sock"),
                   DLROVER_TPU_PARAL_CONFIG=os.path.join(own, "paral.json"),
                   DLROVER_TPU_RUN_ID=name,
                   DLROVER_TPU_HOST_ADDR="127.0.0.1")
        return cmd, env

    def _run_pod(self, pod):
        name = pod["metadata"]["name"]
        rec = self.pods[name] = {"added_at": time.time()}
        self.say(f"pod {name} added")
        try:
            cmd, env = self._resolve_env(pod)
        except KeyError as e:
            self.api.set_pod_phase(name, "Failed", "CreateContainerConfigError",
                                   self.ns)
            self.say(f"pod {name} failed: {e}")
            rec.update(rc=None, exited_at=time.time())
            return
        rec["node_id"] = env.get("DLROVER_TPU_NODE_ID")
        try:
            proc = subprocess.Popen(
                ["timeout", "-k", "10", str(self.deadline_s)] + cmd,
                env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            self.api.set_pod_phase(name, "Failed", "StartError", self.ns)
            self.say(f"pod {name} failed to start: {e}")
            rec.update(rc=None, exited_at=time.time())
            return
        self._procs[name] = proc
        rec.update(started_at=time.time(), pid=proc.pid)
        self.api.set_pod_phase(name, "Running", namespace=self.ns)
        self.say(f"pod {name} started pid={proc.pid}")
        t = threading.Thread(target=self._follow, args=(name, proc),
                             daemon=True)
        t.start()
        self._threads.append(t)

    def _follow(self, name, proc):
        for line in proc.stdout:
            self._emit(line, name)
        rc = proc.wait()
        rec = self.pods[name]
        rec.update(rc=rc, exited_at=time.time())
        self.say(f"pod {name} exited rc={rc}")
        if "deleted_at" not in rec:
            try:
                self.api.set_pod_phase(name, "Succeeded" if rc == 0
                                       else "Failed",
                                       "Completed" if rc == 0 else "Error",
                                       self.ns)
            except KeyError:
                pass  # deleted meanwhile

    def running(self):
        """The pods added and not yet exited."""
        return [n for n, r in list(self.pods.items()) if "exited_at" not in r]

    def stop(self):
        """Stop watching and kill what still runs."""
        self._stop.set()
        for proc in self._procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for t in self._threads:
            t.join(10)


def autoscale_master(argv):
    """The master pod's command in the autoscale phase (``chip_smoke.py
    --autoscale-master``): the port's ``DistributedJobMaster`` with the
    platform attached as the JAX package's tests attach it — a scaler
    whose ``scale(plan)`` posts ``SliceScaler.to_scale_plan_crd(plan)``
    through ``RealKubeApi`` (the operator's reconciler acts on it) and a
    ``PodWatcher`` over ``RealKubeApi`` feeding the job manager's
    ``process_event``. The API token comes from ``KUBE_TOKEN_ENV``. Its
    lines start with ``[master]``."""
    from dlrover_tpu_torch.cluster.crd import ElasticJob
    from dlrover_tpu_torch.cluster.kube import PodWatcher
    from dlrover_tpu_torch.cluster.kube_http import RealKubeApi
    from dlrover_tpu_torch.cluster.scaler import SliceScaler
    from dlrover_tpu_torch.master.master import DistributedJobMaster
    from dlrover_tpu_torch.master.node_manager import Scaler

    ap = argparse.ArgumentParser(prog="chip_smoke.py --autoscale-master")
    ap.add_argument("--kube-url", required=True)
    ap.add_argument("--namespace", default="default")
    ap.add_argument("--job-name", required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--num-workers", type=int, default=1)
    ap.add_argument("--max-workers", type=int, default=1)
    ap.add_argument("--optimize-mode", default="single-job")
    ap.add_argument("--brain-addr", default="")
    args = ap.parse_args(argv)
    api = RealKubeApi(args.kube_url, token=os.environ[KUBE_TOKEN_ENV])
    job = ElasticJob.from_manifest(api.get("ElasticJob", args.job_name,
                                           args.namespace))
    render = SliceScaler(job)

    class CrdScaler(Scaler):
        def __init__(self):
            self.posted = 0

        def scale(self, plan):
            at = time.time()
            self.posted += 1
            crd = render.to_scale_plan_crd(plan)
            crd.name = f"{job.name}-scaleplan-{self.posted}"
            api.create(crd.to_manifest())
            print(f"[master] scale plan {crd.name} "
                  f"worker_num={plan.worker_num} "
                  f"launch={len(plan.launch_nodes)} at={at:.6f} "
                  f"posted={time.time():.6f}", flush=True)

    master = DistributedJobMaster(
        port=args.port, num_workers=args.num_workers,
        max_workers=args.max_workers, scaler=CrdScaler(),
        optimize_mode=args.optimize_mode, brain_addr=args.brain_addr,
        job_name=args.job_name)
    watcher = PodWatcher(api, job.name, master.job_manager.process_event,
                         namespace=args.namespace)
    master.prepare()
    watcher.start()
    print(f"[master] DLROVER_TPU_MASTER_ADDR={master.addr}", flush=True)
    try:
        reason = master.run()
    finally:
        watcher.stop()
    print(f"[master] exit reason {reason}", flush=True)
    return 0 if reason == "succeeded" else 1


def autoscale_launcher(argv):
    """A worker pod's command in the autoscale phase (``chip_smoke.py
    --autoscale-launcher``): the port's launcher on ``argv``, its
    ``ParalConfigTuner`` polling every ``AUTOSCALE_POLL_S`` (the
    launcher's command line keeps the JAX launcher's 30 s)."""
    from dlrover_tpu_torch.agent import launcher

    return launcher.run(launcher.parse_args(argv),
                        config_interval_s=AUTOSCALE_POLL_S)


def autoscale_reference(cfg, seed, dev, steps, overrides=(), reverse=False):
    """The undisturbed stream the drill is held to: one process, each
    step's global batch (``sample_batch`` over the step's samples, as the
    worker's ranks slice it) in micro-batches of ``AUTOSCALE_MICRO``,
    the worker's optimizer and config (remat "full", its
    ``overrides``); ``reverse``: in micro-batches of half that (the
    revised size), in the reverse order (with two micro-batches a
    reversal alone sums the same). [(loss, grad_norm)] a step."""
    from dlrover_tpu_torch.examples import train_gpt_elastic as ex
    from dlrover_tpu_torch.models.config import get_config
    from dlrover_tpu_torch.train.optimizer import make_optimizer
    from dlrover_tpu_torch.train.train_step import (
        TrainStepBuilder,
        init_train_state,
    )

    fields = dict(n_layer=cfg.n_layer, remat="full")
    for item in overrides:
        key, _, value = item.partition("=")
        fields[key] = json.loads(value)
    cfg = get_config(cfg.name, max_seq=TRAIN_SEQ, **fields)
    opt = make_optimizer(learning_rate=ex.LR, warmup_steps=ex.WARMUP,
                         decay_steps=ex.DECAY)
    state = init_train_state(seed, cfg, opt, device=dev)
    micro = AUTOSCALE_MICRO // 2 if reverse else AUTOSCALE_MICRO
    accum = TRAIN_BATCH // micro
    step = TrainStepBuilder(cfg, opt, grad_accum=accum, device=dev).build()
    out = []
    for s in range(1, steps + 1):
        lo = (s - 1) * TRAIN_BATCH
        batch = ex.sample_batch(seed, range(lo, lo + TRAIN_BATCH), TRAIN_SEQ,
                                cfg.vocab_size)
        if reverse:
            batch = {k: v.reshape((accum, micro) + v.shape[1:])
                     [::-1].reshape(v.shape) for k, v in batch.items()}
        state, m = step(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    del state, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _autoscale_wait(lines, pattern, deadline, done, pod=None):
    """The first match of ``pattern`` among ``lines`` (a list other
    threads append (time, line, pod) to; only ``pod``'s lines when
    given) as (time, match), or None at the deadline or once ``done()``
    holds and every line has been read."""
    seen = 0
    while time.monotonic() < deadline:
        while seen < len(lines):
            at, line, who = lines[seen]
            seen += 1
            m = pattern.search(line) if pod in (None, who) else None
            if m:
                return at, m
        if done() and seen >= len(lines):
            return None
        time.sleep(0.05)
    return None


def _autoscale_job(name, url, master_port, worker, job_env, network_check):
    """The phase's ElasticJob: one worker replica growing to two nodes of
    one GPU each (``max_hosts`` 2, ``optimizeMode: cluster``), each node
    the port's launcher (``autoscale_launcher``, with ``--network-check``
    when ``network_check``) running ``worker``, and a user-declared
    master replica (``autoscale_master``) reading the API token from a
    Secret the phase writes."""
    from dlrover_tpu_torch.cluster.crd import (
        ElasticJob,
        ElasticJobSpec,
        GPUSliceSpec,
        ReplicaSpec,
    )

    here = os.path.abspath(__file__)
    node = [sys.executable, here, "--autoscale-launcher", "--nnodes", "1:2",
            "--nproc", "1", "--max-restarts", "0", "--monitor-interval",
            "0.2"]
    if network_check:
        node.append("--network-check")
    master = [sys.executable, here, "--autoscale-master", "--kube-url", url,
              "--job-name", name, "--port", str(master_port),
              "--num-workers", "1", "--max-workers", "2"]
    gpu = GPUSliceSpec(gpus_per_host=1)
    return ElasticJob(name, spec=ElasticJobSpec(
        optimize_mode="cluster", min_hosts=1, max_hosts=2, replica_specs={
            "worker": ReplicaSpec(replicas=1, image="chip-smoke",
                                  command=node + ["--", *worker],
                                  env=dict(job_env), slice=gpu),
            "master": ReplicaSpec(replicas=1, image="chip-smoke",
                                  command=master, cpu="2", memory="4Gi",
                                  env=dict(job_env), secret_env={
                                      KUBE_TOKEN_ENV: (f"{name}-api-token",
                                                       "token")})}))


def autoscale_check(cfg, seed, name="autoscale", device="cuda", overrides=(),
                    train_peak_bytes=None):
    """The master's planning loop on the card, under the operator. This
    process holds the API server (``KubeFacade``, the port's
    ``FakeKubeApi`` over HTTP) and the kubelet (``Kubelet``); a Brain
    process (``python -m dlrover_tpu_torch.cluster.brain``) and the
    operator (``python -m dlrover_tpu_torch.cluster.operator``, leader
    on its lease, the Brain's address to append to a cluster-mode
    master) run beside them. The phase applies an ElasticJob
    (``_autoscale_job``) over HTTP: the operator mints the job's wire
    token Secret and creates the master pod (``autoscale_master``: the
    port's ``DistributedJobMaster``, its auto-scaler over a
    ``BrainClient``, its scaler posting ScalePlan CRDs, its pod watcher),
    the master Service and worker pod 0, which the kubelet starts. Node
    0's launcher runs the network check on the card, then the worker:
    the elastic example's ``--micro-batch`` loop (``ElasticTrainer``,
    the replicated step, every rank on card 0 over gloo), llama-1.4b at
    full width, ``AUTOSCALE_LAYERS`` layers, remat "full", the global
    batch ``TRAIN_BATCH`` × ``TRAIN_SEQ`` at every world size; after
    step ``AUTOSCALE_GROW_AT`` (staged to memory; the checkpoints on
    /dev/shm) it holds until the world grows. The Brain plans 2, the
    auto-scaler clamps it to [1, 2], the master posts a ScalePlan, the
    operator's reconciler creates pod 1 and marks the plan
    ``Succeeded``, the kubelet starts node 1, which passes its network
    check and joins; node 0's agent persists the staged step and both
    restart into dp 2 (the accumulation re-derived). After the first
    dp-2 step this process plays the failure classifier: a
    ``BrainTuner`` held on the job's plan (remat "full", micro-batch
    ``AUTOSCALE_MICRO``) is given a planted OOM (``on_failure("oom")``:
    the drill tests the loop, not an OOM); the revision (the micro-batch
    halved) is versioned by the master's ``plan_tuning``
    (``brain.master_report``), the agents' ``ParalConfigTuner`` write
    it, and each worker rebuilds its step once at a step boundary
    (``ElasticTrainer.apply_tuning``). When the job has ended the phase
    deletes the ElasticJob; the operator tears down its pods, Service,
    Secret and ScalePlans, and the operator is stopped (SIGTERM). Every
    step's loss and grad norm are held to ``autoscale_reference`` (one
    process, the same global batches) within the reshard phase's
    tolerances; ``order_spread`` reads the reference against itself at
    the revised micro-batch, its micro-batches reversed. ``device``,
    ``overrides`` serve a rehearsal on the CPU at a cut size, where the
    nodes run without ``--network-check`` (the node check needs a GPU)."""
    import secrets
    import shutil
    import signal
    import tempfile

    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.cluster.brain import (
        BrainTuner,
        TuningPlan,
        estimate_hbm_bytes,
        master_report,
    )
    from dlrover_tpu_torch.cluster.kube import JOB_LABEL
    from dlrover_tpu_torch.cluster.kube_http import RealKubeApi
    from dlrover_tpu_torch.common.multi_process import (
        attach_shared_memory,
        unlink_shared_memory,
    )
    from dlrover_tpu_torch.examples.train_gpt_elastic import launches
    from dlrover_tpu_torch.models.config import get_config

    here = os.path.dirname(os.path.abspath(__file__))
    log_dir = os.path.join(here, "build", "chip_smoke")
    os.makedirs(log_dir, exist_ok=True)
    out = tempfile.mkdtemp(prefix="dlrover_autoscale_")
    shm_dir = "/dev/shm" if os.path.isdir("/dev/shm") else None
    ckpt_dir = tempfile.mkdtemp(prefix="dlrover_autoscale_ckpt_",
                                dir=shm_dir)
    job_name = f"autoscale-{os.getpid()}"
    trace_dir = os.path.join(out, "trace")
    os.makedirs(trace_dir)
    network_check = device != "cpu"
    # what every pod of the job is given: the drill's periods and the
    # trace directory (the job's env), on the machine's own (the image's)
    job_env = {"DLROVER_TPU_COORDINATOR_PORT": "0",
               "DLROVER_TPU_TRACE_DIR": trace_dir,
               "DLROVER_TPU_CTX_AUTOSCALE_INTERVAL_S":
                   str(AUTOSCALE_INTERVAL_S),
               "DLROVER_TPU_CTX_RDZV_WAIT_EXTRA_NODES_S": "1"}
    host_env = {k: v for k, v in os.environ.items()
                if not k.startswith("DLROVER_TPU_")}
    host_env["TMPDIR"] = out
    worker = [sys.executable, "-m",
              "dlrover_tpu_torch.examples.train_gpt_elastic", "--model",
              cfg.name, "--override", f"n_layer={cfg.n_layer}",
              "--override", 'remat="full"', "--steps", str(AUTOSCALE_STEPS),
              "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
              "--seed", str(seed), "--ckpt-dir", ckpt_dir, "--ckpt-every",
              str(AUTOSCALE_GROW_AT), "--micro-batch",
              str(AUTOSCALE_MICRO), "--grow-at", str(AUTOSCALE_GROW_AT),
              "--one-card", "--device", device]
    for item in overrides:
        worker += ["--override", item]
    full = get_config(cfg.name, max_seq=TRAIN_SEQ)
    rec = {"phase": name, "config": cfg.name, "n_layer": cfg.n_layer,
           "remat": "full", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": AUTOSCALE_STEPS, "grow_at": AUTOSCALE_GROW_AT,
           "micro": AUTOSCALE_MICRO, "nodes": "1:2", "job": job_name,
           "network_check": network_check,
           "autoscale_interval_s": AUTOSCALE_INTERVAL_S,
           "config_poll_s": AUTOSCALE_POLL_S, "card": nvidia_smi_line(),
           # the cold-start planner's memory model against the full-depth
           # train phase's measured peak (remat "none", b8 x s1024)
           "hbm_estimate": {
               "config": full.name, "n_layer": full.n_layer, "batch": 8,
               "seq": TRAIN_SEQ, "remat": "none",
               "estimate_bytes": estimate_hbm_bytes(full, 8, TRAIN_SEQ,
                                                    "none"),
               "estimate_bytes_f32_state": estimate_hbm_bytes(
                   full, 8, TRAIN_SEQ, "none", state_dtype="float32"),
               "train_phase_peak_bytes": train_peak_bytes}}
    lines, procs, files = [], [], []
    token = secrets.token_hex(16)
    facade = KubeFacade(token)
    store = facade.fake
    status_seen, plan_phases = [], {}
    polling = threading.Event()

    def poll_status():
        """The job's status and its ScalePlans' phases as the store
        holds them, every 0.1 s."""
        while not polling.wait(0.1):
            ej = store.get("ElasticJob", job_name) or {}
            workers = (ej.get("status") or {}).get(
                "replicaStatuses", {}).get("worker", {})
            if not status_seen or status_seen[-1][1] != workers:
                status_seen.append((time.time(), workers))
            for sp in store.list("ScalePlan",
                                 label_selector={JOB_LABEL: job_name}):
                plan_phases[sp["metadata"]["name"]] = (
                    sp.get("status") or {}).get("phase", "")

    def pump(stream, f, who):
        for line in stream:
            lines.append((time.time(), line, who))
            f.write(line)
            f.flush()

    log_path = os.path.join(log_dir, f"{name}_log.txt")
    t0 = time.perf_counter()
    deadline = time.monotonic() + AUTOSCALE_TIMEOUT_S
    kubelet = operator = None
    client = None
    try:
        url = facade.start()
        api = RealKubeApi(url, token=token)
        f = open(os.path.join(log_dir, f"{name}_brain.txt"), "w")
        files.append(f)
        brain = subprocess.Popen(
            ["timeout", "-k", "10", str(AUTOSCALE_TIMEOUT_S + 30),
             sys.executable, "-m", "dlrover_tpu_torch.cluster.brain",
             "--port", str(_free_port())], cwd=here,
            stdout=subprocess.PIPE, stderr=f, text=True, env=host_env)
        procs.append(brain)
        brain_addr = brain.stdout.readline().strip().split("=", 1)[-1]
        rec["brain_addr"] = brain_addr
        f = open(log_path, "w")
        files.append(f)
        kubelet = Kubelet(store, out, host_env, lines, f,
                          AUTOSCALE_TIMEOUT_S)
        kubelet.start()
        master_port, health_port = _free_port(), _free_port()
        g = open(os.path.join(log_dir, f"{name}_operator.txt"), "w")
        files.append(g)
        t_op = time.time()
        operator = subprocess.Popen(
            ["timeout", "-k", "10", str(AUTOSCALE_TIMEOUT_S + 60),
             sys.executable, "-m", "dlrover_tpu_torch.cluster.operator",
             "--kube-url", url, "--token", token, "--brain-addr",
             brain_addr, "--master-port", str(master_port),
             "--health-port", str(health_port)], cwd=here,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=host_env)
        procs.append(operator)
        threading.Thread(target=pump, args=(operator.stdout, g, "operator"),
                         daemon=True).start()
        health = None
        while time.monotonic() < deadline and operator.poll() is None:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{health_port}/healthz",
                        timeout=2) as r:
                    health = json.loads(r.read())
                if health.get("leading"):
                    break
            except OSError:
                pass
            time.sleep(0.1)
        rec["operator_health"] = health
        rec["operator_leading_s"] = time.time() - t_op
        threading.Thread(target=poll_status, daemon=True).start()
        store.create({"apiVersion": "v1", "kind": "Secret",
                      "metadata": {"name": f"{job_name}-api-token",
                                   "namespace": "default"},
                      "type": "Opaque", "stringData": {"token": token}})
        job = _autoscale_job(job_name, url, master_port, worker, job_env,
                             network_check)
        rec["apply_at"] = time.time()
        api.create(job.to_manifest())

        def ended():  # the job's pods have run, or the operator died
            return operator.poll() is not None or (
                bool(kubelet.pods) and not kubelet.running())

        grown = _autoscale_wait(
            lines, re.compile(r"\[worker\] elastic step=\d+ rank=0 world=2 "),
            deadline, ended)
        if grown is not None:
            # the failure classifier's verdict, planted
            client = MasterClient(f"127.0.0.1:{master_port}", node_id=0)
            tuner = BrainTuner(TuningPlan(version=0, remat="full",
                                          batch_size=AUTOSCALE_MICRO),
                               report=master_report(client), cooldown_s=0.0)
            rec["revision_at"] = time.time()
            rev = tuner.on_failure("oom", "planted by the drill")
            rec["revision"] = {"version": rev.version, "knob": rev.knob,
                               "batch_size": rev.batch_size,
                               "reason": rev.reason}
            rec["master_tuning_version"] = client.get_tuning().version
        # the job ends: every pod's process exits
        while time.monotonic() < deadline and not ended():
            time.sleep(0.1)
        rec["job_s"] = time.time() - rec["apply_at"]
        rec["delete_at"] = time.time()
        api.delete("ElasticJob", job_name)
        torn = time.monotonic() + AUTOSCALE_TEARDOWN_S
        while time.monotonic() < torn and (kubelet.running() or any(
                store.list(k, label_selector={JOB_LABEL: job_name})
                for k in ("Pod", "ScalePlan")) or store.get(
                    "Service", f"{job_name}-master") or store.get(
                        "Secret", f"{job_name}-wire-token")):
            time.sleep(0.05)
        rec["torn_down_at"] = time.time()
        operator.send_signal(signal.SIGTERM)
        try:
            rec["operator_rc"] = operator.wait(
                max(0.1, torn - time.monotonic()))
        except subprocess.TimeoutExpired:
            rec["operator_rc"] = None
        rec["operator_exited_at"] = time.time()
        store.delete("Secret", f"{job_name}-api-token")
        rec["left_in_store"] = {
            k: [o["metadata"]["name"] for o in store.list(k)]
            for k in ("Pod", "Service", "Secret", "ScalePlan", "ElasticJob")}
        rec["seconds"] = time.perf_counter() - t0
    finally:
        polling.set()
        if kubelet is not None:
            rec["pods_running_at_end"] = kubelet.running()
            kubelet.stop()
        for p in procs:
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        facade.stop()
        for f in files:
            f.close()
        leftovers = [f for f in os.listdir("/dev/shm")
                     if job_name in f] if shm_dir else []
        for f in leftovers:
            unlink_shared_memory(attach_shared_memory(f))
        rec["left_behind"] = leftovers
        try:
            evs = _trace_events(trace_dir)
        except OSError:
            evs = {}
        shutil.rmtree(out, ignore_errors=True)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    pods = kubelet.pods if kubelet is not None else {}
    log = "".join(line for _, line, _ in lines)
    steps = _rank_steps(log)
    shape = {}
    for m in _ELASTIC_STEP.finditer(log):
        shape.setdefault(int(m.group(1)), {})[int(m.group(2))] = tuple(
            int(m.group(i)) for i in range(3, 7))
    tuned = [dict(zip(("version", "step", "rank", "micro", "accum"),
                      map(int, m.groups()[:5])), remat=m.group(6),
                  at=float(m.group(7))) for m in _TUNED.finditer(log)]
    plans = [{"name": m.group(1),
              "worker_num": None if m.group(2) == "None" else int(m.group(2)),
              "launch": int(m.group(3)), "at": float(m.group(4)),
              "posted": float(m.group(5))}
             for m in _SCALE_PLAN.finditer(log)]
    brain_plans = [int(x) for x in re.findall(
        r"auto-scale: plan wants (\d+) workers", log)]
    scaled = [(int(a), int(b)) for a, b in re.findall(
        r"auto-scale: (\d+) → (\d+) workers", log)]
    agents = sorted(int(x) for x in re.findall(
        r"agent of node (\d+) exits \(rc 0\)", log))
    spans = [sum(1 for e in p if e["name"] == "brain.tuning_replan")
             for p in evs.get("worker", [])]
    workers = sorted(n for n in pods if "-worker-" in n)
    checks_by_pod = {}
    for at, line, who in lines:
        m = _NODE_CHECK.search(line)
        if m:
            secs, size, iters = float(m.group(1)), int(m.group(2)), int(
                m.group(3))
            checks_by_pod.setdefault(who, {}).update(
                matmul_s=secs, size=size, iters=iters,
                tflops=2 * size ** 3 * iters / secs / 1e12)
        if "network check status: normal=" in line:
            checks_by_pod.setdefault(who, {}).update(
                normal="normal=True faults=[] " in line, at=at)
    dev = torch.device(device)
    ref = autoscale_reference(cfg, seed, dev, AUTOSCALE_STEPS, overrides)
    reverse = autoscale_reference(cfg, seed, dev, AUTOSCALE_STEPS, overrides,
                                  reverse=True)
    grow, micro = AUTOSCALE_GROW_AT, AUTOSCALE_MICRO
    accum1 = TRAIN_BATCH // micro
    accum2 = -(-TRAIN_BATCH // (micro * 2))
    accum3 = -(-TRAIN_BATCH // (micro // 2 * 2))
    rank0 = {s: v[0]["at"] for s, v in steps.items() if 0 in v}
    first2 = min((s for s, v in shape.items() if v.get(0, (0,))[0] == 2),
                 default=None)
    new_batch = min((s for s, v in shape.items()
                     if v.get(0, (0, 0))[1] == micro // 2), default=None)

    def gaps(lo, hi):
        return sorted(rank0[s] - rank0[s - 1] for s in range(lo, hi + 1)
                      if s in rank0 and s - 1 in rank0)

    def since(t, t_from):
        return None if t is None or t_from is None else t - t_from

    def pod_time(pod, key):
        return pods.get(pod, {}).get(key)

    master_pod = f"{job_name}-master"
    pod1 = f"{job_name}-worker-1"
    plan_at = plans[0]["at"] if plans else None
    last_step = rank0.get(max(rank0)) if rank0 else None
    # the job's status in effect while dp 2 trained: the one written last
    # before its first step, and any written until its last
    dp2_status = []
    if first2 in rank0:
        lo = rank0[first2]
        dp2_status = [w for t, w in status_seen if t <= lo][-1:] + [
            w for t, w in status_seen if lo < t <= last_step]
    exits = [p.get("exited_at") for p in pods.values()]
    kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "norm_fwd",
               "norm_bwd")
    rec.update({
        "scale_plans": plans, "scale_plan_phases": plan_phases,
        # what the Brain planned: every plan the auto-scaler executed
        # (the job's count → the clamped target), and the Brain's own
        # target where the clamp to [1, 2] moved it
        "scaled": scaled, "brain_plans_clamped": brain_plans,
        "pods": pods, "job_status_seen": status_seen,
        "node_checks": checks_by_pod,
        "timeline": {
            "apply_to_master_running_s": since(pod_time(master_pod,
                                                        "started_at"),
                                               rec.get("apply_at")),
            "apply_to_first_step_s": since(rank0.get(1),
                                           rec.get("apply_at")),
            "plan_to_posted_s": since(plans[0]["posted"] if plans else None,
                                      plan_at),
            "plan_to_pod1_created_s": since(pod_time(pod1, "added_at"),
                                            plan_at),
            "plan_to_node1_started_s": since(pod_time(pod1, "started_at"),
                                             plan_at),
            "plan_to_node1_checked_s": since(
                checks_by_pod.get(pod1, {}).get("at"), plan_at),
            "plan_to_first_dp2_s": since(rank0.get(first2), plan_at),
            "delete_to_pods_gone_s": since(rec.get("torn_down_at"),
                                           rec.get("delete_at")),
            "delete_to_all_exited_s": since(max(
                [rec.get("operator_exited_at")]
                + [x for x in exits if x is not None], default=None),
                rec.get("delete_at"))},
        "shape": {s: {r: list(x) for r, x in v.items()}
                  for s, v in shape.items()},
        "tuned": tuned, "tuning_replan_spans": spans,
        "losses": {s: {r: x["loss"] for r, x in v.items()}
                   for s, v in steps.items()},
        "reference": ref, "errors": _stream_errors(steps, ref),
        "order_spread": _stream_errors(
            {s: {0: {"loss": x, "grad_norm": n}}
             for s, (x, n) in enumerate(reverse, 1)}, ref),
        "tolerances": {"loss": RESHARD_RTOL_LOSS,
                       "grad_norm": RESHARD_RTOL_NORM},
        "revision_to_new_batch_s": (
            rank0[new_batch] - rec["revision_at"]
            if new_batch in rank0 and "revision_at" in rec else None),
        "step_s_dp1": gaps(2, grow),
        "step_s_dp2": gaps(grow + 2, (new_batch or grow + 1) - 1),
        "step_s_dp2_tuned": gaps((new_batch or AUTOSCALE_STEPS) + 1,
                                 AUTOSCALE_STEPS),
        "launches": {k: sum(r["launches"].get(k, 0) for v in steps.values()
                            for r in v.values()) for k in launches()}})
    want_shape = {
        s: ({0: (1, micro, accum1, 0)} if s <= grow else
            {r: ((2, micro, accum2, 0) if new_batch is None or s < new_batch
                 else (2, micro // 2, accum3, rec.get("revision", {}).get(
                     "version", -1))) for r in (0, 1)})
        for s in range(1, AUTOSCALE_STEPS + 1)}
    deleted = rec.get("delete_at")
    rec["checks"] = checks = {
        "operator_led": bool((rec.get("operator_health") or {}).get(
            "leading")),
        "pods_rc_0": set(pods) == {master_pod, f"{job_name}-worker-0", pod1}
        and all(p.get("rc") == 0 for p in pods.values()),
        "node_ids_0_1": [pods[w].get("node_id") for w in workers]
        == ["0", "1"] and agents == [0, 1],
        "plan_target_2": bool(plans) and plans[0]["worker_num"] == 2
        and scaled[:1] == [(1, 2)],
        "scale_plan_succeeded": bool(plans) and plan_phases.get(
            plans[0]["name"]) == "Succeeded",
        "status_two_running": bool(dp2_status) and all(
            w.get("Running") == 2 for w in dp2_status),
        "network_checks_ok": network_check and sorted(checks_by_pod) == workers
        and all(c.get("normal") and c.get("matmul_s", 0) > 0
                for c in checks_by_pod.values()),
        "second_worker_joined": first2 == grow + 1,
        "accum_rederived": {s: {r: tuple(x) for r, x in v.items()}
                            for s, v in shape.items()} == want_shape
        and new_batch is not None and new_batch > first2,
        "one_rebuild_per_worker": sorted(spans) == [0, 1, 1]
        and sorted(t["rank"] for t in tuned) == [0, 1]
        and len({(t["step"], t["version"]) for t in tuned}) == 1,
        "tuning_version_is_masters": bool(tuned) and all(
            t["version"] == rec.get("master_tuning_version")
            == rec["revision"]["version"] for t in tuned),
        "losses_match": sorted(steps) == list(
            range(1, AUTOSCALE_STEPS + 1)) and rec["errors"]["within"],
        "kernels_ran": all(
            all(r["launches"].get(k, 0) > 0 for k in kernels)
            for v in steps.values() for r in v.values()),
        "torn_down_in_30s": deleted is not None
        and rec["timeline"]["delete_to_all_exited_s"] is not None
        and rec["timeline"]["delete_to_all_exited_s"]
        <= AUTOSCALE_TEARDOWN_S and rec.get("operator_rc") == 0
        and not rec.get("pods_running_at_end")
        and rec.get("left_in_store") is not None
        and not any(rec["left_in_store"].values()),
        "nothing_left_behind": rec["left_behind"] == [],
    }
    rec["ok"] = all(checks.values())
    emit(rec)
    if not rec["ok"]:
        _failures.append(f"{name}: {[k for k, v in checks.items() if not v]}")
    return rec


# what the phases' processes import that the smoke run itself does not
# (the example worker, the agent, the master, the Brain, and what
# non-reentrant ``torch.utils.checkpoint`` imports at its first call)
PREWARM = (
    "import torch, torch.distributed; "
    "from torch.utils.checkpoint import checkpoint; "
    "x = torch.ones(2, requires_grad=True); "
    "checkpoint(torch.sin, x, use_reentrant=False).sum().backward(); "
    "import dlrover_tpu_torch.examples.train_gpt_elastic, "
    "dlrover_tpu_torch.agent.launcher, dlrover_tpu_torch.checkpoint.saver, "
    "dlrover_tpu_torch.master.main, dlrover_tpu_torch.cluster.brain, "
    "dlrover_tpu_torch.cluster.operator, dlrover_tpu_torch.cluster.kube_http, "
    "dlrover_tpu_torch.agent.node_check")


def startup_probe() -> dict:
    """What a fresh process on this machine pays before its first step:
    ``import torch`` three times under each bytecode setting (as the
    interpreter comes: ``plain``; a cache prefix it may not write:
    ``prefix``; a prefix it writes: ``prefix_write``), the first CUDA use
    (one process, four at once), the port's entry modules, and
    ``torch._dynamo`` (what non-reentrant ``torch.utils.checkpoint``
    imports at its first call). Seconds a child process."""
    import glob

    base = {k: v for k, v in os.environ.items()
            if k not in ("PYTHONPYCACHEPREFIX", "PYTHONDONTWRITEBYTECODE")}
    prefix = os.path.abspath(os.path.join("build", "pycache_probe"))
    envs = {"plain": dict(base, **_STARTED_ENV),
            "prefix": dict(base, PYTHONPYCACHEPREFIX=prefix,
                           **_STARTED_ENV),
            "prefix_write": dict(base, PYTHONPYCACHEPREFIX=prefix + "_w")}

    def secs(code, env="prefix_write", n=1):
        t = time.monotonic()
        ps = [subprocess.Popen([sys.executable, "-c", code], env=envs[env])
              for _ in range(n)]
        ok = all(p.wait() == 0 for p in ps)
        return time.monotonic() - t if ok else None

    cuda = "import torch; torch.zeros(1, device='cuda'); torch.cuda.synchronize()"
    rec = {"phase": "startup_probe", "started_env": _STARTED_ENV,
           "site_pyc": len(glob.glob(os.path.join(
               os.path.dirname(torch.__file__), "__pycache__", "*.pyc")))}
    for env in envs:
        rec[f"torch_{env}"] = [secs("import torch", env) for _ in range(3)]
    rec["cuda_init"] = secs(cuda)
    rec["cuda_init_x4"] = secs(cuda, n=4)
    for env in ("plain", "prefix_write"):
        for key, mod in (("launcher", "dlrover_tpu_torch.agent.launcher, "
                          "dlrover_tpu_torch.checkpoint.saver"),
                         ("example",
                          "dlrover_tpu_torch.examples.train_gpt_elastic"),
                         ("dynamo", "torch, torch._dynamo")):
            rec[f"{key}_{env}"] = [secs(f"import {mod}", env)
                                   for _ in range(2)]
    rec["master"] = secs("import dlrover_tpu_torch.master.master")
    return rec


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--zero-fault-worker"]:  # a rank of the fault run
        return zero_fault_worker(argv[1:])
    if argv[:1] == ["--autoscale-master"]:  # the autoscale phase's pods
        return autoscale_master(argv[1:])
    if argv[:1] == ["--autoscale-launcher"]:
        return autoscale_launcher(argv[1:])
    if argv[:1] == ["--startup-probe"]:  # not part of the smoke run
        emit(startup_probe())
        return 0
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
    # the library check needs none of the kernels: it runs on the card
    # while nvcc compiles them (the build's seconds hold it); meanwhile a
    # child process writes the bytecode of what the later phases'
    # processes import and this one does not
    warm = subprocess.Popen([sys.executable, "-c", PREWARM],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    with phase("build"):
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            built = ex.submit(build_all)
            with phase("library"):
                library_check(args.seed, dev)
            built.result()
    emit({"phase": "bytecode", "prewarm_rc": warm.wait(),
          "cache": sys.pycache_prefix})
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
                                             False)[0]["verify"]
    with phase("prefix_serve"):
        prefix_serve(model, cfg, args.seed, dev, False)
    with phase("profile"):
        profile_steps(model, cfg, args.seed, dev)
    # the disaggregated fleet: its launches add to the main path's
    fleet_launches = {}
    with phase("fleet"):
        fleet_launches = fleet_serve(model, cfg, args.seed, dev)
    for k, n in fleet_launches.items():
        main_launches[k] = main_launches.get(k, 0) + n
    del model
    torch.cuda.empty_cache()
    # the gated spec/prefix checks: llama3-8b at full width and depth in
    # f32, where spec-on and spec-off differ by f32 rounding only
    with phase("serve_f32"):
        cfg32 = get_config("llama3-8b", dtype="float32")
        model32 = decoder.init(cfg32, seed=args.seed, device=dev)
        _, ref_outs = spec_serve(model32, cfg32, args.seed, dev, True)
        prefix_serve(model32, cfg32, args.seed, dev, True)
        with phase("fleet_f32"):
            fleet_f32(model32, cfg32, args.seed, dev, ref_outs)
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
    train_peak = {}
    for name, cfg_name in (("train", "llama-1.4b"), ("train_gpt2",
                                                     "gpt2-1.5b")):
        state = None
        cfg = get_config(cfg_name)
        with phase(name):
            state, step, batch, rec, opt = train_run(cfg, args.seed, dev,
                                                     name)
            train_launches[name] = rec["launches"]
            train_peak[name] = rec["max_memory_allocated"]
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
            rec = elastic_check(get_config("llama-1.4b",
                                           n_layer=ELASTIC_LAYERS),
                                args.seed, trainer_rec)
            train_launches["elastic"] = rec["launches"]
    # a lost node restored from its peer's memory: two nodes' launchers,
    # llama-1.4b at full width and 2 layers at dp 2 on this card
    gc.collect()
    torch.cuda.empty_cache()
    with phase("node_loss"):
        rec = node_loss_check(get_config("llama-1.4b",
                                         n_layer=NODE_LOSS_LAYERS), args.seed)
        train_launches["node_loss"] = rec["launches"]
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
    with phase("sp"):  # one group of four workers runs both configs
        sp_recs.update(sp_check(
            {"mistral-7b": {"ring": "ring", "auto": "ulysses"},
             "glm-10b": {"ring": "ring_glm"}}, args.seed, dev))
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
    # the master's planning loop under the operator: the Brain and the
    # auto-scaler grow a llama-1.4b job from one node to two on this card
    # through a ScalePlan the operator acts on, each node passing the
    # network check first, and a Brain tuning revision is applied at a
    # step boundary
    gc.collect()
    torch.cuda.empty_cache()
    with phase("autoscale"):
        rec = autoscale_check(get_config("llama-1.4b",
                                         n_layer=AUTOSCALE_LAYERS),
                              args.seed, train_peak_bytes=train_peak.get(
                                  "train"))
        train_launches["autoscale"] = rec["launches"]
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
