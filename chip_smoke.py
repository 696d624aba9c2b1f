#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``dlrover_tpu_torch``) on one card.

Drives the port's two main paths with random weights drawn on the card
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
  sequence (packed kernels with the prefix).

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
   and 4), in bf16 (reported) and again with llama3-8b in f32 at full
   depth (serve_f32, gated: streams equal but at near-ties, the
   oracle's drafts accepted above 0.9, prefix hits and COW pages);
5. profile: the decode step, a prefill chunk and a verify step at the
   serve shapes,
   timed (CUDA events and wall) and traced (``torch.profiler``): kernel
   time by class (the paged-attention class also on its own), launches
   per step, the device's busy share;
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
   kernels at D 128), each under an
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
10. trainer: ``Trainer`` with Flash Checkpoint, llama-1.4b at full size
   (b8 × s1024, f32 params and moments, fixed batches from ``--seed``):
   (a) 10 steps, staging to shared memory every 2 and persisting every 4
   over the first 8 (two persists of the 16.4 GB pack), exact launches;
   (b) a new Trainer resumes from the memory tier to a state equal to
   the saved one bit for bit and repeats (a)'s last losses; (d) a byte
   flipped in the staged pack shows in that leaf alone; (c) the segment
   unlinked, the same from storage (``step_8/``); (e) ``block_k=4`` over
   the same batches gives (a)'s losses, its first block under
   ``torch.cuda.set_sync_debug_mode("error")``; each save, persist and
   restore beside its bound from the pinned copy and disk rates measured
   in the phase.

The lines before the last are the card's name and power limit and a
``{"kernels": [...]}`` summary (the chunk kernel's entry also gives its
split count; it and ``flash_fwd`` give their bytes and the share of
their bound they reach); the last line is
``{"ok": true, "device": {...}}``. Run: ``python3 chip_smoke.py``.
"""

import argparse
import concurrent.futures
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
    64 new tokens, half greedy and half sampled, int8 pools, 8 slots)
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
    new = 64
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
    their own; 32 new tokens, half greedy and half sampled, int8 pools,
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
    new = 32
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


def profile_steps(model, cfg, seed, dev, steps=8):
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
                      prefix=None):
    """The magnitude products of the flash bounds, in f32, one batch
    element at a time: sum_j p_j·|v_j| (forward), P^T·|dO| (dV),
    |dS|·|K| (dQ) and |dS|^T·|Q| (dK), and the cancellation terms C of
    dQ and dK; dK/dV magnitudes summed over each KV head's query-head
    group. Returns (fwd, dq, dk, dv, dq_c, dk_c)."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    mask = fa._allowed(sq, sk, causal, window, prefix, None, q.device)
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


def _flash_work(kernel, b, s, h, hkv, d, causal, window, prefix=None):
    """(bytes, operations) of one flash kernel's share of the work for
    this call: bf16 tensors read and written once (lse/delta f32), and
    2·D FLOP per visible pair for each product (forward: QK^T, PV). The
    backward's least work is five products (10·D per pair, the FA2
    minimum) and one read of q, k, v, dO, lse, delta; the work the two
    backward kernels share (the reads, QK^T and dO·V^T) is counted once,
    in dkv (QK^T, dO·V^T, P^T·dO, dS^T·Q, every read, the dk/dv writes),
    so dq holds only dS·K and its dq write, and the two bounds add up to
    the backward's. The split kernels execute 14·D per pair: both
    recompute QK^T and dO·V^T."""
    q_bytes, kv_bytes, row = b * s * h * d * 2, b * s * hkv * d * 2, b * h * s * 4
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
                   window, pack=1, prefix=None):
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
    args = ([x.data_ptr() for x in (q, k, v, g, lse, delta, *outs)]
            + [None if prefix is None else prefix.data_ptr()]
            + [b, sq, sk, h, hkv, d, float(scale), int(causal), int(window),
               fa._DTYPE_CODE[q.dtype]])

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


def _zero_head(x):
    """``x`` ``[B, S, H, D]`` with one zero head appended."""
    return torch.cat([x, torch.zeros_like(x[:, :, :1])], 2).contiguous()


def flash_case(name, b, s, h, hkv, d, causal, window, gen, dev, timed,
               pack=1, prefix=None, fault="key", sk=None):
    """The flash kernels (``pack`` 2: the packed ones) at one shape (``s``
    queries, ``sk`` keys, ``s`` by default) against their plain versions,
    with a planted fault: ``key`` (key row min(Sq, Sk)/2 of every KV
    head replaced), ``prefix`` (the prefix shifted by one key) or ``last_pack``
    (odd H: the last pack's second head, run on the zero-padded inputs,
    written into head H - 1; the ragged path's heads must also equal the
    padded path's bit for bit)."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    scale = d ** -0.5
    names = fa.PACKED if pack == 2 else fa.UNPACKED

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    sk = s if sk is None else sk
    q, k, v, g = rnd(b, s, h, d), rnd(b, sk, hkv, d), rnd(b, sk, hkv, d), \
        rnd(b, s, h, d)
    pref = (None if prefix is None
            else torch.tensor(prefix, dtype=torch.int32, device=dev))
    kw = dict(causal=causal, scale=scale, window=window)

    def run(q, k, v, g, pref):
        out, lse = fa.flash_fwd_cuda(q, k, v, prefix=pref, pack=pack, **kw)
        delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1)
        grads = fa.flash_bwd_cuda(q, k, v, g, lse, delta.contiguous(),
                                  prefix=pref, pack=pack, **kw)
        return dict(zip(("out", "lse", "dq", "dk", "dv"), (out, lse, *grads)))

    got = run(q, k, v, g, pref)
    out, lse = got["out"], got["lse"]
    torch.cuda.synchronize()
    f32 = [x.float() for x in (q, k, v)]
    ref_out, ref_lse = fa.flash_fwd_reference(*f32, prefix=pref, **kw)
    rdq, rdk, rdv = fa.flash_bwd_reference(*f32, out.float(), lse,
                                           g.float(), prefix=pref, **kw)
    fm, dqm, dkm, dvm, dqc, dkc = _flash_magnitudes(
        q, k, v, out, lse, g, causal, scale, window, pref)

    def bound(ref, m, c=0.0):
        return (FLASH_ROUND * ref.abs() + (FLASH_ROUND + FLASH_SLACK) * m
                + FLASH_DOT * c)

    bounds = {"out": bound(ref_out, fm), "dq": bound(rdq, dqm, dqc),
              "dk": bound(rdk, dkm, dkc), "dv": bound(rdv, dvm)}
    refs = {"out": ref_out, "dq": rdq, "dk": rdk, "dv": rdv}
    checks = {n: _over(got[n], refs[n], bounds[n]) for n in refs}
    checks["lse"] = _over(lse, ref_lse, 1e-5 * (1 + ref_lse.abs()))
    extra = {}
    if fault == "key":
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
           "Hkv": hkv,
           "D": d, "causal": causal, "window": window, "pack": pack,
           "prefix": prefix,
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
        fwd_plain = graph_ms(lambda: fa.flash_fwd_reference(q, k, v, **pkw),
                             3)
        bwd_plain = graph_ms(lambda: fa.flash_bwd_reference(
            q, k, v, out, lse, g, **pkw), 3)
        sdpa_fwd, sdpa_bwd = (
            (None, None) if window or prefix is not None or sk != s
            else _sdpa_train(q, k, v, g, causal, scale))
        delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1) \
            .contiguous()

        def kernel_ms(p, fwd_yard=None, bwd_yard=None):
            """ms of the forward, dq and dkv kernels at pack ``p``, then
            of the yardsticks given: the forward in turns with
            ``fwd_yard``, dq and dkv with ``bwd_yard``."""
            fwd = [lambda: fa.flash_fwd_cuda(q, k, v, pack=p, **pkw)]
            bwd = [_bwd_kernel_fn(w, q, k, v, g, lse, delta, pack=p, **pkw)
                   for w in (1, 2)]
            fwd_ms = (in_turns_ms(fwd + [fwd_yard], 20) if fwd_yard
                      else [graph_ms(fwd[0], 20)])
            bwd_ms = (in_turns_ms(bwd + [bwd_yard], 20) if bwd_yard
                      else [graph_ms(f, 20) for f in bwd])
            return fwd_ms[:1] + bwd_ms[:2] + fwd_ms[1:] + bwd_ms[2:]

        ms = kernel_ms(pack, sdpa_fwd, sdpa_bwd)
        lib_fwd, lib_bwd = ms[3:] if sdpa_fwd else (None, None)

        rec["timing"] = {}
        for kernel, t, plain, lib in zip(names, ms[:3],
                                         (fwd_plain, bwd_plain, bwd_plain),
                                         (lib_fwd, lib_bwd, lib_bwd)):
            moved, ops = _flash_work(kernel, b, s, h, hkv, d, causal,
                                     window, prefix)
            bound_ms, by = _bound(moved, ops)
            rec["timing"][kernel] = {
                "ms": t, "plain_ms": plain, "library_ms": lib,
                "bound_ms": bound_ms, "bound_by": by, "bytes": moved,
                "timer": "graph",
                "library_timer": None if lib is None else "graph"}
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
YARDSTICK_BYTES, DISK_YARDSTICK_GIB = 1 << 30, 4


def _trainer_batches(cfg, seed, n):
    """``n`` fixed host batches (numpy) of TRAIN_BATCH × TRAIN_SEQ."""
    rng = np.random.default_rng(seed + 8)
    out = []
    for _ in range(n):
        tok = rng.integers(0, cfg.vocab_size,
                           size=(TRAIN_BATCH, TRAIN_SEQ + 1)).astype(np.int32)
        out.append({"tokens": tok[:, :-1], "targets": tok[:, 1:]})
    return out


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
    """``Trainer`` with Flash Checkpoint at full size: (a) TRAINER_STEPS
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

    def opt():
        return make_optimizer(learning_rate=1e-4, warmup_steps=10,
                              decay_steps=1000)

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
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
    # the Trainer with Flash Checkpoint, llama-1.4b at full size
    with phase("trainer"):
        rec = trainer_check(get_config("llama-1.4b"), args.seed, dev)
        train_launches["trainer"] = rec["launches"]
    torch.cuda.empty_cache()
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
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
