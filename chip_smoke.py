#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``dlrover_tpu_torch``) on one card.

Drives the port's serving path — ``GenerationServer`` → ``Scheduler`` →
``ServingEngine`` → ``Decoder`` paged prefill/decode →
``ops.paged_attention`` (the hand-written CUDA kernel built from
``dlrover_tpu_torch/csrc/``) — with llama3-8b at full width and depth
and random weights drawn on the card from ``--seed``. Phases, one JSON
line each; any failure exits nonzero and prints no result:

1. device: the card (``nvidia-smi`` name and power limit) and the
   kernel build from source;
2. kernel: every paged-attention case against its plain PyTorch
   version at llama3-8b's attention shapes (H 32, Hkv 8, D 128, page
   16): decode at B=8 and chunk at C=256, bf16 and int8 pools, window 0
   and 512, ragged positions up to 2047, a shuffled page assignment with
   -1 columns and a free slot; with the kernel's time, the plain
   version's, ``F.scaled_dot_product_attention`` on pre-gathered dense
   K/V (the gather excluded) and the byte/operation bound. Each case
   also runs a planted fault (a held page dropped, or the window edge
   moved by one key) that the tolerance must catch;
3. model: one ``decode_step_paged`` and one ``prefill_chunk_paged`` on
   the same pools, through the kernel and through the plain attention,
   and through the kernel with one held page dropped. In f32 (full
   width, 4 layers) the logits must agree within the stated tolerance
   and the planted fault must exceed it; in bf16 (full depth) the
   logits must be finite, and the differences are reported;
4. serve: 16 requests (prompts 64–1536 tokens, 32 new tokens, half
   greedy, half temperature 0.8 / top-p 0.9) through ``GenerationServer``
   with int8 pools, then 4 through bf16 pools; every output is checked
   and the kernel's launch counts on that path must be above zero;
5. profile: the decode step and a prefill chunk at the serve shapes,
   timed (CUDA events and wall) and traced (``torch.profiler``): kernel
   time by class, launches per step, the device's busy share.

The lines before the last are the card's name and power limit and a
``{"kernels": [...]}`` summary; the last line is
``{"ok": true, "device": {...}}``. Run: ``python3 chip_smoke.py``
(``--skip-serve`` stops after phase 3).
"""

import argparse
import contextlib
import dataclasses
import itertools
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_OPS_PER_S = 989e12    # dense bf16 tensor-core peak
PAGED_SRC = "dlrover_tpu_torch/csrc/paged_attention.cu"
PAGED_REPLACES = "dlrover_tpu/ops/pallas_paged.py:300"
# Kernel vs plain version, per element of the attention output. The
# plain version runs in f32 on the very values the kernel reads (bf16 q
# and pools upcast exactly; int8 pages dequantized through the codec to
# bf16, as the kernel rounds its in-register dequant), so the two differ
# only by f32 summation order (far below 1e-5 at these shapes) and the
# kernel's one rounding of its output to bf16 (at most 2^-9 relative):
# the bound is twice that rounding plus 1e-5. Against the plain version
# in bf16 the difference is only reported: its chunk variant rounds the
# probabilities to bf16 before P·V (as mha_reference does), the kernel
# keeps them in f32.
KERNEL_ATOL = 1e-5
KERNEL_RTOL = 2.0 ** -8
# Model logits, kernel vs plain attention, max |Δ| over max |logit|. In
# f32 (full width, depth cut to 4) the two attentions differ by
# summation order only, so the logits must agree to 1e-3 of the largest
# logit, and one dropped page must move them by more. The bf16 run at
# full depth is a report: every layer rounds its residual stream to
# bf16, and a random-weight network carries one-ulp differences of the
# attention output forward into logit differences of the same order as
# a dropped page's.
MODEL_REL_TOL = 1e-3
F32_CHECK_LAYERS = 4

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


def _held(out, ref, active):
    """(max |out - ref|, elements over the bound) over the active slots."""
    o, r = out.float()[active], ref.float()[active]
    diff = (o - r).abs()
    over = int((diff > KERNEL_ATOL + KERNEL_RTOL * r.abs()).sum())
    return float(diff.max()), over


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
    return cuda_ms(call, 20)


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
    for mode in ("bf16", "int8"):
        geom = kvc.make_geometry(geom_cfg, n_slots=8, max_len=2048,
                                 page_size=16, mode=mode)
        pools = _fill_pools(geom, gen, dev)
        width = geom.max_pages_per_slot
        for variant in ("decode", "chunk"):
            for window in (0, 512):
                if variant == "decode":
                    # ragged positions up to 2047, slot 7 free (pos 0, no pages)
                    pos = rng.integers(1, 2047, size=8)
                    pos[0] = 2047
                    pos[7] = 0
                    lens = pos + 1
                    lens[7] = 0
                    b, c = 8, 1
                    pos_rows = torch.as_tensor(pos[:, None], dtype=torch.int32,
                                               device=dev)
                    call_pos = pos_rows[:, 0].contiguous()
                else:
                    # one 256-token chunk of a prompt, as the engine runs it
                    start = 1536
                    b, c = 1, 256
                    lens = np.asarray([start + c])
                    pos_rows = (start + torch.arange(c, device=dev,
                                                     dtype=torch.int32))[None]
                    call_pos = pos_rows
                tab_np = _fragmented_tables(b, width, lens, 16, rng)
                tables = torch.as_tensor(tab_np, device=dev)
                max_pages = _pages_bucket(tab_np)
                q = torch.randn((b, c, cfg.n_head, d), generator=gen,
                                device=dev).to(torch.bfloat16)
                kw = dict(scale=scale, window=window, kv_heads=cfg.kv_heads,
                          max_pages=max_pages, variant=variant)
                layer0 = kvc.layer_pools(pools, 0)
                out = pa.paged_attention(q, layer0, tables, call_pos, **kw)
                torch.cuda.synchronize()
                ref = pa.paged_attention_reference(
                    q.float(), _f32_pools(layer0, geom), tables, call_pos,
                    **kw)
                same = pa.paged_attention_reference(q, layer0, tables,
                                                    call_pos, **kw)
                active = torch.as_tensor(lens > 0, device=dev)
                err, over = _held(out, ref, active)
                same_err, _ = _held(out, same, active)
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
                bad_err, bad_over = _held(bad, ref, active)
                control = {"fault": fault, "max_abs_err": bad_err,
                           "over_bound": bad_over, "caught": bad_over > 0}
                layers = itertools.cycle(
                    [kvc.layer_pools(pools, i) for i in range(n_layers)])

                def run_kernel():
                    pa.paged_attention(q, next(layers), tables, call_pos, **kw)

                def run_plain():
                    pa.paged_attention_reference(q, next(layers), tables,
                                                 call_pos, **kw)

                ms = cuda_ms(run_kernel, 50)
                plain_ms = cuda_ms(run_plain, 10)
                lib_ms = _sdpa_ms(q, layer0, tables, pos_rows, geom, scale,
                                  window, max_pages)
                moved, ops = _work(q, tables, pos_rows, geom, window,
                                   max_pages)
                bound_ms, bound_by = _bound(moved, ops)
                kernel = pa.kernel_for(c, cfg.n_head, cfg.kv_heads)
                case = {
                    "phase": "kernel", "kernel": f"paged_attention.{kernel}",
                    "variant": variant, "mode": mode, "window": window,
                    "B": b, "C": c, "max_pages": max_pages,
                    "max_abs_err": err, "over_bound": over,
                    "atol": KERNEL_ATOL, "rtol": KERNEL_RTOL,
                    "same_dtype_max_abs_err": same_err, "control": control,
                    "free_slot_zero": free_zero, "finite": finite,
                    "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "bytes": moved, "ops": ops,
                    "ok": (over == 0 and control["caught"] and free_zero
                           and finite),
                }
                emit(case)
                if not case["ok"]:
                    _failures.append(f"kernel case {case}")
                results.append(case)
        del pools
    return results


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
            dec, _ = model.decode_step_paged(tokens, pools, tables, posd,
                                             valid, max_pages=128)
            ch, _ = model.prefill_chunk_paged(
                chunk_tok, pools, tables[:1], start,
                torch.tensor([256], device=dev), max_pages=128)
        torch.cuda.synchronize()
        out[name] = (dec, ch)
        del pools
    gate = cfg.dtype == "float32"
    rec = {"phase": "model", "dtype": cfg.dtype, "n_layer": cfg.n_layer,
           "gate": gate, "tol_rel": MODEL_REL_TOL}
    ok = True
    for i, step in enumerate(("decode_step_paged", "prefill_chunk_paged")):
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


def serve(model, cfg, seed, dev, mode, n_requests, lengths):
    from dlrover_tpu_torch.ops import paged_attention as pa
    from dlrover_tpu_torch.serving.scheduler import SamplingParams
    from dlrover_tpu_torch.serving.server import GenerationServer

    rng = np.random.default_rng(seed + 2)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, size=int(n))))
               for n in lengths[:n_requests]]
    new = 32
    server = GenerationServer(
        model, cfg, n_slots=8, max_len=2048, page_size=16, mode=mode,
        prefill_chunk=256, device=dev,
    )
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launches()
    t0 = time.monotonic()
    server.start()
    try:
        reqs = []
        for i, p in enumerate(prompts):
            sampling = (SamplingParams() if i % 2 == 0 else
                        SamplingParams(temperature=0.8, top_p=0.9,
                                       seed=seed * 1000 + i))
            reqs.append(server.submit(p, new, sampling=sampling))
        outs = [r.future.result(timeout=600) for r in reqs]
        wall = time.monotonic() - t0
    finally:
        server.stop()
    launches = dict(pa.LAUNCHES)
    ok = True
    for p, o in zip(prompts, outs):
        ok = ok and len(o) == len(p) + new and o[:len(p)] == p
        ok = ok and all(0 <= t < cfg.vocab_size for t in o[len(p):])
    ok = ok and launches["decode"] > 0 and launches["chunk"] > 0
    lat = server.scheduler.latency_summary()
    es = server.engine.stats()
    rec = {
        "phase": "serve", "mode": mode, "requests": len(prompts),
        "prompt_tokens": sum(len(p) for p in prompts),
        "new_tokens_per_request": new, "wall_s": wall,
        "generated_tokens": es["tokens_generated"],
        "tokens_per_s": es["tokens_generated"] / wall,
        "ttft_p50_ms": lat["ttft_p50_ms"], "ttft_p99_ms": lat["ttft_p99_ms"],
        "tpot_p50_ms": lat["tpot_p50_ms"], "tpot_p99_ms": lat["tpot_p99_ms"],
        "e2e_p50_ms": lat["p50"], "e2e_p99_ms": lat["p99"],
        "step_time_s": es["step_time_s"], "host_time_s": es["host_time_s"],
        "prefill_chunks": es["prefill_chunks"],
        "kv_pool_bytes": server.engine.resident_kv_bytes(),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches, "ok": ok,
    }
    emit(rec)
    if not ok:
        _failures.append(f"serve {mode}: {rec}")
    return rec


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
    calls = {
        "decode_step_paged": lambda: model.decode_step_paged(
            tokens, pools, tab, posd, valid, max_pages=bucket),
        "prefill_chunk_paged": lambda: model.prefill_chunk_paged(
            chunk, pools, tab[:1], start, clen, max_pages=bucket),
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
              "kernels_per_step": sum(n_by_class.values()),
              "kernels_per_step_by_class": n_by_class,
              "device_busy_share": busy / traced_ms,
              "kernel_ms_by_class": by_class,
              "top_kernels_ms": [[n[:80], t] for n, t in top]})
    del pools


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-serve", action="store_true",
                    help="stop after the model-level check")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from dlrover_tpu_torch.models import decoder
    from dlrover_tpu_torch.models.config import get_config
    from dlrover_tpu_torch.ops import _build
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
        t0 = time.monotonic()
        secs = _build.build("paged_attention")
        log = _build.build_log("paged_attention")
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spill = sum(int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log))
        emit({"phase": "build", "seconds": time.monotonic() - t0,
              "compile_s": secs, "kernels": len(regs),
              "max_registers": max(regs, default=0), "spill_bytes": spill})
    if _failures:
        print("\n".join(_failures), file=sys.stderr)
        return 1

    cfg = get_config("llama3-8b")
    cases = []
    with phase("kernel"):
        cases = kernel_cases(cfg, args.seed, dev)
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
    main_launches = dict.fromkeys(pa.KERNELS, 0)
    if not args.skip_serve:
        rng = np.random.default_rng(args.seed + 3)
        lengths = rng.integers(64, 1537, size=16)
        with phase("serve"):
            rec = serve(model, cfg, args.seed, dev, "int8", 16, lengths)
            main_launches = rec["launches"]
        with phase("serve_bf16"):
            serve(model, cfg, args.seed, dev, "bf16", 4, lengths)
        with phase("profile"):
            profile_steps(model, cfg, args.seed, dev)
    if _failures:
        print("\n".join(_failures), file=sys.stderr)
        return 1

    kernels = []
    for kernel in pa.KERNELS:
        name = f"paged_attention.{kernel}"
        mine = [c for c in cases if c["kernel"] == name]
        head = next(c for c in mine if c["mode"] == "int8" and not c["window"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": PAGED_SRC, "replaces": PAGED_REPLACES,
            "launches": main_launches[kernel],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
        })
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
