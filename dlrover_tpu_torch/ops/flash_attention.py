"""FlashAttention-2 forward and backward.

Port of ``dlrover_tpu/ops/pallas_attention.py``:

- ``flash_attention`` / ``flash_attention_with_lse`` — the ops, with
  autograd. On CUDA tensors they launch the hand-written Hopper kernels
  of ``csrc/flash_attention.cu``, which replace the TPU kernels
  ``_fwd_kernel``, ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``: in bf16
  the forward ``flash_fwd_wgmma_kernel`` and the backward
  ``flash_bwd_dq_wgmma_kernel`` and ``flash_bwd_dkv_wgmma_kernel``, all
  on wgmma from TMA-fed shared-memory rings (the primitives of
  ``csrc/attn_fwd_core.cuh``; the forward persistent, one body with the
  packed forward's); in f32 ``flash_fwd_kernel``,
  ``flash_bwd_dq_kernel`` and ``flash_bwd_dkv_kernel`` (mma.sync tiles
  through f32 FMAs). With two heads of 64 packed per block
  (``head_pack``, auto for every MHA model of head_dim 64) they launch
  ``flash_fwd_packed_wgmma_kernel`` (bf16, on the same core) or
  ``flash_fwd_packed_kernel`` (f32), then
  ``flash_bwd_dq_packed_wgmma_kernel`` and
  ``flash_bwd_dkv_packed_wgmma_kernel`` (bf16, the backward pair's bodies
  at two heads a block) or ``flash_bwd_dq_packed_kernel`` and
  ``flash_bwd_dkv_packed_kernel`` (f32, mma.sync tiles), which replace
  ``_fwd_kernel_packed``, ``_bwd_dq_kernel_packed`` and
  ``_bwd_dkv_kernel_packed``. ``fwd_cuda_kernel`` and
  ``bwd_cuda_kernel`` name the kernels a call launches. The backward is
  bound by operations: its least work is 10·D FLOP a visible (query,
  key) pair, and its two kernels execute 14·D (both recompute Q·Kᵀ and
  dO·Vᵀ, so that neither needs atomics). On CPU
  tensors the same autograd function runs the plain versions, whatever
  the pack (packing changes where heads run, not the numbers). There is
  no other path: a CUDA tensor launches the kernel or raises.
- ``flash_fwd_reference`` / ``flash_bwd_reference`` — the plain PyTorch
  versions: the forward as one block of the kernel's online softmax (p
  relative to the row max, rounded to the input type before P·V, ``l``
  summing the unrounded p), the backward the port of
  ``_chunked_backward``. The CPU tests hold them against the JAX kernels;
  ``chip_smoke.py`` holds the kernels against them.
- ``head_pack_for`` — the pack rule of the JAX ``flash_attention``.

The mask is the flash kernels' (``_allowed_mask``): causal aligned
top-left (query i sees key j iff ``i >= j``), a sliding ``window``, and
the GLM prefix-LM ``prefix_len`` (keys before ``prefix_len[b]`` seen by
every query). ``mha_reference`` aligns causal bottom-right; the two
agree when ``Sq == Sk``, the training case. Layout ``[B, S, H, D]``; GQA
shares K/V by index (``H`` a multiple of ``Hkv``), never repeated in
memory by the kernels. Ring ``offsets`` ``(q_off, k_off)``, host ints, put
q row 0 and key 0 at those global positions: the causal and window terms
and the prefix compare global positions, every bound stays local. Every
kernel takes them (``OFFSET_LAUNCHES`` counts the launches that carried
them); ``key_tiles``, ``q_tiles`` and ``dkv_q_range`` are the plain twins
of the kernels' tile and range math.
"""

import ctypes
from typing import Dict, Optional, Tuple

import torch

from dlrover_tpu_torch.ops.attention import NEG_INF

#: the CUDA kernels of ``csrc/flash_attention.cu``: a head per block,
#: then two heads of 64 per block
UNPACKED = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
PACKED = ("flash_fwd_packed", "flash_bwd_dq_packed", "flash_bwd_dkv_packed")
KERNELS = UNPACKED + PACKED
#: launches of each kernel since the last ``reset_launches()``
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}
#: the launches of ``LAUNCHES`` that carried ring offsets
OFFSET_LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}

#: the forward kernels the C entry point takes, by id
FWD_CUDA_KERNELS = ("flash_fwd_kernel", "flash_fwd_packed_kernel",
                    "flash_fwd_wgmma_kernel", "flash_fwd_packed_wgmma_kernel")
#: the backward kernels the C entry point takes, by id
BWD_CUDA_KERNELS = ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                    "flash_bwd_dq_packed_kernel", "flash_bwd_dkv_packed_kernel",
                    "flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel",
                    "flash_bwd_dq_packed_wgmma_kernel",
                    "flash_bwd_dkv_packed_wgmma_kernel")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
#: the packed kernels hold two heads of this width
PACK_HEAD_DIM = 64
#: the kernels' tiles: q rows and keys a tile of the forward and dq
#: (bf16: ``kTcBK`` keys a forward stage, ``kDqKeys`` a dq stage) and
#: the q rows a dkv stage (``kDkvBQ``)
FWD_TILE_KEYS, DQ_TILE_KEYS, DKV_TILE_ROWS = 128, 64, 64
#: the offsets' range (``offsets_in_range`` in the CUDA file): positions
#: and their differences stay in int32
MAX_OFFSET, MAX_LOCAL = 1 << 30, 1 << 24


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        OFFSET_LAUNCHES[k] = 0


def host_offsets(offsets, sq: int = 0, sk: int = 0,
                 window: int = 0) -> Tuple[int, int]:
    """``(q_off, k_off)`` as host ints (``(0, 0)`` for None), checked
    against the kernels' range: ``|q_off|``, ``|k_off|`` and ``|q_off −
    k_off|`` at most 2^30, ``Sq``, ``Sk`` and the window under 2^24."""
    if offsets is None:
        return 0, 0
    if isinstance(offsets, torch.Tensor):
        offsets = offsets.reshape(-1).tolist()
    q_off, k_off = (int(x) for x in offsets)
    if (max(abs(q_off), abs(k_off), abs(q_off - k_off)) > MAX_OFFSET
            or max(sq, sk, window) >= MAX_LOCAL):
        raise ValueError(
            f"offsets ({q_off}, {k_off}) with Sq {sq}, Sk {sk}, window "
            f"{window} leave the kernels' int32 range: |q_off|, |k_off| "
            f"and |q_off - k_off| at most 2^30, S and window under 2^24")
    return q_off, k_off


def fwd_cuda_kernel(dtype, pack: int) -> str:
    """The CUDA forward kernel for ``dtype`` at ``pack``. In bf16 both
    run on the tensor-core core of ``csrc/attn_fwd_core.cuh``: one head a
    block ``flash_fwd_wgmma_kernel``, two heads of 64 a block
    ``flash_fwd_packed_wgmma_kernel``. In f32 the mma.sync bodies'
    ``flash_fwd_kernel`` and ``flash_fwd_packed_kernel``. Each counts
    under ``LAUNCHES["flash_fwd"]`` or ``LAUNCHES["flash_fwd_packed"]``."""
    bf16 = dtype == torch.bfloat16
    if pack == 2:
        return ("flash_fwd_packed_wgmma_kernel" if bf16
                else "flash_fwd_packed_kernel")
    return "flash_fwd_wgmma_kernel" if bf16 else "flash_fwd_kernel"


def bwd_cuda_kernel(dtype, pack: int) -> Tuple[str, str]:
    """The CUDA backward kernels ``(dq, dkv)`` for ``dtype`` at ``pack``.
    In bf16 both run on the tensor cores, one pair of bodies at one head
    or two heads of 64 a block: ``flash_bwd_dq_wgmma_kernel`` and
    ``flash_bwd_dkv_wgmma_kernel``, or ``flash_bwd_dq_packed_wgmma_kernel``
    and ``flash_bwd_dkv_packed_wgmma_kernel``. In f32 the mma.sync bodies'
    ``flash_bwd_dq_kernel`` and ``flash_bwd_dkv_kernel``, or
    ``flash_bwd_dq_packed_kernel`` and ``flash_bwd_dkv_packed_kernel``.
    They count under ``LAUNCHES["flash_bwd_dq"]`` and
    ``LAUNCHES["flash_bwd_dkv"]`` (``_packed`` at pack 2)."""
    packed = "_packed" if pack == 2 else ""
    core = "_wgmma" if dtype == torch.bfloat16 else ""
    return (f"flash_bwd_dq{packed}{core}_kernel",
            f"flash_bwd_dkv{packed}{core}_kernel")


def head_pack_for(h: int, hkv: int, d: int, head_pack: int = 0) -> int:
    """Heads per kernel block, the rule of ``pallas_attention.
    flash_attention``: 0 (auto) packs ``128 // d`` heads when ``d < 128``
    divides 128 and the layout is MHA, else 1; a pack asked for is
    demoted to 1 for GQA or when ``d · pack`` passes 128 (or ``d`` does
    not divide 128)."""
    if head_pack < 0:
        raise ValueError(f"head_pack must be >= 0, got {head_pack}")
    if head_pack == 0:
        return 128 // d if (d < 128 and 128 % d == 0 and h == hkv) else 1
    if h != hkv or d * head_pack > 128 or 128 % d:
        return 1
    return head_pack


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------


def _allowed(sq, sk, causal, window, prefix, offsets, device):
    """``[B or 1, Sq, Sk]`` visibility (None when unmasked), the rule of
    ``_allowed_mask`` with the kernels' global offsets and prefix."""
    if not causal:
        return None
    q_off, k_off = host_offsets(offsets)
    q_pos = torch.arange(q_off, q_off + sq, device=device)[:, None]
    k_pos = torch.arange(k_off, k_off + sk, device=device)[None, :]
    mask = q_pos >= k_pos
    if window:
        mask = mask & (q_pos - k_pos < window)
    mask = mask[None]
    if prefix is not None:
        mask = mask | (k_pos[None] < prefix.to(device)[:, None, None])
    return mask


def local_prefix(prefix: int, k_off: int, sk: int) -> int:
    """A global prefix in this call's keys: the keys ``[0, p)`` every
    query sees (``prefix_of`` in ``csrc/flash_attention.cu``)."""
    return min(max(int(prefix) - k_off, 0), sk)


def dkv_q_range(sq, sk, causal, window, prefix=None, offsets=None):
    """``(lo, hi)``, ``[B or 1, Sk]`` int64: the queries ``[lo, hi)`` that
    each key sees, the rule the dkv kernel masks a key row by (``q_range``
    in ``csrc/flash_attention.cu``): causal ``[k, k + window)`` (``[k,
    Sq)`` without a window), less ``q_off − k_off``; a key inside the
    prefix, or any key without causal, is seen by every query; cut to
    ``[0, Sq)`` (``lo >= hi``: no query). The same visibility as
    ``_allowed``, turned round."""
    q_off, k_off = host_offsets(offsets)
    sh = q_off - k_off
    k = torch.arange(sk)[None]
    lo = torch.zeros_like(k)
    hi = torch.full_like(k, sq)
    if causal:
        lo = torch.clamp(k - sh, 0, sq)
        if window:
            hi = torch.clamp(k - sh + window, 0, sq)
        if prefix is not None:
            pref = torch.clamp(prefix.cpu().long() - k_off, 0, sk)
            seen = k < pref[:, None]
            lo = torch.where(seen, 0, lo)
            hi = torch.where(seen, sq, hi)
    return lo, hi


def key_tiles(q0, bq, bk, sk, causal, window, pref=0, offsets=None):
    """``(begin, end)``: the key tiles of width ``bk`` that the q tile
    ``[q0, q0 + bq)`` visits, the twin of ``key_tiles`` in
    ``csrc/flash_attention.cu`` (the forward's and dq's walk): causal up
    to the tile's last row's diagonal, with a window from its first row's
    window edge, both moved by ``q_off − k_off`` (floor division: a
    negative position is not rounded toward 0), and every tile that
    reaches into the local prefix ``pref`` (``local_prefix``)."""
    q_off, k_off = host_offsets(offsets)
    n = -(-sk // bk)
    b, e = 0, n
    if causal:
        d0 = q0 + q_off - k_off
        e = min(max((d0 + bq - 1) // bk + 1, 0), n)
        if window:
            b = min(max((d0 - window + 1) // bk, 0), n)
        e = max(e, -(-min(pref, sk) // bk))
    return b, e


def q_tiles(k0, keys, sq, causal, window, pref=0, offsets=None,
            rows=DKV_TILE_ROWS):
    """``(begin, end)``: the q tiles of ``rows`` rows that the dkv walk of
    the keys ``[k0, k0 + keys)`` visits, the twin of ``q_tiles`` (bf16)
    and of the f32 dkv body's range in ``csrc/flash_attention.cu``: under
    causal from the first key's diagonal, with a window up to the last
    key's window edge, both moved by ``q_off − k_off``; every tile when
    the first key lies in the local prefix."""
    q_off, k_off = host_offsets(offsets)
    n = -(-sq // rows)
    b, e = 0, n
    if causal and k0 >= pref:
        sh = q_off - k_off
        b = min(max((k0 - sh) // rows, 0), n)
        if window:
            e = min(max((k0 + keys - 1 - sh + window - 1) // rows + 1, 0), n)
    return b, e


def fwd_items(b, sq, h, hkv, pack=1):
    """The work items of the persistent bf16 forward kernels, ``(batch
    element, first head, first q row)``, in the order their blocks take
    them (``fwd_item`` in ``csrc/flash_attention.cu``): at ``pack`` 1
    (``flash_fwd_wgmma_kernel``) tiles of 128 q rows by batch element, KV
    head, q tile from the last, then the query heads of the KV head's
    group side by side; at ``pack`` 2 (``flash_fwd_packed_wgmma_kernel``)
    tiles of 64 rows by batch element, pack of two heads, q tile from the
    last. The causal items that do the most work come first, and the
    blocks at work at once read few heads' K/V."""
    rows = 128 // pack
    n_qt = -(-sq // rows)
    items = []
    if pack == 1:
        groups = h // hkv
        for bi in range(b):
            for kh in range(hkv):
                for qt in reversed(range(n_qt)):
                    items += [(bi, kh * groups + g, qt * rows)
                              for g in range(groups)]
    else:
        for bi in range(b):
            for p in range(-(-h // 2)):
                items += [(bi, 2 * p, qt * rows)
                          for qt in reversed(range(n_qt))]
    return items


def _grouped(x, hkv):
    """``[B, S, H, D]`` → ``[B, Hkv, G, S, D]`` f32 (query heads grouped by
    the KV head they share)."""
    b, s, h, d = x.shape
    return x.float().permute(0, 2, 1, 3).reshape(b, hkv, h // hkv, s, d)


def flash_fwd_reference(q, k, v, *, causal=True, scale=None, window=0,
                        prefix=None, offsets=None):
    """``(out [B, Sq, H, D] in q.dtype, lse [B, H, Sq] f32)``: the kernel's
    online softmax over one block holding every key, so p is taken
    against the row max, rounded to ``q.dtype`` before P·V, and ``l``
    sums the unrounded p; ``l == 0 → 1``; ``lse = m + log l``."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    qg = _grouped(q, hkv)                                   # [B,Hkv,G,Sq,D]
    kt = k.float().permute(0, 2, 1, 3)                      # [B,Hkv,Sk,D]
    s = torch.einsum("bkgqd,bkcd->bkgqc", qg, kt) * scale
    mask = _allowed(sq, sk, causal, window, prefix, offsets, q.device)
    if mask is not None:
        s = torch.where(mask[:, None, None], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    pv = p.to(q.dtype).float()
    vt = v.float().permute(0, 2, 1, 3)
    out = torch.einsum("bkgqc,bkcd->bkgqd", pv, vt) / l
    lse = (m + torch.log(l))[..., 0].reshape(b, h, sq)
    out = out.reshape(b, h, sq, d).permute(0, 2, 1, 3).to(q.dtype)
    return out.contiguous(), lse


def flash_bwd_reference(q, k, v, out, lse, g, *, causal=True, scale=None,
                        window=0, g_lse=None, prefix=None, offsets=None,
                        chunk=1024):
    """``(dq, dk, dv)`` from the saved ``(out, lse)``: the port of
    ``_chunked_backward``. Recomputes ``p = exp(s − lse)`` one key chunk
    at a time (never the whole ``[Sq, Sk]`` matrix), ``ds = p·(dp −
    delta)·scale`` with ``delta = rowsum(dO·O)``, in f32, with GQA kept
    at ``Hkv`` heads and dk/dv summed over each group. ``g_lse`` (the
    cotangent of the lse output) folds into delta."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    groups = h // hkv
    scale = d ** -0.5 if scale is None else scale
    qt, gt, ot = _grouped(q, hkv), _grouped(g, hkv), _grouped(out, hkv)
    kt = k.float().permute(0, 2, 1, 3)
    vt = v.float().permute(0, 2, 1, 3)
    lse_g = lse.float().reshape(b, hkv, groups, sq)
    delta = (gt * ot).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse.float().reshape(b, hkv, groups, sq)
    mask = _allowed(sq, sk, causal, window, prefix, offsets, q.device)
    dq = torch.zeros_like(qt)
    dk = torch.empty_like(kt)
    dv = torch.empty_like(vt)
    for c0 in range(0, sk, chunk):
        c1 = min(sk, c0 + chunk)
        kc, vc = kt[:, :, c0:c1], vt[:, :, c0:c1]
        s = torch.einsum("bkgqd,bkcd->bkgqc", qt, kc) * scale
        if mask is not None:
            s = torch.where(mask[:, None, None, :, c0:c1], s, NEG_INF)
        p = torch.exp(s - lse_g[..., None])
        dv[:, :, c0:c1] = torch.einsum("bkgqc,bkgqd->bkcd", p, gt)
        dp = torch.einsum("bkgqd,bkcd->bkgqc", gt, vc)
        ds = p * (dp - delta[..., None]) * scale
        dk[:, :, c0:c1] = torch.einsum("bkgqc,bkgqd->bkcd", ds, qt)
        dq = dq + torch.einsum("bkgqc,bkcd->bkgqd", ds, kc)
    dq = dq.reshape(b, h, sq, d).permute(0, 2, 1, 3).to(q.dtype)
    return (dq.contiguous(), dk.permute(0, 2, 1, 3).contiguous().to(k.dtype),
            dv.permute(0, 2, 1, 3).contiguous().to(v.dtype))


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

_fns = {}


def _lib():
    """The C entry points of ``csrc/flash_attention.cu``, built on first
    use, with their argument types declared."""
    if not _fns:
        from dlrover_tpu_torch.ops import _build

        lib = _build.load("flash_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fwd = lib.dlrover_flash_fwd
        fwd.argtypes = [p] * 6 + [i] * 6 + [f] + [i] * 6 + [p]
        fwd.restype = i
        bwd = lib.dlrover_flash_bwd
        bwd.argtypes = [i] + [p] * 10 + [i] * 6 + [f] + [i] * 5 + [p]
        bwd.restype = i
        _fns.update(fwd=fwd, bwd=bwd)
    return _fns


def _check(t, name, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _geometry(q, k, v, pack, prefix):
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if pack == 2:
        if d != PACK_HEAD_DIM or h != hkv:
            raise ValueError(f"the packed flash kernels take MHA heads of "
                             f"{PACK_HEAD_DIM}, got H {h}, Hkv {hkv}, D {d}")
    elif pack != 1:
        raise ValueError(f"no flash kernel packs {pack} heads: the kernels "
                         f"take 1, or 2 of {PACK_HEAD_DIM}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash kernels take f32/bf16, got {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernels take head_dim in {_HEAD_DIMS}, "
                         f"got {d}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} KV heads")
    _check(q, "q", q.device, q.dtype, (b, sq, h, d))
    _check(k, "k", q.device, q.dtype, (b, sk, hkv, d))
    _check(v, "v", q.device, q.dtype, (b, sk, hkv, d))
    if prefix is not None:
        if prefix.device != q.device or prefix.dtype != torch.int32 \
                or tuple(prefix.shape) != (b,) or not prefix.is_contiguous():
            raise ValueError(f"prefix must be a contiguous [{b}] int32 "
                             f"tensor on {q.device}")
    return b, sq, sk, h, hkv, d


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_fwd_cuda(q, k, v, *, causal, scale, window, prefix=None, pack=1,
                   offsets=None):
    """The forward kernel on ``q``'s device and current stream → ``(out,
    lse)``: for ``pack`` 1 ``flash_fwd_wgmma_kernel`` (bf16) or
    ``flash_fwd_kernel`` (f32), for ``pack`` 2
    ``flash_fwd_packed_wgmma_kernel`` (bf16) or ``flash_fwd_packed_kernel``
    (f32), two heads of 64 per block, MHA, any head count;
    ``fwd_cuda_kernel`` picks. ``prefix``: ``[B]`` int32 on the device, or
    None. ``offsets``: ``(q_off, k_off)`` host ints, or None. Both bf16
    kernels are persistent: each takes its work items (``fwd_items``)
    from its own counter in device memory, which each launch resets at its
    end, so their launches must not run on two streams at once (processes
    that share a card each have their own context, and so their own
    counters)."""
    b, sq, sk, h, hkv, d = _geometry(q, k, v, pack, prefix)
    q_off, k_off = host_offsets(offsets, sq, sk, window)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()["fwd"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _ptr(prefix), b, sq, sk, h, hkv, d, float(scale),
        int(causal), int(window), q_off, k_off,
        FWD_CUDA_KERNELS.index(fwd_cuda_kernel(q.dtype, pack)),
        _DTYPE_CODE[q.dtype], stream)
    name = "flash_fwd_packed" if pack == 2 else "flash_fwd"
    _raise_on(err, name)
    LAUNCHES[name] += 1
    if q_off or k_off:
        OFFSET_LAUNCHES[name] += 1
    return out, lse


def flash_bwd_cuda(q, k, v, g, lse, delta, *, causal, scale, window,
                   prefix=None, pack=1, offsets=None):
    """The dq kernel then the dkv kernel on ``q``'s device and current
    stream → ``(dq, dk, dv)``: ``bwd_cuda_kernel`` picks the pair, for
    ``pack`` 1 ``flash_bwd_dq_wgmma_kernel`` and
    ``flash_bwd_dkv_wgmma_kernel`` (bf16, on the tensor cores) or the
    mma.sync ``flash_bwd_dq_kernel`` and ``flash_bwd_dkv_kernel`` (f32),
    for ``pack`` 2 their packed twins (bf16) or the packed mma.sync pair
    (f32). ``delta`` ``[B, H, Sq]`` f32
    is ``rowsum(dO·O)`` (minus any lse cotangent). At head_dim 64 the bf16
    pair is persistent and takes its work from counters in device memory
    that each launch resets at its end, as the packed forward does, so its
    launches must not run on two streams at once."""
    b, sq, sk, h, hkv, d = _geometry(q, k, v, pack, prefix)
    q_off, k_off = host_offsets(offsets, sq, sk, window)
    _check(g, "dO", q.device, q.dtype, q.shape)
    _check(lse, "lse", q.device, torch.float32, (b, h, sq))
    _check(delta, "delta", q.device, torch.float32, (b, h, sq))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _ptr(prefix), b, sq, sk, h, hkv, d, float(scale),
            int(causal), int(window), q_off, k_off, _DTYPE_CODE[q.dtype],
            stream)
    suffix = "_packed" if pack == 2 else ""
    for kernel, name in zip(bwd_cuda_kernel(q.dtype, pack),
                            ("flash_bwd_dq", "flash_bwd_dkv")):
        _raise_on(_lib()["bwd"](BWD_CUDA_KERNELS.index(kernel), *args),
                  name + suffix)
        LAUNCHES[name + suffix] += 1
        if q_off or k_off:
            OFFSET_LAUNCHES[name + suffix] += 1
    return dq, dk, dv


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class _Flash(torch.autograd.Function):
    """Saves ``(q, k, v, out, lse)`` like ``_fwd_rule``; the backward
    computes ``delta`` in torch and runs the two backward kernels (or, on
    the CPU, ``flash_bwd_reference``). ``pack`` picks the kernels on the
    card: 1 the unpacked, 2 the packed."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, prefix, offsets, pack):
        kw = dict(causal=causal, scale=scale, window=window)
        if q.device.type == "cuda":
            if prefix is not None:
                prefix = prefix.to(device=q.device,
                                   dtype=torch.int32).contiguous()
            out, lse = flash_fwd_cuda(q.contiguous(), k.contiguous(),
                                      v.contiguous(), prefix=prefix,
                                      pack=pack, offsets=offsets, **kw)
        elif q.device.type == "cpu":
            out, lse = flash_fwd_reference(q, k, v, prefix=prefix,
                                           offsets=offsets, **kw)
        else:
            raise ValueError(f"flash_attention runs on cuda or cpu, not "
                             f"{q.device}")
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        ctx.extra = (prefix, offsets, pack)
        ctx.set_materialize_grads(False)  # an unused output's grad is None
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        prefix, offsets, pack = ctx.extra
        if g_out is None:
            g_out = torch.zeros_like(out)
        if q.device.type == "cpu":
            dq, dk, dv = flash_bwd_reference(
                q, k, v, out, lse, g_out, g_lse=g_lse, prefix=prefix,
                offsets=offsets, **ctx.kw)
        else:
            g = g_out.to(q.dtype).contiguous()
            delta = (g_out.float() * out.float()).sum(-1)       # [B, S, H]
            delta = delta.permute(0, 2, 1)
            if g_lse is not None:
                delta = delta - g_lse.float()
            dq, dk, dv = flash_bwd_cuda(
                q.contiguous(), k.contiguous(), v.contiguous(), g, lse,
                delta.contiguous(), prefix=prefix, pack=pack,
                offsets=offsets, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None


def _validate(q, k, causal, window, prefix_len):
    if window:
        if window < 0:
            raise ValueError(f"window must be >= 0, got {window}")
        if not causal:
            raise ValueError("window requires causal=True")
        if prefix_len is not None:
            raise ValueError("window and prefix_len are mutually exclusive")
    if prefix_len is not None and not causal:
        raise ValueError("prefix_len requires causal=True")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads do not group over "
                         f"{k.shape[2]} KV heads")


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             softmax_scale: Optional[float] = None,
                             window: int = 0, prefix_len=None, offsets=None,
                             head_pack: int = 0):
    """Flash attention returning ``(out, lse)``, both differentiable (ring
    attention merges blocks through the lse, so its cotangent folds into
    the backward's delta). q ``[B, Sq, H, D]``, k/v ``[B, Sk, Hkv, D]``;
    lse ``[B, H, Sq]`` f32. ``prefix_len`` ``[B]`` int: the GLM
    prefix-LM mask. ``head_pack``: heads per kernel block
    (``head_pack_for``; 0 = auto). ``offsets`` ``(q_off, k_off)`` (host
    ints, or a 2-element tensor read once to the host) shift the mask to
    global positions, as the JAX ``offs`` do."""
    _validate(q, k, causal, window, prefix_len)
    if offsets is not None:
        offsets = host_offsets(offsets, q.shape[1], k.shape[1], window)
    pack = head_pack_for(q.shape[2], k.shape[2], q.shape[3], head_pack)
    scale = q.shape[-1] ** -0.5 if softmax_scale is None else softmax_scale
    return _Flash.apply(q, k, v, bool(causal), float(scale), int(window),
                        prefix_len, offsets, pack)


def flash_attention(q, k, v, *, causal: bool = True,
                    softmax_scale: Optional[float] = None, window: int = 0,
                    prefix_len=None, head_pack: int = 0):
    """Flash attention ``[B, Sq, H, D]``: the CUDA kernels on the card,
    their plain versions on the CPU, with the backward of each. With the
    auto ``head_pack`` an MHA layout of head_dim 64 runs the packed
    kernels, any head count (an odd one leaves the last block one
    head)."""
    return flash_attention_with_lse(
        q, k, v, causal=causal, softmax_scale=softmax_scale, window=window,
        prefix_len=prefix_len, head_pack=head_pack)[0]
