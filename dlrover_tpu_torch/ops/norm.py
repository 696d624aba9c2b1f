"""Fused rmsnorm / layernorm with an optional fused residual add.

Port of ``dlrover_tpu/ops/pallas_norm.py``:

- ``norm`` — the op, with autograd. On CUDA tensors the forward launches
  ``norm_fwd_kernel`` and the backward ``norm_bwd_kernel``, the
  hand-written Hopper kernels of ``csrc/fused_norm.cu``, which replace the
  TPU kernels ``_fwd_kernel`` and ``_bwd_kernel``. On CPU tensors the same
  autograd function runs the plain versions. A CUDA tensor launches the
  kernel or raises.
- ``_reference`` — the plain forward, the port of ``pallas_norm._reference``
  (the math of ``decoder._norm``, with the pre-norm residual add in the
  input dtype); ``norm_bwd_reference`` — the plain backward, the formulas
  of ``_bwd_kernel`` on the saved summed stream.

With ``residual``, ``norm`` returns ``(norm(x + residual), x + residual)``
from one visit, and the backward saves only the summed stream ``h``
(a forward output already), recomputing the statistics from it.
"""

import ctypes
from typing import Dict

import torch

# the decoder passes no eps: these two constants are its defaults
RMS_EPS = 1e-6
LN_EPS = 1e-5

#: the CUDA kernels of ``csrc/fused_norm.cu``
KERNELS = ("norm_fwd", "norm_bwd")
#: launches of each kernel since the last ``reset_launches()``
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KINDS = ("rmsnorm", "layernorm")


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------


def _reference(x, scale, bias, kind, eps, residual):
    """The plain forward: ``norm(h)``, or ``(norm(h), h)`` with
    ``h = x + residual`` added in the input dtype; f32 statistics
    (layernorm single-pass ``E[x]``, ``E[x²]``, variance clamped at 0);
    output in ``x.dtype``."""
    h = x + residual if residual is not None else x
    x32 = h.float()
    if kind == "rmsnorm":
        rms = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
        out = x32 * rms * scale.float()
    else:
        mean = x32.mean(-1, keepdim=True)
        ex2 = (x32 * x32).mean(-1, keepdim=True)
        var = torch.clamp(ex2 - mean * mean, min=0.0)
        out = (x32 - mean) * torch.rsqrt(var + eps)
        out = out * scale.float()
        if bias is not None:
            out = out + bias.float()
    out = out.to(x.dtype)
    return (out, h) if residual is not None else out


def norm_bwd_reference(g, h, scale, gh, kind, eps, has_bias):
    """``(dx, dscale, dbias)`` of ``_bwd_kernel``: statistics recomputed
    from the saved stream ``h`` ``[N, D]``, the row formulas in f32, the
    stream's own cotangent ``gh`` folded into dx; dscale/dbias are the
    column sums (f32). dbias is None without a bias."""
    g32, h32, s32 = g.float(), h.float(), scale.float()
    d = h.shape[-1]
    if kind == "rmsnorm":
        ms = (h32 * h32).sum(-1, keepdim=True) / d
        r = torch.rsqrt(ms + eps)
        gx = g32 * s32
        dot = (gx * h32).sum(-1, keepdim=True) / d
        dx = r * gx - (r * r * r) * dot * h32
        dscale = (g32 * h32 * r).sum(0)
        dbias = None
    else:
        mean = h32.sum(-1, keepdim=True) / d
        ex2 = (h32 * h32).sum(-1, keepdim=True) / d
        var = torch.clamp(ex2 - mean * mean, min=0.0)
        r = torch.rsqrt(var + eps)
        xhat = (h32 - mean) * r
        gx = g32 * s32
        m1 = gx.sum(-1, keepdim=True) / d
        m2 = (gx * xhat).sum(-1, keepdim=True) / d
        dx = r * (gx - m1 - xhat * m2)
        dscale = (g32 * xhat).sum(0)
        dbias = g32.sum(0) if has_bias else None
    if gh is not None:
        dx = dx + gh.float()
    return dx.to(h.dtype), dscale, dbias


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

_fns = {}
# the widest rows the kernels take (glm-10b's d_model; the f32 model
# checks run it too)
_MAX_D = {torch.bfloat16: 4096, torch.float32: 4096}
#: vectors of 16 bytes a lane the forward plans for a row, at most:
#: without and with a residual
FWD_LANE_VECTORS = (2, 4)
#: the same for the backward, whose lanes also keep their columns'
#: dscale (dbias) sums in registers
BWD_LANE_VECTORS = (2, 2)
#: warps a row (forward and backward)
FWD_WARPS = (1, 2, 4, 8)


def _plan(d, dtype, cap):
    n_vec = d // (16 // dtype.itemsize)
    warps = next((w for w in FWD_WARPS if n_vec <= 32 * w * cap),
                 FWD_WARPS[-1])
    per_lane = -(-n_vec // (32 * warps))
    return warps, 1 << (per_lane - 1).bit_length()


def fwd_plan(d: int, dtype, residual: bool = False) -> tuple:
    """``(warps_per_row, vectors_per_lane)`` of ``norm_fwd_kernel`` for
    rows of ``d`` elements: the fewest of ``FWD_WARPS`` whose lanes hold
    the row's 16-byte vectors at ``FWD_LANE_VECTORS`` a lane (8 warps
    beyond that: f32 rows over 2048 elements without a residual), and the
    vectors a lane rounded up to a power of two (the kernel's
    instantiations). Spreading a row over many small loads ran fastest on
    the H100 at the training widths (PERF.md)."""
    return _plan(d, dtype, FWD_LANE_VECTORS[bool(residual)])


def bwd_plan(d: int, dtype, residual: bool = False) -> tuple:
    """``(warps_per_row, vectors_per_lane)`` of ``norm_bwd_kernel``: the
    rule of ``fwd_plan`` at ``BWD_LANE_VECTORS`` a lane (8 warps beyond
    that: f32 rows over 2048 elements, 4 vectors a lane). A lane holds its
    vectors of the row's g and h (and gh) and its columns' dscale (dbias)
    sums in f32 without spilling; the next rows wait in shared memory."""
    return _plan(d, dtype, BWD_LANE_VECTORS[bool(residual)])


def _lib():
    """The C entry points of ``csrc/fused_norm.cu``, built on first use."""
    if not _fns:
        from dlrover_tpu_torch.ops import _build

        lib = _build.load("fused_norm")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fwd = lib.dlrover_norm_fwd
        fwd.argtypes = [p] * 6 + [i, i, f, i, i, i, i, p]
        fwd.restype = i
        bwd = lib.dlrover_norm_bwd
        bwd.argtypes = [p] * 9 + [i, i, f, i, i, i, i, i, p]
        bwd.restype = i
        blocks = lib.dlrover_norm_bwd_blocks
        blocks.argtypes = [i] * 8
        blocks.restype = i
        _fns.update(fwd=fwd, bwd=bwd, bwd_blocks=blocks)
    return _fns


def _check_rows(t, name, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: want {dtype} {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _geometry(x2):
    n, d = x2.shape
    if x2.dtype not in _DTYPE_CODE:
        raise TypeError(f"norm kernels take f32/bf16, got {x2.dtype}")
    if d % 8 or d > _MAX_D[x2.dtype]:
        raise ValueError(f"norm kernels take a last dim that is a multiple "
                         f"of 8 and at most {_MAX_D[x2.dtype]} for "
                         f"{x2.dtype}, got {d}")
    return n, d


def norm_fwd_cuda(x2, scale, bias, res2, kind, eps):
    """``norm_fwd_kernel`` over rows ``[N, D]`` → ``(out, h)`` (``h`` is
    ``x2`` itself without a residual), launched with ``fwd_plan``'s warps
    a row and vectors a lane."""
    n, d = _geometry(x2)
    dev = x2.device
    _check_rows(x2, "x", x2.dtype, (n, d), dev)
    _check_rows(scale, "scale", torch.float32, (d,), dev)
    if bias is not None:
        _check_rows(bias, "bias", torch.float32, (d,), dev)
    out = torch.empty_like(x2)
    h = x2
    if res2 is not None:
        _check_rows(res2, "residual", x2.dtype, (n, d), dev)
        h = torch.empty_like(x2)
    err = _lib()["fwd"](
        x2.data_ptr(), res2.data_ptr() if res2 is not None else None,
        scale.data_ptr(), bias.data_ptr() if bias is not None else None,
        out.data_ptr(), h.data_ptr() if res2 is not None else None,
        n, d, float(eps), int(kind == "rmsnorm"), _DTYPE_CODE[x2.dtype],
        *fwd_plan(d, x2.dtype, res2 is not None),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"norm_fwd kernel launch failed: cudaError {err}")
    LAUNCHES["norm_fwd"] += 1
    return out, h


def norm_bwd_cuda(g2, h2, scale, gh2, kind, eps, has_bias):
    """``norm_bwd_kernel`` → ``(dx, dscale, dbias)``, launched with
    ``bwd_plan``'s warps a row and vectors a lane over the grid the C side
    reports; each block writes one dscale/dbias partial row into scratch
    of that many rows, and the same C call sums them in a fixed order
    (``norm_bwd_colsum_kernel``)."""
    n, d = _geometry(h2)
    dev = h2.device
    _check_rows(g2, "g", h2.dtype, (n, d), dev)
    _check_rows(h2, "h", h2.dtype, (n, d), dev)
    _check_rows(scale, "scale", torch.float32, (d,), dev)
    if gh2 is not None:
        _check_rows(gh2, "gh", h2.dtype, (n, d), dev)
    fns = _lib()
    rms = int(kind == "rmsnorm")
    code = _DTYPE_CODE[h2.dtype]
    plan = bwd_plan(d, h2.dtype, gh2 is not None)
    n_part = fns["bwd_blocks"](n, d, rms, int(gh2 is not None),
                               int(has_bias), code, *plan)
    if n_part <= 0:
        raise RuntimeError(f"norm_bwd grid query failed: cudaError "
                           f"{-n_part}")
    dx = torch.empty_like(h2)
    parts = torch.empty((1 + has_bias, n_part, d), dtype=torch.float32,
                        device=dev)
    sums = torch.empty((1 + has_bias, d), dtype=torch.float32, device=dev)
    err = fns["bwd"](
        g2.data_ptr(), h2.data_ptr(), scale.data_ptr(),
        gh2.data_ptr() if gh2 is not None else None, dx.data_ptr(),
        parts[0].data_ptr(), parts[1].data_ptr() if has_bias else None,
        sums[0].data_ptr(), sums[1].data_ptr() if has_bias else None,
        n, d, float(eps), rms, code, *plan, n_part,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"norm_bwd kernel launch failed: cudaError {err}")
    LAUNCHES["norm_bwd"] += 1
    return dx, sums[0], sums[1] if has_bias else None


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class _Norm(torch.autograd.Function):
    """Forward ``(out, h)`` over ``[N, D]`` rows; saves ``h`` (the summed
    stream, or x) as the only activation, like ``_norm_call_fwd``."""

    @staticmethod
    def forward(ctx, x2, scale, bias, res2, kind, eps):
        if x2.device.type == "cuda":
            out, h = norm_fwd_cuda(x2.contiguous(), scale.float().contiguous(),
                                   None if bias is None
                                   else bias.float().contiguous(),
                                   None if res2 is None else res2.contiguous(),
                                   kind, eps)
        elif x2.device.type == "cpu":
            res = _reference(x2, scale, bias, kind, eps, res2)
            out, h = res if res2 is not None else (res, x2)
        else:
            raise ValueError(f"norm runs on cuda or cpu, not {x2.device}")
        ctx.save_for_backward(h, scale)
        ctx.meta = (kind, eps, bias is not None, res2 is not None,
                    None if bias is None else bias.dtype)
        ctx.set_materialize_grads(False)
        if res2 is None:
            return out
        return out, h

    @staticmethod
    def backward(ctx, g_out, g_h=None):
        h, scale = ctx.saved_tensors
        kind, eps, has_bias, has_res, bias_dtype = ctx.meta
        if g_out is None:
            g_out = torch.zeros_like(h)
        g = g_out.to(h.dtype)
        gh = None if g_h is None else g_h.to(h.dtype)
        if h.device.type == "cuda":
            dx, dscale, dbias = norm_bwd_cuda(
                g.contiguous(), h.contiguous(), scale.float().contiguous(),
                None if gh is None else gh.contiguous(), kind, eps, has_bias)
        else:
            dx, dscale, dbias = norm_bwd_reference(
                g, h, scale, gh, kind, eps, has_bias)
        dscale = dscale.to(scale.dtype)
        if dbias is not None:
            dbias = dbias.to(bias_dtype)
        # d(x + res)/dx = d(x + res)/dres = identity: both take dx
        return dx, dscale, dbias, dx if has_res else None, None, None


def norm(x, scale, bias=None, kind: str = "rmsnorm", *, residual=None,
         eps: float = None):
    """Fused norm over the last axis of ``x`` (``[..., D]``).

    Without ``residual``: ``norm(x)``. With it: ``(norm(x + residual),
    x + residual)``, the summed stream emitted from the same kernel visit.
    ``kind``: "rmsnorm" (bias ignored) or "layernorm". CUDA tensors run
    the kernels, CPU tensors the plain versions, both with the backward
    of ``_bwd_kernel``."""
    if kind not in _KINDS:
        raise ValueError(f"unknown norm kind {kind!r}")
    if eps is None:
        eps = RMS_EPS if kind == "rmsnorm" else LN_EPS
    if kind == "rmsnorm":
        bias = None
    d = x.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, d)
    res2 = None if residual is None else residual.reshape(-1, d)
    out = _Norm.apply(x2, scale, bias, res2, kind, float(eps))
    if residual is None:
        return out.reshape(lead + (d,))
    return out[0].reshape(lead + (d,)), out[1].reshape(lead + (d,))
