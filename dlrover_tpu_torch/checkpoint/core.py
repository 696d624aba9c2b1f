"""The shard pack: a state of tensors ⇄ one contiguous buffer.

Port of ``dlrover_tpu/checkpoint/core.py`` with its layout byte for
byte, so a pack written by either package restores in the other:

    [u64 header_len][header JSON][pad to 128][shard | pad | shard | ...]

The header holds ``version``, ``step``, ``process_index``,
``process_count``, ``extra`` and, per leaf, its ``path``, ``dtype``
(numpy's name; ``bfloat16`` as ml_dtypes names it), ``global_shape`` and
the ``shards`` with their global ``index`` ([start, stop] a dim),
``offset`` from the payload start (a multiple of ``ALIGN``) and
``nbytes``.

A state is a list of ``Leaf``: the JAX tree's flattened leaves, each
with the port tensors that hold its shards. A port tensor may hold the
TRANSPOSE of its shard (``nn.Linear`` keeps ``[out, in]`` where the JAX
tree keeps ``[in, out]``): it is transposed on the device before its
copy out and after its copy in. Bytes move through ``torch`` views of
the buffer, so bf16 leaves need no ml_dtypes.

The port writes the 8-byte header length LAST, after every shard and
the header: a staged segment whose length reads 0 is being written (or
was torn by a crash) and is never restored.
"""

import dataclasses
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from dlrover_tpu_torch.observability.tracing import get_tracer

HEADER_LEN_BYTES = 8
ALIGN = 128

DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float16": torch.float16, "float64": torch.float64,
    "int32": torch.int32, "int64": torch.int64, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """The header's name of a torch dtype (numpy's; ml_dtypes' for bf16)."""
    return _NAMES[dtype]


@dataclasses.dataclass
class Shard:
    """One shard of a leaf: its global ``index`` ([start, stop] a dim) and
    the port tensor that holds it, or its transpose when ``transposed``
    (the shard's shape, its size-1 dims dropped, is then 2-D)."""

    index: List[List[int]]
    tensor: torch.Tensor
    transposed: bool = False


@dataclasses.dataclass
class Leaf:
    path: str
    dtype: str
    global_shape: List[int]
    shards: List[Shard]


@dataclasses.dataclass
class ShardEntry:
    index: List[List[int]]  # [[start, stop], ...] per dim (global coords)
    offset: int
    nbytes: int


@dataclasses.dataclass
class LeafEntry:
    path: str
    dtype: str
    global_shape: List[int]
    shards: List[ShardEntry]


def _align(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def plan_pack(leaves: Sequence[Leaf]) -> Tuple[List[LeafEntry], int]:
    """The header entries and the payload size of ``leaves``."""
    entries: List[LeafEntry] = []
    offset = 0
    for leaf in leaves:
        item = torch.empty((), dtype=DTYPES[leaf.dtype]).element_size()
        shards = []
        for s in leaf.shards:
            nbytes = item * math.prod(b - a for a, b in s.index)
            offset = _align(offset)
            shards.append(ShardEntry([list(i) for i in s.index], offset,
                                     nbytes))
            offset += nbytes
        entries.append(LeafEntry(leaf.path, leaf.dtype,
                                 list(leaf.global_shape), shards))
    return entries, offset


def header_bytes(step: int, entries: List[LeafEntry],
                 extra: Optional[Dict] = None) -> bytes:
    """The header JSON, field for field the JAX package's (one process:
    ``process_index`` 0 of ``process_count`` 1)."""
    doc = {
        "version": 1,
        "step": step,
        "process_index": 0,
        "process_count": 1,
        "extra": extra or {},
        "leaves": [
            {
                "path": e.path,
                "dtype": e.dtype,
                "global_shape": e.global_shape,
                "shards": [dataclasses.asdict(s) for s in e.shards],
            }
            for e in entries
        ],
    }
    return json.dumps(doc).encode("utf-8")


def payload_start(header: bytes) -> int:
    return _align(HEADER_LEN_BYTES + len(header))


def pack_size(header: bytes, payload_size: int) -> int:
    return payload_start(header) + payload_size


def _shard_source(s: Shard) -> torch.Tensor:
    """The shard's values in its global layout, contiguous (a transposed
    tensor is transposed where it lives: on the card for a card tensor)."""
    t = s.tensor.t() if s.transposed else s.tensor
    return t.contiguous()


def write_pack(buf: torch.Tensor, leaves: Sequence[Leaf],
               entries: List[LeafEntry], header: bytes) -> int:
    """Write every shard of ``leaves`` and the header into ``buf`` (a
    uint8 tensor over host memory); returns the bytes used.

    The copies of card tensors are all started, on the current stream,
    before one wait for their end, so the device transposes and the
    copies stream back to back; the wait also keeps the next step's
    in-place update from racing them. The header length goes in last.
    """
    buf[:HEADER_LEN_BYTES] = 0
    start = payload_start(header)
    used = start
    on_card = False
    with get_tracer().span("ckpt.write_pack", leaves=len(leaves)):
        for leaf, entry in zip(leaves, entries):
            dtype = DTYPES[leaf.dtype]
            for s, e in zip(leaf.shards, entry.shards):
                src = _shard_source(s)
                lo = start + e.offset
                dst = buf[lo: lo + e.nbytes].view(dtype).view(src.shape)
                dst.copy_(src, non_blocking=src.is_cuda)
                on_card |= src.is_cuda
                used = max(used, lo + e.nbytes)
        if on_card:
            torch.cuda.current_stream().synchronize()
    n = len(header)
    buf[HEADER_LEN_BYTES: HEADER_LEN_BYTES + n] = torch.frombuffer(
        bytearray(header), dtype=torch.uint8)
    buf[:HEADER_LEN_BYTES] = torch.frombuffer(
        bytearray(n.to_bytes(HEADER_LEN_BYTES, "little")), dtype=torch.uint8)
    return used


def read_header(buf) -> Optional[Dict]:
    """The header of the pack in ``buf`` (bytes-like or a uint8 tensor),
    or None while its length field reads 0 (being written, or torn)."""
    raw = _as_bytes(buf)
    n = _header_len(raw)
    if n == 0:
        return None
    return json.loads(raw[HEADER_LEN_BYTES: HEADER_LEN_BYTES + n]
                      .numpy().tobytes())


def _header_len(raw: torch.Tensor) -> int:
    return int.from_bytes(raw[:HEADER_LEN_BYTES].numpy().tobytes(), "little")


def _as_bytes(buf) -> torch.Tensor:
    if isinstance(buf, torch.Tensor):
        return buf
    return torch.frombuffer(buf, dtype=torch.uint8)


class PackIndex:
    """Random access over one or more packs (staged segments or mapped
    files), as views: nothing is copied until a slice is read."""

    def __init__(self):
        # path -> [(index, raw uint8 view)]
        self._shards: Dict[str, List[Tuple[List[List[int]],
                                           torch.Tensor]]] = {}
        self._meta: Dict[str, Tuple[str, Tuple[int, ...]]] = {}
        self.step: Optional[int] = None

    def add_pack(self, buf):
        raw = _as_bytes(buf)
        doc = read_header(raw)
        if doc is None:
            raise KeyError("pack is incomplete: its header length is 0")
        if self.step is None:
            self.step = doc["step"]
        start = _align(HEADER_LEN_BYTES + _header_len(raw))
        for leaf in doc["leaves"]:
            path = leaf["path"]
            self._meta[path] = (leaf["dtype"], tuple(leaf["global_shape"]))
            for s in leaf["shards"]:
                lo = start + s["offset"]
                self._shards.setdefault(path, []).append(
                    (s["index"], raw[lo: lo + s["nbytes"]]))

    def add_tensor(self, path: str, t: torch.Tensor):
        """Index a whole leaf held in one host tensor (the JAX state's
        arrays as a restore source)."""
        t = t.contiguous()
        self._meta[path] = (dtype_name(t.dtype), tuple(t.shape))
        self._shards[path] = [([[0, d] for d in t.shape],
                               t.reshape(-1).view(torch.uint8))]

    def close(self):
        """Drop every view, so the segment or mapping can close."""
        self._shards.clear()
        self._meta.clear()

    def global_shape(self, path: str) -> Tuple[int, ...]:
        return self._meta[path][1]

    def read_slice(self, path: str, want: Sequence[Sequence[int]]
                   ) -> torch.Tensor:
        """The global slice ``want`` ([start, stop] a dim) of ``path``: a
        view when one stored shard covers it, else assembled."""
        dtype = DTYPES[self._meta[path][0]]
        stored = self._shards.get(path, [])
        shape = [b - a for a, b in want]
        for idx, raw in stored:
            if all(h0 <= w0 and w1 <= h1
                   for (w0, w1), (h0, h1) in zip(want, idx)):
                view = raw.view(dtype).view([b - a for a, b in idx])
                return view[tuple(slice(w0 - h0, w1 - h0) for (w0, w1), (h0, _)
                                  in zip(want, idx))]
        out = torch.empty(shape, dtype=dtype)
        filled = torch.zeros(shape, dtype=torch.bool)
        for idx, raw in stored:
            inter = [(max(w0, h0), min(w1, h1))
                     for (w0, w1), (h0, h1) in zip(want, idx)]
            if any(lo >= hi for lo, hi in inter):
                continue
            view = raw.view(dtype).view([b - a for a, b in idx])
            dst = tuple(slice(lo - w0, hi - w0)
                        for (lo, hi), (w0, _) in zip(inter, want))
            src = tuple(slice(lo - h0, hi - h0)
                        for (lo, hi), (h0, _) in zip(inter, idx))
            out[dst] = view[src]
            filled[dst] = True
        if not bool(filled.all()):
            raise KeyError(f"pack set does not cover the slice {want} of "
                           f"{path}")
        return out


class RestoreMismatchError(Exception):
    """The checkpoint's leaf set does not satisfy the restore contract
    (a leaf missing without ``partial``, a missing PARAM leaf, or a global
    shape that differs). Deliberately not a KeyError: the engine's tiers
    read KeyError as "no checkpoint here", and a contract violation must
    propagate instead of silently restarting from scratch."""


def state_template(leaves: Sequence[Leaf]) -> Dict[str, Tuple[str, Tuple]]:
    """The abstract (dtype, global shape) of each leaf of a live state,
    by path: what a restore checks a pack against before it writes."""
    return {leaf.path: (leaf.dtype, tuple(leaf.global_shape))
            for leaf in leaves}


def restore_leaves(leaves: Sequence[Leaf], pack_index: PackIndex,
                   partial: bool = False) -> List[str]:
    """Copy the pack's values into ``leaves``' tensors, in place, each in
    its tensor's dtype. Every leaf is checked against the pack before any
    tensor is written. ``partial``: leaves missing from the pack keep
    their values (never a ``params`` leaf). Returns the kept paths."""
    kept = []
    for path, (_, gshape) in state_template(leaves).items():
        if path not in pack_index._meta:
            if not partial:
                raise RestoreMismatchError(
                    f"checkpoint has no leaf {path} (state tree grew since "
                    "the save?); pass partial=True to keep fresh values for "
                    "new leaves")
            if path.startswith("params"):
                raise RestoreMismatchError(
                    f"partial restore: param leaf {path} is missing from the "
                    "checkpoint; refusing to substitute fresh weights")
            kept.append(path)
        elif tuple(pack_index.global_shape(path)) != gshape:
            raise RestoreMismatchError(
                f"{path}: checkpoint shape "
                f"{list(pack_index.global_shape(path))} against "
                f"{list(gshape)}")
    span = get_tracer().span("ckpt.restore_tree", step=pack_index.step,
                             leaves=len(leaves))
    on_card = False
    for leaf in leaves:
        if leaf.path in kept:
            continue
        for s in leaf.shards:
            src = pack_index.read_slice(leaf.path, s.index).contiguous()
            dst = s.tensor
            if dst.is_cuda:
                src = src.to(dst.device, non_blocking=True)
                on_card = True
            src = src.view(dst.t().shape if s.transposed else dst.shape)
            dst.copy_(src.t() if s.transposed else src)
    if on_card:
        # the copies read the pack's memory: finish them before it closes
        torch.cuda.current_stream().synchronize()
    span.end(kept=len(kept))
    return kept
