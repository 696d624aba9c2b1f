"""Paged KV cache for the serving engine.

Port of ``dlrover_tpu/serving/kv_cache.py``: physical KV storage is a
pool of fixed-size pages; each decode slot owns a row of a block table
mapping logical page index → physical page. Admission grabs pages from
a free list, eviction returns them.

Two storage modes share one geometry:

- ``bf16`` — pages hold the model compute dtype verbatim.
- ``int8`` — pages hold int8 payloads + per-block f32 scales
  (``ops/quant.py`` ``kv_encode_rows``), dequantized inside the paged
  attention kernel. A token row of ``kv_heads*head_dim`` elements
  becomes ``row`` int8 bytes + ``row/kv_block`` f32 scales.

Physical page 0 is the TRASH page: never allocated, the write target
for masked-out lanes (inactive slots, prefill-chunk padding).

Pools are torch tensors on the engine's device, layer-leading so one
layer's slice is a contiguous view; the decoder writes into them in
place. The host side (``PageAllocator``) is plain numpy + a free list,
with per-page refcounts for prefix sharing (``admit_shared`` maps a
committed prefix into a new slot, ``cow_page`` gives a slot its own copy
of a shared page). Live page migration between replicas
(``serving/migration.py``) and the prefill → decode handoff
(``serving/disagg.py``) hold their landing pages through the
allocator's named reservations (``reserve_for_migration`` /
``commit_migration`` / ``abort_migration``), so an in-flight transfer
never loses its pages to admission.
"""

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.ops import quant

TRASH_PAGE = 0


class PageGeometry(NamedTuple):
    """Static shape/layout contract between allocator and pools."""

    n_layers: int
    kv_heads: int
    head_dim: int
    page_size: int           # tokens per page
    n_pages: int             # physical pages incl. the trash page
    max_pages_per_slot: int  # block-table width
    mode: str                # "bf16" | "int8"
    dtype: str               # model compute dtype (bf16-mode pools)
    kv_block: int            # int8 scale-block width (elements)

    @property
    def row_elems(self) -> int:
        return self.kv_heads * self.head_dim

    @property
    def n_blocks(self) -> int:
        return self.row_elems // self.kv_block

    @property
    def max_len(self) -> int:
        """Longest sequence one slot can hold."""
        return self.max_pages_per_slot * self.page_size


def make_geometry(
    cfg,
    *,
    n_slots: int,
    max_len: int,
    page_size: int = 16,
    mode: str = "int8",
    slack_pages: int = 0,
) -> PageGeometry:
    """Geometry sized so ``n_slots`` concurrent sequences of ``max_len``
    tokens always fit, plus ``slack_pages`` headroom and the trash page."""
    if mode not in ("bf16", "int8"):
        raise ValueError(f"mode must be bf16|int8, got {mode}")
    max_pages = -(-max_len // page_size)
    row = cfg.kv_heads * cfg.head_dim
    return PageGeometry(
        n_layers=cfg.n_layer,
        kv_heads=cfg.kv_heads,
        head_dim=cfg.head_dim,
        page_size=page_size,
        n_pages=1 + n_slots * max_pages + slack_pages,
        max_pages_per_slot=max_pages,
        mode=mode,
        dtype=str(cfg.dtype),
        kv_block=quant.kv_block_size(row),
    )


def init_pools(geom: PageGeometry, device) -> Dict[str, torch.Tensor]:
    """Allocate the physical page pools on ``device``, zero-filled."""
    g = geom
    if g.mode == "bf16":
        shape = (g.n_layers, g.n_pages, g.page_size, g.kv_heads, g.head_dim)
        dt = getattr(torch, g.dtype)
        return {
            "k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
        }
    qshape = (g.n_layers, g.n_pages, g.page_size, g.n_blocks, g.kv_block)
    sshape = (g.n_layers, g.n_pages, g.page_size, g.n_blocks)
    return {
        "k_q": torch.zeros(qshape, dtype=torch.int8, device=device),
        "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
        "v_q": torch.zeros(qshape, dtype=torch.int8, device=device),
        "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
    }


def layer_pools(pools: Dict[str, torch.Tensor], layer: int):
    """One layer's slice of every pool: views, so writes land in place."""
    return {k: v[layer] for k, v in pools.items()}


def resident_bytes(geom: PageGeometry) -> int:
    """Resident KV pool bytes at this geometry: K and V rows of every
    page cell, int8 payloads plus their f32 scales."""
    g = geom
    rows = g.n_layers * g.n_pages * g.page_size
    if g.mode == "bf16":
        return 2 * rows * g.row_elems * getattr(torch, g.dtype).itemsize
    return 2 * rows * (g.row_elems + 4 * g.n_blocks)


class PageAllocator:
    """Host-side block-table allocator over the physical page pool.

    Invariants: every physical page's refcount equals the number of
    (slot, logical) table cells mapping it — 1 for a private page, >1
    when prefix sharing maps one committed page into several slots;
    page 0 (trash) is never handed out; ``evict`` decrements each held
    page's refcount and frees only the pages that reach 0; free +
    assigned-unique + reserved is a partition of pages 1..n_pages-1.
    Reservations are the migration footprint hold: pages moved from the
    free list into a named bucket, invisible to ``can_admit``/``ensure``
    until ``commit_migration`` assigns them to a slot or
    ``abort_migration`` returns them. Pages are
    popped in ascending order, the same discipline as the JAX
    allocator, so the same trace gives the same tables in both
    packages. Mutations are not locked — the engine thread owns the
    allocator.

    ``on_free`` (optional) fires with the list of physical pages whose
    refcount just hit zero — the prefix index drops them there, so a
    recycled page is never offered as a prefix hit."""

    def __init__(self, geom: PageGeometry, n_slots: int):
        self.geom = geom
        self.n_slots = n_slots
        # pop() yields ascending physical pages — deterministic layouts
        self._free = list(range(geom.n_pages - 1, TRASH_PAGE, -1))
        self._reserved: Dict[str, List[int]] = {}
        self._tables = np.full(
            (n_slots, geom.max_pages_per_slot), -1, np.int32
        )
        self._n_pages = np.zeros(n_slots, np.int32)
        # per-physical-page refcount: (slot, logical) cells mapping it
        self._rc = np.zeros(geom.n_pages, np.int32)
        # set by every table mutation; the engine consumes it to re-ship
        # the device copy only when something actually changed
        self._dirty = True
        # cached snapshot for block_tables(), dropped by every mutation
        self._snap: Optional[np.ndarray] = None
        self.on_free: Optional[Callable[[List[int]], None]] = None

    # ---- queries ---------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-max(int(n_tokens), 0) // self.geom.page_size)

    def can_admit(self, n_tokens: int, n_shared: int = 0) -> bool:
        """True when a slot covering ``n_tokens`` fits. ``n_shared``
        discounts prefix pages that would be mapped rather than drawn
        from the free list (a copy-on-write page is a fresh allocation
        and gets no discount)."""
        need = self.pages_needed(n_tokens)
        return (
            need <= self.geom.max_pages_per_slot
            and need - min(int(n_shared), need) <= len(self._free)
        )

    def slot_pages(self, slot: int) -> int:
        return int(self._n_pages[slot])

    def refcount(self, page: int) -> int:
        return int(self._rc[page])

    @property
    def unique_assigned_pages(self) -> int:
        """Distinct physical pages held by any slot — the denominator of
        the dedup ratio (slot cells / unique pages)."""
        return int(np.count_nonzero(self._rc))

    @property
    def reserved_pages(self) -> int:
        return sum(len(p) for p in self._reserved.values())

    def reservation(self, tag: str) -> Tuple[int, ...]:
        """The physical pages held under ``tag`` (empty if none)."""
        return tuple(self._reserved.get(tag, ()))

    def block_tables(self) -> np.ndarray:
        """A host-side snapshot of the [n_slots, max_pages] table, cached
        between mutations (a returned snapshot is never mutated)."""
        if self._snap is None:
            self._snap = self._tables.copy()
        return self._snap

    def consume_dirty(self) -> bool:
        """True exactly once after any table mutation since the last
        call — the engine re-ships its device copy only then."""
        d = self._dirty
        self._dirty = False
        return d

    # ---- transitions -----------------------------------------------------

    def _mutated(self) -> None:
        self._dirty = True
        self._snap = None

    def admit(self, slot: int, n_tokens: int) -> bool:
        """Assign pages covering ``n_tokens`` to an EMPTY slot."""
        if self._n_pages[slot]:
            raise ValueError(f"slot {slot} already holds pages")
        return self.ensure(slot, n_tokens)

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot`` to cover ``n_tokens`` total; False (state
        unchanged) when the free list cannot cover the growth."""
        need = self.pages_needed(n_tokens)
        if need > self.geom.max_pages_per_slot:
            return False
        have = int(self._n_pages[slot])
        if need <= have:
            return True
        if need - have > len(self._free):
            return False
        for i in range(have, need):
            p = self._free.pop()
            self._tables[slot, i] = p
            self._rc[p] = 1
        self._n_pages[slot] = need
        self._mutated()
        return True

    def admit_shared(
        self, slot: int, n_tokens: int, prefix_pages: Sequence[int]
    ) -> bool:
        """Admit an EMPTY slot covering ``n_tokens``, mapping logical
        pages 0..len(prefix_pages)-1 onto EXISTING physical pages (rc+1
        each — a prefix hit) and drawing the rest fresh. False (state
        unchanged) when the free list cannot cover the unshared suffix.
        Shared pages are read-only for this slot until ``cow_page``
        gives it a private copy."""
        if self._n_pages[slot]:
            raise ValueError(f"slot {slot} already holds pages")
        need = self.pages_needed(n_tokens)
        shared = list(prefix_pages)
        if len(shared) > need:
            raise ValueError(
                f"prefix ({len(shared)} pages) exceeds footprint ({need})"
            )
        if need > self.geom.max_pages_per_slot:
            return False
        if need - len(shared) > len(self._free):
            return False
        for p in shared:  # validate BEFORE mutating — no partial maps
            if not (TRASH_PAGE < p < self.geom.n_pages) or self._rc[p] < 1:
                raise ValueError(f"prefix page {p} is not live")
        for i, p in enumerate(shared):
            self._tables[slot, i] = p
            self._rc[p] += 1
        for i in range(len(shared), need):
            p = self._free.pop()
            self._tables[slot, i] = p
            self._rc[p] = 1
        self._n_pages[slot] = need
        if need:
            self._mutated()
        return True

    def cow_page(self, slot: int, logical: int) -> Optional[Tuple[int, int]]:
        """Give ``slot`` a private copy of its ``logical`` page before it
        writes into it. None when the page is already private (rc 1);
        otherwise pops a fresh page, remaps the cell and returns
        ``(src, dst)`` physical pages — the caller copies the payload on
        the device. Raises when the free list is empty: the admission
        footprint must already have counted the copy."""
        if not 0 <= logical < int(self._n_pages[slot]):
            raise ValueError(f"slot {slot} has no logical page {logical}")
        src = int(self._tables[slot, logical])
        if self._rc[src] == 1:
            return None
        if not self._free:
            raise RuntimeError("cow_page: free list empty (footprint bug)")
        dst = self._free.pop()
        self._tables[slot, logical] = dst
        self._rc[src] -= 1
        self._rc[dst] = 1
        self._mutated()
        return src, dst

    def evict(self, slot: int) -> int:
        """Release every page the slot holds (rc-1 each; pages reaching
        0 return to the free list and go to ``on_free``); returns the
        CELL count released — the slot's logical footprint, not the
        pages actually freed."""
        n = int(self._n_pages[slot])
        freed: List[int] = []
        for i in range(n):
            p = int(self._tables[slot, i])
            self._rc[p] -= 1
            if self._rc[p] == 0:
                self._free.append(p)
                freed.append(p)
        self._tables[slot, :] = -1
        self._n_pages[slot] = 0
        if n:
            self._mutated()
        if freed and self.on_free is not None:
            self.on_free(freed)
        return n

    # ---- migration reservations ------------------------------------------

    def reserve_for_migration(self, tag: str, n_tokens: int) -> bool:
        """Hold the full page footprint of an incoming migrated request
        under ``tag``. False (state unchanged) when the free list cannot
        cover it: the caller sheds, backs off and retries."""
        if tag in self._reserved:
            raise ValueError(f"migration tag {tag!r} already reserved")
        need = self.pages_needed(n_tokens)
        if need > self.geom.max_pages_per_slot or need > len(self._free):
            return False
        self._reserved[tag] = [self._free.pop() for _ in range(need)]
        return True

    def commit_migration(self, tag: str, slot: int) -> List[int]:
        """Assign the reservation's pages to an EMPTY slot's table row in
        reservation order (logical page i → reserved page i); returns
        the physical pages, where the importer scatters the payloads."""
        if tag not in self._reserved:
            raise KeyError(f"no migration reservation {tag!r}")
        if self._n_pages[slot]:
            raise ValueError(f"slot {slot} already holds pages")
        pages = self._reserved.pop(tag)
        for i, p in enumerate(pages):
            self._tables[slot, i] = p
            self._rc[p] = 1
        self._n_pages[slot] = len(pages)
        if pages:
            self._mutated()
        return list(pages)

    def abort_migration(self, tag: str) -> int:
        """Return a reservation's pages to the free list (a torn transfer,
        the fall back to re-prefill). A missing tag is a no-op, so any
        phase's unwind may call it."""
        pages = self._reserved.pop(tag, [])
        self._free.extend(pages)
        return len(pages)
