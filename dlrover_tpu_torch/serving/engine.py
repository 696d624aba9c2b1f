"""Continuous-batching decode engine over the paged KV cache.

Port of ``dlrover_tpu/serving/engine.py``'s ``ServingEngine`` in its
unified role, paged mode, with speculative decoding and prefix sharing
off. Orca/vLLM-style iteration-level scheduling on a FIXED decode batch
of ``n_slots`` lanes: requests are admitted into free slots and evicted
at step boundaries, and every decode runs the full batch with a
per-lane ``valid`` mask. Each step is:

1. finish: resolve slots that hit ``max_new_tokens``/EOS, free pages;
2. admit: pop queued requests into free slots (head-of-line admission —
   the scheduler's top request waits for pages rather than being
   jumped), reserving the full prompt + generation footprint;
3. prefill one chunk: ONE slot advances its prompt by ``prefill_chunk``
   tokens (chunked prefill interleaves long prompts with decode);
4. decode: one token for every decoding slot in a single batched step.

Both steps are ``Decoder.prefill_chunk_paged`` /
``Decoder.decode_step_paged``: K/V rows commit straight to their page
cells and attention walks the block table through the paged-attention
kernel. The page walk is bounded by a power-of-two bucket of the most
pages any slot holds. The block tables are re-shipped to the device
only when the allocator reports a mutation.

Sampling (``models/generate.py``): greedy is argmax; a sampled token is
a Gumbel-max draw keyed on (request seed, absolute position of the
token drawn), so a stream is stable across admission order and batch
composition.

The pools are updated in place by each step (the JAX engine donates
them to its jitted steps instead).
"""

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models.generate import draw_token
from dlrover_tpu_torch.observability.tracing import get_tracer
from dlrover_tpu_torch.serving import kv_cache as kvc
from dlrover_tpu_torch.serving.scheduler import (
    AdmissionError,
    Request,
    Scheduler,
)


@dataclass
class _Slot:
    """Host-side state of one decode lane."""

    req: Request
    phase: str                  # "prefill" | "decode"
    prompt: np.ndarray          # int32 [P]
    n_prefilled: int = 0
    generated: List[int] = field(default_factory=list)
    span: object = None         # open "serving.decode" trace span, if any


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to dlrover_tpu_torch yet (ROADMAP {item})"
    )


class ServingEngine:
    """Single-replica continuous-batching engine (host loop + 2 steps)."""

    def __init__(
        self,
        model,
        cfg,
        scheduler: Scheduler,
        *,
        n_slots: int = 4,
        max_len: int = 128,
        page_size: int = 16,
        mode: str = "int8",
        prefill_chunk: int = 8,
        paged: bool = True,
        spec_k: int = 0,
        prefix_sharing: bool = False,
        role: str = "unified",
        device="cuda",
    ):
        if role != "unified":
            raise _not_ported(f"role={role!r} (disaggregated serving)",
                              "A15")
        if spec_k:
            raise _not_ported("speculative decoding (spec_k > 0)",
                              "A13, with the B7 verify variant")
        if prefix_sharing:
            raise _not_ported("prefix sharing", "A14")
        if not paged:
            raise _not_ported("the gather (paged=False) engine", "A15")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.scheduler = scheduler
        self.n_slots = n_slots
        self.prefill_chunk = prefill_chunk
        self.role = role
        self.geom = kvc.make_geometry(
            cfg, n_slots=n_slots, max_len=max_len, page_size=page_size,
            mode=mode,
        )
        if self.geom.max_len % prefill_chunk:
            raise ValueError(
                f"slot capacity {self.geom.max_len} (pages*page_size) must "
                f"be a multiple of prefill_chunk={prefill_chunk}: chunk "
                "starts are chunk-aligned, so an unaligned capacity would "
                "put a chunk's tail past the block table"
            )
        self.alloc = kvc.PageAllocator(self.geom, n_slots)
        self.pools = kvc.init_pools(self.geom, self.device)
        self.slots: List[Optional[_Slot]] = [None] * n_slots
        self.draining = False     # planned drain: stop admitting new work
        self._tokens = 0
        self._t0: Optional[float] = None
        self._tables_dev = None   # cached device block tables
        self._table_ships = 0     # host→device table transfers
        self._step_time = 0.0     # wall seconds inside model steps
        self._prefill_tokens = 0  # prompt tokens run through the chunk step
        self._prefill_chunks = 0  # chunk-step invocations

    # ---- queries ---------------------------------------------------------

    @property
    def max_len(self) -> int:
        """Longest prompt+generation one slot can hold."""
        return self.geom.max_len

    def active_slots(self) -> int:
        return sum(s is not None for s in self.slots)

    def stats(self) -> dict:
        dt = time.monotonic() - self._t0 if self._t0 else 0.0
        return {
            "active_slots": self.active_slots(),
            "free_pages": self.alloc.free_pages,
            "tokens_generated": self._tokens,
            "tokens_per_s": self._tokens / dt if dt > 0 else 0.0,
            "decode_kernel": "paged",
            "table_ships": self._table_ships,
            "step_time_s": self._step_time,
            "host_time_s": max(0.0, dt - self._step_time),
            "spec_k": 0,
            "prefill_tokens": self._prefill_tokens,
            "prefill_chunks": self._prefill_chunks,
            "role": self.role,
        }

    def resident_kv_bytes(self) -> int:
        return kvc.resident_bytes(self.geom)

    # ---- device-side inputs ----------------------------------------------

    def _device_tables(self) -> torch.Tensor:
        """The block tables on the device, re-shipped only when the
        allocator mutated since the last ship."""
        if self.alloc.consume_dirty() or self._tables_dev is None:
            self._tables_dev = torch.as_tensor(
                self.alloc.block_tables(), device=self.device
            )
            self._table_ships += 1
        return self._tables_dev

    def _pages_bucket(self) -> int:
        """Page-walk width: the next power of two ≥ the most pages any
        slot holds, floored at 4 and capped at the table width."""
        held = max(
            (self.alloc.slot_pages(i) for i in range(self.n_slots)),
            default=1,
        )
        b = 4
        while b < held:
            b *= 2
        return min(b, self.geom.max_pages_per_slot)

    def _tensor(self, values, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), dtype=dtype,
                               device=self.device)

    def _sampling_arrays(self, lanes):
        """Per-lane sampling inputs: seed, temperature, top_k, top_p.
        Idle lanes carry greedy defaults."""
        n = len(lanes)
        seeds = np.zeros(n, np.int64)
        temp = np.zeros(n, np.float32)
        top_k = np.zeros(n, np.int64)
        top_p = np.ones(n, np.float32)
        for j, i in enumerate(lanes):
            s = self.slots[i]
            if s is None:
                continue
            sp = s.req.sampling
            seeds[j] = int(sp.seed)
            temp[j] = sp.temperature
            top_k[j] = sp.top_k
            top_p[j] = sp.top_p
        return (
            self._tensor(seeds, torch.int64),
            self._tensor(temp, torch.float32),
            self._tensor(top_k, torch.int64),
            self._tensor(top_p, torch.float32),
        )

    def _draw(self, logits, lanes, positions) -> np.ndarray:
        seeds, temp, top_k, top_p = self._sampling_arrays(lanes)
        tok = draw_token(
            logits, seeds, self._tensor(positions, torch.int64),
            temp, top_k, top_p,
        )
        return tok.cpu().numpy()

    # ---- the step loop ---------------------------------------------------

    def step(self) -> bool:
        """One engine iteration; returns False when fully idle."""
        worked = self._finish_and_evict()
        worked = self._admit() or worked
        if self._t0 is None and any(self.slots):
            self._t0 = time.monotonic()
        worked = self._prefill_one() or worked
        worked = self._decode_batch() or worked
        return worked

    def drain(self, timeout: float = 120.0) -> None:
        """Step until queue and slots are empty (tests / benches)."""
        deadline = time.monotonic() + timeout
        while self.scheduler.queue_depth() or self.active_slots():
            self.step()
            if time.monotonic() > deadline:
                raise TimeoutError("engine did not drain in time")

    @staticmethod
    def _slot_done(s: _Slot) -> bool:
        req = s.req
        return len(s.generated) >= req.max_new_tokens or (
            req.eos_id is not None
            and bool(s.generated)
            and s.generated[-1] == req.eos_id
        )

    def _finish_and_evict(self) -> bool:
        worked = False
        for i, s in enumerate(self.slots):
            if s is None or s.phase != "decode" or not self._slot_done(s):
                continue
            if s.span is not None:
                s.span.end(tokens=len(s.generated), reason="completed")
                s.span = None
            self.scheduler.complete(
                s.req, [int(t) for t in s.prompt] + s.generated
            )
            self.alloc.evict(i)
            self.slots[i] = None
            worked = True
        return worked

    def _admit(self) -> bool:
        worked = False
        if self.draining:
            return worked
        while True:
            try:
                idx = self.slots.index(None)
            except ValueError:
                return worked

            def can(req):
                # oversize requests pass so they can be popped and FAILED
                # (they would block the head of the line forever)
                if req.total_tokens > self.geom.max_len:
                    return True
                return self.alloc.can_admit(req.total_tokens)

            req = self.scheduler.pop_next(can)
            if req is None:
                return worked
            if req.total_tokens > self.geom.max_len:
                self.scheduler.count_rejected()
                self.scheduler.fail(req, AdmissionError(
                    f"request {req.rid} needs {req.total_tokens} tokens "
                    f"> slot capacity {self.geom.max_len}"
                ))
                continue
            # validate sampling params HERE so a poisoned request fails
            # its own future instead of raising in the step-loop thread
            try:
                req.sampling.validate()
                int(req.sampling.seed)
            except Exception as exc:  # noqa: BLE001 — poisoned objects
                err = exc if isinstance(exc, AdmissionError) else (
                    AdmissionError(
                        f"request {req.rid} has invalid sampling "
                        f"params: {exc}"
                    )
                )
                self.scheduler.count_poisoned()
                self.scheduler.fail(req, err)
                continue
            # reserve the FULL prompt+generation footprint up front so a
            # decoding slot can never deadlock waiting for pages
            self.alloc.admit(idx, req.total_tokens)
            self.slots[idx] = _Slot(
                req=req, phase="prefill",
                prompt=np.asarray(req.prompt, np.int32),
            )
            self.scheduler.record_admitted(req)
            tr = get_tracer()
            if tr.enabled:
                tr.instant(
                    "serving.admit", rid=req.rid,
                    replica=self.scheduler.replica, slot=idx,
                    re_admits=req.re_admits,
                )
            worked = True

    def _prefill_one(self) -> bool:
        for i, s in enumerate(self.slots):
            if s is None or s.phase != "prefill":
                continue
            self._prefill_slot(i, s)
            return True
        return False

    def _prefill_slot(self, i: int, s: _Slot) -> None:
        """Advance one slot by one prefill chunk; the last chunk draws
        the first generated token at the last valid position."""
        p = len(s.prompt)
        clen = min(self.prefill_chunk, p - s.n_prefilled)
        chunk = np.zeros(self.prefill_chunk, np.int32)
        chunk[:clen] = s.prompt[s.n_prefilled:s.n_prefilled + clen]
        tables = self._device_tables()[i:i + 1]
        tr = get_tracer()
        sp = None
        if tr.enabled:
            sp = tr.begin(
                "serving.prefill_chunk", rid=s.req.rid,
                replica=self.scheduler.replica, slot=i,
                start=s.n_prefilled, tokens=clen,
            )
        t0 = time.monotonic()
        logits, _ = self.model.prefill_chunk_paged(
            self._tensor(chunk[None], torch.int64), self.pools, tables,
            self._tensor([s.n_prefilled], torch.int32),
            self._tensor([clen], torch.int32),
            max_pages=self._pages_bucket(),
        )
        tok0 = self._draw(logits[:, clen - 1], [i], [s.n_prefilled + clen])
        self._step_time += time.monotonic() - t0
        if sp is not None:
            sp.end()
        s.n_prefilled += clen
        self._prefill_tokens += clen
        self._prefill_chunks += 1
        if s.n_prefilled < p:
            return
        s.generated = [int(tok0[0])]
        self.scheduler.record_first_token(s.req)
        self._tokens += 1
        s.phase = "decode"
        if tr.enabled:
            # the long occupancy span: first token → finish
            s.span = tr.begin(
                "serving.decode", rid=s.req.rid,
                replica=self.scheduler.replica, slot=i,
            )

    def _decode_batch(self) -> bool:
        # a slot can complete within the step that finishes its prefill
        # (max_new=1, or EOS on the prefill token): it must not decode
        # an extra token before the next _finish_and_evict sees it
        live = [
            i for i, s in enumerate(self.slots)
            if s is not None and s.phase == "decode"
            and not self._slot_done(s)
        ]
        if not live:
            return False
        tokens = np.zeros(self.n_slots, np.int64)
        pos = np.zeros(self.n_slots, np.int32)
        valid = np.zeros(self.n_slots, bool)
        for i in live:
            s = self.slots[i]
            tokens[i] = s.generated[-1]
            pos[i] = len(s.prompt) + len(s.generated) - 1
            valid[i] = True
        t0 = time.monotonic()
        logits, _ = self.model.decode_step_paged(
            self._tensor(tokens, torch.int64), self.pools,
            self._device_tables(), self._tensor(pos, torch.int32),
            self._tensor(valid, torch.bool),
            max_pages=self._pages_bucket(),
        )
        tok = self._draw(logits, range(self.n_slots), pos + 1)
        self._step_time += time.monotonic() - t0
        for i in live:
            self.slots[i].generated.append(int(tok[i]))
            self._tokens += 1
        return True
