"""Continuous-batching decode engine over the paged KV cache.

Port of ``dlrover_tpu/serving/engine.py``'s ``ServingEngine`` in its
unified role, paged mode, with speculative decoding and prefix sharing.
Orca/vLLM-style iteration-level scheduling on a FIXED decode batch of
``n_slots`` lanes: requests are admitted into free slots and evicted
at step boundaries, and every decode runs the full batch with a
per-lane ``valid`` mask. Each step is:

1. finish: resolve slots that hit ``max_new_tokens``/EOS, free pages;
2. admit: pop queued requests into free slots (head-of-line admission —
   the scheduler's top request waits for pages rather than being
   jumped), reserving the full prompt + generation footprint;
3. prefill one chunk: ONE slot advances its prompt by ``prefill_chunk``
   tokens (chunked prefill interleaves long prompts with decode);
4. decode: one token for every decoding slot in a single batched step —
   or, with speculative decoding on (``spec_k > 0``), one VERIFY chunk
   that can commit up to ``spec_k + 1`` tokens per slot.

The steps are ``Decoder.prefill_chunk_paged`` / ``decode_step_paged`` /
``verify_chunk_paged``: K/V rows commit straight to their page cells
and attention walks the block table through the paged-attention
kernel. The page walk is bounded by a power-of-two bucket of the most
pages any slot holds. The block tables are re-shipped to the device
only when the allocator reports a mutation.

Sampling (``models/generate.py``): greedy is argmax; a sampled token is
a Gumbel-max draw keyed on (request seed, absolute position of the
token drawn), so a stream is stable across admission order, batch
composition and speculation.

Speculative decoding (``spec_k``, prompt-lookup drafts by default):
each decoding slot proposes up to ``spec_k`` continuation tokens from
an n-gram suffix match over its own history (``DraftModel`` takes any
other proposer), and one verify step scores ``[last token, drafts...]``
against the paged cache with DEFERRED K/V writes: the verify variant of
the paged kernel folds the chunk's own rows as in-flight keys. A draft
survives iff it EQUALS the target draw of the row before it (each
target drawn exactly as the sequential sampler would draw it at that
position), and the first mismatch emits the target draw itself, so the
emitted stream is the spec-off stream. Only the accepted prefix of
chunk K/V rows is committed; rejected draft rows never reach the pools.

Prefix sharing (``prefix_sharing=True``): committed prompt pages are
interned into a radix index (``serving/prefix.py``) as chunked prefill
fills them, and admission consults the index. On a hit the new slot's
block-table prefix maps the SAME physical pages (refcounted in the
allocator), prefill resumes at the first divergent chunk boundary, and
a partially matched tail page is copied (copy-on-write) before the slot
writes into it. ``admission_lookahead`` lets the scheduler admit a
later request whose prefix-discounted footprint fits past a cold
head-of-line request that is blocked on pages.

The pools are updated in place by each step (the JAX engine donates
them to its jitted steps instead).
"""

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models.generate import draw_token
from dlrover_tpu_torch.observability.tracing import get_tracer
from dlrover_tpu_torch.ops.paged_attention import write_page_rows
from dlrover_tpu_torch.serving import kv_cache as kvc
from dlrover_tpu_torch.serving import prefix as prefix_mod
from dlrover_tpu_torch.serving.scheduler import (
    AdmissionError,
    Request,
    Scheduler,
)


class DraftModel:
    """Draft-token proposer hook for speculative decoding.

    ``propose(history, k)`` returns up to ``k`` candidate continuation
    tokens for a slot whose committed stream is ``history`` (prompt +
    generated so far). Runs on the host between steps; returning ``[]``
    makes the slot take a plain decode for that step. Acceptance is the
    engine's, so a proposer can be arbitrarily wrong without changing
    the output — only the accept rate."""

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        raise NotImplementedError


class PromptLookupDraft(DraftModel):
    """Prompt-lookup (n-gram) drafting — no second model.

    Finds the most recent EARLIER occurrence of the history's trailing
    n-gram (longest first, ``max_ngram`` down to ``min_ngram``) and
    proposes the tokens that followed it."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError("need max_ngram >= min_ngram >= 1")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        hist = [int(t) for t in history]
        if k <= 0 or len(hist) < 2:
            return []
        top = min(self.max_ngram, len(hist) - 1)
        for n in range(top, self.min_ngram - 1, -1):
            pat = hist[-n:]
            for i in range(len(hist) - n - 1, -1, -1):
                if hist[i:i + n] == pat:
                    # i + n <= len-1, so there is always >= 1 token here
                    return hist[i + n:i + n + k]
        return []


def accept_and_emit(logits, tokens, start, valid, n_draft,
                    seeds, temp, top_k, top_p):
    """Gumbel-coupled rejection sampling over a verify chunk.

    ``logits`` ``[B, C, V]``: row j predicts position ``start + j + 1``,
    and its target token is drawn there exactly as the sequential
    sampler would draw it. Draft ``tokens[:, j]`` (j ≥ 1) survives iff
    it EQUALS row j-1's target, acceptance stops at the first mismatch,
    and the mismatching position emits its target. Returns (targets
    ``[B, C]`` int32, n_emit ``[B]`` = accepted + 1, commit mask
    ``[B, C]`` covering rows 0..n_accepted of valid lanes)."""
    b, c = tokens.shape
    dev = logits.device
    ar = torch.arange(c, device=dev)
    positions = start.to(torch.int64)[:, None] + ar[None, :]

    def rows(x):
        return x.repeat_interleave(c)

    tgt = draw_token(
        logits.reshape(b * c, -1), rows(seeds), (positions + 1).reshape(-1),
        rows(temp), rows(top_k), rows(top_p),
    ).reshape(b, c)
    drafts = tokens[:, 1:]
    draft_ok = ar[None, :c - 1] < n_draft[:, None]
    match = (drafts == tgt[:, :-1]) & draft_ok
    n_acc = torch.cumprod(match.to(torch.int32), dim=1).sum(1)
    commit = (ar[None, :] <= n_acc[:, None]) & valid[:, None]
    return tgt, n_acc + 1, commit


@dataclass
class _Slot:
    """Host-side state of one decode lane."""

    req: Request
    phase: str                  # "prefill" | "decode"
    prompt: np.ndarray          # int32 [P]
    n_prefilled: int = 0
    generated: List[int] = field(default_factory=list)
    span: object = None         # open "serving.decode" trace span, if any
    interned_pages: int = 0     # full prompt pages already in the index


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to dlrover_tpu_torch yet (ROADMAP {item})"
    )


class ServingEngine:
    """Single-replica continuous-batching engine (host loop + 3 steps)."""

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
        draft: Optional[DraftModel] = None,
        prefix_sharing: bool = False,
        admission_lookahead: int = 0,
        role: str = "unified",
        device="cuda",
    ):
        if role != "unified":
            raise _not_ported(f"role={role!r} (disaggregated serving)",
                              "A15")
        if not paged:
            raise _not_ported("the gather (paged=False) engine", "A15")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.scheduler = scheduler
        self.n_slots = n_slots
        self.prefill_chunk = prefill_chunk
        self.role = role
        self.spec_k = int(spec_k)
        self.draft = draft if draft is not None else PromptLookupDraft()
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
        self.prefix_sharing = bool(prefix_sharing)
        self.admission_lookahead = int(admission_lookahead)
        self.trie: Optional[prefix_mod.PrefixIndex] = None
        if self.prefix_sharing:
            self.trie = prefix_mod.PrefixIndex(page_size)
            # pages whose refcount hits zero leave the index together
            # with their return to the free list
            self.alloc.on_free = self.trie.drop_pages
        self.slots: List[Optional[_Slot]] = [None] * n_slots
        self.draining = False     # planned drain: stop admitting new work
        self._tokens = 0
        self._t0: Optional[float] = None
        self._tables_dev = None   # cached device block tables
        self._table_ships = 0     # host→device table transfers
        self._step_time = 0.0     # wall seconds inside model steps
        self._draft_tokens = 0    # drafts proposed to the verify step
        self._accepted_tokens = 0  # drafts that survived acceptance
        self._verify_steps = 0    # verify steps run (not decode fallbacks)
        self._verify_tokens = 0   # tokens those verify steps emitted
        self._prefill_tokens = 0  # prompt tokens run through the chunk step
        self._prefill_chunks = 0  # chunk-step invocations
        self._prefix_hits = 0     # admissions that mapped shared pages
        self._prefix_misses = 0   # sharing-on admissions with no usable hit
        self._prefill_tokens_saved = 0  # prompt tokens skipped via hits
        self._cow_pages = 0       # tail pages copy-on-write duplicated
        self._peak_dedup = 1.0    # peak slot cells / unique pages

    # ---- queries ---------------------------------------------------------

    @property
    def max_len(self) -> int:
        """Longest prompt+generation one slot can hold."""
        return self.geom.max_len

    def active_slots(self) -> int:
        return sum(s is not None for s in self.slots)

    def stats(self) -> dict:
        dt = time.monotonic() - self._t0 if self._t0 else 0.0
        looked_up = self._prefix_hits + self._prefix_misses
        return {
            "active_slots": self.active_slots(),
            "free_pages": self.alloc.free_pages,
            "tokens_generated": self._tokens,
            "tokens_per_s": self._tokens / dt if dt > 0 else 0.0,
            "decode_kernel": "paged",
            "table_ships": self._table_ships,
            "step_time_s": self._step_time,
            "host_time_s": max(0.0, dt - self._step_time),
            "spec_k": self.spec_k,
            "draft_tokens": self._draft_tokens,
            "accepted_tokens": self._accepted_tokens,
            "spec_accept_rate": (
                self._accepted_tokens / self._draft_tokens
                if self._draft_tokens else 0.0
            ),
            "verify_steps": self._verify_steps,
            "verify_tokens": self._verify_tokens,
            "prefill_tokens": self._prefill_tokens,
            "prefill_chunks": self._prefill_chunks,
            "role": self.role,
            # prefix sharing: hit rate over sharing-on admissions, prompt
            # tokens whose prefill was skipped, COW duplications, live
            # index size, and the dedup ratio (slot cells per unique
            # physical page — 1.0 means nothing is shared)
            "prefix_hit_rate": (
                self._prefix_hits / looked_up if looked_up else 0.0
            ),
            "prefix_hits": self._prefix_hits,
            "prefix_misses": self._prefix_misses,
            "prefill_tokens_saved": self._prefill_tokens_saved,
            "cow_pages": self._cow_pages,
            "trie_pages": self.trie.n_pages if self.trie is not None else 0,
            "dedup_ratio": self.dedup_ratio(),
            "peak_dedup_ratio": self._peak_dedup,
        }

    def dedup_ratio(self) -> float:
        """Slot cells / unique assigned pages — how many logical pages
        each resident physical page serves."""
        unique = self.alloc.unique_assigned_pages
        if not unique:
            return 1.0
        cells = sum(self.alloc.slot_pages(i) for i in range(self.n_slots))
        return cells / unique

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
        if self.spec_k:
            worked = self._spec_batch() or worked
        else:
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

    def _prefix_plan(self, req) -> Optional[prefix_mod.AdmissionPlan]:
        """The admission recipe for ``req`` under prefix sharing: which
        committed pages its prompt can map, where prefill resumes. None
        when sharing is off or the index has no usable match."""
        if self.trie is None:
            return None
        match = self.trie.lookup(req.prompt)
        if not match.pages and not match.tail_tokens:
            return None
        return prefix_mod.plan_admission(
            match, len(req.prompt), self.geom.page_size, self.prefill_chunk
        )

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
                # hit-aware footprint: shared prefix pages are mapped,
                # not drawn from the free list (COW pages get no discount)
                plan = self._prefix_plan(req)
                n_shared = len(plan.shared) if plan else 0
                return self.alloc.can_admit(req.total_tokens, n_shared)

            req = self.scheduler.pop_next(
                can, lookahead=self.admission_lookahead
            )
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
            # decoding slot can never deadlock waiting for pages; on a
            # prefix hit the matched prefix maps existing pages, and
            # prefill resumes at the plan's chunk-aligned resume point
            plan = self._prefix_plan(req)
            resume = 0
            if plan is not None:
                self.alloc.admit_shared(idx, req.total_tokens,
                                        plan.prefix_pages)
                for logical, _src in plan.cow:
                    pair = self.alloc.cow_page(idx, logical)
                    if pair is not None:
                        self._copy_page(*pair)
                        self._cow_pages += 1
                resume = plan.resume
                self._prefix_hits += 1
                self._prefill_tokens_saved += resume
            else:
                self.alloc.admit(idx, req.total_tokens)
                if self.prefix_sharing:
                    self._prefix_misses += 1
            self._peak_dedup = max(self._peak_dedup, self.dedup_ratio())
            self.slots[idx] = _Slot(
                req=req, phase="prefill",
                prompt=np.asarray(req.prompt, np.int32),
                n_prefilled=resume,
                interned_pages=len(plan.shared) if plan else 0,
            )
            self.scheduler.record_admitted(req)
            tr = get_tracer()
            if tr.enabled:
                tr.instant(
                    "serving.admit", rid=req.rid,
                    replica=self.scheduler.replica, slot=idx,
                    re_admits=req.re_admits, prefix_resume=resume,
                )
            worked = True

    # ---- prefix sharing helpers ------------------------------------------

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy one physical page's payload across every pool tensor, in
        place — the device half of a COW duplication (all layers)."""
        for v in self.pools.values():
            v[:, dst].copy_(v[:, src])

    def _intern_full_pages(self, i: int, s: _Slot) -> None:
        """Index the slot's newly COMMITTED full prompt pages. Only pages
        that are pure prompt — ``(j+1)*page_size <= len(prompt)`` — and
        fully prefilled are eligible: a page carrying generated tokens
        (or an uncommitted tail) is not a reusable prefix."""
        if self.trie is None:
            return
        full = min(int(s.n_prefilled), len(s.prompt)) // self.geom.page_size
        if full <= s.interned_pages:
            return
        self.trie.intern(s.prompt, full, self.alloc.block_tables()[i])
        s.interned_pages = full

    # ---- model steps -----------------------------------------------------

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
        self._intern_full_pages(i, s)
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

    def _live(self) -> List[int]:
        # a slot can complete within the step that finishes its prefill
        # (max_new=1, or EOS on the prefill token): it must not decode
        # an extra token before the next _finish_and_evict sees it
        return [
            i for i, s in enumerate(self.slots)
            if s is not None and s.phase == "decode"
            and not self._slot_done(s)
        ]

    def _decode_batch(self) -> bool:
        live = self._live()
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

    def _spec_batch(self) -> bool:
        """Speculative variant of ``_decode_batch``: every decoding slot
        contributes a verify chunk ``[last token, drafts..., pad]`` and
        the verify step commits 1..spec_k+1 tokens per slot. Falls back
        to plain decode on steps where NO slot has a draft."""
        live = self._live()
        if not live:
            return False
        c = self.spec_k + 1
        tokens = np.zeros((self.n_slots, c), np.int64)
        start = np.zeros(self.n_slots, np.int32)
        valid = np.zeros(self.n_slots, bool)
        n_draft = np.zeros(self.n_slots, np.int32)
        for i in live:
            s = self.slots[i]
            # never draft past the request's budget: the LAST emitted
            # token must be the one that hits max_new_tokens, so drafts
            # beyond remaining-1 could commit K/V rows the allocator
            # never reserved
            remaining = s.req.max_new_tokens - len(s.generated)
            k_eff = max(0, min(self.spec_k, remaining - 1))
            drafts = list(
                self.draft.propose(list(s.prompt) + s.generated, k_eff)
            )[:k_eff]
            tokens[i, 0] = s.generated[-1]
            tokens[i, 1:1 + len(drafts)] = drafts
            start[i] = len(s.prompt) + len(s.generated) - 1
            valid[i] = True
            n_draft[i] = len(drafts)
        if not n_draft.any():
            return self._decode_batch()
        tr = get_tracer()
        sp = None
        if tr.enabled:
            sp = tr.begin(
                "serving.spec_verify", replica=self.scheduler.replica,
                n_live=len(live), drafts=int(n_draft.sum()),
                rids=",".join(self.slots[i].req.rid for i in live),
            )
        t0 = time.monotonic()
        tables = self._device_tables()
        tok_t = self._tensor(tokens, torch.int64)
        start_t = self._tensor(start, torch.int32)
        valid_t = self._tensor(valid, torch.bool)
        logits, ck, cv = self.model.verify_chunk_paged(
            tok_t, self.pools, tables, start_t,
            max_pages=self._pages_bucket(),
        )
        tgt, n_emit, commit = accept_and_emit(
            logits, tok_t, start_t, valid_t,
            self._tensor(n_draft, torch.int32),
            *self._sampling_arrays(range(self.n_slots)),
        )
        # commit ONLY the accepted rows 0..n_acc; rejected draft rows
        # never reach the pools
        positions = start_t[:, None] + torch.arange(
            c, dtype=torch.int32, device=self.device)[None, :]
        for layer in range(ck.shape[0]):
            write_page_rows(kvc.layer_pools(self.pools, layer), tables,
                            positions, commit, ck[layer], cv[layer])
        tgt = tgt.cpu().numpy()
        n_emit = n_emit.cpu().numpy()
        self._step_time += time.monotonic() - t0
        if sp is not None:
            sp.end(emitted=int(n_emit[live].sum()))
        self._verify_steps += 1
        for i in live:
            s = self.slots[i]
            n = int(n_emit[i])
            self._draft_tokens += int(n_draft[i])
            self._accepted_tokens += n - 1
            for j in range(n):
                s.generated.append(int(tgt[i, j]))
                self._tokens += 1
                self._verify_tokens += 1
                if self._slot_done(s):
                    break
        return True
