"""Radix prefix index over committed KV pages (SGLang-style).

Port of ``dlrover_tpu/serving/prefix.py``, line for line: the module
holds no JAX, but the port imports nothing of the JAX package, so it
keeps its own copy.

Host-side companion to the refcounted ``PageAllocator``: a trie keyed on
token-id runs of ``page_size`` granularity. When a prefill chunk commits
a FULL page of pure prompt tokens, the engine interns that page here;
at admission the engine looks an incoming prompt up and — on a hit —
maps the matched physical pages straight into the new slot's block-table
row via ``admit_shared`` (zero prefill compute for matched pages).

Invariants:

- every node indexes exactly one live physical page (rc ≥ 1 in the
  allocator) whose pool payload is the committed KV of the node's
  root-to-node token path;
- keep-first on collision: a second slot committing the same token run
  descends through the existing holder's node, it never replaces it;
- ``drop_pages`` is wired to ``PageAllocator.on_free`` so a page whose
  refcount hits zero leaves the index atomically with its free-list
  return — a recycled page can never be offered as a prefix hit.

The planner (``plan_admission``) turns a raw trie match into the
admission recipe: which pages to map read-only, which single tail page
to copy-on-write, and where chunked prefill resumes. The resume point is
floored to a ``prefill_chunk`` multiple (chunk starts must stay aligned
— the engine's chunk slices assume aligned starts) and capped at
``prompt_len - 1`` so the final prompt token is always recomputed for
the first-token logits. Pages the plan keeps shared lie entirely below
the resume point, so prefill and decode never write into them; the COW
page's committed rows below ``matched_tokens`` are rewritten with
bitwise-identical values (chunked prefill is deterministic and the int8
row codec is row-local), which is what makes a prefix-hit stream
bitwise-equal to the cold stream.
"""

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

__all__ = [
    "PrefixMatch",
    "AdmissionPlan",
    "PrefixIndex",
    "plan_admission",
]


class PrefixMatch(NamedTuple):
    """Raw trie lookup result: ``pages[j]`` is the physical page whose
    committed KV covers prompt tokens ``[j*ps, (j+1)*ps)``; ``tail_page``
    (if any) matches only its first ``tail_tokens`` tokens."""

    pages: Tuple[int, ...]
    tail_page: Optional[int]
    tail_tokens: int

    def matched_tokens(self, page_size: int) -> int:
        return len(self.pages) * page_size + self.tail_tokens


class AdmissionPlan(NamedTuple):
    """Admission recipe derived from a match (see ``plan_admission``)."""

    shared: Tuple[int, ...]       # phys pages mapped read-only, logical 0..
    cow: Tuple[Tuple[int, int], ...]  # (logical, src_phys) to duplicate
    resume: int                   # first prompt position prefill recomputes
    matched_tokens: int           # raw trie match length (tokens)

    @property
    def prefix_pages(self) -> Tuple[int, ...]:
        """Contiguous logical run handed to ``admit_shared``: the shared
        pages followed by the COW sources (COW'd immediately after)."""
        return self.shared + tuple(src for _, src in self.cow)


class _Node:
    __slots__ = ("children", "page", "parent", "key")

    def __init__(self, parent=None, key=None, page=None):
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.key = key
        self.page = page


class PrefixIndex:
    """The radix/trie index. Mutated only on the engine thread (or under
    ``GenerationServer.paused()``) — same serialization contract as the
    allocator it mirrors."""

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self._root = _Node()
        self._by_page: Dict[int, _Node] = {}
        self.interned_total = 0
        self.dropped_total = 0

    def __len__(self) -> int:
        return len(self._by_page)

    @property
    def n_pages(self) -> int:
        """Live physical pages currently indexed."""
        return len(self._by_page)

    def stats(self) -> Dict[str, int]:
        return {
            "pages": len(self._by_page),
            "interned_total": self.interned_total,
            "dropped_total": self.dropped_total,
        }

    # ---- mutation --------------------------------------------------------

    def intern(self, tokens: Sequence[int], n_pages: int, phys_row) -> int:
        """Index the first ``n_pages`` FULL pages of ``tokens``;
        ``phys_row[j]`` is the physical page holding logical page ``j``.
        Existing nodes win (keep-first) — the walk descends through them
        without touching their page binding. Returns nodes created."""
        ps = self.page_size
        node = self._root
        created = 0
        for j in range(n_pages):
            key = tuple(int(t) for t in tokens[j * ps:(j + 1) * ps])
            child = node.children.get(key)
            if child is None:
                p = int(phys_row[j])
                if p in self._by_page:
                    # a live page is indexed at most once; a duplicate
                    # here means the caller handed a stale row — stop
                    # rather than corrupt the reverse map
                    break
                child = _Node(parent=node, key=key, page=p)
                node.children[key] = child
                self._by_page[p] = child
                created += 1
            node = child
        self.interned_total += created
        return created

    def drop_pages(self, pages: Sequence[int]) -> int:
        """Remove freed pages from the index (``PageAllocator.on_free``).
        A dropped node takes its whole subtree out of the index: deeper
        prefixes are only reachable through it, so orphaning them would
        leak unreachable entries. Returns entries removed."""
        removed = 0
        for p in pages:
            node = self._by_page.pop(int(p), None)
            if node is None:
                continue
            removed += 1
            if node.parent is not None:
                node.parent.children.pop(node.key, None)
                node.parent = None
            stack = list(node.children.values())
            node.children = {}
            while stack:
                sub = stack.pop()
                self._by_page.pop(sub.page, None)
                removed += 1
                stack.extend(sub.children.values())
                sub.children = {}
        self.dropped_total += removed
        return removed

    # ---- lookup ----------------------------------------------------------

    def lookup(self, tokens: Sequence[int]) -> PrefixMatch:
        """Longest committed prefix of ``tokens``: full-page walk, then
        the best partial match among the next node's children (the
        longest common prefix of the remaining tokens with any child
        key — that child's page is the COW-able tail)."""
        ps = self.page_size
        toks = [int(t) for t in tokens]
        node = self._root
        pages: List[int] = []
        j = 0
        while (j + 1) * ps <= len(toks):
            child = node.children.get(tuple(toks[j * ps:(j + 1) * ps]))
            if child is None:
                break
            pages.append(child.page)
            node = child
            j += 1
        rest = toks[j * ps:(j + 1) * ps]
        tail_page, tail_tokens = None, 0
        if rest:
            for key, child in node.children.items():
                n = 0
                for a, b in zip(rest, key):
                    if a != b:
                        break
                    n += 1
                if n > tail_tokens:
                    tail_tokens, tail_page = n, child.page
        return PrefixMatch(tuple(pages), tail_page, tail_tokens)


def plan_admission(
    match: PrefixMatch,
    prompt_len: int,
    page_size: int,
    prefill_chunk: int,
) -> Optional[AdmissionPlan]:
    """Turn a trie match into the admission recipe, or None on a miss.

    ``resume`` — the first prompt position chunked prefill recomputes —
    is ``matched_tokens`` floored to a ``prefill_chunk`` multiple and
    capped at ``prompt_len - 1`` (the last prompt token always re-runs
    so the first generated token's logits exist). Matched pages then
    split three ways by their span against ``resume``:

    - entirely below ``resume`` → mapped shared, read-only (rc+1);
    - straddling ``resume`` → at most ONE page: mapped then COW'd, its
      rows in ``[page_start, resume)`` survive the copy and the rest are
      deterministically rewritten by the resumed prefill;
    - at or above ``resume`` → discarded (prefill rewrites them whole,
      a copy would be pure waste).
    """
    matched = min(match.matched_tokens(page_size), prompt_len)
    resume = min(matched, prompt_len - 1)
    resume -= resume % prefill_chunk
    if resume <= 0:
        return None
    all_pages = list(match.pages)
    if match.tail_page is not None:
        all_pages.append(match.tail_page)
    n_keep = resume // page_size
    shared = tuple(all_pages[:n_keep])
    cow: Tuple[Tuple[int, int], ...] = ()
    if resume % page_size and n_keep < len(all_pages):
        cow = ((n_keep, all_pages[n_keep]),)
    if not shared and not cow:
        return None
    return AdmissionPlan(shared, cow, resume, matched)


def affinity_ok(
    plan: Optional[AdmissionPlan], prompt_len: int, max_suffix: int
) -> bool:
    """Whether a prefix hit is strong enough for a decode-role replica
    to admit the request directly — the shared pages are already
    resident, so only the divergent suffix (``prompt_len - resume``
    tokens) needs local prefill, and that must stay under
    ``max_suffix`` or the decode fleet re-inherits the chunked-prefill
    interference the prefill/decode split exists to remove."""
    return (
        plan is not None
        and plan.resume > 0
        and prompt_len - plan.resume <= max_suffix
    )
