"""Paged KV cache — block-pooled pages so memory scales with live tokens.

Counterpart of ``apex_tpu/serve/cache.py``:

- **device side** — one pool per layer, stacked: ``k``/``v`` tensors of
  shape ``(L, P, H, page, D)`` (heads outside the page dim, the layout
  the paged decode kernel reads with no transposes).  With
  ``kv_wire="int8"`` they hold the blockwise int8 codes of
  :mod:`apex_tpu_torch.parallel.comm` at ``block = D`` beside f32 scale
  planes ``k_scale``/``v_scale`` ``(L, P, H, page)``, one scale per
  (head, token) row (:func:`encode_kv`);
- **host side** — :class:`PagePool`, a refcounted free-list allocator.
  Page 0 is the reserved **null page**: page-table entries past a
  sequence's live count point at it, padded prefill tails and idle
  decode slots write into it, and the ``lengths`` masking guarantees it
  is never read;
- **prefix cache** — :class:`PrefixCache` maps chained hashes of
  page-sized prompt prefixes (:func:`prefix_keys`) to committed pages,
  which later prompts with the same prefix borrow (refcounts) instead of
  prefilling again.

The JAX helpers are pure functions whose updates land in place through
buffer donation; here the write helpers update the pool tensors in
place (advanced-index assignment, i.e. ``index_put_``) and return them,
so the pool never moves: a captured decode graph reads it at fixed
addresses.
"""

from __future__ import annotations

import hashlib
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.ops._dispatch import resolve_device
from apex_tpu_torch.parallel import comm

__all__ = [
    "NULL_PAGE",
    "PagePool",
    "PrefixCache",
    "prefix_keys",
    "init_kv_pages",
    "encode_kv",
    "pack_prompt_pages",
    "write_prompt_pages",
    "append_token_kv",
]

#: page 0 — never allocated; the write-only garbage target for padded
#: tails and idle slots
NULL_PAGE = 0


class PagePool:
    """Host-side free-list allocator over ``num_pages`` device pages.

    Page 0 (:data:`NULL_PAGE`) is reserved, so ``num_pages - 1`` pages
    are usable.  ``alloc`` is all-or-nothing.  Pages are refcounted:
    ``alloc`` hands a page out at refcount 1, :meth:`share` adds a
    reference (a prefix-cache borrow, or the cache's own hold on a
    committed page), and :meth:`free` releases one reference; a page
    returns to the free list at refcount 0, so every free path is safe
    for shared pages.  Each allocated page carries a namespace tag
    (``"kv"`` by default; a speculative engine's draft pages would be
    ``"draft"``), which :meth:`leak_check` screens the prefix cache
    against.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is reserved)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO free list: recently freed pages are re-used first
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        #: allocated page -> reference count (absent = free)
        self._refs: Dict[int, int] = {}
        #: allocated page -> namespace tag (absent = free)
        self._ns: Dict[int, str] = {}

    @property
    def usable(self) -> int:
        return self.num_pages - 1

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.usable - self.available

    def occupancy(self) -> float:
        """Live fraction of the usable pool (0..1)."""
        return self.in_use / self.usable

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` KV positions."""
        return -(-max(tokens, 0) // self.page_size)

    def alloc(self, n: int, ns: str = "kv") -> Optional[List[int]]:
        """``n`` pages tagged ``ns``, or None when the pool cannot cover
        all of them (all-or-nothing; never hands out :data:`NULL_PAGE`)."""
        if n < 0:
            raise ValueError("cannot allocate a negative page count")
        if n > len(self._free):
            return None
        taken = [self._free.pop() for _ in range(n)]
        for p in taken:
            self._refs[p] = 1
            self._ns[p] = ns
        return taken

    def namespace(self, page: int) -> Optional[str]:
        """The namespace tag of an allocated page (None = free)."""
        return self._ns.get(page)

    def share(self, pages: List[int]) -> None:
        """Add one reference per page; sharing a page that is not
        allocated raises."""
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"cannot share unallocated page {p}")
        for p in pages:
            self._refs[p] += 1

    def refcount(self, page: int) -> int:
        """Current reference count of ``page`` (0 = free)."""
        return self._refs.get(page, 0)

    def free(self, pages: List[int]) -> None:
        """Release one reference per page; a page returns to the free
        list at refcount 0."""
        for p in pages:
            if not 0 < p < self.num_pages:
                raise ValueError(f"page {p} is not an allocatable page id")
            if p not in self._refs:
                raise ValueError(f"double free of page {p}")
        for p in pages:
            r = self._refs[p] - 1
            if r:
                self._refs[p] = r
            else:
                del self._refs[p]
                self._ns.pop(p, None)
                self._free.append(p)

    def leak_check(self, owned, cached=()) -> None:
        """Assert the pool's accounting is exact: every allocated page's
        refcount equals the number of holders claiming it, and every
        claimed page is allocated.  ``owned`` is an iterable of
        per-request page lists, ``cached`` the prefix cache's pages (one
        reference each; :meth:`PrefixCache.cached_pages`).  Raises
        ``ValueError`` naming the double-owned, leaked and foreign pages,
        and any page outside the ``"kv"`` namespace in the cache."""
        want: Counter = Counter()
        for pages in owned:
            want.update(pages)
        want.update(cached)
        problems = []
        over = sorted(p for p, c in want.items()
                      if c > self._refs.get(p, 0) and p in self._refs)
        if over:
            problems.append(f"pages owned by more than one request "
                            f"without a shared reference: {over}")
        leaked = sorted(p for p, r in self._refs.items() if r > want[p])
        if leaked:
            problems.append(
                f"leaked pages (allocated references owned by no live "
                f"request or cache entry): {leaked}"
            )
        foreign = sorted(set(want) - set(self._refs))
        if foreign:
            problems.append(
                f"foreign pages (owned but not allocated): {foreign}"
            )
        draft_cached = sorted(
            p for p in cached if self._ns.get(p, "kv") != "kv"
        )
        if draft_cached:
            problems.append(
                f"draft-namespace pages shared into the prefix cache: "
                f"{draft_cached}"
            )
        if problems:
            raise ValueError(
                "PagePool leak check failed: " + "; ".join(problems)
            )


# ---------------------------------------------------------------------------
# cross-request prefix cache: content hash -> committed KV page run
# ---------------------------------------------------------------------------


def prefix_keys(prompt, page_size: int) -> List[Tuple[bytes, int]]:
    """Chained page-granularity content keys of a prompt:
    ``key_i = blake2b(key_{i-1} || int32 bytes of page i's tokens)``, 16
    bytes, from the seed ``b"apex-prefix-v1"`` — byte for byte the
    reference's keys.  A key commits to every token before it; the final
    partial page gets a key too, so only a whole-prompt hit reuses a
    partial tail page.  Returns ``[(key, tokens_through_here), ...]``."""
    out: List[Tuple[bytes, int]] = []
    key = b"apex-prefix-v1"
    for start in range(0, len(prompt), page_size):
        block = np.asarray(prompt[start:start + page_size], np.int32)
        key = hashlib.blake2b(key + block.tobytes(), digest_size=16).digest()
        out.append((key, start + len(block)))
    return out


class _CacheEntry:
    __slots__ = ("key", "page", "tokens", "parent", "children", "tick")

    def __init__(self, key, page, tokens, parent, tick):
        self.key = key
        self.page = page          # the committed device page id
        self.tokens = tokens      # prompt tokens through this page
        self.parent = parent      # previous key in the chain (or None)
        self.children = 0         # cached entries chaining through us
        self.tick = tick          # LRU clock

    def __repr__(self):
        return (f"_CacheEntry(page={self.page}, tokens={self.tokens}, "
                f"children={self.children}, tick={self.tick})")


class PrefixCache:
    """Content-addressed map from chained prompt-prefix keys to
    committed KV pages of one :class:`PagePool`.

    - **commit** — after a prompt's prefill, each of its pages is
      published under its chain key with one cache-owned
      :meth:`PagePool.share` reference, so it outlives its request;
    - **match** / **borrow** — a new prompt walks its key chain for the
      longest cached run; :meth:`borrow` adds one reference per page,
      released by the borrower's ordinary ``pool.free``;
    - **copy-on-write** — full shared pages are never written again;
      the scheduler forks a shared partial tail page before its first
      append (``refcount > 1`` at the append page);
    - **eviction** — :meth:`evict` frees least-recently-used entries
      with no borrowers (refcount 1: the cache's own), leaf first along
      the chain.

    Host-side bookkeeping only; page content lives in the engine's pool
    tensors.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.entries: Dict[bytes, _CacheEntry] = {}
        self._tick = 0
        # cumulative ledger
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.evictions = 0
        self.commits = 0

    def __len__(self) -> int:
        return len(self.entries)

    def cached_pages(self) -> List[int]:
        """Pages the cache holds a reference on (the ``cached`` arm of
        :meth:`PagePool.leak_check`)."""
        return [e.page for e in self.entries.values()]

    # -- lookup ------------------------------------------------------------
    def _walk(self, prompt) -> List[_CacheEntry]:
        """Longest cached run from page 0."""
        run: List[_CacheEntry] = []
        for key, _end in prefix_keys(prompt, self.pool.page_size):
            e = self.entries.get(key)
            if e is None:
                break
            run.append(e)
        return run

    def peek_tokens(self, prompt) -> int:
        """Match length in tokens, touching neither the LRU clock nor
        any reference."""
        run = self._walk(prompt)
        return run[-1].tokens if run else 0

    def match(self, prompt) -> Tuple[List[int], int]:
        """``(pages, tokens)`` of the longest cached prefix run
        (LRU-touched), not yet borrowed: call :meth:`borrow` to take
        the references."""
        run = self._walk(prompt)
        self._tick += 1
        if not run:
            self.misses += 1
            return [], 0
        for e in run:
            e.tick = self._tick
        self.hits += 1
        self.hit_tokens += run[-1].tokens
        return [e.page for e in run], run[-1].tokens

    def borrow(self, pages: List[int]) -> None:
        """One reference per matched page for the borrowing request."""
        self.pool.share(pages)

    # -- publication -------------------------------------------------------
    def commit(self, prompt, pages: List[int]) -> int:
        """Publish a prefilled prompt's pages under their chain keys (one
        cache-owned reference each).  A key already cached keeps its
        incumbent page, and the chain stops at the first key whose
        incumbent differs from ours (a child must chain through our
        parent pages).  Returns the number of new entries."""
        self._tick += 1
        added = 0
        parent = None
        for (key, end), page in zip(
            prefix_keys(prompt, self.pool.page_size), pages
        ):
            e = self.entries.get(key)
            if e is not None:
                e.tick = self._tick
                if e.page != page:
                    break
                parent = key
                continue
            self.pool.share([page])
            self.entries[key] = _CacheEntry(key, page, end, parent,
                                            self._tick)
            if parent is not None:
                self.entries[parent].children += 1
            parent = key
            added += 1
        if added:
            self.commits += 1
        return added

    # -- eviction ----------------------------------------------------------
    def _evictable(self) -> List[_CacheEntry]:
        """Leaf entries with no live borrowers, oldest first."""
        return sorted(
            (e for e in self.entries.values()
             if e.children == 0 and self.pool.refcount(e.page) == 1),
            key=lambda e: (e.tick, e.page),
        )

    def _drop(self, e: _CacheEntry) -> None:
        del self.entries[e.key]
        if e.parent is not None and e.parent in self.entries:
            self.entries[e.parent].children -= 1
        self.pool.free([e.page])
        self.evictions += 1

    def evict(self, need: Optional[int] = None) -> int:
        """Free least-recently-used borrower-free cached pages until
        ``need`` pages came back (None = everything evictable).  A parent
        whose last cached child goes becomes a leaf in the same sweep;
        borrowed entries are never evicted.  Returns pages freed."""
        freed = 0
        while need is None or freed < need:
            cands = self._evictable()
            if not cands:
                break
            take = cands if need is None else cands[: need - freed]
            for e in take:
                self._drop(e)
                freed += 1
                if need is not None and freed >= need:
                    break
        return freed

    def flush(self) -> int:
        """Release every cache-owned reference (borrowers keep theirs).
        Returns the entry count released."""
        n = len(self.entries)
        for e in list(self.entries.values()):
            self.pool.free([e.page])
        self.entries.clear()
        self.evictions += n
        return n


# ---------------------------------------------------------------------------
# device-side helpers
# ---------------------------------------------------------------------------


def init_kv_pages(
    num_layers: int,
    num_pages: int,
    num_heads: int,
    page_size: int,
    head_dim: int,
    *,
    dtype=torch.bfloat16,
    device="cuda",
    kv_wire: str = "f32",
) -> dict:
    """Fresh zeroed pool tensors ``{"k", "v"}`` of ``(L, P, H, page,
    D)`` on ``device`` (the card unless the caller asks for the CPU):
    in ``dtype`` under ``kv_wire="f32"``, int8 codes under ``"int8"``
    with ``{"k_scale", "v_scale"}`` ``(L, P, H, page)`` f32 planes of
    ones beside them (two distinct tensors)."""
    if kv_wire not in ("f32", "int8"):
        raise ValueError(f"kv_wire must be 'f32' or 'int8', got {kv_wire!r}")
    device = resolve_device(device)
    shape = (num_layers, num_pages, num_heads, page_size, head_dim)
    store = torch.int8 if kv_wire == "int8" else dtype
    cache = {
        "k": torch.zeros(shape, dtype=store, device=device),
        "v": torch.zeros(shape, dtype=store, device=device),
    }
    if kv_wire == "int8":
        cache["k_scale"] = torch.ones(shape[:-1], dtype=torch.float32,
                                      device=device)
        cache["v_scale"] = torch.ones(shape[:-1], dtype=torch.float32,
                                      device=device)
    return cache


def encode_kv(x: torch.Tensor):
    """Blockwise int8 codes ``(..., D)`` and f32 scales ``(...)`` of KV
    rows ``x (..., D)``: the codec of :mod:`apex_tpu_torch.parallel.comm`
    at ``block = D``, one scale per (head, token) row (an all-zero row
    gets scale 1.0, so the null page stays NaN-free)."""
    d = x.shape[-1]
    codes, scale = comm.quantize_blocks(x.float(), block=d)
    return codes, scale[..., 0]


def pack_prompt_pages(kv: torch.Tensor, page_size: int) -> torch.Tensor:
    """``(S, H, D)`` per-position rows -> ``(NP, H, page, D)`` page
    blocks (``S`` must be a page multiple — prefill buckets are)."""
    s, h, d = kv.shape
    if s % page_size:
        raise ValueError(f"prompt length {s} is not a page multiple")
    return kv.reshape(s // page_size, page_size, h, d).transpose(1, 2)


def write_prompt_pages(pages: torch.Tensor, new: torch.Tensor,
                       page_ids: torch.Tensor) -> torch.Tensor:
    """Scatter layer-stacked page blocks ``new`` ``(L, NP, H, page,
    D[, ...])`` into the pool ``pages`` ``(L, P, H, page, D[, ...])`` at
    ``page_ids`` ``(NP,)``, in place (codes, or scale planes without the
    trailing D).  Entries pointing at the null page dump the
    padded tail there (never read back)."""
    pages[:, page_ids.long()] = new.to(pages.dtype)
    return pages


def append_token_kv(pages: torch.Tensor, rows: torch.Tensor,
                    page_ids: torch.Tensor, slots: torch.Tensor
                    ) -> torch.Tensor:
    """Scatter one token's rows ``(B, H[, D])`` into ``pages`` ``(P, H,
    page[, D])`` at ``(page_ids[b], slots[b])`` per sequence, in place —
    the per-layer decode append (idle slots target the null page)."""
    pages[page_ids.long(), :, slots.long()] = rows.to(pages.dtype)
    return pages
