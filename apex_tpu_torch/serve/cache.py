"""Paged KV cache — block-pooled pages so memory scales with live tokens.

Counterpart of ``apex_tpu/serve/cache.py``:

- **device side** — one pool per layer, stacked: ``k``/``v`` tensors of
  shape ``(L, P, H, page, D)`` (heads outside the page dim, the layout
  the paged decode kernel reads with no transposes);
- **host side** — :class:`PagePool`, a refcounted free-list allocator.
  Page 0 is the reserved **null page**: page-table entries past a
  sequence's live count point at it, padded prefill tails and idle
  decode slots write into it, and the ``lengths`` masking guarantees it
  is never read.

The JAX helpers are pure functions whose updates land in place through
buffer donation; here the write helpers update the pool tensors in
place (advanced-index assignment, i.e. ``index_put_``) and return them.
The int8 KV wire and the prefix cache are not ported yet.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional

import torch

from apex_tpu_torch.ops._dispatch import resolve_device

__all__ = [
    "NULL_PAGE",
    "PagePool",
    "init_kv_pages",
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
    ``alloc`` hands a page out at refcount 1, :meth:`free` releases one
    reference, and a page returns to the free list at refcount 0.  (The
    JAX pool's ``share``, which adds references for the prefix cache,
    comes with the prefix cache.)
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

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` pages, or None when the pool cannot cover all of them
        (all-or-nothing; never hands out :data:`NULL_PAGE`)."""
        if n < 0:
            raise ValueError("cannot allocate a negative page count")
        if n > len(self._free):
            return None
        taken = [self._free.pop() for _ in range(n)]
        for p in taken:
            self._refs[p] = 1
        return taken

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
                self._free.append(p)

    def leak_check(self, owned) -> None:
        """Assert the pool's accounting is exact against the live
        ownership ledger ``owned`` (an iterable of per-request page
        lists): every allocated page's refcount equals the number of
        holders claiming it, and every claimed page is allocated.
        Raises ``ValueError`` naming the pages otherwise."""
        want: Counter = Counter()
        for pages in owned:
            want.update(pages)
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
                f"request): {leaked}"
            )
        foreign = sorted(set(want) - set(self._refs))
        if foreign:
            problems.append(
                f"foreign pages (owned but not allocated): {foreign}"
            )
        if problems:
            raise ValueError(
                "PagePool leak check failed: " + "; ".join(problems)
            )


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
    D)`` in ``dtype`` on ``device`` (the card unless the caller asks for
    the CPU; raises without a GPU, as every entry point does).
    ``kv_wire="f32"`` (the KV cache in the model dtype) is the only wire
    ported so far."""
    if kv_wire != "f32":
        raise NotImplementedError(
            f"kv_wire {kv_wire!r} is not ported yet (only 'f32')"
        )
    device = resolve_device(device)
    shape = (num_layers, num_pages, num_heads, page_size, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def pack_prompt_pages(kv: torch.Tensor, page_size: int) -> torch.Tensor:
    """``(S, H, D)`` per-position rows -> ``(NP, H, page, D)`` page
    blocks (``S`` must be a page multiple — prefill buckets are)."""
    s, h, d = kv.shape
    if s % page_size:
        raise ValueError(f"prompt length {s} is not a page multiple")
    return kv.reshape(s // page_size, page_size, h, d).transpose(1, 2)


def write_prompt_pages(pages: torch.Tensor, new: torch.Tensor,
                       page_ids: torch.Tensor) -> torch.Tensor:
    """Scatter layer-stacked page blocks ``new`` ``(L, NP, H, page, D)``
    into the pool ``pages`` ``(L, P, H, page, D)`` at ``page_ids``
    ``(NP,)``, in place.  Entries pointing at the null page dump the
    padded tail there (never read back)."""
    pages[:, page_ids.long()] = new.to(pages.dtype)
    return pages


def append_token_kv(pages: torch.Tensor, rows: torch.Tensor,
                    page_ids: torch.Tensor, slots: torch.Tensor
                    ) -> torch.Tensor:
    """Scatter one token's rows ``(B, H, D)`` into ``pages`` ``(P, H,
    page, D)`` at ``(page_ids[b], slots[b])`` per sequence, in place —
    the per-layer decode append (idle slots target the null page)."""
    pages[page_ids.long(), :, slots.long()] = rows.to(pages.dtype)
    return pages
