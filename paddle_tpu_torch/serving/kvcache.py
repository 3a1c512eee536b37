"""Paged KV cache: the page pool and block tables under continuous
batching (a copy of ``paddle_tpu/serving/kvcache.py`` without the
refcounts of prefix sharing).

The cache is split into fixed pages of ``page_tokens`` positions,
preallocated once per model as one device-resident pool, and each
running sequence owns a **block table**, the ordered list of its page
ids. Allocation is list work on the host; attention reads K/V through
the block table and the step writes the new position through it.

Layout: ``[num_layers, num_pages + 1, page_tokens, heads, head_dim]``
per K and V. The LAST page is the **trash page**: block tables are
padded with it and writes of inactive rows go to it, so every write has
a legal target. Its contents are garbage and never read by a live row.

Exhaustion is policy: ``alloc`` raises :class:`PoolExhausted` and the
engine sheds or preempts.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np
import torch

from .admission import ServingError

__all__ = ["PoolExhausted", "PagePool", "BlockTable", "pages_for"]


class PoolExhausted(ServingError):
    """The page pool cannot satisfy an allocation right now."""


def pages_for(tokens, page_tokens):
    """Pages needed to hold ``tokens`` positions (ceil division; at
    least one: a live sequence always owns a page)."""
    tokens = max(int(tokens), 1)
    return -(-tokens // int(page_tokens))


class PagePool(object):
    """Host-side allocator of one model's page pool. The device tensors
    (:meth:`zeros`) are owned by the engine; this object owns which page
    ids are free and which are live. Thread-safe: submit threads ask
    about feasibility while the engine thread allocates."""

    def __init__(self, num_pages, page_tokens, num_layers, num_heads,
                 head_dim):
        if num_pages < 1:
            raise ValueError("num_pages must be >= 1")
        if page_tokens < 1:
            raise ValueError("page_tokens must be >= 1")
        self.num_pages = int(num_pages)
        self.page_tokens = int(page_tokens)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self._lock = threading.Lock()
        # free list kept SORTED so allocation order is deterministic
        self._free = list(range(self.num_pages))
        self._live = set()
        self._max_live = 0
        # rolling log of (monotonic t, pages released): the observed
        # release rate that prices a 429's Retry-After hint
        self._release_log = collections.deque(maxlen=256)

    @property
    def trash_page(self):
        """Id of the write-sink page (the extra last page)."""
        return self.num_pages

    def zeros(self, device):
        """Zeroed (k_pages, v_pages) float32 tensors in the pool layout
        on ``device``; the engine writes into them in place."""
        shape = (self.num_layers, self.num_pages + 1, self.page_tokens,
                 self.num_heads, self.head_dim)
        return (torch.zeros(shape, dtype=torch.float32, device=device),
                torch.zeros(shape, dtype=torch.float32, device=device))

    def alloc(self, n):
        """Take ``n`` pages; raises :class:`PoolExhausted` (allocating
        nothing) when fewer are free."""
        n = int(n)
        with self._lock:
            if n > len(self._free):
                raise PoolExhausted(
                    "kv page pool exhausted: want %d page(s), %d of %d "
                    "free" % (n, len(self._free), self.num_pages))
            pages = self._free[:n]
            del self._free[:n]
            self._live.update(pages)
            self._max_live = max(self._max_live, len(self._live))
            return pages

    def free(self, pages):
        """Return pages to the free list. Double-free, duplicate and
        foreign ids raise: aliasing a live page would corrupt another
        sequence's cache."""
        pages = list(pages)
        with self._lock:
            bad = [p for i, p in enumerate(pages)
                   if p not in self._live or p in pages[:i]]
            if bad:
                raise ValueError("freeing pages %s that are not live "
                                 "(double free, duplicate, or foreign "
                                 "id)" % bad)
            self._live.difference_update(pages)
            self._free.extend(pages)
            self._free.sort()
            if pages:
                self._release_log.append((time.monotonic(), len(pages)))

    def release_rate(self, window_s=30.0):
        """Observed page-release rate (pages/s) over the last
        ``window_s`` seconds."""
        cutoff = time.monotonic() - float(window_s)
        with self._lock:
            events = [(t, n) for t, n in self._release_log if t >= cutoff]
        if not events:
            return 0.0
        span = max(time.monotonic() - events[0][0], 1e-3)
        return sum(n for _, n in events) / span

    @property
    def available(self):
        with self._lock:
            return len(self._free)

    @property
    def live(self):
        with self._lock:
            return len(self._live)

    def can_fit(self, tokens):
        """Whether a sequence of ``tokens`` positions could EVER be held
        (the submit-time feasibility test)."""
        return pages_for(tokens, self.page_tokens) <= self.num_pages

    def utilization(self):
        """{live, free, num_pages, max_live, frac} snapshot."""
        with self._lock:
            live = len(self._live)
            return {"live": live, "free": len(self._free),
                    "num_pages": self.num_pages, "max_live": self._max_live,
                    "frac": live / float(self.num_pages)}


class BlockTable(object):
    """One sequence's ordered page list."""

    __slots__ = ("pool", "pages")

    def __init__(self, pool, pages=()):
        self.pool = pool
        self.pages = list(pages)

    @property
    def capacity(self):
        return len(self.pages) * self.pool.page_tokens

    def ensure(self, tokens):
        """Grow the table to hold ``tokens`` positions; raises
        :class:`PoolExhausted` allocating nothing."""
        need = pages_for(tokens, self.pool.page_tokens) - len(self.pages)
        if need > 0:
            self.pages.extend(self.pool.alloc(need))

    def release(self):
        """Free every page back to the pool (idempotent)."""
        if self.pages:
            self.pool.free(self.pages)
            self.pages = []

    def as_row(self, max_blocks):
        """Fixed-width int32 row of the device block table, trash-padded."""
        row = np.full((max_blocks,), self.pool.trash_page, np.int32)
        n = min(len(self.pages), max_blocks)
        row[:n] = self.pages[:n]
        return row
