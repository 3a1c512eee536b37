"""Paged KV cache: the refcounted page pool and block tables under
continuous batching (counterpart of ``paddle_tpu/serving/kvcache.py``).

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

**Sharing** (copy-on-write prefix reuse, ``serving/prefix.py``): every
live page carries a refcount. ``alloc`` hands pages out at refcount 1,
``ref`` lets another holder (a second table pinning the same prompt
prefix, or the prefix cache) pin a live page, and ``free`` drops one
reference, returning the page to the free list only at zero. So the
accounting has two units: *physical* pages (what the device holds, the
exhaustion policy's unit) and *effective* pages (the sum of refcounts,
what the same traffic would hold without sharing). The pool never
copies: deciding when a shared page must be copied before a write is
the engine's job, from ``refcount`` / ``is_shared``. A ``reclaimer``
hook lets the prefix cache give unreferenced cached pages back before
``alloc`` declares exhaustion.
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
    ids are free, which are live and how many holders pin each.
    Thread-safe: submit threads ask about feasibility while the engine
    thread allocates."""

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
        self._refs = {}            # live page id -> refcount (>= 1)
        self._max_live = 0
        self._reclaim = None       # see set_reclaimer
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

    def set_reclaimer(self, fn):
        """Install (or clear, with None) the allocation-pressure hook:
        ``fn(n_short) -> pages_freed`` is called OUTSIDE the pool's lock
        when ``alloc`` comes up ``n_short`` pages short, and frees cold
        cached pages through :meth:`free`."""
        with self._lock:
            self._reclaim = fn

    def alloc(self, n):
        """Take ``n`` pages at refcount 1; raises :class:`PoolExhausted`
        (allocating nothing) when fewer are free after the reclaimer
        had one chance to free cold cached pages."""
        n = int(n)
        for attempt in (0, 1):
            with self._lock:
                if n <= len(self._free):
                    pages = self._free[:n]
                    del self._free[:n]
                    for p in pages:
                        self._refs[p] = 1
                    self._max_live = max(self._max_live, len(self._refs))
                    return pages
                short = n - len(self._free)
                reclaim = self._reclaim
            if attempt or reclaim is None:
                break
            # outside the lock: the reclaimer frees through free(), which
            # takes it again (cache lock, then pool lock: never inverted)
            if not reclaim(short):
                break
        raise PoolExhausted(
            "kv page pool exhausted: want %d page(s), %d of %d "
            "free" % (n, self.available, self.num_pages))

    def ref(self, pages):
        """Pin one more reference on each of ``pages``, which must be
        live: pinning a free or foreign id would resurrect garbage as
        shared state, so it raises."""
        pages = list(pages)
        with self._lock:
            bad = [p for p in pages if p not in self._refs]
            if bad:
                raise ValueError("ref on pages %s that are not live "
                                 "(free or foreign id)" % bad)
            for p in pages:
                self._refs[p] += 1

    def refcount(self, page):
        """Current refcount of ``page`` (0 when free or foreign)."""
        with self._lock:
            return self._refs.get(page, 0)

    def is_shared(self, page):
        """True when more than one holder pins ``page``: the engine's
        copy-on-write test before a write."""
        with self._lock:
            return self._refs.get(page, 0) > 1

    def free(self, pages):
        """Drop one reference a page; a page returns to the free list
        only when its refcount reaches zero. Double-free, foreign ids and
        a duplicate id within one call raise (one holder never frees a
        page twice in one release; counting it twice would eat another
        holder's reference), and then nothing is dropped."""
        pages = list(pages)
        with self._lock:
            seen = set()
            bad = []
            for p in pages:
                if p not in self._refs or p in seen:
                    bad.append(p)
                seen.add(p)
            if bad:
                raise ValueError("freeing pages %s that are not live "
                                 "(double free, duplicate, or foreign "
                                 "id)" % bad)
            released = 0
            for p in pages:
                self._refs[p] -= 1
                if self._refs[p] == 0:
                    del self._refs[p]
                    self._free.append(p)
                    released += 1
            if released:
                self._free.sort()
                self._release_log.append((time.monotonic(), released))

    def release_rate(self, window_s=30.0):
        """Observed physical page-release rate (pages/s) over the last
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
            return len(self._refs)

    @property
    def effective(self):
        """Sum of refcounts: the pages this traffic would hold without
        sharing (``effective / live`` is the dedup ratio)."""
        with self._lock:
            return sum(self._refs.values())

    def can_fit(self, tokens):
        """Whether a sequence of ``tokens`` positions could EVER be held
        (the submit-time feasibility test, in physical pages)."""
        return pages_for(tokens, self.page_tokens) <= self.num_pages

    def utilization(self):
        """{live, free, num_pages, max_live, frac, effective,
        shared_pages, dedup_ratio} snapshot; ``frac`` is physical."""
        with self._lock:
            live = len(self._refs)
            effective = sum(self._refs.values())
            shared = sum(1 for c in self._refs.values() if c > 1)
            return {"live": live, "free": len(self._free),
                    "num_pages": self.num_pages, "max_live": self._max_live,
                    "frac": live / float(self.num_pages),
                    "effective": effective, "shared_pages": shared,
                    "dedup_ratio": (effective / float(live)
                                    if live else 1.0)}


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

    def trim(self, tokens):
        """Shrink the table to the pages ``tokens`` positions need and
        free the tail (one reference each, through :meth:`PagePool.free`,
        so a double free stays loud): the speculative round's rollback.
        A round grows the table for its optimistic positions; the pages
        past the accepted point go back between rounds. Cache contents
        need no rollback, as stale positions are masked and written again
        before any read. Returns the number of pages freed."""
        keep = pages_for(tokens, self.pool.page_tokens)
        if keep >= len(self.pages):
            return 0
        tail = self.pages[keep:]
        del self.pages[keep:]
        self.pool.free(tail)
        return len(tail)

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
