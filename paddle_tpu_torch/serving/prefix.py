"""Copy-on-write prefix sharing over the paged KV pool (counterpart of
``paddle_tpu/serving/prefix.py``).

After a prefill writes a prompt into its pages, each page's content, the
token chunk it holds chained to everything before it, is hashed and
published here; a later request whose prompt starts with the same chunks
pins those physical pages into its own block table (``PagePool.ref``)
instead of allocating and computing them again.

**The chain key.** Page *i* of a prompt covers the token chunk
``[i*T, min(L, (i+1)*T))``. Its key is ``blake2b(key_{i-1} || chunk)``,
the JAX package's bytes: a chunk matches only at the same position after
the same history, and a partial final chunk (another byte length) never
collides with a full one.

**Copy-on-write is the engine's move.** Shared pages are immutable
history; the first write into a still-shared page (a generated token
landing in a shared partial tail page) makes the engine allocate a page,
copy that one page on the device and swap it into the table
(``GenerationEngine._unshare_for_write``). The port's prefill writes no
matched page: positions below the matched run go to the trash page,
where the JAX package rewrites them with the same values.

**LRU warmth.** The cache holds its own reference on every published
page, so a prompt stays warm after its last user retires. Under
allocation pressure the pool's reclaimer hook walks the LRU oldest first
and evicts entries whose page only the cache still pins. Admission calls
the same walk when the free list is short of a request's reservation,
sparing the pages that request will pin: without it, an idle engine
whose free list the cache has drained would never admit again, since
only an allocation calls the pool's hook.

Lock order: the cache's lock, then the pool's; the pool calls the
reclaimer outside its own lock, so the order never inverts.

Fault site ``serving.prefix`` (at cache build and per match): a raise
degrades that engine to private pages with a recorded
``prefix_degraded`` event.
"""
from __future__ import annotations

import collections
import hashlib
import threading

from ..resilience.faults import fault_point

__all__ = ["PrefixCache", "chunk_keys"]


def chunk_keys(tokens, page_tokens):
    """Yield ``(key, start, end)`` per page-sized chunk of ``tokens``
    (the final chunk may be partial). ``key`` is the 16-byte rolling
    blake2b digest: position- and history-dependent."""
    tokens = list(tokens)
    T = int(page_tokens)
    prev = b""
    for start in range(0, len(tokens), T):
        chunk = tokens[start:start + T]
        h = hashlib.blake2b(prev, digest_size=16)
        h.update(b",".join(b"%d" % int(t) for t in chunk))
        prev = h.digest()
        yield prev, start, start + len(chunk)


class _Entry(object):
    __slots__ = ("key", "page", "tokens")

    def __init__(self, key, page, tokens):
        self.key = key
        self.page = page       # physical page id (the cache holds a ref)
        self.tokens = tokens   # positions of the page the chunk covers


class PrefixCache(object):
    """Content-addressed prefix-page cache over ONE :class:`PagePool`."""

    def __init__(self, pool, name="model"):
        fault_point("serving.prefix")
        self.pool = pool
        self.name = name
        self._lock = threading.Lock()
        # key -> _Entry, in LRU order (oldest first)
        self._entries = collections.OrderedDict()
        self._counts = collections.Counter()
        pool.set_reclaimer(self.reclaim)

    def probe(self, tokens):
        """How many leading FULL pages of ``tokens`` are cached now: the
        admission discount (those pages are pinned, not allocated). A
        partial final chunk is not counted even when cached, since
        copy-on-write buys it back at the first generated token. No pin,
        no LRU touch."""
        T = self.pool.page_tokens
        n = 0
        with self._lock:
            for key, start, end in chunk_keys(tokens, T):
                if end - start < T or key not in self._entries:
                    break
                n += 1
        return n

    def match(self, tokens):
        """Pin the longest cached page run covering a prefix of
        ``tokens``: each matched page takes one ``pool.ref`` for the
        caller's table (released through the table's normal free).
        Returns ``(pages, covered_tokens)``; matched entries move to the
        most recently used end."""
        fault_point("serving.prefix")
        pages, covered = [], 0
        with self._lock:
            for key, start, end in chunk_keys(tokens, self.pool.page_tokens):
                entry = self._entries.get(key)
                if entry is None or entry.tokens != end - start:
                    break
                self._entries.move_to_end(key)
                pages.append(entry.page)
                covered = end
            if pages:
                self.pool.ref(pages)
                self._counts["hits"] += len(pages)
                self._counts["hit_requests"] += 1
            else:
                self._counts["miss_requests"] += 1
        return pages, covered

    def publish(self, tokens, pages):
        """Register the pages now holding ``tokens`` (page *i* holds
        chunk *i*; a partial final chunk is published too, so
        same-prompt requests share their tail page until copy-on-write
        parts them). Cached chunks are refreshed, new entries pin one
        cache reference each. Returns the number newly published."""
        published = 0
        with self._lock:
            for i, (key, start, end) in enumerate(
                    chunk_keys(tokens, self.pool.page_tokens)):
                if i >= len(pages):
                    break
                if key in self._entries:
                    self._entries.move_to_end(key)
                    continue
                self.pool.ref([pages[i]])
                self._entries[key] = _Entry(key, pages[i], end - start)
                published += 1
            self._counts["published"] += published
        return published

    def reclaim(self, n_short, keep=()):
        """Evict the oldest entries whose page the cache alone still pins
        (refcount 1) until ``n_short`` pages came back or none is left;
        the leading full pages of the prompt ``keep`` stay (the ones
        :meth:`probe` discounts, which its own match will pin). The
        pool's pressure hook, and admission's when the cache holds the
        pages a reservation needs. Returns the pages freed."""
        freed = 0
        with self._lock:
            kept = set()
            for key, start, end in chunk_keys(keep, self.pool.page_tokens):
                if end - start < self.pool.page_tokens or \
                        key not in self._entries:
                    break
                kept.add(key)
            for key in list(self._entries):
                if freed >= n_short:
                    break
                entry = self._entries[key]
                if key in kept or self.pool.refcount(entry.page) != 1:
                    continue   # a running table still shares it
                del self._entries[key]
                self.pool.free([entry.page])
                freed += 1
            self._counts["evictions"] += freed
        return freed

    def reset(self):
        """Drop every entry and its cache reference; stay registered."""
        with self._lock:
            for entry in self._entries.values():
                try:
                    self.pool.free([entry.page])
                except ValueError:
                    pass   # the pool's accounting was reset under us
            self._entries.clear()

    def clear(self):
        """:meth:`reset` and unregister from the pool's pressure hook
        (engine close or degrade)."""
        self.reset()
        self.pool.set_reclaimer(None)

    def stats(self):
        with self._lock:
            c = dict(self._counts)
            return {"entries": len(self._entries),
                    "hits": c.get("hits", 0),
                    "hit_requests": c.get("hit_requests", 0),
                    "miss_requests": c.get("miss_requests", 0),
                    "published": c.get("published", 0),
                    "evictions": c.get("evictions", 0)}
