"""The asynchronous execution pipeline (counterpart of
``paddle_tpu/pipeline.py:57-290``): a feed thread that prepares batch
k+1 while the card computes batch k, and lazy fetches.

- :class:`FeedPipeline`: a feed thread runs ``DataFeeder.feed`` on the
  host, pins the batch and copies it to the card on a stream of its own
  into one of ``depth`` device slots, then records an event. The
  consumer makes its stream wait on that event (the host does not wait)
  before the Executor copies the batch into a compiled step's static
  feed buffers. The slots are reused in place, in a ring: the feed
  thread refills a slot only after the consumer has taken the next batch
  and the card has passed the point where it did (an event recorded
  then). On the CPU the feed thread builds each batch with
  ``Executor.prepare_feed``, as the JAX package does. If the feed thread
  fails (fault site ``pipeline.feed_next``), the pipeline records a
  ``pipeline_degraded`` event and feeds synchronously from the batch it
  failed on: no batch is lost, and losses stay those of the synchronous
  mode. An exception of the reader itself is raised to the consumer.
  The feed thread's CUDA calls wait while the consumer captures a step
  (``core/executor.py:CAPTURE_LOCK``).
- :class:`AsyncFetch` (``core/executor.py``, re-exported here):
  ``Executor.run(..., sync=False)`` returns handles that copy to the host
  only at a real sync point; :func:`materialize` and
  :func:`materialize_scalar` force them.

The JAX package's persistent compile cache (``enable_compile_cache``)
has no counterpart: a CUDA graph does not outlive its process.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from .core.executor import CAPTURE_LOCK, AsyncFetch, LoDValue
from .resilience.events import record_event
from .resilience.faults import fault_point

__all__ = ["AsyncFetch", "FeedPipeline", "materialize", "materialize_scalar"]


def materialize(value):
    """An AsyncFetch (or a list or tuple of them) as its host value;
    anything else as it is."""
    if isinstance(value, AsyncFetch):
        return value.value()
    if isinstance(value, (list, tuple)):
        return type(value)(materialize(v) for v in value)
    return value


def materialize_scalar(value):
    """The Python float of a fetched scalar, materialized if lazy."""
    if isinstance(value, float):
        return value
    if isinstance(value, AsyncFetch):
        return float(value)
    return float(np.asarray(materialize(value)).reshape(-1)[0])


_END = object()


class _Degraded(object):
    """What a failing feed thread hands over: the raw batch it failed on,
    which the synchronous fallback feeds again."""

    __slots__ = ("item", "error")

    def __init__(self, item, error):
        self.item = item
        self.error = error


class _ReaderError(object):
    """The reader raised on the feed thread: raised again to the
    consumer, as the synchronous loop would see it."""

    __slots__ = ("error",)

    def __init__(self, error):
        self.error = error


class _Stopped(Exception):
    pass


def _tensors(feed):
    for v in feed.values():
        if isinstance(v, LoDValue):
            yield v.data
            yield from v.lod
        else:
            yield v


class FeedPipeline(object):
    """Iterating yields feed dicts on the Executor's device, in reader
    order, prepared on a feed thread ``depth`` batches ahead at most
    (``depth=2``: double buffering). ``stats``: ``batches``,
    ``feed_wait_ms`` (the consumer's waits for the next batch),
    ``produce_wait_ms``, ``max_in_flight``, ``slot_reuse`` (batches fed
    into a slot used before) and ``fallback_sync``."""

    def __init__(self, reader, feeder, executor, depth=2):
        self.depth = max(int(depth), 1)
        self._feeder = feeder
        self._exe = executor
        self._it = iter(reader())
        self._q = queue.Queue(maxsize=self.depth)
        self._stop = False
        self._sync_mode = False
        self.stats = {"depth": self.depth, "batches": 0,
                      "feed_wait_ms": 0.0, "produce_wait_ms": 0.0,
                      "max_in_flight": 0, "slot_reuse": 0,
                      "fallback_sync": False}
        self._cuda = executor.device.type == "cuda"
        if self._cuda:
            self._stream = torch.cuda.Stream(executor.device)
            self._slots = [{} for _ in range(self.depth)]
            self._free = [threading.Event() for _ in range(self.depth)]
            for f in self._free:
                f.set()
            self._released = [None] * self.depth
            self._held = None
        self._thread = threading.Thread(target=self._produce,
                                        name="paddle_tpu_torch-feed",
                                        daemon=True)
        self._thread.start()

    # -- the feed thread ------------------------------------------------------
    def _prepare_sync(self, raw):
        return self._exe.prepare_feed(self._feeder.feed(raw))

    def _prepare(self, raw, slot):
        if not self._cuda:
            return self._prepare_sync(raw), None
        host = self._feeder.feed(raw, device="cpu")
        while not self._free[slot].wait(0.1):
            if self._stop:
                raise _Stopped()
        self._free[slot].clear()
        # not while the consumer captures a step (core/executor.py)
        with CAPTURE_LOCK, torch.cuda.stream(self._stream):
            if self._released[slot] is not None:
                self._stream.wait_event(self._released[slot])
            bufs = self._slots[slot]
            dev = {}
            for name, v in host.items():
                if isinstance(v, LoDValue):
                    parts = [self._fill(bufs, (name, -1), v.data)] + [
                        self._fill(bufs, (name, i), l)
                        for i, l in enumerate(v.lod)]
                    dev[name] = LoDValue(parts[0], parts[1:],
                                         max_lens=v.max_lens)
                else:
                    dev[name] = self._fill(bufs, (name,), v)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return dev, ready

    def _fill(self, bufs, key, t):
        """Copy host tensor ``t`` into the slot's buffer for ``key``
        (made anew only when its shape or dtype changes), from pinned
        memory, without the host waiting."""
        buf = bufs.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = bufs[key] = torch.empty(t.shape, dtype=t.dtype,
                                          device=self._exe.device)
        buf.copy_(t.pin_memory(), non_blocking=True)
        return buf

    def _produce(self):
        k = 0
        try:
            while not self._stop:
                try:
                    raw = next(self._it)
                except StopIteration:
                    break
                except BaseException as e:
                    self._put(_ReaderError(e))
                    return
                slot = k % self.depth
                try:
                    fault_point("pipeline.feed_next")
                    item = self._prepare(raw, slot)
                except _Stopped:
                    return
                except BaseException as e:
                    record_event("pipeline_degraded",
                                 site="pipeline.feed_next",
                                 error=repr(e), batch=k)
                    self._put(_Degraded(raw, e))
                    return
                if k >= self.depth:
                    self.stats["slot_reuse"] += 1
                k += 1
                self._put((slot, item))
                n = self._q.qsize()
                if n > self.stats["max_in_flight"]:
                    self.stats["max_in_flight"] = n
        finally:
            self._put(_END)

    def _put(self, item):
        t0 = time.perf_counter()
        while not self._stop:
            try:
                self._q.put(item, timeout=0.1)
                break
            except queue.Full:
                continue
        self.stats["produce_wait_ms"] += (time.perf_counter() - t0) * 1e3

    # -- the consumer ---------------------------------------------------------
    def __iter__(self):
        return self

    def _release_held(self):
        """The batch handed out last is done with as far as the host
        goes: its run is on the stream. Record where, and free its slot."""
        if self._cuda and self._held is not None:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self._exe.device))
            self._released[self._held] = done
            self._free[self._held].set()
            self._held = None

    def __next__(self):
        self._release_held()
        if self._sync_mode:
            return self._next_sync()
        t0 = time.perf_counter()
        e = self._q.get()
        self.stats["feed_wait_ms"] += (time.perf_counter() - t0) * 1e3
        if e is _END:
            raise StopIteration
        if isinstance(e, _ReaderError):
            raise e.error
        if isinstance(e, _Degraded):
            # feed synchronously from the batch the thread failed on
            self._sync_mode = True
            self.stats["fallback_sync"] = True
            self.stats["batches"] += 1
            return self._prepare_sync(e.item)
        slot, (dev, ready) = e
        self.stats["batches"] += 1
        if ready is not None:
            stream = torch.cuda.current_stream(self._exe.device)
            stream.wait_event(ready)
            for t in _tensors(dev):
                t.record_stream(stream)
            self._held = slot
        return dev

    def _next_sync(self):
        raw = next(self._it)  # StopIteration ends the pass
        self.stats["batches"] += 1
        return self._prepare_sync(raw)

    def close(self):
        """Stop the feed thread and release the ring (safe twice)."""
        self._stop = True
        self._release_held()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
