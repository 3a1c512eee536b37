"""Speculative decoding's draft side (counterpart of
``paddle_tpu/serving/speculative.py``): a second engine inside the first.

One speculative round takes the place of one decode step: the DRAFT
model, small and of the same vocabulary, proposes ``k`` tokens a row
(``models/transformer.draft_propose_step``: k + 1 decode steps over its
own pool, each attending through the paged-attention kernel), then the
TARGET verifies all k + 1 positions in one step
(``verify_step_sampled``), accepts the longest valid prefix and samples
the correction or bonus token on the device. Greedy output is the plain
engine's; tempered rows use rejection sampling keyed by position, so a
preempted request resumes the same accept/reject history.

This module owns what is drafted: the draft's own
:class:`~paddle_tpu_torch.serving.kvcache.PagePool` on the target's
device and its per-slot block tables (the same page size and the same
loud free discipline as the target's), the propose and prefill calls,
and their warm-up. The proposals and draft logits it returns stay on the
device and go straight into the target's verify step.

Fault site ``serving.speculate``: at the draft engine's build, per draft
prefill and per propose round. A raise degrades the generation engine to
plain decode with a recorded ``speculation_degraded`` event; the draft
pool is the only state a draft failure can touch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import transformer as _tm
from ..resilience.faults import fault_point
from .kvcache import BlockTable, PagePool, pages_for

__all__ = ["DraftEngine"]


class DraftEngine(object):
    """The draft half of a speculative generation engine, owned by a
    :class:`~paddle_tpu_torch.serving.generator.GenerationEngine` and
    driven only from its engine thread. ``kv_pages`` / ``page_tokens``
    mirror the target pool's geometry, so a reservation that admits on
    the target admits here too; a draft-side exhaustion preempts the row
    through the engine's normal path. ``device`` is the target's: the
    draft's weights must live there."""

    def __init__(self, model, k, target_config, kv_pages, page_tokens,
                 max_context, buckets, device, name="model"):
        fault_point("serving.speculate")
        k = int(k)
        if k < 1:
            raise ValueError("speculation depth k must be >= 1, got %d"
                             % k)
        dc = model.config
        if dc.vocab_size != target_config.vocab_size:
            raise ValueError(
                "draft vocab_size=%d != target vocab_size=%d — "
                "speculative accept compares token ids, the "
                "vocabularies must be identical"
                % (dc.vocab_size, target_config.vocab_size))
        if dc.max_seq < int(max_context):
            raise ValueError(
                "draft max_seq=%d < target context window %d — the "
                "draft must cover every position it proposes at"
                % (dc.max_seq, int(max_context)))
        if model.device != torch.device(device):
            raise ValueError("the draft's weights are on %s, the target's "
                             "on %s: load both onto one device"
                             % (model.device, device))
        self.model = model
        self.k = k
        self.name = name
        self.device = model.device
        self.max_context = int(max_context)
        self.max_blocks = pages_for(self.max_context, page_tokens)
        L, nh, dh = model.kv_spec
        self.pool = PagePool(kv_pages, page_tokens, L, nh, dh)
        self._kp, self._vp = self.pool.zeros(self.device)
        self._propose = model.draft_propose_fn(k)
        self._buckets = list(buckets)
        self._tables = {}   # slot -> BlockTable of the draft pool

    # -- per-slot block tables ----------------------------------------------
    def ensure_slot(self, slot, tokens):
        """Grow (creating if needed) the slot's draft table to hold
        ``tokens`` positions; raises PoolExhausted allocating nothing."""
        t = self._tables.get(slot)
        if t is None:
            t = self._tables[slot] = BlockTable(self.pool)
        t.ensure(tokens)

    def trim_slot(self, slot, tokens):
        """Give back the slot's pages past ``tokens`` positions (see
        ``BlockTable.trim``)."""
        t = self._tables.get(slot)
        return t.trim(tokens) if t is not None else 0

    def release_slot(self, slot):
        """Free the slot's draft pages (idempotent)."""
        t = self._tables.pop(slot, None)
        if t is not None:
            t.release()

    def release_all(self):
        for slot in list(self._tables):
            self.release_slot(slot)

    def row(self, slot):
        return self._tables[slot].as_row(self.max_blocks)

    def _i32(self, a):
        return torch.as_tensor(np.asarray(a, np.int32)).to(self.device)

    # -- the device calls ----------------------------------------------------
    def prefill(self, slot, padded, length):
        """Write one prompt's K/V into the draft pool (bucketed like the
        target's prefill; the logits stay on the device)."""
        fault_point("serving.speculate")
        _tm.prefill_step(self.model.params, self._kp, self._vp,
                         self._i32(padded), int(length),
                         self._i32(self.row(slot)), self.model.config)

    def propose(self, tables, positions, tokens, active, temperatures,
                seeds, spec_caps):
        """One k-token proposal round for the whole running batch, on
        device operands. Returns (drafts [R, k], draft_logits [R, k, V])
        on the device: they feed the target's verify step directly."""
        fault_point("serving.speculate")
        return self._propose(self.model.params, self._kp, self._vp, tables,
                             positions, tokens, active, temperatures, seeds,
                             spec_caps)

    def warm(self, max_running):
        """Run every prefill bucket and one propose round with all-trash
        tables, so that the kernels are built and loaded before the
        first request. Returns the propose's (drafts, draft_logits) for
        the caller's verify warm-up."""
        trash_row = np.full((self.max_blocks,), self.pool.trash_page,
                            np.int32)
        for S_b in self._buckets:
            _tm.prefill_step(self.model.params, self._kp, self._vp,
                             self._i32(np.zeros((S_b,), np.int32)), 1,
                             self._i32(trash_row), self.model.config)
        R = int(max_running)
        zeros_i = self._i32(np.zeros((R,), np.int32))
        return self._propose(
            self.model.params, self._kp, self._vp,
            self._i32(np.tile(trash_row, (R, 1))), zeros_i, zeros_i,
            torch.zeros((R,), dtype=torch.bool, device=self.device),
            torch.zeros((R,), dtype=torch.float32, device=self.device),
            zeros_i, zeros_i)

    def close(self):
        self.release_all()
