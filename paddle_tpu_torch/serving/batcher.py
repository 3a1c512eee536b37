"""Padding buckets (the part of ``paddle_tpu/serving/batcher.py`` the
generation engine uses): prompt lengths are padded up to a small set of
sizes so that the prefill sees few distinct shapes."""
from __future__ import annotations

__all__ = ["padding_buckets", "bucket_for"]


def padding_buckets(max_batch):
    """Powers of two with ``max_batch`` itself as the cap
    (8 -> [1, 2, 4, 8]; 6 -> [1, 2, 4, 6])."""
    max_batch = max(int(max_batch), 1)
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def bucket_for(r, buckets):
    """Smallest bucket that fits ``r``."""
    for b in buckets:
        if b >= r:
            return b
    return buckets[-1]
