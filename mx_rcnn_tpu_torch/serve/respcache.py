"""Idempotent response cache for duplicate-heavy serving traffic (port of
``mx_rcnn_tpu/serve/respcache.py``).

Detection is a pure function of ``(model params version, serve-graph
precision, input image)`` — the serve stack runs one program
per signature and a swap changes results only through the live version
pointer.  That makes the response cacheable by content: the key is
``(model_id, live_version, precision, blake2b(image bytes + shape +
dtype))``, so a hit can only ever return what the identical request
would have recomputed, byte for byte (the stored detections arrays are
returned as-is; callers treat detections as immutable, which every
existing consumer already does).  Precision joined the key with the
compression ladder: an f32 and an int8 serving of the same
family must never share bytes, and under a cascade the key always names
the family that actually served — cheap-family bytes can never be
stored under a flagship key.

Version is part of the key, so a hot-swap can never serve stale bytes —
but stale entries would still occupy capacity, so the registry notifies
:meth:`invalidate_model` on every live-pointer movement (commit,
canary rollback, cancel rollback) and the model's entries drop eagerly.

The cache is host-side and bounded (LRU).  Its lock is a leaf — only
dict bookkeeping ever runs under it, never device work — so it composes
with the serve stack's lock order by construction
(``MX_RCNN_LOCK_CHECK=1`` asserts it at run time).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from mx_rcnn_tpu_torch.analysis.lockcheck import make_lock


class ResponseCache:
    """Bounded LRU of per-request detection results, keyed by image
    content digest per ``(model, version)``."""

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._lock = make_lock("ResponseCache._lock")
        self._entries: "OrderedDict[Tuple, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    # ---------------------------------------------------------------- keys
    @staticmethod
    def digest(im: np.ndarray) -> str:
        """Content digest of the raw input image — shape and dtype are
        part of the identity (a (2,8) f32 image and its (4,4) reshape
        share bytes but are different requests)."""
        arr = np.ascontiguousarray(im)
        h = hashlib.blake2b(digest_size=16)
        h.update(repr((arr.shape, str(arr.dtype))).encode())
        h.update(arr.tobytes())
        return h.hexdigest()

    def key_for(
        self,
        im: np.ndarray,
        model_id: str,
        version: int,
        precision: str = "f32",
    ) -> Tuple:
        """Key layout ``(model, version, precision, digest)`` — index 1
        stays the version (the engine's put-guard reads it) and index 0
        the family (:meth:`invalidate_model` matches on it)."""
        return (model_id, int(version), str(precision), self.digest(im))

    # -------------------------------------------------------------- lookup
    def get(self, key: Tuple):
        with self._lock:
            try:
                entry = self._entries[key]
            except KeyError:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry

    def put(self, key: Tuple, dets) -> None:
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return
            self._entries[key] = dets
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1

    def invalidate_model(self, model_id: str) -> int:
        """Drop every entry for ``model_id`` (all versions) — the
        registry's live-pointer-moved hook.  Idempotent; returns how
        many entries were dropped."""
        with self._lock:
            dead = [k for k in self._entries if k[0] == model_id]
            for k in dead:
                del self._entries[k]
            self.invalidations += len(dead)
            return len(dead)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # ------------------------------------------------------- observability
    def snapshot(self) -> Dict:
        with self._lock:
            looked = self.hits + self.misses
            return {
                "size": len(self._entries),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hits / looked, 4) if looked else None,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
            }
