"""Shape-bucket ladder and signature accounting for serving (port of
``BucketLadder`` and ``CompileCache`` in ``mx_rcnn_tpu/serve/buckets.py``):
every request is padded into the smallest bucket that holds it, and an
oversize request is rejected.

The JAX package's ``CompileCache`` counts XLA compiles.  The port compiles
no graph, but the invariant it guards carries over: each (model, bucket,
``max_batch``, dtype, precision) rung is one input shape through one
module, so the cuDNN algorithm choices, the kernels' builds and the
allocator's blocks settle once per rung at warmup.  ``misses`` counts the
distinct signatures seen; after warmup it must not grow."""

from __future__ import annotations

from typing import Dict, Iterator, Sequence, Tuple

from mx_rcnn_tpu_torch.analysis.lockcheck import make_lock


class BucketOverflow(ValueError):
    """The (resized) image does not fit any serving bucket — the request
    must be rejected, not silently cropped."""


class BucketLadder:
    """Immutable ladder of (H, W) canvas shapes, smallest-fit selection."""

    def __init__(self, buckets: Sequence[Tuple[int, int]]):
        if not buckets:
            raise ValueError("empty bucket ladder")
        uniq = {(int(h), int(w)) for h, w in buckets}
        self.buckets: Tuple[Tuple[int, int], ...] = tuple(
            sorted(uniq, key=lambda b: (b[0] * b[1], b))
        )

    def select(self, h: int, w: int) -> Tuple[int, int]:
        """Smallest-area bucket containing (h, w); raises
        :class:`BucketOverflow` when none fits."""
        for bh, bw in self.buckets:
            if bh >= h and bw >= w:
                return (bh, bw)
        raise BucketOverflow(
            f"image ({h}, {w}) exceeds every serving bucket {list(self.buckets)}"
        )

    def fits(self, h: int, w: int) -> bool:
        return any(b[0] >= h and b[1] >= w for b in self.buckets)

    def __iter__(self) -> Iterator[Tuple[int, int]]:
        return iter(self.buckets)

    def __len__(self) -> int:
        return len(self.buckets)

    def __repr__(self) -> str:
        return f"BucketLadder({list(self.buckets)})"


class CompileCache:
    """Counts distinct serving signatures (see the module docstring).
    Thread-safe: the engine's workers record while warmup and tests read
    the counters."""

    def __init__(self):
        self._lock = make_lock("CompileCache._lock")
        self._keys: set = set()
        self.hits = 0
        self.misses = 0

    def record(self, key) -> bool:
        """Note one forward with signature ``key``; True when the signature
        was seen before."""
        with self._lock:
            if key in self._keys:
                self.hits += 1
                return True
            self._keys.add(key)
            self.misses += 1
            return False

    @property
    def keys(self) -> Tuple:
        with self._lock:
            return tuple(sorted(self._keys, key=repr))

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "signatures": sorted(map(list, self._keys)),
            }
