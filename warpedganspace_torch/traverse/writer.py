"""Asynchronous JPEG emission for traversal output.

The device renders 1024^2 frames far faster than a single host thread can JPEG-
encode them, so the traversal CLI hands frames to a bounded thread pool (PIL's
C encoder releases the GIL, so encodes genuinely run in parallel) and the
device never waits on the filesystem. Bounded queue => bounded host RAM.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from warpedganspace_torch.parallel.mesh import host_threads
from warpedganspace_torch.traverse.images import tensor2image


class AsyncImageWriter:
    """Thread-pooled tensor2image + JPEG save with a bounded in-flight window;
    by default a thread per core of the host's share of this process
    (``host_threads``: the cores over the ranks of a group, at most 8)."""

    def __init__(self, workers: int | None = None, max_inflight: int = 256):
        if workers is None:
            workers = host_threads()
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._max_inflight = max_inflight
        self._futures = []

    @staticmethod
    def _encode(img_hwc, path, img_size, quality):
        pil = tensor2image(np.asarray(img_hwc), img_size=img_size, adaptive=True)
        pil.save(path, "JPEG", quality=quality, optimize=True, progressive=True)

    def submit(self, img_hwc, path: str, img_size=None, quality: int = 75):
        if len(self._futures) >= self._max_inflight:
            self._drain(self._max_inflight // 2)
        self._futures.append(
            self._pool.submit(self._encode, img_hwc, path, img_size, quality)
        )

    def _drain(self, keep: int):
        done = self._futures[: len(self._futures) - keep]
        self._futures = self._futures[len(self._futures) - keep :]
        for f in done:
            f.result()

    def flush(self):
        for f in self._futures:
            f.result()
        self._futures = []

    def close(self):
        self.flush()
        self._pool.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
