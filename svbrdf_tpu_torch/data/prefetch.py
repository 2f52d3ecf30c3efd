"""A pool of worker processes that decode PNG strips ahead of their use.

Counterpart of svbrdf_tpu/data/native_loader.PrefetchPool, with its
contract over a fixed list of files: request(idx) queues a decode ahead of
time, take(idx) returns the decoded uint8 (H, W, 3) strip (waiting for it),
close() stops the workers. The workers run the port's own decoder
(strips.read_image_u8 over data/png.py), so the pool needs neither libpng
nor a native build; a dataset may hand them more of a sample's host work
(`decode`, e.g. dataset.strip_tiles).

The workers are processes from a `spawn` context. The decoder's Average and
Paeth rows are a Python loop per anti-diagonal that holds the interpreter
lock, so decode threads would contend with the thread that launches the
card's kernels; and forking a process that has started CUDA is unsafe.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import Future, ProcessPoolExecutor
from typing import Any, Callable, Dict, Sequence

from svbrdf_tpu_torch.data import strips


class PrefetchPool:
    """Background decode of `paths` in `workers` processes: `decode(path)`,
    by default the strip (strips.read_image_u8); a module-level function
    (or a partial of one), since the workers import it by name.

    At most `capacity` = max(32, 8 per worker) decodes are queued or held,
    as in the JAX package's pool; a request beyond that is dropped, as the
    native pool drops it, and its take decodes it then. Use as a context
    manager, or call close(): the workers are joined there."""

    def __init__(self, paths: Sequence[str], workers: int = 2,
                 decode: Callable[[str], Any] = strips.read_image_u8):
        self._paths = list(paths)
        self._decode = decode
        self.capacity = max(32, workers * 8)
        self._executor = ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn"))
        self._queued: Dict[int, Future] = {}

    def request(self, idx: int) -> None:
        """Queue the decode of file `idx` unless it is queued or held
        already, or the pool is at capacity (the hint is then dropped)."""
        if not 0 <= idx < len(self._paths):
            raise IndexError(f"sample index {idx} out of range "
                             f"[0, {len(self._paths)})")
        if idx in self._queued or len(self._queued) >= self.capacity:
            return
        self._queued[idx] = self._executor.submit(self._decode,
                                                  self._paths[idx])

    def take(self, idx: int):
        """File `idx` decoded: a requested one from its worker (waiting for
        it), any other here, in the caller. A failed decode raises
        RuntimeError naming the file."""
        path = self._paths[idx]
        queued = self._queued.pop(idx, None)
        try:
            if queued is None:
                return self._decode(path)
            return queued.result()
        except Exception as exc:  # a decode or worker failure: name the file
            raise RuntimeError(f"decoding {path!r} failed: {exc}") from exc

    def close(self) -> None:
        """Drop what is queued and join the workers."""
        self._queued.clear()
        self._executor.shutdown(wait=True, cancel_futures=True)

    def __enter__(self) -> "PrefetchPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
