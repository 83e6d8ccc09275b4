"""Bounded background prefetch (port of ``absolutetrack_tpu/data/prefetch.py``):
a worker thread feeds a bounded queue, so that host data work (and the
preprocessing it launches on the card) overlaps the consumer's compute."""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional


class PrefetchIterator:
    """Iterate ``source`` on a daemon thread, ``max_prefetch`` items ahead.

    ``transform``, if given, runs on the worker. An exception in the worker
    re-raises at the consuming site after the items before it; ``close``
    (or dropping the iterator) stops the worker promptly, and ``close``
    returns once the worker has finished the item in hand, so no work it
    launches follows the call.
    """

    _DONE = object()

    def __init__(
        self,
        source: Iterable,
        max_prefetch: int = 2,
        transform: Optional[Callable] = None,
    ):
        self._q: queue.Queue = queue.Queue(maxsize=max_prefetch)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._transform = transform

        def worker():
            try:
                for item in source:
                    if self._stop.is_set():
                        return
                    if self._transform is not None:
                        item = self._transform(item)
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # noqa: BLE001 - re-raised at the consumer
                self._exc = e
            finally:
                while not self._stop.is_set():
                    try:
                        self._q.put(self._DONE, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if threading.current_thread() is not self._thread:
            self._thread.join()

    def __del__(self):  # best-effort cleanup
        self.close()
