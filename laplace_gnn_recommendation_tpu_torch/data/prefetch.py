"""Background-thread batch prefetching (host-side double buffering), a copy
of the JAX package's ``data/prefetch.py``.

Replaces the reference's DataLoader worker processes (``config.num_workers``,
``data/data_loader.py:48-50``): the sampler runs on a daemon thread filling a
bounded queue while the device computes the previous step — sampling and
device compute overlap without fork overhead or tensor pickling.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch(
    iterable: Iterable[T],
    buffer_size: int = 2,
    transform: Optional[Callable[[T], T]] = None,
) -> Iterator[T]:
    """Iterate ``iterable`` on a background thread, ``buffer_size`` items
    ahead. Exceptions on the worker re-raise at the consumer.

    ``transform`` runs on the worker thread on each item before it is
    queued."""
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)

    def worker():
        try:
            for item in iterable:
                q.put(item if transform is None else transform(item))
        except BaseException as e:  # pragma: no cover - propagated below
            q.put(("__error__", e))
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            break
        if isinstance(item, tuple) and len(item) == 2 and item[0] == "__error__":
            raise item[1]
        yield item
