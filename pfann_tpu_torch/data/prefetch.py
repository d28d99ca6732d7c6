"""Background-thread batch prefetcher (port of ``pfann_tpu/data/prefetch.py``).

One producer thread runs the loader one batch ahead.  With the real
loader that thread queues device work (the window gather, augmentation and
log-mel on the card), so each CUDA tensor it yields travels with an event
recorded on the producer's stream after the work that made it; the
consumer's stream waits on that event before it reads the batch.  The wait
is on the device: the host never blocks on it.  An item may also be a tuple
whose first element is the batch (a data-parallel rank's (rows, n)).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import torch

_END = object()


def _batch(item):
    return item[0] if isinstance(item, tuple) else item


def _ready_event(item):
    """An event after the work that produced ``item``'s batch on its CUDA
    stream, or None for host data."""
    item = _batch(item)
    if isinstance(item, torch.Tensor) and item.is_cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(item.device))
        return ev
    return None


def prefetch(it: Iterable, depth: int = 2) -> Iterator:
    """Iterate ``it`` on a daemon thread, buffering up to ``depth`` items.
    Exceptions propagate to the consumer; abandoning the iterator (break /
    GC) stops the producer instead of leaving it running into interpreter
    shutdown."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        try:
            for item in it:
                entry = (item, _ready_event(item))
                while not stop.is_set():
                    try:
                        q.put(entry, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # re-raise in consumer
            q.put(e)
            return
        q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            entry = q.get()
            if entry is _END:
                return
            if isinstance(entry, BaseException):
                raise entry
            item, ev = entry
            if ev is not None:
                batch = _batch(item)
                stream = torch.cuda.current_stream(batch.device)
                stream.wait_event(ev)
                # the allocator must not reuse the batch's memory on the
                # producer's stream while this stream still reads it
                batch.record_stream(stream)
            yield item
    finally:
        stop.set()
        # drain so a blocked producer can observe the stop flag and exit
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=5)
