"""Input prefetching: the next batches are prepared and copied to the
device while the current step runs (counterpart of
``papc_tpu/data/prefetch.py``).

A background thread runs the host pipeline (the loader and an optional
``transform``) and puts each batch on the device, at most ``size``
batches ahead of the consumer. On a CUDA device a batch's arrays go from
pinned host memory to the card with ``non_blocking=True`` on a copy
stream of the prefetcher's own, and an event recorded after them; the
consumer's stream waits on that event before it hands the batch out, and
each tensor is ``record_stream``-ed onto the consumer's stream, so the
caching allocator does not reuse its memory before the consumer's work on
it is done.

``train()`` copies each batch inline instead, where JAX's feeds its
steps through this: a step of the port is host-bound (its Python
enqueues every launch), and on the card the prefetch cost it steps a
second (``PERF.md`` §5, ``tools/epoch_ab.py``). A loader that waits on
I/O can still use it.
"""

from __future__ import annotations

import queue
import threading
from collections.abc import Callable, Iterable, Iterator, Mapping

import numpy as np
import torch


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic, torch.Tensor))


def map_arrays(fn: Callable, tree):
    """``tree`` (dicts, lists, tuples and named tuples of leaves) with
    ``fn`` applied to every array leaf (numpy array or scalar, tensor);
    every other leaf as it is."""
    if _is_array(tree):
        return fn(tree)
    if isinstance(tree, Mapping):
        return type(tree)((k, map_arrays(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_arrays(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_arrays(fn, v) for v in tree)
    return tree


def _tensors(tree) -> list:
    found = []
    map_arrays(lambda t: found.append(t), tree)
    return found


def prefetch_to_device(iterable: Iterable, size: int = 2,
                       transform: Callable | None = None,
                       device: str | torch.device = "cuda") -> Iterator:
    """Iterate ``iterable`` on a background thread, apply ``transform``
    (on the host) and put every array leaf on ``device`` as a tensor,
    ``size`` items ahead of the consumer. Items come in the iterable's
    order; an exception raised by the iterable or ``transform`` is raised
    in the consumer. Non-array leaves (tags, ``None``) pass through."""
    if size < 1:
        raise ValueError(f"size must be at least 1, got {size}")
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        device = torch.device("cuda", device.index
                              if device.index is not None
                              else torch.cuda.current_device())
        copy_stream = torch.cuda.Stream(device)
    q: queue.Queue = queue.Queue(maxsize=size)
    end = object()

    def put(item):
        if not cuda:
            return map_arrays(lambda x: torch.as_tensor(x, device=device),
                              item), None

        def copy(x):
            t = torch.as_tensor(x)
            if t.device.type == "cpu":
                t = t.pin_memory()
            return t.to(device, non_blocking=True)

        with torch.cuda.device(device), torch.cuda.stream(copy_stream):
            moved = map_arrays(copy, item)
            event = torch.cuda.Event()
            event.record(copy_stream)
        return moved, event

    def producer():
        try:
            for item in iterable:
                if transform is not None:
                    item = transform(item)
                q.put(put(item))
        except BaseException as e:  # raised again in the consumer
            q.put(e)
            return
        q.put(end)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        got = q.get()
        if got is end:
            return
        if isinstance(got, BaseException):
            raise got
        item, event = got
        if event is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(event)
            for t in _tensors(item):
                t.record_stream(stream)
        yield item
