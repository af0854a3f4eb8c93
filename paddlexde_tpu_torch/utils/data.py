"""Host-side input pipeline helpers.

The port's counterpart of ``paddlexde_tpu/utils/data.py`` (``prefetch``,
``:21-90``): a batch generator runs on a daemon thread with a bounded queue,
so host-side window assembly overlaps the card's work (the role of the
reference's ``paddle.io.DataLoader`` workers, ``train_dde.py:99-114`` in
DrownFish19/PaddleXDE). A dataset that reuses its batch buffers is safe: the
producer thread copies each item before it is queued.

The port's ``Trainer`` gathers its windows on the card and does not use
this; a multi-process host input path does.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import torch
from torch.utils._pytree import tree_map

from .._device import resolve_device

__all__ = ["prefetch"]

_SENTINEL = object()


def _copy_to(device: torch.device) -> Callable:
    """The default transfer: a COPY of every leaf on ``device``, landed
    before it returns. A ``non_blocking=True`` copy from pinned memory would
    return before the bytes move, and the producer's next batch could
    overwrite a reused buffer under it (the torch form of the trap the JAX
    docstring names for ``jax.device_put``, ``utils/data.py:28-32``)."""

    def transfer(item):
        out = tree_map(lambda x: torch.as_tensor(x).to(device, copy=True), item)
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        return out

    return transfer


def prefetch(
    iterable: Iterable,
    depth: int = 2,
    transfer: Optional[Callable] = None,
    *,
    device=None,
) -> Iterator:
    """Iterate ``iterable`` on a background thread, ``depth`` (>= 1) items ahead.

    ``transfer`` runs on the producer thread; the default copies each item
    (a tensor, numpy array or a nested tuple/list/dict of them) to
    ``device`` -- the card unless the caller names another, raising when
    there is none -- and waits for the copy to land. Order is kept, an
    error of the producer is raised on the consumer, and closing or
    abandoning the returned generator stops the producer thread.
    """
    if depth < 1:
        raise ValueError(
            f"depth must be >= 1 (got {depth}); queue.Queue(0) would be "
            f"UNBOUNDED and eagerly drain the whole iterable"
        )
    if transfer is None:
        transfer = _copy_to(resolve_device(device))

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    err: list = []

    def _put(item) -> bool:
        """put that gives up once the consumer has stopped."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterable:
                if not _put(transfer(item)):
                    return
        except BaseException as exc:  # raised on the consumer thread
            err.append(exc)
        finally:
            _put(_SENTINEL)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        try:  # drain so a blocked producer unblocks promptly
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
