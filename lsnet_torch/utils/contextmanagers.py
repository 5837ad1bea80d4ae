"""Async inference helpers (counterpart of
``lsnet_tpu/utils/contextmanagers.py``, the reference's
``mmdet/utils/contextmanagers.py``).

Work queued on the card returns at once; what an asyncio task needs is a
wait for it that does not block the event loop, and a limit on the tasks
in flight. :func:`await_ready` records a CUDA event on the current stream
and waits for it in a worker thread; CPU tensors are ready when they
exist.
"""

from __future__ import annotations

import asyncio
import contextlib
from typing import Any

import torch


def _tensors(tree: Any):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


async def await_ready(tree: Any) -> Any:
    """Return ``tree`` once the work that makes its CUDA tensors is done,
    waiting off the event loop (reference ``completed()``'s purpose)."""
    devices = {t.device for t in _tensors(tree) if t.device.type == "cuda"}
    events = []
    for dev in devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        events.append(event)
    if events:
        await asyncio.get_running_loop().run_in_executor(
            None, lambda: [e.synchronize() for e in events])
    return tree


@contextlib.asynccontextmanager
async def completed(trace_name: str = "", name: str = ""):
    """Async context manager: on exit, the work whose result was passed to
    the yielded sink is done, awaited off the event loop::

        async with completed('inference') as sink:
            out = sink(model(x))
        # out is ready here
    """
    holder = {}

    def sink(tree):
        holder["tree"] = tree
        return tree

    try:
        yield sink
    finally:
        if "tree" in holder:
            await await_ready(holder["tree"])


@contextlib.asynccontextmanager
async def concurrent(limiter: asyncio.Semaphore):
    """Limit concurrent in-flight inference tasks (reference
    ``concurrent()``)."""
    await limiter.acquire()
    try:
        yield
    finally:
        limiter.release()
