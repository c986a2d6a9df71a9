"""Host input pipeline with device prefetch — the port of the GAN half of
``tpgan_tpu/data/pipeline.py``.

:func:`batch_iterator` is a ``torch.utils.data.DataLoader`` that yields
the JAX iterator's batches in the JAX iterator's order: worker processes
decode items ahead of the step, and with ``pin_memory`` the batches land
in page-locked host memory. :func:`prefetch_to_device` keeps ``size``
batches in flight to the device, each copied with ``non_blocking=True``
on a side stream, so the copy of batch i+1 overlaps the step on batch i.
"""

from __future__ import annotations

import collections
import multiprocessing
from typing import Any, Iterable, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch
from torch.utils.data import DataLoader

from tpgan_tpu_torch.utils.device import resolve_device


_PRELOAD = ("torch", "tpgan_tpu_torch.data.multipie", "tpgan_tpu_torch.data.packing")


class _JaxOrder:
    """The batches of index lists that JAX's ``batch_iterator`` visits:
    per epoch, ``RandomState(seed).shuffle`` of the index list (one
    generator across epochs), then chunks of ``batch_size``; with
    ``drop_last`` a short tail chunk is skipped."""

    def __init__(self, idxs: List[int], batch_size: int, shuffle: bool, seed: int,
                 drop_last: bool, epochs: Optional[int]):
        self.idxs, self.batch_size, self.shuffle = idxs, batch_size, shuffle
        self.seed, self.drop_last, self.epochs = seed, drop_last, epochs

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.RandomState(self.seed)
        epoch = 0
        while self.epochs is None or epoch < self.epochs:
            order = self.idxs[:]
            if self.shuffle:
                rng.shuffle(order)
            for start in range(0, len(order), self.batch_size):
                chunk = order[start:start + self.batch_size]
                if self.drop_last and len(chunk) < self.batch_size:
                    continue
                yield chunk
            epoch += 1


def _collate(items: List[Any]):
    """Stack the items that are not None (the reference's oversize filter,
    Pretrain.py:66-74) into torch tensors; None when none is left."""
    items = [x for x in items if x is not None]
    if not items:
        return None
    first = items[0]
    stack = lambda xs: torch.from_numpy(np.stack([np.asarray(x) for x in xs]))
    if isinstance(first, dict):
        return {k: stack([it[k] for it in items]) for k in first}
    if isinstance(first, tuple):
        return tuple(stack([it[i] for it in items]) for i in range(len(first)))
    return stack(items)


def batch_iterator(
    dataset,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    num_workers: int = 4,
    indices: Optional[Sequence[int]] = None,
    epochs: Optional[int] = None,
    pin_memory: bool = False,
) -> Iterator[Any]:
    """Yield stacked batches (dicts, tuples or tensors of CPU tensors)
    from an indexable dataset, in the order of the JAX package's
    ``batch_iterator`` for the same seed. Items that are None are
    dropped, leaving a smaller batch; a batch left empty is skipped.

    ``num_workers`` > 0 decodes in that many worker processes, forked
    from a fresh server process (``forkserver``): they inherit no thread
    and no CUDA state of the caller, receive the dataset pickled, and
    never touch CUDA. (``spawn`` workers end with a full interpreter
    shutdown, in which PyTorch aborted on a thread it still held.)
    ``pin_memory`` puts each batch in page-locked memory, so that
    :func:`prefetch_to_device` copies it asynchronously."""
    idxs = list(indices) if indices is not None else list(range(len(dataset)))
    if epochs is None and (not idxs or (drop_last and len(idxs) < batch_size)):
        raise ValueError(f"{len(idxs)} items make no batch of {batch_size} (drop_last="
                         f"{drop_last}): an endless iterator would never yield")
    context = None
    if num_workers:
        context = multiprocessing.get_context("forkserver")
        # the server imports torch and the port's datasets once, so that a
        # worker forked from it starts without importing them (no effect
        # once the server runs)
        context.set_forkserver_preload(["__main__", *_PRELOAD])
    loader = DataLoader(
        dataset,
        batch_sampler=_JaxOrder(idxs, batch_size, shuffle, seed, drop_last, epochs),
        collate_fn=_collate,
        num_workers=num_workers,
        pin_memory=pin_memory,
        multiprocessing_context=context,
    )
    for batch in loader:
        if batch is not None:
            yield batch


def stop_worker_server() -> None:
    """Stop the ``forkserver`` process that :func:`batch_iterator`'s
    workers are forked from, and the resource tracker it started, and wait
    for both to exit. Without this call Python stops them only after the
    program has exited, and the server outlives it for as long as its
    preload (torch's import) still runs. Call it once every iterator with
    workers is closed: the server exits only after its last worker has,
    so this call waits for as long as one still runs. A later
    ``batch_iterator`` with workers starts them again. A no-op when none
    runs."""
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    # the tracker exits once every holder of its pipe has: the server, its
    # workers and this process
    resource_tracker._resource_tracker._stop()


def _tree_map(fn, batch):
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    if isinstance(batch, tuple):
        return tuple(fn(v) for v in batch)
    return fn(batch)


def prefetch_to_device(
    iterator: Iterable[Any],
    size: int = 2,
    device: Optional[Union[str, torch.device]] = None,
) -> Iterator[Any]:
    """Stage batches on the device ``size`` deep. ``device``: ``cuda``
    unless asked otherwise; on the CPU, batches pass through unchanged.

    On the card each leaf is copied from page-locked host memory (pinned
    here if the iterator did not pin it) with ``non_blocking=True`` on a
    side stream, and an event is recorded after the copies. Before a
    batch is yielded the consumer's stream waits on its event, and each
    device tensor ``record_stream``s the consumer's stream, so the
    caching allocator does not hand its memory to the next copy while the
    consumer may still read it. The host tensors are held until then;
    after that, PyTorch's pinned-memory allocator keeps a block from
    reuse until the copies that read it have finished."""
    device = resolve_device(device)
    if device.type != "cuda":
        yield from iterator
        return
    copy_stream = torch.cuda.Stream(device)

    def put(batch):
        host = _tree_map(lambda x: _pinned(torch.as_tensor(x)), batch)
        with torch.cuda.stream(copy_stream):
            staged = _tree_map(lambda t: t.to(device, non_blocking=True), host)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return staged, done, host

    q: "collections.deque[Any]" = collections.deque()
    it = iter(iterator)
    for batch in it:
        q.append(put(batch))
        if len(q) >= size:
            break
    while q:
        staged, done, _host = q.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        _tree_map(lambda t: t.record_stream(consumer), staged)
        nxt = next(it, None)
        if nxt is not None:
            q.append(put(nxt))
        yield staged


def _pinned(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_pinned() else t.pin_memory()
