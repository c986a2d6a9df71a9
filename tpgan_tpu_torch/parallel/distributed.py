"""Multi-process initialisation — the port of
``tpgan_tpu/parallel/distributed.py`` over ``torch.distributed``.

One process per rank; ``parallel.mesh.make_mesh`` lays the ranks out on
the (data, model) mesh and makes each axis's process group. :func:`maybe_initialize` is called once per
process before the models are built. On the card the group is NCCL, one
rank per card (``LOCAL_RANK`` picks the card, so ``utils.device``'s
``"cuda"`` is the rank's own); the caller may ask for gloo, which also
takes CUDA tensors (staged through the host) and is the group of CPU
runs.

Where JAX's ``maybe_initialize`` swallows any error of its initialisation
and returns False (a silent single-process run), this one raises: a rank
that was asked to join a group and cannot does not train alone.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# torchrun's environment; all three present means a launcher started us
CLUSTER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def maybe_initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: Optional[str] = None,
    device_index: Optional[int] = None,
    timeout_s: Optional[float] = None,
) -> bool:
    """Join the process group when running multi-process; True when one
    is active.

    With no arguments it initialises only when torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``) is present and is a no-op
    returning False otherwise, so entry points call it unconditionally.
    ``coordinator_address`` (``host:port``, rank 0's), ``num_processes``
    and ``process_id`` start a group without that environment.

    ``backend``: ``nccl`` unless ``device="cpu"`` (then ``gloo``); gloo on
    the card is asked for by name. On the card the rank's device is set
    to ``device_index``, else ``LOCAL_RANK``, else 0. Any failure raises:
    no rank carries on alone."""
    if dist.is_initialized():
        return True
    env_driven = all(v in os.environ for v in CLUSTER_ENV)
    if coordinator_address is None and not env_driven:
        return False
    on_cpu = device is not None and torch.device(device).type == "cpu"
    backend = backend or ("gloo" if on_cpu else "nccl")
    if not on_cpu:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"maybe_initialize: backend {backend} on the card, but no CUDA device is "
                "available; pass device='cpu' for a gloo group on the CPU")
        index = device_index if device_index is not None else int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(index)
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is None:
        dist.init_process_group(backend, **kwargs)  # env:// from torchrun
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator_address needs num_processes and process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id), **kwargs)
    return True


def process_count() -> int:
    """The number of ranks: the world's size, 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank, 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """True on rank 0, the one that writes checkpoints, metrics and
    samples."""
    return process_index() == 0


def process_batch_slice(global_batch: int) -> int:
    """Per-process batch size for a host-sharded input pipeline; raises
    ``ValueError`` when the processes do not divide the batch."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n


def barrier(group=None) -> None:
    """Wait for every rank of ``group`` (the world by default); a no-op
    without a process group."""
    if not dist.is_initialized():
        return
    if dist.get_backend(group) == "nccl":
        dist.barrier(group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group)


def shutdown() -> None:
    """Leave the process group, if one is active."""
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port on 127.0.0.1 that no process listens on now, for a
    ``coordinator_address``."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]



def _rank_main(fn, rank: int, n: int, port: int, backend: str, device: str,
               timeout_s: float, args: tuple, results) -> None:
    """One spawned rank: join the group on 127.0.0.1:``port``, run
    ``fn(rank, *args)``, put ``(rank, "ok", result)`` or ``(rank,
    "error", traceback)`` on ``results``, leave the group."""
    import traceback

    try:
        on_card = torch.device(device).type == "cuda"
        # NCCL: one card per rank; gloo on the card: the ranks share the cards
        index = (rank if backend == "nccl" else rank % torch.cuda.device_count()) if on_card \
            else None
        maybe_initialize(f"127.0.0.1:{port}", n, rank, backend=backend, device=device,
                         device_index=index, timeout_s=timeout_s)
        results.put((rank, "ok", fn(rank, *args)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        shutdown()


def spawn(fn, n: int, *, backend: str, device: str, args: tuple = (),
          timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` in ``n`` fresh processes (``spawn``), one
    rank each of a ``backend`` group on ``device`` (``cuda`` or ``cpu``),
    and return their results by rank. ``fn`` is found by its import path
    and its result is pickled. NCCL takes one card per rank and raises
    when there are fewer; gloo on the card puts the ranks on the cards in
    turn. Any rank that raises, exits without a result or outlasts
    ``timeout_s`` raises here with its traceback; every process is gone
    when this returns."""
    import multiprocessing
    import queue
    import time

    if backend == "nccl" and (torch.device(device).type != "cuda"
                              or n > torch.cuda.device_count()):
        raise ValueError(f"NCCL takes one card per rank: {n} ranks on {device} with "
                         f"{torch.cuda.device_count()} cards; ask for gloo by name")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, n, port, backend, device, timeout_s,
                                                  args, results)) for r in range(n)]
    for p in procs:
        p.start()
    got: dict = {}
    errors = []
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < n:  # drained before the joins
            try:
                rank, status, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    errors.append(f"rank(s) {dead} exited with {[procs[r].exitcode for r in dead]}"
                                  " and no result")
                    break
                if time.monotonic() > deadline:
                    errors.append(f"ranks outlasted {timeout_s} s")
                    break
                continue
            if status != "ok":  # the others may wait for it in a collective: stop them
                errors.append(f"rank {rank}:\n{value}")
                break
            got[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 30.0) if not errors else 10.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    bad = [f"rank {r} exit code {p.exitcode}" for r, p in enumerate(procs) if p.exitcode != 0]
    if errors or bad:
        raise RuntimeError("spawned ranks failed: " + "; ".join(bad) + "\n" + "\n".join(errors))
    return [got[r] for r in range(n)]
