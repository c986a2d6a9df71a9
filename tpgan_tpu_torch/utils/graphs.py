"""CUDA-graph capture, the port's counterpart of JAX's ``jit`` and
``lax.scan``: a captured graph replays a whole train step or synthesis
forward with one host call, where the eager form dispatches each of its
thousands of kernels from Python. Used by
``train/gan_trainer.make_multi_step``, and through :func:`graphed_per_shape`
(a graph per input shape) by ``make_graphed_synthesize_fn``,
``data/jit_preprocess.make_synthesis_pipeline`` and
``frontalize.make_graphed_frontalize_fn``."""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Tuple, TypeVar

import torch

from tpgan_tpu_torch.ops import _build, kernels
from tpgan_tpu_torch.utils import trace

T = TypeVar("T")

# Host seconds of every capture in this process (:func:`capture`).
_capture_seconds = 0.0


def capture_seconds() -> float:
    """Host seconds this process has spent in :func:`capture`: the warm-up
    calls and the captures, without the kernel builds they started."""
    return _capture_seconds


def capture(
    fn: Callable[[], T],
    warmup: int,
    reset: Optional[Callable[[], None]] = None,
    generators: Sequence[torch.Generator] = (),
) -> Tuple[torch.cuda.CUDAGraph, T, kernels.CapturedLaunches]:
    """``(graph, out, launches)``: ``fn()`` run ``warmup`` times on a side
    stream, so that what is built or allocated on first use (the kernel
    libraries, K2's scratch, Adam's moments, the ``.grad`` buffers, the
    cuBLAS and cuDNN workspaces) exists before the capture; then
    ``reset()``, which undoes what the warm-up calls changed; then one
    capture of ``fn()`` in thread-local mode, with each of ``generators``
    registered so its draws advance at every replay. Thread-local: the
    capturing thread may make no call that could sync or allocate on the
    card, but other threads may, as the pin-memory thread of a data
    loader feeding the train loop does (``cudaHostAlloc``) while the
    loop's first dispatch captures the step; global mode forbids that. ``out``
    holds the graph's output tensors, rewritten by each ``graph.replay()``;
    ``launches`` the kernel launches of one replay as the wrappers recorded
    them at the capture, which the launch counts leave out
    (``ops.kernels.captured_launches``); a replay adds nothing to them.

    Each capture adds its host seconds, warm-up included and the kernels'
    first builds (``ops._build``) left out, to :func:`capture_seconds`.

    Whatever the capture raises is raised: nothing falls back to eager
    calls."""
    global _capture_seconds
    start, built = time.perf_counter(), _build.build_seconds()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    if reset is not None:
        reset()
    graph = torch.cuda.CUDAGraph()
    for generator in generators:
        graph.register_generator_state(generator)
    with kernels.captured_launches() as launches, \
            torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = fn()
    _capture_seconds += time.perf_counter() - start - (_build.build_seconds() - built)
    return graph, out, launches


def graphed_per_shape(fn: Callable[..., T], device: torch.device, warmup: int = 2
                      ) -> Callable[..., T]:
    """``fn(*tensors)`` as CUDA-graph replays on ``device``, one graph per
    shape and dtype of the arguments: captured by :func:`capture` at the
    first call of each (after ``warmup`` calls, where cuDNN and cuBLAS
    pick their algorithms and workspaces), then each call copies the
    arguments (tensors or numpy arrays) into that graph's buffers,
    replays it and returns copies of its outputs, a tensor or a tuple of
    tensors. A failed capture raises; nothing falls back to eager calls.
    ``graphed.launches()`` is {argument shapes and dtypes: the port's
    kernel launches of one replay} for each captured graph. A call is the
    span ``graph.dispatch`` (``utils.trace``)."""
    captured: Dict[tuple, tuple] = {}

    @torch.inference_mode()
    def graphed(*args):
        with trace.span("graph.dispatch"):
            args = [torch.as_tensor(a) for a in args]
            key = tuple((tuple(a.shape), a.dtype) for a in args)
            if key not in captured:
                static = [a.to(device, copy=True) for a in args]
                graph, out, launches = capture(lambda: fn(*static), warmup)
                captured[key] = (static, graph, out, launches)
            static, graph, out, _launches = captured[key]
            for buf, a in zip(static, args):
                buf.copy_(a, non_blocking=True)
            graph.replay()
            if isinstance(out, tuple):
                return tuple(o.clone() for o in out)
            return out.clone()

    graphed.launches = lambda: {key: launches.per_replay
                                for key, (_s, _g, _o, launches) in captured.items()}
    return graphed
