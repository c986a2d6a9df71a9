"""CUDA-graph capture, the port's counterpart of JAX's ``jit`` and
``lax.scan``: a captured graph replays a whole train step or synthesis
forward with one host call, where the eager form dispatches each of its
thousands of kernels from Python. Used by
``train/gan_trainer.make_multi_step`` and ``make_graphed_synthesize_fn``."""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, TypeVar

import torch

from tpgan_tpu_torch.ops import kernels

T = TypeVar("T")


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
    capture of ``fn()`` in the default global mode, with each of
    ``generators`` registered so its draws advance at every replay. ``out``
    holds the graph's output tensors, rewritten by each ``graph.replay()``;
    ``launches`` the kernel launches of one replay as the wrappers recorded
    them at the capture, which the launch counts leave out
    (``ops.kernels.captured_launches``); a replay adds nothing to them.

    Whatever the capture raises is raised: nothing falls back to eager
    calls."""
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
    with kernels.captured_launches() as launches, torch.cuda.graph(graph):
        out = fn()
    return graph, out, launches
