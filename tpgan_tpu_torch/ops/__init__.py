"""Layers, initializers, part geometry and the hand-written CUDA kernels
(``kernels``, built by ``_build`` from ``../csrc``)."""
