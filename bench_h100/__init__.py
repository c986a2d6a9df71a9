"""The port's benchmark on an NVIDIA GPU: see run.py."""
