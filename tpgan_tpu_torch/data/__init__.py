"""Synthetic batches for the entry point and the smoke run."""
