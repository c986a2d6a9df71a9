"""Drivers, one per kind of traffic; run.py loads them by file."""
