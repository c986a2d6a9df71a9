"""Scripts of the port that drive one path end to end (run with ``python -m``)."""
