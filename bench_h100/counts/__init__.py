"""The yardstick's counts: FLOPs from layer shapes, kernel byte bounds, the chip's peaks."""
