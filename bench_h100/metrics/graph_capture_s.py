"""graph_capture_s: host seconds the program spent warming up and capturing
CUDA graphs, ``tpgan_tpu_torch.utils.graphs.capture_seconds()`` read after
the run, the kernels' first builds (nvcc) left out; every capture of a cell
happens in set-up, so this is the part of ``setup_s`` it moves. None when
the program has no such number or captured nothing."""


def read(run):
    try:
        from tpgan_tpu_torch.utils import graphs
    except ImportError:
        return None
    return getattr(graphs, "capture_seconds", lambda: 0.0)() or None
