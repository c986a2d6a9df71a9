"""Input-pipeline benchmark: can the loader feed the card? The port of
``tpgan_tpu/data/bench_loader.py``.

The train step consumes ``batch_size`` items per step (15 tensors each);
the loader must sustain more images/s than the step burns or the card
starves. Four input paths:

* ``files`` — TrainDataset: 15 PNG decodes per item (the reference's
  access pattern, DataAndDataset.py:206-215), float batches;
* ``packed`` — PackedDataset(to_float=False): memory-mapped uint8
  shards, no decode, the batches the train step takes (it decodes on the
  device);
* ``packed+prefetch`` — the same through pinned memory and
  ``prefetch_to_device`` (``non_blocking`` copies on a side stream);
* ``device`` — the whole pack in device memory, batches gathered there
  by index (``load_packed_to_device`` + ``device_batch_iterator``).

Usage::

    python -m tpgan_tpu_torch.data.bench_loader --img-list .../img.list \\
        --packed .../packed --batch-size 64 --batches 10

Prints one JSON line per path: {"path", "imgs_per_sec", "batch_size",
"device"}. Runs on ``cuda`` unless ``--device`` says otherwise; on the
CPU the prefetch passes batches through and "device" means host memory.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Union

import torch

from tpgan_tpu_torch.utils.device import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_iterator(it, batch_size: int, batches: int, device: torch.device,
                   warmup: int = 2) -> float:
    """Pull ``batches`` batches after ``warmup`` and return images/s,
    synchronising the device before each clock read."""
    for _ in range(warmup):
        next(it)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    _sync(device)
    return batches * batch_size / (time.perf_counter() - t0)


def run(img_list: Optional[str], packed: Optional[str], batch_size: int, batches: int = 10,
        num_workers: int = 4, device: Optional[Union[str, torch.device]] = None) -> List[Dict]:
    """Time each path whose input is given; one result dict per path."""
    from tpgan_tpu_torch.data.multipie import TrainDataset
    from tpgan_tpu_torch.data.packing import (
        PackedDataset,
        device_batch_iterator,
        load_packed_to_device,
    )
    from tpgan_tpu_torch.data.pipeline import batch_iterator, prefetch_to_device

    device = resolve_device(device)
    cuda = device.type == "cuda"
    paths = []
    if img_list:
        with open(img_list) as f:
            ds = TrainDataset([l.strip() for l in f if l.strip()])
        paths.append(("files", lambda: batch_iterator(
            ds, batch_size, num_workers=num_workers)))
    if packed:
        pds = PackedDataset(packed, to_float=False)
        paths.append(("packed", lambda: batch_iterator(
            pds, batch_size, num_workers=num_workers)))
        paths.append(("packed+prefetch", lambda: prefetch_to_device(batch_iterator(
            pds, batch_size, num_workers=num_workers, pin_memory=cuda),
            size=2, device=device)))
        paths.append(("device", lambda: device_batch_iterator(
            load_packed_to_device(packed, device), batch_size)))
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    # the batches the workers make while the first one is awaited (two
    # each, DataLoader's prefetch) are drawn before the clock starts
    warmup = 2 + 2 * num_workers
    results = []
    for path, make in paths:
        it = make()
        try:
            rate = bench_iterator(it, batch_size, batches, device, warmup)
        finally:
            it.close()  # stops the path's worker processes
        results.append({"path": path, "imgs_per_sec": rate, "batch_size": batch_size,
                        "device": name})
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--img-list", default=None)
    ap.add_argument("--packed", default=None)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--num-workers", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda unless given (e.g. cpu)")
    args = ap.parse_args(argv)
    from tpgan_tpu_torch.data.pipeline import stop_worker_server

    try:
        for r in run(args.img_list, args.packed, args.batch_size, args.batches,
                     args.num_workers, args.device):
            print(json.dumps(r))
    finally:
        stop_worker_server()  # exit with no worker server left behind
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
