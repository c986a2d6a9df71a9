"""Packed-shard dataset format and device-resident datasets — the port of
``tpgan_tpu/data/packing.py``.

A one-time packing pass serialises a dataset into fixed-shape uint8
shards (4x smaller than float32, no decode); the reader memory-maps the
shards. ``to_float=False`` keeps the uint8 bytes all the way to the
device, where the train step decodes them (``gan_trainer.
decode_u8_batch``); a dataset that fits device memory is loaded there
whole and batches are gathered on the device by index.

Format: ``<out_dir>/shard_<i>_<key>.npy`` (standard .npy, mmap-able) +
``<out_dir>/index.json`` with keys, shapes, dtypes, counts and, when the
source has an ``img_list``, the items' basenames. The same files as the
JAX package's.

The landmark pretraining keeps its whole dataset in device memory too
(:func:`load_pretrain_to_device`): one uint8 image tensor and one label
tensor per bucket shape, batches gathered there by index.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from tpgan_tpu_torch.data import native
from tpgan_tpu_torch.parallel.sharding import shard_rows
from tpgan_tpu_torch.utils import trace
from tpgan_tpu_torch.utils.device import resolve_device

INDEX_NAME = "index.json"


def shard_path(directory: str, shard: int, key: str) -> str:
    return os.path.join(directory, f"shard_{shard}_{key}.npy")


def pack_dataset(dataset, out_dir: str, shard_size: int = 1024) -> None:
    """Serialise an indexable dataset of dict items (float arrays in
    [-1, 1] plus integer 'label') into packed uint8 shards."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(dataset)
    keys = None
    shard_idx = 0
    meta: Dict = {"num_items": n, "shards": [], "keys": {}}
    # record item basenames when the source exposes them: downstream
    # consumers (yaw-weighted sampling) need the Multi-PIE camera token
    # per packed index without re-reading the original img.list
    src_list = getattr(dataset, "img_list", None)
    if src_list is not None and len(src_list) == n:
        meta["names"] = [os.path.basename(p) for p in src_list]

    for start in range(0, n, shard_size):
        items = [dataset[i] for i in range(start, min(start + shard_size, n))]
        if keys is None:
            keys = sorted(items[0].keys())
        for key in keys:
            arrs = np.stack([it[key] for it in items])
            if key == "label":
                data = arrs.astype(np.int32)
            else:
                data = np.clip((arrs + 1.0) * 127.5, 0, 255).astype(np.uint8)
            np.save(shard_path(out_dir, shard_idx, key), data)
            meta["keys"][key] = {
                "shape": list(data.shape[1:]),
                "dtype": str(data.dtype),
            }
        meta["shards"].append(len(items))
        shard_idx += 1

    with open(os.path.join(out_dir, INDEX_NAME), "w") as f:
        json.dump(meta, f)


class PackedDataset:
    """Memory-mapped reader over packed shards; item = the same dict the
    source dataset produced (uint8 converted back to [-1, 1] float32 by
    the host library), or, with ``to_float=False``, the raw uint8 bytes:
    the production input path, whose decode runs on the device inside the
    train step."""

    def __init__(self, directory: str, to_float: bool = True):
        with open(os.path.join(directory, INDEX_NAME)) as f:
            self.meta = json.load(f)
        self.directory = directory
        self.to_float = to_float
        self._mmaps: Dict[int, Dict[str, np.ndarray]] = {}
        self._offsets = np.cumsum([0] + self.meta["shards"])

    def __getstate__(self):
        # data-loader workers reopen the maps rather than receive copies
        state = dict(self.__dict__)
        state["_mmaps"] = {}
        return state

    def __len__(self) -> int:
        return int(self.meta["num_items"])

    @property
    def names(self) -> Optional[List[str]]:
        """Per-item source basenames, when recorded at pack time; else the
        ``img.list`` file next to the packed directory, whose line i is
        item i, when its length matches; else None."""
        if "names" in self.meta:
            return list(self.meta["names"])
        sibling = os.path.join(os.path.dirname(
            os.path.abspath(self.directory)), "img.list")
        if os.path.exists(sibling):
            with open(sibling) as f:
                lines = [l.strip() for l in f if l.strip()]
            if len(lines) == len(self):
                return [os.path.basename(p) for p in lines]
        return None

    def _shard_for(self, idx: int):
        shard = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return shard, idx - int(self._offsets[shard])

    def _maps(self, shard: int) -> Dict[str, np.ndarray]:
        if shard not in self._mmaps:
            self._mmaps[shard] = {
                key: np.load(shard_path(self.directory, shard, key), mmap_mode="r")
                for key in self.meta["keys"]
            }
        return self._mmaps[shard]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        shard, local = self._shard_for(idx)
        maps = self._maps(shard)
        out = {}
        for key, arr in maps.items():
            rec = np.asarray(arr[local])
            if key != "label" and self.to_float:
                rec = native.u8_to_pm1(rec)
            out[key] = rec
        return out


# --------------------------------------------------------------------------
# Device-resident dataset mode
# --------------------------------------------------------------------------

def load_packed_to_device(
    directory: str, device: Optional[Union[str, torch.device]] = None
) -> Dict[str, torch.Tensor]:
    """Load the whole packed dataset into device memory, one uint8 (or
    int32 label) tensor per key, stacked over items. ``device``: ``cuda``
    unless asked otherwise.

    A dataset that fits device memory (the full Multi-PIE-layout GAN
    protocol packs to ~0.4 GB uint8) needs no host input pipeline:
    batches are gathered on the device by index
    (:func:`device_batch_iterator`), and a step copies only the index
    vector to the device."""
    device = resolve_device(device)
    with open(os.path.join(directory, INDEX_NAME)) as f:
        meta = json.load(f)
    out = {}
    for key in meta["keys"]:
        parts = [np.load(shard_path(directory, s, key), mmap_mode="r")
                 for s in range(len(meta["shards"]))]
        # a copy in memory, not a view of the read-only maps
        host = np.concatenate(parts) if len(parts) > 1 else np.array(parts[0])
        out[key] = torch.from_numpy(host).to(device)
    return out


def device_batch_iterator(
    data: Dict[str, torch.Tensor], batch_size: int, seed: int = 0,
    weights: Optional[np.ndarray] = None, shard: Optional[Tuple[int, int]] = None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite iterator over batches gathered on the device by random
    index from a device-resident dataset (:func:`load_packed_to_device`).

    The indices come from ``np.random.RandomState(seed)`` as in the JAX
    package (``randint``, or ``choice`` with ``p``), so both yield the
    same batches for the same seed; per step the host ships only the
    index vector. Sampling is with replacement (the i.i.d. regime the
    WGAN-GP critic assumes).

    ``weights`` (len == dataset size, any positive scale) biases the
    sampling distribution — yaw-weighted sampling oversamples
    extreme-pose items (``train.yaw_weight_gamma``).

    ``shard`` = (r, n) (a mesh's ``data_shard``): every rank draws the same
    global indices and gathers only its rows ``[r * b, (r + 1) * b)`` of
    them, ``batch_size`` being the global batch.

    Drawing and gathering a batch is the span ``data.sample``, and the
    index vector's copy to the device inside it ``data.index_copy``
    (``utils.trace``)."""
    first = next(iter(data.values()))
    n, device = int(first.shape[0]), first.device
    rng = np.random.RandomState(seed)
    p = None
    if weights is not None:
        p = np.asarray(weights, np.float64)
        if p.shape != (n,):
            raise ValueError(f"weights shape {p.shape} != ({n},)")
        if (p < 0).any() or p.sum() <= 0:
            raise ValueError("weights must be non-negative with a "
                             "positive sum")
        p = p / p.sum()

    # a function, so that the generator's frame does not hold the batch it
    # yielded (device memory) until the next one is drawn
    def sample() -> Dict[str, torch.Tensor]:
        with trace.span("data.sample"):
            if p is None:
                idx = rng.randint(0, n, size=(batch_size,))
            else:
                idx = rng.choice(n, size=(batch_size,), p=p)
            if shard is not None:
                idx = shard_rows(idx, shard)
            with trace.span("data.index_copy"):
                idx = torch.from_numpy(idx.astype(np.int64)).to(device)
            return {k: v.index_select(0, idx) for k, v in data.items()}

    while True:
        yield sample()


# --------------------------------------------------------------------------
# Device-resident landmark pretraining data
# --------------------------------------------------------------------------

Groups = Dict[tuple, Dict[str, torch.Tensor]]


def load_pretrain_to_device(dataset, indices,
                            device: Optional[Union[str, torch.device]] = None) -> Groups:
    """Decode every item of ``indices`` once on the host
    (``CelebALandmarkDataset`` items: ``(image, label)``; None is the
    oversize drop), group them by image shape, and put each group on the
    device once: ``{shape: {"img": uint8 (n, H, W, 3), "label": float32
    (n, 8)}}``, shapes in sorted order. A float image becomes uint8 as
    the JAX package makes it, ``clip(img * 255, 0, 255)`` truncated.
    ``device``: ``cuda`` unless asked otherwise."""
    device = resolve_device(device)
    groups: Dict[tuple, list] = {}
    for i in indices:
        item = dataset[i]
        if item is None:
            continue
        img, lbl = item
        if img.dtype != np.uint8:
            img = np.clip(img * 255.0, 0.0, 255.0).astype(np.uint8)
        groups.setdefault(img.shape, []).append((img, np.asarray(lbl, np.float32)))
    out: Groups = {}
    for key in sorted(groups):
        imgs, lbls = zip(*groups[key])
        out[key] = {"img": torch.from_numpy(np.stack(imgs)).to(device),
                    "label": torch.from_numpy(np.stack(lbls)).to(device)}
    return out


def pixel_budget_batches(groups: Groups, batch_size: int) -> Dict[tuple, int]:
    """Per-bucket batch sizes that hold the pixels per step constant:
    ``batch_size`` at the smallest bucket, larger buckets scaled down by
    area (at least 1)."""
    if not groups:
        return {}
    min_area = min(k[0] * k[1] for k in groups)
    return {k: max(1, int(batch_size * min_area / (k[0] * k[1]))) for k in groups}


def _take(group: Dict[str, torch.Tensor], idx: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    with trace.span("data.index_copy"):
        idx_t = torch.from_numpy(idx.astype(np.int64)).to(group["img"].device)
    return group["img"].index_select(0, idx_t), group["label"].index_select(0, idx_t)


def device_bucketed_batch_iterator(
    groups: Groups, batch_size: int, seed: int = 0,
    batch_for: Optional[Dict[tuple, int]] = None,
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Endless training batches from :func:`load_pretrain_to_device`'s
    buckets: each step picks a bucket with probability proportional to
    the steps it needs per epoch (items / its batch size), then draws a
    batch with replacement and gathers it on the device. The picks come
    from ``np.random.RandomState(seed)`` (``choice``, then ``randint``) as
    in the JAX package, so both take the same items for the same seed;
    only the index vector crosses to the device. ``batch_for``: the batch
    size per bucket (:func:`pixel_budget_batches`). The spans are
    :func:`device_batch_iterator`'s."""
    keys = sorted(groups)
    bs = {k: (batch_for or {}).get(k, batch_size) for k in keys}
    steps = np.asarray([int(groups[k]["img"].shape[0]) / bs[k] for k in keys], np.float64)
    probs = steps / steps.sum()
    rng = np.random.RandomState(seed)

    def sample() -> Tuple[torch.Tensor, torch.Tensor]:  # as device_batch_iterator's
        with trace.span("data.sample"):
            k = keys[int(rng.choice(len(keys), p=probs))]
            return _take(groups[k], rng.randint(0, int(groups[k]["img"].shape[0]), size=(bs[k],)))

    while True:
        yield sample()


def device_bucketed_eval_batches(
    groups: Groups, batch_size: int, batch_for: Optional[Dict[tuple, int]] = None,
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """One pass over every item of every bucket in order (validation);
    each bucket's last batch may be short."""
    for k in sorted(groups):
        n = int(groups[k]["img"].shape[0])
        b_k = (batch_for or {}).get(k, batch_size)
        for start in range(0, n, b_k):
            yield _take(groups[k], np.arange(start, min(start + b_k, n)))
