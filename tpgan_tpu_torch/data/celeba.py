"""CelebA landmark-pretraining data — the port of ``tpgan_tpu/data/celeba.py``
(reference: PretrainDataset, DataAndDataset.py:60-176).

* ``list_landmarks_celeba.txt``: two header lines, then a name and 5
  (x, y) pairs per row (:123-139); the mouth label is the integer
  midpoint of the two mouth corners (``//2``, :142-143);
* images: every ``*.jpg`` under the root (:170-176), decoded by the
  port's JPEG codec (``data/imageio.read_rgb``) to PIL's pixels;
* each image is letterboxed into a fixed square bucket (an
  aspect-preserving resize by PIL's bilinear filter, ``imageio.
  resize_bilinear_u8``, then zero padding), its labels moved by the same
  transform, so shapes are static and batches real.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpgan_tpu_torch.data.imageio import read_rgb, resize_bilinear_u8


def _basename_any_sep(name: str) -> str:
    """Basename across both path separators: the reference's corpus
    carries Windows-style names it splits on '\\' (DataAndDataset.py:77)."""
    return name.replace("\\", "/").rsplit("/", 1)[-1]


def parse_celeba_landmarks(txt_path: str) -> Dict[str, np.ndarray]:
    """label txt -> {image name: float32 (8,) = left eye, right eye, nose,
    mouth (x, y)}. Tolerates CRLF, a BOM, runs of whitespace, float-
    formatted coordinates, names with Windows or unix path prefixes (keyed
    by basename), extra columns after the ten coordinates, and skips rows
    with fewer than eleven fields or unparseable numbers."""
    labels: Dict[str, np.ndarray] = {}
    with open(txt_path, "r", encoding="utf-8-sig") as f:
        lines = f.read().splitlines()
    for line in lines[2:]:
        parts = line.split()
        if len(parts) < 11:
            continue
        name = _basename_any_sep(parts[0])
        try:
            v = [int(float(p)) for p in parts[1:11]]
        except ValueError:
            continue
        mouth = ((v[6] + v[8]) // 2, (v[7] + v[9]) // 2)
        labels[name] = np.asarray([v[0], v[1], v[2], v[3], v[4], v[5], *mouth], np.float32)
    return labels


def find_images(root: str, suffix: str = ".jpg") -> List[str]:
    """Every file under ``root`` whose name ends in ``suffix`` (any
    case), sorted."""
    out = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.lower().endswith(suffix):
                out.append(os.path.join(dirpath, f))
    out.sort()
    return out


def letterbox(image: np.ndarray, size: int, allow_upscale: bool = True
              ) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """Aspect-preserving bilinear resize into a (size, size) zero-padded
    square, as the JAX package does it with PIL: a float image is first
    truncated to uint8 by ``(image * 255).astype(uint8)``, the resized
    uint8 pixels come back as float32 / 255. Returns (out, scale,
    (pad_left, pad_top)); labels transform as ``xy * scale + pad``. With
    ``allow_upscale=False`` a smaller image is only padded."""
    h, w = image.shape[:2]
    scale = size / max(h, w)
    if not allow_upscale:
        scale = min(scale, 1.0)
    nw, nh = max(int(round(w * scale)), 1), max(int(round(h * scale)), 1)
    u8 = image if image.dtype == np.uint8 else (image * 255).astype(np.uint8)
    arr = resize_bilinear_u8(u8, (nw, nh)).astype(np.float32) / 255.0
    out = np.zeros((size, size) + image.shape[2:], np.float32)
    pad_left, pad_top = (size - nw) // 2, (size - nh) // 2
    out[pad_top:pad_top + nh, pad_left:pad_left + nw] = arr
    return out, scale, (pad_left, pad_top)


class CelebALandmarkDataset:
    """Indexable dataset: item = (image (S, S, 3) float32 in [0, 1], label
    (8,) float32 in bucket coordinates), or None for an image over
    ``max_source_size`` on either side (the reference's collate_fn drop,
    Pretrain.py:66-74).

    ``buckets``: ascending sizes; each image goes to the smallest bucket
    that holds it and is only padded there (source-pixel labels), the
    largest bucket downscaling what fits none. Without ``buckets``, every
    image resizes into the ``image_size`` square."""

    def __init__(self, txt_name: str, data_root_dir: str, image_size: int = 256,
                 max_source_size: Optional[int] = None,
                 buckets: Optional[Tuple[int, ...]] = None):
        self.labels = parse_celeba_landmarks(os.path.join(data_root_dir, txt_name))
        all_paths = find_images(data_root_dir)
        # only labelled images: a stray .jpg would otherwise fail mid-epoch
        self.image_paths = [p for p in all_paths if os.path.basename(p) in self.labels]
        dropped = len(all_paths) - len(self.image_paths)
        if dropped:
            print(f"[celeba] {dropped} image(s) without landmark rows skipped")
        self.image_size = image_size
        self.max_source_size = max_source_size
        self.buckets = tuple(sorted(buckets)) if buckets else None

    def __len__(self) -> int:
        return len(self.image_paths)

    def bucket_for(self, h: int, w: int) -> int:
        """The smallest bucket that holds (h, w) without downscaling; the
        largest when none does."""
        side = max(h, w)
        for b in self.buckets:
            if side <= b:
                return b
        return self.buckets[-1]

    def __getitem__(self, idx: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        path = self.image_paths[idx]
        arr = read_rgb(path)
        if self.max_source_size is not None and max(arr.shape[:2]) > self.max_source_size:
            return None
        size = self.bucket_for(*arr.shape[:2]) if self.buckets else self.image_size
        boxed, scale, (pl, pt) = letterbox(arr, size, allow_upscale=not self.buckets)
        label = self.labels[os.path.basename(path)].reshape(4, 2) * scale + np.asarray(
            [pl, pt], np.float32)
        return boxed, label.reshape(8)

    def split(self, train_ratio: float, val_ratio: float, seed: int = 0
              ) -> Tuple[List[int], List[int], List[int]]:
        """A random train / validation / test index split, the test part
        the remainder (Pretrain.py:96-102), by ``RandomState(seed)``."""
        n = len(self)
        n_train, n_val = int(n * train_ratio), int(n * val_ratio)
        perm = np.random.RandomState(seed).permutation(n)
        return (perm[:n_train].tolist(), perm[n_train:n_train + n_val].tolist(),
                perm[n_train + n_val:].tolist())
