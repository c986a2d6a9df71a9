"""Multi-PIE-style GAN train/test data — the port of
``tpgan_tpu/data/multipie.py`` (reference: TrainDataset/TestDataset,
DataAndDataset.py:179-256), with files read by :mod:`.imageio` in place
of PIL.

File-naming protocol preserved:
* the frontal twin of an image path is derived by replacing the
  ``_``-separated token[-2] with '051' (the frontal camera; :203-205);
* per item, 15 tensors load from sibling directories: the image itself,
  ``32x32/`` and ``64x64/`` downsampled copies, and ``patch/<part>/``
  crops — for both the profile and its frontal twin (:206-215);
* values normalise to [-1, 1] via ``t*2-1`` (:218-220);
* the subject label is ``int(filename.split('_')[0])`` (:226).

Outputs are NHWC float32 numpy dicts whose keys match the train step's
batch contract (``train.gan_trainer.example_batch``).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from tpgan_tpu_torch.data import native
from tpgan_tpu_torch.data.imageio import read_rgb, resize_lanczos_u8
from tpgan_tpu_torch.data.patches import PATCH_SIZES, crop_patches
from tpgan_tpu_torch.utils.misc import five_landmarks_from_68

PART_NAMES = tuple(PATCH_SIZES.keys())


# Real Multi-PIE camera labels carry an underscore ("05_1" is the
# frontal camera); the reference's protocol flattens them to one token
# ("051", DataAndDataset.py:203-205). Both spellings appear in the wild
# — recordings distributed as <subject>_<session>_<recording>_<cc>_<r>_
# <frame>.png keep the pair form — so the parsers accept either.
MULTIPIE_CAMERA_PAIRS = frozenset(
    f"{cc:02d}_{r}" for cc, r in (
        (11, 0), (12, 0), (9, 0), (8, 0), (13, 0), (14, 0), (5, 1),
        (5, 0), (4, 1), (19, 1), (20, 0), (1, 0), (24, 0), (8, 1),
        (19, 0),
    )
)


def camera_token(name: str) -> str:
    """Flattened camera token of a Multi-PIE-style filename: '051' for
    both ``001_01_051_00.png`` (flattened protocol) and
    ``001_01_01_05_1_00.png`` (real pair-form labels)."""
    parts = os.path.basename(name).split("_")
    if len(parts) >= 3 and "_".join(parts[-3:-1]) in MULTIPIE_CAMERA_PAIRS:
        return parts[-3] + parts[-2]
    return parts[-2] if len(parts) >= 2 else ""


def frontal_twin_path(path: str) -> str:
    """Replace the camera token with the frontal camera
    (DataAndDataset.py:203-205): '051' in the flattened protocol,
    '05_1' when the filename uses real pair-form camera labels."""
    parts = path.split("_")
    if len(parts) >= 3 and "_".join(parts[-3:-1]) in MULTIPIE_CAMERA_PAIRS:
        return "_".join(parts[:-3] + ["05", "1", parts[-1]])
    if len(parts) < 2:
        return path
    parts[-2] = "051"
    return "_".join(parts)


def _sibling(path: str, subdir: List[str]) -> str:
    """path .../<split>/<name> -> .../<subdir...>/<name> (two levels up,
    mirroring the reference's list-slicing on '/', :207-215)."""
    comps = path.split("/")
    return "/".join(comps[:-2] + subdir + [comps[-1]])


def _norm(x: np.ndarray) -> np.ndarray:
    return x * 2.0 - 1.0


def _label(path: str) -> np.ndarray:
    return np.asarray(int(os.path.basename(path).split("_")[0]), np.int32)


class TrainDataset:
    """item = dict with the 15-tensor contract + 'label' (int)."""

    def __init__(self, img_list: List[str]):
        self.img_list = list(img_list)

    def __len__(self) -> int:
        return len(self.img_list)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        path = self.img_list[idx]
        frontal = frontal_twin_path(path)
        batch: Dict[str, np.ndarray] = {}
        to_pm1 = native.u8_to_pm1
        for key, p in (("", path), ("_frontal", frontal)):
            batch["img" + key] = to_pm1(read_rgb(p))
            batch["img32" + key] = to_pm1(read_rgb(_sibling(p, ["32x32"])))
            batch["img64" + key] = to_pm1(read_rgb(_sibling(p, ["64x64"])))
            for part in PART_NAMES:
                batch[part + key] = to_pm1(read_rgb(_sibling(p, ["patch", part])))
        batch["label"] = _label(path)
        return batch


class IdentityImageDataset:
    """Identity-classification data for the feature-extract embedder:
    items are (image in [-1, 1], subject label) tuples over any
    Multi-PIE-named image tree — the label protocol is the TrainDataset
    one, ``int(filename.split('_')[0])`` (DataAndDataset.py:226)."""

    def __init__(self, img_list: List[str]):
        self.img_list = list(img_list)

    def __len__(self) -> int:
        return len(self.img_list)

    def __getitem__(self, idx: int):
        path = self.img_list[idx]
        return native.u8_to_pm1(read_rgb(path)), _label(path)


class TestDataset:
    """Inference-time preprocessing (DataAndDataset.py:230-256): raw image
    + a 68-point landmark string -> 128x128 image, 64/32 downsamples, and
    the four patches, all in [-1, 1]."""

    __test__ = False  # not a pytest class despite the Test* name

    def __init__(self, img_list: List[str], lm_list: List[str]):
        if len(img_list) != len(lm_list):
            raise ValueError(f"{len(img_list)} images but {len(lm_list)} landmark strings")
        self.img_list = list(img_list)
        self.lm_list = list(lm_list)

    def __len__(self) -> int:
        return len(self.img_list)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        im = read_rgb(self.img_list[idx])
        height, width = im.shape[:2]
        # whitespace-split (not single-space): real landmark files may
        # carry runs of spaces, tabs, or CRLF tails
        lm = np.asarray(self.lm_list[idx].split(), np.float32).reshape(-1, 2)
        lm5 = five_landmarks_from_68(lm)
        lm5[:, 0] *= 128.0 / width
        lm5[:, 1] *= 128.0 / height
        img128 = resize_lanczos_u8(im, (128, 128))
        img64 = resize_lanczos_u8(img128, (64, 64))
        img32 = resize_lanczos_u8(img64, (32, 32))

        arr128 = np.asarray(img128, np.float32) / 255.0
        batch = {name: _norm(p) for name, p in crop_patches(arr128, lm5).items()}
        batch["img"] = _norm(arr128)
        batch["img64"] = _norm(np.asarray(img64, np.float32) / 255.0)
        batch["img32"] = _norm(np.asarray(img32, np.float32) / 255.0)
        return batch
