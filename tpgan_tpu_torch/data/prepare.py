"""Dataset preparation: build the Multi-PIE training layout — the port of
``tpgan_tpu/data/prepare.py``, with PIL's LANCZOS resize and PNG writer
replaced by :mod:`.imageio` (the same pixels).

The reference's TrainDataset assumes precomputed sibling directories —
``32x32/``, ``64x64/`` and ``patch/<part>/`` copies of every image
(DataAndDataset.py:206-215) — but ships no tool that creates them. This
module builds the full layout from raw images + 68-point landmarks using
the same preprocessing as TestDataset (DataAndDataset.py:238-256):
resize to 128 (LANCZOS), 64 and 32 pyramids, and the landmark-centred
patch crops.

Layout produced under ``out_root`` (matching the reference's
path-derivation exactly):

    out_root/train/<name>          128x128 image
    out_root/32x32/<name>          32x32
    out_root/64x64/<name>          64x64
    out_root/patch/left_eye/<name> 40x40 crop   (and right_eye/nose/mouth)

plus ``out_root/img.list`` listing the non-frontal images (camera token
!= '051').
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

from tpgan_tpu_torch.data.imageio import read_rgb, resize_lanczos_u8, write_png
from tpgan_tpu_torch.data.patches import PATCH_SIZES, crop_patches
from tpgan_tpu_torch.utils.misc import five_landmarks_from_68


def prepare_image(
    image_path: str,
    landmarks68: np.ndarray,
    out_root: str,
    split: str = "train",
) -> str:
    """Process one image into the layout; returns the written main path."""
    name = os.path.basename(image_path)
    im = read_rgb(image_path)
    height, width = im.shape[:2]
    lm5 = five_landmarks_from_68(np.asarray(landmarks68, np.float32))
    lm5[:, 0] *= 128.0 / width
    lm5[:, 1] *= 128.0 / height
    img128 = resize_lanczos_u8(im, (128, 128))
    img64 = resize_lanczos_u8(img128, (64, 64))
    img32 = resize_lanczos_u8(img64, (32, 32))

    main_dir = os.path.join(out_root, split)
    for d in [main_dir, os.path.join(out_root, "32x32"),
              os.path.join(out_root, "64x64")] + [
        os.path.join(out_root, "patch", part) for part in PATCH_SIZES
    ]:
        os.makedirs(d, exist_ok=True)

    main_path = os.path.join(main_dir, name)
    write_png(main_path, img128)
    write_png(os.path.join(out_root, "32x32", name), img32)
    write_png(os.path.join(out_root, "64x64", name), img64)

    # the JAX module's float round trip: crops of u8 / 255, then
    # clip(patch * 255).astype(uint8), which truncates
    arr128 = np.asarray(img128, np.float32) / 255.0
    for part, patch in crop_patches(arr128, lm5).items():
        write_png(os.path.join(out_root, "patch", part, name),
                  np.clip(patch * 255.0, 0, 255).astype(np.uint8))
    return main_path


def is_frontal(path: str) -> bool:
    """Camera token '051' marks the frontal view
    (DataAndDataset.py:203-205)."""
    parts = os.path.basename(path).split("_")
    return len(parts) >= 2 and parts[-2] == "051"


def prepare_dataset(
    image_paths: Sequence[str],
    landmark_strings: Sequence[str],
    out_root: str,
    split: str = "train",
    write_img_list: bool = True,
) -> List[str]:
    """Build the full layout for a list of (image, 68-pt landmark string)
    pairs. Returns the training list (non-frontal images)."""
    if len(image_paths) != len(landmark_strings):
        raise ValueError(f"{len(image_paths)} images but {len(landmark_strings)} "
                         "landmark strings")
    train_list: List[str] = []
    for path, lm_str in zip(image_paths, landmark_strings):
        lm68 = np.asarray(lm_str.split(), np.float32).reshape(-1, 2)
        written = prepare_image(path, lm68, out_root, split)
        if not is_frontal(written):
            train_list.append(written)
    if write_img_list:
        with open(os.path.join(out_root, "img.list"), "w") as f:
            f.write("\n".join(train_list) + ("\n" if train_list else ""))
    return train_list
