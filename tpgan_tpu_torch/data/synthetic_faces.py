"""Procedural synthetic-face protocol — the port of
``tpgan_tpu/data/synthetic_faces.py``: learnable stand-in data for the
Multi-PIE corpus (which cannot ship with the repo), numpy-identical to
the JAX package's for the same subject and yaw.

It renders deterministic cartoon faces with:

* a per-subject identity (skin/hair/eye colours, face geometry) derived
  from the integer subject id — so an identity classifier has real
  classes to learn;
* a yaw pose axis with a crude 3-D projection (features carry a depth
  coordinate; ``x' = x cos(yaw) + z sin(yaw)``) — so profile -> frontal
  is a deterministic, learnable mapping with an exact frontal ground
  truth;
* analytically known 5-point landmarks (eye centres, nose tip, mouth
  corners).

``generate_gan_protocol`` writes the Multi-PIE layout through
``data.prepare`` (``<subject>_01_<camera>_00.png``; camera '051' =
frontal, the reference's twin derivation at DataAndDataset.py:203-205),
with PNGs written by ``data.imageio``. ``generate_pretrain_protocol``
writes the CelebA layout the landmark detector trains on: JPEGs coded by
``data.imageio.write_jpeg`` as PIL codes them, and the landmark txt.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpgan_tpu_torch.data.imageio import write_jpeg, write_png

# camera-token -> yaw degrees. '051' is the frontal camera (the token the
# reference swaps in to find the frontal twin, DataAndDataset.py:203-205);
# the rest follow Multi-PIE's naming style with our own yaw assignment.
CAMERA_YAWS: Dict[str, float] = {
    "110": -60.0,
    "120": -45.0,
    "090": -30.0,
    "080": -15.0,
    "051": 0.0,
    "130": 15.0,
    "140": 30.0,
    "010": 45.0,
    "200": 60.0,
}

# Extreme-pose extension (Multi-PIE's full camera ring reaches +/-90;
# the TP-GAN paper evaluates those bins too). Not part of the default
# 9-camera protocol: the round-2/3 campaigns and their committed
# artifacts were generated from CAMERA_YAWS, and changing that set would
# silently change every "same recipe" retrain. Used by the harder
# identity-evaluation protocol (VERDICT r3 item 5) where Rank-1 needs
# headroom below 1.0 to discriminate.
EXTREME_CAMERA_YAWS: Dict[str, float] = {
    "240": -90.0,
    "191": -75.0,
    "041": 75.0,
    "020": 90.0,
}

ALL_CAMERA_YAWS: Dict[str, float] = {**CAMERA_YAWS, **EXTREME_CAMERA_YAWS}


def identity_params(subject: int) -> Dict[str, np.ndarray]:
    """Deterministic per-subject appearance/geometry parameters."""
    rng = np.random.RandomState(subject * 9973 + 11)
    u = rng.uniform

    skin = np.asarray(
        [0.78 + u(0, 0.17), 0.55 + u(0, 0.2), 0.42 + u(0, 0.2)], np.float32
    )
    hair = np.asarray([u(0.05, 0.55), u(0.05, 0.45), u(0.05, 0.4)], np.float32)
    iris = np.asarray([u(0.1, 0.5), u(0.2, 0.6), u(0.3, 0.8)], np.float32)
    lips = np.asarray([0.6 + u(0, 0.3), 0.25 + u(0, 0.15), 0.25 + u(0, 0.15)],
                      np.float32)
    bg = np.float32(0.12 + u(0, 0.12))
    return {
        "skin": skin, "hair": hair, "iris": iris, "lips": lips, "bg": bg,
        # geometry in canonical face units (face spans roughly [-1, 1])
        "face_rx": np.float32(u(0.30, 0.36)),   # x half-axis, in units of S
        "face_ry": np.float32(u(0.40, 0.46)),   # y half-axis
        "depth": np.float32(u(0.55, 0.75)),      # head depth / face_rx
        "eye_dx": np.float32(u(0.38, 0.50)),     # lateral eye offset
        "eye_y": np.float32(u(-0.30, -0.18)),
        "eye_r": np.float32(u(0.11, 0.15)),
        "brow_y": np.float32(u(-0.50, -0.42)),
        "nose_y": np.float32(u(0.10, 0.20)),
        "nose_w": np.float32(u(0.10, 0.16)),
        "nose_len": np.float32(u(0.22, 0.32)),
        "mouth_y": np.float32(u(0.48, 0.60)),
        "mouth_w": np.float32(u(0.28, 0.42)),
        "mouth_h": np.float32(u(0.07, 0.12)),
        "hair_top": np.float32(u(0.25, 0.45)),   # hair cap thickness
    }


def _ellipse_mask(xx, yy, cx, cy, rx, ry):
    """Soft-edged (~1.5 px) ellipse alpha mask."""
    rx = max(float(rx), 1e-3)
    ry = max(float(ry), 1e-3)
    d = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2
    # |grad d| at the boundary ~ 2 / min(rx, ry) per pixel
    edge = 0.75 * min(rx, ry)
    return np.clip(0.5 + (1.0 - d) * edge, 0.0, 1.0)


def _blend(canvas, mask, color):
    return canvas * (1.0 - mask[..., None]) + mask[..., None] * np.asarray(
        color, np.float32
    )


def render_face(
    subject: int, yaw_deg: float, size: int = 128
) -> Tuple[np.ndarray, np.ndarray]:
    """Render one face. Returns (uint8 (size, size, 3) image,
    float32 (5, 2) landmarks = left eye, right eye, nose tip, left mouth
    corner, right mouth corner — in PIXEL (x, y) coordinates, image-left
    first, matching the LocalFuser slot convention D_and_G_model.py:148).
    """
    p = identity_params(subject)
    yaw = np.deg2rad(yaw_deg)
    cy_, sy_ = float(np.cos(yaw)), float(np.sin(yaw))

    S = float(size)
    cx, cy = S / 2.0, S * 0.52
    fx = float(p["face_rx"]) * S          # face x half-axis, pixels
    fy = float(p["face_ry"]) * S
    depth = float(p["depth"])

    def project(x: float, y: float, z: float) -> Tuple[float, float]:
        """Canonical face coords (x lateral, y down, z out of the face,
        all in face units) -> pixel coords under the yaw rotation."""
        xr = x * cy_ + z * sy_
        return cx + xr * fx, cy + y * fy

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    canvas = np.full((size, size, 3), float(p["bg"]), np.float32)

    # head silhouette: ellipsoid with depth radius ``depth * fx`` — its
    # x half-axis under yaw is fx * sqrt(cos^2 + depth^2 sin^2)
    head_rx = fx * float(np.sqrt(cy_ ** 2 + (depth * sy_) ** 2))
    # hair cap: a slightly larger ellipse behind the head, upper part
    hair_m = _ellipse_mask(xx, yy, cx, cy - 0.06 * fy, head_rx * 1.12, fy * 1.1)
    hair_m = hair_m * (yy < cy - (1.0 - 2.0 * float(p["hair_top"])) * fy)
    canvas = _blend(canvas, hair_m, p["hair"])
    head_m = _ellipse_mask(xx, yy, cx, cy, head_rx, fy)
    canvas = _blend(canvas, head_m, p["skin"])
    # hair fringe on top of the forehead
    fringe = _ellipse_mask(
        xx, yy, cx + 0.1 * sy_ * fx, cy - 0.78 * fy, head_rx * 0.98, fy * 0.38
    )
    canvas = _blend(canvas, fringe * head_m, p["hair"])

    eye_dx, eye_y = float(p["eye_dx"]), float(p["eye_y"])
    eye_r = float(p["eye_r"])
    z_eye = 0.25
    # feature foreshortening: lateral extents scale with cos(yaw)
    fsc = abs(cy_)

    lm: List[Tuple[float, float]] = []
    for side in (-1.0, 1.0):  # -1 = image-left eye
        ex, ey = project(side * eye_dx, eye_y, z_eye)
        rx = eye_r * fx * fsc
        ry = eye_r * fy * 0.75
        white = _ellipse_mask(xx, yy, ex, ey, rx, ry)
        canvas = _blend(canvas, white, (0.95, 0.95, 0.95))
        canvas = _blend(
            canvas, _ellipse_mask(xx, yy, ex, ey, rx * 0.55, ry * 0.8), p["iris"]
        )
        canvas = _blend(
            canvas, _ellipse_mask(xx, yy, ex, ey, rx * 0.25, ry * 0.4),
            (0.05, 0.05, 0.05),
        )
        # brow
        bx, by = project(side * eye_dx, float(p["brow_y"]), z_eye)
        brow = _ellipse_mask(xx, yy, bx, by, rx * 1.3, ry * 0.35)
        canvas = _blend(canvas, brow, p["hair"] * 0.7)
        lm.append((ex, ey))

    # nose: bridge + tip (the tip carries the most depth -> moves most)
    nose_y, nose_w = float(p["nose_y"]), float(p["nose_w"])
    z_nose = 0.9
    tx, ty = project(0.0, nose_y, z_nose)
    bx0, by0 = project(0.0, nose_y - float(p["nose_len"]), 0.45)
    nsteps = 5
    for t in np.linspace(0.0, 1.0, nsteps):
        px = bx0 + (tx - bx0) * t
        py = by0 + (ty - by0) * t
        w = nose_w * fx * fsc * (0.45 + 0.55 * t)
        shade = p["skin"] * (0.88 - 0.08 * t)
        canvas = _blend(
            canvas, _ellipse_mask(xx, yy, px, py, w, 0.05 * fy + 0.02 * fy * t),
            shade,
        )
    # nostrils
    for side in (-1.0, 1.0):
        nx, ny = project(side * nose_w * 0.8, nose_y + 0.03, 0.7)
        canvas = _blend(
            canvas,
            _ellipse_mask(xx, yy, nx, ny, 0.025 * fx * fsc + 0.5, 0.018 * fy + 0.5),
            p["skin"] * 0.45,
        )
    nose_lm = (tx, ty)

    # mouth
    mouth_y, mouth_w = float(p["mouth_y"]), float(p["mouth_w"])
    z_mouth = 0.45
    mx, my = project(0.0, mouth_y, z_mouth)
    mrx = mouth_w * fx * fsc
    mry = float(p["mouth_h"]) * fy
    canvas = _blend(canvas, _ellipse_mask(xx, yy, mx, my, mrx, mry), p["lips"])
    canvas = _blend(
        canvas, _ellipse_mask(xx, yy, mx, my, mrx * 0.85, mry * 0.25),
        p["lips"] * 0.55,
    )
    lmx, lmy = project(-mouth_w, mouth_y, z_mouth * 0.8)
    rmx, rmy = project(+mouth_w, mouth_y, z_mouth * 0.8)

    img = np.clip(canvas * 255.0, 0, 255).astype(np.uint8)
    landmarks = np.asarray(
        [lm[0], lm[1], nose_lm, (lmx, lmy), (rmx, rmy)], np.float32
    )
    return img, landmarks


def landmarks68_string(lm5: np.ndarray) -> str:
    """Expand 5 landmarks into a 68-point line compatible with
    ``five_landmarks_from_68`` (mean over dlib ranges, the reference's
    UtilityMethods.py:148 quirk included): ranges 36-41 / 42-47 / 27-35
    are filled with the eye/nose points, 48 and 54 with the mouth
    corners; everything else gets the nose point (harmless filler)."""
    pts = np.tile(lm5[2], (68, 1)).astype(np.float32)
    pts[36:42] = lm5[0]
    pts[42:48] = lm5[1]
    pts[27:36] = lm5[2]
    pts[48] = lm5[3]
    pts[54] = lm5[4]
    return " ".join(f"{v:.2f}" for v in pts.reshape(-1))


def generate_gan_protocol(
    out_root: str,
    num_subjects: int,
    cameras: Optional[Sequence[str]] = None,
    render_size: int = 144,
    start_subject: int = 0,
) -> List[str]:
    """Render subjects x cameras, write the raw images + 68-pt landmark
    strings, and build the full Multi-PIE training layout through
    ``data.prepare.prepare_dataset`` (128 images, 32/64 pyramids,
    landmark patches, img.list). Returns the training list."""
    from tpgan_tpu_torch.data.prepare import prepare_dataset

    cameras = list(cameras) if cameras is not None else list(CAMERA_YAWS)
    raw_dir = os.path.join(out_root, "raw")
    os.makedirs(raw_dir, exist_ok=True)
    paths: List[str] = []
    lm_strings: List[str] = []
    for s in range(start_subject, start_subject + num_subjects):
        for cam in cameras:
            img, lm5 = render_face(s, ALL_CAMERA_YAWS[cam], render_size)
            name = f"{s:03d}_01_{cam}_00.png"
            path = os.path.join(raw_dir, name)
            write_png(path, img)
            paths.append(path)
            lm_strings.append(landmarks68_string(lm5))
    return prepare_dataset(paths, lm_strings, out_root)


def generate_pretrain_protocol(
    out_root: str,
    num_images: int,
    sizes: Tuple[int, int] = (160, 320),
    num_subjects: int = 512,
    seed: int = 0,
) -> str:
    """Render a CelebA-layout corpus: ``img/NNNNNN.jpg`` (quality 92) and
    ``list_landmarks_celeba.txt`` (2 header lines, then a name and 10
    integer coordinates per row: left eye, right eye, nose, left and right
    mouth corner, as ``celeba.parse_celeba_landmarks`` reads them). Each
    image draws a subject, a yaw in [-60, 60) and a side in ``sizes``
    from ``RandomState(seed)``. Returns the txt name, relative to
    ``out_root`` (as ``pretrain.txt_name`` takes it). The same tree as the
    JAX package's: the same txt, byte for byte, and JPEGs that PIL
    decodes to the same pixels."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(out_root, "img")
    os.makedirs(img_dir, exist_ok=True)
    rows = []
    for i in range(num_images):
        subject = int(rng.randint(0, num_subjects))
        yaw = float(rng.uniform(-60, 60))
        size = int(rng.randint(sizes[0], sizes[1] + 1))
        img, lm5 = render_face(subject, yaw, size)
        name = f"{i:06d}.jpg"
        write_jpeg(os.path.join(img_dir, name), img, quality=92)
        v = np.round(lm5).astype(int)
        rows.append(f"{name} {v[0,0]} {v[0,1]} {v[1,0]} {v[1,1]} {v[2,0]} {v[2,1]} "
                    f"{v[3,0]} {v[3,1]} {v[4,0]} {v[4,1]}")
    txt_name = "list_landmarks_celeba.txt"
    with open(os.path.join(out_root, txt_name), "w") as f:
        f.write(f"{num_images}\n")
        f.write("image_id lefteye_x lefteye_y righteye_x righteye_y nose_x "
                "nose_y leftmouth_x leftmouth_y rightmouth_x rightmouth_y\n")
        f.write("\n".join(rows) + "\n")
    return txt_name
