"""The port's on-device preprocessing (``tpgan_tpu_torch.data.
jit_preprocess``) and inference API (``tpgan_tpu_torch.api``) against the
JAX package's (``tpgan_tpu/data/jit_preprocess.py``, ``tpgan_tpu/api.py``)
on the same seeded numpy inputs and converted weights, on the CPU; and the
mirrors of ``tests/test_jit_preprocess.py``, the three api cases of
``tests/test_api_and_feature_extract.py`` and
``tests/test_serving_pipeline.py``.

Bars: the 68 -> 5 reduction within 1e-6 of JAX's (the same float32 bits:
an in-order sum times float32(1/n), as XLA takes the mean); every output
key of ``preprocess_for_synthesis`` / ``_lm5`` within 1e-5 absolute, and
the patches ``torch.equal`` to JAX's where both sides crop the same image
at the same landmarks (a 128x128 input: no resample); the fused
synthesis pipeline within 1e-4 of JAX's at fm 0.25 in float32; the
mirrored cases at the JAX tests' own bars."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpgan_tpu import api as japi
from tpgan_tpu.config import make_config as jax_make_config
from tpgan_tpu.data import jit_preprocess as jpre
from tpgan_tpu.data.patches import crop_patches_batch as jax_crop_patches_batch
from tpgan_tpu.train.gan_trainer import build_models
from tpgan_tpu.train.gan_trainer import make_synthesize_fn as jax_make_synthesize_fn
from tpgan_tpu_torch import api
from tpgan_tpu_torch.config import make_config
from tpgan_tpu_torch.data import jit_preprocess as pre
from tpgan_tpu_torch.data.imageio import write_png
from tpgan_tpu_torch.data.multipie import TestDataset
from tpgan_tpu_torch.data.patches import crop_patches_batch
from tpgan_tpu_torch.ops.resize import resize
from tpgan_tpu_torch.train.gan_trainer import build_generator, make_synthesize_fn
from tpgan_tpu_torch.utils.misc import five_landmarks_from_68

from _torch_detector import detector_pair
from _torch_port import init_numpy, load_port

torch.set_num_threads(1)

OVERRIDES = {"G": {"fm_multiplier": 0.25, "local_feature_layer_dim": 16},
             "D": {"fm_multiplier": 0.25}, "compute_dtype": "float32"}
KEYS = ("img", "img64", "img32", "left_eye", "right_eye", "nose", "mouth")
PRE_ATOL = 1e-5
FACE_ATOL = 1e-4


def _inputs(seed, b=2, h=200, w=180):
    rng = np.random.RandomState(seed)
    imgs = (rng.rand(b, h, w, 3) * 255).astype(np.uint8)
    lm68 = (rng.rand(b, 68, 2) * np.asarray([w - 30, h - 30]) + 10).astype(np.float32)
    return imgs, lm68


@pytest.fixture(scope="module")
def generator_pair():
    """(JAX generator, its numpy params, the port generator) at fm 0.25."""
    jgen, _ = build_models(jax_make_config(OVERRIDES))
    shapes = [(1, 128, 128, 3), (1, 40, 40, 3), (1, 40, 40, 3), (1, 32, 40, 3), (1, 32, 48, 3)]
    params, _ = init_numpy(jgen, *(np.zeros(s, np.float32) for s in shapes),
                           np.zeros((1, 64), np.float32), seed=3)
    return jgen, params, load_port(build_generator(make_config(OVERRIDES), "cpu"), params)


# ---- mirrors of tests/test_jit_preprocess.py ----

def test_landmark_reduction_matches_host_and_jax():
    rng = np.random.RandomState(0)
    for rows in (68, 69):  # 68: the fallback to index 54; 69: the reference's extra row
        lm = rng.rand(3, rows, 2).astype(np.float32) * 100
        got = pre.five_landmarks_from_68_batch(torch.from_numpy(lm)).numpy()
        for b in range(3):
            np.testing.assert_allclose(got[b], five_landmarks_from_68(lm[b]), rtol=1e-5)
        want = np.asarray(jpre.five_landmarks_from_68_jax(jnp.asarray(lm)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_preprocess_shapes_and_range():
    imgs, lm68 = _inputs(1)
    out = pre.preprocess_for_synthesis(torch.from_numpy(imgs), torch.from_numpy(lm68))
    assert out["img"].shape == (2, 128, 128, 3)
    assert out["img64"].shape == (2, 64, 64, 3)
    assert out["img32"].shape == (2, 32, 32, 3)
    assert out["left_eye"].shape == (2, 40, 40, 3)
    assert out["mouth"].shape == (2, 32, 48, 3)
    for v in out.values():
        assert v.dtype == torch.float32
        assert float(v.min()) >= -1.001 and float(v.max()) <= 1.001


def test_preprocess_approximates_host_testdataset(tmp_path):
    """The port's float pyramid against its host TestDataset path (PIL's
    Lanczos on uint8, ``data/imageio``): close in the interior, the patch
    geometry the same, at the JAX test's bars."""
    rng = np.random.RandomState(2)
    base = rng.rand(25, 23, 3)
    img = np.kron(base, np.ones((8, 8, 1)))[:200, :180]
    img_u8 = (img * 255).astype(np.uint8)
    path = tmp_path / "probe.png"
    write_png(str(path), img_u8)
    lm68 = (rng.rand(68, 2) * np.asarray([150, 170]) + 10).astype(np.float32)

    host = TestDataset([str(path)], [" ".join(str(float(v)) for v in lm68.reshape(-1))])[0]
    dev = pre.preprocess_for_synthesis(torch.from_numpy(img_u8)[None], torch.from_numpy(lm68)[None])
    for key in ("img", "img64", "img32"):
        assert np.abs(dev[key][0].numpy() - host[key]).mean() < 0.03, key
    for key in ("left_eye", "right_eye", "nose", "mouth"):
        a, b = dev[key][0].numpy(), host[key]
        assert a.shape == b.shape, key
        assert np.abs(a - b).mean() < 0.06, (key, np.abs(a - b).mean())


# ---- parity with JAX ----

@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_preprocess_every_key_matches_jax(dtype):
    imgs, lm68 = _inputs(4, h=480, w=640)  # the entry's frame
    x = imgs if dtype == "uint8" else imgs.astype(np.float32) / 255.0
    want = jax.jit(jpre.preprocess_for_synthesis)(jnp.asarray(x), jnp.asarray(lm68))
    got = pre.preprocess_for_synthesis(torch.from_numpy(x), torch.from_numpy(lm68))
    assert set(got) == set(want) == set(KEYS)
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=PRE_ATOL,
                                   err_msg=k)
    lm5 = (np.random.RandomState(5).rand(2, 5, 2) * 400 + 20).astype(np.float32)
    want = jax.jit(jpre.preprocess_for_synthesis_lm5)(jnp.asarray(x), jnp.asarray(lm5))
    got = pre.preprocess_for_synthesis_lm5(torch.from_numpy(x), torch.from_numpy(lm5))
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=PRE_ATOL,
                                   err_msg=k)


def test_patches_equal_jax_given_the_same_image_and_landmarks():
    """The crop geometry bit for bit: a 128x128 input is not resampled
    (each side clips and maps the same float32 values), so every key of
    the batch equals JAX's; and the crops of one image at one set of
    landmarks equal JAX's."""
    rng = np.random.RandomState(6)
    imgs = (rng.rand(3, 128, 128, 3) * 255).astype(np.uint8)
    lm5 = rng.uniform(-20, 150, (3, 5, 2)).astype(np.float32)  # some crops leave the image
    want = jax.jit(jpre.preprocess_for_synthesis_lm5)(jnp.asarray(imgs), jnp.asarray(lm5))
    got = pre.preprocess_for_synthesis_lm5(torch.from_numpy(imgs), torch.from_numpy(lm5))
    for k in ("img", "left_eye", "right_eye", "nose", "mouth"):
        assert torch.equal(got[k], torch.from_numpy(np.array(want[k]))), k
    img = rng.rand(3, 128, 128, 3).astype(np.float32)
    jp = jax_crop_patches_batch(jnp.asarray(img), jnp.asarray(lm5))
    tp = crop_patches_batch(torch.from_numpy(img), torch.from_numpy(lm5))
    for k in jp:
        assert torch.equal(tp[k], torch.from_numpy(np.array(jp[k]))), k


# ---- mirrors of the api cases of tests/test_api_and_feature_extract.py ----

def test_landmarks5_expansion():
    pts = torch.arange(8, dtype=torch.float32).reshape(1, 4, 2)
    lm5 = api.landmarks5_from_detection(pts)
    assert lm5.shape == (1, 5, 2)
    assert torch.equal(lm5[0, 3], pts[0, 3]) and torch.equal(lm5[0, 4], pts[0, 3])
    assert torch.equal(lm5, torch.from_numpy(np.asarray(
        japi.landmarks5_from_detection(jnp.asarray(pts.numpy())))))


def test_preprocess_from_landmarks5():
    rng = np.random.RandomState(0)
    imgs = rng.rand(2, 200, 180, 3).astype(np.float32)
    lm5 = (rng.rand(2, 5, 2) * 150 + 10).astype(np.float32)
    assert api.preprocess_from_landmarks5 is pre.preprocess_for_synthesis_lm5  # one copy
    out = api.preprocess_from_landmarks5(torch.from_numpy(imgs), torch.from_numpy(lm5))
    assert out["img"].shape == (2, 128, 128, 3)
    assert out["left_eye"].shape == (2, 40, 40, 3)


def test_full_inference_fn_shapes(generator_pair):
    """Detector + generator with seeded weights, float images in [0, 1]
    as the JAX function expects (a uint8 image reaches its detector
    undivided, as ``tpgan_tpu/api.py:189-195`` stands): the whole chain
    gives frontal images, and they are the faces of its own pieces run
    one after the other (each piece is held against JAX in its own
    test: the detector, the decoders, the preprocessing, synthesis)."""
    _jgen, _g_params, gen = generator_pair
    cfg = make_config(OVERRIDES)
    _jdet, _det_vars, det = detector_pair("absolute")
    imgs = torch.from_numpy(np.random.RandomState(2).rand(2, 160, 140, 3).astype(np.float32))
    z = torch.zeros(2, 64)
    out = api.make_full_inference_fn(cfg, gen, det, detector_input_size=128)(imgs, z)
    assert out.shape == (2, 128, 128, 3) and torch.isfinite(out).all()
    pts, _valid = api.detect_landmarks(
        det, torch.clamp(resize(imgs, (2, 128, 128, 3), "linear"), 0.0, 1.0))
    pts = torch.stack([pts[..., 0] * (140 / 128), pts[..., 1] * (160 / 128)], dim=-1)
    batch = api.preprocess_from_landmarks5(imgs, api.landmarks5_from_detection(pts))
    assert torch.equal(out, make_synthesize_fn(cfg, gen)(batch, z))


# ---- mirror of tests/test_serving_pipeline.py ----

def test_fused_pipeline_end_to_end(generator_pair):
    jgen, g_params, gen = generator_pair
    cfg = make_config(OVERRIDES)
    synthesize = make_synthesize_fn(cfg, gen)
    pipeline = pre.make_synthesis_pipeline(synthesize)
    imgs, lm68 = _inputs(0)
    z = np.zeros((2, cfg.G.zdim), np.float32)
    out = pipeline(imgs, lm68, z)
    assert out.shape == (2, 128, 128, 3) and torch.isfinite(out).all()
    # the fused pipeline == preprocessing, then synthesis
    want = synthesize(pre.preprocess_for_synthesis(torch.from_numpy(imgs),
                                                   torch.from_numpy(lm68)), z)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    # and == JAX's fused pipeline on the same weights
    jpipe = jpre.make_synthesis_pipeline(jax_make_synthesize_fn(jax_make_config(OVERRIDES), jgen))
    jout = np.asarray(jpipe(g_params, jnp.asarray(imgs), jnp.asarray(lm68), jnp.asarray(z)))
    np.testing.assert_allclose(out.numpy(), jout, rtol=0, atol=FACE_ATOL)
