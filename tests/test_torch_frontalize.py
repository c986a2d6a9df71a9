"""The port's full-stack frontalization (``tpgan_tpu_torch.frontalize``)
against the JAX package's (``tpgan_tpu/frontalize.py``) on the CPU: the
mirrors of the nine frontalize cases of ``tests/test_frontalize.py``
(letterbox geometry, unmapping, upscale, TTA, refine, the nose gate and
vote; the stub detectors as small ``nn.Module``s); ``detect_lm5`` with
the full detector at 128 on converted seeded weights in each option; and
the slice whole, ``make_frontalize_fn`` against JAX's at fm 0.25.

The seeded detector's location biases are drawn inside the frame, so its
points fall on the image and the crops, the refine window and the vote
see real geometry. JAX's side runs jitted, as its programs run: one
compile per option, the full detector at 128 inside (a module-scoped
fixture holds the weights).

Bars: the mirrored cases at the JAX tests' own tolerances; the full
detector's decode picks equal (the anchor each part takes, from both
sides' softmax), lm5 within 1e-3 px, scores within 1e-5, valid equal;
the slice's face within 1e-4 absolute in float32, its crops' floors
(the landmarks in the 128 frame) equal to JAX's."""

import copy

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from tpgan_tpu import frontalize as jfront
from tpgan_tpu.config import make_config as jax_make_config
from tpgan_tpu.train.gan_trainer import build_models
from tpgan_tpu_torch import frontalize as front
from tpgan_tpu_torch.config import make_config
from tpgan_tpu_torch.convert import jax_detector_variables_to_state_dict
from tpgan_tpu_torch.data.celeba import letterbox as host_letterbox
from tpgan_tpu_torch.data.synthetic_faces import render_face
from tpgan_tpu_torch.models.mobilenet_v2 import MobileNetV2
from tpgan_tpu_torch.ops import quant
from tpgan_tpu_torch.ops.blocks import BatchNorm2d, set_compute_dtype
from tpgan_tpu_torch.ops.resize import resize
from tpgan_tpu_torch.train.gan_trainer import build_generator, make_int8_synthesize_fn
from tpgan_tpu_torch.train.pretrain import build_detector, fit_nose_prior

from _torch_detector import detector_pair
from _torch_port import init_numpy, load_port

torch.set_num_threads(1)

OVERRIDES = {"G": {"fm_multiplier": 0.25, "local_feature_layer_dim": 16},
             "D": {"fm_multiplier": 0.25}, "compute_dtype": "float32"}
SIZE = 128  # the detector's frame in these tests, as tests/test_frontalize.py uses
LM_ATOL = 1e-3
SCORE_ATOL = 1e-5
FACE_ATOL = 1e-4
INT8_FACE_OF_QUANT = 1.5


# ---- stub detectors: tests/test_frontalize.py's, as modules on NCHW ----

def _one_hot_logits(b):
    cls = torch.full((b, 4, 5), -10.0)
    cls[:, torch.arange(4), torch.arange(4)] = 10.0
    return cls


class _StubDetector(nn.Module):
    """One candidate per part at fixed letterbox-frame points."""

    head_mode = "absolute"

    def __init__(self, pts_boxed):
        super().__init__()
        self.register_buffer("pts", torch.as_tensor(np.asarray(pts_boxed, np.float32)))

    def forward(self, x):
        b = x.shape[0]
        return self.pts[None].expand(b, 4, 2), _one_hot_logits(b)


def _centroid(x):
    xf = x[:, 0].float()
    tot = xf.sum(dim=(1, 2)) + 1e-9
    ys = (xf * torch.arange(x.shape[2], dtype=torch.float32)[None, :, None]).sum(dim=(1, 2)) / tot
    xs = (xf * torch.arange(x.shape[3], dtype=torch.float32)[None, None, :]).sum(dim=(1, 2)) / tot
    return torch.stack([xs, ys], dim=-1), tot


OFFSETS = torch.tensor([[-10.0, 0.0], [10.0, 0.0], [0.0, 10.0], [0.0, 20.0]])
BAD_NOSE = torch.tensor([200.0, 30.0])


class _ContentStubDetector(nn.Module):
    """Candidates around each image's intensity centroid, so the mirrored
    half of a TTA batch gives mirrored points; ``sabotage_left`` adds a
    far, low-confidence nose when the marker is in the left half."""

    head_mode = "absolute"

    def __init__(self, sabotage_left=False):
        super().__init__()
        self.sabotage_left = sabotage_left

    def forward(self, x):
        c, _tot = _centroid(x)
        loc = c[:, None, :] + OFFSETS[None]
        cls = _one_hot_logits(x.shape[0])
        if self.sabotage_left:
            left = c[:, 0] < x.shape[3] / 2
            loc[:, 2] = torch.where(left[:, None], BAD_NOSE[None], loc[:, 2])
            cls[:, 2, 2] = torch.where(left, 2.0, 10.0)
        return loc, cls


class _ScaleKeyedStubDetector(nn.Module):
    """The centroid detector with the nose broken in the coarse letterbox
    pass only, told apart by the marker's energy (the refine crop zooms
    far harder than the letterbox)."""

    head_mode = "absolute"

    def forward(self, x):
        c, tot = _centroid(x)
        loc = c[:, None, :] + OFFSETS[None]
        coarse = tot < 10.0
        loc[:, 2] = torch.where(coarse[:, None], BAD_NOSE[None], loc[:, 2])
        return loc, _one_hot_logits(x.shape[0])


def _nose_prior(bias):
    """nose = (le + re) / 2 + bias, as a (7, 2) matrix."""
    w = np.zeros((7, 2), np.float32)
    w[0:2, 0] = [0.5, 0.0]
    w[2:4, 0] = [0.5, 0.0]
    w[0:2, 1] = [0.0, 0.5]
    w[2:4, 1] = [0.0, 0.5]
    w[6] = bias
    return w


def _lm5(det, images, **kw):
    lm5, valid, scores = front.detect_lm5(det, torch.as_tensor(images), **kw)
    return lm5.numpy(), valid.numpy(), scores.numpy()


# ---- mirrors of tests/test_frontalize.py ----

def test_letterbox_batch_matches_host_geometry():
    rng = np.random.RandomState(0)
    for h, w, size, up in [(100, 180, 256, False), (300, 200, 256, False), (64, 48, 128, True)]:
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        want, scale, (pl, pt) = host_letterbox(img, size, allow_upscale=up)
        got, g_scale, (g_pl, g_pt) = front.letterbox_batch(torch.from_numpy(img)[None], size, up)
        got = got.numpy()[0]
        assert g_scale == scale and (g_pl, g_pt) == (pl, pt)
        assert got.shape == want.shape == (size, size, 3)
        mask = want == 0.0
        np.testing.assert_array_equal(got[mask & (got != 0)], [])
        if scale == 1.0:
            np.testing.assert_allclose(got, want, atol=1e-6)
        # and JAX's letterbox_batch on the same frame: the same geometry;
        # the pixels within 2e-6 of the same weights applied in float64,
        # which JAX's CPU einsum misses by up to 5e-6 when both axes
        # shrink (300x200 -> 256x171; tests/test_torch_resize.py)
        jgot, j_scale, j_pads = jfront.letterbox_batch(jnp.asarray(img)[None], size, up)
        assert (j_scale, j_pads) == (g_scale, (g_pl, g_pt))
        nh, nw = max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)
        truth = np.zeros((size, size, 3))
        truth[pt:pt + nh, pl:pl + nw] = resize(
            torch.from_numpy(img)[None].double() / 255.0, (1, nh, nw, 3), "bilinear")[0].numpy()
        np.testing.assert_allclose(got, truth, rtol=0, atol=2e-6)
        np.testing.assert_allclose(np.asarray(jgot)[0], truth, rtol=0, atol=1e-5)


def test_detect_lm5_unmaps_to_source_frame():
    h, w, size = 180, 120, 256
    pl, pt = (size - w) // 2, (size - h) // 2
    src = np.asarray([[30.0, 60.0], [80.0, 58.0], [55.0, 90.0], [54.0, 130.0]], np.float32)
    images = np.zeros((2, h, w, 3), np.uint8)
    lm5, valid, scores = _lm5(_StubDetector(src + [pl, pt]), images, detector_size=size,
                              allow_upscale=False)
    assert lm5.shape == (2, 5, 2) and valid.all()
    assert scores.shape == (2, 4) and (scores > 0.9).all()
    np.testing.assert_allclose(lm5[0, :4], src, atol=1e-4)
    np.testing.assert_allclose(lm5[0, 3], lm5[0, 4])


def test_detect_lm5_upscale_divides_error_by_scale():
    src = np.asarray([[30.0, 60.0], [80.0, 58.0], [55.0, 90.0], [54.0, 110.0]], np.float32)
    images = np.zeros((2, 128, 128, 3), np.uint8)
    lm5, valid, _ = _lm5(_StubDetector(src * 2.0), images, detector_size=256)
    np.testing.assert_allclose(lm5[0, :4], src, atol=1e-4)
    assert valid.all()
    lm5b, _, _ = _lm5(_StubDetector(src * 2.0 + [4.0, 0.0]), images, detector_size=256)
    np.testing.assert_allclose(lm5b[0, :4] - lm5[0, :4], np.tile([2.0, 0.0], (4, 1)), atol=1e-4)


def test_frontalize_end_to_end_shapes():
    cfg = make_config(OVERRIDES)
    fn = front.make_frontalize_fn(cfg, build_detector(cfg, "cpu", seed=0),
                                  build_generator(cfg, "cpu", seed=1), detector_size=128)
    images = (np.random.RandomState(0).rand(2, 150, 110, 3) * 255).astype(np.uint8)
    fake, lm5, scores = fn(images, np.zeros((2, cfg.G.zdim), np.float32))
    assert fake.shape == (2, 128, 128, 3) and lm5.shape == (2, 5, 2) and scores.shape == (2, 4)
    assert torch.isfinite(fake).all() and torch.isfinite(lm5).all()


def _marker(size, x, y):
    img = np.zeros((1, size, size, 3), np.uint8)
    img[0, y, x, :] = 255
    return img


def test_detect_lm5_tta_mirror_swap_and_fuse():
    lm5, valid, _ = _lm5(_ContentStubDetector(), _marker(256, 60, 100), detector_size=256,
                         tta=True, tta_agree_radius=25.0)
    want = np.asarray([[50.0, 100.0], [70.0, 100.0], [60.0, 110.0], [60.0, 120.0]])
    np.testing.assert_allclose(lm5[0, :4], want, atol=0.75)
    assert valid.all()


def test_detect_lm5_refine_repairs_nose_tail():
    marker = np.asarray([60.0, 50.0])
    img = _marker(128, 60, 50)
    det = _ScaleKeyedStubDetector()
    lm5_c, _, _ = _lm5(det, img, detector_size=256)
    assert np.linalg.norm(lm5_c[0, 2] - (marker + [0, 10])) > 40
    lm5, valid, _ = _lm5(det, img, detector_size=256, refine=True)
    assert np.linalg.norm(lm5[0, 2] - marker) < 5.0, lm5[0, 2]
    np.testing.assert_allclose(lm5[0, [0, 1, 3]],
                               marker + np.asarray([[-5.0, 0.0], [5.0, 0.0], [0.0, 10.0]]), atol=1.0)
    assert valid.all()


def test_detect_lm5_nose_gate_snaps_implausible_decode():
    h, w, size = 180, 120, 256
    off = np.asarray([(size - w) // 2, (size - h) // 2], np.float32)
    src = np.asarray([[30.0, 60.0], [80.0, 58.0], [55.0, 90.0], [54.0, 130.0]], np.float32)
    prior = _nose_prior([0.0, 31.0])
    images = np.zeros((1, h, w, 3), np.uint8)
    kw = dict(detector_size=size, allow_upscale=False)
    lm5, _, _ = _lm5(_StubDetector(src + off), images, nose_prior=prior, **kw)
    np.testing.assert_allclose(lm5[0, :4], src, atol=1e-3)
    bad = src.copy()
    bad[2] = [200.0, 20.0]
    lm5, _, _ = _lm5(_StubDetector(bad + off), images, nose_prior=prior, **kw)
    np.testing.assert_allclose(lm5[0, 2], [55.0, 90.0], atol=1e-3)
    np.testing.assert_allclose(lm5[0, [0, 1, 3]], src[[0, 1, 3]], atol=1e-3)
    lm5, _, _ = _lm5(_StubDetector(bad + off), images, **kw)
    np.testing.assert_allclose(lm5[0, 2], [200.0, 20.0], atol=1e-3)


def test_detect_lm5_refine_prior_three_way_vote():
    marker = np.asarray([60.0, 50.0])
    img = _marker(128, 60, 50)
    prior = _nose_prior([0.0, 10.0])
    lm5, _, _ = _lm5(_ScaleKeyedStubDetector(), img, detector_size=256, refine=True,
                     nose_prior=prior)
    np.testing.assert_allclose(lm5[0, 2], marker + [0.0, 10.0], atol=5.0)
    np.testing.assert_allclose(lm5[0, [0, 1, 3]],
                               marker + np.asarray([[-5.0, 0.0], [5.0, 0.0], [0.0, 10.0]]), atol=1.0)
    lm5b, _, _ = _lm5(_ContentStubDetector(), img, detector_size=256, refine=True,
                      nose_prior=_nose_prior([500.0, 500.0]))
    assert np.linalg.norm(lm5b[0, 2] - marker) < 8.0


def test_detect_lm5_tta_picks_confident_pass_on_disagreement():
    img = _marker(256, 60, 100)
    det = _ContentStubDetector(sabotage_left=True)
    lm5_plain, _, _ = _lm5(det, img, detector_size=256)
    np.testing.assert_allclose(lm5_plain[0, 2], [200.0, 30.0], atol=0.75)
    lm5, _, _ = _lm5(det, img, detector_size=256, tta=True)
    np.testing.assert_allclose(lm5[0, 2], [60.0, 110.0], atol=0.75)


# ---- the full detector against JAX's ----

class _JaxDetector:
    """JAX's detector as ``tpgan_tpu/frontalize.py`` calls it (``clone``,
    ``apply``, ``head_mode``), inside the jitted programs below."""

    head_mode = "absolute"

    def __init__(self, jmod):
        self.jmod = jmod

    def clone(self, **_kw):
        return self

    def apply(self, variables, x, train=False):
        return self.jmod.apply(variables, x, train=train)


@pytest.fixture(scope="module")
def full():
    """The full detector at 128 on both sides, its location biases drawn
    inside the frame; two 150x110 frames with a rendered face each; a
    nose prior fit on seeded labels."""
    jmod, variables, det = detector_pair("absolute", seed=0)
    rng = np.random.RandomState(7)
    head = variables["params"]["ssd_head"]
    for name in sorted(head):
        if name.startswith("loc"):
            head[name]["bias"] = rng.uniform(0.15 * SIZE, 0.85 * SIZE,
                                             head[name]["bias"].shape).astype(np.float32)
    det.load_state_dict(jax_detector_variables_to_state_dict(variables), strict=True)
    det.eval()
    images = np.zeros((2, 150, 110, 3), np.uint8)
    for i in range(2):
        face, _ = render_face(i, 30.0 * i, 100)
        images[i, 20 + 10 * i:120 + 10 * i, 5:105] = face
    prior = fit_nose_prior(rng.uniform(20, 100, (64, 4, 2)).astype(np.float32))
    return dict(jdet=_JaxDetector(jmod), variables=variables, det=det, images=images,
                prior=prior)


def _picks(loc_cls):
    """Per image and part, the anchor the top-1 decode takes: the argmax
    of the part's softmax score over anchors (float64)."""
    cls = np.asarray(loc_cls[1], np.float64)
    e = np.exp(cls - cls.max(-1, keepdims=True))
    return np.argmax(e / e.sum(-1, keepdims=True), axis=1)[:, :4]


OPTIONS = {"plain": {}, "tta": dict(tta=True), "refine": dict(refine=True),
           "prior": dict(nose_prior=True), "refine_prior": dict(refine=True, nose_prior=True)}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_detect_lm5_full_detector_matches_jax(full, option):
    kw = dict(OPTIONS[option])
    if kw.pop("nose_prior", False):
        kw["nose_prior"] = full["prior"]
    images = full["images"]

    def jax_run(variables, im):
        """JAX's detect_lm5 as its program runs it (jitted), and the
        coarse pass's class logits (and the mirror's)."""
        out = jfront.detect_lm5(full["jdet"], variables, im, detector_size=SIZE, **kw)
        boxed, _, _ = jfront.letterbox_batch(im, SIZE, True)
        if kw.get("tta"):
            boxed = jnp.concatenate([boxed, boxed[:, :, ::-1, :]])
        return out, full["jdet"].apply(variables, boxed)

    want, jax_coarse = jax.jit(jax_run)(full["variables"], jnp.asarray(images))
    got = front.detect_lm5(full["det"], torch.from_numpy(images), detector_size=SIZE, **kw)
    # the coarse pass picks the same anchor for every part (and the mirror's)
    boxed, _, _ = front.letterbox_batch(torch.from_numpy(images), SIZE, True)
    if kw.get("tta"):
        boxed = torch.cat([boxed, torch.flip(boxed, dims=[2])])
    with torch.no_grad():
        port_coarse = full["det"](boxed.permute(0, 3, 1, 2))
    np.testing.assert_array_equal(_picks(port_coarse), _picks(jax_coarse))
    lm5, valid, scores = (t.numpy() for t in got)
    assert (lm5 > 0).all() and (lm5[..., 0] < 110).all()  # points on the frames
    np.testing.assert_allclose(lm5, np.asarray(want[0]), rtol=0, atol=LM_ATOL)
    np.testing.assert_array_equal(valid, np.asarray(want[1]))
    np.testing.assert_allclose(scores, np.asarray(want[2]), rtol=0, atol=SCORE_ATOL)


def test_make_frontalize_fn_matches_jax_whole(full):
    """The slice whole, uint8 frames to faces, with TTA, refine and the
    nose prior: the generator at fm 0.25 in float32 on converted weights,
    the detector as above. The crops floor the landmarks in the 128
    frame; those floors equal JAX's here (a crossing would be shown
    against a float64 run of both, not re-seeded)."""
    cfg = make_config(OVERRIDES)
    jcfg = jax_make_config(OVERRIDES)
    jgen, _ = build_models(jcfg)
    shapes = [(1, 128, 128, 3), (1, 40, 40, 3), (1, 40, 40, 3), (1, 32, 40, 3), (1, 32, 48, 3)]
    params, _ = init_numpy(jgen, *(np.zeros(s, np.float32) for s in shapes),
                           np.zeros((1, 64), np.float32), seed=3)
    gen = load_port(build_generator(cfg, "cpu"), params)
    opts = dict(detector_size=SIZE, tta=True, refine=True, nose_prior=full["prior"])
    images = full["images"]
    z = np.random.RandomState(5).standard_normal((2, cfg.G.zdim)).astype(np.float32)
    want = jax.jit(jfront.make_frontalize_fn(jcfg, full["jdet"], jgen, **opts))(
        params, full["variables"], jnp.asarray(images), jnp.asarray(z))
    fake, lm5, scores = front.make_frontalize_fn(cfg, full["det"], gen, **opts)(images, z)
    assert fake.shape == (2, 128, 128, 3) and fake.dtype == torch.float32
    np.testing.assert_allclose(lm5.numpy(), np.asarray(want[1]), rtol=0, atol=LM_ATOL)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want[2]), rtol=0, atol=SCORE_ATOL)
    frame = np.asarray([128.0 / 110, 128.0 / 150], np.float32)
    assert np.array_equal(np.floor(lm5.numpy() * frame), np.floor(np.asarray(want[1]) * frame))
    assert np.abs(np.asarray(want[0])).max() > 1e-2
    np.testing.assert_allclose(fake.numpy(), np.asarray(want[0]), rtol=0, atol=FACE_ATOL)
    # the graphed form is the eager function on the CPU
    graphed = front.make_graphed_frontalize_fn(cfg, full["det"], gen, **opts)
    for a, b in zip(graphed(images, z), (fake, lm5, scores)):
        assert torch.equal(a, b)


def test_make_frontalize_fn_refuses_what_it_cannot_run():
    """The int8 stage refuses a BatchNorm generator (as JAX's does); the
    detector must compute in float32: bf16 parameters pass only under a
    float32 compute dtype (the serving export's narrowed detector)."""
    cfg = make_config(OVERRIDES)
    det = MobileNetV2(device="cpu")
    gen = build_generator(cfg, "cpu", seed=0)
    bn_cfg = make_config({**OVERRIDES, "G": {**OVERRIDES["G"], "use_batchnorm": True}})
    with pytest.raises(NotImplementedError, match="BatchNorm"):
        front.make_frontalize_fn(bn_cfg, det, build_generator(bn_cfg, "cpu", seed=0),
                                 quant_scales={"x": 1.0})
    with pytest.raises(ValueError, match="one device"):
        front.make_frontalize_fn(cfg, MobileNetV2(device="meta"), gen)
    with pytest.raises(ValueError, match="float32"):
        front.make_frontalize_fn(cfg, copy.deepcopy(det).to(torch.bfloat16), gen)
    det16 = copy.deepcopy(det)  # conv weights stored in bf16, BatchNorm in float32
    for m in det16.modules():
        if not isinstance(m, BatchNorm2d):
            for p in m.parameters(recurse=False):
                p.data = p.data.to(torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        front.make_frontalize_fn(cfg, det16, gen)
    front.make_frontalize_fn(cfg, set_compute_dtype(det16, torch.float32), gen)


# ---- the int8 generator stage ----

def _jax_quant_tree(scales):
    """The port's {module name: absmax} as JAX's nested ``quant``
    collection (the inverse of ``convert.jax_quant_scales_to_port``)."""
    tree = {}
    for name, value in scales.items():
        node = tree
        for part in name.split("."):
            node = node.setdefault(part, {})
        node["x_absmax"] = np.float32(value)
    return tree


@pytest.fixture(scope="module")
def int8_side(full):
    """The fm-0.25 generator on converted weights, its port calibration,
    and two 128x128 frames with a rendered face each."""
    cfg = make_config(OVERRIDES)
    jcfg = jax_make_config(OVERRIDES)
    jgen, _ = build_models(jcfg)
    shapes = [(1, 128, 128, 3), (1, 40, 40, 3), (1, 40, 40, 3), (1, 32, 40, 3), (1, 32, 48, 3)]
    params, _ = init_numpy(jgen, *(np.zeros(s, np.float32) for s in shapes),
                           np.zeros((1, 64), np.float32), seed=3)
    gen = load_port(build_generator(cfg, "cpu"), params)
    images = np.zeros((2, 128, 128, 3), np.uint8)
    for i in range(2):
        face, _ = render_face(2 + i, 20.0 - 40.0 * i, 100)
        images[i, 14 + 4 * i:114 + 4 * i, 10:110] = face
    z = np.random.RandomState(5).standard_normal((2, cfg.G.zdim)).astype(np.float32)
    batch = front.preprocess_for_synthesis_lm5(
        torch.from_numpy(images), front.detect_lm5(full["det"], torch.from_numpy(images),
                                                   detector_size=SIZE)[0])
    scales = quant.calibrate_synthesis(cfg, gen, [batch], zs=[z])
    return dict(cfg=cfg, jcfg=jcfg, jgen=jgen, params=params, gen=gen, images=images, z=z,
                scales=scales)


def test_int8_frontalize_is_the_composition(full, int8_side):
    """``make_frontalize_fn(quant_scales=...)`` is ``detect_lm5`` ->
    ``preprocess_for_synthesis_lm5`` -> ``make_int8_synthesize_fn``, bit
    for bit (float32 and bf16 rescale); the graphed form is the eager one
    on the CPU."""
    s = int8_side
    images = torch.from_numpy(s["images"])
    for rdt in (None, torch.bfloat16):
        fake, lm5, scores = front.make_frontalize_fn(
            s["cfg"], full["det"], s["gen"], detector_size=SIZE, quant_scales=s["scales"],
            quant_rescale_dtype=rdt)(images, s["z"])
        want_lm5, _valid, want_scores = front.detect_lm5(full["det"], images, detector_size=SIZE)
        batch = front.preprocess_for_synthesis_lm5(images, want_lm5)
        want = make_int8_synthesize_fn(s["cfg"], s["gen"], s["scales"], rescale_dtype=rdt)(
            batch, s["z"])
        assert torch.equal(fake, want) and torch.equal(lm5, want_lm5)
        assert torch.equal(scores, want_scores)
    graphed = front.make_graphed_frontalize_fn(s["cfg"], full["det"], s["gen"], detector_size=SIZE,
                                               quant_scales=s["scales"], quant_rescale_dtype=rdt)
    assert all(torch.equal(a, b) for a, b in zip(graphed(images, s["z"]), (fake, lm5, scores)))


def test_int8_frontalize_matches_jax(full, int8_side):
    """Against JAX's ``make_frontalize_fn(quant_scales=...)`` on the same
    scales, 128x128 frames: lm5 within LM_ATOL and the crops' floors equal
    (the detector is float on both sides); the face no further from JAX's
    int8 face than INT8_FACE_OF_QUANT times the port's own int8-vs-float
    error (``tests/test_torch_quant.py``'s flip argument: last-bit float
    differences move quantized values at rounding edges)."""
    s = int8_side
    want = jax.jit(jfront.make_frontalize_fn(s["jcfg"], full["jdet"], s["jgen"], detector_size=SIZE,
                                             quant_scales=_jax_quant_tree(s["scales"])))(
        s["params"], full["variables"], jnp.asarray(s["images"]), jnp.asarray(s["z"]))
    fake, lm5, scores = front.make_frontalize_fn(
        s["cfg"], full["det"], s["gen"], detector_size=SIZE, quant_scales=s["scales"])(
        s["images"], s["z"])
    np.testing.assert_allclose(lm5.numpy(), np.asarray(want[1]), rtol=0, atol=LM_ATOL)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want[2]), rtol=0, atol=SCORE_ATOL)
    assert np.array_equal(np.floor(lm5.numpy()), np.floor(np.asarray(want[1])))
    float_fake = front.make_frontalize_fn(s["cfg"], full["det"], s["gen"], detector_size=SIZE)(
        s["images"], s["z"])[0]
    quant_mae = float((fake - float_fake).abs().mean())
    assert quant_mae > 0
    face_mae = float(np.abs(fake.numpy() - np.asarray(want[0])).mean())
    assert face_mae <= INT8_FACE_OF_QUANT * quant_mae
