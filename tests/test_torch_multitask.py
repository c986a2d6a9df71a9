"""The port's multi-task landmark loss, decoders and banded accuracy
(``tpgan_tpu_torch/losses/multitask.py``, ``losses/decoder.py``,
``train/pretrain.py::landmark_accuracy``) against the JAX package on the
CPU, on the same numpy inputs:

* the loss in both assignment modes (from the predictions; from the
  static anchor grid), with JAX's per-item uniforms injected: the
  assignment and the background subsample equal JAX's (asserted first),
  the loss and its parts within rtol 1e-5, and the gradient with respect
  to the predictions and the logits within rtol 1e-4, atol 1e-6 x its
  largest element against ``jax.grad``;
* planted ties: predictions exactly on the clip corners (0 and the image
  size), the absolute head's ReLU corner (a loc conv whose weights and
  bias are zero) and the anchor head's image-bound clip (a bias that
  puts an anchor's decode exactly on 0 or on the bound), each held
  against ``jax.grad`` through the JAX head (the head's weight gradients,
  sums over positions, within rtol 1e-4, atol 1e-4 x the leaf's largest;
  the tied bias's under the loss's bar); a second check shows that
  ``torch.relu`` in place of ``torch.maximum`` misses JAX's 0.5;
* planted distance ties: duplicated predictions at the threshold and
  predictions equidistant from two labels (the first label wins on both
  sides);
* ``masked_nms``, ``decode_landmarks``, ``soft_decode_landmarks`` and
  ``decode_for_head_mode`` on random inputs and on planted score ties
  (identical logit rows: the lower index wins on both sides): points and
  validity equal, scores within rtol 1e-5;
* ``landmark_accuracy`` at every band edge and just past it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpgan_tpu.losses.decoder import decode_for_head_mode as jax_decode_for
from tpgan_tpu.losses.decoder import decode_landmarks as jax_decode
from tpgan_tpu.losses.decoder import masked_nms as jax_nms
from tpgan_tpu.losses.decoder import soft_decode_landmarks as jax_soft_decode
from tpgan_tpu.losses.multitask import multitask_landmark_loss as jax_loss
from tpgan_tpu.models.mobilenet_v2 import SSD_SCALES
from tpgan_tpu.models.mobilenet_v2 import SSDHead as JSSDHead
from tpgan_tpu.models.mobilenet_v2 import anchor_centres as jax_anchor_centres
from tpgan_tpu.train.pretrain import landmark_accuracy as jax_accuracy
from tpgan_tpu_torch.convert import jax_generator_params_to_state_dict
from tpgan_tpu_torch.losses.decoder import (
    decode_for_head_mode,
    decode_landmarks,
    masked_nms,
    soft_decode_landmarks,
)
from tpgan_tpu_torch.losses.multitask import multitask_landmark_loss
from tpgan_tpu_torch.models.mobilenet_v2 import SSDHead, anchor_centres
from tpgan_tpu_torch.train.pretrain import landmark_accuracy

from _torch_detector import jax_assignment, jax_uniforms
from _torch_port import numpy_variables

torch.set_num_threads(1)

SIZE = 128
N = 394  # the 128x128 grid: 8x8x4 + 4x4x6 + 2x2x6 + 3 x 1x1x6
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-4, 1e-6
PARAM_GRAD_ATOL_SHARE = 1e-4


def _inputs(seed, batch=2, n=N, classes=5):
    rng = np.random.RandomState(seed)
    loc = rng.uniform(0, SIZE, (batch, n, 2)).astype(np.float32)
    cls = rng.standard_normal((batch, n, classes)).astype(np.float32)
    lbl = rng.uniform(0.2 * SIZE, 0.8 * SIZE, (batch, 8)).astype(np.float32)
    return loc, cls, lbl


def _jax_loss_and_grad(loc, cls, lbl, rng, assign_points=None):
    def f(l, c):
        return jax_loss(l, c, jnp.asarray(lbl), rng, image_size=(SIZE, SIZE),
                        assign_points=assign_points)

    (total, aux), (gl, gc) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jnp.asarray(loc), jnp.asarray(cls))
    return float(total), {k: float(v) for k, v in aux.items()}, np.asarray(gl), np.asarray(gc)


def _port_loss_and_grad(loc, cls, lbl, u, assign_points=None):
    lt = torch.tensor(loc, requires_grad=True)
    ct = torch.tensor(cls, requires_grad=True)
    total, aux = multitask_landmark_loss(
        lt, ct, torch.tensor(lbl), torch.tensor(u), image_size=(SIZE, SIZE),
        assign_points=None if assign_points is None else torch.from_numpy(assign_points))
    total.backward()
    return total, aux, lt.grad.numpy(), ct.grad.numpy()


def _grad_close(got, want, label):
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_SHARE * float(np.abs(want).max()), err_msg=label)


@pytest.mark.parametrize("mode", ["predictions", "anchors"])
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_value_and_gradient_match_jax(mode, seed):
    loc, cls, lbl = _inputs(seed)
    rng = jax.random.PRNGKey(seed + 10)
    u = jax_uniforms(rng, 2, N)
    anchors = np.asarray(jax_anchor_centres((SIZE, SIZE))) if mode == "anchors" else None
    assert anchors is None or anchors.shape == (N, 2)
    total, aux, gl, gc = _port_loss_and_grad(loc, cls, lbl, u, anchors)
    want_assigned, want_keep = jax_assignment(loc, lbl, u, assign_points=anchors)
    np.testing.assert_array_equal(aux["assigned"].numpy(), want_assigned)
    np.testing.assert_array_equal(aux["keep_bg"].numpy(), want_keep)
    assert (want_assigned >= 0).sum() > 0 and want_keep.sum() > 0
    jt, jaux, jgl, jgc = _jax_loss_and_grad(loc, cls, lbl, rng, anchors)
    np.testing.assert_allclose(total.item(), jt, rtol=LOSS_RTOL)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(aux[k]), v, rtol=LOSS_RTOL, err_msg=k)
    _grad_close(gl, jgl, "d loss / d loc")
    _grad_close(gc, jgc, "d loss / d cls")


def test_loss_draws_from_a_generator_and_needs_one():
    loc, cls, lbl = (torch.from_numpy(a) for a in _inputs(2))
    kw = dict(image_size=(SIZE, SIZE))
    a, aux_a = multitask_landmark_loss(loc, cls, lbl, generator=torch.Generator().manual_seed(4),
                                       **kw)
    b, aux_b = multitask_landmark_loss(loc, cls, lbl, generator=torch.Generator().manual_seed(4),
                                       **kw)
    assert torch.equal(a, b) and torch.equal(aux_a["keep_bg"], aux_b["keep_bg"])
    with pytest.raises(ValueError, match="uniforms u or a generator"):
        multitask_landmark_loss(loc, cls, lbl, **kw)


def test_gradient_on_the_loss_clip_corners_matches_jax_grad():
    loc, cls, lbl = _inputs(3)
    # two labels on the image's edges, predictions exactly on the corners
    lbl[0, 0:2] = (2.0, 20.0)
    lbl[1, 2:4] = (SIZE - 2.0, 90.0)
    loc[0, :40] = (0.0, 20.0)   # lp / size == 0: the clip's lower corner
    loc[0, 40:60, 0] = 0.0
    loc[1, :40] = (SIZE, 90.0)  # lp / size == 1: the upper corner
    loc[1, 40:60, 1] = SIZE
    rng = jax.random.PRNGKey(7)
    u = jax_uniforms(rng, 2, N)
    _t, aux, gl, gc = _port_loss_and_grad(loc, cls, lbl, u)
    a, k = jax_assignment(loc, lbl, u)
    np.testing.assert_array_equal(aux["assigned"].numpy(), a)
    assert (a[0, :40] == 0).all() and (a[1, :40] == 1).all()
    _t, _aux, jgl, jgc = _jax_loss_and_grad(loc, cls, lbl, rng)
    # on a corner the clip passes half the gradient, as jnp.clip's two ops do
    assert np.all(jgl[0, :40, 0] != 0) and np.all(jgl[1, :40, 0] != 0)
    _grad_close(gl, jgl, "d loss / d loc")
    _grad_close(gc, jgc, "d loss / d cls")


def _features(seed, batch=2):
    rng = np.random.RandomState(seed)
    shapes = [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1), (1, 1)]
    return [rng.uniform(-1, 1, (batch, c, h, w)).astype(np.float32)
            for (h, w), (c, _a) in zip(shapes, SSD_SCALES)]


def _head_pair(head_mode, feats, seed):
    jhead = JSSDHead(head_mode=head_mode, accum_f32=False)
    nhwc = [jnp.asarray(f.transpose(0, 2, 3, 1)) for f in feats]
    shapes = jax.eval_shape(lambda r: jhead.init(r, nhwc, image_hw=(SIZE, SIZE)),
                            jax.random.PRNGKey(0))
    params, _ = numpy_variables(shapes, seed)
    return jhead, params, nhwc


def _head_grads_torch(head, feats, lbl, u):
    loc, cls = head([torch.from_numpy(f) for f in feats], image_hw=(SIZE, SIZE))
    anchors = anchor_centres((SIZE, SIZE)) if head.head_mode == "anchor_offset" else None
    total, aux = multitask_landmark_loss(loc, cls, torch.from_numpy(lbl), torch.from_numpy(u),
                                         image_size=(SIZE, SIZE), assign_points=anchors)
    head.zero_grad()
    total.backward()
    return loc.detach().numpy(), aux, {n: p.grad.numpy().copy()
                                       for n, p in head.named_parameters()}


@pytest.mark.parametrize("head_mode", ["absolute", "anchor_offset"])
def test_head_gradient_at_its_clip_ties_matches_jax_grad(head_mode):
    feats = _features(4)
    jhead, params, nhwc = _head_pair(head_mode, feats, seed=5)
    loc0 = params["loc0"]
    loc0["kernel"] = np.zeros_like(loc0["kernel"])
    if head_mode == "absolute":
        # every anchor of scale 0 emits exactly (0, 0): the ReLU's corner,
        # then the loss clip's lower corner; the other scales' anchors sit
        # far from it, near (60, 60), so that label 0 takes scale 0's
        loc0["bias"] = np.zeros_like(loc0["bias"])
        for j in range(1, len(SSD_SCALES)):
            params[f"loc{j}"]["bias"] = np.full_like(params[f"loc{j}"]["bias"], 60.0)
    else:
        # decode = centre + bias * stride: anchor 0 lands exactly on x = 0
        # in column 0, anchor 1 exactly on x = 128 in column 7 (stride 16)
        loc0["bias"] = np.asarray([-0.5, 0.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    lbl = np.tile(np.asarray([[3.0, 4.0, 60.0, 60.0, 70.0, 80.0, 125.0, 6.0]], np.float32),
                  (2, 1))
    rng = jax.random.PRNGKey(8)
    u = jax_uniforms(rng, 2, N)

    head = SSDHead(head_mode=head_mode, device="cpu")
    head.load_state_dict(jax_generator_params_to_state_dict(params), strict=True)
    loc, aux, grads = _head_grads_torch(head, feats, lbl, u)
    if head_mode == "absolute":
        assert (loc[:, :256] == 0).all()
    else:
        assert (loc[:, 0:256:32, 0] == 0).all() and (loc[:, 29:256:32, 0] == SIZE).all()
    anchors = np.asarray(jax_anchor_centres((SIZE, SIZE))) if head_mode == "anchor_offset" \
        else None

    def f(p):
        jl, jc = jhead.apply({"params": p}, nhwc, image_hw=(SIZE, SIZE))
        return jax_loss(jl, jc, jnp.asarray(lbl), rng, image_size=(SIZE, SIZE),
                        assign_points=anchors)[0]

    jgrads = jax_generator_params_to_state_dict(jax.jit(jax.grad(f))(params))
    a, _k = jax_assignment(np.asarray(jax.jit(lambda p: jhead.apply(
        {"params": p}, nhwc, image_hw=(SIZE, SIZE))[0])(params)), lbl, u, assign_points=anchors)
    np.testing.assert_array_equal(aux["assigned"].numpy(), a)
    for name, g in grads.items():
        # a weight's gradient sums over positions and items, and its f32
        # rounding differs between the sides: 1e-4 of the leaf's largest
        want = jgrads[name].numpy()
        np.testing.assert_allclose(g, want, rtol=GRAD_RTOL,
                                   atol=PARAM_GRAD_ATOL_SHARE * float(np.abs(want).max()),
                                   err_msg=name)
    _grad_close(grads["loc0.bias"], jgrads["loc0.bias"].numpy(), "loc0.bias")
    assert np.abs(jgrads["loc0.bias"].numpy()).max() > 0  # the ties pass a gradient

    # torch's clamp (1 at a tie) or relu (0) in place of the two ops misses it
    if head_mode == "absolute":
        orig = torch.maximum
        try:
            torch.maximum = lambda x, y: torch.relu(x)
            _loc, _aux, wrong = _head_grads_torch(head, feats, lbl, u)
        finally:
            torch.maximum = orig
        assert not np.allclose(wrong["loc0.bias"], jgrads["loc0.bias"].numpy(), rtol=1e-2)


def test_distance_ties_resolve_as_jax_does():
    loc, cls, lbl = _inputs(5)
    lbl[0] = (40, 40, 80, 40, 60, 80, 60, 100)
    # equidistant from labels 0 and 1: the first label wins
    loc[0, :30] = (60.0, 40.0)
    # duplicates straddling the threshold: all or none are positive
    loc[0, 30:90] = (60.0, 79.0)
    loc[1, :100] = loc[1, :1]
    rng = jax.random.PRNGKey(11)
    u = jax_uniforms(rng, 2, N)
    _t, aux, gl, gc = _port_loss_and_grad(loc, cls, lbl, u)
    a, k = jax_assignment(loc, lbl, u)
    np.testing.assert_array_equal(aux["assigned"].numpy(), a)
    np.testing.assert_array_equal(aux["keep_bg"].numpy(), k)
    assert (a[0, :30] == 0).all()
    _t, _aux, jgl, jgc = _jax_loss_and_grad(loc, cls, lbl, rng)
    _grad_close(gl, jgl, "d loss / d loc")
    _grad_close(gc, jgc, "d loss / d cls")


def _decode_inputs(seed, ties):
    rng = np.random.RandomState(seed)
    loc = rng.uniform(0, SIZE, (2, N, 2)).astype(np.float32)
    cls = (3.0 * rng.standard_normal((2, N, 5))).astype(np.float32)
    if ties:
        # identical logit rows: exactly equal scores at several indices
        cls[:, 100:140] = cls[:, 7:8]
        cls[:, 300:310] = cls[:, 7:8]
        loc[:, 100:140] = rng.uniform(0, SIZE, (2, 40, 2))
    return loc, cls


def _assert_decoded(got, want):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "score_ties"])
def test_decoders_match_jax(ties):
    loc, cls = _decode_inputs(6, ties)
    tl, tc = torch.from_numpy(loc), torch.from_numpy(cls)
    for kw in (dict(), dict(confidence_threshold=0.05, top_k=4),
               dict(confidence_threshold=0.0, top_k=3, nms_distance_threshold=15.0)):
        _assert_decoded(decode_landmarks(tl, tc, **kw), jax.jit(
            lambda a, b: jax_decode(a, b, **kw))(loc, cls))
    for kw in (dict(), dict(confidence_threshold=0.05, candidates=32, cluster_radius=25.0)):
        _assert_decoded(soft_decode_landmarks(tl, tc, **kw), jax.jit(
            lambda a, b: jax_soft_decode(a, b, **kw))(loc, cls))
    for mode in ("absolute", "anchor_offset"):
        _assert_decoded(decode_for_head_mode(mode, 0.1)(tl, tc),
                        jax.jit(jax_decode_for(mode, 0.1))(loc, cls))


def test_masked_nms_matches_jax_on_ties():
    rng = np.random.RandomState(9)
    pts = rng.uniform(0, 100, (50, 2)).astype(np.float32)
    scores = rng.choice([0.2, 0.5, 0.9], 50).astype(np.float32)  # many exact ties
    valid = rng.uniform(size=50) < 0.8
    got = masked_nms(torch.from_numpy(pts), torch.from_numpy(scores), torch.from_numpy(valid),
                     12.0, 20)
    want = jax.jit(lambda p, s, v: jax_nms(p, s, v, 12.0, 20))(pts, scores, valid)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < got[2].sum() < 20  # some slots kept, some left empty


def test_landmark_accuracy_at_the_band_edges():
    # part offsets from their labels with these exact lengths (3-4-5 triangles)
    edges = [(3.0, 4.0), (6.0, 8.0), (18.0, 0.0), (18.0, 24.0), (27.0, 36.0)]
    past = [(3.0, 4.01), (6.0, 8.01), (18.01, 0.0), (18.0, 24.01), (27.0, 36.01)]
    rows = [edges[0:4], edges[1:5], past[0:4], past[1:5], [(0.0, 0.0)] * 4]
    # integer labels: the offsets, and so the distances, are exact
    lbl = np.random.RandomState(1).randint(50, 70, (len(rows), 8)).astype(np.float32)
    pts = lbl.reshape(-1, 4, 2) + np.asarray(rows, np.float32)
    points = np.zeros((len(rows), 5, 1, 2), np.float32)
    points[:, :4, 0] = pts
    valid = np.ones((len(rows), 5, 1), bool)
    valid[4, 2, 0] = False  # an undetected part scores 0
    for scale in (1.0, 2.0):
        got = landmark_accuracy(torch.from_numpy(points), torch.from_numpy(valid),
                                torch.from_numpy(lbl), scale)
        want = jax_accuracy(jnp.asarray(points), jnp.asarray(valid), jnp.asarray(lbl), scale)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    per_row = [float(landmark_accuracy(torch.from_numpy(points[i:i + 1]),
                                       torch.from_numpy(valid[i:i + 1]),
                                       torch.from_numpy(lbl[i:i + 1]))) for i in range(5)]
    np.testing.assert_allclose(per_row, [(1 + .9 + .65 + .35) / 4, (.9 + .65 + .35 + .1) / 4,
                                         (.9 + .65 + .35 + .1) / 4, (.65 + .35 + .1 + 0) / 4,
                                         0.75], rtol=1e-6)
