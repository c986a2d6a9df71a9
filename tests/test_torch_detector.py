"""The port's landmark detector (``tpgan_tpu_torch/models/mobilenet_v2.py``:
``MobileNetV2``, ``SSDHead``, ``anchor_centres``, ``find_best_coordinates``),
its converter, its registry entry and ``import_mobilenet_v2_pth`` against
the JAX package on the CPU, on the same numpy-drawn weights carried across
by ``convert.jax_detector_variables_to_state_dict`` and loaded strict:

* the whole model at 128x128, batch 2, both head modes, BatchNorm in eval
  and in train mode: loc and cls within rtol 2e-3, atol 2e-4 x the
  output's largest magnitude (the other port tests' f32 bar), and the
  running statistics a train-mode pass leaves under the same bar per
  BatchNorm. The absolute head's ReLU zeroes about half of the anchors
  on both sides;
* ``anchor_centres``: equal to JAX's, and the anchor head with zero loc
  convs emits it exactly;
* ``find_best_coordinates`` on the model's outputs: the same points,
  scores (rtol 1e-5) and validity;
* the reference ``.pth`` import: the port's import of a reference-named
  state dict gives the forward of JAX's import and of the reference
  module itself.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpgan_tpu.models.mobilenet_v2 import anchor_centres as jax_anchor_centres
from tpgan_tpu.models.mobilenet_v2 import find_best_coordinates as jax_find_best
from tpgan_tpu.train.checkpoint import import_mobilenet_v2_pth as jax_import_pth
from tpgan_tpu_torch.convert import jax_detector_variables_to_state_dict
from tpgan_tpu_torch.models.mobilenet_v2 import (
    MobileNetV2,
    SSD_SCALES,
    anchor_centres,
    anchor_strides,
    find_best_coordinates,
)
from tpgan_tpu_torch.models.registry import get_model
from tpgan_tpu_torch.train.checkpoint import import_mobilenet_v2_pth

from _torch_detector import (
    TorchRef,
    bn_stats,
    detector_pair,
    images,
    jax_stats_as_port,
    port_outputs,
)

torch.set_num_threads(1)

OUT_RTOL, OUT_ATOL_SHARE = 2e-3, 2e-4


def _close(got, want, label):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=OUT_RTOL, atol=OUT_ATOL_SHARE * scale + 1e-12,
                               err_msg=label)


@pytest.fixture(scope="module", params=["absolute", "anchor_offset"])
def pair(request):
    return (request.param, *detector_pair(request.param, seed=3))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_detector_forward_matches_jax(pair, train):
    head_mode, jmod, variables, model = pair
    x = images(2, 4)
    loc, cls = port_outputs(model, x, train)
    if train:
        (jl, jc), mutated = jax.jit(lambda v, x: jmod.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables, x)
        want = jax_stats_as_port(variables["params"], mutated["batch_stats"])
        got = bn_stats(model)
        assert got.keys() == want.keys() and len(got) == 2 * (1 + 3 * 17 + 1)
        for k, v in want.items():
            _close(got[k], v, k)
        model.load_state_dict(jax_detector_variables_to_state_dict(variables), strict=True)
    else:
        jl, jc = jax.jit(jmod.apply)(variables, x)
    jl, jc = np.asarray(jl), np.asarray(jc)
    n = sum(a * (128 // 2 ** d) ** 2 if d < 7 else a
            for d, (_c, a) in zip((4, 5, 6, 7, 8, 9), SSD_SCALES))
    assert loc.shape == jl.shape == (2, n, 2) and cls.shape == jc.shape == (2, n, 5)
    if head_mode == "absolute":
        zeros = jl == 0
        assert 0.3 < zeros.mean() < 0.7  # the ReLU's corner, hit on both sides
        assert np.array_equal(loc[zeros], jl[zeros])
    else:
        assert (jl >= 0).all() and (jl <= 128).all() and (loc >= 0).all() and (loc <= 128).all()
    _close(loc, jl, "loc")
    _close(cls, jc, "cls")


@pytest.mark.parametrize("hw", [(128, 128), (256, 256), (96, 160)])
def test_anchor_centres_match_jax(hw):
    got = anchor_centres(hw).numpy()
    want = np.asarray(jax_anchor_centres(hw))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_anchor_head_with_zero_loc_convs_emits_the_anchor_grid():
    model = MobileNetV2(head_mode="anchor_offset", device="cpu").eval()
    with torch.no_grad():
        for j in range(len(SSD_SCALES)):
            getattr(model.ssd_head, f"loc{j}").weight.zero_()
            getattr(model.ssd_head, f"loc{j}").bias.zero_()
        loc, _ = model(torch.rand(2, 3, 96, 160))
        grid = anchor_centres((96, 160))
        assert torch.equal(loc[0], grid) and torch.equal(loc[1], grid)
        # a bias of 0.25 in every loc conv moves each anchor by a quarter
        # of its stride, in x and y (inside the image: no clip engages)
        for j in range(len(SSD_SCALES)):
            getattr(model.ssd_head, f"loc{j}").bias.fill_(0.25)
        moved, _ = model(torch.rand(1, 3, 96, 160))
    strides = anchor_strides((96, 160))
    assert strides.shape == grid.shape
    want = torch.tensor([(160 / w, 96 / h) for h, w in ((6, 10), (3, 5), (2, 3), (1, 2),
                                                          (1, 1))])
    assert {tuple(r) for r in strides.tolist()} == {tuple(r) for r in want.tolist()}
    inside = (grid + 0.25 * strides <= torch.tensor([160.0, 96.0])).all(dim=1)
    assert torch.allclose(((moved[0] - grid) / strides)[inside], torch.tensor(0.25))


def test_find_best_coordinates_matches_jax(pair):
    head_mode, jmod, variables, _model = pair
    jl, jc = jax.jit(jmod.apply)(variables, images(2, 5))
    got = find_best_coordinates(torch.from_numpy(np.array(jl)), torch.from_numpy(np.array(jc)))
    want = jax.jit(jax_find_best)(jl, jc)
    assert got.points.shape == (2, 5, 1, 2)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-5)


def test_import_mobilenet_v2_pth_matches_the_jax_importer(tmp_path):
    torch.manual_seed(0)
    ref = TorchRef()
    with torch.no_grad():  # non-trivial BatchNorm statistics
        ref.train()
        ref(torch.randn(2, 3, 128, 128))
    ref.eval()
    path = str(tmp_path / "model_epoch_0.pth")
    torch.save(ref.state_dict(), path)

    model = MobileNetV2(device="cpu")
    model.load_state_dict(import_mobilenet_v2_pth(path), strict=True)
    model.eval()
    x = images(2, 6)
    loc, cls = port_outputs(model, x, train=False)
    with torch.no_grad():
        rl, rc = ref(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    np.testing.assert_allclose(loc, rl.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cls, rc.numpy(), rtol=1e-5, atol=1e-5)

    from tpgan_tpu.models.mobilenet_v2 import MobileNetV2 as JMobileNetV2

    jl, jc = jax.jit(JMobileNetV2().apply)(jax_import_pth(path), jnp.asarray(x))
    _close(loc, np.asarray(jl), "loc")
    _close(cls, np.asarray(jc), "cls")


def test_converter_and_registry():
    _jmod, variables, _model = detector_pair("absolute", seed=1)
    sd = jax_detector_variables_to_state_dict(variables)
    p = variables["params"]
    np.testing.assert_array_equal(sd["block3.depthwise.weight"].numpy(),
                                  p["block3"]["depthwise"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["ssd_head.cls5.bias"].numpy(), p["ssd_head"]["cls5"]["bias"])
    np.testing.assert_array_equal(sd["conv2_bn.running_var"].numpy(),
                                  variables["batch_stats"]["conv2_bn"]["var"])
    with pytest.raises(ValueError, match="not a MobileNetV2 detector"):
        jax_detector_variables_to_state_dict({"params": {"base": {}}})
    for name in ("mobilenet_v2", "mobilenetv2", "MobileNetV2"):
        m = get_model(name, head_mode="anchor_offset", device="cpu")
        assert isinstance(m, MobileNetV2) and m.head_mode == "anchor_offset"
    with pytest.raises(KeyError, match="unknown model"):
        get_model("vgg16")
    with pytest.raises(ValueError, match="unknown head_mode"):
        MobileNetV2(head_mode="offset")
    # the head's and the extras' biases start at zero (bias_init)
    m = MobileNetV2(device="cpu")
    assert not m.ssd_head.loc0.bias.any() and not m.extra3.bias.any()
