"""The port's identity embedders (``tpgan_tpu_torch.models.resnet``,
``.mobilenet_v2``, ``.feature_extract``) and their converter against the
JAX package on the CPU, on the same numpy-drawn weights
(``tests/_torch_port.py``), carried across by
``convert.jax_embedder_variables_to_state_dict`` and loaded strict:

* ``max_pool_3x3_s2``: exact;
* ResNet18 with and without fc0, and MobileNetV2Classifier (depthwise
  ``groups``), in eval and train-mode BatchNorm: logits and features at
  rtol 2e-3, atol 2e-4 x the output's largest magnitude, and the running
  statistics a train-mode pass leaves under the same bar per BatchNorm
  (they are means of activations, which carry the same f32 noise, and JAX
  takes the variance as E[x^2] - E[x]^2 where torch does not);
* ``make_identity_embed_fn`` in f32 and bf16: the gradient of the L1
  identity loss with respect to the input image against ``jax.grad``
  (f32: rtol 2e-3, atol 2e-3 of its largest element), no embedder
  parameter given a gradient, no weight or BatchNorm statistic moved. In
  bf16 the features are held within 5% of the f32 features' range (the
  bf16 forward bar of the other port tests), and the gradient in relative
  L2 within BF16_GRAD_REL_L2 of JAX's bf16 gradient and of the f32 one:
  the L1 gradient is the sign of each feature difference, and bf16 flips
  about 7% of those signs, which puts JAX's own bf16 gradient 0.14 from
  its f32 one (relative L2, these weights), and the port's 0.15 from JAX's
  bf16 one.

64x64 inputs keep the run short; the 128x128 width is the step's
(tests/test_torch_train_step_identity.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpgan_tpu.losses.pixel import l1 as jax_l1
from tpgan_tpu.models.feature_extract import FeatureExtractModel as JFeatureExtractModel
from tpgan_tpu.models.feature_extract import make_identity_embed_fn as jax_embed_fn
from tpgan_tpu.models.mobilenet_v2 import InvertedResidual as JInvertedResidual
from tpgan_tpu.models.resnet import ResNet18 as JResNet18
from tpgan_tpu.models.resnet import max_pool_3x3_s2 as jax_max_pool
from tpgan_tpu_torch.convert import jax_embedder_variables_to_state_dict
from tpgan_tpu_torch.losses.pixel import l1
from tpgan_tpu_torch.models.feature_extract import (
    FeatureExtractModel,
    cast_embedder,
    make_identity_embed_fn,
)
from tpgan_tpu_torch.models.mobilenet_v2 import InvertedResidual
from tpgan_tpu_torch.models.resnet import ResNet18, max_pool_3x3_s2

from _torch_port import init_numpy, nchw, nhwc

torch.set_num_threads(1)

OUT_RTOL, OUT_ATOL_SHARE = 2e-3, 2e-4
BF16_REL_DIFF = 0.05
BF16_GRAD_REL_L2 = 0.25


def _close(got, want, label):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=OUT_RTOL, atol=OUT_ATOL_SHARE * scale + 1e-12,
                               err_msg=label)


def _images(shape, seed):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


def _port_model(jmod_vars, base, classes, fdim=256):
    model = FeatureExtractModel(base, classes, feature_layer_dim_before_fc=fdim, device="cpu")
    model.load_state_dict(jax_embedder_variables_to_state_dict(jmod_vars, base), strict=True)
    return model


def _stats(model):
    return {k: v.numpy().copy() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _jax_stats_as_port(variables, base):
    sd = jax_embedder_variables_to_state_dict(variables, base)
    return {k: v.numpy() for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def test_max_pool_matches_jax():
    x = _images((2, 9, 11, 5), 0)
    x[0, 0:3, 0:3, 0] = 0.25  # a tied window
    got = max_pool_3x3_s2(torch.from_numpy(nchw(x))).numpy()
    np.testing.assert_array_equal(nhwc(got), np.asarray(jax_max_pool(jnp.asarray(x))))


@pytest.fixture(scope="module")
def resnet_pair():
    """JAX FeatureExtractModel(resnet) variables at 64x64, 10 classes."""
    jmod = JFeatureExtractModel(base_model_name="resnet", num_of_output_classes=10)
    x = _images((4, 64, 64, 3), 1)
    params, stats = init_numpy(jmod, jnp.asarray(x[:1]), seed=3)
    return jmod, {"params": params, "batch_stats": stats}, x


@pytest.mark.parametrize("train", [False, True])
def test_resnet18_with_fc0_matches_jax(resnet_pair, train):
    jmod, variables, x = resnet_pair
    model = _port_model(variables, "resnet", 10)
    model.train(train)
    with torch.no_grad():
        logits, feats = model(torch.from_numpy(nchw(x)))
    if train:
        (jl, jf), mutated = jax.jit(lambda v, x: jmod.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables, x)
        want_stats = _jax_stats_as_port({"params": variables["params"], **mutated}, "resnet")
        got_stats = _stats(model)
        assert got_stats.keys() == want_stats.keys()
        for k, v in want_stats.items():
            _close(got_stats[k], v, k)
        # the pass moved the statistics
        assert not np.allclose(want_stats["base.conv1.bn.running_mean"],
                               variables["batch_stats"]["base"]["conv1"]["bn"]["mean"])
    else:
        jl, jf = jax.jit(jmod.apply)(variables, x)
    assert logits.shape == (4, 10) and feats.shape == (4, 256)
    _close(logits.numpy(), np.asarray(jl), "logits")
    _close(feats.numpy(), np.asarray(jf), "fc0")


def test_resnet18_without_fc0_matches_jax():
    jmod = JResNet18(num_of_output_classes=7)
    x = _images((2, 64, 64, 3), 2)
    params, stats = init_numpy(jmod, jnp.asarray(x[:1]), seed=4)
    variables = {"params": params, "batch_stats": stats}
    model = ResNet18(num_of_output_classes=7, device="cpu")
    sd = jax_embedder_variables_to_state_dict(
        {"params": {"base": params}, "batch_stats": {"base": stats}}, "resnet")
    model.load_state_dict({k[len("base."):]: v for k, v in sd.items()}, strict=True)
    model.eval()
    with torch.no_grad():
        logits, fc0 = model(torch.from_numpy(nchw(x)))
    jl, jfc0 = jax.jit(jmod.apply)(variables, x)
    assert fc0 is None and jfc0 is None
    _close(logits.numpy(), np.asarray(jl), "logits")


@pytest.mark.parametrize("train", [False, True])
def test_mobilenet_v2_classifier_matches_jax(train):
    jmod = JFeatureExtractModel(base_model_name="mobilenetv2", num_of_output_classes=11)
    # 64x64 leaves 2x2 maps at the last blocks: at 32x32 their train-mode
    # BatchNorm normalises 4 values per channel, where JAX's E[x^2] - E[x]^2
    # cancels (its logits there are 1e-3 of their max off the port's)
    x = _images((4, 64, 64, 3), 5)
    params, stats = init_numpy(jmod, jnp.asarray(x[:1]), seed=6)
    variables = {"params": params, "batch_stats": stats}
    model = _port_model(variables, "mobilenetv2", 11)
    # the depthwise convs are grouped, one group per channel
    dw = model.base.block1.depthwise
    assert dw.groups == 96 and tuple(dw.weight.shape) == (96, 1, 3, 3)
    model.train(train)
    with torch.no_grad():
        logits, pooled = model(torch.from_numpy(nchw(x)))
    if train:
        (jl, jp), mutated = jax.jit(lambda v, x: jmod.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables, x)
        want_stats = _jax_stats_as_port({"params": params, **mutated}, "mobilenetv2")
        got_stats = _stats(model)
        assert got_stats.keys() == want_stats.keys()
        for k, v in want_stats.items():
            _close(got_stats[k], v, k)
    else:
        jl, jp = jax.jit(jmod.apply)(variables, x)
    assert logits.shape == (4, 11) and pooled.shape == (4, 1280)
    _close(logits.numpy(), np.asarray(jl), "logits")
    _close(pooled.numpy(), np.asarray(jp), "pooled")


@pytest.mark.parametrize("inp,oup,stride,t", [(16, 16, 1, 6), (16, 24, 2, 6), (8, 8, 1, 1)])
def test_inverted_residual_matches_jax(inp, oup, stride, t):
    jblk = JInvertedResidual(inp, oup, stride, t)
    x = _images((2, 9, 9, inp), 7)
    params, stats = init_numpy(jblk, jnp.asarray(x), seed=8)
    blk = InvertedResidual(inp, oup, stride, t, device="cpu")
    sd = jax_embedder_variables_to_state_dict(
        {"params": {"base": {"stem": {}, **params}}, "batch_stats": {"base": stats}},
        "mobilenetv2")
    blk.load_state_dict({k[len("base."):]: v for k, v in sd.items()}, strict=True)
    blk.eval()
    with torch.no_grad():
        got = blk(torch.from_numpy(nchw(x))).numpy()
    want = np.asarray(jax.jit(jblk.apply)({"params": params, "batch_stats": stats}, x))
    assert blk.residual == (stride == 1 and inp == oup)
    _close(nhwc(got), want, "block")


def test_converter_maps_layouts_and_checks_the_backbone():
    jmod = JFeatureExtractModel(base_model_name="mobilenetv2", num_of_output_classes=5)
    params, stats = init_numpy(jmod, jnp.zeros((1, 32, 32, 3)), seed=9)
    sd = jax_embedder_variables_to_state_dict({"params": params, "batch_stats": stats},
                                              "mobilenetv2")
    dw = params["base"]["block3"]["depthwise"]["kernel"]  # (3, 3, 1, 144)
    np.testing.assert_array_equal(sd["base.block3.depthwise.weight"].numpy(),
                                  dw.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["base.fc.weight"].numpy(),
                                  params["base"]["fc"]["kernel"].T)
    np.testing.assert_array_equal(sd["base.stem_bn.running_var"].numpy(),
                                  stats["base"]["stem_bn"]["var"])
    np.testing.assert_array_equal(sd["base.block3.expand_bn.weight"].numpy(),
                                  params["base"]["block3"]["expand_bn"]["scale"])
    with pytest.raises(ValueError, match="no base.conv1"):
        jax_embedder_variables_to_state_dict({"params": params, "batch_stats": stats}, "resnet")
    with pytest.raises(ValueError, match="unknown embedder backbone"):
        jax_embedder_variables_to_state_dict({"params": params}, "vgg")


def _identity_grad_jax(jmod, variables, fake, gt):
    embed = jax_embed_fn(jmod, variables)
    # gt is an argument: closed over, XLA would constant-fold its embedding
    grad = jax.jit(jax.grad(lambda f, g: jax_l1(embed(f), embed(g))))
    return np.asarray(grad(fake, gt)), np.asarray(jax.jit(embed)(fake))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_identity_embed_fn_gradient_matches_jax_grad(resnet_pair, dtype):
    jmod, variables, x = resnet_pair
    fake, gt = x[:2], _images((2, 64, 64, 3), 11)
    want32, feats32 = _identity_grad_jax(jmod, variables, fake, gt)
    model = _port_model(variables, "resnet", 10)
    if dtype == "bfloat16":
        cast_embedder(model, torch.bfloat16)
        jmod16 = JFeatureExtractModel(base_model_name="resnet", num_of_output_classes=10,
                                      dtype=jnp.bfloat16, accum_f32=False)
        v16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), variables)
        want, _ = _identity_grad_jax(jmod16, v16, fake, gt)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    embed = make_identity_embed_fn(model)
    f = torch.from_numpy(nchw(fake)).requires_grad_()
    feats = embed(f)
    loss = l1(feats, embed(torch.from_numpy(nchw(gt))))
    loss.backward()
    got = nhwc(f.grad.numpy())
    assert f.grad.dtype == torch.float32 and np.isfinite(got).all() and np.abs(got).max() > 0
    assert all(p.grad is None and not p.requires_grad for p in model.parameters())
    assert not model.training
    for k, v in model.state_dict().items():  # no statistic or weight moved
        assert torch.equal(v, before[k]), k
    if dtype == "float32":
        np.testing.assert_allclose(got, want32, rtol=2e-3, atol=2e-3 * np.abs(want32).max())
        return
    assert model.base.conv1.conv.weight.dtype == torch.bfloat16
    assert model.base.conv1.bn.weight.dtype == torch.float32
    assert feats.dtype == torch.bfloat16
    diff = np.abs(feats.detach().float().numpy() - feats32).max()
    assert diff <= BF16_REL_DIFF * np.abs(feats32).max(), diff
    for ref in (want, want32):
        rel = np.linalg.norm(got - ref) / np.linalg.norm(want32)
        assert rel <= BF16_GRAD_REL_L2, rel
