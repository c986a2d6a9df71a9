"""The port's generator modules against the JAX package's at
fm_multiplier 0.25 (local_feature_layer_dim 16), in float32 on the CPU:
LocalPathway, GlobalPathway and the whole Generator with all 8
GeneratorOutput fields, for each upsample mode and once with BatchNorm
(eval mode, running statistics). Weights are drawn with numpy over the
JAX init tree and carried across by ``tpgan_tpu_torch.convert``, loaded
with ``strict=True``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpgan_tpu.config import make_config as jax_make_config
from tpgan_tpu.models.global_pathway import GlobalPathway as JGlobalPathway
from tpgan_tpu.models.local_pathway import LocalPathway as JLocalPathway
from tpgan_tpu.train.gan_trainer import build_models
from tpgan_tpu_torch.config import make_config
from tpgan_tpu_torch.models.generator import GeneratorOutput
from tpgan_tpu_torch.models.global_pathway import GlobalPathway
from tpgan_tpu_torch.models.local_pathway import LocalPathway
from tpgan_tpu_torch.train.gan_trainer import build_generator, make_synthesize_fn

from _torch_port import F32_TOL, init_numpy, jax_variables, load_port, nchw, nhwc

torch.set_num_threads(1)

MODES = ["deconv", "subpixel", "resize_conv"]
SMALL = {"fm_multiplier": 0.25, "local_feature_layer_dim": 16}
PATCHES = ((128, 128), (40, 40), (40, 40), (32, 40), (32, 48))


def _inputs(b=2, seed=0):
    rng = np.random.RandomState(seed)
    imgs = [rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32) for h, w in PATCHES]
    z = rng.standard_normal((b, 64)).astype(np.float32)
    return imgs, z


def _cfgs(mode, use_batchnorm=False):
    ov = {"G": dict(SMALL, upsample_mode=mode, use_batchnorm=use_batchnorm),
          "compute_dtype": "float32"}
    return jax_make_config(ov), make_config(ov)


@pytest.mark.parametrize("mode", MODES)
def test_local_pathway_matches_jax(mode):
    x = _inputs()[0][1]
    jmod = JLocalPathway(use_batchnorm=False, feature_layer_dim=16, fm_multiplier=0.25,
                         upsample_mode=mode)
    params, stats = init_numpy(jmod, x, seed=1)
    want_img, want_feat = jax.jit(jmod.apply)(jax_variables(params, stats), x)
    tmod = load_port(LocalPathway(False, 16, 0.25, mode), params, stats)
    with torch.no_grad():
        img, feat = tmod(torch.from_numpy(nchw(x)))
    # the feature output is the raw deconv2 activation: ReLU'd, 16 channels
    assert feat.shape == (2, 16, 40, 40) and float(feat.min()) >= 0.0
    np.testing.assert_allclose(nhwc(img.numpy()), np.asarray(want_img), **F32_TOL)
    np.testing.assert_allclose(nhwc(feat.numpy()), np.asarray(want_feat), **F32_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_global_pathway_matches_jax(mode):
    imgs, z = _inputs(seed=2)
    rng = np.random.RandomState(3)
    local_fake = rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    local_feature = np.maximum(rng.standard_normal((2, 128, 128, 16)), 0).astype(np.float32)
    args = (imgs[0], local_fake, local_feature, z)
    jmod = JGlobalPathway(zdim=64, local_feature_layer_dim=16, use_batchnorm=False,
                          fm_multiplier=0.25, upsample_mode=mode)
    params, stats = init_numpy(jmod, *args, seed=4)
    want_img, want_fc2 = jax.jit(jmod.apply)(jax_variables(params, stats), *args)
    # nested under its Generator name: the converter permutes
    # global_pathway.fc1 by path
    holder = torch.nn.Module()
    holder.global_pathway = GlobalPathway(
        64, 16, use_batchnorm=False, fm_multiplier=0.25, upsample_mode=mode
    )
    load_port(holder, {"global_pathway": params})
    with torch.no_grad():
        img, fc2 = holder.global_pathway(
            *(torch.from_numpy(nchw(a)) for a in args[:3]), torch.from_numpy(z)
        )
    np.testing.assert_allclose(nhwc(img.numpy()), np.asarray(want_img), **F32_TOL)
    np.testing.assert_allclose(fc2.numpy(), np.asarray(want_fc2), **F32_TOL)


def _generator_pair(mode, use_batchnorm, seed):
    jcfg, cfg = _cfgs(mode, use_batchnorm)
    jgen, _ = build_models(jcfg)
    imgs, z = _inputs(seed=seed)
    params, stats = init_numpy(jgen, *imgs, z, seed=seed)
    want = jax.jit(jgen.clone(accum_f32=True).apply)(jax_variables(params, stats), *imgs, z)
    gen = load_port(build_generator(cfg, "cpu"), params, stats)
    with torch.no_grad():
        got = gen(*(torch.from_numpy(nchw(a)) for a in imgs), torch.from_numpy(z))
    return got, want


@pytest.mark.parametrize(
    "mode,use_batchnorm", [(m, False) for m in MODES] + [("deconv", True)]
)
def test_generator_all_outputs_match_jax(mode, use_batchnorm):
    got, want = _generator_pair(mode, use_batchnorm, seed=5)
    assert isinstance(got, GeneratorOutput) and got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        g = g.numpy()
        g = nhwc(g) if g.ndim == 4 else g
        assert g.shape == np.asarray(w).shape, name
        np.testing.assert_allclose(g, np.asarray(w), err_msg=name, **F32_TOL)


def test_fc1_flatten_is_permuted_not_reshaped():
    """The JAX fc1 reads conv4 flattened HWC; the port flattens CHW, so
    the converter must permute fc1's columns. A converter that only
    transposed the kernel would feed fc1 scrambled inputs: check the
    permutation against a direct NHWC-flatten product."""
    from tpgan_tpu_torch.convert import jax_generator_params_to_state_dict

    c = 128  # enc[4] at fm 0.25
    rng = np.random.RandomState(6)
    kernel = rng.standard_normal((8 * 8 * c, 512)).astype(np.float32)
    conv4 = rng.standard_normal((2, 8, 8, c)).astype(np.float32)
    sd = jax_generator_params_to_state_dict(
        {"global_pathway": {"fc1": {"kernel": kernel, "bias": np.zeros(512, np.float32)}}}
    )
    w = sd["global_pathway.fc1.weight"].numpy()
    want = conv4.reshape(2, -1) @ kernel
    got = nchw(conv4).reshape(2, -1) @ w.T
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert not np.allclose(nchw(conv4).reshape(2, -1) @ kernel, want, atol=1e-2)


def test_bf16_serving_copy_keeps_weights_and_batchnorm_f32():
    """make_synthesize_fn in bfloat16 works on a bf16 copy: the caller's
    generator keeps f32 weights, BatchNorm stays f32, and the output is
    NHWC bf16 near the f32 output (bf16 keeps 8 mantissa bits, so the
    bound is loose: 5% of the output's range)."""
    _jcfg, cfg = _cfgs("deconv", use_batchnorm=True)
    gen = build_generator(cfg, "cpu", seed=1)
    imgs, z = _inputs(b=1, seed=7)
    batch = dict(zip(("img", "left_eye", "right_eye", "nose", "mouth"), imgs))
    ref = make_synthesize_fn(cfg, gen)(batch, z)
    cfg16 = make_config({"G": dict(SMALL, use_batchnorm=True), "compute_dtype": "bfloat16"})
    out = make_synthesize_fn(cfg16, gen)(batch, z)
    assert out.shape == (1, 128, 128, 3) and out.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in gen.parameters())
    err = (out.float() - ref).abs().max().item()
    assert err <= 0.05 * ref.abs().max().item(), err


def test_seeded_build_is_reproducible():
    _jcfg, cfg = _cfgs("deconv")
    a = build_generator(cfg, "cpu", seed=3).state_dict()
    b = build_generator(cfg, "cpu", seed=3).state_dict()
    c = build_generator(cfg, "cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["global_pathway.fc1.weight"], c["global_pathway.fc1.weight"])


def test_dropout_without_generator_or_mask_raises():
    _jcfg, cfg = _cfgs("deconv")
    gen = build_generator(cfg, "cpu", seed=0)
    imgs, z = _inputs(seed=8)
    with pytest.raises(ValueError, match="torch.Generator or a keep_mask"):
        gen(*(torch.from_numpy(nchw(a)) for a in imgs), torch.from_numpy(z), use_dropout=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_injected_mask_reproduces_jax_dropout_exactly(dtype):
    """FeaturePredict's dropout with JAX's mask: where(mask, x / keep, 0),
    keep = 0.7 taken in x's dtype, bit for bit."""
    import flax.linen as fnn

    from tpgan_tpu_torch.models.generator import apply_dropout

    x = np.random.RandomState(9).standard_normal((4, 256)).astype(np.float32)
    jx = jnp.asarray(x, dtype=dtype)
    want = fnn.Dropout(rate=0.3).apply({}, jx, deterministic=False,
                                       rngs={"dropout": jax.random.PRNGKey(3)})
    want = np.asarray(want.astype(jnp.float32))
    mask = torch.from_numpy(want != 0)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = apply_dropout(tx, mask, 0.3)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_dropout_draws_from_the_explicit_generator():
    _jcfg, cfg = _cfgs("deconv")
    gen = build_generator(cfg, "cpu", seed=0)
    imgs, z = _inputs(seed=10)
    args = [torch.from_numpy(nchw(a)) for a in imgs] + [torch.from_numpy(z)]
    with torch.no_grad():
        runs = [gen(*args, use_dropout=True,
                    dropout_generator=torch.Generator().manual_seed(s)).encoder_predict
                for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
