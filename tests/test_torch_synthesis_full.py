"""The port's full-size (fm_multiplier 1.0, ``deconv``) synthesis
function against the JAX package's ``make_synthesize_fn``, batch 1 in
float32 on the CPU, with the same weights carried across by
``tpgan_tpu_torch.convert`` and loaded with ``strict=True``. Kept in its
own file so ``--dist loadfile`` gives it a worker of its own."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from tpgan_tpu.config import make_config as jax_make_config
from tpgan_tpu.train.gan_trainer import build_models
from tpgan_tpu.train.gan_trainer import make_synthesize_fn as jax_make_synthesize_fn
from tpgan_tpu_torch.config import make_config
from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
from tpgan_tpu_torch.train.gan_trainer import build_generator, make_synthesize_fn

from _torch_port import F32_TOL, init_numpy, load_port

torch.set_num_threads(1)

KEYS = ("img", "left_eye", "right_eye", "nose", "mouth")


def test_full_size_synthesis_matches_jax():
    overrides = {"compute_dtype": "float32"}
    jcfg, cfg = jax_make_config(overrides), make_config(overrides)
    assert cfg.G.fm_multiplier == 1.0 and cfg.G.upsample_mode == "deconv"
    batch = {k: v for k, v in synthetic_gan_batch(1, seed=11).items() if k in KEYS}
    z = np.random.RandomState(12).standard_normal((1, cfg.G.zdim)).astype(np.float32)

    jgen, _ = build_models(jcfg)
    params, stats = init_numpy(jgen, *(batch[k] for k in KEYS), z, seed=13)
    assert stats is None  # the serving config has no BatchNorm
    want = np.asarray(
        jax.jit(jax_make_synthesize_fn(jcfg, jgen))(
            params, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(z)
        )
    )

    gen = load_port(build_generator(cfg, "cpu"), params)
    # the full-size concat widths the converter and the modules must agree on
    gp = gen.global_pathway
    assert gp.add_128.conv0.conv.weight.shape[1] == 75
    assert gp.enhance_128.conv0.conv.weight.shape[1] == 64 + 75 + 64 + 3
    assert gp.fc1.weight.shape == (512, 512 * 8 * 8)
    got = make_synthesize_fn(cfg, gen)(batch, z)

    assert got.shape == (1, 128, 128, 3) and got.dtype == torch.float32
    assert np.isfinite(want).all() and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
