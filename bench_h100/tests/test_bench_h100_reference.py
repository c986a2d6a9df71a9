"""The plain reference against the port's eager path on the CPU, in
float32, on the same seeded weights and inputs: the reference describes
the same models, loss and optimizer step."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from bench_h100 import weights
from bench_h100.drivers.pretrain import make_pool
from bench_h100.reference import detector as det_ref
from bench_h100.reference import tpgan as gan_ref
from bench_h100.reference.net import Net


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(4)


def _gan_weights():
    return (weights.make(gan_ref.spec("generator").spec, 11, "cpu"),
            weights.make(gan_ref.spec("critic").spec, 12, "cpu"),
            weights.make(gan_ref.spec("embedder").spec, 13, "cpu"))


def test_every_leaf_of_the_port_is_described():
    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.models.feature_extract import build_feature_extract_model
    from tpgan_tpu_torch.models.mobilenet_v2 import MobileNetV2
    from tpgan_tpu_torch.train.gan_trainer import build_models

    cfg = make_config()
    gen, disc = build_models(cfg, "cpu")
    for module, net in ((gen, gan_ref.spec("generator")), (disc, gan_ref.spec("critic")),
                        (build_feature_extract_model(cfg, "cpu"), gan_ref.spec("embedder")),
                        (MobileNetV2(device="cpu"), det_ref.spec())):
        sd = module.state_dict()
        assert set(sd) == set(net.spec)
        assert all(tuple(sd[k].shape) == net.spec[k].shape for k in sd)


def test_gan_step_matches_the_port_in_float32():
    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
    from tpgan_tpu_torch.models.feature_extract import (build_feature_extract_model,
                                                        make_identity_embed_fn)
    from tpgan_tpu_torch.train.gan_trainer import create_gan_state, make_gan_train_step

    cfg = make_config({"compute_dtype": "float32"})
    gw, dw, ew = _gan_weights()
    state, gen, disc, g_opt, d_opt = create_gan_state(cfg, 0, "cpu")
    weights.load(gen, gw)
    weights.load(disc, dw)
    emb = build_feature_extract_model(cfg, "cpu")
    weights.load(emb, ew)
    step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt, make_identity_embed_fn(emb))
    batch = synthetic_gan_batch(2, 0)
    z, eps, keep_d, keep_g = gan_ref.draw_noise(torch.Generator().manual_seed(5), 2)
    state, metrics = step(state, batch, torch.Generator(),
                          noise={"z": z, "gp_eps": eps, "drop_mask_d": keep_d,
                                 "drop_mask_g": keep_g})

    gref = {k: v.clone().requires_grad_(True) for k, v in gw.items()}
    dref = {k: v.clone().requires_grad_(True) for k, v in dw.items()}
    opt_g, opt_d = gan_ref.Adam(gref, 1e-4, 0.5, 0.9), gan_ref.Adam(dref, 1e-4, 0.5, 0.9)
    nchw = {k: (torch.as_tensor(v).permute(0, 3, 1, 2).contiguous() if v.ndim == 4
                else torch.as_tensor(v)) for k, v in batch.items()}
    out = gan_ref.gan_step(gref, dref, ew, opt_g, opt_d, nchw, (z, eps, keep_d, keep_g),
                           dataclasses.asdict(cfg.loss))
    for name in ("d_loss", "g_loss"):
        assert abs(float(metrics[name]) - out[name]) <= 1e-5 * abs(out[name])
    for opt_port, opt_ref, module, w0, ref in ((g_opt, opt_g, gen, gw, gref),
                                               (d_opt, opt_d, disc, dw, dref)):
        moved, apart = 0.0, 0.0
        for n, p in module.named_parameters():
            m_port, m_ref = opt_port.state[p]["exp_avg"], opt_ref.m[n]
            assert torch.allclose(m_port, m_ref, rtol=1e-3, atol=1e-6 * float(m_ref.abs().max()))
            # Adam moves a weight by about the learning rate whatever its
            # gradient's size, so a gradient at round-off can move it either way
            moved += float((ref[n].detach() - w0[n]).square().sum())
            apart += float((p.detach() - ref[n].detach()).square().sum())
        assert apart ** 0.5 <= 1e-2 * moved ** 0.5


def test_synthesis_matches_the_port_in_float32():
    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.train.gan_trainer import build_generator, make_synthesize_fn

    cfg = make_config({"compute_dtype": "float32"})
    gw, _, _ = _gan_weights()
    gen = build_generator(cfg, "cpu")
    weights.load(gen, gw)
    rng = np.random.RandomState(0)
    shapes = {"img": (128, 128), "left_eye": (40, 40), "right_eye": (40, 40),
              "nose": (32, 40), "mouth": (32, 48)}
    batch = {k: torch.from_numpy(rng.uniform(-1, 1, (1, h, w, 3)).astype(np.float32))
             for k, (h, w) in shapes.items()}
    z = torch.from_numpy(rng.randn(1, 64).astype(np.float32))
    port = make_synthesize_fn(cfg, gen)(batch, z)
    ref = gan_ref.synthesize(gw, {k: v.permute(0, 3, 1, 2) for k, v in batch.items()}, z)
    assert torch.allclose(port, ref.permute(0, 2, 3, 1), rtol=1e-4,
                          atol=1e-5 * float(ref.abs().max()))


def test_detector_step_matches_the_port_in_float32():
    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.train.pretrain import create_pretrain_state, make_pretrain_step

    cfg = make_config({"pretrain": {"image_size": 128}})
    w = weights.make(det_ref.spec(128).spec, 3, "cpu")
    state, model, opt = create_pretrain_state(cfg, 0, "cpu", steps_per_epoch=100)
    weights.load(model, w)
    step = make_pretrain_step(cfg, model, opt, state.scheduler)
    images, labels = make_pool(4, 128, 7, "cpu")
    g = torch.Generator().manual_seed(9)
    before = g.get_state()
    state, metrics, aux = step(state, images, labels, g, return_aux=True)

    params = {k: v.clone().requires_grad_(True) for k, v in w.items()
              if v.dtype.is_floating_point and "running" not in k}
    buffers = {k: v for k, v in w.items() if k not in params}
    sgd = det_ref.SGD(params, 5e-4, 0.9, 5e-4)
    g2 = torch.Generator()
    g2.set_state(before)
    u = torch.rand((4, aux["loc"].shape[1]), generator=g2)
    loss, loc, cls = det_ref.pretrain_step(params, buffers, sgd, images, labels, u,
                                           dataclasses.asdict(cfg.pretrain.loss))
    assert abs(float(metrics["loss"]) - loss) <= 1e-5 * abs(loss)
    # the seeded MobileNetV2 is ill-conditioned in float32 (its train-mode
    # BatchNorm over four images): 1e-4 of the predictions' norm
    assert float((aux["loc"] - loc).norm()) <= 1e-4 * float(loc.norm())
    assert torch.equal(det_ref.assignment(aux["loc"], labels, 0.1), aux["assigned"])
    # each leaf's step within 2.5e-2 of the larger of its length and the
    # median leaf's (the port's own bar for this ill-conditioned float32
    # model, tests/test_torch_cuda.py; a bias ahead of a BatchNorm has a
    # gradient at round-off)
    moved = {n: float((params[n].detach() - w[n]).norm()) for n in params}
    median = sorted(moved.values())[len(moved) // 2]
    for n, p in model.named_parameters():
        gap = float((p.detach() - params[n].detach()).norm())
        assert gap <= 2.5e-2 * max(moved[n], median), n


def test_a_rounded_net_differs_and_a_plain_one_does_not():
    x = torch.randn(2, 3, 8, 8)
    w = {"c.weight": torch.randn(4, 3, 3, 3), "c.bias": torch.zeros(4)}
    plain = Net(w).conv(x, "c", 4, 3, 1, 1)
    assert torch.equal(plain, torch.nn.functional.conv2d(x, w["c.weight"], w["c.bias"], 1, 1))
    rounded = Net(w, rounding=lambda t: t.to(torch.bfloat16).float()).conv(x, "c", 4, 3, 1, 1)
    assert not torch.equal(plain, rounded)
