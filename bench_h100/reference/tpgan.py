"""Plain float32 TP-GAN: the two-pathway generator, the PatchGAN critic,
the frozen ResNet18 identity embedder, the 11-term generator loss, the
WGAN-GP critic loss and Adam, written from the published architecture
(arXiv 1704.04086; the reference implementation's D_and_G_model.py,
config.py:50-85) with the two deviations the port documents kept, so
that the same weights mean the same model: ``add_128`` takes 75 channels
(``cat[deconv_128, conv0, i128]``) and the critic's residual blocks carry
no BatchNorm.

Everything is a function of a weight dict keyed by the parameter names of
the port's modules (``local_left_eye.conv0_conv.conv.weight``, ...), so
the benchmark hands the same tensors to both sides; a name or a shape the
port does not hold fails its ``load_state_dict(strict=True)``.

Images are NCHW. No batch norm in the generator or the critic (the
configuration's ``use_batchnorm`` is off for both); the embedder's is in
eval mode.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from bench_h100.reference.net import PLAIN, SQRT2, Net, lrelu

# name -> ((height, width), (top, left)) on the 128x128 canvas
PARTS = {
    "left_eye": ((40, 40), (19, 18)),
    "right_eye": ((40, 40), (18, 65)),
    "nose": ((32, 40), (47, 43)),
    "mouth": ((32, 48), (72, 40)),
}
CANVAS = 128
FRONTAL_KEYS = ("left_eye_frontal", "right_eye_frontal", "nose_frontal", "mouth_frontal")
DROPOUT = 0.3


def fuse(parts) -> torch.Tensor:
    """Each part max-ed into its slot of a zero canvas."""
    b, c = parts[0].shape[:2]
    out = parts[0].new_zeros(b, c, CANVAS, CANVAS)
    for part, ((h, w), (top, left)) in zip(parts, PARTS.values()):
        placed = F.pad(part, (left, CANVAS - left - w, top, CANVAS - top - h), value=float("-inf"))
        out = torch.maximum(out, placed)
    return out


def conv_block(net: Net, x, name, cout, k, stride=1, padding=0, act=lrelu, gain=None):
    y = net.conv(x, f"{name}.conv", cout, k, stride, padding,
                 gain=(SQRT2 if act is not None else PLAIN) if gain is None else gain)
    return act(y) if act is not None else y


def deconv_block(net: Net, x, name, cout, k, stride, padding, output_padding):
    return F.relu(net.deconv(x, f"{name}.deconv", cout, k, stride, padding, output_padding))


def res_block(net: Net, x, name, k=3, padding=None, act=lrelu):
    """act(conv1(act(conv0(x))) + x), both convs k x k, width kept."""
    c = x.shape[1]
    pad = (k - 1) // 2 if padding is None else padding
    h = conv_block(net, x, f"{name}.conv0", c, k, 1, pad, act)
    h = conv_block(net, h, f"{name}.conv1", c, k, 1, pad, None)
    return act(h + x)


def local_pathway(net: Net, x, name: str, feature_dim: int = 64):
    """(3-channel patch, feature map): encoder 64/128/256/512 with a
    residual block each, three transposed-conv decoder stages with skip
    concats, a 1x1 conv to the patch."""
    skips = []
    h = x
    for i, (cout, stride) in enumerate(((64, 1), (128, 2), (256, 2), (512, 2))):
        h = conv_block(net, h, f"{name}.conv{i}_conv", cout, 3, stride, 1)
        h = res_block(net, h, f"{name}.conv{i}_res")
        skips.append(h)
    for j, (cout, skip) in enumerate(zip((256, 128, feature_dim), skips[2::-1])):
        feat = deconv_block(net, h, f"{name}.dec{j}_deconv", cout, 3, 2, 1, 1)
        h = torch.cat([feat, skip], dim=1)
        h = conv_block(net, h, f"{name}.dec{j}_select_conv", cout, 3, 1, 1)
        h = res_block(net, h, f"{name}.dec{j}_select_res")
    return conv_block(net, h, f"{name}.local_img", 3, 1, 1, 0, None), feat


ENCODER = (("conv0", 7, 1, 3, 1, 64), ("conv1", 5, 2, 2, 1, 64), ("conv2", 3, 2, 1, 1, 128),
           ("conv3", 3, 2, 1, 1, 256), ("conv4", 3, 2, 1, 4, 512))


def global_pathway(net: Net, i128, local_img, local_feat, z, name="global_pathway"):
    """(128x128 image, 256-d bottleneck feature)."""
    skips = []
    h = i128
    for enc, k, stride, pad, n_res, cout in ENCODER:
        h = conv_block(net, h, f"{name}.{enc}_conv", cout, k, stride, pad)
        for i in range(n_res):
            h = res_block(net, h, f"{name}.{enc}_res{i}", k, pad)
        skips.append(h)
    conv0, conv1, conv2, conv3, conv4 = skips
    b = conv4.shape[0]
    fc1 = net.linear(conv4.reshape(b, -1), f"{name}.fc1", 512)
    fc2 = fc1.reshape(b, 256, 2).amax(dim=-1)
    trunk = torch.cat([fc2, z], dim=1)[:, :, None, None]
    d8 = deconv_block(net, trunk, f"{name}.deconv_8", 64, 8, 1, 0, 0)
    d32 = deconv_block(net, d8, f"{name}.deconv_32", 32, 3, 4, 0, 1)
    d64 = deconv_block(net, d32, f"{name}.deconv_64", 16, 3, 2, 1, 1)
    d128 = deconv_block(net, d64, f"{name}.deconv_128", 8, 3, 2, 1, 1)

    refl = (1, 0, 1, 0)
    h = res_block(net, torch.cat([d8, conv4], dim=1), f"{name}.add_8", 2, refl)
    h = res_block(net, h, f"{name}.enhance_8_0", 2, refl)
    h = res_block(net, h, f"{name}.enhance_8_1", 2, refl)
    h = deconv_block(net, h, f"{name}.upsample_16", 512, 3, 2, 1, 1)
    h = torch.cat([h, res_block(net, conv3, f"{name}.add_16")], dim=1)
    h = res_block(net, res_block(net, h, f"{name}.enhance_16_0"), f"{name}.enhance_16_1")
    h = deconv_block(net, h, f"{name}.upsample_32", 256, 3, 2, 1, 1)
    h = torch.cat([h, res_block(net, torch.cat([d32, conv2], dim=1), f"{name}.add_32")], dim=1)
    h = res_block(net, res_block(net, h, f"{name}.enhance_32_0"), f"{name}.enhance_32_1")
    h = deconv_block(net, h, f"{name}.upsample_64", 128, 3, 2, 1, 1)
    h = torch.cat([h, res_block(net, torch.cat([d64, conv1], dim=1), f"{name}.add_64", 5)],
                  dim=1)
    h = res_block(net, res_block(net, h, f"{name}.enhance_64_0"), f"{name}.enhance_64_1")
    h = deconv_block(net, h, f"{name}.upsample_128", 64, 3, 2, 1, 1)
    a128 = res_block(net, torch.cat([d128, conv0, i128], dim=1), f"{name}.add_128", 7)
    h = torch.cat([h, a128, local_feat, local_img], dim=1)
    h = res_block(net, h, f"{name}.enhance_128", 5)
    h = conv_block(net, h, f"{name}.conv5_conv", 64, 5, 1, 2)
    h = res_block(net, h, f"{name}.conv5_res")
    h = conv_block(net, h, f"{name}.conv6", 32, 3, 1, 1)
    return conv_block(net, h, f"{name}.decoded_img128", 3, 3, 1, 1, None), fc2


def generator(net: Net, batch: Mapping[str, torch.Tensor], z: torch.Tensor,
              keep: Optional[torch.Tensor] = None,
              num_classes: int = 347) -> Dict[str, torch.Tensor]:
    """``batch``: NCHW ``img`` and the four patches. ``keep``: the (B, 256)
    dropout keep-mask of training (rate 0.3), None in inference.
    Returns the frontal image, the identity logits and the fused fake
    patches."""
    imgs, feats = [], []
    for part in PARTS:
        img, feat = local_pathway(net, batch[part], f"local_{part}")
        imgs.append(img)
        feats.append(feat)
    local_feat, local_img = fuse(feats), fuse(imgs)
    img128, code = global_pathway(net, batch["img"], local_img, local_feat, z)
    if keep is not None:
        code = torch.where(keep, code / (1.0 - DROPOUT), torch.zeros_like(code))
    logits = net.linear(code, "feature_predict.fc", num_classes)
    return {"img": img128, "logits": logits, "local_fake": local_img}


def critic(net: Net, x: torch.Tensor) -> torch.Tensor:
    """(B, 1, 4, 4) scores: five stride-2 convs, residual blocks after the
    fourth and fifth, a 3x3 head."""
    h = x
    for i, cout in enumerate((64, 128, 256, 512, 512)):
        h = conv_block(net, h, f"conv{i}", cout, 3, 2, 1)
        if i >= 3:
            h = res_block(net, h, f"res{i}")
    return conv_block(net, h, "head", 1, 3, 1, 1, None)


def _bn_conv(net: Net, x, name, cout, k, stride, padding, act):
    h = net.batchnorm(net.conv(x, f"{name}.conv", cout, k, stride, padding, bias=False),
                      f"{name}.bn", train=False)
    return act(h) if act is not None else h


def embedder(net: Net, x: torch.Tensor, num_classes: int = 347,
             prefix: str = "base") -> torch.Tensor:
    """ResNet18 identity features (eval-mode BatchNorm): 7x7 stem, max
    pool, four sections of two residual blocks (64/128/256/512, stride 1,
    a 1x1 projection where the width changes), global mean, a 256-d
    ``fc0`` with BatchNorm. The classifier ``fc`` is listed, not run."""
    h = _bn_conv(net, x, f"{prefix}.conv1", 64, 7, 2, 3, F.relu)
    h = F.max_pool2d(h, 3, 2, 1)
    cin = 64
    for sec, width in enumerate((64, 128, 256, 512)):
        for blk in range(2):
            name = f"{prefix}.section{sec}_block{blk}"
            m = _bn_conv(net, h, f"{name}.conv0", cin, 3, 1, 1, F.relu)
            m = _bn_conv(net, m, f"{name}.conv1", width, 3, 1, 1, None)
            sc = h if cin == width else net.conv(h, f"{name}.shortcut.conv", width, 1,
                                                 gain=PLAIN)
            h = F.relu(m + sc)
            cin = width
    h = h.mean(dim=(2, 3))
    h = net.linear(h, f"{prefix}.fc0", 256, bias=False)
    feats = net.batchnorm(h[:, :, None, None], f"{prefix}.fc0.bn", train=False)[:, :, 0, 0]
    if net.spec_mode:  # the classifier's leaves, which the identity loss never runs
        net.param(f"{prefix}.fc.weight", (num_classes, 256), std=PLAIN / 16.0)
        net.param(f"{prefix}.fc.bias", (num_classes,), std=PLAIN / 16.0)
    return feats


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


def generator_loss(out, fake_scores, batch, embed: Optional[Callable],
                   weights) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The 11-term objective at the configuration's weights (``loss`` of
    the configuration file)."""
    fake = out["img"]
    w = weights
    comps = {
        "adv_G": -fake_scores.mean(),
        "pixelwise": (w["weight_128"] * l1(fake, batch["img_frontal"])
                      + w["weight_64"] * l1(F.avg_pool2d(fake, 2), batch["img64_frontal"])
                      + w["weight_32"] * l1(F.avg_pool2d(fake, 4), batch["img32_frontal"])),
        "pixelwise_local": l1(out["local_fake"], fuse([batch[k] for k in FRONTAL_KEYS])),
        "symmetry": (fake - fake.flip(3)).abs().mean(),
        "total_variation": ((fake[:, :, 1:] - fake[:, :, :-1]).abs().mean()
                            + (fake[..., 1:] - fake[..., :-1]).abs().mean()),
        "cross_entropy": F.cross_entropy(out["logits"], batch["label"].long()),
        "identity_preserving": (l1(embed(fake), embed(batch["img_frontal"])) if embed is not None
                                else torch.zeros((), device=fake.device)),
    }
    total = (w["weight_adv_G"] * comps["adv_G"] + w["weight_pixelwise"] * comps["pixelwise"]
             + w["weight_pixelwise_local"] * comps["pixelwise_local"]
             + w["weight_symmetry"] * comps["symmetry"]
             + w["weight_total_varation"] * comps["total_variation"]
             + w["weight_identity_preserving"] * comps["identity_preserving"]
             + w["weight_cross_entropy"] * comps["cross_entropy"])
    return total, comps


def gradient_penalty(d: Callable, real, fake, eps) -> torch.Tensor:
    x_hat = (eps * real + (1.0 - eps) * fake).detach().requires_grad_(True)
    (g,) = torch.autograd.grad(d(x_hat).sum(), x_hat, create_graph=True)
    return (torch.sqrt(g.square().sum(dim=(1, 2, 3)) + 1e-12) - 1.0).square().mean()


def decode_u8(batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A uint8 NHWC batch as float32 NCHW in [-1, 1]: (2v - 255) / 255."""
    out = {}
    for k, v in batch.items():
        if v.dtype == torch.uint8:
            v = ((2.0 * v.float() - 255.0) / 255.0).permute(0, 3, 1, 2).contiguous()
        out[k] = v
    return out


class Adam:
    """Adam with bias-corrected moments and eps outside the square root,
    over a dict of leaves."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, b1: float, b2: float,
                 eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps))


def draw_noise(generator: torch.Generator, b: int, zdim: int = 64, features: int = 256):
    """One step's draws in the train step's order: z ~ N(0, 1), the GP's
    eps ~ U[0, 1), the D- and G-phase dropout keep-masks."""
    dev = generator.device
    z = torch.randn((1, b, zdim), generator=generator, device=dev)[0]
    eps = torch.rand((1, b, 1, 1, 1), generator=generator, device=dev)[0]
    keep_d = (torch.rand((1, b, features), generator=generator, device=dev) < 1.0 - DROPOUT)[0]
    keep_g = (torch.rand((1, b, features), generator=generator, device=dev) < 1.0 - DROPOUT)[0]
    return z, eps, keep_d, keep_g


def grads_of(loss: torch.Tensor, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    names = list(params)
    gs = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
    return {k: (torch.zeros_like(params[k]) if g is None else g) for k, g in zip(names, gs)}


def gan_step(gen_w, disc_w, emb_w, opt_g: Adam, opt_d: Adam, batch, noise, loss_weights,
             rounding=None, half_batch: bool = False) -> Dict[str, float]:
    """One WGAN-GP D+G step on an NCHW float batch with one step's draws:
    the critic's update, then the generator's against the updated critic.
    Returns the step's D and G loss and each of their terms.
    ``half_batch`` plants a fault (the first half of the rows alone) for
    the harness's check of its own comparison."""
    z, eps, keep_d, keep_g = noise
    if half_batch:
        h = batch["img"].shape[0] // 2
        batch = {k: v[:h] for k, v in batch.items()}
        z, eps, keep_d, keep_g = z[:h], eps[:h], keep_d[:h], keep_g[:h]
    gnet, dnet = Net(gen_w, rounding), Net(disc_w, rounding)
    enet = Net(emb_w, rounding) if emb_w is not None else None
    d = lambda x: critic(dnet, x)
    real = batch["img_frontal"]
    with torch.no_grad():
        fake = generator(gnet, batch, z, keep_d)["img"]
    w_loss = d(fake).mean() - d(real).mean()
    gp = gradient_penalty(d, real, fake, eps)
    d_loss = w_loss + loss_weights["weight_gradient_penalty"] * gp
    opt_d.step(grads_of(d_loss, disc_w))

    out = generator(gnet, batch, z, keep_g)
    embed = (lambda x: embedder(enet, x)) if enet is not None else None
    g_loss, comps = generator_loss(out, d(out["img"]), batch, embed, loss_weights)
    opt_g.step(grads_of(g_loss, gen_w))
    return {"d_loss": float(d_loss.detach()), "g_loss": float(g_loss.detach()),
            "d_wasserstein": float(w_loss.detach()), "d_gradient_penalty": float(gp.detach()),
            **{f"g_{k}": float(v.detach()) for k, v in comps.items()}}


def synthesize(gen_w, batch, z, rounding=None) -> torch.Tensor:
    """Inference: the frontal image, NCHW float32."""
    with torch.no_grad():
        return generator(Net(gen_w, rounding), batch, z)["img"]


def spec(kind: str):
    """{name: Leaf} of the generator, critic or embedder."""
    net = Net()
    meta = lambda *s: torch.zeros(s, device="meta")
    if kind == "generator":
        batch = {"img": meta(1, 3, 128, 128)}
        for part, ((h, w), _) in PARTS.items():
            batch[part] = meta(1, 3, h, w)
        generator(net, batch, meta(1, 64))
    elif kind == "critic":
        critic(net, meta(1, 3, 128, 128))
    elif kind == "embedder":
        embedder(net, meta(1, 3, 128, 128))
    else:
        raise ValueError(kind)
    return net
