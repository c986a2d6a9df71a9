"""Plain float32 landmark detector: MobileNetV2 with an SSD head in the
absolute head mode, the multi-task landmark loss and SGD with Nesterov
momentum and weight decay, after the reference implementation's
MobileNetV2.py:10-534, Pretrain.py and config.py:3-35.

Parameter names are the port's (``stem``, ``block{i}.expand``, ...,
``ssd_head.loc{j}``), so one weight dict serves both sides. BatchNorm is
in train mode (batch statistics, biased variance); the running
statistics are not advanced, since nothing compared reads them.

The loss is the reference's, batched with fixed shapes: per image the
positives are the predictions within each label's k-th smallest
distance (k = 0.1 * N), each taking its nearest label; a background
subsample ranked by the step's uniforms ``u``; alpha * location MSE +
beta * cross-entropy.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from bench_h100.reference.net import Net, relu6

SETTINGS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1),
            (6, 160, 3, 2), (6, 320, 1, 1))
SCALES = ((96, 4), (1280, 6), (512, 6), (256, 6), (256, 6), (128, 6))
EXTRAS = ((512, 1, 1, 0), (512, 3, 2, 1), (256, 1, 1, 0), (256, 3, 2, 1), (256, 3, 2, 1),
          (128, 1, 1, 0), (128, 3, 2, 1))
EXTRA_TAPS = (1, 3, 4, 6)
FIRST_TAP = 12
CLASSES = 5  # four landmarks and the background
LABELS = 4


def _he(net: Net, x, name, cout, k, stride, pad, bias, groups=1):
    """A conv with the reference's He init, N(0, sqrt(2 / (k * k * cout))),
    and a zero bias (MobileNetV2.py:220-250)."""
    return net.conv(x, name, cout, k, stride, pad, bias=bias, groups=groups,
                    std=math.sqrt(2.0 / (k * k * cout)))


def detector(net: Net, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """NCHW images in [0, 1] -> (loc (B, N, 2) absolute pixel coordinates
    clamped at 0, cls (B, N, 5) logits), per scale in (row, column,
    anchor) order."""
    feats = []
    h = relu6(net.batchnorm(_he(net, x, "stem", 32, 3, 2, 1, False), "stem_bn", True))
    cin, i = 32, 0
    for t, c, n, s in SETTINGS:
        for rep in range(n):
            name = f"block{i}"
            mid = cin * t
            m = relu6(net.batchnorm(_he(net, h, f"{name}.expand", mid, 1, 1, 0, False),
                                    f"{name}.expand_bn", True))
            m = relu6(net.batchnorm(_he(net, m, f"{name}.depthwise", mid, 3, s if rep == 0 else 1,
                                        1, False, groups=mid), f"{name}.depthwise_bn", True))
            m = net.batchnorm(_he(net, m, f"{name}.project", c, 1, 1, 0, False),
                              f"{name}.project_bn", True)
            h = h + m if (s if rep == 0 else 1) == 1 and cin == c else m
            if i == FIRST_TAP:
                feats.append(h)
            cin, i = c, i + 1
    h = relu6(net.batchnorm(_he(net, h, "conv2", 1280, 1, 1, 0, False), "conv2_bn", True))
    feats.append(h)
    for j, (cout, k, s, p) in enumerate(EXTRAS):
        h = _he(net, h, f"extra{j}", cout, k, s, p, True)
        if j in EXTRA_TAPS:
            feats.append(h)
    locs, clss = [], []
    for j, ((_cin, anchors), f) in enumerate(zip(SCALES, feats)):
        b = f.shape[0]
        loc = _he(net, f, f"ssd_head.loc{j}", anchors * 2, 3, 1, 1, True).permute(0, 2, 3, 1)
        locs.append(torch.clamp_min(loc.reshape(b, -1, 2), 0.0))
        cls = _he(net, f, f"ssd_head.cls{j}", anchors * CLASSES, 3, 1, 1, True).permute(0, 2, 3, 1)
        clss.append(cls.reshape(b, -1, CLASSES))
    return torch.cat(locs, dim=1), torch.cat(clss, dim=1)


def assignment(points: torch.Tensor, loc_true: torch.Tensor, ratio: float) -> torch.Tensor:
    """(B, N): each prediction's nearest label among those whose k-th
    smallest distance it lies within, else -1 (background)."""
    b = loc_true.shape[0]
    lt = loc_true.reshape(b, LABELS, 2)
    d = torch.sqrt(torch.sum(torch.square(points.detach()[:, :, None, :] - lt[:, None, :, :]),
                             dim=-1) + 1e-20)
    k = max(int(ratio * d.shape[1]), 1)
    thresh = torch.kthvalue(d, k, dim=1).values
    pos = d <= thresh[:, None, :]
    nearest = torch.where(pos, d, torch.full_like(d, float("inf"))).argmin(-1)
    return torch.where(pos.any(-1), nearest, torch.full_like(nearest, -1))


def background_keep(assigned: torch.Tensor, u: torch.Tensor, ratio: float) -> torch.Tensor:
    """The background predictions whose stable rank by ``u`` among the
    background is below floor(ratio * positives)."""
    bg = assigned == -1
    max_bg = torch.floor(ratio * (~bg).sum(-1).float()).long()
    order = torch.argsort(torch.where(bg, u, torch.full_like(u, float("inf"))), dim=-1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(order.shape[-1], device=u.device).expand_as(order))
    return bg & (rank < max_bg[:, None])


def landmark_loss(loc, cls, loc_true, u, image_hw, loss_cfg, assign_from=None) -> torch.Tensor:
    """``assign_from``: the (B, N, 2) predictions the positives are
    assigned from, ``loc`` itself when None."""
    b = loc.shape[0]
    assigned = assignment(loc if assign_from is None else assign_from, loc_true,
                          loss_cfg["distance_threshold_ratio"])
    h, w = image_hw
    size = torch.tensor([w, h], dtype=loc.dtype, device=loc.device)
    p = torch.clamp(loc / size, 0.0, 1.0)
    t = torch.clamp(loc_true.reshape(b, LABELS, 2) / size, 0.0, 1.0)
    sq = ((p[:, :, None, :] - t[:, None, :, :]) ** 2).mean(-1)
    onehot = (assigned[..., None] == torch.arange(LABELS, device=loc.device)).float()
    counts = onehot.sum(1)
    denom = counts.clamp_min(1.0)
    location = torch.where(counts > 0, (sq * onehot).sum(1) / denom,
                           torch.zeros_like(counts)).sum(-1)
    logp = torch.log_softmax(cls, dim=-1)
    ce = torch.where(counts > 0, (-logp[..., :LABELS] * onehot).sum(1) / denom,
                     torch.zeros_like(counts)).sum(-1)
    keep = background_keep(assigned, u, loss_cfg["ratio_non_background"]).float()
    n_bg = keep.sum(-1)
    ce = ce + torch.where(n_bg > 0, (-logp[..., -1] * keep).sum(-1) / n_bg.clamp_min(1.0),
                          torch.zeros_like(n_bg))
    return (loss_cfg["alpha"] * location + loss_cfg["beta"] * ce).mean()


class SGD:
    """SGD with momentum, Nesterov and weight decay (torch's form: the
    decay added to the gradient, the buffer set to it at the first step)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, momentum: float,
                 weight_decay: float):
        self.params, self.lr, self.mu, self.wd = params, lr, momentum, weight_decay
        self.buf: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        for k, p in self.params.items():
            d = grads[k] + self.wd * p
            if k in self.buf:
                self.buf[k].mul_(self.mu).add_(d)
            else:
                self.buf[k] = d.clone()
            p.sub_(self.lr * (d + self.mu * self.buf[k]))


def decode_u8(images: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> float32 NCHW in [0, 1]: v / 255."""
    return (images.float() / 255.0).permute(0, 3, 1, 2).contiguous()


def pretrain_step(params: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor], opt: SGD,
                  images, labels, u, loss_cfg, assign_from=None, rounding=None,
                  half_batch: bool = False):
    """One step on a uint8 NHWC batch with (B, 8) labels; returns (loss,
    loc, cls). ``assign_from``: the predictions the positives are assigned
    from (the loss's one discrete choice), this forward's own when None."""
    if half_batch:
        h = images.shape[0] // 2
        images, labels, u = images[:h], labels[:h], u[:h]
        assign_from = None if assign_from is None else assign_from[:h]
    x = decode_u8(images)
    net = Net({**params, **buffers}, rounding)
    loc, cls = detector(net, x)
    loss = landmark_loss(loc, cls, labels.float(), u, x.shape[2:], loss_cfg, assign_from)
    names = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names])
    opt.step(dict(zip(names, grads)))
    return float(loss.detach()), loc.detach(), cls.detach()


def spec(image_size: int = 256) -> Net:
    net = Net()
    detector(net, torch.zeros(1, 3, image_size, image_size, device="meta"))
    return net
