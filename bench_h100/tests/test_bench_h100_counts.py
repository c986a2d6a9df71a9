"""The yardstick's counts against hand counts at tiny shapes."""

from __future__ import annotations

import torch

from bench_h100.counts import flops, kernels
from bench_h100.reference.net import Net, conv_taps, deconv_taps


def test_conv_products_leave_out_zero_padding():
    # 3x3, stride 1, pad 1 on 4x4: per axis the outputs see 2, 3, 3, 2 taps
    assert conv_taps(4, 4, 3, 1, 1) == 10
    net = Net()
    net.conv(torch.zeros(1, 2, 4, 4, device="meta"), "c", 3, 3, 1, 1)
    assert net.calls[0].products == 1 * 3 * 2 * 10 * 10
    # stride 2, pad 1, 3x3 on 4x4 -> 2x2: outputs 0 and 1 see 2 and 3 taps
    assert conv_taps(4, 2, 3, 2, 1) == 5


def test_transposed_conv_products_by_hand():
    # k3 s2 p1 op1, 2 -> 4: input 0 reaches outputs 0, 1; input 1 reaches 1, 2, 3
    assert deconv_taps(2, 4, 3, 2, 1) == 5
    net = Net()
    y = net.deconv(torch.zeros(2, 5, 2, 2, device="meta"), "d", 7, 3, 2, 1, 1)
    assert tuple(y.shape) == (2, 7, 4, 4)
    assert net.calls[0].products == 2 * 5 * 7 * 25


def _phase_taps(n_in: int, n_out: int, k: int, s: int, p: int) -> int:
    """The subpixel form's count: each output takes, in its phase, the
    taps whose input lies inside the image."""
    return sum(1 for o in range(n_out) for t in range(k)
               if (o + p - t) % s == 0 and 0 <= (o + p - t) // s < n_in)


def test_a_transposed_conv_counts_alike_in_deconv_and_subpixel():
    # the generator's transposed convs: (in, out, k, s, p)
    for geom in ((1, 8, 8, 1, 0), (8, 32, 3, 4, 0), (32, 64, 3, 2, 1), (5, 10, 3, 2, 1),
                 (64, 128, 3, 2, 1)):
        assert deconv_taps(*geom) == _phase_taps(*geom), geom
    # and neither counts the input-dilated form's zeros
    n_in, n_out, k, s, p = 32, 64, 3, 2, 1
    dilated = n_out * k  # every output against every tap of the dilated input
    assert deconv_taps(n_in, n_out, k, s, p) < dilated


def test_linear_and_network_counts():
    net = Net()
    net.linear(torch.zeros(3, 10, device="meta"), "l", 4)
    assert net.calls[0].products == 3 * 10 * 4
    counts = flops.tpgan_networks()
    assert 170e9 < counts["generator"]["F"] < 172e9  # two FLOPs per product, batch 1
    assert counts["generator"]["X"] < counts["generator"]["F"]  # inputs need no gradient
    terms = flops.gan_train_terms(50)
    assert terms["d.gp"] == 4 * counts["critic"]["F"]
    assert abs(sum(terms.values()) - 746.1e9) < 0.5e9
    p = flops.pretrain_terms(64)
    assert p["backward"] < 2 * p["forward"]  # the stem's input gradient is not needed


def test_kernel_bytes_by_hand():
    assert kernels.part_pixels() == 40 * 40 * 2 + 32 * 40 + 32 * 48
    assert kernels.covered_pixels() == 5358
    assert kernels.k1_bytes(1, 1, 2) == (6016 + 128 * 128) * 2
    assert kernels.k1_bwd_bytes(1, 1, 2) == 34780
    assert kernels.k2_bytes(2, 3, 4) == 2 * 3 * 128 * 128 * 4
    assert kernels.k2_bwd_bytes(2, 3, 4) == 2 * kernels.k2_bytes(2, 3, 4)
    # PERF.md's bounds: K1 B=8 C=64 bf16 6.85 us, its backward B=16 10.63 us
    assert abs(kernels.bound_s(kernels.k1_bytes(8, 64, 2)) * 1e6 - 6.85) < 0.01
    assert abs(kernels.bound_s(kernels.k1_bwd_bytes(16, 64, 2)) * 1e6 - 10.63) < 0.01
    step = kernels.gan_step(50)
    assert [step[k][0] for k in ("k1", "k1_bwd", "k2", "k2_bwd")] == [7, 2, 1, 1]
    assert kernels.synthesis(128)["k1"][0] == 3
