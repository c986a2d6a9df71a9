"""The port's memory layout rule (``ops.blocks.conv_memory_format``): every
bf16 conv and transposed conv of the GAN computes channels-last, every f32
conv (the detector, the identity embedder) contiguous NCHW; the K1 / K2
wrappers take channels-last arguments through counted copies; the
conversions and copies of a forward and of a train step are pinned
(``ops.kernels.layout_counts``, ``copy_counts``). All on the CPU, at
fm 0.25."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpgan_tpu_torch.config import make_config
from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
from tpgan_tpu_torch.models.feature_extract import (
    build_feature_extract_model,
    make_identity_embed_fn,
)
from tpgan_tpu_torch.ops import blocks, kernels
from tpgan_tpu_torch.ops.geometry import PART_GEOMETRY, PART_NAMES
from tpgan_tpu_torch.train.gan_trainer import (
    build_generator,
    create_gan_state,
    make_gan_train_step,
    make_synthesize_fn,
)

CL = torch.channels_last
SMALL = {"G": {"fm_multiplier": 0.25, "local_feature_layer_dim": 16},
         "D": {"fm_multiplier": 0.25}, "compute_dtype": "bfloat16"}
CONVS = (blocks.Conv2d, blocks.ConvTranspose2d)


def _record_inputs(module, seen, name):
    """Forward pre-hooks on every conv of ``module``: (name, dtype, channels-
    last, contiguous) of each input a conv receives."""
    def hook(_m, args):
        x = args[0]
        seen.append((name, x.dtype, x.is_contiguous(memory_format=CL), x.is_contiguous()))
    return [m.register_forward_pre_hook(hook) for m in module.modules() if isinstance(m, CONVS)]


def _gan_step_with_identity(seed=3):
    cfg = make_config(SMALL)
    state, gen, disc, g_opt, d_opt = create_gan_state(cfg, 0, "cpu")
    emb = build_feature_extract_model(cfg, "cpu")
    step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt, make_identity_embed_fn(emb))
    return (lambda: step(state, synthetic_gan_batch(2, seed=seed),
                         torch.Generator().manual_seed(0))), (gen, disc, emb)


def _synthesis_batch(b=2, seed=1):
    rng = np.random.RandomState(seed)
    shapes = [("img", (128, 128))] + [(n, PART_GEOMETRY[n][0]) for n in PART_NAMES]
    return {k: rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32) for k, (h, w) in shapes}


@pytest.mark.parametrize("case", ["gan_step", "detector_step"])
def test_each_conv_receives_the_layout_of_its_dtype(case):
    """bf16 generator and critic convs receive channels-last inputs through
    a whole step (both phases, the GP's double backward included); the f32
    identity embedder inside that step and the f32 detector's step hand
    every conv contiguous NCHW."""
    seen = []
    if case == "gan_step":
        run, (gen, disc, emb) = _gan_step_with_identity()
        for name, module in (("gen", gen), ("disc", disc), ("emb", emb)):
            _record_inputs(module, seen, name)
        state, metrics = run()
        assert all(torch.isfinite(v.float()) for v in metrics.values())
    else:
        from tpgan_tpu_torch.train.pretrain import create_pretrain_state, make_pretrain_step

        cfg = make_config({"pretrain": {"image_size": 128}})
        state, model, opt = create_pretrain_state(cfg, 0, "cpu")
        _record_inputs(model, seen, "detector")
        rng = np.random.RandomState(0)
        x = (rng.uniform(0, 1, (2, 128, 128, 3)) * 255).astype(np.uint8)
        lbl = rng.uniform(32, 96, (2, 8)).astype(np.float32)
        make_pretrain_step(cfg, model, opt, state.scheduler)(state, x, lbl,
                                                              torch.Generator().manual_seed(0))
    by_model = {}
    for name, dtype, channels_last, contiguous in seen:
        by_model.setdefault(name, []).append((dtype, channels_last, contiguous))
    for name, calls in by_model.items():
        if name in ("gen", "disc"):
            assert all(channels_last for _d, channels_last, _c in calls), name
            # the bf16 convs; the first conv of each pathway and of the critic
            # receives the f32 images and casts them (channels-last kept)
            assert {d for d, _cl, _c in calls} == {torch.bfloat16, torch.float32}, name
        else:
            assert all(contiguous for _d, _cl, contiguous in calls), name
            assert {d for d, _cl, _c in calls} == {torch.float32}, name
    want = {"gan_step": {"gen", "disc", "emb"}, "detector_step": {"detector"}}[case]
    assert set(by_model) == want


def test_bf16_generator_gives_equal_results_from_either_input_layout():
    """A bf16 generator's outputs and parameter gradients are equal (bit for
    bit) whether its inputs arrive as contiguous NCHW or as NCHW views of
    NHWC arrays: every conv computes channels-last either way."""
    cfg = make_config(SMALL)
    gen = blocks.set_compute_dtype(build_generator(cfg, "cpu", seed=0), torch.bfloat16)
    batch = _synthesis_batch()
    z = torch.from_numpy(np.random.RandomState(2).standard_normal((2, cfg.G.zdim))
                         .astype(np.float32))
    runs = []
    for contiguous in (True, False):
        gen.zero_grad(set_to_none=True)
        args = [torch.from_numpy(batch[k]).permute(0, 3, 1, 2) for k in
                ("img", "left_eye", "right_eye", "nose", "mouth")]
        if contiguous:
            args = [a.contiguous() for a in args]
        out = gen(*args, z)
        sum(t.float().square().mean() for t in out).backward()
        runs.append(([t.detach() for t in out], [p.grad.clone() for p in gen.parameters()]))
    (out_a, grad_a), (out_b, grad_b) = runs
    assert all(torch.equal(a, b) for a, b in zip(out_a, out_b))
    assert all(torch.equal(a, b) for a, b in zip(grad_a, grad_b))
    assert all(g.is_contiguous() for g in grad_a)  # the parameters' own layout


@pytest.mark.parametrize("case,layouts,copies", [
    # contiguous NCHW inputs: one conversion at each of the five entries
    # and one at add_128, whose cat takes the NCHW profile image; the two
    # fuses of the pathways' channels-last outputs copy their parts
    ("generator_forward_nchw_inputs", {"to_nhwc": 6, "to_nchw": 0},
     {"fuse_parts_in": 8, "fuse_parts_out": 2, "fuse_parts_bwd_g": 0,
      "fuse_parts_bwd_out": 0, "sym_tv_in": 0, "sym_tv_bwd_out": 0}),
    # the serving path: NHWC views in, nothing converted
    ("synthesis_forward", {"to_nhwc": 0, "to_nchw": 0},
     {"fuse_parts_in": 12, "fuse_parts_out": 3, "fuse_parts_bwd_g": 0,
      "fuse_parts_bwd_out": 0, "sym_tv_in": 0, "sym_tv_bwd_out": 0}),
    # a D+G step with the identity term: the f32 embedder's two inputs go
    # to NCHW; 7 fuses (28 parts in, 7 canvases out), 2 fuse backwards (2
    # g, 8 part gradients out), K2 once each way
    ("train_step", {"to_nhwc": 0, "to_nchw": 2},
     {"fuse_parts_in": 28, "fuse_parts_out": 7, "fuse_parts_bwd_g": 2,
      "fuse_parts_bwd_out": 8, "sym_tv_in": 1, "sym_tv_bwd_out": 1}),
])
def test_layout_and_copy_counts_of_a_forward_and_a_step(case, layouts, copies):
    if case == "train_step":
        run, _models = _gan_step_with_identity()
    else:
        cfg = make_config(SMALL)
        gen = build_generator(cfg, "cpu", seed=0)
        batch, z = _synthesis_batch(), np.zeros((2, cfg.G.zdim), np.float32)
        if case == "synthesis_forward":
            synthesize = make_synthesize_fn(cfg, gen)
            run = lambda: synthesize(batch, z)  # noqa: E731
        else:
            blocks.set_compute_dtype(gen, torch.bfloat16).eval()
            nchw = [torch.from_numpy(batch[k]).permute(0, 3, 1, 2).contiguous()
                    for k in ("img", "left_eye", "right_eye", "nose", "mouth")]
            run = lambda: gen(*nchw, torch.from_numpy(z))  # noqa: E731
    kernels.reset_launch_counts()
    run()
    assert kernels.layout_counts() == layouts
    assert kernels.copy_counts() == copies


def _channels_last(t):
    return t.contiguous(memory_format=CL)


@pytest.mark.parametrize("kernel", ["fuse_parts", "symmetry_tv_losses"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_wrappers_take_channels_last_arguments(kernel, dtype):
    """K1 and K2, forward and backward, on channels-last arguments: the same
    values as on contiguous NCHW ones, results and gradients handed back
    channels-last, and every copy counted."""
    rng = np.random.RandomState(5)
    if kernel == "fuse_parts":
        shapes = [(2, 8) + PART_GEOMETRY[n][0] for n in PART_NAMES]
        want_copies = {"fuse_parts_in": 4, "fuse_parts_out": 1, "fuse_parts_bwd_g": 1,
                       "fuse_parts_bwd_out": 4}
        fn = lambda *xs: (kernels.fuse_parts(*xs),)  # noqa: E731
    else:
        shapes = [(2, 3, 128, 128)]
        want_copies = {"sym_tv_in": 1, "sym_tv_bwd_out": 1}
        fn = kernels.symmetry_tv_losses
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
            for s in shapes]
    runs = []
    for layout in (torch.contiguous_format, CL):
        xs = [a.clone(memory_format=layout).requires_grad_() for a in args]
        kernels.reset_launch_counts()
        outs = fn(*xs)
        # cotangents: the canvas's in the canvas's layout; K2's are scalars
        weights = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32)).to(o.dtype)
                   for o in outs] if not runs else runs[0][3]
        torch.autograd.backward(list(outs), [w.clone(memory_format=layout) if w.dim() == 4
                                             else w for w in weights])
        runs.append(([o.detach() for o in outs], [x.grad for x in xs],
                     kernels.copy_counts(), weights))
    (out_a, grad_a, copies_a, _), (out_b, grad_b, copies_b, _) = runs
    assert all(torch.equal(a, b) for a, b in zip(out_a, out_b))
    assert all(torch.equal(a, b) for a, b in zip(grad_a, grad_b))
    assert all(g.is_contiguous(memory_format=CL) and not g.is_contiguous() for g in grad_b)
    if kernel == "fuse_parts":
        assert out_b[0].is_contiguous(memory_format=CL) and not out_b[0].is_contiguous()
        # a contiguous canvas's gradient is read in place
        assert copies_a["fuse_parts_bwd_g"] == 0
    assert not any(copies_a.values())
    assert {k: v for k, v in copies_b.items() if v} == want_copies


@pytest.mark.parametrize("dtype,layout", [(torch.bfloat16, CL),
                                          (torch.float32, torch.contiguous_format)])
def test_conv_layers_cast_weights_into_the_layout_of_their_dtype(dtype, layout):
    """A Conv2d with reflect padding and a ConvTranspose2d in ``dtype``, fed
    an NHWC view: a bf16 conv sees its input and weight channels-last, an
    f32 conv its input as given and its weight as stored (contiguous); the
    result equals ``F.conv2d`` / ``F.conv_transpose2d`` on the same values,
    the weight's gradient comes back contiguous float32 (equal to a plain
    cast's), and a serving copy stores the weight in
    ``conv_memory_format(dtype)``."""
    assert blocks.conv_memory_format(dtype) == layout
    g = torch.Generator().manual_seed(0)
    conv = blocks.Conv2d(8, 16, 2, 1, (1, 0, 1, 0))
    deconv = blocks.ConvTranspose2d(8, 4, 3, 2, 1, 1)
    x = torch.randn(2, 9, 9, 8, generator=g).permute(0, 3, 1, 2)  # an NHWC view
    for layer in (conv, deconv):
        layer.compute_dtype = dtype
        seen = []
        op = F.conv2d if layer is conv else F.conv_transpose2d
        spy = lambda inp, w, *a, _op=op, **k: seen.append((inp, w)) or _op(inp, w, *a, **k)  # noqa
        name = "conv2d" if layer is conv else "conv_transpose2d"
        xs = x.detach().requires_grad_()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(blocks.F, name, spy)
            y = layer(xs)
        inp, w = seen[0]
        assert w.is_contiguous(memory_format=layout)
        if dtype == torch.bfloat16:
            assert inp.is_contiguous(memory_format=CL) and y.is_contiguous(memory_format=CL)
        elif layer is deconv:  # no pad: the f32 input is the view itself
            assert inp.stride() == x.stride()
        wd = layer.weight.detach().to(dtype).requires_grad_()
        xin = xs.detach().to(dtype)
        if layer is conv:
            want = F.conv2d(blocks.reflect_pad(xin, layer.reflect), wd, layer.bias.to(dtype))
        else:
            want = F.conv_transpose2d(xin, wd, layer.bias.to(dtype), 2, 1, 1)
        assert torch.allclose(y.float(), want.float(), rtol=1e-2, atol=1e-2)
        (gw,) = torch.autograd.grad(y.float().sum(), layer.weight)
        (gw_plain,) = torch.autograd.grad(want.float().sum(), wd)
        assert gw.dtype == torch.float32
        if dtype == torch.bfloat16:  # an f32 conv's gradient takes its input's layout, as before
            assert gw.is_contiguous()
        assert torch.allclose(gw, gw_plain.float(), rtol=2e-2, atol=2e-2)
        served = blocks.compute_copy(layer, dtype)
        assert served.weight.dtype == dtype and served.weight.is_contiguous(memory_format=layout)
        assert torch.equal(served.weight, layer.weight.detach().to(dtype))


def test_reflect_pad_keeps_channels_last_with_the_same_values():
    x = torch.randn(2, 6, 8, 8).to(torch.bfloat16)
    for lrtb in ((1, 0, 1, 0), (2, 1, 0, 3)):
        want = F.pad(x, lrtb, mode="reflect")
        got = blocks.reflect_pad(_channels_last(x), lrtb)
        assert got.is_contiguous(memory_format=CL) and torch.equal(got, want)
        assert blocks.reflect_pad(x, lrtb).is_contiguous()
