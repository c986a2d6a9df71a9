"""The port's int8 post-training quantization (``tpgan_tpu_torch.ops.quant``
and the conv hooks of ``ops/blocks.py``) against the JAX package's
(``tpgan_tpu/ops/quant.py``) on the CPU, at fm 0.25.

What is held, and to what:

* the quantizers bit-equal to JAX's as its jitted int8 program computes
  them (weights traced, the activation's absmax a constant), ties at .5
  (half to even) and the all-zero 1e-8 guard included;
* the int32 accumulator of the port's im2col + ``torch._int_mm`` conv
  bit-equal to ``lax.conv_general_dilated(preferred_element_type=int32)``
  on the same int8 inputs, for the generator's conv geometries; the
  subpixel phase weights element for element;
* the calibration's keys equal to JAX's (converted), each absmax within
  CALIB_REL of JAX's (both run the float graph in float32; the convs sum
  in other orders: up to 12 ulp measured);
* every one of the 162 int8 convs of the synthesis on JAX's own float
  input: the quantized input and the int32 sums bit-equal to JAX's;
* the whole int8 synthesis on JAX's converted scales against JAX's, by
  flips of the quantized values: a float activation that differs from
  JAX's in its last bits (the rescale and the elementwise ops are summed
  and fused differently by XLA) moves a quantized value by 1 where it
  sits at a rounding edge, and a flip then propagates. The bars, per
  case: the first layer with a flip has no flip beyond 1 and at most
  FIRST_SHARE of its values flipped; over all layers at most TOTAL_SHARE
  flipped; the image within IMAGE_MAE_OF_QUANT of JAX's own int8-vs-float
  error (the port is no further from JAX's int8 program than quantization
  moves it);
* JAX's own bars on the port alone (``tests/test_quant.py:126,168``).
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax import lax

from tpgan_tpu.config import make_config as jax_make_config
from tpgan_tpu.ops import blocks as jblocks
from tpgan_tpu.ops import quant as jquant
from tpgan_tpu.train.gan_trainer import build_models
from tpgan_tpu.train.gan_trainer import make_synthesize_fn as jax_make_synthesize_fn
from tpgan_tpu_torch.config import make_config
from tpgan_tpu_torch.convert import jax_quant_scales_to_port
from tpgan_tpu_torch.ops import blocks, quant
from tpgan_tpu_torch.ops.blocks import Conv2d, ConvTranspose2d
from tpgan_tpu_torch.train.gan_trainer import (
    build_generator,
    make_graphed_int8_synthesize_fn,
    make_int8_synthesize_fn,
    make_synthesize_fn,
    synthesize_fn_of,
)

from _torch_port import init_numpy, load_port, nchw, nhwc

torch.set_num_threads(1)

PATCHES = ((128, 128), (40, 40), (40, 40), (32, 40), (32, 48))
KEYS = quant.SYNTHESIS_KEYS
CALIB_REL = 1e-5  # ~84 ulp; measured up to 12 ulp (8.2e-7)
# (first-flip share, total share) per rescale dtype. float32: measured
# 3.8e-6 / 4.2-4.5%; bfloat16 rescale rounds each op to bf16 where XLA
# keeps some in float32 (its excess precision): 1.5% / 10-20% measured
FLIP_BARS = {"float32": (1e-3, 0.10), "bfloat16": (0.05, 0.30)}
IMAGE_MAE_OF_QUANT = 1.5  # measured 0.4-1.1 of JAX's own int8-vs-float MAE


def _batch(seed, b=2):
    rng = np.random.RandomState(seed)
    return {k: rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32)
            for k, (h, w) in zip(KEYS, PATCHES)}


def _overrides(mode="deconv", dtype="float32"):
    return {"G": {"fm_multiplier": 0.25, "local_feature_layer_dim": 16, "upsample_mode": mode},
            "D": {"fm_multiplier": 0.25}, "compute_dtype": dtype}


@pytest.fixture(scope="module")
def side():
    """One JAX generator's numpy weights, JAX's calibration on two batches
    with injected z (float32, deconv; one calibration serves both
    algorithms, as JAX's observe notes) and its conversion."""
    jcfg = jax_make_config(_overrides())
    jgen, _ = build_models(jcfg)
    params, _ = init_numpy(jgen, *(np.zeros((1,) + s + (3,), np.float32) for s in PATCHES),
                           np.zeros((1, 64), np.float32), seed=3)
    batches = [_batch(10), _batch(11)]
    zs = [np.random.RandomState(50 + i).standard_normal((2, 64)).astype(np.float32)
          for i in range(2)]
    jax_scales = jax.device_get(jquant.calibrate_synthesis(jcfg, jgen, params, batches, zs=zs))
    return dict(params=params, batches=batches, zs=zs, jax_scales=jax_scales, jax={},
                scales=jax_quant_scales_to_port(jax_scales), request=_batch(9),
                z=np.random.RandomState(1).standard_normal((2, 64)).astype(np.float32))


def _port_gen(side, mode="deconv", dtype="float32"):
    return load_port(build_generator(make_config(_overrides(mode, dtype)), "cpu"),
                     side["params"])


def _jax_int8(side, mode="deconv", dtype="float32", rescale_dtype=None, min_channels=None):
    """JAX's jitted int8 synthesis of the request, and per int8 conv, in
    call order: (quantized input, float input, int32 sums); one compile
    per program in the module (``side``'s cache)."""
    key = ("int8", mode, dtype, rescale_dtype, min_channels)
    if key not in side["jax"]:
        side["jax"][key] = _run_jax_int8(side, mode, dtype, rescale_dtype, min_channels)
    return side["jax"][key]


def _jax_float(side, mode, dtype):
    """JAX's jitted float synthesis of the request (cached as above)."""
    key = ("float", mode, dtype)
    if key not in side["jax"]:
        jcfg = jax_make_config(_overrides(mode, dtype))
        jgen, _ = build_models(jcfg)
        side["jax"][key] = np.asarray(jax.jit(jax_make_synthesize_fn(jcfg, jgen))(
            side["params"], side["request"], side["z"]), np.float32)
    return side["jax"][key]


def _run_jax_int8(side, mode, dtype, rescale_dtype, min_channels):
    jcfg = jax_make_config(_overrides(mode, dtype))
    jgen, _ = build_models(jcfg)
    records = []
    quantize, conv = jquant.quantize_activation, lax.conv_general_dilated

    def recording_quantize(x, absmax):
        out = quantize(x, absmax)
        records.append([out[0], x])
        return out

    def recording_conv(*args, **kw):
        out = conv(*args, **kw)
        if kw.get("preferred_element_type") == jnp.int32:
            records[-1].append(out)
        return out

    def run(params, batch, z):
        records.clear()
        out = jquant.make_int8_synthesize_fn(jcfg, jgen, side["jax_scales"], rescale_dtype,
                                             min_channels)(params, batch, z)
        return out, [tuple(r) for r in records]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jquant, "quantize_activation", recording_quantize)
        mp.setattr(lax, "conv_general_dilated", recording_conv)
        out, recs = jax.jit(run)(side["params"], side["request"], side["z"])
    return np.asarray(out, np.float32), [tuple(np.array(t) for t in r) for r in recs]


def _port_int8(side, mode="deconv", dtype="float32", rescale_dtype=None, min_channels=None):
    """The port's int8 synthesis of the request on JAX's scales, and each
    int8 conv's quantized input in call order (with a subpixel conv's
    input pads)."""
    cfg = make_config(_overrides(mode, dtype))
    model = quant.make_int8_model(cfg, _port_gen(side, mode), side["scales"], rescale_dtype,
                                  min_channels)
    records = []

    def record(mod, args, _out):
        subpixel = mod.phases != (1, 1)  # its (lo, hi) pads are JAX's before the quantizer
        records.append((nhwc(mod.quantize(args[0]).numpy()),
                        mod.padding if subpixel else None))

    hooks = [m.int8.register_forward_hook(record) for m in model.modules()
             if isinstance(m, (Conv2d, ConvTranspose2d)) and m.int8 is not None]
    out = synthesize_fn_of(model)(side["request"], side["z"])
    for h in hooks:
        h.remove()
    return out.float().numpy(), records


# ---- the quantizers ----

def _tie_weight():
    """OIHW (4, 3, 2, 2): channel 0's absmax 15.875 makes its scale exactly
    0.125, and its other values sit at (k + 0.5) * 0.125 (ties); channel 1
    is all zero (the 1e-8 guard); the rest random."""
    rng = np.random.RandomState(0)
    w = rng.standard_normal((4, 3, 2, 2)).astype(np.float32)
    w[0] = (np.arange(12).reshape(3, 2, 2) - 5.5) * 0.125
    w[0, 0, 0, 0] = 15.875
    w[1] = 0.0
    return w


def test_quantize_weight_per_channel_matches_jax():
    w = _tie_weight()
    want_q, want_s = jax.jit(jquant.quantize_weight_per_channel)(w.transpose(2, 3, 1, 0))
    got_q, got_s = quant.quantize_weight_per_channel(torch.from_numpy(w), out_axis=0)
    assert got_q.dtype == torch.int8 and float(got_s[0]) == 0.125
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))
    assert np.array_equal(got_q.numpy(), np.asarray(want_q).transpose(3, 2, 0, 1))
    assert got_q[0].flatten()[1:4].tolist() == [-4, -4, -2]  # -4.5, -3.5, -2.5: half to even
    assert not got_q[1].any()
    # a transposed conv's IOHW weight: the output channels on axis 1
    got_t, got_ts = quant.quantize_weight_per_channel(torch.from_numpy(w.transpose(1, 0, 2, 3)), 1)
    assert torch.equal(got_t, got_q.transpose(0, 1)) and torch.equal(got_ts, got_s)


@pytest.mark.parametrize("case", ["ties", "zero_absmax", "random"])
def test_quantize_activation_matches_jax(case):
    rng = np.random.RandomState(1)
    if case == "ties":  # absmax 127: scale 1, values on .5 and past the clip
        x, absmax = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, 127.5, -200.0], np.float32), 127.0
    elif case == "zero_absmax":
        x, absmax = np.array([0.0, 1e-12, -1e-9, 3.0], np.float32), 0.0
    else:
        x, absmax = (rng.standard_normal((2, 5, 7, 3)) * 3).astype(np.float32), 7.3
    want_q, want_s = jax.jit(lambda v: jquant.quantize_activation(v, jnp.float32(absmax)))(x)
    got_q, got_s = quant.quantize_activation(torch.from_numpy(x), torch.tensor(absmax))
    assert float(got_s) == float(want_s)
    assert np.array_equal(got_q.numpy(), np.asarray(want_q))
    if case == "ties":
        assert got_q.tolist() == [0, 2, 2, 0, -2, 126, 127, -127]


# ---- the int32 accumulator ----

# name: (input (C, H, W), kernel, stride, padding, groups, lhs_dilation,
# reflect (l, r, t, b) or None); transposed convs as JAX runs them, the
# flipped kernel over the dilated input
GEOMETRIES = {
    "stem_7x7_k147": ((3, 20, 20), 7, 1, 3, 1, 1, None),
    "stride2_5x5": ((16, 18, 18), 5, 2, 2, 1, 1, None),
    "stride2_3x3": ((16, 17, 17), 3, 2, 1, 1, 1, None),
    "add_8_2x2_reflect": ((36, 8, 8), 2, 1, 0, 1, 1, (1, 0, 1, 0)),
    "grouped_3x3": ((16, 9, 9), 3, 1, 1, 4, 1, None),
    "deconv_8_k8_from_1x1": ((80, 1, 1), 8, 1, (7, 7), 1, 1, None),
    "deconv_32_s4_op1": ((16, 8, 8), 3, 1, (2, 3), 1, 4, None),
    "deconv_s2_p1_op1": ((16, 8, 8), 3, 1, (1, 2), 1, 2, None),
}


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_int8_accumulator_matches_jax(name):
    (c, h, w), k, s, p, groups, dil, reflect = GEOMETRIES[name]
    rng = np.random.RandomState(len(name))
    cout = 12
    x_q = rng.randint(-127, 128, (2, c, h, w)).astype(np.int8)
    if reflect is not None:  # the float input is reflect-padded before it is quantized
        l, r, t, b = reflect
        x_q = np.pad(x_q, ((0, 0), (0, 0), (t, b), (l, r)), mode="reflect")
    w_q = rng.randint(-127, 128, (cout, c // groups, k, k)).astype(np.int8)
    lo, hi = (p, p) if isinstance(p, int) else p
    want = lax.conv_general_dilated(
        jnp.asarray(nhwc(x_q)), jnp.asarray(w_q.transpose(2, 3, 1, 0)), (s, s),
        ((lo, hi), (lo, hi)), lhs_dilation=(dil, dil),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups,
        preferred_element_type=jnp.int32)
    mats = quant.pack_int8_weight(torch.from_numpy(w_q), groups)
    got = quant.int8_conv_accumulate(torch.from_numpy(x_q), mats, (k, k), (s, s),
                                     ((lo, hi), (lo, hi)), (dil, dil))
    n = cout // groups
    got = got.view(*got.shape[:3], groups, -1)[..., :n].reshape(*got.shape[:3], cout)
    assert got.dtype == torch.int32 and mats.shape[1] % 8 == 0 and mats.shape[2] % 8 == 0
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_columns_are_built_in_chunks(monkeypatch):
    """A batch whose columns pass COLUMN_BYTES goes in chunks of images,
    with the same sums; fewer than 17 rows are padded for _int_mm."""
    rng = np.random.RandomState(2)
    x_q = torch.from_numpy(rng.randint(-127, 128, (5, 8, 6, 6)).astype(np.int8))
    mats = quant.pack_int8_weight(torch.from_numpy(
        rng.randint(-127, 128, (16, 8, 3, 3)).astype(np.int8)))
    whole = quant.int8_conv_accumulate(x_q, mats, (3, 3), padding=((1, 1), (1, 1)))
    monkeypatch.setattr(quant, "COLUMN_BYTES", 2 * 36 * 72)  # two images per chunk
    chunked = quant.int8_conv_accumulate(x_q, mats, (3, 3), padding=((1, 1), (1, 1)))
    assert torch.equal(whole, chunked)
    tiny = quant.int8_conv_accumulate(x_q[:1, :, :3, :3], mats, (3, 3))  # one row
    columns = x_q[:1, :, :3, :3].permute(0, 2, 3, 1).int().flatten()[None]  # (row, col, C)
    assert torch.equal(tiny, (columns @ mats[0, :, :72].int().t())[None, None])


@pytest.mark.parametrize("k,s,p,op", [(3, 2, 1, 1), (3, 4, 0, 1), (4, 2, 1, 0)])
def test_subpixel_weights_match_jax(k, s, p, op):
    rng = np.random.RandomState(k * 10 + s)
    wf = rng.standard_normal((k, k, 5, 6)).astype(np.float32)
    plan = blocks.subpixel_plan(k, s, p, op)
    assert plan == jblocks._subpixel_plan(k, s, p, op)
    taps, lo, _hi, win, _ = plan
    want = jblocks._subpixel_weights(jnp.asarray(wf), taps, lo, win, taps, lo, win)
    got = blocks.subpixel_weights(torch.from_numpy(wf), taps, lo, win, taps, lo, win)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_int8_conv_matches_float_within_quant_error():
    """``tests/test_quant.py``'s single-conv bound on the port's layouts."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 8, 16, 16).astype(np.float32))
    w = torch.from_numpy(rng.randn(16, 8, 3, 3).astype(np.float32) * 0.1)
    want = F.conv2d(x, w, padding=1)
    got = quant.int8_conv(x, w, x.abs().amax(), padding=((1, 1), (1, 1)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got - want).abs().max()) / float(want.abs().max()) < 0.02


# ---- modes, scales, calibration ----

def test_quant_mode_blocks_nest_and_restore():
    conv = Conv2d(8, 16, 3, padding=1)
    holder = torch.nn.Sequential(conv, ConvTranspose2d(16, 8, 3, 2, 1, 1))
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 8, 8, 8).astype(np.float32))
    with pytest.raises(ValueError, match="unknown quant mode"):
        quant.quant_mode(holder, "int4")
    with torch.no_grad():
        want = holder(x)
        with quant.quant_mode(holder, quant.CALIB):
            assert torch.equal(holder(x), want)  # calibration runs the float graph
            holder(x * 2.0)
            with quant.quant_mode(holder, None):
                assert holder[0].quant_mode is None
            assert holder[0].quant_mode == quant.CALIB
        assert holder[0].quant_mode is None
        assert float(conv.quant_absmax) == float((x * 2.0).abs().amax())
        scales = quant.collect_quant_scales(holder)
        assert set(scales) == {"0", "1"}
        with quant.quant_mode(holder, quant.INT8):  # int8 needs the weights quantized first
            with pytest.raises(ValueError, match="prepare_int8"):
                holder(x)
        int8 = copy.deepcopy(holder)
        with quant.quant_mode(int8, quant.INT8), quant.quant_config(int8, torch.bfloat16, 0):
            assert int8[0].quant_rescale_dtype == torch.bfloat16
            quant.prepare_int8(int8)
            got = int8(x)
        assert int8[0].quant_rescale_dtype == torch.float32 and int8[0].quant_mode is None
        assert int8[0].int8.scale.dtype == torch.bfloat16  # the knob read when prepared
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) / float(want.abs().max()) < 0.05


def test_load_quant_scales_is_strict(side):
    gen = _port_gen(side)
    with pytest.raises(KeyError, match="missing"):
        quant.load_quant_scales(gen, {k: v for k, v in list(side["scales"].items())[1:]})
    with pytest.raises(KeyError, match="unexpected"):
        quant.load_quant_scales(gen, {**side["scales"], "global_pathway.nope": 1.0})
    quant.load_quant_scales(gen, side["scales"])


def test_batch_norm_generator_raises(side):
    cfg = make_config({**_overrides(), "G": {**_overrides()["G"], "use_batchnorm": True}})
    gen = build_generator(cfg, "cpu", seed=0)
    with pytest.raises(NotImplementedError, match="BatchNorm"):
        quant.calibrate_synthesis(cfg, gen, [side["request"]])
    with pytest.raises(NotImplementedError, match="BatchNorm"):
        make_int8_synthesize_fn(cfg, gen, side["scales"])


def test_calibration_matches_jax(side):
    cfg = make_config(_overrides())
    got = quant.calibrate_synthesis(cfg, _port_gen(side), side["batches"], zs=side["zs"])
    want = side["scales"]
    assert len(want) > 50 and set(got) == set(want)
    for key, value in want.items():
        assert float(got[key]) > 0 and got[key].dtype == torch.float32 and got[key].dim() == 0
        assert abs(float(got[key]) - float(value)) <= CALIB_REL * float(value), key
    # a seeded torch.Generator draws z by default, the same twice
    again = [quant.calibrate_synthesis(cfg, _port_gen(side), side["batches"][:1])
             for _ in range(2)]
    assert all(torch.equal(again[0][k], again[1][k]) for k in want)


# ---- the int8 synthesis against JAX's ----

@pytest.mark.parametrize("mode", ["deconv", "subpixel"])
def test_every_int8_conv_matches_jax_on_its_own_inputs(side, mode):
    """Each int8 conv of JAX's program, fed JAX's float input: the port's
    quantized input and int32 sums equal JAX's bit for bit."""
    recs = _jax_int8(side, mode)[1]
    model = quant.make_int8_model(make_config(_overrides(mode)), _port_gen(side, mode),
                                  side["scales"])
    calls = []
    hooks = [m.register_forward_pre_hook(lambda mod, a: calls.append((mod, a[0].shape)))
             for m in model.modules() if isinstance(m, (Conv2d, ConvTranspose2d))]
    synthesize_fn_of(model)(side["request"], side["z"])
    for h in hooks:
        h.remove()
    assert len(calls) == len(recs) == 162
    for (layer, shape), (x_q, x, acc) in zip(calls, recs):
        prog = layer.int8
        x_q_port = prog.quantize(torch.from_numpy(nchw(x)))
        assert np.array_equal(nhwc(x_q_port.numpy()), x_q)
        # JAX pads a subpixel input before quantizing it; the port after
        padded = isinstance(layer, ConvTranspose2d) and x.shape[1:3] != tuple(shape[2:])
        got = quant.int8_conv_accumulate(
            torch.from_numpy(nchw(x_q)), prog.weight_q, prog.kernel_size, prog.stride,
            ((0, 0), (0, 0)) if padded else prog.padding, prog.lhs_dilation)
        assert np.array_equal(got[..., :acc.shape[-1]].numpy(), acc)


CASES = {  # name: (upsample mode, compute dtype, rescale dtype, min_channels)
    "deconv": ("deconv", "float32", None, None),
    "subpixel": ("subpixel", "float32", None, None),
    "subpixel_bf16rescale": ("subpixel", "float32", "bfloat16", None),
    "deconv_min96": ("deconv", "float32", None, 96),
    "subpixel_bf16rescale_bf16": ("subpixel", "bfloat16", "bfloat16", None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_int8_synthesis_matches_jax(side, case):
    mode, dtype, rdt, min_channels = CASES[case]
    want, recs = _jax_int8(side, mode, dtype, getattr(jnp, rdt) if rdt else None, min_channels)
    got, port_q = _port_int8(side, mode, dtype, getattr(torch, rdt) if rdt else None,
                             min_channels)
    assert got.shape == want.shape == (2, 128, 128, 3) and np.isfinite(got).all()
    assert len(port_q) == len(recs) > 0
    first, flipped, total = None, 0, 0
    for (got_q, pads), (jax_q, _x, _acc) in zip(port_q, recs):
        if pads is not None:  # JAX quantized the padded subpixel input: its interior
            (lo_h, _), (lo_w, _) = pads
            jax_q = jax_q[:, lo_h:lo_h + got_q.shape[1], lo_w:lo_w + got_q.shape[2]]
        assert got_q.shape == jax_q.shape
        d = np.abs(got_q.astype(np.int32) - jax_q.astype(np.int32))
        if first is None and d.any():
            first = (float((d > 0).mean()), int(d.max()))
        flipped += int((d > 0).sum())
        total += d.size
    first_share, total_share = FLIP_BARS[rdt or "float32"]
    assert first is None or (first[1] == 1 and first[0] <= first_share), first
    assert flipped / total <= total_share, flipped / total
    quant_mae = np.abs(want - _jax_float(side, mode, dtype)).mean()
    assert np.abs(got - want).mean() <= IMAGE_MAE_OF_QUANT * quant_mae, (
        np.abs(got - want).mean(), quant_mae)


def test_jax_bars_hold_on_the_port(side):
    """``tests/test_quant.py``'s bars on the port alone, on its own
    calibration: int8 against float MAE < 0.25, subpixel against deconv
    int8 MAE < 0.05 (the same parameters)."""
    cfg = make_config(_overrides())
    gen = _port_gen(side)
    scales = quant.calibrate_synthesis(cfg, gen, side["batches"], zs=side["zs"])
    f32 = make_synthesize_fn(cfg, gen)(side["request"], side["z"]).numpy()
    i8 = make_int8_synthesize_fn(cfg, gen, scales)(side["request"], side["z"]).numpy()
    assert np.isfinite(i8).all() and np.abs(i8 - f32).mean() < 0.25
    sub_cfg = make_config(_overrides("subpixel"))
    sub = make_int8_synthesize_fn(sub_cfg, _port_gen(side, "subpixel"), scales)(
        side["request"], side["z"]).numpy()
    assert np.abs(sub - i8).mean() < 0.05
    # the graphed form is the eager function on the CPU
    graphed = make_graphed_int8_synthesize_fn(cfg, gen, scales)
    assert np.array_equal(graphed(side["request"], side["z"]).numpy(), i8)


def test_int8_model_keeps_int8_weights_only(side):
    """The int8 copy holds each quantized conv's int8 weight and drops its
    float one; ``gen`` is untouched; ``min_channels`` leaves narrow convs
    float."""
    gen = _port_gen(side)
    before = {k: v.clone() for k, v in gen.state_dict().items()}
    model = quant.make_int8_model(make_config(_overrides("deconv", "bfloat16")), gen,
                                  side["scales"], min_channels=96)
    assert all(torch.equal(v, before[k]) for k, v in gen.state_dict().items())
    layers = [m for m in model.modules() if isinstance(m, (Conv2d, ConvTranspose2d))]
    assert all(m.quant_prepared and m.quant_mode == quant.INT8 for m in layers)
    int8 = [m for m in layers if m.int8 is not None]
    assert 0 < len(int8) < len(layers)
    for m in int8:
        assert m.weight.numel() == 0 and m.int8.weight_q.dtype == torch.int8
        assert min(m.quant_in_per_group, m.quant_out) >= 96
    for m in layers:
        if m.int8 is None:
            assert m.weight.dtype == torch.bfloat16


def test_int8_entry_on_the_cpu():
    from tpgan_tpu_torch.entry import int8_entry

    fn, (batch, z) = int8_entry("cpu", batch_size=1)
    out = fn(batch, z)
    assert out.shape == (1, 128, 128, 3) and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()


def _load_chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("fault", ["none", "bias left out", "one weight value +1",
                                   "input scale x(1 + 1e-3)"])
def test_the_smokes_per_layer_bars_catch_a_planted_fault(side, fault):
    """``chip_smoke.int8_layers_against_cpu`` (phase 18 (b): each int8 conv
    of the card's program fed the CPU run's float input) with a fault
    planted in the last biased conv of the twin program, run on the CPU:
    the smoke's per-layer bars pass the twin unchanged and fail exactly
    that conv otherwise."""
    smoke = _load_chip_smoke()
    cfg = make_config(_overrides())
    ref = quant.make_int8_model(cfg, _port_gen(side), side["scales"])
    twin = quant.make_int8_model(cfg, _port_gen(side), side["scales"])
    names = [n for n, m in twin.named_modules()
             if isinstance(m, quant.Int8Conv) and m.bias is not None]
    last = twin.get_submodule(names[-1])
    with torch.no_grad():
        if fault == "bias left out":
            last.bias.zero_()
        elif fault == "one weight value +1":
            last.weight_q.view(-1)[0] += 1
        elif fault == "input scale x(1 + 1e-3)":
            last.x_inv_scale.mul_(1 + 1e-3)
    rows = smoke.int8_layers_against_cpu(ref, twin, side["request"], side["z"],
                                         torch.device("cpu"))
    outside = [r["name"] for r in smoke.int8_layers_outside_bars(rows)]
    assert len(rows) == 162
    assert outside == ([] if fault == "none" else [names[-1]])
