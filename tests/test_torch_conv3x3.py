"""The port's conv3x3 + bias + LeakyReLU (K3, ``tpgan_tpu_torch.ops.kernels.
conv3x3_bias_lrelu``) against the JAX package's: the Pallas kernel in
interpret mode and the XLA formulation it raced, on the same numpy-seeded
inputs. On the CPU the port's wrapper runs its plain version; the CUDA
kernel itself runs only on the card (tests/test_torch_cuda.py).

Tolerances: f32 within atol 1e-5 (the three sum the same products in other
orders; the outputs are of magnitude ~5); bf16 within one bf16 ulp per
element (each side rounds its f32 sum once, and the sums differ in the
last f32 bits)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpgan_tpu.ops.pallas_kernels import conv3x3_bias_lrelu_pallas, conv3x3_bias_lrelu_xla
from tpgan_tpu_torch.examples import conv_ab
from tpgan_tpu_torch.ops import kernels

torch.set_num_threads(1)

F32_ATOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, seed=0):
    """f32 numpy x ~ N(0, 1), kernel ~ 0.1 N(0, 1), bias ~ N(0, 1), as the
    JAX package's own test draws them."""
    b, h, w, cin, cout = shape
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, w, cin).astype(np.float32),
            (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32),
            rng.randn(cout).astype(np.float32))


def _run_both(arrays, dtype, slope):
    """(Pallas interpret, XLA, port) outputs as numpy arrays in ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    jx, jk, jb = (jnp.asarray(a).astype(jdt) for a in arrays)
    want_kernel = conv3x3_bias_lrelu_pallas(jx, jk, jb, slope, interpret=True)
    want_xla = conv3x3_bias_lrelu_xla(jx, jk, jb, slope)
    got = kernels.conv3x3_bias_lrelu(*(torch.from_numpy(a).to(tdt) for a in arrays), slope)
    assert got.dtype == tdt
    return np.asarray(want_kernel), np.asarray(want_xla), got


def _bf16_ulps(got: torch.Tensor, want: np.ndarray) -> np.ndarray:
    """|got - want| in bf16 ulps, from the bit patterns (ordered so that
    adjacent values differ by 1 across zero)."""
    def ordered(bits):
        bits = bits.astype(np.int32)
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)

    return np.abs(ordered(got.view(torch.int16).numpy().view(np.uint16))
                  - ordered(want.view(np.uint16)))


def _assert_close(got: torch.Tensor, want: np.ndarray, dtype: str):
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_ATOL)
    else:
        assert _bf16_ulps(got, want).max() <= 1


@pytest.mark.parametrize("shape,dtype,slope", [
    ((2, 16, 16, 8, 16), "float32", 0.2),  # the JAX package's test shape
    ((2, 9, 13, 5, 7), "float32", 0.01),  # odd sizes: every tile has a tail
    ((2, 9, 13, 5, 7), "bfloat16", 0.01),
    ((1, 32, 32, 64, 32), "bfloat16", 0.01),  # global_pathway.conv6 widths, 64 -> 32
])
def test_conv3x3_matches_pallas_interpret_and_xla(shape, dtype, slope):
    want_kernel, want_xla, got = _run_both(_inputs(shape), dtype, slope)
    _assert_close(got, want_kernel, dtype)
    _assert_close(got, want_xla, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3x3_propagates_nan_like_the_pallas_kernel(dtype):
    x, k, b = _inputs((2, 9, 13, 5, 7), seed=1)
    x[1, 4, 0, 3] = np.nan  # a left-edge pixel: its 2x3 neighbourhood turns NaN
    want, _, got = _run_both((x, k, b), dtype, 0.2)
    nan = np.isnan(want.astype(np.float32))
    assert nan.sum() == 3 * 2 * 7
    np.testing.assert_array_equal(got.float().isnan().numpy(), nan)
    _assert_close(got.masked_fill(torch.from_numpy(nan), 0.0), np.where(nan, 0, want)
                  .astype(want.dtype), dtype)


def test_conv3x3_leaky_relu_at_exact_zero():
    """A zero kernel leaves the bias: y = 0 exactly stays 0 (the y >= 0
    branch, sign included), a negative bias is scaled by the slope."""
    x, _, _ = _inputs((1, 4, 5, 3, 4))
    k = np.zeros((3, 3, 3, 4), np.float32)
    b = np.array([0.0, -0.0, -1.5, 2.0], np.float32)
    want, _, got = _run_both((x, k, b), "float32", 0.2)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.signbit(got.numpy()), np.signbit(want))
    np.testing.assert_array_equal(got.numpy()[0, 0, 0], np.array([0.0, 0.0, -0.3, 2.0],
                                                                  np.float32))


def test_conv3x3_refuses_mixed_dtypes_and_bad_shapes():
    x, k, b = (torch.from_numpy(a) for a in _inputs((1, 4, 4, 3, 2)))
    with pytest.raises(TypeError, match="kernel"):
        kernels.conv3x3_bias_lrelu(x, k.bfloat16(), b)
    with pytest.raises(ValueError, match=r"\(3, 3, Cin, Cout\)"):
        kernels.conv3x3_bias_lrelu(x, k[:, :, :2], b)
    with pytest.raises(ValueError, match="bias"):
        kernels.conv3x3_bias_lrelu(x, k, b[:1])


def test_cudnn_yardstick_computes_the_same_function():
    """The library call's weight layout and padding, held to the plain
    version in f32 (on the CPU ``F.conv2d`` is not cuDNN, but the layouts
    are the same)."""
    x, k, b = (torch.from_numpy(a) for a in _inputs((2, 9, 13, 5, 7), seed=2))
    weight = kernels.conv3x3_weight_oihw(k)
    assert weight.shape == (7, 5, 3, 3) and weight.is_contiguous(memory_format=torch.channels_last)
    got = kernels.conv3x3_bias_lrelu_cudnn(x, weight, b, 0.2)
    assert got.shape == (2, 9, 13, 7) and got.is_contiguous()
    torch.testing.assert_close(got, kernels.conv3x3_bias_lrelu_plain(x, k, b, 0.2),
                               rtol=0, atol=F32_ATOL)


def test_conv_ab_entry_runs_on_the_cpu_when_asked():
    """One row per dtype, bf16 then f32, each with its plan's variant."""
    lines = []
    rows = conv_ab.run("cpu", shapes=[(1, 6, 7, 8, 16)], log=lines.append)
    assert len(rows) == len(lines) == 2
    assert [(r["dtype"], r["variant"]) for r in rows] == [("bfloat16", "tma_wgmma"),
                                                          ("float32", "f32")]
    for row in rows:
        assert row["device"] == "cpu" and row["kernel_calls"] == 1 and row["max_abs_err"] == 0.0
        assert row["kernel_us"] is None and row["cuda_vs_cudnn"] is None and row["card"] is None
        assert row["bound_by"] == "bytes" and row["mma_sync_calls"] == 0
    assert rows[0]["cudnn_max_abs_err"] < 0.05
    assert rows[1]["cudnn_max_abs_err"] < F32_ATOL


def test_conv_ab_bounds_at_the_ab_shapes():
    """bf16 bytes and operations of the three A/B shapes: 33.63 / 17.07 /
    34.73 MB and 9.66 / 9.66 / 38.65 GFLOP."""
    want = [(33_628_288, 9_663_676_416, "bytes"), (17_072_384, 9_663_676_416, "operations"),
            (34_734_592, 38_654_705_664, "operations")]
    for shape, (nbytes, flops, by) in zip(conv_ab.SHAPES, want):
        assert conv_ab.work(shape) == (nbytes, flops)
        us, got_by = conv_ab.bound(shape)
        assert got_by == by
        assert us == pytest.approx(max(nbytes / 3.35e12, flops / 989e12) * 1e6)


@pytest.mark.parametrize("shape,nbytes,bound_us", [
    (conv_ab.SHAPES[0], 67_256_576, 144.23),
    (conv_ab.SHAPES[1], 34_144_768, 144.23),
    (conv_ab.SHAPES[2], 69_469_184, 576.94),
])
def test_conv_ab_f32_bounds_are_the_cuda_cores(shape, nbytes, bound_us):
    """f32: twice bf16's bytes, the same operations over the CUDA cores'
    67 TFLOP/s; operations bound all three shapes."""
    assert conv_ab.work(shape, torch.float32) == (nbytes, conv_ab.work(shape)[1])
    us, by = conv_ab.bound(shape, torch.float32)
    assert by == "operations"
    assert round(us, 2) == bound_us


@pytest.mark.parametrize("shape,rows,cols,bn,tiles_m,tiles_n", [
    ((8, 128, 128, 64, 64), 1, 128, 64, 8 * 128, 1),
    ((8, 64, 64, 128, 128), 2, 64, 128, 8 * 32, 1),
    ((32, 32, 32, 256, 256), 4, 32, 256, 32 * 8, 1),
])
def test_conv3x3_plan_gives_the_ab_shapes_tma_wgmma(shape, rows, cols, bn, tiles_m, tiles_n):
    plan = kernels.conv3x3_plan(*shape, torch.bfloat16)
    assert plan == ("tma_wgmma", rows, cols, bn, tiles_m, tiles_n, True)
    assert plan.box == (64, cols, rows, 1)


@pytest.mark.parametrize("shape,dtype,x_mod,w_mod,variant,vec", [
    ((2, 9, 13, 5, 7), torch.bfloat16, 0, 0, "mma_sync", False),  # Cin, Cout not multiples of 8
    ((2, 16, 16, 64, 60), torch.bfloat16, 0, 0, "mma_sync", False),  # Cout alone
    ((8, 128, 128, 64, 64), torch.bfloat16, 2, 0, "mma_sync", False),  # a misaligned x
    ((8, 128, 128, 64, 64), torch.bfloat16, 0, 8, "mma_sync", False),  # a misaligned weight
    ((8, 128, 128, 64, 64), torch.float32, 0, 0, "f32", True),  # f32: the CUDA-core kernel
    ((2, 9, 13, 5, 7), torch.float32, 0, 0, "f32", False),
])
def test_conv3x3_plan_keeps_the_other_cases_off_tma(shape, dtype, x_mod, w_mod, variant, vec):
    plan = kernels.conv3x3_plan(*shape, dtype, x_mod, w_mod)
    b, h, w, _, cout = shape
    bm = 128 if dtype == torch.bfloat16 else 256  # f32 at Cout <= 64: 256 x 64 tiles
    assert plan == (variant, 0, 0, 64, -(-b * h * w // bm), -(-cout // 64), vec)
    assert plan.bm == bm


def test_conv3x3_plan_boxes_stay_within_tma_limits():
    """Every tma_wgmma plan over a sweep of image sizes: a 128-pixel tile
    of a power-of-two width that fits the image (up to 128), boxes of at
    most 256 per dimension and 128 bytes in the inner one, tiles that cover
    the image and the channels."""
    for h in (1, 2, 7, 32, 100, 513):
        for w in (1, 3, 8, 31, 64, 96, 127, 128, 129, 300, 4096):
            for cout in (8, 64, 72, 256, 264):
                plan = kernels.conv3x3_plan(2, h, w, 16, cout, torch.bfloat16)
                assert plan.variant == "tma_wgmma"
                assert plan.rows * plan.cols == 128 and plan.cols & (plan.cols - 1) == 0
                assert plan.cols <= w or plan.cols == 1
                assert max(plan.box) <= kernels.TMA_BOX_MAX
                assert plan.box[0] * 2 <= kernels.TMA_SWIZZLE_BYTES
                tiles_h, tiles_w = -(-h // plan.rows), -(-w // plan.cols)
                assert plan.tiles_m == 2 * tiles_h * tiles_w
                assert plan.tiles_n * plan.bn >= cout > (plan.tiles_n - 1) * plan.bn


def test_conv3x3_plan_picks_the_narrowest_compiled_n_tile():
    plans = [kernels.conv3x3_plan(1, 8, 8, 16, c, torch.bfloat16)
             for c in (8, 64, 72, 128, 200, 256, 264, 520)]
    assert [p.bn for p in plans] == [64, 64, 128, 128, 256, 256, 256, 256]
    assert [p.tiles_n for p in plans] == [1, 1, 1, 1, 1, 1, 2, 3]
    assert all(p.bn in kernels.CONV3X3_BN for p in plans)


@pytest.mark.parametrize("cin,cout,x_mod,w_mod,vec", [
    (64, 64, 0, 0, True),
    (8, 16, 0, 0, True),  # the JAX test's shape: one 16-channel step, half zero-filled
    (72, 64, 0, 0, True),  # a chunk tail: 16-byte copies still (Cin % 4 == 0)
    (12, 4, 0, 0, True),
    (5, 64, 0, 0, False),  # Cin % 4: guarded
    (64, 7, 0, 0, False),  # Cout % 4: guarded
    (64, 66, 0, 0, False),
    (64, 64, 4, 0, False),  # x misaligned by 4 bytes
    (64, 64, 8, 0, False),
    (64, 64, 0, 12, False),  # a misaligned weight
])
def test_conv3x3_f32_plan_picks_vector_or_guarded_copies(cin, cout, x_mod, w_mod, vec):
    plan = kernels.conv3x3_plan(2, 16, 16, cin, cout, torch.float32, x_mod, w_mod)
    assert (plan.variant, plan.vec) == ("f32", vec)
    assert (plan.rows, plan.cols) == (0, 0)


@pytest.mark.parametrize("shape,bn,tiles_m,tiles_n", [
    ((8, 128, 128, 64, 64), 64, 512, 1),  # 256 x 64 tiles
    ((8, 64, 64, 128, 128), 128, 256, 1),  # 128 x 128
    ((32, 32, 32, 256, 256), 128, 256, 2),
    ((2, 9, 13, 5, 7), 64, 1, 1),  # one M tile over 234 pixels
    ((1, 1, 1, 8, 8), 64, 1, 1),
    ((2, 6, 96, 64, 64), 64, 5, 1),  # 1,152 pixels: the fifth tile 128 rows
    ((2, 16, 16, 64, 72), 128, 4, 1),  # an N tail: 72 of 128
    ((2, 12, 12, 32, 200), 128, 3, 2),  # 288 pixels; two N tiles, the second 72 wide
    ((2, 8, 8, 32, 264), 128, 1, 3),  # three N tiles, the third 8 wide
    ((3, 17, 19, 24, 40), 64, 4, 1),
])
def test_conv3x3_f32_plan_tiles_cover_the_tails(shape, bn, tiles_m, tiles_n):
    plan = kernels.conv3x3_plan(*shape, torch.float32)
    b, h, w, _, cout = shape
    assert (plan.bn, plan.tiles_m, plan.tiles_n) == (bn, tiles_m, tiles_n)
    assert plan.bn in kernels.CONV3X3_F32_BN
    assert plan.bm * plan.bn == kernels.CONV3X3_F32_TILE_OUTPUTS  # 8 x 8 outputs a thread
    assert plan.tiles_m * plan.bm >= b * h * w > (plan.tiles_m - 1) * plan.bm
    assert plan.tiles_n * plan.bn >= cout > (plan.tiles_n - 1) * plan.bn
