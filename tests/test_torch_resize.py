"""The port's resampler (``tpgan_tpu_torch.ops.resize``) against
``jax.image`` itself (jax 0.9.0, ``jax/_src/image/scale.py``), on the CPU.

Bars: the weight matrices within 1e-6 absolute of
``compute_weight_mat``'s (``jnp.sin`` under XLA and ``torch.sin`` may
differ by an ulp, and the column sums are taken in other orders);
``resize`` of [0, 1] float32 images within 2e-6; ``nearest`` offsets and
outputs equal bit for bit; an axis whose size does not change passes
through unchanged; the batched ``scale_and_translate`` within 2e-6 of
``jax.vmap`` of JAX's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src.image import scale as jscale

from tpgan_tpu_torch.ops import resize as R

torch.set_num_threads(1)

W_ATOL = 1e-6
IMG_ATOL = 2e-6

JAX_KERNELS = {"lanczos3": jscale._kernels[jscale.ResizeMethod.LANCZOS3],
               "linear": jscale._fill_triangle_kernel}
PORT_KERNELS = {"lanczos3": R.lanczos3_kernel, "linear": R.triangle_kernel}
# JAX's compute_weight_mat with a Python scale, static as resize passes it
# (1 / scale a double rounded once), compiled once per call (XLA folds the
# constants; op by op it takes 8x longer). A float32 scale (refine_lm5's
# crop) is held op by op, as the function writes its arithmetic: compiled
# with the scale traced, XLA's CPU code fuses (i + 0.5) * inv_scale -
# translation * inv_scale into FMAs, 1-4e-6 off the roundings written
jax_weight_mat = jax.jit(jscale.compute_weight_mat, static_argnums=(0, 1, 2, 3, 4, 5))
# shrink (the 480x640 frame, odd sizes, the pyramid), upscale and identity
SIZES = [(480, 128), (640, 128), (150, 128), (128, 64), (64, 32), (128, 256), (128, 128)]


@pytest.mark.parametrize("method", ["lanczos3", "linear"])
@pytest.mark.parametrize("antialias", [True, False], ids=["antialias", "no_antialias"])
def test_weight_matrices_match_jax(method, antialias):
    for m, n in SIZES:
        want = np.asarray(jax_weight_mat(m, n, n / m, 0.0, JAX_KERNELS[method], antialias))
        got = R.compute_weight_mat(m, n, n / m, 0.0, PORT_KERNELS[method], antialias)
        assert got.dtype == torch.float32 and got.shape == (m, n)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=W_ATOL,
                                   err_msg=f"{method} {m}->{n}")


@pytest.mark.parametrize("method", ["lanczos3", "linear"])
def test_weight_matrices_with_translations_out_of_range(method):
    """Translations that push some samples outside [-0.5, m - 0.5] (their
    columns are 0) and scales far from 1, as float32 tensors (the traced
    path of ``refine_lm5``'s crop)."""
    # one shape (each new shape costs JAX a compile per op): shrink,
    # zoom in, a shift past the end, a hard shrink
    for m, n, scale, t in [(100, 64, 0.4, -30.0), (100, 64, 2.7, 45.5), (100, 64, 1.0, 300.0),
                           (100, 64, 0.25, 17.25), (100, 64, 5.3, -250.0)]:
        want = np.asarray(jscale.compute_weight_mat(m, n, jnp.float32(scale), jnp.float32(t),
                                                    JAX_KERNELS[method], True))
        got = R.compute_weight_mat(m, n, torch.tensor(scale), torch.tensor(t),
                                   PORT_KERNELS[method], True).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=W_ATOL, err_msg=f"{m} {n} {scale} {t}")
        assert np.array_equal(got.any(axis=0), want.any(axis=0))  # the same columns zeroed
    # everything out of range: all zero
    assert not R.compute_weight_mat(10, 8, torch.tensor(1.0), torch.tensor(1e4),
                                    PORT_KERNELS[method], True).any()


def test_eps_guard_zeroes_a_column_whose_weights_cancel():
    """A column whose weight sum is within 1000 eps of 0 is set to 0,
    not divided (``scale.py:76-80``): a kernel that sums to ~1e-5 in
    every column."""
    def tiny(x):
        return torch.where(x < 0.5, torch.full_like(x, 1e-5), torch.zeros_like(x))

    def jtiny(x):
        return jnp.where(x < 0.5, 1e-5, 0.0).astype(jnp.float32)

    want = np.asarray(jscale.compute_weight_mat(8, 8, 1.0, 0.0, jtiny, False))
    got = R.compute_weight_mat(8, 8, 1.0, 0.0, tiny, False).numpy()
    assert not want.any() and not got.any()
    # and just above the guard, the same column is normalised to 1
    big = R.compute_weight_mat(8, 8, 1.0, 0.0, lambda x: 1e3 * tiny(x), False)
    np.testing.assert_allclose(big.sum(0).numpy(), np.ones(8), rtol=1e-6)


def _images(shape, seed):
    return np.random.RandomState(seed).uniform(0, 1, shape).astype(np.float32)


def _float64_resize(x, out_hw, method):
    """The same weight matrices applied in float64: the truth both f32
    sides round."""
    (h, w), (oh, ow) = x.shape[1:3], out_hw
    k = PORT_KERNELS["linear" if method == "bilinear" else method]
    wh = R.compute_weight_mat(h, oh, oh / h, 0.0, k, True).double()
    ww = R.compute_weight_mat(w, ow, ow / w, 0.0, k, True).double()
    return torch.einsum("bhwc,hy,wx->byxc", torch.from_numpy(x).double(), wh, ww).numpy()


@pytest.mark.parametrize("method", ["lanczos3", "linear", "bilinear", "nearest"])
@pytest.mark.parametrize("out_hw", [(128, 128), (64, 96), (250, 90)],
                         ids=["to_128", "shrink", "mixed"])
def test_resize_matches_jax(method, out_hw):
    x = _images((2, 200, 180, 3), seed=1)
    shape = (2, *out_hw, 3)
    want = np.asarray(jax.image.resize(jnp.asarray(x), shape, method))
    got = R.resize(torch.from_numpy(x), shape, method).numpy()
    assert got.shape == want.shape
    if method == "nearest":
        np.testing.assert_array_equal(got, want)
    elif out_hw != (250, 90):
        np.testing.assert_allclose(got, want, rtol=0, atol=IMG_ATOL)
    else:
        # one axis grows while the other shrinks: JAX's CPU einsum lands
        # up to 5.2e-6 from the float64 result of its own matrices, the
        # port 1e-7; both are held to that float64 result, the port at the
        # bar and JAX no nearer than the port
        truth = _float64_resize(x, out_hw, method)
        np.testing.assert_allclose(got, truth, rtol=0, atol=IMG_ATOL)
        assert np.abs(want - truth).max() >= np.abs(got - truth).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("m,n", [(3, 7), (7, 3), (480, 128), (5, 13), (128, 256), (640, 96)])
def test_nearest_offsets_equal_jax(m, n):
    want = np.asarray(jscale._resize_nearest(jnp.arange(m, dtype=jnp.float32), (n,)))
    got = R.nearest_offsets(m, n).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("method", ["lanczos3", "linear", "nearest"])
def test_an_axis_of_unchanged_size_passes_through(method):
    x = torch.from_numpy(_images((2, 64, 48, 3), seed=2))
    assert torch.equal(R.resize(x, (2, 64, 48, 3), method), x)
    # only the width changes: the rows are resampled, the height skipped
    y = R.resize(x, (2, 64, 20, 3), method)
    want = np.asarray(jax.image.resize(jnp.asarray(x.numpy()), (2, 64, 20, 3), method))
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=0 if method == "nearest" else IMG_ATOL)


def test_resize_rejects_an_unknown_method_and_a_wrong_rank():
    x = torch.zeros(1, 4, 4, 3)
    with pytest.raises(ValueError, match="unknown resize method"):
        R.resize(x, (1, 8, 8, 3), "cubic")
    with pytest.raises(ValueError, match="one entry per axis"):
        R.resize(x, (8, 8, 3), "linear")


def test_batched_scale_and_translate_matches_jax_vmap():
    """One scale and (y, x) translation per image, as ``refine_lm5``'s
    crop makes them: zoom in, zoom out (antialiased), samples outside."""
    rng = np.random.RandomState(3)
    x = _images((4, 90, 70, 3), seed=4)
    s = np.asarray([2.3, 0.7, 5.1, 1.0], np.float32)
    t = rng.uniform(-120, 40, (4, 2)).astype(np.float32)

    def one(img, si, ti):
        return jax.image.scale_and_translate(
            img, (64, 64, 3), (0, 1, 2), jnp.asarray([si, si, 1.0]),
            jnp.asarray([ti[0], ti[1], 0.0]), method="linear")

    want = np.asarray(jax.vmap(one)(jnp.asarray(x), jnp.asarray(s), jnp.asarray(t)))
    got = R.scale_and_translate(torch.from_numpy(x), (64, 64), torch.from_numpy(s),
                                torch.from_numpy(t), "linear").numpy()
    assert got.shape == (4, 64, 64, 3)
    assert (want == 0).any() and (want != 0).any()  # some samples fall outside
    np.testing.assert_allclose(got, want, rtol=0, atol=IMG_ATOL)
    with pytest.raises(ValueError, match="nearest"):
        R.scale_and_translate(torch.from_numpy(x), (64, 64), torch.from_numpy(s),
                              torch.from_numpy(t), "nearest")
