"""The port's LocalFuser scatter-max (``tpgan_tpu_torch.ops.kernels``
and ``models.local_fuser``) against the JAX package's: the Pallas kernel
in interpret mode, the jnp ``fuse_parts``, and ``jax.grad`` through
``fuse_parts_pallas``. The max is exact, so outputs and gradients must be
equal, not close. The CUDA kernel itself runs only on the card:
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpgan_tpu.models import local_fuser as jlf
from tpgan_tpu.ops.pallas_kernels import fuse_parts_pallas, fuse_parts_pallas_interpret
from tpgan_tpu_torch.models import local_fuser as tlf
from tpgan_tpu_torch.ops import kernels

from _torch_port import nchw, nhwc

torch.set_num_threads(1)

SHAPES = ((40, 40), (40, 40), (32, 40), (32, 48))


def _parts(b, c, seed=0):
    """NHWC parts with negatives, exact ties across overlapping slots, and
    zeros (ties with the background)."""
    rng = np.random.RandomState(seed)
    le, re, no, mo = (rng.standard_normal((b, h, w, c)).astype(np.float32) for h, w in SHAPES)
    # canvas (47..58, 43..57) is covered by the left eye (rows 28.., cols 25..)
    # and the nose (rows 0.., cols 0..): make part of it an exact tie
    no[:, 0:8, 0:10] = le[:, 28:36, 25:35]
    # the mouth overlaps the nose at canvas rows 72..78: tie there too
    mo[:, 0:6, 5:20] = no[:, 25:31, 2:17]
    le[:, :5] = 0.0  # ties with the zero background
    re[:, :, :3] = -0.0
    return le, re, no, mo


def _torch(parts):
    return [torch.from_numpy(nchw(p)) for p in parts]


@pytest.mark.parametrize("c", [3, 64])
def test_fuse_matches_pallas_interpret_and_jnp(c):
    parts = _parts(2, c, seed=c)
    want_kernel = np.asarray(fuse_parts_pallas_interpret(*map(jnp.asarray, parts)))
    want_jnp = np.asarray(jlf.fuse_parts(*map(jnp.asarray, parts)))
    got_wrapper = nhwc(kernels.fuse_parts(*_torch(parts)).numpy())
    got_plain = nhwc(tlf.fuse_parts(*_torch(parts)).numpy())
    np.testing.assert_array_equal(got_wrapper, want_kernel)
    np.testing.assert_array_equal(got_wrapper, want_jnp)
    np.testing.assert_array_equal(got_plain, want_jnp)


def test_fuse_propagates_nan_like_jnp():
    parts = _parts(1, 3, seed=1)
    parts[2][0, 3, 4, 1] = np.nan  # nose, inside the left-eye overlap
    parts[0][0, 39, 39, 0] = np.nan
    want = np.asarray(jlf.fuse_parts(*map(jnp.asarray, parts)))
    got = nhwc(kernels.fuse_parts(*_torch(parts)).numpy())
    assert np.isnan(want).sum() == 2
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c", [3, 16])
def test_fuse_gradient_matches_jax_custom_vjp(c):
    """The port's backward is ``_fuse_bwd``: a part gets g wherever it
    reaches the max of its slot, so exact ties (including ties at 0) all
    receive it — autodiff of a max chain would split them."""
    parts = _parts(2, c, seed=10 + c)
    g = np.random.RandomState(c).standard_normal((2, 128, 128, c)).astype(np.float32)

    def loss(*ps):
        return jnp.sum(fuse_parts_pallas(*ps) * g)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, parts))
    tparts = [t.requires_grad_() for t in _torch(parts)]
    (kernels.fuse_parts(*tparts) * torch.from_numpy(nchw(g))).sum().backward()
    for t, w in zip(tparts, want):
        np.testing.assert_array_equal(nhwc(t.grad.numpy()), np.asarray(w))
    # the ties at 0 really are ties that both sides hand the gradient to
    assert np.count_nonzero(np.asarray(want[0])[:, :5]) > 0


def test_fuse_checks_shapes_and_dtypes():
    parts = _torch(_parts(1, 3))
    with pytest.raises(ValueError, match="nose must be 32x40"):
        kernels.fuse_parts(parts[0], parts[1], parts[3], parts[3])
    with pytest.raises(ValueError, match="nose must be 32x40"):
        tlf.fuse_parts(parts[0], parts[1], parts[3], parts[3])
    with pytest.raises(ValueError, match="share one dtype"):
        kernels.fuse_parts(parts[0], parts[1], parts[2], parts[3].double())
    with pytest.raises(ValueError, match="batch/channels"):
        kernels.fuse_parts(parts[0], parts[1], parts[2], parts[3][:, :2])


def test_cpu_fuse_does_not_count_kernel_launches():
    before = kernels.launch_counts()["fuse_parts"]
    kernels.fuse_parts(*_torch(_parts(1, 3)))
    assert kernels.launch_counts()["fuse_parts"] == before


def test_extract_parts_inverts_placement():
    parts = [np.abs(p) + 1.0 for p in _parts(1, 3, seed=4)]  # no ties, all > 0
    canvas = tlf.fuse_parts(*_torch(parts))
    want = jlf.extract_parts(jnp.asarray(nhwc(canvas.numpy())))
    got = tlf.extract_parts(canvas)
    assert list(got) == list(want)
    for name in got:
        np.testing.assert_array_equal(nhwc(got[name].numpy()), np.asarray(want[name]))
