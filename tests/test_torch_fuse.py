"""The port's LocalFuser scatter-max (``tpgan_tpu_torch.ops.kernels``
and ``models.local_fuser``) against the JAX package's: the Pallas kernel
in interpret mode, the jnp ``fuse_parts``, and ``jax.grad`` through
``fuse_parts_pallas`` (with the cotangent dense, or a channel slice of a
``torch.cat``'s gradient as on the main path). The max is exact, so
outputs and gradients must be equal, not close. The CUDA kernels
themselves run only on the card: tests/test_torch_cuda.py; here, their
launch plans."""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpgan_tpu.models import local_fuser as jlf
from tpgan_tpu.ops.pallas_kernels import fuse_parts_pallas, fuse_parts_pallas_interpret
from tpgan_tpu_torch.models import local_fuser as tlf
from tpgan_tpu_torch.ops import kernels
from tpgan_tpu_torch.ops.geometry import PART_GEOMETRY

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


@pytest.mark.parametrize("c,layout", [
    pytest.param(3, "dense", id="3"),
    pytest.param(16, "dense", id="16"),
    pytest.param(3, "cat_slice", id="3-cat_slice"),
    pytest.param(16, "cat_slice", id="16-cat_slice"),
])
def test_fuse_gradient_matches_jax_custom_vjp(c, layout):
    """The port's backward is ``_fuse_bwd``: a part gets g wherever it
    reaches the max of its slot, so exact ties (including ties at 0) all
    receive it — autodiff of a max chain would split them. ``cat_slice``:
    the canvas feeds a ``torch.cat`` between other channels, as the
    feature canvas does in ``GlobalPathway``, so the cotangent reaches the
    fuse as a non-contiguous channel slice of the cat's gradient."""
    parts = _parts(2, c, seed=10 + c)
    g = np.random.RandomState(c).standard_normal((2, 128, 128, c)).astype(np.float32)

    def loss(*ps):
        return jnp.sum(fuse_parts_pallas(*ps) * g)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, parts))
    tparts = [t.requires_grad_() for t in _torch(parts)]
    canvas = kernels.fuse_parts(*tparts)
    if layout == "dense":
        (canvas * torch.from_numpy(nchw(g))).sum().backward()
    else:
        rng = np.random.RandomState(c + 1)
        before, after = (torch.from_numpy(rng.standard_normal((2, n, 128, 128)).astype(np.float32))
                         for n in (5, 3))
        wide = torch.cat([before, canvas, after], dim=1)
        g_wide = torch.from_numpy(rng.standard_normal(tuple(wide.shape)).astype(np.float32))
        g_wide[:, 5 : 5 + c] = torch.from_numpy(nchw(g))
        seen, plain = [], kernels.fuse_parts_bwd_plain
        spy = lambda parts_, out, g_: seen.append(g_) or plain(parts_, out, g_)
        with mock.patch.object(kernels, "fuse_parts_bwd_plain", spy):
            (wide * g_wide).sum().backward()
        assert len(seen) == 1 and not seen[0].is_contiguous()
        assert seen[0].stride() == ((5 + c + 3) * 128 * 128, 128 * 128, 128, 1)
    for t, w in zip(tparts, want):
        np.testing.assert_array_equal(nhwc(t.grad.numpy()), np.asarray(w))
    # the ties at 0 really are ties that both sides hand the gradient to
    assert np.count_nonzero(np.asarray(want[0])[:, :5]) > 0
    assert kernels.copy_counts()["fuse_parts_bwd_g"] == 0  # the CPU path copies nothing


def test_fuse_saves_the_parts_not_the_canvas():
    """Autograd keeps the four parts only: the backward recomputes the
    canvas, so the canvas is freed once its consumer is done with it."""
    saved = []
    tparts = [t.requires_grad_() for t in _torch(_parts(2, 4, seed=6))]
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        canvas = kernels.fuse_parts(*tparts)
    assert [tuple(t.shape) for t in saved] == [tuple(p.shape) for p in tparts]
    canvas.sum().backward()
    assert all(p.grad is not None and p.grad.shape == p.shape for p in tparts)


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


@pytest.mark.parametrize("planes,dtype,per_block,bands", [
    (512, torch.bfloat16, 2, 4),  # B=8, C=64: two 12,032-byte planes per block
    (8192, torch.bfloat16, 2, 1),  # B=128, C=64
    (15, torch.bfloat16, 2, 16),  # an odd B*C: the last block takes one plane
    (1, torch.bfloat16, 2, 16),
    (24, torch.bfloat16, 2, 16),  # B=8, C=3: 12 plane pairs in 16 row bands
    (24, torch.float32, 1, 16),  # one 24,064-byte f32 plane per block
    (192, torch.bfloat16, 2, 8),  # B=64, C=3
])
def test_fuse_forward_launch_plan(planes, dtype, per_block, bands):
    plan = kernels.fuse_parts_plan(planes, dtype)
    area = 40 * 40 + 40 * 40 + 32 * 40 + 32 * 48  # 6,016 part pixels per plane
    size = torch.tensor([], dtype=dtype).element_size()
    assert (plan.planes_per_block, plan.bands) == (per_block, bands)
    assert plan.blocks == -(-planes // per_block) * bands
    assert plan.blocks >= kernels.FUSE_FILL_BLOCKS or bands == kernels.FUSE_MAX_BANDS
    assert plan.smem_bytes == per_block * area * size <= kernels.FUSE_STAGE_BYTES
    # each part row starts 16-byte aligned, as the 16-byte copies need
    assert all(w * size % 16 == 0 for (h, w), _ in PART_GEOMETRY.values())


@pytest.mark.parametrize("planes,dtype,bands,band_rows", [
    (3, torch.bfloat16, 15, 6),  # B=1, C=3: 16 bands of the 86 rows, the last one dropped
    (64, torch.bfloat16, 8, 11),  # B=1, C=64
    (48, torch.bfloat16, 8, 11),  # B=16, C=3: 384 blocks
    (1024, torch.bfloat16, 1, 86),  # B=16, C=64: one band, 28,544 bytes of staging
    (192, torch.bfloat16, 2, 43),  # B=64, C=3
    (4096, torch.bfloat16, 1, 86),  # B=64, C=64
    (15, torch.bfloat16, 15, 6),  # an odd B*C
    (128, torch.bfloat16, 4, 22),  # B=2, C=64
    (48, torch.float32, 8, 11),
    (1024, torch.float32, 1, 86),  # 55,712 bytes: above 48 KB, opted in at launch
])
def test_fuse_backward_launch_plan(planes, dtype, bands, band_rows):
    plan = kernels.fuse_parts_bwd_plan(planes, dtype)
    size = torch.tensor([], dtype=dtype).element_size()
    assert (plan.bands, plan.band_rows) == (bands, band_rows)
    assert plan.blocks == planes * bands  # one plane per block
    # the bands cover the 86 rows some slot covers (18..103), none of them empty
    assert bands * band_rows >= 86 > (bands - 1) * band_rows
    # at least FUSE_BWD_FILL_BLOCKS blocks, unless the rows are split FUSE_MAX_BANDS ways
    assert plan.blocks >= kernels.FUSE_BWD_FILL_BLOCKS or \
        band_rows == -(-86 // kernels.FUSE_MAX_BANDS)
    # g's window: whole 16-byte chunks over the slots' columns 18..104
    win_lo, win_w = kernels.fuse_bwd_g_window(size)
    assert (win_lo, win_w) == ((16, 96) if size == 2 else (16, 92))
    parts = sum(min(h, band_rows) * w for (h, w), _ in PART_GEOMETRY.values())
    assert plan.smem_bytes == (parts + band_rows * win_w) * size
    assert plan.smem_bytes <= 227 * 1024  # an H100 block's shared memory
