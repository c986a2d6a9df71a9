"""Cases of the PyTorch port that need an NVIDIA GPU: the hand-written
CUDA kernels against their plain versions on the card, and the paths
around them (graphs, data, the detector, frontalize, int8, export). They skip on a
host without CUDA. This file imports nothing of JAX, so it also runs on a
GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from tpgan_tpu_torch.config import make_config
from tpgan_tpu_torch.ops import kernels
from tpgan_tpu_torch.ops.geometry import PART_GEOMETRY, PART_NAMES
from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
from tpgan_tpu_torch.examples import conv_ab
from tpgan_tpu_torch.train.gan_trainer import (
    build_generator,
    create_gan_state,
    make_gan_train_step,
    make_synthesize_fn,
)

torch.set_num_threads(1)

# the detector's f32 step, card against CPU: the movement of the
# parameters in relative L2 over all leaves (the CPU tests hold each f32
# side within 2.5e-2 of a float64 run: the seeded MobileNetV2 is
# ill-conditioned in f32; chip_smoke.py phase 16 measured 7.8e-3 - 2.0e-2)
PRETRAIN_MOVE_REL_L2 = 5e-2


def _profiler_warm_up(device):
    """A throwaway kernel first in a trace: on the H100 the first device
    event after the profiler starts has gone missing from its trace."""
    torch.zeros(1, device=device).add_(1)
    torch.cuda.synchronize()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _parts(b, c, dtype, device, seed=0):
    """NCHW parts with negatives, an exact nose/left-eye tie, zeros and a NaN."""
    rng = np.random.RandomState(seed)
    parts = [rng.standard_normal((b, c) + PART_GEOMETRY[n][0]).astype(np.float32)
             for n in PART_NAMES]
    parts[2][:, :, 0:8, 0:10] = parts[0][:, :, 28:36, 25:35]
    parts[0][:, :, :5] = 0.0
    parts[2][0, c - 1, 3, 4] = np.nan
    return [torch.from_numpy(p).to(device, dtype) for p in parts]


@pytest.mark.parametrize(
    "c,dtype", [(64, torch.bfloat16), (3, torch.bfloat16), (3, torch.float32)]
)
def test_fuse_kernel_equals_plain_version(cuda, c, dtype):
    parts = _parts(8, c, dtype, cuda, seed=c)
    before = kernels.launch_counts()["fuse_parts"]
    got = kernels.fuse_parts(*parts)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fuse_parts"] == before + 1
    want = kernels.fuse_parts_plain(*parts)
    assert int(got.isnan().sum()) == 1
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0))


@pytest.mark.parametrize("b,c,dtype,bands", [
    (1, 64, torch.bfloat16, 16),  # B = 1
    (3, 5, torch.bfloat16, 16),  # B*C odd: the last block takes one plane
    (1, 3, torch.float32, 16),
    (64, 3, torch.bfloat16, 8),  # each row-band split the plan makes
    (8, 64, torch.bfloat16, 4),
    (16, 64, torch.bfloat16, 2),
    (64, 64, torch.bfloat16, 1),
    (8, 64, torch.float32, 2),
])
def test_fuse_kernel_takes_any_plane_count(cuda, b, c, dtype, bands):
    """Plane counts and row-band splits; NaN, an exact tie and zeros
    planted (``_parts``)."""
    plan = kernels.fuse_parts_plan(b * c, dtype)
    assert plan.bands == bands and plan.planes_per_block == (2 if dtype == torch.bfloat16 else 1)
    parts = _parts(b, c, dtype, cuda, seed=b + c)
    got = kernels.fuse_parts(*parts)
    want = kernels.fuse_parts_plain(*parts)
    torch.cuda.synchronize()
    assert int(got.isnan().sum()) == 1
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fuse_kernel_stages_misaligned_parts(cuda, dtype):
    """A part that starts one element past a 16-byte boundary takes the
    element copies into shared memory; the result is the same."""
    parts = _parts(2, 8, dtype, cuda, seed=4)
    shifted = torch.empty(parts[1].numel() + 1, dtype=dtype, device=cuda)[1:]
    shifted.copy_(parts[1].reshape(-1))
    parts[1] = shifted.view(parts[1].shape)
    assert parts[1].data_ptr() % 16 != 0
    got = kernels.fuse_parts(*parts)
    want = kernels.fuse_parts_plain(*parts)
    torch.cuda.synchronize()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0))


def test_fuse_kernel_rejects_instead_of_falling_back(cuda):
    parts = _parts(2, 3, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.fuse_parts(*parts[:3], parts[3].transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernels.fuse_parts(*(p.half() for p in parts))


@pytest.mark.parametrize("layout", ["dense", "cat_slice"])
def test_fuse_gradient_on_cuda_equals_cpu(cuda, layout):
    """Through autograd on both devices; ``cat_slice``: the canvas feeds a
    ``torch.cat``, so its cotangent is a channel slice of the cat's, which
    the kernel reads in place. Autograd saves the parts, not the canvas."""
    parts = [p.nan_to_num(0.0) for p in _parts(2, 16, torch.float32, cuda, seed=3)]
    rng = torch.Generator().manual_seed(0)
    g = torch.randn(2, 16 + 8 * (layout == "cat_slice"), 128, 128, generator=rng)
    others = [torch.randn(2, 5, 128, 128, generator=rng), torch.randn(2, 3, 128, 128, generator=rng)]
    grads = []
    for device in (cuda, torch.device("cpu")):
        ps = [p.detach().to(device).requires_grad_() for p in parts]
        saved = []
        copies = kernels.copy_counts()["fuse_parts_bwd_g"]
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
            canvas = kernels.fuse_parts(*ps)
        assert [tuple(t.shape) for t in saved] == [tuple(p.shape) for p in ps]
        if layout == "cat_slice":
            canvas = torch.cat([others[0].to(device), canvas, others[1].to(device)], dim=1)
        (canvas * g.to(device)).sum().backward()
        assert kernels.copy_counts()["fuse_parts_bwd_g"] == copies
        grads.append([p.grad.cpu() for p in ps])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_small_bf16_synthesis_goes_through_the_kernel(cuda):
    cfg = make_config({"G": {"fm_multiplier": 0.25, "local_feature_layer_dim": 16},
                       "compute_dtype": "bfloat16"})
    synthesize = make_synthesize_fn(cfg, build_generator(cfg, cuda, seed=0))
    rng = np.random.RandomState(1)
    batch = {k: rng.uniform(-1, 1, (2, h, w, 3)).astype(np.float32)
             for k, (h, w) in [("img", (128, 128))]
             + [(n, PART_GEOMETRY[n][0]) for n in PART_NAMES]}
    before = kernels.launch_counts()["fuse_parts"]
    out = synthesize(batch, np.zeros((2, cfg.G.zdim), np.float32))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fuse_parts"] == before + 3
    assert out.shape == (2, 128, 128, 3) and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()


def _tied_image(b, dtype, device, seed=0):
    """NCHW (b, 3, 128, 128) with TV ties, symmetry ties, zeros and a NaN."""
    x = np.random.RandomState(seed).uniform(-1, 1, (b, 3, 128, 128)).astype(np.float32)
    x[:, :, 10] = x[:, :, 9]
    x[:, :, :, 40] = x[:, :, :, 41]
    x[:, :, :, 100] = x[:, :, :, 27]  # mirror of column 27
    x[0, 1, 60:70, 60:70] = 0.0
    return torch.from_numpy(x).to(device, dtype)


def _cotangent(b, c, dtype, device, layout, seed=1):
    """A (b, c, 128, 128) g with a NaN inside the left-eye / nose overlap:
    ``cat_slice`` a channel slice of a wider tensor (a torch.cat's
    gradient), ``contiguous``, or ``transposed`` (rows not dense)."""
    rng = torch.Generator(device=device).manual_seed(seed)
    wide = torch.randn(b, c + 7, 128, 128, generator=rng, device=device).to(dtype)
    g = {"cat_slice": wide[:, 4 : 4 + c], "contiguous": wide[:, :c].contiguous(),
         "transposed": wide[:, :c].transpose(2, 3).contiguous().transpose(2, 3)}[layout]
    g[0, c - 1, 50, 50] = float("nan")  # passes where the part reaches the max
    return g


def _check_fuse_bwd(parts, g, copies):
    """The backward kernel against the plain version, ``copies`` copies of
    g counted, one launch."""
    launches = kernels.launch_counts()["fuse_parts_bwd"]
    before = kernels.copy_counts()["fuse_parts_bwd_g"]
    got = kernels._launch_fuse_bwd(parts, g)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fuse_parts_bwd"] == launches + 1
    assert kernels.copy_counts()["fuse_parts_bwd_g"] == before + copies
    want = kernels.fuse_parts_bwd_plain(parts, kernels.fuse_parts_plain(*parts), g)
    for a, b, p in zip(got, want, parts):
        assert a.dtype == p.dtype and a.shape == p.shape
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))
    return got


@pytest.mark.parametrize("c,dtype", [(64, torch.bfloat16), (3, torch.bfloat16), (3, torch.float32)])
def test_fuse_backward_kernel_equals_plain_version(cuda, c, dtype):
    """A g whose rows are not dense is copied once (counted), then the
    kernel runs; NaN in a part and in g, ties, zeros."""
    parts = _parts(4, c, dtype, cuda, seed=c + 1)
    parts[0][0, c - 1, 31, 32] = parts[2][0, c - 1, 3, 7] = 1.0  # a tie at g's NaN, (50, 50)
    got = _check_fuse_bwd(parts, _cotangent(4, c, dtype, cuda, "transposed"), copies=1)
    assert bool(got[0][0, c - 1, 31, 32].isnan()) and bool(got[2][0, c - 1, 3, 7].isnan())


@pytest.mark.parametrize("layout,copies", [("cat_slice", 0), ("contiguous", 0), ("transposed", 1)])
@pytest.mark.parametrize("c,dtype", [(64, torch.bfloat16), (3, torch.bfloat16), (16, torch.float32)])
def test_fuse_backward_kernel_takes_g_as_autograd_hands_it(cuda, layout, copies, c, dtype):
    parts = _parts(16, c, dtype, cuda, seed=c)
    _check_fuse_bwd(parts, _cotangent(16, c, dtype, cuda, layout), copies)


@pytest.mark.parametrize("b,c,dtype,bands", [
    (1, 64, torch.bfloat16, 8),  # B = 1
    (3, 5, torch.bfloat16, 15),  # B*C odd
    (16, 3, torch.bfloat16, 8),  # the C=3 backward of the train step
    (64, 3, torch.bfloat16, 2),  # each band split the plan makes
    (2, 64, torch.bfloat16, 4),
    (16, 64, torch.bfloat16, 1),  # the C=64 backward of the train step
    (64, 64, torch.bfloat16, 1),
    (1, 3, torch.float32, 15),
    (16, 3, torch.float32, 8),
    (64, 3, torch.float32, 2),
    (8, 64, torch.float32, 1),  # 55.7 KB of shared memory per block
])
def test_fuse_backward_kernel_takes_any_plane_count(cuda, b, c, dtype, bands):
    assert kernels.fuse_parts_bwd_plan(b * c, dtype).bands == bands
    parts = _parts(b, c, dtype, cuda, seed=b + c)
    _check_fuse_bwd(parts, _cotangent(b, c, dtype, cuda, "cat_slice"), copies=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fuse_backward_kernel_stages_misaligned_inputs(cuda, dtype):
    """A part and a g that start one element past a 16-byte boundary take
    the element copies into shared memory; nothing is copied in Python."""
    parts = _parts(2, 8, dtype, cuda, seed=5)
    shifted = torch.empty(parts[3].numel() + 1, dtype=dtype, device=cuda)[1:]
    shifted.copy_(parts[3].reshape(-1))
    parts[3] = shifted.view(parts[3].shape)
    g = _cotangent(2, 8, dtype, cuda, "contiguous")
    g_shifted = torch.empty(g.numel() + 1, dtype=dtype, device=cuda)[1:].view(g.shape)
    g_shifted.copy_(g)
    assert parts[3].data_ptr() % 16 != 0 and g_shifted.data_ptr() % 16 != 0
    _check_fuse_bwd(parts, g_shifted, copies=0)
    _check_fuse_bwd(parts, g, copies=0)  # aligned g, misaligned part


def test_fuse_backward_rejects_instead_of_falling_back(cuda):
    parts = _parts(2, 3, torch.float32, cuda)
    g = _cotangent(2, 3, torch.float32, cuda, "contiguous")
    with pytest.raises(TypeError, match="g is torch.bfloat16"):
        kernels._launch_fuse_bwd(parts, g.bfloat16())
    with pytest.raises(ValueError, match="expected"):
        kernels._launch_fuse_bwd(parts, g[:, :2])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sym_tv_kernels_equal_plain_versions(cuda, dtype):
    x = _tied_image(4, dtype, cuda)
    before = kernels.launch_counts()
    sums, sym, tv = kernels._launch_sym_tv(x)
    sums2, sym2, tv2 = kernels._launch_sym_tv(x)
    torch.cuda.synchronize()
    assert torch.equal(sums, sums2) and torch.equal(sym, sym2) and torch.equal(tv, tv2)
    torch.testing.assert_close(sums, kernels.sym_tv_sums_plain(x), rtol=1e-5, atol=0)
    want_sym, want_tv = kernels.symmetry_tv_plain(x)
    torch.testing.assert_close(sym, want_sym, rtol=1e-5, atol=0)
    torch.testing.assert_close(tv, want_tv, rtol=1e-5, atol=0)
    g_sym, g_tv = torch.tensor(0.3, device=cuda), torch.tensor(0.007, device=cuda)
    dx = kernels._launch_sym_tv_bwd(x, g_sym, g_tv)
    torch.cuda.synchronize()
    assert dx.dtype == dtype
    assert _same(dx, kernels.sym_tv_bwd_plain(x, g_sym, g_tv))
    after = kernels.launch_counts()
    assert after["sym_tv"] == before["sym_tv"] + 2
    assert after["sym_tv_bwd"] == before["sym_tv_bwd"] + 1
    # NaN: the sums turn NaN; the backward follows JAX's select (NaN -> -1)
    x[1, 2, 5, 5] = float("nan")
    _, sym_nan, _ = kernels._launch_sym_tv(x)
    assert torch.isnan(sym_nan)
    assert _same(kernels._launch_sym_tv_bwd(x, g_sym, g_tv),
                 kernels.sym_tv_bwd_plain(x, g_sym, g_tv))


def _same(a, b):
    """torch.equal, NaN-aware."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


def _bwd_image(shape, dtype, device, seed=0):
    """An NCHW x with the ties the K2 backward's layout makes hard: at each
    16-byte chunk boundary, at the row ends, between one row's last
    element and the next row's first (bf16 lanes 15/16 and 31/0, f32 lanes
    31/0 of a warp), between the rows at band boundaries (rows 1, 2, 4
    and 8: bands of 1 and 4 rows) and at the plane's first and last rows,
    with a column's mirror; zeros and a NaN."""
    b, c, h, w = shape
    per = 16 // torch.tensor([], dtype=dtype).element_size()
    x = np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)
    for col in range(per, w, per):  # chunk boundaries
        x[..., col] = x[..., col - 1]
    x[..., 1] = x[..., 0]
    x[..., w - 2] = x[..., w - 1]
    x[:, :, 1:, 0] = x[:, :, :-1, w - 1]  # across the row boundary
    for y in (1, 2, 4, 8, h - 1):  # band boundaries and the plane's last row
        if y < h:
            x[:, :, y] = x[:, :, y - 1]
    if w > 7:
        x[..., w - 4] = x[..., 3]  # mirror ties
    x[0, 0, :2, :2] = 0.0
    x[-1, -1, h // 2, w // 2] = np.nan
    return torch.from_numpy(x).to(device, dtype)


def _check_sym_tv_bwd(x, variant):
    """The K2 backward against its plain version, bit for bit; one launch,
    of ``variant``."""
    g_sym, g_tv = torch.tensor(0.3, device=x.device), torch.tensor(0.007, device=x.device)
    launches = kernels.launch_counts()["sym_tv_bwd"]
    variants = kernels.sym_tv_bwd_variant_counts()
    dx = kernels._launch_sym_tv_bwd(x, g_sym, g_tv)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sym_tv_bwd"] == launches + 1
    assert kernels.sym_tv_bwd_variant_counts() == {**variants, variant: variants[variant] + 1}
    assert dx.dtype == x.dtype and dx.shape == x.shape
    assert _same(dx, kernels.sym_tv_bwd_plain(x, g_sym, g_tv))
    # another upstream pair: the scalars are read from device memory
    g_sym, g_tv = torch.tensor(-1.5, device=x.device), torch.tensor(2.0, device=x.device)
    assert _same(kernels._launch_sym_tv_bwd(x, g_sym, g_tv),
                 kernels.sym_tv_bwd_plain(x, g_sym, g_tv))


@pytest.mark.parametrize("shape,dtype,variant,lanes", [
    ((16, 3, 128, 128), torch.bfloat16, "banded", 16),  # the train step at batch 16
    ((64, 3, 128, 128), torch.bfloat16, "banded", 16),  # batch 64
    ((8, 3, 128, 128), torch.float32, "banded", 32),  # the f32 step at batch 8
    ((1, 3, 128, 128), torch.bfloat16, "banded", 16),  # B = 1
    ((3, 1, 128, 128), torch.bfloat16, "banded", 16),  # B*C odd
    ((5, 3, 128, 128), torch.float32, "banded", 32),
    ((2, 3, 13, 128), torch.bfloat16, "banded", 16),  # H not a multiple of any band
    ((2, 3, 9, 24), torch.bfloat16, "banded", 4),  # 3 chunks in a group of 4 lanes
    ((2, 3, 16, 12), torch.float32, "banded", 4),
    ((2, 3, 10, 256), torch.bfloat16, "banded", 32),  # a row of 32 chunks
    ((2, 3, 5, 8), torch.bfloat16, "banded", 1),  # a row of one chunk
    ((2, 3, 7, 5), torch.bfloat16, "general", 0),  # W not a multiple of a chunk
    ((2, 3, 7, 5), torch.float32, "general", 0),
    ((2, 2, 6, 264), torch.float32, "general", 0),  # 66 chunks: wider than a warp
    ((2, 3, 12, 2), torch.bfloat16, "general", 0),
])
def test_sym_tv_backward_kernel_equals_plain_version(cuda, shape, dtype, variant, lanes):
    plan = kernels.sym_tv_bwd_plan(shape, dtype)
    assert (plan.variant, plan.lanes_per_row) == (variant, lanes)
    _check_sym_tv_bwd(_bwd_image(shape, dtype, cuda, seed=sum(shape)), variant)


@pytest.mark.parametrize("shape,dtype,band_rows", [
    ((16, 3, 128, 128), torch.bfloat16, 1), ((8, 3, 128, 128), torch.float32, 1),
    ((64, 3, 128, 128), torch.bfloat16, 4), ((64, 3, 128, 128), torch.float32, 4),
    ((2, 3, 13, 128), torch.bfloat16, 1),
    ((96, 3, 126, 128), torch.bfloat16, 4),  # the last band of each plane is short
    ((176, 3, 13, 128), torch.float32, 4),
    ((1024, 3, 24, 24), torch.bfloat16, 4),  # 3 chunks in a group of 4 lanes
])
def test_sym_tv_backward_kernel_takes_every_band_length(cuda, shape, dtype, band_rows):
    assert kernels.sym_tv_bwd_plan(shape, dtype).band_rows == band_rows
    _check_sym_tv_bwd(_bwd_image(shape, dtype, cuda, seed=band_rows), "banded")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sym_tv_backward_misaligned_x_takes_the_general_kernel(cuda, dtype):
    x = _bwd_image((4, 3, 128, 128), dtype, cuda, seed=3)
    shifted = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)[1:].view(x.shape)
    shifted.copy_(x)
    assert kernels.sym_tv_bwd_plan(tuple(x.shape), dtype, shifted.data_ptr() % 16).variant \
        == "general"
    _check_sym_tv_bwd(shifted, "general")
    _check_sym_tv_bwd(x, "banded")


def test_sym_tv_backward_is_one_launch(cuda):
    x = _bwd_image((16, 3, 128, 128), torch.bfloat16, cuda)
    g = torch.tensor(1.0, device=cuda)
    kernels._launch_sym_tv_bwd(x, g, g)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _profiler_warm_up(x.device)
        kernels._launch_sym_tv_bwd(x, g, g)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len([n for n in names if "sym_tv_bwd" in n]) == 1, names


@pytest.mark.parametrize("shape,dtype", [
    ((1, 3, 128, 128), torch.bfloat16),
    ((16, 3, 128, 128), torch.bfloat16),
    ((64, 3, 128, 128), torch.bfloat16),
    ((16, 3, 128, 128), torch.float32),
    ((2, 3, 7, 5), torch.bfloat16),  # single elements: W is not a 16-byte multiple
    ((2, 3, 7, 5), torch.float32),
    ((3, 2, 9, 24), torch.bfloat16),  # 24 bf16: single elements
    ((3, 2, 9, 24), torch.float32),  # 16-byte chunks, 6 per row
])
def test_sym_tv_forward_kernel_equals_plain_version(cuda, shape, dtype):
    x = torch.from_numpy(np.random.RandomState(sum(shape)).uniform(-1, 1, shape)
                         .astype(np.float32)).to(cuda, dtype)
    x[:, :, 1] = x[:, :, 0]  # H ties
    sums, sym, tv = kernels._launch_sym_tv(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(sums, kernels.sym_tv_sums_plain(x), rtol=1e-5, atol=0)
    want_sym, want_tv = kernels.symmetry_tv_plain(x)
    torch.testing.assert_close(sym, want_sym, rtol=1e-5, atol=0)
    torch.testing.assert_close(tv, want_tv, rtol=1e-5, atol=0)
    x[-1, -1, -1, 0] = float("nan")  # a corner: it reaches all three sums
    sums, sym, tv = kernels._launch_sym_tv(x)
    assert bool(sums.isnan().all()) and bool(sym.isnan()) and bool(tv.isnan())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sym_tv_forward_is_one_deterministic_launch(cuda, dtype):
    """Bit-identical over three calls, with a call of another shape between
    them (a counter left non-zero would change the finish), and one device
    kernel per call."""
    x = _tied_image(16, dtype, cuda)
    other = torch.rand(2, 3, 7, 5, device=cuda, dtype=dtype)
    kernels._launch_sym_tv(x)  # the scratch is made on the first call
    torch.cuda.synchronize()
    before = kernels.launch_counts()["sym_tv"]
    runs = []
    for _ in range(3):
        runs.append(torch.cat([t.reshape(-1) for t in kernels._launch_sym_tv(x)]).clone())
        kernels._launch_sym_tv(other)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sym_tv"] == before + 6
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _profiler_warm_up(x.device)
        kernels._launch_sym_tv(x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len([n for n in names if "sym_tv" in n]) == 1, names


def test_sym_tv_rejects_instead_of_falling_back(cuda):
    x = _tied_image(2, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.symmetry_tv_losses(x.transpose(2, 3))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernels.symmetry_tv_losses(x.half())


def test_small_bf16_train_step_goes_through_every_kernel(cuda):
    cfg = make_config({"G": {"fm_multiplier": 0.25, "local_feature_layer_dim": 16},
                       "D": {"fm_multiplier": 0.25}, "compute_dtype": "bfloat16"})
    state, gen, disc, g_opt, d_opt = create_gan_state(cfg, 0, cuda)
    step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt)
    kernels.reset_launch_counts()
    state, metrics = step(state, synthetic_gan_batch(2, seed=3),
                          torch.Generator(device=cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"fuse_parts": 7, "fuse_parts_bwd": 2,
                                       "sym_tv": 1, "sym_tv_bwd": 1, "conv3x3_bias_lrelu": 0}
    assert kernels.copy_counts() == {"fuse_parts_bwd_g": 0}  # g read where autograd left it
    assert all(torch.isfinite(v.float()) for v in metrics.values())
    assert state.step == 1


def _check_conv3x3(shape, dtype, device, call, variant):
    """K3 through ``call(x, k, b)`` against its plain version, a NaN planted
    at a left-edge pixel; asserts one launch, of ``variant``."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    b_, h, w, cin, cout = shape
    x, k, b = conv_ab.make_inputs(shape, device, dtype)
    x[b_ - 1, h // 2, 0, cin - 1] = float("nan")  # a left-edge pixel
    before = kernels.launch_counts()["conv3x3_bias_lrelu"]
    variants = kernels.conv3x3_variant_counts()
    got = call(x, k, b)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["conv3x3_bias_lrelu"] == before + 1
    assert kernels.conv3x3_variant_counts() == {**variants, variant: variants[variant] + 1}
    rows = min(h // 2 + 1, h - 1) - max(h // 2 - 1, 0) + 1
    assert int(got.isnan().sum()) == rows * min(2, w) * cout  # the pixel's neighbourhood
    conv_ab.check_against_plain(
        got, kernels.conv3x3_bias_lrelu_plain(x, k, b, conv_ab.NEGATIVE_SLOPE))


@pytest.mark.parametrize("shape,dtype", [
    ((2, 9, 13, 5, 7), torch.float32),  # odd sizes
    ((2, 9, 13, 5, 7), torch.bfloat16),  # mma_sync's guarded scalar loads
    ((2, 16, 16, 8, 16), torch.bfloat16),  # the JAX test's shape: tma_wgmma, Cin < 64
    ((2, 16, 16, 8, 16), torch.float32),
    ((3, 17, 19, 24, 40), torch.bfloat16),  # tma_wgmma with H, W, N and K tails
    ((3, 17, 19, 24, 40), torch.float32),
    ((1, 1, 1, 8, 8), torch.bfloat16),  # every tap but the centre in the halo
    *((s, torch.bfloat16) for s in conv_ab.SHAPES),
    (conv_ab.SHAPES[0], torch.float32),
])
def test_conv3x3_kernel_equals_plain_version(cuda, shape, dtype):
    variant = kernels.conv3x3_plan(*shape, dtype).variant
    _check_conv3x3(shape, dtype, cuda, lambda x, k, b: kernels.conv3x3_bias_lrelu(
        x, k, b, conv_ab.NEGATIVE_SLOPE), variant)


@pytest.mark.parametrize("shape,bn", [
    ((2, 6, 96, 64, 64), 64),  # W = 96: the second column tile runs past W
    ((2, 20, 8, 64, 64), 64),  # W = 8: 16 x 8 tiles, the second past H
    ((2, 1, 40, 64, 64), 64),  # H = 1: 4 x 32 tiles, three rows past H
    ((1, 32, 32, 128, 128), 128),  # B = 1
    ((2, 16, 16, 72, 64), 64),  # Cin = 72: TMA zero-fills the second chunk's tail
    ((2, 16, 16, 64, 72), 128),  # Cout = 72: an N tail, the store clips it
    ((2, 12, 12, 32, 200), 256),  # one N tile of 256 over 200 channels
    ((2, 8, 8, 32, 264), 256),  # two N tiles, the second 8 of 256 wide
    ((4, 32, 32, 256, 256), 256),
])
def test_conv3x3_tma_wgmma_equals_plain_version(cuda, shape, bn):
    plan = kernels.conv3x3_plan(*shape, torch.bfloat16)
    assert (plan.variant, plan.bn) == ("tma_wgmma", bn)
    _check_conv3x3(shape, torch.bfloat16, cuda, lambda x, k, b: kernels.conv3x3_bias_lrelu(
        x, k, b, conv_ab.NEGATIVE_SLOPE), "tma_wgmma")


@pytest.mark.parametrize("shape", [(2, 16, 16, 8, 16), (3, 17, 19, 24, 40), conv_ab.SHAPES[0]])
def test_conv3x3_mma_sync_equals_plain_version(cuda, shape):
    """The general bf16 kernel on shapes the plan gives tma_wgmma: its
    16-byte copies, as the A/B times it."""
    _check_conv3x3(shape, torch.bfloat16, cuda, lambda x, k, b: kernels._launch_conv3x3(
        x, k, b, conv_ab.NEGATIVE_SLOPE, variant="mma_sync"), "mma_sync")


def test_conv3x3_misaligned_x_takes_mma_sync(cuda):
    x, k, b = conv_ab.make_inputs((2, 16, 16, 64, 64), cuda, torch.bfloat16)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:].view(x.shape)
    shifted.copy_(x)
    plan = kernels.conv3x3_plan(*x.shape, 64, x.dtype, shifted.data_ptr() % 16)
    assert plan.variant == "mma_sync"
    before = kernels.conv3x3_variant_counts()["mma_sync"]
    got = kernels.conv3x3_bias_lrelu(shifted, k, b, 0.2)
    torch.cuda.synchronize()
    assert kernels.conv3x3_variant_counts()["mma_sync"] == before + 1
    conv_ab.check_against_plain(got, kernels.conv3x3_bias_lrelu_plain(x, k, b, 0.2))


@pytest.mark.parametrize("shape,bn,vec", [
    (conv_ab.SHAPES[0], 64, True),  # 256 x 64 tiles
    (conv_ab.SHAPES[1], 128, True),  # 128 x 128
    (conv_ab.SHAPES[2], 128, True),  # two N tiles
    ((2, 6, 96, 64, 64), 64, True),  # W 96: tiles run across image rows
    ((2, 20, 8, 64, 64), 64, True),  # W 8
    ((2, 1, 40, 64, 64), 64, True),  # H 1: only the middle row of taps in the image
    ((1, 32, 32, 128, 128), 128, True),  # B 1
    ((2, 16, 16, 72, 64), 64, True),  # Cin 72: the fifth 16-channel step half zero-filled
    ((2, 9, 13, 5, 64), 64, False),  # Cin 5: guarded element-wise copies
    ((2, 16, 16, 64, 72), 128, True),  # Cout 72: an N tail
    ((2, 12, 12, 32, 200), 128, True),  # two N tiles, the second 72 wide
    ((2, 8, 8, 32, 264), 128, True),  # three N tiles, the third 8 wide
])
def test_conv3x3_f32_kernel_equals_plain_version(cuda, shape, bn, vec):
    """The f32 CUDA-core kernel at the A/B shapes and its tails, each in
    the tile and copy path its plan gives, a NaN planted."""
    plan = kernels.conv3x3_plan(*shape, torch.float32)
    assert (plan.variant, plan.bn, plan.vec) == ("f32", bn, vec)
    _check_conv3x3(shape, torch.float32, cuda, lambda x, k, b: kernels.conv3x3_bias_lrelu(
        x, k, b, conv_ab.NEGATIVE_SLOPE), "f32")


def test_conv3x3_f32_misaligned_x_takes_the_guarded_path(cuda):
    x, k, b = conv_ab.make_inputs((2, 16, 16, 64, 64), cuda, torch.float32)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 == 4
    plan = kernels.conv3x3_plan(*x.shape, 64, x.dtype, shifted.data_ptr() % 16)
    assert (plan.variant, plan.vec) == ("f32", False)
    before = kernels.conv3x3_variant_counts()["f32"]
    got = kernels.conv3x3_bias_lrelu(shifted, k, b, 0.2)
    torch.cuda.synchronize()
    assert kernels.conv3x3_variant_counts()["f32"] == before + 1
    conv_ab.check_against_plain(got, kernels.conv3x3_bias_lrelu_plain(x, k, b, 0.2))


@pytest.mark.parametrize("cin", [8, 5])  # 16-byte copies and guarded
def test_conv3x3_f32_kernel_leaky_relu_at_exact_zero(cuda, cin):
    """A zero kernel leaves the bias: y = 0 and -0 stay as they are (the
    y >= 0 branch), a negative bias is scaled by the slope; bit for bit."""
    x = torch.from_numpy(np.random.RandomState(3).randn(1, 4, 5, cin).astype(np.float32)).to(cuda)
    k = torch.zeros(3, 3, cin, 4, device=cuda)
    b = torch.tensor([0.0, -0.0, -1.5, 2.0], device=cuda)
    got = kernels.conv3x3_bias_lrelu(x, k, b, 0.2)
    want = kernels.conv3x3_bias_lrelu_plain(x, k, b, 0.2)
    assert torch.equal(got, want) and torch.equal(got.signbit(), want.signbit())
    assert got[0, 0, 0].tolist() == [0.0, 0.0, float(np.float32(-1.5) * np.float32(0.2)), 2.0]


def test_conv3x3_kernel_takes_an_f32_bias_beside_bf16(cuda):
    for shape in ((2, 16, 16, 8, 16), (2, 16, 16, 64, 72)):  # both tma_wgmma
        x, k, b = conv_ab.make_inputs(shape, cuda, torch.bfloat16)
        b32 = b.float() + 1e-3  # not representable in bf16
        before = kernels.conv3x3_variant_counts()["tma_wgmma"]
        conv_ab.check_against_plain(kernels.conv3x3_bias_lrelu(x, k, b32, 0.2),
                                    kernels.conv3x3_bias_lrelu_plain(x, k, b32, 0.2))
        assert kernels.conv3x3_variant_counts()["tma_wgmma"] == before + 1


def test_conv3x3_rejects_instead_of_falling_back(cuda):
    x, k, b = conv_ab.make_inputs((2, 9, 13, 5, 7), cuda, torch.float32)
    before = kernels.launch_counts()["conv3x3_bias_lrelu"]
    with pytest.raises(ValueError, match="contiguous"):
        kernels.conv3x3_bias_lrelu(x.transpose(1, 2).contiguous().transpose(1, 2), k, b)
    with pytest.raises(TypeError, match="kernel"):
        kernels.conv3x3_bias_lrelu(x, k.bfloat16(), b)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernels.conv3x3_bias_lrelu(x.half(), k.half(), b)
    with pytest.raises(ValueError, match="forward only"):
        kernels.conv3x3_bias_lrelu(x.clone().requires_grad_(), k, b)
    assert kernels.launch_counts()["conv3x3_bias_lrelu"] == before


SMALL = {"G": {"fm_multiplier": 0.25, "local_feature_layer_dim": 16},
         "D": {"fm_multiplier": 0.25}}


def _f32_exact():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _written(state):
    out = [p.detach() for m in (state.gen, state.disc) for p in m.parameters()]
    out += list(state.g_ema_params.values())
    for opt in (state.g_opt, state.d_opt):
        out += [v for s in opt.state.values() for v in s.values()]
    return out


def test_multi_step_graph_replays_equal_eager_steps(cuda):
    """K=3 replays of the captured f32 step against 3 eager steps from the
    same seeded state, batches and generator seed, the eager step's
    optimizers made capturable as the capture makes the graph's, after a
    warm-up step (a process's first f32 step differs in the last bits,
    ROADMAP C2)."""
    from tpgan_tpu_torch.train.gan_trainer import make_multi_step
    from tpgan_tpu_torch.train.optim import make_capturable

    _f32_exact()
    cfg = make_config(dict(SMALL, compute_dtype="float32"))
    batches = [synthetic_gan_batch(2, seed=s) for s in range(3)]
    warm, *models = create_gan_state(cfg, 0, cuda)
    make_gan_train_step(cfg, *models)(warm, batches[0], torch.Generator(device=cuda).manual_seed(1))
    runs = []
    for graphed in (False, True):
        state, gen, disc, g_opt, d_opt = create_gan_state(cfg, 0, cuda)
        step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt)
        generator = torch.Generator(device=cuda).manual_seed(5)
        kernels.reset_launch_counts()
        assert not g_opt.param_groups[0]["capturable"]  # the eager default
        if graphed:
            multi = make_multi_step(step, 3)
            state, metrics = multi(state, {k: np.stack([b[k] for b in batches]) for k in batches[0]},
                                   generator)
            assert multi.launches() == {"fuse_parts": 7, "fuse_parts_bwd": 2, "sym_tv": 1,
                                        "sym_tv_bwd": 1, "conv3x3_bias_lrelu": 0}
        else:
            make_capturable(g_opt)
            make_capturable(d_opt)
            history = [step(state, b, generator)[1] for b in batches]
            metrics = {k: torch.stack([m[k] for m in history]) for k in history[0]}
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        # eager: 3 steps; graphed: the 2 warm-up steps only (a replay runs
        # no wrapper)
        steps = 2 if graphed else 3
        assert counts["fuse_parts"] == 7 * steps and counts["sym_tv_bwd"] == steps
        assert state.step == 3
        assert all(opt.param_groups[0]["capturable"] for opt in (g_opt, d_opt))
        runs.append((metrics, [t.clone() for t in _written(state)]))
    torch.backends.cudnn.deterministic = False
    (m_eager, t_eager), (m_graph, t_graph) = runs
    for k in m_eager:
        assert m_graph[k].shape == (3,) and torch.equal(m_graph[k], m_eager[k]), k
    assert len(t_eager) == len(t_graph)
    assert all(torch.equal(a, b) for a, b in zip(t_eager, t_graph))


def test_multi_step_graph_refuses_a_replaced_state_or_generator(cuda):
    from tpgan_tpu_torch.train.gan_trainer import make_multi_step

    cfg = make_config(dict(SMALL, compute_dtype="bfloat16"))
    state, gen, disc, g_opt, d_opt = create_gan_state(cfg, 0, cuda)
    multi = make_multi_step(make_gan_train_step(cfg, gen, disc, g_opt, d_opt), 2)
    batches = [synthetic_gan_batch(2, seed=s) for s in range(2)]
    super_batch = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    generator = torch.Generator(device=cuda).manual_seed(0)
    state, metrics = multi(state, super_batch, generator)
    assert state.step == 2 and all(torch.isfinite(v.float()).all() for v in metrics.values())
    with pytest.raises(ValueError, match="captured with"):
        multi(state, super_batch, torch.Generator(device=cuda).manual_seed(0))
    moments = g_opt.state[next(gen.parameters())]
    moments["exp_avg"] = moments["exp_avg"].clone()  # a new tensor in the state
    with pytest.raises(RuntimeError, match="replaced since the capture"):
        multi(state, super_batch, generator)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_synthesis_equals_eager(cuda, dtype):
    from tpgan_tpu_torch.train.gan_trainer import make_graphed_synthesize_fn

    _f32_exact()
    cfg = make_config(dict(SMALL, compute_dtype=dtype))
    gen = build_generator(cfg, cuda, seed=0)
    graphed, eager = make_graphed_synthesize_fn(cfg, gen), make_synthesize_fn(cfg, gen)
    # the first shape's graph again, on a batch other than the one it was
    # captured on
    for b, seed, new in ((2, 0, True), (3, 1, True), (2, 2, False)):
        batch = {k: v for k, v in synthetic_gan_batch(b, seed=seed).items()
                 if k in ("img", "left_eye", "right_eye", "nose", "mouth")}
        z = np.random.RandomState(seed).standard_normal((b, cfg.G.zdim)).astype(np.float32)
        kernels.reset_launch_counts()
        got = graphed(batch, z)
        torch.cuda.synchronize()
        # 2 eager warm-up calls' 3 each on a new shape; a replay runs no wrapper
        assert kernels.launch_counts()["fuse_parts"] == (6 if new else 0)
        # the same kernels in the same order: bit-equal in bf16 too
        assert torch.equal(got, eager(batch, z))
    torch.backends.cudnn.deterministic = False
    assert graphed.launches()[2]["fuse_parts"] == 3 and sorted(graphed.launches()) == [2, 3]


def _one_dispatch_of(prof, tmp_path, replays):
    """The trace holds one ``graph.dispatch`` span, and the ``replays``
    graph launches the host made all lie inside it."""
    import json

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]

    def spans(cat, name):
        return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
                if e.get("cat") == cat and e.get("name") == name]

    dispatches = spans("user_annotation", "graph.dispatch")
    assert len(dispatches) == 1, dispatches
    (start, end), = dispatches
    launches = spans("cuda_runtime", "cudaGraphLaunch")
    assert len(launches) == replays, launches
    assert all(start <= a <= b <= end for a, b in launches)


def test_multi_step_counts_its_capture_and_spans_each_dispatch(cuda, tmp_path):
    """The first call adds its capture's seconds to ``capture_seconds()``
    and later calls add nothing; a profiled call is one ``graph.dispatch``
    holding its K replays."""
    from tpgan_tpu_torch.train.gan_trainer import make_multi_step
    from tpgan_tpu_torch.utils import graphs

    cfg = make_config(dict(SMALL, compute_dtype="bfloat16"))
    state, gen, disc, g_opt, d_opt = create_gan_state(cfg, 0, cuda)
    multi = make_multi_step(make_gan_train_step(cfg, gen, disc, g_opt, d_opt), 3)
    batches = [synthetic_gan_batch(2, seed=s) for s in range(3)]
    super_batch = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    generator = torch.Generator(device=cuda).manual_seed(0)
    before = graphs.capture_seconds()
    state, _ = multi(state, super_batch, generator)
    torch.cuda.synchronize()
    first = graphs.capture_seconds()
    assert first > before
    _profiler_warm_up(cuda)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        state, _ = multi(state, super_batch, generator)
        torch.cuda.synchronize()
    state, _ = multi(state, super_batch, generator)
    torch.cuda.synchronize()
    assert graphs.capture_seconds() == first
    _one_dispatch_of(prof, tmp_path, 3)


def test_graphed_per_shape_counts_its_capture_and_spans_each_call(cuda, tmp_path):
    from tpgan_tpu_torch.utils import graphs

    graphed = graphs.graphed_per_shape(lambda x: (x * 2.0 + 1.0).relu(), cuda)
    x = torch.randn(4, 8)
    before = graphs.capture_seconds()
    graphed(x)
    first = graphs.capture_seconds()
    assert first > before
    _profiler_warm_up(cuda)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = graphed(x)
        torch.cuda.synchronize()
    assert graphs.capture_seconds() == first
    assert torch.equal(got.cpu(), (x * 2.0 + 1.0).relu())
    _one_dispatch_of(prof, tmp_path, 1)


def test_a_capture_leaves_the_kernel_build_out_of_its_seconds(cuda, monkeypatch):
    """A kernel built in the warm-up (here a first call that stands for a
    1-s nvcc build) adds its seconds to ``ops._build.build_seconds()`` and
    none to the capture's."""
    import time

    from tpgan_tpu_torch.ops import _build
    from tpgan_tpu_torch.utils import graphs

    x = torch.ones(8, device=cuda)
    calls = []

    def fn():
        if not calls:
            time.sleep(1.0)
            monkeypatch.setattr(_build, "_build_seconds", _build.build_seconds() + 1.0)
        calls.append(1)
        return x * 2.0

    before = graphs.capture_seconds()
    graph, out, _launches = graphs.capture(fn, warmup=1)
    graph.replay()
    assert torch.equal(out, x * 2.0) and len(calls) == 2
    assert 0.0 < graphs.capture_seconds() - before < 0.5


# ---- the data path on the card ----------------------------------------

def test_decode_u8_on_the_card_is_correctly_rounded(cuda):
    from tpgan_tpu_torch.train.gan_trainer import decode_u8_batch

    v = np.arange(256, dtype=np.uint8).reshape(16, 16)
    got = decode_u8_batch({"img": torch.from_numpy(v).to(cuda)})["img"].cpu().numpy()
    # a CPU-scalar divisor would be a reciprocal product, off by an ulp
    np.testing.assert_array_equal(got, (2.0 * v.astype(np.float32) - 255.0) / 255.0)


def test_prefetch_to_device_delivers_every_batch_intact(cuda):
    from tpgan_tpu_torch.data.pipeline import batch_iterator, prefetch_to_device

    rng = np.random.RandomState(0)
    items = [{"img": rng.randint(0, 256, (128, 128, 3), np.uint8),
              "label": np.asarray(i, np.int32)} for i in range(24)]
    host = list(batch_iterator(items, 4, seed=1, epochs=3, num_workers=0))
    feed = prefetch_to_device(batch_iterator(items, 4, seed=1, epochs=3, num_workers=0,
                                             pin_memory=True), size=3, device=cuda)
    x = torch.randn(2048, 2048, device=cuda)
    n = 0
    for want, got in zip(host, feed):
        assert got["img"].is_cuda and got["img"].dtype == torch.uint8
        for _ in range(3):  # the consumer's own work, behind the copies
            x = x @ x / 2048
        assert torch.equal(got["img"].cpu(), want["img"]) and torch.equal(got["label"].cpu(),
                                                                         want["label"])
        n += 1
    assert n == len(host) == 18


def test_device_sampler_and_crops_on_the_card(cuda, tmp_path):
    from tpgan_tpu_torch.data.packing import (
        PackedDataset,
        device_batch_iterator,
        load_packed_to_device,
        pack_dataset,
    )
    from tpgan_tpu_torch.data.patches import crop_patches, crop_patches_batch

    items = [{k: v[0] for k, v in synthetic_gan_batch(1, seed=i).items()} for i in range(5)]
    pack_dataset(items, str(tmp_path), shard_size=2)
    data = load_packed_to_device(str(tmp_path), cuda)
    host = PackedDataset(str(tmp_path), to_float=False)
    rng = np.random.RandomState(3)
    for batch in (next(device_batch_iterator(data, 4, seed=3)) for _ in range(1)):
        idx = rng.randint(0, 5, size=(4,))
        for k, v in batch.items():
            assert v.is_cuda
            assert np.array_equal(v.cpu().numpy(), np.stack([host[i][k] for i in idx])), k
    imgs = np.random.RandomState(1).rand(2, 128, 128, 3).astype(np.float32)
    lms = np.asarray([[[-10.5, 40.2], [250.0, 38.7], [63.6, -70.0], [-100.0, 90.0],
                       [83.9, 88.7]],
                      [[39.5, 40.2], [86.0, 38.7], [63.6, 63.6], [45.7, 90.0], [83.9, 88.7]]],
                     np.float32)
    got = crop_patches_batch(torch.from_numpy(imgs).to(cuda), torch.from_numpy(lms).to(cuda))
    for b in range(2):
        for name, want in crop_patches(imgs[b], lms[b]).items():
            assert np.array_equal(got[name][b].cpu().numpy(), want), (b, name)


def _small_embedder(device, seed=0):
    from tpgan_tpu_torch.models.feature_extract import build_feature_extract_model

    return build_feature_extract_model(make_config(), device, seed=seed)


def test_embedder_forward_on_the_card_matches_the_cpu(cuda):
    """The full-width ResNet18 embedder in f32 (TF32 off) on the card
    against the same weights on the CPU: within 1e-4 of each output's
    largest magnitude."""
    _f32_exact()
    model = _small_embedder(cuda).eval()
    cpu = _small_embedder("cpu").eval()
    cpu.load_state_dict(model.state_dict())
    x = torch.from_numpy(np.random.RandomState(0).uniform(-1, 1, (2, 3, 128, 128))
                         .astype(np.float32))
    with torch.no_grad():
        got = [t.cpu() for t in model(x.to(cuda))]
        want = cpu(x)
    torch.backends.cudnn.deterministic = False
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_identity_step_graph_replays_equal_eager_steps(cuda):
    """The f32 step with the identity term on: K=2 replays of the captured
    step against 2 eager steps (capturable optimizers on both sides),
    bit for bit, after a warm-up step; the frozen embedder closed over by
    the graph takes no gradient and does not move."""
    from tpgan_tpu_torch.models.feature_extract import make_identity_embed_fn
    from tpgan_tpu_torch.train.gan_trainer import make_multi_step
    from tpgan_tpu_torch.train.optim import make_capturable

    _f32_exact()
    cfg = make_config(dict(SMALL, compute_dtype="float32"))
    embedder = _small_embedder(cuda, seed=3)
    before = {k: v.clone() for k, v in embedder.state_dict().items()}
    embed = make_identity_embed_fn(embedder)
    batches = [synthetic_gan_batch(2, seed=s) for s in range(2)]
    warm, *models = create_gan_state(cfg, 0, cuda)
    make_gan_train_step(cfg, *models, embed)(warm, batches[0],
                                             torch.Generator(device=cuda).manual_seed(1))
    runs = []
    for graphed in (False, True):
        state, gen, disc, g_opt, d_opt = create_gan_state(cfg, 0, cuda)
        step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt, embed)
        generator = torch.Generator(device=cuda).manual_seed(5)
        if graphed:
            multi = make_multi_step(step, 2)
            state, metrics = multi(state, {k: np.stack([b[k] for b in batches])
                                           for k in batches[0]}, generator)
            assert multi.launches()["fuse_parts"] == 7
        else:
            make_capturable(g_opt)
            make_capturable(d_opt)
            history = [step(state, b, generator)[1] for b in batches]
            metrics = {k: torch.stack([m[k] for m in history]) for k in history[0]}
        torch.cuda.synchronize()
        assert bool((metrics["g_identity_preserving"] > 0).all())
        runs.append((metrics, [t.clone() for t in _written(state)]))
    torch.backends.cudnn.deterministic = False
    (m_eager, t_eager), (m_graph, t_graph) = runs
    assert all(torch.equal(m_graph[k], m_eager[k]) for k in m_eager)
    assert all(torch.equal(a, b) for a, b in zip(t_eager, t_graph))
    assert all(p.grad is None for p in embedder.parameters())
    assert all(torch.equal(v, before[k]) for k, v in embedder.state_dict().items())


def _anchor_offsets(loc, head_mode, size):
    """The anchor head's loc as offsets from its anchors in stride units
    (what its convs emit; the decode multiplies their noise by the
    stride, up to 256 px); the absolute head's loc as it is."""
    from tpgan_tpu_torch.models.mobilenet_v2 import anchor_centres, anchor_strides

    if head_mode != "anchor_offset":
        return loc
    return (loc - anchor_centres((size, size))) / anchor_strides((size, size))


@pytest.mark.parametrize("head_mode", ["absolute", "anchor_offset"])
def test_detector_forward_on_the_card_matches_the_cpu(cuda, head_mode):
    """The full landmark detector in f32 (TF32 off, deterministic cuDNN)
    on the card against the same weights on the CPU: cls, and loc (the
    anchor head's as its offsets in stride units), within 1e-4 of each
    output's largest magnitude in eval mode, 5e-4 with train-mode
    BatchNorm (the batch statistics' sums run in other orders)."""
    from tpgan_tpu_torch.train.pretrain import build_detector

    _f32_exact()
    cfg = make_config({"pretrain": {"head_mode": head_mode}})
    model = build_detector(cfg, cuda, seed=2)
    cpu = build_detector(cfg, "cpu", seed=2)
    cpu.load_state_dict(model.state_dict())
    x = torch.from_numpy(np.random.RandomState(0).uniform(0, 1, (2, 3, 256, 256))
                         .astype(np.float32))
    for train in (False, True):
        model.train(train)
        cpu.train(train)
        with torch.no_grad():
            got = [t.cpu() for t in model(x.to(cuda))]
            want = list(cpu(x))
        got[0], want[0] = (_anchor_offsets(t, head_mode, 256) for t in (got[0], want[0]))
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= (5e-4 if train else 1e-4) * float(w.abs().max())
    torch.backends.cudnn.deterministic = False


def test_pretrain_step_on_the_card_matches_the_cpu(cuda):
    """One f32 pretrain step (batch 4, 256x256, uint8 input, the same
    uniforms) on the card against the CPU: the assignment equal, the loss
    within 1e-5 x |loss| + 1e-6, the parameters' movement within
    PRETRAIN_MOVE_REL_L2 of the CPU's in relative L2 over all leaves and
    every BatchNorm's running statistics within 1e-4 of its largest
    running variance (running means sit near 0)."""
    from tpgan_tpu_torch.train.pretrain import create_pretrain_state, make_pretrain_step

    _f32_exact()
    cfg = make_config()
    rng = np.random.RandomState(1)
    x = (rng.uniform(0, 1, (4, 256, 256, 3)) * 255).astype(np.uint8)
    lbl = rng.uniform(64, 192, (4, 8)).astype(np.float32)
    u = torch.from_numpy(rng.uniform(0, 1, (4, 1540)).astype(np.float32))
    runs = []
    for dev in (cuda, torch.device("cpu")):
        state, model, opt = create_pretrain_state(cfg, 2, dev)
        if runs:
            model.load_state_dict(runs[0][3])
        before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        step = make_pretrain_step(cfg, model, opt, state.scheduler)
        state, metrics, aux = step(state, x, lbl, u=u, return_aux=True)
        runs.append((metrics, aux, {k: v.detach().cpu() for k, v in model.state_dict().items()},
                     before, [k for k, _ in model.named_parameters()]))
    torch.backends.cudnn.deterministic = False
    (gm, ga, gsd, g0, leaves), (cm, ca, csd, c0, _) = runs
    assert torch.equal(ga["assigned"].cpu(), ca["assigned"])
    assert torch.equal(ga["keep_bg"].cpu(), ca["keep_bg"])
    assert abs(float(gm["loss"]) - float(cm["loss"])) <= 1e-5 * abs(float(cm["loss"])) + 1e-6
    move = lambda sd, sd0: torch.cat([(sd[k] - sd0[k]).double().ravel()  # noqa: E731
                                      for k in leaves])
    mg, mc = move(gsd, g0), move(csd, c0)
    assert float((mg - mc).norm() / mc.norm()) <= PRETRAIN_MOVE_REL_L2
    for k, w in csd.items():
        if k.endswith("running_var"):
            base, scale = k[:-len("running_var")], float(w.abs().max())
            for stat in ("running_mean", "running_var"):
                assert float((gsd[base + stat] - csd[base + stat]).abs().max()) <= 1e-4 * scale, k


# ---- full-stack frontalization on the card ------------------------------

def _in_frame_detector(device, size, seed=0, head_mode="absolute"):
    """The full detector with weights from ``seed`` and its location
    biases drawn inside a ``size`` frame for the absolute head, so its
    points fall on the image (its seeded zero biases put every point in a
    corner; the anchor head's put each on its anchor's centre)."""
    from tpgan_tpu_torch.train.pretrain import build_detector

    det = build_detector(make_config({"pretrain": {"head_mode": head_mode}}), device, seed=seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    with torch.no_grad():
        for name, conv in det.ssd_head.named_children():
            if name.startswith("loc") and head_mode == "absolute":
                conv.bias.uniform_(0.15 * size, 0.85 * size, generator=gen)
    return det.eval()


def _face_frames(b, h, w, seed=0):
    from tpgan_tpu_torch.data.synthetic_faces import render_face

    rng = np.random.RandomState(seed)
    out = rng.randint(60, 160, (b, h, w, 3)).astype(np.uint8)
    for i in range(b):
        face, _ = render_face(i, float(rng.uniform(-40, 40)), min(h, w) - 10)
        out[i, 5:5 + face.shape[0], 5:5 + face.shape[1]] = face
    return out


@pytest.mark.parametrize("method", ["lanczos3", "linear", "nearest"])
def test_resampler_on_the_card_matches_the_cpu(cuda, method):
    """resize, the batched scale_and_translate and the whole synthesis
    preprocessing on the card against the CPU, f32 with TF32 off: within
    1e-5 (the matmuls sum in other orders), nearest and the uint8 decode
    bit for bit."""
    from tpgan_tpu_torch.data.jit_preprocess import preprocess_for_synthesis
    from tpgan_tpu_torch.ops.resize import resize, scale_and_translate

    _f32_exact()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 480, 640, 3)).astype(np.float32))
    got, want = resize(x.to(cuda), (2, 128, 96, 3), method).cpu(), resize(x, (2, 128, 96, 3), method)
    if method == "nearest":
        assert torch.equal(got, want)
    else:
        assert float((got - want).abs().max()) <= 1e-5
    s = torch.tensor([0.4, 2.5])
    t = torch.tensor([[-30.0, 12.5], [-400.0, -700.0]])
    got = scale_and_translate(x.to(cuda), (256, 256), s.to(cuda), t.to(cuda), "linear").cpu()
    assert float((got - scale_and_translate(x, (256, 256), s, t, "linear")).abs().max()) <= 1e-5
    imgs = torch.from_numpy((rng.rand(2, 480, 640, 3) * 255).astype(np.uint8))
    lm68 = torch.from_numpy(rng.uniform(100, 400, (2, 68, 2)).astype(np.float32))
    got = preprocess_for_synthesis(imgs.to(cuda), lm68.to(cuda))
    want = preprocess_for_synthesis(imgs, lm68)
    for k, v in want.items():
        assert float((got[k].cpu() - v).abs().max()) <= 1e-5, k
    torch.backends.cudnn.deterministic = False


@pytest.mark.parametrize("head_mode", ["absolute", "anchor_offset"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_frontalize_equals_eager(cuda, dtype, head_mode):
    """The whole program, uint8 frames to (fake, lm5, scores), captured as
    one CUDA graph per shape: its replays bit-equal to the eager function
    on frames other than the capture's, with TTA, refine and a nose prior;
    the eager forward launches K1 three times, a replay none (the
    capture's record holds the 3). Both head modes: the anchor head's
    grid and clip bounds are made on the device inside the capture."""
    from tpgan_tpu_torch.frontalize import make_frontalize_fn, make_graphed_frontalize_fn
    from tpgan_tpu_torch.train.pretrain import fit_nose_prior

    _f32_exact()
    cfg = make_config(dict(SMALL, compute_dtype=dtype))
    det = _in_frame_detector(cuda, 128, head_mode=head_mode)
    gen = build_generator(cfg, cuda, seed=0)
    prior = fit_nose_prior(np.random.RandomState(3).uniform(20, 100, (64, 4, 2)))
    opts = dict(detector_size=128, tta=True, refine=True, nose_prior=prior)
    eager = make_frontalize_fn(cfg, det, gen, **opts)
    graphed = make_graphed_frontalize_fn(cfg, det, gen, **opts)
    z = np.random.RandomState(4).standard_normal((2, cfg.G.zdim)).astype(np.float32)
    graphed(_face_frames(2, 150, 110, seed=1), z)  # the capture
    frames = _face_frames(2, 150, 110, seed=2)
    kernels.reset_launch_counts()
    got = graphed(frames, z)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fuse_parts"] == 0
    want = eager(frames, z)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fuse_parts"] == 3
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert [r["fuse_parts"] for r in graphed.launches().values()] == [3]
    torch.backends.cudnn.deterministic = False


def test_frontalize_entry_launches_k1_three_times_per_forward(cuda):
    from tpgan_tpu_torch.entry import frontalize_entry

    fn, (images, z) = frontalize_entry(batch_size=2)
    kernels.reset_launch_counts()
    fake, lm5, scores = fn(images, z)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fuse_parts"] == 3
    assert fake.shape == (2, 128, 128, 3) and fake.dtype == torch.bfloat16
    assert torch.isfinite(fake.float()).all() and torch.isfinite(lm5).all()
    assert lm5.shape == (2, 5, 2) and scores.shape == (2, 4)


# ---- int8 synthesis and the serving export on the card -------------------

@pytest.mark.parametrize("geometry", [
    (3, 20, 7, 1, (3, 3), 1, 1),  # the RGB stem: K 147, padded to 152
    (16, 9, 3, 1, (1, 1), 1, 4),  # grouped
    (32, 1, 8, 1, (7, 7), 1, 1),  # deconv_8: k8 from 1x1
    (16, 8, 3, 1, (2, 3), 4, 1),  # deconv_32: dilated by 4
])
def test_int8_accumulator_on_the_card_equals_the_cpu(cuda, geometry):
    """cuBLASLt's int8 GEMM (torch._int_mm) gives the CPU's exact sums, the
    K and N padding and the row padding (fewer than 17 rows) included."""
    from tpgan_tpu_torch.ops import quant

    c, h, k, s, pad, dil, groups = geometry
    rng = np.random.RandomState(c + h)
    x_q = torch.from_numpy(rng.randint(-127, 128, (2, c, h, h)).astype(np.int8))
    mats = quant.pack_int8_weight(torch.from_numpy(
        rng.randint(-127, 128, (12, c // groups, k, k)).astype(np.int8)), groups)
    args = ((k, k), (s, s), (pad, pad), (dil, dil))
    want = quant.int8_conv_accumulate(x_q, mats, *args)
    got = quant.int8_conv_accumulate(x_q.to(cuda), mats.to(cuda), *args)
    assert torch.equal(got.cpu(), want)
    small = x_q[:1, :, :3, :3]  # 9 rows for the stem and the grouped conv
    tiny = quant.int8_conv_accumulate(small.to(cuda), mats.to(cuda), *args)
    assert torch.equal(tiny.cpu(), quant.int8_conv_accumulate(small, mats, *args))


@pytest.mark.parametrize("mode,rescale", [("deconv", None), ("subpixel", torch.bfloat16)])
def test_graphed_int8_synthesis_equals_eager(cuda, mode, rescale):
    """The int8 synthesis captures (no host value in its forward), its
    replays equal eager calls on other batches, and K1 runs 3 times per
    forward; the card's output is finite and near the float one (JAX's
    MAE bar, tests/test_quant.py:126)."""
    from tpgan_tpu_torch.ops import quant
    from tpgan_tpu_torch.train.gan_trainer import (
        make_graphed_int8_synthesize_fn,
        make_int8_synthesize_fn,
    )

    cfg = make_config(dict(SMALL, compute_dtype="bfloat16",
                           G=dict(SMALL["G"], upsample_mode=mode)))
    gen = build_generator(cfg, cuda, seed=0)
    keys = ("img", "left_eye", "right_eye", "nose", "mouth")
    batches = [{k: v for k, v in synthetic_gan_batch(2, seed=s).items() if k in keys}
               for s in range(3)]
    z = np.random.RandomState(0).standard_normal((2, cfg.G.zdim)).astype(np.float32)
    scales = quant.calibrate_synthesis(cfg, gen, batches[:1], zs=[z])
    eager = make_int8_synthesize_fn(cfg, gen, scales, rescale_dtype=rescale)
    graphed = make_graphed_int8_synthesize_fn(cfg, gen, scales, rescale_dtype=rescale)
    graphed(batches[1], z)  # the capture
    for batch in batches[1:]:
        kernels.reset_launch_counts()
        got = graphed(batch, z)
        torch.cuda.synchronize()
        assert sum(kernels.launch_counts().values()) == 0
        want = eager(batch, z)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["fuse_parts"] == 3
        assert torch.equal(got, want)
    assert graphed.launches()[2]["fuse_parts"] == 3
    f32 = make_synthesize_fn(cfg, gen)(batches[2], z).float()
    assert torch.isfinite(want.float()).all() and float((want.float() - f32).abs().mean()) < 0.25


def test_int8_entry_launches_k1_three_times_per_forward(cuda):
    from tpgan_tpu_torch.entry import int8_entry

    fn, (batch, z) = int8_entry(batch_size=2)
    kernels.reset_launch_counts()
    out = fn(batch, z)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fuse_parts"] == 3
    assert out.shape == (2, 128, 128, 3) and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()


def test_exported_synthesis_runs_on_the_card(cuda, tmp_path):
    """An artifact exported on the card runs there, within 1e-5 of the
    live f32 program (TF32 off), and its fuse is the plain one: it
    launches no kernel of the port."""
    from tpgan_tpu_torch import serving

    _f32_exact()
    cfg = make_config(dict(SMALL, compute_dtype="float32"))
    gen = build_generator(cfg, cuda, seed=0)
    batch, z = serving.example_inputs(cfg, 2, cuda)
    batch = {k: torch.randn(v.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(i))
             for i, (k, v) in enumerate(batch.items())}
    path = str(tmp_path / "synthesis.pt2")
    serving.export_synthesis(cfg, gen, path, batch=2)
    loaded = serving.load_synthesis(path)
    assert loaded.device.type == "cuda"
    kernels.reset_launch_counts()
    out = loaded(batch, z)
    torch.cuda.synchronize()
    assert sum(kernels.launch_counts().values()) == 0
    live = make_synthesize_fn(cfg, gen)(batch, z)
    torch.backends.cudnn.deterministic = False
    assert float((out - live).abs().max()) <= 1e-5 * float(live.abs().max())


# ---- the command line on the card -----------------------------------------

CLI_SMALL = ["--set", "G.fm_multiplier=0.25", "--set", "G.local_feature_layer_dim=16",
             "--set", "D.fm_multiplier=0.25"]
BF16_PNG_LEVELS = 0.05 * 255  # the synthesis tests' bf16 bound, 5% of the range


def test_cli_synthesize_on_the_card_against_the_cpu(cuda, tmp_path, monkeypatch):
    """``synthesize`` from one checkpoint with the same z, ``--device cuda``
    against ``--device cpu``: f32 (TF32 off) within 1 level on 99% of the
    PNG's values, bf16 within 5% of the range; 3 K1 launches on the card."""
    from tpgan_tpu_torch import cli
    from tpgan_tpu_torch.data.imageio import read_png, write_png
    from tpgan_tpu_torch.data.synthetic_faces import (
        ALL_CAMERA_YAWS,
        landmarks68_string,
        render_face,
    )
    from tpgan_tpu_torch.train.checkpoint import save_checkpoint

    _f32_exact()
    cfg = make_config(dict(SMALL, compute_dtype="float32"))
    state = create_gan_state(cfg, 0, "cpu")[0]
    save_checkpoint(str(tmp_path / "ck"), 0, state)
    img, lm5 = render_face(2, ALL_CAMERA_YAWS["140"], 160)
    write_png(str(tmp_path / "probe.png"), img)
    (tmp_path / "lm.txt").write_text(landmarks68_string(lm5))
    # the CUDA and CPU generators draw different normals: one z for both
    z = torch.randn((1, cfg.G.zdim), generator=torch.Generator().manual_seed(0))
    monkeypatch.setattr(cli, "draw_z", lambda seed, b, zdim, device: z.to(device))
    outs = {}
    for device, dtype in (("cpu", "float32"), ("cuda", "float32"), ("cuda", "bfloat16")):
        out = str(tmp_path / f"{device}_{dtype}.png")
        kernels.reset_launch_counts()
        assert cli.main(["synthesize", "--image", str(tmp_path / "probe.png"), "--landmarks",
                         str(tmp_path / "lm.txt"), "--checkpoint", str(tmp_path / "ck"),
                         "--output", out, *CLI_SMALL, "--set", f"compute_dtype={dtype}",
                         "--device", device]) == 0
        torch.cuda.synchronize()
        assert kernels.launch_counts()["fuse_parts"] == (3 if device == "cuda" else 0)
        outs[device, dtype] = read_png(out).astype(int)
    torch.backends.cudnn.deterministic = False
    f32 = np.abs(outs["cuda", "float32"] - outs["cpu", "float32"])
    assert f32.max() <= 1 and (f32 > 0).mean() <= 0.01, (f32.max(), (f32 > 0).mean())
    bf16 = np.abs(outs["cuda", "bfloat16"] - outs["cpu", "float32"])
    assert bf16.max() <= BF16_PNG_LEVELS, bf16.max()


def test_cli_without_a_visible_card_exits_3(cuda):
    import os
    import subprocess
    import sys

    from pathlib import Path

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "tpgan_tpu_torch", "eval", "--img-list", "x"],
                          env=env, capture_output=True, text=True, timeout=120,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 3, proc.stderr
    assert "tpgan_tpu_torch eval: no CUDA device is available" in proc.stderr


def _world_of_one_step(rank):
    """A rank of the world-of-one case: one f32 SGD step at fm 0.25 from
    seed 0, batch 4, without the NCCL mesh and with it, each on a fresh
    state, after a throwaway step (a process's first f32 step differs in
    the last bits, ROADMAP C2); TF32 off, deterministic cuDNN. Returns the
    worst gradient leaf's gap in ulps of its largest, and the backend."""
    from tpgan_tpu_torch.config import MeshConfig
    from tpgan_tpu_torch.parallel import make_mesh
    from tpgan_tpu_torch.train.gan_trainer import GANTrainState, build_models

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    dev = torch.device("cuda")
    cfg = make_config({"G": {"fm_multiplier": 0.25, "local_feature_layer_dim": 16},
                       "D": {"fm_multiplier": 0.25}, "compute_dtype": "float32"})
    mesh = make_mesh(MeshConfig(data=1))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in synthetic_gan_batch(4, seed=1).items()}

    def grads(m):
        gen, disc = build_models(cfg, dev, seed=0)
        g_opt, d_opt = (torch.optim.SGD(x.parameters(), lr=1e-2) for x in (gen, disc))
        step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt, mesh=m)
        step(GANTrainState(0, gen, disc, g_opt, d_opt), batch,
             torch.Generator(device=dev).manual_seed(0))
        return {n: p.grad for x in (gen, disc) for n, p in x.named_parameters()}

    grads(None)
    plain, meshed = grads(None), grads(mesh)
    worst = 0.0
    for name, a in plain.items():
        ulp = float(torch.finfo(a.dtype).eps) * max(float(a.abs().max()), 1e-30)
        worst = max(worst, float((a - meshed[name]).abs().max()) / ulp)
    return worst, mesh.backend


def test_world_of_one_nccl_step_equals_the_step_without_a_mesh(cuda):
    """A world of one over NCCL (one spawned rank): the step's gradients
    with the mesh (the gradient and metric all-reduces, a mean over one
    rank) against those without, within 4 ulps of each leaf's largest
    (chip_smoke.py's f32 gate)."""
    from tpgan_tpu_torch.parallel.distributed import spawn

    (worst, backend), = spawn(_world_of_one_step, 1, backend="nccl", device="cuda",
                              timeout_s=600)
    assert backend == "nccl"
    assert worst <= 4, worst


def test_two_gloo_ranks_on_the_card_match_one_process(cuda):
    """dryrun_multichip over two gloo ranks on one card (NCCL takes one
    rank per card), JAX's layout for two devices ({data: 1, model: 2}):
    the fm 0.25 f32 step against one process at the global batch (JAX's
    bar), the full-size synthesis under tensor parallelism (5e-4), each
    rank's parameters + Adam below 0.8 of one process's."""
    from tpgan_tpu_torch.entry import dryrun_multichip

    out = dryrun_multichip(2, backend="gloo")
    assert out["backend"] == "gloo" and out["synthesis_max_abs_delta"] <= 5e-4
    assert out["mesh"] == {"data": 1, "model": 2}
    assert max(out["params_opt_mib"]) < 0.8 * out["unsharded_params_opt_mib"]
