"""Cases of the PyTorch port that need an NVIDIA GPU: the hand-written
CUDA kernels against their plain versions on the card. They skip on a
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
from tpgan_tpu_torch.train.gan_trainer import (
    build_generator,
    create_gan_state,
    make_gan_train_step,
    make_synthesize_fn,
)

torch.set_num_threads(1)


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


def test_fuse_kernel_rejects_instead_of_falling_back(cuda):
    parts = _parts(2, 3, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.fuse_parts(*parts[:3], parts[3].transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernels.fuse_parts(*(p.half() for p in parts))


def test_fuse_gradient_on_cuda_equals_cpu(cuda):
    parts = [p.nan_to_num(0.0) for p in _parts(2, 16, torch.float32, cuda, seed=3)]
    g = torch.randn(2, 16, 128, 128, generator=torch.Generator().manual_seed(0))
    grads = []
    for device in (cuda, torch.device("cpu")):
        ps = [p.detach().to(device).requires_grad_() for p in parts]
        (kernels.fuse_parts(*ps) * g.to(device)).sum().backward()
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


@pytest.mark.parametrize("c,dtype", [(64, torch.bfloat16), (3, torch.bfloat16), (3, torch.float32)])
def test_fuse_backward_kernel_equals_plain_version(cuda, c, dtype):
    parts = _parts(4, c, dtype, cuda, seed=c + 1)
    out = kernels.fuse_parts_plain(*parts)
    g = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda).to(dtype)
    g = g.transpose(2, 3).contiguous().transpose(2, 3)  # non-contiguous, as autograd may hand it
    before = kernels.launch_counts()["fuse_parts_bwd"]
    got = kernels._launch_fuse_bwd(parts, out, g)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fuse_parts_bwd"] == before + 1
    for a, b in zip(got, kernels.fuse_parts_bwd_plain(parts, out, g)):
        assert a.dtype == dtype and torch.equal(a, b)


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
    torch.testing.assert_close(dx, kernels.sym_tv_bwd_plain(x, g_sym, g_tv), rtol=1e-6, atol=0)
    after = kernels.launch_counts()
    assert after["sym_tv"] == before["sym_tv"] + 2
    assert after["sym_tv_bwd"] == before["sym_tv_bwd"] + 1
    # NaN: the sums turn NaN; the backward follows JAX's select (NaN -> -1)
    x[1, 2, 5, 5] = float("nan")
    _, sym_nan, _ = kernels._launch_sym_tv(x)
    assert torch.isnan(sym_nan)
    torch.testing.assert_close(kernels._launch_sym_tv_bwd(x, g_sym, g_tv),
                               kernels.sym_tv_bwd_plain(x, g_sym, g_tv), rtol=1e-6, atol=0)


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
                                       "sym_tv": 1, "sym_tv_bwd": 1}
    assert all(torch.isfinite(v.float()) for v in metrics.values())
    assert state.step == 1
