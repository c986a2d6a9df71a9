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
from tpgan_tpu_torch.train.gan_trainer import build_generator, make_synthesize_fn

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
    before = kernels.FUSE_LAUNCHES
    got = kernels.fuse_parts(*parts)
    torch.cuda.synchronize()
    assert kernels.FUSE_LAUNCHES == before + 1
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
    before = kernels.FUSE_LAUNCHES
    out = synthesize(batch, np.zeros((2, cfg.G.zdim), np.float32))
    torch.cuda.synchronize()
    assert kernels.FUSE_LAUNCHES == before + 3
    assert out.shape == (2, 128, 128, 3) and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
