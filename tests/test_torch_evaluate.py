"""The port's evaluation (``tpgan_tpu_torch.evaluate``) against the JAX
package on the CPU:

* ``psnr`` and ``ssim``, aggregated and per image, on images that run
  outside [-1, 1] (clipped, and with ``clip=False``): within 1e-5
  relative (PSNR) and 1e-5 absolute (SSIM);
* the adversarial near-constant windows of ``tests/test_evaluate.py``:
  SSIM in [-1, 1] on both sides and within 1e-5 of JAX;
* ``rank1_correct`` / ``rank1_accuracy`` with planted ties (equal gallery
  rows, a zero probe): equal masks, the first index on ties;
* ``evaluate_frontalization`` on a toy synthesis and embedder: within
  1e-5;
* ``evaluate_protocol`` against ``tpgan_tpu.cli.cmd_eval`` on a rendered
  Multi-PIE protocol, the same toy synthesis and embedder on both sides
  and JAX's z injected: every aggregate, the z spread and every
  ``per_camera`` row within 1e-5 relative or absolute, SSIM within 5e-5
  (on the rendered faces' flat regions the two sides' Gaussian filter
  sums, in another order, move a camera's mean SSIM by 1.2e-5), Rank-1
  equal; and the warning when the listed and evaluated counts differ.
"""

import argparse
import json
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpgan_tpu import evaluate as jev
from tpgan_tpu_torch.data.multipie import TrainDataset
from tpgan_tpu_torch.data.pipeline import batch_iterator
from tpgan_tpu_torch.data.synthetic_faces import generate_gan_protocol
from tpgan_tpu_torch.evaluate import (
    evaluate_frontalization,
    evaluate_protocol,
    psnr,
    rank1_accuracy,
    rank1_correct,
    ssim,
)

torch.set_num_threads(1)


def _pair(seed, shape=(3, 24, 20, 3), scale=1.3):
    rng = np.random.RandomState(seed)
    a = (rng.uniform(-1, 1, shape) * scale).astype(np.float32)
    b = (a + rng.standard_normal(shape) * 0.3).astype(np.float32)
    return a, b


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("aggregate", [True, False])
def test_psnr_and_ssim_match_jax(clip, aggregate):
    a, b = _pair(0)
    kw = dict(aggregate=aggregate, clip=clip)
    np.testing.assert_allclose(psnr(torch.from_numpy(a), torch.from_numpy(b), **kw).numpy(),
                               np.asarray(jev.psnr(a, b, **kw)), rtol=1e-5)
    np.testing.assert_allclose(ssim(torch.from_numpy(a), torch.from_numpy(b), **kw).numpy(),
                               np.asarray(jev.ssim(a, b, **kw)), rtol=1e-5, atol=1e-5)


def test_metrics_clip_out_of_range_inputs():
    gt = torch.ones((1, 16, 16, 3))
    pred = torch.full((1, 16, 16, 3), 7.0)
    assert float(psnr(pred, gt)) > 100.0 and float(ssim(pred, gt)) > 0.999
    assert float(psnr(pred, gt, clip=False)) < 10.0


def _adversarial_cases():
    """tests/test_evaluate.py's near-constant, flat-plus-noise, step-edge
    and out-of-range images."""
    rng = np.random.RandomState(1)
    return [
        np.full((1, 48, 48, 3), 0.937, np.float32),
        (0.81 + rng.randn(1, 48, 48, 3) * 1e-4).astype(np.float32),
        np.kron(rng.rand(1, 6, 6, 3) > 0.5, np.ones((1, 8, 8, 1))).astype(np.float32) * 2 - 1,
        (rng.randn(1, 48, 48, 3) * 3).astype(np.float32),
    ]


def test_ssim_bounded_and_equal_on_adversarial_windows():
    cases = _adversarial_cases()
    for a in cases:
        for b in cases:
            got = float(ssim(torch.from_numpy(a), torch.from_numpy(b)))
            want = float(jev.ssim(jnp.asarray(a), jnp.asarray(b)))
            assert -1.0 <= got <= 1.0 and -1.0 <= want <= 1.0, (got, want)
            assert abs(got - want) <= 1e-5, (got, want, a.mean(), b.mean())
        assert float(ssim(torch.from_numpy(a), torch.from_numpy(a))) > 0.999


def test_rank1_with_planted_ties_matches_jax():
    rng = np.random.RandomState(2)
    gallery = rng.standard_normal((5, 6)).astype(np.float32)
    gallery[3] = gallery[1] * 2.0  # the same direction under two labels
    g_lbl = np.asarray([10, 20, 30, 40, 50])
    probes = np.concatenate([gallery[[1, 3, 0]] + 0.0, np.zeros((1, 6), np.float32),
                             rng.standard_normal((4, 6)).astype(np.float32)])
    p_lbl = np.asarray([20, 40, 10, 10, 20, 30, 40, 50])
    want = np.asarray(jev.rank1_correct(probes, p_lbl, gallery, g_lbl))
    got = rank1_correct(probes, p_lbl, gallery, g_lbl).numpy()
    np.testing.assert_array_equal(got, want)
    # ties go to the first gallery row: the label-40 probe takes row 1's
    # label 20, a miss; the zero probe (every similarity 0) takes row 0's
    # label 10, a hit
    assert got[:4].tolist() == [True, False, True, True]
    assert float(rank1_accuracy(probes, p_lbl, gallery, g_lbl)) == pytest.approx(
        float(jev.rank1_accuracy(probes, p_lbl, gallery, g_lbl)))


_PROJ = np.random.RandomState(3).standard_normal((128 * 128 * 3, 8)).astype(np.float32) / 128


def _jax_synth(g_params, batch, z):
    return 0.6 * batch["img"] + 0.2 * jnp.tanh(z[:, :3])[:, None, None, :]


def _port_synth(batch, z):
    img = torch.as_tensor(batch["img"])
    return 0.6 * img + 0.2 * torch.tanh(torch.as_tensor(z)[:, :3])[:, None, None, :]


def _jax_embed(x):  # NHWC
    return jnp.tanh(x.reshape(x.shape[0], -1) @ _PROJ)


def _port_embed(x):  # NCHW, as the step's identity term calls it
    return torch.tanh(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1) @ torch.from_numpy(_PROJ))


def test_evaluate_frontalization_matches_jax():
    rng = np.random.RandomState(4)
    batch = {"img": rng.uniform(-1, 1, (3, 128, 128, 3)).astype(np.float32)}
    z = rng.standard_normal((3, 64)).astype(np.float32)
    gt = rng.uniform(-1, 1, (3, 128, 128, 3)).astype(np.float32)
    gallery = np.concatenate([gt[:2], rng.uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)])
    labels, g_lbl = np.asarray([1, 2, 3]), np.asarray([1, 2, 3])
    want = jev.evaluate_frontalization(_jax_synth, _jax_embed, batch, labels, gallery, g_lbl,
                                       gt, z, None)
    got = evaluate_frontalization(_port_synth, _port_embed, batch, labels, gallery, g_lbl,
                                  gt, z)
    for k in ("psnr", "ssim", "rank1"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5, abs=1e-5), k


class _FakeFX:
    """Stands in for JAX's FeatureExtractModel: cmd_eval inits it, and the
    mocked ``make_identity_embed_fn`` ignores what it made."""

    def __init__(self, **kwargs):
        pass

    def init(self, rng, x):
        return {}


@pytest.fixture(scope="module")
def protocol(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mp"))
    return generate_gan_protocol(root, 3, cameras=("051", "140", "080", "200"))


def _jax_cmd_eval(img_list_file, z_samples, capsys):
    from tpgan_tpu import cli as jcli

    args = argparse.Namespace(set=[], checkpoint=None, img_list=img_list_file,
                              identity_checkpoint="embedder", batch_size=4, seed=0,
                              z_samples=z_samples, detector_checkpoint=None, g_weights="auto")
    with mock.patch("tpgan_tpu.train.gan_trainer.create_gan_state", lambda *a: (None, None)), \
            mock.patch("tpgan_tpu.train.gan_trainer.eval_g_params", lambda *a: None), \
            mock.patch("tpgan_tpu.train.gan_trainer.make_synthesize_fn", lambda *a: _jax_synth), \
            mock.patch("tpgan_tpu.models.feature_extract.FeatureExtractModel", _FakeFX), \
            mock.patch("tpgan_tpu.models.feature_extract.make_identity_embed_fn",
                       lambda *a: _jax_embed), \
            mock.patch("tpgan_tpu.train.checkpoint.restore_checkpoint", lambda d, t: t):
        capsys.readouterr()
        assert jcli.cmd_eval(args) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _jax_z(zdim, z_samples, n_batches, seed=0):
    """cmd_eval's z: per batch a split of the running key, folded with the
    draw's index."""
    rng, keys = jax.random.PRNGKey(seed), []
    for _ in range(n_batches):
        rng, zr = jax.random.split(rng)
        keys.append(zr)
    return lambda bi, zi, b: np.array(jax.random.normal(jax.random.fold_in(keys[bi], zi),
                                                        (b, zdim)))


@pytest.mark.parametrize("z_samples", [1, 2])
def test_evaluate_protocol_matches_cmd_eval(protocol, tmp_path, capsys, z_samples):
    list_file = tmp_path / "img.list"
    list_file.write_text("\n".join(protocol) + "\n")
    want = _jax_cmd_eval(str(list_file), z_samples, capsys)
    batches = batch_iterator(TrainDataset(protocol), 4, shuffle=False, epochs=1,
                             drop_last=False, num_workers=0)
    got = evaluate_protocol(_port_synth, batches, protocol, 64, embed=_port_embed,
                            z_samples=z_samples, draw_z=_jax_z(64, z_samples, 3))
    assert got.keys() == want.keys()
    assert got["num_images"] == want["num_images"] == 9
    assert got["landmarks"] == want["landmarks"] == "ground_truth"
    assert got["rank1"] == want["rank1"]
    tol = {"ssim": 5e-5, "ssim_z_std": 5e-5}
    for k in ("psnr", "ssim", "identity_sim", "psnr_z_std", "ssim_z_std"):
        if k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=tol.get(k, 1e-5)), k
    assert got["per_camera"].keys() == want["per_camera"].keys() == {"140", "080", "200"}
    for cam, row in want["per_camera"].items():
        assert got["per_camera"][cam].keys() == row.keys()
        for k, v in row.items():
            assert got["per_camera"][cam][k] == pytest.approx(
                v, rel=1e-5, abs=tol.get(k, 1e-5)), (cam, k)
    if z_samples > 1:
        assert got["psnr_z_std"] > 0


def test_evaluate_protocol_warns_when_counts_differ(protocol, capsys):
    batches = batch_iterator(TrainDataset(protocol), 4, shuffle=False, epochs=1,
                             drop_last=False, num_workers=0)
    out = evaluate_protocol(_port_synth, batches, protocol + protocol[:1], 64,
                            generator=torch.Generator().manual_seed(0))
    assert "per_camera" not in out and "identity_sim" not in out and "rank1" not in out
    assert "per-camera breakdown skipped — 10 listed items but 9 evaluated" in \
        capsys.readouterr().err
    with pytest.raises(ValueError, match="Generator or draw_z"):
        evaluate_protocol(_port_synth, [], protocol, 64)
