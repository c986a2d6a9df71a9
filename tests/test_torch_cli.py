"""The port's command line (``tpgan_tpu_torch/cli.py``) against
``tpgan_tpu.cli`` on the CPU, at fm 0.25, ``G.local_feature_layer_dim=16``,
``compute_dtype=float32``:

* the parser: every JAX subcommand and option, with its default, choices,
  type and flags, in ``build_parser()``; ``--device`` the one addition (on
  every subcommand that runs a model); help texts equal but for the few
  that named JAX or the TPU;
* ``synthesize``: both CLIs from the same seeded weights (JAX's state saved
  by JAX's ``save_checkpoint``; the port's carried across by
  ``convert.load_jax_gan_state`` and saved by the port), JAX's z injected:
  the two PNGs differ by at most 1 level on at most 1% of values;
* ``eval``: the same two checkpoints, JAX's z draws injected: the same
  JSON keys, ``psnr`` / ``ssim`` and every ``per_camera`` row within 1e-4,
  each row's ``n`` equal;
* ``synth-data --protocol gan --pack`` and ``prepare-data``: the same JSON
  or line with paths taken relative to ``--out``, the same ``img.list``
  entries and the same pixels in every written PNG;
* the port's own runs: ``pretrain`` (with and without ``--device-data``,
  then ``--resume``; the nose prior equal to JAX's ``fit_nose_prior`` on
  the same training labels), ``train`` (a list, ``--packed --device-data``
  with the yaw-weighted sampler held to JAX's formula, ``--sample-dir``,
  the identity embedder in bf16 with ``--steps-per-dispatch 2``; a
  multi-device mesh refused), ``train-embedder``, ``frontalize`` (PNG and
  JPEG frames, equal to ``make_frontalize_fn`` on the same frame) and
  ``export`` (the wiring of the ``serving`` calls; one f32 ``.pt2`` that
  loads back equal to the live program; ``--platforms cpu,tpu`` exit 2);
* with no CUDA device: every subcommand that runs a model returns 3 unless
  ``--device cpu`` is given, and ``prepare-data`` still runs.

Everything runs in-process; metrics writers skip TensorBoard (its import
pulls TensorFlow where that is installed: ~20 s on one CPU core) and the
data loaders decode in the main process.
JAX compiles two programs: its synthesis at batch 1 and at the eval batch.
"""

import argparse
import functools
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import optax

from tpgan_tpu import cli as jcli
from tpgan_tpu.config import make_config as jax_make_config
from tpgan_tpu.train.gan_trainer import GANTrainState as JGANTrainState
from tpgan_tpu.train.gan_trainer import build_models as jax_build_models
from tpgan_tpu.train.optim import adam_wgan as jax_adam_wgan
from tpgan_tpu_torch import cli
from tpgan_tpu_torch.config import make_config
from tpgan_tpu_torch.convert import load_jax_gan_state
from tpgan_tpu_torch.data import pipeline
from tpgan_tpu_torch.data.imageio import read_png, write_jpeg, write_png
from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
from tpgan_tpu_torch.data.synthetic_faces import (
    ALL_CAMERA_YAWS,
    generate_gan_protocol,
    generate_pretrain_protocol,
    landmarks68_string,
    render_face,
)
from tpgan_tpu_torch.train import metrics
from tpgan_tpu_torch.train.checkpoint import latest_step, save_checkpoint
from tpgan_tpu_torch.train.gan_trainer import create_gan_state

from _torch_port import init_numpy
from test_torch_hygiene import no_cuda  # noqa: F401  (a fixture)

torch.set_num_threads(1)

OVERRIDES = {"G": {"fm_multiplier": 0.25, "local_feature_layer_dim": 16},
             "D": {"fm_multiplier": 0.25}, "compute_dtype": "float32"}
SMALL = ["--set", "G.fm_multiplier=0.25", "--set", "G.local_feature_layer_dim=16",
         "--set", "D.fm_multiplier=0.25", "--set", "compute_dtype=float32"]
CPU = ["--device", "cpu"]
CHIP_BOUND = ("pretrain", "train", "train-embedder", "eval", "frontalize", "synthesize",
              "export")
# help texts of the JAX CLI that name JAX or the TPU: the port says what it does
ADAPTED_HELP = {("train", "--identity-embed-dtype"), ("train", "--debug-nans"),
                ("export", "--int8"), ("export", "--int8-rescale-dtype"),
                ("export", "--int8-min-channels"), ("export", "--platforms")}
PNG_LEVELS = 1  # synthesize: at most this many levels apart ...
PNG_SHARE = 0.01  # ... on at most this share of the values
EVAL_TOL = 1e-4
EVAL_BATCH = 4


@pytest.fixture(autouse=True)
def _fast_host_paths(monkeypatch):
    monkeypatch.setattr(metrics, "MetricWriter",
                        functools.partial(metrics.MetricWriter, use_tensorboard=False))
    monkeypatch.setattr(pipeline, "batch_iterator",
                        functools.partial(pipeline.batch_iterator, num_workers=0))


# --------------------------------------------------------------------------
# the parser
# --------------------------------------------------------------------------

class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _jax_parser() -> argparse.ArgumentParser:
    """JAX's parser as its ``main`` builds it, caught at ``parse_args``."""
    def grab(self, *args, **kwargs):
        raise _Parsed(self)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab), \
            mock.patch.object(jcli, "_enable_compile_cache", lambda: None):
        with pytest.raises(_Parsed) as caught:
            jcli.main([])
    return caught.value.parser


def _subparsers(parser):
    action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    helps = {a.dest: a.help for a in action._choices_actions}
    return action.choices, helps


def _options(parser):
    return {a.option_strings[-1]: a for a in parser._actions if a.option_strings
            and not isinstance(a, argparse._HelpAction)}


def _norm(v):
    return tuple(v) if isinstance(v, list) else v


@pytest.fixture(scope="module")
def parsers():
    return _subparsers(_jax_parser()), _subparsers(cli.build_parser())


@pytest.mark.parametrize("command", sorted(cli.COMMANDS))
def test_parser_matches_jax(parsers, command):
    (jax_subs, jax_helps), (subs, helps) = parsers
    assert set(subs) == set(jax_subs) == set(cli.COMMANDS)
    if command != "export":  # "StableHLO" -> ".pt2"
        assert helps[command] == jax_helps[command]
    want, got = _options(jax_subs[command]), _options(subs[command])
    added = {"--device"} if command in CHIP_BOUND else set()
    assert set(got) == set(want) | added, command
    for name, a in want.items():
        b = got[name]
        for field in ("option_strings", "dest", "default", "choices", "type", "required",
                      "nargs", "const"):
            assert _norm(getattr(b, field)) == _norm(getattr(a, field)), (command, name, field)
        assert type(b) is type(a), (command, name)
        if (command, name) not in ADAPTED_HELP:
            assert b.help == a.help, (command, name)
    if added:
        assert got["--device"].default is None


@pytest.mark.parametrize("command", sorted(cli.COMMANDS))
def test_every_subcommand_has_help(command, capsys):
    with pytest.raises(SystemExit) as done:
        cli.main([command, "--help"])
    assert done.value.code == 0
    assert f"usage: tpgan_tpu_torch {command}" in capsys.readouterr().out


# --------------------------------------------------------------------------
# synthesize and eval against the JAX CLI, from the same weights
# --------------------------------------------------------------------------

def _flat_jax_state(state) -> dict:
    """A JAX GANTrainState as ``load_jax_gan_state`` reads it."""
    tree = jax.tree.map(np.asarray, {
        "step": state.step, "g_params": state.g_params, "d_params": state.d_params,
        "g_ema_params": state.g_ema_params,
        "g_opt_state": {"mu": state.g_opt_state[0].mu, "nu": state.g_opt_state[0].nu,
                        "count": state.g_opt_state[0].count},
        "d_opt_state": {"mu": state.d_opt_state[0].mu, "nu": state.d_opt_state[0].nu,
                        "count": state.d_opt_state[0].count},
    })
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            flat["/".join(path)] = node

    walk(tree, ())
    return flat


@pytest.fixture(scope="module")
def gan(tmp_path_factory):
    """One seeded GAN state in both formats: numpy weights over the JAX
    trees (the EMA weights drawn apart from the live ones, so that ``auto``
    picking EMA shows), saved by JAX's ``save_checkpoint``; and the port's
    state carried across from it and saved by the port."""
    from tpgan_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint

    root = tmp_path_factory.mktemp("gan")
    jcfg = jax_make_config(OVERRIDES)
    jgen, jdisc = jax_build_models(jcfg)
    b = synthetic_gan_batch(1)
    imgs = [b[k] for k in ("img", "left_eye", "right_eye", "nose", "mouth")]
    gp, _ = init_numpy(jgen, *imgs, np.zeros((1, jcfg.G.zdim), np.float32), seed=1)
    dp, _ = init_numpy(jdisc, imgs[0], seed=3)
    rng = np.random.RandomState(2)
    ema = jax.tree.map(lambda w: (w + 0.5 * w.std() * rng.standard_normal(w.shape)
                                  ).astype(np.float32), gp)
    t = jcfg.train
    tx = jax_adam_wgan(t.learning_rate, t.beta1, t.beta2)

    def adam_state(params, count):  # tx.init's tree, in numpy
        return (optax.ScaleByAdamState(count=np.asarray(count, np.int32),
                                       mu=jax.tree.map(np.zeros_like, params),
                                       nu=jax.tree.map(np.zeros_like, params)),
                optax.EmptyState())

    jstate = JGANTrainState(step=np.asarray(3, np.int32), g_params=gp, d_params=dp,
                            g_opt_state=adam_state(gp, 3), d_opt_state=adam_state(dp, 3),
                            g_batch_stats={}, d_batch_stats={}, g_ema_params=ema)
    assert jax.tree.structure(adam_state(dp, 0)) == jax.tree.structure(tx.init(dp))
    jax_dir = str(root / "jax_ck")
    jax_save_checkpoint(jax_dir, 3, jstate)

    state = create_gan_state(make_config(OVERRIDES), 0, "cpu")[0]
    load_jax_gan_state(_flat_jax_state(jstate), state)
    port_dir = str(root / "port_ck")
    save_checkpoint(port_dir, state.step, state)
    # JAX's CLI builds its template with a jitted init; a zeroed copy of the
    # state's tree is the same template without the compile
    template = jax.tree.map(np.zeros_like, jstate)
    return {"jax_dir": jax_dir, "port_dir": port_dir, "template": template,
            "models": (jgen, jdisc, tx), "zdim": jcfg.G.zdim}


def _jax_templates(gan):
    jgen, jdisc, tx = gan["models"]
    return mock.patch("tpgan_tpu.train.gan_trainer.create_gan_state",
                      lambda *a, **k: (gan["template"], jgen, jdisc, tx, tx))


def _jax_normal(seed, batch, zdim, device):
    return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(seed), (batch, zdim))))


def test_synthesize_matches_the_jax_cli(gan, tmp_path, monkeypatch, capsys):
    img, lm5 = render_face(7, ALL_CAMERA_YAWS["080"], 180)
    write_png(str(tmp_path / "probe.png"), img)
    (tmp_path / "lm.txt").write_text(landmarks68_string(lm5))
    common = ["--image", str(tmp_path / "probe.png"), "--landmarks", str(tmp_path / "lm.txt"),
              "--seed", "5", *SMALL]
    jargs = _jax_parser().parse_args(["synthesize", *common, "--output", str(tmp_path / "j.png"),
                                      "--checkpoint", gan["jax_dir"]])
    with _jax_templates(gan):
        assert jcli.cmd_synthesize(jargs) == 0
    monkeypatch.setattr(cli, "draw_z", _jax_normal)
    out = str(tmp_path / "p.png")
    assert cli.main(["synthesize", *common, "--output", out, "--checkpoint", gan["port_dir"],
                     *CPU]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == f"wrote {out}"
    want, got = read_png(str(tmp_path / "j.png")), read_png(out)
    assert got.shape == want.shape == (128, 128, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= PNG_LEVELS and (diff > 0).mean() <= PNG_SHARE, \
        (diff.max(), (diff > 0).mean())
    # the EMA weights: the live ones give another face
    assert cli.main(["synthesize", *common, "--output", str(tmp_path / "live.png"),
                     "--checkpoint", gan["port_dir"], "--g-weights", "live", *CPU]) == 0
    assert np.abs(read_png(str(tmp_path / "live.png")).astype(int) - got).max() > 8


def _jax_eval_z(zdim, n_batches, seed):
    """JAX's eval draws: per batch a split of the running key, folded with
    the draw's index (``tpgan_tpu/cli.py:517-527``)."""
    rng, keys = jax.random.PRNGKey(seed), []
    for _ in range(n_batches):
        rng, zr = jax.random.split(rng)
        keys.append(zr)
    return lambda bi, zi, b: np.array(jax.random.normal(jax.random.fold_in(keys[bi], zi),
                                                        (b, zdim)))


@pytest.fixture(scope="module")
def protocol(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp")
    items = generate_gan_protocol(str(root), 2, cameras=("051", "140", "080"))
    lst = root / "img.list"
    assert lst.read_text().split() == items
    return str(lst), items


def test_eval_matches_the_jax_cli(gan, protocol, monkeypatch, capsys):
    lst, items = protocol
    common = ["--img-list", lst, "--batch-size", str(EVAL_BATCH), "--z-samples", "2",
              "--seed", "3", *SMALL]
    jargs = _jax_parser().parse_args(["eval", *common, "--checkpoint", gan["jax_dir"]])
    capsys.readouterr()
    with _jax_templates(gan):
        assert jcli.cmd_eval(jargs) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    n_batches = -(-len(items) // EVAL_BATCH)
    monkeypatch.setattr(cli, "eval_z_draws",
                        lambda seed, zdim, device: _jax_eval_z(zdim, n_batches, seed))
    assert cli.main(["eval", *common, "--checkpoint", gan["port_dir"], *CPU]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == list(want)
    assert got["num_images"] == want["num_images"] == len(items) == 4
    assert got["landmarks"] == want["landmarks"] == "ground_truth"
    assert got["z_samples"] == want["z_samples"] == 2
    for k in ("psnr", "ssim", "psnr_z_std", "ssim_z_std"):
        assert got[k] == pytest.approx(want[k], abs=EVAL_TOL), k
    assert list(got["per_camera"]) == list(want["per_camera"]) == ["080", "140"]
    for cam, row in want["per_camera"].items():
        assert list(got["per_camera"][cam]) == list(row)
        assert got["per_camera"][cam]["n"] == row["n"] == 2
        for k in ("psnr", "ssim"):
            assert got["per_camera"][cam][k] == pytest.approx(row[k], abs=EVAL_TOL), (cam, k)


# --------------------------------------------------------------------------
# the host-only subcommands against the JAX CLI
# --------------------------------------------------------------------------

def _relative(value, root):
    return value.replace(str(root), "<out>") if isinstance(value, str) else value


def _png_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs if f.endswith(".png"))


def _same_tree(jax_root, port_root):
    files = _png_files(port_root)
    assert files == _png_files(jax_root) and files
    for f in files:
        np.testing.assert_array_equal(read_png(os.path.join(port_root, f)),
                                      read_png(os.path.join(jax_root, f)), err_msg=f)


def _list_entries(path, root):
    with open(path) as f:
        return [os.path.relpath(line.strip(), root) for line in f if line.strip()]


def test_synth_data_matches_the_jax_cli(tmp_path, capsys):
    args = ["synth-data", "--protocol", "gan", "--subjects", "1", "--render-size", "144",
            "--pack"]
    outs = {}
    for side, run in (("jax", jcli.main), ("port", cli.main)):
        root = tmp_path / side
        with mock.patch.object(jcli, "_enable_compile_cache", lambda: None):
            assert run([*args, "--out", str(root)]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        outs[side] = (root, line)
    (jroot, jline), (proot, pline) = outs["jax"], outs["port"]
    assert {k: _relative(v, proot) for k, v in pline.items()} == \
        {k: _relative(v, jroot) for k, v in jline.items()}
    assert pline["gan_train_items"] == 8
    assert _list_entries(pline["gan_img_list"], proot) == \
        _list_entries(jline["gan_img_list"], jroot)
    _same_tree(jroot, proot)
    with open(os.path.join(pline["gan_packed"], "index.json")) as f:
        pmeta = json.load(f)
    with open(os.path.join(jline["gan_packed"], "index.json")) as f:
        assert pmeta["num_items"] == json.load(f)["num_items"] == 8


def test_prepare_data_matches_the_jax_cli(tmp_path, capsys):
    paths, lms = [], []
    for cam in ("051", "110", "200"):
        img, lm5 = render_face(3, ALL_CAMERA_YAWS[cam], 150)
        path = str(tmp_path / f"003_01_{cam}_00.png")
        write_png(path, img)
        paths.append(path)
        lms.append(landmarks68_string(lm5))
    (tmp_path / "images.txt").write_text("\n".join(paths) + "\n")
    (tmp_path / "lm.txt").write_text("\n".join(lms) + "\n")
    lines = {}
    for side, run in (("jax", jcli.main), ("port", cli.main)):
        out = tmp_path / side
        with mock.patch.object(jcli, "_enable_compile_cache", lambda: None):
            assert run(["prepare-data", "--images", str(tmp_path / "images.txt"),
                        "--landmarks", str(tmp_path / "lm.txt"), "--out", str(out)]) == 0
        lines[side] = _relative(capsys.readouterr().out.strip().splitlines()[-1], out)
    assert lines["port"] == lines["jax"] == \
        "prepared 3 images; 2 training (non-frontal) entries -> <out>/img.list"
    assert _list_entries(tmp_path / "port" / "img.list", tmp_path / "port") == \
        _list_entries(tmp_path / "jax" / "img.list", tmp_path / "jax")
    _same_tree(tmp_path / "jax", tmp_path / "port")


# --------------------------------------------------------------------------
# pretrain, train, train-embedder, frontalize, export: the port's own runs
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def celeba(tmp_path_factory):
    root = tmp_path_factory.mktemp("celeba")
    txt = generate_pretrain_protocol(str(root), 24, sizes=(48, 80), num_subjects=8)
    return str(root), txt


def _pretrain_args(root, txt, ck, logs, *extra):
    return ["pretrain", "--checkpoint", ck, "--set", f"pretrain.data_root_dir={root}",
            "--set", f"pretrain.txt_name={txt}", "--set", f"pretrain.log_root_dir={logs}",
            "--set", "pretrain.batch_size=4", "--set", "pretrain.train_data_ratio=0.7",
            "--set", "pretrain.validation_data_ratio=0.2", "--set", "pretrain.log_step_of_batchs=2",
            *extra, *CPU]


@pytest.fixture(scope="module")
def detector_ck(celeba, tmp_path_factory):
    """A pretrain checkpoint at 64², one epoch, from the CLI."""
    root, txt = celeba
    out = tmp_path_factory.mktemp("det")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(metrics, "MetricWriter",
                   functools.partial(metrics.MetricWriter, use_tensorboard=False))
        mp.setattr(pipeline, "batch_iterator",
                   functools.partial(pipeline.batch_iterator, num_workers=0))
        assert cli.main(_pretrain_args(root, txt, str(out / "ck"), str(out / "logs"),
                                       "--set", "pretrain.image_size=64",
                                       "--set", "pretrain.num_epochs=1")) == 0
    return str(out / "ck")


def test_pretrain_checkpoint_and_nose_prior(celeba, detector_ck):
    from tpgan_tpu.data.celeba import CelebALandmarkDataset as JaxCelebA
    from tpgan_tpu.train.pretrain import fit_nose_prior as jax_fit_nose_prior
    from tpgan_tpu_torch.train.pretrain import load_nose_prior

    root, txt = celeba
    ds = JaxCelebA(txt, root, 64)
    train_idx, _, _ = ds.split(0.7, 0.2)
    want = jax_fit_nose_prior(np.stack([ds.labels[os.path.basename(ds.image_paths[i])]
                                        for i in train_idx]))
    np.testing.assert_allclose(load_nose_prior(detector_ck), want, rtol=1e-6, atol=1e-4)
    assert latest_step(detector_ck) == len(train_idx) // 4
    with open(os.path.join(detector_ck, "detector_meta.json")) as f:
        assert json.load(f)["head_mode"] == make_config().pretrain.head_mode


def test_pretrain_device_data_and_resume(celeba, tmp_path):
    root, txt = celeba
    ck, logs = str(tmp_path / "ck"), str(tmp_path / "logs")
    buckets = ["--set", "pretrain.image_buckets=(64,80)"]
    assert cli.main(_pretrain_args(root, txt, ck, logs, "--device-data", *buckets,
                                   "--set", "pretrain.num_epochs=1")) == 0
    first = latest_step(ck)
    assert first and os.path.exists(os.path.join(ck, "detector_meta.json"))
    assert cli.main(_pretrain_args(root, txt, ck, logs, "--device-data", "--resume", *buckets,
                                   "--set", "pretrain.num_epochs=2")) == 0
    assert latest_step(ck) == 2 * first
    with open(os.path.join(logs, "mobilenet_v2", "metrics.jsonl")) as f:
        assert any("val_accuracy" in json.loads(line) for line in f)


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """The GAN protocol rendered and packed by ``synth-data``."""
    root = tmp_path_factory.mktemp("synth")
    assert cli.main(["synth-data", "--out", str(root), "--protocol", "gan", "--subjects", "2",
                     "--pack"]) == 0
    return str(root / "gan")


def _train(tmp_path, *extra):
    return cli.main(["train", "--steps", "2", "--checkpoint", str(tmp_path / "ck"),
                     "--log-dir", str(tmp_path / "logs"), "--set", "train.batch_size=2",
                     *SMALL, *extra, *CPU])


def test_train_from_a_list_with_samples(packed, tmp_path):
    assert _train(tmp_path, "--set", f"train.img_list={packed}/img.list",
                  "--sample-dir", str(tmp_path / "samples"), "--sample-every", "2") == 0
    assert latest_step(str(tmp_path / "ck")) == 2
    sample = read_png(str(tmp_path / "samples" / "samples_000002.png"))
    assert sample.shape[0] == 3 * 128 + 2 * 3  # profile, fake, frontal rows


def test_train_device_data_yaw_weighted_sampler_is_jax_formula(packed, tmp_path, monkeypatch):
    from tpgan_tpu.data.multipie import camera_token as jax_camera_token
    from tpgan_tpu.data.synthetic_faces import ALL_CAMERA_YAWS as JAX_YAWS
    from tpgan_tpu_torch.data import packing

    seen = {}
    real = packing.device_batch_iterator

    def spy(data, batch_size, seed=0, weights=None):
        seen["weights"], seen["n"] = weights, int(next(iter(data.values())).shape[0])
        return real(data, batch_size, seed=seed, weights=weights)

    monkeypatch.setattr(packing, "device_batch_iterator", spy)
    gamma = 2.5
    assert _train(tmp_path, "--packed", f"{packed}/packed", "--device-data",
                  "--set", f"train.yaw_weight_gamma={gamma}") == 0
    assert latest_step(str(tmp_path / "ck")) == 2
    names = packing.PackedDataset(f"{packed}/packed").names
    yaws = np.asarray([abs(JAX_YAWS.get(jax_camera_token(n), 0.0)) for n in names])
    want = 1.0 + gamma * (yaws / 90.0) ** 2  # tpgan_tpu/cli.py:279-283
    assert seen["n"] == len(names) == 16
    np.testing.assert_array_equal(seen["weights"], want)
    assert want.max() > want.min()


def test_train_refusals(tmp_path, capsys):
    with pytest.raises(SystemExit, match="requires --packed"):
        _train(tmp_path, "--device-data")
    with pytest.raises(SystemExit, match="mesh.data=8.*more than one device.*A12"):
        _train(tmp_path, "--set", "mesh.data=8")
    with pytest.raises(SystemExit, match="mesh.model=2"):
        _train(tmp_path, "--set", "mesh.model=2")
    assert not os.path.exists(tmp_path / "ck")


@pytest.fixture(scope="module")
def embedder_ck(packed, tmp_path_factory):
    """``train-embedder`` for 2 steps on four cameras of each rendered
    subject (the frontal one too: the held-out subject's gallery), one
    subject held out."""
    out = tmp_path_factory.mktemp("emb")
    train_dir = os.path.join(packed, "train")
    (out / "all.list").write_text("\n".join(
        os.path.join(train_dir, f) for f in sorted(os.listdir(train_dir))
        if f.split("_")[2] in ("051", "110", "140", "200")) + "\n")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(metrics, "MetricWriter",
                   functools.partial(metrics.MetricWriter, use_tensorboard=False))
        mp.setattr(pipeline, "batch_iterator",
                   functools.partial(pipeline.batch_iterator, num_workers=0))
        assert cli.main(["train-embedder", "--img-list", str(out / "all.list"), "--steps", "2",
                         "--batch-size", "2", "--val-subjects", "1", "--val-every", "1",
                         "--checkpoint", str(out / "ck"), "--log-dir", str(out / "logs"),
                         "--set", "feature_extract_model.base_model_name=resnet", *CPU]) == 0
    return str(out / "ck"), str(out / "logs")


def test_train_embedder_holds_out_a_subject(embedder_ck, capsys):
    ck, logs = embedder_ck
    assert latest_step(ck) == 2
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    vals = [r for r in rows if "val_rank1" in r]
    assert [r["step"] for r in vals] == [1, 2, 2] and all(r["val_probes"] == 3 for r in vals)


def test_train_with_the_identity_embedder_in_bf16_and_two_steps_per_dispatch(
        packed, embedder_ck, tmp_path):
    assert _train(tmp_path, "--packed", f"{packed}/packed",
                  "--identity-checkpoint", embedder_ck[0], "--identity-embed-dtype", "bfloat16",
                  "--set", "feature_extract_model.base_model_name=resnet",
                  "--steps-per-dispatch", "2", "--debug-nans") == 0
    assert latest_step(str(tmp_path / "ck")) == 2
    assert not torch.is_anomaly_enabled()  # --debug-nans holds for the run only
    with open(tmp_path / "logs" / "metrics.jsonl") as f:
        assert all(np.isfinite(v) for line in f for v in json.loads(line).values())


def test_frontalize_equals_make_frontalize_fn(gan, detector_ck, tmp_path, capsys):
    from tpgan_tpu_torch.data.imageio import read_rgb
    from tpgan_tpu_torch.frontalize import make_frontalize_fn
    from tpgan_tpu_torch.train.checkpoint import restore_checkpoint, restore_gan_checkpoint
    from tpgan_tpu_torch.train.gan_trainer import eval_g_params
    from tpgan_tpu_torch.train.pretrain import create_pretrain_state, load_nose_prior

    frames = []
    for i, (cam, ext) in enumerate((("140", "png"), ("010", "jpg"))):
        img, _ = render_face(4 + i, ALL_CAMERA_YAWS[cam], 96 + 32 * i)
        path = str(tmp_path / f"frame{i}.{ext}")
        (write_png if ext == "png" else write_jpeg)(path, img)
        frames.append(path)
    out_dir = tmp_path / "out"
    capsys.readouterr()
    assert cli.main(["frontalize", "--image", frames[0], "--image", frames[1],
                     "--detector-checkpoint", detector_ck, "--checkpoint", gan["port_dir"],
                     "--detector-size", "64", "--output", str(out_dir), "--seed", "2",
                     *SMALL, *CPU]) == 0
    lines = capsys.readouterr().out.strip().splitlines()

    cfg = make_config(OVERRIDES)
    det_state, detector, _ = create_pretrain_state(cfg, 9, "cpu")
    restore_checkpoint(detector_ck, det_state)
    state = restore_gan_checkpoint(gan["port_dir"], create_gan_state(cfg, 9, "cpu")[0])
    with torch.no_grad():
        for n, p in state.gen.named_parameters():
            p.copy_(eval_g_params(state)[n])
    fn = make_frontalize_fn(cfg, detector, state.gen, detector_size=64,
                            nose_prior=load_nose_prior(detector_ck))
    z = cli.draw_z(2, 1, cfg.G.zdim, "cpu")
    for frame, line in zip(frames, lines):
        fake, lm5, scores = fn(torch.from_numpy(read_rgb(frame))[None], z)
        want = ((fake[0].clamp(-1, 1) + 1) * 127.5).to(torch.uint8).numpy()
        name = os.path.splitext(os.path.basename(frame))[0]
        out = str(out_dir / f"{name}_frontal.png")
        np.testing.assert_array_equal(read_png(out), want)
        assert line.startswith(f"{frame}: landmarks [") and line.endswith(f"-> {out}")
        assert f"({lm5[0, 0, 0]:.0f},{lm5[0, 0, 1]:.0f})" in line
        assert ", ".join(f"{s:.2f}" for s in scores[0].tolist()) in line


def _capture(monkeypatch, name):
    from tpgan_tpu_torch import serving

    calls = []
    monkeypatch.setattr(serving, name, lambda *a, **k: calls.append((a, k)))
    return calls


def test_export_wiring(gan, detector_ck, packed, tmp_path, monkeypatch, capsys):
    from tpgan_tpu_torch.ops import quant

    synth = _capture(monkeypatch, "export_synthesis")
    front = _capture(monkeypatch, "export_frontalize")
    calibrations = []
    real = quant.calibrate_synthesis

    def spy(cfg, gen, batches, *a, **k):
        calibrations.append([{k2: np.shape(v) for k2, v in b.items()} for b in batches])
        return real(cfg, gen, batches, *a, **k)

    monkeypatch.setattr(quant, "calibrate_synthesis", spy)
    base = ["export", "--checkpoint", gan["port_dir"], "--batch", "2", *SMALL, *CPU]
    assert cli.main([*base, "--output", "a.pt2", "--weights-dtype", "bfloat16"]) == 0
    (args, kw), = synth
    assert args[2] == "a.pt2" and kw["batch"] == 2 and kw["quant_scales"] is None
    assert kw["weights_dtype"] == torch.bfloat16 and kw["device"] == torch.device("cpu")
    assert kw["rescale_dtype"] is None and kw["min_channels"] is None
    assert capsys.readouterr().out.strip() == "wrote a.pt2 (float32, batch=2, device=cpu)"

    assert cli.main([*base, "--output", "b.pt2", "--int8", "--calib-items", "4",
                     "--int8-rescale-dtype", "bfloat16", "--int8-min-channels", "16",
                     "--platforms", "cpu"]) == 0
    args, kw = synth[1]
    assert calibrations[-1] == [{k: (2,) + s for k, s in (
        ("img", (128, 128, 3)), ("left_eye", (40, 40, 3)), ("right_eye", (40, 40, 3)),
        ("nose", (32, 40, 3)), ("mouth", (32, 48, 3)))}] * 2
    assert kw["quant_scales"] and all(v.ndim == 0 for v in kw["quant_scales"].values())
    assert kw["rescale_dtype"] == torch.bfloat16 and kw["min_channels"] == 16
    assert kw["weights_dtype"] is None and kw["device"] == torch.device("cpu")

    assert cli.main([*base, "--output", "c.pt2", "--int8", "--calib-items", "3",
                     "--calib-packed", f"{packed}/packed"]) == 0
    # batches start below --calib-items and are whole, as in JAX's
    assert [b["img"] for b in calibrations[-1]] == [(2, 128, 128, 3)] * 2

    assert cli.main([*base, "--output", "d.pt2", "--detector-checkpoint", detector_ck,
                     "--input-size", "48x64", "--detector-size", "64", "--detector-tta",
                     "--no-detector-upscale"]) == 0
    (args, kw), = front
    assert args[3] == "d.pt2" and kw["input_hw"] == (48, 64) and kw["detector_size"] == 64
    assert kw["tta"] and not kw["allow_upscale"] and not kw["refine"]
    assert kw["nose_prior"] is not None and kw["quant_scales"] is None
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        "wrote d.pt2 (full-stack float32, input 48x64, batch=2, device=cpu)"
    assert cli.main([*base, "--output", "e.pt2", "--detector-checkpoint", detector_ck,
                     "--no-nose-gate"]) == 0
    assert front[1][1]["nose_prior"] is None and front[1][1]["input_hw"] == (128, 128)


def test_export_f32_loads_back_equal_to_the_live_program(gan, tmp_path, capsys):
    from tpgan_tpu_torch.serving import load_synthesis
    from tpgan_tpu_torch.train.gan_trainer import make_synthesize_fn

    path = str(tmp_path / "synthesis.pt2")
    assert cli.main(["export", "--checkpoint", gan["port_dir"], "--batch", "2",
                     "--output", path, *SMALL, *CPU]) == 0
    batch = {k: v for k, v in synthetic_gan_batch(2, seed=4).items()
             if k in ("img", "left_eye", "right_eye", "nose", "mouth")}
    z = np.random.RandomState(0).standard_normal((2, gan["zdim"])).astype(np.float32)
    got = load_synthesis(path)(batch, z)
    args = argparse.Namespace(checkpoint=gan["port_dir"], g_weights="auto")
    live = make_synthesize_fn(make_config(OVERRIDES),
                              cli.eval_generator(make_config(OVERRIDES), args, "cpu"))(batch, z)
    assert torch.equal(got, live)


@pytest.mark.parametrize("platforms", ["cpu,tpu", "tpu", "cpu,cuda"])
def test_export_refuses_other_platforms(platforms, capsys):
    with pytest.raises(SystemExit) as done:
        cli.main(["export", "--output", "x.pt2", "--platforms", platforms, *CPU])
    assert done.value.code == 2
    assert "a .pt2 artifact holds one device's program" in capsys.readouterr().err


# --------------------------------------------------------------------------
# no CUDA device
# --------------------------------------------------------------------------

REQUIRED = {"pretrain": [], "train": [], "eval": [], "synthesize": ["--image", "x", "--landmarks",
                                                                     "y"],
            "train-embedder": ["--img-list", "x"],
            "frontalize": ["--image", "x", "--detector-checkpoint", "y"],
            "export": ["--output", "x"]}


@pytest.mark.parametrize("command", CHIP_BOUND)
def test_without_cuda_a_chip_bound_subcommand_returns_3(no_cuda, command, capsys, monkeypatch):
    ran = []
    monkeypatch.setitem(cli.COMMANDS, command, lambda args: ran.append(args.device) or 0)
    assert cli.main([command, *REQUIRED[command]]) == 3
    assert cli.main([command, *REQUIRED[command], "--device", "cuda"]) == 3
    err = capsys.readouterr().err
    assert err.count(f"tpgan_tpu_torch {command}: no CUDA device is available") == 2
    assert not ran
    assert cli.main([command, *REQUIRED[command], *CPU]) == 0
    assert ran == [torch.device("cpu")]


def test_without_cuda_host_commands_run_and_an_export_to_cuda_returns_3(no_cuda, tmp_path,
                                                                         capsys):
    assert cli.main(["export", "--output", "x", "--platforms", "cuda", *CPU]) == 3
    assert "tpgan_tpu_torch export: no CUDA device" in capsys.readouterr().err
    img, lm5 = render_face(1, ALL_CAMERA_YAWS["130"], 140)
    write_png(str(tmp_path / "001_01_130_00.png"), img)
    (tmp_path / "i.txt").write_text(str(tmp_path / "001_01_130_00.png") + "\n")
    (tmp_path / "l.txt").write_text(landmarks68_string(lm5) + "\n")
    assert cli.main(["prepare-data", "--images", str(tmp_path / "i.txt"), "--landmarks",
                     str(tmp_path / "l.txt"), "--out", str(tmp_path / "out")]) == 0
    assert (tmp_path / "out" / "img.list").read_text().split() == \
        [str(tmp_path / "out" / "train" / "001_01_130_00.png")]
