"""The port's data path (``tpgan_tpu_torch/data/``) against the JAX
package's ``tpgan_tpu/data/`` on the CPU, exact unless a line says
otherwise:

* the 68 -> 5 landmarks; ``resize_image`` against ``jax.image.resize``
  (within 1e-6); the host and batched patch crops, landmarks far outside
  the image included;
* the Multi-PIE naming rules, and ``TrainDataset``, ``IdentityImageDataset``
  and ``TestDataset`` items on a tree that the JAX package's
  ``prepare_dataset`` wrote (through PIL);
* the port's ``generate_gan_protocol`` / ``prepare_dataset`` against
  JAX's: the decoded pixels of every file and ``img.list``;
* ``pack_dataset``'s shards and index, ``PackedDataset`` items in both
  modes, the device sampler's batches (with and without yaw weights) and
  its errors, ``batch_iterator``'s batches over two epochs (in worker
  processes too), its worker server stopped, ``prefetch_to_device`` on
  the CPU;
* the host library against its numpy references and JAX's binding, and a
  failed build raising;
* ``bench_loader`` on the CPU, the train step's uint8 transfer;
* the slice as a whole: the same uint8 batches from both pipelines, one
  D+G step on each side from the first of them (the JAX step's noise
  injected), and ``run_gan_training`` fed by the port's pipeline.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from tpgan_tpu.data import multipie as jmultipie
from tpgan_tpu.data import native as jnative
from tpgan_tpu.data import packing as jpacking
from tpgan_tpu.data import patches as jpatches
from tpgan_tpu.data import pipeline as jpipeline
from tpgan_tpu.data import synthetic as jsynthetic
from tpgan_tpu.data import synthetic_faces as jfaces
from tpgan_tpu.utils import misc as jmisc
from tpgan_tpu_torch.data import bench_loader, multipie, native, packing, patches, pipeline
from tpgan_tpu_torch.data import synthetic, synthetic_faces
from tpgan_tpu_torch.ops import _build
from tpgan_tpu_torch.train import gan_trainer
from tpgan_tpu_torch.utils import misc

from _torch_data_items import Toy
from _torch_train_parity import Pair, assert_metrics_match, overrides, sgd, torch_sgd

torch.set_num_threads(1)

SUBJECTS = 2


@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory):
    """The 2-subject protocol written by the JAX package (PIL files)."""
    root = str(tmp_path_factory.mktemp("jax_tree"))
    return root, jfaces.generate_gan_protocol(root, SUBJECTS)


@pytest.fixture(scope="module")
def port_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_tree"))
    return root, synthetic_faces.generate_gan_protocol(root, SUBJECTS)


@pytest.fixture(scope="module")
def packs(port_tree, tmp_path_factory):
    """The port's tree packed by the port and by JAX (shards of 5 items)."""
    _, img_list = port_tree
    out = tmp_path_factory.mktemp("packs")
    port_dir, jax_dir = str(out / "port"), str(out / "jax")
    packing.pack_dataset(multipie.TrainDataset(img_list), port_dir, shard_size=5)
    jpacking.pack_dataset(jmultipie.TrainDataset(img_list), jax_dir, shard_size=5)
    return port_dir, jax_dir


def _equal_trees(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and np.array_equal(g, w), k


# ---- utils/misc.py, data/patches.py ---------------------------------------

@pytest.mark.parametrize("rows", [68, 69])
def test_five_landmarks_from_68(rows):
    lm = np.random.RandomState(rows).uniform(0, 128, (rows, 2)).astype(np.float32)
    got = misc.five_landmarks_from_68(lm)
    assert got.dtype == np.float32
    assert np.array_equal(got, jmisc.five_landmarks_from_68(lm))
    assert misc.FIVE_PTS_IDX == jmisc.FIVE_PTS_IDX


@pytest.mark.parametrize("size", [64, 32, 256, (100, 70)], ids=str)
def test_resize_image_matches_jax(size):
    x = np.random.RandomState(0).uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    want = np.asarray(jmisc.resize_image(jnp.asarray(x), size))
    got = misc.resize_image(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    got_hwc = misc.resize_image(torch.from_numpy(x[1]), size).numpy()
    np.testing.assert_allclose(got_hwc, want[1], rtol=0, atol=1e-6)


LANDMARKS = np.asarray([
    [[39.5, 40.2], [86.0, 38.7], [63.6, 63.6], [45.7, 90.0], [83.9, 88.7]],
    # x = -10.5 floors to -11; x = 250 and y = -70 are far outside (all-
    # zero patches); the mouth centre of x = -100 and 83.9 is -8.05
    [[-10.5, 40.2], [250.0, 38.7], [63.6, -70.0], [-100.0, 90.0], [83.9, 88.7]],
    [[-60.0, 127.9], [200.0, 0.0], [127.5, 127.5], [0.4, 1.0], [-0.4, -1.0]],
], np.float32)


def test_crop_patches_host_and_batch_match_jax():
    imgs = np.random.RandomState(1).rand(len(LANDMARKS), 128, 128, 3).astype(np.float32)
    want_batch = jpatches.crop_patches_batch(jnp.asarray(imgs), jnp.asarray(LANDMARKS))
    got_batch = patches.crop_patches_batch(torch.from_numpy(imgs), torch.from_numpy(LANDMARKS))
    assert patches.PATCH_SIZES == jpatches.PATCH_SIZES
    for b, lm in enumerate(LANDMARKS):
        host = patches.crop_patches(imgs[b], lm)
        _equal_trees(host, jpatches.crop_patches(imgs[b], lm))
        for name in patches.PATCH_SIZES:
            assert np.array_equal(got_batch[name][b].numpy(), np.asarray(want_batch[name][b]))
            assert np.array_equal(got_batch[name][b].numpy(), host[name]), (b, name)
    assert not got_batch["right_eye"][1].any() and not got_batch["nose"][1].any()


# ---- data/multipie.py ---------------------------------------------------

NAMES = [
    "data/train/001_01_110_00.png", "my_data/train/001_01_110_00.png",
    "mp/001_01_01_11_0_00.png", "mp/042_02_03_24_0_07.png", "mp/001_01_01_05_1_00.png",
    "mp/001_01_01_19_1_00.PNG", "001_01_051_00.png", "/abs/dir/001_01_01_08_1_00.png",
    "weird.png",
]


@pytest.mark.parametrize("name", NAMES)
def test_camera_token_and_frontal_twin_match_jax(name):
    assert multipie.camera_token(name) == jmultipie.camera_token(name)
    assert multipie.frontal_twin_path(name) == jmultipie.frontal_twin_path(name)


def test_datasets_match_jax_on_a_jax_written_tree(jax_tree):
    root, img_list = jax_tree
    assert len(img_list) == SUBJECTS * 8
    port, jax_ds = multipie.TrainDataset(img_list), jmultipie.TrainDataset(img_list)
    for i in range(len(img_list)):
        _equal_trees(port[i], jax_ds[i])
    files = sorted(os.path.join(root, "train", n) for n in os.listdir(os.path.join(root, "train")))
    ident, jident = multipie.IdentityImageDataset(files), jmultipie.IdentityImageDataset(files)
    for i in range(len(files)):
        (img, label), (jimg, jlabel) = ident[i], jident[i]
        assert np.array_equal(img, jimg) and label.dtype == jlabel.dtype and label == jlabel


@pytest.mark.parametrize("subject,camera", [(0, "110"), (1, "051"), (1, "200")])
def test_test_dataset_matches_jax(tmp_path, subject, camera):
    img, lm5 = jfaces.render_face(subject, jfaces.CAMERA_YAWS[camera], 150)
    path = str(tmp_path / f"{subject:03d}_01_{camera}_00.png")
    Image.fromarray(img[:, 3:]).save(path)  # a non-square source
    # runs of spaces and a CRLF tail, as real landmark files carry
    lm = jfaces.landmarks68_string(lm5).replace(" ", "  ", 3) + "\r\n"
    _equal_trees(multipie.TestDataset([path], [lm])[0], jmultipie.TestDataset([path], [lm])[0])


def _pixels(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def test_protocol_and_prepare_match_jax(jax_tree, port_tree):
    (jroot, jlist), (root, plist) = jax_tree, port_tree
    walk = lambda r: sorted(os.path.relpath(os.path.join(d, f), r)
                            for d, _, fs in os.walk(r) for f in fs)
    files = walk(root)
    assert files == walk(jroot) and len(files) == SUBJECTS * 9 * 8 + 1
    for rel in files:
        if rel == "img.list":
            continue
        assert np.array_equal(_pixels(os.path.join(root, rel)),
                              _pixels(os.path.join(jroot, rel))), rel
    assert [os.path.relpath(p, root) for p in plist] == [os.path.relpath(p, jroot) for p in jlist]
    with open(os.path.join(root, "img.list")) as f, open(os.path.join(jroot, "img.list")) as g:
        assert f.read().replace(root, "<root>") == g.read().replace(jroot, "<root>")


def test_synthetic_faces_and_batches_match_jax():
    assert synthetic_faces.ALL_CAMERA_YAWS == jfaces.ALL_CAMERA_YAWS
    assert synthetic_faces.CAMERA_YAWS == jfaces.CAMERA_YAWS
    for subject in (0, 7, 346):
        _equal_trees(synthetic_faces.identity_params(subject), jfaces.identity_params(subject))
        for yaw in (-90.0, -45.0, 0.0, 30.0, 75.0):
            (img, lm), (jimg, jlm) = (synthetic_faces.render_face(subject, yaw, 144),
                                      jfaces.render_face(subject, yaw, 144))
            assert np.array_equal(img, jimg) and np.array_equal(lm, jlm)
            assert synthetic_faces.landmarks68_string(lm) == jfaces.landmarks68_string(jlm)
    _equal_trees(synthetic.synthetic_pretrain_batch(2, 64, seed=4),
                 jsynthetic.synthetic_pretrain_batch(2, 64, seed=4))


# ---- data/packing.py ----------------------------------------------------

def test_packed_shards_and_items_match_jax(packs):
    port_dir, jax_dir = packs
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    for name in os.listdir(port_dir):
        if name.endswith(".npy"):
            got, want = np.load(os.path.join(port_dir, name)), np.load(os.path.join(jax_dir, name))
            assert got.dtype == want.dtype and np.array_equal(got, want), name
    with open(os.path.join(port_dir, "index.json")) as f, \
            open(os.path.join(jax_dir, "index.json")) as g:
        meta = json.load(f)
        assert meta == json.load(g)
    assert meta["shards"] == [5, 5, 5, 1] and len(meta["names"]) == 16
    for to_float in (True, False):
        port, jds = packing.PackedDataset(port_dir, to_float), jpacking.PackedDataset(jax_dir, to_float)
        assert len(port) == len(jds) == 16 and port.names == jds.names
        for i in (0, 4, 5, 15):  # across shard boundaries
            _equal_trees(port[i], jds[i])


def _yaw_weights(names):
    yaws = np.asarray([abs(synthetic_faces.ALL_CAMERA_YAWS.get(multipie.camera_token(n), 0.0))
                       for n in names])
    return 1.0 + (yaws / 90.0) ** 2


@pytest.mark.parametrize("weighted", [False, True])
def test_device_batch_iterator_matches_jax(packs, weighted):
    port_dir, jax_dir = packs
    data = packing.load_packed_to_device(port_dir, "cpu")
    jdata = jpacking.load_packed_to_device(jax_dir)
    assert {k: (v.dtype, tuple(v.shape)) for k, v in data.items()} == {
        k: (torch.from_numpy(np.asarray(v)).dtype, tuple(v.shape)) for k, v in jdata.items()}
    w = _yaw_weights(packing.PackedDataset(port_dir).names) if weighted else None
    it = packing.device_batch_iterator(data, 3, seed=2, weights=w)
    jit = jpacking.device_batch_iterator(jdata, 3, seed=2, weights=w)
    for _ in range(6):
        _equal_trees({k: v.numpy() for k, v in next(it).items()}, next(jit))


@pytest.mark.parametrize("weights,match", [(np.ones(3), "shape"), (-np.ones(16), "non-negative"),
                                           (np.zeros(16), "non-negative")])
def test_device_batch_iterator_rejects_bad_weights(packs, weights, match):
    data = packing.load_packed_to_device(packs[0], "cpu")
    with pytest.raises(ValueError, match=match):
        next(packing.device_batch_iterator(data, 2, weights=weights))
    with pytest.raises(ValueError, match=match):
        next(jpacking.device_batch_iterator(jpacking.load_packed_to_device(packs[1]), 2,
                                            weights=weights))


# ---- data/pipeline.py ---------------------------------------------------

def _as_numpy(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("shuffle,drop_last,workers", [
    (True, True, 0), (True, False, 0), (False, True, 0), (False, False, 0), (True, False, 2),
])
def test_batch_iterator_matches_jax(shuffle, drop_last, workers):
    kw = dict(shuffle=shuffle, seed=5, drop_last=drop_last, epochs=2)
    got = list(pipeline.batch_iterator(Toy(), 4, num_workers=workers, **kw))
    want = list(jpipeline.batch_iterator(Toy(), 4, num_workers=2, **kw))
    assert len(got) == len(want) == (4 if drop_last else 6)
    for g, w in zip(got, want):
        assert all(isinstance(v, torch.Tensor) for v in g.values())
        _equal_trees(_as_numpy(g), w)
    if not drop_last:  # item 3 is None: 9 items per epoch
        assert sum(len(g["x"]) for g in got) == 18 and min(len(g["x"]) for g in got) < 4
    sub = [0, 3, 4, 9, 2]
    _equal_trees(_as_numpy(next(pipeline.batch_iterator(Toy(), 4, indices=sub, num_workers=0,
                                                        **kw))),
                 next(jpipeline.batch_iterator(Toy(), 4, indices=sub, **kw)))


def test_stop_worker_server_leaves_no_process():
    from multiprocessing import forkserver, resource_tracker

    it = pipeline.batch_iterator(Toy(), 4, num_workers=2, epochs=1)
    next(it)
    server = forkserver._forkserver._forkserver_pid
    assert server is not None
    it.close()
    pipeline.stop_worker_server()
    assert forkserver._forkserver._forkserver_pid is None
    assert resource_tracker._resource_tracker._pid is None
    with pytest.raises(ChildProcessError):  # exited and reaped
        os.waitpid(server, os.WNOHANG)
    pipeline.stop_worker_server()  # nothing left to stop
    assert len(list(pipeline.batch_iterator(Toy(), 4, num_workers=2, epochs=1))) == 2


def test_endless_batch_iterator_that_cannot_yield_raises():
    # JAX's iterator loops forever here: 9 items, batch 20, drop_last
    with pytest.raises(ValueError, match="no batch of 20"):
        next(pipeline.batch_iterator(Toy(), 20, num_workers=0))
    assert len(list(pipeline.batch_iterator(Toy(), 20, num_workers=0, drop_last=False,
                                            epochs=1))[0]["x"]) == 9


def test_prefetch_to_device_passes_batches_through_on_the_cpu():
    batches = [{"x": torch.zeros(2)}, {"x": np.ones(3)}]
    assert [b is c for b, c in zip(pipeline.prefetch_to_device(iter(batches), 2, "cpu"),
                                   batches)] == [True, True]


# ---- data/native.py -----------------------------------------------------

def test_native_matches_reference_and_jax():
    rng = np.random.RandomState(0)
    src = rng.randint(0, 256, (37, 23, 3), np.uint8)
    for fn in ("u8_to_pm1", "u8_to_unit"):
        got = getattr(native, fn)(src)
        assert got.dtype == np.float32
        assert np.array_equal(got, getattr(native, fn + "_reference")(src))
        assert np.array_equal(got, getattr(jnative, fn)(src))
    assert list(native.u8_to_pm1(np.array([0, 255], np.uint8))) == [-1.0, 1.0]
    img = rng.rand(128, 128, 3).astype(np.float32)
    for center in [(39.4, 40.2), (-10.5, 3.0), (200.0, -70.0), (127.9, 127.9), (0.0, 64.0)]:
        for size in [(40, 40), (40, 32), (48, 32)]:
            got = native.crop_patch(img, center, size)
            assert np.array_equal(got, native.crop_patch_reference(img, center, size))
            assert np.array_equal(got, jnative.crop_patch(img, center, size))
    for shape in [(218, 178, 3), (100, 300, 3), (64, 64, 1), (129, 77, 3)]:
        s = rng.randint(0, 256, shape, np.uint8)
        out, scale, pads = native.letterbox(s, 128)
        ref, ref_scale, ref_pads = native.letterbox_reference(s, 128)
        assert np.array_equal(out, ref) and (scale, pads) == (ref_scale, ref_pads)
        # JAX's build is tuned to the host CPU (-march=native), which may
        # contract the source coordinate's multiply-add into an FMA: the
        # coordinate moves by up to one f32 ulp (1.5e-5 below 256 px),
        # the blend by that much of the pixel range [0, 1]
        jout, jscale, jpads = jnative.letterbox(s, 128)
        np.testing.assert_allclose(out, jout, rtol=0, atol=1.6e-5)
        assert (scale, pads) == (jscale, jpads)


def test_failed_host_build_raises(tmp_path, monkeypatch):
    (tmp_path / "host").mkdir()
    (tmp_path / "host" / "tpgan_host.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="host library build failed"):
        _build.build_host()
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="host library build failed"):
        native.u8_to_pm1(np.zeros(4, np.uint8))


# ---- data/bench_loader.py, the step's transfer ----------------------------

def test_bench_loader_on_the_cpu(port_tree, packs, capsys):
    root, _ = port_tree
    assert bench_loader.main([
        "--img-list", os.path.join(root, "img.list"), "--packed", packs[0], "--batch-size", "2",
        "--batches", "2", "--num-workers", "0", "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["path"] for r in rows] == ["files", "packed", "packed+prefetch", "device"]
    for r in rows:
        assert set(r) == {"path", "imgs_per_sec", "batch_size", "device"}
        assert r["imgs_per_sec"] > 0 and r["batch_size"] == 2 and r["device"] == "cpu"


def test_train_step_moves_uint8_to_the_device(monkeypatch):
    batch = synthetic.synthetic_gan_batch(2, seed=1)
    u8 = {k: (v if k == "label" else np.round((v + 1) * 127.5).astype(np.uint8))
          for k, v in batch.items()}
    moved = []
    real = gan_trainer._to_device

    def spy(x, device):
        moved.append(np.asarray(x).dtype)
        return real(x, device)

    monkeypatch.setattr(gan_trainer, "_to_device", spy)
    got = gan_trainer._to_device_nchw(u8, torch.device("cpu"))
    assert moved == [np.uint8 if k != "label" else np.int32 for k in u8]
    v = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(gan_trainer.decode_u8_batch({"x": v})["x"].numpy(),
                                  (2.0 * v.astype(np.float32) - 255.0) / 255.0)
    # the former order: decoded on the host, then moved
    for k, v in gan_trainer.decode_u8_batch(u8).items():
        t = torch.as_tensor(v)
        want = t.permute(0, 3, 1, 2).contiguous() if t.dim() == 4 else t
        assert got[k].dtype == want.dtype and torch.equal(got[k], want), k


# ---- the slice as a whole -----------------------------------------------

def test_slice_pipelines_agree_and_feed_both_steps(packs, tmp_path):
    """Port files -> both packs -> each package's batch_iterator and
    prefetch (seed 3) give the same uint8 batches; one D+G step on each
    side from the first batch, with JAX's noise, gives the same metrics;
    run_gan_training takes 2 steps from the port's pipeline."""
    port_dir, jax_dir = packs
    port_ds = packing.PackedDataset(port_dir, to_float=False)
    got = list(pipeline.prefetch_to_device(pipeline.batch_iterator(
        port_ds, 2, seed=3, epochs=1, num_workers=0), 2, "cpu"))
    want = list(jpipeline.prefetch_to_device(jpipeline.batch_iterator(
        jpacking.PackedDataset(jax_dir, to_float=False), 2, seed=3, epochs=1)))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g["img"].dtype == torch.uint8
        _equal_trees(_as_numpy(g), _as_numpy(w))

    first = _as_numpy(got[0])
    decoded = {k: v if k == "label" else native.u8_to_pm1(v) for k, v in first.items()}
    pair = Pair(batch=2, data=decoded)
    pair.batch = first  # both steps decode the uint8 batch themselves
    _, _, jax_metrics = pair.jax_step(sgd)
    _, _, port_metrics = pair.port_step(torch_sgd)
    assert_metrics_match(port_metrics, jax_metrics)

    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.train.loop import run_gan_training
    from tpgan_tpu_torch.train.metrics import MetricWriter

    cfg = make_config(overrides(train={"batch_size": 2}))
    writer = MetricWriter(str(tmp_path), use_tensorboard=False)
    feed = pipeline.prefetch_to_device(pipeline.batch_iterator(port_ds, 2, seed=3, num_workers=0),
                                       2, "cpu")
    state = run_gan_training(cfg, feed, steps=2, writer=writer, log_every=1, device="cpu")
    writer.close()
    with open(os.path.join(str(tmp_path), "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert state.step == 2 and [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(v) for r in rows for v in r.values())
