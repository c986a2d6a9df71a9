"""The port's CelebA pretraining data (``tpgan_tpu_torch/data/celeba.py``,
``pipeline.bucketed_batch_iterator``, the pretrain half of ``packing.py``,
``synthetic_faces.generate_pretrain_protocol``) against the JAX package's
on the CPU, exact:

* ``parse_celeba_landmarks`` on a messy txt (BOM, CRLF, tabs, float and
  Windows-path fields, extra columns, short and unparseable rows);
* ``letterbox`` on uint8 and float images (the float -> uint8 truncation
  before PIL's bilinear resize, the / 255 after);
* ``CelebALandmarkDataset`` items on a tree the JAX package wrote (PIL's
  JPEGs), single-bucket and multi-bucket with the oversize drop, and the
  split;
* the port's ``generate_pretrain_protocol`` against JAX's: the txt byte
  for byte, every image decoded (by PIL) to the same pixels;
* ``bucketed_batch_iterator``'s batches over two epochs (shuffled or
  not, partial buckets kept or dropped) and ``batch_iterator`` over the
  dataset, against JAX's; the device iterators are held in
  ``tests/test_torch_pretrain.py``.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from tpgan_tpu.data import celeba as jceleba
from tpgan_tpu.data import pipeline as jpipeline
from tpgan_tpu.data import synthetic_faces as jfaces
from tpgan_tpu_torch.data import celeba, pipeline, synthetic_faces

torch.set_num_threads(1)

IMAGES = 16


@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory):
    """A CelebA-layout corpus written by the JAX package (PIL's JPEGs)."""
    root = str(tmp_path_factory.mktemp("jax_celeba"))
    return root, jfaces.generate_pretrain_protocol(root, IMAGES, sizes=(60, 200),
                                                   num_subjects=8, seed=4)


@pytest.fixture(scope="module")
def port_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_celeba"))
    return root, synthetic_faces.generate_pretrain_protocol(root, IMAGES, sizes=(60, 200),
                                                            num_subjects=8, seed=4)


def test_parse_celeba_landmarks_on_a_messy_file(tmp_path):
    rows = [
        "3",
        "lefteye_x lefteye_y righteye_x righteye_y nose_x nose_y ...",
        "000001.jpg 69 109 106 113 77 142 73 152 108 154",
        "C:\\data\\img\\000002.jpg\t70.0  110.7 107 114 78 143 74 153 109 156 1 -1 1",
        "celeba/img/000003.jpg 71 111 108 115 79 144 75 154 110 157 extra",
        "000004.jpg 1 2 3",
        "000005.jpg a b c d e f g h i j",
        "",
    ]
    path = tmp_path / "list.txt"
    path.write_bytes(b"\xef\xbb\xbf" + "\r\n".join(rows).encode())
    got = celeba.parse_celeba_landmarks(str(path))
    want = jceleba.parse_celeba_landmarks(str(path))
    assert sorted(got) == sorted(want) == ["000001.jpg", "000002.jpg", "000003.jpg"]
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["000001.jpg"], [69, 109, 106, 113, 77, 142, 90, 153])


@pytest.mark.parametrize("shape,size,upscale", [
    ((120, 90, 3), 128, True), ((200, 150, 3), 128, True), ((50, 50, 3), 128, True),
    ((50, 70, 3), 128, False), ((300, 100, 3), 256, True),
])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_letterbox_matches_jax(shape, size, upscale, dtype):
    rng = np.random.RandomState(shape[0])
    img = rng.randint(0, 256, shape, np.uint8)
    if dtype == "float32":
        img = img.astype(np.float32) / 255.0  # truncates to v - 1 for some v on the way back
    got = celeba.letterbox(img, size, allow_upscale=upscale)
    want = jceleba.letterbox(img, size, allow_upscale=upscale)
    assert got[1:] == want[1:]
    assert got[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("kw", [dict(image_size=128), dict(image_size=96),
                                dict(buckets=(96, 160), max_source_size=180)])
def test_dataset_items_match_jax_on_a_jax_written_tree(jax_tree, kw):
    root, txt = jax_tree
    ds = celeba.CelebALandmarkDataset(txt, root, **kw)
    jds = jceleba.CelebALandmarkDataset(txt, root, **kw)
    assert ds.image_paths == jds.image_paths and len(ds) == IMAGES
    dropped = 0
    for i in range(len(ds)):
        got, want = ds[i], jds[i]
        if want is None:
            assert got is None
            dropped += 1
            continue
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    assert ds.split(0.7, 0.2) == jds.split(0.7, 0.2)
    if "buckets" in kw:  # images over 180 px dropped, the rest in both buckets
        assert dropped > 0
        assert {ds[i][0].shape[0] for i in range(len(ds)) if ds[i] is not None} == {96, 160}
    else:
        assert dropped == 0


def test_the_ports_protocol_matches_jaxs(jax_tree, port_tree):
    (jroot, jtxt), (root, txt) = jax_tree, port_tree
    assert txt == jtxt
    with open(f"{root}/{txt}", "rb") as f, open(f"{jroot}/{jtxt}", "rb") as g:
        assert f.read() == g.read()
    paths = celeba.find_images(root)
    assert [p[len(root):] for p in paths] == [p[len(jroot):] for p in celeba.find_images(jroot)]
    for p in paths:
        np.testing.assert_array_equal(np.asarray(Image.open(p)),
                                      np.asarray(Image.open(jroot + p[len(root):])))


def _as_numpy(batch):
    return tuple(np.asarray(v) for v in batch)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False), (False, False)])
def test_bucketed_batch_iterator_matches_jax(jax_tree, shuffle, drop_last):
    root, txt = jax_tree
    kw = dict(buckets=(96, 160), max_source_size=180)
    ds, jds = celeba.CelebALandmarkDataset(txt, root, **kw), \
        jceleba.CelebALandmarkDataset(txt, root, **kw)
    args = dict(shuffle=shuffle, seed=3, drop_last=drop_last, epochs=2, num_workers=2,
                indices=list(range(1, IMAGES)))
    got = list(pipeline.bucketed_batch_iterator(ds, 3, **args))
    want = list(jpipeline.bucketed_batch_iterator(jds, 3, **args))
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        assert all(isinstance(v, torch.Tensor) for v in g)
        for a, b in zip(_as_numpy(g), w):
            np.testing.assert_array_equal(a, b)
    assert {g[0].shape[1] for g in got} == {96, 160}


def test_batch_iterator_over_the_dataset_matches_jax(jax_tree):
    root, txt = jax_tree
    ds, jds = celeba.CelebALandmarkDataset(txt, root, 96), \
        jceleba.CelebALandmarkDataset(txt, root, 96)
    kw = dict(shuffle=True, seed=1, epochs=1, indices=list(range(IMAGES)))
    got = list(pipeline.batch_iterator(ds, 4, num_workers=0, **kw))
    want = list(jpipeline.batch_iterator(jds, 4, **kw))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for a, b in zip(_as_numpy(g), w):
            np.testing.assert_array_equal(a, b)
