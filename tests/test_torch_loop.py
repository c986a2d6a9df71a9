"""The port's training loop (``tpgan_tpu_torch/train/loop.py``) with its
metrics, samples and profiler trace, on the CPU at fm_multiplier 0.25,
batch 1, float32:

* 4 steps with a checkpoint every 2, then a resume to 6: the numbering
  continues, and ``metrics.jsonl`` holds the step's metric keys, which
  tests/test_torch_train_step.py holds equal to the JAX step's, plus
  ``imgs_per_sec``;
* ``steps_per_dispatch=2`` reaches the state of one step per dispatch, to
  the bit (the step count, the weights, the logged metrics);
* a NaN planted in the batch makes ``NaNMonitor`` raise;
* ``profile_dir`` gets a ``torch.profiler`` trace;
* the sample grid is a PNG that PIL reads back pixel for pixel.
"""

import itertools
import json

import numpy as np
import pytest
import torch
from PIL import Image

from tpgan_tpu_torch.config import make_config
from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
from tpgan_tpu_torch.train.checkpoint import latest_step
from tpgan_tpu_torch.train.gan_trainer import create_gan_state, make_gan_train_step
from tpgan_tpu_torch.train.loop import PROFILE_TRACE, run_gan_training
from tpgan_tpu_torch.train.metrics import MetricWriter, NaNMonitor
from tpgan_tpu_torch.train.sampling import make_sample_fn, save_image_grid

from _torch_train_parity import overrides

torch.set_num_threads(1)


BATCH = 1  # the loop's logic, at the least CPU time per step


def _cfg(**train):
    return make_config(overrides(train=dict({"batch_size": BATCH}, **train)))


def _batches(seed=0):
    return (synthetic_gan_batch(BATCH, seed=seed + i) for i in itertools.count())


def _step_metric_keys(cfg):
    """The port step's metric keys, which tests/test_torch_train_step.py
    holds equal to the JAX step's (``assert_metrics_match``)."""
    state, gen, disc, g_opt, d_opt = create_gan_state(cfg, 0, "cpu")
    step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt)
    return set(step(state, synthetic_gan_batch(BATCH), torch.Generator().manual_seed(0))[1])


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_checkpoints_resume_and_metrics(tmp_path):
    cfg = _cfg(checkpoint_every_steps=2)
    ckpt, logs = str(tmp_path / "ckpt"), str(tmp_path / "logs")
    writer = MetricWriter(logs, use_tensorboard=False)
    state = run_gan_training(cfg, _batches(), steps=4, checkpoint_dir=ckpt, writer=writer,
                             log_every=1, device="cpu")
    assert state.step == 4 and latest_step(ckpt) == 4
    state = run_gan_training(cfg, _batches(100), steps=6, checkpoint_dir=ckpt, resume=True,
                             writer=writer, log_every=1, device="cpu")
    writer.close()
    assert state.step == 6
    assert sorted(int(p.name) for p in (tmp_path / "ckpt").iterdir()) == [2, 4, 6]
    rows = _read_jsonl(tmp_path / "logs" / "metrics.jsonl")
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5, 6]  # numbering continues
    want = _step_metric_keys(cfg) | {"imgs_per_sec"}
    for r in rows:
        assert set(r) - {"step"} == want
        assert all(np.isfinite(v) for v in r.values()) and r["imgs_per_sec"] > 0
    # a budget already reached runs nothing and saves nothing new
    again = run_gan_training(cfg, _batches(), steps=6, checkpoint_dir=ckpt, resume=True,
                             device="cpu")
    assert again.step == 6 and latest_step(ckpt) == 6


def _params(state):
    return [p.detach().clone() for m in (state.gen, state.disc) for p in m.parameters()]


def test_steps_per_dispatch_reaches_the_same_state(tmp_path):
    cfg = _cfg()
    runs = {}
    for k in (1, 2):
        writer = MetricWriter(str(tmp_path / f"k{k}"), use_tensorboard=False)
        state = run_gan_training(cfg, _batches(), steps=2, writer=writer, log_every=2,
                                 steps_per_dispatch=k, device="cpu")
        writer.close()
        runs[k] = (state.step, _params(state),
                   _read_jsonl(tmp_path / f"k{k}" / "metrics.jsonl"))
    (s1, p1, m1), (s2, p2, m2) = runs[1], runs[2]
    assert s1 == s2 == 2
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    assert [r["step"] for r in m1] == [r["step"] for r in m2] == [2]
    for a, b in zip(m1, m2):  # the last step of each dispatch
        assert {k: v for k, v in a.items() if k != "imgs_per_sec"} == \
            {k: v for k, v in b.items() if k != "imgs_per_sec"}


def test_a_planted_nan_raises(tmp_path):
    def poisoned():
        for batch in _batches():
            batch["img_frontal"][0, 0, 0, 0] = np.nan
            yield batch

    writer = MetricWriter(str(tmp_path), use_tensorboard=False)
    with pytest.raises(FloatingPointError, match="non-finite metrics at step 1"):
        run_gan_training(_cfg(), poisoned(), steps=2, writer=writer, log_every=1, device="cpu")
    writer.close()
    NaNMonitor().check(3, {"a": torch.tensor(1.0), "b": 2.0})
    with pytest.raises(FloatingPointError, match=r"\['b'\]"):
        NaNMonitor().check(3, {"a": torch.tensor(1.0), "b": float("inf")})
    NaNMonitor(enabled=False).check(3, {"b": float("nan")})


def test_profile_dir_gets_a_trace(tmp_path):
    run_gan_training(_cfg(), _batches(), steps=2, profile_dir=str(tmp_path),
                     profile_steps=(1, 2), device="cpu")
    with open(tmp_path / PROFILE_TRACE) as f:
        trace = json.load(f)
    assert any("Optimizer.step" in e.get("name", "") for e in trace["traceEvents"])


def test_image_grid_is_a_png_pil_reads_back(tmp_path):
    rng = np.random.RandomState(0)
    rows = [rng.uniform(-1.2, 1.2, (3, 5, 7, 3)).astype(np.float32) for _ in range(2)]
    path = str(tmp_path / "grid.png")
    save_image_grid([rows[0], torch.from_numpy(rows[1])], path, pad=2)
    want = np.zeros((2 * 7, 3 * 9 - 2, 3), np.uint8)
    for r, arr in enumerate(rows):
        u8 = ((np.clip(arr, -1, 1) + 1) * 127.5).astype(np.uint8)
        for i in range(3):
            want[r * 7: r * 7 + 5, i * 9: i * 9 + 7] = u8[i]
    with Image.open(path) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), want)


def test_sample_fn_writes_grids_during_training(tmp_path):
    cfg = _cfg()
    items = synthetic_gan_batch(3, seed=5)
    dataset = [{k: v[i] for k, v in items.items()} for i in range(3)]
    sample_fn = make_sample_fn(cfg, None, dataset, str(tmp_path), num_samples=2)
    run_gan_training(cfg, _batches(), steps=1, sample_fn=sample_fn, sample_every=1, device="cpu")
    with Image.open(tmp_path / "samples_000001.png") as im:
        assert im.size == (2 * 130 - 2, 3 * 130)  # 2 probes; profile, fake, frontal
        assert np.asarray(im).std() > 0


def test_a_mesh_is_refused():
    """The loop runs over a (data, model) mesh (tests/test_torch_parallel.py,
    tests/test_torch_tensor_parallel.py); refused are a mesh whose data
    ranks do not divide the global batch, and a model axis that one
    process cannot hold (make_mesh's JAX error)."""
    from tpgan_tpu_torch.config import MeshConfig
    from tpgan_tpu_torch.parallel import make_mesh
    from tpgan_tpu_torch.parallel.mesh import Mesh

    three = Mesh({"data": 3, "model": 1}, ("data", "model"), None)
    with pytest.raises(ValueError, match="not divisible by the data axis's 3 ranks"):
        run_gan_training(_cfg(), _batches(), steps=1, mesh=three, device="cpu")
    with pytest.raises(ValueError, match="^1 devices not divisible by model=2$"):
        make_mesh(MeshConfig(data=1, model=2))
