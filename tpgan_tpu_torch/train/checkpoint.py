"""Checkpoints of the GAN and the pretrain state, and the import of
reference ``.pth`` weights — the port of ``tpgan_tpu/train/checkpoint.py``.

A checkpoint is one directory per step, ``<directory>/<step>/state.pt``:
a ``torch.save`` of the step and, for a GAN state, both models'
``state_dict`` (parameters and BatchNorm statistics), both optimizers'
``state_dict`` and the EMA weights; for the detector's pretrain state
(``train.pretrain.PretrainState``), the model's, the optimizer's and the
learning-rate schedule's ``state_dict``; all copied to the host. It is
written under a temporary name and renamed, so a directory named by a
step always holds a whole checkpoint.
The JAX package's Orbax checkpoints do not load here; a JAX state comes
across through ``tpgan_tpu_torch.convert.load_jax_gan_state``. One model's
variables alone (the identity embedder's) are saved in the same layout
by :func:`save_model_variables`, with ``step`` and ``model`` (its
``state_dict``) in place of the train state.

``import_mobilenet_v2_pth`` maps a reference landmark-detector ``.pth``
onto the port's ``MobileNetV2`` (``tpgan_tpu/train/checkpoint.py:173``).
"""

from __future__ import annotations

import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple, Union

import torch

from tpgan_tpu_torch.train.gan_trainer import GANTrainState

if TYPE_CHECKING:
    from tpgan_tpu_torch.train.pretrain import PretrainState

State = Union[GANTrainState, "PretrainState"]

CHECKPOINT_FILE = "state.pt"


# --------------------------------------------------------------------------
# save / restore
# --------------------------------------------------------------------------

def _to_host(obj: Any) -> Any:
    """``obj`` with every tensor copied to the host (dicts, lists and
    tuples walked)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _snapshot(state: State) -> Dict[str, Any]:
    if not isinstance(state, GANTrainState):  # the pretrain state
        return _to_host({
            "step": int(state.step),
            "detector": state.model.state_dict(),
            "opt": state.optimizer.state_dict(),
            "sched": state.scheduler.state_dict() if state.scheduler is not None else None,
        })
    return _to_host({
        "step": int(state.step),
        "gen": state.gen.state_dict(),
        "disc": state.disc.state_dict(),
        "g_opt": state.g_opt.state_dict(),
        "d_opt": state.d_opt.state_dict(),
        "g_ema": dict(state.g_ema_params),
    })


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(name) for name in os.listdir(directory)
        if name.isdigit() and os.path.isfile(os.path.join(directory, name, CHECKPOINT_FILE))
    )


def _write(directory: str, step: int, payload: Dict[str, Any], max_to_keep: int) -> None:
    final = os.path.join(directory, str(step))
    tmp = os.path.join(directory, f".{step}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)  # left by a write that was cut
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, CHECKPOINT_FILE))
    os.replace(tmp, final)
    for old in _steps(directory)[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old)))


# directory -> (its writer thread, the writes queued on it)
_async_writers: Dict[str, Tuple[ThreadPoolExecutor, List[Future]]] = {}
_async_lock = threading.Lock()


def save_checkpoint(
    directory: str, step: int, state: State, max_to_keep: int = 5,
    block: bool = True,
) -> None:
    """Save ``state`` (a ``GANTrainState``: the step, both models, both
    optimizers, the EMA weights; or a ``PretrainState``: the step, the
    detector, its optimizer and schedule) as ``directory/<step>``, keeping the
    newest ``max_to_keep`` steps. Raises ``FileExistsError`` when that
    step is saved already.

    The state is copied to the host before the call returns. With
    ``block=False`` the file is then written on a background thread, one
    per directory, and the training goes on; ``finalize_checkpoints`` (or
    the next blocking save to the directory) waits for the writes and
    raises what failed in them."""
    directory = os.path.abspath(directory)
    if os.path.exists(os.path.join(directory, str(step))):
        raise FileExistsError(f"a checkpoint of step {step} exists under {directory}")
    os.makedirs(directory, exist_ok=True)
    payload = _snapshot(state)
    if block:
        finalize_checkpoints(directory)
        _write(directory, step, payload, max_to_keep)
        return
    with _async_lock:
        if directory not in _async_writers:
            _async_writers[directory] = (ThreadPoolExecutor(max_workers=1), [])
        pool, futures = _async_writers[directory]
        futures.append(pool.submit(_write, directory, step, payload, max_to_keep))


def finalize_checkpoints(directory: Optional[str] = None) -> None:
    """Wait for the background writes of one directory, or of all, and
    raise the first error one of them met."""
    with _async_lock:
        dirs = [os.path.abspath(directory)] if directory else list(_async_writers)
        writers = [_async_writers.pop(d) for d in dirs if d in _async_writers]
    for pool, futures in writers:
        try:
            for future in futures:
                future.result()
        finally:
            pool.shutdown(wait=True)


def latest_step(directory: str) -> Optional[int]:
    """The newest step saved whole under ``directory``, else None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def _load(directory: str, step: Optional[int]) -> Dict[str, Any]:
    step = latest_step(directory) if step is None else step
    path = os.path.join(directory, str(step), CHECKPOINT_FILE) if step is not None else None
    if path is None or not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint found under {directory}")
    return torch.load(path, map_location="cpu", weights_only=True)


def _load_optimizer(opt: torch.optim.Optimizer, saved: Dict[str, Any]) -> None:
    """The saved per-parameter state (Adam's moments and count) into
    ``opt``, whose own hyperparameters and device settings (``capturable``
    once a CUDA graph was captured) stay: they come from the config and
    the path that runs the step, as optax's state holds none."""
    opt.load_state_dict({"state": saved["state"],
                         "param_groups": opt.state_dict()["param_groups"]})


def _apply_pretrain(payload: Dict[str, Any], state: "PretrainState") -> "PretrainState":
    if "detector" not in payload:
        raise ValueError("the checkpoint holds no pretrain state (no detector)")
    state.model.load_state_dict(payload["detector"], strict=True)
    _load_optimizer(state.optimizer, payload["opt"])
    if (payload["sched"] is None) != (state.scheduler is None):
        raise ValueError("the checkpoint and the state disagree on the learning-rate schedule")
    if state.scheduler is not None:
        # the milestones and gamma come from the config; the count and the
        # rate reached, from the checkpoint
        sched = payload["sched"]
        state.scheduler.last_epoch = sched["last_epoch"]
        state.scheduler._last_lr = list(sched["_last_lr"])
        for group, lr in zip(state.optimizer.param_groups, sched["_last_lr"]):
            group["lr"] = lr
    state.step = int(payload["step"])
    return state


def _apply(payload: Dict[str, Any], state: State, tolerate_ema: bool) -> State:
    if not isinstance(state, GANTrainState):
        return _apply_pretrain(payload, state)
    if "gen" not in payload:
        raise ValueError("the checkpoint holds no GAN train state")
    has_ema, wants_ema = bool(payload["g_ema"]), bool(state.g_ema_params)
    if has_ema != wants_ema and not tolerate_ema:
        raise ValueError(
            f"the checkpoint {'tracks' if has_ema else 'tracks no'} EMA weights and the state "
            f"{'does' if wants_ema else 'does not'}; restore_gan_checkpoint bridges the two")
    state.gen.load_state_dict(payload["gen"], strict=True)
    state.disc.load_state_dict(payload["disc"], strict=True)
    _load_optimizer(state.g_opt, payload["g_opt"])
    _load_optimizer(state.d_opt, payload["d_opt"])
    with torch.no_grad():
        if wants_ema:
            # EMA switched on across the checkpoint: it starts from the
            # restored live weights
            source = payload["g_ema"] if has_ema else dict(state.gen.named_parameters())
            if set(source) != set(state.g_ema_params):
                raise ValueError("the checkpoint's EMA weights do not match the generator's")
            for name, t in state.g_ema_params.items():
                t.copy_(source[name])
        # EMA switched off: the checkpoint's EMA weights are dropped, and
        # evaluation scores the live weights
    state.step = int(payload["step"])
    return state


def restore_checkpoint(
    directory: str, state_like: State, step: Optional[int] = None
) -> State:
    """Restore ``directory/<step>`` (the newest when ``step`` is None)
    into ``state_like`` (a GAN or a pretrain state), in place, and return
    it. Raises ``FileNotFoundError`` when there is none, and on any
    layout mismatch (keys, shapes, EMA tracked on one side only, a
    schedule on one side only)."""
    return _apply(_load(directory, step), state_like, tolerate_ema=False)


def restore_gan_checkpoint(
    directory: str, state_like: GANTrainState, step: Optional[int] = None
) -> GANTrainState:
    """:func:`restore_checkpoint` that tolerates ``train.ema_decay``
    switched on or off across the checkpoint, as the JAX function does:
    a state that tracks EMA restored from a checkpoint without it starts
    its EMA from the restored live weights; a checkpoint's EMA weights
    that the state does not track are dropped, so evaluation scores the
    live weights. Any other mismatch raises."""
    return _apply(_load(directory, step), state_like, tolerate_ema=True)


def save_model_variables(
    directory: str, step: int, model: torch.nn.Module, max_to_keep: int = 5
) -> None:
    """Save one model's variables, its ``state_dict`` (weights and
    BatchNorm statistics) and no optimizer state, as ``directory/<step>``
    in the layout of :func:`save_checkpoint`, keeping the newest
    ``max_to_keep`` steps: what the JAX embedder training saves
    (``tpgan_tpu/train/feature_extract.py:234-247``) and an identity
    checkpoint restores. Raises ``FileExistsError`` when that step is
    saved already."""
    directory = os.path.abspath(directory)
    if os.path.exists(os.path.join(directory, str(step))):
        raise FileExistsError(f"a checkpoint of step {step} exists under {directory}")
    os.makedirs(directory, exist_ok=True)
    finalize_checkpoints(directory)
    _write(directory, step, _to_host({"step": int(step), "model": model.state_dict()}),
           max_to_keep)


def restore_model_variables(
    directory: str, model: torch.nn.Module, step: Optional[int] = None
) -> int:
    """Load ``directory/<step>`` (the newest when ``step`` is None), saved
    by :func:`save_model_variables`, into ``model`` (strict: keys and
    shapes must match; values are cast to the model's dtypes) and return
    its step. Raises ``FileNotFoundError`` when there is none and
    ``ValueError`` for a train-state checkpoint."""
    payload = _load(directory, step)
    if "model" not in payload:
        raise ValueError(f"{directory} holds a train state, not one model's variables")
    model.load_state_dict(payload["model"], strict=True)
    return int(payload["step"])


# --------------------------------------------------------------------------
# reference .pth import
# --------------------------------------------------------------------------
#
# The reference Generator and Discriminator (D_and_G_model.py, the GAN
# config's no-BN layout) keep torch layouts, and so does the port: Conv2d
# OIHW, ConvTranspose2d IOHW, Linear (out, in), and fc1's columns in the
# CHW flatten order of both. Importing is renaming, plus the JAX
# importer's healing of the reference's 72-vs-75 channel defect by
# zero-extension (checkpoint.py:361-396): add_conv_and_deconv_128 gains 3
# zero input channels (the raw I128 channels are ignored) and 3 zero
# outputs; enhance_features_128 and conv5 gain zero input channels at
# the insertion offset 64 + 72 = 136. Conv factories emit [Conv2d, act]
# (conv at index 0) or [ReflectionPad2d, Conv2d, act] (index 1).
#
# Like the JAX importers, these are tested on module trees built with the
# reference's naming (tests/test_reference_checkpoint_import.py); no
# author-trained .pth exists to test against.

def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch ``state_dict`` from ``path`` (unwrapping the reference's
    optimizer bundle, which nests the model under ``model``,
    UtilityMethods.py:95-99), as CPU tensors."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    return {k: v.detach() for k, v in obj.items() if isinstance(v, torch.Tensor)}


def _zero_extend(w: torch.Tensor, dim: int, count: int, at: int) -> torch.Tensor:
    """Insert ``count`` zero slices into ``w`` along ``dim`` at ``at``."""
    shape = list(w.shape)
    shape[dim] = count
    return torch.cat([w.narrow(dim, 0, at), w.new_zeros(shape),
                      w.narrow(dim, at, w.shape[dim] - at)], dim)


def _layer(sd, name: str) -> Dict[str, torch.Tensor]:
    out = {"weight": sd[f"{name}.weight"]}
    if f"{name}.bias" in sd:
        out["bias"] = sd[f"{name}.bias"]
    return out


def _conv_p(sd, prefix: str, reflect: bool = False) -> Dict[str, torch.Tensor]:
    return _layer(sd, f"{prefix}.{1 if reflect else 0}")


def _rb_p(sd, prefix: str, reflect: bool = False) -> Dict[str, Any]:
    return {
        "conv0": {"conv": _conv_p(sd, f"{prefix}.layers.0", reflect)},
        "conv1": {"conv": _conv_p(sd, f"{prefix}.layers.1", reflect)},
    }


def _local_pathway(sd, prefix: str) -> Dict[str, Any]:
    p: Dict[str, Any] = {}
    for i in range(4):
        p[f"conv{i}_conv"] = {"conv": _conv_p(sd, f"{prefix}.conv{i}.0")}
        p[f"conv{i}_res"] = _rb_p(sd, f"{prefix}.conv{i}.1")
    for j in range(3):
        p[f"dec{j}_deconv"] = {"deconv": _conv_p(sd, f"{prefix}.deconv{j}")}
        p[f"dec{j}_select_conv"] = {"conv": _conv_p(sd, f"{prefix}.after_select{j}.0")}
        p[f"dec{j}_select_res"] = _rb_p(sd, f"{prefix}.after_select{j}.1")
    p["local_img"] = {"conv": _conv_p(sd, f"{prefix}.local_img")}
    return p


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = value.contiguous()
    return out


def _extend_conv(conv: Dict[str, torch.Tensor], at: int, inputs: bool, outputs: bool) -> None:
    """Zero-extend an OIHW conv by 3 channels at ``at``: its inputs
    (dim 1) and/or its outputs (dim 0, and the bias)."""
    if inputs:
        conv["weight"] = _zero_extend(conv["weight"], 1, 3, at)
    if outputs:
        conv["weight"] = _zero_extend(conv["weight"], 0, 3, at)
        if "bias" in conv:
            conv["bias"] = _zero_extend(conv["bias"], 0, 3, at)


def import_generator_pth(path: str) -> Dict[str, torch.Tensor]:
    """Reference Generator ``state_dict`` -> the port Generator's
    ``state_dict`` (``use_batchnorm=False``; load with ``strict=True``),
    the 72->75 defect healed by zero-extension."""
    sd = load_torch_state_dict(path)
    params: Dict[str, Any] = {}
    for part, ours in (
        ("local_pathway_left_eye", "local_left_eye"),
        ("local_pathway_right_eye", "local_right_eye"),
        ("local_pathway_nose", "local_nose"),
        ("local_pathway_mouth", "local_mouth"),
    ):
        params[ours] = _local_pathway(sd, part)

    g = "global_pathway"
    gp: Dict[str, Any] = {}
    for i in range(5):
        gp[f"conv{i}_conv"] = {"conv": _conv_p(sd, f"{g}.conv{i}.0")}
        for j in range(4 if i == 4 else 1):
            gp[f"conv{i}_res{j}"] = _rb_p(sd, f"{g}.conv{i}.{1 + j}")
    gp["fc1"] = _layer(sd, f"{g}.fc1")  # CHW flatten on both sides
    for name in ("deconv_8", "deconv_32", "deconv_64", "deconv_128"):
        gp[name] = {"deconv": _conv_p(sd, f"{g}.{name}")}
    gp["add_8"] = _rb_p(sd, f"{g}.add_conv_and_deconv_8", reflect=True)
    for j in range(2):
        gp[f"enhance_8_{j}"] = _rb_p(sd, f"{g}.enhance_features_8.{j}", reflect=True)
    for size in (16, 32, 64):
        gp[f"upsample_{size}"] = {"deconv": _conv_p(sd, f"{g}.upsample_{size}")}
        gp[f"add_{size}"] = _rb_p(sd, f"{g}.add_conv_and_deconv_{size}")
        for j in range(2):
            gp[f"enhance_{size}_{j}"] = _rb_p(sd, f"{g}.enhance_features_{size}.{j}")
    gp["upsample_128"] = {"deconv": _conv_p(sd, f"{g}.upsample_128")}

    # the 72 -> 75 zero-extension (see the comment above)
    gp["add_128"] = _rb_p(sd, f"{g}.add_conv_and_deconv_128")
    gp["enhance_128"] = _rb_p(sd, f"{g}.enhance_features_128.0")
    for cname in ("conv0", "conv1"):
        _extend_conv(gp["add_128"][cname]["conv"], 72, inputs=True, outputs=True)
        _extend_conv(gp["enhance_128"][cname]["conv"], 136, inputs=True, outputs=True)
    gp["conv5_conv"] = {"conv": _conv_p(sd, f"{g}.conv5.0")}
    _extend_conv(gp["conv5_conv"]["conv"], 136, inputs=True, outputs=False)
    gp["conv5_res"] = _rb_p(sd, f"{g}.conv5.1")
    gp["conv6"] = {"conv": _conv_p(sd, f"{g}.conv6")}
    gp["decoded_img128"] = {"conv": _conv_p(sd, f"{g}.decoded_img128")}
    params["global_pathway"] = gp
    params["feature_predict"] = {"fc": _layer(sd, "feature_predict.fc")}
    return _flatten(params)


def import_discriminator_pth(path: str) -> Dict[str, torch.Tensor]:
    """Reference Discriminator ``state_dict`` (D_and_G_model.py:409-435,
    no-BN layout) -> the port Discriminator's ``state_dict`` (load with
    ``strict=True``). Sequential indices: convs at model.{0,1,2,3,5},
    residual blocks at model.{4,6}, the head at model.7."""
    sd = load_torch_state_dict(path)
    params: Dict[str, Any] = {}
    for slot, ours in {0: "conv0", 1: "conv1", 2: "conv2", 3: "conv3", 5: "conv4"}.items():
        params[ours] = {"conv": _conv_p(sd, f"model.{slot}")}
    params["res3"] = _rb_p(sd, "model.4")
    params["res4"] = _rb_p(sd, "model.6")
    params["head"] = {"conv": _conv_p(sd, "model.7")}
    return _flatten(params)


def _bn_sd(sd, src: str, dst: str) -> Dict[str, torch.Tensor]:
    out = {f"{dst}.{k}": sd[f"{src}.{k}"]
           for k in ("weight", "bias", "running_mean", "running_var")}
    out[f"{dst}.num_batches_tracked"] = sd.get(f"{src}.num_batches_tracked",
                                               torch.tensor(0, dtype=torch.long))
    return out


def import_mobilenet_v2_pth(path: str) -> Dict[str, torch.Tensor]:
    """Reference MobileNetV2 landmark-model ``state_dict`` (saved by
    UtilityMethods.save_model from the model at MobileNetV2.py:122-218)
    -> the port detector's ``state_dict`` (load with ``strict=True``; the
    head mode is not in the weights). Layouts carry over as they are;
    names map as the JAX importer maps them: ``conv1.{0,1}`` -> ``stem``
    / ``stem_bn``; ``bottlenecks.i.conv.{0,1,3,4,6,7}`` -> ``block{i}``'s
    ``expand``, ``expand_bn``, ``depthwise``, ``depthwise_bn``,
    ``project``, ``project_bn``; ``conv2.{0,1}`` -> ``conv2`` /
    ``conv2_bn``; ``extra_layers.i`` -> ``extra{i}``; ``ssd_head.
    {location,classification}_layer.j`` -> ``ssd_head.{loc,cls}{j}``."""
    sd = load_torch_state_dict(path)
    out = {"stem.weight": sd["conv1.0.weight"], **_bn_sd(sd, "conv1.1", "stem_bn")}
    i = 0
    while f"bottlenecks.{i}.conv.0.weight" in sd:
        base = f"bottlenecks.{i}.conv"
        for slot, name in ((0, "expand"), (3, "depthwise"), (6, "project")):
            out[f"block{i}.{name}.weight"] = sd[f"{base}.{slot}.weight"]
            out.update(_bn_sd(sd, f"{base}.{slot + 1}", f"block{i}.{name}_bn"))
        i += 1
    out["conv2.weight"] = sd["conv2.0.weight"]
    out.update(_bn_sd(sd, "conv2.1", "conv2_bn"))
    i = 0
    while f"extra_layers.{i}.weight" in sd:
        out.update({f"extra{i}.{k}": v for k, v in _layer(sd, f"extra_layers.{i}").items()})
        i += 1
    j = 0
    while f"ssd_head.location_layer.{j}.weight" in sd:
        for ref, ours in (("location_layer", "loc"), ("classification_layer", "cls")):
            out.update({f"ssd_head.{ours}{j}.{k}": v
                        for k, v in _layer(sd, f"ssd_head.{ref}.{j}").items()})
        j += 1
    return {k: v.contiguous() for k, v in out.items()}
