"""tpgan_tpu_torch — the PyTorch/CUDA port of ``tpgan_tpu`` for one NVIDIA
H100 (Hopper, sm_90a).

The module layout mirrors ``tpgan_tpu`` so each module's counterpart is
found by name. The port imports ``torch`` and numpy only: nothing of JAX
and nothing of ``tpgan_tpu``, whose jax-free pieces (config, part
geometry, channel scaling, the synthetic batch) it keeps as its own
copies.

Layout: modules take and return NCHW tensors with OIHW conv and IOHW
transposed-conv weights (reference-layout state_dicts load directly);
the synthesis entry point keeps the JAX package's NHWC batch contract.

Device rule: entry points (``train.gan_trainer.build_generator``,
``entry.entry``, ``train.loop.run_gan_training``) run on ``cuda`` unless
the caller passes ``device="cpu"``; with no GPU and no explicit device
they raise.

Importing this package imports only :mod:`tpgan_tpu_torch.config`; no
kernel is built until one is first launched on a CUDA tensor.
"""

from tpgan_tpu_torch.config import Config, flat_override, make_config

__all__ = ["Config", "flat_override", "make_config"]
