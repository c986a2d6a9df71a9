"""Data subsystem of the port: patch-crop geometry, Multi-PIE-style GAN
train/test data, packed uint8 shards, a DataLoader-based host pipeline
with pinned, ``non_blocking`` device prefetch, and the synthetic
batches. Files are read and written without an imaging package
(:mod:`.imageio`). The CelebA pretraining data waits for the landmark
detector's port."""

from tpgan_tpu_torch.data.multipie import (
    TestDataset,
    TrainDataset,
    frontal_twin_path,
)
from tpgan_tpu_torch.data.patches import crop_patches, crop_patches_batch
from tpgan_tpu_torch.data.pipeline import batch_iterator, prefetch_to_device
from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch, synthetic_pretrain_batch

__all__ = [
    "crop_patches",
    "crop_patches_batch",
    "TrainDataset",
    "TestDataset",
    "frontal_twin_path",
    "batch_iterator",
    "prefetch_to_device",
    "synthetic_gan_batch",
    "synthetic_pretrain_batch",
]
