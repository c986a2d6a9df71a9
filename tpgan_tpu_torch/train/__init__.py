"""Model construction, the synthesis (serving) function, the fused
WGAN-GP train step with its options and its optimizers, checkpoints, the
training loop, its metrics and sample grids, and the identity
embedder's training."""
