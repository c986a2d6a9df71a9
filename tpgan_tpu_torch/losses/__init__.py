"""The GAN losses: WGAN-GP (``gan``), pixel-space L1 terms (``pixel``) and
the composite generator objective (``composite``)."""
