"""The generator's modules (LocalPathway, the LocalFuser, GlobalPathway,
Generator) and the PatchGAN critic (Discriminator)."""
