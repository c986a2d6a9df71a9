"""The generator's modules (LocalPathway, the LocalFuser, GlobalPathway,
Generator), the PatchGAN critic (Discriminator) and the identity
embedders (ResNet18, MobileNetV2Classifier, FeatureExtractModel)."""
