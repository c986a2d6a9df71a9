"""The generator's modules: LocalPathway, the LocalFuser, GlobalPathway and
Generator."""
