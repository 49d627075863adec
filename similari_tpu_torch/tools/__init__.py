"""The port's measurement tools, each run as `python -m
similari_tpu_torch.tools.<name>`: the adversarial accuracy suite and the
gallery and oriented profilers (the JAX package's `tools/` scripts of the
same names).  Importing a module runs nothing."""
