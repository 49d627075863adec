"""The port's measurement tools, each run as `python -m
similari_tpu_torch.tools.<name>`: the adversarial accuracy suite, the
gallery and oriented profilers, the decision margins, the stage ablation
of the batched VisualSORT step, the merge and fused-batch experiments and
the doc-table generator (the JAX package's `tools/` scripts of the same
names).  Importing a module runs nothing."""
