"""The experiments of gendr_tpu on the port (``experiments/`` there):
``python -m gendr_tpu_torch.experiments.opt_shape``."""
