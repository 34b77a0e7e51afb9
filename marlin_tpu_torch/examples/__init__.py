"""The port's example entry points (``python -m
marlin_tpu_torch.examples.<name>``)."""
