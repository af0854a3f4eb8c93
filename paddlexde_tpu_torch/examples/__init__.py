"""Command-line entry points of the port (``python -m
paddlexde_tpu_torch.examples.<name>``)."""
