"""Command-line entry points, run as ``python -m epnet_tpu_torch.tools.<name>``."""
