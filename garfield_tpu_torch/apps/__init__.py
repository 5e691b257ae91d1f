"""Command-line applications of the port (counterpart of
``garfield_tpu/apps``): ``python -m garfield_tpu_torch.apps.aggregathor``."""
