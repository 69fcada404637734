"""Command-line tools of the port (``python -m raggesture_tpu_torch.tools.<name>``)."""
