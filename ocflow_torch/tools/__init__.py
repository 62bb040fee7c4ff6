"""Measurement tools of the port (``python -m ocflow_torch.tools.<name>``)."""
