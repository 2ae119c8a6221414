"""Runnable examples of the port (``python -m pysfm_tpu_torch.examples.<name>``)."""
