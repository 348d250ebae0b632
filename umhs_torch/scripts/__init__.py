"""Command-line runs of umhs_torch (``python -m umhs_torch.scripts.<name>``)."""
