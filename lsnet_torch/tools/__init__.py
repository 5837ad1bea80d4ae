"""Command-line tools of the port (``python3 -m lsnet_torch.tools.<name>``)."""
