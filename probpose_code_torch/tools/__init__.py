"""Command-line tools of the port (``python -m probpose_code_torch.tools.test``)."""
