"""Runnable examples of the port's library pieces
(``python -m repro_torch.examples.<name>``)."""
