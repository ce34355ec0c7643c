"""Training runtime: the losses, the ``Trainer`` and its CLI."""
