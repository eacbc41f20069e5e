"""Losses, batch sampling and the training loop."""
