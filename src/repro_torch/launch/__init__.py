"""Launchers: ``train`` (the fault-tolerant training loop)."""
