"""Integrity-hashed, asynchronous checkpoints of train states."""
