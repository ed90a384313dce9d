"""Deterministic synthetic training data."""
