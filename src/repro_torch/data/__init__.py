"""Deterministic synthetic training data and calibration sampling."""
