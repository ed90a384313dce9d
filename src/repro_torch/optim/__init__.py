"""Optimizer, learning-rate schedules and 1-bit gradient compression."""
