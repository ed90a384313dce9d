"""Optimizer, learning-rate schedules, 1-bit gradient compression and
distillation with the SPS threshold search."""
