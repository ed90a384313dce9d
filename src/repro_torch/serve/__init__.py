"""Serving: samplers, cache report and the static-batch engine."""
