"""Inputs made from a run's seed."""
