"""Optimizer and checkpoint utilities."""
