"""Functional optimizers over param dicts."""
