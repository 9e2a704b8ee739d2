"""Helpers over nested dicts of tensors."""
