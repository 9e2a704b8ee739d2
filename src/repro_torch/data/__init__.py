"""Per-machine graph loaders and round sampling (numpy)."""
