"""Per-machine graph loaders and round sampling, and the synthetic token
corpora of LM training (numpy)."""
