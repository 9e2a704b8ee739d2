"""Hand-written Hopper kernels, their plain PyTorch versions and the
wrappers that dispatch between them by device."""
