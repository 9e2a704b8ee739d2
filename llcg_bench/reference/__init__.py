"""Plain PyTorch/NumPy references that decide ``correct``.

They follow the published description of the work and import nothing of
the program (``repro_torch``), of JAX or of the JAX package."""
