"""PyTorch + CUDA port of the LLCG system, beside the JAX reference.

``repro_torch`` mirrors ``repro``'s module layout and never imports JAX or
the JAX package.  Its entry points run on the GPU unless the caller passes
``device="cpu"``; there the hand-written kernels' plain PyTorch versions
run in their place.  See ``ROADMAP.md`` for what is ported so far.
"""
