"""Transformer-family language models: configs, norms, the RWKV6 block, the
shared chunked scan and the ``LM`` assembly (the port has the ``rwkv6``
block kind; the others are ROADMAP.md Queue 1 item 13)."""
