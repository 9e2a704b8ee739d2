"""Inter-machine communication: the pluggable payload-compression layer.

* :mod:`repro_torch.comm.compress` — codecs (``none | bf16 | int8 |
  int8_ef``) for the averaging round's parameter-delta exchange and the
  halo round's cut-node feature exchange, the wire-format byte pricing the
  accounting uses, and the stochastic-rounding uniform stream.
"""
from repro_torch.comm.compress import (
    COMPRESSIONS,
    HALO_COMPRESSIONS,
    UniformStream,
    averaging_payload_bytes,
    check_compression,
    compress_features,
    compress_tree,
    decompress_features,
    decompress_tree,
    wire_row_bytes,
)

__all__ = [
    "COMPRESSIONS",
    "HALO_COMPRESSIONS",
    "UniformStream",
    "averaging_payload_bytes",
    "check_compression",
    "compress_features",
    "compress_tree",
    "decompress_features",
    "decompress_tree",
    "wire_row_bytes",
]
