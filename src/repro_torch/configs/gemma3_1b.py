"""gemma3-1b — [hf:google/gemma-3-1b-pt].

26L, d_model 1152, 4 heads with head_dim 256, MQA (kv=1), d_ff 6912,
vocab 262144, 5:1 local(SWA-512):global interleave, QK-norm, 128k-class
context via the windowed layers.

long_500k note: the global layers make the stock pattern unbounded-state;
``LONG_CONTEXT_CONFIG`` is the serving variant where the global layers also
fall back to the sliding window — the documented trade for 500k-token
decode, cf. DESIGN.md §Arch-applicability.
"""
import dataclasses

from repro_torch.models.transformer.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    pattern=(("swa", 5), ("full", 1)),
    n_units=4,
    remainder=(("swa", 2),),
    sliding_window=512,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    citation="hf:google/gemma-3-1b-pt",
)

# 500k-decode serving variant: global layers get a 32k window (bounded state)
LONG_CONTEXT_CONFIG = dataclasses.replace(
    CONFIG,
    name="gemma3-1b-long",
    pattern=(("swa", 5), ("swa", 1)),
)
