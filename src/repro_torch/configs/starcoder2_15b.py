"""starcoder2-15b — [arXiv:2402.19173].

40L dense, d_model 6144, 48 heads GQA kv=4, d_ff 24576 (non-gated GELU
MLP), vocab 49152, RoPE.  Full attention ⇒ long_500k skipped.
"""
from repro_torch.models.transformer.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24_576,
    vocab_size=49_152,
    pattern=(("full", 1),),
    rope_theta=100_000.0,
    act="gelu",
    tie_embeddings=False,
    citation="arXiv:2402.19173",
)
