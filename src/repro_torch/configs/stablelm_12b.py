"""stablelm-12b — [hf:stabilityai/stablelm-2-12b (family card: stablelm-2-1_6b)].

40L dense, d_model 5120, 32 heads GQA kv=8, d_ff 13824, vocab 100352,
full attention + RoPE.  Full attention ⇒ long_500k skipped (see DESIGN.md).
"""
from repro_torch.models.transformer.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13_824,
    vocab_size=100_352,
    pattern=(("full", 1),),
    rope_theta=10_000.0,
    tie_embeddings=False,
    citation="hf:stabilityai/stablelm-2-1_6b",
)
