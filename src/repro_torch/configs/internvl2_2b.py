"""internvl2-2b — [arXiv:2404.16821].

VLM: InternViT vision encoder + InternLM2-1.8B language backbone.
LM backbone: 24L, d_model 2048, 16 heads GQA kv=8, d_ff 8192, vocab 92553.

The vision tower is a STUB per the assignment carve-out: ``input_specs``
provides 256 precomputed 1024-dim patch embeddings per image; the model
owns the 2-layer MLP projector + the language transformer.  Full attention
⇒ long_500k skipped.
"""
from repro_torch.models.transformer.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92_553,
    pattern=(("full", 1),),
    frontend="vision",
    frontend_dim=1024,
    num_prefix_tokens=256,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    citation="arXiv:2404.16821",
)
