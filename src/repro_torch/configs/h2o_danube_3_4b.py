"""h2o-danube-3-4b — [arXiv:2401.16818].

24L, d_model 3840, 32 heads GQA kv=8, d_ff 10240, vocab 32000.  The Danube
family mixes Llama architecture with Mistral-style sliding-window attention
(window 4096) — every layer windowed, which makes the stack long_500k
eligible with constant-size KV state.
"""
from repro_torch.models.transformer.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10_240,
    vocab_size=32_000,
    pattern=(("swa", 1),),
    sliding_window=4096,
    rope_theta=10_000.0,
    tie_embeddings=False,
    citation="arXiv:2401.16818",
)
