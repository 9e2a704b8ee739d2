"""qwen3-moe-30b-a3b — [hf:Qwen/Qwen3-30B-A3B].

48L, d_model 2048, 32 heads with explicit head_dim 128 and GQA kv=4,
QK-norm, MoE: 128 routed experts top-8, expert d_ff 768, vocab 151936.

128 experts divide the 16-way model axis → expert-parallel sharding.
"""
from repro_torch.models.transformer.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151_936,
    pattern=(("moe", 1),),
    moe=MoEConfig(num_experts=128, top_k=8, expert_d_ff=768),
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    citation="hf:Qwen/Qwen3-30B-A3B",
)
