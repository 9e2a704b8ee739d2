"""qwen2-moe-a2.7b — [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L, d_model 2048, 16 heads (MHA: kv=16), MoE: 60 routed experts top-4 with
expert d_ff 1408, plus 4 always-on shared experts (fused 4×1408 = 5632 GLU
with sigmoid gate), vocab 151936.

Sharding note: 60 experts do not divide the 16-way model axis, so this
config uses tensor-parallel experts (d_ff axis sharded) — contrast with
qwen3-moe's expert parallelism.
"""
from repro_torch.models.transformer.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151_936,
    pattern=(("moe", 1),),
    moe=MoEConfig(num_experts=60, top_k=4, expert_d_ff=1408,
                  num_shared_experts=4, shared_expert_d_ff=1408),
    rope_theta=10_000.0,
    tie_embeddings=False,
    citation="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
