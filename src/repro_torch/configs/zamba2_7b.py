"""zamba2-7b — [arXiv:2411.15242].

81L hybrid: Mamba2 backbone with a *shared* full-attention transformer
block interleaved every 6th layer (the Zamba2 signature — one parameter set
reused at every application, fed concat(hidden, original embedding)).
d_model 3584, 32 heads (MHA kv=32) for the shared block, d_ff 14336,
vocab 32000, ssm_state 64 (d_inner 7168 → 112 Mamba2 heads of 64).

Pattern: 13 × [shared_attn, mamba2×5] + mamba2×3 = 81 layers.
Hybrid ⇒ long_500k eligible: SSM state is constant-size; the shared-attn KV
caches are sharded over the model axis.
"""
from repro_torch.models.transformer.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14_336,
    vocab_size=32_000,
    pattern=(("shared_attn", 1), ("mamba2", 5)),
    n_units=13,
    remainder=(("mamba2", 3),),
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_kernel=4, chunk=64),
    rope_theta=10_000.0,
    tie_embeddings=False,
    citation="arXiv:2411.15242",
)
