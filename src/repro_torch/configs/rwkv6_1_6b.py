"""rwkv6-1.6b ("Finch") — [arXiv:2404.05892].

24L attention-free RWKV6, d_model 2048 (32 heads of 64), channel-mix
d_ff 7168, vocab 65536.  Data-dependent per-channel decay through the
low-rank adapter — the paper's signature mechanism.  Constant-size
recurrent state ⇒ long_500k eligible.
"""
from repro_torch.models.transformer.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65_536,
    pattern=(("rwkv6", 1),),
    tie_embeddings=False,
    citation="arXiv:2404.05892",
)
