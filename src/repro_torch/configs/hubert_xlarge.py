"""hubert-xlarge — [arXiv:2106.07447].

48L encoder-only, d_model 1280, 16 heads (MHA), d_ff 5120, vocab 504
(masked-prediction codebook targets).  Same backbone as wav2vec2-XL.

The conv/mel frontend is a STUB per the assignment carve-out:
``input_specs`` provides precomputed 512-dim frame embeddings; the model
owns only the projection + mask-embedding + transformer encoder + codebook
classifier.  Encoder-only ⇒ no decode shapes (see DESIGN.md).
"""
from repro_torch.models.transformer.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    pattern=(("full", 1),),
    encoder_only=True,
    frontend="audio",
    frontend_dim=512,
    act="gelu",
    tie_embeddings=False,
    citation="arXiv:2106.07447",
)
