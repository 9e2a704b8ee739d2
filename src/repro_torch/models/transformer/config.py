"""Architecture configuration for the assigned model families.

A :class:`ModelConfig` fully describes one architecture: dimensions, the
block *pattern* (which block type at which depth, including repeated units
and shared blocks à la Zamba2 / Gemma3's 5:1 local:global), MoE routing,
SSM/RWKV state sizes, and modality frontend stubs.

The pattern is expressed as a repeating **unit**; parameters and decode
states are stacked per unit entry as ``(n_units, count, …)``, the JAX
package's layout, and the model loops over them:

    pattern      = [("swa", 5), ("full", 1)]   # gemma3's 5 local : 1 global
    n_units      = 4                            # → 24 layers
    remainder    = [("swa", 2)]                 # → 26 total
    shared_kinds = {"shared_attn"}              # zamba2: one param set reused
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

BlockKind = str  # "full" | "swa" | "moe" | "moe_swa" | "mamba2" | "rwkv6" | "shared_attn"

ATTN_KINDS = ("full", "swa", "shared_attn")
MOE_KINDS = ("moe", "moe_swa")
SCAN_KINDS = ("mamba2", "rwkv6")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared_experts: int = 0
    shared_expert_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64          # d_state (Mamba2 "N")
    head_dim: int = 64           # per-head channel dim ("P")
    num_heads: int = 0           # 0 → derive from d_inner / head_dim
    expand: int = 2              # d_inner = expand · d_model
    conv_kernel: int = 4
    chunk: int = 64


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # block pattern (repeating-unit form)
    pattern: Tuple[Tuple[BlockKind, int], ...] = (("full", 1),)
    n_units: Optional[int] = None          # default: num_layers / unit size
    remainder: Tuple[Tuple[BlockKind, int], ...] = ()

    # attention
    rope_theta: float = 10_000.0
    sliding_window: int = 4096
    logit_softcap: float = 0.0
    qk_norm: bool = False

    # substacks
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None

    # modality frontends (stubs per assignment carve-out)
    encoder_only: bool = False
    frontend: Optional[str] = None         # None | "audio" | "vision"
    frontend_dim: int = 0
    num_prefix_tokens: int = 0             # VLM patch tokens prepended

    # numerics / activation
    dtype: str = "bfloat16"
    kv_cache_dtype: Optional[str] = None   # None (=dtype) | "int8" (serving)
    norm_eps: float = 1e-6
    act: str = "silu"                      # silu-glu FFN; "gelu" for encoders
    tie_embeddings: bool = True

    # provenance
    citation: str = ""

    # ---------------------------------------------------------------- util
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def unit_size(self) -> int:
        return sum(c for _, c in self.pattern)

    def resolved_units(self) -> int:
        if self.n_units is not None:
            return self.n_units
        rem = sum(c for _, c in self.remainder)
        return (self.num_layers - rem) // max(self.unit_size(), 1)

    def layer_plan(self) -> List[BlockKind]:
        """Flat list of block kinds, length == num_layers (sanity-checked)."""
        plan: List[BlockKind] = []
        for _ in range(self.resolved_units()):
            for kind, cnt in self.pattern:
                plan.extend([kind] * cnt)
        for kind, cnt in self.remainder:
            plan.extend([kind] * cnt)
        if len(plan) != self.num_layers:
            raise ValueError(
                f"{self.name}: pattern covers {len(plan)} layers, "
                f"config says {self.num_layers}")
        return plan

    def supports_decode(self) -> bool:
        return not self.encoder_only

    def subquadratic(self) -> bool:
        """True if long-context decode is admissible per the assignment:
        SSM / hybrid / linear-attention / sliding-window stacks qualify;
        stacks containing unwindowed full attention ("full"/"moe") do not.
        Zamba2's *shared_attn* blocks are full-attention but few and shared —
        the assignment explicitly lists hybrids as long_500k-eligible, so
        shared_attn does not disqualify (its KV is sharded on the model axis).
        """
        plan = self.layer_plan()
        return all(k in SCAN_KINDS or k in ("swa", "moe_swa", "shared_attn")
                   for k in plan)

    def validate(self) -> None:
        assert self.d_model % self.num_heads == 0 or self.head_dim, self.name
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, self.name
        self.layer_plan()
        if any(k in MOE_KINDS for k in self.layer_plan()):
            assert self.moe is not None, f"{self.name}: MoE pattern needs moe cfg"
        if any(k in SCAN_KINDS for k in self.layer_plan()):
            assert self.ssm is not None or "rwkv6" in {k for k, _ in self.pattern}, self.name


def reduced_variant(cfg: ModelConfig, num_layers: int = 2, d_model: int = 256,
                    **overrides) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests (≤4 experts, d_model≤512)."""
    plan = cfg.layer_plan()
    # shrink pattern → keep one unit's worth of structure, cut to num_layers
    kinds: List[BlockKind] = []
    for k in plan:
        if len(kinds) >= num_layers:
            break
        kinds.append(k)
    # ensure at least one of each kind present in the original unit
    unit_kinds = [k for k, _ in cfg.pattern]
    for uk in unit_kinds:
        if uk not in kinds and len(kinds) >= 1:
            kinds[-1] = uk
    pattern = tuple((k, 1) for k in kinds)
    heads = max(2, min(cfg.num_heads, 4))
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, num_experts=4,
                                  top_k=min(cfg.moe.top_k, 2),
                                  expert_d_ff=d_model,
                                  num_shared_experts=min(cfg.moe.num_shared_experts, 1),
                                  shared_expert_d_ff=d_model)
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, state_dim=16, head_dim=32, chunk=16)
    small = dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=len(kinds),
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=d_model // heads,
        d_ff=2 * d_model,
        vocab_size=min(cfg.vocab_size, 512),
        pattern=pattern,
        n_units=1,
        remainder=(),
        sliding_window=min(cfg.sliding_window, 64),
        moe=moe,
        ssm=ssm,
        frontend_dim=min(cfg.frontend_dim, 64) if cfg.frontend_dim else 0,
        num_prefix_tokens=min(cfg.num_prefix_tokens, 8),
        dtype="float32",
        **overrides,
    )
    small.validate()
    return small
