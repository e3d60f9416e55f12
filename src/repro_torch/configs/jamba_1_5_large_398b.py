"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e
top-2 on every other layer.  [arXiv:2403.19887; hf]"""

from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("jamba-1.5-large-398b")
def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab=65536,
        # period-8 Jamba block: attention at slot 4, Mamba elsewhere (1:7);
        # MoE replaces the FFN on every other layer
        pattern=("mamba",) * 4 + ("attn",) + ("mamba",) * 3,
        moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576),
        moe_mask=(False, True) * 4,
        ssm_state=16,
        ssm_expand=2,
        # 398B on a 256-chip v5e pod: f32 master + f32 Adam moments would be
        # 18+ GB/chip; bf16 master/moments (8-bit-Adam-style trade) fits.
        param_dtype="bfloat16",
        long_context=True,
    )
