"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + 4 shared experts (fused
shared hidden 4*1408=5632), qwen1.5 arch with QKV bias.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""

from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("qwen2-moe-a2.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab=151936,
        qkv_bias=True,
        moe=MoEConfig(
            n_experts=60, top_k=4, d_expert=1408, n_shared=4, d_shared=5632
        ),
    )
