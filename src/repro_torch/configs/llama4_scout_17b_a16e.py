"""llama4-scout-17b-a16e [moe] — 16 routed experts top-1 + 1 shared expert on
every layer; iRoPE-style chunked-local attention on 3 of 4 layers (the 4th is
global) => sub-quadratic, long_500k runs.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""

from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("llama4-scout-17b-a16e")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab=202048,
        pattern=("attn_chunked", "attn_chunked", "attn_chunked", "attn"),
        chunk_size=8192,
        rope_on_global=False,  # iRoPE: NoPE on the global-attention layers
        moe=MoEConfig(
            n_experts=16, top_k=1, d_expert=8192, n_shared=1, d_shared=8192
        ),
        long_context=True,
        attn_pad_heads=48,
    )
