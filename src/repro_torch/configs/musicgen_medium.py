"""musicgen-medium [audio] — decoder-only over EnCodec tokens; the EnCodec
frontend is a stub providing frame embeddings.  vocab=2048 is the best-case
regime for the KY token sampler (paper targets <=32-bin distributions; 2048
needs a 2-level 128-ary hierarchy).  [arXiv:2306.05284; hf]"""

from repro_torch.configs.base import ModelConfig, register


@register("musicgen-medium")
def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        vocab=2048,
        frontend="audio",
        frontend_len=512,
        attn_pad_heads=32,
    )
