"""internvl2-76b [vlm] — InternViT frontend (stub) + 76B LLM backbone.
[arXiv:2404.16821; unverified]"""

from repro_torch.configs.base import ModelConfig, register


@register("internvl2-76b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab=128256,
        frontend="vision",  # input_specs() provides patch embeddings
        frontend_len=1024,
    )
