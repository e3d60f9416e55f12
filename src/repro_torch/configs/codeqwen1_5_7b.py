"""codeqwen1.5-7b [dense] — qwen1.5 arch, full MHA (kv=32), QKV bias.
[hf:Qwen/CodeQwen1.5-7B; hf]"""

from repro_torch.configs.base import ModelConfig, register


@register("codeqwen1.5-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        head_dim=128,
        d_ff=13440,
        vocab=92416,
        qkv_bias=True,
    )
