"""xlstm-350m [ssm] — sLSTM + mLSTM blocks (3:1 interleave), no separate FFN
(d_ff=0; the xLSTM blocks carry their own up/down projections).
[arXiv:2405.04517; unverified]"""

from repro_torch.configs.base import ModelConfig, register


@register("xlstm-350m")
def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        family="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        head_dim=256,
        d_ff=0,
        vocab=50304,
        pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        long_context=True,
    )
