"""`repro_torch.optim` — AdamW with global-norm clipping and a warmup-cosine
schedule (`adamw`), the port of `repro/optim/adamw.py`.  The gradient
compression collectives (`compression`) reduce over an axis of a mesh of
ranks (`launch/mesh.py`)."""
