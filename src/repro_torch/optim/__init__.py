"""`repro_torch.optim` — AdamW with global-norm clipping and a warmup-cosine
schedule (`adamw`), the port of `repro/optim/adamw.py`.  The gradient
compression collectives (`repro/optim/compression.py`) reduce over a mesh
axis and wait for meshes over several cards."""
