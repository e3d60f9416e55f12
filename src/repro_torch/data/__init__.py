"""`repro_torch.data` — the token data pipeline (`pipeline`), the port of
`repro/data/pipeline.py`."""
