"""`repro_torch.checkpoint` — atomic, rotated checkpoints in the
reference's format (`checkpoint`), the port of
`repro/checkpoint/checkpoint.py`."""
