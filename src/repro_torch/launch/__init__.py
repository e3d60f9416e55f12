"""`repro_torch.launch` — the H100 roofline (`roofline`), the static work
of the port's kernels and runs (`kernel_cost`), and the report tables the
CLIs print (`report`).  The reference's LM-stack launchers (dry runs,
sharding, serving and training a language model) are not ported yet."""
