"""`repro_torch.launch` — the H100 roofline (`roofline`), the static work
of the port's kernels and runs (`kernel_cost`), the report tables the
CLIs print (`report`), and LM serving: the step builders (`steps`) and
the serve CLI (`serve`).  The reference's training, sharding, mesh and
dry-run launchers are not ported yet (ROADMAP §1 items 3-4)."""
