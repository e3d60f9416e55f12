"""`repro_torch.launch` — the H100 roofline (`roofline`), the static work
of the port's kernels and runs (`kernel_cost`), the report tables the
CLIs print (`report`), and the LM's steps: the step builders (`steps`),
the serve CLI (`serve`) and the single-card trainer (`train`).  The
reference's sharding, mesh and dry-run launchers wait for meshes over
several cards (ROADMAP §1)."""
