"""`repro_torch.launch` — the H100 roofline (`roofline`), the static work
of the port's kernels and runs (`kernel_cost`), the report tables the
CLIs print (`report`), and the LM's steps: the step builders (`steps`),
the serve CLI (`serve`) and the single-card trainer (`train`), and meshes
over the ranks of a `torch.distributed` world (`mesh`).  The reference's
sharding and dry-run launchers wait for the LM mesh (ROADMAP §1 item 2)."""
