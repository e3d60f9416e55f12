"""The port's hand-written CUDA kernels (`csrc/`) and their torch twins.

  K1 `ky_sampler.ky_sample_kernel`, `ky_sample_keyed`
                                    <- repro/kernels/ky_sampler.py:159
  K2 `interp_lut.interp_kernel`     <- repro/kernels/interp_lut.py:50
  K3 `bn_gibbs.bn_sweep`            <- repro/kernels/bn_gibbs.py:236
  K4 `mrf_gibbs.mrf_half_step`      <- repro/kernels/mrf_gibbs.py:159
  K5 `bn_gibbs.fused_color_round_mesh`, `fused_color_round`
                                    <- repro/kernels/bn_gibbs.py:316
  K6 `mrf_gibbs.mrf_halo_half_step` <- repro/kernels/mrf_gibbs.py:280

Each wrapper launches its kernel for CUDA tensors and counts the launch in
its `.launches` attribute (K1's two entries in
`ky_sample_kernel.launches`, K5's in `fused_color_round.launches`); for
CPU tensors it runs its plain torch twin (`*_ref`).  K3-K6 and K1's keyed
entry take a key and hash their random words inside the kernel; their
wrappers build the same words for the twins.
Kernels are built with nvcc at first use (`_lib.py`).
"""
