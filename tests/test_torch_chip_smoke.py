"""The arithmetic of `chip_smoke.py`'s bounds, on the CPU: the SASS loop
counter that reads a threefry call's instructions, the least time of a
number of calls (the same as `launch.roofline`'s at the same counts), the
bound's choice between bytes and operations, and the counts its
`profile` phase holds `launch.kernel_cost` against (here at a few
chains); and the buckets its runtime phase's queries form.  The script
itself runs only on a card."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the shape of `cuobjdump -sass` output: a loop closed by a branch to an
# address (newer cuobjdump) or to a label, and a trailing self-branch
ADDRESS_FORM = """
\t\tFunction : _Z13interp_kernelPKfS0_ifffPfi
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   STG.E desc[UR4][R2.64], R5 ;
        /*0020*/              @!P0 BRA 0x10 ;
\t\tFunction : _ZN12_GLOBAL__N_121threefry_words_kernelEjjyyPi
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LOP3.LUT R0, R2, 0x1bd11bda, R3, 0x96, !PT ;
        /*0020*/                   IADD3 R8, P0, R4, UR12, RZ ;
        /*0030*/                   IADD3.X R8, R5, UR13, RZ, P0, !PT ;
        /*0040*/                   IMAD.IADD R9, R8, 0x1, R3 ;
        /*0050*/                   SHF.L.W.U32.HI R9, R9, 0xd, R9 ;
        /*0060*/                   LOP3.LUT R9, R9, R8, RZ, 0x3c, !PT ;
        /*0070*/                   PRMT R9, R9, 0x1032, R9 ;
        /*0080*/                   VIADD R7, R0, 0x1 ;
        /*0090*/                   IMAD.MOV.U32 R3, RZ, RZ, RZ ;
        /*00a0*/                   IMAD.WIDE.U32 R4, R5, UR6, R2 ;
        /*00b0*/                   LEA R8, P0, R4, UR14, 0x2 ;
        /*00c0*/                   STG.E desc[UR8][R8.64], R9 ;
        /*00d0*/                   ISETP.GE.U32.AND P0, PT, R4, UR10, PT ;
        /*00e0*/              @!P0 BRA 0x20 ;
        /*00f0*/                   EXIT ;
        /*0100*/                   BRA 0x100;
"""

LABEL_FORM = """
\t\tFunction : threefry_words_kernel
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_0:
        /*0010*/                   SHF.L.W.U32.HI R9, R9, 0xd, R9 ;
        /*0020*/                   LOP3.LUT R9, R9, R8, RZ, 0x3c, !PT ;
        /*0030*/                   IADD3 R8, R8, R9, RZ ;
        /*0040*/                   STG.E desc[UR8][R8.64], R9 ;
        /*0050*/                   SHF.L.W.U32.HI R9, R9, 0xf, R9 ;
        /*0060*/                   LOP3.LUT R9, R9, R8, RZ, 0x3c, !PT ;
        /*0070*/                   STG.E desc[UR8][R10.64], R9 ;
        /*0080*/              @!P0 BRA `(.L_x_0) ;
.L_x_1:
        /*0090*/                   BRA `(.L_x_1);
"""


def test_sass_loop_counts_reads_the_storing_loop():
    cs = _chip_smoke()
    loops = cs.sass_loop_counts(ADDRESS_FORM, "threefry_words_kernel")
    # 0x20 .. 0xe0: LOP3 x1, SHF x1, PRMT x1; IADD3, IADD3.X, IMAD.IADD,
    # VIADD (the move and the wide product are not adds); the LOP3 before
    # the loop is not counted
    assert loops == [{"instructions": 13, "stores": 1, "bit_ops": 3,
                      "add_ops": 4}]
    loops = cs.sass_loop_counts(LABEL_FORM, "threefry_words_kernel")
    assert loops == [{"instructions": 8, "stores": 2, "bit_ops": 4,
                      "add_ops": 1}]
    assert cs.sass_loop_counts(ADDRESS_FORM, "no_such_kernel") == []


@pytest.mark.parametrize("bit,add,want_cycles", [
    (41.0, 31.0, 41.0 / 64),   # bit operations on the ALU lanes bind
    (10.0, 200.0, 210.0 / 128),  # the issue rate binds
])
def test_hash_ms_takes_the_binding_pipe(bit, add, want_cycles):
    cs = _chip_smoke()
    per_call = {"bit_ops_per_call": bit, "add_ops_per_call": add,
                "sm_clock_hz": 2e9}
    calls = 132 * 1000
    want = calls * want_cycles / 132 / 2e9 * 1e3
    assert cs.hash_ms(calls, per_call) == pytest.approx(want, rel=1e-12)


def test_hash_ms_is_the_roofline_hash_term():
    """At the SASS counts the library assumes, chip_smoke's hash time and
    `launch.roofline`'s are one number, so both give one bound."""
    from repro_torch.launch import roofline

    cs = _chip_smoke()
    per_call = {"bit_ops_per_call": roofline.HASH_BIT_OPS,
                "add_ops_per_call": roofline.HASH_ADD_OPS,
                "sm_clock_hz": roofline.SM_CLOCK_HZ}
    assert (cs.SMS, cs.ALU_LANES, cs.ISSUE_LANES) == (
        roofline.SMS, roofline.ALU_LANES, roofline.ISSUE_LANES)
    assert (cs.HBM_BYTES_PER_S, cs.FP32_FLOPS) == (roofline.HBM_BW,
                                                   roofline.PEAK_FLOPS)
    for calls in (451_584, 3_612_672):
        assert cs.hash_ms(calls, per_call) == pytest.approx(
            roofline.hash_seconds(calls) * 1e3, rel=1e-12)


@pytest.mark.parametrize("entry", ["k3", "k4", "k3_lanes", "k4_lanes", "k5",
                                   "k6"])
def test_profile_counts_agree_with_kernel_cost(entry, monkeypatch):
    """The profile phase's check at 8 chains on the CPU twins: the bytes
    `timing` counts from the tensors and the threefry calls the twins'
    walks need equal `kernel_cost`'s counts of the same launch."""
    import torch

    cs = _chip_smoke()
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "CHAINS", 8)
    c = cs.COUNTS[entry](torch)
    cost = c["cost"]
    assert cost.hbm_bytes == c["bytes"]
    assert cost.hash_calls == pytest.approx(c["threefry_calls"], rel=0.01)
    assert c["threefry_calls"] > 0


def test_bound_names_what_sets_it():
    cs = _chip_smoke()
    ms, by = cs.bound(3.35e9, 0.0)  # 1 ms of bytes, no operations
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    ms, by = cs.bound(3.35e9, 0.0, int_ms=2.0)
    assert (ms, by) == (2.0, "operations")
    ms, by = cs.bound(0.0, 67e9)  # 1 ms of float32 operations
    assert (ms, by) == (pytest.approx(1.0), "operations")


# the shape of `nvcc -Xptxas -v` output: K1's template instances in the
# anonymous namespace of ky_sampler.cu, and a plain kernel beside them
PTXAS_LOG = """
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__496cbd7e_13_ky_sampler_cu_03bb7e9716ky_planes_kernelILi4ENS_7FromKeyEEEvPKiT0_iiiiNS_3OutE' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__496cbd7e_13_ky_sampler_cu_03bb7e9716ky_planes_kernelILi4ENS_7FromKeyEEEvPKiT0_iiiiNS_3OutE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 87 registers, used 0 barriers, 32384 bytes smem
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__496cbd7e_13_ky_sampler_cu_03bb7e9715ky_lanes_kernelILi8ENS_10FromMemoryEEEvPKiT0_iiiiNS_3OutE' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__496cbd7e_13_ky_sampler_cu_03bb7e9715ky_lanes_kernelILi8ENS_10FromMemoryEEEvPKiT0_iiiiNS_3OutE
    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__496cbd7e_13_ky_sampler_cu_03bb7e9721threefry_words_kernelEjjyyPi' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__496cbd7e_13_ky_sampler_cu_03bb7e9721threefry_words_kernelEjjyyPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 14 registers, used 0 barriers
"""


def test_ptxas_entries_names_k1_instances_and_their_spills():
    cs = _chip_smoke()
    assert cs.ptxas_entries(PTXAS_LOG, cs.K1_KERNEL) == [
        {"function": "ky_planes_kernel<4, FromKey>", "stack_bytes": 0,
         "spill_store_bytes": 0, "spill_load_bytes": 0, "registers": 87},
        {"function": "ky_lanes_kernel<8, FromMemory>", "stack_bytes": 16,
         "spill_store_bytes": 8, "spill_load_bytes": 4, "registers": 255},
    ]
    assert cs.ptxas_entries(PTXAS_LOG, "bn_") == []


def test_runtime_trace_forms_the_four_buckets():
    """The serve_runtime phase's queries: 8 pigs queries sharing one
    observed-node set, 2 hailfinder, 2 pinned and 2 unpinned Penguin, all
    at 1,024 chains x 200 sweeps; under the phase's engine config they
    fall into 4 fused buckets, the unpinned Penguin one on the sharded
    route."""
    from repro_torch.compile import ir
    from repro_torch.runtime import bucket_key

    cs = _chip_smoke()
    models, queries = cs._runtime_trace()
    cfg = cs._runtime_config(slice_iters=cs.RUNTIME_SLICE)
    assert cfg.fused and cfg.max_batch == 8
    assert len(queries) == 14
    assert all(q.n_chains == 1024 and q.n_iters == 200 for q in queries)
    graphs = {m: ir.canonicalize(g, evidence_mode="runtime")
              for m, g in models.items()}
    keys = {}
    for q in queries:
        k = bucket_key(q, graphs[q.model], cfg.backend, cfg.slice_iters,
                       fused=True)
        assert k.fused and k.n_iters == cs.RUNTIME_SLICE
        keys.setdefault(k, []).append(q)
    sizes = sorted((qs[0].model, len(qs), k.has_pins)
                   for k, qs in keys.items())
    assert sizes == [("hailfinder", 2, False), ("penguin", 2, False),
                     ("penguin", 2, True), ("pigs", 8, False)]
    pigs = [q for q in queries if q.model == "pigs"]
    assert len({tuple(sorted(q.evidence)) for q in pigs}) == 1
    assert 5 <= len(pigs[0].evidence) <= 20
    assert len({q.seed for q in queries}) == len(queries)
    pinned = [q for q in queries if q.model == "penguin" and q.evidence]
    assert [len(q.evidence) for q in pinned] == [cs.MRF_PINS] * 2
