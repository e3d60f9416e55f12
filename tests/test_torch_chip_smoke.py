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


K3_K6_LOG = """
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__a9d8ca57_11_bn_gibbs_cu_03bb7e9715bn_lanes_kernelILi3ELb1ELi32EEEvNS_9LanesArgsE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers, 600 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__a9d8ca57_11_bn_gibbs_cu_03bb7e9716bn_rounds_kernelILi128EEEvNS_10RoundsArgsE' for 'sm_90a'
    192 bytes stack frame, 344 bytes spill stores, 340 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__c70cf027_12_mrf_gibbs_cu_03bb7e9716mrf_lanes_kernelILi5ELb1EEEvNS_9LanesArgsE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__496cbd7e_13_ky_sampler_cu_03bb7e9721threefry_words_kernelEjjyyPi' for 'sm_90a'
ptxas info    : Used 14 registers, used 0 barriers
"""


def test_template_instances_names_k3_k6_instances_and_their_spills():
    cs = _chip_smoke()
    assert cs.template_instances(K3_K6_LOG) == [
        {"function": "bn_lanes_kernel<3, 1, 32>", "stack_bytes": 0,
         "spill_store_bytes": 0, "spill_load_bytes": 0, "registers": 56},
        {"function": "bn_rounds_kernel<128>", "stack_bytes": 192,
         "spill_store_bytes": 344, "spill_load_bytes": 340,
         "registers": 255},
        {"function": "mrf_lanes_kernel<5, 1>", "stack_bytes": 0,
         "spill_store_bytes": 0, "spill_load_bytes": 0, "registers": 40},
    ]


class _Row:
    def __init__(self, key, us, count):
        self.key, self.device_time_total, self.count = key, us, count


def test_device_ms_averages_the_recorded_launches(monkeypatch):
    """A named kernel's device ms a call is the mean of the launches the
    profiler recorded, times the launches a call: a window that missed
    its first launches still reads a launch's time.  "" sums every kernel
    of `reps` calls."""
    cs = _chip_smoke()
    rows = [_Row("void bn_lanes_kernel<3, true, 32>(LanesArgs)", 300.0, 3),
            _Row("elementwise_kernel", 999.0, 10)]
    monkeypatch.setattr(cs, "profiled_kernels", lambda torch, fn, reps: rows)
    assert cs.device_ms(None, None, 10, "bn_lanes_kernel") == 0.1
    assert cs.device_ms(None, None, 10, "bn_lanes_kernel",
                        launches=4) == 0.4
    assert cs.device_ms(None, None, 10, "") == (300.0 + 999.0) / 10 / 1e3
    assert cs.device_ms(None, None, 10, "mrf_lanes_kernel") is None


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


def test_lm_bounds_count_yi_9b():
    """The serve_lm phase's bounds at yi-9b, B = 8, worked by hand: the
    projections, head, table and norms make the model's 8,829,407,232
    parameters; a prefill of 128 tokens needs 1.7064e13 operations
    (17.25 ms at the bf16 peak), a decode step at position 158 moves
    17,263,263,744 bytes (5.15 ms at 3.35 TB/s)."""
    from repro_torch.configs import get_config

    cs = _chip_smoke()
    cfg = get_config("yi-9b")
    proj = 48 * (4096 * 128 * (2 * 32 + 2 * 4) + 3 * 4096 * 11008)
    assert cs.lm_matmul_params(cfg) == proj == 8_304_721_920
    assert proj + 2 * 4096 * 64000 + 97 * 4096 == 8_829_407_232
    # projections for 1,024 tokens, causal attention over 8,256 pairs a
    # head, the head for the 8 last positions
    attn = 4 * 128 * 32 * 48 * (128 * 129 // 2) * 8
    head = 2 * 4096 * 64000 * 8
    assert cs.lm_prefill_flops(cfg, 8, 128) == 2 * proj * 1024 + attn + head
    assert cs.lm_prefill_flops(cfg, 8, 128) == 17_064_207_056_896
    weight_bytes = 2 * (proj + 2 * 4096 * 64000) + 4 * 97 * 4096
    kv_row = 48 * 2 * 8 * 4 * 128 * 2  # one position of K and V, bf16
    got = cs.lm_step_bytes(weight_bytes, 2 * 64000 * 4096, cfg, 8,
                           kv_row * 159, kv_row, 8)
    assert got == 17_263_263_744
    ms, by = cs.bound(got, cs.lm_decode_flops(cfg, 8, 159), cs.BF16_FLOPS)
    assert by == "bytes" and ms == pytest.approx(5.1532, abs=1e-4)
    ms, by = cs.bound(weight_bytes, cs.lm_prefill_flops(cfg, 8, 128),
                      cs.BF16_FLOPS)
    assert by == "operations" and ms == pytest.approx(17.254, abs=1e-3)


# the reduced() configs, counted by hand: (projections every token
# multiplies, expert multiply-adds of a prefill of 2 x 8 tokens and of a
# decode step at B = 2, recurrent operations of the same prefill and step)
REDUCED_COUNTS = {
    # 2 layers: attention 64 x 16 x (8 + 8) = 16,384; router 64 x 4 and
    # shared SwiGLU 3 x 64 x 64 = 12,544.  Experts: a row's 8 tokens take
    # capacity 8, a decode group of 2 capacity 4: 2 rows x 4 experts x 8
    # slots x 3 x 64 x 64 a layer, and 1 x 4 x 4 x 12,288
    "qwen2-moe-a2.7b": (57_856, 1_572_864, 393_216, 0.0, 0.0),
    # 6 mLSTM (3 x 64 x 64 + 2 x 64 x 4 + 2 x 64 x 64 = 20,992) and 2
    # sLSTM (4 x 64 x 64 + 4 x 4 x 16 x 16 + 64 x 64 = 24,576); the matrix
    # memory 4 x 4 x 16^2 a token an mLSTM layer, one chunk of 8 (36
    # causal pairs) at 6 x 4 x 16 a pair
    "xlstm-350m": (175_104, 0, 0, 393_216.0 + 165_888.0, 49_152.0),
    # 7 Mamba (64 x 256 + 128 x 20 + 4 x 128 + 128 x 64 = 27,648), one
    # attention (64 x 16 x 12 = 12,288), 4 dense SwiGLU (3 x 64 x 128) and
    # 4 routers (64 x 4); 4 MoE layers of 2 x 4 x 8 slots; the scan 6 x
    # 128 x 8 a token a Mamba layer
    "jamba-1.5-large-398b": (305_152, 3_145_728, 786_432, 688_128.0,
                             86_016.0),
}


@pytest.mark.parametrize("arch", sorted(REDUCED_COUNTS))
def test_lm_bounds_count_moe_and_recurrent_mixers(arch):
    from repro_torch.configs import get_config

    cs = _chip_smoke()
    cfg = get_config(arch).reduced()
    mm, pre_macs, dec_macs, pre_rec, dec_rec = REDUCED_COUNTS[arch]
    assert cs.lm_matmul_params(cfg) == mm
    assert cs.lm_expert_macs(cfg, 2, 8) == pre_macs
    assert cs.lm_expert_macs(cfg, 2, 1) == dec_macs
    assert cs.lm_recurrent_flops(cfg, 2, 8) == pre_rec
    assert cs.lm_recurrent_flops(cfg, 2, 1) == dec_rec
    n_attn = sum(k.startswith("attn") for k in cfg.pattern) * cfg.n_super
    attn = 4 * 16 * 4 * n_attn * 36 * 2
    assert cs.lm_prefill_flops(cfg, 2, 8) == (
        2 * mm * 16 + 2 * pre_macs + attn + pre_rec + 2 * 64 * 256 * 2)
    assert cs.lm_decode_flops(cfg, 2, 9) == (
        2 * (mm + 64 * 256) * 2 + 2 * dec_macs + 4 * 16 * 4 * n_attn * 9
        * 2 + dec_rec)
    assert cs.token_levels(cfg.vocab) == 2


def test_lm_bounds_of_qwen2_moe_at_full_width():
    """The serve_lm_moe phase's bound: a prefill of 8 x 128 tokens
    multiplies 60 experts x 12 slots a row at 3 x 2,048 x 1,408 a slot in
    each of 24 layers, beside the attention, router and shared expert;
    a decode step reads every expert's weights."""
    from repro_torch.configs import get_config

    cs = _chip_smoke()
    cfg = get_config("qwen2-moe-a2.7b")
    per_layer = 2048 * 128 * 64 + 2048 * 60 + 3 * 2048 * 5632
    assert cs.lm_matmul_params(cfg) == 24 * per_layer
    assert cs.lm_expert_macs(cfg, 8, 128) == 24 * 8 * 60 * 12 * 3 * 2048 \
        * 1408
    assert cs.lm_expert_macs(cfg, 8, 1) == 24 * 60 * 4 * 3 * 2048 * 1408
    flops = cs.lm_prefill_flops(cfg, 8, 128)
    assert 4.9e12 < flops < 5.0e12  # 4.96 TFLOP: 5.0 ms at 989 TFLOP/s
    assert [cs.token_levels(v) for v in (151_936, 50_304, 64_000, 256)] \
        == [3, 3, 3, 2]


@pytest.mark.parametrize("b,s", [(2, 16), (16, 1), (1, 1)])
def test_moe_row_drops_counts_each_rows_dropped_assignments(b, s):
    """The drops the LM phases print per row: a prefill row's own dropped
    assignments, and in a decode step over several rows (one group) those
    of each row's token; the inputs lean towards two experts."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod

    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(),
                              dtype="float32")
    router = moe_mod.init_moe(torch.Generator().manual_seed(0), cfg,
                              cfg.moe, torch.device("cpu"))["router"]
    x = torch.randn((b, s, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    x = x + 3.0 * (router[:, 0] + router[:, 1]) * cfg.d_model ** 0.5
    got = cs.moe_row_drops(torch, moe_mod, x, router, cfg.moe)
    r = moe_mod.route(moe_mod.groups(x), router, cfg.moe)
    if s == 1 and b > 1:
        want = torch.bincount(r.stok[~r.keep], minlength=b)
    else:
        want = (~r.keep).sum(-1)
    assert got.tolist() == want.tolist()
    assert (got.sum() > 0) == (b * s > 1)


def test_main_runs_every_lm_phase_and_ends_with_the_device_line():
    """chip_smoke's main drives the LM phases after `profile` (yi-9b, then
    qwen2-moe, xlstm, jamba at reduced(), the Mamba block, the MoE block,
    then training: train_lm and train_block), `timing` last; the last
    line is the device JSON."""
    import inspect

    cs = _chip_smoke()
    src = inspect.getsource(cs.main)
    order = ["phase_profile", "phase_serve_lm,", "phase_serve_lm_moe",
             "phase_serve_lm_xlstm", "phase_serve_lm_hybrid",
             "phase_mamba_block", "phase_moe_block", "phase_train_lm",
             "phase_train_block", "phase_timing"]
    where = [src.index(name) for name in order]
    assert where == sorted(where)
    assert (cs.LM_MOE_ARCH, cs.LM_XLSTM_ARCH, cs.LM_HYBRID_ARCH) == (
        "qwen2-moe-a2.7b", "xlstm-350m", "jamba-1.5-large-398b")
    tail = src[src.index('emit({"phase": "done"'):]
    assert tail.index("print(card)") < tail.index('emit({"ok": True')
    assert '"platform": "gpu"' in tail and "get_device_name(0)" in tail \
        and "device_count()" in tail


@pytest.mark.parametrize("arch", ["yi-9b", "qwen2-moe-a2.7b"])
def test_lm_train_flops_is_three_forwards_over_every_position(arch):
    """train_lm's bound counts three times a forward whose head runs at
    every position: the prefill's count (head at the last position only)
    plus the head over the other positions, times three; and AdamW's
    bytes are three reads and two writes of float32 leaves' size (leaf,
    grad, m, v read; leaf, m, v written: 28 bytes a parameter)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw

    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config(arch), n_layers=cs.TRAIN_LAYERS[
        arch])
    b, s = cs.TRAIN_BATCH, cs.TRAIN_SEQ
    head_rest = 2.0 * cfg.d_model * cfg.vocab * b * (s - 1)
    assert cs.lm_train_flops(cfg, b, s) == pytest.approx(
        3.0 * (cs.lm_prefill_flops(cfg, b, s) + head_rest), rel=1e-12)
    small = dataclasses.replace(cfg.reduced(), n_layers=len(cfg.pattern))
    model = tfm.init_model(small, device="cpu", train=True)
    leaves = tfm.train_leaves(model, small)
    state = adamw.init(leaves, adamw.AdamWConfig())
    n = sum(p.numel() for p in leaves.values())
    assert all(p.dtype == torch.float32 for p in leaves.values())
    assert cs.adamw_bytes(leaves, state) == 28 * n


def test_main_runs_serve_ranks_after_the_single_process_mesh():
    """serve_ranks runs after serve_sharded and before `timing`, whose
    kernels line keeps K1-K6 and both lane entries."""
    import inspect

    cs = _chip_smoke()
    src = inspect.getsource(cs.main)
    where = [src.index(n) for n in ("phase_serve_sharded,",
                                    "phase_serve_ranks", "phase_timing")]
    assert where == sorted(where)
    timing = inspect.getsource(cs.timing_sharded) + inspect.getsource(
        cs.phase_timing) + inspect.getsource(cs.timing_lanes)
    for line in ("ky_sampler.py:159", "interp_lut.py:50", "bn_gibbs.py:236",
                 "mrf_gibbs.py:159", "bn_gibbs.py:316", "mrf_gibbs.py:280"):
        assert line in inspect.getsource(cs), line
    for name in ("bn_sweep_lanes", "mrf_half_step_lanes"):
        assert name in timing, name


def test_rank_jobs_are_the_published_runs():
    cs = _chip_smoke()
    jobs = cs._rank_jobs(None)
    assert [j["name"] for j in jobs] == ["pigs", "hailfinder", "penguin",
                                         "asia_diagnostics", "pigs_sliced"]
    for j in jobs:
        assert j["kw"]["n_chains"] == 1024 and j["kw"]["n_iters"] == 200
        assert j["kw"]["fused"] and j["kw"]["backend"] == "schedule"
    assert jobs[3]["kw"]["diagnostics"]
    assert jobs[4]["slice"] == 100 and jobs[4]["seed"] == jobs[0]["seed"]
    assert cs.MRF_MODELS[jobs[2]["model"]] == (64, 64, 4, "potts")


def test_a_sliced_rank_job_equals_the_whole_run():
    """`_run_job` on the CPU at a few chains: one device, a (2, 4) mesh
    and the run sliced through its carry agree, snapshot included."""
    import numpy as np
    import torch

    from repro_torch.core import distributed

    cs = _chip_smoke()
    job = {"name": "asia", "model": "asia", "evidence": {0: 1, 5: 0},
           "seed": 4, "kw": dict(n_chains=8, n_iters=6, burn_in=2,
                                 sampler="lut_ky", backend="schedule",
                                 fused=True)}
    prog, ev = cs._rank_program(torch, job, torch.device("cpu"))
    mesh = distributed.make_mesh((2, 4), device="cpu")
    whole = cs._run_job(job, prog, ev, None)
    assert cs._same(cs._run_job(job, prog, ev, mesh), whole)
    assert cs._same(cs._run_job({**job, "slice": 3}, prog, ev, mesh), whole)
    diag = {**job, "kw": {**job["kw"], "diagnostics": True}}
    assert cs._same(cs._run_job(diag, prog, ev, mesh),
                    cs._run_job(diag, prog, ev, None))
    assert not cs._same(cs._run_job({**job, "seed": 5}, prog, ev, None),
                        whole)
    assert cs._same(np.array([np.nan, 1.0]), np.array([np.nan, 1.0]))
    assert not cs._same(torch.zeros(2, dtype=torch.int32), torch.zeros(2))


def test_lm_mesh_phases_are_registered_and_run_before_timing():
    """serve_lm_mesh runs after the one-card LM phases and train_lm_mesh
    after the one-card training ones, both before `timing`; both run
    alone through tools/chip_phases.py: yi-9b (2 layers),
    qwen2-moe-a2.7b (1), xlstm-350m (4: one period of its pattern) and
    jamba-1.5-large-398b (1: a Mamba mixer) served at full width over a
    (2, 4) mesh, 4 tokens (8 until the cut printed with them); yi-9b (2
    layers) trained at B 8 x S 512 for 3 steps."""
    import importlib.util
    import inspect

    cs = _chip_smoke()
    src = inspect.getsource(cs.main)
    order = ["phase_moe_block", "phase_serve_lm_mesh", "phase_train_lm,",
             "phase_train_block", "phase_train_lm_mesh", "phase_timing"]
    where = [src.index(name) for name in order]
    assert where == sorted(where)
    spec = importlib.util.spec_from_file_location(
        "chip_phases", ROOT / "tools" / "chip_phases.py")
    phases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(phases)
    assert {"phase_serve_lm_mesh", "phase_train_lm_mesh"} <= set(
        phases.PHASES)
    assert all(hasattr(cs, name) for name in phases.PHASES)
    assert phases.main(["phase_timing"]) == 2  # not runnable alone
    assert cs.LM_MESH == (2, 4)
    assert cs.LM_MESH_SERVE == {"yi-9b": 2, "qwen2-moe-a2.7b": 1,
                                "xlstm-350m": 4, "jamba-1.5-large-398b": 1}
    assert (cs.LM_BATCH, cs.LM_PROMPT, cs.LM_MESH_GEN) == (8, 128, 4)
    assert cs.LM_MESH_GEN_CUT == "8 -> 4"
    assert (cs.LM_MESH_TRAIN_ARCH, cs.LM_MESH_TRAIN_LAYERS,
            cs.LM_MESH_TRAIN_BATCH, cs.LM_MESH_TRAIN_SEQ,
            cs.LM_MESH_TRAIN_STEPS) == ("yi-9b", 2, 8, 512, 3)


def test_train_lm_mesh_counts_each_block_of_an_update_once():
    """`_update_gaps` sums a leaf's distinct blocks (replicas once): two
    blocks with errors 3 and 4 against updates 6 and 8, each held by two
    ranks, give 5 / 10."""
    cs = _chip_smoke()
    ranks = [{"update_sq": {"w": (block, err, upd)}}
             for block, err, upd in (("a", 9.0, 36.0), ("b", 16.0, 64.0))
             for _ in range(2)]
    assert cs._update_gaps(ranks) == {"w": pytest.approx(0.5)}


def test_lm_mesh_phases_report_collective_bytes_by_op_and_axis():
    """serve_lm_mesh and train_lm_mesh print each rank's collective bytes
    a token or a step: the growth of `collectives.BYTES` (a live Comm's
    result bytes by "<op> over <axis>") over the run, divided by the
    tokens or steps, keys that did not grow left out."""
    import inspect

    cs = _chip_smoke()
    before = {"all-gather over data": 10, "all-reduce over model": 4}
    now = {"all-gather over data": 50, "all-reduce over model": 4,
           "all-gather over model": 8}
    assert cs.collective_bytes(now, before, 8) == {
        "all-gather over data": 5.0, "all-gather over model": 1.0}
    assert "collective_bytes_per_token_ranks" in inspect.getsource(
        cs.phase_serve_lm_mesh)
    assert "collective_bytes_per_step_ranks" in inspect.getsource(
        cs.phase_train_lm_mesh)


@pytest.mark.parametrize("phase", ["phase_serve_lm_mesh",
                                   "phase_train_lm_mesh"])
def test_no_failure_of_an_lm_mesh_phase_is_caught(phase, monkeypatch,
                                                   tmp_path):
    """A rank that fails ends the phase with its error (chip_smoke then
    exits non-zero): nothing in the phases or their ranks catches it."""
    import inspect

    import torch

    from repro_torch.kernels import _lib
    from repro_torch.launch import mesh as mesh_mod

    cs = _chip_smoke()
    for fn in (cs.phase_serve_lm_mesh, cs.phase_train_lm_mesh,
               cs.rank_lm_serve, cs._rank_serve, cs._serve_single,
               cs.rank_lm_train, cs._save_zero_restore, cs._train_single,
               cs._resident):
        assert "except" not in inspect.getsource(fn), fn.__name__

    def failed(*a, **k):
        raise mesh_mod.RankFailed("rank3 exited with code 1")

    monkeypatch.setattr(mesh_mod, "spawn", failed)
    monkeypatch.setattr(_lib, "build", lambda: None)
    monkeypatch.setattr(cs, "nvidia_smi", lambda: "card, 700.00 W")
    monkeypatch.setattr(cs, "LM_MESH_DIR", tmp_path / "lm_mesh")
    with pytest.raises(mesh_mod.RankFailed, match="rank3"):
        getattr(cs, phase)(torch)
