"""The port's grid-MRF path against the reference on the same inputs: the
K4 twin against the reference's Pallas kernel (interpret mode, through
`mrf_round_step`, so the word derivation is held too) and its jitted
oracle `kernels/ref.mrf_gibbs_half_step`; the eager `half_step`,
`run_mrf_gibbs` and `compile_graph(GridMRF).run(fused=True/False)` against
the reference's; and the slice, pin and cross-check contracts.

Inputs come from numpy seeds; keys are the reference's keys carried
across.  Grids (8, 8), (15, 9) and (7, 16) cover a height that is no
multiple of the 32-row tile and odd widths; V in {2, 3, 5}; Potts and
quadratic data costs; theta/h beyond the benchmarks' 1.2/2.0.
Tolerance: bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compile import clear_program_cache as r_clear
from repro.compile import compile_graph as r_compile_graph
from repro.compile.ir import from_mrf as r_from_mrf
from repro.core import interp as r_interp
from repro.core import mrf as r_mrf
from repro.core.graphs import GridMRF as RGrid
from repro.kernels import mrf_gibbs as r_kernels
from repro.kernels import ref as r_ref
from repro_torch import convert, prng
from repro_torch.compile import backend as t_backend
from repro_torch.compile import ir as t_ir
from repro_torch.compile import program as t_program
from repro_torch.core import interp as t_interp
from repro_torch.core import mrf as t_mrf
from repro_torch.core.graphs import GridMRF as TGrid
from repro_torch.kernels import mrf_gibbs as t_kernels

# (H, W, V, data_cost, theta, h)
CASES = [
    (8, 8, 3, "potts", 1.2, 2.0),
    (15, 9, 5, "quadratic", 0.37, 1.3),
    (7, 16, 2, "potts", 2.9, 0.45),
    (8, 8, 5, "quadratic", 1.7, 0.11),
]
IDS = [f"{h}x{w}-V{v}-{c}-t{t}-h{hh}" for h, w, v, c, t, hh in CASES]


@pytest.fixture(autouse=True)
def _fresh_caches():
    t_program.clear_program_cache()
    r_clear()
    yield
    t_program.clear_program_cache()
    r_clear()


def _key(seed):
    jk = jax.random.key(seed)
    return jk, convert.key_from_reference(
        np.asarray(jax.random.key_data(jk)))


def _models(case):
    h, w, v, cost, theta, hh = case
    kw = dict(theta=theta, h=hh, data_cost=cost)
    return RGrid(h, w, v, **kw), TGrid(h, w, v, **kw)


def _inputs(case, chains=3, seed=0):
    h, w, v = case[:3]
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, v, (chains, h, w)).astype(np.int32)
    evidence = rng.integers(0, v, (h, w)).astype(np.int32)
    return labels, evidence


def _tables():
    r_tab, r_spec = r_interp.build_exp_weight_lut()
    t_tab, t_spec = t_interp.build_exp_weight_lut(device="cpu")
    return r_tab, r_spec, t_tab, t_spec


_oracle = jax.jit(
    r_ref.mrf_gibbs_half_step,
    static_argnames=("parity", "theta", "h", "n_labels", "exp_spec",
                     "data_cost", "precision", "max_retries"),
)
_r_half_step = r_mrf.half_step  # jitted by the reference itself


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k4_twin_matches_reference_kernel_and_oracle(case):
    rm, tm = _models(case)
    r_tab, r_spec, t_tab, t_spec = _tables()
    labels, evidence = _inputs(case)
    lab_t, ev_t = torch.from_numpy(labels), torch.from_numpy(evidence)
    p = t_kernels.half_step_params(tm)
    for parity in (0, 1):
        jk, k = _key(10 + parity)
        # the reference's fused round (Pallas, interpreted) from the key
        want = np.asarray(r_kernels.mrf_round_step(
            rm, jnp.asarray(labels), jnp.asarray(evidence), jk, parity,
            r_tab, r_spec, interpret=True))
        launches = t_kernels.mrf_half_step.launches
        got = t_kernels.mrf_round_step(tm, lab_t, ev_t, k, parity, t_tab,
                                       t_spec)
        assert t_kernels.mrf_half_step.launches == launches  # the twin ran
        np.testing.assert_array_equal(got.numpy(), want)
        # the twin against the jitted oracle, chain by chain, on the words
        words = t_kernels.round_words(tm, k, labels.shape[0], p, "cpu")
        for b in range(labels.shape[0]):
            want_b = np.asarray(_oracle(
                jnp.asarray(labels[b]), jnp.asarray(evidence),
                jnp.asarray(words[b].numpy().view(np.uint32)),
                parity=parity, theta=rm.theta, h=rm.h, n_labels=rm.n_labels,
                exp_table=r_tab, exp_spec=r_spec, data_cost=rm.data_cost))
            np.testing.assert_array_equal(got[b].numpy(), want_b)
        # and the port's own eager half-step draws the same labels
        eager = t_mrf.half_step(tm, lab_t, ev_t, k, parity, "lut_ky", t_tab,
                                t_spec)
        np.testing.assert_array_equal(eager.numpy(), want)


@pytest.mark.parametrize("case", CASES[:2], ids=IDS[:2])
def test_half_step_matches_reference_with_pins(case):
    rm, tm = _models(case)
    r_tab, r_spec, t_tab, t_spec = _tables()
    labels, evidence = _inputs(case, seed=4)
    pin = np.zeros(case[:2], bool)
    pin[::3, ::2] = True
    jk, k = _key(21)
    want = _r_half_step(rm, jnp.asarray(labels), jnp.asarray(evidence), jk,
                        1, "lut_ky", r_tab, r_spec, jnp.asarray(pin))
    got = t_mrf.half_step(tm, torch.from_numpy(labels),
                          torch.from_numpy(evidence), k, 1, "lut_ky", t_tab,
                          t_spec, torch.from_numpy(pin))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[:, pin], labels[:, pin])


@pytest.mark.parametrize("case", CASES[:2], ids=IDS[:2])
def test_run_mrf_gibbs_and_programs_match_reference(case):
    rm, tm = _models(case)
    _, evidence = _inputs(case, seed=7)
    jk, k = _key(5)
    kw = dict(n_chains=3, n_iters=4)
    want = np.asarray(r_mrf.run_mrf_gibbs(rm, jnp.asarray(evidence), jk,
                                          **kw))
    got = t_mrf.run_mrf_gibbs(tm, evidence, k, device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    r_prog = r_compile_graph(rm)
    t_prog = t_program.compile_graph(tm, device="cpu")
    assert t_prog.program_key == r_prog.program_key
    want_s = np.asarray(r_prog.run(jk, evidence=jnp.asarray(evidence), **kw))
    np.testing.assert_array_equal(want_s, want)
    launches = t_kernels.mrf_half_step.launches
    for fused in (True, False):
        got = t_prog.run(k, evidence=evidence, fused=fused, device="cpu",
                         **kw)
        np.testing.assert_array_equal(got.numpy(), want)
    eager = t_prog.run(k, evidence=evidence, backend="eager", device="cpu",
                       **kw)
    np.testing.assert_array_equal(eager.numpy(), want)
    assert t_kernels.mrf_half_step.launches == launches  # CPU: twins only


def test_sliced_run_equals_whole_and_pins_hold():
    case = CASES[1]
    rm, tm = _models(case)
    _, evidence = _inputs(case, seed=9)
    h, w = case[:2]
    rng = np.random.default_rng(3)
    sites = rng.choice(h * w, size=12, replace=False)
    pins = {int(s): int(rng.integers(0, case[2])) for s in sites}
    jk, k = _key(8)
    kw = dict(n_chains=4, fused=True, device="cpu")
    runtime = t_program.compile_graph(
        t_ir.canonicalize(tm, evidence_mode="runtime"), device="cpu")
    baked = t_program.compile_graph(t_ir.from_mrf(tm, pinned=pins),
                                    device="cpu")
    whole = runtime.run(k, evidence=evidence, pins=pins,
                        n_iters=7, **kw)
    _, st = runtime.run(k, evidence=evidence, pins=pins,
                        n_iters=4, return_state=True, **kw)
    assert isinstance(st, t_mrf.MRFChainState)
    sliced = runtime.run(None, evidence=evidence, pins=pins, n_iters=3,
                         carry_state=st, **kw)
    assert torch.equal(sliced, whole)
    assert torch.equal(baked.run(k, evidence=evidence, n_iters=7,
                                 **kw), whole)
    mask, vals = t_backend.pin_arrays(tm, pins, "cpu")
    assert torch.equal(whole[:, mask], vals[mask].expand(4, -1))
    unfused = runtime.run(k, evidence=evidence, pins=pins,
                          n_iters=7, n_chains=4, device="cpu")
    assert torch.equal(unfused, whole)
    # the reference's baked-pin program draws the same labels
    r_prog = r_compile_graph(r_from_mrf(rm, pinned=pins))
    want = r_prog.run(jk, evidence=jnp.asarray(evidence), n_chains=4,
                      n_iters=7)
    np.testing.assert_array_equal(whole.numpy(), np.asarray(want))


def test_mrf_run_contracts():
    tm = TGrid(6, 6, 3)
    prog = t_program.compile_graph(tm, device="cpu")
    ev = np.zeros((6, 6), np.int32)
    with pytest.raises(ValueError):
        prog.run(prng.key(0), evidence=ev, burn_in=3, device="cpu")
    with pytest.raises(ValueError):
        prog.run(prng.key(0), evidence=ev, thin=2, device="cpu")
    with pytest.raises(ValueError):
        prog.run(prng.key(0), device="cpu")  # no evidence image
    with pytest.raises(ValueError):
        prog.run(prng.key(0), evidence=np.zeros((5, 6)), device="cpu")
    with pytest.raises(ValueError):
        prog.run(prng.key(0), evidence=ev, fused=True, sampler="exact_ky",
                 device="cpu")
    baked = t_program.compile_graph(t_ir.from_mrf(tm, pinned={0: 1}),
                                    device="cpu")
    with pytest.raises(ValueError):
        baked.run(prng.key(0), evidence=ev, pins={1: 0}, device="cpu")
    with pytest.raises(TypeError):
        prog.run(None, evidence=ev, carry_state=object(), device="cpu")
    # a tampered schedule backend is caught by the first-use cross-check
    ex = t_backend.lower_schedule(prog)
    bad = t_backend.MRFScheduleExec(mrf=tm, parities=ex.parities[::-1])
    with pytest.raises(t_backend.BackendMismatch):
        t_backend.cross_check(prog, bad)
    with pytest.raises(t_backend.BackendMismatch):
        t_backend.cross_check_fused(prog, bad)


def test_total_energy_and_denoising_problem_match_reference():
    for case in CASES[:2]:
        rm, tm = _models(case)
        labels, evidence = _inputs(case, seed=2)
        want = r_mrf.total_energy(rm, jnp.asarray(labels),
                                  jnp.asarray(evidence))
        got = t_mrf.total_energy(tm, torch.from_numpy(labels),
                                 torch.from_numpy(evidence))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for args in ((16, 12, 4, 0.25, 1), (9, 9, 8, 0.4, 3)):
        for a, b in zip(r_mrf.make_denoising_problem(*args),
                        t_mrf.make_denoising_problem(*args)):
            np.testing.assert_array_equal(a, b)


# the reference's MRF benchmark widths (benchmarks/bench_mrf.py:33-34)
BENCH_GRIDS = {"penguin": (64, 64, 4, "potts"), "art": (48, 48, 8, "potts")}


@pytest.mark.parametrize("name", list(BENCH_GRIDS))
def test_site_word_index_addresses_the_round_words(name):
    """K4 reads word j of active site (chain, r, c) at counter
    `site_word_index(chain, r, c, H, W, n_words) + j` of the half-step's
    stream: indexed that way out of `prng.bits` over a flat counter range,
    the words equal `round_words`, element for element."""
    h, w, v, cost = BENCH_GRIDS[name]
    tm = TGrid(h, w, v, theta=1.2, h=2.0, data_cost=cost)
    p = t_kernels.half_step_params(tm)
    chains = 2
    key = prng.key(17)
    words = t_kernels.round_words(tm, key, chains, p, "cpu")
    stream = prng.bits(key, (chains * h * w * p.n_words,), "cpu")
    b, r, c, j = np.meshgrid(np.arange(chains), np.arange(h), np.arange(w),
                             np.arange(p.n_words), indexing="ij")
    idx = t_kernels.site_word_index(b, r, c, h, w, p.n_words) + j
    np.testing.assert_array_equal(stream.numpy()[idx], words.numpy())


@pytest.mark.parametrize("case", CASES + [(*BENCH_GRIDS["art"], 1.2, 2.0)],
                         ids=IDS + ["art"])
def test_keyed_mrf_half_step_is_the_twin_on_that_keys_words(case):
    """`mrf_half_step` takes the half-step's key; on CPU tensors it is the
    twin run on `round_words` of that key, and launches nothing."""
    _, tm = _models(case)
    _, _, t_tab, t_spec = _tables()
    labels, evidence = _inputs(case, chains=2, seed=6)
    lab_t, ev_t = torch.from_numpy(labels), torch.from_numpy(evidence)
    p = t_kernels.half_step_params(tm)
    launches = t_kernels.mrf_half_step.launches
    for parity in (0, 1):
        key = prng.key(40 + parity)
        got = t_kernels.mrf_half_step(tm, lab_t, ev_t, key, parity, t_tab,
                                      t_spec, p)
        words = t_kernels.round_words(tm, key, 2, p, "cpu")
        want = t_kernels.mrf_half_step_ref(tm, lab_t, ev_t, words, parity,
                                           t_tab, t_spec, p)
        assert torch.equal(got, want)
    assert t_kernels.mrf_half_step.launches == launches
    with pytest.raises(TypeError):
        t_kernels.mrf_half_step(tm, lab_t, ev_t, words, 0, t_tab, t_spec, p)


@pytest.mark.cuda
def test_k4_matches_its_twin_on_the_card():
    """K4 hashes its words from the half-step's key; the twin runs on the
    same key's `round_words`.  Bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    dev = torch.device("cuda")
    tab, spec = t_interp.build_exp_weight_lut(device=dev)
    for case in CASES + [(*BENCH_GRIDS["penguin"], 1.2, 2.0)]:
        _, tm = _models(case)
        labels, evidence = _inputs(case, chains=64)
        lab = torch.from_numpy(labels).to(dev)
        ev = torch.from_numpy(evidence).to(dev)
        p = t_kernels.half_step_params(tm)
        for parity in (0, 1):
            key = prng.key(parity)
            got = t_kernels.mrf_half_step(tm, lab, ev, key, parity, tab,
                                          spec, p)
            words = t_kernels.round_words(tm, key, 64, p, dev)
            want = t_kernels.mrf_half_step_ref(tm, lab, ev, words, parity,
                                               tab, spec, p)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
