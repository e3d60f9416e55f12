"""The port's sharded-slice kernels against the reference on the same
inputs: K5's twin (`bn_gibbs.fused_color_round_ref`) against the
reference's Pallas `fused_color_round` and K6's twin
(`mrf_gibbs.mrf_halo_half_step_ref`) against its Pallas
`mrf_halo_half_step_kernel`, both interpreted on the CPU; the port's
sharded round step against its single-device one; and, on a card, K5 and
K6 against their twins.

Inputs (chain values, labels, halo rows, random words) come from numpy
seeds, and each package gets the same arrays.  K5 runs every round and
every position of `build_sharded_fused_rounds` at 1, 3 and 4 node
positions (so pad lanes appear), on `random_bayesnet(12, seed=3)` and the
alarm replica.  K6 runs slabs of 5, 12 and 16 rows, V in {3, 4, 8},
Potts and quadratic costs, both parities, even and odd global row offsets,
halo rows holding -1.  Tolerance: bit-equal (lut_ky)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compile import clear_program_cache as r_clear
from repro.compile import compile_graph as r_compile_graph
from repro.core import distributed as r_dist
from repro.core import graphs as r_graphs
from repro.core import interp as r_interp
from repro.kernels import bn_gibbs as r_bg
from repro.kernels import mrf_gibbs as r_mg
from repro_torch import convert, prng
from repro_torch.core import bayesnet as t_bn
from repro_torch.core import distributed as t_dist
from repro_torch.core import interp as t_interp
from repro_torch.core.graphs import GridMRF as TGrid
from repro_torch.core.mapping import MeshPlacement
from repro_torch.kernels import bn_gibbs as t_bg
from repro_torch.kernels import mrf_gibbs as t_mg

NETS = {
    "random12": lambda: r_graphs.random_bayesnet(12, seed=3),
    "alarm": lambda: r_graphs.bn_repository_replica("alarm"),
}


def _nets(name):
    """(reference cbn, port cbn on the CPU, reference placement, port
    placement): the port's net and placement are the reference's arrays."""
    r_clear()
    prog = r_compile_graph(NETS[name]())
    r_cbn = prog.cbn
    arrays, meta = convert.reference_bn_arrays(r_cbn)
    t_cbn = convert.from_reference_bn(arrays, meta, device="cpu")
    t_place = MeshPlacement(np.array(prog.placement.placement),
                            tuple(prog.placement.mesh_shape))
    return r_cbn, t_cbn, prog.placement, t_place


@functools.lru_cache(maxsize=None)
def _r_color_round(spec, v_max, n_words, precision, total_steps):
    return jax.jit(functools.partial(
        r_bg.fused_color_round, sampler="lut_ky", exp_spec=spec, v_max=v_max,
        n_words=n_words, weight_bits=8, precision=precision,
        total_steps=total_steps, interpret=True,
    ))


@pytest.mark.parametrize("n_dev", [1, 3, 4])
@pytest.mark.parametrize("name", list(NETS))
def test_k5_twin_matches_reference_color_round(name, n_dev):
    r_cbn, t_cbn, r_place, t_place = _nets(name)
    r_sfr = r_dist.build_sharded_fused_rounds(r_cbn, r_cbn.groups, n_dev,
                                              r_place)
    t_sfr = t_dist.build_sharded_fused_rounds(t_cbn, t_cbn.groups, n_dev,
                                              t_place)
    # the same ownership: owned lanes first, pads after them (the
    # reference marks a pad with node id n_nodes, the port with -1)
    r_nodes = np.asarray(r_sfr.nodes)
    own = r_nodes < r_cbn.n_nodes
    np.testing.assert_array_equal(
        t_sfr.nodes.numpy(), np.where(own, r_nodes, -1))
    np.testing.assert_array_equal(t_sfr.n_own_t.numpy(), own.sum(-1))
    for f in ("cards", "base", "stride", "scope_var", "is_self", "word_pos"):
        np.testing.assert_array_equal(
            getattr(t_sfr, f).numpy(), np.asarray(getattr(r_sfr, f)), f)
    if n_dev > 1:
        assert (~own).any()  # pad lanes are exercised

    p = t_bg.sweep_params(t_cbn, "lut_ky")
    kern = _r_color_round(r_cbn.exp_spec, p.v_max, p.n_words, p.precision,
                          p.total_steps)
    logf = jnp.reshape(r_cbn.log_flat, (1, -1))
    tab = jnp.reshape(r_cbn.exp_table, (1, -1)).astype(jnp.float32)
    rng = np.random.default_rng(n_dev)
    n_chains, b_loc, chain0 = 6, 3, 3
    cards = np.asarray(r_cbn.cards)
    word_pos = np.asarray(r_sfr.word_pos)
    for r, nc in enumerate(t_sfr.n_c):
        words = rng.integers(0, 2**32, (n_chains, nc, p.n_words),
                             dtype=np.uint64).astype(np.uint32)
        vals = (rng.integers(0, 1 << 20, (b_loc, r_cbn.n_nodes))
                % cards).astype(np.int32)
        words_t = torch.from_numpy(words.view(np.int32).reshape(-1))
        for d in range(n_dev):
            sl = (d, r)
            wr = words[chain0:chain0 + b_loc][:, word_pos[sl]]
            want = np.asarray(kern(
                jnp.asarray(vals), r_sfr.nodes[sl], r_sfr.cards[sl],
                r_sfr.base[sl], r_sfr.stride[sl], r_sfr.scope_var[sl],
                r_sfr.is_self[sl], jnp.asarray(wr), logf, tab))
            got = t_bg.fused_color_round(
                t_cbn, t_sfr, d, r, torch.from_numpy(vals), words_t, chain0,
                "lut_ky", p).numpy()
            np.testing.assert_array_equal(got, want, f"round {r} pos {d}")
            owned = r_nodes[sl][own[sl]]
            rest = np.setdiff1d(np.arange(r_cbn.n_nodes), owned)
            np.testing.assert_array_equal(got[:, rest], vals[:, rest])


# (slab rows, width, labels, data cost)
K6_CASES = [
    (5, 7, 3, "potts"),
    (12, 9, 4, "quadratic"),
    (16, 8, 8, "potts"),
    (5, 6, 8, "quadratic"),
]


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize(
    "case", K6_CASES, ids=[f"h{h}-w{w}-V{v}-{c}" for h, w, v, c in K6_CASES])
def test_k6_twin_matches_reference_halo_kernel(case, parity):
    h_loc, width, v, cost = case
    row0s = (0, 7, 10)  # even and odd global offsets
    tm = TGrid(max(row0s) + h_loc, width, v, theta=1.3, h=1.7,
               data_cost=cost)
    r_tab, r_spec = r_interp.build_exp_weight_lut()
    t_tab, t_spec = t_interp.build_exp_weight_lut(device="cpu")
    p = t_mg.half_step_params(tm)
    rng = np.random.default_rng(h_loc * 10 + parity)
    b = 3
    for row0 in row0s:
        labels = rng.integers(0, v, (b, h_loc, width)).astype(np.int32)
        up = rng.integers(-1, v, (b, width)).astype(np.int32)
        down = rng.integers(-1, v, (b, width)).astype(np.int32)
        up[0] = -1  # a chain at the grid's top border
        down[-1] = -1
        ev = rng.integers(0, v, (h_loc, width)).astype(np.int32)
        words = rng.integers(0, 2**32, (b, h_loc, width, p.n_words),
                             dtype=np.uint64).astype(np.uint32)
        got = t_mg.mrf_halo_half_step(
            tm, torch.from_numpy(labels), torch.from_numpy(up),
            torch.from_numpy(down), row0, torch.from_numpy(ev),
            torch.from_numpy(words.view(np.int32)), parity, t_tab, t_spec,
            p).numpy()
        for c in range(b):
            want = np.asarray(r_mg.mrf_halo_half_step_kernel(
                jnp.asarray(labels[c]), jnp.asarray(up[c:c + 1]),
                jnp.asarray(down[c:c + 1]),
                jnp.full((1, 1), row0, jnp.int32), jnp.asarray(ev),
                jnp.asarray(words[c].reshape(h_loc, -1)),
                jnp.reshape(r_tab, (1, -1)).astype(jnp.float32),
                parity=parity, theta=tm.theta, h=tm.h, n_labels=v,
                spec=r_spec, data_cost=cost, precision=p.precision,
                block_h=h_loc, interpret=True))
            np.testing.assert_array_equal(got[c], want, f"row0 {row0}")
        active = ((row0 + np.arange(h_loc))[:, None]
                  + np.arange(width)[None]) % 2 == parity
        np.testing.assert_array_equal(got[:, ~active], labels[:, ~active])


@pytest.mark.parametrize("mesh", [(1, 1), (2, 3), (3, 5)])
def test_sharded_round_step_equals_single_device_round(mesh):
    """A 15-row grid over 3 or 5 row slabs puts slabs at odd global rows;
    every mesh gives the single-device round's labels."""
    tm = TGrid(15, 9, 4, theta=1.2, h=2.0)
    tab, spec = t_interp.build_exp_weight_lut(device="cpu")
    rng = np.random.default_rng(5)
    labels = torch.from_numpy(rng.integers(0, 4, (6, 15, 9)).astype(np.int32))
    ev = torch.from_numpy(rng.integers(0, 4, (15, 9)).astype(np.int32))
    for parity in (0, 1):
        k = prng.key(30 + parity)
        want = t_mg.mrf_round_step(tm, labels, ev, k, parity, tab, spec)
        up, down = t_dist._halo_exchange(labels, mesh[1])
        got = t_mg.mrf_sharded_round_step(
            tm, labels, ev, k, parity, tab, spec, n_chain_pos=mesh[0],
            n_row_pos=mesh[1], up_halo=up, down_halo=down)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_k5_and_k6_match_their_twins_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    dev = torch.device("cuda")
    for name in NETS:
        _, t_cbn, _, t_place = _nets(name)
        arrays, meta = convert.reference_bn_arrays(t_cbn)
        cbn = convert.from_reference_bn(arrays, meta, device=dev)
        for n_dev in (1, 3, 4):
            sfr = t_dist.build_sharded_fused_rounds(cbn, cbn.groups, n_dev,
                                                    t_place)
            for sampler in ("lut_ky", "exact_ky"):
                p = t_bg.sweep_params(cbn, sampler)
                vals, _ = t_bn.init_chain_values(cbn, prng.key(1), 64)
                for r, nc in enumerate(sfr.n_c):
                    words = prng.bits(prng.key(2 + r), (64 * nc * p.n_words,),
                                      dev)
                    for d in range(n_dev):
                        got = t_bg.fused_color_round(
                            cbn, sfr, d, r, vals[32:], words, 32, sampler, p)
                        want = t_bg.fused_color_round_ref(
                            cbn, sfr, d, r, vals[32:], words, 32, sampler, p)
                        if sampler == "lut_ky":
                            assert torch.equal(got, want)
                        else:  # exp on the card may round another way
                            assert (got != want).float().mean() < 0.01
    tab, spec = t_interp.build_exp_weight_lut(device=dev)
    for h_loc, width, v, cost in K6_CASES:
        tm = TGrid(3 * h_loc, width, v, theta=1.3, h=1.7, data_cost=cost)
        p = t_mg.half_step_params(tm)
        labels = prng.randint(prng.key(3), (64, 3 * h_loc, width), 0, v, dev)
        ev = prng.randint(prng.key(4), (3 * h_loc, width), 0, v, dev)
        words = t_mg.round_words(tm, prng.key(5), 64, p, dev)
        up, down = t_dist._halo_exchange(labels, 3)
        for parity in (0, 1):
            for g in range(3):
                rs = slice(g * h_loc, (g + 1) * h_loc)
                args = (tm, labels[32:, rs], up[g, 32:], down[g, 32:],
                        g * h_loc, ev[rs], words[32:, rs], parity, tab, spec,
                        p)
                assert torch.equal(t_mg.mrf_halo_half_step(*args),
                                   t_mg.mrf_halo_half_step_ref(*args))
    torch.cuda.synchronize()
