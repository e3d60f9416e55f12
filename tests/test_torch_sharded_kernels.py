"""The port's sharded-slice kernels against the reference on the same
inputs: K5's keyed one-position entry (`bn_gibbs.fused_color_round`,
which runs its twin on CPU tensors) against the reference's Pallas
`fused_color_round` and K6's keyed entry (`mrf_gibbs.mrf_halo_half_step`)
against its Pallas `mrf_halo_half_step_kernel`, both interpreted on the
CPU, each given the rows of the key's stream; the counters K5 and K6 hash
(`bn_gibbs.owned_row_word_index`, `mrf_gibbs.site_word_index` at the
global site) against the rows' places in the round's full stream; the
all-positions entries against per-position twin calls on the round's full
words followed by the merge; the port's sharded round step against its
single-device one; and, on a card, K5 and K6 against their twins.

Inputs (chain values, labels, halo rows) come from numpy seeds, and each
package gets the same arrays and the same random words.  K5 runs every
round and every position of `build_sharded_fused_rounds` at 1, 3 and 4
node positions (so pad lanes appear), on `random_bayesnet(12, seed=3)` and
the alarm replica.  K6 runs slabs of 5, 12 and 16 rows, V in {3, 4, 8},
Potts and quadratic costs, both parities, even and odd global row
offsets, halo rows holding -1.  The counter and all-positions tests run
(1, 2), (2, 2) and (2, 4) meshes on `random_bayesnet(12, seed=3)` and a
16 x 8 grid, plus a block of rows starting at odd row 5.  Tolerance:
bit-equal (lut_ky; exact_ky too on the CPU, where kernel and twin are the
same code)."""

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
from repro_torch.compile import ir as t_ir
from repro_torch.compile import program as t_program
from repro_torch.core import bayesnet as t_bn
from repro_torch.core import distributed as t_dist
from repro_torch.core import interp as t_interp
from repro_torch.core import ky as t_ky
from repro_torch.core.graphs import GridMRF as TGrid
from repro_torch.core.graphs import random_bayesnet as t_random_bayesnet
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
    sub = prng.key(40 + n_dev)  # the sweep's key
    cards = np.asarray(r_cbn.cards)
    word_pos = np.asarray(r_sfr.word_pos)
    for r, nc in enumerate(t_sfr.n_c):
        # the reference reads the rows of round r's stream from memory
        words = t_bg.round_stream(t_sfr, sub, r, 0, n_chains, p.n_words,
                                  "cpu").numpy().view(np.uint32).reshape(
                                      n_chains, nc, p.n_words)
        vals = (rng.integers(0, 1 << 20, (b_loc, r_cbn.n_nodes))
                % cards).astype(np.int32)
        for d in range(n_dev):
            sl = (d, r)
            wr = words[chain0:chain0 + b_loc][:, word_pos[sl]]
            want = np.asarray(kern(
                jnp.asarray(vals), r_sfr.nodes[sl], r_sfr.cards[sl],
                r_sfr.base[sl], r_sfr.stride[sl], r_sfr.scope_var[sl],
                r_sfr.is_self[sl], jnp.asarray(wr), logf, tab))
            got = t_bg.fused_color_round(
                t_cbn, t_sfr, d, r, torch.from_numpy(vals), sub, chain0,
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
    b, chain0 = 3, 2  # chains [2, 5) of the half-step's stream
    key = prng.key(h_loc + 3 * parity)
    # the reference reads the block's sites' words from memory
    stream = t_mg.round_words(tm, key, chain0 + b, p, "cpu")[chain0:]
    for row0 in row0s:
        labels = rng.integers(0, v, (b, h_loc, width)).astype(np.int32)
        up = rng.integers(-1, v, (b, width)).astype(np.int32)
        down = rng.integers(-1, v, (b, width)).astype(np.int32)
        up[0] = -1  # a chain at the grid's top border
        down[-1] = -1
        ev = rng.integers(0, v, (h_loc, width)).astype(np.int32)
        words = stream[:, row0:row0 + h_loc].numpy().view(np.uint32)
        got = t_mg.mrf_halo_half_step(
            tm, torch.from_numpy(labels), torch.from_numpy(up[None]),
            torch.from_numpy(down[None]), row0, torch.from_numpy(ev), key,
            parity, t_tab, t_spec, p, chain0=chain0).numpy()
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


MESHES = [(1, 2), (2, 2), (2, 4)]


def _port_bn(n_dev):
    """`random_bayesnet(12, seed=3)` compiled by the port on the CPU, and
    its ownership table over the schedule's rounds at n_dev node
    positions."""
    prog = t_program.compile_graph(
        t_ir.from_bayesnet(t_random_bayesnet(12, seed=3)), device="cpu")
    groups = prog.schedule_executable().round_groups
    sfr = t_dist.build_sharded_fused_rounds(prog.cbn, groups, n_dev,
                                            prog.placement)
    return prog.cbn, sfr


def _hashed_words(key, counters):
    """Word i of `key`'s stream for each counter i (uint32), hashed as the
    kernels hash it: b1 ^ b2 of threefry2x32 of (i >> 32, i & 0xFFFFFFFF)."""
    i = np.asarray(counters, np.int64)
    b1, b2 = prng.threefry2x32(key.k1, key.k2, i >> 32, i & prng.MASK)
    return (b1 ^ b2).astype(np.uint32)


@pytest.mark.parametrize("mesh", MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
def test_k5_counters_are_the_rows_places_in_the_full_stream(mesh):
    """For every (position, round, owned lane, chain): the counter K5
    hashes is where the twin's row lies in the round's full stream, and
    the owned lanes of the node positions cover each round's group
    once."""
    n_ci, n_d = mesh
    cbn, sfr = _port_bn(n_d)
    p = t_bg.sweep_params(cbn, "lut_ky")
    nw, n_chains = p.n_words, 3 * n_ci
    sub = prng.key(17)
    word_pos = sfr.word_pos.numpy()
    for r, nc in enumerate(sfr.n_c):
        rk = t_bg.round_key(sub, r)
        assert rk == prng.split(sub, len(sfr.n_c))[r]
        full = t_bg.round_stream(sfr, sub, r, 0, n_chains, nw, "cpu")
        np.testing.assert_array_equal(
            full.numpy(), t_ky.random_words(rk, (n_chains * nc,), nw,
                                            "cpu").reshape(-1).numpy())
        rows = full.numpy().view(np.uint32).reshape(n_chains, nc, nw)
        places = []
        for d in range(n_d):
            k = sfr.n_own[d][r]
            places.extend(word_pos[d, r, :k])
            for c in range(k):
                for chain in range(n_chains):
                    i = t_bg.owned_row_word_index(sfr, d, r, c, chain, nw)
                    assert i == t_bg.row_word_index(
                        chain, nc, int(word_pos[d, r, c]), nw)
                    want = rows[chain, word_pos[d, r, c]]
                    np.testing.assert_array_equal(
                        rows.reshape(-1)[i:i + nw], want)
                    np.testing.assert_array_equal(
                        _hashed_words(rk, range(i, i + nw)), want)
        assert sorted(places) == list(range(nc))


@pytest.mark.parametrize("mesh", MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
def test_k6_counters_are_the_sites_places_in_the_full_stream(mesh):
    """For every site of every slab: the counter K6 hashes (the global
    chain and row) is where the twin's site lies in the single-device
    half-step's stream; and for a block of rows starting at odd row 5."""
    n_ci, n_g = mesh
    tm = TGrid(16, 8, 4)
    p = t_mg.half_step_params(tm)
    nw, b = p.n_words, 2 * n_ci
    key = prng.key(23)
    full = t_mg.round_words(tm, key, b, p, "cpu").numpy().view(np.uint32)
    b_loc, h_loc = b // n_ci, tm.height // n_g
    blocks = [(ci * b_loc, b_loc, g * h_loc, h_loc)
              for ci in range(n_ci) for g in range(n_g)]
    blocks.append((1, b - 1, 5, 8))  # chains [1, b), rows [5, 13)
    for chain0, nb, row0, hh in blocks:
        slab = full[chain0:chain0 + nb, row0:row0 + hh]
        counters = np.array([
            t_mg.site_word_index(chain0 + c, row0 + r, x, tm.height,
                                 tm.width, nw)
            for c in range(nb) for r in range(hh) for x in range(tm.width)])
        np.testing.assert_array_equal(
            full.reshape(-1)[counters[:, None] + np.arange(nw)],
            slab.reshape(-1, nw))
        np.testing.assert_array_equal(
            _hashed_words(key, (counters[:, None] + np.arange(nw)).ravel()),
            slab.reshape(-1))


@pytest.mark.parametrize("sampler", ["lut_ky", "exact_ky"])
@pytest.mark.parametrize("mesh", MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
def test_k5_all_positions_equal_per_position_calls_and_merge(mesh, sampler):
    """`fused_color_round_mesh` (one launch per round on a card) equals the
    twin per position on the round's full words, plane for plane, and so
    after `_psum_merge`; the keyed one-position entry equals its plane."""
    n_ci, n_d = mesh
    cbn, sfr = _port_bn(n_d)
    p = t_bg.sweep_params(cbn, sampler)
    n_chains = 3 * n_ci
    b_loc = n_chains // n_ci
    rng = np.random.default_rng(n_ci * 10 + n_d)
    cards = cbn.cards.numpy()
    vals = torch.from_numpy(
        (rng.integers(0, 1 << 20, (n_chains, cbn.n_nodes)) % cards).astype(
            np.int32))
    sub = prng.key(31)
    for r, nc in enumerate(sfr.n_c):
        words = t_ky.random_words(t_bg.round_key(sub, r), (n_chains * nc,),
                                  p.n_words, "cpu").reshape(-1)
        want = torch.stack([torch.cat([
            t_bg.fused_color_round_ref(cbn, sfr, d, r, vals[c0:c0 + b_loc],
                                       words, c0, sampler, p)
            for c0 in range(0, n_chains, b_loc)]) for d in range(n_d)])
        got = t_bg.fused_color_round_mesh(cbn, sfr, r, vals, sub, sampler, p,
                                          n_ci)
        assert got.shape == (n_d, n_chains, cbn.n_nodes)
        assert torch.equal(got, want), f"round {r}"
        for d in range(n_d):
            for c0 in range(0, n_chains, b_loc):
                one = t_bg.fused_color_round(
                    cbn, sfr, d, r, vals[c0:c0 + b_loc], sub, c0, sampler, p)
                assert torch.equal(one, want[d, c0:c0 + b_loc])
        merged = t_dist._psum_merge(vals, got)
        assert torch.equal(merged, t_dist._psum_merge(vals, want))
        changed = (merged != vals).any(0).nonzero().flatten().tolist()
        assert set(changed) <= set(sfr.nodes[:, r].flatten().tolist())
        vals = merged


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("mesh", MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
def test_k6_all_slabs_equal_per_slab_calls(mesh, parity):
    """`mrf_halo_half_step` over every slab (one launch on a card) equals
    the twin per slab on the half-step's full words, assembled; and so
    does a block of chains [1, B) and rows [5, 13) in two slabs (odd
    global rows) with random halo rows."""
    n_ci, n_g = mesh
    tm = TGrid(16, 8, 4, theta=1.1, h=1.9)
    tab, spec = t_interp.build_exp_weight_lut(device="cpu")
    p = t_mg.half_step_params(tm)
    b = 2 * n_ci
    rng = np.random.default_rng(n_g * 7 + parity)
    labels = torch.from_numpy(
        rng.integers(0, 4, (b, 16, 8)).astype(np.int32))
    ev = torch.from_numpy(rng.integers(0, 4, (16, 8)).astype(np.int32))
    key = prng.key(50 + parity)
    words = t_mg.round_words(tm, key, b, p, "cpu")
    up, down = t_dist._halo_exchange(labels, n_g)
    h_loc = 16 // n_g
    want = torch.cat([
        t_mg.mrf_halo_half_step_ref(
            tm, labels[:, g * h_loc:(g + 1) * h_loc], up[g], down[g],
            g * h_loc, ev[g * h_loc:(g + 1) * h_loc],
            words[:, g * h_loc:(g + 1) * h_loc], parity, tab, spec, p)
        for g in range(n_g)], dim=1)
    got = t_mg.mrf_halo_half_step(tm, labels, up, down, 0, ev, key, parity,
                                  tab, spec, p)
    assert torch.equal(got, want)
    assert torch.equal(got, t_mg.mrf_round_step(tm, labels, ev, key, parity,
                                                tab, spec))
    halo = torch.from_numpy(rng.integers(-1, 4, (2, 2, b - 1, 8)).astype(
        np.int32))
    block = labels[1:, 5:13]
    got = t_mg.mrf_halo_half_step(tm, block, halo[0], halo[1], 5, ev[5:13],
                                  key, parity, tab, spec, p, chain0=1)
    want = torch.cat([
        t_mg.mrf_halo_half_step_ref(
            tm, block[:, 4 * g:4 * g + 4], halo[0, g], halo[1, g], 5 + 4 * g,
            ev[5 + 4 * g:9 + 4 * g], words[1:, 5 + 4 * g:9 + 4 * g], parity,
            tab, spec, p)
        for g in range(2)], dim=1)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_k5_and_k6_match_their_twins_on_the_card():
    """The keyed K5 (all positions in one launch, and one position) and
    K6 (all slabs in one launch, and a block at odd rows) against their
    twins on the key's words: lut_ky bit-equal, exact_ky within 1% of
    labels (exp on the card may round another way)."""
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
                sub = prng.key(2)
                for r in range(len(sfr.n_c)):
                    words = t_bg.round_stream(sfr, sub, r, 0, 64, p.n_words,
                                              dev)
                    got = t_bg.fused_color_round_mesh(cbn, sfr, r, vals, sub,
                                                      sampler, p, 2)
                    want = torch.stack([torch.cat([
                        t_bg.fused_color_round_ref(
                            cbn, sfr, d, r, vals[c0:c0 + 32], words, c0,
                            sampler, p) for c0 in (0, 32)])
                        for d in range(n_dev)])
                    one = t_bg.fused_color_round(cbn, sfr, n_dev - 1, r,
                                                 vals[32:], sub, 32, sampler,
                                                 p)
                    if sampler == "lut_ky":
                        assert torch.equal(got, want)
                        assert torch.equal(one, want[-1, 32:])
                    else:
                        assert (got != want).float().mean() < 0.01
                        assert (one != want[-1, 32:]).float().mean() < 0.01
    tab, spec = t_interp.build_exp_weight_lut(device=dev)
    for h_loc, width, v, cost in K6_CASES:
        tm = TGrid(3 * h_loc, width, v, theta=1.3, h=1.7, data_cost=cost)
        p = t_mg.half_step_params(tm)
        labels = prng.randint(prng.key(3), (64, 3 * h_loc, width), 0, v, dev)
        ev = prng.randint(prng.key(4), (3 * h_loc, width), 0, v, dev)
        key = prng.key(5)
        words = t_mg.round_words(tm, key, 64, p, dev)
        up, down = t_dist._halo_exchange(labels, 3)
        for parity in (0, 1):
            got = t_mg.mrf_halo_half_step(tm, labels, up, down, 0, ev, key,
                                          parity, tab, spec, p)
            for g in range(3):
                rs = slice(g * h_loc, (g + 1) * h_loc)
                want = t_mg.mrf_halo_half_step_ref(
                    tm, labels[:, rs], up[g], down[g], g * h_loc, ev[rs],
                    words[:, rs], parity, tab, spec, p)
                assert torch.equal(got[:, rs], want)
            # one slab of chains [32, 64) at odd rows [1, 1 + h_loc)
            rs = slice(1, 1 + h_loc)
            halo = prng.randint(prng.key(6), (2, 1, 32, width), -1, v, dev)
            got = t_mg.mrf_halo_half_step(tm, labels[32:, rs], halo[0],
                                          halo[1], 1, ev[rs], key, parity,
                                          tab, spec, p, chain0=32)
            want = t_mg.mrf_halo_half_step_ref(
                tm, labels[32:, rs], halo[0, 0], halo[1, 0], 1, ev[rs],
                words[32:, rs], parity, tab, spec, p)
            assert torch.equal(got, want)
    torch.cuda.synchronize()
