"""The port's Bayes-net engine against the reference on the same compiled
model and key: `compile_bayesnet` arrays, `init_chain_values`, one lut_ky
`gibbs_sweep`, the K3 twin against the reference's fused Pallas sweep
(interpret mode), and `run_gibbs`.  The reference runs under `jax.jit`, as
its engines run it.  Tolerance: bit-equal, except exact_ky, whose `exp`
differs in its last bits between XLA and torch: there the marginals are
held within per-node TV 0.03 of the reference run with the same key (at
64 chains x 500 sweeps sampling noise is about 0.01)."""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import bayesnet as r_bn
from repro.core import graphs as r_graphs
from repro.kernels import bn_gibbs as r_fused
from repro_torch import convert, prng
from repro_torch.core import bayesnet as t_bn
from repro_torch.core import graphs as t_graphs
from repro_torch.kernels import bn_gibbs as t_fused

# the whole bench zoo (`bn_repository_names()`)
MODELS = ["survey", "asia", "cancer", "alarm", "hailfinder", "sachs",
          "insurance", "water", "hepar2", "win95pts", "pigs"]

_r_sweep = jax.jit(r_bn.gibbs_sweep, static_argnames=("sampler",))


def _key(seed):
    """The same key on both sides."""
    jk = jax.random.key(seed)
    return jk, convert.key_from_reference(
        np.asarray(jax.random.key_data(jk)))


@functools.lru_cache(maxsize=None)
def _nets(name):
    r = r_bn.compile_bayesnet(r_graphs.bn_repository_replica(name))
    t = t_bn.compile_bayesnet(t_graphs.bn_repository_replica(name),
                              device="cpu")
    return r, t


@pytest.mark.parametrize("name", MODELS)
def test_compile_bayesnet_arrays_match_reference(name):
    r, t = _nets(name)
    ra, rm = convert.reference_bn_arrays(r)
    ta, tm = convert.reference_bn_arrays(t)
    assert rm == tm
    assert ra.keys() == ta.keys()
    for k in ra:
        assert ra[k].shape == ta[k].shape, k
        np.testing.assert_array_equal(ta[k], ra[k], err_msg=k)
    # the converter hands the reference's arrays over unchanged
    back = convert.from_reference_bn(ra, rm, device="cpu")
    for k, v in convert.reference_bn_arrays(back)[0].items():
        np.testing.assert_array_equal(v, ra[k], err_msg=k)


@pytest.mark.parametrize("name", MODELS)
def test_init_and_one_lut_ky_sweep_match_reference(name):
    r, t = _nets(name)
    jk, k = _key(3)
    r_vals, r_next = r_bn.init_chain_values(r, jk, 6)
    t_vals, t_next = t_bn.init_chain_values(t, k, 6)
    np.testing.assert_array_equal(t_vals.numpy(), np.asarray(r_vals))
    assert [t_next.k1, t_next.k2] == np.asarray(
        jax.random.key_data(r_next)).tolist()
    jk2, k2 = _key(11)
    want = _r_sweep(r, r_vals, jk2, sampler="lut_ky")
    got = t_bn.gibbs_sweep(t, t_vals, k2, "lut_ky")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["survey", "alarm", "sachs", "insurance",
                                  "water"])
def test_k3_twin_matches_reference_fused_kernel(name):
    """The K3 twin (what `bn_sweep` runs on CPU tensors) against the
    reference's `fused_gibbs_sweep` Pallas kernel in interpret mode."""
    r, t = _nets(name)
    jk, k = _key(0)
    r_vals, _ = r_bn.init_chain_values(r, jk, 3)
    t_vals, _ = t_bn.init_chain_values(t, k, 3)
    jk2, k2 = _key(11)
    want = r_fused.fused_gibbs_sweep(
        r, r_fused.build_fused_rounds(r.groups), r_vals, jk2, "lut_ky",
        interpret=True)
    fr = t_fused.build_fused_rounds(t.groups)
    launches = t_fused.bn_sweep.launches
    got = t_fused.fused_gibbs_sweep(t, fr, t_vals, k2, "lut_ky")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert t_fused.bn_sweep.launches == launches  # the twin, not the kernel
    # and the port's own fused and unfused sweeps agree
    unfused = t_bn.gibbs_sweep(t, t_vals, k2, "lut_ky")
    np.testing.assert_array_equal(got.numpy(), unfused.numpy())


def test_run_gibbs_and_slices_match_reference():
    r, t = _nets("survey")
    jk, k = _key(5)
    rm, rv = r_bn.run_gibbs(r, jk, n_chains=16, n_iters=30, burn_in=10)
    tm, tv = t_bn.run_gibbs(t, k, n_chains=16, n_iters=30, burn_in=10,
                            device="cpu")
    np.testing.assert_array_equal(tm.numpy(), np.asarray(rm))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    _, _, st = t_bn.run_gibbs(t, k, n_chains=16, n_iters=12, burn_in=10,
                              return_state=True, device="cpu")
    sm, sv = t_bn.run_gibbs(t, None, n_iters=18, burn_in=10, carry=st,
                            device="cpu")
    assert torch.equal(sm, tm) and torch.equal(sv, tv)


def test_exact_ky_marginals_within_tv_of_reference():
    r, t = _nets("asia")
    jk, k = _key(17)
    rm, _ = r_bn.run_gibbs(r, jk, n_chains=64, n_iters=500, burn_in=100,
                           sampler="exact_ky")
    tm, _ = t_bn.run_gibbs(t, k, n_chains=64, n_iters=500, burn_in=100,
                           sampler="exact_ky", device="cpu")
    tv = 0.5 * np.abs(tm.numpy() - np.asarray(rm)).sum(-1)
    assert tv.max() <= 0.03, tv


def test_run_gibbs_refuses_a_net_compiled_for_another_device():
    _, t = _nets("survey")
    with pytest.raises(ValueError):
        t_bn.run_gibbs(t, prng.key(0), device="meta")


@functools.lru_cache(maxsize=None)
def _fused(name):
    t = t_bn.compile_bayesnet(t_graphs.bn_repository_replica(name),
                              device="cpu")
    return t, t_fused.build_fused_rounds(t.groups)


@pytest.mark.parametrize("name", ["pigs", "hailfinder"])
def test_row_word_index_addresses_the_fused_round_words(name):
    """K3 reads word j of row (chain, c) of round r at counter
    `row_word_index(chain, n_c_r, c, W) + j` of round r's stream under
    `round_key(key, r)`: indexed that way out of `prng.bits` over a flat
    counter range, the words equal `fused_round_words`, element for
    element."""
    t, fr = _fused(name)
    chains = 5
    p = t_fused.sweep_params(t, "lut_ky")
    key = prng.key(13)
    words = t_fused.fused_round_words(fr, key, chains, p.n_words, "cpu")
    off = 0
    for r, nc in enumerate(fr.n_c):
        stream = prng.bits(t_fused.round_key(key, r),
                           (chains * nc * p.n_words,), "cpu")
        b, c, j = np.meshgrid(np.arange(chains), np.arange(nc),
                              np.arange(p.n_words), indexing="ij")
        idx = t_fused.row_word_index(b, nc, c, p.n_words) + j
        n = chains * nc * p.n_words
        np.testing.assert_array_equal(
            stream.numpy()[idx],
            words[off:off + n].numpy().reshape(chains, nc, p.n_words))
        off += n
    assert off == words.numel()


@pytest.mark.parametrize("name", ["pigs", "hailfinder", "alarm"])
@pytest.mark.parametrize("sampler", ["lut_ky", "exact_ky"])
def test_keyed_bn_sweep_is_the_twin_on_that_keys_words(name, sampler):
    """`bn_sweep` takes the sweep's key; on CPU tensors it is the twin run
    on `fused_round_words` of that key, and launches nothing."""
    t, fr = _fused(name)
    p = t_fused.sweep_params(t, sampler)
    vals, _ = t_bn.init_chain_values(t, prng.key(2), 4)
    key = prng.key(31)
    launches = t_fused.bn_sweep.launches
    got = t_fused.bn_sweep(t, fr, vals, key, sampler, p)
    words = t_fused.fused_round_words(fr, key, 4, p.n_words, "cpu")
    want = t_fused.bn_sweep_ref(t, fr, vals, words, sampler, p)
    assert torch.equal(got, want)
    assert t_fused.bn_sweep.launches == launches
    with pytest.raises(TypeError):
        t_fused.bn_sweep(t, fr, vals, words, sampler, p)


@pytest.mark.cuda
def test_k3_matches_its_twin_on_the_card():
    """K3 hashes its words from the sweep key; the twin runs on the same
    key's `fused_round_words`.  lut_ky bit-equal; exact_ky's `exp` may
    round another way on the card in a few labels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    dev = torch.device("cuda")
    for name in ("survey", "alarm", "hailfinder", "pigs"):
        cbn = t_bn.compile_bayesnet(t_graphs.bn_repository_replica(name),
                                    device=dev)
        fr = t_fused.build_fused_rounds(cbn.groups)
        vals, _ = t_bn.init_chain_values(cbn, prng.key(1), 64)
        for sampler in ("lut_ky", "exact_ky"):
            p = t_fused.sweep_params(cbn, sampler)
            for seed in (2, 3):
                key = prng.key(seed)
                got = t_fused.bn_sweep(cbn, fr, vals, key, sampler, p)
                words = t_fused.fused_round_words(fr, key, 64, p.n_words,
                                                  dev)
                want = t_fused.bn_sweep_ref(cbn, fr, vals, words, sampler,
                                            p)
                torch.cuda.synchronize()
                if sampler == "lut_ky":
                    assert torch.equal(got, want), name
                else:
                    assert (got != want).float().mean() < 0.01, name
