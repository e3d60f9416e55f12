"""The lane kernels' layouts (`kernels/bn_gibbs.py` K3, `kernels/mrf_gibbs.py`
K4), held on the CPU: the compact round tables against `BNFusedRounds`,
the K3 row over them against the twin, and the launch rules; on the card
(`cuda` marker) the kernels against their twins.

The compact tables keep each node's real factors and scope slots of the
padded `BNFusedRounds`, in order.  The kernel skips the padding, which the
twin evaluates: a padded factor adds the arena's 0.0 to a lane's log-prob
(x + 0.0 == x but for the sign of a zero, which the max subtraction
erases) and a padded slot adds stride 0.  `compact_sweep` below is the
kernel's row in plain torch, with the twin's arithmetic (f32 sums left to
right, the same weights and KY walk), over the compact tables; it must
give the twin's labels bit for bit over the bench zoo, lut_ky and
exact_ky.  Tolerance: bit-equal.
"""

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core import bayesnet as bnet
from repro_torch.core import ky as ky_core
from repro_torch.core import mrf as mrf_mod
from repro_torch.core.bayesnet import NEG_INF
from repro_torch.core.graphs import (GridMRF, bn_repository_names,
                                     bn_repository_replica)
from repro_torch.core.interp import build_exp_weight_lut, interp_ref
from repro_torch.kernels import bn_gibbs, mrf_gibbs

ZOO = bn_repository_names()
SMS = 132
CHAINS = 1024


def lane_blocks(q, b, chains_per_warp):
    """(query, first chain, chains) of each block of a K3 lane launch, in
    block order, as `bn_lanes_kernel` derives them from its block index
    (csrc/bn_gibbs.cu)."""
    per_query = -(-b // chains_per_warp)
    out = []
    for blk in range(q * per_query):
        qq = blk // per_query
        first = (blk - qq * per_query) * chains_per_warp
        out.append((qq, first, min(chains_per_warp, b - first)))
    return out


def _compiled(name, device="cpu"):
    cbn = bnet.compile_bayesnet(bn_repository_replica(name), device=device)
    return cbn, bn_gibbs.build_fused_rounds(cbn.groups)


@pytest.mark.parametrize("name", ZOO)
def test_compact_tables_hold_the_real_slots(name):
    """Rows, factors and slots of the compact tables are the padded
    tables' real ones (factor base != 0, slot stride != 0), in order, and
    the padding trails each node's factors and each factor's slots."""
    cbn, fr = _compiled(name)
    t = bn_gibbs.lane_tables(fr)
    r_n, c, f, s = len(fr.n_c), fr.c_max, fr.f_max, fr.s_max
    nodes = fr.nodes.numpy().reshape(r_n, c)
    cards = fr.cards.numpy().reshape(r_n, c)
    base = fr.base.numpy().reshape(r_n, c, f)
    stride = fr.stride.numpy().reshape(r_n, c, f, s)
    scope = fr.scope_var.numpy().reshape(r_n, c, f, s)
    is_self = fr.is_self.numpy().reshape(r_n, c, f, s)
    rows, facs, slots = [], [], []
    for r in range(r_n):
        for k in range(fr.n_c[r]):
            real_f = base[r, k] != 0
            assert real_f.all() or not real_f[np.argmin(real_f):].any()
            f0 = len(facs)
            for j in np.flatnonzero(real_f):
                real_s = stride[r, k, j] != 0
                assert real_s.all() or not real_s[np.argmin(real_s):].any()
                s0 = len(slots)
                slots += [(stride[r, k, j, i],
                           2 * scope[r, k, j, i] + is_self[r, k, j, i])
                          for i in np.flatnonzero(real_s)]
                facs.append((base[r, k, j], s0, len(slots)))
            rows.append((nodes[r, k], cards[r, k], f0, len(facs)))
    assert t.round_rows.tolist() == [0, *np.cumsum(fr.n_c).tolist()]
    assert t.rows.tolist() == [list(x) for x in rows]
    assert t.facs[:len(facs), :3].tolist() == [list(x) for x in facs]
    assert t.slots[:len(slots)].tolist() == [list(x) for x in slots]
    # nothing real beyond them: the kernel reads the leading entries only
    assert int(t.rows[:, 3].max()) == len(facs)
    assert int(t.facs[:len(facs), 2].max()) == len(slots)


def compact_sweep(cbn, fr, vals, words, sampler, p):
    """One sweep of K3's lane kernel in plain torch: for each round, each
    compact row's gather and factor sum over its real factors and slots
    only, then the twin's weights and KY walk on the round's words
    (`fused_round_words` order, chain-major)."""
    t = bn_gibbs.lane_tables(fr)
    b = vals.shape[0]
    v_range = torch.arange(p.v_max)
    last = cbn.log_flat.shape[0] - 1
    off = 0
    for r, nc in enumerate(fr.n_c):
        r0 = int(t.round_rows[r])
        logps, nodes = [], []
        for node, card, f0, f1 in t.rows[r0:r0 + nc].tolist():
            logp = None
            for fbase, s0, s1, _ in t.facs[f0:f1].tolist():
                fixed = torch.full((b,), fbase, dtype=torch.int64)
                self_stride = 0
                for st, code in t.slots[s0:s1].tolist():
                    if code & 1:
                        self_stride += st
                    else:
                        fixed = fixed + st * vals[:, code >> 1].long()
                addr = (fixed[:, None] + self_stride * v_range).clamp(0, last)
                x = cbn.log_flat[addr]
                logp = x if logp is None else logp + x
            logps.append(torch.where(v_range < card, logp,
                                     torch.full_like(logp, NEG_INF)))
            nodes.append(node)
        flat = torch.stack(logps, 1).reshape(b * nc, p.v_max)
        z = flat - flat.amax(-1, keepdim=True)
        if sampler == "lut_ky":
            w = torch.clamp(torch.round(
                interp_ref(z, cbn.exp_table, cbn.exp_spec)), min=0.0).to(
                    torch.int32)
        else:
            w = ky_core.quantize_probs(torch.exp(z), bits=p.weight_bits)
        n = b * nc * p.n_words
        labels, _ = ky_core.ky_sample_fast(
            w, words[off:off + n].reshape(b * nc, p.n_words),
            n_bins=p.v_max, precision=p.precision,
            max_retries=p.max_retries)
        off += n
        vals = vals.clone()
        vals[:, torch.tensor(nodes)] = labels.reshape(b, nc)
    return vals


@pytest.mark.parametrize("name", ZOO)
def test_compact_row_equals_the_twin(name):
    """`compact_sweep` over 2 queries of 5 chains, each query with its own
    key, equals `bn_sweep_lanes_ref` (the per-key twin over the padded
    tables) bit for bit, for lut_ky and exact_ky."""
    cbn, fr = _compiled(name)
    q, b = 2, 5
    vals = torch.cat([bnet.init_chain_values(cbn, prng.key(7 + i), b)[0]
                      for i in range(q)])
    keys = [prng.key(11), prng.Key(0xFFFFFFFF, 0x89ABCDEF)]
    kt = prng.key_tensor(keys, "cpu")
    for sampler in ("lut_ky", "exact_ky"):
        p = bn_gibbs.sweep_params(cbn, sampler)
        want = bn_gibbs.bn_sweep_lanes_ref(cbn, fr, vals, kt, sampler, p)
        got = torch.cat([
            compact_sweep(cbn, fr, vals[i * b:(i + 1) * b],
                          bn_gibbs.fused_round_words(fr, k, b, p.n_words,
                                                     "cpu"), sampler, p)
            for i, k in enumerate(keys)])
        assert torch.equal(got, want), (name, sampler)
        assert not torch.equal(got, vals)


@pytest.mark.parametrize("name,q,b", [
    ("pigs", 8, CHAINS), ("hailfinder", 2, CHAINS), ("pigs", 1, CHAINS),
    ("hailfinder", 1, CHAINS), ("pigs", 3, 1000), ("alarm", 4, 777),
    ("asia", 1, 3)])
def test_k3_lane_blocks(name, q, b):
    """K3's lane launch: every block holds chains of one query, each chain
    in exactly one block; the runtime's shapes (pigs Q 8, hailfinder Q 2,
    Q 1, all at 1,024 chains) give every SM of the card a block; none
    keeps the parent's mapping."""
    cbn, fr = _compiled(name)
    ln = bn_gibbs.lanes_launch(cbn, fr, q, b)
    blocks = lane_blocks(q, b, ln["chains_per_warp"])
    assert len(blocks) == ln["blocks"]
    seen = np.zeros((q, b), int)
    for qq, first, nch in blocks:
        assert 0 <= qq < q and 1 <= nch <= ln["chains_per_warp"]
        assert 0 <= first and first + nch <= b  # within its query
        seen[qq, first:first + nch] += 1
    assert (seen == 1).all()
    if b == CHAINS and (name, q) in {("pigs", 8), ("hailfinder", 2),
                                     ("pigs", 1), ("hailfinder", 1)}:
        assert ln["blocks"] >= SMS
    assert ln["threads"] % 32 == 0 and 32 <= ln["threads"] <= 512
    assert ln["smem"] <= bn_gibbs._SMEM_MAX


@pytest.mark.parametrize("h,w,v,q", [(64, 64, 4, 2), (64, 64, 4, 1),
                                     (48, 48, 8, 2), (48, 48, 8, 1)])
def test_k4_lane_blocks(h, w, v, q):
    """K4's lane launch at the runtime's Penguin and Art buckets and at
    Q 1: every SM of the card gets a block, and the exact-width instance
    (2-8 labels) is taken."""
    ln = mrf_gibbs.lanes_launch(GridMRF(h, w, v), q, CHAINS)
    assert ln["blocks"] >= SMS
    assert ln["kernel"] == f"mrf_lanes_kernel<{v}, 1>"
    assert ln["smem"] <= mrf_gibbs._SMEM_MAX


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["asia", "insurance", "hailfinder", "pigs"])
def test_k3_lanes_against_the_twin_on_the_card(name):
    """K3's lane entry against its twin at Q in {1, 2, 3, 8} and B in
    {1,000, 1,024}, on models that reach the VCAP 4 (asia, pigs), 8
    (insurance) and 16 (hailfinder) instances; lut_ky bit-equal, and
    exact_ky bit-equal to the one-query kernel run query by query."""
    dev = _card()
    cbn, fr = _compiled(name, dev)
    for q in (1, 2, 3, 8):
        for b in (1000, CHAINS):
            vals = torch.cat([bnet.init_chain_values(
                cbn, prng.key(20 + i), b)[0] for i in range(q)])
            keys = [prng.key(30 + i) for i in range(q)]
            kt = prng.key_tensor(keys, dev)
            for sampler in ("lut_ky", "exact_ky"):
                p = bn_gibbs.sweep_params(cbn, sampler)
                got = bn_gibbs.bn_sweep_lanes(cbn, fr, vals, kt, sampler, p)
                if sampler == "lut_ky":
                    want = bn_gibbs.bn_sweep_lanes_ref(cbn, fr, vals, kt,
                                                       sampler, p)
                else:
                    want = torch.cat([bn_gibbs.bn_sweep(
                        cbn, fr, vals[i * b:(i + 1) * b], k, sampler, p)
                        for i, k in enumerate(keys)])
                torch.cuda.synchronize()
                assert torch.equal(got, want), (name, q, b, sampler)


@pytest.mark.cuda
@pytest.mark.parametrize("model", [(64, 64, 4, "potts"), (48, 48, 8, "potts"),
                                   (48, 48, 8, "quadratic")])
def test_k4_lanes_against_the_twin_on_the_card(model):
    """K4's lane entry on Penguin, Art and Art-quadratic, 2 queries of
    1,000 chains with their own evidence planes and keys, both parities:
    bit-equal to the twin."""
    dev = _card()
    h, w, v, cost = model
    mrf = GridMRF(h, w, v, theta=1.2, h=2.0, data_cost=cost)
    tab, spec = build_exp_weight_lut(device=dev)
    q, b = 2, 1000
    evs = torch.stack([torch.as_tensor(mrf_mod.make_denoising_problem(
        h, w, v, 0.25, seed=s)[1]) for s in range(q)]).to(dev)
    labels = prng.randint(prng.key(1), (q * b, h, w), 0, v, dev)
    p = mrf_gibbs.half_step_params(mrf)
    for parity in (0, 1):
        kt = prng.key_tensor([prng.key(40 + 3 * parity + i)
                              for i in range(q)], dev)
        got = mrf_gibbs.mrf_half_step_lanes(mrf, labels, evs, kt, parity,
                                            tab, spec, p)
        want = mrf_gibbs.mrf_half_step_lanes_ref(mrf, labels, evs, kt,
                                                 parity, tab, spec, p)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (model, parity)
