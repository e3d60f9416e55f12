"""The port's copied numpy front end against the reference across the
bench zoo: replica CPTs, DSATUR colours, the IR content hash, the pass
pipeline's schedule rounds, and variable-elimination marginals."""

import numpy as np
import pytest

from repro.compile import ir as r_ir
from repro.compile import passes as r_passes
from repro.core import coloring as r_coloring
from repro.core import exact as r_exact
from repro.core import graphs as r_graphs
from repro_torch.compile import ir as t_ir
from repro_torch.compile import passes as t_passes
from repro_torch.core import coloring as t_coloring
from repro_torch.core import exact as t_exact
from repro_torch.core import graphs as t_graphs

ZOO = r_graphs.bn_repository_names()


def test_zoo_names_match():
    assert t_graphs.bn_repository_names() == ZOO


@pytest.mark.parametrize("name", ZOO)
def test_replica_colours_ir_and_schedule_match(name):
    r_bn = r_graphs.bn_repository_replica(name)
    t_bn = t_graphs.bn_repository_replica(name)
    np.testing.assert_array_equal(t_bn.cards, r_bn.cards)
    assert t_bn.parents == r_bn.parents
    for a, b in zip(t_bn.cpts, r_bn.cpts):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        t_coloring.dsatur(t_bn.moral_adjacency()),
        r_coloring.dsatur(r_bn.moral_adjacency()),
    )
    for mode in ("baked", "runtime"):
        r_g = r_ir.canonicalize(r_bn, evidence_mode=mode)
        t_g = t_ir.canonicalize(t_bn, evidence_mode=mode)
        assert t_g.ir_key == r_g.ir_key
    ev = {0: 0, t_bn.n_nodes - 1: 1}
    assert (t_ir.canonicalize(t_bn, ev).ir_key
            == r_ir.canonicalize(r_bn, ev).ir_key)
    for pipeline in ("default", "runtime"):
        r_ctx = r_passes.run_pipeline(r_ir.canonicalize(r_bn),
                                      passes=r_passes.named_pipeline(pipeline))
        t_ctx = t_passes.run_pipeline(t_ir.canonicalize(t_bn),
                                      passes=t_passes.named_pipeline(pipeline))
        assert _rounds(t_ctx.schedule) == _rounds(r_ctx.schedule)
        assert t_ctx.schedule.cost() == r_ctx.schedule.cost()
        np.testing.assert_array_equal(t_ctx.placement.placement,
                                      r_ctx.placement.placement)


def _rounds(schedule):
    """A schedule's rounds as plain tuples (the two packages' dataclasses
    are distinct types)."""
    return [
        (r.color, r.nodes, r.core_load,
         [(c.mechanism, c.src_core, c.dst_core, c.n_bytes, c.hops)
          for c in r.comm])
        for r in schedule.rounds
    ]


@pytest.mark.parametrize("name", ["survey", "cancer", "asia", "sachs"])
def test_variable_elimination_matches(name):
    r_bn = r_graphs.bn_repository_replica(name)
    t_bn = t_graphs.bn_repository_replica(name)
    ev = {1: 0}
    for q in range(r_bn.n_nodes):
        if q in ev:
            continue
        np.testing.assert_array_equal(t_exact.ve_marginal(t_bn, q, ev),
                                      r_exact.ve_marginal(r_bn, q, ev))


def test_grid_mrf_ir_matches():
    r_m = r_graphs.GridMRF(6, 5, 3)
    t_m = t_graphs.GridMRF(6, 5, 3)
    assert t_ir.canonicalize(t_m).ir_key == r_ir.canonicalize(r_m).ir_key
