"""The port's gradient-compression collectives (`optim/compression.py`)
and mesh helpers (`launch/mesh.py`) on 8 gloo ranks on the CPU, against
the reference's `tree_psum_compressed` under `shard_map` on 8 simulated
host devices (built as `tests/test_compression.py` builds it), one
subprocess and one spawn a session:

  * int8: q and scale of `quantize_int8`, the reduced total and the
    residual of `psum_int8`, bit for bit, over 3 error-feedback steps
    whose residuals telescope;
  * none: the float32 sum within float32 sum order, |port - reference|
    at most 8 float32 steps (2^-23) of the largest |sum| (8 addends);
  * bf16: the reference's all-reduce (XLA on the CPU) adds the 8 bf16
    addends in float32 and rounds once; gloo's ring rounds to bf16 at
    each of its 7 hops, each off by at most half a bf16 step (2^-8
    relative) of a partial sum no larger than A = sum_r |g_r|.  So
    |port - reference| <= 8 * 2^-8 * A = 2^-5 * A at each element;
  * `dp_axes`, `fsdp_axis`, `tp_axis` on (2, 4), (16, 16) and
    (2, 16, 16) meshes equal the reference's.

Inputs come from numpy seeds."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as mesh_mod

import torch_rank_cases as cases

N_RANKS = 8
STEPS = 3
MESH_AXES = {(2, 4): ("data", "model"), (16, 16): ("data", "model"),
             (2, 16, 16): ("pod", "data", "model")}


def grads_of(rank: int) -> dict:
    """Rank `rank`'s gradients: a nested dict of float32 leaves."""
    rng = np.random.default_rng(100 + rank)
    return {"w": rng.standard_normal((64, 32)).astype(np.float32),
            "blk": {"b": (3.0 * rng.standard_normal(16)).astype(np.float32),
                    "s": rng.standard_normal((4, 4)).astype(np.float32)}}


_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.core import compat
    from repro.launch import mesh as ref_mesh
    from repro.optim import compression as comp
    sys.path.insert(0, sys.argv[2])
    from test_torch_compression import (MESH_AXES, N_RANKS, STEPS,
                                        grads_of)

    mesh = compat.make_mesh((N_RANKS,), ("data",))
    per = [grads_of(r) for r in range(N_RANKS)]
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *per)
    spec = jax.tree.map(lambda _: P("data"), stacked)
    rep = jax.tree.map(lambda _: P(), stacked)
    out = {}

    def run(mode):
        def f(g):
            red, _ = comp.tree_psum_compressed(
                jax.tree.map(lambda x: x[0], g), "data", mode)
            return red
        return jax.jit(compat.shard_map(f, mesh=mesh, in_specs=(spec,),
                                        out_specs=rep, check_vma=False))

    for mode in ("none", "bf16"):
        red = run(mode)(stacked)
        for path, x in jax.tree_util.tree_leaves_with_path(red):
            out[mode + jax.tree_util.keystr(path)] = np.asarray(x)

    def quant(g):
        q, s = comp.quantize_int8(g[0])
        return q[None], s[None]

    qf = jax.jit(compat.shard_map(quant, mesh=mesh, in_specs=P("data"),
                                  out_specs=(P("data"), P("data")),
                                  check_vma=False))
    q, s = qf(stacked["w"])
    out["q"], out["scale"] = np.asarray(q), np.asarray(s)
    out["dequant"] = np.asarray(jax.jit(jax.vmap(comp.dequantize_int8))(
        q, s))

    def step(g, r):
        red, new_r = comp.tree_psum_compressed(
            jax.tree.map(lambda x: x[0], g), "data", "int8",
            jax.tree.map(lambda x: x[0], r))
        return red, jax.tree.map(lambda x: x[None], new_r)

    stepf = jax.jit(compat.shard_map(step, mesh=mesh, in_specs=(spec, spec),
                                     out_specs=(rep, spec), check_vma=False))
    res = jax.tree.map(jnp.zeros_like, stacked)
    for t in range(STEPS):
        red, res = stepf(stacked, res)
        for name, tree in (("total", red), ("residual", res)):
            for path, x in jax.tree_util.tree_leaves_with_path(tree):
                out[f"{name}{t}" + jax.tree_util.keystr(path)] = \\
                    np.asarray(x)
    for shape, axes in MESH_AXES.items():
        m = type("M", (), {"axis_names": axes})()
        out["axes" + str(shape)] = np.array(repr(
            (ref_mesh.dp_axes(m), ref_mesh.fsdp_axis(m),
             ref_mesh.tp_axis(m))))
    np.savez(sys.argv[1], **out)
    print("REFERENCE_OK")
""")


def _keystr(path) -> str:
    """jax.tree_util.keystr of a dict path."""
    return "".join(f"['{k}']" for k in path)


def rank_collectives(rank, device_mesh) -> dict:
    """One rank's side of every comparison (`spawn` runs it on 8 ranks)."""
    from repro_torch.optim import compression as comp

    g = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
             {kk: torch.from_numpy(vv) for kk, vv in v.items()})
         for k, v in grads_of(rank).items()}
    out = {}
    for mode in ("none", "bf16"):
        red, res = comp.tree_psum_compressed(g, "data", mode,
                                             mesh=device_mesh)
        assert res is None
        for path, x in comp._leaves(red):
            out[mode + _keystr(path)] = x
    q, s = comp.quantize_int8(g["w"])
    out["q"], out["scale"] = q, s
    out["dequant"] = comp.dequantize_int8(q, s)
    res = comp.init_residuals(g)
    for t in range(STEPS):
        red, res = comp.tree_psum_compressed(g, "data", "int8", res,
                                             mesh=device_mesh)
        for name, tree in (("total", red), ("residual", res)):
            for path, x in comp._leaves(tree):
                out[f"{name}{t}" + _keystr(path)] = x
    mesh24 = mesh_mod.make_mesh((2, 4), ("data", "model"), device_type="cpu")
    for shape, axes in MESH_AXES.items():
        m = mesh24 if shape == (2, 4) else SimpleNamespace(
            mesh_dim_names=axes)
        out["axes" + str(shape)] = repr((mesh_mod.dp_axes(m),
                                         mesh_mod.fsdp_axis(m),
                                         mesh_mod.tp_axis(m)))
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the reference's outputs, each rank's outputs)."""
    def reference():
        out = tmp_path_factory.mktemp("compression") / "reference.npz"
        root = Path(__file__).resolve().parent.parent
        env = dict(os.environ)
        env["PYTHONPATH"] = str(root / "src")
        env["JAX_PLATFORMS"] = "cpu"
        env.pop("XLA_FLAGS", None)
        res = subprocess.run(
            [sys.executable, "-c", _REFERENCE, str(out),
             str(Path(__file__).parent)],
            env=env, capture_output=True, text=True, timeout=600)
        assert "REFERENCE_OK" in res.stdout, (res.stdout[-2000:]
                                              + res.stderr[-4000:])
        return dict(np.load(out))

    ref = cases.once_per_session(tmp_path_factory, "compression_reference",
                                 reference)
    ranks = cases.once_per_session(
        tmp_path_factory, "compression_ranks", lambda: mesh_mod.spawn(
            rank_collectives, N_RANKS, backend="gloo", device="cpu",
            timeout_s=300))
    return ref, ranks


def _leaf_names(prefix: str) -> list[str]:
    return ["".join([prefix, _keystr(p)]) for p in
            (("blk", "b"), ("blk", "s"), ("w",))]


def test_int8_is_bit_equal(both):
    ref, ranks = both
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["q"].numpy(), ref["q"][r])
        np.testing.assert_array_equal(out["scale"].numpy(), ref["scale"][r])
        np.testing.assert_array_equal(out["dequant"].numpy(),
                                      ref["dequant"][r])
        for t in range(STEPS):
            for name in _leaf_names(f"total{t}"):
                np.testing.assert_array_equal(out[name].numpy(), ref[name])
            for name in _leaf_names(f"residual{t}"):
                np.testing.assert_array_equal(out[name].numpy(),
                                              ref[name][r])


def test_error_feedback_telescopes(both):
    """sum_t total_t = STEPS * sum_r g_r - sum_r residual_r(STEPS): the
    quantization error of every step is paid back by the next."""
    _, ranks = both
    for name in ("w", "blk']['b", "blk']['s"):
        want = STEPS * sum(np.asarray(_leaf(grads_of(r), name), np.float64)
                           for r in range(N_RANKS))
        totals = sum(ranks[0][f"total{t}['{name}']"].double()
                     for t in range(STEPS))
        owed = sum(out[f"residual{STEPS - 1}['{name}']"].double()
                   for out in ranks)
        scale = np.abs(want).max()
        np.testing.assert_allclose((totals + owed).numpy(), want,
                                   atol=1e-5 * scale)
        # one step alone is off by up to half a quantization step a rank
        single = ranks[0][f"total0['{name}']"].double().numpy()
        assert np.abs(single - want / STEPS).max() > 1e-4 * scale


def _leaf(tree, name):
    for k in name.split("']['"):
        tree = tree[k]
    return tree


def test_none_within_float32_sum_order(both):
    ref, ranks = both
    for name in _leaf_names("none"):
        tol = 8 * 2.0 ** -23 * np.abs(ref[name]).max()
        for out in ranks:
            np.testing.assert_allclose(out[name].numpy(), ref[name], rtol=0,
                                       atol=tol)


def test_bf16_within_its_hops_rounding(both):
    ref, ranks = both
    for name in _leaf_names("bf16"):
        leaf = name[len("bf16"):].strip("[]'")
        a = sum(np.abs(torch.from_numpy(_leaf(grads_of(r), leaf)).to(
            torch.bfloat16).float().numpy()) for r in range(N_RANKS))
        want = ref[name].astype(np.float32)
        for out in ranks:
            got = out[name].numpy()
            assert out[name].dtype == torch.float32
            err = np.abs(got - want)
            assert (err <= 2.0 ** -5 * a).all(), (err / a).max()


@pytest.mark.parametrize("shape", list(MESH_AXES))
def test_mesh_axis_helpers_match_the_reference(both, shape):
    ref, ranks = both
    for out in ranks:
        assert out["axes" + str(shape)] == str(ref["axes" + str(shape)])


def test_trees_and_modes():
    from repro_torch.optim import compression as comp

    g = {"a": torch.ones(2), "b": {"c": torch.zeros(3)}}
    res = comp.init_residuals(g)
    assert res["a"].dtype == torch.float32 and res["b"]["c"].shape == (3,)
    assert [p for p, _ in comp._leaves(g)] == [("a",), ("b", "c")]
    with pytest.raises(ValueError):
        comp.tree_psum_compressed(g, "data", "fp4", mesh=None)
