"""The LM mesh of the port (`launch/sharding.py`, `launch/collectives.py`,
the meshed factories of `launch/steps.py`) against the reference's.

* The sharding rules: every parameter, optimizer, batch and cache spec of
  the ten configs at full width (abstract shapes), on (2, 4), (16, 16)
  and (2, 16, 16), equals the reference's leaf by leaf.  The reference's
  rules run in a subprocess with 8 simulated host devices (the (2, 4)
  mesh through `compat.make_mesh`, the production meshes as
  `jax.sharding.AbstractMesh`).
* The steps: 8 gloo CPU ranks as (2, 4) run reduced yi-9b, qwen2-moe,
  xlstm-350m and jamba in float32 with the reference's weights
  (`torch_rank_cases.lm_mesh_cases`): prefill logits and caches, three
  teacher-forced decode steps' logits and KY tokens, one train step's
  loss, gradients and updated leaves.  Every rank returns the same; each
  is within the larger of 1e-5 of its scale and the reference's own
  (2, 4)-against-unsharded gap of the port's single-process step, and
  within 1e-4 of its scale of the reference's (2, 4) step (the same
  subprocess, under `jax.set_mesh`), or, where the reference's (2, 4)
  step is further than that from its own unsharded step (xlstm-350m's
  sLSTM `out`: 6.8e-4 of its scale after the update), within the sum of
  the gaps along mesh -> one process -> the reference's one process ->
  its mesh.  Two leaves are cancellations
  (tests/test_torch_train.py): the mLSTM input-gate bias `bi`, whose
  gradient is a sum of large terms, and the attention key bias `bk`, to
  which the output is invariant (its gradient is rounding noise, and
  AdamW's first step scales that noise to the learning rate); both are
  held at `CANCEL_RTOL` of their scale on both bounds.  A 1 x 1 world is
  bit-equal to the single-process step.
* Tensor-parallel compute, counted: on (2, 4) no block leaf the rules
  split over the model axis (attention, Mamba and xLSTM mixers, MLP,
  MoE) is gathered over it, and the region's sums over it are the ones
  the blocks' parts need; on the shape-only meshes (2, 4) and (16, 16) a
  rank's gathered block leaves of yi-9b, qwen2-moe-a2.7b, jamba and
  xlstm-350m at full width are the model axis's share of the leaf
  exactly where the reference's rules split it; and decode over a cache
  split by sequence moves the same bytes over the model axis whatever
  the cache's length.
* Checkpoints: a (2, 4) run resumed from its checkpoint is bit-equal to
  the uninterrupted run, and the checkpoint restores onto (1, 2) and
  1 x 1 with every leaf bit-equal.

The spawns and the reference run once a session
(`torch_rank_cases.once_per_session`).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import transformer as r_tfm
from repro_torch import configs as t_configs
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as t_ckpt
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import sharding
from repro_torch.launch import steps as t_steps
from repro_torch.models import sampling as t_sampling
from repro_torch.models import transformer as t_tfm

import torch_rank_cases as cases

ROOT = Path(__file__).resolve().parent.parent
ARCHS = sorted(r_configs.list_archs())
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# (cell, seq, batch) whose batch and cache specs are compared: the
# batch split, the sequence split, and neither split over dp
SPEC_CELLS = (("train_4k", 4096, 256), ("decode_32k", 32768, 128),
              ("long_500k", 524288, 1))
RANK_TIMEOUT_S = 600
WEIGHT_SEED = 1
CANCEL_RTOL = 0.1  # test_torch_train.BI_RTOL
CANCELLING = ("bi", "bk")

_REFERENCE = textwrap.dedent("""
    import dataclasses, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.core import compat
    from repro.launch import sharding, steps
    from repro.models import sampling, transformer as tfm
    from repro.optim import adamw

    MESHES = {MESHES!r}
    CELLS = {CELLS!r}
    ARCHS = {ARCHS!r}
    B, S0, GEN, SEQ = {B}, {S0}, {GEN}, {SEQ}

    def flat(tree):
        out = {{}}
        for path, spec in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))[0]:
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                           for p in path)
            out[key] = tuple(None if e is None else
                             (e if isinstance(e, str) else tuple(e))
                             for e in spec)
        return out

    res = {{"specs": {{name: {{}} for name in MESHES}}, "steps": {{}}}}
    dev_mesh = compat.make_mesh((2, 4), ("data", "model"))
    for arch in ARCHS:
        cfg = configs.get_config(arch)
        params = steps.abstract_params(cfg)
        opt = steps.abstract_opt_state(cfg, steps.default_opt_cfg(cfg))
        cells = [(cell, steps.abstract_batch(cfg, seq, batch),
                  steps.abstract_caches(cfg, batch, seq))
                 for cell, seq, batch in CELLS]
        for name, (shape, axes) in MESHES.items():
            mesh = dev_mesh if name == "2x4" else AbstractMesh(shape, axes)
            r = {{"params": flat(sharding.param_specs(mesh, cfg, params)),
                  "opt": flat(sharding.opt_specs(mesh, cfg, opt))}}
            for cell, b, c in cells:
                r["batch/" + cell] = flat(sharding.batch_specs(mesh, cfg, b))
                r["caches/" + cell] = flat(sharding.cache_specs(mesh, cfg,
                                                                c))
            res["specs"][name][arch] = r

    def inputs(vocab):
        rng = np.random.default_rng(0)
        t = rng.integers(0, vocab, (B, SEQ + 1)).astype(np.int32)
        return {{"prompts": rng.integers(0, vocab, (B, S0)).astype(np.int32),
                 "decode": rng.integers(0, vocab, (GEN, B, 1)
                                        ).astype(np.int32),
                 "tokens": t[:, :-1].copy(), "labels": t[:, 1:].copy()}}

    def run(cfg, params, x, mesh):
        named = lambda specs: sharding.to_named(mesh, specs)
        out = {{}}
        batch = {{"tokens": jnp.asarray(x["prompts"])}}
        pre = steps.make_prefill_step(cfg, mesh)
        if mesh is not None:
            pspecs = sharding.param_specs(mesh, cfg, params)
            params = jax.device_put(params, named(pspecs))
            pre = pre(batch)
        logits, caches = pre(params, batch)
        out["prefill_logits"] = np.asarray(logits)
        out["prefill_caches"] = jax.tree.map(np.asarray, caches)
        # grown from host copies: jnp.pad of the meshed prefill's output
        # under jax.set_mesh fails in the reference's JAX
        caches = tfm.grow_attn_caches(out["prefill_caches"], cfg, GEN)
        serve = steps.make_serve_step(cfg, mesh, sampler="greedy")
        if mesh is not None:
            serve, cspecs = serve(caches, B)
            caches = jax.device_put(caches, named(cspecs))
        lgs = []
        for t in range(GEN):
            _, lg, caches = serve(params, jnp.asarray(x["decode"][t]),
                                  caches, jnp.asarray(S0 + t, jnp.int32),
                                  jax.random.key(0))
            lgs.append(np.asarray(lg))
        out["decode_logits"] = np.stack(lgs)
        tb = {{k: jnp.asarray(x[k]) for k in ("tokens", "labels")}}
        opt_cfg = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
        if mesh is None:
            steps._set_moe_ctx(None)
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: tfm.train_loss(p, cfg, tb)))(params)
            fn = steps.make_train_step(cfg, None, opt_cfg)[0]
            opt = adamw.init(params, opt_cfg)
        else:
            with_batch, sh = steps.make_train_step(cfg, mesh, opt_cfg)
            fn, bspecs = with_batch(tb)
            aspec = steps.act_partition(mesh, cfg, B)
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, b: tfm.train_loss(p, cfg, b, act_spec=aspec)),
                in_shardings=(named(sh["params"]), named(bspecs)))(
                    params, tb)
            opt = jax.device_put(adamw.init(params, opt_cfg),
                                 named(sh["opt"]))
        out["grad_loss"] = float(loss)
        out["grads"] = jax.tree.map(np.asarray, grads)
        new, _, m = fn(jax.tree.map(jnp.copy, params), opt, tb)
        out["loss"] = float(m["loss"])
        out["grad_norm"] = float(m["grad_norm"])
        out["leaves"] = jax.tree.map(np.asarray, new)
        return out

    for arch in sys.argv[2].split(","):
        cfg = dataclasses.replace(configs.get_config(arch).reduced(),
                                  dtype="float32", param_dtype="float32")
        params = tfm.init_model(jax.random.PRNGKey(int(sys.argv[3])), cfg)
        x = inputs(cfg.vocab)
        with jax.set_mesh(dev_mesh):
            meshed = run(cfg, params, x, dev_mesh)
        steps._set_moe_ctx(None)
        res["steps"][arch] = {{"mesh": meshed,
                              "single": run(cfg, params, x, None)}}

    # a reduced train step's per-device argument bytes on (2, 4)
    cfg = configs.get_config("yi-9b").reduced()
    with jax.set_mesh(dev_mesh):
        with_batch, _ = steps.make_train_step(cfg, dev_mesh)
        b = steps.abstract_batch(cfg, SEQ, B)
        fn, _ = with_batch(b)
        args = (steps.abstract_params(cfg), steps.abstract_opt_state(
            cfg, steps.default_opt_cfg(cfg)), b)
        mem = fn.lower(*args).compile().memory_analysis()
    res["train_argument_bytes"] = int(mem.argument_size_in_bytes)
    steps._set_moe_ctx(None)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(res, f)
    print("REFERENCE_OK")
""").format(MESHES=MESHES, CELLS=SPEC_CELLS, ARCHS=ARCHS, B=cases.LM_B,
            S0=cases.LM_S0, GEN=cases.LM_GEN, SEQ=cases.LM_SEQ)


def run_reference(out: Path, archs=cases.LM_ARCHS,
                  seed: int = WEIGHT_SEED) -> dict:
    """The reference's rules and its (2, 4) and unsharded steps of the
    reduced `archs` on `_weights(arch, seed)`, in a subprocess with 8
    simulated host devices, written to `out`."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, "-c", _REFERENCE, str(out),
                          ",".join(archs), str(seed)],
                         env=env, capture_output=True, text=True, timeout=900)
    assert "REFERENCE_OK" in res.stdout, (res.stdout[-2000:]
                                          + res.stderr[-4000:])
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's rules and meshed steps, once a session in a
    subprocess with 8 simulated host devices."""
    def compute():
        return run_reference(tmp_path_factory.mktemp("lm_mesh")
                             / "reference.pkl")

    return cases.once_per_session(tmp_path_factory, "lm_mesh_reference",
                                  compute)


def _weights(arch: str, seed: int = WEIGHT_SEED) -> dict:
    """The reference's `init_model` tree of reduced `arch` (float32), as
    numpy: the weights every side of these tests holds."""
    cfg = dataclasses.replace(r_configs.get_config(arch).reduced(),
                              dtype="float32", param_dtype="float32")
    return jax.tree.map(np.asarray, r_tfm.init_model(
        jax.random.PRNGKey(seed), cfg))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return cases.once_per_session(
        tmp_path_factory, "lm_mesh_trees",
        lambda: {arch: _weights(arch) for arch in cases.LM_ARCHS})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, trees):
    """Every rank's LM cases on (2, 4), (1, 1), and the (2, 4) world's
    checkpoint restored on (1, 2) and (1, 1): spawned once a session."""
    def compute():
        ck = str(tmp_path_factory.mktemp("lm_mesh_ckpt"))
        run = lambda fn, shape, *args: mesh_mod.spawn(
            fn, shape[0] * shape[1], backend="gloo", device="cpu",
            timeout_s=RANK_TIMEOUT_S, mesh_shape=shape, args=args)
        out = {"2x4": run(cases.lm_mesh_cases, (2, 4), trees, ck, False),
               "1x1": run(cases.lm_mesh_cases, (1, 1), trees, ck, True),
               "restore_1x2": run(cases.lm_restore, (1, 2), trees["yi-9b"],
                                  ck),
               "ckpt": dict(t_ckpt.restore(ck, 1)[1])}
        out["restore_1x1"] = [r["restored"] for r in out["1x1"]]
        return out

    return cases.once_per_session(tmp_path_factory, "lm_mesh_ranks", compute)


@pytest.fixture(scope="module")
def single(tmp_path_factory, trees):
    """The port's single-process steps on the same weights and inputs,
    once a session."""
    return cases.once_per_session(tmp_path_factory, "lm_mesh_single",
                                  lambda: _single(trees))


def _single(trees) -> dict:
    out = {}
    for arch in cases.LM_ARCHS:
        cfg = cases.lm_cfg(arch)
        x = cases.lm_inputs(cfg.vocab)
        res = cases.lm_serve(cfg, convert.lm_params_from_reference(
            trees[arch], cfg, "cpu"), x)
        res.update(cases.lm_train(cfg, convert.lm_params_from_reference(
            trees[arch], cfg, "cpu", train=True), x))
        if arch == "yi-9b":
            res["generate"] = cases.lm_generate(
                cfg, convert.lm_params_from_reference(trees[arch], cfg,
                                                      "cpu"), x)
        out[arch] = res
    return out


# ---------------------------------------------------------------------------
# the sharding rules
# ---------------------------------------------------------------------------


def _norm(spec) -> tuple:
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


@functools.lru_cache(maxsize=None)
def _abstract(arch: str):
    """A full-width training model's and AdamW state's shapes (meta)."""
    cfg = t_configs.get_config(arch)
    return (t_steps.abstract_params(cfg, train=True),
            t_steps.abstract_opt_state(cfg, t_steps.default_opt_cfg(cfg)))


def _port_specs(mesh, cfg) -> dict:
    """The port's specs under the reference's paths: a block leaf's spec
    behind the layer axis the reference stacks it on (every layer of a
    slot has the same)."""
    model, state = _abstract(cfg.name)
    out: dict = {"params": {}, "opt": {}}
    for name, spec in sharding.param_specs(mesh, cfg, model).items():
        path = t_tfm.reference_path(name, cfg)
        scanned = path[0] == "super"
        key = "/".join(path[:-1] if scanned else path)
        spec = (None,) + spec if scanned else spec
        assert out["params"].setdefault(key, spec) == spec, key
    ospecs = sharding.opt_specs(mesh, cfg, state)
    for part in ("m", "v"):
        for name, spec in ospecs[part].items():
            path = t_tfm.reference_path(name, cfg)
            scanned = path[0] == "super"
            key = f"{part}/" + "/".join(path[:-1] if scanned else path)
            out["opt"][key] = (None,) + spec if scanned else spec
    out["opt"]["step"] = ospecs["step"]
    for cell, seq, batch in SPEC_CELLS:
        out["batch/" + cell] = sharding.batch_specs(
            mesh, cfg, t_steps.abstract_batch(cfg, seq, batch))
        cspecs = sharding.cache_specs(
            mesh, cfg, t_steps.abstract_caches(cfg, batch, seq))
        c: dict = {}
        period = len(cfg.pattern)
        for i, layer in enumerate(cspecs):
            for n, spec in layer.items():
                key = f"b{i % period}/{n}"
                assert c.setdefault(key, (None,) + spec) == (None,) + spec
        out["caches/" + cell] = c
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharding_rules_equal_the_references(reference, mesh_name):
    shape, axes = MESHES[mesh_name]
    mesh = mesh_mod.AbstractMesh(shape, axes)
    for arch in ARCHS:
        want = reference["specs"][mesh_name][arch]
        got = _port_specs(mesh, t_configs.get_config(arch))
        assert got.keys() == want.keys()
        for part in want:
            w = {k: _norm(v) for k, v in want[part].items()}
            g = {k: _norm(v) for k, v in got[part].items()}
            assert g == w, (arch, part)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = mesh_mod.abstract_mesh((2, 16, 16))
    assert sharding.placements(mesh, (("pod", "data"), None, "model")) == [
        Shard(0), Shard(0), Shard(2)]
    assert sharding.placements(mesh, (None, None)) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        sharding.placements(mesh, (("data", "pod"),))
    # a dimension over two axes: the major axis's blocks hold the minor's
    m = mesh_mod.AbstractMesh((2, 4), ("data", "model"), (1, 2))
    sl = sharding.shard_slices(m, (16, 3), (("data", "model"), None))
    assert sl == (slice(12, 14), slice(0, 3))


# ---------------------------------------------------------------------------
# the steps on 8 gloo ranks
# ---------------------------------------------------------------------------


def _scale(x) -> float:
    return float(np.abs(np.asarray(x, np.float64)).max()) or 1.0


def _gap(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def one_process_bound(k: str, r_mesh, r_one) -> float:
    """The bound on quantity k's gap of the port's meshed step from its
    one-process step: the larger of 1e-5 of its scale (`CANCEL_RTOL` for
    a cancelling leaf) and the reference's own meshed-against-unsharded
    gap."""
    cancel = k.rsplit("/", 1)[-1] in CANCELLING
    return max((CANCEL_RTOL if cancel else 1e-5) * _scale(r_one),
               _gap(r_mesh, r_one))


def _ref_caches(tree, cfg, i) -> dict:
    """Layer i's caches from the reference's stacked tree."""
    period = len(cfg.pattern)
    return {n: v[i // period] for n, v in tree[f"b{i % period}"].items()}


def _quantities(res, cfg, reference: bool) -> dict:
    """Everything a step gave, as {name: array}, gradients and leaves by
    the reference's paths (the port's through `lm_tree_from_port`)."""
    out = {"prefill_logits": res["prefill_logits"],
           "decode_logits": res["decode_logits"],
           "loss": res["loss"], "grad_loss": res["grad_loss"],
           "grad_norm": res["grad_norm"]}
    for i in range(cfg.n_layers):
        c = (_ref_caches(res["prefill_caches"], cfg, i) if reference
             else res["prefill_caches"][i])
        for n, v in c.items():
            out[f"cache/{i}/{n}"] = v
    for part in ("grads", "leaves"):
        tree = res[part] if reference else convert.lm_tree_from_port(
            res[part], cfg)
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[part + "/" + "/".join(str(p.key) for p in path)] = v
    return {k: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor)
                          else v, np.float64) for k, v in out.items()}


@pytest.mark.parametrize("arch", cases.LM_ARCHS)
def test_every_rank_returns_the_same(ranks, arch):
    rs = ranks["2x4"]
    assert [r["coords"] for r in rs] == [(i, j) for i in range(2)
                                         for j in range(4)]
    cfg = cases.lm_cfg(arch)
    first = _quantities(rs[0][arch], cfg, False)
    for r in rs[1:]:
        got = _quantities(r[arch], cfg, False)
        for k, v in first.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert torch.equal(r[arch]["ky_tokens"], rs[0][arch]["ky_tokens"])


@pytest.mark.parametrize("arch", cases.LM_ARCHS)
def test_mesh_steps_hold_against_single_process_and_reference(
        ranks, single, reference, arch):
    """The (2, 4) ranks' steps within the larger of 1e-5 of each
    quantity's scale and the reference's own meshed-against-unsharded
    gap of the port's single-process step, and within 1e-4 of the scale
    of the reference's meshed step."""
    cfg = cases.lm_cfg(arch)
    mesh = _quantities(ranks["2x4"][0][arch], cfg, False)
    one = _quantities(single[arch], cfg, False)
    r_mesh = _quantities(reference["steps"][arch]["mesh"], cfg, True)
    r_one = _quantities(reference["steps"][arch]["single"], cfg, True)
    assert mesh.keys() == one.keys() == r_mesh.keys() == r_one.keys()
    for k in mesh:
        scale = _scale(r_one[k])
        cancel = k.rsplit("/", 1)[-1] in CANCELLING
        bound = one_process_bound(k, r_mesh[k], r_one[k])
        assert _gap(mesh[k], one[k]) <= bound, (k, _gap(mesh[k], one[k]),
                                                bound)
        # where the reference's mesh moves further from its own unsharded
        # step than that: the path mesh -> one process -> the reference's
        # one process -> its mesh
        ref_bound = max((CANCEL_RTOL if cancel else 1e-4) * scale,
                        _gap(mesh[k], one[k]) + _gap(one[k], r_one[k])
                        + _gap(r_one[k], r_mesh[k]))
        assert _gap(mesh[k], r_mesh[k]) <= ref_bound, (
            k, _gap(mesh[k], r_mesh[k]), ref_bound)


@pytest.mark.parametrize("arch", cases.LM_ARCHS)
def test_mesh_token_draw_is_the_single_process_draw(ranks, single, arch):
    """Every rank draws the whole batch from the gathered logits with the
    step's key: the tokens equal the one-device draw on those logits,
    and the one-device step's tokens where the logits are the same."""
    from repro_torch import prng

    r = ranks["2x4"][0][arch]
    key = prng.key(cases.LM_KEY)
    for t in range(cases.LM_GEN):
        key, sub = prng.split(key)
        want = t_sampling.sample_tokens(r["decode_logits"][t], sub, "ky")
        assert torch.equal(r["ky_tokens"][t], want)
        if torch.equal(r["decode_logits"][t], single[arch]["decode_logits"][t]):
            assert torch.equal(r["ky_tokens"][t], single[arch]["ky_tokens"][t])


def test_meshed_generate_keeps_each_rank_to_its_rows(ranks, single):
    """`serve.generate` on (2, 4) draws the one-process tokens, and no
    rank makes a K/V tensor beyond its own rows of the grown cache (the
    whole cache is dp = 2 times that, as one process holds it)."""
    cfg = cases.lm_cfg("yi-9b")
    whole = (cases.LM_B * (cases.LM_S0 + cases.LM_GEN) * cfg.n_kv_heads
             * cfg.hd)
    want = single["yi-9b"]["generate"]
    assert want["kv_peak"] == whole
    for r in ranks["2x4"]:
        got = r["yi-9b"]["generate"]
        assert torch.equal(got["tokens"], want["tokens"])
        assert 0 < got["kv_peak"] <= whole // 2


@pytest.mark.parametrize("arch", cases.LM_ARCHS)
def test_one_by_one_world_is_bit_equal_to_single_process(ranks, single,
                                                         arch):
    cfg = cases.lm_cfg(arch)
    got = _quantities(ranks["1x1"][0][arch], cfg, False)
    want = _quantities(single[arch], cfg, False)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert torch.equal(ranks["1x1"][0][arch]["ky_tokens"],
                       single[arch]["ky_tokens"])


# ---------------------------------------------------------------------------
# tensor-parallel compute on the model axis
# ---------------------------------------------------------------------------


def _plan(cfg, shape):
    """(a rank's `collectives.Plan` of `cfg` at coordinate 0 of a
    shape-only (data, model) mesh, over meta shards; each leaf's whole
    element count)."""
    from repro_torch.launch import collectives

    mesh = mesh_mod.AbstractMesh(shape, ("data", "model"))
    model = t_steps.abstract_params(cfg)
    specs = sharding.param_specs(mesh, cfg, model)
    shards = sharding.distribute(mesh, model, specs, cfg=cfg)
    plan = collectives.Plan(collectives.Comm(mesh), cfg,
                            dict(shards.named_parameters()), specs)
    return plan, {n: p.numel() for n, p in model.named_parameters()}


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _part(name: str) -> str:
    """A block leaf's part: "core", "ffn" or "shared" (blocks.i.<...>)."""
    path = name.split(".")
    return "shared" if path[2:4] == ["ffn", "shared"] else path[2]


def _split_by_rule(cfg, name: str, spec) -> bool:
    """Whether a block leaf is computed split: the rules name the model
    axis in its spec (every mixer's and FFN's split leaves are)."""
    return "model" in spec


# the split block leaves of full-width yi-9b: 32 query heads and d_ff
# 11,008 divide both model axes, its 4 KV heads divide 4 but not 16
YI_SPLIT = {(2, 4): {"core.wq", "core.wk", "core.wv", "core.wo", "ffn.wg",
                     "ffn.wu", "ffn.wd"},
            (16, 16): {"core.wq", "core.wo", "ffn.wg", "ffn.wu", "ffn.wd"}}


@pytest.mark.parametrize("shape", [(2, 4), (16, 16)])
@pytest.mark.parametrize("arch", ["yi-9b", "qwen2-moe-a2.7b",
                                  "jamba-1.5-large-398b", "xlstm-350m"])
def test_a_rank_gathers_its_model_share_of_each_split_leaf(arch, shape):
    """Shape only, at full width: `Plan.block` of every slot of the
    pattern keeps a leaf split over the model axis exactly where the
    reference's rules (`sharding.param_spec`) split it (attention heads,
    Mamba's d_inner, the xLSTM mixers' heads, head dims and output
    columns, the MoE experts' hidden dim, the dense and shared experts'
    d_ff), and a rank's gathered bytes of such a leaf are the whole
    leaf's divided by the model axis; every other block leaf (the norms,
    the router, the mLSTM gates, xlstm-350m's 4 mLSTM heads on 16 ranks,
    K/V projections whose heads do not divide the axis) is whole.  The
    block's `ModelSplit` names the parts those leaves belong to."""
    cfg = t_configs.get_config(arch)
    plan, whole = _plan(cfg, shape)
    for i in range(len(cfg.pattern)):
        prefix = f"blocks.{i}."
        blk, split = plan.block(i)
        got = _flat(blk, prefix)
        assert got.keys() == {n for n in plan.leaves if n.startswith(prefix)}
        split_names = set()
        for name, t in got.items():
            if _split_by_rule(cfg, name, plan.specs[name]):
                split_names.add(name)
                assert t.numel() * shape[1] == whole[name], name
            else:
                assert t.numel() == whole[name], name
        assert (set() if split is None else split.parts) == {
            _part(n) for n in split_names}, i
        if arch == "yi-9b":
            assert {n[len(prefix):] for n in split_names} == YI_SPLIT[shape]
    if arch == "jamba-1.5-large-398b":  # Mamba's channels split
        mamba = cfg.pattern.index("mamba")
        assert "core" in plan.split(mamba).parts


def _model_sums(cfg, plan, step: str) -> int:
    """The all-reduces over the model axis a prefill or a decode step
    makes: the embedding's sum, and each layer's split parts' (an FFN
    part one; attention's `wo` sum, and in decode its sequence-split
    output's; Mamba's x_proj and out_proj sums; an mLSTM's decode
    readout over its split key dim; none for an sLSTM, whose split
    recurrence and output gather)."""
    n = 1
    for i in range(cfg.n_layers):
        split = plan.split(i)
        if split is None:
            continue
        n += len(split.parts - {"core"})
        if "core" not in split.parts:
            continue
        kind = cfg.pattern[i % len(cfg.pattern)]
        if kind in t_tfm.ATTN_KINDS:
            n += 1 + (step == "decode")
        elif kind == "mamba":
            n += 2
        elif kind == "mlstm":
            n += step == "decode"
    return n


@pytest.mark.parametrize("arch", cases.LM_ARCHS)
def test_split_leaves_are_not_gathered_over_the_model_axis(ranks, arch):
    """Counted on every (2, 4) rank's `Comm`, in the prefill, the decode
    steps and a train step's gradient pass: no block leaf the rules
    split over the model axis (attention, Mamba and xLSTM mixers, MLP,
    MoE experts, shared experts) is all-gathered over it, and the model
    axis's all-reduces are the embedding's sum and the sums each split
    part of each layer needs (`_model_sums`), in the prefill and in each
    decode step, and at least the forward's and the backward's of each
    part in training."""
    cfg = cases.lm_cfg(arch)
    plan, _ = _plan(cfg, (2, 4))
    parts = sum(len(s.parts) for s in map(plan.split, range(cfg.n_layers))
                if s is not None)
    assert parts == {"yi-9b": 4, "qwen2-moe-a2.7b": 6, "xlstm-350m": 8,
                     "jamba-1.5-large-398b": 16}[arch]
    want = {"prefill": _model_sums(cfg, plan, "prefill"),
            "decode": cases.LM_GEN * _model_sums(cfg, plan, "decode")}
    for r in ranks["2x4"]:
        for step, rec in r[arch]["comm"].items():
            blocks = {n: a for n, a in rec["leaf_axes"].items()
                      if n.startswith("blocks.")}
            assert len(blocks) == sum(n.startswith("blocks.")
                                      for n in plan.specs)
            for name, axes in blocks.items():
                spec = plan.specs[name]
                split = _split_by_rule(cfg, name, spec)
                assert ("model" in axes) == ("model" in spec and not split), (
                    step, name, axes)
            got = rec["axis_count"].get("all-reduce over model", 0)
            if step in want:
                assert got == want[step], (step, got, want[step])
            else:
                assert got >= 2 * parts + 1, (step, got)


@pytest.mark.parametrize("arch", ["yi-9b", "jamba-1.5-large-398b"])
def test_decode_moves_no_cache_over_the_model_axis(arch):
    """Shape only, reduced, on (2, 4): a decode step whose K/V caches are
    split by sequence over the model axis (32 or 64 slots, 8 or 16 a
    rank) moves the same bytes over that axis at either length (every
    query head's queries, the ranks' per-query (max, sum) pairs and
    partial outputs: no cache slot crosses it), where gathering the
    cache's sequence would double them."""
    from repro_torch.launch import dryrun

    cfg = t_configs.get_config(arch).reduced()
    mesh = mesh_mod.AbstractMesh((2, 4), ("data", "model"))
    got = {}
    for seq in (32, 64):
        fn, args, _, _ = dryrun.cell_inputs(cfg, "decode", seq, 8, mesh)
        attn = [i for i in range(cfg.n_layers)
                if cfg.pattern[i % len(cfg.pattern)] == "attn"]
        _, cspecs = t_steps.make_serve_step(cfg, mesh)(args[2], 8)
        assert attn and all(cspecs[i]["k"][1] == "model" for i in attn)
        with dryrun.shape_only_paths():
            fn(*args)
        got[seq] = {k: v for k, v in fn.comm.axis_bytes.items()
                    if k.endswith("over model")}
        assert got[seq].get("all-gather over model", 0) > 0
    assert got[32] == got[64]


def test_kv_projections_read_in_part_get_whole_gradients(ranks, single):
    """The trouble spot of a leaf replicated over the model axis but read
    in part inside the split region: reduced yi-9b on (2, 4) has 4 query
    heads, one a model rank, and 2 KV heads, which do not divide the
    axis, so wk/wv stay whole on every rank and each rank projects only
    the KV head its query head reads.  Each rank's gradient of them is
    then partial, and the gather's backward sums it over the model axis
    as well as over dp: every rank's whole wk/wv gradients are within
    1e-5 of their scale of the single-process step's (a missing sum
    leaves each rank a quarter of the heads' terms)."""
    cfg = cases.lm_cfg("yi-9b")
    plan, _ = _plan(cfg, (2, 4))
    one = single["yi-9b"]["grads"]
    names = [n for n in one if n.endswith(("core.wk", "core.wv"))]
    assert len(names) == 2 * cfg.n_layers
    for name in names:
        q = name[:-2] + "wq"
        assert "model" in plan.specs[q] and "model" not in plan.specs[name]
        assert plan.split(int(name.split(".")[1])).parts >= {"core"}
    for r in ranks["2x4"]:
        assert r["yi-9b"]["comm"]["train"]["leaf_axes"][names[0]] == (
            "data",)
        for name in names:
            got, want = r["yi-9b"]["grads"][name], one[name]
            assert _gap(got, want) <= 1e-5 * _scale(want), name


def test_resumed_mesh_run_is_bit_equal(ranks):
    for r in ranks["2x4"]:
        res = r["yi-9b"]
        assert res["second"].keys() == res["second_resumed"].keys()
        for n in res["second"]:
            assert torch.equal(res["second"][n], res["second_resumed"][n]), n


@pytest.mark.parametrize("world", ["restore_1x2", "restore_1x1"])
def test_checkpoint_restores_onto_other_meshes(ranks, world):
    """The (2, 4) checkpoint holds the one-device layout and comes back
    onto (1, 2) and 1 x 1 bit for bit: the leaves the (2, 4) ranks held
    after the step, and the stored first moments."""
    saved = ranks["2x4"][0]["yi-9b"]["leaves"]
    stored = ranks["ckpt"]
    for r in ranks[world]:
        for n, t in r["leaves"].items():
            assert torch.equal(t, saved[n]), n
            np.testing.assert_array_equal(t.numpy(), stored[f"params/{n}"])
        for n, t in r["m"].items():
            np.testing.assert_array_equal(t.numpy(), stored[f"opt/m/{n}"])


# ---------------------------------------------------------------------------
# binding and refusals
# ---------------------------------------------------------------------------


def test_a_meshed_step_takes_whole_or_placed_inputs():
    """On a shape-only mesh, place_batch-style shards and whole tensors
    give a rank the same rows."""
    from repro_torch.launch import collectives

    mesh = mesh_mod.AbstractMesh((2, 4), ("data", "model"), (1, 3))
    comm = collectives.Comm(mesh)
    whole = torch.arange(8 * 5).reshape(8, 5)
    assert torch.equal(comm.own(whole, ("data", None)), whole[4:])
    assert torch.equal(comm.own_rows(whole), whole[4:])
    assert torch.equal(comm.own(whole, (("data", "model"), None)),
                       whole[7:8])
    assert comm.link(("model",)) == "nvlink"
    big = collectives.Comm(mesh_mod.abstract_mesh((16, 16)))
    assert big.link(("model",)) == "network"


def test_steps_refuse_what_is_not_a_mesh():
    cfg = t_configs.get_config("yi-9b").reduced()
    for make in (t_steps.make_train_step, t_steps.make_prefill_step,
                 t_steps.make_serve_step):
        with pytest.raises(ValueError, match="not a mesh"):
            make(cfg, object())
