"""Model assembly: blocks, embedding and frontends, the training loss,
prefill and decode.

Port of `repro/models/transformer.py`: the attention (`attn`,
`attn_chunked`), Mamba, mLSTM and sLSTM mixers, with the SwiGLU or MoE
FFN.  The reference runs `lax.scan` over `n_super` stacked superblocks of
the config's pattern, rematerialised per superblock; here the layer stack
is a Python loop over a per-layer `nn.ModuleList` (layer i is slot
i % period of superblock i // period), checkpointed per superblock in
training (`torch.utils.checkpoint`), and the caches are a list with one
entry per layer: `{"k", "v"}` for attention, the recurrent state for the
others.  Serving (`forward`, `prefill`, `decode_step`) runs without
autograd; training (`train_forward`, `train_loss`) with it, and adds the
MoE FFNs' switch loss.

On a mesh of ranks each function takes `shard`, the rank's
`launch/collectives.Plan`: the model's leaves are then the rank's shards,
and each block's leaves are gathered just before the block runs (inside
the superblock's checkpoint in training, so the backward gathers them
again, and the recompute issues the region's sums again), as the
reference's GSPMD gathers its FSDP-sharded weights per scanned layer.
Where the rules split an attention's heads, a Mamba mixer's d_inner, an
xLSTM mixer's heads, head dims or output columns, the FFN's d_ff, the
experts' hidden dim or the shared experts' d_ff over the model axis, the
block gets those leaves still split and its `ModelSplit` (`Plan.block`),
and the layers compute the rank's heads, channels and columns and sum
or gather the partial outputs over the axis (tensor parallelism).  The
embedding and the head stay split over the model axis by vocabulary (a
masked lookup summed over it; a column block of logits gathered over
it).  A decode cache is read as the rank stores it, its rows and its
block of the dimensions the rules split over the model axis (a
recurrent state's channels or head dims; an attention's sequence, which
decode attends where it lies, `collectives.SeqSplit`), every other
dimension gathered before the layer and its block written back after (a
prefill's and a new token's K/V of the rank's heads are gathered over
the model axis to every KV head, `layers.whole_kv`; an mLSTM's prefill
state by head is moved to its stored head-dim blocks,
`xlstm.mlstm_stored`).  The counterpart of the reference's `act_spec`
constraints.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, moe as moe_mod, ssm, xlstm
from repro_torch.models.layers import Params

FRONTEND_DIM = 1024  # feature dim delivered by the (stubbed) modality encoder
ATTN_KINDS = ("attn", "attn_chunked")

# ---------------------------------------------------------------------------
# single block (mixer + optional FFN/MoE)
# ---------------------------------------------------------------------------


def init_block(gen, cfg: ModelConfig, slot: int, device) -> Params:
    kind = cfg.pattern[slot]
    f32 = dict(dtype=torch.float32, device=device)
    if kind in ATTN_KINDS:
        core = layers.init_attention(gen, cfg, device)
    elif kind == "mamba":
        core = ssm.init_mamba(gen, cfg, device)
    elif kind == "mlstm":
        core = xlstm.init_mlstm(gen, cfg, device)
    elif kind == "slstm":
        core = xlstm.init_slstm(gen, cfg, device)
    else:
        raise ValueError(kind)
    p = {"norm1": torch.ones(cfg.d_model, **f32), "core": core}
    moe_cfg = cfg.moe_for(slot)
    if moe_cfg is not None:
        p["norm2"] = torch.ones(cfg.d_model, **f32)
        p["ffn"] = moe_mod.init_moe(gen, cfg, moe_cfg, device)
    elif cfg.d_ff:
        p["norm2"] = torch.ones(cfg.d_model, **f32)
        p["ffn"] = layers.init_mlp(gen, cfg, device)
    return Params(**p)


def _mixer_apply(p, x, cfg, kind, positions, q_offset, tp=None):
    if kind in ATTN_KINDS:
        return layers.attention_apply(p, x, cfg, kind=kind,
                                      positions=positions, q_offset=q_offset,
                                      tp=tp)
    if kind == "mamba":
        return ssm.mamba_apply(p, x, cfg, **_tp(tp))
    if kind == "mlstm":
        return xlstm.mlstm_apply(p, x, cfg, **_tp(tp))
    if kind == "slstm":
        return xlstm.slstm_apply(p, x, cfg, **_tp(tp))
    raise ValueError(kind)


def _mixer_decode(p, x, cache, pos, cfg, kind, tp=None, seq=None):
    if kind in ATTN_KINDS:
        return layers.attention_decode(p, x, cache, pos, cfg, kind=kind,
                                       tp=tp, seq=seq)
    if kind == "mamba":
        return ssm.mamba_decode(p, x, cache, cfg, **_tp(tp))
    if kind == "mlstm":
        return xlstm.mlstm_decode(p, x, cache, cfg, **_tp(tp))
    if kind == "slstm":
        return xlstm.slstm_decode(p, x, cache, cfg, **_tp(tp))
    raise ValueError(kind)


def _part(split, part: str):
    """The block's `ModelSplit` for `part` ("core", "ffn"), or None."""
    return None if split is None else split.of(part)


def _tp(tp) -> dict:
    """A layer's `tp` argument where there is a region: a one-device call
    passes the layer its one-device arguments alone (a caller's wrapper
    of `mlp_apply` or `moe_apply` keeps working)."""
    return {} if tp is None else {"tp": tp}


def _ffn(p: Params, x, mix, cfg: ModelConfig, slot: int, aux=None,
         split=None):
    """x + mix, then the FFN's residual branch on it if the block has one.
    With `aux` (a list), an MoE FFN appends its switch loss to it."""
    if "ffn" not in p:
        return x + mix
    x, h = layers.add_rms_norm(x, mix, p["norm2"], cfg.norm_eps)
    moe_cfg = cfg.moe_for(slot)
    if moe_cfg is None:
        return x + layers.mlp_apply(p["ffn"], h, cfg,
                                    **_tp(_part(split, "ffn")))
    if aux is None:
        return x + moe_mod.moe_apply(p["ffn"], h, cfg, moe_cfg,
                                     **_tp(split))
    y, a = moe_mod.moe_apply(p["ffn"], h, cfg, moe_cfg, aux=True,
                             **_tp(split))
    aux.append(a)
    return x + y


def block_apply(p: Params, x, cfg: ModelConfig, slot: int, positions,
                q_offset: int = 0, aux=None, split=None):
    """(x, cache) after one block over a whole sequence; the cache is the
    attention's K/V or the recurrent mixer's state after the sequence.
    With `aux` (a list), an MoE block appends its switch loss to it.
    `split`: the block's `collectives.ModelSplit` on a mesh, or None."""
    h = layers.rms_norm(x, p["norm1"], cfg.norm_eps)
    mix, cache = _mixer_apply(p["core"], h, cfg, cfg.pattern[slot],
                              positions, q_offset, _part(split, "core"))
    return _ffn(p, x, mix, cfg, slot, aux, split), cache


def block_decode(p: Params, x, cache, pos: int, cfg: ModelConfig,
                 slot: int, split=None, seq=None):
    """(x, cache) after one block at one new position; `seq`: an
    attention cache's `collectives.SeqSplit` on a mesh, or None."""
    h = layers.rms_norm(x, p["norm1"], cfg.norm_eps)
    mix, cache = _mixer_decode(p["core"], h, cache, pos, cfg,
                               cfg.pattern[slot], _part(split, "core"), seq)
    return _ffn(p, x, mix, cfg, slot, split=split), cache


def init_block_cache(cfg: ModelConfig, slot: int, batch: int, s_max: int,
                     device):
    kind = cfg.pattern[slot]
    if kind in ATTN_KINDS:
        return layers.init_attn_cache(cfg, batch, s_max, kind, device)
    if kind == "mamba":
        return ssm.init_mamba_state(cfg, batch, device)
    if kind == "mlstm":
        return xlstm.init_mlstm_state(cfg, batch, device)
    if kind == "slstm":
        return xlstm.init_slstm_state(cfg, batch, device)
    raise ValueError(kind)


def _slot(cfg: ModelConfig, layer: int) -> int:
    return layer % len(cfg.pattern)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


# leaves a training model holds in float32 whatever the parameter type
# (the reference's Mamba `a_log` and `d_skip`)
FLOAT32_LEAVES = ("a_log", "d_skip")


def init_model(cfg: ModelConfig, *, seed: int = 0, device="cuda",
               train: bool = False) -> Params:
    """Random weights from a seeded `torch.Generator` on `device`: each
    weight drawn in float32 and cast to `cfg.dtype` one tensor at a time,
    so the peak is the model in its working type plus one float32 tensor.
    On the `meta` device, the shapes alone.  Products accumulate in float32
    from here on (`layers.accumulate_in_float32`).

    With `train`, a training model: the reference's leaves, every weight
    in `cfg.param_dtype` (Mamba's `a_log` and `d_skip` in float32, the
    norms too in the parameter type), each cast to the activation type
    where a layer reads it, and all of them trainable."""
    if train:
        pdt = getattr(torch, cfg.param_dtype)
        model = init_model(dataclasses.replace(cfg, dtype=cfg.param_dtype),
                           seed=seed, device=device)
        for name, leaf in model.named_parameters():
            leaf.data = leaf.data.to(
                torch.float32 if name.endswith(FLOAT32_LEAVES) else pdt)
        return model.requires_grad_(True)
    layers.accumulate_in_float32()
    dev = torch.device(device)
    if dev.type != "meta":  # shapes only on meta; else the card by default
        dev = device_mod.resolve(device)
    gen = None if dev.type == "meta" else torch.Generator(
        device=dev).manual_seed(seed)
    dt = cfg.act_dtype
    if dev.type == "meta":
        embed = torch.empty((cfg.vocab, cfg.d_model), dtype=dt, device=dev)
    else:
        embed = (torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                             dtype=torch.float32, device=dev) * 0.02).to(dt)
    p: dict[str, Any] = {
        "embed": embed,
        "blocks": nn.ModuleList(
            init_block(gen, cfg, _slot(cfg, i), dev)
            for i in range(cfg.n_layers)),
        "final_norm": torch.ones(cfg.d_model, dtype=torch.float32,
                                 device=dev),
    }
    if not cfg.tie_embeddings:
        p["head"] = layers.init_dense(gen, cfg.d_model, (cfg.vocab,), dt,
                                      dev)
    if cfg.frontend:
        p["frontend_proj"] = layers.init_dense(gen, FRONTEND_DIM,
                                               (cfg.d_model,), dt, dev)
    return Params(**p)


def _top(p: Params, name: str, shard):
    """Leaf `name` outside the blocks: the model's own, or gathered."""
    return p[name] if shard is None else shard.leaf(name)


def embed_inputs(p: Params, cfg: ModelConfig, batch: dict[str, Any],
                 shard=None):
    """tokens (B, S_tok) [+ features (B, S_f, FRONTEND_DIM)] -> (B, S, d).
    On a mesh, the vocabulary-parallel lookup (`Plan.embed`)."""
    if shard is None:
        x = layers.embed_rows(p["embed"], batch["tokens"], cfg)
    else:
        x = shard.embed(batch["tokens"])
    if cfg.frontend:
        feats = (batch["features"].to(cfg.act_dtype)
                 @ layers.act(_top(p, "frontend_proj", shard), cfg))
        x = torch.cat([feats, x], dim=1)
    return x


def _logits(p: Params, cfg: ModelConfig, x, shard=None):
    """float32 logits of the last hidden states; on a mesh, the
    vocabulary-parallel head (`Plan.logits`)."""
    x = layers.rms_norm(x, _top(p, "final_norm", shard), cfg.norm_eps)
    if shard is not None:
        return shard.logits(x)
    head = p["embed"].T if cfg.tie_embeddings else p["head"]
    return (x @ layers.act(head, cfg)).float()


def _block(p: Params, i: int, shard):
    """Block i's leaves and its `ModelSplit`: the model's own and None, or
    gathered on a mesh (`Plan.block`)."""
    return (p["blocks"][i], None) if shard is None else shard.block(i)


@torch.no_grad()
def forward(p: Params, cfg: ModelConfig, batch: dict[str, Any], *,
            collect_cache: bool = False, shard=None):
    """Full forward (prefill).  Returns (logits (B, S, V) float32, caches:
    one per layer, or None)."""
    x = embed_inputs(p, cfg, batch, shard)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    caches = []
    for i in range(cfg.n_layers):
        blk, split = _block(p, i, shard)
        x, cache = block_apply(blk, x, cfg, _slot(cfg, i), positions,
                               split=split)
        tp = _part(split, "core")
        if collect_cache and tp is not None:
            kind = cfg.pattern[_slot(cfg, i)]
            if kind in ATTN_KINDS:
                cache = layers.whole_kv(cache, cfg, tp)
            elif kind == "mlstm":
                cache = xlstm.mlstm_stored(cache, cfg, tp)
        caches.append(cache)
    return _logits(p, cfg, x, shard), caches if collect_cache else None


def _dots_saved(ctx, op, *args, **kwargs):
    """The "dots" remat policy: keep the outputs of products without a
    batch axis (the projections), recompute the rest, as JAX's
    `dots_with_no_batch_dims_saveable` does."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(policy: str):
    """`torch.utils.checkpoint` arguments of a remat policy."""
    if policy == "nothing":
        return {}
    if policy == "dots":
        return {"context_fn": functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_saved)}
    raise ValueError(f"unknown remat policy {policy!r}")


def train_forward(p: Params, cfg: ModelConfig, batch: dict[str, Any], *,
                  remat_policy: str = "nothing", shard=None):
    """The training forward, under autograd: (logits (B, S, V) float32,
    the MoE FFNs' switch losses summed in layer order, a float32 scalar).
    Each superblock of `len(cfg.pattern)` layers is checkpointed: its
    input is kept and its insides recomputed in the backward
    (`remat_policy` "nothing"), or its products without a batch axis kept
    too ("dots"), the reference's `jax.checkpoint` policies."""
    x = embed_inputs(p, cfg, batch, shard)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    period = len(cfg.pattern)

    def superblock(x, aux, first):
        moe = []
        # a depth cut short of a whole period ends with a partial one
        for j in range(min(period, cfg.n_layers - first)):
            blk, split = _block(p, first + j, shard)
            x, _ = block_apply(blk, x, cfg, j, positions, aux=moe,
                               split=split)
        for a in moe:
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kw = _remat(remat_policy)
    for first in range(0, cfg.n_layers, period):
        x, aux = ckpt.checkpoint(superblock, x, aux, first,
                                 use_reentrant=False, **kw)
    return _logits(p, cfg, x, shard), aux


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
    """Mean token cross-entropy in float32.  logits (B, S, V), labels
    (B, S)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


def train_loss(p: Params, cfg: ModelConfig, batch: dict[str, Any], *,
               remat_policy: str = "nothing", shard=None) -> torch.Tensor:
    """batch: tokens (B, S), labels (B, S_total); for frontend archs the
    labels cover the frontend positions too (stub targets).  The mean
    cross-entropy plus the switch losses.  On a mesh, the mean over the
    rank's rows (the step averages it over the dp ranks) plus the switch
    losses of the global batch (`moe.aux_loss` over the dp group)."""
    logits, aux = train_forward(p, cfg, batch, remat_policy=remat_policy,
                                shard=shard)
    return softmax_xent(logits, batch["labels"]) + aux


def reference_path(name: str, cfg: ModelConfig) -> tuple:
    """A leaf's place in the reference's parameter tree: the keys from
    the root, then for a block's leaf its superblock (the index into the
    stacked leaf).  `blocks.5.core.wq` at period 2 is
    ("super", "b1", "core", "wq", 2)."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return tuple(parts)
    i = int(parts[1])
    period = len(cfg.pattern)
    return ("super", f"b{i % period}", *parts[2:], i // period)


def train_leaves(p: Params, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The model's leaves by state-dict name, in the reference's leaf
    order (`jax.tree.leaves`: dict keys sorted at every level, a stacked
    leaf's superblocks in order): the order of its `global_norm` sum."""
    named = dict(p.named_parameters())
    return {n: named[n] for n in sorted(
        named, key=lambda n: reference_path(n, cfg))}


def decays(name: str, leaf: torch.Tensor) -> bool:
    """Whether AdamW decays a leaf: the reference decays leaves of two or
    more axes, and it holds every block leaf stacked over the superblocks,
    so every block leaf (norms and biases too) and, outside the blocks,
    the matrices."""
    return name.startswith("blocks.") or leaf.ndim >= 2


def prefill(p: Params, cfg: ModelConfig, batch, shard=None):
    """Returns (last-position logits (B, V), decode-ready caches);
    chunked-attention slots are rearranged into decode's ring layout.  On
    a mesh, the rank's rows, each cache in the compute layout (the step
    stores the rank's block)."""
    logits, caches = forward(p, cfg, batch, collect_cache=True, shard=shard)
    for i, cache in enumerate(caches):
        if cfg.pattern[_slot(cfg, i)] == "attn_chunked":
            for name in ("k", "v"):
                cache[name] = layers.ring_from_prefill(cache[name],
                                                       cfg.chunk_size)
    return logits[:, -1], caches


def grow_attn_caches(caches, cfg: ModelConfig, extra: int):
    """Pad full-attention K/V caches by `extra` positions (decode headroom).
    Chunked and recurrent slots are fixed-size and pass through."""
    out = []
    for i, cache in enumerate(caches):
        if cfg.pattern[_slot(cfg, i)] == "attn":
            cache = {name: torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, extra))
                     for name, kv in cache.items()}
        out.append(cache)
    return out


@torch.no_grad()
def decode_step(p: Params, cfg: ModelConfig, tokens, caches, pos: int,
                shard=None):
    """One token for every sequence.  tokens (B, 1); caches as from
    prefill/init_decode_caches, updated in place; pos the new token's
    absolute position.  Returns (logits (B, V) float32, caches).  On a
    mesh, the rank's rows, the caches its stored shards."""
    x = p["embed"][tokens] if shard is None else shard.embed(tokens)
    for i in range(cfg.n_layers):
        blk, split = _block(p, i, shard)
        if shard is None:
            x, caches[i] = block_decode(blk, x, caches[i], pos, cfg,
                                        _slot(cfg, i))
            continue
        x, new = block_decode(blk, x, shard.cache_in(i, caches[i]), pos,
                              cfg, _slot(cfg, i), split,
                              shard.seq_split(i, caches[i]))
        caches[i] = shard.cache_out(i, caches[i], new)
    return _logits(p, cfg, x, shard)[:, 0], caches


def init_decode_caches(cfg: ModelConfig, batch: int, s_max: int,
                       device="cuda"):
    """One zeroed cache per layer (an attention layer's {"k", "v"}, a
    recurrent mixer's initial state), for decode from scratch."""
    dev = torch.device(device)
    if dev.type != "meta":  # shapes only on meta, as init_model
        dev = device_mod.resolve(device)
    return [init_block_cache(cfg, _slot(cfg, i), batch, s_max, dev)
            for i in range(cfg.n_layers)]
