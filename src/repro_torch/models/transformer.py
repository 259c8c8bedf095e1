"""The multi-family LM stack: dense / MoE / RWKV6 / Mamba2-hybrid /
encoder-decoder, built from one ArchConfig.

The port of ``repro.models.transformer``.  Parameters keep the reference's
names: ``Transformer`` is an ``nn.Module`` whose parameters read like the
reference's values tree (``model["embed"]``,
``model["layers"][i]["attn"]["wq"]``); the reference stacks the layers on a
leading axis for ``lax.scan``, the port keeps an ``nn.ModuleList``
(``layers``, and ``enc_layers``/``dec_layers`` for the encoder-decoder) and
``convert.lm_params_from_numpy`` splits the stack.  The hybrid's one shared
attention block (``shared_attn``) is unstacked in both.  The model lives on
one device, CUDA unless the caller passes ``device="cpu"``, or sharded over
a mesh (``Transformer.distribute``): every parameter carries its logical
axes (``axes()``), and the reference's ``shard_act`` and ``fsdp_gather``
stand at the reference's lines (``distributed.sharding``; the identity
without a mesh).

While gradients are on, every layer body the reference wraps in
``jax.checkpoint`` (a decoder or encoder layer, an RWKV or SSM layer, the
hybrid's shared block) runs under ``cfg.remat_policy`` through
``models.remat`` (``torch.utils.checkpoint``; the default ``'nothing'``
recomputes the body, K8 included, in the backward).  The reference's
optimization barrier (``act_barrier``) has no counterpart: eager PyTorch
compiles nothing across layers.  ``prefill`` and ``decode_step`` run
without gradients; ``train_logits`` leaves that to its caller.

Behaviours kept from the reference so both packages serve the same tokens:
decode ropes every row at ``cache.length[0]``; a window schedule (gemma3)
keeps the flash route off K8 (it attends blockwise with the layer's
window); the MoE decode routes at capacity factor 2.0; the encoder-decoder's
decode cache holds zero-length cross caches (``enc_len=0``), which nothing
fills, so decode's cross attention adds 0.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import Tensor, resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import fsdp_gather, shard_act
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (apply_m_rope, apply_rope, dense_init,
                                       embed_init, embed_lookup, init_device,
                                       layer_norm, ones_init, rms_norm,
                                       sinusoidal, unembed, with_axes,
                                       zeros_init)
from repro_torch.models.remat import remat
from repro_torch.optim.optimizers import tree_map

# the parameter lists the reference stacks on a leading 'layers' axis
STACKED = ("layers", "enc_layers", "dec_layers")


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a config no package can build: a width the
    RWKV heads do not divide (M-RoPE sections that do not cover head_dim / 2
    raise in ``apply_m_rope``).  Every registry config passes."""
    if cfg.rwkv and cfg.d_model % cfg.rwkv_head_dim:
        raise ValueError(f"rwkv_head_dim {cfg.rwkv_head_dim} does not divide "
                         f"d_model {cfg.d_model}")


class ParamTree(nn.Module):
    """A nested dict of tensors as an ``nn.Module``: a mapping becomes a
    child ``ParamTree``, a list of mappings an ``nn.ModuleList`` of them, a
    tensor a parameter.  Read by the reference's names with ``[]``, ``in``
    and ``get``."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, Mapping):
                self.add_module(name, ParamTree(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(name, nn.ModuleList(ParamTree(v)
                                                    for v in val))
            else:
                self.register_parameter(name, nn.Parameter(val))

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        if key in self._modules:
            return self._modules[key]
        raise KeyError(key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def get(self, key: str, default=None):
        return self[key] if key in self else default

    def keys(self) -> List[str]:
        return list(self._parameters) + list(self._modules)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _norm(cfg: ArchConfig, p, x: Tensor, name: str) -> Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p[f"{name}_w"], p[f"{name}_b"], cfg.rms_eps)
    return rms_norm(x, p[f"{name}_w"], cfg.rms_eps)


def _norm_init(cfg: ArchConfig, d: int, name: str,
               device=None) -> Dict[str, Tensor]:
    ax = ("embed_no_shard",)
    if cfg.norm == "layernorm":
        return {f"{name}_w": ones_init((d,), ax, cfg.dtype, device),
                f"{name}_b": zeros_init((d,), ax, cfg.dtype, device)}
    return {f"{name}_w": zeros_init((d,), ax, cfg.dtype, device)}


def _position_row(table: Tensor, length: Tensor) -> Tensor:
    """The absolute-position row (1, 1, d) at row 0's cache length, the
    start clamped into the table as the reference's dynamic_slice clamps
    it."""
    pos = length[:1].clamp(0, table.shape[0] - 1)
    return table.index_select(0, pos)[None]


def _residual(x: Tensor, h: Tensor) -> Tensor:
    """x + h, a block's output h first reduced to the activations' batch
    placements under a mesh (its partial sums over 'model' summed), so the
    residual stream stays whole over 'model'."""
    return x + shard_act(h, ("batch", None, None))


def _scale_embed(cfg: ArchConfig, x: Tensor) -> Tensor:
    """x * sqrt(d_model), the factor rounded to x's dtype as the reference
    rounds it."""
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()


def _rope(cfg: ArchConfig, x: Tensor, positions: Tensor) -> Tensor:
    """RoPE on x (B, T, H, D) at positions (B, T); M-RoPE's three streams
    are (t, t, t), the text tokens' degenerate streams."""
    if cfg.m_rope:
        pos3 = positions[..., None].expand(*positions.shape, 3)
        return apply_m_rope(x, pos3, cfg.rope_theta, cfg.m_rope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


# ---------------------------------------------------------------------------
# attention sub-block
# ---------------------------------------------------------------------------


def attn_init(generator: Optional[torch.Generator], cfg: ArchConfig) -> Dict:
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    dev = init_device(generator)
    p = {
        "wq": dense_init(generator, (d, nq), ("embed", "heads"), cfg.dtype),
        "wk": dense_init(generator, (d, nkv), ("embed", "kv"), cfg.dtype),
        "wv": dense_init(generator, (d, nkv), ("embed", "kv"), cfg.dtype),
        "wo": dense_init(generator, (nq, d), ("heads", "embed"), cfg.dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros_init((nq,), ("heads",), cfg.dtype, dev)
        p["bk"] = zeros_init((nkv,), ("kv",), cfg.dtype, dev)
        p["bv"] = zeros_init((nkv,), ("kv",), cfg.dtype, dev)
    return p


def _qkv(cfg: ArchConfig, p, xq: Tensor, xkv: Tensor):
    b, tq, _ = xq.shape
    tk = xkv.shape[1]
    hd = cfg.head_dim
    q = xq @ fsdp_gather(p["wq"], ("embed", "heads")).to(xq.dtype)
    k = xkv @ fsdp_gather(p["wk"], ("embed", "kv")).to(xq.dtype)
    v = xkv @ fsdp_gather(p["wv"], ("embed", "kv")).to(xq.dtype)
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = shd.split_last(q, cfg.n_heads, hd)
    k = shd.split_last(k, cfg.n_kv_heads, hd)
    v = shd.split_last(v, cfg.n_kv_heads, hd)
    q = shard_act(q, ("batch", None, "heads", None))
    k = shard_act(k, ("batch", None, "kv", None))
    v = shard_act(v, ("batch", None, "kv", None))
    return q, k, v


def attn_apply_full(
    cfg: ArchConfig,
    p,
    x: Tensor,
    window: Union[int, Tensor],
    *,
    causal: bool = True,
    kv_x: Optional[Tensor] = None,       # cross attention source
) -> Tensor:
    """Training/prefill attention over a full sequence: K8 on the flash
    route (``attn_impl='pallas'``) on a CUDA device unless the config has a
    window schedule, else blockwise.  Self attention ropes at positions
    0..T-1 when ``cfg.pos == 'rope'``; cross attention never ropes."""
    b, t, _ = x.shape
    q, k, v = _qkv(cfg, p, x, kv_x if kv_x is not None else x)
    rope = cfg.pos == "rope" and kv_x is None

    flash = cfg.attn_impl == "pallas" and not cfg.window_pattern

    def attend(q, k, v, q_offset):
        if rope:
            tq, tk = q.shape[1], k.shape[1]
            q_pos = q_offset + torch.arange(tq, device=q.device)
            k_pos = torch.arange(tk, device=q.device)
            q = _rope(cfg, q, q_pos[None].expand(q.shape[0], tq))
            k = _rope(cfg, k, k_pos[None].expand(k.shape[0], tk))
        if flash:
            return attn_mod.flash_attention(q, k, v, causal=causal,
                                            q_offset=q_offset,
                                            block_q=cfg.block_q,
                                            block_k=cfg.block_k)
        return attn_mod.blockwise_attention(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            block_q=cfg.block_q, block_k=cfg.block_k)

    out = attn_mod.local_heads(attend, q, k, v)
    # the merged heads sharded as wo's rows: the product stays local, and
    # its gradient comes back whole over 'model' before it splits the heads
    out = shd.relayout(out.reshape(b, t, cfg.n_heads * cfg.head_dim),
                       ("batch", None, "heads"))
    wo = fsdp_gather(p["wo"], ("heads", "embed"))
    return out @ wo.to(x.dtype)


def attn_apply_decode(
    cfg: ArchConfig,
    p,
    x: Tensor,             # (B, 1, d)
    cache: KVCache,
    window: Union[int, Tensor],
    *,
    cross: bool = False,
) -> Tuple[Tensor, KVCache]:
    """One token per row.  Every row is roped at ``cache.length[0]`` while
    ``KVCache.append`` writes each row at its own length: the reference's
    behaviour, kept so both packages serve the same tokens.  ``cross``
    attends the cache's (encoder) keys as they are and appends nothing."""
    b = x.shape[0]
    hd = cfg.head_dim
    if cross:
        q = x @ p["wq"].to(x.dtype)
        if "bq" in p:
            q = q + p["bq"].to(q.dtype)
        q = shd.split_last(q, cfg.n_heads, hd)
        out = attn_mod.decode_attend(q, cache, window=0)
        out = out.reshape(b, 1, cfg.n_heads * hd)
        return out @ p["wo"].to(x.dtype), cache
    q, k, v = _qkv(cfg, p, x, x)
    def rope(q, k, length):
        positions = length[:1].expand(q.shape[0])[:, None]
        return _rope(cfg, q, positions), _rope(cfg, k, positions)

    out, cache = attn_mod.decode_attend(
        q, cache, window=window, new_kv=(k, v),
        rope=rope if cfg.pos == "rope" else None)
    out = out.reshape(b, 1, cfg.n_heads * hd)
    return out @ p["wo"].to(x.dtype), cache


# ---------------------------------------------------------------------------
# decoder layer (dense / moe)
# ---------------------------------------------------------------------------


def layer_init(generator: Optional[torch.Generator], cfg: ArchConfig,
               cross: bool = False) -> Dict:
    d = cfg.d_model
    dev = init_device(generator)
    p: Dict[str, Any] = {"attn": attn_init(generator, cfg)}
    p.update(_norm_init(cfg, d, "ln_attn", dev))
    if cross:
        p["cross"] = attn_init(generator, cfg)
        p.update(_norm_init(cfg, d, "ln_cross", dev))
    if cfg.family == "moe":
        p["moe"] = moe_mod.moe_init(generator, d, cfg.d_ff, cfg.n_experts,
                                    cfg.dtype)
    else:
        p["mlp"] = ffn_mod.mlp_init(generator, d, cfg.d_ff, cfg.dtype,
                                    gated=(cfg.act == "silu"))
    p.update(_norm_init(cfg, d, "ln_mlp", dev))
    return p


def layer_apply_full(
    cfg: ArchConfig, p, x: Tensor, window, *, causal: bool = True,
    enc_out: Optional[Tensor] = None,
) -> Tuple[Tensor, Dict]:
    aux: Dict[str, Tensor] = {}
    h = attn_apply_full(cfg, p["attn"], _norm(cfg, p, x, "ln_attn"), window,
                        causal=causal)
    x = _residual(x, h)
    if "cross" in p and enc_out is not None:
        h = attn_apply_full(cfg, p["cross"], _norm(cfg, p, x, "ln_cross"), 0,
                            causal=False, kv_x=enc_out)
        x = _residual(x, h)
    if cfg.family == "moe":
        h, aux = moe_mod.moe_apply(p["moe"], _norm(cfg, p, x, "ln_mlp"),
                                   capacity_factor=cfg.capacity_factor,
                                   activation=cfg.act)
    else:
        h = ffn_mod.mlp_apply(p["mlp"], _norm(cfg, p, x, "ln_mlp"), cfg.act)
    return shard_act(_residual(x, h), ("batch", None, None)), aux


def layer_apply_decode(
    cfg: ArchConfig, p, x: Tensor, cache: KVCache, window,
    cross_cache: Optional[KVCache] = None,
) -> Tuple[Tensor, KVCache]:
    h, cache = attn_apply_decode(cfg, p["attn"], _norm(cfg, p, x, "ln_attn"),
                                 cache, window)
    x = _residual(x, h)
    if "cross" in p and cross_cache is not None:
        h, _ = attn_apply_decode(cfg, p["cross"], _norm(cfg, p, x, "ln_cross"),
                                 cross_cache, 0, cross=True)
        x = _residual(x, h)
    if cfg.family == "moe":
        # the reference's decode capacity, not cfg.capacity_factor
        h, _ = moe_mod.moe_apply(p["moe"], _norm(cfg, p, x, "ln_mlp"),
                                 capacity_factor=2.0, activation=cfg.act)
    else:
        h = ffn_mod.mlp_apply(p["mlp"], _norm(cfg, p, x, "ln_mlp"), cfg.act)
    return _residual(x, h), cache


# ---------------------------------------------------------------------------
# rwkv / ssm layers (attention-free families)
# ---------------------------------------------------------------------------


def rwkv_layer_init(generator: Optional[torch.Generator],
                    cfg: ArchConfig) -> Dict:
    d = cfg.d_model
    p: Dict[str, Any] = {"time_mix": rwkv_mod.rwkv_block_init(
        generator, d, cfg.rwkv_head_dim, dtype=cfg.dtype)}
    p.update(_norm_init(cfg, d, "ln_attn", init_device(generator)))
    p["mlp"] = ffn_mod.mlp_init(generator, d, cfg.d_ff, cfg.dtype,
                                gated=True)
    p.update(_norm_init(cfg, d, "ln_mlp", init_device(generator)))
    return p


def ssm_layer_init(generator: Optional[torch.Generator],
                   cfg: ArchConfig) -> Dict:
    d = cfg.d_model
    p: Dict[str, Any] = {"ssm": ssm_mod.ssm_block_init(
        generator, d, cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_expand,
        cfg.dtype)}
    p.update(_norm_init(cfg, d, "ln_attn", init_device(generator)))
    return p


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def init_tree(cfg: ArchConfig, generator: Optional[torch.Generator]
              ) -> Dict[str, Any]:
    """The parameters as a nested dict of tensors on the generator's
    device, in the reference's names and draw order, each with its logical
    axes (``tensor.axes``).  Without a generator: meta tensors, nothing
    drawn or allocated."""
    dev = init_device(generator)
    p: Dict[str, Any] = {
        "embed": embed_init(generator, cfg.padded_vocab, cfg.d_model,
                            cfg.dtype)}
    p.update(_norm_init(cfg, cfg.d_model, "ln_f", dev))
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(generator, (cfg.padded_vocab, cfg.d_model),
                                  ("vocab", "embed_no_shard"), cfg.dtype,
                                  fan_in=cfg.d_model)
    if cfg.is_encdec:
        p["enc_layers"] = [layer_init(generator, cfg)
                           for _ in range(cfg.enc_layers)]
        p["dec_layers"] = [layer_init(generator, cfg, cross=True)
                           for _ in range(cfg.dec_layers)]
        p.update(_norm_init(cfg, cfg.d_model, "ln_enc", dev))
        # absolute positions for whisper-style models
        table = torch.empty((cfg.max_abs_pos, cfg.d_model), device=dev) \
            if dev.type == "meta" else sinusoidal(cfg.max_abs_pos, cfg.d_model)
        p["pos_embed"] = with_axes(table.to(device=dev, dtype=cfg.dtype),
                                   ("seq", "embed_no_shard"))
    elif cfg.rwkv:
        p["layers"] = [rwkv_layer_init(generator, cfg)
                       for _ in range(cfg.n_layers)]
    elif cfg.family == "hybrid":
        p["layers"] = [ssm_layer_init(generator, cfg)
                       for _ in range(cfg.n_layers)]
        p["shared_attn"] = layer_init(generator, cfg)  # ONE shared block
    else:
        p["layers"] = [layer_init(generator, cfg)
                       for _ in range(cfg.n_layers)]
    return p


def param_shapes(cfg: ArchConfig) -> Dict[str, Any]:
    """The parameter tree as meta tensors (shapes and dtypes, each with its
    ``axes``), in the port's layout: nothing drawn or allocated."""
    return init_tree(cfg, None)


def param_axes(cfg: ArchConfig) -> Dict[str, Any]:
    """The logical axes of every parameter, in the port's layout (a layer
    leaf's axes are the reference's stacked axes less their leading
    ``"layers"``, which resolves to no mesh axis)."""
    return tree_map(lambda t: t.axes, param_shapes(cfg))


class Transformer(ParamTree):
    """The LM of any registry family on one device, or sharded over a
    mesh (``distribute``).

    ``generator`` seeds the parameters (default: a CPU generator at seed
    0).  They are drawn on the generator's device and moved: a CPU
    generator gives one model on every device, a CUDA generator draws a
    model too large for the host on the card.
    """

    def __init__(self, cfg: ArchConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        check_supported(cfg)
        dev = resolve_device(device, "Transformer")
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        # on the meta device: the shapes alone, nothing drawn
        super().__init__(init_tree(cfg, None if dev.type == "meta" else gen))
        self.cfg = cfg
        self.device = dev
        self.to(dev)

    # ---- logical axes and sharding ---------------------------------------

    def axes(self) -> Dict[str, Any]:
        """The parameters' logical axes tree (``param_axes``)."""
        return param_axes(self.cfg)

    def param_shapes(self) -> Dict[str, Any]:
        """The parameters as meta tensors (``param_shapes``)."""
        return param_shapes(self.cfg)

    def distribute(self, mesh, rules=None, placements=None) -> "Transformer":
        """Shard the parameters over ``mesh`` (an ``LMMesh``) in place: each
        becomes a DTensor at its guarded placements
        (``sharding.guarded_shardings``, or ``placements``), placed by
        ``sharding.place`` (``distribute_tensor``: every rank keeps its
        shard of the same global value; a meta model becomes zeros of
        each rank's shard).  The model's device becomes the mesh's.
        Returns the model."""
        if placements is None:
            placements = shd.guarded_shardings(self, self.axes(), mesh,
                                               rules)
        placed = shd.place(self, placements, mesh)
        self.device = torch.device(mesh.device_mesh.device_type)
        for name, _ in list(self.named_parameters()):
            path = name.split(".")
            owner = self.get_submodule(".".join(path[:-1]))
            leaf = placed
            for key in path:
                leaf = leaf[int(key) if isinstance(leaf, list) else key]
            owner.register_parameter(path[-1], nn.Parameter(leaf))
        return self

    # ---- layer-window schedule ---------------------------------------------

    def windows(self, n_layers: int) -> List[int]:
        """Each layer's attention window (0: global): the reference's
        ``window_schedule``, as Python ints."""
        return [self.cfg.window_for_layer(i) for i in range(n_layers)]

    # ---- inputs -------------------------------------------------------------

    def as_tokens(self, tokens) -> Tensor:
        if isinstance(tokens, np.ndarray):
            tokens = torch.from_numpy(tokens)
        return tokens.to(device=self.device, dtype=torch.int64)

    def as_embeds(self, embeds) -> Tensor:
        """Frame or patch embeddings (B, T, d_model) on the model's device
        in its dtype (the reference's input spec for ``input_mode =
        'embeds'``)."""
        if isinstance(embeds, np.ndarray):
            embeds = torch.from_numpy(np.asarray(embeds, np.float32))
        return embeds.to(device=self.device, dtype=self.cfg.dtype)

    def _embed(self, tokens) -> Tensor:
        x = embed_lookup(self["embed"], self.as_tokens(tokens))
        return _scale_embed(self.cfg, x)

    # ---- forward (train / prefill trunk) ------------------------------------

    def _trunk(self, x: Tensor, *, enc_out: Optional[Tensor] = None
               ) -> Tuple[Tensor, Dict]:
        """The decoder stack.  Aux: the layers' mean lb and z losses (zero
        for dense layers); none for the attention-free families."""
        cfg = self.cfg
        if cfg.rwkv:
            return self._trunk_rwkv(x)
        if cfg.family == "hybrid":
            return self._trunk_hybrid(x)
        key = "dec_layers" if cfg.is_encdec else "layers"
        windows = self.windows(len(self[key]))
        zero = shd.zeros((), (), torch.float32, self.device)

        def body(x, enc_out, lp, w):
            x, aux = layer_apply_full(cfg, lp, x, w, enc_out=enc_out)
            return x, aux.get("lb_loss", zero), aux.get("z_loss", zero)

        body = remat(cfg.remat_policy, body)
        lb, zl = [], []
        for lp, w in zip(self[key], windows):
            x, lb_i, zl_i = body(x, enc_out, lp, w)
            lb.append(lb_i)
            zl.append(zl_i)
        return x, {"lb_loss": torch.stack(lb).mean(),
                   "z_loss": torch.stack(zl).mean()}

    def _trunk_rwkv(self, x: Tensor) -> Tuple[Tensor, Dict]:
        cfg = self.cfg
        b = x.shape[0]
        hd = cfg.rwkv_head_dim
        nh = cfg.d_model // hd

        def body(x, lp):
            st = rwkv_mod.RwkvState(
                s=shd.zeros((b, nh, hd, hd), ("batch", "heads", None, None),
                            torch.float32, self.device),
                x_last=shd.zeros((b, cfg.d_model), ("batch", None), x.dtype,
                                 self.device))
            h, _ = rwkv_mod.rwkv_block_apply(
                lp["time_mix"], _norm(cfg, lp, x, "ln_attn"), st,
                head_dim=hd, chunk=cfg.scan_chunk, eps=cfg.rms_eps)
            x = _residual(x, h)
            h = ffn_mod.mlp_apply(lp["mlp"], _norm(cfg, lp, x, "ln_mlp"),
                                  cfg.act)
            return shard_act(_residual(x, h), ("batch", None, None))

        body = remat(cfg.remat_policy, body)
        for lp in self["layers"]:
            x = body(x, lp)
        return x, {}

    def _trunk_hybrid(self, x: Tensor) -> Tuple[Tensor, Dict]:
        """SSM layers with the one shared attention block after each run
        of ``attn_every`` of them (none after a shorter last run)."""
        cfg = self.cfg
        b = x.shape[0]

        def ssm_body(x, lp):
            st = ssm_mod.ssm_state_init(b, cfg.d_model, cfg.ssm_state,
                                        cfg.ssm_head_dim, cfg.ssm_expand,
                                        device=self.device)
            h, _ = ssm_mod.ssm_block_apply(
                lp["ssm"], _norm(cfg, lp, x, "ln_attn"), st,
                ssm_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                expand=cfg.ssm_expand, chunk=cfg.scan_chunk, eps=cfg.rms_eps)
            return shard_act(_residual(x, h), ("batch", None, None))

        ssm_body = remat(cfg.remat_policy, ssm_body)
        shared = remat(cfg.remat_policy, lambda x: layer_apply_full(
            cfg, self["shared_attn"], x, 0)[0])
        for i, lp in enumerate(self["layers"]):
            x = ssm_body(x, lp)
            if (i + 1) % cfg.attn_every == 0:
                x = shared(x)
        return x, {}

    def _encode(self, enc_embeds: Tensor) -> Tensor:
        """The non-causal encoder over frame embeddings plus absolute
        positions, normed by ``ln_enc``."""
        cfg = self.cfg
        enc = enc_embeds + self["pos_embed"][:enc_embeds.shape[1]][None]
        windows = self.windows(cfg.enc_layers)

        def enc_body(x, lp, w):
            return layer_apply_full(cfg, lp, x, w, causal=False)[0]

        enc_body = remat(cfg.remat_policy, enc_body)
        for lp, w in zip(self["enc_layers"], windows):
            enc = enc_body(enc, lp, w)
        return _norm(cfg, self, enc, "ln_enc")

    def _hidden(self, tokens=None, embeds=None, enc_embeds=None
                ) -> Tuple[Tensor, Dict]:
        """The last hidden states (B, T, d_model) before ``ln_f``, and the
        aux losses."""
        cfg = self.cfg
        if cfg.is_encdec:
            enc = self._encode(self.as_embeds(enc_embeds))
            # encoder-decoder models do not scale the embedding
            x = embed_lookup(self["embed"], self.as_tokens(tokens))
            x = x + self["pos_embed"][:x.shape[1]][None].to(x.dtype)
            return self._trunk(x, enc_out=enc)
        x = self.as_embeds(embeds) if embeds is not None else \
            self._embed(tokens)
        return self._trunk(shard_act(x, ("batch", None, None)))

    def _logits(self, x: Tensor) -> Tensor:
        x = _norm(self.cfg, self, x, "ln_f")
        return unembed(x, self.get("unembed", self["embed"]))

    def train_logits(self, tokens=None, embeds=None, enc_embeds=None
                     ) -> Tuple[Tensor, Dict]:
        """f32 logits (B, T, V) and the aux losses, from tokens (B, T), or
        embeddings (B, T, d_model) for ``input_mode='embeds'``, or, for
        the encoder-decoder, decoder tokens and encoder frames
        ``enc_embeds`` (B, T_enc, d_model)."""
        x, aux = self._hidden(tokens, embeds, enc_embeds)
        return self._logits(x), aux

    @torch.no_grad()
    def prefill(self, tokens=None, embeds=None, enc_embeds=None) -> Tensor:
        """Full-sequence forward returning the last position's f32 logits
        (B, V).  Only that position goes through ``ln_f`` and the unembed:
        the same arithmetic for the row returned, without the (B, T, V)
        logits the reference builds and slices."""
        x, _ = self._hidden(tokens, embeds, enc_embeds)
        return self._logits(x[:, -1:])[:, -1]

    # ---- caches ---------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, enc_len: int = 0
                   ) -> Dict[str, Tensor]:
        """The reference's cache layout, every per-row leaf's batch on
        axis 1 but ``len``'s and ``enc_len``'s (axis 0).  Attention caches
        are (L, B, S, KV, D) in the model's dtype; RWKV's state s
        (L, B, H, D, D) fp32 and x_last (L, B, d); the hybrid's SSD state
        s (L, B, H, N, P) fp32, conv tail (L, B, K-1, C) and one KV cache
        per shared-block site (n_layers // attn_every)."""
        return tree_map(
            lambda spec, axes: shd.zeros(spec.shape, axes, spec.dtype,
                                         self.device),
            self.cache_specs(batch, max_len, enc_len),
            self.cache_axes(batch, max_len, enc_len))

    def cache_specs(self, batch: int, max_len: int, enc_len: int = 0
                    ) -> Dict[str, Tensor]:
        """The decode cache's leaves as meta tensors (``init_cache``'s
        shapes and dtypes; nothing allocated)."""
        cfg = self.cfg

        def meta(shape, dtype=cfg.dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        length = meta((batch,), torch.int32)
        if cfg.rwkv:
            hd = cfg.rwkv_head_dim
            nh = cfg.d_model // hd
            return {"s": meta((cfg.n_layers, batch, nh, hd, hd),
                              torch.float32),
                    "x_last": meta((cfg.n_layers, batch, cfg.d_model)),
                    "len": length}
        if cfg.family == "hybrid":
            d_in = cfg.ssm_expand * cfg.d_model
            nh = d_in // cfg.ssm_head_dim
            conv_dim = d_in + 2 * cfg.ssm_state
            n_sites = cfg.n_layers // cfg.attn_every
            kv = (n_sites, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            return {"s": meta((cfg.n_layers, batch, nh, cfg.ssm_state,
                               cfg.ssm_head_dim), torch.float32),
                    "conv": meta((cfg.n_layers, batch, ssm_mod.CONV_K - 1,
                                  conv_dim)),
                    "attn_k": meta(kv), "attn_v": meta(kv),
                    "len": length}
        n_layers = cfg.dec_layers if cfg.is_encdec else cfg.n_layers
        shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        cache = {"k": meta(shape), "v": meta(shape), "len": length}
        if cfg.is_encdec:
            cross = (n_layers, batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
            cache.update(cross_k=meta(cross), cross_v=meta(cross),
                         enc_len=meta((batch,), torch.int32))
        return cache

    def cache_axes(self, batch: int, max_len: int, enc_len: int = 0
                   ) -> Dict[str, Tuple]:
        """Logical axes of the cache's leaves (the reference's): batch over
        the data axes; KV heads over 'model' where they divide, else
        head_dim ('kv_alt'); the recurrent states' heads over 'model'."""

        def ax(name: str) -> Tuple:
            if name in ("len", "enc_len"):
                return (None,)
            if name == "s":
                return (None, "batch", "heads", None, None)
            if name == "conv":
                return (None, "batch", None, "mlp")
            if name == "x_last":
                return (None, "batch", None)
            return (None, "batch", None, "kv", "kv_alt")

        return {k: ax(k) for k in self.cache_specs(batch, max_len, enc_len)}

    # ---- decode -----------------------------------------------------------------

    @torch.no_grad()
    def decode_step(self, token, cache: Dict[str, Tensor]
                    ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """One token (B, 1) per row: f32 logits (B, V) and the cache, its
        state buffers updated in place, its len advanced by one."""
        cfg = self.cfg
        if cfg.rwkv:
            return self._decode_rwkv(token, cache)
        if cfg.family == "hybrid":
            return self._decode_hybrid(token, cache)
        x = embed_lookup(self["embed"], self.as_tokens(token))
        if not cfg.is_encdec:  # matches train_logits' scaling convention
            x = _scale_embed(cfg, x)
        if cfg.pos == "absolute":
            # the reference's dynamic_slice clamps the start into the table
            x = x + shd.local_region(
                _position_row, ((None, None), (None,)), 0)(
                self["pos_embed"], cache["len"]).to(x.dtype)
        key = "dec_layers" if cfg.is_encdec else "layers"
        windows = self.windows(len(self[key]))
        for i, (lp, w) in enumerate(zip(self[key], windows)):
            layer_cache = KVCache(k=cache["k"][i], v=cache["v"][i],
                                  length=cache["len"])
            cross = KVCache(k=cache["cross_k"][i], v=cache["cross_v"][i],
                            length=cache["enc_len"]) if cfg.is_encdec \
                else None
            x, _ = layer_apply_decode(cfg, lp, x, layer_cache, w, cross)
        new_cache = dict(cache)
        new_cache["len"] = cache["len"] + 1
        return self._logits(x)[:, -1], new_cache

    def _decode_rwkv(self, token, cache):
        cfg = self.cfg
        x = self._embed(token)
        for i, lp in enumerate(self["layers"]):
            st = rwkv_mod.RwkvState(s=cache["s"][i], x_last=cache["x_last"][i])
            h, st2 = rwkv_mod.rwkv_decode_step(
                lp["time_mix"], _norm(cfg, lp, x, "ln_attn"), st,
                head_dim=cfg.rwkv_head_dim, eps=cfg.rms_eps)
            cache["s"][i] = st2.s
            cache["x_last"][i] = st2.x_last
            x = _residual(x, h)
            h = ffn_mod.mlp_apply(lp["mlp"], _norm(cfg, lp, x, "ln_mlp"),
                                  cfg.act)
            x = _residual(x, h)
        new_cache = dict(cache)
        new_cache["len"] = cache["len"] + 1
        return self._logits(x)[:, -1], new_cache

    def _decode_hybrid(self, token, cache):
        cfg = self.cfg
        x = self._embed(token)
        for i, lp in enumerate(self["layers"]):
            st = ssm_mod.SsmState(s=cache["s"][i], conv=cache["conv"][i])
            h, st2 = ssm_mod.ssm_block_apply(
                lp["ssm"], _norm(cfg, lp, x, "ln_attn"), st,
                ssm_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                expand=cfg.ssm_expand, chunk=1, eps=cfg.rms_eps)
            cache["s"][i] = st2.s
            cache["conv"][i] = st2.conv
            x = _residual(x, h)
            if (i + 1) % cfg.attn_every == 0:
                site = i // cfg.attn_every
                layer_cache = KVCache(k=cache["attn_k"][site],
                                      v=cache["attn_v"][site],
                                      length=cache["len"])
                x, _ = layer_apply_decode(cfg, self["shared_attn"], x,
                                          layer_cache, 0)
        new_cache = dict(cache)
        new_cache["len"] = cache["len"] + 1
        return self._logits(x)[:, -1], new_cache
