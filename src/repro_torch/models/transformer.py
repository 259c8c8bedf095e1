"""The dense decoder-only LM, built from one ArchConfig.

The port of the dense family of ``repro.models.transformer``.  Parameters
keep the reference's names: ``Transformer`` is an ``nn.Module`` whose
parameters read like the reference's values tree (``model["embed"]``,
``model["layers"][i]["attn"]["wq"]``); the reference stacks the layers on a
leading axis for ``lax.scan``, the port keeps an ``nn.ModuleList`` and
``convert.lm_params_from_numpy`` splits the stack.  The model lives on one
device, CUDA unless the caller passes ``device="cpu"``.

Eager PyTorch runs each layer as it comes, so the reference's remat policy
(``remat_policy``) and its optimization barrier (``act_barrier``) have no
counterpart: nothing is compiled across layers, and the serving entry
points keep no autograd state.  ``prefill`` and ``decode_step`` run without
gradients; ``train_logits`` leaves that to its caller.

Not ported yet, each raising ``NotImplementedError`` at construction with
its ROADMAP.md item: the MoE, hybrid-SSM, encoder-decoder and RWKV
families, M-RoPE and the embeddings frontend (VLM), and window schedules
(gemma3) - all under 'LM families'.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import Tensor, resolve_device, unported
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (apply_rope, dense_init, embed_init,
                                       embed_lookup, layer_norm, ones_init,
                                       rms_norm, unembed, zeros_init)

LM_FAMILIES = "LM families"


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what the port cannot build yet."""
    if cfg.family == "moe":
        raise unported("family 'moe'", LM_FAMILIES)
    if cfg.family in ("hybrid", "ssm"):
        raise unported(f"family {cfg.family!r}", LM_FAMILIES)
    if cfg.family == "encdec" or cfg.is_encdec:
        raise unported("family 'encdec'", LM_FAMILIES)
    if cfg.rwkv:
        raise unported("rwkv=True", LM_FAMILIES)
    if cfg.m_rope:
        raise unported("m_rope=True", LM_FAMILIES)
    if cfg.input_mode == "embeds":
        raise unported("input_mode='embeds'", LM_FAMILIES)
    if cfg.window_pattern:
        raise unported("a window_pattern", LM_FAMILIES)
    if cfg.pos != "rope":
        raise unported(f"pos={cfg.pos!r}", LM_FAMILIES)


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


def _norm_init(cfg: ArchConfig, d: int, name: str) -> Dict[str, Tensor]:
    if cfg.norm == "layernorm":
        return {f"{name}_w": ones_init((d,), cfg.dtype),
                f"{name}_b": zeros_init((d,), cfg.dtype)}
    return {f"{name}_w": zeros_init((d,), cfg.dtype)}


def _scale_embed(cfg: ArchConfig, x: Tensor) -> Tensor:
    """x * sqrt(d_model), the factor rounded to x's dtype as the reference
    rounds it."""
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()


# ---------------------------------------------------------------------------
# attention sub-block
# ---------------------------------------------------------------------------


def attn_init(generator: torch.Generator, cfg: ArchConfig) -> Dict:
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    p = {
        "wq": dense_init(generator, (d, nq), cfg.dtype),
        "wk": dense_init(generator, (d, nkv), cfg.dtype),
        "wv": dense_init(generator, (d, nkv), cfg.dtype),
        "wo": dense_init(generator, (nq, d), cfg.dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros_init((nq,), cfg.dtype)
        p["bk"] = zeros_init((nkv,), cfg.dtype)
        p["bv"] = zeros_init((nkv,), cfg.dtype)
    return p


def _qkv(cfg: ArchConfig, p, xq: Tensor, xkv: Tensor):
    b, tq, _ = xq.shape
    tk = xkv.shape[1]
    hd = cfg.head_dim
    q = xq @ p["wq"].to(xq.dtype)
    k = xkv @ p["wk"].to(xq.dtype)
    v = xkv @ p["wv"].to(xq.dtype)
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(b, tq, cfg.n_heads, hd)
    k = k.reshape(b, tk, cfg.n_kv_heads, hd)
    v = v.reshape(b, tk, cfg.n_kv_heads, hd)
    return q, k, v


def attn_apply_full(
    cfg: ArchConfig,
    p,
    x: Tensor,
    window: Union[int, Tensor],
    *,
    causal: bool = True,
) -> Tensor:
    """Training/prefill attention over a full sequence: K8 on the flash
    route (``attn_impl='pallas'``) on a CUDA device, else blockwise."""
    b, t, _ = x.shape
    q, k, v = _qkv(cfg, p, x, x)
    positions = torch.arange(t, device=x.device)[None].expand(b, t)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.attn_impl == "pallas":
        out = attn_mod.flash_attention(q, k, v, causal=causal)
    else:
        out = attn_mod.blockwise_attention(
            q, k, v, causal=causal, window=window, block_q=cfg.block_q,
            block_k=cfg.block_k)
    out = out.reshape(b, t, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"].to(x.dtype)


def attn_apply_decode(
    cfg: ArchConfig,
    p,
    x: Tensor,             # (B, 1, d)
    cache: KVCache,
    window: Union[int, Tensor],
) -> Tuple[Tensor, KVCache]:
    """One token per row.  Every row is roped at ``cache.length[0]`` while
    ``KVCache.append`` writes each row at its own length: the reference's
    behaviour, kept so both packages serve the same tokens."""
    b = x.shape[0]
    q, k, v = _qkv(cfg, p, x, x)
    positions = cache.length[:1].expand(b)[:, None]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    cache = cache.append(k, v)
    out = attn_mod.decode_attention(q, cache.k, cache.v, cache.length,
                                    window=window)
    out = out.reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"].to(x.dtype), cache


# ---------------------------------------------------------------------------
# decoder layer
# ---------------------------------------------------------------------------


def layer_init(generator: torch.Generator, cfg: ArchConfig) -> Dict:
    d = cfg.d_model
    p: Dict[str, Any] = {"attn": attn_init(generator, cfg)}
    p.update(_norm_init(cfg, d, "ln_attn"))
    p["mlp"] = ffn_mod.mlp_init(generator, d, cfg.d_ff, cfg.dtype,
                                gated=(cfg.act == "silu"))
    p.update(_norm_init(cfg, d, "ln_mlp"))
    return p


def layer_apply_full(
    cfg: ArchConfig, p, x: Tensor, window, *, causal: bool = True,
) -> Tuple[Tensor, Dict]:
    h = attn_apply_full(cfg, p["attn"], _norm(cfg, p, x, "ln_attn"), window,
                        causal=causal)
    x = x + h
    h = ffn_mod.mlp_apply(p["mlp"], _norm(cfg, p, x, "ln_mlp"), cfg.act)
    return x + h, {}


def layer_apply_decode(
    cfg: ArchConfig, p, x: Tensor, cache: KVCache, window,
) -> Tuple[Tensor, KVCache]:
    h, cache = attn_apply_decode(cfg, p["attn"], _norm(cfg, p, x, "ln_attn"),
                                 cache, window)
    x = x + h
    h = ffn_mod.mlp_apply(p["mlp"], _norm(cfg, p, x, "ln_mlp"), cfg.act)
    return x + h, cache


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def init_tree(cfg: ArchConfig, generator: torch.Generator) -> Dict[str, Any]:
    """The parameters as a nested dict of CPU tensors, in the reference's
    names and draw order (embed, unembed, the layers)."""
    p: Dict[str, Any] = {
        "embed": embed_init(generator, cfg.padded_vocab, cfg.d_model,
                            cfg.dtype)}
    p.update(_norm_init(cfg, cfg.d_model, "ln_f"))
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(generator, (cfg.padded_vocab, cfg.d_model),
                                  cfg.dtype, fan_in=cfg.d_model)
    p["layers"] = [layer_init(generator, cfg) for _ in range(cfg.n_layers)]
    return p


class Transformer(ParamTree):
    """The dense decoder-only LM on one device.

    ``generator`` seeds the parameters (default: seed 0); they are drawn on
    the CPU and moved, so one seed gives one model on every device.
    """

    def __init__(self, cfg: ArchConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        check_supported(cfg)
        dev = resolve_device(device, "Transformer")
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        super().__init__(init_tree(cfg, gen))
        self.cfg = cfg
        self.device = dev
        self.to(dev)

    # ---- layer-window schedule ---------------------------------------------

    def window_schedule(self, n_layers: int) -> Tensor:
        cfg = self.cfg
        return torch.tensor([cfg.window_for_layer(i) for i in range(n_layers)],
                            dtype=torch.int32)

    # ---- forward (train / prefill trunk) ------------------------------------

    def as_tokens(self, tokens) -> Tensor:
        if isinstance(tokens, np.ndarray):
            tokens = torch.from_numpy(tokens)
        return tokens.to(device=self.device, dtype=torch.int64)

    def _embed(self, tokens) -> Tensor:
        x = embed_lookup(self["embed"], self.as_tokens(tokens))
        return _scale_embed(self.cfg, x)

    def _trunk(self, x: Tensor) -> Tuple[Tensor, Dict]:
        cfg = self.cfg
        windows = self.window_schedule(cfg.n_layers).tolist()
        for lp, w in zip(self["layers"], windows):
            x, _ = layer_apply_full(cfg, lp, x, w)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, {"lb_loss": zero, "z_loss": zero}

    def _logits(self, x: Tensor) -> Tensor:
        x = _norm(self.cfg, self, x, "ln_f")
        return unembed(x, self.get("unembed", self["embed"]))

    def train_logits(self, tokens) -> Tuple[Tensor, Dict]:
        """f32 logits (B, T, V) of a token batch (B, T), and the aux losses
        (zero for the dense family)."""
        x, aux = self._trunk(self._embed(tokens))
        return self._logits(x), aux

    @torch.no_grad()
    def prefill(self, tokens) -> Tensor:
        """Full-sequence forward returning the last position's f32 logits
        (B, V).  Only that position goes through ``ln_f`` and the unembed:
        the same arithmetic for the row returned, without the (B, T, V)
        logits the reference builds and slices."""
        x, _ = self._trunk(self._embed(tokens))
        return self._logits(x[:, -1:])[:, -1]

    # ---- caches ---------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int) -> Dict[str, Tensor]:
        """The reference's cache layout: k, v (L, B, S, KV, D) in the
        model's dtype and len (B,) int32."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {
            "k": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
            "len": torch.zeros((batch,), dtype=torch.int32,
                               device=self.device),
        }

    # ---- decode -----------------------------------------------------------------

    @torch.no_grad()
    def decode_step(self, token, cache: Dict[str, Tensor]
                    ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """One token (B, 1) per row: f32 logits (B, V) and the cache, its k
        and v updated in place, its len advanced by one."""
        cfg = self.cfg
        x = self._embed(token)
        windows = self.window_schedule(cfg.n_layers).tolist()
        for i, (lp, w) in enumerate(zip(self["layers"], windows)):
            layer_cache = KVCache(k=cache["k"][i], v=cache["v"][i],
                                  length=cache["len"])
            x, _ = layer_apply_decode(cfg, lp, x, layer_cache, w)
        new_cache = dict(cache)
        new_cache["len"] = cache["len"] + 1
        return self._logits(x)[:, -1], new_cache
