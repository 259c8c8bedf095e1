"""Architecture registry: one module per assigned architecture.

A copy of ``repro.configs``: ``get_config(arch_id)`` returns the full
published configuration; ``get_reduced(arch_id)`` returns the same family
scaled down for CPU tests (few layers, narrow widths, tiny vocab).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ArchConfig, SHAPES, ShapeSpec  # noqa: F401
from repro_torch.configs.gemma3_4b import CONFIG as gemma3_4b
from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG as llama4_maverick
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as llama4_scout
from repro_torch.configs.minitron_8b import CONFIG as minitron_8b
from repro_torch.configs.qwen15_110b import CONFIG as qwen15_110b
from repro_torch.configs.qwen2_vl_7b import CONFIG as qwen2_vl_7b
from repro_torch.configs.rwkv6_7b import CONFIG as rwkv6_7b
from repro_torch.configs.smollm_135m import CONFIG as smollm_135m
from repro_torch.configs.whisper_small import CONFIG as whisper_small
from repro_torch.configs.zamba2_1_2b import CONFIG as zamba2_1_2b

REGISTRY: Dict[str, ArchConfig] = {
    c.name: c
    for c in [
        rwkv6_7b,
        llama4_maverick,
        llama4_scout,
        minitron_8b,
        gemma3_4b,
        qwen15_110b,
        smollm_135m,
        zamba2_1_2b,
        whisper_small,
        qwen2_vl_7b,
    ]
}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; have {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def get_reduced(arch_id: str) -> ArchConfig:
    """Reduced same-family config for CPU tests."""
    cfg = get_config(arch_id)
    updates = dict(
        n_layers=max(2, min(4, cfg.n_layers)),
        d_model=128,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab=512,
        scan_chunk=32,
        block_q=64,
        block_k=64,
        max_abs_pos=512,
    )
    if cfg.family == "moe":
        updates.update(n_experts=4)
    if cfg.m_rope:
        updates.update(m_rope_sections=(4, 6, 6))  # head_dim 32 -> 16 half-slots
    if cfg.rwkv:
        updates.update(rwkv_head_dim=32)
    if cfg.ssm_state:
        updates.update(ssm_state=16, ssm_head_dim=32, attn_every=2)
    if cfg.is_encdec:
        updates.update(enc_layers=2, dec_layers=2)
    if cfg.window_pattern:
        updates.update(window_pattern=(32, 32, 0))
    return dataclasses.replace(cfg, **updates)


ALL_ARCHS = sorted(REGISTRY)
