"""Gemma-3 4B: 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt; unverified].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144; local window 1024.
Global layers are full-attention => long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab=262144,
    window_pattern=(1024, 1024, 1024, 1024, 1024, 0),  # 5 local : 1 global
    rope_theta=1e6,
    act="gelu",
    skip_shapes=("long_500k",),
    grad_accum={"train_4k": 4, "prefill_32k": 1},
)
