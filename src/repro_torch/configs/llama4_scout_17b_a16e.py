"""Llama-4 Scout 17B-16E: MoE 16e top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    n_experts=16,
    top_k=1,
    capacity_factor=1.25,
    rope_theta=5e5,
    skip_shapes=("long_500k",),
    grad_accum={"train_4k": 8, "prefill_32k": 2},
)
