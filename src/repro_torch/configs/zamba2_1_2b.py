"""Zamba2-1.2B: Mamba2 backbone + shared attention block [arXiv:2411.15242; hf].

38L d_model=2048 (GQA kv=32 on the shared block) d_ff=8192 vocab=32000,
ssm_state=64.  Constant-size SSD state => runs long_500k (the shared-attn
call sites keep a KV cache, sharded over 'model').
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    grad_accum={"train_4k": 4, "prefill_32k": 1},
)
