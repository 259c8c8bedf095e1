"""RWKV-6 'Finch' 7B: attention-free, data-dependent decay [arXiv:2404.05892; hf].

32L d_model=4096 d_ff=14336 vocab=65536; linear-time recurrent state =>
runs the long_500k cell (constant-size state at decode).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="dense",
    rwkv=True,
    rwkv_head_dim=64,
    n_layers=32,
    d_model=4096,
    n_heads=64,        # d_model / rwkv_head_dim (bookkeeping only)
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    act="silu",
    grad_accum={"train_4k": 8, "prefill_32k": 1},
)
