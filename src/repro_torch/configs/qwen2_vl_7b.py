"""Qwen2-VL-7B backbone: M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.  The vision
frontend is a STUB: input_specs provide precomputed patch embeddings; text
tokens use degenerate (t,t,t) M-RoPE streams.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab=152064,
    qkv_bias=True,
    m_rope=True,
    m_rope_sections=(16, 24, 24),
    input_mode="embeds",
    skip_shapes=("long_500k",),
    grad_accum={"train_4k": 4, "prefill_32k": 1},
)
