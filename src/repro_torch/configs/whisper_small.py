"""Whisper-small: enc-dec audio, conv frontend STUB [arXiv:2212.04356; unverified].

12L enc + 12L dec, d_model=768 12H d_ff=3072 vocab=51865 (padded to 51968).
input_specs supply precomputed frame embeddings (the assigned stub).
Encoder has no decode step; decode cells exercise the decoder with
cross-attention to stub encoder states.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,       # stack depth bookkeeping (enc/dec below)
    enc_layers=12,
    dec_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=51865,
    norm="layernorm",
    act="gelu",
    pos="absolute",
    input_mode="embeds",
    max_abs_pos=32800,
    skip_shapes=("long_500k",),
    grad_accum={"train_4k": 1, "prefill_32k": 1},
)
