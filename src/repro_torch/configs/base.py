"""ArchConfig: one dataclass describing every supported architecture, plus
the four assigned input shapes.

A copy of ``repro.configs.base`` with the same fields, defaults and methods;
``dtype`` is a torch dtype.  ``input_specs`` gives a step's inputs as
tensors on the meta device (shapes and dtypes, never allocated), the
stand-ins of the reference's ShapeDtypeStructs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The assigned shape set (identical for all 10 LM-family archs).
SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    # --- attention ---
    qkv_bias: bool = False
    window_pattern: Tuple[int, ...] = ()   # cycled per layer; 0 = global
    rope_theta: float = 1e4
    m_rope: bool = False                   # qwen2-vl 3-stream RoPE
    m_rope_sections: Tuple[int, int, int] = (16, 24, 24)
    # --- recurrent families ---
    rwkv: bool = False
    rwkv_head_dim: int = 64
    ssm_state: int = 0                     # mamba2 state size (hybrid/ssm)
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every: int = 6                    # zamba2: shared attn block period
    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    dec_layers: int = 0
    # --- frontend stubs ---
    input_mode: str = "tokens"             # tokens | embeds (audio/vision stub)
    # --- numerics / misc ---
    norm: str = "rms"                      # rms | layernorm
    act: str = "silu"                      # silu | gelu
    pos: str = "rope"                      # rope | absolute
    max_abs_pos: int = 32800               # absolute-pos table size (encdec)
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    # --- training-time knobs (overridable per run) ---
    remat_policy: str = "nothing"          # nothing | dots | none
    scan_chunk: int = 128                  # rwkv/ssd chunk length
    block_q: int = 512
    block_k: int = 1024
    # attention implementation: 'xla' (the plain blockwise route) or
    # 'pallas' (the flash kernel K8 on a CUDA device; on the CPU the plain
    # blockwise route, as the reference runs it off the TPU)
    attn_impl: str = "xla"
    # the reference pins block outputs with an optimization barrier; eager
    # PyTorch has nothing to pin, so the port reads but never acts on it
    act_barrier: bool = False
    # shape-dependent skips, e.g. long_500k for full-attention archs
    skip_shapes: Tuple[str, ...] = ()
    # microbatch split per shape name (grad accumulation steps)
    grad_accum: Any = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (shardable by model axis)."""
        return -(-self.vocab // 256) * 256

    def window_for_layer(self, i: int) -> int:
        if not self.window_pattern:
            return 0
        return self.window_pattern[i % len(self.window_pattern)]

    # ----- parameter count (for 6ND model-flops accounting) ------------------

    def param_count(self) -> int:
        d, ff, v = self.d_model, self.d_ff, self.padded_vocab
        hd = self.head_dim
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd
        embed = v * d * (1 if self.tie_embeddings else 2)
        if self.rwkv:
            per_layer = 5 * d * d + d * 64 + 64 * d + 2 * d  # rwkv6 approx
            ffn = 2 * d * ff
            return self.n_layers * (per_layer + ffn) + embed
        attn = d * n_q + 2 * d * n_kv + n_q * d
        dense_ffn = 3 * d * ff if self.act == "silu" else 2 * d * ff
        if self.family == "moe":
            moe_ffn = self.n_experts * 3 * d * ff + d * self.n_experts
            layers = self.n_layers * (attn + moe_ffn)
        elif self.family in ("ssm", "hybrid"):
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_head_dim
            ssm = d * (2 * d_in + 2 * self.ssm_state + nh) + d_in * d
            layers = self.n_layers * ssm
            # zamba2 shares ONE attn+ffn block across call sites
            if self.family == "hybrid":
                layers += attn + dense_ffn
        else:
            layers = self.n_layers * (attn + dense_ffn)
        if self.is_encdec:
            # encoder + decoder stacks + cross attention
            cross = d * n_q + 2 * d * n_kv + n_q * d
            layers = (self.enc_layers + self.dec_layers) * (attn + dense_ffn)
            layers += self.dec_layers * cross
        return layers + embed

    def active_param_count(self) -> int:
        """Params touched per token (MoE top-k active experts)."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        total = self.param_count()
        moe_all = self.n_layers * self.n_experts * 3 * d * ff
        moe_active = self.n_layers * self.top_k * 3 * d * ff
        return total - moe_all + moe_active


def input_specs(cfg: ArchConfig, shape: ShapeSpec, *,
                batch_override: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input of a step function.

    train:   tokens + targets (B, T)
    prefill: tokens (B, T)
    decode:  token (B, 1) + cache (built separately, with the decode step)
    For input_mode='embeds' the token stream is replaced by precomputed
    frame/patch embeddings (B, T, d_model) - the assigned frontend stub.
    """
    b = batch_override or shape.global_batch
    t = shape.seq_len

    def spec(dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "train":
        if cfg.input_mode == "embeds":
            return {"embeds": spec((b, t, cfg.d_model), cfg.dtype),
                    "targets": spec((b, t))}
        return {"tokens": spec((b, t)), "targets": spec((b, t))}
    if shape.kind == "prefill":
        if cfg.input_mode == "embeds":
            return {"embeds": spec((b, t, cfg.d_model), cfg.dtype)}
        return {"tokens": spec((b, t))}
    # decode: one new token against a cache of seq_len
    return {"token": spec((b, 1))}
