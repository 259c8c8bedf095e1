"""Top-1 (Switch-style) Mixture of Experts.

The port of ``repro.models.moe``.  Tokens are grouped (``_group_size``,
the reference's rule), routed by an fp32 router to their argmax expert,
and given a slot below the capacity ``int(S / E * capacity_factor)``;
tokens past capacity are dropped and fall through the residual.  The
router's aux losses are the switch load-balance loss and the z-loss.

The reference dispatches and combines with einsums against a one-hot
(G, S, E, C) tensor, so that its expert-parallel resharding lowers to an
all-to-all.  Every term of those sums but one is a product with 0, so the
port writes each kept token into its (expert, slot) row and reads it back
by index: the same values (a one-hot product is exact, and the combine
rounds ye * gate once, as the einsum does), without the S x E x C x D
products.  The expert FFN is one batched product over the experts.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.types import Tensor
from repro_torch.models.layers import dense_init
from repro_torch.models.remat import checkpoint_name


def moe_init(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, dtype=torch.bfloat16) -> Dict[str, Tensor]:
    return {
        "router": dense_init(generator, (d_model, n_experts), torch.float32,
                             scale=d_model ** -0.5),
        "w_gate": dense_init(generator, (n_experts, d_model, d_ff), dtype),
        "w_up": dense_init(generator, (n_experts, d_model, d_ff), dtype),
        "w_down": dense_init(generator, (n_experts, d_ff, d_model), dtype),
    }


def _group_size(b: int, t: int) -> int:
    if t >= 1024 and t % 1024 == 0:
        return 1024
    if b * t <= 4096:
        return b * t  # single global group
    for cand in (2048, 1024, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
        if t % cand == 0:
            return cand
    return 1


class Routing(NamedTuple):
    logits: Tensor   # (G, S, E) f32 router logits
    probs: Tensor    # (G, S, E) f32
    expert: Tensor   # (G, S) int64 argmax expert
    slot: Tensor     # (G, S) int64 slot within the expert, before capacity
    keep: Tensor     # (G, S) bool: slot < capacity


def route(router: Tensor, xg: Tensor, capacity: int) -> Routing:
    """Top-1 routing of grouped tokens xg (G, S, D): the router's product
    in xg's dtype with f32 accumulation, the softmax and argmax in f32,
    each token's slot its rank among the group's tokens of its expert."""
    logits = torch.einsum("gsd,de->gse", xg.float(),
                          router.to(xg.dtype).float())
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)
    onehot = F.one_hot(expert, probs.shape[-1])
    slot = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(-1)
    return Routing(logits, probs, expert, slot, slot < capacity)


def moe_apply(
    p,
    x: Tensor,                   # (B, T, d_model)
    *,
    capacity_factor: float = 1.25,
    activation: str = "silu",
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Returns (output, aux) with aux = {lb_loss, z_loss,
    fraction_dropped}."""
    b, t, d = x.shape
    e = p["router"].shape[-1]
    s_g = _group_size(b, t)
    g = (b * t) // s_g
    xg = x.reshape(g, s_g, d)
    cap = max(1, int(s_g / e * capacity_factor))
    r = route(p["router"], xg, cap)

    # switch load-balance loss: E * sum_e fraction_tokens_e * mean_prob_e
    frac = F.one_hot(r.expert, e).to(torch.float32).mean(1)      # (G, E)
    mean_p = r.probs.mean(1)                                     # (G, E)
    lb_loss = e * torch.mean(torch.sum(frac * mean_p, dim=-1))
    z_loss = torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2)
    gate = r.probs.amax(-1) * r.keep                             # (G, S)

    # dispatch: each kept token into its (expert, slot) row
    gi, si = torch.nonzero(r.keep, as_tuple=True)
    ei, ci = r.expert[gi, si], r.slot[gi, si]
    rows, xe = xg[gi, si], x.new_zeros((g, e, cap, d))
    # the save_moe remat policy keeps xe, so a recompute does not redo the
    # dispatch (the reference names it 'moe_xe' for its policy)
    with checkpoint_name("moe_xe"):
        xe = xe.index_put((gi, ei, ci), rows)

    # expert FFN, batched over E
    xe_e = xe.transpose(0, 1).reshape(e, g * cap, d)
    gate_h = torch.bmm(xe_e, p["w_gate"].to(x.dtype))
    up_h = torch.bmm(xe_e, p["w_up"].to(x.dtype))
    act = F.silu(gate_h.float()) if activation == "silu" else \
        F.gelu(gate_h.float(), approximate="tanh")
    h = act.to(x.dtype) * up_h
    ye = torch.bmm(h, p["w_down"].to(x.dtype))                   # (E, G*C, D)
    ye = ye.reshape(e, g, cap, d).transpose(0, 1)                # (G, E, C, D)

    # combine: weight by the gate probability; dropped tokens give 0
    y = x.new_zeros((g, s_g, d))
    y[gi, si] = ye[gi, ei, ci] * gate[gi, si].to(x.dtype)[:, None]
    aux = {
        "lb_loss": lb_loss,
        "z_loss": z_loss,
        "fraction_dropped": 1.0 - r.keep.to(torch.float32).mean(),
    }
    return y.reshape(b, t, d), aux
