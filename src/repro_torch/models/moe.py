"""Top-1 (Switch-style) Mixture of Experts.

The port of ``repro.models.moe``.  Tokens are grouped (``_group_size``,
the reference's rule), routed by an fp32 router to their argmax expert,
and given a slot below the capacity ``int(S / E * capacity_factor)``;
tokens past capacity are dropped and fall through the residual.  The
router's aux losses are the switch load-balance loss and the z-loss.

The reference dispatches and combines with einsums against a one-hot
(G, S, E, C) tensor, so that its expert-parallel resharding lowers to an
all-to-all.  Every term of those sums but one is a product with 0, so the
port writes each token into its (expert, slot) row and reads it back by
index: the same values (a one-hot product is exact, and the combine
rounds ye * gate once, as the einsum does), without the S x E x C x D
products.  The expert FFN is one batched product over the experts.

The dispatch has a fixed shape: every token is written, a dropped one to
a spare slot past the capacity that is cut off, so no shape depends on
the routing (the dry run traces it on fake tensors).  Under a mesh
(``distributed.sharding``), the reference's constraints stand at its
lines: the groups split over the data axes, the dispatched tokens move to
their experts' ranks (the (G, E, C, D) block redistributed from G to E
over the data axes: an all-to-all), the expert FFN runs on each rank's
experts with d_ff over 'model', and the outputs move back; the routing,
dispatch and combine of a group run on its rank (``local_region``).
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.types import Tensor
from repro_torch.distributed.sharding import local_region, shard_act
from repro_torch.models.layers import dense_init
from repro_torch.models.remat import checkpoint_name


def moe_init(generator: Optional[torch.Generator], d_model: int, d_ff: int,
             n_experts: int, dtype=torch.bfloat16) -> Dict[str, Tensor]:
    ex = ("expert", "embed", "expert_mlp")
    return {
        "router": dense_init(generator, (d_model, n_experts),
                             ("embed_no_shard", None), torch.float32,
                             scale=d_model ** -0.5),
        "w_gate": dense_init(generator, (n_experts, d_model, d_ff), ex,
                             dtype),
        "w_up": dense_init(generator, (n_experts, d_model, d_ff), ex, dtype),
        "w_down": dense_init(generator, (n_experts, d_ff, d_model),
                             ("expert", "expert_mlp", "embed"), dtype),
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


def _experts(p, xe: Tensor, activation: str) -> Tensor:
    """The expert FFN on dispatched tokens xe (G, E, C, D), batched over
    E: (G, E, C, D)."""
    g, e, cap, d = xe.shape
    xe_e = xe.transpose(0, 1).reshape(e, g * cap, d)
    gate_h = torch.bmm(xe_e, p["w_gate"].to(xe.dtype))
    up_h = torch.bmm(xe_e, p["w_up"].to(xe.dtype))
    act = F.silu(gate_h.float()) if activation == "silu" else \
        F.gelu(gate_h.float(), approximate="tanh")
    h = act.to(xe.dtype) * up_h
    ye = torch.bmm(h, p["w_down"].to(xe.dtype))                  # (E, G*C, D)
    return ye.reshape(e, g, cap, d).transpose(0, 1)


def _aux(r: Routing, e: int) -> Tuple[Tensor, Tensor]:
    """Each group's switch load-balance term, E * sum_e fraction_tokens_e
    * mean_prob_e (G,), and each token's squared router logsumexp
    (G, S); the losses are their means."""
    frac = F.one_hot(r.expert, e).to(torch.float32).mean(1)      # (G, E)
    mean_p = r.probs.mean(1)                                     # (G, E)
    return (e * torch.sum(frac * mean_p, dim=-1),
            torch.logsumexp(r.logits, dim=-1) ** 2)


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
    if g > 1:
        xg = shard_act(xg, ("batch", None, None))
    cap = max(1, int(s_g / e * capacity_factor))
    grp, tok = ("batch", None, None), ("batch", None)
    dispatch = local_region(functools.partial(_dispatch, cap=cap),
                            ((None, None), grp), (1, 1, 1, 1, 1, 1, 1))
    xe, gate, expert, slot, kept, lb_g, z_tok = dispatch(p["router"], xg)
    with checkpoint_name("moe_xe"):
        xe = shard_act(xe, (None, "expert", None, None))
    ye = shard_act(_experts(p, xe, activation), (None, "expert", None, None))
    combine = local_region(_combine, (("batch", None, None, None), tok, tok,
                                      tok), 1)
    y = combine(ye, gate, expert, slot)
    aux = {"lb_loss": lb_g.mean(), "z_loss": z_tok.mean(),
           "fraction_dropped": 1.0 - kept.mean()}
    return y.reshape(b, t, d), aux


def _dispatch(router: Tensor, xg: Tensor, cap: int):
    """One rank's groups: route, and write every token to its (expert,
    slot) row of (G, E, C + 1, D), a dropped one to the spare slot C,
    which is cut off.  Returns (xe (G, E, C, D), the gate (G, S) zero where
    dropped, the expert (G, S), the slot (G, S) with C where dropped, the
    kept share (G, S) as f32, the lb terms (G,), the z terms (G, S))."""
    g, s_g, d = xg.shape
    e = router.shape[-1]
    r = route(router, xg, cap)
    lb_g, z_tok = _aux(r, e)
    slot = torch.where(r.keep, r.slot, cap)
    gi = torch.arange(g, device=xg.device)[:, None].expand(g, s_g)
    # the save_moe remat policy keeps xe (and under a mesh its move to the
    # experts' ranks), so a recompute does not redo the dispatch: the
    # reference names it 'moe_xe' for that policy
    with checkpoint_name("moe_xe"):
        xe = xg.new_zeros((g, e, cap + 1, d)).index_put(
            (gi, r.expert, slot), xg)
    xe = xe[:, :, :cap]
    gate = r.probs.amax(-1) * r.keep
    return (xe, gate, r.expert, slot, r.keep.to(torch.float32), lb_g,
            z_tok)


def _combine(ye: Tensor, gate: Tensor, expert: Tensor, slot: Tensor
             ) -> Tensor:
    """One rank's groups: each token's expert output times its gate, 0 for
    a dropped token (it reads the zero spare slot)."""
    g, s_g = gate.shape
    ye = F.pad(ye, (0, 0, 0, 1))                          # (G, E, C + 1, D)
    gi = torch.arange(g, device=ye.device)[:, None].expand(g, s_g)
    return ye[gi, expert, slot] * gate.to(ye.dtype)[..., None]
