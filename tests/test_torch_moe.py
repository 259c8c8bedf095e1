"""The port's top-1 MoE (``repro_torch.models.moe``) against the
reference's ``repro.models.moe.moe_apply``, on the CPU.

The reference's parameters and seeded numpy inputs go to both:

* fp32: the expert index and the kept mask of every token equal exactly
  (the reference's routing recomputed from its own lines, an fp32 router
  in both), the output within 1e-5 of its largest entry, the aux losses
  (lb, z, fraction dropped) within 1e-6 relative;
* bf16 (the LM's dtype) on equal inputs: the output within 2e-2 of its
  largest entry, the aux losses within 1e-5 relative (fp32 in both);
* tokens past capacity dropped, the single-group decode path at
  capacity factor 2.0, and ``_group_size`` over a grid of shapes;
* the four properties ``tests/test_models_moe.py`` holds the reference
  to, on the port: a large capacity matches the per-token dense
  reference, a skewed router drops most tokens, a balanced router has a
  lower lb loss than a skewed one, a decode-shaped call stays finite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as rmoe
from repro.models.layers import is_pv
from repro_torch.models import moe as pmoe

D, FF, E = 16, 32, 4


def _params(seed: int, dtype: str = "float32", skew: bool = False):
    """(reference params, the port's params) from one init."""
    p = jax.tree_util.tree_map(
        lambda pv: pv.value,
        rmoe.moe_init(jax.random.PRNGKey(seed), D, FF, E,
                      dtype=getattr(jnp, dtype)), is_leaf=is_pv)
    if skew:
        p["router"] = p["router"].at[:, 0].set(10.0)
    port = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.float32 if k == "router" else getattr(torch, dtype))
        for k, v in p.items()}
    return p, port


# the reference jitted: eager, each of its operations compiles on its own
_ref_apply = jax.jit(rmoe.moe_apply, static_argnames=("capacity_factor",))


def _x(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ref_routing(p, x, capacity_factor):
    """The reference's expert index and kept mask, from its own lines."""
    b, t, d = x.shape
    s_g = rmoe._group_size(b, t)
    xg = x.reshape((b * t) // s_g, s_g, d)
    cap = max(1, int(s_g / E * capacity_factor))
    logits = jnp.einsum("gsd,de->gse", xg, p["router"].astype(xg.dtype),
                        preferred_element_type=jnp.float32)
    expert = jnp.argmax(jax.nn.softmax(logits, axis=-1), axis=-1)
    onehot = jax.nn.one_hot(expert, E, dtype=jnp.float32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=1) - 1.0) * onehot, axis=-1)
    return np.asarray(expert), np.asarray(pos < cap), cap


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("shape,cf,skew", [
    ((2, 24, D), 1.25, False),     # one global group, some drops
    ((1, 2048, D), 1.25, False),   # groups of 1024 within the sequence
    ((2, 16, D), 0.5, True),       # a skewed router past capacity
    ((8, 1, D), 2.0, False),       # decode: one group, capacity 2.0
])
def test_moe_matches_reference_fp32(shape, cf, skew):
    p, port = _params(0, skew=skew)
    x = _x(shape, seed=shape[1])
    want, waux = _ref_apply(p, jnp.asarray(x), capacity_factor=cf)
    got, gaux = pmoe.moe_apply(port, torch.from_numpy(x), capacity_factor=cf)
    assert tuple(got.shape) == shape and got.dtype == torch.float32
    assert _rel(got, want) <= 1e-5
    for key in ("lb_loss", "z_loss", "fraction_dropped"):
        w, g = float(waux[key]), float(gaux[key])
        assert abs(g - w) <= 1e-6 * max(abs(w), 1.0), (key, g, w)
    expert, keep, cap = _ref_routing(p, jnp.asarray(x), cf)
    b, t, d = shape
    r = pmoe.route(port["router"], torch.from_numpy(x).reshape(
        expert.shape + (d,)), cap)
    np.testing.assert_array_equal(r.expert.numpy(), expert)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    if skew:
        assert float(gaux["fraction_dropped"]) > 0.4
        dropped = ~r.keep.numpy().reshape(b, t)
        assert not got.numpy()[dropped].any()   # through the residual only


def test_moe_matches_reference_bf16():
    p, port = _params(1, "bfloat16")
    x = _x((2, 64, D), seed=5)
    want, waux = _ref_apply(p, jnp.asarray(x, jnp.bfloat16))
    got, gaux = pmoe.moe_apply(port, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) <= 2e-2
    for key in ("lb_loss", "z_loss", "fraction_dropped"):
        w, g = float(waux[key]), float(gaux[key])
        assert abs(g - w) <= 1e-5 * max(abs(w), 1.0), (key, g, w)


def test_group_size_matches_reference():
    for b in (1, 2, 3, 8, 64):
        for t in (1, 7, 24, 512, 1000, 1024, 3072, 4096, 6000):
            assert pmoe._group_size(b, t) == rmoe._group_size(b, t), (b, t)


def _dense_reference(p, x: np.ndarray) -> np.ndarray:
    """Each token through its argmax expert, scaled by its gate, with no
    capacity (``tests/test_models_moe.py``'s oracle)."""
    probs = torch.softmax(torch.from_numpy(x @ p["router"].numpy()), -1)
    expert, gate = probs.argmax(-1).numpy(), probs.amax(-1).numpy()
    wg, wu, wd = (p[k].numpy() for k in ("w_gate", "w_up", "w_down"))
    out = np.zeros_like(x)
    for idx in np.ndindex(*x.shape[:-1]):
        e = expert[idx]
        g, u = x[idx] @ wg[e], x[idx] @ wu[e]
        out[idx] = gate[idx] * (((g / (1 + np.exp(-g))) * u) @ wd[e])
    return out


def test_moe_matches_dense_reference_with_big_capacity():
    _, port = _params(0)
    x = _x((2, 24, D), seed=1)
    y, aux = pmoe.moe_apply(port, torch.from_numpy(x),
                            capacity_factor=float(E))
    assert float(aux["fraction_dropped"]) == 0.0
    np.testing.assert_allclose(y.numpy(), _dense_reference(port, x),
                               rtol=2e-2, atol=2e-2)


def test_moe_capacity_drops_tokens():
    _, port = _params(2, skew=True)
    y, aux = pmoe.moe_apply(port, torch.from_numpy(_x((1, 16, D), 3)),
                            capacity_factor=0.5)
    assert float(aux["fraction_dropped"]) > 0.4
    assert bool(torch.isfinite(y).all())


def test_moe_balanced_router_has_lower_lb_loss():
    _, port = _params(4)
    x = torch.from_numpy(_x((2, 32, D), 5))
    _, aux_bal = pmoe.moe_apply(port, x)
    _, skew = _params(4, skew=True)
    _, aux_skew = pmoe.moe_apply(skew, x)
    assert float(aux_bal["lb_loss"]) < float(aux_skew["lb_loss"])


def test_moe_decode_single_group_path():
    _, port = _params(6)
    y, _ = pmoe.moe_apply(port, torch.from_numpy(_x((8, 1, D), 7)),
                          capacity_factor=2.0)
    assert tuple(y.shape) == (8, 1, D)
    assert bool(torch.isfinite(y).all())
