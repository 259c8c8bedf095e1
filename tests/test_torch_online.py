"""The port's online engine against the reference's vmapped serve step.

``online_serve_step`` takes the slot-batched state directly; the reference
writes it for one system and the stream server vmaps it over slots, so the
reference side here is ``jax.vmap(online_serve_step)``.  States cross over
through ``repro_torch.convert``.

Tolerance: rtol 1e-4 / atol 1e-5 on every leaf.  Both sides run the same
fp32 arithmetic in different orders (reservoir matvec, DPRR sums, autograd),
and one SGD step or one (A, B) accumulation does not amplify that beyond a
few ulps of the largest terms.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import online as ronline
from repro.core.types import DFRConfig as RConfig
from repro.core.types import DFRParams as RParams
from repro.core.types import QuantParams as RQuant
from repro.core.types import RidgeState as RRidge
from repro_torch import convert
from repro_torch.core import online
from repro_torch.core.types import DFRConfig

TOL = dict(rtol=1e-4, atol=1e-5)
NX, N_IN, NY, S, B, T = 6, 2, 3, 3, 2, 10
RCFG = RConfig(n_in=N_IN, n_classes=NY, n_nodes=NX, nonlinearity="tanh")
CFG = DFRConfig(n_in=N_IN, n_classes=NY, n_nodes=NX, nonlinearity="tanh")


def _ref_state(seed=0):
    """A slot-batched reference state with every leaf the step reads made
    non-trivial: trained readouts, accumulated statistics, mixed steps."""
    rng = np.random.default_rng(seed)
    single = ronline.init_state(RCFG)
    st = jax.tree_util.tree_map(
        lambda leaf: jnp.broadcast_to(leaf, (S, *leaf.shape)), single)
    s = RCFG.s
    X = 0.1 * rng.normal(size=(S, 3 * s, s))
    params = RParams(
        p=jnp.asarray([0.01, 0.1, 0.3], jnp.float32),
        q=jnp.asarray([0.01, -0.2, 0.4], jnp.float32),
        W=jnp.asarray(0.05 * rng.normal(size=(S, NY, RCFG.n_rep)),
                      jnp.float32),
        b=jnp.asarray(0.1 * rng.normal(size=(S, NY)), jnp.float32))
    ridge = RRidge(
        A=jnp.asarray(rng.normal(size=(S, NY, s)), jnp.float32),
        B=jnp.asarray(np.einsum("kni,knj->kij", X, X), jnp.float32),
        count=jnp.asarray([0, 5, 9], jnp.int32),
        Lt=st.ridge.Lt,
        factor_beta=jnp.asarray([0.0, 0.5, 0.0], jnp.float32))
    return dataclasses.replace(
        st, params=params, ridge=ridge,
        step=jnp.asarray([0, 3, 7], jnp.int32),
        loss_ema=jnp.asarray([0.0, 0.4, 1.2], jnp.float32))


def _window(seed=1):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(S, B, T, N_IN)).astype(np.float32)
    length = np.asarray([[T, 1], [4, 7], [T, 2]], np.int32)
    label = rng.integers(0, NY, (S, B)).astype(np.int32)
    weight = np.asarray([[1, 1], [1, 0], [1, 1]], np.float32)
    lr = np.asarray([0.2, 0.0, 0.2], np.float32)
    accumulate = np.asarray([0, 1, 1], np.float32)
    mask = np.sign(rng.normal(size=(NX, N_IN))).astype(np.float32)
    return mask, u, length, label, lr, weight, accumulate


def _assert_state_close(got, want_leaves, **tol):
    got_leaves = convert.state_leaves(got)
    for name, w in want_leaves.items():
        np.testing.assert_allclose(got_leaves[name].astype(np.float64),
                                   w.astype(np.float64), err_msg=name, **tol)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("fused", [False, True])
def test_online_serve_step_matches_vmapped_reference(train, fused):
    ref_state = _ref_state()
    mask, u, length, label, lr, weight, acc = _window()

    def one(st, u_s, len_s, y_s, lr_s, w_s, a_s):
        return ronline.online_serve_step(
            RCFG, jnp.asarray(mask), st, u_s, len_s, y_s, lr_s, w_s, a_s,
            train=train, fused=fused)

    want_state, want_logits, want_metrics = jax.jit(jax.vmap(one))(
        ref_state, *(jnp.asarray(a) for a in (u, length, label, lr, weight,
                                              acc)))
    state = convert.state_from_leaves(convert.state_leaves(ref_state))
    got_state, got_logits, got_metrics = online.online_serve_step(
        CFG, torch.from_numpy(mask), state,
        *(torch.from_numpy(a) for a in (u, length, label, lr, weight, acc)),
        train=train, fused=fused)
    _assert_state_close(got_state, convert.state_leaves(want_state), **TOL)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               **TOL)
    for k in ("loss", "acc"):
        np.testing.assert_allclose(got_metrics[k].numpy(),
                                   np.asarray(want_metrics[k]), **TOL)
    # the step is functional: the input state is untouched
    _assert_state_close(state, convert.state_leaves(ref_state), rtol=0,
                        atol=0)


def test_refresh_output_rows_matches_reference():
    """Cohort refresh of rows [2, 0] with row 0 ineligible (it must keep
    its readout).  Cholesky solves of a well-conditioned s=43 system:
    rtol 1e-4 / atol 1e-5."""
    ref_state = _ref_state(seed=3)
    rows = np.asarray([2, 0], np.int32)
    el = np.asarray([True, False])
    want = jax.jit(ronline.refresh_output_rows)(
        ref_state, jnp.float32(1e-2), jnp.asarray(rows), jnp.asarray(el))
    state = convert.state_from_leaves(convert.state_leaves(ref_state))
    got = online.refresh_output_rows(state, 1e-2, torch.from_numpy(rows),
                                     torch.from_numpy(el))
    want_leaves = convert.state_leaves(want)
    _assert_state_close(got, want_leaves, **TOL)
    np.testing.assert_array_equal(convert.state_leaves(got)["params_W"][0],
                                  np.asarray(ref_state.params.W[0]))
    # every row, all eligible: the batched refresh of the whole slot axis
    every = online.refresh_output_rows(state, 1e-2, torch.arange(S),
                                       torch.ones(S, dtype=torch.bool))
    whole = online.refresh_output_batched(state, 1e-2)
    for name in ("W", "b"):
        torch.testing.assert_close(getattr(every.params, name),
                                   getattr(whole.params, name), rtol=0,
                                   atol=0)


def test_convert_round_trip():
    """Reference leaves -> port state -> leaves is exact, and the leaves
    rebuild a reference state equal to the original."""
    ref_state = _ref_state(seed=5)
    leaves = convert.state_leaves(ref_state)
    state = convert.state_from_leaves(leaves)
    back = convert.state_leaves(state)
    assert back.keys() == leaves.keys()
    for k in leaves:
        assert back[k].dtype == leaves[k].dtype, k
        np.testing.assert_array_equal(back[k], leaves[k], err_msg=k)
    j = {k: jnp.asarray(v) for k, v in back.items()}
    rebuilt = ronline.OnlineState(
        params=RParams(j["params_p"], j["params_q"], j["params_W"],
                       j["params_b"]),
        ridge=RRidge(j["ridge_A"], j["ridge_B"], j["ridge_count"],
                     j["ridge_Lt"], j["ridge_factor_beta"]),
        step=j["step"], loss_ema=j["loss_ema"],
        quant=RQuant(j["quant_Wq"], j["quant_w_scale"], j["quant_x_scale"],
                     j["quant_x_absmax"]),
        loss_fast=j["loss_fast"], loss_slow=j["loss_slow"])
    for a, b in zip(jax.tree_util.tree_leaves(rebuilt),
                    jax.tree_util.tree_leaves(ref_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
