"""bf16 serving in the port (``cfg.dtype=torch.bfloat16``) against the
reference's, on the CPU.

The reference's two bf16 tests, ported (tests/test_stream_pipeline.py:
test_bf16_config_is_not_silently_upcast, tests/test_stream_quant.py:
test_bf16_inputs_feed_the_int8_path), on their episode (Nx=8, 3 classes,
t_max 16; 3 slots, window 2, phase_steps 2, refresh_every 3; two streams)
and with the incremental refresh, the only one either package serves in
bf16: the state, the staged pool and the window batches are bf16, the
int8 scales fp32, host and device staging serve the same predictions, and
the blocked int8 episode the unblocked one, exactly.

Parity with the reference is anchored to the reference's own bf16 error.
The reference folds a bf16 factor in bf16 arithmetic, the port (K3 and its
plain version) in fp32, so the two bf16 runs differ by bf16 rounding, not
by a fixed tolerance.  On the five-stream episode of
tests/test_torch_stream_pipeline.py the test measures the reference's bf16
run against its fp32 run, with the same mask and data: the share of
predictions they agree on, and the largest |dLt| and |dW| of each stream's
final state relative to that state's largest entry.  The port's bf16 run
must agree with the reference's bf16 predictions at least as often, and
hold Lt and W within 2x those gaps.  Both gaps are printed.

Within the port, exactly: the captured round's in-place bodies
(``RoundGraphs(capture=False)``) and the pipelined, blocked rounds serve
the eager bf16 episode bit for bit, as tests/test_torch_stream_pipeline.py
holds fp32; and the kernels' wrappers take bf16 operands, compute in fp32
and return bf16 (the int8 logits fp32, as the reference's).  Both packages
refuse bf16 with the recompute refresh (no bf16 Cholesky).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import masking as rmasking
from repro.core.types import DFRConfig as RConfig
from repro.runtime import StreamRequest as RRequest
from repro.runtime import StreamServer as RServer
from repro_torch.core import ridge
from repro_torch.core.types import DFRConfig, map_leaves
from repro_torch.kernels import ops
from repro_torch.runtime import StreamRequest, StreamServer
from repro_torch.runtime.graphs import RoundGraphs

RCFG = RConfig(n_in=2, n_classes=3, n_nodes=8, dtype=jnp.bfloat16)
CFG = DFRConfig(n_in=2, n_classes=3, n_nodes=8, dtype=torch.bfloat16)
SERVER = dict(t_max=16, max_streams=3, window=2, phase_steps=2,
              refresh_every=3)
INC = dict(refresh_mode="incremental")
MODES = {"incremental": INC, "int8": dict(INC, quantize="int8")}
EPISODE_SIZES = (8, 6, 10, 4, 7)   # tests/test_torch_stream_pipeline.py
GAP_FACTOR = 2.0


def _make_stream(cls, rid, n, t=16, seed=0, n_in=2, n_classes=3):
    r = np.random.default_rng(seed)
    return cls(rid=rid,
               u=r.normal(size=(n, t, n_in)).astype(np.float32),
               length=r.integers(4, t + 1, n).astype(np.int32),
               label=r.integers(0, n_classes, n).astype(np.int32))


def _two_streams(cls=StreamRequest):
    """The reference tests' streams."""
    return [_make_stream(cls, 0, 6, seed=3), _make_stream(cls, 1, 4, seed=4)]


def _episode_streams(cls=StreamRequest):
    return [_make_stream(cls, rid, n, seed=rid)
            for rid, n in enumerate(EPISODE_SIZES)]


def _mask():
    """The reference's bf16 mask (what its bf16 server draws), as float32
    values that bf16 holds exactly."""
    return np.asarray(rmasking.make_mask(
        jax.random.PRNGKey(RCFG.mask_seed), RCFG.n_nodes, RCFG.n_in,
        jnp.bfloat16)).astype(np.float32)


def _serve(streams, cfg=CFG, graphs=False, **kw):
    srv = StreamServer(cfg, mask=_mask(), device="cpu", **SERVER, **kw)
    if graphs:
        srv._graphs = RoundGraphs(capture=False)
    for s in streams:
        srv.submit(s)
    done = srv.run_until_drained()
    return {r.rid: r for r in done}, srv


def _rserve(streams, dtype=jnp.bfloat16, **kw):
    cfg = dataclasses.replace(RCFG, dtype=dtype)
    srv = RServer(cfg, mask=jnp.asarray(_mask(), dtype), **SERVER, **kw)
    for s in streams:
        srv.submit(s)
    done = srv.run_until_drained()
    return {r.rid: r for r in done}, srv


def _preds(done):
    return {rid: list(r.preds) for rid, r in done.items()}


def _leaves(state):
    out = []
    map_leaves(out.append, state)
    return out


def _assert_bitwise(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


# -- the reference's two bf16 tests ------------------------------------------


@pytest.mark.parametrize("staging", ["host", "device"])
def test_bf16_config_is_not_silently_upcast(staging):
    """A bf16 config serves in bf16: the state leaves and the staged pool
    carry cfg.dtype on both staging paths, both paths serve the same
    predictions, and each stream is served whole.  The reference's episode
    serves the same predictions in both packages on at least the share its
    own fp32 run agrees with its bf16 run."""
    done, srv = _serve(_two_streams(), staging=staging, **INC)
    assert srv.states.ridge.B.dtype == torch.bfloat16
    assert srv.states.ridge.Lt.dtype == torch.bfloat16
    assert srv.states.params.W.dtype == torch.bfloat16
    assert srv.states.quant.w_scale.dtype == torch.float32
    if staging == "device":
        assert srv.pool.u.dtype == torch.bfloat16
        host, _ = _serve(_two_streams(), staging="host", **INC)
        assert _preds(done) == _preds(host)
    for r in srv.completed:
        assert len(r.preds) == r.n_samples
    ref, _ = _rserve(_two_streams(RRequest), staging=staging, **INC)
    ref32, _ = _rserve(_two_streams(RRequest), dtype=jnp.float32,
                       staging=staging, **INC)
    floor = _agreement(ref, ref32)
    got = _agreement(done, ref)
    print(f"staging={staging}: port bf16 vs reference bf16 {got:.4f}, "
          f"reference bf16 vs fp32 {floor:.4f}")
    assert got >= floor


def test_bf16_inputs_feed_the_int8_path():
    """A bf16 config serves through quantize='int8' (the wrapper upcasts
    the window to f32 for K5; the scales stay f32), NaN-free, the blocked
    path equal to the unblocked one."""
    preds_q, srv = _serve(_two_streams(), **MODES["int8"])
    assert srv.states.params.W.dtype == torch.bfloat16
    assert srv.states.quant.w_scale.dtype == torch.float32
    assert srv.states.quant.x_absmax.dtype == torch.float32
    for leaf in _leaves(srv.states.quant):
        assert bool(torch.isfinite(leaf.to(torch.float64)).all())
    for r in srv.completed:
        assert len(r.preds) == r.n_samples
    preds_b, _ = _serve(_two_streams(), step_block=2, **MODES["int8"])
    assert _preds(preds_q) == _preds(preds_b)


# -- parity, anchored to the reference's own bf16 error ----------------------


def _agreement(got, want) -> float:
    total = agree = 0
    for rid, r in want.items():
        assert len(got[rid].preds) == len(r.preds) == r.n_samples
        total += len(r.preds)
        agree += sum(int(a == b) for a, b in zip(got[rid].preds, r.preds))
    return agree / total


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(x.astype(jnp.float32), np.float64)


def _gap(got, want, leaf) -> float:
    """The largest |d leaf| of any stream's final state, relative to that
    state's largest entry."""
    out = 0.0
    for rid, r in want.items():
        a = _f64(getattr(got[rid].final_state.ridge if leaf == "Lt"
                         else got[rid].final_state.params, leaf))
        b = _f64(getattr(r.final_state.ridge if leaf == "Lt"
                         else r.final_state.params, leaf))
        out = max(out, float(np.abs(a - b).max() / np.abs(b).max()))
    return out


_REF = {}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_bf16_serving_within_the_references_own_bf16_gap(mode):
    if mode not in _REF:
        _REF[mode] = (_rserve(_episode_streams(RRequest), **MODES[mode])[0],
                      _rserve(_episode_streams(RRequest), dtype=jnp.float32,
                              **MODES[mode])[0])
    ref, ref32 = _REF[mode]
    got, srv = _serve(_episode_streams(), **MODES[mode])
    floor = _agreement(ref, ref32)
    agree = _agreement(got, ref)
    gaps = {leaf: (_gap(got, ref, leaf), _gap(ref, ref32, leaf))
            for leaf in ("Lt", "W")}
    print(f"{mode}: predictions: port bf16 vs reference bf16 {agree:.4f}, "
          f"reference bf16 vs fp32 {floor:.4f}; " + "; ".join(
              f"{leaf}: port vs reference bf16 {g:.3e}, reference bf16 vs "
              f"fp32 {r:.3e} (limit {GAP_FACTOR * r:.3e})"
              for leaf, (g, r) in gaps.items()))
    assert agree >= floor
    for leaf, (g, r) in gaps.items():
        assert g <= GAP_FACTOR * r, leaf
    assert srv.states.ridge.Lt.dtype == torch.bfloat16


# -- within the port, bit for bit -------------------------------------------


_EAGER = {}


def _eager(mode):
    if mode not in _EAGER:
        _EAGER[mode] = _serve(_episode_streams(), **MODES[mode])
    return _EAGER[mode]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("kind", ["in-place", "pipelined", "in-place "
                                  "pipelined"])
def test_bf16_rounds_serve_the_eager_episode_bitwise(mode, kind):
    """The captured round's bodies, run eagerly, and the pipelined, blocked
    round (depth 2, blocks of 2) serve the eager bf16 episode: predictions,
    retirement snapshots and the final state bit for bit."""
    kw = dict(pipeline_depth=2, step_block=2) if "pipelined" in kind else {}
    got, gs = _serve(_episode_streams(), graphs="in-place" in kind,
                     **MODES[mode], **kw)
    want, ws = _eager(mode)
    assert sorted(got) == sorted(want)
    for rid, r in want.items():
        assert got[rid].preds == r.preds
        _assert_bitwise(got[rid].final_state, r.final_state)
    _assert_bitwise(gs.states, ws.states)
    assert gs.served_int8 == ws.served_int8
    if mode == "int8":
        assert gs.served_int8 > 0


def test_bf16_recompute_is_refused_in_both_packages():
    """No bf16 Cholesky: the reference raises at its first recompute
    refresh (XLA's Cholesky), the port at construction, and the port's
    batched Cholesky raises on bf16."""
    ref = RServer(RCFG, mask=jnp.asarray(_mask(), jnp.bfloat16), **SERVER)
    for s in _two_streams(RRequest):
        ref.submit(s)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        ref.run_until_drained()
    with pytest.raises(ValueError, match="incremental"):
        StreamServer(CFG, device="cpu", **SERVER)
    B = torch.eye(5, dtype=torch.bfloat16).expand(2, 5, 5)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        ridge.ridge_cholesky_batched(torch.ones(2, 3, 5, dtype=B.dtype), B)


# -- the kernels' wrappers on bf16 operands ----------------------------------


def _operands(seed=0, S=3, W=2, T=9, nx=5, ny=3):
    r = np.random.default_rng(seed)
    j = torch.from_numpy(r.normal(size=(S, W, T, nx)).astype(np.float32))
    lens = torch.from_numpy(r.integers(0, T + 1, (S, W)).astype(np.int32))
    p = torch.from_numpy(r.uniform(0.1, 0.5, S).astype(np.float32))
    q = torch.from_numpy(r.uniform(-0.4, 0.4, S).astype(np.float32))
    Wr = torch.from_numpy(
        (0.1 * r.normal(size=(S, ny, nx * (nx + 1)))).astype(np.float32))
    b = torch.from_numpy(r.normal(size=(S, ny)).astype(np.float32))
    bf = torch.bfloat16
    return [x.to(bf) if x.dtype == torch.float32 else x
            for x in (j, lens, p, q, Wr, b)]


def test_k1_k2_wrappers_compute_bf16_operands_in_fp32():
    """K1's and K2's wrappers on bf16 operands: the fp32 result on the
    upcast operands, rounded once to bf16."""
    j, lens, p, q, Wr, b = _operands()
    f32 = [x.float() if x.is_floating_point() else x
           for x in (j, lens, p, q, Wr, b)]
    got = ops.train_forward(j, lens, p, q, 5, backend="torch")
    want = ops.train_forward(*f32[:4], 5, backend="torch")
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.to(torch.bfloat16))
    got = ops.streaming_logits_slots(j, lens, p, q, Wr, b, 5,
                                     backend="torch")
    want = ops.streaming_logits_slots(*f32, 5, backend="torch")
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


def test_k5_wrapper_takes_bf16_inputs_and_returns_fp32_logits():
    """The int8 path defines its own precision, as the reference's: a bf16
    window is upcast, the logits come back fp32, equal to the fp32 call's
    on the upcast inputs (the int32 accumulators too)."""
    j, lens, p, q, _, b = _operands()
    r = np.random.default_rng(1)
    Wq = torch.from_numpy(r.integers(-127, 128, (3, 3, 30)).astype(np.int8))
    ws = torch.tensor([1e-3, 0.0, 2e-3])
    xs = torch.tensor([0.02, 0.0, 0.03])
    got, acc = ops.streaming_logits_slots_q8(j, lens, p, q, Wq, ws, xs, b, 5,
                                             backend="torch",
                                             return_acc=True)
    want, want_acc = ops.streaming_logits_slots_q8(
        j.float(), lens, p.float(), q.float(), Wq, ws, xs, b.float(), 5,
        backend="torch", return_acc=True)
    assert got.dtype == torch.float32
    assert torch.equal(got, want) and torch.equal(acc, want_acc)


@pytest.mark.parametrize("sign,scaled", [(1.0, False), (1.0, True),
                                         (-1.0, False)])
def test_k3_folds_a_bf16_factor_in_fp32(sign, scaled):
    """K3's plain version on a bf16 factor: the fp32 fold of the upcast
    factor, rounded once to bf16 (the lower triangle untouched), with the
    same guard flags; through the wrapper, in place too."""
    g = torch.Generator().manual_seed(0)
    K, W, s = 3, 4, 11
    Lt = torch.triu(0.05 * torch.randn(K, s, s, generator=g), diagonal=1)
    Lt = (Lt + torch.diag_embed(1.0 + torch.rand(K, s, generator=g)))
    Lt = (Lt + torch.tril(torch.randn(K, s, s, generator=g), -1)).to(
        torch.bfloat16)
    X = (0.3 * torch.randn(K, W, s, generator=g)).to(torch.bfloat16)
    if sign < 0:
        X[0, -1, s // 2] = 3.0
    scale = (torch.full((K, W), 0.95 ** 0.5).to(torch.bfloat16)
             if scaled else None)
    flags, flags32 = (torch.zeros(K, dtype=torch.int32) for _ in range(2))
    got = ops.cholupdate_window_t(Lt, X, sign, scale=scale, flags=flags,
                                  backend="torch")
    want = ridge.cholupdate_window_t(Lt.float(), X.float(), sign,
                                     scale=None if scale is None
                                     else scale.float(), flags=flags32)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))
    assert torch.equal(flags, flags32)
    assert torch.equal(torch.tril(got, -1), torch.tril(Lt, -1))
    out = Lt.clone()
    ops.cholupdate_window_t(out, X, sign, scale=scale, out=out,
                            backend="torch")
    assert torch.equal(out, got)
    if sign < 0:
        assert flags.tolist()[0] == 1
