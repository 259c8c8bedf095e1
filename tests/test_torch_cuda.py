"""Card-only tests: the port's CUDA kernels against their plain versions.

Every test here is marked ``cuda`` and skips on a host without a CUDA device
(the fixture decides at run time, so every pytest worker collects the same
tests).  This file imports no JAX, so it also runs on a machine that has
PyTorch and the CUDA toolkit but no JAX; there, skip the JAX-importing
``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances:
  * K1, K2 and K5's logits: rtol 1e-4 / atol 1e-4 - the kernels sum the
    same fp32 terms as the plain versions in another order (register FMAs
    against tensor ops);
  * K5's int32 DPRR accumulators for linear f: exact - the kernel rounds
    every fp32 operation before a requantization as the plain version does;
  * K3: max |dLt| <= 1e-5 x max |Lt| - the same rotations in the same
    order, each divided by c and d; with its retirement operands (the
    forget scale, the guard flags) bit for bit, as the server's checks
    print it;
  * K6 and K7: rtol 1e-4 / atol 1e-4, as K1 (the ring matvec and the DPRR
    sums in another order);
  * K4a: max |dL| <= 1e-5 x max |L| - the same column updates in the same
    order with the same rounded operations (no FMA) as its plain version,
    so on its packed route (bs <= 256) it is also equal bit for bit;
  * K4b: max |dX| <= 1e-4 x max |X| on well-conditioned factors - each
    row's sums run right-looking (in another order than the plain version's
    dot products), with FMA and a reciprocal multiply, and each column's
    error feeds the next;
  * the blocked ridge solve at s = 931: max |dW| <= 1e-3 max |W| against the
    unblocked library solve at a well-conditioned beta;
  * K8 in fp32: rtol 1e-4 / atol 1e-4 (the same f32 scores, softmax and
    products, summed in another order, with the fast exponential); in bf16:
    rtol 2^-7 / atol 1e-4, compared in f32 - both sides round to bf16 from
    f32 values that differ in their last bits, so they are one bf16 step
    apart at most, and a step is at most 2^-7 of the value; the limit is
    relative because the outputs are small (a causal row of randn inputs
    averages about T/e keys);
  * the reduced LM on the card against the CPU in fp32: logits within 1e-3
    of the largest, greedy tokens equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.core.dfr import DFRModel
from repro_torch.core.online import OnlineDFR
from repro_torch.core.types import (DFRConfig, Nonlinearity, TimeSeriesBatch,
                                    map_leaves)
from repro_torch.kernels import cholesky as k_cholesky
from repro_torch.kernels import cholupdate as k_cholupdate
from repro_torch.kernels import dprr as k_dprr
from repro_torch.kernels import flash_attention as k_flash
from repro_torch.kernels import ops, ref
from repro_torch.kernels import reservoir as k_reservoir
from repro_torch.kernels import ridge_solve as k_ridge
from repro_torch.kernels import streaming as k_streaming
from repro_torch.kernels import streaming_q8 as k_streaming_q8
from repro_torch.kernels import train as k_train
from repro_torch.models.attention import blockwise_attention
from repro_torch.models.transformer import Transformer
from repro_torch.runtime import Request, Server, StreamRequest, StreamServer
from repro_torch.runtime.graphs import RoundGraphs

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-4, atol=1e-4)
K3_REL = 1e-5
K4A_REL = 1e-5
K4B_REL = 1e-4
SOLVE_REL = 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(dev, n_sys, b, t, nx, ny, seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, t + 1, (n_sys, b))
    lengths.flat[:2] = (1, t)
    arrays = (
        rng.normal(size=(n_sys, b, t, nx)).astype(np.float32),
        lengths.astype(np.int32),
        rng.uniform(0.01, 0.6, n_sys).astype(np.float32),
        rng.uniform(-0.6, 0.6, n_sys).astype(np.float32),
        (0.05 * rng.normal(size=(n_sys, ny, nx * (nx + 1)))).astype(
            np.float32),
        rng.normal(size=(n_sys, ny)).astype(np.float32),
    )
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


SHAPES = [(1, 3, 7, 1, 2), (3, 4, 20, 5, 3), (2, 8, 93, 30, 10),
          (4, 2, 33, 32, 4)]


@pytest.mark.parametrize("n_sys,b,t,nx,ny", SHAPES)
@pytest.mark.parametrize("f_name", ["linear", "tanh", "mackey_glass"])
def test_k1_kernel_matches_plain(dev, n_sys, b, t, nx, ny, f_name):
    j, lens, p, q, _, _ = _operands(dev, n_sys, b, t, nx, ny, seed=nx + t)
    f = Nonlinearity(f_name, 0.8)
    got = ops.train_forward(j, lens, p, q, nx, f=f, backend="cuda")
    want = ops.train_forward(j, lens, p, q, nx, f=f, backend="torch")
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("r", "x_last", "x_prev", "j_last")):
        torch.testing.assert_close(g, w, msg=name, **TOL)


@pytest.mark.parametrize("n_sys,b,t,nx,ny", SHAPES)
@pytest.mark.parametrize("f_name", ["linear", "tanh", "mackey_glass"])
def test_k2_kernel_matches_plain(dev, n_sys, b, t, nx, ny, f_name):
    j, lens, p, q, W, bias = _operands(dev, n_sys, b, t, nx, ny, seed=t)
    f = Nonlinearity(f_name, 0.8)
    got = ops.streaming_logits_slots(j, lens, p, q, W, bias, nx, f=f,
                                     backend="cuda")
    want = ops.streaming_logits_slots(j, lens, p, q, W, bias, nx, f=f,
                                      backend="torch")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)


def test_launch_counts_and_default_dispatch(dev):
    j, lens, p, q, W, bias = _operands(dev, 2, 3, 9, 6, 3, seed=0)
    k1, k2 = k_train.KERNEL.launches, k_streaming.KERNEL.launches
    ops.train_forward(j, lens, p, q, 6)               # backend from device
    ops.streaming_logits_slots(j, lens, p, q, W, bias, 6)
    ops.train_forward(j, lens, p, q, 6, backend="torch")  # the plain version
    assert k_train.KERNEL.launches == k1 + 1
    assert k_streaming.KERNEL.launches == k2 + 1


def test_kernels_reject_what_they_do_not_take(dev):
    j, lens, p, q, W, bias = _operands(dev, 1, 2, 5, 33, 2, seed=1)
    with pytest.raises(ValueError, match="Nx"):
        ops.train_forward(j, lens, p, q, 33)
    j, lens, p, q, W, bias = _operands(dev, 1, 2, 5, 4, 2, seed=1)
    with pytest.raises(ValueError, match="device|on"):
        k_train.train_forward_cuda(j[0], lens[0], p.cpu(), q)
    with pytest.raises(TypeError):
        k_train.train_forward_cuda(j[0], lens[0].float(), p, q)
    with pytest.raises(ValueError, match="contiguous"):
        k_train.train_forward_cuda(j[0].transpose(0, 1), lens[0], p, q)


def test_server_on_card_agrees_with_cpu(dev):
    """A small episode through K1 and K2 on the card against the same
    episode on the CPU; each kernel launches once per server round."""
    cfg = DFRConfig(n_in=2, n_classes=3, n_nodes=8)
    rng = np.random.default_rng(0)
    mask = np.sign(rng.normal(size=(8, 2))).astype(np.float32)
    results = {}
    for device in ("cuda", "cpu"):
        srv = StreamServer(cfg, t_max=16, max_streams=3, window=2,
                           phase_steps=2, refresh_every=3, mask=mask,
                           device=device)
        for rid, n in enumerate((8, 6, 10, 4, 7)):
            r = np.random.default_rng(rid)
            srv.submit(StreamRequest(
                rid=rid, u=r.normal(size=(n, 16, 2)).astype(np.float32),
                length=r.integers(4, 17, n).astype(np.int32),
                label=r.integers(0, 3, n).astype(np.int32)))
        k1, k2 = k_train.KERNEL.launches, k_streaming.KERNEL.launches
        done = srv.run_until_drained()
        if device == "cuda":
            assert k_train.KERNEL.launches - k1 == srv.global_step
            assert k_streaming.KERNEL.launches - k2 == srv.global_step
        results[device] = {r.rid: r.preds for r in done}
    total = sum(len(v) for v in results["cpu"].values())
    agree = sum(int(a == b) for rid, v in results["cpu"].items()
                for a, b in zip(v, results["cuda"][rid]))
    assert agree / total >= 0.98


def _q8_operands(dev, n_sys, b, t, nx, ny, seed):
    """K5's operands: the K2 operands plus int8 readout codes and per-slot
    scales, the last slot unarmed (scales 0)."""
    j, lens, p, q, _, bias = _operands(dev, n_sys, b, t, nx, ny, seed)
    rng = np.random.default_rng(seed + 1)
    Wq = torch.from_numpy(rng.integers(-127, 128, (n_sys, ny, nx * (nx + 1)))
                          .astype(np.int8)).to(dev)
    w_scale = torch.from_numpy(
        rng.uniform(1e-4, 1e-3, n_sys).astype(np.float32)).to(dev)
    x_scale = torch.from_numpy(
        rng.uniform(0.01, 0.05, n_sys).astype(np.float32)).to(dev)
    w_scale[-1] = x_scale[-1] = 0.0
    return j, lens, p, q, Wq, w_scale, x_scale, bias


@pytest.mark.parametrize("n_sys,b,t,nx,ny", SHAPES)
@pytest.mark.parametrize("f_name", ["linear", "tanh", "mackey_glass"])
def test_k5_kernel_matches_plain(dev, n_sys, b, t, nx, ny, f_name):
    args = _q8_operands(dev, n_sys, b, t, nx, ny, seed=2 * t + nx)
    f = Nonlinearity(f_name, 0.8)
    got, got_acc = ops.streaming_logits_slots_q8(
        *args, nx, f=f, backend="cuda", return_acc=True)
    want, want_acc = ops.streaming_logits_slots_q8(
        *args, nx, f=f, backend="torch", return_acc=True)
    torch.cuda.synchronize()
    if f_name == "linear":
        assert torch.equal(got_acc, want_acc)
    torch.testing.assert_close(got, want, **TOL)


def _k3_operands(dev, k, w, s, seed):
    """Upper-triangular factors with a positive diagonal, and sample rows."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    Lt = torch.triu(0.05 * torch.randn(k, s, s, generator=g), diagonal=1)
    Lt = Lt + torch.diag_embed(1.0 + torch.rand(k, s, generator=g))
    X = 0.3 * torch.randn(k, w, s, generator=g)
    return Lt.to(dev), X.to(dev)


def _assert_factor_close(got, want):
    err = float((got - want).abs().max())
    assert torch.isfinite(got).all()
    assert err <= K3_REL * float(want.abs().max()), err


# W of 1, 4, 9 and 17 (one pass of up to 8 rows, or several); s from 1 to
# 4096, where shared memory takes passes of 5 rows
@pytest.mark.parametrize("k,w,s", [(1, 1, 5), (3, 4, 73), (2, 11, 200),
                                   (4, 4, 931), (2, 1, 1), (2, 9, 2),
                                   (3, 17, 31), (2, 4, 33), (1, 9, 931),
                                   (1, 4, 2048), (1, 9, 4096)])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_k3_kernel_matches_plain(dev, k, w, s, sign):
    Lt, X = _k3_operands(dev, k, w, s, seed=s + w)
    X[:, 0] = 0.0                                  # a zero row: a no-op
    if sign < 0:
        Lt = ops.cholupdate_window_t(Lt, X, 1.0, backend="torch")
        X[0, -1] = 0.0
        X[0, -1, s // 2] = 3.0 * Lt[0, s // 2, s // 2]   # guard-skipped
    want = ops.cholupdate_window_t(Lt, X, sign, backend="torch")
    got = ops.cholupdate_window_t(Lt, X, sign, backend="cuda")
    torch.cuda.synchronize()
    _assert_factor_close(got, want)
    inplace = Lt.clone()
    ops.cholupdate_window_t(inplace, X, sign, out=inplace, backend="cuda")
    torch.cuda.synchronize()
    _assert_factor_close(inplace, want)


@pytest.mark.parametrize("scale", [1e-20, 1e18])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_k3_out_of_range_operands_fold_exactly(dev, scale, sign):
    """Factors and rows scaled so that diagonals, radicands and numerators
    leave the range where the kernel's fast divide and square root are
    exact (2^-60 .. 2^60; at 1e-20 the squared diagonals are subnormal,
    where the approximate reciprocal square root flushes to zero): the
    kernel must fold them again with the correctly rounded intrinsics."""
    Lt, X = _k3_operands(dev, 2, 4, 64, seed=7)
    Lt, X = Lt * scale, X * scale
    X[:, 1] = 0.0
    if sign < 0:
        Lt = ops.cholupdate_window_t(Lt, X, 1.0, backend="torch")
        X[0, -1] = 0.0
        X[0, -1, 32] = 3.0 * Lt[0, 32, 32]             # guard-skipped
    want = ops.cholupdate_window_t(Lt, X, sign, backend="torch")
    got = ops.cholupdate_window_t(Lt, X, sign, backend="cuda")
    torch.cuda.synchronize()
    _assert_factor_close(got, want)


# the forget fold's scale and the window's flagged downdate, at one pass
# of 1, 4 and 8 rows, a small factor and ARAB's
@pytest.mark.parametrize("w", [1, 4, 8])
@pytest.mark.parametrize("s", [31, 931])
def test_k3_scale_and_flags_bit_for_bit(dev, w, s):
    k = 4
    Lt, X = _k3_operands(dev, k, w, s, seed=w + s)
    X[1, -1] = 0.0                     # a gated row: scale exactly 1.0
    scale = torch.where(X.abs().sum(dim=-1) > 0, 0.95 ** 0.5,
                        1.0).to(torch.float32)
    want = ops.cholupdate_window_t(Lt, X, 1.0, scale=scale, backend="torch")
    got = ops.cholupdate_window_t(Lt, X, 1.0, scale=scale, backend="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # a downdate the guard skips in factors 0 and 2, not in 1 and 3
    D = 0.05 * X
    D[0, -1, s // 2] = 3.0 * want[0, s // 2, s // 2]
    D[2, 0, 0] = 3.0 * want[2, 0, 0]
    flags = torch.full((k,), 7, dtype=torch.int32, device=dev)
    plain_flags = flags.clone()
    got = ops.cholupdate_window_t(want, D, -1.0, flags=flags, out=want.clone(),
                                  backend="cuda")
    plain = ops.cholupdate_window_t(want, D, -1.0, flags=plain_flags,
                                    backend="torch")
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    assert flags.tolist() == plain_flags.tolist() == [1, 0, 1, 0]


def test_k3_scale_of_one_is_the_unscaled_fold(dev):
    Lt, X = _k3_operands(dev, 3, 4, 73, seed=3)
    ones = torch.ones(3, 4, device=dev)
    flags = torch.ones(3, dtype=torch.int32, device=dev)
    a = ops.cholupdate_window_t(Lt, X, 1.0, scale=ones, flags=flags)
    b = ops.cholupdate_window_t(Lt, X, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and flags.tolist() == [0, 0, 0]
    with pytest.raises(ValueError, match="scale"):
        k_cholupdate.cholupdate_window_t_cuda(Lt.clone(), X, 1.0,
                                              scale=ones[:, :3].clone())
    with pytest.raises(TypeError):
        k_cholupdate.cholupdate_window_t_cuda(Lt.clone(), X, 1.0,
                                              flags=flags.long())


def test_k5_k3_launch_counts_and_rejections(dev):
    args = _q8_operands(dev, 2, 3, 9, 6, 3, seed=0)
    Lt, X = _k3_operands(dev, 2, 3, 10, seed=0)
    k5, k3 = k_streaming_q8.KERNEL.launches, k_cholupdate.KERNEL.launches
    ops.streaming_logits_slots_q8(*args, 6)              # backend from device
    ops.cholupdate_window_t(Lt, X)
    ops.cholupdate_window_t(Lt, X, backend="torch")      # the plain version
    assert k_streaming_q8.KERNEL.launches == k5 + 1
    assert k_cholupdate.KERNEL.launches == k3 + 1
    with pytest.raises(ValueError, match="s <="):
        k_cholupdate.cholupdate_window_t_cuda(
            torch.zeros(1, 4097, 4097, device=dev),
            torch.zeros(1, 1, 4097, device=dev), 1.0)
    with pytest.raises(TypeError):
        k_cholupdate.cholupdate_window_t_cuda(Lt, X.double(), 1.0)


def test_int8_incremental_server_on_card_agrees_with_cpu(dev):
    """A short armed int8 + incremental episode on the card against the same
    episode on the CPU; K1, K2, K5 and K3 each launch once per round."""
    cfg = DFRConfig(n_in=2, n_classes=3, n_nodes=8)
    rng = np.random.default_rng(0)
    mask = np.sign(rng.normal(size=(8, 2))).astype(np.float32)
    kernels = (k_train.KERNEL, k_streaming.KERNEL, k_streaming_q8.KERNEL,
               k_cholupdate.KERNEL)
    results = {}
    for device in ("cuda", "cpu"):
        srv = StreamServer(cfg, t_max=16, max_streams=3, window=2,
                           phase_steps=2, refresh_every=3, mask=mask,
                           refresh_mode="incremental", quantize="int8",
                           device=device)
        for rid, n in enumerate((12, 6, 10, 4, 9)):
            r = np.random.default_rng(rid)
            srv.submit(StreamRequest(
                rid=rid, u=r.normal(size=(n, 16, 2)).astype(np.float32),
                length=r.integers(4, 17, n).astype(np.int32),
                label=r.integers(0, 3, n).astype(np.int32)))
        before = [kn.launches for kn in kernels]
        done = srv.run_until_drained()
        if device == "cuda":
            for kn, b in zip(kernels, before):
                assert kn.launches - b == srv.global_step, kn.name
            assert srv.served_int8 > 0
        results[device] = {r.rid: r.preds for r in done}
    total = sum(len(v) for v in results["cpu"].values())
    agree = sum(int(a == b) for rid, v in results["cpu"].items()
                for a, b in zip(v, results["cuda"][rid]))
    assert agree / total >= 0.98


# ---------------------------------------------------------------------------
# The captured round: the server's CUDA graphs against its eager round
# ---------------------------------------------------------------------------

GRAPH_MODES = {
    "recompute": {},
    "int8": {"refresh_mode": "incremental", "quantize": "int8"},
}


def _graph_server(mode, eager=False, sizes=(12, 6, 10, 4, 9), **kw):
    """The small episode's server with its streams submitted; ``eager``
    serves through the eager round (the captured round's oracle)."""
    cfg = DFRConfig(n_in=2, n_classes=3, n_nodes=8)
    rng = np.random.default_rng(0)
    mask = np.sign(rng.normal(size=(8, 2))).astype(np.float32)
    srv = StreamServer(cfg, t_max=16, max_streams=3, window=2,
                       phase_steps=2, refresh_every=3, mask=mask,
                       device="cuda", **GRAPH_MODES[mode], **kw)
    if eager:
        srv._graphs = None
    for rid, n in enumerate(sizes):
        r = np.random.default_rng(rid)
        srv.submit(StreamRequest(
            rid=rid, u=r.normal(size=(n, 16, 2)).astype(np.float32),
            length=r.integers(4, 17, n).astype(np.int32),
            label=r.integers(0, 3, n).astype(np.int32)))
    return srv


def _state_leaves(st):
    out = []
    map_leaves(out.append, st)
    return out


def _assert_same_serving(a, b):
    """Predictions, retirement snapshots and final states bit for bit."""
    done_a = {r.rid: r for r in a.completed}
    done_b = {r.rid: r for r in b.completed}
    assert sorted(done_a) == sorted(done_b)
    for rid, r in done_b.items():
        assert done_a[rid].preds == r.preds
        for x, y in zip(_state_leaves(done_a[rid].final_state),
                        _state_leaves(r.final_state)):
            assert torch.equal(x, y)
    for x, y in zip(_state_leaves(a.states), _state_leaves(b.states)):
        assert torch.equal(x, y)
    assert a.global_step == b.global_step
    assert a.served_int8 == b.served_int8


@pytest.mark.parametrize("mode", sorted(GRAPH_MODES))
def test_captured_episode_serves_the_eager_episode(dev, mode):
    eager = _graph_server(mode, eager=True)
    eager.run_until_drained()
    srv = _graph_server(mode)
    srv.run_until_drained()
    assert srv._graphs.replays > 0
    _assert_same_serving(srv, eager)


@pytest.mark.parametrize("mode", sorted(GRAPH_MODES))
def test_pipelined_blocked_captured_episode_is_the_synchronous_one(dev,
                                                                   mode):
    sync = _graph_server(mode)
    sync.run_until_drained()
    srv = _graph_server(mode, pipeline_depth=2, step_block=4)
    srv.run_until_drained()
    assert len(srv.step_times_s) < srv.global_step
    _assert_same_serving(srv, sync)


@pytest.mark.parametrize("mode", sorted(GRAPH_MODES))
def test_captured_launch_counts_equal_rounds(dev, mode):
    """Every kernel of the path counts one launch a round, counted at
    replay; the launches recorded during capture count nowhere."""
    kernels = [k_train.KERNEL, k_streaming.KERNEL]
    if mode == "int8":
        kernels += [k_streaming_q8.KERNEL, k_cholupdate.KERNEL]
    srv = _graph_server(mode)
    before = [kn.launches for kn in kernels]
    srv.run_until_drained()
    assert srv._graphs.replays > 0
    for kn, b in zip(kernels, before):
        assert kn.launches - b == srv.global_step, kn.name


def test_capture_tallies_launches_instead_of_counting_them(dev):
    j, lens, p, q, _, _ = _operands(dev, 2, 3, 9, 6, 3, seed=0)
    graphs = RoundGraphs()
    before = k_train.KERNEL.launches
    outs = []
    for _ in range(4):   # eager, capture + replay, replay, replay
        r = graphs.run("k1", lambda: ops.train_forward(j, lens, p, q, 6)[0])
        outs.append(r.clone())
        assert k_train.KERNEL.launches == before + len(outs)
    torch.cuda.synchronize()
    assert graphs.eager_calls == 1 and graphs.replays == 3
    for r in outs[1:]:
        assert torch.equal(r, outs[0])


def test_pool_growth_captures_again(dev):
    """A stream longer than the pool's rows, submitted mid-episode, grows
    the pool: the graphs are dropped, captured again, and the episode still
    serves the eager one's."""
    runs = {}
    for eager in (True, False):
        srv = _graph_server("int8", eager=eager, sizes=(4, 6, 4, 8, 6))
        for _ in range(4):
            srv.step()
        r = np.random.default_rng(9)
        srv.submit(StreamRequest(
            rid=9, u=r.normal(size=(20, 16, 2)).astype(np.float32),
            length=r.integers(4, 17, 20).astype(np.int32),
            label=r.integers(0, 3, 20).astype(np.int32)))
        assert srv.pool.capacity == 20
        if not eager:
            assert srv._graphs.replays > 0 and not srv._graphs._graphs
        srv.run_until_drained()
        runs[eager] = srv
    assert runs[False]._graphs._graphs   # captured again after the growth
    _assert_same_serving(runs[False], runs[True])


# the retirement modes: streams whose labels follow a fixed linear rule of
# the first steps and move to the next class at sample 20, so that the
# adaptive detector trips
RETIRE_MODES = {
    "forget": {"retirement": "forget", "forget": 0.95},
    "window": {"retirement": "window", "retire_window": 3},
    "adaptive": {"retirement": "adaptive"},
    "adaptive_int8": {"retirement": "adaptive", "quantize": "int8"},
}


def _retire_server(mode, eager=False, **kw):
    cfg = DFRConfig(n_in=2, n_classes=3, n_nodes=8)
    rng = np.random.default_rng(0)
    mask = np.sign(rng.normal(size=(8, 2))).astype(np.float32)
    knobs = {**RETIRE_MODES[mode], **kw}
    srv = StreamServer(cfg, t_max=16, max_streams=3, window=4,
                       phase_steps=2, refresh_every=3, mask=mask,
                       refresh_mode="incremental", device="cuda", **knobs)
    if eager:
        srv._graphs = None
    for rid, n in enumerate((40, 34, 37, 29)):
        r = np.random.default_rng(rid)
        u = r.normal(size=(n, 16, 2)).astype(np.float32)
        score = u[:, :4].sum(axis=1) @ np.array([1.0, -1.0], np.float32)
        label = np.digitize(score, [-1.0, 1.0]).astype(np.int32)
        label[20:] = (label[20:] + 1) % 3
        srv.submit(StreamRequest(
            rid=rid, u=u, length=r.integers(4, 17, n).astype(np.int32),
            label=label))
    return srv


def _serve_retire(mode, eager=False, shrink_at=None, **kw):
    """Serve the retirement episode; ``shrink_at`` shrinks every live
    factor after that many dispatches, so the next evictions trip the
    downdate guard (the reference's
    ``test_window_guard_refactorizes_on_indefinite_eviction``)."""
    srv = _retire_server(mode, eager=eager, **kw)
    steps = 0
    while srv.sched.active():
        if steps == shrink_at:
            srv.states.ridge.Lt.mul_(0.05)
        srv.step()
        steps += 1
    srv.drain()
    return srv


@pytest.mark.parametrize("mode", sorted(RETIRE_MODES))
def test_retirement_captured_and_pipelined_serve_the_eager_episode(dev,
                                                                   mode):
    """Each mode's captured round (the window's guard rebuild and the
    detector's anneal as conditional nodes) and its pipelined, blocked
    round serve the eager round's episode bit for bit."""
    eager = _serve_retire(mode, eager=True)
    captured = _serve_retire(mode)
    assert captured._graphs.replays > 0
    _assert_same_serving(captured, eager)
    blocked = _serve_retire(mode, pipeline_depth=2, step_block=4)
    assert len(blocked.step_times_s) < blocked.global_step
    _assert_same_serving(blocked, eager)
    if captured.win is not None:
        for x, y in zip(_state_leaves(captured.win),
                        _state_leaves(eager.win)):
            assert torch.equal(x, y)


def test_window_guard_rebuild_captured_is_the_eager_one(dev):
    """Rounds where the guard fires: the captured round's conditional
    rebuild gives the eager round's factors bit for bit, and the rebuilt
    factors factor their statistics again."""
    eager = _serve_retire("window", eager=True, shrink_at=8)
    captured = _serve_retire("window", shrink_at=8)
    clean = _serve_retire("window", shrink_at=None)
    _assert_same_serving(captured, eager)
    assert any(not torch.equal(a.final_state.ridge.Lt, b.final_state.ridge.Lt)
               for a, b in zip(sorted(captured.completed, key=lambda r: r.rid),
                               sorted(clean.completed, key=lambda r: r.rid)))
    for r in captured.completed:
        Lt = r.final_state.ridge.Lt.double()
        M = r.final_state.ridge.B.double() + 1e-2 * torch.eye(
            Lt.shape[0], dtype=torch.float64, device=dev)
        assert float((Lt.T @ Lt - M).abs().max() / M.abs().max()) <= 1e-4


def test_adaptive_trips_in_the_captured_round(dev):
    """The detector trips on the drifting streams inside the captured
    round: its statistics leave the silent detector's."""
    tripping = _serve_retire("adaptive")
    silent = _serve_retire("adaptive", adapt_ratio=1e9)
    assert tripping._graphs.replays > 0
    assert any(not torch.equal(a.final_state.ridge.B, b.final_state.ridge.B)
               for a, b in zip(sorted(tripping.completed, key=lambda r: r.rid),
                               sorted(silent.completed, key=lambda r: r.rid)))


@pytest.mark.parametrize("mode,per_round", [("forget", 1), ("window", 2)])
def test_retirement_k3_launches_at_replay(dev, mode, per_round):
    """K3 folds once a round under forget (scaled) and twice under window
    (the fold, then the flagged downdate), counted at replay."""
    srv = _retire_server(mode)
    before = k_cholupdate.KERNEL.launches
    srv.run_until_drained()
    assert srv._graphs.replays > 0
    assert k_cholupdate.KERNEL.launches - before == per_round * srv.global_step


def test_failed_capture_raises(dev, monkeypatch):
    """A body that syncs the host cannot be captured: the capture raises,
    and the server raises rather than serving the round eagerly."""
    graphs = RoundGraphs()
    x = torch.ones(4, device=dev)
    assert graphs.run("sync", lambda: float(x.sum())) == 4.0   # eager
    with pytest.raises(RuntimeError):
        graphs.run("sync", lambda: float(x.sum()))
    torch.cuda.synchronize()

    from repro_torch.runtime import stream_server

    gather = stream_server._gather_window

    def syncing_gather(pool, cursor, live, window, dtype):
        int(cursor.sum())
        return gather(pool, cursor, live, window, dtype)

    monkeypatch.setattr(stream_server, "_gather_window", syncing_gather)
    srv = _graph_server("recompute")
    with pytest.raises(RuntimeError):
        srv.run_until_drained()
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# K6, K7, K4a, K4b and the training path (DFRModel, OnlineDFR)
# ---------------------------------------------------------------------------


# B = 4 is fit_sgd's minibatch and 6600 ARAB's training split (T = 93)
@pytest.mark.parametrize("nx", [1, 8, 17, 30, 32])
@pytest.mark.parametrize("b", [1, 4, 7, 37, 6600])
@pytest.mark.parametrize("f_name", ["linear", "tanh"])
def test_k6_k7_kernels_match_plain(dev, nx, b, f_name):
    j, lens, p, q, _, _ = _operands(dev, 1, b, 93, nx, 1, seed=nx + b)
    j, lens = j[0], lens[0]
    special = (93, 0, 1)[:b]                       # full, empty, one step
    lens[:len(special)] = torch.tensor(special, dtype=lens.dtype)
    f = Nonlinearity(f_name, 0.8)
    got = ops.reservoir_states(j, lens, p[0], q[0], nx, f=f, backend="cuda")
    want = ops.reservoir_states(j, lens, p[0], q[0], nx, f=f,
                                backend="torch")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    live = torch.arange(93, device=dev) < lens[:, None]
    last = got[torch.arange(b, device=dev), (lens - 1).clamp(min=0).long()]
    frozen = ~live & (lens > 0)[:, None]           # the frozen rows
    assert bool((got == last[:, None])[frozen].all())
    if b > 1:
        assert bool((got[1] == 0).all())           # the empty sample
    # K7 on the kernel's states; rows past a length must not count
    noisy = torch.where(live[..., None], got, 1e3)
    r = ops.dprr_features(noisy, lens, nx, backend="cuda")
    r_plain = ops.dprr_features(got, lens, nx, backend="torch")
    torch.cuda.synchronize()
    torch.testing.assert_close(r, r_plain, **TOL)


# K6 at one warp a block: lone samples and the grid's edges around the 132
# SMs, one system or several, and lengths 0, 1, T - 1 and T.  The gains are
# drawn where the reservoir is stable (p alpha / (1 - |q|) < 1, the echo
# state the model trains in): past it the states grow like the gain to the
# power of the step, and so do the rounding differences of any two fp32
# orders of the sums, the plain version's own distance to a float64 run
# among them.
@pytest.mark.parametrize("nx", [1, 7, 30, 32])
@pytest.mark.parametrize("n", [1, 4, 5, 131, 132, 133])
def test_k6_sample_counts_systems_and_lengths(dev, nx, n):
    t = 93
    rng = np.random.default_rng(1000 * nx + n)
    j = torch.from_numpy(rng.normal(size=(n, t, nx)).astype(np.float32))
    lengths = rng.integers(0, t + 1, n)
    lengths[:4] = (0, 1, t, t - 1)[:n]
    lens = torch.from_numpy(lengths.astype(np.int32))
    j, lens = j.to(dev), lens.to(dev)
    step = torch.arange(t, device=dev)
    for n_sys in sorted({1, n} | ({n // 2} if n % 2 == 0 else set())):
        p = torch.from_numpy(rng.uniform(0.01, 0.4, n_sys).astype(
            np.float32)).to(dev)
        q = torch.from_numpy(rng.uniform(-0.5, 0.5, n_sys).astype(
            np.float32)).to(dev)
        for f in (Nonlinearity("linear", 0.8), Nonlinearity("tanh", 0.8),
                  Nonlinearity("mackey_glass", 1.0)):
            got = k_reservoir.reservoir_states_cuda(j, lens, p, q, f)
            want = ref.reservoir_ref(j, lens, p, q, f)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **TOL)
            last = got[torch.arange(n, device=dev),
                       (lens.long() - 1).clamp(min=0)]
            frozen = (step[None, :] >= lens[:, None]) & (lens > 0)[:, None]
            assert bool((got == last[:, None])[frozen].all())
            assert bool((got[lens == 0] == 0).all())


# K1 and K2 at one warp a block: lone samples and the grid's edges around
# the 132 SMs, one system or several, T from 1 to 257 (several turns of the
# state ring), lengths around the chunks of 16 steps (0, 1, 2, 15, 16, 17,
# 31, 32, 33, T - 1 and T, as far as n and T allow; the first is T), all
# three f, and Ny 1, 4, 5 and 10 across K2's groups of 2 classes.  Gains
# where the reservoir is stable, as for K6 above.
_EDGE_T_NY = ((1, 1), (17, 4), (93, 10), (257, 5))
_EDGE_F = (Nonlinearity("linear", 0.8), Nonlinearity("tanh", 0.8),
           Nonlinearity("mackey_glass", 1.0))


def _edge_cases(dev, nx, n):
    """(T, Ny, j, lengths, p, q, W, b) at each T, for 1 and several
    systems."""
    for t, ny in _EDGE_T_NY:
        rng = np.random.default_rng(1000 * nx + 10 * n + t)
        lengths = rng.integers(0, t + 1, n)
        edges = list(dict.fromkeys(
            min(v, t) for v in (t, 0, 1, 2, 15, 16, 17, 31, 32, 33, t - 1)))
        lengths[:len(edges)] = edges[:n]
        j = torch.from_numpy(rng.normal(size=(n, t, nx)).astype(np.float32))
        lens = torch.from_numpy(lengths.astype(np.int32))
        for n_sys in sorted({1, n} | ({n // 2} if n % 2 == 0 else set())):
            arrays = (rng.uniform(0.01, 0.4, n_sys).astype(np.float32),
                      rng.uniform(-0.5, 0.5, n_sys).astype(np.float32),
                      (0.05 * rng.normal(size=(n_sys, ny, nx * (nx + 1))))
                      .astype(np.float32),
                      rng.normal(size=(n_sys, ny)).astype(np.float32))
            yield (t, ny, j.to(dev), lens.to(dev),
                   *(torch.from_numpy(a).to(dev) for a in arrays))


@pytest.mark.parametrize("nx", [1, 7, 30, 32])
@pytest.mark.parametrize("n", [1, 4, 5, 131, 132, 133])
def test_k1_sample_counts_systems_and_lengths(dev, nx, n):
    for t, _, j, lens, p, q, _, _ in _edge_cases(dev, nx, n):
        for f in _EDGE_F:
            got = k_train.train_forward_cuda(j, lens, p, q, f)
            want = ref.train_forward_ref(j, lens, p, q, f)
            torch.cuda.synchronize()
            for g, w, name in zip(got, want,
                                  ("r", "x_last", "x_prev", "j_last")):
                torch.testing.assert_close(g, w, msg=f"{name} T={t}", **TOL)
            # the boundary rows of steps that do not exist are exactly 0
            assert not bool(got[2][lens <= 1].any())
            assert not any(bool(g[lens == 0].any()) for g in got)


@pytest.mark.parametrize("nx", [1, 7, 30, 32])
@pytest.mark.parametrize("n", [1, 4, 5, 131, 132, 133])
def test_k2_sample_counts_systems_and_lengths(dev, nx, n):
    for t, ny, j, lens, p, q, W, bias in _edge_cases(dev, nx, n):
        for f in _EDGE_F:
            got = k_streaming.streaming_logits_cuda(j, lens, p, q, W, bias, f)
            want = ref.streaming_logits_ref(j, lens, p, q, W, bias, f)
            torch.cuda.synchronize()
            assert got.shape == (n, ny)
            torch.testing.assert_close(got, want, msg=f"T={t}", **TOL)


# K5 at every node count it takes and at lengths around its chunks of 16
# steps and its integer products of 32 and 128 steps
@pytest.mark.parametrize("nx", [1, 7, 30, 32])
@pytest.mark.parametrize("t", [1, 31, 33, 93, 129, 257])
def test_k5_node_counts_and_lengths(dev, nx, t):
    args = _q8_operands(dev, 3, 4, t, nx, 3, seed=7 * t + nx)
    for f in (Nonlinearity("linear", 0.8), Nonlinearity("tanh", 0.8),
              Nonlinearity("mackey_glass", 1.0)):
        got, got_acc = ops.streaming_logits_slots_q8(
            *args, nx, f=f, backend="cuda", return_acc=True)
        want, want_acc = ops.streaming_logits_slots_q8(
            *args, nx, f=f, backend="torch", return_acc=True)
        torch.cuda.synchronize()
        if f.code == 0:
            assert torch.equal(got_acc, want_acc)
        torch.testing.assert_close(got, want, **TOL)


# K5's divide: an x_scale below its fast quotient's range runs the exact
# divide from the start; an input too large for it makes the warp run its
# sample again with the exact divide.  The codes must not change.
@pytest.mark.parametrize("case", ["small x_scale", "huge input"])
def test_k5_exact_divide_gives_equal_codes(dev, case):
    j, lens, p, q, Wq, w_scale, x_scale, b = _q8_operands(
        dev, 3, 4, 93, 30, 10, seed=5)
    if case == "small x_scale":
        x_scale = x_scale * 1e-28
    else:
        j = j.clone()
        j[0, 1] *= 1e25
    args = (j, lens, p, q, Wq, w_scale, x_scale, b)
    f = Nonlinearity("linear", 0.8)
    got, got_acc = ops.streaming_logits_slots_q8(
        *args, 30, f=f, backend="cuda", return_acc=True)
    want, want_acc = ops.streaming_logits_slots_q8(
        *args, 30, f=f, backend="torch", return_acc=True)
    torch.cuda.synchronize()
    assert torch.equal(got_acc, want_acc)
    torch.testing.assert_close(got, want, **TOL)


def _spd_tiles(dev, k, n, seed):
    g = torch.Generator().manual_seed(seed)
    M = torch.randn(k, n, 2 * n, generator=g)
    return (M @ M.mT + n * torch.eye(n)).to(dev)


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("k,bs", [(1, 16), (3, 64), (2, 128), (1, 256)])
def test_k4a_kernel_matches_plain(dev, k, bs):
    a = _spd_tiles(dev, k, bs, seed=bs)
    got = k_cholesky.chol_block_batched(a, backend="cuda")
    want = k_cholesky.chol_block_batched(a, backend="torch")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert bool((torch.triu(got, 1) == 0).all())
    assert _rel(got, want) <= K4A_REL


def test_k4a_non_spd_tile_gives_nan(dev):
    for bs in (128, 256):
        a = _spd_tiles(dev, 2, bs, seed=1)
        a[1, 5, 5] = -a[1, 5, 5]
        got = k_cholesky.chol_block_batched(a, backend="cuda")
        want = k_cholesky.chol_block_batched(a, backend="torch")
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got[0]).all())
        assert bool(torch.isnan(got[1]).any())
        assert bool((torch.isnan(got) == torch.isnan(want)).all())


@pytest.mark.parametrize("k,m,bs", [(1, 8, 32), (2, 16, 128), (1, 896, 128),
                                    (2, 200, 256), (1, 16, 256)])
def test_k4b_kernels_match_plain(dev, k, m, bs):
    L = torch.linalg.cholesky(_spd_tiles(dev, k, bs, seed=m))
    g = torch.Generator().manual_seed(m + bs)
    rhs = torch.randn(k, m, bs, generator=g).to(dev)
    for fn in (k_cholesky.trsm_lower_t_batched,
               k_cholesky.trsm_lower_batched):
        got = fn(rhs, L, backend="cuda")
        want = fn(rhs, L, backend="torch")
        torch.cuda.synchronize()
        assert _rel(got, want) <= K4B_REL, fn.__name__


# K4a's two routes: bs <= 256 runs the blocked kernel on the packed tile in
# shared memory (ragged bs pads to a multiple of 32), bs > 256 the column
# loop on the tile in device memory
K4A_SIZES = [1, 17, 31, 32, 33, 100, 128, 129, 200, 256, 300, 1024]


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("bs", K4A_SIZES)
def test_k4a_tile_sizes_match_plain(dev, k, bs):
    a = _spd_tiles(dev, k, bs, seed=bs + k)
    got = k_cholesky.chol_block_batched(a, backend="cuda")
    want = k_cholesky.chol_block_batched(a, backend="torch")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert bool((torch.triu(got, 1) == 0).all())
    assert _rel(got, want) <= K4A_REL


@pytest.mark.parametrize("k,bs", [(1, 128), (3, 128), (1, 256), (2, 100)])
def test_k4a_equals_plain_bit_for_bit(dev, k, bs):
    """The blocked kernel applies each element's column updates in the
    plain version's order with the same rounded operations."""
    a = _spd_tiles(dev, k, bs, seed=7 * bs + k)
    got = k_cholesky.chol_block_batched(a, backend="cuda")
    want = k_cholesky.chol_block_batched(a, backend="torch")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("bs,bad", [(17, 3), (128, 70), (256, 200),
                                    (300, 150)])
def test_k4a_non_spd_tile_nan_where_plain(dev, bs, bad):
    """A pivot that goes negative in a later panel (packed route) or past
    bs = 256 (device-memory route): NaN exactly where the plain version has
    it, and the other tile untouched."""
    a = _spd_tiles(dev, 2, bs, seed=bs)
    a[1, bad, bad] = -a[1, bad, bad]
    got = k_cholesky.chol_block_batched(a, backend="cuda")
    want = k_cholesky.chol_block_batched(a, backend="torch")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got[0]).all())
    assert bool(torch.isnan(got[1]).any())
    assert bool((torch.isnan(got) == torch.isnan(want)).all())
    assert bool(torch.isfinite(got[1, :bad, :bad]).all())


@pytest.mark.parametrize("bs", [32, 100, 128, 256])
@pytest.mark.parametrize("m", [1, 16, 31, 33, 896, 1000])
def test_k4b_rows_and_tiles_match_plain(dev, m, bs):
    _check_k4b(dev, 2, m, bs)


@pytest.mark.parametrize("m,bs", [(40, 300), (33, 700), (16, 1024)])
def test_k4b_large_tiles_match_plain(dev, m, bs):
    """Double-buffered panels of L up to bs = 512, one buffer above."""
    _check_k4b(dev, 1, m, bs)


def _check_k4b(dev, k, m, bs):
    L = torch.linalg.cholesky(_spd_tiles(dev, k, bs, seed=m + bs))
    g = torch.Generator().manual_seed(m * bs)
    rhs = torch.randn(k, m, bs, generator=g).to(dev)
    for fn in (k_cholesky.trsm_lower_t_batched,
               k_cholesky.trsm_lower_batched):
        got = fn(rhs, L, backend="cuda")
        want = fn(rhs, L, backend="torch")
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all()), fn.__name__
        assert _rel(got, want) <= K4B_REL, fn.__name__


@pytest.mark.parametrize("block", [128, 256])
def test_blocked_ridge_solve_on_card(dev, block):
    s, ny = 931, 10
    g = torch.Generator().manual_seed(0)
    R = torch.randn(s, 3000, generator=g) / 50.0
    B = (R @ R.T + 1e-2 * torch.eye(s)).to(dev)
    A = torch.randn(ny, s, generator=g).to(dev)
    c4a, c4b = (k_cholesky.CHOL_KERNEL.launches,
                k_cholesky.TRSM_KERNEL.launches)
    got = ops.ridge_solve(A, B, block=block)
    want = ops.ridge_solve(A, B, backend="torch")
    torch.cuda.synchronize()
    assert _rel(got, want) <= SOLVE_REL
    nb = -(-s // block)
    assert k_cholesky.CHOL_KERNEL.launches - c4a == nb
    assert k_cholesky.TRSM_KERNEL.launches - c4b == (nb - 1) + 2 * nb
    C = ops.cholesky(B, block=block)
    assert _rel(C, ops.cholesky(B, backend="torch")) <= SOLVE_REL
    bad = B.clone()
    bad[300, 300] = -1.0
    assert not bool(torch.isfinite(ops.ridge_solve(A, bad,
                                                   block=block)).all())
    Wb = k_ridge.ridge_solve_blocked_batched(
        torch.stack([A, 2 * A]), torch.stack([B, B]), block=block,
        backend="cuda")
    assert _rel(Wb[1], 2 * want) <= SOLVE_REL


def _small_batch(dev, n, t, n_in, n_classes, seed):
    rng = np.random.default_rng(seed)
    return TimeSeriesBatch(
        u=torch.from_numpy(rng.normal(size=(n, t, n_in)).astype(np.float32)),
        length=torch.from_numpy(rng.integers(2, t + 1, n).astype(np.int32)),
        label=torch.from_numpy(rng.integers(0, n_classes, n).astype(
            np.int32)))


def test_dfr_model_fit_on_card_agrees_with_cpu(dev):
    """A small fit through K6, K7, K4a and K4b on the card against the same
    fit on the CPU: the same predictions on 0.98 of the samples."""
    cfg = DFRConfig(n_in=3, n_classes=4, n_nodes=8, epochs=2)
    train = _small_batch(dev, 96, 20, 3, 4, seed=0)
    kernels = (k_reservoir.KERNEL, k_dprr.KERNEL, k_cholesky.CHOL_KERNEL,
               k_cholesky.TRSM_KERNEL)
    preds = {}
    for device in ("cuda", "cpu"):
        m = DFRModel.create(cfg, device=device)
        before = [kn.launches for kn in kernels]
        params = m.fit(train, minibatch=4)
        preds[device] = m.predict(train, params).cpu()
        if device == "cuda":
            for kn, b in zip(kernels, before):
                assert kn.launches > b, kn.symbol
    assert float((preds["cuda"] == preds["cpu"]).float().mean()) >= 0.98


def test_online_dfr_on_card_launches_its_kernels(dev):
    cfg = DFRConfig(n_in=3, n_classes=4, n_nodes=8)
    batch = _small_batch(dev, 32, 12, 3, 4, seed=1)
    preds = {}
    for device in ("cuda", "cpu"):
        o = OnlineDFR(cfg, device=device)
        st = o.init()
        for lo in range(0, 32, 8):
            sl = slice(lo, lo + 8)
            st, _ = o.step(st, batch.u[sl], batch.length[sl],
                           batch.label[sl], 0.5, 0.5)
        k6, k7 = k_reservoir.KERNEL.launches, k_dprr.KERNEL.launches
        c4a, c4b = (k_cholesky.CHOL_KERNEL.launches,
                    k_cholesky.TRSM_KERNEL.launches)
        st = o.refresh_output(st, 1e-2)
        if device == "cuda":
            assert k_cholesky.CHOL_KERNEL.launches > c4a
            assert k_cholesky.TRSM_KERNEL.launches > c4b
        preds[device] = o.infer(st, batch.u, batch.length).cpu()
        if device == "cuda":
            assert k_reservoir.KERNEL.launches == k6 + 1
            assert k_dprr.KERNEL.launches == k7 + 1
    assert float((preds["cuda"] == preds["cpu"]).float().mean()) >= 0.98


def test_k4_k6_k7_reject_what_they_do_not_take(dev):
    with pytest.raises(ValueError, match="bs"):
        k_cholesky.chol_tile_cuda(torch.zeros(1, 1025, 1025, device=dev))
    with pytest.raises(ValueError, match="rhs"):
        k_cholesky.trsm_tile_cuda(torch.zeros(1, 4, 8, device=dev),
                                  torch.eye(16, device=dev)[None], False)
    with pytest.raises(ValueError, match="Nx"):
        k_dprr.dprr_features_cuda(torch.zeros(2, 4, 33, device=dev),
                                  torch.ones(2, dtype=torch.int32,
                                             device=dev))
    with pytest.raises(TypeError):
        k_dprr.dprr_features_cuda(torch.zeros(2, 4, 3, device=dev),
                                  torch.ones(2, device=dev))


# ---------------------------------------------------------------------------
# K8: flash attention, and the LM that runs it
# ---------------------------------------------------------------------------

K8_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
          torch.bfloat16: dict(rtol=2 ** -7, atol=1e-4)}
# (causal, window, Tq, Tk): causal across two ragged query tiles, causal
# with a sliding window, non-causal cross attention with Tq != Tk, and a
# ragged causal length that is no multiple of any tile
K8_CASES = {"causal": (True, 0, 256, 256), "window": (True, 50, 200, 200),
            "noncausal": (False, 0, 100, 300), "ragged": (True, 0, 77, 77)}


def _qkv_operands(dev, b, h, kv, tq, tk, d, dtype, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 .to(dev, dtype)
                 for shape in ((b, h, tq, d), (b, kv, tk, d), (b, kv, tk, d)))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,kv", [(9, 3), (32, 8)])
@pytest.mark.parametrize("case", sorted(K8_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k8_kernel_matches_plain(dev, d, h, kv, case, dtype):
    causal, window, tq, tk = K8_CASES[case]
    q, k, v = _qkv_operands(dev, 2, h, kv, tq, tk, d, dtype, seed=d + tq)
    before = k_flash.KERNEL.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              backend="cuda")
    want = ops.flash_attention(q, k, v, causal=causal, window=window,
                               backend="torch")
    torch.cuda.synchronize()
    assert k_flash.KERNEL.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **K8_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k8_fully_masked_rows_are_zero(dev, dtype):
    """Non-causal with a window of 16 over 32 keys: query rows 48.. see no
    key (k_pos > q_pos - 16 >= 32), and come out 0, not NaN."""
    q, k, v = _qkv_operands(dev, 1, 4, 2, 96, 32, 64, dtype, seed=3)
    got = ops.flash_attention(q, k, v, causal=False, window=16)
    want = ops.flash_attention(q, k, v, causal=False, window=16,
                               backend="torch")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert bool((got[:, :, 48:] == 0).all())
    torch.testing.assert_close(got.float(), want.float(), **K8_TOL[dtype])


def test_k8_reads_strided_views(dev):
    """The model's (B, T, H, D) activations enter as transposed views; the
    output is a (B, H, T, D) view of a (B, T, H, D) buffer."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 130, n, 64)).astype(
        np.float32)).to(dev, torch.bfloat16) for n in (9, 3, 3))
    got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2))
    want = ops.flash_attention(q.transpose(1, 2).contiguous(),
                               k.transpose(1, 2).contiguous(),
                               v.transpose(1, 2).contiguous(),
                               backend="torch")
    torch.cuda.synchronize()
    assert got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got.float(), want.float(),
                               **K8_TOL[torch.bfloat16])


def test_k8_long_causal_rows_match_blockwise(dev):
    """Nearly the prefill_32k length (32668, no multiple of a tile) in the
    model's layout: the longest causal rows and a ragged last key tile at
    full length, against blockwise_attention (the dense plain version's
    scores would take 38 GB at this length)."""
    rng = np.random.default_rng(5)
    t = 32768 - 100
    q, k, v = (torch.from_numpy(rng.normal(size=(1, t, n, 64)).astype(
        np.float32)).to(dev, torch.bfloat16) for n in (9, 3, 3))
    got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2))
    want = blockwise_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.transpose(1, 2).float(), want.float(),
                               **K8_TOL[torch.bfloat16])


def test_k8_rejects_what_it_does_not_take(dev):
    q, k, v = _qkv_operands(dev, 1, 4, 2, 8, 8, 64, torch.float32, seed=5)
    with pytest.raises(ValueError, match="head_dim"):
        k_flash.flash_attention_cuda(q[..., :48].contiguous(),
                                     k[..., :48].contiguous(),
                                     v[..., :48].contiguous())
    with pytest.raises(TypeError):
        k_flash.flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        k_flash.flash_attention_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="KV"):
        k_flash.flash_attention_cuda(q[:, :3], k, v)
    with pytest.raises(ValueError, match="device|on"):
        k_flash.flash_attention_cuda(q, k.cpu(), v)
    with pytest.raises(ValueError, match="contiguous"):
        k_flash.flash_attention_cuda(q.mT, k.mT, v.mT)


# The bf16 route's edges: a block holds 128 query rows in two warpgroups of
# 64, and K/V arrive by TMA in tiles of 128 keys, zero-filled past Tk.
K8_EDGE_LENGTHS = [1, 63, 64, 65, 127, 128, 129, 300]


def _k8_bf16_check(dev, b, h, kv, tq, tk, d, causal, window, seed):
    q, k, v = _qkv_operands(dev, b, h, kv, tq, tk, d, torch.bfloat16, seed)
    before = k_flash.KERNEL.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              backend="cuda")
    want = ops.flash_attention(q, k, v, causal=causal, window=window,
                               backend="torch")
    torch.cuda.synchronize()
    assert k_flash.KERNEL.launches == before + 1
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(),
                               **K8_TOL[torch.bfloat16])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tk", K8_EDGE_LENGTHS)
@pytest.mark.parametrize("tq", K8_EDGE_LENGTHS)
def test_k8_bf16_ragged_lengths(dev, tq, tk, causal):
    """Tq and Tk on both sides of the warpgroup's 64 rows and the 128-key
    tile; causal with Tq > Tk leaves the rows past Tk all their keys."""
    _k8_bf16_check(dev, 2, 4, 2, tq, tk, 64, causal, 0, seed=tq * 1000 + tk)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("g", [1, 3, 4])
def test_k8_bf16_head_dims_and_groups(dev, d, g):
    """Every head_dim the route takes (one or two 64-column swizzle blocks,
    or one of 32 in the 64-byte swizzle), with H / KV = 1, 3 and 4."""
    _k8_bf16_check(dev, 2, 2 * g, 2, 300, 300, d, True, 0, seed=d + g)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [1, 100, 200])
def test_k8_bf16_window_edge_inside_a_key_tile(dev, causal, window):
    """Windows whose edge falls inside a 128-key tile, so that a tile is
    masked on its left for some rows and skipped for others."""
    _k8_bf16_check(dev, 1, 6, 3, 517, 517, 64, causal, window, seed=window)


@pytest.mark.parametrize("tq,tk,causal", [(256, 385, False),
                                          (385, 385, True),
                                          (130, 641, False)])
def test_k8_bf16_last_key_tile_mostly_out_of_bounds(dev, tq, tk, causal):
    """Tk one key past a tile (or one after 5 tiles): the last tile's other
    127 keys are the TMA unit's zero fill and must score nothing."""
    _k8_bf16_check(dev, 2, 9, 3, tq, tk, 64, causal, 0, seed=tk)


def test_k8_bf16_rejects_what_tma_cannot_read(dev):
    """A bf16 operand the TMA unit cannot address raises before any launch:
    no fallback to the SIMT kernel."""
    q, k, v = _qkv_operands(dev, 1, 4, 2, 64, 64, 64, torch.bfloat16, seed=7)
    before = k_flash.KERNEL.launches
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=dev)
    shifted = flat[1:].view(q.shape)              # base 2 bytes off
    with pytest.raises(ValueError, match="^q's base address"):
        k_flash.flash_attention_cuda(shifted, k, v)
    padded = torch.zeros(1, 2, 64, 65, dtype=torch.bfloat16,
                         device=dev)[..., :64]    # rows 130 bytes apart
    with pytest.raises(ValueError, match="^v's strides"):
        k_flash.flash_attention_cuda(q, k, padded)
    with pytest.raises(ValueError, match="head_dim"):
        k_flash.flash_attention_cuda(q[..., :48].contiguous(),
                                     k[..., :48].contiguous(),
                                     v[..., :48].contiguous())
    assert k_flash.KERNEL.launches == before


def _lm_pair(dev):
    cfg = dataclasses.replace(get_reduced("smollm-135m"), dtype=torch.float32,
                              attn_impl="pallas")
    return tuple(Transformer(cfg, device=d,
                             generator=torch.Generator().manual_seed(0))
                 for d in (dev, "cpu"))


def test_lm_prefill_on_card_runs_k8_and_agrees_with_cpu(dev):
    card, cpu = _lm_pair(dev)
    toks = np.random.default_rng(6).integers(0, 512, (2, 150)).astype(np.int32)
    before = k_flash.KERNEL.launches
    got = card.prefill(toks)
    torch.cuda.synchronize()
    assert k_flash.KERNEL.launches == before + card.cfg.n_layers
    want = cpu.prefill(toks)
    err = float((got.cpu() - want).abs().max() / want.abs().max())
    assert err <= 1e-3
    assert bool((got.argmax(-1).cpu() == want.argmax(-1)).all())


def test_lm_server_on_card_agrees_with_cpu(dev):
    models = _lm_pair(dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (5, 9, 3, 7)]
    out = []
    for model in models:
        server = Server(model, max_batch=2, max_len=64)
        for i, p in enumerate(prompts):
            server.submit(Request(rid=i, prompt=p, max_tokens=6))
        before = k_flash.KERNEL.launches
        out.append({r.rid: r.out_tokens for r in server.run_until_drained()})
        assert k_flash.KERNEL.launches == before   # decode attention is plain
    assert out[0] == out[1]
