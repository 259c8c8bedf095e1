"""The port's packed 1-D Cholesky ridge (paper Algorithms 2-4), its numpy
oracles and the Table 2/3 counters against the JAX package's, on the CPU.

The same inputs, made with numpy, go through the reference's functions and
the port's; arrays cross as numpy.

Tolerances:
  * the port's numpy oracles (Algorithms 1-4 and the packed update, loops
    and all): equal bit for bit - the same numpy code on the same arrays;
  * the packed layout: exact (a copy);
  * the packed pipeline on tensors against the reference's jitted packed
    forms and against ``torch.linalg.cholesky`` (float64): max |d| <= 2e-4
    of the largest entry, the blocked solve's limit
    (tests/test_torch_ridge_solve.py) - the same column steps with each
    dot product summed in another order;
  * ``DFRModel.fit_ridge(method='cholesky_packed')``: the same beta, and
    training logits within 5e-3 of the largest (tests/test_torch_dfr.py);
  * the counters and the benchmark tables: equal.
"""
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import ridge as rridge
from repro_torch.core import ridge

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmarks import bench_ridge as rbench  # noqa: E402
from benchmarks_torch import bench_ridge  # noqa: E402

REL = 2e-4
LOGIT_REL = 5e-3


def _spd(s, seed=None):
    rng = np.random.default_rng(s if seed is None else seed)
    R = rng.normal(size=(s, 2 * s)).astype(np.float32)
    return (R @ R.T + 0.1 * np.eye(s, dtype=np.float32)).astype(np.float32)


def _system(s, ny=5):
    B = _spd(s)
    A = np.random.default_rng(s + 1).normal(size=(ny, s)).astype(np.float32)
    return A, B


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_packed_layout_matches_reference():
    s = 11
    B = _spd(s)
    assert ridge.packed_size(s) == rridge.packed_size(s) == 66
    assert ridge.packed_index(7, 3) == rridge.packed_index(7, 3) == 31
    P = ridge.pack_lower(torch.from_numpy(B))
    np.testing.assert_array_equal(P.numpy(),
                                  np.asarray(rridge.pack_lower(jnp.asarray(B))))
    D = ridge.unpack_lower(P, s).numpy()
    np.testing.assert_array_equal(D, np.tril(B))
    np.testing.assert_array_equal(
        D, np.asarray(rridge.unpack_lower(jnp.asarray(P.numpy()), s)))


def test_numpy_oracles_equal_reference():
    s = 9
    A, B = _system(s, ny=3)
    np.testing.assert_array_equal(ridge.ridge_gaussian_numpy(A, B),
                                  rridge.ridge_gaussian_numpy(A, B))
    P = np.asarray(rridge.pack_lower(jnp.asarray(B)))
    C = ridge.cholesky_packed_numpy(P, s)
    np.testing.assert_array_equal(C, rridge.cholesky_packed_numpy(P, s))
    D = ridge.trsm_packed_numpy(A, C, s)
    np.testing.assert_array_equal(D, rridge.trsm_packed_numpy(A, C, s))
    np.testing.assert_array_equal(ridge.trsm_packed_rev_numpy(D, C, s),
                                  rridge.trsm_packed_rev_numpy(D, C, s))
    np.testing.assert_array_equal(ridge.ridge_cholesky_packed_numpy(A, B),
                                  rridge.ridge_cholesky_packed_numpy(A, B))
    x = np.random.default_rng(4).normal(size=s).astype(np.float32)
    np.testing.assert_array_equal(ridge.cholupdate_packed_numpy(C, x, s),
                                  rridge.cholupdate_packed_numpy(C, x, s))
    W = ridge.ridge_cholesky_packed_numpy(A, B)
    assert _rel(W, A @ np.linalg.inv(B.astype(np.float64))) <= REL


@pytest.mark.parametrize("s", [13, 31, 57])
def test_packed_pipeline_matches_reference(s):
    A, B = _system(s)
    tA, tB = torch.from_numpy(A), torch.from_numpy(B)
    jP = rridge.pack_lower(jnp.asarray(B))
    P = ridge.pack_lower(tB)
    C = ridge.cholesky_packed(P, s)
    assert C is P  # Algorithm 2 overwrites the packed array
    Cr = rridge.cholesky_packed_jax(jP, s)
    assert _rel(C, Cr) <= REL
    lapack = np.linalg.cholesky(B.astype(np.float64))
    assert _rel(ridge.unpack_lower(C, s), lapack) <= REL
    D = ridge.trsm_packed(tA.clone(), C, s)
    Dr = rridge.trsm_packed_jax(jnp.asarray(A), Cr, s)
    assert _rel(D, Dr) <= REL
    W = ridge.trsm_packed_rev(D.clone(), C, s)
    assert _rel(W, rridge.trsm_packed_rev_jax(Dr, Cr, s)) <= REL
    got = ridge.ridge_cholesky_packed(tA, tB)
    assert _rel(got, rridge.ridge_cholesky_packed(jnp.asarray(A),
                                                  jnp.asarray(B))) <= REL
    assert _rel(got, A @ np.linalg.inv(B.astype(np.float64))) <= REL
    np.testing.assert_array_equal(tA.numpy(), A)  # A is not overwritten


class _Storages(TorchDispatchMode):
    """Records the element count of every storage the ops return, by
    address (an in-place op's output and a view share their input's
    storage)."""

    def __init__(self):
        super().__init__()
        self.numels = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                n = st.nbytes() // t.element_size()
                self.numels[st.data_ptr()] = max(
                    n, self.numels.get(st.data_ptr(), 0))
        return out


def test_packed_solve_makes_no_dense_square():
    """The factor is the one packed array of s(s+1)/2 words; every other
    tensor the solve makes (Q, the column gathers and their indices) holds
    at most s^2/4 words: no (s, s) tensor anywhere on the path."""
    s = 31
    A, B = _system(s)
    tA, tB = torch.from_numpy(A), torch.from_numpy(B)
    with _Storages() as made:
        ridge.ridge_cholesky_packed(tA, tB)
    for t in (tA, tB):  # views of the inputs
        made.numels.pop(t.untyped_storage().data_ptr(), None)
    big = [n for n in made.numels.values() if n > s * s // 4]
    assert big == [ridge.packed_size(s)]


@pytest.mark.parametrize("method",
                         ["gaussian", "cholesky_packed", "cholesky_blocked"])
def test_ridge_solve_methods_match_reference(method):
    A, B = _system(40, ny=4)
    got = ridge.ridge_solve(torch.from_numpy(A), torch.from_numpy(B), method)
    want = rridge.ridge_solve(jnp.asarray(A), jnp.asarray(B), method)
    assert _rel(got, want) <= REL


def test_blocked_structural_reference_matches_reference():
    A, B = _system(40, ny=4)
    tA, tB = torch.from_numpy(A), torch.from_numpy(B)
    C = ridge.cholesky_blocked_jnp(tB, block=16)
    assert _rel(C, rridge.cholesky_blocked_jnp(jnp.asarray(B), 16)) <= REL
    got = ridge.ridge_cholesky_blocked_ref(tA, tB, block=16)
    want = rridge.ridge_cholesky_blocked_ref(jnp.asarray(A), jnp.asarray(B),
                                             16)
    assert _rel(got, want) <= REL


def test_fit_ridge_packed_matches_reference():
    from repro.core import dfr as rdfr
    from repro.core.types import DFRConfig as RConfig
    from repro.core.types import DFRParams as RParams
    from repro.data import load as rload
    from repro_torch import convert
    from repro_torch.core import dfr
    from repro_torch.core.types import DFRConfig
    from repro_torch.data import load

    nx, method = 5, "cholesky_packed"
    train, rtrain = load("JPVOW", size_cap=72)[0], rload("JPVOW",
                                                        size_cap=72)[0]
    rm = rdfr.DFRModel.create(RConfig(n_in=12, n_classes=9, n_nodes=nx))
    m = dfr.DFRModel(DFRConfig(n_in=12, n_classes=9, n_nodes=nx),
                     convert.mask_from_numpy(convert.mask_to_numpy(rm.mask)),
                     device="cpu")
    rng = np.random.default_rng(3)
    leaves = {"p": np.float32(0.05), "q": np.float32(0.2),
              "W": (0.05 * rng.normal(size=(9, nx * (nx + 1)))).astype(
                  np.float32),
              "b": (0.1 * rng.normal(size=9)).astype(np.float32)}
    params = convert.params_from_leaves(leaves)
    rparams = RParams(**{k: jnp.asarray(v) for k, v in leaves.items()})
    got = m.fit_ridge(train, params, method=method)
    want = rm.fit_ridge(rtrain, rparams, method=method)
    rlg = np.asarray(rm.logits(rtrain, want))
    lg = m.logits(train, got).numpy()
    assert np.abs(lg - rlg).max() <= LOGIT_REL * np.abs(rlg).max()

    def chosen(solve, A, B, W):
        dist = {beta: _rel(solve(A, B, beta)[:, :-1], W)
                for beta in m.cfg.betas}
        return min(dist, key=dist.get)

    A, B = m.ridge_statistics(train, params)
    beta = chosen(lambda A, B, beta: ridge.ridge_solve(
        A, ridge.regularize(B, beta), method).numpy(), A, B, got.W.numpy())
    rbeta = chosen(lambda A, B, beta: np.asarray(rridge.ridge_solve(
        jnp.asarray(A.numpy()), rridge.regularize(
            jnp.asarray(B.numpy()), jnp.float32(beta)), method)),
        A, B, np.asarray(want.W))
    assert beta == rbeta


@pytest.mark.parametrize("s,ny", [(931, 9), (931, 2), (241, 5), (421, 95)])
def test_counters_equal_reference(s, ny):
    assert ridge.memory_words_naive(s, ny) == rridge.memory_words_naive(s, ny)
    assert (ridge.memory_words_proposed(s, ny)
            == rridge.memory_words_proposed(s, ny))
    assert ridge.op_counts_naive(s, ny) == rridge.op_counts_naive(s, ny)
    assert ridge.op_counts_proposed(s, ny) == rridge.op_counts_proposed(s, ny)
    counted = ridge.count_ops_packed(s, ny)
    assert counted == rridge.count_ops_packed(s, ny)
    if s == 931:  # the paper's operating point (tests/test_ridge.py:66)
        closed = ridge.op_counts_proposed(s, ny)
        for op in ("add", "mul"):
            assert abs(counted[op] - closed[op]) / counted[op] < 0.15
        assert counted["sqrt"] == closed["sqrt"]
        assert counted["div"] == pytest.approx(closed["div"], rel=0.05)


def test_bench_ridge_tables_equal_reference():
    assert bench_ridge.table2_memory_words() == rbench.table2_memory_words()
    assert bench_ridge.table3_op_counts() == rbench.table3_op_counts()
    rows = bench_ridge.fig9_runtime_ratio(sizes=(2,), n_ys=(2,),
                                          device="cpu", reps=1)
    assert set(rows[0]) >= {"gaussian_us", "cholesky_us", "ratio",
                            "packed_us", "device"}
    (row,) = bench_ridge.table8_accuracy_parity(("JPVOW",), size_cap=20,
                                                n_nodes=3, device="cpu")
    assert row["gaussian"] == row["cholesky_blocked"] == row["cholesky_packed"]
