"""Ridge regression engine, in PyTorch.

The counterpart of ``repro.core.ridge``: the streaming sufficient statistics
(paper Eq. 21-22, 38); the offline solves of ``DFRModel`` and ``OnlineDFR``
(``ridge_solve``: Algorithm 1 by Gauss-Jordan; the paper's packed in-place
Cholesky, Algorithms 2-4, on one 1-D tensor; or Cholesky plus two
triangular solves through ``kernels.ops.ridge_solve``, the blocked tile
kernels K4a/K4b on the card); the verbatim numpy loops of Algorithms 1-4,
the oracles; the batched Cholesky solve W~ = A (B + beta I)^-1 of the
stream server's recompute mode; the rank-1 factor updates - the incremental
mode's live factor, seeded as sqrt(beta) I, rotated per sample
(``cholupdate_window_t``, the plain version of K3) and solved by two
triangular substitutions, and its packed, dense-lower and windowed forms;
and the Table 2/3 memory-word and operation counters.

The live factor is stored transposed, ``Lt = L^T`` (upper triangular), as
the reference stores it: column k of L is row k of Lt, contiguous.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import Tensor

# Relative radicand floor of the downdate guard (the reference's value): a
# rotation with d_k^2 + sign * x_k^2 <= DOWNDATE_GUARD_REL * d_k^2 is
# treated as indefinite and skipped.  Only reachable for sign = -1.
DOWNDATE_GUARD_REL = 1e-6


def accumulate_ab(A: Tensor, B: Tensor, r_tilde: Tensor, onehot: Tensor,
                  in_place: bool = False,
                  decay: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Rank-k update of (A, B) with a batch of samples.

    r_tilde: (..., batch, s), onehot: (..., batch, Ny); A (..., Ny, s) and
    B (..., s, s) carry the same leading dims.  ``decay`` (the leading
    dims) scales the carried A and B before the add: A * decay + dA.
    ``in_place`` updates A and B themselves and returns them, rounding
    exactly as into new tensors.
    """
    dA = onehot.transpose(-1, -2) @ r_tilde
    dB = r_tilde.transpose(-1, -2) @ r_tilde
    if decay is not None:
        d = decay[..., None, None]
        if in_place:
            return A.mul_(d).add_(dA), B.mul_(d).add_(dB)
        return A * d + dA, B * d + dB
    if in_place:
        return A.add_(dA), B.add_(dB)
    return A + dA, B + dB


def regularize(B: Tensor, beta) -> Tensor:
    """B + beta I, broadcasting over any leading axes."""
    eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    return B + beta * eye


def ridge_gaussian(A: Tensor, B: Tensor) -> Tensor:
    """Algorithm 1 with row operations vectorized: Gauss-Jordan inversion
    of B in the reference's pivot order, no pivot search (B is SPD, so the
    diagonal never vanishes), then A B^-1.  Batched over leading axes."""
    s = B.shape[-1]
    B = B.clone()
    Binv = torch.eye(s, dtype=B.dtype, device=B.device).expand_as(B).clone()
    for i in range(s):
        buf = 1.0 / B[..., i, i, None]
        brow = B[..., i, :] * buf
        binvrow = Binv[..., i, :] * buf
        B[..., i, :] = brow
        Binv[..., i, :] = binvrow
        col = B[..., :, i].clone()
        col[..., i] = 0.0  # eliminate everywhere but the pivot row
        B = B - col[..., :, None] * brow[..., None, :]
        Binv = Binv - col[..., :, None] * binvrow[..., None, :]
    return A @ Binv


# ---------------------------------------------------------------------------
# Packed 1-D triangular indexing (paper Eq. 41): P[i(i+1)/2 + j] = B[i][j],
# j <= i, rows stored contiguously.
# ---------------------------------------------------------------------------


def packed_size(s: int) -> int:
    return s * (s + 1) // 2


def packed_index(i, j):
    return i * (i + 1) // 2 + j


def _row_starts(s: int, device) -> Tensor:
    """Where each packed row begins: i(i+1)/2 for i < s (int64)."""
    ar = torch.arange(s, device=device)
    return ar * (ar + 1) // 2


def pack_lower(B: Tensor) -> Tensor:
    """Dense (s, s) -> packed 1-D lower triangle P[s(s+1)/2], copied row by
    row, so nothing larger than P is made."""
    s = B.shape[-1]
    P = B.new_empty(packed_size(s))
    for i in range(s):
        P[packed_index(i, 0):packed_index(i, i + 1)] = B[i, :i + 1]
    return P


def unpack_lower(P: Tensor, s: int) -> Tensor:
    """Packed 1-D -> dense lower-triangular (s, s) (upper = 0)."""
    i, j = torch.tril_indices(s, s, device=P.device)
    out = P.new_zeros((s, s))
    out[i, j] = P
    return out


# ---------------------------------------------------------------------------
# Paper Algorithms 1-4 verbatim (numpy, loops and all): the oracles.
# ---------------------------------------------------------------------------


def ridge_gaussian_numpy(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Verbatim Algorithm 1 (Gauss-Jordan with an explicit B^-1).  Returns
    W~ (Ny, s)."""
    A = np.asarray(A, np.float64 if A.dtype == np.float64
                   else np.float32).copy()
    B = np.array(B, copy=True)
    n_y, s = A.shape
    Binv = np.zeros_like(B)
    for i in range(s):  # lines 1-9: identity init
        Binv[i, i] = 1.0
    for i in range(s):  # lines 10-25: Gauss-Jordan
        buf = 1.0 / B[i, i]
        for j in range(s):
            B[i, j] *= buf
            Binv[i, j] *= buf
        for j in range(s):
            if i != j:
                buf = B[j, i]
                for k in range(s):
                    B[j, k] -= B[i, k] * buf
                    Binv[j, k] -= Binv[i, k] * buf
    W = np.zeros((n_y, s), A.dtype)
    for i in range(n_y):  # lines 26-33
        for j in range(s):
            acc = 0.0
            for k in range(s):
                acc += A[i, k] * Binv[k, j]
            W[i, j] = acc
    return W


def cholesky_packed_numpy(P: np.ndarray, s: int) -> np.ndarray:
    """Algorithm 2: in-place Cholesky in the packed 1-D array."""
    P = np.array(P, copy=True)
    for i in range(s):
        for j in range(i):  # lines 2-4: diagonal update
            P[i * (i + 1) // 2 + i] -= P[i * (i + 1) // 2 + j] ** 2
        P[i * (i + 1) // 2 + i] = np.sqrt(P[i * (i + 1) // 2 + i])
        buf = 1.0 / P[i * (i + 1) // 2 + i]
        for j in range(i + 1, s):  # lines 7-12: column below the diagonal
            for k in range(i):
                P[j * (j + 1) // 2 + i] -= (P[i * (i + 1) // 2 + k]
                                            * P[j * (j + 1) // 2 + k])
            P[j * (j + 1) // 2 + i] *= buf
    return P


def trsm_packed_numpy(Q: np.ndarray, P: np.ndarray, s: int) -> np.ndarray:
    """Algorithm 3: Q (storing A) -> D = A (C^T)^-1, in place."""
    Q = np.array(Q, copy=True)
    n_y = Q.shape[0]
    for i in range(n_y):
        for j in range(s):
            for k in range(j):
                Q[i, j] -= Q[i, k] * P[j * (j + 1) // 2 + k]
            Q[i, j] /= P[j * (j + 1) // 2 + j]
    return Q


def trsm_packed_rev_numpy(Q: np.ndarray, P: np.ndarray, s: int) -> np.ndarray:
    """Algorithm 4: Q (storing D) -> W~ = D C^-1, in place."""
    Q = np.array(Q, copy=True)
    n_y = Q.shape[0]
    for i in range(n_y):
        for j in range(s - 1, -1, -1):
            for k in range(s - 1, j, -1):
                Q[i, j] -= Q[i, k] * P[k * (k + 1) // 2 + j]
            Q[i, j] /= P[j * (j + 1) // 2 + j]
    return Q


def ridge_cholesky_packed_numpy(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """The paper's full proposed pipeline: pack -> Alg 2 -> Alg 3 -> Alg 4."""
    s = B.shape[0]
    i, j = np.tril_indices(s)
    P = np.ascontiguousarray(np.asarray(B)[(i, j)])
    P = cholesky_packed_numpy(P, s)
    Q = trsm_packed_numpy(np.asarray(A), P, s)
    return trsm_packed_rev_numpy(Q, P, s)


# ---------------------------------------------------------------------------
# The packed in-place pipeline on tensors.  The factor is one 1-D tensor of
# s(s+1)/2 words that Algorithm 2 overwrites; Q, an (Ny, s) tensor, holds A,
# then D, then W~.  Packed row j is the contiguous slice at j(j+1)/2, so the
# dot products of Alg 2 line 9 and Alg 3 line 4 read views; Alg 4's column
# C[k > j, j] is strided and is gathered.  No dense (s, s) tensor is made.
# ---------------------------------------------------------------------------


def cholesky_packed(P: Tensor, s: int) -> Tensor:
    """Algorithm 2 in place: P (s(s+1)/2,) holding B's packed lower triangle
    is overwritten by its Cholesky factor C (B = C C^T) and returned.

    Column i at once: the rows j > i of one column are independent (each
    reads packed rows i and j up to column i - 1 and writes only (j, i)),
    so they are updated together from one gather of their first i words.
    That gather and its int64 index are the only transients: (s - 1 - i) i
    <= (s - 1)^2 / 4 words each, under a quarter of the dense square.  NaN
    from the first pivot that is not positive, as the reference gives it."""
    rs = _row_starts(s, P.device)
    ar = torch.arange(s, device=P.device)
    for i in range(s):
        r0 = packed_index(i, 0)
        rowi = P[r0:r0 + i]                       # C[i, :i]
        d = P[r0 + i:r0 + i + 1]
        d.sub_(rowi @ rowi).sqrt_()               # lines 2-6
        if i + 1 == s:
            break
        starts = rs[i + 1:]                       # lines 7-12
        dst = starts + i
        val = P[dst]
        if i:
            val = val - P[starts[:, None] + ar[None, :i]] @ rowi
        P[dst] = val * (1.0 / d)
    return P


def trsm_packed(Q: Tensor, P: Tensor, s: int) -> Tensor:
    """Algorithm 3 in place: Q (Ny, s) holding A becomes D = A (C^T)^-1,
    columns left to right, all Ny rows at once."""
    for j in range(s):
        r0 = packed_index(j, 0)
        q = Q[:, j]
        if j:
            q.sub_(Q[:, :j] @ P[r0:r0 + j])
        q.div_(P[r0 + j])
    return Q


def trsm_packed_rev(Q: Tensor, P: Tensor, s: int) -> Tensor:
    """Algorithm 4 in place: Q (Ny, s) holding D becomes W~ = D C^-1,
    columns right to left; the strided column C[k > j, j] is a gather of P
    at the row starts plus j."""
    rs = _row_starts(s, P.device)
    for j in range(s - 1, -1, -1):
        q = Q[:, j]
        if j < s - 1:
            q.sub_(Q[:, j + 1:] @ P[rs[j + 1:] + j])
        q.div_(P[packed_index(j, j)])
    return Q


def ridge_cholesky_packed(A: Tensor, B: Tensor) -> Tensor:
    """The paper's proposed ridge solve W~ = A B^-1: pack B, then Algorithms
    2, 3 and 4 in place on the packed factor and on one (Ny, s) buffer -
    the s(s+2Ny)/2 + s/2 words of Table 2 plus one column's gather."""
    s = B.shape[-1]
    P = cholesky_packed(pack_lower(B), s)
    Q = A.clone()
    return trsm_packed_rev(trsm_packed(Q, P, s), P, s)


def ridge_cholesky_blocked(A: Tensor, B: Tensor, block: int = 128) -> Tensor:
    """The production ridge solve W~ = A B^-1: Cholesky plus two triangular
    solves, no inverse.  Through ``kernels.ops.ridge_solve``: on the card
    the blocked solve over the tile kernels K4a and K4b with tiles of
    ``block`` (128, the reference's default here, keeps each tile in one
    block's shared memory); on the CPU the unblocked library solve, as the
    reference computes it off the TPU.  NaN where B is not positive
    definite."""
    from repro_torch.kernels import ops as kops  # kernels import core

    return kops.ridge_solve(A, B, block=block)


def cholesky_blocked_jnp(B: Tensor, block: int = 128) -> Tensor:
    """The blocked right-looking Cholesky over the plain tiles (the
    structural reference of K4a/K4b's composition): the port's blocked
    factorization, ``kernels.ridge_solve.cholesky_blocked``, on the tiles'
    plain versions whatever the device."""
    from repro_torch.kernels import ridge_solve  # kernels import core

    return ridge_solve.cholesky_blocked(B, block=block, backend="torch")


def ridge_cholesky_blocked_ref(A: Tensor, B: Tensor,
                               block: int = 128) -> Tensor:
    """W~ = A B^-1 from ``cholesky_blocked_jnp``'s factor and two triangular
    solves."""
    return ridge_solve_from_factor(A, cholesky_blocked_jnp(B, block))


def ridge_solve(A: Tensor, B: Tensor,
                method: str = "cholesky_blocked") -> Tensor:
    """Dispatch: 'gaussian' | 'cholesky_packed' | 'cholesky_blocked'."""
    if method == "gaussian":
        return ridge_gaussian(A, B)
    if method == "cholesky_packed":
        return ridge_cholesky_packed(A, B)
    if method == "cholesky_blocked":
        return ridge_cholesky_blocked(A, B)
    raise ValueError(f"unknown ridge method: {method}")


def cholesky_or_nan(B: Tensor) -> Tensor:
    """Lower Cholesky factor of (..., s, s), NaN where a system is not
    positive definite, as ``jnp.linalg.cholesky`` gives it in the reference
    (``torch.linalg.cholesky`` would raise instead, and reading its status
    would stall the device queue).  A bf16 B raises: there is no bf16
    Cholesky, and the reference's XLA Cholesky refuses bf16 too."""
    if B.dtype == torch.bfloat16:
        raise NotImplementedError(
            "no bfloat16 Cholesky: factor in float32, or keep a live factor "
            "(refresh_mode='incremental')")
    C, info = torch.linalg.cholesky_ex(B)
    return torch.where((info == 0)[..., None, None], C,
                       torch.full((), float("nan"), dtype=C.dtype,
                                  device=C.device))


def ridge_cholesky_batched(A: Tensor, B: Tensor) -> Tensor:
    """Batched ridge solve:  A (K, Ny, s), B (K, s, s)  ->  W~ (K, Ny, s).

    Cholesky plus two triangular solves per member, no inverse; NaN for a
    system that is not positive definite (``cholesky_or_nan``).  The solves
    are the incremental refresh's (``ridge_solve_from_factor_t_batched``),
    not ``torch.cholesky_solve``: on a CUDA batch that one runs MAGMA, whose
    queue allocates device memory, which a CUDA graph capture forbids (the
    stream server captures this refresh).
    """
    return ridge_solve_from_factor_t_batched(A, cholesky_or_nan(B).mT)


def ridge_solve_batched(A: Tensor, B: Tensor,
                        method: str = "cholesky_blocked") -> Tensor:
    """Population-axis dispatch mirroring ``ridge_solve``: A (K, Ny, s),
    B (K, s, s) -> (K, Ny, s)."""
    if method == "cholesky_blocked":
        return ridge_cholesky_batched(A, B)
    if method == "gaussian":
        return ridge_gaussian(A, B)
    raise ValueError(f"unknown batched ridge method: {method}")


def seed_factor(s: int, beta, dtype=torch.float32, device=None) -> Tensor:
    """Factor of the empty system: chol(0 + beta I) = sqrt(beta) I."""
    root = torch.sqrt(torch.tensor(beta, dtype=dtype, device=device))
    return root * torch.eye(s, dtype=dtype, device=device)


def guarded_rotation(dk: Tensor, xk: Tensor, sign: float):
    """One rotation's (r, c, s, bad) with the downdate guard, in the
    reference's operation order (``repro.core.ridge._guarded_rotation``).

    A bad rotation (radicand <= DOWNDATE_GUARD_REL * d_k^2) degrades to the
    identity: r = d_k, c = 1, s = 0.  A zero x_k gives r = d_k, c = 1, s = 0
    as well, so zero rows are exact no-ops."""
    dd = dk * dk
    rad = dd + sign * xk * xk
    bad = rad <= DOWNDATE_GUARD_REL * dd
    r = torch.where(bad, dk, torch.sqrt(torch.where(bad, torch.ones_like(rad),
                                                    rad)))
    c = r / dk
    sk = torch.where(bad, torch.zeros_like(xk), xk / dk)
    return r, c, sk, bad


def cholupdate_window_t(Lt: Tensor, X: Tensor, sign: float = 1.0,
                        scale: Optional[Tensor] = None,
                        flags: Optional[Tensor] = None) -> Tensor:
    """Rotate the rows of X (..., W, s) one by one, in stream order, into
    the transposed factors Lt (..., s, s): Lt'^T Lt' = Lt^T Lt + sign x x^T
    per row (sign -1: the guarded hyperbolic downdate).

    ``scale`` (..., W) multiplies the factor (its upper triangle, the only
    part read) by ``scale[..., t]`` before row t: the forgetting factor's
    fold, Lt'^T Lt' = scale^2 Lt^T Lt + x x^T, the reference's
    ``cholupdate_window_t_decay``.  A scale of 1.0 changes no bit, so
    ``scale=None`` and all-ones give the same factor.
    ``flags`` (the leading dims, int32) receives whether the downdate guard
    skipped any rotation of that factor (``_cholupdate_dense_t_flagged``'s
    flag): its factor is then finite but no longer factors the statistics.

    The plain version of K3 and the reference's sample-by-sample sweep
    (``repro.core.ridge.cholupdate_window_t``), batched over the leading
    axes.  Rotation k touches only row k of Lt (its part right of the
    diagonal) and the tail of x.  Returns a new tensor in Lt's dtype.

    A bf16 factor is folded in fp32, as K3 folds it: read into fp32,
    rotated, and rounded back once at the end.  (The reference folds a
    bf16 factor in bf16 arithmetic.)"""
    if sign not in (1.0, -1.0):
        raise ValueError(f"sign must be +1 or -1, got {sign!r}")
    U = Lt.to(torch.float32 if Lt.dtype == torch.bfloat16 else Lt.dtype,
              copy=True)
    s = U.shape[-1]
    bad_any = torch.zeros(U.shape[:-2], dtype=torch.bool, device=U.device)
    upper = torch.ones(s, s, dtype=torch.bool, device=U.device).triu()
    for t in range(X.shape[-2]):
        if scale is not None:
            # the upper triangle, as K3 reads and writes it
            U = torch.where(upper, U * scale[..., t, None, None].to(U.dtype),
                            U)
        x = X[..., t, :].to(U.dtype).clone()
        for k in range(s):
            r, c, sk, bad = guarded_rotation(U[..., k, k], x[..., k], sign)
            bad_any |= bad
            tail = ((U[..., k, k + 1:] + (sign * sk)[..., None] * x[..., k + 1:])
                    / c[..., None])
            x[..., k + 1:] = (c[..., None] * x[..., k + 1:]
                              - sk[..., None] * tail)
            U[..., k, k + 1:] = tail
            U[..., k, k] = r
    if flags is not None:
        flags.copy_(bad_any)
    return U.to(Lt.dtype)


def ridge_solve_from_factor_t(A: Tensor, Lt: Tensor) -> Tensor:
    """Refresh from one live transposed factor: W~ = A (Lt^T Lt)^-1 for
    A (Ny, s), Lt (s, s)."""
    return ridge_solve_from_factor_t_batched(A[None], Lt[None])[0]


def ridge_solve_from_factor_t_batched(A: Tensor, Lt: Tensor) -> Tensor:
    """Refresh from live transposed factors: W~ = A (Lt^T Lt)^-1 for
    A (K, Ny, s), Lt (K, s, s) - two triangular substitutions, no
    factorization.  (The reference runs blocked substitutions in XLA; here
    ``solve_triangular`` takes both.)  A bf16 system is solved in fp32 and
    returned in A's dtype: ``solve_triangular`` has no bf16 kernel, on the
    CPU or the card."""
    dt = A.dtype
    if dt == torch.bfloat16:
        A, Lt = A.to(torch.float32), Lt.to(torch.float32)
    Y = torch.linalg.solve_triangular(Lt.mT, A.mT, upper=False)  # Lt^T Y = A^T
    return torch.linalg.solve_triangular(Lt, Y, upper=True).mT.to(dt)


def ridge_solve_from_factor(A: Tensor, L: Tensor) -> Tensor:
    """Refresh from a live lower factor: W~ = A (L L^T)^-1 for A (Ny, s),
    L (s, s) - Algorithms 3/4 as two triangular substitutions."""
    return ridge_solve_from_factor_t(A, L.mT)


def ridge_solve_from_factor_batched(A: Tensor, L: Tensor) -> Tensor:
    """Batched refresh from live lower factors: A (K, Ny, s), L (K, s, s)."""
    return ridge_solve_from_factor_t_batched(A, L.mT)


def pad_factor_identity(F: Tensor, pad: int) -> Tensor:
    """Zero-pad a (..., s, s) triangular factor by ``pad`` rows and columns
    with ones on the padded diagonal: padded rotations and substitutions
    become exact no-ops instead of zero-pivot divisions."""
    if not pad:
        return F
    out = torch.nn.functional.pad(F, (0, pad, 0, pad))
    idx = torch.arange(F.shape[-1], F.shape[-1] + pad, device=F.device)
    out[..., idx, idx] = 1.0
    return out


# ---------------------------------------------------------------------------
# The rank-1 factor update in its other forms.  Each streamed sample adds
# x x^T to B, so the factor is rotated forward in O(s^2) instead of being
# factored again (sign -1: the guarded hyperbolic downdate).  The packed
# forms sweep the same 1-D array Algorithm 2 factors into; the dense lower
# (L) and transposed (Lt = L^T) forms are all ``cholupdate_window_t``, the
# plain version of K3: column k of L is row k of L^T, so a lower factor is
# swept as its transpose.
# ---------------------------------------------------------------------------


def cholupdate_packed_numpy(P: np.ndarray, x: np.ndarray, s: int,
                            sign: float = 1.0) -> np.ndarray:
    """Rank-1 update of the packed factor, loops and all (the oracle):
    returns the packed factor of C C^T + sign * x x^T.  One rotation per
    column k, touching only packed column k and the tail of x.

    Raises ``numpy.linalg.LinAlgError`` on an indefinite downdate (a
    rotation radicand <= 0): the oracle never returns a NaN factor."""
    P = np.array(P, copy=True)
    x = np.array(x, copy=True).astype(P.dtype)
    for k in range(s):
        dk = P[k * (k + 1) // 2 + k]
        rad = dk * dk + sign * x[k] * x[k]
        if rad <= 0.0:
            raise np.linalg.LinAlgError(
                f"indefinite downdate: rotation {k} radicand {rad!r} <= 0 "
                "(x^T B^-1 x >= 1; the downdated matrix is not SPD)")
        r = np.sqrt(rad)
        c = r / dk
        sk = x[k] / dk
        P[k * (k + 1) // 2 + k] = r
        for j in range(k + 1, s):
            pj = (P[j * (j + 1) // 2 + k] + sign * sk * x[j]) / c
            P[j * (j + 1) // 2 + k] = pj
            x[j] = c * x[j] - sk * pj
    return P


def cholupdate_packed(P: Tensor, x: Tensor, s: int,
                      sign: float = 1.0) -> Tensor:
    """``cholupdate_packed_numpy`` on tensors, in place: P (s(s+1)/2,) is
    overwritten by the packed factor of C C^T + sign x x^T and returned.
    Column k of C (rows >= k) is a gather of P at the row starts plus k.
    Indefinite downdate rotations are skipped by ``guarded_rotation``, as
    the reference's jitted form clamps them."""
    rs = _row_starts(s, P.device)
    x = x.to(P.dtype).clone()
    for k in range(s):
        idx = rs[k:] + k                      # C[k:, k]
        col = P[idx]
        r, c, sk, _ = guarded_rotation(col[0], x[k], sign)
        new = (col[1:] + sign * sk * x[k + 1:]) / c
        x[k + 1:] = c * x[k + 1:] - sk * new
        P[idx[1:]] = new
        P[idx[:1]] = r
    return P


def cholupdate_dense_t(U: Tensor, x: Tensor, sign: float = 1.0) -> Tensor:
    """Rank-1 update/downdate of a transposed factor U = L^T (..., s, s),
    x (..., s).  Indefinite downdate rotations are skipped."""
    return cholupdate_window_t(U, x[..., None, :], sign)


def cholupdate_dense_t_guarded(U: Tensor, x: Tensor,
                               sign: float = 1.0) -> Tuple[Tensor, Tensor]:
    """``cholupdate_dense_t`` and ``ok``: False where the guard skipped a
    rotation (the factor is then finite but no longer factors
    B + sign x x^T)."""
    flags = torch.zeros(U.shape[:-2], dtype=torch.int32, device=U.device)
    U = cholupdate_window_t(U, x[..., None, :], sign, flags=flags)
    return U, flags == 0


def cholupdate_window_t_decay(U: Tensor, X: Tensor, scale: Tensor,
                              sign: float = 1.0) -> Tensor:
    """``cholupdate_window_t`` with the factor scaled by ``scale[t]`` before
    row t (the forgetting factor's fold)."""
    return cholupdate_window_t(U, X, sign, scale=scale)


def cholupdate_dense(L: Tensor, x: Tensor, sign: float = 1.0) -> Tensor:
    """Rank-1 update/downdate of a dense lower factor: L (..., s, s),
    x (..., s); batched over leading axes."""
    return cholupdate_dense_t(L.mT, x, sign).mT


def cholupdate_dense_guarded(L: Tensor, x: Tensor,
                             sign: float = 1.0) -> Tuple[Tensor, Tensor]:
    """``cholupdate_dense`` and the guard's ``ok``."""
    U, ok = cholupdate_dense_t_guarded(L.mT, x, sign)
    return U.mT, ok


def cholupdate_dense_batched(L: Tensor, x: Tensor,
                             sign: float = 1.0) -> Tensor:
    """Member/slot-axis rank-1 update: L (K, s, s), x (K, s)."""
    return cholupdate_dense(L, x, sign)


def cholupdate_window(L: Tensor, X: Tensor, sign: float = 1.0) -> Tensor:
    """Fold a window X (..., W, s) into lower factors, rows in stream
    order; a zero row is an exact no-op."""
    return cholupdate_window_t(L.mT, X, sign).mT


# ---------------------------------------------------------------------------
# Table 2 / Table 3 formulas (for the benchmark harness).
# ---------------------------------------------------------------------------


def memory_words_naive(s: int, n_y: int) -> int:
    """Table 2 'naive': B + B^-1 + A + W~ + buf = 2s(s+Ny) + 1 words."""
    return 2 * s * (s + n_y) + 1


def memory_words_proposed(s: int, n_y: int) -> int:
    """Table 2 'proposed': P + Q = s(s+2Ny)/2 + s/2 words."""
    return (s * (s + 2 * n_y) + s) // 2


def op_counts_naive(s: int, n_y: int) -> dict:
    """Table 3 'naive' (Gauss-Jordan) arithmetic op counts.

    add: s^2(2s + Ny) - 2s^2;  mul: s^2(2s + Ny).
    """
    return {
        "add": float(s * s * (2 * s + n_y) - 2 * s * s),
        "mul": float(s * s * (2 * s + n_y)),
        "div": float(s),
        "sqrt": 0.0,
    }


def op_counts_proposed(s: int, n_y: int) -> dict:
    """Table 3 'proposed' (1-D Cholesky) arithmetic op counts."""
    return {
        "add": s * s * (s + n_y) / 6 - s / 6 - s * n_y,
        "mul": s * s * (s + n_y) / 6 + s * s / 2 - 2 * s / 3 - s * n_y,
        "div": float(s + 2 * s * n_y),
        "sqrt": float(s),
    }


def count_ops_packed(s: int, n_y: int) -> dict:
    """Exact op count of Algorithms 2+3+4 by loop enumeration (cross-checks
    the Table 3 closed forms)."""
    add = mul = div = sqrt = 0
    for i in range(s):
        add += i            # diagonal update subs
        mul += i            # squares
        sqrt += 1
        div += 1            # buf = 1/diag  (the paper counts the reciprocal)
        for j in range(i + 1, s):
            add += i
            mul += i + 1    # dots + final *buf
    # Alg 3: for each of Ny rows: sum_j (j subs + j muls + 1 div)
    add += n_y * (s * (s - 1) // 2)
    mul += n_y * (s * (s - 1) // 2)
    div += n_y * s
    # Alg 4: mirror of Alg 3
    add += n_y * (s * (s - 1) // 2)
    mul += n_y * (s * (s - 1) // 2)
    div += n_y * s
    return {"add": add, "mul": mul, "div": div, "sqrt": sqrt}
