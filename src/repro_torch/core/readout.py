"""DFR readout at scale: the paper's online trainer over a process group.

The counterpart of ``repro.core.readout``.  A frozen LM backbone emits a
feature stream h(k) (B, T, D); a fixed random mask projects it to the
Nx-node reservoir; the modular DFR and DPRR give r; the Ridge sufficient
statistics (A, B) are sums over samples (paper Eq. 38), so one
``all_reduce`` over the ranks of a ``torch.distributed`` process group makes
the trainer exact under data parallelism: every rank sees the global
(A, B) and solves the same small system.

With ``group=None`` the readout runs in one process.  On the card the
features come from K6 (every reservoir state) and K7 (their DPRR), the SGD
step's forward from K1, and the default solve from the blocked ridge solve
over K4a and K4b; on the CPU each from its plain version.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.core import backprop, dprr, masking, ridge
from repro_torch.core.online import all_reduce_sum
from repro_torch.core.types import (DFRConfig, DFRParams, RidgeState, Tensor,
                                    resolve_device)


@dataclasses.dataclass(frozen=True)
class ReadoutConfig:
    feature_dim: int          # D of the backbone features
    n_classes: int
    n_nodes: int = 30
    nonlinearity: str = "tanh"  # features are unbounded: a saturating f
    alpha: float = 1.0
    mask_seed: int = 0
    dtype: torch.dtype = torch.float32

    def dfr(self) -> DFRConfig:
        return DFRConfig(
            n_in=self.feature_dim,
            n_classes=self.n_classes,
            n_nodes=self.n_nodes,
            nonlinearity=self.nonlinearity,
            alpha=self.alpha,
            mask_seed=self.mask_seed,
            dtype=self.dtype,
        )


class DistributedDFRReadout:
    """Online DFR classification head over frozen backbone features.

    ``group`` is the process group whose ranks share the data (None: one
    process).  ``mask`` is the (Nx, D) input projection as used, scaled by
    1/sqrt(D); its default is drawn from a ``torch.Generator`` seeded by
    ``cfg.mask_seed`` and cannot replay the reference's ``jax.random`` mask,
    so pass the reference readout's ``mask`` (``convert.mask_from_numpy``)
    to reproduce it.  The readout's tensors live on ``device``: the CUDA
    device unless the caller asks for another; features given elsewhere
    are moved there.
    """

    def __init__(self, cfg: ReadoutConfig, group=None, mask=None,
                 device=None):
        self.cfg = cfg
        self.dfr_cfg = cfg.dfr()
        self.group = group
        self.device = resolve_device(device, "DistributedDFRReadout")
        if mask is None:
            # scale by 1/sqrt(D): keeps the masked projection O(1) for
            # unit-variance features regardless of backbone width
            mask = masking.make_mask(
                torch.Generator().manual_seed(cfg.mask_seed), cfg.n_nodes,
                cfg.feature_dim, cfg.dtype) / math.sqrt(cfg.feature_dim)
        self.mask = torch.as_tensor(mask).to(self.device, cfg.dtype)

    def init(self) -> Tuple[DFRParams, RidgeState]:
        return (
            DFRParams.init(self.dfr_cfg, self.device),
            RidgeState.zeros(self.dfr_cfg.s, self.cfg.n_classes,
                             self.cfg.dtype, self.device),
        )

    def _masked(self, h: Tensor, lengths: Optional[Tensor]):
        """(j_seq (B, T, Nx), lengths (B,)): the masked features and their
        lengths (the full T where none are given)."""
        h = torch.as_tensor(h).to(self.device, self.cfg.dtype)
        if lengths is None:
            lengths = torch.full(h.shape[:1], h.shape[1], dtype=torch.int32,
                                 device=self.device)
        return masking.apply_mask(self.mask, h), torch.as_tensor(
            lengths).to(self.device)

    def _onehot(self, label) -> Tensor:
        label = torch.as_tensor(label).to(self.device, torch.int64)
        return torch.nn.functional.one_hot(
            label, self.cfg.n_classes).to(self.cfg.dtype)

    @torch.no_grad()
    def features(self, params: DFRParams, h: Tensor,
                 lengths: Optional[Tensor] = None) -> Tensor:
        """h: (B, T, D) backbone features -> r: (B, Nr), through K6 and
        K7."""
        from repro_torch.kernels import ops as kops  # kernels import core

        j_seq, lengths = self._masked(h, lengths)
        nx = self.cfg.n_nodes
        x = kops.reservoir_states(j_seq, lengths, params.p, params.q, nx,
                                  f=self.dfr_cfg.f())
        return kops.dprr_features(x, lengths, nx)

    def accumulate(self, ridge_state: RidgeState, params: DFRParams,
                   h: Tensor, label, lengths: Optional[Tensor] = None
                   ) -> RidgeState:
        """Accumulate this rank's (A, B) contributions (no collective
        yet)."""
        r = self.features(params, h, lengths)
        A, B = ridge.accumulate_ab(ridge_state.A, ridge_state.B,
                                   dprr.r_tilde(r), self._onehot(label))
        # B moved without rotating a factor: drop any live one
        return RidgeState(A=A, B=B, count=ridge_state.count + r.shape[0],
                          Lt=ridge_state.Lt,
                          factor_beta=torch.zeros_like(
                              ridge_state.factor_beta))

    def solve(self, ridge_state: RidgeState, params: DFRParams, beta,
              method: str = "cholesky_blocked") -> DFRParams:
        """Global Ridge solve: one ``all_reduce`` of the statistics, then
        the factorization (the blocked solve over K4a and K4b on the card
        by default).  The sum is the only collective the readout needs:
        s^2 floats per solve, whatever the stream length."""
        A, B = all_reduce_sum([ridge_state.A, ridge_state.B], self.group)
        Wt = ridge.ridge_solve(A, ridge.regularize(B, beta), method)
        return DFRParams(p=params.p, q=params.q, W=Wt[:, :-1], b=Wt[:, -1])

    def sgd_step(self, params: DFRParams, h: Tensor, label, lr_res, lr_out,
                 lengths: Optional[Tensor] = None
                 ) -> Tuple[DFRParams, Tensor]:
        """Truncated-BP SGD step (the forward through K1) with the loss,
        the gradients and the batch size summed over the group: the mean
        gradient of the global batch."""
        j_seq, lengths = self._masked(h, lengths)
        loss, g = backprop.grads_truncated_fused(
            params, j_seq, self._onehot(label), self.dfr_cfg.f(),
            lengths=lengths)
        bsz = torch.tensor(float(j_seq.shape[0]), dtype=self.cfg.dtype,
                           device=self.device)
        loss, g_p, g_q, g_W, g_b, total = all_reduce_sum(
            [loss, g.p, g.q, g.W, g.b, bsz], self.group)
        inv = 1.0 / total
        new = backprop.apply_sgd(params, DFRParams(g_p, g_q, g_W, g_b),
                                 lr_res, lr_out, inv_batch=inv)
        return new, loss * inv

    def predict(self, params: DFRParams, h: Tensor,
                lengths: Optional[Tensor] = None) -> Tensor:
        r = self.features(params, h, lengths)
        return (r @ params.W.T + params.b).argmax(dim=-1)
