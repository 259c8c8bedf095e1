"""End-to-end DFR classifier: the paper's training recipe (Sec. 4.1), in PyTorch.

The counterpart of ``repro.core.dfr``.  Pipeline:
  1. SGD with truncated backprop for 25 epochs on (p, q, W, b); LR starts at
     1.0, x0.1 for the reservoir params at epochs {5,10,15,20} and for the
     output params at {10,15,20}.
  2. Re-fit the output layer with Ridge regression; sweep
     beta in {1e-6, 1e-4, 1e-2, 1} and keep the lowest training loss.

The features (reservoir states, then DPRR) come from
``kernels.ops.reservoir_states`` and ``kernels.ops.dprr_features`` and the
ridge solves from ``kernels.ops.ridge_solve``: on the card the kernels K6,
K7, K4a and K4b, on the CPU their plain versions and the library solve.
The model's tensors live on ``device``: the CUDA device unless the caller
asks for the CPU; batches given on another device are moved there.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import backprop, dprr, masking, ridge
from repro_torch.core.types import (DFRConfig, DFRParams, Tensor,
                                    TimeSeriesBatch, resolve_device)


def _one_hot(label: Tensor, n_classes: int, dtype) -> Tensor:
    return torch.nn.functional.one_hot(label.to(torch.int64),
                                       n_classes).to(dtype)


def _sgd_epoch(
    cfg: DFRConfig,
    mask: Tensor,
    params: DFRParams,
    u: Tensor,
    length: Tensor,
    onehot: Tensor,
    lr_res,
    lr_out,
    minibatch: int = 1,
) -> Tuple[DFRParams, Tensor]:
    """One SGD epoch over a padded dataset, minibatch at a time (the
    trailing samples that do not fill a minibatch are dropped)."""
    f = cfg.f()
    n = u.shape[0] // minibatch * minibatch
    inv = 1.0 / minibatch
    losses = []
    for lo in range(0, n, minibatch):
        hi = lo + minibatch
        j_seq = masking.apply_mask(mask, u[lo:hi])
        loss, g = backprop.grads_truncated(params, j_seq, onehot[lo:hi], f,
                                           lengths=length[lo:hi])
        params = backprop.apply_sgd(params, g, lr_res, lr_out,
                                    inv_batch=inv)
        losses.append(loss * inv)
    return params, torch.stack(losses).mean()


def _subset(batch: TimeSeriesBatch, idx) -> TimeSeriesBatch:
    return TimeSeriesBatch(u=batch.u[idx], length=batch.length[idx],
                           label=batch.label[idx])


@dataclasses.dataclass
class DFRModel:
    cfg: DFRConfig
    mask: Tensor  # (Nx, n_in)
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = resolve_device(self.device, "DFRModel")
        self.mask = torch.as_tensor(self.mask).to(self.device, self.cfg.dtype)

    @classmethod
    def create(cls, cfg: DFRConfig,
               generator: Optional[torch.Generator] = None,
               device=None) -> "DFRModel":
        """A model with a fresh mask drawn from ``generator`` (default: seeded
        by ``cfg.mask_seed``).  It cannot replay the reference's
        ``jax.random`` mask: pass that one to the constructor instead."""
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.mask_seed)
        return cls(cfg, masking.make_mask(generator, cfg.n_nodes, cfg.n_in,
                                          cfg.dtype), device)

    def init_params(self) -> DFRParams:
        return DFRParams.init(self.cfg, self.device)

    def _on_device(self, batch: TimeSeriesBatch) -> TimeSeriesBatch:
        return TimeSeriesBatch(u=batch.u.to(self.device, self.cfg.dtype),
                               length=batch.length.to(self.device),
                               label=batch.label.to(self.device))

    # -- forward ------------------------------------------------------------

    def mask_inputs(self, u: Tensor) -> Tensor:
        return masking.apply_mask(self.mask, u)

    @torch.no_grad()
    def features(self, batch: TimeSeriesBatch, params: DFRParams) -> Tensor:
        """DPRR feature vectors r for a batch: (B, Nr), through K6 and K7."""
        from repro_torch.kernels import ops as kops  # kernels import core

        batch = self._on_device(batch)
        j_seq = self.mask_inputs(batch.u)
        nx = self.cfg.n_nodes
        x = kops.reservoir_states(j_seq, batch.length, params.p, params.q,
                                  nx, f=self.cfg.f())
        return kops.dprr_features(x, batch.length, nx)

    def logits(self, batch: TimeSeriesBatch, params: DFRParams) -> Tensor:
        r = self.features(batch, params)
        return r @ params.W.T + params.b

    def predict(self, batch: TimeSeriesBatch, params: DFRParams) -> Tensor:
        return self.logits(batch, params).argmax(dim=-1)

    def accuracy(self, batch: TimeSeriesBatch, params: DFRParams) -> Tensor:
        label = batch.label.to(self.device)
        return (self.predict(batch, params) == label).to(torch.float32).mean()

    # -- SGD with truncated backprop -----------------------------------------

    def _lr_at(self, epoch: int) -> Tuple[float, float]:
        cfg = self.cfg
        lr_res = cfg.lr * (0.1 ** sum(1 for e in cfg.res_lr_drop_epochs
                                      if epoch >= e))
        lr_out = cfg.lr * (0.1 ** sum(1 for e in cfg.out_lr_drop_epochs
                                      if epoch >= e))
        return lr_res, lr_out

    def _epoch(self, params, u, length, onehot, lr_res, lr_out, minibatch=1):
        return _sgd_epoch(self.cfg, self.mask, params, u, length, onehot,
                          lr_res, lr_out, minibatch)

    def fit_sgd(
        self,
        train: TimeSeriesBatch,
        params: Optional[DFRParams] = None,
        minibatch: int = 1,
        shuffle_seed: int = 0,
        verbose: bool = False,
    ) -> Tuple[DFRParams, List[Tuple[float, DFRParams]]]:
        """Truncated-BP SGD for ``cfg.epochs`` epochs; each epoch shuffles
        with ``np.random.default_rng(shuffle_seed)``, so the order is the
        reference's.  Returns the last params and (loss, params) per
        epoch."""
        cfg = self.cfg
        if params is None:
            params = self.init_params()
        train = self._on_device(train)
        onehot = _one_hot(train.label, cfg.n_classes, cfg.dtype)
        rng = np.random.default_rng(shuffle_seed)
        history = []
        for epoch in range(cfg.epochs):
            lr_res, lr_out = self._lr_at(epoch)
            perm = torch.from_numpy(rng.permutation(train.batch)).to(
                self.device)
            params, loss = self._epoch(
                params, train.u[perm], train.length[perm], onehot[perm],
                lr_res, lr_out, minibatch=minibatch)
            history.append((float(loss), params))
            if verbose:
                print(f"epoch {epoch:3d}  loss {float(loss):.5f}  lr "
                      f"({lr_res:g},{lr_out:g})")
        return params, history

    # -- Ridge refit of the output layer --------------------------------------

    def ridge_statistics(self, train: TimeSeriesBatch, params: DFRParams,
                         chunk: int = 256) -> Tuple[Tensor, Tensor]:
        """The ridge statistics (A, B) of a batch, streamed in chunks: the
        same associative accumulation the edge system performs sample by
        sample (Eq. 38)."""
        cfg = self.cfg
        train = self._on_device(train)
        A = torch.zeros((cfg.n_classes, cfg.s), dtype=cfg.dtype,
                        device=self.device)
        B = torch.zeros((cfg.s, cfg.s), dtype=cfg.dtype, device=self.device)
        onehot = _one_hot(train.label, cfg.n_classes, cfg.dtype)
        for lo in range(0, train.batch, chunk):
            sub = _subset(train, slice(lo, lo + chunk))
            rt = dprr.r_tilde(self.features(sub, params))
            A, B = ridge.accumulate_ab(A, B, rt, onehot[lo:lo + chunk])
        return A, B

    def fit_ridge(
        self,
        train: TimeSeriesBatch,
        params: DFRParams,
        method: str = "cholesky_blocked",
        chunk: int = 256,
    ) -> DFRParams:
        """Re-train (W, b) with Ridge regression, sweeping beta (paper 4.1).
        A beta whose solve is not finite (below the fp32 noise floor of this
        B the factorization breaks down) is skipped, as in the reference."""
        cfg = self.cfg
        train = self._on_device(train)
        A, B = self.ridge_statistics(train, params, chunk)
        onehot = _one_hot(train.label, cfg.n_classes, cfg.dtype)
        best = None
        for beta in cfg.betas:
            Wt = ridge.ridge_solve(A, ridge.regularize(B, beta), method)
            if not bool(torch.isfinite(Wt).all()):
                continue
            cand = DFRParams(p=params.p, q=params.q, W=Wt[:, :-1],
                             b=Wt[:, -1])
            logits = self.logits(train, cand)
            loss = float(backprop.loss_from_logits(logits, onehot).mean())
            if np.isfinite(loss) and (best is None or loss < best[0]):
                best = (loss, cand)
        return best[1] if best is not None else params

    def fit(
        self,
        train: TimeSeriesBatch,
        minibatch: int = 1,
        ridge_method: str = "cholesky_blocked",
        select: str = "val",
        val_fraction: float = 0.25,
        verbose: bool = False,
        seed: int = 0,
    ) -> DFRParams:
        """Truncated-BP SGD then Ridge refit.

        select='final' is the paper's recipe verbatim (keep the last-epoch
        (p, q)).  select='val' (default) holds out ``val_fraction`` of the
        training set, picks the epoch checkpoint whose ridge-refit
        validation accuracy is best, then refits on the full training set.
        """
        if select == "final":
            params, _ = self.fit_sgd(train, minibatch=minibatch,
                                     verbose=verbose)
            return self.fit_ridge(train, params, method=ridge_method)
        if select != "val":
            raise ValueError(f"unknown select mode: {select}")
        train = self._on_device(train)
        rng = np.random.default_rng(seed)
        perm = rng.permutation(train.batch)
        n_val = max(1, int(train.batch * val_fraction))
        val_idx = torch.from_numpy(perm[:n_val]).to(self.device)
        tr_idx = torch.from_numpy(perm[n_val:]).to(self.device)
        tr, val = _subset(train, tr_idx), _subset(train, val_idx)
        _, history = self.fit_sgd(tr, minibatch=minibatch, verbose=verbose)
        # evaluate distinct (p, q) checkpoints on the held-out split
        best, seen = None, set()
        for _, ckpt in history:
            key = (round(float(ckpt.p), 6), round(float(ckpt.q), 6))
            if key in seen:
                continue
            seen.add(key)
            fitted = self.fit_ridge(tr, ckpt, method=ridge_method)
            acc = float(self.accuracy(val, fitted))
            if best is None or acc > best[0]:
                best = (acc, ckpt)
        return self.fit_ridge(train, best[1], method=ridge_method)
