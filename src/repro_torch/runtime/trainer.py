"""Fault-tolerant training loop and population-search runtime wrapper,
in PyTorch: the port of ``repro.runtime.trainer``.

``Trainer`` responsibilities beyond calling train_step:
  * checkpoint/restart: periodic saves (keep-last-k) and resume from the
    newest checkpoint that reads back,
  * failure handling: a step that raises (device loss, preemption signal,
    injected fault) restores the newest checkpoint and replays from its
    step; batches are a pure function of the step index, so the replay is
    deterministic,
  * straggler watchdog: each step's duration feeds
    ``runtime.straggler``; an evict verdict saves and raises
    ``ElasticRestart`` so the caller can rebuild its devices.

Checkpoints hold ``(params, opt_state)`` in the reference's layout
(``convert.to_reference_layout``: the model's layer lists stacked, an
``AdamState``'s ``mu``/``nu`` trees likewise), through the port's
``CheckpointManager``, so a checkpoint that either package's ``Trainer``
writes restores in the other's.  ``TrainerConfig.compress_grads`` raises
``NotImplementedError`` when set: the reference's ``Trainer`` never reads
the field and its train step never compresses, so there is nothing to
port.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import population
from repro_torch.data.timeseries import RegressionBatch
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.runtime.straggler import StragglerWatchdog


def _whole(t):
    """A sharded leaf's whole value (a collective over its mesh)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


class ElasticRestart(Exception):
    """Raised when the devices must be rebuilt (host eviction, resize)."""


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 100
    keep: int = 3
    max_retries_per_step: int = 2
    straggler_threshold: float = 2.5
    compress_grads: bool = False


class Trainer:
    """Runs ``train_step(params, opt_state, step, batch) -> (params,
    opt_state, metrics)`` over the steps, with checkpoints, retries and the
    straggler watchdog.  Waits on ``metrics['loss']`` once a step (one host
    sync, as the reference blocks on it) and logs ``{'step', 'loss',
    'sec'}`` to ``metrics_log``.  ``fault_hook(step)`` runs before each
    attempt and may raise (fault injection in tests)."""

    def __init__(
        self,
        cfg: TrainerConfig,
        train_step: Callable,
        batch_fn: Callable[[int], Any],
        fault_hook: Optional[Callable[[int], None]] = None,
    ):
        if cfg.compress_grads:
            raise NotImplementedError(
                "TrainerConfig(compress_grads=True): the reference's Trainer "
                "never reads compress_grads and its train step compresses "
                "nothing, so the port has no compression to run")
        self.cfg = cfg
        self.train_step = train_step
        self.batch_fn = batch_fn
        self.fault_hook = fault_hook
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
        self.watchdog = StragglerWatchdog(threshold=cfg.straggler_threshold)
        self.metrics_log: list = []

    # -- checkpoints ---------------------------------------------------------

    def _save(self, params, opt_state, step: int, metadata=None) -> None:
        """Save (params, opt_state) in the reference's layout.  A sharded
        state (DTensors over a process group) is gathered whole on every
        rank and written by rank 0 alone."""
        tree = tree_map(_whole, convert.to_reference_layout(
            (params, opt_state)))
        if not dist.is_initialized() or dist.get_rank() == 0:
            self.ckpt.save(tree, step, metadata)

    def _restore(self, params, opt_state):
        """(params, opt_state, step) from the newest checkpoint that reads
        back, on the parameters' device (each sharded leaf placed as it
        was); None if there is none.  The checkpoint is matched against the
        state's shapes on the meta device, so no copy of the weights is
        made for it."""
        template = (params, opt_state)
        shapes = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                device="meta"), template)
        leaf = tree_leaves(params)[0]
        dev = leaf.device_mesh.device_type if isinstance(leaf, DTensor) \
            else leaf.device
        res = self.ckpt.restore_latest(convert.to_reference_layout(shapes),
                                       dev)
        if res is None:
            return None
        tree, step, _ = res
        params, opt_state = convert.from_reference_layout(template, tree)
        return params, opt_state, step

    def restore(self, params, opt_state) -> Tuple[Any, Any, int]:
        """Resume: the newest checkpoint's (params, opt_state, step), or the
        arguments and step 0 when there is none."""
        res = self._restore(params, opt_state)
        return (params, opt_state, 0) if res is None else res

    # -- main loop -----------------------------------------------------------

    def run(self, params, opt_state, num_steps: int, start_step: int = 0,
            host: str = "host0"):
        step = start_step
        while step < num_steps:
            batch = self.batch_fn(step)
            retries = 0
            while True:
                t0 = time.perf_counter()
                try:
                    if self.fault_hook is not None:
                        self.fault_hook(step)  # may raise (injected fault)
                    params, opt_state, metrics = self.train_step(
                        params, opt_state, step, batch)
                    loss = float(metrics["loss"])
                    break
                except ElasticRestart:
                    raise
                except Exception:  # noqa: BLE001 - recover from step failure
                    retries += 1
                    if retries > self.cfg.max_retries_per_step:
                        raise
                    restored = self._restore(params, opt_state)
                    if restored is not None:
                        params, opt_state, step = restored
                        batch = self.batch_fn(step)
            dur = time.perf_counter() - t0
            verdict = self.watchdog.observe(host, dur)
            if verdict == "evict":
                # persist the state, then ask the caller to re-mesh
                self._save(params, opt_state, step, {"evicted": host})
                raise ElasticRestart(host)
            self.metrics_log.append({"step": step, "loss": loss, "sec": dur})
            step += 1
            if step % self.cfg.ckpt_every == 0 or step == num_steps:
                self._save(params, opt_state, step)
        return params, opt_state, step


# ---------------------------------------------------------------------------
# Population hyperparameter search runtime
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PopulationTrainerConfig:
    """Knobs of the population search (``core.population``)."""

    divs: int = 4                   # grid seeds per axis -> K = divs^2
    rounds: int = 1                 # cull -> refine -> re-evaluate rounds
    steps_per_round: int = 1        # truncated-BP epochs per round
    minibatch: int = 4
    survive_frac: float = 0.5
    jitter: float = 0.15
    ckpt_dir: Optional[str] = None  # save the winning member when set


class PopulationTrainer:
    """Runs ``core.population.train_population`` with the config's knobs,
    keeps the per-round history as ``metrics_log``, and dispatches on the
    batch type: ``data.RegressionBatch`` pairs run the NRMSE regression
    path, ``TimeSeriesBatch`` pairs the classification path.  ``device``
    (and any other ``train_population`` keyword) passes through ``fit``'s
    overrides.  With ``ckpt_dir`` set, the winning member's parameters are
    saved there (``checkpoint.CheckpointManager``, keep 1, step = rounds)
    with its scores and hyperparameters as metadata, as the reference
    saves them."""

    def __init__(self, cfg: PopulationTrainerConfig):
        self.cfg = cfg
        self.metrics_log: list = []

    def fit(self, dfr_cfg, train, evalb, seed: int = 0, **overrides
            ) -> population.PopulationResult:
        runner = (population.train_population_regression
                  if isinstance(train, RegressionBatch)
                  else population.train_population_classification)
        kwargs = dict(
            divs=self.cfg.divs,
            rounds=self.cfg.rounds,
            steps_per_round=self.cfg.steps_per_round,
            minibatch=self.cfg.minibatch,
            survive_frac=self.cfg.survive_frac,
            jitter=self.cfg.jitter,
            seed=seed,
        )
        kwargs.update(overrides)
        result = runner(dfr_cfg, train, evalb, **kwargs)
        self.metrics_log = list(result.history)
        if self.cfg.ckpt_dir is not None:
            ckpt = CheckpointManager(self.cfg.ckpt_dir, keep=1)
            ckpt.save(
                result.best_params,
                step=kwargs["rounds"],
                metadata={
                    "best_nrmse": result.best_nrmse,
                    "best_acc": result.best_acc,
                    "best_beta": result.best_beta,
                    "best_p": result.best_p,
                    "best_q": result.best_q,
                },
            )
        return result
