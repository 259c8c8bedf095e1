"""Population-search runtime wrapper, in PyTorch.

The counterpart of ``PopulationTrainerConfig`` and ``PopulationTrainer`` in
``repro.runtime.trainer``.  The LM ``Trainer`` of that module is not ported
yet (ROADMAP Queue 1, 'LM optimizers, Trainer and launch').
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import population
from repro_torch.data.timeseries import RegressionBatch


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
