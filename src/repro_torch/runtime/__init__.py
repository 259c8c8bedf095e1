"""Serving runtime: the continuous-batching stream server, its warm-pool
autotuner and its calibrated planner, the LM server, and the
population-search trainer."""
from repro_torch.runtime.autotuner import WarmPoolAutotuner
from repro_torch.runtime.planner import (Calibration, Plan, Planner,
                                         get_calibration, predict_step_cost,
                                         replay_bench_tables)
from repro_torch.runtime.scheduler import RefreshCohorts, SlotScheduler
from repro_torch.runtime.server import Request, Server
from repro_torch.runtime.stream_server import StreamRequest, StreamServer
from repro_torch.runtime.trainer import (PopulationTrainer,
                                         PopulationTrainerConfig)

__all__ = ["Calibration", "Plan", "Planner", "PopulationTrainer",
           "PopulationTrainerConfig", "RefreshCohorts", "Request", "Server",
           "SlotScheduler", "StreamRequest", "StreamServer",
           "WarmPoolAutotuner", "get_calibration", "predict_step_cost",
           "replay_bench_tables"]
