"""Runtime: the continuous-batching stream server, its warm-pool autotuner
and its calibrated planner, the LM server, the fault-tolerant LM trainer
with its straggler watchdog, and the population-search trainer."""
from repro_torch.runtime.autotuner import WarmPoolAutotuner
from repro_torch.runtime.planner import (Calibration, Plan, Planner,
                                         get_calibration, predict_step_cost,
                                         replay_bench_tables)
from repro_torch.runtime.scheduler import RefreshCohorts, SlotScheduler
from repro_torch.runtime.server import Request, Server
from repro_torch.runtime.stream_server import StreamRequest, StreamServer
from repro_torch.runtime.straggler import StragglerWatchdog
from repro_torch.runtime.trainer import (ElasticRestart, PopulationTrainer,
                                         PopulationTrainerConfig, Trainer,
                                         TrainerConfig)

# the reference's exports, and RefreshCohorts (the slot-sharded refresh
# schedule, which the port's tests read from here)
__all__ = ["Calibration", "ElasticRestart", "Plan", "Planner",
           "PopulationTrainer", "PopulationTrainerConfig", "RefreshCohorts",
           "Request", "Server", "SlotScheduler", "StragglerWatchdog",
           "StreamRequest", "StreamServer", "Trainer", "TrainerConfig",
           "WarmPoolAutotuner", "get_calibration", "predict_step_cost",
           "replay_bench_tables"]
