"""Serving runtime: the continuous-batching stream server and its warm-pool
autotuner, the LM server, and the population-search trainer."""
from repro_torch.runtime.autotuner import WarmPoolAutotuner
from repro_torch.runtime.scheduler import RefreshCohorts, SlotScheduler
from repro_torch.runtime.server import Request, Server
from repro_torch.runtime.stream_server import StreamRequest, StreamServer
from repro_torch.runtime.trainer import (PopulationTrainer,
                                         PopulationTrainerConfig)

__all__ = ["PopulationTrainer", "PopulationTrainerConfig", "RefreshCohorts",
           "Request", "Server", "SlotScheduler", "StreamRequest",
           "StreamServer", "WarmPoolAutotuner"]
