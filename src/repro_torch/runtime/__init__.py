"""Serving runtime: the continuous-batching stream server and the LM
server."""
from repro_torch.runtime.scheduler import RefreshCohorts, SlotScheduler
from repro_torch.runtime.server import Request, Server
from repro_torch.runtime.stream_server import StreamRequest, StreamServer

__all__ = ["RefreshCohorts", "Request", "Server", "SlotScheduler",
           "StreamRequest", "StreamServer"]
