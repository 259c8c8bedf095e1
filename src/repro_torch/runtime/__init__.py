"""Serving runtime: the continuous-batching stream server."""
from repro_torch.runtime.scheduler import RefreshCohorts, SlotScheduler
from repro_torch.runtime.stream_server import StreamRequest, StreamServer

__all__ = ["RefreshCohorts", "SlotScheduler", "StreamRequest", "StreamServer"]
