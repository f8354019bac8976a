"""repro_torch.runtime — asynchronous edge-network runtime.

Port of ``repro.runtime``: event-driven simulation of the paper's
master/edge deployment — a virtual clock scheduler (``scheduler``),
pluggable per-link network models (``transport``) over generated
topologies (``topology``), adaptive cipher-backend dispatch
(``dispatch``), crypto-op coalescing (``coalesce``), and the protocol
phases as actors (``runner``).  The big-integer work runs on the card
unless the caller passes ``device="cpu"``.

Entry point: ``python -m repro_torch.launch.edge_sim`` (CLI).
"""
from .scheduler import Scheduler
from .topology import Topology, make, star, ring, full_mesh, hierarchical
from .transport import LinkModel, Message, Transport
from .dispatch import AdaptiveBox, CostModel, calibrate
from .coalesce import CoalesceQueue
from .runner import run_on_runtime

__all__ = [
    "Scheduler", "Topology", "make", "star", "ring", "full_mesh",
    "hierarchical", "LinkModel", "Message", "Transport", "AdaptiveBox",
    "CostModel", "calibrate", "CoalesceQueue", "run_on_runtime",
]
