"""paddle_tpu_torch.parallel — the port of ``paddle_tpu.parallel``, cut
to its host-side control plane: the elastic master (``TaskQueue`` and
its lease protocol in ``master.py``, ``master_reader``, and the HTTP
``MasterServer`` / ``MasterClient`` of ``master_service.py``) that
``ResilientTrainer`` leases its data from, and the pod coordinator
(``coordinator.py``: ``PodCoordinator``, its HTTP ``CoordinatorServer``
and the hosts' ``PodClient``) that its pod mode runs over.

The reference's mesh, SPMD sharding, transpiler, MoE, pipeline and
distributed-init modules (ROADMAP A15) are not ported yet; nothing here
imports them.
"""

from .master import Task, TaskQueue, master_reader
from .master_service import MasterClient, MasterServer
from .coordinator import (CoordinatorServer, MembershipView, PodClient,
                          PodCoordinator, StaleGeneration, agree_verdicts)

__all__ = ["Task", "TaskQueue", "master_reader", "MasterClient",
           "MasterServer", "CoordinatorServer", "MembershipView",
           "PodClient", "PodCoordinator", "StaleGeneration",
           "agree_verdicts"]
