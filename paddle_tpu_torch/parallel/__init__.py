"""paddle_tpu_torch.parallel — the port of ``paddle_tpu.parallel``, cut
to the elastic master: ``TaskQueue`` and its lease protocol
(``master.py``), ``master_reader``, and the HTTP ``MasterServer`` /
``MasterClient`` (``master_service.py``) that ``ResilientTrainer``
leases its data from.

The reference's mesh, SPMD sharding, transpiler, MoE, pipeline and
distributed-init modules (ROADMAP A15) and its pod coordinator (A16)
are not ported yet; nothing here imports them.
"""

from .master import Task, TaskQueue, master_reader
from .master_service import MasterClient, MasterServer

__all__ = ["Task", "TaskQueue", "master_reader", "MasterClient",
           "MasterServer"]
