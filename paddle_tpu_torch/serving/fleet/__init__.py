"""Multi-replica serving fleet: the failure-domain layer above the
gateway; the port of ``paddle_tpu.serving.fleet``.

One gateway process is one failure domain — a crash loses its queue, a
traffic spike has nowhere to spill, a drain strands its tail.  This
package is the reference's master/pserver fault-tolerance cycle
(etcd-journaled leases, health-checked workers, re-dispatch on death)
rebuilt for serving:

* ``FleetRouter`` (router.py) — prefix-affinity routing over the
  ``paging.py`` chain hash, ``/readyz`` health checks with seeded
  backoff, and journal migration: a dead or drained replica's pending
  ``RequestJournal`` tail replays onto a healthy replica exactly once.
* ``FleetRouterServer`` (server.py) — the ``/v1/generate`` front door
  plus ``/v1/fleet`` operator verbs (drain/kill/restore).
* ``FleetSupervisor`` (supervisor.py) — one ``SupervisedService`` per
  replica: distinct ports, per-replica journals, respawn-in-place.

``python -m paddle_tpu_torch.tools.fleet`` is the CLI over all three."""

from .router import FleetRouter, NoReadyReplica, ReplicaSpec  # noqa: F401
from .server import FleetRouterServer  # noqa: F401
from .supervisor import FleetSupervisor  # noqa: F401

__all__ = ["FleetRouter", "FleetRouterServer", "FleetSupervisor",
           "NoReadyReplica", "ReplicaSpec"]
