"""FleetSupervisor — spawn and respawn the replica processes; the port
of ``paddle_tpu/serving/fleet/supervisor.py``.

One ``SupervisedService`` per replica, each running the existing
``python -m paddle_tpu_torch.tools.gateway serve`` on its own port with its
own journal file.  A SIGKILLed replica respawns in place (restart
budget permitting), replays what is left of its journal — the router
already migrated the tail, so a respawn replays only what arrived after
migration — and rejoins rotation at the router's next probe.  Cold
start is cheap by construction: replicas load artifacts through the
registry, whose ``compiled/`` cache restores the kernel libraries and
the steps' records from disk, so crash-replace and scale-up pay I/O
and one capture a signature, not an nvcc build.  A replica runs on the
card; ``extra_args=["--cpu"]`` puts every replica on the CPU.

The supervisor owns processes; the router owns rotation.  They meet in
``replica_specs()``: the spec list (name, address, journal path) a
``FleetRouter`` is built from."""

from __future__ import annotations

import os
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence

from ...resilience.service import SupervisedService
from .router import ReplicaSpec

__all__ = ["FleetSupervisor"]


class FleetSupervisor:
    """Spawn ``n`` gateway replicas on distinct ports and keep them up.

    ``models`` are ``NAME[=VERSION]`` specs passed straight through to
    ``tools.gateway serve --model``; every replica serves the same set
    (the fleet is homogeneous — affinity routing assumes any replica
    can serve any request)."""

    def __init__(self, root: str, models: Sequence[str], n: int = 2,
                 host: str = "127.0.0.1",
                 base_port: Optional[int] = None,
                 journal_dir: str = "fleet-journals",
                 slots: int = 4, max_new: int = 32,
                 max_restarts: int = 3,
                 log_dir: Optional[str] = None,
                 exit_on_wedge: float = 0.0,
                 draft: Optional[str] = None, speculate_k: int = 4,
                 env_extra: Optional[Dict[str, str]] = None,
                 extra_args: Sequence[str] = ()):
        if n < 1:
            raise ValueError("FleetSupervisor: n >= 1 replicas")
        self.root = str(root)
        self.models = list(models)
        self.host = str(host)
        self.journal_dir = str(journal_dir)
        os.makedirs(self.journal_dir, exist_ok=True)
        if base_port is None:
            from ...launch import find_free_port

            ports = [find_free_port() for _ in range(n)]
        else:
            ports = [int(base_port) + i for i in range(n)]
        self._services: Dict[str, SupervisedService] = {}
        self._specs: List[ReplicaSpec] = []
        for i, port in enumerate(ports):
            name = f"replica-{i}"
            journal = os.path.join(self.journal_dir, f"{name}.journal")
            argv = ["-m", "paddle_tpu_torch.tools.gateway", "serve",
                    "--root", self.root, "--host", self.host,
                    "--port", str(port), "--journal", journal,
                    "--slots", str(int(slots)),
                    "--max-new", str(int(max_new))]
            for spec in self.models:
                argv += ["--model", spec]
            if draft:
                argv += ["--draft", draft,
                         "--speculate-k", str(int(speculate_k))]
            if exit_on_wedge:
                argv += ["--exit-on-wedge", str(float(exit_on_wedge))]
            argv += list(extra_args)
            log_path = (os.path.join(log_dir, f"{name}.log")
                        if log_dir else None)
            self._services[name] = SupervisedService(
                argv, max_restarts=max_restarts, log_path=log_path,
                name=name, env_extra=env_extra)
            self._specs.append(ReplicaSpec(
                name, f"{self.host}:{port}", journal_path=journal))

    def replica_specs(self) -> List[ReplicaSpec]:
        return list(self._specs)

    # -- lifecycle -----------------------------------------------------------
    def start(self, wait_ready: float = 0.0) -> "FleetSupervisor":
        """Spawn every replica; with ``wait_ready`` > 0, block until
        each answers ``/readyz`` 200 or the budget runs out (a replica
        still compiling past the budget is not an error — the router's
        probes pick it up whenever it finishes warming)."""
        for svc in self._services.values():
            svc.start()
        if wait_ready > 0:
            deadline = time.monotonic() + float(wait_ready)
            waiting = {s.name: s.address for s in self._specs}
            while waiting and time.monotonic() < deadline:
                for name, address in list(waiting.items()):
                    try:
                        with urllib.request.urlopen(
                                f"http://{address}/readyz",
                                timeout=2.0):
                            pass
                        del waiting[name]
                    except (urllib.error.URLError, OSError):
                        pass
                if waiting:
                    time.sleep(0.1)
        return self

    def stop(self) -> None:
        for svc in self._services.values():
            svc.stop()

    def kill(self, name: str) -> Optional[int]:
        """SIGKILL one replica (chaos drill); its monitor respawns it
        while the restart budget lasts."""
        if name not in self._services:
            raise KeyError(f"fleet: unknown replica {name!r}")
        return self._services[name].kill()

    def status(self) -> Dict[str, Dict[str, object]]:
        return {name: {"pid": svc.pid, "running": svc.running(),
                       "restarts": svc.restarts,
                       "address": spec.address,
                       "journal": spec.journal_path}
                for (name, svc), spec in zip(self._services.items(),
                                             self._specs)}
