"""Multi-process launcher — ``python -m paddle_tpu_torch.launch --nprocs
N script.py [args...]``; the port of ``paddle_tpu/launch.py``.

The reference's cluster launcher
(paddle/scripts/cluster_train/paddle.py:1, fabric-over-ssh starting one
trainer per node with role env vars), for one host's processes: the
launcher picks a coordinator endpoint and spawns N copies of the script
with PADDLE_TPU_COORDINATOR / PADDLE_TPU_NPROCS / PADDLE_TPU_PROC_ID
set.  The ranks inherit the launcher's environment and pick their own
device: a rank runs on the card unless its script asks for the CPU (the
launcher adds no ``--cpu`` and no ``CUDA_VISIBLE_DEVICES`` of its own).
``PADDLE_TPU_COORDINATOR`` is exported for the reference's
``parallel/distributed.init_distributed``, which is not ported (ROADMAP
A15): nothing in this package reads it yet.

Elastic supervision (``--max-restarts N``): a rank that dies with a
non-zero exit (including SIGKILL) is respawned with the same rank and
environment instead of tearing the job down — the reference's
trainers-are-expected-to-die contract, where a restarted worker rejoins
the master's task queue and resumes from its checkpoint (see
paddle_tpu_torch/resilience).  Restart supervision is for master/data-
dispatch and pod workloads (ResilientTrainer over a MasterClient or a
PodClient); collective jobs keep the default fail-fast teardown
(``--max-restarts 0``): a restarted rank cannot rejoin a live
collective group.

``--pod-rendezvous auto`` serves a ``parallel.coordinator``
``CoordinatorServer`` inside the launcher and hands its address to
every rank (``PADDLE_TPU_POD_COORDINATOR``): the elastic pod that
``ResilientTrainer(coordinator=PodClient(...))`` runs over.

Teardown always escalates: survivors get SIGTERM, then SIGKILL after
``--kill-grace`` seconds, so one wedged rank can never hang the launcher
(or CI).  ``--log-dir`` gives each rank an append-mode
``rank-<i>.log`` that persists across restarts.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time


def find_free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _hold_port() -> tuple:
    """(port, held_socket): pick an ephemeral port and KEEP a
    SO_REUSEPORT-bound socket on it until the launcher exits.

    A close-then-reuse free-port probe races: between our close and the
    rank-0 coordinator's bind, the kernel can hand the same ephemeral
    port to any other process.  Holding the socket removes the port
    from the ephemeral pool, while a server that sets SO_REUSEPORT can
    still bind alongside the placeholder."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    s.bind(("127.0.0.1", 0))
    return s.getsockname()[1], s


class _RankSpec:
    """Everything needed to (re)spawn one rank: same cmd, same env, same
    rank id, append-mode log across incarnations."""

    __slots__ = ("rank", "cmd", "env", "log_path")

    def __init__(self, rank, cmd, env, log_path=None):
        self.rank = rank
        self.cmd = list(cmd)
        self.env = dict(env)
        self.log_path = log_path

    def spawn(self) -> subprocess.Popen:
        if self.log_path is None:
            return subprocess.Popen(self.cmd, env=self.env)
        log = open(self.log_path, "ab", buffering=0)
        try:
            return subprocess.Popen(self.cmd, env=self.env,
                                    stdout=log, stderr=log)
        finally:
            log.close()   # the child holds its own fd


def _terminate(procs, kill_grace: float = 10.0) -> None:
    """SIGTERM every live rank, then SIGKILL whatever ignored it after
    `kill_grace` seconds — a wedged rank cannot hang the launcher."""
    for q in procs:
        if q.poll() is None:
            try:
                q.send_signal(signal.SIGTERM)
            except OSError:
                pass
    deadline = time.monotonic() + kill_grace
    for q in procs:
        if q.poll() is None:
            try:
                q.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                q.kill()
    for q in procs:
        if q.poll() is None:
            try:
                q.wait(timeout=5)
            except subprocess.TimeoutExpired:
                pass


def launch(nprocs: int, argv, coordinator: str | None = None,
           env_extra: dict | None = None, max_restarts: int = 0,
           kill_grace: float = 10.0, log_dir: str | None = None,
           pod_rendezvous: str | None = None, pod_min_world: int = 1,
           pod_heartbeat: float | None = None) -> int:
    """Spawn ``nprocs`` copies of ``argv``; returns the first fatal
    non-zero exit code (terminating the rest), else 0.

    ``max_restarts`` > 0 enables elastic supervision: a rank exiting
    non-zero is respawned (same rank/env) while the shared restart
    budget lasts; only exhaustion of the budget tears the job down.
    Meant for master/data-dispatch workloads — collective (SPMD) jobs
    should keep the fail-fast default (see module docstring).

    ``pod_rendezvous`` arms the elastic pod control plane:
    ``"auto"`` starts a PodCoordinator server inside the launcher
    (world_target=nprocs, world_min=pod_min_world) and hands its
    address to every rank via ``PADDLE_TPU_POD_COORDINATOR``; an
    explicit ``host:port`` points ranks at an externally-run
    coordinator instead.  Each rank also gets a stable pod host id
    (``PADDLE_TPU_POD_HOST=host-<rank>``, doubling as the
    ``PADDLE_TPU_METRICS_HOST`` exposition label) so the pod scrapes
    as one /metrics surface.  Note the pod coordinator is NOT torn
    down between elastic restarts — a respawned rank re-rendezvouses
    into the live membership, which is the point."""
    held = None
    pod_server = None
    if coordinator is None:
        port, held = _hold_port()
        coordinator = f"127.0.0.1:{port}"
    pod_addr = pod_rendezvous
    if pod_rendezvous == "auto":
        from .parallel.coordinator import CoordinatorServer

        hb = 1.0 if pod_heartbeat is None else float(pod_heartbeat)
        pod_server = CoordinatorServer(
            world_min=max(1, int(pod_min_world)), world_target=nprocs,
            heartbeat_timeout=max(10.0, 10.0 * hb))
        pod_addr = pod_server.start()
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
    specs = []
    for rank in range(nprocs):
        env = dict(os.environ)
        env.update(env_extra or {})
        env["PADDLE_TPU_COORDINATOR"] = coordinator
        env["PADDLE_TPU_NPROCS"] = str(nprocs)
        env["PADDLE_TPU_PROC_ID"] = str(rank)
        if pod_addr is not None:
            env["PADDLE_TPU_POD_COORDINATOR"] = pod_addr
            env.setdefault("PADDLE_TPU_POD_HOST", f"host-{rank}")
            env.setdefault("PADDLE_TPU_METRICS_HOST",
                           env["PADDLE_TPU_POD_HOST"])
            if pod_heartbeat is not None:
                env["PADDLE_TPU_POD_HEARTBEAT"] = str(pod_heartbeat)
        log = (os.path.join(log_dir, f"rank-{rank}.log")
               if log_dir is not None else None)
        specs.append(_RankSpec(rank, [sys.executable] + list(argv), env,
                               log))
    procs = []
    try:
        # spawn INSIDE the try: a spawn failure at rank k (fd/disk
        # exhaustion opening its log) must tear down ranks 0..k-1, not
        # orphan them in collective init
        for spec in specs:
            procs.append(spec.spawn())
        # poll ALL ranks: a crash in any rank must terminate the rest
        # immediately (a sequential wait on rank 0 would hang forever on
        # a collective stuck waiting for the dead rank)
        return _monitor(procs, specs=specs, max_restarts=max_restarts,
                        kill_grace=kill_grace)
    except BaseException:
        # Ctrl-C, but also a failed (re)spawn: nothing may orphan live
        # ranks
        _terminate(procs, kill_grace)
        raise
    finally:
        if pod_server is not None:
            pod_server.stop()
        if held is not None:
            held.close()


def _monitor(procs, specs=None, max_restarts: int = 0,
             kill_grace: float = 10.0) -> int:
    """Poll all ranks.  A rank exiting non-zero is restarted in place
    (same rank, same env) while ``specs`` is given and the shared
    ``max_restarts`` budget lasts; otherwise — and when the budget runs
    out — the first non-zero exit terminates the remaining ranks with
    SIGTERM->SIGKILL escalation."""
    rc = 0
    restarts_left = max_restarts if specs is not None else 0
    live = set(range(len(procs)))
    while live:
        progressed = False
        for i in sorted(live):
            code = procs[i].poll()
            if code is None:
                continue
            progressed = True
            if code != 0 and restarts_left > 0:
                restarts_left -= 1
                procs[i] = specs[i].spawn()   # same rank, same env
                continue
            live.discard(i)
            if code != 0 and rc == 0:
                rc = code
                _terminate([q for j, q in enumerate(procs) if j in live],
                           kill_grace)
        if live and not progressed:
            time.sleep(0.05)
    return rc


_LOCAL_HOSTS = ("localhost", "127.0.0.1")


def launch_hosts(hosts, nprocs_per_host: int, argv,
                 coordinator: str | None = None, ssh_cmd: str = "ssh",
                 env_extra: dict | None = None,
                 kill_grace: float = 10.0) -> int:
    """Multi-host launch — the analog of the reference's ssh cluster
    launcher (paddle/scripts/cluster_train/paddle.py: fabric-over-ssh,
    one trainer per node with role env vars).  ``hosts`` is a list of
    hostnames (repeat a host for multiple slots, or use
    ``nprocs_per_host``); each remote rank is started through ``ssh host
    env K=V ... python script`` — the script path must exist on every
    host (shared filesystem, the reference's assumption too).  Local
    hosts (localhost/127.0.0.1) spawn directly, so CI exercises the full
    rank/coordinator wiring without sshd.

    No restart supervision here: an ssh child's exit code conflates the
    remote rank with the transport, so multi-host jobs keep fail-fast
    teardown (with the same kill-grace escalation).
    """
    import shlex

    hosts = list(hosts)
    total = len(hosts) * nprocs_per_host
    held = None
    if coordinator is None:
        if all(h in _LOCAL_HOSTS for h in hosts):
            port, held = _hold_port()
            coordinator = f"127.0.0.1:{port}"
        elif hosts[0] in _LOCAL_HOSTS:
            raise ValueError(
                "mixed localhost+remote host list needs an explicit "
                "--coordinator reachable from every host ('localhost' "
                "would resolve to each remote's own loopback)")
        else:
            coordinator = f"{hosts[0]}:29571"
    procs = []
    try:
        for hi, host in enumerate(hosts):
            for local in range(nprocs_per_host):
                rank = hi * nprocs_per_host + local
                envs = {"PADDLE_TPU_COORDINATOR": coordinator,
                        "PADDLE_TPU_NPROCS": str(total),
                        "PADDLE_TPU_PROC_ID": str(rank),
                        "PADDLE_TPU_HOST_ID": str(hi)}
                envs.update(env_extra or {})
                if host in _LOCAL_HOSTS:
                    env = dict(os.environ)
                    env.update(envs)
                    procs.append(subprocess.Popen(
                        [sys.executable] + list(argv), env=env))
                else:
                    # ssh joins argv into one remote shell string: quote
                    # every token or spaces in env values/args re-split
                    kv = [shlex.quote(f"{k}={v}") for k, v in envs.items()]
                    remote = [shlex.quote(a)
                              for a in [sys.executable] + list(argv)]
                    procs.append(subprocess.Popen(
                        [ssh_cmd, host, "env"] + kv + remote))
        return _monitor(procs, kill_grace=kill_grace)
    except BaseException:
        # a failed spawn (bad host, missing ssh) or Ctrl-C must not
        # orphan already-started ranks blocked in collective init
        _terminate(procs, kill_grace)
        raise
    finally:
        if held is not None:
            held.close()


def _parse_hosts(spec: str):
    """"h1,h2,h2" or "@file" (one host per line, '#' comments)."""
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            return [ln.strip() for ln in f
                    if ln.strip() and not ln.strip().startswith("#")]
    return [h.strip() for h in spec.split(",") if h.strip()]


def main() -> None:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.launch",
        description="spawn N SPMD worker processes of a training script")
    ap.add_argument("--nprocs", type=int, default=None,
                    help="single-host mode: number of local processes")
    ap.add_argument("--hosts", default=None,
                    help="multi-host mode: comma list or @hostfile "
                         "(reference cluster_train/paddle.py analog)")
    ap.add_argument("--nprocs-per-host", type=int, default=1)
    ap.add_argument("--ssh", default="ssh", help="remote shell command")
    ap.add_argument("--coordinator", default=None,
                    help="host:port (default: a free local port, or "
                         "first-host:29571 for remote hosts)")
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="elastic mode: respawn a rank that dies non-zero "
                         "(same rank/env), up to N restarts total — for "
                         "master/data-dispatch workloads; collective SPMD "
                         "jobs should keep 0 (fail-fast)")
    ap.add_argument("--kill-grace", type=float, default=10.0,
                    help="seconds between SIGTERM and SIGKILL at teardown")
    ap.add_argument("--log-dir", default=None,
                    help="write each rank's stdout/stderr to "
                         "DIR/rank-<i>.log (appended across restarts)")
    ap.add_argument("--pod-rendezvous", default=None,
                    metavar="auto|HOST:PORT",
                    help="elastic multi-host pod: 'auto' runs the pod "
                         "coordinator inside the launcher; HOST:PORT "
                         "points ranks at an external one (exported as "
                         "PADDLE_TPU_POD_COORDINATOR)")
    ap.add_argument("--pod-min-world", type=int, default=1,
                    help="survivors needed for the pod to keep running "
                         "after a host loss (first rendezvous still "
                         "waits for all --nprocs ranks)")
    ap.add_argument("--pod-heartbeat", type=float, default=None,
                    help="pod heartbeat interval seconds (exported as "
                         "PADDLE_TPU_POD_HEARTBEAT; eviction timeout is "
                         "10x this)")
    ap.add_argument("script", help="python script to run")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    ns = ap.parse_args()
    if (ns.nprocs is None) == (ns.hosts is None):
        ap.error("exactly one of --nprocs / --hosts is required")
    if ns.hosts is not None:
        sys.exit(launch_hosts(_parse_hosts(ns.hosts), ns.nprocs_per_host,
                              [ns.script] + ns.args, ns.coordinator,
                              ssh_cmd=ns.ssh, kill_grace=ns.kill_grace))
    sys.exit(launch(ns.nprocs, [ns.script] + ns.args, ns.coordinator,
                    max_restarts=ns.max_restarts,
                    kill_grace=ns.kill_grace, log_dir=ns.log_dir,
                    pod_rendezvous=ns.pod_rendezvous,
                    pod_min_world=ns.pod_min_world,
                    pod_heartbeat=ns.pod_heartbeat))


if __name__ == "__main__":
    main()
