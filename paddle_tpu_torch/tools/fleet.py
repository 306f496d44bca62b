"""fleet — serve and administer a multi-replica serving fleet; the port
of ``paddle_tpu/tools/fleet.py``.

::

    # 3 supervised replicas + the affinity router on :9300
    python -m paddle_tpu_torch.tools.fleet serve --root models/ \\
        --model nmt=1 --replicas 3 --port 9300 \\
        --journal-dir /var/lib/paddle-fleet

    # operator verbs against a running router
    python -m paddle_tpu_torch.tools.fleet status 127.0.0.1:9300
    python -m paddle_tpu_torch.tools.fleet drain 127.0.0.1:9300 replica-1
    python -m paddle_tpu_torch.tools.fleet kill 127.0.0.1:9300 replica-1
    python -m paddle_tpu_torch.tools.fleet restore 127.0.0.1:9300 replica-1
    python -m paddle_tpu_torch.tools.fleet generate 127.0.0.1:9300 nmt \\
        --prompt "3 5 7"

The drain/kill runbook (README "Serving fleet"): ``drain`` finishes
in-flight work, migrates the queued tail, and leaves the replica out
of rotation (its scheduler is terminally stopped — it keeps answering
``/statusz`` for inspection); ``kill`` SIGKILLs it — which is also how
a drained replica rejoins: the supervisor respawns a fresh process,
which replays an already-migrated journal — i.e. nothing — and
re-enters rotation at the next green ``/readyz``; ``restore`` forces
an immediate re-probe, skipping the down backoff (for a manual
respawn outside the supervisor).

Exit status: 0 = ok, 1 = the router answered with an error, 2 = could
not reach/parse the endpoint."""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request
from typing import List, Optional


def _post(address: str, route: str, body: dict, timeout: float) -> dict:
    data = json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://{address}{route}", data=data,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def _get(address: str, route: str, timeout: float) -> dict:
    with urllib.request.urlopen(f"http://{address}{route}",
                                timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def _cmd_serve(args) -> int:
    from ..observability.server import ObservabilityServer
    from ..serving.fleet import (FleetRouter, FleetRouterServer,
                                 FleetSupervisor)

    sup = FleetSupervisor(
        root=args.root, models=args.model or [], n=args.replicas,
        host=args.host, base_port=args.base_port,
        journal_dir=args.journal_dir, slots=args.slots,
        max_new=args.max_new, max_restarts=args.max_restarts,
        log_dir=args.log_dir, exit_on_wedge=args.exit_on_wedge,
        draft=args.draft, speculate_k=args.speculate_k)
    sup.start(wait_ready=args.wait_ready)
    router = FleetRouter(
        sup.replica_specs(), page_size=args.page_size,
        affinity_depth=args.affinity_depth, routing=args.routing,
        probe_interval=args.probe_interval, seed=args.seed)
    srv = FleetRouterServer(router, host=args.host, port=args.port)
    print(f"fleet router listening on {srv.start()} "
          f"({args.replicas} replicas, routing={args.routing})")
    for name, st in sup.status().items():
        print(f"  {name}: {st['address']} pid={st['pid']}")
    obs = None
    if args.obs_port is not None:
        obs = ObservabilityServer(host=args.host, port=args.obs_port)
        obs.attach("fleet_router", router)
        print(f"observability on {obs.start()}")
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        if obs is not None:
            obs.stop()
        srv.stop()
        sup.stop()
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.fleet",
        description="Serve and administer a multi-replica serving "
                    "fleet behind the affinity router.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sv = sub.add_parser("serve", help="start supervisor + router")
    sv.add_argument("--root", required=True,
                    help="versioned model store (<root>/<name>/<ver>/)")
    sv.add_argument("--model", action="append", metavar="NAME[=VER]",
                    help="model spec passed to every replica; "
                         "repeatable")
    sv.add_argument("--replicas", type=int, default=2)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=0,
                    help="router port (0 = pick)")
    sv.add_argument("--base-port", type=int, default=None,
                    help="first replica port (default: pick free ports)")
    sv.add_argument("--journal-dir", default="fleet-journals",
                    help="one request journal per replica lives here")
    sv.add_argument("--slots", type=int, default=4)
    sv.add_argument("--max-new", type=int, default=32)
    sv.add_argument("--draft", metavar="NAME=VER", default=None,
                    help="attach this draft to every replica's models "
                         "(the fleet serves speculatively)")
    sv.add_argument("--speculate-k", type=int, default=4)
    sv.add_argument("--max-restarts", type=int, default=3,
                    help="per-replica respawn budget")
    sv.add_argument("--routing",
                    choices=("affinity", "least_loaded", "random"),
                    default="affinity")
    sv.add_argument("--page-size", type=int, default=8,
                    help="must match the replicas' paged generators")
    sv.add_argument("--affinity-depth", type=int, default=2,
                    help="leading prompt chunks hashed into the "
                         "routing key")
    sv.add_argument("--probe-interval", type=float, default=0.25)
    sv.add_argument("--wait-ready", type=float, default=60.0,
                    help="block this long for replicas to warm before "
                         "serving")
    sv.add_argument("--exit-on-wedge", type=float, default=30.0,
                    help="replicas exit 13 on a stall of this many "
                         "seconds (supervisor respawns them); 0 off")
    sv.add_argument("--seed", type=int, default=0)
    sv.add_argument("--obs-port", type=int, default=None)
    sv.add_argument("--log-dir", default=None)

    st = sub.add_parser("status", help="GET /statusz")
    st.add_argument("address")
    st.add_argument("--timeout", type=float, default=10.0)

    for name, hlp in (
            ("drain", "finish in-flight, migrate the tail, leave "
                      "rotation"),
            ("kill", "SIGKILL the replica (supervisor respawns it)"),
            ("restore", "force an immediate re-probe")):
        p = sub.add_parser(name, help=hlp)
        p.add_argument("address")
        p.add_argument("replica")
        p.add_argument("--timeout", type=float, default=30.0)

    g = sub.add_parser("generate", help="POST /v1/generate via the "
                                        "router")
    g.add_argument("address")
    g.add_argument("model")
    g.add_argument("--prompt", required=True,
                   help="space-separated token ids")
    g.add_argument("--tenant", default="default")
    g.add_argument("--max-new", type=int, default=None)
    g.add_argument("--timeout", type=float, default=120.0)

    args = ap.parse_args(argv)
    if args.cmd == "serve":
        return _cmd_serve(args)

    try:
        if args.cmd == "status":
            print(json.dumps(_get(args.address, "/statusz",
                                  args.timeout), indent=1, default=str))
            return 0
        if args.cmd in ("drain", "kill", "restore"):
            out = _post(args.address, "/v1/fleet",
                        {"action": args.cmd, "replica": args.replica,
                         "timeout": args.timeout}, args.timeout + 10)
            print(json.dumps(out, indent=1))
            return 0
        if args.cmd == "generate":
            body = {"model": args.model, "tenant": args.tenant,
                    "prompt": [int(t) for t in args.prompt.split()]}
            if args.max_new is not None:
                body["max_new"] = args.max_new
            print(json.dumps(_post(args.address, "/v1/generate", body,
                                   args.timeout), indent=1))
            return 0
    except urllib.error.HTTPError as e:
        try:
            print(json.dumps(json.loads(e.read().decode()), indent=1),
                  file=sys.stderr)
        except Exception:
            print(f"fleet: HTTP {e.code}", file=sys.stderr)
        return 1
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"fleet: cannot reach {args.address}: {e}",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
