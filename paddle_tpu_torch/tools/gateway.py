"""gateway — serve and administer the serving gateway; the port of
``paddle_tpu/tools/gateway.py``.

::

    # serve a model root (versioned layout: <root>/<name>/<version>/)
    # on the card (--cpu: on the CPU)
    python -m paddle_tpu_torch.tools.gateway serve --root models/ \\
        --model nmt=1 --port 9200 --journal gw.journal

    # administer a running gateway
    python -m paddle_tpu_torch.tools.gateway status 127.0.0.1:9200
    python -m paddle_tpu_torch.tools.gateway models 127.0.0.1:9200
    python -m paddle_tpu_torch.tools.gateway load 127.0.0.1:9200 nmt 2
    python -m paddle_tpu_torch.tools.gateway swap 127.0.0.1:9200 nmt 2
    python -m paddle_tpu_torch.tools.gateway generate 127.0.0.1:9200 nmt \\
        --prompt "3 5 7" --tenant interactive --stream

Exit status: 0 = ok, 1 = the gateway answered with an error,
2 = could not reach/parse the endpoint, 13 = serve exited on wedge
(non-zero so a supervisor restarts it).  ``serve --supervise`` (the
reference's re-exec under ``resilience.run_supervised``) raises
``NotImplementedError``: the supervised service is ROADMAP A13."""

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


def _parse_tenant(spec: str):
    """``name=slo[:weight[:rate]]`` -> TenantConfig."""
    from ..serving.gateway import TenantConfig

    name, _, rest = spec.partition("=")
    parts = (rest or "batch").split(":")
    slo = parts[0] or "batch"
    weight = float(parts[1]) if len(parts) > 1 and parts[1] else 1.0
    rate = float(parts[2]) if len(parts) > 2 and parts[2] else None
    return TenantConfig(name, slo=slo, weight=weight, rate=rate)


def _strip_supervise(argv: List[str]) -> List[str]:
    """The child of a supervised serve is the SAME command line minus
    the --supervise flag (keeping the 'serve' subcommand itself) — the
    supervised child must not recursively supervise."""
    child: List[str] = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == "--supervise":
            skip = True
            continue
        if a.startswith("--supervise="):
            continue
        child.append(a)
    return child


def _cmd_serve(args, raw_argv: List[str]) -> int:
    if args.supervise:
        # the reference re-execs THIS command (_strip_supervise(raw_argv))
        # under its elastic launcher: a crash or an --exit-on-wedge exit
        # respawns the gateway, which replays its journal on the way up
        raise NotImplementedError(
            "gateway serve --supervise re-executes under "
            "resilience.run_supervised, not ported to paddle_tpu_torch "
            "(ROADMAP A13); run serve without it under your own "
            "supervisor: --journal replays on restart")

    from ..observability.server import ObservabilityServer
    from ..serving.gateway import (Gateway, GatewayServer, ModelRegistry,
                                   TenantRouter)

    from .. import fluid

    registry = ModelRegistry(root=args.root,
                             hbm_budget_bytes=args.hbm_budget,
                             place=fluid.CPUPlace() if args.cpu else None)
    router = TenantRouter(
        tenants=[_parse_tenant(s) for s in args.tenant or []],
        reserve_latency_slots=args.reserve_latency_slots)
    gw = Gateway(registry=registry, router=router, n_slots=args.slots,
                 max_new_tokens=args.max_new, journal_path=args.journal)
    draft_name = draft_version = None
    if args.draft:
        draft_name, _, draft_version = args.draft.partition("=")
        if not draft_version:
            print("gateway: --draft needs NAME=VER", file=sys.stderr)
            return 1
    for spec in args.model or []:
        name, _, version = spec.partition("=")
        if not version:
            io_mod = __import__("paddle_tpu_torch.fluid.io", fromlist=["io"])
            # deploy-on-restart honors the release controller's CURRENT
            # marker (the last PROMOTED version), not merely the newest
            # artifact on disk — which may be an unvetted candidate
            version = io_mod.current_model_version(args.root, name)
            if not version:
                versions = io_mod.list_model_versions(args.root, name)
                if not versions:
                    print(f"gateway: no versions for {name} under "
                          f"{args.root}", file=sys.stderr)
                    return 1
                version = versions[-1]
        key = gw.load_model(name, version, n_slots=args.slots,
                            draft_model=draft_name,
                            draft_version=draft_version,
                            speculate_k=args.speculate_k)
        print(f"loaded {key}"
              + (f" (draft {draft_name}={draft_version})"
                 if draft_name else ""))
    recovered = gw.recover()
    if recovered:
        print(f"recovered {len(recovered)} journaled request(s)")
    srv = GatewayServer(gw, host=args.host, port=args.port)
    print(f"gateway listening on {srv.start()}")
    obs = None
    if args.obs_port is not None:
        obs = ObservabilityServer(host=args.host, port=args.obs_port)
        obs.attach("gateway", gw)
        obs.attach("gateway_registry", registry)
        obs.attach("gateway_router", router)
        print(f"observability on {obs.start()}")
    try:
        while True:
            time.sleep(1.0)
            if args.exit_on_wedge and gw.wedged(args.exit_on_wedge):
                print(f"gateway: wedged > {args.exit_on_wedge}s; "
                      f"exiting for supervised restart", file=sys.stderr)
                srv.stop(drain=False)
                return 13
    except KeyboardInterrupt:
        pass
    finally:
        if obs is not None:
            obs.stop()
        srv.stop(drain=True)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.gateway",
        description="Serve and administer the paddle_tpu_torch serving "
                    "gateway.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sv = sub.add_parser("serve", help="start a gateway process")
    sv.add_argument("--root", required=True,
                    help="versioned model store (<root>/<name>/<ver>/)")
    sv.add_argument("--model", action="append", metavar="NAME[=VER]",
                    help="load NAME at VER (default: newest on disk); "
                         "repeatable")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=0)
    sv.add_argument("--obs-port", type=int, default=None,
                    help="also start an ObservabilityServer with the "
                         "gateway sources attached")
    sv.add_argument("--slots", type=int, default=4)
    sv.add_argument("--max-new", type=int, default=32)
    sv.add_argument("--draft", metavar="NAME=VER", default=None,
                    help="attach this draft artifact to every --model "
                         "(the group serves speculatively)")
    sv.add_argument("--speculate-k", type=int, default=4,
                    help="draft tokens per verify dispatch")
    sv.add_argument("--hbm-budget", type=int, default=None,
                    help="reject loads beyond this many HBM bytes")
    sv.add_argument("--tenant", action="append",
                    metavar="NAME=SLO[:WEIGHT[:RATE]]",
                    help="tenant contract; repeatable")
    sv.add_argument("--reserve-latency-slots", type=int, default=1)
    sv.add_argument("--journal", default=None,
                    help="request journal path (replayed on restart)")
    sv.add_argument("--supervise", type=int, default=0, metavar="N",
                    help="run under the elastic launcher with N "
                         "restarts")
    sv.add_argument("--exit-on-wedge", type=float, default=0,
                    metavar="SECONDS",
                    help="exit 13 when pending work makes no progress "
                         "for SECONDS (supervisor restarts us)")
    sv.add_argument("--log-dir", default=None)
    sv.add_argument("--cpu", action="store_true",
                    help="run the models on the CPU (default: the card)")

    for name, hlp in (("status", "GET /statusz"),
                      ("models", "GET /v1/models")):
        p = sub.add_parser(name, help=hlp)
        p.add_argument("address")
        p.add_argument("--timeout", type=float, default=10.0)

    for name in ("load", "swap", "unload"):
        p = sub.add_parser(name, help=f"POST /v1/models action={name}")
        p.add_argument("address")
        p.add_argument("model")
        p.add_argument("version", nargs="?" if name == "unload"
                       else None)
        p.add_argument("--dirname", default=None)
        p.add_argument("--n-slots", type=int, default=None)
        p.add_argument("--timeout", type=float, default=120.0)

    g = sub.add_parser("generate", help="POST /v1/generate")
    g.add_argument("address")
    g.add_argument("model")
    g.add_argument("--prompt", required=True,
                   help="space-separated token ids")
    g.add_argument("--tenant", default="default")
    g.add_argument("--max-new", type=int, default=None)
    g.add_argument("--stream", action="store_true")
    g.add_argument("--timeout", type=float, default=120.0)

    args = ap.parse_args(argv)
    if args.cmd == "serve":
        # pass the FULL argv ('serve' included): the supervised child is
        # this exact command re-run without --supervise
        return _cmd_serve(args, argv)

    try:
        if args.cmd in ("status", "models"):
            route = "/statusz" if args.cmd == "status" else "/v1/models"
            out = _get(args.address, route, args.timeout)
            print(json.dumps(out, indent=1, default=str))
            return 0
        if args.cmd in ("load", "swap", "unload"):
            body = {"action": args.cmd, "model": args.model,
                    "version": args.version}
            if args.dirname:
                body["dirname"] = args.dirname
            if args.n_slots:
                body["n_slots"] = args.n_slots
            out = _post(args.address, "/v1/models", body, args.timeout)
            print(json.dumps(out, indent=1))
            return 0
        if args.cmd == "generate":
            body = {"model": args.model, "tenant": args.tenant,
                    "prompt": [int(t) for t in args.prompt.split()],
                    "stream": bool(args.stream)}
            if args.max_new is not None:
                body["max_new"] = args.max_new
            if not args.stream:
                out = _post(args.address, "/v1/generate", body,
                            args.timeout)
                print(json.dumps(out, indent=1))
                return 0
            data = json.dumps(body).encode()
            req = urllib.request.Request(
                f"http://{args.address}/v1/generate", data=data,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req,
                                        timeout=args.timeout) as resp:
                for line in resp:
                    sys.stdout.write(line.decode())
                    sys.stdout.flush()
            return 0
    except urllib.error.HTTPError as e:
        try:
            print(json.dumps(json.loads(e.read().decode()), indent=1),
                  file=sys.stderr)
        except Exception:
            print(f"gateway: HTTP {e.code}", file=sys.stderr)
        return 1
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"gateway: cannot reach {args.address}: {e}",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
