"""obs — scrape and pretty-print a live ObservabilityServer; the port's
copy of ``paddle_tpu/tools/obs.py``.

::

    python -m paddle_tpu_torch.tools.obs metrics 127.0.0.1:9100
    python -m paddle_tpu_torch.tools.obs metrics 127.0.0.1:9100 --grep serving
    python -m paddle_tpu_torch.tools.obs statusz 127.0.0.1:9100
    python -m paddle_tpu_torch.tools.obs healthz 127.0.0.1:9100
    python -m paddle_tpu_torch.tools.obs trace   127.0.0.1:9100 -o trace.json

``metrics`` prints the Prometheus text (optionally filtered), ``statusz``
and ``healthz`` pretty-print the JSON rollup, and ``trace`` dumps the
server's Chrome-trace JSON to a file you load in chrome://tracing or
https://ui.perfetto.dev.

Exit status: 0 = ok, 1 = the endpoint answered but unhealthy
(healthz ok != true), 2 = could not reach/parse the endpoint.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.error
import urllib.request
from typing import List, Optional


def _fetch(address: str, route: str, timeout: float) -> bytes:
    url = f"http://{address}{route}"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.obs",
        description="Scrape a paddle_tpu_torch ObservabilityServer "
                    "(/metrics, /healthz, /statusz, /trace).")
    ap.add_argument("endpoint",
                    choices=("metrics", "healthz", "statusz", "trace"))
    ap.add_argument("address", help="host:port of the "
                    "ObservabilityServer (its .address property)")
    ap.add_argument("--timeout", type=float, default=5.0)
    ap.add_argument("--grep", default=None, metavar="SUBSTR",
                    help="metrics only: print just the lines containing "
                         "SUBSTR (comment lines of matching families "
                         "kept)")
    ap.add_argument("-o", "--out", default=None, metavar="FILE",
                    help="trace only: write the Chrome-trace JSON here "
                         "(default: trace.json)")
    args = ap.parse_args(argv)

    try:
        body = _fetch(args.address, f"/{args.endpoint}", args.timeout)
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"obs: cannot reach http://{args.address}/"
              f"{args.endpoint}: {e}", file=sys.stderr)
        return 2

    if args.endpoint == "metrics":
        text = body.decode()
        if args.grep:
            text = "\n".join(ln for ln in text.splitlines()
                             if args.grep in ln)
        print(text)
        return 0

    try:
        obj = json.loads(body)
    except ValueError as e:
        print(f"obs: bad JSON from /{args.endpoint}: {e}",
              file=sys.stderr)
        return 2

    if args.endpoint == "trace":
        out = args.out or "trace.json"
        with open(out, "w") as f:
            json.dump(obj, f)
        n = len(obj.get("traceEvents", []))
        print(f"wrote {n} events to {out} "
              f"(load in chrome://tracing or ui.perfetto.dev)")
        return 0

    print(json.dumps(obj, indent=2, sort_keys=True))
    if args.endpoint == "healthz" and not obj.get("ok"):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
