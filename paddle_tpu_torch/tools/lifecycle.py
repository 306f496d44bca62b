"""lifecycle — inspect and steer the release controller; the port of
``paddle_tpu/tools/lifecycle.py``.

::

    # what the controller knows: last good, canary, versions on disk
    python -m paddle_tpu_torch.tools.lifecycle status \\
        --journal rc.journal --root models/ --model nmt

    # operator promote: journal a directive; the live controller
    # validates and applies it at its next step (flipping the durable
    # CURRENT marker on success).  --set-current additionally flips
    # the marker NOW — the no-controller deploy path.
    python -m paddle_tpu_torch.tools.lifecycle promote 3 \\
        --journal rc.journal --root models/ --model nmt

    # operator rollback to an older version (mid-canary: no version
    # needed — the directive aborts the canary)
    python -m paddle_tpu_torch.tools.lifecycle rollback 2 \\
        --journal rc.journal --root models/ --model nmt

The CLI is journal-first: ``promote``/``rollback`` append operator
directives to the controller's own journal; a live
``ReleaseController`` validates, applies, and acknowledges them at its
next ``step()``, flipping the on-disk ``CURRENT`` marker on success
(``tools.gateway serve`` prefers the marker over "newest version on
disk").  With no controller running, ``--set-current`` flips the
marker immediately — an unvalidated override by design.

Exit status: 0 = ok, 1 = validation error (unknown version, no
journal), 64 = usage."""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from ..fluid import io as fio
from ..lifecycle import ReleaseJournal


def _status(args) -> int:
    out = {"journal": args.journal, "model": args.model}
    if os.path.exists(args.journal):
        journal = ReleaseJournal(args.journal)
        out["state"] = journal.state().to_dict()
        out["entries"] = len(journal.replay())
    else:
        out["state"] = None
        out["entries"] = 0
    if args.root:
        out["root"] = args.root
        out["versions_on_disk"] = fio.list_model_versions(args.root,
                                                          args.model)
        out["current_marker"] = fio.current_model_version(args.root,
                                                          args.model)
    print(json.dumps(out, indent=1, default=str))
    return 0


def _directive(args, action: str) -> int:
    version: Optional[str] = args.version
    if args.root and version is not None:
        if version not in fio.list_model_versions(args.root, args.model):
            print(f"lifecycle: no published version {version!r} of "
                  f"{args.model!r} under {args.root}", file=sys.stderr)
            return 1
    if action == "promote" and version is None:
        print("lifecycle: promote needs a version", file=sys.stderr)
        return 1
    if not os.path.exists(args.journal) and not args.set_current:
        # a typo'd --journal would create an orphan journal no
        # controller reads — the directive would be silently lost.
        # --set-current is the deliberate no-controller path and may
        # start a fresh journal.
        print(f"lifecycle: no journal at {args.journal} (is a "
              f"controller running? use --set-current for a "
              f"no-controller deploy)", file=sys.stderr)
        return 1
    if args.set_current and not (args.root and version is not None):
        # validate BEFORE the append: an exit-1 invocation must not
        # have enqueued a live directive the controller then applies
        print("lifecycle: --set-current needs --root and a version",
              file=sys.stderr)
        return 1
    journal = ReleaseJournal(args.journal)
    entry = journal.append("directive", action=action, model=args.model,
                           version=version, operator=True)
    # the CURRENT marker flips when the directive is APPLIED — the live
    # controller does that (and may refuse, e.g. promoting a foreign
    # version mid-canary).  --set-current is the explicit no-controller
    # escape hatch: flip the durable marker NOW so a plain gateway
    # restart comes up on the operator's choice, skipping validation.
    marked = False
    if args.set_current:
        fio.set_current_version(args.root, args.model, version)
        marked = True
    print(json.dumps({"appended": entry,
                      "note": "a live controller applies this at its "
                              "next step; CURRENT marker "
                              + ("updated" if marked else "unchanged")},
                     indent=1))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.lifecycle",
        description="Inspect and steer the release controller.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--journal", required=True,
                       help="the controller's release journal (jsonl)")
        p.add_argument("--model", required=True)
        p.add_argument("--root", default=None,
                       help="versioned model store "
                            "(<root>/<name>/<version>/)")

    common(sub.add_parser("status",
                          help="fold the journal + list versions"))
    pr = sub.add_parser("promote",
                        help="journal an operator promote directive")
    pr.add_argument("version")
    common(pr)
    rb = sub.add_parser("rollback",
                        help="journal an operator rollback directive")
    rb.add_argument("version", nargs="?", default=None,
                    help="target version (omit mid-canary: aborts the "
                         "canary)")
    common(rb)
    for p in (pr, rb):
        p.add_argument("--set-current", action="store_true",
                       help="ALSO flip the durable CURRENT marker now "
                            "(no-controller deploys; skips the live "
                            "controller's validation)")

    args = ap.parse_args(argv)
    if args.cmd == "status":
        return _status(args)
    return _directive(args, args.cmd)


if __name__ == "__main__":
    sys.exit(main())
