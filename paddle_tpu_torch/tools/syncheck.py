"""syncheck — static concurrency lint over the repo's Python sources;
the port of ``paddle_tpu/tools/syncheck.py``.

``python -m paddle_tpu_torch.tools.syncheck [paths...]`` (default: the
installed ``paddle_tpu_torch`` package tree) sweeps every ``.py`` file
with a pure-AST pass and reports three error classes (exit 1 when any
is found), the static half of the concurrency sanitizer beside the
runtime ``utils.sync`` checker:

* ``raw-lock`` — construction of ``threading.Lock`` / ``RLock`` /
  ``Condition`` anywhere outside ``utils/sync.py``.  Every lock in the
  tree must be an ``OrderedLock``/``OrderedRLock``/``OrderedCondition``
  with a declared name and rank, or the runtime deadlock checker (and
  the ``paddle_sync_*`` accounting) is blind to it.
* ``io-under-lock`` — a blocking call **lexically** inside a
  ``with <lock>:`` body: ``time.sleep``, ``open``/``os.fsync``/file
  ``.write``, HTTP (``urlopen``/``requests``), subprocess spawns, and
  a host wait on the card (``synchronize``, and a blocking ``.item()``
  / ``.cpu()`` / ``.tolist()`` read of a device tensor).  A journal
  fsync under the scheduler lock is the canonical instance.
  The check is lexical by design (simple, zero false negatives inside
  the guarded block); calls into helpers are not followed — blocking
  helpers must keep lock acquisition out of their callers' hands or
  carry a suppression.
* ``wait-no-loop`` — a condition-variable ``.wait(...)`` (receiver
  named like a condition: ``*cv``, ``*cond*``, ``_work``) that is not
  lexically inside a ``while`` loop.  Stolen wakeups are legal for
  every Condition implementation; a bare ``if``-guarded wait is a
  latent lost-wakeup bug.

Suppressions: a trailing ``# syncheck: ok`` comment on the offending
line *or* on the enclosing ``with`` line silences a finding — used for
the two dedicated journal I/O locks, whose entire purpose is to order
file appends (see utils/journal.py).  Nested ``def``/``lambda`` bodies
inside a ``with`` block are NOT treated as running under the lock.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

__all__ = ["Finding", "check_file", "check_paths", "main"]

# files where raw threading primitive construction is allowed (path
# suffix match, '/'-normalized): the sync wrappers themselves
RAW_ALLOWED = ("paddle_tpu_torch/utils/sync.py",)

_LOCK_CLASSES = {"Lock", "RLock", "Condition"}

# final-identifier heuristic for "this with-item is a lock"
_LOCKISH = re.compile(
    r"(^|_)(lock|locks|mutex|cv|cond|condition|work)$", re.IGNORECASE)
# receivers whose .wait() is a condition-variable wait (not an Event
# or Request wait)
_CONDISH = re.compile(r"(^|_)(cv|cond|condition|work)$", re.IGNORECASE)

_SUPPRESS = re.compile(r"#\s*syncheck:\s*ok\b")

# blocking-call table: (dotted-suffix match) -> short reason
_BLOCKING_SUFFIXES: Dict[Tuple[str, ...], str] = {
    ("time", "sleep"): "time.sleep",
    ("sleep",): "sleep()",
    ("os", "fsync"): "os.fsync",
    ("fsync",): "fsync",
    ("open",): "file open",
    ("urlopen",): "HTTP request",
    ("create_connection",): "socket connect",
    ("subprocess", "run"): "subprocess",
    ("subprocess", "Popen"): "subprocess",
    ("subprocess", "call"): "subprocess",
    ("subprocess", "check_call"): "subprocess",
    ("subprocess", "check_output"): "subprocess",
    ("synchronize",): "device sync",
    ("item",): "device read",
    ("cpu",): "device read",
    ("tolist",): "device read",
    ("write",): "file write",
}
_BLOCKING_BASES = {"requests": "HTTP request"}


class Finding:
    __slots__ = ("path", "line", "code", "message")

    def __init__(self, path: str, line: int, code: str, message: str):
        self.path = path
        self.line = line
        self.code = code
        self.message = message

    def to_dict(self) -> Dict[str, object]:
        return {"path": self.path, "line": self.line, "code": self.code,
                "message": self.message}

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.code}] {self.message}"


def _dotted(node: ast.AST) -> List[str]:
    """['threading', 'Lock'] for threading.Lock — [] when not a plain
    name/attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif parts:
        parts.append("")          # computed base, e.g. x[0].write
    return list(reversed(parts))


def _final_name(node: ast.AST) -> Optional[str]:
    """The last identifier of a name/attribute chain (``self._lock`` ->
    ``_lock``)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _blocking_reason(parts: List[str]) -> Optional[str]:
    if not parts:
        return None
    if parts[0] in _BLOCKING_BASES:
        return _BLOCKING_BASES[parts[0]]
    for suffix, reason in _BLOCKING_SUFFIXES.items():
        if len(parts) >= len(suffix) \
                and tuple(parts[-len(suffix):]) == suffix:
            # bare one-part suffixes must not swallow dotted matches of
            # a DIFFERENT module (json.open isn't a thing, keep simple)
            return reason
    return None


class _Checker:
    def __init__(self, path: str, tree: ast.AST, lines: List[str],
                 raw_allowed: bool):
        self.path = path
        self.tree = tree
        self.lines = lines
        self.raw_allowed = raw_allowed
        self.findings: List[Finding] = []
        # names bound by `from threading import Lock` etc.
        self.threading_aliases: Dict[str, str] = {}

    # -- helpers -------------------------------------------------------------
    def _suppressed(self, *linenos: int) -> bool:
        for ln in linenos:
            if 1 <= ln <= len(self.lines) \
                    and _SUPPRESS.search(self.lines[ln - 1]):
                return True
        return False

    def _add(self, node: ast.AST, code: str, message: str,
             with_line: int = 0) -> None:
        line = getattr(node, "lineno", 0)
        if self._suppressed(line, with_line):
            return
        self.findings.append(Finding(self.path, line, code, message))

    # -- the pass ------------------------------------------------------------
    def run(self) -> List[Finding]:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ImportFrom) \
                    and node.module == "threading":
                for alias in node.names:
                    if alias.name in _LOCK_CLASSES:
                        self.threading_aliases[
                            alias.asname or alias.name] = alias.name
        self._scan(self.tree, in_while=False, lock_ctx=None)
        return self.findings

    def _is_raw_lock_call(self, call: ast.Call) -> Optional[str]:
        parts = _dotted(call.func)
        if len(parts) == 2 and parts[0] == "threading" \
                and parts[1] in _LOCK_CLASSES:
            return f"threading.{parts[1]}"
        if len(parts) == 1 and parts[0] in self.threading_aliases:
            return f"threading.{self.threading_aliases[parts[0]]}"
        return None

    def _lockish_item(self, expr: ast.AST) -> Optional[str]:
        name = _final_name(expr)
        if name is not None and _LOCKISH.search(name):
            return name
        return None

    def _scan(self, node: ast.AST, in_while: bool,
              lock_ctx: Optional[Tuple[str, int]]) -> None:
        for child in ast.iter_child_nodes(node):
            self._scan_node(child, in_while, lock_ctx)

    def _scan_node(self, node: ast.AST, in_while: bool,
                   lock_ctx: Optional[Tuple[str, int]]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            # a nested def's body does not run under the enclosing
            # lock (or inside the enclosing while)
            self._scan(node, in_while=False, lock_ctx=None)
            return
        if isinstance(node, ast.While):
            self._scan(node, in_while=True, lock_ctx=lock_ctx)
            return
        if isinstance(node, ast.With):
            ctx = lock_ctx
            with_line = node.lineno
            for item in node.items:
                # items AFTER a lock item (with self._lock, open(...))
                # evaluate under that lock
                self._scan_node(item.context_expr, in_while, ctx)
                if item.optional_vars is not None:
                    self._scan_node(item.optional_vars, in_while, ctx)
                lname = self._lockish_item(item.context_expr)
                if lname is not None:
                    ctx = (lname, with_line)
            for stmt in node.body:
                self._scan_node(stmt, in_while, ctx)
            return
        if isinstance(node, ast.Call):
            raw = self._is_raw_lock_call(node)
            if raw is not None and not self.raw_allowed:
                self._add(node, "raw-lock",
                          f"{raw}() constructed outside utils/sync.py —"
                          f" use OrderedLock/OrderedRLock/"
                          f"OrderedCondition with a declared rank")
            if lock_ctx is not None:
                reason = _blocking_reason(_dotted(node.func))
                if reason is not None:
                    self._add(node, "io-under-lock",
                              f"blocking call ({reason}) lexically "
                              f"inside `with {lock_ctx[0]}:` (line "
                              f"{lock_ctx[1]}) — move the I/O off the "
                              f"lock or suppress with `# syncheck: ok`"
                              f" if this lock exists to order it",
                              with_line=lock_ctx[1])
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "wait" and not in_while:
                recv = _final_name(node.func.value)
                if recv is not None and _CONDISH.search(recv):
                    self._add(node, "wait-no-loop",
                              f"condition wait on {recv!r} outside a "
                              f"while predicate loop — stolen wakeups "
                              f"make a bare wait a lost-wakeup bug")
            self._scan(node, in_while, lock_ctx)
            return
        self._scan(node, in_while, lock_ctx)


def check_file(path: str) -> List[Finding]:
    norm = path.replace(os.sep, "/")
    raw_allowed = any(norm.endswith(sfx) for sfx in RAW_ALLOWED)
    try:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
    except OSError as e:
        return [Finding(path, 0, "unreadable", str(e))]
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, "syntax-error", str(e))]
    return _Checker(path, tree, source.splitlines(), raw_allowed).run()


def _iter_py_files(paths: List[str]):
    for p in paths:
        if os.path.isfile(p):
            yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if d not in ("__pycache__", ".git"))
            for name in sorted(files):
                if name.endswith(".py"):
                    yield os.path.join(root, name)


def check_paths(paths: List[str]) -> List[Finding]:
    out: List[Finding] = []
    for path in _iter_py_files(paths):
        out.extend(check_file(path))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.syncheck",
        description="Static concurrency lint: raw locks, blocking I/O "
                    "under locks, predicate-free condition waits.")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to sweep (default: the "
                         "paddle_tpu_torch package directory)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the OK summary line")
    args = ap.parse_args(argv)
    paths = args.paths
    if not paths:
        import paddle_tpu_torch

        paths = [os.path.dirname(os.path.abspath(
            paddle_tpu_torch.__file__))]
    findings = check_paths(paths)
    if args.json:
        print(json.dumps([f.to_dict() for f in findings], indent=1))
    else:
        for f in findings:
            print(str(f))
        if not findings and not args.quiet:
            print(f"syncheck: OK — "
                  f"{sum(1 for _ in _iter_py_files(paths))} files clean")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
