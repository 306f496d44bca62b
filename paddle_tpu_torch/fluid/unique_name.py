"""Unique name generator — a copy of ``paddle_tpu/fluid/unique_name.py``.
Names must come out identical in both packages: they reach the
serialized program."""

from __future__ import annotations

import contextlib
from collections import defaultdict

__all__ = ["generate", "guard", "switch"]


class NameGenerator:
    def __init__(self):
        self.counters = defaultdict(int)

    def generate(self, key: str) -> str:
        n = self.counters[key]
        self.counters[key] += 1
        return f"{key}_{n}"


_generator = NameGenerator()


def generate(key: str) -> str:
    return _generator.generate(key)


def switch(new_generator=None):
    global _generator
    old = _generator
    _generator = new_generator or NameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
