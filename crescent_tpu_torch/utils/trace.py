"""Scoped wall-clock timers (ark_std::{start_timer,end_timer} parity).

The reference gates per-phase timing prints behind the `print-trace` cargo
feature (creds/Cargo.toml:81; e.g. lib.rs:216-249, groth16rand.rs:104-176).
Here the switch is the CRESCENT_TRACE env var (any non-empty value), or
`enable()`.  Nesting is indented like ark_std's output.

    with timed("Groth16::prove"):
        ...

Also exposes `timed_fn` as a decorator.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import time

_depth = 0


def enabled() -> bool:
    return bool(os.environ.get("CRESCENT_TRACE"))


def enable():
    os.environ["CRESCENT_TRACE"] = "1"


def _fmt(dt: float) -> str:
    if dt >= 1.0:
        return f"{dt:.3f}s"
    if dt >= 1e-3:
        return f"{dt * 1e3:.3f}ms"
    return f"{dt * 1e6:.1f}µs"


@contextlib.contextmanager
def timed(label: str):
    global _depth
    if not enabled():
        yield
        return
    pad = "· " * _depth
    print(f"{pad}Start: {label}", file=sys.stderr, flush=True)
    _depth += 1
    t0 = time.time()
    try:
        yield
    finally:
        _depth -= 1
        print(
            f"{pad}End:   {label} {'.' * max(1, 40 - len(label))} {_fmt(time.time() - t0)}",
            file=sys.stderr,
            flush=True,
        )


def timed_fn(label: str | None = None):
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with timed(label or fn.__qualname__):
                return fn(*a, **kw)

        return wrapper

    return deco
