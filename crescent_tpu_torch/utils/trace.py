"""Scoped wall-clock timers (ark_std::{start_timer,end_timer} parity).

The reference gates per-phase timing prints behind the `print-trace` cargo
feature (creds/Cargo.toml:81; e.g. lib.rs:216-249, groth16rand.rs:104-176).
Here the switch is the CRESCENT_TRACE env var (any non-empty value), or
`enable()`.  Nesting is indented like ark_std's output.

    with timed("Groth16::prove"):
        ...

Also exposes `timed_fn` as a decorator, and `recording()`, which collects
the spans for a caller that reports them itself.
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


_records: list | None = None


@contextlib.contextmanager
def recording():
    """Collects every span that `timed` opens inside it, printed or not, as
    [depth, label, seconds] lists in the order they open (seconds is None
    until the span closes)."""
    global _records
    prev, _records = _records, []
    try:
        yield _records
    finally:
        _records = prev


@contextlib.contextmanager
def timed(label: str):
    global _depth
    show = enabled()
    if not show and _records is None:
        yield
        return
    pad = "· " * _depth
    if show:
        print(f"{pad}Start: {label}", file=sys.stderr, flush=True)
    rec = [_depth, label, None]
    if _records is not None:
        _records.append(rec)
    _depth += 1
    t0 = time.time()
    try:
        yield
    finally:
        _depth -= 1
        rec[2] = time.time() - t0
        if show:
            print(
                f"{pad}End:   {label} {'.' * max(1, 40 - len(label))} {_fmt(rec[2])}",
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
