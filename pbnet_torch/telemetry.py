"""Spans and counters at the boundaries of the port's layers.

Tracing is on exactly while a ``torch.profiler`` session records in this
process (``torch.autograd.profiler._is_profiler_enabled``), such as
``engine.train``'s ``profile_steps`` window.  There is no other switch.  With tracing off a span or a counter costs one check of that
flag, and a span does not enter ``record_function``.

* :class:`span`, a context manager and a decorator.  On, it enters
  ``torch.profiler.record_function(name)``, so the span is one of the
  profiler's own events, on the clock of the device trace, and it keeps a
  :class:`SpanRecord` on the host clock (``time.perf_counter_ns``).  Its
  parent is the innermost span open on the same thread, so spans opened on
  a worker thread nest among themselves.
* :func:`count` adds to a counter.  On, the amount is kept with the spans
  open on the calling thread.  A ``tally`` dict, where given, counts the
  name whether tracing is on or off (the kernel launch counters).
  :func:`host_read` counts one read of a tensor by the host (a read that
  waits for the device) in ``host_reads`` and ``host_read_bytes``.
* :func:`collected`: per span name its calls, total ms and self ms (the
  duration less the part that child spans cover); per counter its total and
  the amount counted inside each span, at any depth.

What is collected covers one profiler session: the first span or counter
call that finds tracing on, after a call of this module that found it off
(reading :func:`collected` once the session has ended is one), starts a
new collection.  Set-up, warm passes and earlier sessions are not in it.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import defaultdict
from typing import NamedTuple

from torch.autograd import profiler as _profiler
from torch.profiler import record_function


class SpanRecord(NamedTuple):
    name: str
    parent: str | None  # the innermost span open on the same thread, if any
    start_ns: int
    end_ns: int
    thread: int
    child_ns: int  # the part of [start_ns, end_ns] that child spans cover


_lock = threading.Lock()
_local = threading.local()
_records: list[SpanRecord] = []
_counts: dict = defaultdict(int)  # (counter, names of the open spans) -> amount
_stale = True  # the next call that finds tracing on starts a new collection


def tracing() -> bool:
    """Whether a profiler session records in this process."""
    global _stale
    if not _profiler._is_profiler_enabled:
        _stale = True
        return False
    if _stale:
        with _lock:
            if _stale:
                _records.clear()
                _counts.clear()
                _stale = False
    return True


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class span:
    """``with span(name): ...`` or ``@span(name)``: see the module's text."""

    __slots__ = ("name", "_rf", "_frame")

    def __init__(self, name: str):
        self.name = name
        self._frame = None

    def __enter__(self) -> "span":
        if not tracing():
            return self
        self._rf = record_function(self.name)
        self._rf.__enter__()
        st = _stack()
        path = (st[-1][0] + (self.name,)) if st else (self.name,)
        # [path, start_ns, child_ns]
        self._frame = [path, time.perf_counter_ns(), 0]
        st.append(self._frame)
        return self

    def __exit__(self, *exc) -> None:
        frame = self._frame
        if frame is None:
            return
        self._frame = None
        end = time.perf_counter_ns()
        st = _stack()
        st.pop()
        path, start, child = frame
        if st:
            st[-1][2] += end - start
        with _lock:
            _records.append(SpanRecord(self.name, path[-2] if len(path) > 1 else None, start,
                                       end, threading.get_ident(), child))
        self._rf.__exit__(*exc)

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def wrapper(*args, **kw):
            if not tracing():
                return fn(*args, **kw)
            with span(name):
                return fn(*args, **kw)

        return wrapper


def count(name: str, n: int = 1, tally: dict | None = None) -> None:
    """Add ``n`` to counter ``name`` (and to ``tally[name]``, on or off)."""
    if tally is not None:
        tally[name] += n
    if tracing():
        st = _stack()
        with _lock:
            _counts[(name, st[-1][0] if st else ())] += n


def host_read(t):
    """Count one host read of tensor ``t`` and its bytes; return ``t``."""
    if tracing():
        count("host_reads", 1)
        count("host_read_bytes", t.element_size() * t.numel())
    return t


def records() -> list[SpanRecord]:
    """The spans of the collection, in the order they closed."""
    with _lock:
        return list(_records)


def collected() -> dict:
    """``{"spans": {name: {"calls", "ms", "self_ms"}}, "counts": {counter:
    {"total": n, "by_span": {span: n counted while it was open}}}}``."""
    tracing()
    with _lock:
        recs, counts = list(_records), dict(_counts)
    spans: dict = {}
    for r in recs:
        s = spans.setdefault(r.name, {"calls": 0, "ms": 0.0, "self_ms": 0.0})
        s["calls"] += 1
        s["ms"] += (r.end_ns - r.start_ns) * 1e-6
        s["self_ms"] += (r.end_ns - r.start_ns - r.child_ns) * 1e-6
    out: dict = {}
    for (name, path), n in counts.items():
        c = out.setdefault(name, {"total": 0, "by_span": {}})
        c["total"] += n
        for s in set(path):
            c["by_span"][s] = c["by_span"].get(s, 0) + n
    return {"spans": spans, "counts": out}
