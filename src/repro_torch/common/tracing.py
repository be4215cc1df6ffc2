"""Spans of the port's serving path, kept in memory, off unless turned on.

``span(name, **attrs)`` is a context manager around one piece of work.
While tracing is off (the default) it returns the shared :data:`NOOP`
context: no clock read, no record, no profiler call. While it is on, it
records a :class:`SpanRecord` when the span closes: the name, an id, the
id of the span that was open around it on entry (its parent, ``-1`` for
none), ``time.perf_counter_ns()`` at entry and exit, and the attributes.
Counters are integer attributes of the span at whose boundary the work is
done; there is no other counter system.

While tracing is on and a ``torch.profiler`` is recording, each span also
enters ``torch.profiler.record_function(name)``, so it shows in the
profiler's trace as a ``user_annotation`` on the host thread that ran it.
The trace's clock is not ``perf_counter``'s: a record and its annotation
give the offset between the two.

``enable()`` and ``disable()`` turn tracing on and off; ``drain()``
returns the records closed so far and forgets them. Nothing is written
anywhere. Spans nest by the order they are opened, so they are for one
thread: the serving engine's.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple

import torch


class SpanRecord(NamedTuple):
    name: str
    id: int
    parent_id: int
    t0_ns: int
    t1_ns: int
    attrs: Dict[str, int]


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


#: what :func:`span` returns while tracing is off
NOOP = _Noop()

_on = False
_records: List[SpanRecord] = []
_open: List[int] = []       # ids of the spans open now, innermost last
_next_id = 0


class _Span:
    __slots__ = ("name", "attrs", "id", "parent_id", "t0_ns", "_annotation")

    def __init__(self, name: str, attrs: Dict[str, int]):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        global _next_id
        self.id = _next_id
        _next_id += 1
        self.parent_id = _open[-1] if _open else -1
        _open.append(self.id)
        self._annotation = None
        if torch.autograd._profiler_enabled():
            self._annotation = torch.profiler.record_function(self.name)
            self.t0_ns = time.perf_counter_ns()
            self._annotation.__enter__()
        else:
            self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        t1_ns = time.perf_counter_ns()
        _open.pop()
        _records.append(SpanRecord(self.name, self.id, self.parent_id,
                                   self.t0_ns, t1_ns, self.attrs))
        return False


def span(name: str, **attrs: int):
    """A span named ``name`` with integer ``attrs`` (counters), or the
    shared no-op while tracing is off."""
    if not _on:
        return NOOP
    return _Span(name, attrs)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> List[SpanRecord]:
    """The records of the spans closed since the last drain, in the order
    they closed; forgotten here."""
    out = list(_records)
    _records.clear()
    return out
