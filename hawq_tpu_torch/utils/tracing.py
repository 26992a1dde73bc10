"""Spans of the program's own sites, recorded only while a profiler records.

``with span(name):`` marks a site: the engine's whole call and its input,
conv, requant and residual sites (``inference/engine.py``), InceptionV3's
concat and average-pool sites (``inference/engine_inception.py``), the QAT
step and its forward, backward and optimizer phases (``train/train.py``).
There is no switch of its own.  Outside ``torch.profiler.profile`` ``span``
costs one flag check and returns one shared object that does nothing.  The
flag is ``torch.autograd.profiler._is_profiler_enabled``, set for the whole
process while a profiler records; ``torch._C._autograd._profiler_enabled()``
is set per thread, and not at all under the profiler's
``profile_all_threads`` option, with which a trace of the batcher's
threads is taken.  While a profiler records, a span

  * opens a user range of the profiler, as
    ``torch.profiler.record_function(name)`` does but through its C entry
    points (a fifth of the cost), so it lies in the profiler's trace as a
    ``user_annotation`` on the host row and, on a card, as a
    ``gpu_user_annotation`` over the kernels it launched (the per-site
    device time, read from the trace by ``inference.profile``);
  * appends a record to a list in memory: ``name``; ``parent``, the index
    of the enclosing span of the same thread (None at the top level);
    ``call``, the index of the enclosing top-level span (its own at the top
    level), shared by every span of one engine call or one train step;
    ``t0_ns`` / ``t1_ns``, ``time.time_ns()`` at enter and exit, the clock
    of the profiler's chrome trace (its ``ts`` + ``baseTimeNanoseconds``);
    and ``device_ms``, where the caller passes a CUDA ``device``, the
    elapsed time between two timing events recorded on its current stream
    at enter and exit (None otherwise).

Only a span that covers much work passes its device: the engine's whole
call, InceptionV3's unit concats and A1 pools and the step's phases.  A
timing event stalls the stream for microseconds, so events at each of a
forward's ~90 sites would make the traced forward slower than the one it
describes.
:func:`records` reads the device times, waiting for each span's end event
(call it after the work has been synchronized), and lets the events go.
A span inside an open span of the same name records nothing.  Records are
kept until :func:`clear`, which whoever runs the profiler calls before it
starts; the list holds at most ``LIMIT`` records, and spans past it are
counted in ``dropped``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler
from torch._C._autograd import _record_function_with_args_enter as _enter
from torch._C._autograd import _record_function_with_args_exit as _exit

LIMIT = 65_536


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class Records(NamedTuple):
    """What :func:`records` returns: the records, each a dict of the
    fields the module docstring lists, and the count of spans dropped past
    ``LIMIT``."""
    spans: List[Dict]
    dropped: int


class _State:
    """The process's records and the open spans of each thread."""

    def __init__(self):
        self.lock = threading.Lock()
        self.spans: List[_Span] = []
        self.dropped = 0
        self.local = threading.local()

    def stack(self) -> list:
        """The open spans of this thread, outermost first."""
        s = getattr(self.local, 'stack', None)
        if s is None:
            s = self.local.stack = []
        return s


_STATE = _State()


class _Span:
    """An open span, and once appended to ``_STATE.spans`` its record
    (``index`` None: past ``LIMIT``; ``stack`` None: nested in its name)."""
    __slots__ = ('name', 'device', 'index', 'parent', 'call', 't0_ns',
                 't1_ns', 'device_ms', 'events', 'range', 'stack')

    def __init__(self, name: str, device: Optional[torch.device]):
        self.name, self.device = name, device
        self.index = self.parent = self.call = self.t0_ns = None
        self.t1_ns = self.device_ms = self.events = None

    def __enter__(self):
        self.stack = stack = _STATE.stack()
        for s in stack:
            if s.name == self.name:
                self.stack = None
                return self
        with _STATE.lock:
            if len(_STATE.spans) < LIMIT:
                self.index = len(_STATE.spans)
                _STATE.spans.append(self)
            else:
                _STATE.dropped += 1
        if stack:
            self.parent, self.call = stack[-1].index, stack[0].index
        else:
            self.call = self.index
        stack.append(self)
        self.range = _enter(self.name)
        if self.index is not None:
            if self.device is not None and self.device.type == 'cuda':
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                self.events[0].record(torch.cuda.current_stream(self.device))
            self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.stack is None:
            return False
        if self.index is not None:
            if self.events is not None:
                self.events[1].record(torch.cuda.current_stream(self.device))
            self.t1_ns = time.time_ns()
        _exit(self.range)
        self.stack.pop()
        return False


def span(name: str, device: Optional[torch.device] = None):
    """A context manager over the site ``name``; ``device``, where the
    site's work runs, gives it a device time on a CUDA device."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name, device)


def records() -> Records:
    """Every record so far (device times read, their events let go), and
    the count dropped.  A span still open has ``t1_ns`` None."""
    with _STATE.lock:
        out = []
        for r in _STATE.spans:
            if r.events is not None and r.t1_ns is not None:
                start, end = r.events
                end.synchronize()
                r.device_ms = start.elapsed_time(end)
                r.events = None
            out.append(dict(name=r.name, parent=r.parent, call=r.call,
                            t0_ns=r.t0_ns, t1_ns=r.t1_ns,
                            device_ms=r.device_ms))
        return Records(out, _STATE.dropped)


def clear() -> None:
    """Forget every record and the dropped count (call it while no span is
    open)."""
    with _STATE.lock:
        _STATE.spans.clear()
        _STATE.dropped = 0
