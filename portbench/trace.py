"""A profiled slice of a run, and what the per-layer metrics read from it.

``Slice`` wraps ``torch.profiler`` over a steady stretch of the run; its
chrome trace is written under ``TMPDIR`` and deleted once read.  From the
device's activities (kernels, copies, fills) it takes the busy time (the
union of their intervals), the kernel time of the program's own kernels and
of the rest (the PyTorch glue between them), and the breakdown: the device
operations that took most time, and the longest idle gaps by what the host
was doing meanwhile.  A slice whose device trace lacks much of the work
that the host enqueued is profiled anew (:func:`profiled`).  The kernel classifier is copied from the program's
card smoke script, so that the trace names the port's kernels as its
builders do.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

_TEMPLATE = (re.compile(r'gemm_s8_kernel<(\w+), \w+, (\w+)>'),
             re.compile(r'gemm_s8_kernelILb(\d)ELb\dELb(\d)E'))
_SM90_TEMPLATE = (re.compile(r'gemm_s8_sm90_kernel<(\w+), (\w+), (\w+),'),
                  re.compile(r'gemm_s8_sm90_kernelILb(\d)ELb(\d)ELb(\d)E'))
_DW_TEMPLATE = re.compile(r'dwconv_kernel(?:<(\w+),|ILb(\d)E)')
_AVG_TEMPLATE = re.compile(r'avgpool3x3_kernel(?:<[^<>]*?(true|false)>'
                           r'|I\w*?Lb\dELb(\d)E)')
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation', 'python_function')
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')
_ENQUEUES = re.compile(r'Launch|Memcpy|Memset')


def port_kernel(name: str) -> Optional[str]:
    """'port: …' for a kernel of the program's library (demangled or
    mangled name), None for any other kernel."""
    for pattern in _SM90_TEMPLATE:
        m = pattern.search(name)
        if m:
            conv, requant, int4 = (g in ('true', '1') for g in m.groups())
            return ('port: ' + ('conv' if conv else 'matmul') + ' sm90'
                    + (' requant' if requant and not conv else '')
                    + (' acc' if conv and not requant else '')
                    + (' int4' if int4 else ''))
    for pattern in _TEMPLATE:
        m = pattern.search(name)
        if m:
            conv, int4 = (g in ('true', '1') for g in m.groups())
            return ('port: ' + ('conv' if conv else 'matmul')
                    + (' int4' if int4 else ''))
    if 'gemm_s8_splitk_kernel' in name:
        return 'port: matmul split-K'
    m = _DW_TEMPLATE.search(name)
    if m:
        requant = m.group(1) in ('true', '1') or m.group(2) in ('true', '1')
        return 'port: depthwise ' + ('requant' if requant else 'acc')
    m = _AVG_TEMPLATE.search(name)
    if m:
        return 'port: avgpool' + ('' if (m.group(1) or m.group(2)) in (
            'true', '1') else ' quotient')
    if 'maxpool_folded_requant_kernel' in name:
        return 'port: pool requant'
    if 'maxpool_folded_kernel' in name:
        return 'port: pool'
    if 'minmax_partial_kernel' in name or 'minmax_finish_kernel' in name:
        return 'port: minmax'
    return None


def union_s(spans: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def gaps(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The idle intervals between the union's pieces."""
    out, end = [], None
    for a, b in sorted(spans):
        if end is not None and a > end:
            out.append((end, a))
        end = b if end is None else max(end, b)
    return out


def _all_threads() -> Dict:
    """The profiler's option to record the host operations of every
    thread (the serving path launches from the batcher's threads), where
    this torch has it."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return {'experimental_config': _ExperimentalConfig(
            profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


def short_name(name: str) -> str:
    return port_kernel(name) or name[:60]


def lost_share(events: List[dict]) -> float:
    """The share of the host calls that enqueue device work (a kernel
    launch, a copy, a fill) whose device activity the trace lacks, matched
    by correlation id.  A few at a slice's edges are usual; now and then
    the profiler loses a long run of activities, and a slice read from
    such a trace counts too little busy time."""
    done = {e.get('args', {}).get('correlation') for e in events
            if e.get('cat') in DEVICE_CATS}
    enqueued = [e.get('args', {}).get('correlation') for e in events
                if e.get('cat') in LAUNCH_CATS
                and _ENQUEUES.search(e.get('name', ''))]
    if not enqueued:
        return 0.0
    return sum(1 for c in enqueued if c not in done) / len(enqueued)


def profiled(work: Callable[[], None], tries: int = 3,
             most_lost: float = 0.01) -> Dict:
    """The summary of a slice that profiles ``work()``; while its device
    trace lacks more than ``most_lost`` of the enqueued work
    (:func:`lost_share`), ``work()`` is profiled anew, up to ``tries``
    slices in all, and the last is kept."""
    for i in range(tries):
        tr = Slice()
        tr.start()
        work()
        tr.stop()
        summary = tr.summary()
        if summary['lost_share'] <= most_lost:
            break
        sys.stderr.write(f"trace: slice {i + 1} lacks the device activity "
                         f"of {summary['lost_share']:.2%} of the host "
                         f"calls that enqueued work\n")
    return summary


class Slice:
    """A profiled stretch of a run: ``start()``, the work, ``stop()``,
    then :meth:`summary`."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.events: List[dict] = []

    @staticmethod
    def prime() -> None:
        """Profile a trivial step once, so that the profiler's first start
        (its CUDA tracing set up, seconds) falls into the run's set-up and
        not into the slice."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            if torch.cuda.is_available():
                torch.ones(1, device='cuda').add_(1)
                torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA],
                            **_all_threads())
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix='.json')
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = [e for e in json.load(f).get('traceEvents', [])
                               if e.get('ph') == 'X']
        finally:
            os.remove(path)
        self.prof = None

    def summary(self) -> Dict:
        """busy_s, wall_s, kernel counts and seconds (the port's, the
        rest), and the breakdown."""
        dev = [e for e in self.events if e.get('cat') in DEVICE_CATS]
        spans = [(float(e['ts']) * 1e-6,
                  (float(e['ts']) + float(e['dur'])) * 1e-6) for e in dev]
        kernels = [e for e in dev if e.get('cat') == 'kernel']
        by_name: Dict[str, float] = {}
        port_s = glue_s = 0.0
        for e in dev:
            d = float(e['dur']) * 1e-6
            name = short_name(e.get('name', '?'))
            by_name[name] = by_name.get(name, 0.0) + d
            if e.get('cat') == 'kernel':
                if port_kernel(e.get('name', '')):
                    port_s += d
                else:
                    glue_s += d
        return dict(
            busy_s=union_s(spans) if spans else 0.0,
            wall_s=self.t1 - self.t0, kernels=len(kernels),
            lost_share=lost_share(self.events),
            port_s=port_s, glue_s=glue_s,
            breakdown=dict(
                device_ops=[[k, v] for k, v in sorted(
                    by_name.items(), key=lambda kv: -kv[1])[:10]],
                idle_gaps=self._idle_by_host(spans)))

    def _idle_by_host(self, spans, n: int = 500) -> List[list]:
        """The ``n`` longest idle gaps of the device, each named by the
        innermost host operation that overlaps most of it, summed by name
        → the ten largest [name, seconds]."""
        host = sorted(((float(e['ts']) * 1e-6,
                        (float(e['ts']) + float(e['dur'])) * 1e-6,
                        e.get('name', '?'))
                       for e in self.events if e.get('cat') in HOST_CATS))
        if not host or not spans:
            return []
        starts = [h[0] for h in host]
        longest = max(h[1] - h[0] for h in host)
        idle = sorted(gaps(spans), key=lambda g: g[0] - g[1])[:n]
        by_name: Dict[str, float] = {}
        for g0, g1 in idle:
            best, best_key = None, None
            i = bisect.bisect_left(starts, g1)
            while i > 0:
                i -= 1
                a, b, name = host[i]
                if a < g0 - longest:
                    break
                over = min(b, g1) - max(a, g0)
                if over <= 0:
                    continue
                key = (over, -(b - a))
                if best_key is None or key > best_key:
                    best, best_key = name, key
            name = best or '(no host operation)'
            by_name[name] = by_name.get(name, 0.0) + (g1 - g0)
        return [[k, v] for k, v in sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:10]]
