"""The benchmark's one door to the program's tracing: the spans that
``hawq_tpu_torch.utils.tracing`` recorded while the profiled slice ran.

The slice is the run's last profiled stretch, so its calls are the last
top-level spans the program recorded: ``engine.forward`` for a slice of
``trace['forwards']`` engine calls, ``train.step`` for one of
``trace['steps']`` steps.  :func:`device_ms` and :func:`host_ms` sum one
span name over those calls and divide by their count.  Each returns None
where there is nothing whole to read: a program without the tracing module
(an older checkout), no slice, fewer calls than the slice ran, no span of
the name, a span without a device time (the CPU), or any span dropped.
"""

from __future__ import annotations

from typing import Optional

TOP = {'forwards': 'engine.forward', 'steps': 'train.step'}


def _per_call(rec, name: str, device: bool) -> Optional[float]:
    try:
        from hawq_tpu_torch.utils import tracing
    except ImportError:
        return None
    t = rec.get('trace')
    kind = next((k for k in TOP if t and t.get(k)), None)
    if kind is None:
        return None
    calls = int(t[kind])
    recs = tracing.records()
    if recs.dropped:
        return None
    tops = [i for i, r in enumerate(recs.spans)
            if r['name'] == TOP[kind] and r['parent'] is None
            and r['t1_ns'] is not None]
    if len(tops) < calls:
        return None
    chosen = set(tops[-calls:])
    total, found = 0.0, False
    for r in recs.spans:
        if r['name'] != name or r['call'] not in chosen:
            continue
        if device:
            if r['device_ms'] is None:
                return None
            total += r['device_ms']
        else:
            total += (r['t1_ns'] - r['t0_ns']) * 1e-6
        found = True
    return total / calls if found else None


def device_ms(rec, name: str) -> Optional[float]:
    """Device ms of span ``name`` a call of the slice."""
    return _per_call(rec, name, True)


def host_ms(rec, name: str) -> Optional[float]:
    """Host ms of span ``name`` a call of the slice."""
    return _per_call(rec, name, False)
