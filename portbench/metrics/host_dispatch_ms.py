"""Mean host milliseconds of a call into the program's engine made alone,
each after the card has finished the one before (the call returns once
the forward is enqueued): the reader of every ``host_dispatch_ms.<cells>``
metric."""


def read(rec):
    calls = rec.get('dispatch_s')
    if not calls:
        return None
    return 1e3 * sum(calls) / len(calls)
