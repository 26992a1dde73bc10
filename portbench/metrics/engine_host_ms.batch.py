"""Host ms of the engine's whole call a forward (span ``engine.forward``,
inside the program: the call returns once the forward is enqueued), over
the profiled slice's calls."""

from portbench import spans


def read(rec):
    return spans.host_ms(rec, 'engine.forward')
