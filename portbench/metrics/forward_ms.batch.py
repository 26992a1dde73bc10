"""Device ms of the engine's whole call a forward (span ``engine.forward``:
timing events at its enter and exit), over the profiled slice's calls."""

from portbench import spans


def read(rec):
    return spans.device_ms(rec, 'engine.forward')
