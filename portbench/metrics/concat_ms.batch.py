"""Device ms a forward of InceptionV3's unit concats (span
``engine.concat``: each unit's requants of every branch onto the unit's
scale and the concatenation, timing events at its enter and exit), summed
over a forward's units, over the profiled slice's calls."""

from portbench import spans


def read(rec):
    return spans.device_ms(rec, 'engine.concat')
