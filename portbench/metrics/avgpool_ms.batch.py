"""Device ms a forward of InceptionV3's A1 pools (span ``engine.avgpool``:
each pool branch's input requant, 3×3 average pool and requant in one
kernel, timing events at its enter and exit), summed over a forward's
pool branches, over the profiled slice's calls."""

from portbench import spans


def read(rec):
    return spans.device_ms(rec, 'engine.avgpool')
