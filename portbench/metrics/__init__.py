"""Per-layer metric readers, one file each, named as the metric in
BENCHMARK.json.  ``read(rec)`` takes what the run recorded (its counters,
its host spans, the profiled slice's summary under ``trace``, the card's
peaks under ``peaks``) and returns the value, or None where the run holds
nothing to read."""
