"""Device time of the kernels outside the program's library (the PyTorch
elementwise work between them) ÷ the device's busy time, %, over the
profiled slice."""


def read(rec):
    t = rec.get('trace')
    if not t or not t['busy_s'] or not t['kernels']:
        return None
    return 100.0 * t['glue_s'] / t['busy_s']
