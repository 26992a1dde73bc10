"""Device kernels a QAT step, from the profiled steps: a count that
repeats exactly from run to run."""


def read(rec):
    t = rec.get('trace')
    if not t or not t.get('steps') or not t['kernels']:
        return None
    return t['kernels'] / t['steps']
