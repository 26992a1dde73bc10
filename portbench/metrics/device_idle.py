"""1 − device busy ÷ wall time of the profiled slice, %: the reader of
every ``device_idle.<cells>`` metric."""


def read(rec):
    t = rec.get('trace')
    if not t or not t['wall_s'] or not t['busy_s']:
        return None
    return 100.0 * (1.0 - t['busy_s'] / t['wall_s'])
