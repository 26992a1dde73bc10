"""The forward's least time on the card ÷ its device busy time, %: Σ over
its convs and FC of max(int8 operations ÷ the int8 peak, bytes ÷ the
memory bandwidth) (``work/``), against the busy time of the profiled slice
over its forwards.  Busy time holds every device operation, the upload
among them, so the share cannot pass 100 % unless the work is counted too
high."""


def read(rec):
    t = rec.get('trace')
    if not t or not t['busy_s'] or not t.get('forwards'):
        return None
    return 100.0 * rec['bound_s_per_forward'] * t['forwards'] / t['busy_s']
