"""Host ms of a QAT step (span ``train.step``: the step returns once its
work is enqueued), over the profiled slice's steps."""

from portbench import spans


def read(rec):
    return spans.host_ms(rec, 'train.step')
