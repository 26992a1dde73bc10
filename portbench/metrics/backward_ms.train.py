"""Device ms a QAT step of its backward (span ``train.backward``:
``loss.backward()``)."""

from portbench import spans


def read(rec):
    return spans.device_ms(rec, 'train.backward')
