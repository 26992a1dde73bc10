"""Device ms a QAT step of its forward, the model and the loss (span
``train.forward``)."""

from portbench import spans


def read(rec):
    return spans.device_ms(rec, 'train.forward')
