"""Device ms a QAT step of its optimizer phase (span ``train.optimizer``:
the SGD step, the schedule, the step count, the accuracy)."""

from portbench import spans


def read(rec):
    return spans.device_ms(rec, 'train.optimizer')
