"""The least time of the window's steps ÷ the window, %: a step's least
time is its integer forward at the int8 peak plus its float backward
(twice the forward's operations) at the dense bf16 peak, so the share
cannot pass 100 % for any float backward."""


def read(rec):
    if not rec.get('steps') or not rec.get('window_s'):
        return None
    return 100.0 * rec['least_step_s'] * rec['steps'] / rec['window_s']
