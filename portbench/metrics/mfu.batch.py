"""The window's integer operations ÷ what the card's int8 peak does in the
window's wall time, %: 2 operations a MAC of every conv and FC
(``work/``), over every forward the window completed."""


def read(rec):
    if not rec.get('forwards') or not rec.get('window_s'):
        return None
    ops = rec['ops_per_forward'] * rec['forwards']
    return 100.0 * ops / (rec['window_s'] * rec['peaks']['int8_ops_per_s'])
