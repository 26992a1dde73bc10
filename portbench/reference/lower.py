"""The control: the reference in the nearest precision below the
configuration's, int4 for its int8.

Every 8-bit weight becomes a 4-bit one on the same range (w·7/127 rounded
half up, clipped to [−8, 7], its per-channel scale ×127/7) and every 8-bit
activation a 4-bit one (its scale ×127/7, so that the 4-bit grid spans the
same values); each bias is re-expressed on its new accumulator grid.  The
16-bit carriers stay.  The control runs the reference's own forward on
these arrays; where the program is correct at 8 bits, the control's logits
lie far from it."""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

from portbench import common, weights

STEP = np.float32(127 / 7)


def int4(config: Mapping, tensors: Mapping[str, np.ndarray]
         ) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """(config, tensors) of the control; the bits of each node by the
    configuration's family's rule."""
    bits = common.reference_family(config['family']).bits
    cfg = dict(config, act_bits=4, weight_bits=4)
    out = dict(tensors)
    for name, v in tensors.items():
        key, kind = name.rsplit('.', 1)
        if kind == 'act_scale' and bits(config, key) == 8:
            out[name] = np.float32(v * STEP)
        elif kind == 'weight_int':
            q = np.floor(v.astype(np.float32) / STEP + np.float32(0.5))
            out[name] = np.clip(q, -8, 7).astype(np.int8)
            out[key + '.weight_scale'] = (tensors[key + '.weight_scale']
                                          * STEP).astype(np.float32)
    # each conv's input node, as the weight generator pairs them
    plan = weights.family_plan(config)
    for key, _, _, _, node in plan.convs:
        s_old = (tensors[key + '.weight_scale'].astype(np.float64)
                 * float(tensors[node + '.act_scale']))
        s_new = (out[key + '.weight_scale'].astype(np.float64)
                 * float(out[node + '.act_scale']))
        out[key + '.bias_int'] = np.round(
            tensors[key + '.bias_int'] * s_old / s_new).astype(np.int32)
    return cfg, out
