"""What the traffic kinds share: the run's context, the host clock of the
process, the comparison of answers with the reference, and the card's
readings."""

from __future__ import annotations

import dataclasses
import gc
import importlib
import os
import subprocess
import sys
import time
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from portbench.work import common as work_common


def log(msg: str) -> None:
    sys.stderr.write(msg + '\n')
    sys.stderr.flush()


def process_age_s() -> float:
    """Seconds since this process started (Linux: its start time in clock
    ticks since boot against the uptime; 10 ms resolution)."""
    with open('/proc/self/stat') as f:
        fields = f.read().rsplit(')', 1)[1].split()
    with open('/proc/uptime') as f:
        uptime = float(f.read().split()[0])
    return max(0.0, uptime - int(fields[19]) / os.sysconf('SC_CLK_TCK'))


@dataclasses.dataclass
class Run:
    """One run of one cell."""
    workload: str
    seed: int
    seconds: float
    trace: bool
    config: Mapping
    mix: Mapping                 # the traffic's parameters, the cell's over them
    device: torch.device
    born: float                  # perf_counter() value at the process start
    first_timed: Optional[float] = None

    def setup_done(self) -> None:
        """Mark the start of the timed window: set-up ends here."""
        self.first_timed = time.perf_counter()

    @property
    def setup_s(self) -> float:
        return self.first_timed - self.born


def reference_family(family: str):
    return importlib.import_module(f'portbench.reference.{family}')


class Answers:
    """Every answer the window produced, per distinct input, kept as its
    elementwise least and greatest value: the largest gap of any answer
    from the reference is then the larger gap of these two."""

    def __init__(self, n: int):
        self.lo: List[Optional[np.ndarray]] = [None] * n
        self.hi: List[Optional[np.ndarray]] = [None] * n

    def add(self, index: int, logits: np.ndarray) -> None:
        if self.lo[index] is None:
            self.lo[index] = logits.copy()
            self.hi[index] = logits.copy()
        else:
            np.minimum(self.lo[index], logits, out=self.lo[index])
            np.maximum(self.hi[index], logits, out=self.hi[index])

    def max_gap(self, ref: Mapping[int, np.ndarray]) -> float:
        gap = 0.0
        for i, r in ref.items():
            if self.lo[i] is not None:
                gap = max(gap, float(np.max(np.abs(self.lo[i] - r))),
                          float(np.max(np.abs(self.hi[i] - r))))
        return gap


def reference_logits(config: Mapping, tensors, images: np.ndarray,
                     indices, device, input_mode='float32',
                     block: int = 32) -> Dict[int, np.ndarray]:
    """The reference's logits of ``images[i]`` for each i in ``indices``,
    in blocks of ``block`` images on ``device``."""
    fam = reference_family(config['family'])
    out = {}
    indices = list(indices)
    with torch.no_grad():
        for k in range(0, len(indices), block):
            part = indices[k:k + block]
            x = torch.from_numpy(images[part]).to(device)
            y = fam.forward(config, tensors, x, input_mode).cpu().numpy()
            out.update(zip(part, y))
    return out


def release() -> None:
    """Return the memory of the program's dropped state before the
    reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def memory_peak(device: torch.device) -> int:
    if device.type != 'cuda':
        return 0
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))


def sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def work_record(config: Mapping, batch: int) -> Dict[str, float]:
    """Operations and roofline bound of one forward at ``batch``."""
    return dict(ops_per_forward=work_common.forward_ops(config, batch),
                bound_s_per_forward=work_common.forward_bound_s(config, batch))


def card_info(device: torch.device) -> Dict[str, object]:
    """Name, count, power limit and clocks of the card, and the host's CPU
    (for the log lines before the result)."""
    info: Dict[str, object] = {}
    if device.type == 'cuda':
        info['kind'] = torch.cuda.get_device_name(device)
        info['count'] = torch.cuda.device_count()
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit,clocks.sm,'
             'clocks.max.sm,clocks.mem', '--format=csv,noheader'],
            capture_output=True, text=True, timeout=20)
        info['nvidia_smi'] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        info['nvidia_smi'] = f'unavailable ({e})'
    try:
        with open('/proc/cpuinfo') as f:
            info['cpu'] = next((l.split(':', 1)[1].strip() for l in f
                                if l.startswith('model name')), '?')
    except OSError:
        info['cpu'] = '?'
    info['torch'] = torch.__version__
    return info
