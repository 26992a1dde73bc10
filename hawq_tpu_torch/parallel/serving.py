"""Continuous batching of single-image requests onto one device (port of
hawq_tpu/parallel/serving.py ``DynamicBatcher``).

A collector thread aggregates requests into fixed-size batches (padded with
zeros), applies the host transform (for example ``fold4_images``), moves the
batch to the device and dispatches the engine, which returns as soon as its
kernels are enqueued.  A completer thread fetches the logits (the copy to
the host waits for the device) and answers each request, so host work on
batch i+1 overlaps device work on batch i.  Up to ``depth`` batches are in
flight.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch


class DynamicBatcher:
    """Aggregate single-image requests into fixed-size device batches."""

    def __init__(self, infer_fn: Callable, batch_size: int,
                 image_shape: Tuple[int, int, int],
                 max_delay_ms: float = 5.0, depth: int = 2,
                 image_dtype=np.float32,
                 host_transform: Optional[Callable] = None,
                 device='cuda'):
        self.infer_fn = infer_fn
        self.host_transform = host_transform
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.image_shape = image_shape
        self.image_dtype = image_dtype
        self.max_delay_s = max_delay_ms / 1e3
        self.depth = depth
        self._requests: 'queue.Queue[Tuple[np.ndarray, object]]' = queue.Queue()
        self._inflight: 'queue.Queue' = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._collector = threading.Thread(target=self._collect_loop,
                                           daemon=True)
        self._completer = threading.Thread(target=self._complete_loop,
                                           daemon=True)
        self._collector.start()
        self._completer.start()

    def submit(self, image: np.ndarray) -> 'queue.Queue':
        """Submit one image; returns a single-slot queue yielding the logits."""
        slot: 'queue.Queue' = queue.Queue(maxsize=1)
        self._requests.put((image, slot))
        return slot

    def _collect_loop(self):
        while not self._stop.is_set():
            batch: List[np.ndarray] = []
            slots: List[object] = []
            deadline = None
            while len(batch) < self.batch_size:
                timeout = None if deadline is None else \
                    max(deadline - time.perf_counter(), 0.0)
                try:
                    img, slot = self._requests.get(timeout=timeout or 0.05)
                except queue.Empty:
                    if batch and deadline is not None and \
                            time.perf_counter() >= deadline:
                        break
                    if self._stop.is_set():
                        return
                    continue
                batch.append(img)
                slots.append(slot)
                if deadline is None:
                    deadline = time.perf_counter() + self.max_delay_s
            if not batch:
                continue
            n_real = len(batch)
            while len(batch) < self.batch_size:          # pad to static shape
                batch.append(np.zeros(self.image_shape, self.image_dtype))
            arr = np.stack(batch)
            if self.host_transform is not None:
                arr = self.host_transform(arr)
            x = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
            out = self.infer_fn(x)                        # async dispatch
            self._inflight.put((out, slots, n_real))

    def _complete_loop(self):
        while not self._stop.is_set():
            try:
                out, slots, n_real = self._inflight.get(timeout=0.1)
            except queue.Empty:
                continue
            logits = out.cpu().numpy()                    # waits for the device
            for i, slot in enumerate(slots[:n_real]):
                slot.put(logits[i])

    def close(self):
        self._stop.set()
        self._collector.join(timeout=1.0)
        self._completer.join(timeout=1.0)
