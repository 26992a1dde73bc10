"""Serving across cards: continuous batching of single-image requests and
an engine replicated over the local cards (port of
hawq_tpu/parallel/serving.py).

``DynamicBatcher``: a collector thread aggregates requests into fixed-size
batches (padded with zeros), applies the host transform (for example
``fold4_images``), moves the batch to the device (the ``to_device`` hook)
and dispatches the engine, which returns as soon as its kernels are
enqueued.  A completer thread fetches the logits (the ``fetch`` hook; the
copy to the host waits for the device) and answers each request, so host
work on batch i+1 overlaps device work on batch i.  Up to ``depth`` batches
are in flight.

``ServingEngine``: an engine of the port is bound to the card its weights
were uploaded to, so the engine is built once per card it serves on (by a
function such as ``functools.partial(build_resnet_engine, fm, ...)``), each
batch's rows split evenly over those replicas, each enqueued on its card's
current stream, the logits returned in row order.  Where ``hawq_tpu`` runs
one jitted program over a global mesh, so that every dispatch is a
collective of all hosts, each process here serves its own rows
(``batch_size / process_count``) on its own cards with no collective per
dispatch: a process with no traffic holds no other back.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hawq_tpu_torch.parallel import distributed
from hawq_tpu_torch.utils.timing import time_per_iter


class DynamicBatcher:
    """Aggregate single-image requests into fixed-size device batches."""

    def __init__(self, infer_fn: Callable, batch_size: int,
                 image_shape: Tuple[int, int, int],
                 max_delay_ms: float = 5.0, depth: int = 2,
                 image_dtype=np.float32,
                 host_transform: Optional[Callable] = None,
                 device='cuda', to_device: Optional[Callable] = None,
                 fetch: Optional[Callable] = None):
        self.infer_fn = infer_fn
        self.host_transform = host_transform
        self.device = torch.device(device)
        # ServingEngine's hooks: to_device splits a batch over its replicas,
        # fetch joins their logits; by default one tensor on ``device``
        self.to_device = to_device if to_device is not None else (
            lambda arr: torch.from_numpy(np.ascontiguousarray(arr)).to(
                self.device))
        self.fetch = fetch if fetch is not None else (
            lambda out: out.cpu().numpy())
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
            out = self.infer_fn(self.to_device(arr))      # async dispatch
            self._inflight.put((out, slots, n_real))

    def _complete_loop(self):
        while not self._stop.is_set():
            try:
                out, slots, n_real = self._inflight.get(timeout=0.1)
            except queue.Empty:
                continue
            logits = self.fetch(out)               # waits for the device
            for i, slot in enumerate(slots[:n_real]):
                slot.put(logits[i])

    def close(self):
        self._stop.set()
        self._collector.join(timeout=1.0)
        self._completer.join(timeout=1.0)


class ServingEngine:
    """An integer engine replicated over this process's cards.

    ``build(device=...)`` returns an engine on that device (for example
    ``functools.partial(build_resnet_engine, fm, input_mode=...,
    residual_dtype=...)``); one replica is built per card used.  On 'cuda'
    a single process uses ``n_devices`` cards from card 0 (default: all
    visible), a process of several uses ``n_devices`` (default 1) from its
    own (``distributed.local_device``); on 'cpu' ``n_devices`` replicas
    (default 1) share the CPU.  ``batch_size`` is the global batch; this
    process serves ``host_batch = batch_size / process_count`` rows of it,
    split evenly over its replicas."""

    def __init__(self, build: Callable, n_devices: Optional[int] = None,
                 batch_size: int = 64,
                 image_shape: Tuple[int, int, int] = (224, 224, 3),
                 image_dtype=np.float32,
                 host_transform: Optional[Callable] = None, device='cuda'):
        device = torch.device(device)
        world = distributed.process_count()
        if device.type == 'cuda':
            first = distributed.local_device(device).index
            if n_devices is None:
                n_devices = torch.cuda.device_count() if world == 1 else 1
            self.devices = [torch.device('cuda', (first + i)
                                         % torch.cuda.device_count())
                            for i in range(n_devices)]
        else:
            self.devices = [device] * (n_devices or 1)
        if batch_size % world or (batch_size // world) % len(self.devices):
            raise ValueError(f'ServingEngine: batch {batch_size} over {world} '
                             f'processes of {len(self.devices)} replicas')
        self.batch_size = batch_size                       # global batch
        self.host_batch = batch_size // world
        self.image_shape = image_shape
        self.image_dtype = image_dtype
        self.host_transform = host_transform
        self.replicas = [build(device=d) for d in self.devices]

    def to_device(self, arr) -> List[torch.Tensor]:
        """A host batch (numpy; its rows a multiple of the replicas) → one
        equal piece of rows on each replica's device, in row order."""
        arr = np.ascontiguousarray(arr)
        pieces = np.split(arr, len(self.devices))
        return [torch.from_numpy(p).to(d, non_blocking=True)
                for p, d in zip(pieces, self.devices)]

    def infer(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each piece through its replica, enqueued on its card's current
        stream (returns before the cards finish) → the pieces' logits."""
        out = []
        for eng, d, x in zip(self.replicas, self.devices, parts):
            with (torch.cuda.device(d) if d.type == 'cuda'
                  else contextlib.nullcontext()):
                out.append(eng(x))
        return out

    def fetch(self, out: Sequence[torch.Tensor]) -> np.ndarray:
        """The pieces' logits on the host, in row order (waits for the
        cards)."""
        return np.concatenate([o.cpu().numpy() for o in out])

    def __call__(self, images) -> np.ndarray:
        """The logits of a host batch (the host transform applied first)."""
        if self.host_transform is not None:
            images = self.host_transform(images)
        return self.fetch(self.infer(self.to_device(images)))

    def batcher(self, max_delay_ms: float = 5.0, depth: int = 2
                ) -> DynamicBatcher:
        """Continuous batcher for this process's request stream, in batches
        of ``host_batch``, through this engine's replicas."""
        return DynamicBatcher(self.infer, self.host_batch, self.image_shape,
                              max_delay_ms, depth, self.image_dtype,
                              host_transform=self.host_transform,
                              device=self.devices[0],
                              to_device=self.to_device, fetch=self.fetch)

    def throughput(self) -> float:
        """Images per second this process serves: ``host_batch`` over the
        time of one dispatch of a random batch over every replica
        (utils/timing.py; on the cards by CUDA events on the first card's
        stream, which waits for the other cards' streams at every call).
        Over several processes the engine's rate is the sum of theirs."""
        rng = np.random.RandomState(0)
        shape = (self.host_batch, *self.image_shape)
        if np.issubdtype(np.dtype(self.image_dtype), np.integer):
            host = rng.randint(0, 256, shape).astype(self.image_dtype)
        else:
            host = rng.rand(*shape).astype(self.image_dtype)
        if self.host_transform is not None:
            host = self.host_transform(host)
        parts = self.to_device(host)

        def dispatch(first):
            out = self.infer([first, *parts[1:]])
            if first.is_cuda:
                stream = torch.cuda.current_stream(first.device)
                for d in self.devices[1:]:
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(d))
                    stream.wait_event(done)
            return out

        with (torch.cuda.device(self.devices[0]) if parts[0].is_cuda
              else contextlib.nullcontext()):
            return self.host_batch / time_per_iter(dispatch, parts[0])
