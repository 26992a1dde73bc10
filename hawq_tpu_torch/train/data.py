"""Input pipelines: ImageNet-style folder loading, CIFAR-10 and synthetic
data (the port's copy of hawq_tpu/train/data.py; numpy and PIL only).

  * ImageFolder train/val pipelines with RandomResizedCrop/flip and
    Resize(256)/CenterCrop(224), mean/std normalize;
  * the ``data_percentage`` subset;
  * synthetic uniform images and labels from a seed.

Loaders yield fixed-shape NHWC numpy batches on the host; the trainer moves
them to its device.  With several processes each reads its own stripe (pass
process_index/process_count).  JPEG decode + resize run in a thread pool
over PIL.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


# ---------------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------------

def synthetic_batches(batch_size: int, image_size: int = 224,
                      num_classes: int = 1000, n_batches: int = 0,
                      seed: int = 0) -> Iterator[dict]:
    """Uniform random images + labels; n_batches=0 → infinite."""
    rng = np.random.RandomState(seed)
    i = 0
    while n_batches == 0 or i < n_batches:
        yield {
            'image': rng.uniform(-1, 1, (batch_size, image_size, image_size,
                                         3)).astype(np.float32),
            'label': rng.randint(0, num_classes, (batch_size,)),
        }
        i += 1


# ---------------------------------------------------------------------------
# CIFAR-10
# ---------------------------------------------------------------------------

CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


def _load_cifar10_split(root: str, train: bool
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Read the standard python-pickle batch files from a local directory
    (cifar-10-batches-py layout; nothing is downloaded)."""
    import pickle
    names = ([f'data_batch_{i}' for i in range(1, 6)] if train
             else ['test_batch'])
    images, labels = [], []
    for name in names:
        path = os.path.join(root, name)
        if not os.path.exists(path):
            alt = os.path.join(root, 'cifar-10-batches-py', name)
            path = alt if os.path.exists(alt) else path
        with open(path, 'rb') as f:
            d = pickle.load(f, encoding='latin1')
        images.append(np.asarray(d['data'], np.uint8))
        labels.append(np.asarray(d['labels'], np.int32))
    x = np.concatenate(images).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return x, np.concatenate(labels)


def cifar10_batches(root: str, batch_size: int, *, train: bool,
                    n_epochs: int = 1, seed: int = 0,
                    data_percentage: float = 1.0,
                    process_index: int = 0,
                    process_count: int = 1) -> Iterator[dict]:
    """Fixed-shape NHWC float batches: pad-4 random crop + flip (train) or
    plain normalize (eval), CIFAR mean/std.  Per-host striping as in the
    ImageFolder pipeline; incomplete trailing batches are dropped."""
    x, y = _load_cifar10_split(root, train)
    rng = np.random.RandomState(seed)
    if data_percentage < 1.0:
        keep = rng.permutation(len(x))[:max(1, int(len(x) * data_percentage))]
        x, y = x[keep], y[keep]
    x, y = x[process_index::process_count], y[process_index::process_count]

    for epoch in range(n_epochs):
        order = (np.random.RandomState(seed + epoch).permutation(len(x))
                 if train else np.arange(len(x)))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[i:i + batch_size]
            batch = x[idx].astype(np.float32) / 255.0
            if train:
                padded = np.pad(batch, ((0, 0), (4, 4), (4, 4), (0, 0)),
                                mode='reflect')
                out = np.empty_like(batch)
                for b in range(len(batch)):
                    dy, dx = rng.randint(0, 9, 2)
                    img = padded[b, dy:dy + 32, dx:dx + 32]
                    if rng.rand() < 0.5:
                        img = img[:, ::-1]
                    out[b] = img
                batch = out
            batch = (batch - CIFAR10_MEAN) / CIFAR10_STD
            yield {'image': batch, 'label': y[idx].astype(np.int64)}


# ---------------------------------------------------------------------------
# ImageFolder pipeline
# ---------------------------------------------------------------------------

def _list_image_folder(root: str) -> Tuple[List[str], List[int], List[str]]:
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    paths, labels = [], []
    for idx, c in enumerate(classes):
        cdir = os.path.join(root, c)
        for fn in sorted(os.listdir(cdir)):
            if fn.lower().endswith(('.jpg', '.jpeg', '.png', '.bmp')):
                paths.append(os.path.join(cdir, fn))
                labels.append(idx)
    return paths, labels, classes


def _load_train_image(path: str, size: int, rng: np.random.RandomState
                      ) -> np.ndarray:
    """RandomResizedCrop(size) + horizontal flip + normalize."""
    from PIL import Image
    img = Image.open(path).convert('RGB')
    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = rng.uniform(0.08, 1.0) * area
        ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw = int(round(np.sqrt(target_area * ar)))
        ch = int(round(np.sqrt(target_area / ar)))
        if cw <= w and ch <= h:
            x0 = rng.randint(0, w - cw + 1)
            y0 = rng.randint(0, h - ch + 1)
            img = img.crop((x0, y0, x0 + cw, y0 + ch))
            break
    else:
        s = min(w, h)
        img = img.crop(((w - s) // 2, (h - s) // 2,
                        (w + s) // 2, (h + s) // 2))
    img = img.resize((size, size), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    if rng.rand() < 0.5:
        arr = arr[:, ::-1]
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def _load_eval_image(path: str, size: int, resize: int) -> np.ndarray:
    """Resize(resize) + CenterCrop(size) + normalize."""
    from PIL import Image
    img = Image.open(path).convert('RGB')
    w, h = img.size
    if w < h:
        nw, nh = resize, int(h * resize / w)
    else:
        nw, nh = int(w * resize / h), resize
    img = img.resize((nw, nh), Image.BILINEAR)
    x0, y0 = (nw - size) // 2, (nh - size) // 2
    img = img.crop((x0, y0, x0 + size, y0 + size))
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


class ImageFolderLoader:
    """Threaded ImageFolder loader yielding fixed-shape NHWC batches.

    Per-host sharding: pass process_index/process_count and each host reads
    a disjoint stripe of the (shuffled) file list.
    """

    def __init__(self, root: str, batch_size: int, *, train: bool,
                 image_size: int = 224, eval_resize: int = 256,
                 data_percentage: float = 1.0, num_workers: int = 4,
                 prefetch: int = 4, seed: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 drop_remainder: bool = True):
        self.paths, self.labels, self.classes = _list_image_folder(root)
        if data_percentage < 1.0:
            rng = np.random.RandomState(seed)
            n = max(1, int(len(self.paths) * data_percentage))
            keep = rng.permutation(len(self.paths))[:n]
            self.paths = [self.paths[i] for i in keep]
            self.labels = [self.labels[i] for i in keep]
        self.batch_size = batch_size
        self.train = train
        self.image_size = image_size
        self.eval_resize = eval_resize
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.drop_remainder = drop_remainder

    def __len__(self):
        n = len(self.paths) // self.process_count
        return n // self.batch_size if self.drop_remainder else \
            -(-n // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        order = np.arange(len(self.paths))
        if self.train:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        order = order[self.process_index::self.process_count]

        rng = np.random.RandomState(self.seed * 131 + epoch)

        def load(i: int):
            path = self.paths[i]
            if self.train:
                img = _load_train_image(path, self.image_size,
                                        np.random.RandomState(
                                            rng.randint(2 ** 31)))
            else:
                img = _load_eval_image(path, self.image_size,
                                       self.eval_resize)
            return img, self.labels[i]

        with ThreadPoolExecutor(self.num_workers) as pool:
            batch_idx = [order[i:i + self.batch_size]
                         for i in range(0, len(order), self.batch_size)]
            if self.drop_remainder:
                batch_idx = [b for b in batch_idx
                             if len(b) == self.batch_size]
            # pipeline: keep `prefetch` batches in flight
            pending = []
            it = iter(batch_idx)
            for _ in range(self.prefetch):
                b = next(it, None)
                if b is not None:
                    pending.append([pool.submit(load, i) for i in b])
            while pending:
                futs = pending.pop(0)
                b = next(it, None)
                if b is not None:
                    pending.append([pool.submit(load, i) for i in b])
                results = [f.result() for f in futs]
                yield {
                    'image': np.stack([r[0] for r in results]),
                    'label': np.array([r[1] for r in results]),
                }
