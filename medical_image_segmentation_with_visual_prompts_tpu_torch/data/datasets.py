"""Dataset scanning, splitting and batched loading for downstream fitting
and testing and for phase-2 pretraining.

Counterpart of the JAX package's ``data/datasets.py``
(``get_fit_loader_downstream``, ``get_test_loader_downstream``,
``get_fit_loader_self_supervised_learning``,
``get_fit_loader_supervised_learning``): sorted image (and image/mask)
listing, optional subsampling WITH replacement (``random.choices``), a
shuffled split by ``split_ratio`` (downstream: two volumes split 1/1),
per-item transforms seeded from ``(seed, epoch, idx)``, and a loader that
shuffles item order per epoch and re-batches the flattened crop samples,
keeping the last partial batch for downstream and dropping it for
pretraining.  The same ``random`` and numpy draws in the same order as the JAX
loader, so one seed gives the same batches.  Items are transformed in a
thread pool ahead of the consumer; batches are dicts of numpy arrays,
channels-last.
"""

from __future__ import annotations

import math
import queue
import random
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np

from . import transforms as T


def num_samples_of(conf) -> int:
    """Crop samples per volume in the config's training mode."""
    mode = conf.training_mode
    if mode == "downstream":
        return conf.num_samples_downstream
    if mode == "self_supervised_learning_encoder":
        return conf.num_samples_multi_view
    return conf.num_samples_students_teacher


def batch_size_of(conf) -> int:
    """Batch size in the config's training mode."""
    mode = conf.training_mode
    if mode == "downstream":
        return conf.batch_size_downstream
    if mode == "self_supervised_learning_encoder":
        return conf.batch_size_multi_view
    return conf.batch_size_students_teacher


def _scan_images(image_dir, image_key="image"):
    return [{image_key: str(p), "name": p.stem}
            for p in sorted(Path(image_dir).iterdir())]


def _scan_pairs(image_dir, mask_dir, image_key="image", mask_key="mask"):
    image_paths = sorted(Path(image_dir).iterdir())
    mask_paths = sorted(Path(mask_dir).iterdir())
    return [{image_key: str(i), mask_key: str(m), "name": Path(i).stem}
            for i, m in zip(image_paths, mask_paths)]


def _rng_of(conf):
    """Data-selection RNG: seeded when the config carries a ``seed``."""
    seed = getattr(conf, "seed", None)
    return random if seed is None else random.Random(int(seed))


def _subsample(data: List[Dict], k: int, rng) -> List[Dict]:
    return data if k == -1 else rng.choices(data, k=k)


def _split(data: List[Dict], split_ratio: float, rng,
           downstream: bool = False):
    rng.shuffle(data)
    if downstream and len(data) < 2:
        raise ValueError("Not enough samples for downstream task.")
    split = 1 if downstream and len(data) == 2 else \
        math.floor(len(data) * split_ratio)
    return data[:split], data[split:]


class Dataset:
    """Transform-on-access dataset of file-path items; ``__getitem__``
    returns the LIST of crop samples of one item."""

    def __init__(self, data: List[Dict], transform: Callable,
                 seed: int = None):
        self.data = data
        self.transform = transform
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx: int) -> List[Dict]:
        if self.seed is None:
            entropy = [0, idx, random.getrandbits(31)]
        else:
            entropy = [int(self.seed), self.epoch, idx]
        rng = np.random.default_rng(np.random.SeedSequence(entropy))
        out = self.transform(self.data[idx], rng)
        return out if isinstance(out, list) else [out]


def _collate(samples: List[Dict]) -> Dict:
    return {k: (np.stack([s[k] for s in samples])
                if isinstance(samples[0][k], np.ndarray)
                else [s[k] for s in samples]) for k in samples[0]}


class DataLoader:
    """Shuffled, thread-prefetching batch iterator (in order)."""

    def __init__(self, dataset: Dataset, batch_size: int, shuffle: bool,
                 num_workers: int = 2, drop_last: bool = False,
                 prefetch: int = 2, samples_per_item: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 1)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.samples_per_item = max(samples_per_item, 1)

    def __len__(self):
        total = len(self.dataset) * self.samples_per_item
        return total // self.batch_size if self.drop_last \
            else math.ceil(total / self.batch_size)

    def _produce(self, order, q):
        try:
            buffer: List[Dict] = []
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                it = iter(order)
                futures = deque(pool.submit(self.dataset.__getitem__, idx)
                                for _, idx in zip(range(2 * self.num_workers),
                                                  it))
                while futures:
                    buffer.extend(futures.popleft().result())
                    idx = next(it, None)
                    if idx is not None:
                        futures.append(pool.submit(self.dataset.__getitem__,
                                                   idx))
                    while len(buffer) >= self.batch_size:
                        q.put(_collate(buffer[:self.batch_size]))
                        buffer = buffer[self.batch_size:]
            if buffer and not self.drop_last:
                q.put(_collate(buffer))
        except Exception as e:      # handed to the consumer, raised there
            q.put(e)
        finally:
            q.put(None)

    def __iter__(self):
        self.dataset.epoch += 1
        order = list(range(len(self.dataset)))
        if self.shuffle:
            if self.dataset.seed is None:
                random.shuffle(order)
            else:
                random.Random((int(self.dataset.seed) << 20)
                              + self.dataset.epoch).shuffle(order)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=self._produce, args=(order, q),
                             daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # Drain so the producer can finish, then wait for it.
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()


def get_fit_loader_downstream(conf):
    """(train loader, validation loader) over the downstream pairs."""
    rng = _rng_of(conf)
    data = _subsample(_scan_pairs(conf.image_dir_downstream,
                                  conf.mask_dir_downstream,
                                  conf.image_dict_key, conf.mask_dict_key),
                      conf.num_selected_data_downstream, rng)
    train_data, val_data = _split(data, conf.split_ratio, rng,
                                  downstream=True)
    seed = getattr(conf, "seed", None)

    def tf(item, item_rng):
        return T.transform_downstream_fit(item, conf, item_rng)

    def make(d):
        return DataLoader(Dataset(d, tf, seed=seed),
                          conf.batch_size_downstream, shuffle=True,
                          num_workers=conf.num_workers, drop_last=False,
                          samples_per_item=conf.num_samples_downstream)

    return make(train_data), make(val_data)


def _pretrain_loaders(conf, data):
    rng = _rng_of(conf)
    train_data, val_data = _split(data(rng), conf.split_ratio, rng)
    seed = getattr(conf, "seed", None)

    def tf(item, item_rng):
        return T.transform_pretrain_fit(item, conf, item_rng)

    def make(d):
        return DataLoader(Dataset(d, tf, seed=seed), batch_size_of(conf),
                          shuffle=True, num_workers=conf.num_workers,
                          drop_last=True,
                          samples_per_item=num_samples_of(conf))

    return make(train_data), make(val_data)


def get_fit_loader_self_supervised_learning(conf):
    """(train, validation) loaders over the pretrain images."""
    return _pretrain_loaders(conf, lambda rng: _subsample(
        _scan_images(conf.image_dir_pretrain, conf.image_dict_key),
        conf.num_selected_data_pretrain, rng))


def get_fit_loader_supervised_learning(conf):
    """(train, validation) loaders over the supervised image/mask pairs."""
    return _pretrain_loaders(conf, lambda rng: _subsample(
        _scan_pairs(conf.image_dir_supervised, conf.mask_dir_supervised,
                    conf.image_dict_key, conf.mask_dict_key),
        conf.num_selected_data_supervised, rng))


def get_test_loader_downstream(conf):
    """Whole test volume pairs, one per batch, in sorted order."""
    data = _scan_pairs(conf.image_dir_test, conf.mask_dir_test,
                       conf.image_dict_key, conf.mask_dict_key)

    def tf(item, item_rng):
        return T.transform_downstream_test(item, conf)

    return DataLoader(Dataset(data, tf, seed=getattr(conf, "seed", None)),
                      batch_size=1, shuffle=False,
                      num_workers=conf.num_workers, drop_last=False)
