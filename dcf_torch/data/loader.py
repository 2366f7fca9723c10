"""Batched training input with background prefetch, a copy of
`dcf.data.loader`: a thread pool builds static-shape examples (augment
-> pad/stack, numpy) while the card steps, with a bounded queue in
between. Each example draws from `np.random.default_rng([seed, epoch,
index])`, so a (seed, epoch, index) gives the JAX package's batch bit
for bit.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from dcf_torch.config import Config
from dcf_torch.data.augment import GTDatabase, augment_frame
from dcf_torch.data.preprocess import frame_to_example, stack_examples
from dcf_torch.utils import trace


class Loader:
    """Iterable over batched, static-shape training/eval examples."""

    def __init__(self, dataset, cfg: Config, training: bool = True,
                 batch_size: Optional[int] = None,
                 gt_db: Optional[GTDatabase] = None,
                 seed: int = 0, num_workers: int = 4,
                 prefetch: int = 4, drop_last: bool = True):
        self.dataset = dataset
        self.cfg = cfg
        self.training = training
        self.batch_size = batch_size or cfg.train.batch_size
        self.gt_db = gt_db
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _build_example(self, index: int, epoch: int, batch: int = -1
                       ) -> Dict[str, np.ndarray]:
        with trace.span("loader.example", epoch=epoch, batch=batch,
                        index=index):
            frame = self.dataset[index]
            # SeedSequence entropy list: collision-free across (seed,
            # epoch, index)
            rng = np.random.default_rng([self.seed, epoch, index])
            if self.training:
                frame = augment_frame(
                    frame, self.cfg.augment, rng, db=self.gt_db,
                    lidar_only_augs=not self.cfg.with_fusion)
            return frame_to_example(frame, self.cfg,
                                    seed=int(rng.integers(2 ** 31)))

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """One pass over the dataset (shuffled when training). Closing the
        iterator early stops and joins its producer thread."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.training:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, n, self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> None:
            with trace.span("loader.put_wait"):
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        return
                    except queue.Full:
                        continue

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b, idx_batch in enumerate(batches):
                        if stop.is_set():
                            break
                        examples = list(pool.map(
                            lambda i: self._build_example(int(i), epoch, b),
                            idx_batch))
                        put(stack_examples(examples))
            except Exception as e:          # raised in the consumer
                put(e)
                return
            put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                if trace.active():
                    trace.count("loader.queue_depth_at_get", q.qsize())
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()

    def __iter__(self):
        return self.epoch(0)


def infinite_batches(loader: Loader) -> Iterator[Dict[str, np.ndarray]]:
    """Endless stream cycling epochs (training loop consumption)."""
    epoch = 0
    while True:
        yield from loader.epoch(epoch)
        epoch += 1
