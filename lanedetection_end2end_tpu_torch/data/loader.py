"""Input pipeline: deterministic splits, threaded host loading, and
prefetch onto the card.

Counterpart of `lanedetection_end2end_tpu/data/loader.py`: the same
`split_indices`, `collate`, `Loader` (seeded shuffle and flips per epoch,
`pad_final`, `num_real`), `get_loader` and `get_testloader`, so the same
seed, epoch and flip give the same batches. In place of the JAX package's
`DevicePrefetcher`, `DevicePrefetcher` here pins each host batch and copies
it to the card with `non_blocking=True` on a side stream, `depth` batches
ahead, and the consumer's stream waits on the copy's event before use; on
the CPU the batches pass through as tensors. One process:
`process_index` / `process_count` stay for multi-device data parallelism,
which the port does not run yet.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch


# ----------------------------------------------------------------------
# Deterministic split (Load_Data_new.py:293-308 BEV / :255-270 BP)
# ----------------------------------------------------------------------

def split_indices(num_train: int, split_percentage: float = 0.2,
                  shuffle: bool = True) -> Tuple[List[int], List[int]]:
    """Reference-identical train/val split.

    Seeds the legacy MT19937 stream with `num_train` and shuffles — the exact
    permutation of `np.random.seed(num_train); np.random.shuffle(indices)`
    (Load_Data_new.py:301-303) without touching global RNG state. First
    `split` indices are validation.
    """
    indices = np.arange(num_train)
    split = int(np.floor(split_percentage * num_train))
    if shuffle:
        np.random.RandomState(num_train).shuffle(indices)
    return list(map(int, indices[split:])), list(map(int, indices[:split]))


def _truncate_to_batches(idx: Sequence[int], batch_size: int) -> List[int]:
    """Static-shape guarantee: drop the ragged tail (BEV truncates the index
    lists, Load_Data_new.py:305-306; BP uses drop_last=True, :284-288 — both
    reduce to this)."""
    n = len(idx) // batch_size * batch_size
    return list(idx[:n])


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of fixed-shape sample dicts into one batch dict."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


# ----------------------------------------------------------------------
# Threaded loader
# ----------------------------------------------------------------------

class Loader:
    """Epoch-based batch iterator over a `LaneDataset`-like dataset.

    Args:
      dataset: object with `__len__` and `__getitem__(i, *, flip=bool)`.
      indices: dataset indices this loader draws from.
      batch_size: static batch size (ragged tail dropped).
      shuffle: reshuffle per epoch (train) or keep sequential (validation —
        the BP tree's SequentialIndicesSampler, Load_Data_new.py:245-253).
      flip: enable random horizontal flips (train only).
      nworkers: decode thread-pool width.
      seed: base seed; epoch e uses seed+e so runs are reproducible.
      process_index/process_count: input sharding over processes.
        `batch_size` is the GLOBAL batch; every process computes the
        identical epoch permutation (same seed) and decodes only its
        contiguous `batch_size/process_count` slice of each batch.
        Defaults to 0 / 1: one process loads the full batch.
    """

    def __init__(self, dataset, indices: Sequence[int], batch_size: int,
                 shuffle: bool = True, flip: bool = False, nworkers: int = 8,
                 seed: int = 0, pad_final: bool = False,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.dataset = dataset
        self.num_real = len(indices)
        indices = list(indices)
        if pad_final and indices and len(indices) % batch_size:
            # Static shapes without dropping data: repeat the final sample
            # (test-set inference; callers slice predictions to `num_real`).
            indices = indices + [indices[-1]] * (
                batch_size - len(indices) % batch_size)
        self.indices = _truncate_to_batches(indices, batch_size)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.flip = flip
        # more decode threads than cores thrash (the decode path is
        # CPU-bound; ctypes/PIL release the GIL but cannot mint cores)
        self.nworkers = max(1, min(nworkers, os.cpu_count() or nworkers))
        self.seed = seed
        self._epoch = 0
        self.process_index = 0 if process_index is None else process_index
        self.process_count = 1 if process_count is None else process_count
        if batch_size % self.process_count:
            raise ValueError(
                f"global batch_size {batch_size} must divide evenly over "
                f"{self.process_count} processes")
        self.local_batch_size = batch_size // self.process_count

    def __len__(self) -> int:
        return len(self.indices) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _local_slice(self, b: int) -> slice:
        """This process's contiguous rows of global batch `b`: process p
        owns rows [p*local : (p+1)*local)."""
        start = b * self.batch_size + self.process_index * self.local_batch_size
        return slice(start, start + self.local_batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # The permutation and flip draws are computed identically on every
        # process (same seed), so the global batch composition is agreed on
        # before each process fetches only its local rows.
        rng = np.random.RandomState(self.seed + self._epoch)
        order = np.array(self.indices)
        if self.shuffle:
            rng.shuffle(order)
        flips = (rng.uniform(0.0, 1.0, size=len(order)) > 0.5) & self.flip

        def fetch(args):
            i, f = args
            return self.dataset.__getitem__(int(i), flip=bool(f))

        nb = len(order) // self.batch_size
        if self.nworkers == 1:
            # single worker: decode inline, a one-thread pool only adds GIL
            # convoying against the consumer
            for b in range(nb):
                sl = self._local_slice(b)
                yield collate([fetch(a) for a in zip(order[sl], flips[sl])])
            return
        with ThreadPoolExecutor(self.nworkers) as pool:
            # Pipelined: submit batch k+1 while batch k is being consumed.
            pending = collections.deque()
            for b in range(min(2, nb)):
                sl = self._local_slice(b)
                pending.append(pool.map(fetch, zip(order[sl], flips[sl])))
            for b in range(nb):
                samples = list(pending.popleft())
                nxt = b + 2
                if nxt < nb:
                    sl = self._local_slice(nxt)
                    pending.append(pool.map(fetch, zip(order[sl], flips[sl])))
                yield collate(samples)


# ----------------------------------------------------------------------
# Device prefetch
# ----------------------------------------------------------------------

def to_tensors(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A collated numpy batch as CPU tensors (no copy)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


class DevicePrefetcher:
    """Moves host batches onto `device` ahead of their use.

    On a card: a background thread pins each batch and copies it with
    `non_blocking=True` on a side stream, recording an event after the
    copies, with up to `depth` (at least 1) batches in flight;
    `__next__` makes the consumer's current stream wait on the batch's
    event (and marks the batch's tensors as used on that stream, so the
    allocator does not hand their memory to the side stream early). On
    the CPU the batches pass through as tensors.
    """

    def __init__(self, it: Iterable[Dict[str, np.ndarray]],
                 device: torch.device, depth: int = 2):
        self._it = iter(it)
        self._device = torch.device(device)
        self._done = object()
        if self._device.type != "cuda":
            self._thread = None
            return
        self._stream = torch.cuda.Stream(self._device)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, batch):
        host = {k: v.pin_memory() for k, v in to_tensors(batch).items()}
        with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
            out = {k: v.to(self._device, non_blocking=True)
                   for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _run(self):
        try:
            for batch in self._it:
                self._q.put(self._put(batch))
        except BaseException as e:  # handed to the consumer, re-raised there
            self._q.put(e)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        if self._thread is None:
            return to_tensors(next(self._it))
        item = self._q.get()
        if isinstance(item, BaseException):
            raise item
        if item is self._done:
            raise StopIteration
        batch, event = item
        stream = torch.cuda.current_stream(self._device)
        stream.wait_event(event)
        for v in batch.values():
            v.record_stream(stream)
        return batch


# ----------------------------------------------------------------------
# Factories mirroring the reference entry points
# ----------------------------------------------------------------------

def get_loader(dataset_factory, num_train: int, batch_size: int,
               val_batch_size: Optional[int] = None, shuffle: bool = True,
               nworkers: int = 8, flip_on: bool = False,
               split_percentage: float = 0.2, seed: int = 0
               ) -> Tuple[Loader, Loader, List[int]]:
    """Split + build train/val loaders.

    Parity with `get_loader` (Load_Data_new.py:293-326 BEV / :255-290 BP).
    `dataset_factory(valid_idx)` builds the dataset (it needs the validation
    indices to suppress flips on validation images).
    """
    train_idx, valid_idx = split_indices(num_train, split_percentage, shuffle)
    dataset = dataset_factory(valid_idx)
    train_loader = Loader(dataset, train_idx, batch_size, shuffle=True,
                          flip=flip_on, nworkers=nworkers, seed=seed)
    valid_loader = Loader(dataset, valid_idx,
                          val_batch_size or batch_size, shuffle=False,
                          flip=False, nworkers=nworkers, seed=seed)
    return train_loader, valid_loader, valid_idx


def get_testloader(test_set, batch_size: int, nworkers: int = 8) -> Loader:
    """Sequential loader over a `LaneTestSet`
    (Backprojection_Loss/Load_Data_new.py:29-40). The final ragged batch is
    padded by repeating the last image (drop_last=False semantics with static
    shapes); callers slice predictions to `loader.num_real`."""
    return Loader(test_set, range(len(test_set)), batch_size, shuffle=False,
                  flip=False, nworkers=nworkers, pad_final=True)
