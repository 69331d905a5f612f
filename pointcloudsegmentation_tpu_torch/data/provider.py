"""Background-thread data provider and host -> device batch transfer
(mirror of ``pointcloudsegmentation_tpu.data.provider``).

``Provider`` rebuilds the reference's provider (provider.py:43-169): a
producer thread reads and preprocesses one file ahead, the consumer iterates
batches that may span file boundaries, and train mode shuffles the file order
and the blocks within a file.  Blocks are padded to static shapes and stacked
to [B, ...] numpy arrays; the same seed gives the JAX package's batches.
An exception in the producer (a bad pkl, a native library that did not
build) is raised by the consumer, where the JAX Provider ends the epoch
early.  Blocks of the dense pipeline carry their dense cloud padded to
``dense_num_points`` (``dense_*``), blocks of the context pipeline their
context cloud padded to ``ctx_num_points`` (``ctx_*``, the context
indices riding the block's subsample).  ``device_prefetch`` moves the
batches to the card.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, List, Optional, \
    Sequence

import numpy as np
import torch

from ..models.context import CTX_CAP
from .batching import pad_fields, stack_blocks

_STOP = object()
# the dense cloud's static capacity, in block point budgets
DENSE_FACTOR = 4


class _Failed:
    """The producer's exception, queued for the consumer to raise."""

    def __init__(self, error: BaseException):
        self.error = error


class Provider:
    """file_list + read_fn(model, filename) -> list of block dicts
    (keys xyz/feats/labels), served as stacked static-shape batches."""

    def __init__(self, file_list: Sequence[str], model: str, batch_size: int,
                 read_fn: Callable[[str, str], List[Dict]], num_points: int,
                 seed: int = 0, max_queue: int = 4,
                 dense_num_points: int = 0,
                 ctx_num_points: int = CTX_CAP):
        assert model in ("train", "test")
        self.file_list = list(file_list)
        self.model = model
        self.batch_size = batch_size
        self.read_fn = read_fn
        self.num_points = num_points
        # static capacity for the dense cloud of dense-pipeline blocks
        # (read_fns yielding dense_xyz/dense_feats); 0 = DENSE_FACTOR x
        # num_points
        self.dense_num_points = dense_num_points or DENSE_FACTOR * num_points
        # static capacity for context sub-clouds (read_fns yielding ctx_*):
        # the context model's cap, 512, covers a 50 m window at 5 m voxels
        # with z slack
        self.ctx_num_points = ctx_num_points
        self.rng = np.random.RandomState(seed)
        self.max_queue = max_queue
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- producer ---------------------------------------------------------
    def _run(self):
        files = list(self.file_list)
        if self.model == "train":
            self.rng.shuffle(files)
        pending: List[Dict] = []
        try:
            for fn in files:
                if self._stop.is_set():
                    return
                blocks = self.read_fn(self.model, fn)
                if self.model == "train":
                    order = self.rng.permutation(len(blocks))
                    blocks = [blocks[i] for i in order]
                for b in blocks:
                    pending.append(self._pad(b))
                    if len(pending) == self.batch_size:
                        self._q.put(stack_blocks(pending))
                        pending = []
            if pending:
                # final partial batch: train resamples to full size; test
                # pads with fully-masked blocks so IoU never double-counts
                self._q.put(stack_blocks(pending, self.batch_size, self.rng,
                                         pad_masked=self.model == "test"))
        except BaseException as e:
            # handed to the consumer, which raises it: a failed read must
            # not end the epoch early as if the files had run out
            self._q.put(_Failed(e))
        finally:
            self._q.put(_STOP)

    def _pad(self, b: Dict) -> Dict:
        """One block padded to the static shapes (``pad_fields``)."""
        return pad_fields(b, self.num_points, self.dense_num_points,
                          self.ctx_num_points, self.rng)

    # -- consumer ---------------------------------------------------------
    def __iter__(self) -> Iterator[Dict]:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        while True:
            item = self._q.get()
            if item is _STOP:
                break
            if isinstance(item, _Failed):
                self._thread.join()
                raise item.error
            yield item
        self._thread.join()

    def close(self):
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)


def to_device(batch: Dict, device) -> Dict:
    """Every array of ``batch`` (numpy or tensor) as a tensor on ``device``;
    other values pass through.  Host arrays bound for a CUDA device are
    pinned and copied with ``non_blocking``, so the copy overlaps the work
    already queued on the card."""
    device = torch.device(device)
    out = {}
    for key, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        if isinstance(v, torch.Tensor) and v.device != device:
            if device.type == "cuda" and v.device.type == "cpu":
                v = v.pin_memory().to(device, non_blocking=True)
            else:
                v = v.to(device)
        out[key] = v
    return out


def device_prefetch(batches: Iterable[Dict], device) -> Iterator[Dict]:
    """Yield ``batches`` on ``device`` with the next batch's transfer
    issued before the consumer gets the current one."""
    ahead = None
    for b in batches:
        moved = to_device(b, device)
        if ahead is not None:
            yield ahead
        ahead = moved
    if ahead is not None:
        yield ahead
