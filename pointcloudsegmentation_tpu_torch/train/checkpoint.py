"""Checkpoints of the port's trainer (the API of
``pointcloudsegmentation_tpu.train.checkpoint``, without Orbax): per-epoch
saves with retention, plus the best-k by eval mIoU in ``best/``.

A save snapshots the state to host memory first and writes it in a
background thread, so the epoch loop never waits on the disk; ``wait()``
(and every restore or query) drains pending writes and re-raises a failed
one.  Each checkpoint is one ``torch.save`` file of the flat params, the
Adam moments and count, and the step; files are written to a temporary
name and renamed, so a crash never leaves a torn checkpoint."""
from __future__ import annotations

import json
import os
import re
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional

import torch

from .loop import TrainState

_NAME = re.compile(r"^epoch_(\d+)\.pt$")


def _snapshot(state: TrainState) -> Dict:
    return {"step": int(state.step), "count": int(state.count),
            "params": state.params.detach().to("cpu", copy=True),
            "mu": state.mu.detach().to("cpu", copy=True),
            "nu": state.nu.detach().to("cpu", copy=True)}


def _write(path: str, snap: Dict) -> None:
    tmp = f"{path}.tmp"
    torch.save(snap, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 500, best_keep: int = 3):
        if keep < 1 or best_keep < 1:
            raise ValueError("keep and best_keep must be at least 1")
        self._dir = os.path.abspath(directory)
        self._best_dir = os.path.join(self._dir, "best")
        os.makedirs(self._best_dir, exist_ok=True)
        self._keep, self._best_keep = keep, best_keep
        self._index = os.path.join(self._best_dir, "miou.json")
        self._best: Dict[int, float] = {}
        if os.path.exists(self._index):
            with open(self._index) as f:
                self._best = {int(k): float(v) for k, v in json.load(f)
                              .items()}
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(1)   # one writer: saves in order
        self._pending: List[Future] = []

    def _path(self, epoch: int, best: bool = False) -> str:
        return os.path.join(self._best_dir if best else self._dir,
                            f"epoch_{epoch:06d}.pt")

    @staticmethod
    def _epochs(directory: str) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(directory))
                      if m)

    def _save_now(self, epoch: int, snap: Dict,
                  miou: Optional[float]) -> None:
        _write(self._path(epoch), snap)
        for old in self._epochs(self._dir)[:-self._keep]:
            os.remove(self._path(old))
        if miou is None:
            return
        with self._lock:
            self._best[epoch] = miou
            # best first; among equal mIoU the earlier epoch ranks higher
            ranked = sorted(self._best, key=lambda e: (-self._best[e], e))
            kept = set(ranked[:self._best_keep])
            if epoch in kept:
                _write(self._path(epoch, best=True), snap)
            for e in list(self._best):
                if e not in kept:
                    del self._best[e]
                    if os.path.exists(self._path(e, best=True)):
                        os.remove(self._path(e, best=True))
            tmp = f"{self._index}.tmp"
            with open(tmp, "w") as f:
                json.dump({str(e): v for e, v in self._best.items()}, f)
            os.replace(tmp, self._index)

    def save(self, epoch: int, state: TrainState,
             metrics: Optional[Dict[str, float]] = None) -> None:
        """Snapshot ``state`` to host memory now; write it in the
        background (and into ``best/`` if ``metrics['miou']`` ranks among
        the best ``best_keep``)."""
        snap = _snapshot(state)
        miou = None if metrics is None or "miou" not in metrics \
            else float(metrics["miou"])
        self._pending.append(self._pool.submit(self._save_now, epoch, snap,
                                               miou))

    def wait(self) -> None:
        """Drain pending writes; re-raises the first that failed."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def _load(self, path: str, state_like: Optional[TrainState],
              device) -> TrainState:
        snap = torch.load(path, map_location="cpu", weights_only=True)
        if device is None:
            device = "cpu" if state_like is None else state_like.params.device
        state = TrainState(step=snap["step"], params=snap["params"],
                           mu=snap["mu"], nu=snap["nu"],
                           count=torch.tensor(snap["count"],
                                              dtype=torch.int32))
        if state_like is not None and \
                state.params.shape != state_like.params.shape:
            raise ValueError(f"{path} holds {tuple(state.params.shape)} "
                             f"params, expected "
                             f"{tuple(state_like.params.shape)}")
        return state.to(device)

    def restore(self, state_like: Optional[TrainState] = None,
                epoch: Optional[int] = None, device=None) -> TrainState:
        """The checkpoint of ``epoch`` (default: the latest), on
        ``device`` (default: ``state_like``'s, else the CPU)."""
        self.wait()
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None or not os.path.exists(self._path(epoch)):
            raise FileNotFoundError(f"no checkpoint for epoch {epoch} in "
                                    f"{self._dir}")
        return self._load(self._path(epoch), state_like, device)

    def restore_best(self, state_like: Optional[TrainState] = None,
                     device=None) -> TrainState:
        """The highest-mIoU checkpoint seen so far."""
        epoch = self.best_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no best checkpoint in {self._dir}")
        return self._load(self._path(epoch, best=True), state_like, device)

    def latest_epoch(self) -> Optional[int]:
        self.wait()
        epochs = self._epochs(self._dir)
        return epochs[-1] if epochs else None

    def best_epoch(self) -> Optional[int]:
        self.wait()
        with self._lock:
            if not self._best:
                return None
            return min(self._best, key=lambda e: (-self._best[e], e))

    def close(self) -> None:
        """Drain pending writes and stop the writer thread."""
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)
