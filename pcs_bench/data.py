"""The benchmark's one traffic generator: S3DIS-shaped room blocks made
from the seed, grouped into training batches or labelling scenes as a
traffic file's parameters say.

``room_block`` is a copy of the port's ``data/toy.py:synthetic_room_block``
(a third of the points on a floor, a third on a wall, the rest spread
through the block; labels follow position and the first feature), kept
here so that a change to the program cannot change the inputs.  Every
block has exactly ``points_per_block`` points, all valid, so the work of a
step does not depend on the seed."""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def rng_for(seed: int, stream: int) -> np.random.RandomState:
    """A numpy generator for stream ``stream`` of run seed ``seed`` (any
    whole number: it is hashed to 32 bits)."""
    s = np.random.SeedSequence([seed & (2 ** 64 - 1), stream])
    return np.random.RandomState(int(s.generate_state(1)[0]))


def room_block(rng: np.random.RandomState, n: int, num_classes: int,
               feat_dim: int, block: float, floor_share: float,
               wall_share: float) -> Dict[str, np.ndarray]:
    """One block of ``n`` points: xyz [n, 3] in [-block/2, block/2],
    feats [n, feat_dim] in [-1, 1], labels [n] int32, mask [n] all True."""
    n_floor, n_wall = int(n * floor_share), int(n * wall_share)
    n_rest = n - n_floor - n_wall
    floor = rng.uniform(-block / 2, block / 2, (n_floor, 3))
    floor[:, 2] = 0.02 * rng.randn(n_floor)
    wall = rng.uniform(-block / 2, block / 2, (n_wall, 3))
    wall[:, 0] = block / 2 - 0.05 + 0.02 * rng.randn(n_wall)
    rest = rng.uniform(-block / 2, block / 2, (n_rest, 3))
    xyz = np.concatenate([floor, wall, rest], 0).astype(np.float32)
    feats = rng.rand(n, feat_dim).astype(np.float32) * 2 - 1
    region = (np.floor(xyz[:, 0] + block / 2) * 3
              + np.floor(xyz[:, 2] + 1.0)).astype(np.int32)
    feat_bit = (feats[:, 0] > 0) if feat_dim > 0 else 0
    labels = ((region + feat_bit) % num_classes).astype(np.int32)
    perm = rng.permutation(n)
    return {"xyz": xyz[perm], "feats": feats[perm], "labels": labels[perm],
            "mask": np.ones(n, bool)}


def _blocks(cfg: Dict, traffic: Dict, rng: np.random.RandomState,
            count: int) -> List[Dict[str, np.ndarray]]:
    room = traffic["room"]
    return [room_block(rng, traffic["points_per_block"], cfg["num_classes"],
                       cfg["feat_dim"], cfg["block_size"],
                       room["floor_share"], room["wall_share"])
            for _ in range(count)]


def train_batches(cfg: Dict, traffic: Dict,
                  seed: int) -> List[Dict[str, np.ndarray]]:
    """``traffic["batches"]`` batches of ``blocks_per_step`` blocks, every
    block different: dicts of [B, N, ...] arrays."""
    rng = rng_for(seed, 1)
    out = []
    for _ in range(traffic["batches"]):
        blocks = _blocks(cfg, traffic, rng, traffic["blocks_per_step"])
        out.append({k: np.stack([b[k] for b in blocks]) for k in blocks[0]})
    return out


def scenes(cfg: Dict, traffic: Dict,
           seed: int) -> List[List[Dict[str, np.ndarray]]]:
    """``traffic["scenes"]`` scenes of ``blocks_per_scene`` blocks; block i
    of a scene carries ``block_min`` = i * ``block_stride``."""
    rng = rng_for(seed, 2)
    stride = np.asarray(traffic["block_stride"], np.float32)
    out = []
    for _ in range(traffic["scenes"]):
        blocks = _blocks(cfg, traffic, rng, traffic["blocks_per_scene"])
        for i, b in enumerate(blocks):
            b["block_min"] = (i * stride).astype(np.float32)
        out.append(blocks)
    return out
