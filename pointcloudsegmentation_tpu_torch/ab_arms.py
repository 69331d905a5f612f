"""Sequential A/B training arms in one process on one CUDA card (the
port's counterpart of ``scripts/ab_arms.py``).

    python -m pointcloudsegmentation_tpu_torch.ab_arms \
        '[{"label": "base"}, {"label": "remat", "env": {"PCS_REMAT": "1"}},
          {"label": "b8", "batch": 8}]' [--device cuda]

Each arm: {label, env?: {K: V}, batch?: int (4), points?: int (the
preset's), chunk?: int (2048), iters?: int (20), model?: str (registry
key, default the preset's), config?: "s3dis"|"scannet"|"semantic3d"}.
Method (the JAX script's, which is ``bench.py``'s): a fresh ``Trainer``
per arm with weights from ``torch.Generator`` seed 0, two
``toy_batches(kind="room")`` batches with the config's classes and
feature width moved to the device once, 3 warm steps and a host read,
then 3 chains of ``iters`` steps, each ending in one host read; the
median chain's seconds per step give the valid points of the first batch
per second.  One JSON line per arm on standard output, with the JAX keys
in the JAX order and rounding: ``label``, ``points_per_sec``,
``step_ms``, ``batch``, ``model``, ``points``, ``chains_ms``; on the
card, the card's name and power limit go to standard error first.  A
failing arm prints ``{"label", "error"}`` (its traceback to standard
error) and the later arms still run; the process then exits 1.

``env`` holds the JAX build's ``PCS_*`` switches.  The port reads no
environment variable and sets none: ``encoder_settings`` turns the names
into ``Trainer``/``build_model`` arguments by the rules the JAX build
applies (``PCS_WIN_WINDOW``, ``PCS_OV_POOL``, ``PCS_CAND_K``,
``PCS_REMAT``, ``PCS_SEL_MODE``, ``PCS_DISABLE_WINDOWED``), and raises a
``ValueError`` naming any other: the TPU lowerings and the XLA batch
strategies have no counterpart here (the port runs one per-block loop).
Default arms (config ``s3dis``, no overrides) run the flagship at
``bench.py``'s shape, as the JAX records ``results/tpu_queue_r3/*.jsonl``
do; an arm that sets config, model or points changes the workload."""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Dict, List

import torch

from .config import require_device, s3dis_config, scannet_config, \
    semantic3d_config
from .data import toy
from .data.provider import to_device
from .train.loop import Trainer
from .utils.timing import card

PRESETS = {"s3dis": s3dis_config, "scannet": scannet_config,
           "semantic3d": semantic3d_config}
WARMUP, CHAINS = 3, 3
# switches of the JAX package with no counterpart in the port, and why
NO_COUNTERPART = {
    "PCS_PALLAS_GATHER": "a TPU lowering of the gather",
    "PCS_ONEHOT_FWD": "a TPU lowering of the gather",
    "PCS_XYZ_FOLD": "a TPU lowering of the conv's xyz fold",
    "PCS_FACTORED_HEAD": "a TPU layout of the head",
    "PCS_BATCH_VMAP": "an XLA batch strategy (the port runs one per-block "
                      "loop)",
    "PCS_NO_ACCUM": "an XLA batch strategy (the port runs one per-block "
                    "loop)",
    "PCS_ACCUM_UNROLL": "an XLA batch strategy (the port runs one "
                        "per-block loop)",
}


def _win_window(v: str, kw: Dict) -> None:
    """JAX ``train/model_zoo.py:213-228``."""
    win = int(v)
    if win == 256:
        return
    if win <= 0:
        raise ValueError(f"PCS_WIN_WINDOW={win}: must be positive")
    if win % 256 == 0:
        kw["win_window"] = win
    elif 256 % win == 0:
        kw["win_window"] = kw["win_tile"] = win
    else:
        raise ValueError(
            f"PCS_WIN_WINDOW={win}: must be a multiple of the tile (256) or "
            "a divisor of it: window % tile == 0 is required by the "
            "windowed conv backward's dense overlap-add")


def _ov_pool(v: str, kw: Dict) -> None:
    """JAX ``train/model_zoo.py:235-238``."""
    pool = int(v)
    if pool < 0:
        raise ValueError(f"PCS_OV_POOL={pool}: must be >= 0")
    kw["ov_pool_size"] = pool


def _cand_k(v: str, kw: Dict) -> None:
    """JAX ``train/model_zoo.py:242-244``."""
    if int(v):
        kw["win_cand_k"] = int(v)


def _remat(v: str, kw: Dict) -> None:
    """JAX ``train/model_zoo.py:247-248``."""
    if v == "1":
        kw["remat"] = True


def _sel_mode(v: str, kw: Dict) -> None:
    """JAX ``train/model_zoo.py:250-254``."""
    if v:
        if v not in ("global", "slab"):
            raise ValueError(f"PCS_SEL_MODE={v}: must be global|slab")
        kw["sel_mode"] = v


def _disable_windowed(v: str, kw: Dict) -> None:
    """JAX ``models/pointnet.py:458``, ``ops/search.py:473``."""
    if v == "1":
        kw["windowed"] = False


SETTINGS = {"PCS_WIN_WINDOW": _win_window, "PCS_OV_POOL": _ov_pool,
            "PCS_CAND_K": _cand_k, "PCS_REMAT": _remat,
            "PCS_SEL_MODE": _sel_mode,
            "PCS_DISABLE_WINDOWED": _disable_windowed}


def encoder_settings(env: Dict) -> Dict:
    """An arm's ``env`` -> keyword arguments of ``Trainer`` (and through it
    ``build_model``); values are read as ``str(v)``, as the JAX script
    puts them into the environment.  A name without a counterpart
    raises."""
    kw = {}
    for name, value in env.items():
        if name in NO_COUNTERPART:
            raise ValueError(f"{name} has no counterpart in the port: "
                             f"{NO_COUNTERPART[name]}")
        if name not in SETTINGS:
            raise ValueError(f"{name} is not a setting ab_arms knows; "
                             f"known: {sorted(SETTINGS)}")
        SETTINGS[name](str(value), kw)
    return kw


def arm_config(arm: Dict):
    """The arm's ``TrainConfig``: its preset with ``points`` and ``model``
    applied."""
    overrides = {}
    if "points" in arm:
        overrides["data_num_points"] = int(arm["points"])
    if "model" in arm:
        overrides["model"] = arm["model"]
    return PRESETS[arm.get("config", "s3dis")](**overrides)


def arm_batches(cfg, batch: int) -> List[Dict]:
    """The arm's two host batches of room blocks (seed 0)."""
    return list(toy.toy_batches(
        2, batch_size=batch, num_points=cfg.data.num_points, kind="room",
        num_classes=cfg.data.num_classes, feat_dim=cfg.data.feat_dim))


def run_arm(arm: Dict, device="cuda") -> Dict:
    """Train one arm and return its result line's object."""
    batch = int(arm.get("batch", 4))
    chunk = int(arm.get("chunk", 2048))
    iters = int(arm.get("iters", 20))
    settings = encoder_settings(arm.get("env", {}))
    cfg = arm_config(arm)
    trainer = Trainer(cfg, device, search_chunk=chunk, **settings)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    batches = [to_device(b, device) for b in arm_batches(cfg, batch)]
    for i in range(WARMUP):
        state, m = trainer.train_step(state, batches[i % 2])
    float(m["loss"])
    valid = int(batches[0]["mask"].sum())
    chains = []
    for _ in range(CHAINS):
        t0 = time.perf_counter()
        for i in range(iters):
            state, m = trainer.train_step(state, batches[i % 2])
        float(m["loss"])
        chains.append((time.perf_counter() - t0) / iters)
    chains.sort()
    dt = chains[len(chains) // 2]
    return {"label": arm["label"], "points_per_sec": round(valid / dt, 1),
            "step_ms": round(dt * 1e3, 2), "batch": batch,
            "model": cfg.model, "points": cfg.data.num_points,
            "chains_ms": [round(c * 1e3, 2) for c in chains]}


def main(argv=None) -> int:
    """Runs the arms, each line printed as its arm ends; returns the exit
    code: 1 if any arm failed."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("arms", help="a JSON list of arms")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (tests only)")
    args = p.parse_args(argv)
    arms = json.loads(args.arms)
    device = require_device(args.device)
    if device.type == "cuda":   # standard output holds the arms' lines only
        print(f"[ab_arms] {card()}; torch {torch.__version__}",
              file=sys.stderr, flush=True)
    failed = False
    for arm in arms:
        try:
            res = run_arm(arm, device)
        except Exception as e:  # keep later arms alive past a failing arm
            traceback.print_exc()
            res = {"label": arm.get("label"), "error": repr(e)[:300]}
            failed = True
        print(json.dumps(res), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
