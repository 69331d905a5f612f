"""Device profile of a training step on one CUDA card.

    python -m pointcloudsegmentation_tpu_torch.profile_train \
        [--config s3dis|semantic3d] [--model KEY]

Run from the root of a checkout.  Builds ``--model`` (default the config's
own: the flagship ``pointnet_s3dis`` under ``s3dis``) at full width (bf16
compute, weights from ``torch.Generator`` seed 0, the config's class
weights) and feeds it steps of 4 blocks: under ``s3dis`` of 8192 points
(``toy.toy_batches``, seed 0), as ``chip_smoke.py`` phases 7, 10 and 11
do; under ``semantic3d`` (any of its keys, ``dense_semantic3d`` and
``context_semantic3d`` included) of 10,240 points, 10 m blocks of the
seeded synthetic outdoor scan (for a model with a context cloud, of the
120 m scene around it, so a block's context window holds a few hundred
voxels) served by the ``Provider`` with the model's dense or context
fields (``data.synth_outdoor``), as phase 14 does.
Then:

- times 3 unprofiled chains of 10 steps, one host sync per chain, and takes
  the median step;
- runs 3 steps under ``torch.profiler`` (CPU and CUDA activities)
  and prints, per step: device time and launches of kernels and of copies,
  the CUDA runtime calls (count and host ms), the device's busy share
  (device time / unprofiled median step), and the 15 kernels with the
  most device time, with their calls per step and share of kernel time, plus the
  window-gather kernels' own rows.

Everything goes to standard output; the card's name and power limit are on
the first line.
"""
from __future__ import annotations

import argparse
import time
from collections import defaultdict
from typing import Dict, List

import torch

from .utils.profiling import by_name

BLOCKS = 4
POINTS = 8192
STEPS = 3                  # training steps under the profiler
TOP = 15                   # kernels listed by device time
# the port's own kernels, by a substring of their symbol names: K2, and
# K3's two launches (its map, then its sums)
OWN_KERNELS = ("window_gather_kernel", "window_dslab_map_kernel",
               "window_dslab_sum_kernel")


def _device_us(e) -> float:
    """Self device time of a profiler average, in microseconds, under the
    attribute name of either the newer or the older torch API."""
    v = getattr(e, "self_device_time_total", None)
    return float(v if v is not None else e.self_cuda_time_total)


def summarize(averages, steps: int, step_s: float) -> Dict:
    """Per-step totals from ``prof.key_averages()``: device rows (kernels
    and copies) by device time, and CUDA runtime calls by count."""
    kernels: List = []
    copy_us = copy_n = 0.0
    runtime = defaultdict(lambda: [0, 0.0])
    for e in averages:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.key.startswith(("Memcpy", "Memset")):
                copy_us += _device_us(e)
                copy_n += e.count
            else:
                kernels.append((e.key, e.count, _device_us(e)))
        elif e.key.startswith("cuda"):
            runtime[e.key][0] += e.count
            runtime[e.key][1] += e.self_cpu_time_total
    kernel_ms, kernels = by_name(kernels, steps)
    copy_ms = copy_us / 1e3 / steps
    return dict(
        kernel_ms=kernel_ms,
        kernel_launches=sum(r[1] for r in kernels),
        copy_ms=copy_ms,
        copies=copy_n / steps,
        busy=(kernel_ms + copy_ms) / 1e3 / step_s,
        kernels=kernels,
        runtime=sorted(((k, n / steps, us / 1e3 / steps)
                        for k, (n, us) in runtime.items()),
                       key=lambda r: -r[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", choices=("s3dis", "semantic3d"),
                   default="s3dis")
    p.add_argument("--model", default=None,
                   help="registry key (default: the config's model)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")

    from torch.profiler import ProfilerActivity, profile

    from .config import CONFIGS
    from .data import synth_outdoor, toy
    from .data.provider import to_device
    from .train.loop import Trainer
    from .train.model_zoo import blocks_fn_for
    from .utils.timing import card as card_name

    card = card_name()
    cfg = CONFIGS[args.config](**({"model": args.model} if args.model
                                  else {}))
    print(f"[profile] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {args.config} {cfg.model}", flush=True)
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    if args.config == "semantic3d":
        n = cfg.data.num_points
        blocks = synth_outdoor.scan_blocks(
            0, n, context="ctx_idx" in getattr(trainer.model, "extra_keys",
                                               ()))[:2 * BLOCKS]
        host = synth_outdoor.scan_batches(blocks_fn_for(cfg, args.config),
                                          blocks, n, BLOCKS, "train", 0)
        for b in host:
            if "ctx_mask" in b:
                print(f"[profile] valid context points per block "
                      f"{b['ctx_mask'].sum(1).tolist()} of "
                      f"{b['ctx_mask'].shape[1]}", flush=True)
    else:
        host = toy.toy_batches(2, batch_size=BLOCKS, num_points=POINTS,
                               kind="room", num_classes=13, feat_dim=12)
    batches = [to_device(b, "cuda") for b in host]
    for i in range(2):                                   # build + warm-up
        state, m = trainer.train_step(state, batches[i])
    torch.cuda.synchronize()

    chains = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(10):
            state, m = trainer.train_step(state, batches[i % 2])
        float(m["loss"])
        chains.append((time.perf_counter() - t0) / 10)
    chains.sort()
    step_s = chains[1]
    valid = int(batches[0]["mask"].sum())
    print(f"[profile] unprofiled step s (3 chains of 10): "
          f"{', '.join(f'{t:.4f}' for t in chains)}; median {step_s:.4f} s "
          f"= {valid / step_s:.1f} train points/s", flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(STEPS):
            state, m = trainer.train_step(state, batches[i % 2])
        torch.cuda.synchronize()
        prof_s = (time.perf_counter() - t0) / STEPS
    s = summarize(prof.key_averages(), STEPS, step_s)
    print(f"[profile] {STEPS} profiled steps, {prof_s:.4f} s a step "
          f"under the profiler; per step: kernels {s['kernel_ms']:.2f} ms "
          f"in {s['kernel_launches']:.0f} launches, copies "
          f"{s['copy_ms']:.2f} ms in {s['copies']:.0f}; device busy "
          f"{s['busy']:.3f} of the unprofiled {step_s:.4f} s step")
    print("[profile] CUDA runtime calls per step (count, host ms):")
    for key, n, ms in s["runtime"]:
        print(f"    {n:9.1f} {ms:9.2f}  {key}")
    print(f"[profile] top {TOP} kernels per step (calls, device ms, "
          f"share of kernel time):")
    for key, n, ms, share in s["kernels"][:TOP]:
        print(f"    {n:7.1f} {ms:8.3f} {share:6.3f}  {key[:110]}")
    print("[profile] the port's own kernels per step:")
    for key, n, ms, share in s["kernels"]:
        if any(name in key for name in OWN_KERNELS):
            print(f"    {n:7.1f} {ms:8.3f} {share:6.3f}  {key[:110]}")
    print(f"[profile] done [{card}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
