#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which fails loudly:

1. device: the card's name and power limit; TF32 is switched off;
2. build: the window-gather kernel (nvcc, sm_90a) and the native host
   library (csrc/) are built from the checkout's sources;
3. kernel vs plain: the window-gather kernel against its plain PyTorch
   version at every shape the flagship's inference path gives it, bit for
   bit, timed with CUDA events both eagerly (host dispatch included) and as
   CUDA-graph replays (device time);
4. serve: the flagship ``pointnet_s3dis`` (bf16 compute, weights drawn from
   torch.Generator seed 0) sweeps 8 blocks of 8192 points through
   ``eval_scene_probs`` and interpolates to a 4x-dense cloud; the kernel's
   launch count over the sweep must be the expected count per block;
5. determinism and parity: one block twice on the card gives bitwise-equal
   logits; in float32 the card and the CPU agree on neighbor indices and
   logit argmax.

Prints one JSON line describing the kernels, then the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.  Exits
non-zero without that line when there is no CUDA device or a phase fails.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_POINTS = 8192
N_BLOCKS = 8
# what a phase must meet
PARITY_NBR_MIN = 0.999      # share of valid neighbor slots equal, card vs CPU
PARITY_ARGMAX_MIN = 0.99    # share of points with equal logit argmax
PROB_SUM_TOL = 1e-3


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip smoke failed: {msg}")


def log(msg=""):
    print(msg, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=20, replays=5):
    """Mean device milliseconds per call of ``fn``: ``calls`` calls captured
    in one CUDA graph, replayed ``replays`` times between CUDA events, so
    the host's dispatch cost is not in the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def phase_device():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"[device] nvidia-smi: {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{kind}; device_count={torch.cuda.device_count()}")
    log("[device] TF32 off for matmul and cuDNN (float32 is float32)")
    return card, kind


def phase_build():
    from pointcloudsegmentation_tpu_torch.kernels import window_gather as wg

    built = wg.build(force=True)
    log(f"[build] window_gather.cu -> sm_90a in {built.seconds:.2f} s; "
        "ptxas:")
    for line in built.log.splitlines():
        if "ptxas" in line:
            log(f"    {line.strip()}")
    t0 = time.perf_counter()
    mk = subprocess.run(["make", "-C", os.path.join(ROOT, "csrc"), "-B"],
                        capture_output=True, text=True, timeout=300)
    check(mk.returncode == 0, f"native build failed:\n{mk.stdout}{mk.stderr}")
    log(f"[build] native host library (make -C csrc -B) in "
        f"{time.perf_counter() - t0:.2f} s")


def gather_shapes(model, cfg):
    """(name, N, K, F, dtype) of every window-gather launch the flagship's
    inference path makes, per level: the search's xyzm read and each conv's
    projection gather (K = the band's slots, F = the conv's ΣD)."""
    import torch

    from pointcloudsegmentation_tpu_torch.models.pointnet import (
        CAND_K, WIN_CAND_K)
    from pointcloudsegmentation_tpu_torch.ops import search

    enc = model.encoder
    sizes = (cfg.data.num_points,) + tuple(cfg.data.caps)
    shapes = []
    for s, stage in enumerate(enc.arch.stages):
        n = sizes[s]
        if n % enc.win_tile or n < 4 * enc.win_tile:
            continue
        bands = [(c.min_radius, c.radius, c.k) for c in stage.convs]
        ck = search.effective_win_cand_k(WIN_CAND_K, CAND_K, bands, n)
        shapes.append((f"L{s} search xyzm", n, ck, 4, torch.float32))
        for c in stage.convs:
            f = sum(c.fc_dims) + c.out
            shapes.append((f"L{s} conv", n, c.k, f,
                           enc.dtype or torch.float32))
    return shapes


def phase_kernel(model, cfg, card):
    import torch

    from pointcloudsegmentation_tpu_torch.kernels import window_gather as wg

    tile, window = model.encoder.win_tile, model.encoder.win_window
    s = tile + 2 * window
    gen = torch.Generator(device="cuda").manual_seed(0)
    seen, rows = set(), []
    for name, n, k, f, dtype in gather_shapes(model, cfg):
        if (n, k, f, dtype) in seen:
            continue
        seen.add((n, k, f, dtype))
        feats = torch.randn((n, f), generator=gen, device="cuda").to(dtype)
        lidx = torch.randint(0, s, (n, k), generator=gen, device="cuda",
                             dtype=torch.int32)
        lidx[:, 0] = 0          # the zero rows before the block's start
        lidx[:, -1] = s - 1     # ... and past its end
        got = wg.gather_fwd(feats, lidx, window, tile)
        want = wg.gather_fwd_reference(feats, lidx, window, tile)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"kernel != plain at {name} N={n} K={k} F={f} {dtype}")
        err = (got.float() - want.float()).abs().max().item()
        kernel = lambda: wg.gather_fwd(feats, lidx, window, tile)  # noqa
        plain = lambda: wg.gather_fwd_reference(  # noqa: E731
            feats, lidx, window, tile)
        eager_ms, eager_plain_ms = cuda_ms(kernel), cuda_ms(plain)
        ms, plain_ms = graph_ms(kernel), graph_ms(plain)
        mb = n * k * f * feats.element_size() / 1e6
        rows.append(dict(name=name, n=n, k=k, f=f, dtype=str(dtype),
                         max_abs_err=err, ms=ms, plain_ms=plain_ms))
        log(f"[kernel] {name:16s} N={n:5d} K={k:2d} F={f:3d} "
            f"{str(dtype):14s} equal; device ms (graph replay): kernel "
            f"{ms:.4f} ({mb / ms:.1f} GB/s written), plain {plain_ms:.4f}; "
            f"eager ms: kernel {eager_ms:.4f}, plain {eager_plain_ms:.4f} "
            f"[{card}]")
    return rows


def make_blocks(device):
    import numpy as np
    import torch

    from pointcloudsegmentation_tpu.data import toy

    rng = np.random.RandomState(0)
    blocks = []
    for i in range(N_BLOCKS):
        b = toy.synthetic_room_block(rng, n=N_POINTS, num_classes=13,
                                     feat_dim=12)
        blocks.append({
            "xyz": torch.from_numpy(b["xyz"]).to(device),
            "feats": torch.from_numpy(b["feats"]).to(device),
            "mask": torch.ones(N_POINTS, dtype=torch.bool, device=device),
            "block_min": np.array([3.0 * i, 0, 0], np.float32)})
    # the dense cloud: 4x the sampled density near the sampled surfaces
    dense = np.concatenate(
        [np.repeat(b["xyz"].cpu().numpy(), 4, axis=0)
         + rng.uniform(-0.05, 0.05, (4 * N_POINTS, 3)).astype(np.float32)
         + b["block_min"][None, :] for b in blocks], axis=0)
    return blocks, dense.astype(np.float32)


def phase_serve(model, cfg, card):
    import numpy as np
    import torch

    from pointcloudsegmentation_tpu_torch.eval.interpolate import (
        eval_scene_probs, interpolate_to_dense)
    from pointcloudsegmentation_tpu_torch.kernels import window_gather as wg

    blocks, dense = make_blocks("cuda")
    eval_scene_probs(model, blocks[:1])          # warm-up
    torch.cuda.synchronize()

    per_block = len(gather_shapes(model, cfg))
    wg.gather_fwd.launches = 0
    sxyz, probs = eval_scene_probs(model, blocks)
    launches = wg.gather_fwd.launches
    dprobs = interpolate_to_dense(sxyz, probs, dense, k=6)
    log(f"[serve] window-gather launches over the sweep: {launches} "
        f"({launches / N_BLOCKS:g} per block, expected {per_block})")
    check(launches == per_block * N_BLOCKS,
          f"{launches} launches, expected {per_block} x {N_BLOCKS}")
    check(probs.shape == (N_BLOCKS * N_POINTS, 13), f"probs {probs.shape}")
    check(np.isfinite(probs).all(), "non-finite probs")
    dev = np.abs(probs.sum(1) - 1.0).max()
    check(dev <= PROB_SUM_TOL, f"probs rows sum to 1 +- {dev}")
    check(dprobs.shape == (len(dense), 13) and np.isfinite(dprobs).all(),
          f"dense probs {dprobs.shape}")
    ddev = np.abs(dprobs.sum(1) - 1.0).max()
    check(ddev <= PROB_SUM_TOL, f"dense probs rows sum to 1 +- {ddev}")
    log(f"[serve] probs {probs.shape} finite, rows sum to 1 +- {dev:.2e}; "
        f"dense {dprobs.shape} rows sum to 1 +- {ddev:.2e}")

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sxyz, probs = eval_scene_probs(model, blocks)
        interpolate_to_dense(sxyz, probs, dense, k=6)
        times.append(time.perf_counter() - t0)
    times.sort()
    pps = len(dense) / times[1]
    log(f"[serve] sweeps (s): {', '.join(f'{t:.4f}' for t in times)}; "
        f"median {len(dense)} dense points / {times[1]:.4f} s = "
        f"{pps:.1f} dense points/s [{card}]")
    return launches, pps


def phase_parity(serve, cfg, block, card):
    import dataclasses

    import torch

    from pointcloudsegmentation_tpu_torch.ops import hierarchy, morton
    from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

    xyz, feats, mask = block
    # bitwise repeatability of the serving model (bf16) on the card
    with torch.inference_mode():
        a = serve(xyz.to("cuda"), feats.to("cuda"), mask.to("cuda"))
        b = serve(xyz.to("cuda"), feats.to("cuda"), mask.to("cuda"))
    check(torch.equal(a, b), "logits differ between two runs on the card")
    log(f"[parity] same block twice on the card: logits bitwise equal "
        f"({a.dtype})")

    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_model(f32, torch.Generator().manual_seed(0), dev).eval()
        enc = model.encoder
        with torch.inference_mode():
            x, m, f = xyz.to(dev), mask.to(dev), feats.to(dev)
            logits = model(x, f, m).cpu()
            xs, ms, _ = morton.sort_block(x, m, cfg.data.voxel_sizes[0] / 4,
                                          cfg.data.block_size)
            pyr = hierarchy.build_pyramid(xs, ms, cfg.data.voxel_sizes,
                                          cfg.data.caps, cfg.data.block_size,
                                          morton_sorted=True)
            nbrs = []
            for s, stage in enumerate(enc.arch.stages):
                specs = [(c.radius, c.min_radius, c.k) for c in stage.convs]
                res = enc._stage_neighborhoods(pyr.levels[s].xyz,
                                               pyr.levels[s].mask, specs,
                                               pyr.level_sorted(s))
                for spec, (nb, _) in res.items():
                    nb = nb.to_neighborhood() if hasattr(
                        nb, "to_neighborhood") else nb
                    nbrs.append((f"L{s} {spec}", nb.idx.cpu(), nb.mask.cpu()))
        out[dev] = (logits, nbrs)
    total = bad = 0
    for (name, gi, gm), (_, ci, cm) in zip(out["cuda"][1], out["cpu"][1]):
        valid = gm | cm
        diff = valid & ((gm != cm) | (gi != ci))
        total += int(valid.sum())
        bad += int(diff.sum())
        log(f"[parity] {name}: {int(diff.sum())} of {int(valid.sum())} "
            f"valid slots differ")
    share = 1.0 - bad / max(total, 1)
    log(f"[parity] neighbor slots card vs CPU: {bad} of {total} differ "
        f"({share:.6f} equal, need >= {PARITY_NBR_MIN})")
    check(share >= PARITY_NBR_MIN, f"neighbor parity {share}")
    gl, cl = out["cuda"][0], out["cpu"][0]
    agree = (gl.argmax(1) == cl.argmax(1)).float().mean().item()
    dmax = (gl - cl).abs().max().item()
    log(f"[parity] float32 logits card vs CPU: argmax agreement {agree:.6f} "
        f"(need >= {PARITY_ARGMAX_MIN}), max |dlogit| {dmax:.3e} [{card}]")
    check(agree >= PARITY_ARGMAX_MIN, f"argmax agreement {agree}")
    return bad, total


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    port = os.path.join(ROOT, "pointcloudsegmentation_tpu_torch")
    if not os.path.isdir(port):
        print("chip smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    from pointcloudsegmentation_tpu_torch.config import s3dis_config
    from pointcloudsegmentation_tpu_torch.kernels import window_gather as wg
    from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

    t_start = time.perf_counter()
    card, kind = phase_device()
    phase_build()
    cfg = s3dis_config()
    model = build_model(cfg, torch.Generator().manual_seed(0), "cuda").eval()
    rows = phase_kernel(model, cfg, card)
    launches, pps = phase_serve(model, cfg, card)
    blocks, _ = make_blocks("cpu")
    b0 = blocks[0]
    phase_parity(model, cfg, (b0["xyz"], b0["feats"], b0["mask"]), card)

    main_row = next(r for r in rows if r["name"].endswith("conv"))
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s; "
        f"kernel ms/plain_ms below are {main_row['name']} N={main_row['n']} "
        f"K={main_row['k']} F={main_row['f']} {main_row['dtype']}; eval "
        f"{pps:.1f} dense points/s")
    print(json.dumps({"kernels": [{
        "name": "window_gather",
        "route": "cuda",
        "source": "pointcloudsegmentation_tpu_torch/csrc/window_gather.cu",
        "replaces":
            "pointcloudsegmentation_tpu/ops/pallas/window_gather.py:95",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
