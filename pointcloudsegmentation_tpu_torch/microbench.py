"""Primitive costs at the flagship's shapes on one CUDA card (the port's
counterpart of ``scripts/microbench.py``).

    python -m pointcloudsegmentation_tpu_torch.microbench [--which all] \
        [--reps 32] [--device cuda]

Every row is one of the JAX script's, at its shapes, in its order and
under its label: gather, scatter (the gather's backward), sorted segment
sum and cumsum-diff; the conv shape; the one-hot window conv; selection
and its alternatives; windowed, slab and overflow selection; scatter in
float32 and bf16; band compaction.  Inputs are drawn on the device from
``torch.Generator`` seed 0.

Timing (``repeat_timed``): ``reps`` calls of an op chained, each taking
the previous call's scalar (so no call can be dropped or reordered),
between two CUDA events with one host read after them; the median of 5
chains over ``reps``, less the same per-call time of a trivial chained
op (``measure_baseline``).  That time includes the host's dispatch of
each call, which the JAX script's in-jit ``fori_loop`` did not have, so
each row also gives the op's device-only ms (``device_ms``: ``reps``
calls captured in one CUDA graph and replayed, ``utils.timing.graph_ms``).
An op that synchronises with the host cannot be captured; its row says
so.  Rows whose bytes are counted give their byte bound beside them:
bytes read plus bytes written (each input read once, each output written
once) over the H100 SXM's 3.35 TB/s.

Counterparts of what is TPU-only: ``approx_max_k`` (and its
``recall_target``) becomes exact top-k in ``lax.top_k``'s tie order
(``ops.search._topk_smallest``), and the row's label adds "(exact)".
A ``lax.map`` over query chunks stays a loop over the chunks, as the
port's search runs them; the one over tiles is one batched op, as the
port's slab selection runs it.  The JAX segment sum is the port's
``ops.segments.segment_sum``; cumsum-diff scans along the contiguous
dimension (``torch.cumsum`` on dim 0 is a scan per column); the one-hot
conv is ported as written.

``--device cpu`` times with the host clock and gives no device time
(tests only).  Each ``*_cases`` function builds its ops apart from
timing them, with the JAX shapes as keyword defaults, so that a test can
run every op once at a small size."""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import require_device
from .ops import segments
from .ops.search import _topk_smallest
from .utils.timing import card, graph_ms

REPS = 32
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
_BASELINE = 0.0                  # ms per call of a trivial chained op


class Case(NamedTuple):
    """One row: ``fn(carry)`` -> the op's output tensor(s), where
    ``carry`` is a 0-d float32 tensor that perturbs an input by
    ``carry * 1e-9`` (0 gives the op on ``inputs`` as drawn)."""
    label: str                    # the JAX script's label
    fn: Callable
    inputs: Dict
    reps: Optional[int] = None    # None: the run's --reps
    nbytes: int = 0               # bytes read + written; 0: no bound
    note: str = ""                # " (exact)" where JAX approximates


class Row(NamedTuple):
    label: str
    note: str
    ms: float                     # chained calls, dispatch included
    device_ms: Optional[float]    # CUDA-graph replays; None: see why
    why: str
    bound_ms: Optional[float]


def scalar(out) -> torch.Tensor:
    """The chained scalar of an op's output: the sum of every tensor in it
    (in tuples, lists and dataclasses such as a neighborhood) * 1e-9."""
    if isinstance(out, torch.Tensor):
        return out.float().sum() * 1e-9
    if dataclasses.is_dataclass(out):
        out = [getattr(out, f.name) for f in dataclasses.fields(out)]
    return sum(scalar(o) for o in out
               if isinstance(o, (torch.Tensor, tuple, list))
               or dataclasses.is_dataclass(o))


def _chain_ms(op: Callable, seed_val: torch.Tensor, reps: int) -> float:
    """ms of ``reps`` chained calls: CUDA events and one host read on the
    card, the host clock on the CPU."""
    if seed_val.is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        c = seed_val
        for _ in range(reps):
            c = op(c)
        end.record()
        float(c)
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    c = seed_val
    for _ in range(reps):
        c = op(c)
    float(c)
    return (time.perf_counter() - t0) * 1e3


def repeat_timed(op: Callable, seed_val: torch.Tensor, iters: int = 5,
                 reps: Optional[int] = None) -> float:
    """ms per op: op(carry_scalar) -> scalar, chained ``reps`` times (after
    one untimed chain: first-use builds, the allocator); the median of
    ``iters`` chains, less the baseline."""
    reps = reps or REPS
    _chain_ms(op, seed_val, reps)
    ts = [_chain_ms(op, seed_val, reps) for _ in range(iters)]
    return statistics.median(ts) / reps - _BASELINE


def measure_baseline(device="cuda") -> float:
    """Set and return the per-call ms of a trivial chained op (a scalar
    add), timed as ``repeat_timed`` times an op: the median of 7 chains
    of ``REPS`` calls."""
    global _BASELINE
    seed = torch.zeros((), device=device)
    op = lambda c: c + 1.0  # noqa: E731
    _chain_ms(op, seed, REPS)
    _BASELINE = statistics.median(
        _chain_ms(op, seed, REPS) for _ in range(7)) / REPS
    print(f" dispatch baseline: {_BASELINE:.4f} ms per chained call "
          f"(a scalar add, {REPS} calls)", flush=True)
    return _BASELINE


def device_ms(op: Callable, seed_val: torch.Tensor, reps: int
              ) -> Tuple[Optional[float], str]:
    """(device ms per call, "") from ``reps`` calls of ``op`` captured in
    one CUDA graph, or (None, why) on the CPU or for an op that
    synchronises with the host (found by one call under
    ``torch.cuda.set_sync_debug_mode("error")``)."""
    if not seed_val.is_cuda:
        return None, "no device time on the CPU"
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        op(seed_val)
    except RuntimeError as e:
        if "synchronizing CUDA operation" not in str(e):
            raise
        return None, "not capturable: it synchronises with the host"
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return graph_ms(lambda: op(seed_val), calls=reps), ""


def time_row(label: str, op: Callable, seed_val: torch.Tensor,
             reps: int, nbytes: int = 0, note: str = "") -> Row:
    """Time ``op`` (chained and as graph replays) and print its row."""
    ms = repeat_timed(op, seed_val, reps=reps)
    dev, why = device_ms(op, seed_val, reps)
    bound = nbytes / HBM_BYTES_PER_S * 1e3 if nbytes else None
    line = f"{label}{note}: {ms:.4f} ms; device " + (
        f"{dev:.4f} ms" if dev is not None else f"not measured ({why})")
    if bound is not None:
        line += f"; bound {bound:.3g} ms (bytes)"
    print(line, flush=True)
    return Row(label, note, ms, dev, why, bound)


def run_cases(cases: List[Case], device, reps: int) -> List[Row]:
    seed = torch.zeros((), device=device)
    return [time_row(c.label, lambda x, fn=c.fn: scalar(fn(x)), seed,
                     c.reps or reps, c.nbytes, c.note) for c in cases]


def seeded(device) -> torch.Generator:
    """A generator on ``device`` at seed 0 (every row's inputs)."""
    return torch.Generator(device).manual_seed(0)


def _randn(g, *shape, device):
    return torch.randn(shape, generator=g, device=device)


def _nb(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def take_backward(x: torch.Tensor, idx: torch.Tensor, gg: torch.Tensor
                  ) -> torch.Tensor:
    """The gradient of ``x[idx]`` in ``x`` for the cotangent ``gg``, as
    autograd computes it (``index_put_`` accumulating into zeros: PyTorch's
    index backward, the counterpart of ``jax.vjp`` of ``jnp.take``)."""
    return torch.zeros_like(x).index_put_((idx,), gg, accumulate=True)


def gather_scatter_cases(device="cuda", shapes=((8192, 64, 262144),
                                                (8192, 64, 720896),
                                                (8192, 256, 262144))
                         ) -> List[Case]:
    """JAX ``bench_gather_scatter`` (``scripts/microbench.py:70-111``)."""
    cases = []
    for n, f, m in shapes:
        g0 = seeded(device)
        x = _randn(g0, n, f, device=device)
        idx = torch.randint(0, n, (m,), generator=g0, device=device)
        g = _randn(g0, m, f, device=device) * 1e-3
        sidx = torch.sort(idx).values
        begs = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                          torch.cumsum(torch.bincount(idx, minlength=n), 0)])

        def cumdiff(c, g=g, begs=begs):
            # the scan runs along the contiguous dimension: torch.cumsum
            # on dim 0 of [M, F] scans each column in one thread (95.7 ms
            # at M=262144, F=64 on an H100, 4,600x its byte bound)
            cs = torch.cumsum((g + c * 1e-9).t().contiguous(), 1)  # [F, M]
            cs = F.pad(cs, (1, 0))
            return (cs[:, begs[1:]] - cs[:, begs[:-1]]).t()

        io = dict(x=x, idx=idx, g=g, sidx=sidx, begs=begs)
        cases += [
            Case(f" gather  N={n} F={f} M={m}",
                 lambda c, x=x, idx=idx: (x + c * 1e-9)[idx], io,
                 nbytes=_nb(x, idx) + m * f * 4),
            Case(f" scatter N={n} F={f} M={m}",
                 lambda c, x=x, idx=idx, g=g: take_backward(
                     x, idx, g + c * 1e-9), io, nbytes=_nb(g, idx, x)),
            Case(f" segsum(sorted) N={n} F={f} M={m}",
                 lambda c, g=g, sidx=sidx, n=n: segments.segment_sum(
                     g + c * 1e-9, sidx, n), io, nbytes=_nb(g, sidx, x)),
            Case(f" cumsum-diff     N={n} F={f} M={m}", cumdiff, io,
                 nbytes=_nb(g, begs, x)),
        ]
    return cases


def _conv(xx: torch.Tensor, idx: torch.Tensor, w: torch.Tensor
          ) -> torch.Tensor:
    """Gather, project, max over the neighbors (``amax``: ties share the
    gradient, as ``jnp.max``'s do)."""
    return torch.einsum("nkf,fo->nko", xx[idx], w).amax(1)


def grad_of_sum(fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """The gradient of ``fn(x).sum()`` in ``x``."""
    x = x.detach().requires_grad_(True)
    return torch.autograd.grad(fn(x).sum(), x)[0]


def conv_shape_cases(device="cuda", n=8192, k=32, f=64) -> List[Case]:
    """JAX ``bench_conv_shapes`` (``scripts/microbench.py:114-134``)."""
    g0 = seeded(device)
    x = _randn(g0, n, f, device=device) * 0.1
    idx = torch.randint(0, n, (n, k), generator=g0, device=device)
    w = _randn(g0, f, f, device=device) * 0.05
    conv = lambda xx: _conv(xx, idx, w)  # noqa: E731
    io = dict(x=x, idx=idx, w=w)
    return [Case(f" conv fwd  N={n} K={k} F={f}",
                 lambda c: conv(x + c * 1e-9), io),
            Case(f" conv fwd+bwd N={n} K={k} F={f}",
                 lambda c: grad_of_sum(conv, x + c * 1e-9), io)]


def _onehot_conv(xx: torch.Tensor, lidx: torch.Tensor, w: torch.Tensor,
                 window: int, tile: int) -> torch.Tensor:
    """The one-hot window conv as the JAX script writes it: bf16 one-hot
    [nt, T, K, S] (``jax.nn.one_hot``: a comparison with ``arange``), the
    tiles' slabs of the padded features, the gather as an einsum (exact:
    one term per output), the projection, the max over K."""
    s = tile + 2 * window
    oh = (lidx[..., None] == torch.arange(s, device=lidx.device)
          ).to(torch.bfloat16)
    xp = F.pad(xx, (0, 0, window, window))
    slabs = xp.unfold(0, s, tile).transpose(1, 2)             # [nt, S, F]
    e = torch.einsum("ntks,nsf->ntkf", oh, slabs.to(torch.bfloat16)).float()
    return torch.einsum("ntkf,fo->ntko", e, w).amax(2)


def onehot_cases(device="cuda", n=8192, k=32, f=64, tile=256,
                 windows=(256, 512)) -> List[Case]:
    """JAX ``bench_onehot_window`` (``scripts/microbench.py:137-166``)."""
    g0 = seeded(device)
    x = _randn(g0, n, f, device=device) * 0.1
    w = _randn(g0, f, f, device=device) * 0.05
    cases = []
    for wdw in windows:
        s = tile + 2 * wdw
        lidx = torch.randint(0, s, (n // tile, tile, k), generator=g0,
                             device=device)
        conv = lambda xx, lidx=lidx, wdw=wdw: _onehot_conv(  # noqa: E731
            xx, lidx, w, wdw, tile)
        io = dict(x=x, w=w, lidx=lidx, window=wdw, tile=tile)
        cases += [Case(f" onehot fwd  W={wdw}",
                       lambda c, conv=conv: conv(x + c * 1e-9), io, 16),
                  Case(f" onehot fwd+bwd W={wdw}",
                       lambda c, conv=conv: grad_of_sum(conv, x + c * 1e-9),
                       io, 16)]
    return cases


def _uniform_cloud(n: int, device) -> torch.Tensor:
    """U(0, 3)^3 points; the selection rows' squared norms are then
    ``(xyz * xyz).sum(-1)``, as the JAX script forms them outside its jit
    (no fused multiply-add)."""
    return torch.rand((n, 3), generator=seeded(device), device=device) * 3.0


def _chunk_dists(x2: torch.Tensor, sq: torch.Tensor, mask: torch.Tensor,
                 chunk: int, keep: Optional[torch.Tensor] = None):
    """Per query chunk: (rows, d2 [chunk, N]) with invalid columns (and,
    with ``keep``, columns it rules out for the chunk) at +1e30, the
    negation of the JAX script's -1e30 scores."""
    n = x2.shape[0]
    for i in range(n // chunk):
        rows = slice(i * chunk, (i + 1) * chunk)
        d2 = sq[rows, None] + sq[None, :] - 2 * (x2[rows] @ x2.T)
        ok = mask[None, :] if keep is None else mask[None, :] & keep(rows)
        yield rows, torch.where(ok, d2, torch.full_like(d2, 1e30))


def _select(x2, sq, mask, chunk, pick) -> torch.Tensor:
    """[N // chunk, chunk, ck] candidates, ``pick(d2)`` per chunk."""
    return torch.stack([pick(d2) for _, d2 in _chunk_dists(
        x2, sq, mask, chunk)])


def _smallest(k: int) -> Callable:
    return lambda d2: _topk_smallest(d2, k)[1]


def select_cases(device="cuda", shapes=((8192, 64, 2048), (8192, 128, 2048),
                                        (4096, 64, 2048), (1024, 64, 1024))
                 ) -> List[Case]:
    """JAX ``bench_select`` (``scripts/microbench.py:169-203``)."""
    cases = []
    for n, ck, chunk in shapes:
        xyz = _uniform_cloud(n, device)
        mask = torch.ones(n, dtype=torch.bool, device=device)
        sq = (xyz * xyz).sum(-1)
        c = min(chunk, n)
        io = dict(xyz=xyz, mask=mask, sq=sq, chunk=c, ck=ck)
        nbytes = _nb(xyz, mask, sq) + n * ck * 8
        cases += [
            Case(f" selection N={n} ck={ck} chunk={c}",
                 lambda t, xyz=xyz, mask=mask, sq=sq, c=c, ck=ck: _select(
                     xyz + t * 1e-9, sq, mask, c, _smallest(ck)), io, 16,
                 nbytes, " (exact)"),
            Case("   distance-only",
                 lambda t, xyz=xyz, mask=mask, sq=sq, c=c: torch.stack([
                     -d2.sum() for _, d2 in _chunk_dists(
                         xyz + t * 1e-9, sq, mask, c)]), io, 16,
                 _nb(xyz, mask, sq)),
        ]
    return cases


def two_stage(d2: torch.Tensor, groups: int = 8, kk: int = 16,
              ck: int = 64) -> torch.Tensor:
    """Per-group exact top-``kk``, then the ``ck`` best of the
    ``groups * kk`` survivors (JAX ``bench_select2``'s ``two_stage``)."""
    c, n = d2.shape
    sv, si = _topk_smallest(d2.reshape(c, groups, n // groups), kk)
    base = (torch.arange(groups, device=d2.device) * (n // groups))[
        None, :, None]
    si = (si + base).reshape(c, groups * kk)
    _, mi = _topk_smallest(sv.reshape(c, groups * kk), ck)
    return torch.gather(si, 1, mi)


def select2_cases(device="cuda", n=8192, chunk=2048, ck=64) -> List[Case]:
    """JAX ``bench_select2`` (``scripts/microbench.py:206-258``)."""
    xyz = _uniform_cloud(n, device)
    mask = torch.ones(n, dtype=torch.bool, device=device)
    sq = (xyz * xyz).sum(-1)
    io = dict(xyz=xyz, mask=mask, sq=sq, chunk=chunk, ck=ck)
    # (label, the pick, its k, note)
    picks = (("approx_max_k ck=64 (baseline)", _smallest(ck), ck, " (exact)"),
             ("approx_max_k ck=64 recall .8", _smallest(ck), ck, " (exact)"),
             ("approx_max_k ck=16", _smallest(16), 16, " (exact)"),
             ("exact top_k ck=64", _smallest(ck), ck, ""),
             ("two-stage 8x top16 -> top64",
              lambda d2: two_stage(d2, 8, 16, ck), ck, ""),
             ("two-stage 16x top16 -> top64",
              lambda d2: two_stage(d2, 16, 16, ck), ck, ""),
             ("two-stage 8x top32 -> top64",
              lambda d2: two_stage(d2, 8, 32, ck), ck, ""))
    return [Case(f" {label}", lambda t, pick=pick: _select(
                xyz + t * 1e-9, sq, mask, chunk, pick), io, 16,
                 _nb(xyz, mask, sq) + n * k * 8, note)
            for label, pick, k, note in picks]


def _window_d2(x2, sq, mask, tile, window) -> torch.Tensor:
    """[nt, T, S] tile-to-slab squared distances over the padded cloud
    (JAX ``winsel``, its ``lax.map`` over tiles batched), invalid and
    padded columns at +1e30."""
    s = tile + 2 * window
    xp = F.pad(x2, (0, 0, window, window))
    sqp = F.pad(sq, (window, window))
    mp = F.pad(mask, (window, window))
    slab = xp.unfold(0, s, tile).transpose(1, 2)              # [nt, S, 3]
    sn, sm = sqp.unfold(0, s, tile), mp.unfold(0, s, tile)    # [nt, S]
    nt = slab.shape[0]
    q, qn = x2.reshape(nt, tile, 3), sq.reshape(nt, tile)
    d2 = qn[:, :, None] + sn[:, None, :] - 2 * torch.bmm(
        q, slab.transpose(1, 2))
    return torch.where(sm[:, None, :], d2, torch.full_like(d2, 1e30))


def _slab_d2(x2, sq, mask, tile) -> torch.Tensor:
    """[nt, T, 3T] distances to the shift-stacked slabs (tiles t+1, t,
    t-1 by ``roll``, the ends masked), JAX ``slab_neg`` negated."""
    nt = x2.shape[0] // tile
    x0, sq0 = x2.reshape(nt, tile, 3), sq.reshape(nt, tile)
    m0 = mask.reshape(nt, tile)
    tiles = torch.arange(nt, device=x2.device)
    parts, sparts, mparts = [], [], []
    for sh in (1, 0, -1):
        parts.append(torch.roll(x0, sh, 0))
        sparts.append(torch.roll(sq0, sh, 0))
        # the tile that wrapped round has no neighbor there (an item write
        # would copy from the host: the op could not be captured)
        edge = tiles != {1: 0, 0: -1, -1: nt - 1}[sh]
        mparts.append(torch.roll(m0, sh, 0) & edge[:, None])
    slab, sn, sm = (torch.cat(p, 1) for p in (parts, sparts, mparts))
    d2 = sq0[:, :, None] + sn[:, None, :] - 2 * torch.einsum(
        "ntd,nsd->nts", x0, slab)
    return torch.where(sm[:, None, :], d2, torch.full_like(d2, 1e30))


def windowed_cases(device="cuda", n=8192, tile=256, chunk=2048
                   ) -> List[Case]:
    """JAX ``bench_windowed`` (``scripts/microbench.py:261-351``)."""
    xyz = _uniform_cloud(n, device)
    mask = torch.ones(n, dtype=torch.bool, device=device)
    sq = (xyz * xyz).sum(-1)
    io = dict(xyz=xyz, mask=mask, sq=sq, tile=tile, chunk=chunk)
    cases = []
    for wdw, ck in ((256, 48), (384, 48)):
        cases.append(Case(
            f" windowed top{ck} W={wdw} (S={tile + 2 * wdw})",
            lambda t, wdw=wdw, ck=ck: _topk_smallest(_window_d2(
                xyz + t * 1e-9, sq, mask, tile, wdw), ck)[1],
            dict(io, window=wdw, ck=ck), 16,
            _nb(xyz, mask, sq) + n * ck * 8))
    for ck in (48, 64):
        sel = lambda t, ck=ck: _topk_smallest(  # noqa: E731
            _slab_d2(xyz + t * 1e-9, sq, mask, tile), ck)[1]
        nbytes = _nb(xyz, mask, sq) + n * ck * 8
        cases.append(Case(f" slab-batched exact top{ck} W=256", sel,
                          dict(io, ck=ck), 16, nbytes))
        cases += [Case(f" slab-batched approx top{ck} rt={rt} W=256", sel,
                       dict(io, ck=ck), 16, nbytes, " (exact)")
                  for rt in (0.8, 0.95)]
    col = torch.arange(n, device=device)
    for ko in (8, 16):
        # out-of-window columns only: |query - column| > 256
        outside = lambda rows: (col[rows, None] - col[None, :]  # noqa: E731
                                ).abs() > 256
        cases.append(Case(
            f" overflow approx ck={ko}",
            lambda t, ko=ko: torch.stack([
                _topk_smallest(d2, ko)[1] for _, d2 in _chunk_dists(
                    xyz + t * 1e-9, sq, mask, chunk, outside)]),
            dict(io, ko=ko), 16, _nb(xyz, mask, sq) + n * ko * 8,
            " (exact)"))
    return cases


def scatter_variant_cases(device="cuda", n=8192, f=64,
                          sizes=((262144, "K=32"), (65536, "K=8"))
                          ) -> List[Case]:
    """JAX ``bench_scatter_variants`` (``scripts/microbench.py:354-376``):
    the index backward in float32 and in bf16."""
    cases = []
    for m, label in sizes:
        g0 = seeded(device)
        x = _randn(g0, n, f, device=device)
        idx = torch.randint(0, n, (m,), generator=g0, device=device)
        g = _randn(g0, m, f, device=device) * 1e-3
        gb, xb = g.to(torch.bfloat16), x.to(torch.bfloat16)
        io = dict(x=x, idx=idx, g=g)
        cases += [
            Case(f" scatter f32 {label} M={m}",
                 lambda c, x=x, idx=idx, g=g: take_backward(
                     x, idx, g + c * 1e-9), io, nbytes=_nb(g, idx, x)),
            Case(f" scatter bf16 {label} M={m}",
                 lambda c, xb=xb, idx=idx, gb=gb: take_backward(
                     xb, idx, gb + c.to(torch.bfloat16) * 1e-6), io,
                 nbytes=_nb(gb, idx, xb)),
        ]
    return cases


BANDS = ((0.0, 0.15, 32), (0.15, 0.2, 24), (0.1, 0.15, 16), (0.0, 0.1, 16))


def compaction_counts(ed2: torch.Tensor, bands=BANDS) -> torch.Tensor:
    """Per band, per point: the slots that the rank-by-matmul compaction
    fills ([len(bands), N] int64; JAX ``bench_compaction``'s ``compact``
    sums them)."""
    ck = ed2.shape[1]
    ar = torch.arange(ck, device=ed2.device)
    lex_lt = (ed2[:, :, None] > ed2[:, None, :]) | (
        (ed2[:, :, None] == ed2[:, None, :])
        & (ar[None, :, None] > ar[None, None, :]))
    lex_f = lex_lt.float()
    out = []
    for mn, mx, k in bands:
        in_band = (ed2 <= mx * mx) & (ed2 >= mn * mn)
        rank = torch.einsum("ncj,nj->nc", lex_f, in_band.float()).int()
        slot = torch.arange(k, dtype=torch.int32, device=ed2.device)
        hit = in_band[:, :, None] & (rank[:, :, None] == slot[None, None, :])
        out.append(hit.sum((1, 2)))
    return torch.stack(out)


def compaction_cases(device="cuda", n=8192, ck=64) -> List[Case]:
    """JAX ``bench_compaction`` (``scripts/microbench.py:379-403``)."""
    ed2 = torch.rand((n, ck), generator=seeded(device), device=device)
    return [Case(f" 4-band compaction N={n} ck={ck}",
                 lambda c: compaction_counts(ed2 + c * 1e-9),
                 dict(ed2=ed2), 16)]


# --which -> (the JAX script's section header, its cases)
BENCHES = {
    "gather": ("== gather / scatter-add (ms/op, dispatch-corrected) ==",
               gather_scatter_cases),
    "conv": ("== conv-shaped gather+project+max (ms/op) ==",
             conv_shape_cases),
    "onehot": ("== windowed one-hot conv (MXU) ==", onehot_cases),
    "select": ("== selection pass (ms/op) ==", select_cases),
    "select2": ("== selection alternatives (ms/op) ==", select2_cases),
    "windowed": ("== windowed selection + overflow (ms/op) ==",
                 windowed_cases),
    "scatvar": ("== scatter variants (ms/op) ==", scatter_variant_cases),
    "compact": ("== band compaction (ms/op) ==", compaction_cases),
}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--which", default="all", choices=["all", *BENCHES])
    p.add_argument("--reps", type=int, default=32)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (host clock, tests only)")
    return p.parse_args(argv)


def main(argv=None) -> List[Row]:
    """Prints the rows; returns them."""
    args = parse_args(argv)
    device = require_device(args.device)
    if device.type == "cuda":
        print(f"[microbench] {card()}; torch {torch.__version__}",
              flush=True)
    measure_baseline(device)
    rows = []
    for which, (header, cases) in BENCHES.items():
        if args.which in ("all", which):
            print(header, flush=True)
            rows += run_cases(cases(device), device, args.reps)
    return rows


if __name__ == "__main__":
    main()
