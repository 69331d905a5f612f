"""The port's primitive costs (``pointcloudsegmentation_tpu_torch.
microbench``) against ``scripts/microbench.py``: its row labels are the
JAX script's at the JAX shapes, and every timed op, run once at a small
size on the port's own inputs, equals the JAX expression that the script
times (written out here from its lines, since its ops are nested): integers
exactly, float32 within 1e-5 and bf16 within 2^-6 of max(1, the largest
|JAX value|); selections as index sets per row, except rows whose k-th and
(k+1)-th JAX scores lie within 1e-5 (XLA:CPU's float32 dot may round such
a pair either way)."""
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudsegmentation_tpu_torch import microbench as mb

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZERO = torch.zeros(())
BF16_TOL = 2.0 ** -6


def _jax_script():
    """``scripts/microbench.py`` as a module, the environment left as it
    was."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    saved = dict(os.environ)
    try:
        return importlib.import_module("microbench")
    finally:
        sys.path.remove(os.path.join(ROOT, "scripts"))
        os.environ.clear()
        os.environ.update(saved)


def _np(t):
    return t.detach().float().numpy() if t.is_floating_point() \
        else t.numpy()


def close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32) / scale,
                               want / scale, atol=tol, rtol=0)


def same_sets(got, want, neg, k):
    """Rows of index sets equal, but where the JAX scores ``neg`` [rows,
    columns] have their k-th and (k+1)-th largest within 1e-5; returns the
    rows compared."""
    got, want, neg = (np.asarray(a).reshape(-1, a.shape[-1])
                      for a in (got, want, neg))
    top = -np.sort(-neg, axis=1)
    tied = np.abs(top[:, k - 1] - top[:, k]) < 1e-5 if neg.shape[1] > k \
        else np.zeros(len(neg), bool)
    for r in np.flatnonzero(~tied):
        assert set(got[r]) == set(want[r]), r
    assert tied.mean() < 0.01
    return int((~tied).sum())


WHICH = ("gather", "conv", "onehot", "select", "select2", "windowed",
         "scatvar", "compact")


@pytest.mark.parametrize("which", WHICH)
def test_row_labels_are_the_jax_scripts(which, capsys, monkeypatch):
    """At the JAX shapes: the rows the JAX script prints (its timer
    stubbed) are the port's cases, in order, and the "(exact)" note marks
    exactly the rows where the JAX op is ``approx_max_k``."""
    jmb = _jax_script()
    monkeypatch.setattr(jmb, "repeat_timed", lambda *a, **k: 1.0)
    fn = {"gather": jmb.bench_gather_scatter, "conv": jmb.bench_conv_shapes,
          "onehot": jmb.bench_onehot_window, "select": jmb.bench_select,
          "select2": jmb.bench_select2, "windowed": jmb.bench_windowed,
          "scatvar": jmb.bench_scatter_variants,
          "compact": jmb.bench_compaction}[which]
    fn()
    printed = capsys.readouterr().out.splitlines()
    header, cases = mb.BENCHES[which]
    assert printed[0] == header
    want = [line.split(": ")[0] for line in printed[1:]]
    cases = cases("cpu")
    assert [c.label for c in cases] == want
    approx = [w for w in want if "approx" in w or w.startswith(" selection")]
    assert [c.label for c in cases if c.note] == approx
    assert all(c.note == " (exact)" for c in cases if c.note)


def test_gather_scatter_ops():
    n, f, m = 1024, 8, 4096
    cases = mb.gather_scatter_cases("cpu", shapes=((n, f, m),))
    io = {k: _np(v) for k, v in cases[0].inputs.items()}
    x, idx, g = io["x"], io["idx"].astype(np.int32), io["g"]
    got = [_np(c.fn(ZERO)) for c in cases]
    np.testing.assert_array_equal(got[0], np.asarray(jnp.take(x, idx, 0)))
    close(got[1], jax.vjp(lambda xx: jnp.take(xx, idx, axis=0), x)[1](
        jnp.asarray(g))[0])
    sidx = jnp.sort(idx)
    np.testing.assert_array_equal(io["sidx"], np.asarray(sidx))
    close(got[2], jax.ops.segment_sum(g, sidx, num_segments=n,
                                      indices_are_sorted=True))
    begs = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(
        jnp.bincount(idx, length=n)).astype(jnp.int32)])
    np.testing.assert_array_equal(io["begs"], np.asarray(begs))
    cs = jnp.concatenate([jnp.zeros((1, f)), jnp.cumsum(g, axis=0)], 0)
    close(got[3], jnp.take(cs, begs[1:], 0) - jnp.take(cs, begs[:-1], 0))


def test_take_backward_is_autograds():
    """The scatter rows' op is the gradient autograd gives ``x[idx]``, bit
    for bit, in float32 and bf16."""
    case = mb.scatter_variant_cases("cpu", n=256, sizes=((2048, "K=8"),))[0]
    x, idx, g = (case.inputs[k] for k in ("x", "idx", "g"))
    for dt in (torch.float32, torch.bfloat16):
        leaf = x.to(dt).requires_grad_(True)
        want = torch.autograd.grad(leaf[idx], leaf, g.to(dt))[0]
        got = mb.take_backward(x.to(dt), idx, g.to(dt))
        assert got.dtype == dt
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_conv_shape_ops():
    cases = mb.conv_shape_cases("cpu", n=512, k=8, f=16)
    io = {k: _np(v) for k, v in cases[0].inputs.items()}
    x, idx, w = io["x"], io["idx"].astype(np.int32), io["w"]

    def conv(xx):       # scripts/microbench.py:122-125
        e = jnp.take(xx, idx, axis=0)
        y = jnp.einsum("nkf,fo->nko", e, w)
        return jnp.max(y, axis=1)

    close(_np(cases[0].fn(ZERO)), conv(x))
    close(_np(cases[1].fn(ZERO)), jax.grad(lambda xx: jnp.sum(conv(xx)))(x))


def test_onehot_ops():
    n, k, f, t_tile = 512, 8, 16, 128
    cases = mb.onehot_cases("cpu", n=n, k=k, f=f, tile=t_tile,
                            windows=(128, 256))
    for fwd, bwd in zip(cases[::2], cases[1::2]):
        io = fwd.inputs
        x, w, lidx = _np(io["x"]), _np(io["w"]), _np(io["lidx"])
        wdw = io["window"]
        s, nt = t_tile + 2 * wdw, n // t_tile

        def conv(xx):   # scripts/microbench.py:150-158
            oh = jax.nn.one_hot(lidx, s, dtype=jnp.bfloat16)
            xp = jnp.pad(xx, ((wdw, wdw), (0, 0)))
            slabs = jnp.stack([jax.lax.dynamic_slice_in_dim(
                xp, i * t_tile, s, 0) for i in range(nt)])
            e = jnp.einsum("ntks,nsf->ntkf", oh, slabs.astype(jnp.bfloat16),
                           preferred_element_type=jnp.float32)
            y = jnp.einsum("ntkf,fo->ntko", e, w)
            return jnp.max(y, axis=2)

        close(_np(fwd.fn(ZERO)), conv(x))
        close(_np(bwd.fn(ZERO)), jax.grad(lambda xx: jnp.sum(conv(xx)))(x),
              BF16_TOL)


def _jax_dists(xyz, sq, mask, chunk, keep=None):
    """Per chunk the JAX script's scores ``where(mask, -d2, -1e30)``."""
    n = len(xyz)
    out = []
    for i in range(n // chunk):
        q, qn = xyz[i * chunk:(i + 1) * chunk], sq[i * chunk:(i + 1) * chunk]
        d2 = qn[:, None] + sq[None, :] - 2 * (q @ xyz.T)
        ok = mask[None, :] if keep is None else mask[None, :] & keep(i)
        out.append(jnp.where(ok, -d2, -1e30))
    return jnp.stack(out)


def _cloud_io(case):
    io = case.inputs
    xyz = jnp.asarray(_np(io["xyz"]))
    return xyz, jnp.sum(xyz * xyz, -1), jnp.asarray(_np(io["mask"]))


def test_select_ops():
    cases = mb.select_cases("cpu", shapes=((1024, 16, 512), (512, 24, 1024)))
    for sel, dist in zip(cases[::2], cases[1::2]):
        xyz, sq, mask = _cloud_io(sel)
        np.testing.assert_array_equal(_np(sel.inputs["sq"]), np.asarray(sq))
        c, ck = sel.inputs["chunk"], sel.inputs["ck"]
        neg = _jax_dists(xyz, sq, mask, c)
        want = jax.vmap(lambda v: jax.lax.approx_max_k(v, ck)[1])(neg)
        assert same_sets(_np(sel.fn(ZERO)), want, neg, ck) > 0.99 * len(xyz)
        close(_np(dist.fn(ZERO)).sum(), jnp.sum(neg))


def _two_stage(neg, n, ck, groups, kk):      # scripts/microbench.py:244-254
    c = neg.shape[0]
    g = neg.reshape(c, groups, n // groups)
    sv, si = jax.lax.top_k(g, kk)
    base = (jnp.arange(groups, dtype=jnp.int32) * (n // groups))[None, :,
                                                                 None]
    si = (si.astype(jnp.int32) + base).reshape(c, groups * kk)
    sv = sv.reshape(c, groups * kk)
    _, mi = jax.lax.top_k(sv, ck)
    return jnp.take_along_axis(si, mi.astype(jnp.int32), axis=1), sv


def test_select2_ops():
    n, chunk, ck = 1024, 512, 64
    cases = mb.select2_cases("cpu", n=n, chunk=chunk, ck=ck)
    xyz, sq, mask = _cloud_io(cases[0])
    neg = _jax_dists(xyz, sq, mask, chunk)
    flat = neg.reshape(n, n)
    for case, k in zip(cases[:4], (ck, ck, 16, ck)):
        want = jax.lax.top_k(flat, k)[1]
        same_sets(_np(case.fn(ZERO)), want, flat, k)
    for case, (groups, kk) in zip(cases[4:], ((8, 16), (16, 16), (8, 32))):
        want, sv = _two_stage(flat, n, ck, groups, kk)
        got = _np(case.fn(ZERO)).reshape(n, ck)
        # ties of either stage excuse a row
        grouped = np.asarray(flat).reshape(n * groups, n // groups)
        top = -np.sort(-grouped, axis=1)
        tied = (np.abs(top[:, kk - 1] - top[:, kk]) < 1e-5).reshape(
            n, groups).any(1)
        top2 = -np.sort(-np.asarray(sv), axis=1)
        tied |= np.abs(top2[:, ck - 1] - top2[:, ck]) < 1e-5
        assert tied.mean() < 0.01
        for r in np.flatnonzero(~tied):
            assert set(got[r]) == set(np.asarray(want)[r]), (case.label, r)


def test_windowed_ops():
    n, t_tile, chunk = 1024, 128, 512
    cases = mb.windowed_cases("cpu", n=n, tile=t_tile, chunk=chunk)
    xyz, sq, mask = _cloud_io(cases[0])
    nt = n // t_tile
    for case in cases[:2]:                   # scripts/microbench.py:275-290
        wdw, ck = case.inputs["window"], case.inputs["ck"]
        s = t_tile + 2 * wdw
        xp = jnp.pad(xyz, ((wdw, wdw), (0, 0)))
        sqp, mp = jnp.pad(sq, (wdw, wdw)), jnp.pad(mask, (wdw, wdw))
        negs = []
        for i in range(nt):
            slab = jax.lax.dynamic_slice_in_dim(xp, i * t_tile, s, 0)
            sn = jax.lax.dynamic_slice_in_dim(sqp, i * t_tile, s, 0)
            sm = jax.lax.dynamic_slice_in_dim(mp, i * t_tile, s, 0)
            q = xyz[i * t_tile:(i + 1) * t_tile]
            qn = sq[i * t_tile:(i + 1) * t_tile]
            d2 = qn[:, None] + sn[None, :] - 2 * (q @ slab.T)
            negs.append(jnp.where(sm[None, :], -d2, -1e30))
        neg = jnp.stack(negs)
        same_sets(_np(case.fn(ZERO)), jax.lax.top_k(neg, ck)[1], neg, ck)

    x0, sq0 = xyz.reshape(nt, t_tile, 3), sq.reshape(nt, t_tile)
    m0 = mask.reshape(nt, t_tile)
    parts, sparts, mparts = [], [], []     # scripts/microbench.py:296-315
    for sh in (1, 0, -1):
        parts.append(jnp.roll(x0, sh, axis=0))
        sparts.append(jnp.roll(sq0, sh, axis=0))
        edge = jnp.ones((nt,), bool)
        if sh == 1:
            edge = edge.at[0].set(False)
        elif sh == -1:
            edge = edge.at[-1].set(False)
        mparts.append(jnp.roll(m0, sh, axis=0) & edge[:, None])
    slab, sn, sm = (jnp.concatenate(p, axis=1)
                    for p in (parts, sparts, mparts))
    d2 = sq0[:, :, None] + sn[:, None, :] - 2 * jnp.einsum(
        "ntd,nsd->nts", x0, slab)
    neg = jnp.where(sm[:, None, :], -d2, -1e30)
    for case in cases[2:8]:
        ck = case.inputs["ck"]
        same_sets(_np(case.fn(ZERO)), jax.lax.approx_max_k(neg, ck)[1], neg,
                  ck)

    qi = jnp.arange(n, dtype=jnp.int32).reshape(n // chunk, chunk)
    for case in cases[8:]:                  # scripts/microbench.py:335-349
        ko = case.inputs["ko"]
        neg = _jax_dists(xyz, sq, mask, chunk, keep=lambda i: ~(jnp.abs(
            qi[i][:, None] - jnp.arange(n, dtype=jnp.int32)[None, :])
            <= 256))
        want = jax.vmap(lambda v: jax.lax.approx_max_k(v, ko)[1])(neg)
        same_sets(_np(case.fn(ZERO)), want, neg, ko)


def test_scatter_variant_ops():
    cases = mb.scatter_variant_cases("cpu", n=512, f=16,
                                     sizes=((4096, "K=8"),))
    io = {k: _np(v) for k, v in cases[0].inputs.items()}
    x, idx, g = io["x"], io["idx"].astype(np.int32), io["g"]
    close(_np(cases[0].fn(ZERO)), jax.vjp(
        lambda xx: jnp.take(xx, idx, axis=0), x)[1](g)[0])
    xb, gb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    want = jax.vjp(lambda xx: jnp.take(xx, idx, axis=0), xb)[1](gb)[0]
    got = cases[1].fn(ZERO)
    assert got.dtype == torch.bfloat16
    close(_np(got), want.astype(jnp.float32), BF16_TOL)


def test_compaction_counts():
    n, ck = 256, 64
    (case,) = mb.compaction_cases("cpu", n=n, ck=ck)
    ed2 = jnp.asarray(_np(case.inputs["ed2"]))
    lex_lt = (ed2[:, :, None] > ed2[:, None, :]) | (    # :387-400
        (ed2[:, :, None] == ed2[:, None, :])
        & (jnp.arange(ck)[None, :, None] > jnp.arange(ck)[None, None, :]))
    lex_f = lex_lt.astype(jnp.float32)
    want = []
    for mn, mx, k in mb.BANDS:
        in_band = (ed2 <= mx * mx) & (ed2 >= mn * mn)
        rank = jnp.einsum("ncj,nj->nc", lex_f,
                          in_band.astype(jnp.float32)).astype(jnp.int32)
        slot = jnp.arange(k, dtype=jnp.int32)
        hit = in_band[:, :, None] & (rank[:, :, None] == slot[None, None, :])
        want.append(np.asarray(hit.sum((1, 2))))
    np.testing.assert_array_equal(_np(case.fn(ZERO)), np.stack(want))


def test_main_on_the_cpu(monkeypatch, capsys):
    """``--device cpu``: the JAX header, one row a case on the host clock,
    no device time; the baseline is set and printed first."""
    monkeypatch.setattr(mb, "_BASELINE", mb._BASELINE)
    rows = mb.main(["--which", "conv", "--reps", "1", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(" dispatch baseline: ")
    assert out[1] == mb.BENCHES["conv"][0]
    assert [r.label for r in rows] == [" conv fwd  N=8192 K=32 F=64",
                                       " conv fwd+bwd N=8192 K=32 F=64"]
    for r, line in zip(rows, out[2:]):
        assert np.isfinite(r.ms) and r.device_ms is None and r.why
        assert line.startswith(r.label + ": ")


def test_scalar_sums_every_tensor():
    nb = mb.scalar([torch.ones(3), (torch.ones(2, dtype=torch.int64),
                                    None), 7])
    assert float(nb) == pytest.approx(5e-9)
