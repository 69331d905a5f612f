"""The spans' attribution (``pcs_bench/spans.py``) on a hand-built trace:
nested spans, a launch from autograd's device thread, overlapping kernels,
a copy, syncs and idle gaps; the partition sums to ``trace.summarise``'s
totals; the correlation ids and threads the profiler keeps change no
existing reading; the harness gives readers the attribution; and on the
CPU, where no device event is traced, the readings are None."""
import glob
import os

import pytest
import torch

from pcs_bench import harness, spans, trace

from conftest import tiny_cell

FWD, ENC, SEA, BWD, OUT = (spans.FORWARD, spans.ENCODER, spans.SEARCH,
                           spans.BACKWARD, spans.OUTSIDE)


def _ev(cat, name, ts, dur, corr=0, tid=1):
    return {"cat": cat, "name": name, "ts": float(ts), "dur": float(dur),
            "corr": corr, "tid": tid}


def _launch(corr, ts, tid=1):
    return _ev("cuda_runtime", "cudaLaunchKernel", ts, 1, corr, tid)


def _kernel(corr, ts, dur, name="k"):
    return _ev("kernel", name, ts, dur, corr, tid=7)


def events():
    """A 100 µs stretch: a block's forward (encoder, search inside), its
    backward with two overlapping kernels launched from another thread,
    a copy and a sync in the forward, a kernel and a sync outside, and
    events before and after the stretch."""
    return [
        _ev("user_annotation", "bench.window", 0, 100),
        _ev("user_annotation", FWD, 5, 35),
        _ev("user_annotation", ENC, 6, 24),
        _ev("user_annotation", SEA, 7, 8),
        _ev("user_annotation", BWD, 45, 45),
        _ev("gpu_user_annotation", FWD, 10, 30, tid=7),
        _ev("cpu_op", "aten::mm", 7, 20),
        _launch(101, 8), _kernel(101, 10, 10, "topk"),
        _launch(102, 16), _kernel(102, 20, 5, "conv"),
        _ev("cuda_runtime", "cudaMemcpyAsync", 32, 1, 103),
        _ev("gpu_memcpy", "Memcpy DtoH", 33, 2, 103, tid=7),
        _ev("cuda_runtime", "cudaStreamSynchronize", 34, 2, 104),
        _launch(105, 50, tid=2), _kernel(105, 52, 18, "mm_bwd"),
        _launch(106, 55, tid=2), _kernel(106, 60, 20, "index_bwd"),
        _launch(107, 92), _kernel(107, 94, 4, "adam"),
        _ev("cuda_runtime", "cudaDeviceSynchronize", 95, 1, 108),
        _launch(90, -20), _kernel(90, -15, 5),
        _launch(91, 120), _kernel(91, 125, 5),
    ]


def test_each_interval_gap_and_sync_goes_to_its_innermost_span():
    att = spans.attribute(events(), 0.0, 100.0)
    us = {b: round(v * 1e6, 9) for b, v in att["busy_s"].items()}
    assert us == {SEA: 10, ENC: 5, FWD: 2, BWD: 28, OUT: 4}
    us = {b: round(v * 1e6, 9) for b, v in att["idle_s"].items()}
    assert us == {SEA: 0, ENC: 8, FWD: 17, BWD: 14, OUT: 12}
    us = {b: round(v * 1e6, 9) for b, v in att["idle_root_s"].items()}
    assert us == {SEA: 0, ENC: 0, FWD: 25, BWD: 14, OUT: 12}
    assert att["syncs"] == {SEA: 0, ENC: 0, FWD: 1, BWD: 0, OUT: 1}
    assert att["spans"] == {FWD: 1, ENC: 1, SEA: 1, BWD: 1}
    assert (att["device_events"], att["matched"], att["early"],
            att["off_thread"], att["clock_us"]) == (6, 6, 0, 2, 4.0)
    assert att["kernel_s"][SEA] == {"topk": pytest.approx(10e-6)}
    assert att["kernel_s"][BWD] == {"mm_bwd": pytest.approx(18e-6),
                                    "index_bwd": pytest.approx(20e-6)}


def test_the_partition_sums_to_the_summary():
    ev = events()
    att = spans.attribute(ev, 0.0, 100.0)
    summary = trace.summarise(ev, 0.0, 100.0)
    assert summary["syncs"] == 2
    assert sum(att["busy_s"].values()) == pytest.approx(summary["busy_s"],
                                                        rel=1e-12)
    assert sum(att["idle_s"].values()) == pytest.approx(
        summary["window_s"] - summary["busy_s"], rel=1e-12)
    assert sum(att["idle_root_s"].values()) == pytest.approx(
        sum(att["idle_s"].values()), rel=1e-12)
    gaps = spans.partition_gaps(att, summary)
    assert gaps["busy"] < 1e-9 and gaps["idle"] < 1e-9
    assert gaps["syncs"] == 0


def test_an_unmatched_or_early_event_is_counted():
    """A device event whose call is missing goes outside; one that starts
    before its call is counted early."""
    ev = [e for e in events() if e.get("corr") != 102
          or e["cat"] != "cuda_runtime"]
    ev.append(_launch(109, 39))
    ev.append(_kernel(109, 38, 1))
    att = spans.attribute(ev, 0.0, 100.0)
    assert att["matched"] == 6 and att["device_events"] == 7
    assert att["early"] == 1 and att["early_max_us"] == pytest.approx(1.0)
    assert att["busy_s"][OUT] * 1e6 == pytest.approx(4 + 5)
    assert att["busy_s"][FWD] * 1e6 == pytest.approx(2 + 1)


def test_a_drifting_device_clock_shows():
    """Device events that slip against their calls as the stretch goes
    on (a device clock running slow) read as a large ``clock_us``."""
    ev = events()
    for e in ev:
        if e["cat"] in trace.DEVICE_CATS:
            e["ts"] -= 0.1 * e["ts"]
    att = spans.attribute(ev, 0.0, 100.0)
    assert att["early"] == 4 and att["clock_us"] == pytest.approx(7.4)


PEAKS = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


def _ctx(ev, t0, t1, att):
    return {"trace": trace.summarise(ev, t0, t1), "spans": att,
            "traced_units": 1, "traced_blocks": 1, "window_s": 30.0,
            "window_blocks": 100,
            "work": {"flops": 1e12, "gather_bytes": 1e6}, "peaks": PEAKS}


class _Matmuls:
    """A driver whose unit is a few CPU matmuls."""

    blocks_per_unit = 1

    def unit(self):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()

    def close(self):
        pass


def _hand_built():
    return {"events": events(), "t0_us": 0.0, "t1_us": 100.0}


@pytest.mark.parametrize("source", ["hand_built", "profiled"])
def test_the_extra_keys_change_no_existing_reading(source):
    """The profiler's events carry each event's correlation id and thread;
    ``summarise`` and every reader of ``metrics/`` read the same from them
    as from the events without those keys, from a hand-built stretch and
    from one ``trace.stretch`` profiled on the CPU."""
    st = _hand_built() if source == "hand_built" else trace.stretch(
        _Matmuls(), 2)
    ev, t0, t1 = st["events"], st["t0_us"], st["t1_us"]
    assert ev and all(set(e) == {"cat", "name", "ts", "dur", "corr", "tid"}
                      for e in ev)
    plain = [{k: e[k] for k in ("cat", "name", "ts", "dur")} for e in ev]
    assert trace.summarise(ev, t0, t1) == trace.summarise(plain, t0, t1)
    att = spans.attribute(ev, t0, t1)
    names = [os.path.basename(p)[:-3] for p in
             glob.glob(os.path.join(harness.HERE, "metrics", "*.py"))]
    assert names
    for name in names:
        read = harness.reader(name).read
        assert read(_ctx(ev, t0, t1, att)) == read(_ctx(plain, t0, t1,
                                                         att)), name


def test_the_readers_context_attributes_the_stretch(bench, monkeypatch):
    """A hand-built stretch passed through ``harness.traced_stretch``: the
    context's ``spans`` is ``spans.attribute`` of it, its ``trace`` is
    ``summarise``, and a span reader reads the search's busy time over the
    stretch's blocks."""
    cell = tiny_cell(bench, "pointnet_s3dis.train_dense")
    monkeypatch.setattr(trace, "stretch", lambda drv, units: _hand_built())
    monkeypatch.setattr(harness.peaks, "of", lambda device: PEAKS)

    class Drv:
        blocks_per_unit = 4

        def block_work(self):
            return {"flops": 1e12, "gather_bytes": 1e6}

    ctx = harness.traced_stretch(Drv(), cell, 10, 30.0, "cpu")
    assert ctx["spans"] == spans.attribute(events(), 0.0, 100.0)
    assert ctx["trace"] == trace.summarise(events(), 0.0, 100.0)
    assert ctx["traced_blocks"] == 4 * cell.traffic["trace_units"]
    read = harness.reader("search_ms_per_block.train").read
    assert read(ctx) == pytest.approx(1e-2 / ctx["traced_blocks"])


@pytest.mark.parametrize("workload", ["ecd_s3dis.train_dense",
                                      "pointnet_s3dis.label_dense"])
def test_the_span_readers_read_nothing_on_the_cpu(bench, workload,
                                                  monkeypatch):
    """A tiny cell's traced stretch through the harness's own context on
    the CPU: the port opens its search spans, no device event is traced,
    and every span reader the cell names reads None."""
    cell = tiny_cell(bench, workload, "float32")
    monkeypatch.setattr(harness.peaks, "of", lambda device: PEAKS)
    drv = harness.driver(cell.traffic["entry"])(cell.config, cell.traffic,
                                                2 ** 31 + 13, "cpu")
    ctx = harness.traced_stretch(drv, cell, 1, 1.0, "cpu")
    drv.free()
    assert ctx["spans"]["device_events"] == 0
    assert ctx["spans"]["spans"][SEA] == 3 * ctx["traced_blocks"]
    names = [m["name"] for m in cell.per_layer
             if m["name"].startswith("search_ms_per_block.")]
    assert len(names) == 1
    assert harness.reader(names[0]).read(ctx) is None


@pytest.mark.parametrize("name", sorted(spans.METRICS))
def test_no_reading_without_device_events_or_spans(name):
    """A stretch with no device event (a CPU run) reads None; so does one
    where the program opened none of the spans the metric reads."""
    ev = events()
    on = spans.attribute(ev, 0.0, 100.0)
    assert spans.read(name, on, 1) is not None
    no_dev = [e for e in ev if e["cat"] not in trace.DEVICE_CATS]
    assert spans.read(name, spans.attribute(no_dev, 0.0, 100.0), 1) is None
    no_span = [e for e in ev if e["name"] not in spans.SPANS]
    assert spans.read(name, spans.attribute(no_span, 0.0, 100.0),
                      1) is None


def test_readings_of_the_hand_built_stretch():
    att = spans.attribute(events(), 0.0, 100.0)
    got = {m: spans.read(m, att, 2) for m in spans.METRICS}
    assert got == pytest.approx({
        "search_ms_per_block": 5e-3, "conv_ms_per_block": 2.5e-3,
        "backward_ms_per_block": 14e-3,
        "forward_idle_ms_per_block": 12.5e-3,
        "backward_idle_ms_per_block": 7e-3, "model_syncs_per_block": 0.5})


@pytest.mark.parametrize("workload,searches", [
    ("pointnet_s3dis.train_dense", 3), ("ecd_s3dis.label_dense", 3)])
def test_a_tiny_cell_on_the_cpu(bench, workload, searches):
    """The port's spans in a tiny cell's traced stretch on the CPU: each
    opened as often as the cell's blocks ask, the stretch's time all idle
    and all readings None (no device event)."""
    cell = tiny_cell(bench, workload, "float32")
    (rec,) = spans.measure(cell, 2 ** 31 + 11, "cpu", 0.0, 1)
    blocks = rec["blocks"]
    train = workload.endswith("train_dense")
    assert rec["attribution"]["spans"] == {
        FWD: blocks, ENC: blocks, SEA: searches * blocks,
        BWD: blocks if train else 0}
    assert rec["busy_s"] == 0 and rec["partition_gaps"]["idle"] < 1e-9
    assert set(rec["metrics"]) == {
        f"{m}.{'train' if train else 'label'}" for m in spans.METRICS
        if train or "backward" not in m}
    assert all(v is None for v in rec["metrics"].values())
    assert rec["window_s"] > 0
