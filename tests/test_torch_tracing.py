"""The port's tracing (`contour_context_tpu_torch/tracing.py`): host spans
that cost one check without a profiler and nest as the module's table
says under one, stage marks once each a scan and a serving chunk in
order, records bit-equal with the profiler on and off; on the card, the
nine mark kernels inside a replayed step. And the benchmark's reader of
them (`benchmark/harness/stages.py`) on hand-made profiles.

No jax: the `cuda` test runs where only torch is installed,

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tracing.py

The CPU tests take the graphed code paths through the stand-in pool of
`torch_graph_stub` (a capture runs the body, a replay runs it again).
"""

import os
import types

import numpy as np
import pytest
import torch

from synth import make_world, render_scan
import torch_graph_stub

from contour_context_tpu_torch import db as tdb
from contour_context_tpu_torch import tracing
from contour_context_tpu_torch.config import (ContourManagerConfig,
                                              PipelineConfig)
from contour_context_tpu_torch.utils.io import pad_points

torch.set_num_threads(2)

CFG = PipelineConfig(cm=ContourManagerConfig(max_points=4096))
N, DT = 6, 6.0
BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
SERVE_MARKS = ["desc", "end"] + list(tracing.STAGES[1:])


@pytest.fixture(scope="module")
def clouds():
    world = make_world(3, n_structs=60, extent=80.0)
    return torch.from_numpy(np.stack([
        pad_points(render_scan(world, (8.0 * i, 0.0, 0.0), seed=i,
                               pts_per_struct=60), CFG.cm.max_points)
        for i in range(N)]))


@pytest.fixture
def fake_pool():
    with torch_graph_stub.fake_pool():
        yield


def _graphed_db(device="cpu"):
    db = tdb.ContourDB(CFG, capacity=8, device=device)
    db._graphs.enabled = True
    return db


def _stream(db, clouds, k0, k1):
    return [db.step_async(clouds[i], i, DT * i) for i in range(k0, k1)]


def _profiled(fn, cuda=False):
    """fn() under torch.profiler: its result and the host events named
    cont2.*, (name, start, end) in start order."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    ev = sorted(((e.name, e.time_range.start, e.time_range.end)
                 for e in prof.events() if e.name.startswith("cont2.")),
                key=lambda x: x[1])
    return out, ev, prof


def _within(ev, child: str, parent: str) -> None:
    """Every span `child` lies inside a span `parent`."""
    kids = [(s, e) for n, s, e in ev if n == "cont2." + child]
    outer = [(s, e) for n, s, e in ev if n == "cont2." + parent]
    assert kids and outer, (child, parent)
    for s, e in kids:
        assert any(ps <= s and e <= pe for ps, pe in outer), (child, parent)


def _marks(ev) -> list:
    return [n[len("cont2.mark."):] for n, _, _ in ev
            if n.startswith("cont2.mark.")]


def _names(ev) -> set:
    return {n[len("cont2."):] for n, _, _ in ev
            if not n.startswith("cont2.mark.")}


def test_span_without_profiler_is_the_shared_null_context(
        clouds, fake_pool, monkeypatch):
    """With no profiler a span is the module's one null context, a mark
    on the CPU does nothing, and a graphed step, its record and a
    serving request enter no record_function at all."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    for name in tracing.SPANS:
        assert tracing.span(name) is tracing.span("step")
    with tracing.span("step"):
        tracing.mark("desc", torch.device("cpu"))
    db = _graphed_db()
    hs = _stream(db, clouds, 0, 3)
    hs[-1].record()
    db.localize_block_async(clouds[:3], chunk=2).get()


def test_span_and_mark_names_are_checked():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            tracing.span("no_such_span")
    with pytest.raises(KeyError):
        tracing.mark("no_such_stage", torch.device("cpu"))


def test_stream_spans_nest_and_mark_each_stage_once_a_scan(clouds,
                                                           fake_pool):
    """Two replayed steps and their records: step holds upload, stage_in
    and replay; record holds fetch and unpack; the nine marks once each
    a scan, in order, inside the replay."""
    db = _graphed_db()
    _stream(db, clouds, 0, 2)          # the capture

    def steps():
        hs = _stream(db, clouds, 2, 4)
        return [h.record() for h in hs]

    _, ev, _ = _profiled(steps)
    assert _marks(ev) == list(tracing.STAGES) * 2
    assert _names(ev) == {"step", "upload", "stage_in", "replay", "record",
                          "fetch", "unpack"}
    for child in ("upload", "stage_in", "replay"):
        _within(ev, child, "step")
    for child in ("fetch", "unpack"):
        _within(ev, child, "record")
    marks = [(s, e) for n, s, e in ev if n.startswith("cont2.mark.")]
    replays = [(s, e) for n, s, e in ev if n == "cont2.replay"]
    assert all(any(rs <= s and e <= re for rs, re in replays)
               for s, e in marks)
    assert sum(n == "cont2.step" for n, _, _ in ev) == 2


def test_serving_spans_nest_and_mark_each_stage_once_a_chunk(clouds,
                                                             fake_pool):
    """A request of 3 clouds in chunks of 2 (one zero cloud of pad): a
    chunk's span holds its upload, stage_in, two replays and stage_out,
    then come the records' concatenation, fetch and unpack; each chunk marks desc,
    end in its build replay and search to end in its query replay."""
    db = _graphed_db()
    _stream(db, clouds, 0, N)
    db.localize_block_async(clouds[:3], chunk=2).get()     # the captures
    _, ev, _ = _profiled(
        lambda: db.localize_block_async(clouds[3:], chunk=2).get())
    assert _marks(ev) == SERVE_MARKS * 2
    assert _names(ev) == {"chunk.2", "upload", "stage_in", "replay",
                          "stage_out", "fetch", "unpack"}
    for child in ("upload", "stage_in", "replay"):
        _within(ev, child, "chunk.2")
    chunks = [(s, e) for n, s, e in ev if n == "cont2.chunk.2"]
    outs = [(s, e) for n, s, e in ev if n == "cont2.stage_out"]
    assert len(chunks) == 2 and len(outs) == 3      # and the concatenation
    assert [any(cs <= s and e <= ce for cs, ce in chunks)
            for s, e in outs] == [True, True, False]
    assert sum(n == "cont2.replay" for n, _, _ in ev) == 4
    assert sum(n == "cont2.upload" for n, _, _ in ev) == 2
    (fs, fe), = [(s, e) for n, s, e in ev if n == "cont2.fetch"]
    (us, _), = [(s, e) for n, s, e in ev if n == "cont2.unpack"]
    assert all(e <= fs for n, _, e in ev
               if n in ("cont2.upload", "cont2.stage_in", "cont2.replay",
                        "cont2.stage_out"))
    assert fe <= us


def test_a_request_of_21_records_chunks_of_16_4_and_1(clouds, fake_pool):
    """Served with no chunk, 21 clouds are one chunk span each of 16, 4
    and 1, in order, each around its own upload and its build and query
    graphs; nothing is padded, so the build slots are the 21 clouds."""
    db = _graphed_db()
    _stream(db, clouds, 0, 2)
    request = torch.cat([clouds] * 4)[:21]
    _, ev, _ = _profiled(lambda: db.localize_block_async(request).get())
    chunks = [n for n, _, _ in ev if n.startswith("cont2.chunk.")]
    assert chunks == ["cont2.chunk.16", "cont2.chunk.4", "cont2.chunk.1"]
    for c in ("16", "4", "1"):
        inner = [n for n, s, e in ev for cs, ce in
                 [(s0, e0) for m, s0, e0 in ev if m == "cont2.chunk." + c]
                 if cs <= s and e <= ce and n != "cont2.chunk." + c]
        assert inner.count("cont2.upload") == 1, (c, inner)
        assert inner.count("cont2.capture") == 2, (c, inner)
    assert _marks(ev) == SERVE_MARKS * 3
    assert db.serving_counters["build_slots"] == 21
    assert sorted(k[-1] for k in db._graphs.graphs if k[0] == "query") \
        == [1, 4, 16]


def test_records_equal_with_the_profiler_on_and_off(clouds, fake_pool):
    """The same stream and request on two DBs, one of them under the
    profiler: records, store and window state bit-equal."""
    dbs, served = [], []
    for profiled in (False, True):
        db = _graphed_db()

        def run():
            hs = _stream(db, clouds, 0, N)
            [h.record() for h in hs]
            return db.localize_block_async(clouds[1:4], chunk=2).get()

        served.append(_profiled(run)[0] if profiled else run())
        dbs.append(db)
    a, b = dbs
    assert torch.equal(a.recs_store.view(torch.int32),
                       b.recs_store.view(torch.int32))
    for x, y in zip(a.store, b.store):
        assert torch.equal(x, y)
    assert torch.equal(a.state, b.state) and a.counters == b.counters
    assert a.serving_counters == b.serving_counters
    for r, s in zip(*served):
        assert (r is None) == (s is None)
        if r is not None:
            assert r[0] == s[0] and r[1] == s[1]
            assert np.array_equal(r[2], s[2])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _device_ops(prof) -> list:
    """(name, start) of the device's operations, in start order, host
    spans' shadows left out."""
    return [n for n, _ in sorted(
        ((e.name, e.time_range.start) for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and not e.is_user_annotation and not e.name.startswith("cont2.")),
        key=lambda x: x[1])]


@pytest.mark.cuda
def test_replayed_step_carries_the_nine_marks_on_card(cuda, clouds,
                                                      monkeypatch):
    """A replayed step under the profiler shows cont2_mark_desc ..
    cont2_mark_end in order, and the device operations of the same step
    captured without marks plus these nine; its record is bit-equal to
    the unmarked replay's and the eager body's."""
    dbs = {}
    for kind in ("marked", "unmarked", "eager"):
        db = _graphed_db(cuda)
        with monkeypatch.context() as m:
            if kind == "unmarked":
                m.setattr(tracing, "_launch", lambda i, device: None)
            if kind == "eager":
                with db.eager():
                    _stream(db, clouds, 0, 3)
            else:
                _stream(db, clouds, 0, 3)       # the capture at step 0
        dbs[kind] = db
    ops = {}
    for kind in ("marked", "unmarked"):
        db = dbs[kind]
        torch.cuda.synchronize(cuda)
        _, _, prof = _profiled(lambda: _stream(db, clouds, 3, 4)[0].record(),
                               cuda=True)
        ops[kind] = _device_ops(prof)
    with dbs["eager"].eager():
        _stream(dbs["eager"], clouds, 3, 4)[0].record()
    marks = [n for n in ops["marked"] if "cont2_mark_" in n]
    assert marks == ["cont2_mark_" + s for s in tracing.STAGES]
    assert len(ops["marked"]) == len(ops["unmarked"]) + 9
    assert [n for n in ops["marked"] if "cont2_mark_" not in n] \
        == ops["unmarked"]
    rings = [dbs[k].recs_store[:4].view(torch.int32).cpu()
             for k in ("marked", "unmarked", "eager")]
    assert torch.equal(rings[0], rings[1]) and torch.equal(rings[0],
                                                           rings[2])


# ---------------------------------------------------------------------------
# the benchmark's reader of the marks and spans
# ---------------------------------------------------------------------------

@pytest.fixture
def harness(monkeypatch):
    monkeypatch.syspath_prepend(BENCH)
    from harness import stages, trace
    return types.SimpleNamespace(stages=stages, trace=trace)


def _run(harness, dev, host, windows, kind="stream"):
    prof = harness.trace.Profile(dev, host)
    return types.SimpleNamespace(
        kind=kind, window=types.SimpleNamespace(profile=prof),
        item_windows=lambda: list(windows))


def _item(t0, busy, idle=None, stages=tracing.STAGES):
    """Device ops of one item from t0: each stage's mark (1 us), then one
    operation of `busy[k]` us, then `idle[k]` us before the next mark."""
    idle = idle or [0] * len(busy)
    out, t = [], t0
    for stage, b, i in zip(stages, busy, idle):
        out.append((f"cont2_mark_{stage}", t, t + 1))
        if b:
            out.append(("void at::native::elementwise_kernel", t + 1,
                        t + 1 + b))
        t += 1 + b + i
    return out


def test_stage_ms_over_two_items(harness):
    """Two scans: each stage is the device's busy time between its mark
    and the next, averaged over the items, whatever the device idles
    there (here 8 ms in the first scan's search); end, with no mark after
    it, reads None."""
    b1 = [10, 2, 3, 20, 4, 5, 30, 6, 0]
    b2 = [14, 4, 5, 22, 6, 7, 50, 8, 0]
    idle = [0, 8000, 0, 0, 0, 0, 0, 3, 0]
    dev = _item(1000, b1, idle) + _item(20000, b2, [0, 5] + [0] * 7) + [
        ("search_tilemin_kernel", 20021, 20022)]
    run = _run(harness, dev, [], [(900, 15000), (15000, 25000)])
    st = harness.stages
    for k, stage in enumerate(tracing.STAGES[:-1]):
        extra = 1 if stage == "search" else 0
        assert st.stage_ms(run, "stream", stage) == pytest.approx(
            (b1[k] + b2[k] + extra) / 2 / 1e3)
    assert st.stage_ms(run, "stream", "end") is None
    assert st.stage_ms(run, "serve", "desc") is None


def test_an_op_straddling_a_mark_counts_on_each_side(harness):
    """A copy on another stream that runs across the search mark counts
    in desc up to the mark and in search after it, once where it overlaps
    a kernel."""
    dev = [("cont2_mark_desc", 0, 1), ("k", 1, 6),
           ("Memcpy HtoD (Pageable -> Device)", 40, 55),
           ("cont2_mark_search", 50, 51), ("k", 51, 54),
           ("cont2_mark_check1", 60, 61)]
    run = _run(harness, dev, [], [(0, 100)])
    assert harness.stages.stage_ms(run, "stream", "desc") == \
        pytest.approx(15 / 1e3)
    assert harness.stages.stage_ms(run, "stream", "search") == \
        pytest.approx(4 / 1e3)
    assert harness.stages.stage_ms(run, "stream", "check1") is None


def test_stage_ms_sums_a_stage_over_chunks(harness):
    """A request of two chunks: desc, end, search .. end twice; a stage
    met twice in an item reads its sum."""
    b = [100, 1, 2, 3, 4, 5, 6, 7, 8, 9]
    dev = (_item(0, b, stages=SERVE_MARKS)
           + _item(500, b, stages=SERVE_MARKS))
    run = _run(harness, dev, [], [(0, 1000)], kind="serve")
    assert harness.stages.stage_ms(run, "serve", "desc") == \
        pytest.approx(0.2)
    assert harness.stages.stage_ms(run, "serve", "lm") == pytest.approx(
        2 * 7 / 1e3)


def test_an_item_that_lost_a_mark_is_left_out(harness):
    """The profiler dropped the lm mark of one scan of three: that scan
    is left out of every stage (its init would run on into the LM), and a
    mark that no scan has reads None."""
    b1 = [10, 2, 3, 20, 4, 5, 30, 6, 0]
    b3 = [14, 2, 3, 20, 4, 5, 50, 6, 0]
    second = [x for x in _item(2000, b1) if x[0] != "cont2_mark_lm"]
    run = _run(harness, _item(1000, b1) + second + _item(3000, b3), [],
               [(900, 1500), (1500, 2500), (2500, 3500)])
    st = harness.stages
    assert st.stage_ms(run, "stream", "lm") == pytest.approx(0.04)
    assert st.stage_ms(run, "stream", "init") == pytest.approx(0.005)
    assert st.stage_ms(run, "stream", "desc") == pytest.approx(0.012)
    none = _run(harness, [x for x in _item(1000, b1) + _item(3000, b3)
                          if x[0] != "cont2_mark_lm"], [],
                [(900, 2000), (2000, 3500)])
    assert st.stage_ms(none, "stream", "lm") is None
    assert st.stage_ms(none, "stream", "init") == pytest.approx(0.045)


def test_span_ms_sums_an_items_spans(harness):
    """An item reads the sum of its spans of the name; a run the median
    over its items, so one item the host stalled in does not carry it."""
    host = [("cont2.step", 0, 50), ("cont2.upload", 1, 4),
            ("cont2.upload", 10, 12), ("cont2.step", 100, 150),
            ("cont2.upload", 101, 110), ("aten::copy_", 2, 3),
            ("cont2.upload", 201, 241), ("cont2.upload", 301, 308)]
    run = _run(harness, [], host, [(0, 90), (90, 200)])
    assert harness.stages.span_ms(run, "stream", "upload") == \
        pytest.approx((5 + 9) / 2 / 1e3)
    assert harness.stages.span_ms(run, "stream", "stage_in") is None
    run = _run(harness, [], host, [(0, 90), (90, 200), (200, 300),
                                   (300, 400)])
    assert harness.stages.span_ms(run, "stream", "upload") == \
        pytest.approx((7 + 9) / 2 / 1e3)


NEW_METRICS = ([f"{s}_ms.{k}" for s in tracing.STAGES[:7]
                for k in ("stream", "serve")]
               + ["upload_ms.stream", "upload_ms.serve",
                  "slots_per_cloud.serve"])


@pytest.mark.parametrize("metric", NEW_METRICS)
def test_new_metric_reads_none_without_marks_or_spans(harness, metric):
    """A program without marks or spans (the trace of an item holds only
    torch's operations and the harness's own spans) reads None; a run
    without a trace too."""
    from harness.spec import Spec
    read = Spec(os.path.dirname(BENCH), BENCH).reader(metric)
    kind = metric.rsplit(".", 1)[1]
    dev = [("void at::native::reduce_kernel", 10, 30),
           ("ring_key_divs_kernel", 40, 45)]
    host = [("bench.scan", 0, 100), ("cudaGraphLaunch", 1, 5)]
    assert read(_run(harness, dev, host, [(0, 100)], kind)) is None
    untraced = _run(harness, dev, host, [], kind)
    untraced.window.profile = None
    assert read(untraced) is None


def test_slots_per_cloud_reads_the_chunk_spans(harness):
    """Build slots a served cloud over the traced requests: two requests
    of one cloud replayed at their size read 1.0, requests of 3 padded to
    a chunk of 4 read 4/3, and a request with no chunk span reads None."""
    from harness.spec import Spec
    read = Spec(os.path.dirname(BENCH), BENCH).reader(
        "slots_per_cloud.serve")

    def run(host, windows, clouds, items):
        r = _run(harness, [], host, windows, "serve")
        r.window.clouds, r.window.items = clouds, items
        return r

    one = [("cont2.chunk.1", 1, 5), ("cont2.upload", 2, 3),
           ("cont2.chunk.1", 101, 105)]
    assert read(run(one, [(0, 100), (100, 200)], 40, 40)) == 1.0
    padded = [("cont2.chunk.2", 1, 5), ("cont2.chunk.2", 6, 9),
              ("cont2.chunk.4", 101, 105)]
    assert read(run(padded, [(0, 100), (100, 200)], 30, 10)) == \
        pytest.approx(8 / 6)
    assert read(run(one[:2], [(0, 100), (100, 200)], 40, 40)) is None
