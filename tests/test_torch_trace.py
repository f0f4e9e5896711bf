"""Port parity: the span tracer (paddle_tpu_torch/core/trace.py) against
paddle_tpu/core/trace.py.

tests/test_trace.py's cases run on both packages (the ``trace`` fixture),
but its two profiler.RecordEvent cases: the port has no profiler module
yet. Then one script of spans on two threads, with a flow chain, goes
through both tracers: the Chrome events must agree in names, phases,
flows and thread names (ids and timestamps are free).
"""
import json
import threading

import pytest

import paddle_tpu  # noqa: F401  registers the JAX flags
from paddle_tpu.core import trace as jtrace
from paddle_tpu_torch.core import trace as ttrace

PKGS = {"jax": jtrace, "port": ttrace}


@pytest.fixture(params=list(PKGS))
def trace(request):
    tr = PKGS[request.param]
    tr.reset()
    yield tr
    if tr.enabled():
        tr.stop()
    tr.reset()


def test_span_nesting_and_ids(trace):
    with trace.span("outer", kind="test") as outer:
        assert trace.current() == (outer.trace_id, outer.span_id)
        with trace.span("inner") as inner:
            assert inner.parent_id == outer.span_id
            assert inner.trace_id == outer.trace_id
        with trace.span("inner2") as inner2:
            assert inner2.parent_id == outer.span_id
    assert trace.current() is None
    assert outer.t1 is not None and outer.t1 >= outer.t0
    assert outer.attrs["kind"] == "test"
    with trace.span("other") as other:
        assert other.trace_id != outer.trace_id
        assert other.parent_id is None


def test_span_exception_records_error_and_reraises(trace):
    with pytest.raises(ValueError):
        with trace.span("boom") as sp:
            raise ValueError("x")
    assert sp.attrs["error"] == "ValueError"
    assert sp.t1 is not None


def test_ring_is_bounded_and_always_on(trace):
    trace.set_ring_size(8)
    try:
        assert not trace.enabled()
        for i in range(20):
            trace.instant(f"e{i}")
        recent = trace.recent()
        assert len(recent) == 8
        assert recent[-1].name == "e19"
        assert trace.recent(3)[0].name == "e17"
    finally:
        trace.set_ring_size(4096)


def test_capture_buffer_only_between_start_stop(trace):
    trace.instant("before")
    trace.start()
    trace.instant("during")
    spans = trace.stop()
    trace.instant("after")
    assert [s.name for s in spans] == ["during"]
    assert {s.name for s in trace.recent()} >= {"before", "during",
                                                "after"}


def test_attach_joins_worker_thread_to_trace(trace):
    out = {}
    with trace.span("driver") as sp:
        ctx = trace.current()

        def worker():
            with trace.attach(ctx):
                with trace.span("work") as w:
                    out["w"] = w
            out["after"] = trace.current()

        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert out["w"].trace_id == sp.trace_id
    assert out["w"].parent_id == sp.span_id
    assert out["after"] is None
    assert out["w"].tid != sp.tid


def test_remote_parent_tuple_propagates_trace_id(trace):
    with trace.span("handler", parent=("cafe-1", "cafe-2")) as sp:
        assert sp.trace_id == "cafe-1"
        assert sp.parent_id == "cafe-2"


def test_detached_begin_is_not_an_ambient_parent(trace):
    sp = trace.begin("leaky", _attach=False)   # end() never called
    assert trace.current() is None
    with trace.span("after") as after:
        assert after.parent_id is None
    assert sp.t1 is None and trace.open_spans() == []


def test_sink_sees_every_finished_span(trace):
    seen = []
    trace.add_sink(seen.append)
    try:
        with trace.span("a"):
            trace.instant("b")
    finally:
        trace.remove_sink(seen.append)
    trace.instant("c")
    assert [s.name for s in seen] == ["b", "a"]


def test_chrome_export_slices_flows_and_thread_names(trace, tmp_path):
    trace.start()
    with trace.span("dispatch", step=0) as d:
        d.flow(41, "s")
    with trace.span("retire") as r:
        r.flow(41, "t")
    with trace.span("materialize") as m:
        m.flow(41, "f")
    trace.stop()
    path = str(tmp_path / "trace.json")
    trace.export_chrome_trace(path, spans=[d, r, m])
    data = json.load(open(path))
    ev = data["traceEvents"]
    slices = [e for e in ev if e["ph"] == "X"]
    flows = [e for e in ev if e.get("cat") == "flow"]
    metas = [e for e in ev if e["ph"] == "M"]
    assert {e["name"] for e in slices} == {"dispatch", "retire",
                                           "materialize"}
    assert [e["ph"] for e in flows] == ["s", "t", "f"]
    assert all(e["id"] == 41 for e in flows)
    assert flows[-1]["bp"] == "e"
    assert metas and metas[0]["args"]["name"]
    disp = next(e for e in slices if e["name"] == "dispatch")
    assert disp["args"]["step"] == 0
    assert disp["args"]["trace_id"] == d.trace_id
    assert disp["ts"] <= flows[0]["ts"] <= disp["ts"] + disp["dur"]
    # a span_dict record (the dump form) encodes as the live span does
    again = trace.to_chrome_events([trace.span_dict(s) for s in (d, r, m)])
    assert [(e["name"], e["ph"]) for e in again] == \
        [(e["name"], e["ph"]) for e in ev]


def _script(trace):
    """Spans on the main thread and a named worker, a flow chain across
    them, an instant and an error; the capture buffer's spans."""
    trace.start()
    with trace.span("serve/admit", req=0) as a:
        a.flow(7, "s")
        trace.instant("cuda/gate_reject", kernel="k", reason="shape")
    ctx = trace.current()

    def worker():
        with trace.attach(ctx):
            with trace.span("serve/decode_step", step=1, active=3) as s:
                s.flow(7, "t")

    t = threading.Thread(target=worker, name="serve-loop")
    t.start()
    t.join(timeout=30)
    with pytest.raises(KeyError):
        with trace.span("serve/retire", obj=object()) as r:
            r.flow(7, "f")
            raise KeyError("x")
    return trace.stop()


def _shape(events):
    """Everything but ids and clocks: per event its name, phase,
    category, flow id and binding, its thread's name and its args other
    than the span ids."""
    names = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    out = []
    for e in events:
        args = {k: v for k, v in e.get("args", {}).items()
                if k not in ("trace_id", "span_id", "parent_id")}
        out.append((e["name"], e["ph"], e.get("cat"), e.get("id"),
                    e.get("bp"), e.get("s"), names[e["tid"]],
                    json.dumps(args, sort_keys=True),
                    "parent_id" in e.get("args", {})))
    return out


def test_one_script_of_spans_gives_jax_chrome_events(tmp_path):
    shapes = {}
    for name, tr in PKGS.items():
        tr.reset()
        try:
            spans = _script(tr)
            path = tr.export_chrome_trace(str(tmp_path / f"{name}.json"),
                                          spans)
            shapes[name] = _shape(json.load(open(path))["traceEvents"])
        finally:
            tr.reset()
    assert len(shapes["port"]) == 9
    assert shapes["port"] == shapes["jax"]
