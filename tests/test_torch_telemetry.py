"""The port's telemetry sinks against the JAX package's, on the CPU: the
registry's Prometheus text and JSON dump for the same families and
observations; trace contexts across the two wire codecs; the span log's
JSONL ring; the flight recorder's dump (its fields and embedded height
and launch records) for the same event sequence; `SIGUSR2` dumping the black box of
a live process; and the span-name catalog over the port's sources.
Tolerance: exact, except for wall-clock fields (`t`, `dumped_at`)."""

from __future__ import annotations

import ast
import json
import math
import os
import pathlib
import signal
import subprocess
import sys
import time

import pytest

from tendermint_tpu.codec.binary import Reader as J_Reader
from tendermint_tpu.telemetry import flightrec as J_flightrec
from tendermint_tpu.telemetry import heightlog as J_heightlog
from tendermint_tpu.telemetry import launchlog as J_launchlog
from tendermint_tpu.telemetry import registry as J_registry
from tendermint_tpu.telemetry import tracectx as J_tracectx
from tendermint_tpu_torch.telemetry import flightrec, heightlog, launchlog, metrics, registry, tracectx
from tendermint_tpu_torch.telemetry.spanlog import SpanLog, persist_spans
from tendermint_tpu_torch.telemetry.tracer import Tracer
from tendermint_tpu_torch.testing import first_line, lockrank_report, time_limit_fixture

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _port_lockrank_guard():
    """A violation the port's lock-rank sanitizer records fails the test
    that provoked it (the suite's own guard drains only the JAX
    package's sanitizer)."""
    yield
    report = lockrank_report()
    if report:
        pytest.fail("the port's lock-rank sanitizer recorded violation(s):\n" + report, pytrace=False)


# each test fails past this many seconds, with every thread's stack on
# stderr, where a wait that never ends would hold its worker for good
_time_limit = pytest.fixture(autouse=True)(time_limit_fixture(180))


# -- the registry ---------------------------------------------------------------


def _populate(mod):
    """The same families and observations in a fresh registry of either
    package: every metric type, labels that need escaping, a gauge
    callback, an exemplar, values that render as ints, floats and
    infinities."""
    reg = mod.Registry()
    c = mod.Counter("tendermint_t_total", 'count "of" things\\n', ("kind",), registry=reg)
    c.labels(kind="a").inc()
    c.labels(kind='q"uote\\').inc(2.5)
    g = mod.Gauge("tendermint_t_gauge", "a gauge", registry=reg)
    g.set(3)
    g.inc(0.25)
    g.dec(1)
    live = mod.Gauge("tendermint_t_live", "callback gauge", ("x",), registry=reg)
    live.labels(x="1").set_function(lambda: 7.5)
    live.labels(x="2").set_function(lambda: 1 / 0)  # keeps its last value
    h = mod.Histogram("tendermint_t_seconds", "latency", ("stage",), buckets=(0.001, 0.01, 0.1, 1.0), registry=reg)
    for v, ex in ((0.0005, None), (0.02, "abc123"), (0.5, None), (7.0, None)):
        h.labels(stage="s").observe(v, exemplar=ex)
    h.labels(stage="empty")
    u = mod.Histogram("tendermint_t_size", "sizes", buckets=mod.SIZE_BUCKETS, registry=reg)
    for v in (1, 3, 100, 1e6):
        u.observe(v)
    mod.Counter("tendermint_t_labeled_idle", "no children yet", ("k",), registry=reg)
    return reg, h, u, c


def test_prometheus_text_and_dict_equal_the_jax_registry():
    (p_reg, p_h, p_u, p_c), (j_reg, j_h, j_u, j_c) = _populate(registry), _populate(J_registry)
    assert p_reg.prometheus_text() == j_reg.prometheus_text()
    p_dict, j_dict = p_reg.to_dict(), j_reg.to_dict()
    assert p_dict == j_dict
    assert json.dumps(p_dict, sort_keys=True) == json.dumps(j_dict, sort_keys=True)
    assert p_dict["tendermint_t_seconds"]["series"][0]["exemplar"] == "abc123"
    for q in (0.1, 0.5, 0.9, 0.99):
        assert p_h.labels(stage="s").quantile(q) == j_h.labels(stage="s").quantile(q)
        assert p_u.quantile(q) == j_u.quantile(q)
    assert math.isnan(p_h.labels(stage="empty").quantile(0.5))
    assert p_c.sum_total() == j_c.sum_total() == 3.5
    assert p_h.sum_total() == j_h.sum_total()
    assert p_reg.counter_value("tendermint_t_gauge") == j_reg.counter_value("tendermint_t_gauge") == 2.25


# a registry read (its family's lock held) during which a GC collection
# starts on the reading thread: gc.collect() stands in for the allocation
_GC_IN_A_READ = """
import gc, sys, threading
from {pkg}.telemetry import metrics
from {pkg}.telemetry.process import install_gc_telemetry

install_gc_telemetry()
pause = metrics.PROCESS_GC_PAUSE
count0 = pause.value["count"]
done = threading.Event()

def reader():
    with pause._lock:
        gc.collect()
    done.set()

threading.Thread(target=reader, daemon=True).start()
if not done.wait(5):
    print("hung")
    sys.stdout.flush()
    import os
    os._exit(0)
gc.collect()
print("recorded", pause.value["count"] - count0)
"""


def test_a_collection_inside_a_registry_read_is_recorded_later():
    """The JAX package's GC callback waits for the GC families' lock even
    when its own thread holds it (a `/metrics` scrape or `dump_telemetry`
    that allocates while it serializes them), so that thread hangs for
    good; the port's records such a collection with the next one."""
    outs = {}
    for pkg in ("tendermint_tpu", "tendermint_tpu_torch"):
        out = subprocess.run([sys.executable, "-c", _GC_IN_A_READ.format(pkg=pkg)], cwd=REPO, capture_output=True,
                             text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
        assert out.returncode == 0, out.stderr[-2000:]
        outs[pkg] = out.stdout.split()
    assert outs["tendermint_tpu"] == ["hung"]
    assert outs["tendermint_tpu_torch"] == ["recorded", "2"]


def test_port_catalog_renders_and_keeps_the_jax_names():
    """The port's catalog renders whole, and every family it shares with
    the JAX catalog has the same type and label names."""
    import tendermint_tpu.telemetry.metrics as J_metrics  # noqa: F401 (registers the JAX catalog)
    from tendermint_tpu.telemetry import REGISTRY as J_REGISTRY

    text = registry.REGISTRY.prometheus_text()
    assert text.endswith("\n") and "# TYPE tendermint_launch_rows counter" in text
    assert 'tendermint_launch_stage_seconds_count{stage="in_flight"}' in text
    for m in registry.REGISTRY.metrics():
        j = J_REGISTRY.get(m.name)
        assert j is not None, m.name
        assert (m.type_name, m.labelnames) == (j.type_name, j.labelnames), m.name
    assert metrics.SPAN_CATALOG <= J_metrics.SPAN_CATALOG


# -- trace contexts ---------------------------------------------------------------


@pytest.mark.parametrize("origin", ["", "node-7", "nöde-ü"])
def test_trace_context_crosses_both_wire_codecs(origin):
    j_ctx = J_tracectx.TraceContext(os.urandom(8), os.urandom(8), origin)
    wire = j_ctx.encode_wire()
    p_ctx = tracectx.TraceContext.decode_wire(tracectx.Reader(wire))
    assert (p_ctx.trace_id, p_ctx.span_id, p_ctx.origin, p_ctx.trace) == (
        j_ctx.trace_id, j_ctx.span_id, j_ctx.origin, j_ctx.trace)
    assert p_ctx.encode_wire() == wire
    # and back: the port's bytes decode in the JAX package
    p2 = tracectx.TraceContext(os.urandom(8), os.urandom(8), origin)
    back = J_tracectx.TraceContext.decode_wire(J_Reader(p2.encode_wire()))
    assert (back.trace_id, back.span_id, back.origin) == (p2.trace_id, p2.span_id, p2.origin)
    assert tracectx.TraceContext.decode_wire(p2.encode_wire()) == p2


def test_trace_context_rejects_bad_blocks():
    wire = tracectx.TraceContext(b"\x01" * 8, b"\x02" * 8, "o").encode_wire()
    with pytest.raises(ValueError):
        tracectx.TraceContext.decode_wire(b"\x02" + wire[1:])  # unknown version
    with pytest.raises(ValueError):
        tracectx.TraceContext.decode_wire(wire[:10])  # truncated


def test_sampling_knob_force_and_boost(monkeypatch):
    tracectx.force_all(False)
    monkeypatch.setattr(tracectx, "_boost_until", 0.0)
    monkeypatch.setenv("TENDERMINT_TPU_TRACE_SAMPLE", "0")
    assert tracectx.mint() is None
    s0 = metrics.TRACE_SAMPLED.value
    tracectx.force_all(True)
    try:
        ctx = tracectx.mint("n1")
        assert ctx is not None and ctx.origin == "n1" and len(ctx.trace) == 16
    finally:
        tracectx.force_all(False)
    assert tracectx.mint() is None
    tracectx.boost(5.0)
    assert tracectx.sampling_forced() and tracectx.mint() is not None
    assert metrics.TRACE_SAMPLED.value == s0 + 2
    monkeypatch.setattr(tracectx, "_boost_until", 0.0)
    monkeypatch.setenv("TENDERMINT_TPU_TRACE_SAMPLE", "1")
    assert tracectx.mint() is not None
    with tracectx.use(ctx):
        assert tracectx.current() is ctx
        with tracectx.use(None):
            assert tracectx.current() is None
        assert tracectx.current() is ctx
    assert tracectx.current() is None


# -- spans ------------------------------------------------------------------------


def test_span_log_compacts_and_replays(tmp_path):
    path = str(tmp_path / "spans.jsonl")
    tr = Tracer(capacity=64)
    log = persist_spans(tr, path, capacity=4)
    for i in range(11):
        tr.add("dispatch.launch", float(i), float(i) + 0.5, trace=f"{i:016x}", kind="verify")
    with tr.span("batcher.flush", reason="barrier") as attrs:
        attrs["requests"] = 2
    log.close()
    lines = [json.loads(ln) for ln in open(path, encoding="utf-8")]
    # compacted to the newest 4 whenever the file passed 2 x 4 lines
    assert len(lines) <= 8
    assert lines[-1]["name"] == "batcher.flush" and lines[-1]["attrs"] == {"reason": "barrier", "requests": 2}
    assert lines[-2]["attrs"]["trace"] == f"{10:016x}"
    # a torn final line from a crash is skipped on replay
    with open(path, "a", encoding="utf-8") as f:
        f.write('{"name": "dispatch.la')
    tr2 = Tracer(capacity=64)
    log2 = persist_spans(tr2, path, capacity=4)
    replayed = tr2.recent()
    assert [s["name"] for s in replayed][-1] == "batcher.flush"
    assert all(s["attrs"]["restored"] is True for s in replayed)
    assert len(replayed) == 3  # the newest 4 lines, the torn one skipped
    log2.close()
    assert SpanLog(path, capacity=4).load()[-1]["name"] == "batcher.flush"


def test_span_names_in_the_port_are_catalogued():
    """Every literal the port passes to TRACER.add()/TRACER.span() is in
    `telemetry/metrics.py`'s SPAN_CATALOG (the JAX suite's M002 lint,
    over the port's sources)."""
    found = set()
    for path in sorted((REPO / "tendermint_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("add", "span")
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "TRACER"
                and node.args
                and isinstance(node.args[0], ast.Constant)
            ):
                found.add(node.args[0].value)
    assert found == set(metrics.SPAN_CATALOG)


# -- the flight recorder ------------------------------------------------------------


def _flight_sequence(fr_mod, ll_mod, hl_mod, dump_dir):
    """The same events, launch records and height records through either
    package's recorder and ledgers; returns the parsed dump."""
    import weakref

    fr = fr_mod.FlightRecorder(capacity=16)
    fr.set_node_id("n0")
    saved, saved_heights = ll_mod.LAUNCHLOG, hl_mod._LEDGERS
    ll_mod.LAUNCHLOG = ll_mod.LaunchLedger(capacity=64)
    hl_mod._LEDGERS = weakref.WeakSet()
    try:
        ledgers = [hl_mod.HeightLedger(capacity=64, node_id=f"n{k}") for k in range(2)]
        for i in range(40):
            ll_mod.LAUNCHLOG.record({"kind": "verify", "rows": i, "t": 1000.0 + i})
            ledgers[i % 2].record({"height": i + 1, "t_commit": 2000.0 + i, "finality_s": 0.5})
        fr.record("breaker", breaker="verify", frm="closed", to="open")
        fr.record("mesh", event="shard_fault", shard=2, survivors=3)
        fr.record("dispatch_launch", queue="default", work="verify", error="")
        for i in range(20):
            fr.record("coalescer_flush", reason="window", requests=i, triples=4 * i)
        fr.record("mesh", event="restore", recovered=[2], active=4)
        assert fr.recent(kind="mesh")[-1]["event"] == "restore"
        assert len(fr.recent(n=3)) == 3 and len(fr) == 16
        path = fr.dump("test: drill/1", dir=str(dump_dir))
    finally:
        ll_mod.LAUNCHLOG, hl_mod._LEDGERS = saved, saved_heights
    assert path is not None and path.endswith("flightrec-test--drill-1-1.json")
    return fr_mod.FlightRecorder.load(path)


def test_flight_dump_equals_the_jax_dump(tmp_path):
    port = _flight_sequence(flightrec, launchlog, heightlog, tmp_path / "port")
    jax = _flight_sequence(J_flightrec, J_launchlog, J_heightlog, tmp_path / "jax")
    assert port.keys() == jax.keys() == {"node", "reason", "dumped_at", "events", "heights", "launches"}

    def untimed(d):
        return {**d, "dumped_at": None, "events": [{**e, "t": None} for e in d["events"]]}

    # both dumps embed the newest 32 height records across live ledgers
    assert untimed(port) == untimed(jax)
    assert [r["height"] for r in port["heights"]] == list(range(9, 41))
    assert {r["node"] for r in port["heights"]} == {"n0", "n1"}
    assert [r["rows"] for r in port["launches"]] == list(range(8, 40))
    assert [e["kind"] for e in port["events"]][-1] == "mesh"


def test_flight_dump_never_raises(tmp_path):
    fr = flightrec.FlightRecorder()
    assert fr.dump("x") is None  # nowhere to write
    blocker = tmp_path / "file"
    blocker.write_text("")
    assert fr.dump("x", dir=str(blocker / "sub")) is None


_SIGUSR2 = """
import os, signal, sys, time
from tendermint_tpu_torch.telemetry import flightrec, launchlog
flightrec.FLIGHT.set_dump_dir(sys.argv[1])
assert flightrec.install_signal_dump() and flightrec.install_signal_dump()
launchlog.LAUNCHLOG.record({"kind": "hash", "rows": 3})
flightrec.FLIGHT.record("breaker", breaker="hash", frm="closed", to="open")
print("armed", flush=True)
deadline = time.monotonic() + 30
while not os.listdir(sys.argv[1]) and time.monotonic() < deadline:
    time.sleep(0.01)
mods = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.") or m == "tendermint_tpu" or m.startswith("tendermint_tpu."))
print("dumped", os.listdir(sys.argv[1]), mods, flush=True)
"""


@pytest.mark.skipif(not hasattr(signal, "SIGUSR2"), reason="no SIGUSR2 on this platform")
def test_sigusr2_dumps_a_live_process(tmp_path):
    """In a process without the conftest: SIGUSR2 writes the black box,
    with the last launch records, and the process imports no jax."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", _SIGUSR2, str(tmp_path)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        assert first_line(proc, 60).strip() == "armed"
        proc.send_signal(signal.SIGUSR2)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-2000:]
    assert "[]" in out.splitlines()[-1]  # no jax, nothing of the JAX package
    (name,) = os.listdir(tmp_path)
    assert name == "flightrec-sigusr2-1.json"
    dump = json.loads((tmp_path / name).read_text())
    assert dump["reason"] == "sigusr2"
    assert dump["events"][-1]["kind"] == "breaker"
    assert dump["launches"][-1]["rows"] == 3 and dump["launches"][-1]["kind"] == "hash"


# -- logging ------------------------------------------------------------------------


def test_setup_logging_levels_and_format():
    import io
    import logging

    from tendermint_tpu.utils import log as J_log
    from tendermint_tpu_torch.utils import log

    root = logging.getLogger("tendermint_tpu")
    saved = (list(root.handlers), root.propagate, root.level, {
        name: logging.getLogger(name).level
        for name in list(logging.Logger.manager.loggerDict) if name.startswith("tendermint_tpu.")
    })
    buf = io.StringIO()
    try:
        log.setup_logging("mesh:info,*:error", stream=buf)
        log.kv(log.logger("mesh"), logging.INFO, 'shard "fault"', shard=2)
        log.kv(log.logger("resilient"), logging.INFO, "dropped")
        log.kv(log.logger("resilient"), logging.ERROR, "kept", kind="verify")
        lines = buf.getvalue().splitlines()
        assert len(lines) == 2
        assert lines[0].endswith("level=info module=mesh msg=\"shard 'fault'\" shard=2")
        assert lines[1].endswith('level=error module=resilient msg="kept" kind=verify')
        # one root for both packages: the JAX package's spec governs the port's loggers
        buf2 = io.StringIO()
        J_log.setup_logging("resilient:debug,*:error", stream=buf2)
        log.kv(log.logger("resilient"), logging.DEBUG, "seen")
        assert 'module=resilient msg="seen"' in buf2.getvalue()
    finally:
        handlers, propagate, level, levels = saved
        for h in list(root.handlers):
            root.removeHandler(h)
        for h in handlers:
            root.addHandler(h)
        root.propagate, root.level = propagate, level
        for name in list(logging.Logger.manager.loggerDict):
            if name.startswith("tendermint_tpu."):
                logging.getLogger(name).setLevel(levels.get(name, logging.NOTSET))


def test_height_ledger_is_exported_lazily():
    """`telemetry.HeightLedger` resolves to the port's height ledger on
    first use, as the JAX package's `telemetry/__init__.py` exports it,
    and a ledger's records reach the flight recorder's dumps."""
    import tendermint_tpu_torch.telemetry as telemetry

    assert "HeightLedger" in telemetry.__all__
    assert telemetry.HeightLedger is heightlog.HeightLedger
    led = telemetry.HeightLedger(node_id="lazy")
    led.record({"height": 3, "t_commit": time.time() + 1e6})
    try:
        assert heightlog.recent_records(1) == [{"height": 3, "t_commit": led.last()["t_commit"], "node": "lazy"}]
    finally:
        led.close()
