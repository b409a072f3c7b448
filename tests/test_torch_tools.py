"""The port's operator tools (`tendermint_tpu_torch/tools/`) against the
repo's `tools/` on the CPU.

The five readers (`finality_report`, `trace_timeline`,
`contention_report`, `gossip_report`, `device_report`) read seeded
inputs made here with numpy and `random` (launch records, height-ledger
records, span logs with flight dumps, gossip dumps, profile dumps, each
with overlapping copies and torn lines), and then a port node's own
`launches.jsonl`, `heights.jsonl`, `spans.jsonl` and `dump_telemetry`
views: each JAX tool's loaders, `build_report` and `render_text`, and
its `main` with `--json`, give what the port's give on the same files.
The load generator runs in process on `--device cpu` (signed and plain
payloads), against a port node's RPC (writes, and light-client reads
with walks), and raises without a card when no device is named; the
state-sync demo restores a snapshot past a corrupted peer. Tolerance:
exact (text and JSON)."""

from __future__ import annotations

import contextlib
import io
import json
import pathlib
import random
import time

import numpy as np
import pytest

from tendermint_tpu_torch.testing import lockrank_report, time_limit_fixture
from tendermint_tpu_torch.tools import contention_report as P_cr
from tendermint_tpu_torch.tools import device_report as P_dr
from tendermint_tpu_torch.tools import finality_report as P_fr
from tendermint_tpu_torch.tools import gossip_report as P_gr
from tendermint_tpu_torch.tools import loadgen as P_lg
from tendermint_tpu_torch.tools import statesync_demo as P_sd
from tendermint_tpu_torch.tools import trace_timeline as P_tt
from tools import contention_report as J_cr
from tools import device_report as J_dr
from tools import finality_report as J_fr
from tools import gossip_report as J_gr
from tools import loadgen as J_lg
from tools import trace_timeline as J_tt

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

SEEDS = (0, 1, 2)
T0 = 1_790_000_000.0


def _run_main(main, argv) -> tuple[int, str]:
    """`main(argv)`'s exit code and standard output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _both(jmain, pmain, argv, out: pathlib.Path | None = None):
    """Each package's `main(argv)`: exit code, stdout and (`out`: the
    file `--json` names) the JSON it wrote, the JAX tool's first."""
    runs = []
    for main in (jmain, pmain):
        if out is not None and out.exists():
            out.unlink()
        rc, text = _run_main(main, argv)
        runs.append((rc, text, json.loads(out.read_text()) if out is not None else None))
    return runs


def _write_jsonl(path: pathlib.Path, records, torn: bool = False) -> str:
    lines = [json.dumps(r) for r in records]
    if torn:
        lines.append('{"kind": "verify", "rows"')  # a torn tail
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _hex(rng) -> str:
    return rng.bytes(8).hex()


# -- seeded inputs ----------------------------------------------------------------


def launch_records(seed: int, n: int, nodes: list[str], traces=()) -> list[dict]:
    """Launch-ledger records as `telemetry/launchlog.py` writes them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = str(rng.choice(["verify", "tables", "hash", "leaf_hashes"]))
        rows = int(rng.integers(1, 4096))
        stages = {k: float(rng.uniform(0, 0.02)) for k in ("queue_wait_s", "host_prep_s", "in_flight_s",
                                                          "finalize_s")}
        rec = {
            "kind": kind,
            "backend": str(rng.choice(["device", "tables", "host", "mesh"])),
            "rows": rows,
            "rows_padded": int(rng.integers(0, 512)) if rng.random() < 0.6 else 0,
            "rows_cached": int(rng.integers(0, 64)) if rng.random() < 0.3 else 0,
            "transfer_bytes": int(rng.integers(0, 1 << 22)),
            **stages,
            "total_s": round(sum(stages.values()) + float(rng.uniform(0, 0.01)), 6),
            "t": T0 + i * 0.05 + float(rng.uniform(0, 0.04)),
            "node": nodes[i % len(nodes)],
        }
        if rng.random() < 0.7:
            rec["queue"] = str(rng.choice(["coalescer", "window", "fastsync", "chunks"]))
        if rng.random() < 0.5:
            rec["compile"] = str(rng.choice(["hit", "miss"]))
            rec["compile_s"] = float(rng.uniform(0, 0.5)) if rec["compile"] == "miss" else 0.0
        if rng.random() < 0.2:
            rec["device_put_s"] = float(rng.uniform(0, 0.01))
        if rng.random() < 0.5:
            rec["consumers"] = {str(c): int(rng.integers(1, 5))
                                for c in rng.choice(["consensus", "mempool", "lightclient", "evidence"],
                                                    size=int(rng.integers(1, 3)), replace=False)}
        if rng.random() < 0.05:
            rec["error"] = "InjectedDeviceFault"
        if traces and rng.random() < 0.4:
            rec["trace"] = traces[int(rng.integers(0, len(traces)))]
        out.append(rec)
    return out


def height_records(seed: int, heights: int, nodes: list[str]) -> list[dict]:
    """Height-ledger records as `telemetry/heightlog.py` writes them."""
    rng = np.random.default_rng(seed + 100)
    out = []
    for h in range(1, heights + 1):
        for node in nodes:
            phases = {}
            for name in ("new_height", "propose", "prevote", "precommit", "commit", "apply"):
                if name == "apply" and rng.random() < 0.3:
                    continue
                wait, work = float(rng.uniform(0, 0.2)), float(rng.uniform(0, 0.05))
                phases[name] = {"s": wait + work, "wait_s": wait, "work_s": work}
            t_commit = T0 + h + float(rng.uniform(0, 0.1))
            rec = {
                "height": h,
                "node": node,
                "round": int(rng.integers(0, 2)),
                "txs": int(rng.integers(0, 100)),
                "t_start": t_commit - 1.0,
                "t_commit": t_commit,
                "height_s": sum(p["s"] for p in phases.values()),
                "finality_s": None if h == 1 else float(rng.uniform(0.2, 1.5)),
                "phases": phases,
                "critical_path": str(rng.choice(["vote_gather", "propose", "apply", "commit_wait"])),
            }
            if rng.random() < 0.7:
                rec["laggard"] = {"validator": _hex(rng)[:6], "delay_s": float(rng.uniform(0, 0.3))}
            if rng.random() < 0.3:
                rec["pipelined"] = True
                rec["apply_overlap_s"] = float(rng.uniform(0, 0.05))
            out.append(rec)
    return out


SPAN_NAMES = tuple(J_tt.STAGES) + ("p2p.send", "custom.thing", "wal.fsync")


def span_log(seed: int, n: int, nodes: list[str], traces: list[str]) -> list[dict]:
    rng = np.random.default_rng(seed + 200)
    out = []
    for i in range(n):
        start = T0 + i * 0.01 + float(rng.uniform(0, 0.005))
        attrs = {"height": int(rng.integers(1, 6))}
        if rng.random() < 0.6:
            attrs["trace"] = traces[int(rng.integers(0, len(traces)))]
        if rng.random() < 0.5:
            attrs["node"] = nodes[int(rng.integers(0, len(nodes)))]
        elif rng.random() < 0.5:
            attrs["origin"] = nodes[int(rng.integers(0, len(nodes)))][:12]
        if rng.random() < 0.3:
            attrs["result"] = "ok"
        end = start + float(rng.uniform(0, 0.02))
        out.append({"name": str(rng.choice(SPAN_NAMES)), "start": start, "end": end,
                    "duration_s": end - start, "attrs": attrs})
    return out


def flight_dump(seed: int, node: str, n: int) -> dict:
    rng = np.random.default_rng(seed + 300)
    events = [{"t": T0 + float(rng.uniform(0, 1)), "kind": str(rng.choice(["breaker", "invariant", "halt"])),
               "height": int(rng.integers(1, 6)), "detail": _hex(rng)} for _ in range(n)]
    return {"reason": "seeded", "node": node, "events": events}


def gossip_view(seed: int, idx: int, keys: list[str]) -> dict:
    rng = np.random.default_rng(seed * 10 + idx + 400)

    def traffic():
        return {"send_msgs": int(rng.integers(0, 500)), "send_bytes": int(rng.integers(0, 1 << 20)),
                "recv_msgs": int(rng.integers(0, 500)), "recv_bytes": int(rng.integers(0, 1 << 20))}

    view = {
        "node_id": _hex(rng) + _hex(rng),
        "channels": {c: traffic() for c in ("cns_vote", "cns_data", "cns_state", "mempool", "evidence")
                     if rng.random() < 0.85},
        "kinds": {k: traffic() for k in ("vote", "block_part", "tx", "evidence_list", "has_vote")},
        "redundant": {k: {"msgs": int(rng.integers(0, 50)), "bytes": int(rng.integers(0, 1 << 16))}
                      for k in ("vote", "block_part", "tx", "evidence") if rng.random() < 0.6},
        "first_seen": {k: T0 + float(rng.uniform(0, 0.5)) for k in keys if rng.random() < 0.8},
    }
    if rng.random() < 0.5:
        view["moniker"] = f"val-{idx}"
    return view


def profile_dump(seed: int) -> dict:
    rng = np.random.default_rng(seed + 500)
    subs = {}
    for sub in ("consensus", "ingress", "coalescer", "dispatch", "p2p_send", "main", "other", "rpc"):
        if rng.random() < 0.85:
            subs[sub] = {"on_cpu": int(rng.integers(0, 300)), "blocked": int(rng.integers(0, 300)),
                         "blocked_by": {r: int(rng.integers(1, 50))
                                        for r in ("lock", "queue", "io", "sleep") if rng.random() < 0.6}}
    locks = [{"lock": f"lock.{i}", "wait_s": float(rng.uniform(0, 2)), "wait_count": int(rng.integers(1, 900)),
              "wait_max_s": float(rng.uniform(0, 0.1)), "hold_s": float(rng.uniform(0, 3)),
              "top_sites": [{"site": f"mod.py:{int(rng.integers(1, 900))}", "count": int(rng.integers(1, 90))}]
              if rng.random() < 0.8 else []}
             for i in range(int(rng.integers(0, 4)))]

    def waits():
        return {k: {"count": int(rng.integers(1, 500)), "p50_ms": round(float(rng.uniform(0, 5)), 3),
                    "p99_ms": round(float(rng.uniform(5, 50)), 3), "total_s": round(float(rng.uniform(0, 9)), 3)}
                for k in ("", "fastsync", "default") if rng.random() < 0.6}

    return {"profile": {
        "profiler": {
            "samples": int(sum(r["on_cpu"] + r["blocked"] for r in subs.values())),
            "ticks": int(rng.integers(100, 1000)), "hz": 97, "cpu_clock": bool(rng.random() < 0.7),
            "subsystems": subs,
            "threads": {f"t{i}": {"samples": int(rng.integers(1, 99))} for i in range(3)},
            "top_stacks": [{"stack": ";".join(f"f{int(x)}" for x in rng.integers(0, 30, size=4)),
                            "count": int(rng.integers(1, 60))} for _ in range(int(rng.integers(0, 8)))],
        },
        "locks": {"locks": locks},
        "queues": {q: waits() for q in ("consensus", "ingress", "coalescer", "dispatch", "p2p_send")
                   if rng.random() < 0.7},
    }}


# -- the readers on seeded inputs -------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_device_report_equals_the_jax_tool(seed, tmp_path):
    nodes = [random.Random(seed).randbytes(10).hex() for _ in range(3)]
    recs = launch_records(seed, 90, nodes)
    paths = [_write_jsonl(tmp_path / f"n{i}-launches.jsonl", recs[i::3], torn=i == 0) for i in range(3)]
    # a ledger dump and a flight dump that overlap the files (deduped)
    (tmp_path / "launchledger-x.json").write_text(json.dumps({"records": recs[:20]}))
    (tmp_path / "flightrec-x.json").write_text(json.dumps({"launches": recs[10:30], "events": []}))
    inputs = paths + [str(tmp_path / "launchledger-*.json"), str(tmp_path / "flightrec-x.json")]
    loaded = J_dr.load_ledgers(inputs)
    assert P_dr.load_ledgers(inputs) == loaded and len(loaded) == len(recs)
    report = J_dr.build_report(loaded)
    assert P_dr.build_report(loaded) == report
    assert report["verdict"]["top_waste_source"] in P_dr._FIXES
    assert P_dr.render_text(report) == J_dr.render_text(report)
    out = tmp_path / "report.json"
    (jrc, jtext, jjson), (prc, ptext, pjson) = _both(J_dr.main, P_dr.main, ["--ledgers", *inputs, "--json", str(out)],
                                                     out)
    assert jrc == prc == 0 and ptext == jtext and pjson == jjson
    assert "verdict: top waste source is" in ptext
    # no records: the verdict's other branch
    empty = _both(J_dr.main, P_dr.main, ["--ledgers", str(tmp_path / "none.jsonl")])
    assert empty[0] == empty[1] and "no launches recorded" in empty[1][1]


@pytest.mark.parametrize("seed", SEEDS)
def test_finality_report_equals_the_jax_tool(seed, tmp_path):
    nodes = [f"node{i}" for i in range(4)]
    recs = height_records(seed, 9, nodes)
    paths = [_write_jsonl(tmp_path / f"node{i}-heights.jsonl", [r for r in recs if r["node"] == n], torn=i == 1)
             for i, n in enumerate(nodes)]
    # a dump overlapping the files, with records that carry no node
    dump = {"reason": "x", "ledgers": [{"node": "node2", "records": [
        {k: v for k, v in r.items() if k != "node"} for r in recs if r["node"] == "node2"][:4]}]}
    (tmp_path / "heightledger-x-1.json").write_text(json.dumps(dump))
    inputs = [str(tmp_path / "node*-heights.jsonl"), str(tmp_path / "heightledger-*.json")]
    loaded = J_fr.load_records(inputs)
    assert P_fr.load_records(inputs) == loaded and len(loaded) == len(recs)
    for kwargs in ({}, {"height": 4}, {"last": 3}):
        report = J_fr.build_report(loaded, **kwargs)
        assert P_fr.build_report(loaded, **kwargs) == report
        assert P_fr.render_text(report) == J_fr.render_text(report)
    for extra in ([], ["--json"], ["--height", "2", "--json"], ["--last", "2"]):
        (jrc, jtext, _), (prc, ptext, _) = _both(J_fr.main, P_fr.main, ["--ledgers", *paths, *extra])
        assert jrc == prc == 0 and ptext == jtext
    assert "laggard" in ptext and "summary:" in ptext


@pytest.mark.parametrize("seed", SEEDS)
def test_trace_timeline_equals_the_jax_tool(seed, tmp_path):
    rng = np.random.default_rng(seed)
    nodes = [_hex(rng) for _ in range(3)]
    traces = [_hex(rng) for _ in range(4)]
    spans = span_log(seed, 150, nodes, traces)
    # every node's log holds every span, as in a harness of one process
    span_paths = [_write_jsonl(tmp_path / f"n{i}-spans.jsonl", spans[i * 20:] + spans[: i * 20], torn=i == 2)
                  for i in range(3)]
    flights = []
    for i, node in enumerate(nodes):
        path = tmp_path / f"flightrec-{i}.json"
        path.write_text(json.dumps(flight_dump(seed + i, node, 12)))
        flights.append(str(path))
    launches = _write_jsonl(tmp_path / "launches.jsonl", launch_records(seed, 40, nodes, traces))
    loaded = J_tt.load_spans(span_paths) + J_tt.load_launches([launches])
    assert P_tt.load_spans(span_paths) + P_tt.load_launches([launches]) == loaded
    assert P_tt.load_flight(flights) == J_tt.load_flight(flights)
    events = J_tt.load_flight(flights)
    for kwargs in ({}, {"trace_id": traces[0]}, {"height": 3}, {"trace_id": traces[1], "height": 2}):
        tl = J_tt.build_timeline(loaded, events, **kwargs)
        assert P_tt.build_timeline(loaded, events, **kwargs) == tl
        assert P_tt.render_text(tl) == J_tt.render_text(tl)
    base = ["--spans", str(tmp_path / "n*-spans.jsonl"), "--flight", *flights, "--launches", launches]
    for extra in (["--trace", traces[2]], ["--trace", traces[2], "--json"], ["--height", "4", "--json"],
                  ["--trace", "0" * 16]):
        (jrc, jtext, _), (prc, ptext, _) = _both(J_tt.main, P_tt.main, base + extra)
        assert jrc == prc == 0 and ptext == jtext
    assert ptext == "(empty timeline)\n"


@pytest.mark.parametrize("seed", SEEDS)
def test_gossip_report_equals_the_jax_tool(seed, tmp_path):
    keys = [f"vote/{h}/{r}" for h in range(1, 6) for r in range(3)]
    views = [gossip_view(seed, i, keys) for i in range(4)]
    shapes = (lambda v: v, lambda v: {"gossip": v}, lambda v: {"result": {"gossip": v}}, lambda v: v)
    paths = []
    for i, (view, shape) in enumerate(zip(views, shapes)):
        path = tmp_path / f"node{i}-gossip.json"
        path.write_text(json.dumps(shape(view)))
        paths.append(str(path))
    (tmp_path / "bad.json").write_text("not json")
    inputs = paths + [str(tmp_path / "bad.json")]
    loaded = J_gr.load_dumps(inputs)
    assert P_gr.load_dumps(inputs) == loaded and len(loaded) == 4
    placement = ["us-east", "eu-west", "us-east", "ap-south"]
    for pl in (None, placement, placement[:2]):
        report = J_gr.build_report(loaded, pl)
        assert P_gr.build_report(loaded, pl) == report
        assert P_gr.render_text(report) == J_gr.render_text(report)
    out = tmp_path / "report.json"
    for extra in ([], ["--placement", ",".join(placement)]):
        (jrc, jtext, jjson), (prc, ptext, pjson) = _both(J_gr.main, P_gr.main,
                                                         ["--dumps", *inputs, *extra, "--json", str(out)], out)
        assert jrc == prc == 0 and ptext == jtext and pjson == jjson
    assert "verdict: top waste source is" in ptext


@pytest.mark.parametrize("seed", SEEDS)
def test_contention_report_equals_the_jax_tool(seed, tmp_path):
    dump = profile_dump(seed)
    path = tmp_path / "dump.json"
    path.write_text(json.dumps(dump))
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps(dump["profile"]))
    for d in (dump, dump["profile"]):
        assert P_cr._profile_of(d) == J_cr._profile_of(d)
    profile = J_cr._profile_of(dump)
    report = J_cr.build_report(profile)
    assert P_cr.build_report(profile) == report
    assert P_cr.render_text(report) == J_cr.render_text(report)
    assert P_cr.collapsed_lines(profile) == J_cr.collapsed_lines(profile)
    assert P_cr.collapsed_lines(report) == J_cr.collapsed_lines(report)
    out, col = tmp_path / "report.json", tmp_path / "out.collapsed"
    for src in (path, bare):
        runs = _both(J_cr.main, P_cr.main, ["--dump", str(src), "--json", str(out), "--collapsed", str(col)], out)
        assert runs[0] == runs[1] and runs[1][0] == 0
    errors = []
    for mod in (J_cr, P_cr):
        with pytest.raises(ValueError) as e:
            mod._profile_of({"metrics": {}})
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# -- on a port node's own output --------------------------------------------------


@pytest.fixture(scope="module")
def port_home(tmp_path_factory):
    """A solo port node on the CPU whose verifier launches every batch
    (minimum device batch 0) and whose every tx is traced, run to height
    5 with three txs; its RPC's `dump_telemetry` views (gossip, profile,
    launches) saved beside its home while it ran. Yields the home and
    the two loadgen runs against its RPC (writes and reads)."""
    from tendermint_tpu_torch.cmd import main as cli_main
    from tendermint_tpu_torch.config import Config
    from tendermint_tpu_torch.node import Node
    from tendermint_tpu_torch.services.batcher import CoalescingVerifier
    from tendermint_tpu_torch.services.resilient import ResilientVerifier
    from tendermint_tpu_torch.services.verifier import TableBatchVerifier
    from tendermint_tpu_torch.telemetry.profiler import PROFILER
    from tendermint_tpu_torch.telemetry import tracectx

    tmp = tmp_path_factory.mktemp("port_home")
    home = str(tmp / "solo")
    rc, _ = _run_main(cli_main, ["init", "--home", home, "--chain-id", "tools-test"])
    assert rc == 0
    cfg = Config.test_config(home)
    verifier = CoalescingVerifier(ResilientVerifier(TableBatchVerifier(device="cpu", min_device_batch=0)))
    node = Node(cfg, device="cpu", verifier=verifier)
    tracectx.force_all(True)
    PROFILER.start(hz=97)
    node.start()
    runs = {}
    try:
        addr = f"127.0.0.1:{node.rpc_port}"
        from tendermint_tpu_torch.rpc.client import HTTPClient

        client = HTTPClient(addr, timeout=60.0)
        for i in range(3):
            res = client.broadcast_tx_commit(b"tool-%d=v%d" % (i, i))
            assert res["deliver_tx"]["code"] == 0, res
        # the loadgen's writes and reads against the node's RPC (plain
        # payloads: a signed one waits here for a `ladder` window in plain
        # torch on the CPU, seconds a window)
        runs["write"] = _run_main(P_lg.main, ["--rpc", addr, "--rate", "20", "--duration", "0.5", "--threads", "2"])
        runs["write_jax"] = _run_main(J_lg.main, ["--rpc", addr, "--rate", "20", "--duration", "0.5",
                                                  "--threads", "2"])
        node.wait_height(5)
        runs["reads"] = _run_main(P_lg.main, ["--reads", "--rpc", addr, "--walk-prob", "0.3", "--rate", "10",
                                              "--duration", "1", "--threads", "2", "--device", "cpu"])
        for name, params in (("gossip", {"gossip": 1}), ("profile", {"profile": 1}),
                             ("launches", {"launches": 512})):
            dump = client._call("dump_telemetry", spans=0, **params)
            (tmp / f"{name}.json").write_text(json.dumps(dump))
        runs["addr"] = addr
        yield pathlib.Path(home), tmp, runs
    finally:
        node.stop()
        PROFILER.stop()
        tracectx.force_all(False)
        verifier.coalescer.close()


def test_the_reports_agree_on_a_port_nodes_ledgers(port_home, tmp_path):
    home, tmp, _runs = port_home
    data = home / "data"
    launches, heights, spans = (str(data / f) for f in ("launches.jsonl", "heights.jsonl", "spans.jsonl"))
    out = tmp_path / "report.json"
    (jrc, jtext, jjson), (prc, ptext, pjson) = _both(J_dr.main, P_dr.main, ["--ledgers", launches, "--json", str(out)],
                                                     out)
    assert jrc == prc == 0 and ptext == jtext and pjson == jjson
    assert {"tables", "verify"} <= set(pjson["kinds"]) and pjson["verdict"]["top_waste_source"]
    # the rollup is the node's ledger's own `summarize`
    from tendermint_tpu_torch.telemetry.launchlog import summarize

    recs = [json.loads(line) for line in pathlib.Path(launches).read_text().splitlines()]
    assert pjson["kinds"] == json.loads(json.dumps(summarize(recs)))
    for extra in ([], ["--json"]):
        (jrc, jtext, _), (prc, ptext, _) = _both(J_fr.main, P_fr.main, ["--ledgers", heights, *extra])
        assert jrc == prc == 0 and ptext == jtext
    report = json.loads(ptext)
    assert list(report["heights"]) == [str(h) for h in range(1, len(report["heights"]) + 1)]
    # a traced tx, from its admission to its commit
    admitted = [json.loads(line) for line in pathlib.Path(spans).read_text().splitlines()]
    trace = next(s["attrs"]["trace"] for s in admitted if s["name"] == "mempool.admission")
    for extra in (["--trace", trace], ["--trace", trace, "--json"], ["--height", "2", "--json"]):
        (jrc, jtext, _), (prc, ptext, _) = _both(J_tt.main, P_tt.main, ["--spans", spans, "--launches", launches,
                                                                         *extra])
        assert jrc == prc == 0 and ptext == jtext
    stages = {e["stage"] for e in json.loads(_both(J_tt.main, P_tt.main, ["--spans", spans, "--trace", trace,
                                                                          "--json"])[1][1])["entries"]}
    assert {"admission", "commit"} <= stages, stages


def test_the_reports_agree_on_a_port_nodes_dumps(port_home, tmp_path):
    _home, tmp, runs = port_home
    out = tmp_path / "report.json"
    runs_g = _both(J_gr.main, P_gr.main, ["--dumps", str(tmp / "gossip.json"), "--json", str(out)], out)
    assert runs_g[0] == runs_g[1] and runs_g[1][0] == 0 and runs_g[1][2]["verdict"]["top_waste_source"]
    runs_c = _both(J_cr.main, P_cr.main, ["--dump", str(tmp / "profile.json"), "--json", str(out)], out)
    assert runs_c[0] == runs_c[1] and runs_c[1][0] == 0 and runs_c[1][2]["samples"] > 0
    assert runs_c[1][2]["verdict"]["move_out_first"]
    dump = json.loads((tmp / "launches.json").read_text())
    records = dump["launches"]["records"]
    assert records and P_dr.build_report(records) == J_dr.build_report(records)
    assert P_dr.build_report(records)["kinds"] == dump["launches"]["summary"]


# -- the load generator -----------------------------------------------------------

LOADGEN_KEYS = {"offered_rate", "duration_s", "threads", "payload_bytes", "signed", "dup_prob", "hot_prob", "mode",
                "walk_prob", "submitted", "resolved", "achieved_checktx_per_s", "outcomes", "late_arrivals",
                "admission_p50_ms", "admission_p99_ms"}


def test_loadgen_against_a_port_nodes_rpc(port_home):
    _home, _tmp, runs = port_home
    (rc, text), (jrc, jtext) = runs["write"], runs["write_jax"]
    assert rc == jrc == 0
    out, jout = json.loads(text), json.loads(jtext)
    assert set(out) == set(jout) == LOADGEN_KEYS
    assert out["mode"] == jout["mode"] == "rpc"
    assert out["resolved"] == out["submitted"] == 10 and out["outcomes"] == {"ok": 10}
    # the JAX tool, run second with the same arguments, sent the same
    # payloads: the node's cache answers each as a duplicate
    assert jout["resolved"] == jout["submitted"] == 10 and jout["outcomes"] == {"duplicate": 10}
    same = ("offered_rate", "duration_s", "threads", "payload_bytes", "signed", "mode", "walk_prob", "submitted")
    assert {k: out[k] for k in same} == {k: jout[k] for k in same}
    rc, text = runs["reads"]
    reads = json.loads(text)
    assert rc == 0 and reads["mode"] == "reads" and reads["resolved"] == reads["submitted"] == 10
    assert "error" not in reads["outcomes"] and reads["outcomes"].get("walk", 0) >= 1, reads


@pytest.mark.parametrize("signed", [False, True])
def test_loadgen_in_process_on_the_cpu(signed):
    from tendermint_tpu_torch.services.verifier import default_verifier

    argv = ["--rate", "40", "--duration", "0.5", "--threads", "4", "--device", "cpu"]
    rc, text = _run_main(P_lg.main, argv + (["--signed", "--signers", "4"] if signed else []))
    out = json.loads(text)
    assert rc == 0 and set(out) == LOADGEN_KEYS
    assert out["mode"] == "batched" and out["signed"] is signed
    assert out["resolved"] == out["submitted"] == 20 and out["outcomes"] == {"ok": 20}
    # the mempool's close leaves the caller's stack open
    stack = default_verifier("cpu")
    assert stack.coalescer._running or not signed
    from tendermint_tpu_torch.crypto.keys import gen_priv_key

    priv = gen_priv_key(b"\x31" * 32)
    assert list(stack.verify_batch([(priv.pub_key.data, b"m", priv.sign(b"m"))])) == [True]


def test_the_tools_that_verify_raise_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run_main(P_lg.main, ["--rate", "10", "--duration", "0.1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run_main(P_sd.main, ["--nodes", "1", "--height", "2"])


def test_statesync_demo_restores_past_a_corrupted_peer(monkeypatch):
    from tendermint_tpu_torch.telemetry import REGISTRY
    from tendermint_tpu_torch.testing import nemesis

    nets = []

    class Recorded(nemesis.Nemesis):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            nets.append(self)

    monkeypatch.setattr(nemesis, "Nemesis", Recorded)

    def count(name, **labels):
        return REGISTRY.counter_value(name, **labels)

    corrupt0 = count("tendermint_statesync_chunks_total", result="corrupt")
    ok0 = count("tendermint_statesync_chunks_total", result="ok")
    from tendermint_tpu_torch.statesync.reactor import StateSyncReactor

    restores = []
    restore = StateSyncReactor._restore

    def recorded(self, manifest, decoded, anchor_fc):
        state = restore(self, manifest, decoded, anchor_fc)
        restores.append((manifest.height, state.last_block_height, state.app_hash, state.validators.hash(),
                         state.last_block_id))
        return state

    monkeypatch.setattr(StateSyncReactor, "_restore", recorded)
    rc, text = _run_main(P_sd.main, ["--device", "cpu", "--nodes", "2", "--chunk-size", "256"])
    assert rc == 0, text
    out = json.loads(text[text.index("{"):])
    (net,) = nets
    server, joiner = net.nodes[0], net.nodes[2]
    corrupted = int(text.split("corrupted ")[1].split()[0])
    manifest = joiner.node.statesync_reactor.restored_manifest
    assert corrupted >= manifest.chunks > 1
    # every chunk arrived intact once; the corrupt peer's chunk was blamed
    # (the peer dropped) and fetched again from the honest one
    assert count("tendermint_statesync_chunks_total", result="ok") - ok0 == manifest.chunks
    assert count("tendermint_statesync_chunks_total", result="corrupt") - corrupt0 >= 1
    # the restored state is the server's at the snapshot's height
    h = out["snapshot_height"]
    header = server.store.load_block(h + 1).header
    assert restores == [(h, h, header.app_hash, header.validators_hash, header.last_block_id)]
    top = min(server.store.height, joiner.store.height)
    assert top >= out["synced_height"] - 1 > h
    for height in range(h + 1, top + 1):
        assert joiner.store.load_block(height).hash() == server.store.load_block(height).hash()
    assert joiner.app._data.get(b"demo-key") == b"demo-val"


# -- the JAX package's live-net acceptance tests of two reports, on port nodes ----


def _coalescing_factory():
    """Each node's stack as a node composes it on the CPU: the coalescer
    and its signature cache over a resilient host verifier."""
    from tendermint_tpu_torch.services.batcher import CoalescingVerifier
    from tendermint_tpu_torch.services.resilient import ResilientVerifier
    from tendermint_tpu_torch.services.verifier import HostBatchVerifier

    def factory(_i):
        return CoalescingVerifier(ResilientVerifier(HostBatchVerifier(), max_retries=0), cache_size=4096)

    return factory


def _resilient_factory(threshold=2, reset_s=0.5):
    from tendermint_tpu_torch.services.resilient import ResilientVerifier
    from tendermint_tpu_torch.services.verifier import HostBatchVerifier
    from tendermint_tpu_torch.utils.circuit import CircuitBreaker

    def factory(_i):
        return ResilientVerifier(HostBatchVerifier(),
                                 breaker=CircuitBreaker(failure_threshold=threshold, reset_timeout_s=reset_s),
                                 max_retries=0)

    return factory


def _pump(net, seed: bytes, tag: bytes, limit: int, pause: float):
    """A thread that admits signed txs at nodes 0 and 1 until stopped."""
    import itertools
    import threading

    from tendermint_tpu_torch.crypto.keys import gen_priv_key
    from tendermint_tpu_torch.mempool import make_signed_tx

    priv = gen_priv_key(seed * 32)
    stop = threading.Event()

    def pump():
        for i in itertools.count():
            if stop.is_set() or i >= limit:
                return
            tx = make_signed_tx(priv, b"%s-%d=%d" % (tag, i, i))
            net.nodes[i % 2].node.mempool.check_tx_async(tx, lambda res: None)
            time.sleep(pause)

    thread = threading.Thread(target=pump, daemon=True)
    thread.start()
    return stop, thread


@pytest.mark.slow
def test_live_net_loadgen_device_report(tmp_path, monkeypatch):
    """`tests/test_launchlog.py::TestDeviceObservatoryAcceptance` on four
    port nodes under signed traffic: every coalesced launch through the
    coalescing and resilient stack is one ledger record, and the port's
    `device_report` over the node's `dump_telemetry` names the top waste
    source, as the repo's tool does on the same records."""
    import urllib.request

    from tendermint_tpu_torch.telemetry import REGISTRY
    from tendermint_tpu_torch.telemetry.launchlog import LAUNCHLOG
    from tendermint_tpu_torch.testing.nemesis import Nemesis

    # the ledger's ring keeps every record of the run (four nodes' vote
    # and ingress launches outgrow its default 1,024 within the run)
    monkeypatch.setattr(LAUNCHLOG, "capacity", 1 << 16)
    fam = REGISTRY.get("tendermint_batcher_coalesce_factor")
    coalesce0 = fam._child0().value["count"]
    with Nemesis(4, home=str(tmp_path), node_factory=Nemesis.full_node_factory(),
                 verifier_factory=_coalescing_factory(), device="cpu") as net:
        net.wait_height(2, timeout=90)
        stop, thread = _pump(net, b"\x66", b"dev", 600, 0.003)
        try:
            net.wait_progress(delta=3, timeout=120)
        finally:
            stop.set()
            thread.join(10)
        deadline = time.monotonic() + 30
        launches, recs = 0, []
        while time.monotonic() < deadline:
            launches = fam._child0().value["count"] - coalesce0
            recs = [r for r in LAUNCHLOG.recent() if r.get("queue") == "coalescer"]
            if launches > 0 and len(recs) == launches:
                break
            time.sleep(0.25)
        assert launches > 0, "no coalesced launches under the load"
        assert len(recs) == launches, (len(recs), launches)
        for rec in recs:
            assert rec["kind"] == "verify" and rec["backend"] == "host" and rec["rows"] > 0 and rec["consumers"]
        addr = f"127.0.0.1:{net.nodes[0].rpc_port}"
        records = P_dr.fetch_launches_rpc(addr, n=512)
        assert records
        report = P_dr.build_report(records)
        assert report == J_dr.build_report(records)
        assert report["launches"] > 0 and "verify" in report["kinds"]
        assert report["verdict"]["top_waste_source"] in P_dr._FIXES
        text = P_dr.render_text(report)
        assert text == J_dr.render_text(report)
        assert "device observatory" in text and "verdict:" in text
        with urllib.request.urlopen(f"http://{addr}/health", timeout=10) as resp:
            health = json.load(resp)
        assert health["device"]["last_launch_age_s"] is not None


@pytest.mark.slow
def test_live_net_loadgen_contention_report(tmp_path):
    """`tests/test_profiler.py::TestContentionAcceptance` on four port
    nodes under signed traffic, profiled through a breaker trip: the
    profiler survives, and the port's `contention_report` over the node's
    `dump_telemetry?profile=1` names the most-contended lock, the dominant
    blocked subsystem and the move-out-first verdict, as the repo's tool
    does on the same view."""
    from tendermint_tpu_torch.telemetry.profiler import PROFILER
    from tendermint_tpu_torch.testing.nemesis import Nemesis
    from tendermint_tpu_torch.utils import fail, lockrank

    PROFILER.reset()
    lockrank.reset_contention()
    PROFILER.start(hz=97)
    try:
        with Nemesis(4, home=str(tmp_path), node_factory=Nemesis.full_node_factory(),
                     verifier_factory=_resilient_factory(), device="cpu") as net:
            net.wait_height(2, timeout=90)
            stop, thread = _pump(net, b"\x55", b"prof", 1500, 0.004)
            try:
                time.sleep(0.5)
                fail.set_device_fault("verify")
                net.wait_progress(delta=1, timeout=90)
                fail.clear_device_faults()
                net.wait_progress(delta=2, timeout=90)
            finally:
                stop.set()
                thread.join(10)
                fail.clear_device_faults()
            assert PROFILER.running(), "the profiler thread died"
            profile = P_cr.fetch_profile_rpc(f"127.0.0.1:{net.nodes[0].rpc_port}")["profile"]
            report = P_cr.build_report(profile)
            assert report == J_cr.build_report(profile)
            assert report["samples"] > 50
            assert "consensus" in {r["subsystem"] for r in report["waterfall"]}
            lock = report["most_contended_lock"]
            assert lock is not None and lock["lock"] and lock["wait_count"] > 0
            dom = report["dominant_blocked_subsystem"]
            assert dom is not None and dom["subsystem"]
            assert report["verdict"]["move_out_first"] not in ("main", "other")
            text = P_cr.render_text(report)
            assert text == J_cr.render_text(report)
            assert "most-contended lock: " + lock["lock"] in text and "verdict: " in text
            lines = P_cr.collapsed_lines(profile)
            assert lines and lines == J_cr.collapsed_lines(profile)
            assert "dispatch" in profile["queues"]
    finally:
        PROFILER.stop()
        PROFILER.reset()
        lockrank.reset_contention()
