"""The port stands alone: no module of `tendermint_tpu_torch`, and not
`chip_smoke.py`, imports jax or anything of the `tendermint_tpu`
package. (`tendermint_tpu_torch` itself starts with `tendermint_tpu`, so
names are matched exactly or by the `tendermint_tpu.` prefix.) Nor does
any of them import `cryptography`, which a host with the card need not have: the
SecretConnection runs on the port's own X25519, HKDF and
ChaCha20-Poly1305. `grpc` is imported only inside the functions of
`abci/grpc_transport.py` and `rpc/grpc_api.py`, never at module level.
The read path's modules (light client, state sync, RPC, the node
provider, health, views, profiler) and the node's (config, node, cmd,
pex, addrbook, upnp, process telemetry, replay console) exist under the
JAX names, each the JAX module apart from docstrings and the node's
declared differences (`DECLARED`); so do the chaos book's and the
operator tools' (`BOOK_MODULES`, `TOOL_MODULES`), whose tools' JAX files
are the repo's `tools/`, and each tool runs as
`python -m tendermint_tpu_torch.tools.<name>` without jax."""

from __future__ import annotations

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
from tendermint_tpu_torch.testing import time_limit_fixture

# each test fails past this many seconds, with every thread's stack on
# stderr, where a wait that never ends would hold its worker for good
_time_limit = pytest.fixture(autouse=True)(time_limit_fixture(180))

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "tendermint_tpu_torch"


def _forbidden(name: str) -> bool:
    return (
        name == "jax"
        or name.startswith("jax.")
        or name == "tendermint_tpu"
        or name.startswith("tendermint_tpu.")
    )


def _port_sources() -> list[pathlib.Path]:
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env.pop("PYTHONSTARTUP", None)
    return env


def test_forbidden_name_matching():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("tendermint_tpu") and _forbidden("tendermint_tpu.ops")
    assert not _forbidden("tendermint_tpu_torch")
    assert not _forbidden("tendermint_tpu_torch.ops.ed25519_kernel")
    assert not _forbidden("jaxlib_free")


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_lines(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def _imports(path: pathlib.Path):
    """(line, module name, inside a function) for every absolute import."""
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []

    def visit(node, in_fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                found.extend((child.lineno, a.name, in_fn) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                found.append((child.lineno, child.module or "", in_fn))
            visit(child, in_fn or isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)))

    visit(tree, False)
    return found


def _is(name: str, package: str) -> bool:
    return name == package or name.startswith(package + ".")


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_cryptography_import(path):
    bad = [(line, n) for line, n, _ in _imports(path) if _is(n, "cryptography")]
    assert not bad, f"{path.name} imports cryptography at {bad}"


# the modules that may import grpc, each only inside its functions
GRPC_MODULES = (PORT / "abci" / "grpc_transport.py", PORT / "rpc" / "grpc_api.py")


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_grpc_only_inside_functions_of_the_grpc_transport(path):
    uses = [(line, in_fn) for line, n, in_fn in _imports(path) if _is(n, "grpc")]
    if path in GRPC_MODULES:
        assert uses and all(in_fn for _, in_fn in uses), uses
    else:
        assert not uses, f"{path.name} imports grpc at {uses}"


READ_PATH_MODULES = (
    "telemetry/profiler.py", "telemetry/views.py", "telemetry/health.py",
    "lightclient/cache.py", "lightclient/bisect.py", "lightclient/evidence.py", "lightclient/reactor.py",
    "lightclient/__init__.py", "statesync/snapshot.py", "statesync/trust.py", "statesync/reactor.py",
    "statesync/__init__.py", "rpc/server.py", "rpc/websocket.py", "rpc/core.py", "rpc/client.py",
    "rpc/grpc_api.py", "rpc/__init__.py", "certifiers/node_provider.py",
)


@pytest.mark.parametrize("rel", READ_PATH_MODULES)
def test_read_path_modules_stand_where_the_jax_package_has_them(rel):
    port, jax = PORT / rel, REPO / "tendermint_tpu" / rel
    assert port.is_file() and jax.is_file()
    bad = [(line, n) for line, n, _ in _imports(port) if _forbidden(n) or _is(n, "cryptography")]
    assert not bad, bad


def _code(path: pathlib.Path, text: str | None = None) -> str:
    """The module's AST (of `text` in place of the file's, when given)
    without its docstrings, the port's package name read as the JAX
    package's."""
    tree = ast.parse(path.read_text() if text is None else text)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)) and body
                and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree).replace("tendermint_tpu_torch", "tendermint_tpu")


@pytest.mark.parametrize("rel", READ_PATH_MODULES)
def test_read_path_modules_are_the_jax_modules_apart_from_docstrings(rel):
    assert _code(PORT / rel) == _code(REPO / "tendermint_tpu" / rel)


NODE_MODULES = (
    "version.py", "__main__.py", "telemetry/process.py", "config/__init__.py", "p2p/addrbook.py",
    "p2p/pex.py", "p2p/upnp.py", "node/__init__.py", "node/node.py", "consensus/replay_console.py", "cmd.py",
)

# the class `tools/loadgen.py` defines and its port imports (`testing/loadgen.py`)
_LOADGEN = (REPO / "tools" / "loadgen.py").read_text()
_LOADGEN_TX_FACTORY = _LOADGEN[_LOADGEN.index("class TxFactory:"):_LOADGEN.index("class Stats:")]

# The node's deliberate differences from the JAX modules, as (JAX source,
# port source) pairs: with each applied to the JAX module's text, its AST
# must equal the port module's apart from docstrings.
DECLARED = {
    # `Node(..., device=None)`: verifier=None and hasher=None resolve to
    # the card's stack (or `device`'s), never a host backend
    "node/node.py": (
        ("        hasher=None,\n    ) -> None:", "        hasher=None,\n        device=None,\n    ) -> None:"),
        ("verifier = default_verifier()", "verifier = default_verifier(device)"),
        ("hasher = auto_hasher()", "hasher = auto_hasher(device)"),
    ),
    # the port's SecretConnection needs no `cryptography`
    "config/__init__.py": (
        ("""        cfg.statesync.giveup_time_s = 20.0
        try:
            import cryptography  # noqa: F401
        except ImportError:
            # X25519/AEAD transport crypto deliberately has NO pure-Python
            # fallback (unlike signing, `crypto/ed25519_ref.py`); in test
            # environments without the library, run links unencrypted so
            # the p2p/node matrices still exercise everything else.
            # Production configs keep secret_connections=True and fail
            # loudly if the library is missing.
            cfg.p2p.secret_connections = False
""", "        cfg.statesync.giveup_time_s = 20.0\n"),
    ),
    # `--device` on node, replay and replay_console; no persistent XLA
    # cache (`ops/_build.py`'s kernel library is the counterpart)
    "cmd.py": (
        ("""    from tendermint_tpu.utils.jax_cache import enable_persistent_cache

    # kernels (table builds, verify, merkle) compile once per MACHINE:
    # restarts deserialize from the on-disk executable cache
    enable_persistent_cache()
""", ""),
        ("node = Node(cfg)", "node = Node(cfg, device=args.device)"),
        ("make_replay_cs_factory(cfg)", "make_replay_cs_factory(cfg, device=args.device)"),
        ("""        "--fast-sync", type=lambda s: s.lower() != "false", default=None
    )
""", """        "--fast-sync", type=lambda s: s.lower() != "false", default=None
    )
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
"""),
        ("""    p.add_argument("--wal", default="", help="WAL path (default: the home's)")
    p.set_defaults(fn=_cmd_replay, console=False)""", """    p.add_argument("--wal", default="", help="WAL path (default: the home's)")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    p.set_defaults(fn=_cmd_replay, console=False)"""),
        ("""    p.add_argument("--wal", default="", help="WAL path (default: the home's)")
    p.set_defaults(fn=_cmd_replay, console=True)""", """    p.add_argument("--wal", default="", help="WAL path (default: the home's)")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    p.set_defaults(fn=_cmd_replay, console=True)"""),
    ),
    # the replay's ConsensusState and handshake verify on
    # `default_verifier(device)`: a port ConsensusState given no verifier
    # takes the card's stack
    "consensus/replay_console.py": (
        ("def make_replay_cs_factory(config, app_factory=None, db_provider=None):",
         "def make_replay_cs_factory(config, app_factory=None, db_provider=None, device=None):"),
        ("""    \"\"\"

    def make_cs() -> ConsensusState:""", """    \"\"\"
    from tendermint_tpu.services.verifier import default_verifier

    verifier = default_verifier(device)

    def make_cs() -> ConsensusState:"""),
        ("Handshaker(st, store).handshake(app_conns)", "Handshaker(st, store, verifier=verifier).handshake(app_conns)"),
        ("ticker=MockTicker(fire_steps=()),  # records drive everything\n",
         "ticker=MockTicker(fire_steps=()),  # records drive everything\n            verifier=verifier,\n"),
    ),
    # the chaos book (`testing/`): `Nemesis`, its nodes and the scenario
    # runner take `device=` as the port's `Node` does; each run of a
    # `NemesisNode` given no verifier verifies on a signature cache and
    # coalescer of its own over `default_verifier(device)`'s backend, the
    # card's stack, closed when the node stops; `Nemesis.restart` waits
    # for the crashed node's links to drop (a switch refuses a peer id it
    # still holds)
    "testing/nemesis.py": (
        ("""_log = logger("nemesis")
""", """_log = logger("nemesis")

RESTART_DROP_TIMEOUT_S = 30.0
"""),
        ("""        hasher=None,
        app_factory=None,
    ) -> None:""", """        hasher=None,
        app_factory=None,
        device=None,
    ) -> None:"""),
        ("""        self.verifier = verifier
        self.hasher = hasher
        self.state_db = MemDB()""", """        self.verifier = verifier
        self.own_verifier = verifier is None
        self.device = device
        self.hasher = hasher
        self.state_db = MemDB()"""),
        ("""    def _build(self) -> None:
        from tendermint_tpu.abci.client import local_client_creator""", """    @staticmethod
    def own_stack(device):
        from tendermint_tpu.services.batcher import CoalescingVerifier
        from tendermint_tpu.services.verifier import default_verifier

        stack = default_verifier(device)
        return CoalescingVerifier(stack.inner) if isinstance(stack, CoalescingVerifier) else stack

    def _build(self) -> None:
        from tendermint_tpu.abci.client import local_client_creator"""),
        ("""        state = load_state(self.state_db)
        self.store = BlockStore(self.store_db)
        self.conns""", """        if self.own_verifier:
            self.verifier = self.own_stack(self.device)
        state = load_state(self.state_db)
        self.store = BlockStore(self.store_db)
        self.conns"""),
        ("""            self.height_ledger.close()
            self.running = False""", """            self.height_ledger.close()
            if self.own_verifier and hasattr(self.verifier, "coalescer"):
                self.verifier.coalescer.close()
            self.running = False"""),
        ("""        node = self.nodes[i]
        node.restart()""", """        node = self.nodes[i]
        self.wait_dropped(i)
        node.restart()"""),
        ("""    def add_node(self, node) -> int:""", """    def wait_dropped(self, i: int, timeout: float = RESTART_DROP_TIMEOUT_S) -> None:
        name = self.nodes[i].switch.node_info.node_id
        deadline = time.monotonic() + timeout
        while any(
            name in {p.id for p in n.switch.peers()}
            for j, n in enumerate(self.nodes)
            if j != i and n.running
        ):
            if time.monotonic() > deadline:
                raise TimeoutError(f"node{i}'s links still up {timeout} s after its crash")
            time.sleep(0.01)

    def add_node(self, node) -> int:"""),
        ("""        app_factory=None,
        config_mutator=None,
    ) -> None:""", """        app_factory=None,
        config_mutator=None,
        device=None,
    ) -> None:"""),
        ("""        self.hasher = hasher
        self._dbs""", """        self.hasher = hasher
        self.device = device
        self._dbs"""),
        ("""            hasher=self.hasher,
        )
""", """            hasher=self.hasher,
            device=self.device,
        )
"""),
        ("""        n_active: int | None = None,
    ) -> None:
        import tempfile
""", """        n_active: int | None = None,
        device=None,
    ) -> None:
        import tempfile
"""),
        ("""                hasher=hasher_factory(i) if hasher_factory else None,
            )""", """                hasher=hasher_factory(i) if hasher_factory else None,
                device=device,
            )"""),
        ("""        def factory(i, genesis, privs, home, chain_id, config=None, verifier=None, hasher=None):
            return NemesisNode(""", """        def factory(i, genesis, privs, home, chain_id, config=None, verifier=None, hasher=None, device=None):
            return NemesisNode("""),
        ("""                app_factory=app_factory,
            )

        return factory""", """                app_factory=app_factory,
                device=device,
            )

        return factory"""),
        ("""        def factory(i, genesis, privs, home, chain_id, config=None, verifier=None, hasher=None):
            return FullNemesisNode(""", """        def factory(i, genesis, privs, home, chain_id, config=None, verifier=None, hasher=None, device=None):
            return FullNemesisNode("""),
        ("""                config_mutator=config_mutator,
            )""", """                config_mutator=config_mutator,
                device=device,
            )"""),
    ),
    # the evidence poll sleeps between its reads of the stores: a poll
    # without a pause holds the GIL from the nodes it waits on
    "testing/byzantine.py": (
        ("""        if len(found) == len(targets):
            return found
""", """        if len(found) == len(targets):
            return found
        time.sleep(0.05)
"""),
    ),
    # the load feeder's `TxFactory` is the port's copy (`testing/loadgen.py`)
    "testing/scenario.py": (
        ("from tools.loadgen import TxFactory", "from tendermint_tpu.testing.loadgen import TxFactory"),
        ("""    def __init__(self, home: str | None = None) -> None:
        self.home = home
""", """    def __init__(self, home: str | None = None, device=None) -> None:
        self.home = home
        self.device = device
"""),
        ("""            node_factory=node_factory,
        )""", """            node_factory=node_factory,
            device=self.device,
        )"""),
        ("include_slow: bool = True) -> list[dict]:", "include_slow: bool = True, device=None) -> list[dict]:"),
        ("ScenarioRunner(home=home).run(spec)", "ScenarioRunner(home=home, device=device).run(spec)"),
        # the bridging probe's light client verifies on `default_verifier(device)`
        ("def bisect_bridge(node, chain_id: str, genesis_privs, tip: int | None = None) -> dict:",
         "def bisect_bridge(node, chain_id: str, genesis_privs, tip: int | None = None, device=None) -> dict:"),
        ("""    from tendermint_tpu.lightclient.bisect import BisectingCertifier
    from tendermint_tpu.state.state import load_state
""", """    from tendermint_tpu.lightclient.bisect import BisectingCertifier
    from tendermint_tpu.services.verifier import default_verifier
    from tendermint_tpu.state.state import load_state
"""),
        ("""        chain_id, validators=genesis_vals, height=0, source=source
    )""", """        chain_id, validators=genesis_vals, height=0, source=source,
        verifier=default_verifier(device),
    )"""),
        ("""                    net.nodes[0], net.chain_id, genesis_privs
                )""", """                    net.nodes[0], net.chain_id, genesis_privs, device=self.device
                )"""),
    ),
    # the book's entry points run as `python -m tendermint_tpu_torch.tools.*`:
    # no `sys.path` edit, and a `--device` flag
    "tools/scenario_run.py": (
        ("""import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
""", """import tempfile
"""),
        ("""    ap.add_argument("--home", default=None, help="scratch dir (default: tmp)")
""", """    ap.add_argument("--home", default=None, help="scratch dir (default: tmp)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
"""),
        ("ScenarioRunner(home=home).run(spec)", "ScenarioRunner(home=home, device=args.device).run(spec)"),
    ),
    "tools/nemesis_demo.py": (
        ("""import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
""", """import time
"""),
        ("""        node_factory=Nemesis.full_node_factory(),
        verifier_factory=verifier_factory,
    ) as net:""", """        node_factory=Nemesis.full_node_factory(),
        verifier_factory=verifier_factory,
        device=args.device,
    ) as net:"""),
        ("""        home=tempfile.mkdtemp(prefix="nemesis-byz-"),
        verifier_factory=verifier_factory,
    ) as net:""", """        home=tempfile.mkdtemp(prefix="nemesis-byz-"),
        verifier_factory=verifier_factory,
        device=args.device,
    ) as net:"""),
        ("""                3, FaultedApplyApp, args.nodes, fail_from_height=4
            )
        ),
    ) as net:""", """                3, FaultedApplyApp, args.nodes, fail_from_height=4
            )
        ),
        device=args.device,
    ) as net:"""),
        ("""                3, ForgedHashApp, args.nodes, fail_from_height=3
            )
        ),
    ) as net:""", """                3, ForgedHashApp, args.nodes, fail_from_height=3
            )
        ),
        device=args.device,
    ) as net:"""),
        ("""        args.nodes, home=home, node_factory=Nemesis.full_node_factory()
    ) as net:""", """        args.nodes, home=home, node_factory=Nemesis.full_node_factory(), device=args.device
    ) as net:"""),
        ("""                config_mutator=replica_mutator,
            )""", """                config_mutator=replica_mutator,
                device=args.device,
            )"""),
        ("reports = run_library(home=home, include_slow=not args.fast)",
         "reports = run_library(home=home, include_slow=not args.fast, device=args.device)"),
        ("""    ap.add_argument(
        "--fuzz-frames", type=int, default=5000, help="byzantine fuzz frame count"
    )
""", """    ap.add_argument(
        "--fuzz-frames", type=int, default=5000, help="byzantine fuzz frame count"
    )
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
"""),
        ("""        args.nodes, home=tempfile.mkdtemp(prefix="nemesis-demo-"),
        verifier_factory=verifier_factory,
    ) as net:""", """        args.nodes, home=tempfile.mkdtemp(prefix="nemesis-demo-"),
        verifier_factory=verifier_factory,
        device=args.device,
    ) as net:"""),
    ),
    # a GC collection that starts on a thread inside a read of the GC
    # families (their lock held) is recorded with the next collection, not
    # waited for: the JAX callback deadlocks that thread
    "telemetry/process.py": (
        ("""import threading
import time
""", """import threading
import time
from collections import deque
"""),
        ("""_gc_started_at: float | None = None
""", """_gc_started_at: float | None = None
_gc_pending: deque = deque()
"""),
        ("""    _m.PROCESS_GC_COLLECTIONS.labels(gen=str(info.get("generation", "?"))).inc()
    if started is not None:
        _m.PROCESS_GC_PAUSE.observe(time.perf_counter() - started)
""", """    _gc_pending.append(
        (str(info.get("generation", "?")), None if started is None else time.perf_counter() - started)
    )
    if _m.PROCESS_GC_COLLECTIONS.held_here() or _m.PROCESS_GC_PAUSE.held_here():
        return
    while _gc_pending:
        gen, pause = _gc_pending.popleft()
        _m.PROCESS_GC_COLLECTIONS.labels(gen=gen).inc()
        if pause is not None:
            _m.PROCESS_GC_PAUSE.observe(pause)
"""),
    ),
    # the operator tools run as `python -m tendermint_tpu_torch.tools.*`:
    # no `sys.path` edit (nor the `os` import only it used); the device
    # report's rollup is the port's `telemetry/launchlog.py` `summarize`
    "tools/gossip_report.py": (
        ("""import urllib.request

import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
""", """import urllib.request
"""),
    ),
    "tools/device_report.py": (
        ("""import urllib.request

import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
""", """import urllib.request
"""),
    ),
    # the load generator: its `TxFactory` is the scenario library's
    # (`testing/loadgen.py`, held to the tool's class below), and the
    # in-process mempool and the `--reads` walks verify on
    # `default_verifier(--device)`
    "tools/loadgen.py": (
        ("""import json
import os
import random
""", """import json
import random
"""),
        ("sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))",
         "from tendermint_tpu.testing.loadgen import TxFactory"),
        (_LOADGEN_TX_FACTORY, ""),
        ("    verifier = default_verifier()\n", "    verifier = default_verifier(args.device)\n"),
        ("""        from tendermint_tpu.rpc.client import HTTPClient
""", """        from tendermint_tpu.rpc.client import HTTPClient
        from tendermint_tpu.services.verifier import default_verifier
"""),
        ("""            source=NodeProvider(HTTPClient(target)),
        )""", """            source=NodeProvider(HTTPClient(target)),
            verifier=default_verifier(args.device),
        )"""),
        ("""                    "verify-to-height walk (fresh client bootstrap)")
""", """                    "verify-to-height walk (fresh client bootstrap)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
"""),
    ),
    # the state-sync demo: no `sys.path` edit and no JAX_PLATFORMS
    # default; its serving net and its joiner take `--device`, as
    # `nemesis_demo`'s nets do
    "tools/statesync_demo.py": (
        ("""import json
import os
import sys
""", """import json
import sys
"""),
        ("""sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
""", ""),
        ("""    ap.add_argument("--no-corruption", action="store_true")
""", """    ap.add_argument("--no-corruption", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
"""),
        ("""        node_factory=Nemesis.full_node_factory(config_mutator=serving),
    ) as net:""", """        node_factory=Nemesis.full_node_factory(config_mutator=serving),
        device=args.device,
    ) as net:"""),
        ("""            config_mutator=joining,
        )""", """            config_mutator=joining,
            device=args.device,
        )"""),
    ),
    # the package also exports the fixtures the port's tests and
    # `chip_smoke.py` share (`testing/fixtures.py`)
    "testing/__init__.py": (
        ("from tendermint_tpu.testing.nemesis import (\n",
         "from tendermint_tpu.testing.fixtures import *  # noqa: F401,F403\n"
         "from tendermint_tpu.testing.fixtures import __all__ as _FIXTURES\n"
         "from tendermint_tpu.testing.nemesis import (\n"),
        ('    "wait_evidence_committed",\n]', '    "wait_evidence_committed",\n    *_FIXTURES,\n]'),
    ),
}


# the chaos book (`testing/`) and its two entry points, whose JAX files
# are the repo's `tools/`
BOOK_MODULES = (
    "testing/__init__.py", "testing/topology.py", "testing/nemesis.py", "testing/byzantine.py",
    "testing/scenario.py", "tools/scenario_run.py", "tools/nemesis_demo.py",
)


# the operator tools, whose JAX files are the repo's `tools/` too
TOOL_MODULES = (
    "tools/finality_report.py", "tools/trace_timeline.py", "tools/contention_report.py", "tools/gossip_report.py",
    "tools/device_report.py", "tools/loadgen.py", "tools/statesync_demo.py",
)


def _jax_file(rel: str) -> pathlib.Path:
    return REPO / rel if rel.startswith("tools/") else REPO / "tendermint_tpu" / rel


@pytest.mark.parametrize("rel", NODE_MODULES + BOOK_MODULES + TOOL_MODULES)
def test_node_modules_stand_where_the_jax_package_has_them(rel):
    port, jax = PORT / rel, _jax_file(rel)
    assert port.is_file() and jax.is_file()
    bad = [(line, n) for line, n, _ in _imports(port) if _forbidden(n) or _is(n, "cryptography") or _is(n, "grpc")]
    assert not bad, bad


@pytest.mark.parametrize("rel", NODE_MODULES + BOOK_MODULES + TOOL_MODULES)
def test_node_modules_are_the_jax_modules_apart_from_the_declared_differences(rel):
    text = _jax_file(rel).read_text()
    for jax_src, port_src in DECLARED.get(rel, ()):
        assert text.count(jax_src) == 1, (rel, jax_src)
        text = text.replace(jax_src, port_src)
    assert _code(PORT / rel) == _code(_jax_file(rel), text)


def test_a_declared_difference_is_needed():
    """Without its declared differences, each such module differs from
    its JAX counterpart: every entry of DECLARED is still needed."""
    for rel in DECLARED:
        assert _code(PORT / rel) != _code(_jax_file(rel)), rel


def test_node_provider_stays_out_of_the_certifiers_exports():
    """As in the JAX package: `certifiers/__init__.py` does not export
    `NodeProvider`, which reaches `rpc.client` lazily."""
    import tendermint_tpu_torch.certifiers as certifiers

    assert not hasattr(certifiers, "NodeProvider")
    assert not [n for _, n, _ in _imports(PORT / "certifiers" / "__init__.py") if "node_provider" in n or ".rpc" in n]
    lazy = [(line, n, in_fn) for line, n, in_fn in _imports(PORT / "certifiers" / "node_provider.py")
            if _is(n, "tendermint_tpu_torch.rpc")]
    assert lazy and all(in_fn for _, _, in_fn in lazy), lazy


def test_import_scanner_sees_nested_and_module_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import os\nimport grpc\ndef f():\n    import grpc.aio\n    from cryptography import x\n")
    assert _imports(probe) == [(1, "os", False), (2, "grpc", False), (4, "grpc.aio", True), (5, "cryptography", True)]


def test_importing_every_port_module_loads_no_jax():
    code = """
import importlib, pkgutil, sys
import tendermint_tpu_torch as pkg
# `__main__` runs the command line when imported: its imports are held
# by the import-line checks above
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".") if m.name != pkg.__name__ + ".__main__"]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.")
    or m == "tendermint_tpu" or m.startswith("tendermint_tpu.")
    or m == "cryptography" or m.startswith("cryptography.")
    or m == "grpc" or m.startswith("grpc.")
)
assert not bad, bad
assert len(names) >= 10, names
print("OK", len(names))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


def test_chip_smoke_fails_without_a_card():
    """On a machine without CUDA the script exits non-zero and prints no
    result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script cannot find the port and exits non-zero with no result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _env()
    env.pop("PYTHONPATH")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_the_load_generator_is_the_tools_tx_factory():
    """`testing/loadgen.py` holds the repo's `tools/loadgen.py` `TxFactory`,
    its AST apart from docstrings, and nothing else but its imports."""

    def tx_factory(path):
        (cls,) = [n for n in ast.parse(path.read_text()).body if isinstance(n, ast.ClassDef)
                  and n.name == "TxFactory"]
        return _code(path, ast.unparse(cls))

    port = PORT / "testing" / "loadgen.py"
    assert tx_factory(port) == tx_factory(REPO / "tools" / "loadgen.py")
    body = ast.parse(port.read_text()).body[1:]  # past the docstring
    assert [type(n).__name__ for n in body] == ["ImportFrom", "Import", "Import", "ClassDef"]


# a one-node scenario the runner plays in a few seconds
_SOLO_SPEC = {"name": "solo", "nodes": 1, "run": {"target_height": 3, "timeout_s": 60}}


@pytest.mark.parametrize("tool", ["scenario_run", "nemesis_demo"])
def test_the_book_entry_points_run_as_modules_and_import_no_jax(tool, tmp_path):
    """`python -m tendermint_tpu_torch.tools.<tool> --device cpu` plays a
    one-node net to its end (exit code 0), and `-X importtime` lists no
    module of jax, of the JAX package, of `cryptography` or `grpc`."""
    import json

    spec = tmp_path / "solo.json"
    spec.write_text(json.dumps(_SOLO_SPEC))
    args = {
        "scenario_run": ["--spec", str(spec), "--home", str(tmp_path / "home")],
        "nemesis_demo": ["--nodes", "1", "--heights", "1"],
    }[tool]
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", f"tendermint_tpu_torch.tools.{tool}", *args, "--device", "cpu"],
        cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=180,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    imported = {line.rsplit("|", 1)[1].strip() for line in out.stderr.splitlines()
                if line.startswith("import time:") and line.count("|") == 2}
    assert "tendermint_tpu_torch.testing.nemesis" in imported
    bad = sorted(m for m in imported if _forbidden(m) or _is(m, "cryptography") or _is(m, "grpc"))
    assert not bad, bad
    assert ("solo  PASS" if tool == "scenario_run" else "all invariants held") in out.stdout, out.stdout[-2000:]


def _tool_inputs(tool: str, tmp_path) -> list:
    """A tool's arguments on one-record inputs under `tmp_path`."""
    import json

    rec = {
        "launches": {"kind": "verify", "backend": "device", "rows": 4, "t": 1.0, "total_s": 0.5, "queue": "coalescer"},
        "heights": {"height": 1, "node": "n0", "t_commit": 1.0, "finality_s": 0.5, "critical_path": "vote_gather",
                    "phases": {"propose": {"s": 0.1, "wait_s": 0.1, "work_s": 0.0}}},
        "spans": {"name": "mempool.admission", "start": 1.0, "end": 1.5, "attrs": {"trace": "ab" * 8}},
        "gossip": {"channels": {"cns_vote": {"send_msgs": 1, "send_bytes": 9, "recv_msgs": 1, "recv_bytes": 9}},
                   "kinds": {}, "redundant": {}},
        "profile": {"profile": {"profiler": {"samples": 2, "hz": 97, "subsystems": {
            "consensus": {"on_cpu": 1, "blocked": 1, "blocked_by": {"lock": 1}}}}, "locks": {"locks": []},
            "queues": {}}},
    }
    for name, value in rec.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(value) + "\n")
    # a JSONL ledger of two records (a file of one would read as a dump)
    (tmp_path / "launches.json").write_text(json.dumps(rec["launches"]) + "\n" + json.dumps(
        dict(rec["launches"], t=2.0)) + "\n")
    return {
        "finality_report": ["--ledgers", str(tmp_path / "heights.json")],
        "trace_timeline": ["--spans", str(tmp_path / "spans.json"), "--trace", "ab" * 8],
        "contention_report": ["--dump", str(tmp_path / "profile.json")],
        "gossip_report": ["--dumps", str(tmp_path / "gossip.json")],
        "device_report": ["--ledgers", str(tmp_path / "launches.json")],
        "loadgen": ["--rate", "20", "--duration", "0.2", "--threads", "2", "--device", "cpu"],
        "statesync_demo": ["--nodes", "1", "--height", "3", "--interval", "2", "--device", "cpu"],
    }[tool]


# what each tool prints once it has run to its end
_TOOL_DONE = {
    "finality_report": "summary: 1 heights x 1 nodes", "trace_timeline": "1 entries", "contention_report": "verdict:",
    "gossip_report": "verdict: top waste source", "device_report": "verdict: top waste source",
    "loadgen": '"resolved": 4', "statesync_demo": '"restores_ok": 1.0',
}


@pytest.mark.parametrize("tool", [rel[len("tools/"):-len(".py")] for rel in TOOL_MODULES])
def test_the_operator_tools_run_as_modules_and_import_no_jax(tool, tmp_path):
    """`python -m tendermint_tpu_torch.tools.<tool>` (with `--device cpu`
    where it verifies) runs to its end (exit code 0) on small inputs, and
    `-X importtime` lists no module of jax, of the JAX package, of
    `cryptography` or `grpc`."""
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", f"tendermint_tpu_torch.tools.{tool}", *_tool_inputs(tool, tmp_path)],
        cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    imported = {line.rsplit("|", 1)[1].strip() for line in out.stderr.splitlines()
                if line.startswith("import time:") and line.count("|") == 2}
    assert "tendermint_tpu_torch.tools" in imported
    bad = sorted(m for m in imported if _forbidden(m) or _is(m, "cryptography") or _is(m, "grpc"))
    assert not bad, bad
    assert _TOOL_DONE[tool] in out.stdout, out.stdout[-2000:]


# every name the port's tests and `chip_smoke.py` imported from the
# fixtures module `tendermint_tpu_torch/testing.py` before it became the
# package `testing/`
FIXTURE_NAMES = (
    "ChainSim", "MIXED_ZERO_LANE", "NetValidator", "ReadNode", "SignedChainSim", "StateSyncingNode",
    "StormValidator", "SyncingNode", "TEST_CHAIN_ID", "byzantine_signed_vote", "chain_store", "det_priv_keys",
    "device_flat_rows", "finish_edge_lanes", "finish_mixed_lanes", "forge_fullcommit", "forge_newest_precommit",
    "kernel_launches", "ledger_launches", "lockrank_report", "make_block_id", "make_commit", "make_genesis",
    "make_validators", "preloaded_reactor", "serving_switch", "signed_vote", "snapshot_server", "start_net",
)


def test_the_testing_package_keeps_the_fixtures_names():
    """Each name still imports from `tendermint_tpu_torch.testing`; the
    package-level `make_genesis` is the fixtures' (n_vals, power,
    chain_id), the nemesis one stays at `testing.nemesis`, and
    `forge_fullcommit` is the byzantine module's, as in the JAX package."""
    import inspect

    import tendermint_tpu_torch.testing as testing
    from tendermint_tpu_torch.testing import byzantine, fixtures, nemesis

    assert all(hasattr(testing, name) for name in FIXTURE_NAMES)
    assert set(FIXTURE_NAMES) <= set(testing.__all__)
    assert testing.make_genesis is fixtures.make_genesis
    assert list(inspect.signature(testing.make_genesis).parameters) == ["n_vals", "power", "chain_id"]
    assert list(inspect.signature(nemesis.make_genesis).parameters) == ["n_vals", "chain_id", "n_active"]
    assert testing.forge_fullcommit is byzantine.forge_fullcommit
    assert not hasattr(fixtures, "forge_fullcommit")
