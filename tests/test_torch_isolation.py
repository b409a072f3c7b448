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
declared differences (`DECLARED`)."""

from __future__ import annotations

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

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
}


@pytest.mark.parametrize("rel", NODE_MODULES)
def test_node_modules_stand_where_the_jax_package_has_them(rel):
    port, jax = PORT / rel, REPO / "tendermint_tpu" / rel
    assert port.is_file() and jax.is_file()
    bad = [(line, n) for line, n, _ in _imports(port) if _forbidden(n) or _is(n, "cryptography") or _is(n, "grpc")]
    assert not bad, bad


@pytest.mark.parametrize("rel", NODE_MODULES)
def test_node_modules_are_the_jax_modules_apart_from_the_declared_differences(rel):
    text = (REPO / "tendermint_tpu" / rel).read_text()
    for jax_src, port_src in DECLARED.get(rel, ()):
        assert text.count(jax_src) == 1, (rel, jax_src)
        text = text.replace(jax_src, port_src)
    assert _code(PORT / rel) == _code(REPO / "tendermint_tpu" / rel, text)


def test_a_declared_difference_is_needed():
    """Without its declared differences, each such module differs from
    its JAX counterpart: every entry of DECLARED is still needed."""
    for rel in DECLARED:
        assert _code(PORT / rel) != _code(REPO / "tendermint_tpu" / rel), rel


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
