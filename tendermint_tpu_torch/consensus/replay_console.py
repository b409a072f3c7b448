"""Interactive / batch WAL replay — the ops tool for stepping a recorded
consensus WAL through a fresh state machine (reference
`consensus/replay_file.go:24-80` RunReplayFile + playback, CLI commands
`replay` / `replay_console`, `cmd/tendermint/commands/replay.go:9-26`).

The playback drives each WAL record through `ConsensusState._dispatch`
exactly like crash-recovery catchup does (`state.py` `_catchup_replay`),
but under manual control: `next [N]` steps records, `back [N]` rebuilds
the state machine from scratch and replays to count-N (the state machine
cannot step backwards), `rs [field]` inspects the live RoundState, `n`
prints the record count. Replaying writes through the real block/state
stores exactly like the reference's console does; point --home at a copy
to keep the original pristine.

The port's copy of `tendermint_tpu/consensus/replay_console.py`.
`make_replay_cs_factory(..., device=None)` verifies on
`default_verifier(device)`, the CUDA card's stack unless a device is
named, and hands it to the handshake and the ConsensusState: a port
ConsensusState given no verifier takes the card's stack, where the JAX
one takes the host.
"""

from __future__ import annotations

from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.consensus.wal import WAL, EndHeightMessage, RoundStateRecord


class Playback:
    """Stepper over a recorded WAL (reference `playback`,
    `replay_file.go:83-142`).

    `make_cs` builds a FRESH ConsensusState (new app conns + handshake)
    each time — called once up front and again on every `back`.
    """

    def __init__(self, make_cs, wal_path: str, out=print) -> None:
        self._make_cs = make_cs
        self._out = out
        self.cs: ConsensusState = make_cs()
        self.records = [
            rec
            for rec in WAL.iter_records(wal_path)
            if not isinstance(rec, (EndHeightMessage, RoundStateRecord))
        ]
        self.count = 0  # records applied so far

    # -- stepping ----------------------------------------------------------

    def _apply(self, rec) -> None:
        try:
            with self.cs._mtx:
                self.cs._dispatch(rec)
        except Exception as e:  # WAL'd-before-validation inputs may be bad
            self._out(f"record {self.count}: dispatch error: {e}")

    def step(self, n: int = 1) -> int:
        """Apply up to n records; returns how many were applied."""
        applied = 0
        while applied < n and self.count < len(self.records):
            self._apply(self.records[self.count])
            self.count += 1
            applied += 1
        return applied

    def run_all(self) -> int:
        return self.step(len(self.records) - self.count)

    def back(self, n: int = 1) -> None:
        """Rebuild from scratch and replay count-n records (reference
        `replayReset` — the state machine has no reverse gear)."""
        target = max(0, self.count - n)
        self._out(f"resetting from {self.count} to {target}")
        self.cs = self._make_cs()
        self.count = 0
        self.step(target)

    def done(self) -> bool:
        return self.count >= len(self.records)

    # -- inspection --------------------------------------------------------

    def round_state(self, field: str | None = None) -> str:
        rs = self.cs.get_round_state()
        if field is None:
            votes = rs.votes
            return (
                f"height={rs.height} round={rs.round} step={rs.step!r}\n"
                f"proposal={rs.proposal}\n"
                f"proposal_block={'set' if rs.proposal_block else None}\n"
                f"locked_round={rs.locked_round} "
                f"locked_block={'set' if rs.locked_block else None}\n"
                f"votes={votes.summary() if hasattr(votes, 'summary') else votes}"
            )
        if field == "short":
            return f"{rs.height}/{rs.round}/{rs.step!r}"
        if hasattr(rs, field):
            return repr(getattr(rs, field))
        return f"unknown field {field!r}"

    # -- console -----------------------------------------------------------

    def console(self, input_fn=input) -> None:
        """Interactive loop (reference `replayConsoleLoop`)."""
        self._out(
            f"{len(self.records)} records loaded. commands: "
            "next [N] | back [N] | rs [field|short] | n | quit"
        )
        while True:
            try:
                line = input_fn("> ")
            except EOFError:
                return
            tokens = line.strip().split()
            if not tokens:
                continue
            cmd, rest = tokens[0], tokens[1:]
            if cmd in ("quit", "exit", "q"):
                return
            elif cmd == "next":
                n = 1
                if rest:
                    try:
                        n = int(rest[0])
                    except ValueError:
                        self._out("next takes an integer argument")
                        continue
                if self.step(n) == 0:
                    self._out("end of WAL")
            elif cmd == "back":
                n = 1
                if rest:
                    try:
                        n = int(rest[0])
                    except ValueError:
                        self._out("back takes an integer argument")
                        continue
                if n > self.count:
                    self._out(
                        f"argument to back must not exceed the current "
                        f"count ({self.count})"
                    )
                    continue
                self.back(n)
            elif cmd == "rs":
                self._out(self.round_state(rest[0] if rest else None))
            elif cmd == "n":
                self._out(str(self.count))
            else:
                self._out(f"unknown command {cmd!r}")


def make_replay_cs_factory(config, app_factory=None, db_provider=None, device=None):
    """Factory-of-factories for the CLI: each call rebuilds app conns,
    handshakes the stores into the app, and returns a ConsensusState with
    no WAL, no signer, and a ticker whose timeouts never fire (the
    reference's replay ignores ticks — records drive every transition).
    """
    from tendermint_tpu_torch.services.verifier import default_verifier

    verifier = default_verifier(device)

    def make_cs() -> ConsensusState:
        from tendermint_tpu_torch.abci.apps import KVStoreApp
        from tendermint_tpu_torch.abci.client import local_client_creator
        from tendermint_tpu_torch.blockchain.store import BlockStore
        from tendermint_tpu_torch.consensus.replay import Handshaker
        from tendermint_tpu_torch.consensus.ticker import MockTicker
        from tendermint_tpu_torch.db.kv import SQLiteDB
        from tendermint_tpu_torch.state.state import load_state, make_genesis_state
        from tendermint_tpu_torch.types.genesis import GenesisDoc

        def _db(name):
            if db_provider is not None:
                return db_provider(name)
            return SQLiteDB(config.db_path(name))

        state_db = _db("state")
        st = load_state(state_db)
        if st is None:
            st = make_genesis_state(
                state_db, GenesisDoc.from_file(config.genesis_path())
            )
        store = BlockStore(_db("blockstore"))
        app = app_factory() if app_factory is not None else KVStoreApp()
        app_conns = local_client_creator(app)()
        Handshaker(st, store, verifier=verifier).handshake(app_conns)
        return ConsensusState(
            config.consensus,
            st,
            app_conns.consensus,
            store,
            ticker=MockTicker(fire_steps=()),  # records drive everything
            verifier=verifier,
        )

    return make_cs
