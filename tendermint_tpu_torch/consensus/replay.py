"""Handshake / block replay on startup (reference `consensus/replay.go`).

Recovery path (b) of SURVEY.md §5.4: on boot the app reports its
(height, app_hash) over ABCI Info; the Handshaker reconciles app vs
block store vs state by replaying stored blocks into the app, including
the delicate store == state+1 cases:

* app committed the final block but state didn't save → replay it
  against a mock app built from the saved ABCIResponses (so the real
  app, already at H, is never re-mutated) — reference `:284-289,362-398`;
* state saved but app didn't commit → replay the final block for real.
"""

from __future__ import annotations

from tendermint_tpu_torch.abci.application import Application
from tendermint_tpu_torch.abci.client import AppConns, local_client_creator
from tendermint_tpu_torch.abci.types import Result, Validator as ABCIValidator
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.state import apply_block, exec_commit_block
from tendermint_tpu_torch.state.state import ABCIResponses, State
from tendermint_tpu_torch.types.errors import ValidationError


class HandshakeError(ValidationError):
    pass


class _StoredResponsesApp(Application):
    """Mock app replaying saved ABCIResponses (reference mockProxyApp):
    DeliverTx/EndBlock answer from the stored responses; Commit returns
    the app hash the real app already reported."""

    def __init__(self, app_hash: bytes, responses: ABCIResponses) -> None:
        self._app_hash = app_hash
        self._responses = responses
        self._tx_index = 0

    def deliver_tx(self, tx: bytes) -> Result:
        res = self._responses.deliver_tx[self._tx_index]
        self._tx_index += 1
        return res

    def end_block(self, height: int) -> list[ABCIValidator]:
        if height != self._responses.height:
            raise HandshakeError(
                f"mock app EndBlock height {height} != stored {self._responses.height}"
            )
        return self._responses.end_block_changes

    def commit(self) -> Result:
        return Result(data=self._app_hash)


class Handshaker:
    def __init__(self, state: State, store: BlockStore, verifier=None) -> None:
        self.state = state
        self.store = store
        self.verifier = verifier
        self.n_blocks_replayed = 0

    def handshake(self, app_conns: AppConns) -> bytes:
        """Sync the app with the store/state; returns the final app hash
        (reference `Handshake :196-221`)."""
        info = app_conns.query.info_sync()
        app_height = info.last_block_height
        app_hash = info.last_block_app_hash
        if app_height < 0:
            raise HandshakeError(f"app reported negative height {app_height}")
        app_hash = self.replay_blocks(app_hash, app_height, app_conns)
        return app_hash

    def replay_blocks(self, app_hash: bytes, app_height: int, app_conns: AppConns) -> bytes:
        """Reference `ReplayBlocks :225-296`."""
        store_height = self.store.height
        state_height = self.state.last_block_height

        if app_height == 0:
            # genesis: tell the app the initial validator set
            validators = [
                ABCIValidator(pub_key=v.pub_key.data, power=v.voting_power)
                for v in self.state.validators.validators
            ]
            app_conns.consensus.init_chain_sync(validators)

        if store_height == 0:
            return app_hash

        if store_height < state_height:
            raise HandshakeError(
                f"block store height {store_height} < state height {state_height}"
            )
        if store_height > state_height + 1:
            raise HandshakeError(
                f"block store height {store_height} > state height {state_height}+1"
            )

        if store_height == state_height:
            # replay all missing blocks into the app, no state changes
            if app_height > store_height:
                raise HandshakeError(
                    f"app height {app_height} > store height {store_height}"
                )
            return self._replay_to_app(app_height, store_height, app_conns, app_hash)

        # store_height == state_height + 1: the final block is saved but
        # not applied to state
        if app_height == store_height:
            # app committed the final block; replay it against the mock
            # app from saved ABCIResponses so state catches up
            responses = self.state.load_abci_responses(store_height)
            if responses is None:
                raise HandshakeError(
                    f"no saved ABCIResponses for final block {store_height}"
                )
            mock_conns = local_client_creator(
                _StoredResponsesApp(app_hash, responses)
            )()
            self._apply_final_block(mock_conns, store_height)
            return app_hash

        # app is at or behind state: replay into app up to state height,
        # then apply the final block for real
        app_hash = self._replay_to_app(app_height, state_height, app_conns, app_hash)
        self._apply_final_block(app_conns, store_height)
        return app_conns.query.info_sync().last_block_app_hash

    def _replay_to_app(
        self, app_height: int, target: int, app_conns: AppConns, app_hash: bytes
    ) -> bytes:
        for h in range(app_height + 1, target + 1):
            block = self.store.load_block(h)
            if block is None:
                raise HandshakeError(f"missing block {h} in store")
            app_hash = exec_commit_block(app_conns.consensus, block)
            self.n_blocks_replayed += 1
        # cross-check the store's app-hash chain (header H+1 carries
        # the app hash after block H)
        meta = self.store.load_block_meta(target + 1)
        if meta is not None and meta.header.app_hash != app_hash:
            raise HandshakeError(
                f"app hash after replay to {target} is {app_hash.hex()}, "
                f"but header {target + 1} expects {meta.header.app_hash.hex()}"
            )
        return app_hash

    def _apply_final_block(self, app_conns: AppConns, height: int) -> None:
        block = self.store.load_block(height)
        meta = self.store.load_block_meta(height)
        if block is None or meta is None:
            raise HandshakeError(f"missing final block {height}")
        apply_block(
            self.state,
            block,
            meta.block_id.parts_header,
            app_conns.consensus,
            verifier=self.verifier,
        )
        self.n_blocks_replayed += 1
