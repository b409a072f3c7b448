"""Light-client Provider backed by a live node's RPC (reference
`certifiers/client/provider.go`).

Fetches FullCommits over the `/commit` + `/validators` routes so an
external light client can feed directly from a running node — the
missing half that made Mem/File providers test-only. `store_commit` is
a no-op (the node is the source of truth); compose with a caching
provider (Mem/File) via the Inquiring certifier for persistence.

The port's copy of `tendermint_tpu/certifiers/node_provider.py`. It
imports the port's `rpc.client` inside its methods and is not exported
from `certifiers/__init__.py`, as in the JAX package.
"""

from __future__ import annotations

from tendermint_tpu_torch.certifiers.certifier import FullCommit
from tendermint_tpu_torch.certifiers.provider import Provider
from tendermint_tpu_torch.crypto.keys import PubKey
from tendermint_tpu_torch.types.block import Commit, Header
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.part_set import PartSetHeader
from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet
from tendermint_tpu_torch.types.vote import Vote


def _block_id_from_json(d: dict) -> BlockID:
    return BlockID(
        hash=bytes.fromhex(d["hash"]),
        parts_header=PartSetHeader(
            total=int(d["parts"]["total"]),
            hash=bytes.fromhex(d["parts"]["hash"]),
        ),
    )


def header_from_json(d: dict) -> Header:
    return Header(
        chain_id=d["chain_id"],
        height=int(d["height"]),
        time=int(d["time"]),
        num_txs=int(d["num_txs"]),
        last_block_id=_block_id_from_json(d["last_block_id"]),
        last_commit_hash=bytes.fromhex(d["last_commit_hash"]),
        data_hash=bytes.fromhex(d["data_hash"]),
        validators_hash=bytes.fromhex(d["validators_hash"]),
        app_hash=bytes.fromhex(d["app_hash"]),
    )


def commit_from_json(d: dict) -> Commit:
    precommits: list[Vote | None] = []
    for v in d["precommits"]:
        if v is None:
            precommits.append(None)
            continue
        precommits.append(
            Vote(
                validator_address=bytes.fromhex(v["validator_address"]),
                validator_index=int(v["validator_index"]),
                height=int(v["height"]),
                round=int(v["round"]),
                timestamp=int(v["timestamp"]),
                type=int(v["type"]),
                block_id=_block_id_from_json(v["block_id"]),
                signature=bytes.fromhex(v["signature"]),
            )
        )
    return Commit(block_id=_block_id_from_json(d["block_id"]), precommits=precommits)


def validator_set_from_json(vals: list[dict]) -> ValidatorSet:
    return ValidatorSet(
        [
            Validator(
                address=bytes.fromhex(v["address"]),
                pub_key=PubKey(bytes.fromhex(v["pub_key"])),
                voting_power=int(v["voting_power"]),
            )
            for v in vals
        ]
    )


class NodeProvider(Provider):
    """Provider over a node RPC client (HTTPClient or LocalClient)."""

    def __init__(self, client) -> None:
        self._client = client

    def store_commit(self, fc: FullCommit) -> None:  # noqa: B027
        pass  # the node already has it; persistence belongs to a cache

    def _fetch(self, height: int) -> FullCommit | None:
        res = self._client.commit(height)
        if "header" not in res:
            return None
        return FullCommit(
            header=header_from_json(res["header"]),
            commit=commit_from_json(res["commit"]),
            validators=validator_set_from_json(
                self._client.validators(height)["validators"]
            ),
        )

    def get_by_height(self, height: int) -> FullCommit | None:
        from tendermint_tpu_torch.rpc.client import RPCClientError

        try:
            return self._fetch(height)
        except RPCClientError:
            # node answered "no commit at that exact height" — fall back to
            # the newest one not above it (the provider contract). Transport
            # and parse failures propagate: a flaky node must not be
            # indistinguishable from a missing height.
            latest = self.latest_commit()
            if latest is not None and latest.height() <= height:
                return latest
            return None

    def latest_commit(self) -> FullCommit | None:
        from tendermint_tpu_torch.rpc.client import RPCClientError

        try:
            h = int(self._client.status()["sync_info"]["latest_block_height"])
        except RPCClientError:
            return None
        if h < 1:
            return None
        return self._fetch(h)
