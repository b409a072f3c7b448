"""ABCI message/result types (role of the abci repo's types package)."""

from __future__ import annotations

from dataclasses import dataclass


class CodeType:
    """Response codes (subset the node actually branches on)."""

    OK = 0
    INTERNAL_ERROR = 1
    ENCODING_ERROR = 2
    BAD_NONCE = 3
    UNAUTHORIZED = 4
    # Node-level (non-app) rejection: duplicate tx already in the mempool
    # cache (reference mempool.go:172-178 returns ErrTxInCache).
    TX_IN_CACHE = 5


@dataclass
class Result:
    """CheckTx/DeliverTx result: code + data + log."""

    code: int = CodeType.OK
    data: bytes = b""
    log: str = ""

    @property
    def is_ok(self) -> bool:
        return self.code == CodeType.OK

    def encode(self) -> bytes:
        from tendermint_tpu_torch.codec.binary import encode_bytes, encode_string, encode_uvarint

        return encode_uvarint(self.code) + encode_bytes(self.data) + encode_string(self.log)

    @classmethod
    def decode_from(cls, data: bytes, offset: int = 0) -> tuple["Result", int]:
        from tendermint_tpu_torch.codec.binary import decode_bytes, decode_string, decode_uvarint

        code, offset = decode_uvarint(data, offset)
        d, offset = decode_bytes(data, offset)
        log, offset = decode_string(data, offset)
        return cls(code, d, log), offset


def OK(data: bytes = b"", log: str = "") -> Result:
    return Result(CodeType.OK, data, log)


@dataclass
class ResultInfo:
    """Info response: the handshake reads last_block height/app-hash
    (reference `consensus/replay.go:199-204`)."""

    data: str = ""
    version: str = ""
    last_block_height: int = 0
    last_block_app_hash: bytes = b""


@dataclass
class ResultQuery:
    code: int = CodeType.OK
    index: int = -1
    key: bytes = b""
    value: bytes = b""
    proof: bytes = b""
    height: int = 0
    log: str = ""

    @property
    def is_ok(self) -> bool:
        return self.code == CodeType.OK


@dataclass
class Validator:
    """Validator-set diff entry flowing app->consensus via EndBlock
    (reference `state/execution.go:110-159`). power 0 removes."""

    pub_key: bytes = b""
    power: int = 0
