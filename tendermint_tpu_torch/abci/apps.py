"""Built-in example/test applications (reference `proxy/client.go:62-80`:
dummy = kvstore, persistent_dummy, counter, nilapp)."""

from __future__ import annotations

import json

from tendermint_tpu_torch.abci.application import Application
from tendermint_tpu_torch.abci.types import CodeType, Result, ResultInfo, ResultQuery, Validator
from tendermint_tpu_torch.crypto.hashing import tmhash
from tendermint_tpu_torch.db.kv import DB, MemDB


class KVStoreApp(Application):
    """The reference "dummy" app: `key=value` txs into a Merkle-ized KV.

    App hash = hash over sorted (key, value) pairs — deterministic and
    cheap; the reference uses an iavl tree, which is an app-side detail.
    """

    def __init__(self) -> None:
        self._data: dict[bytes, bytes] = {}
        self._height = 0

    def _app_hash(self) -> bytes:
        if not self._data:
            return b""
        acc = b""
        for k in sorted(self._data):
            acc = tmhash(acc + k + b"\x00" + self._data[k] + b"\x01")
        return acc

    def info(self) -> ResultInfo:
        return ResultInfo(
            data=f"{{\"size\":{len(self._data)}}}",
            last_block_height=self._height,
            last_block_app_hash=self._app_hash() if self._height else b"",
        )

    def _parse(self, tx: bytes) -> tuple[bytes, bytes]:
        if b"=" in tx:
            k, v = tx.split(b"=", 1)
        else:
            k = v = tx
        return k, v

    def check_tx(self, tx: bytes) -> Result:
        return Result()

    def deliver_tx(self, tx: bytes) -> Result:
        k, v = self._parse(tx)
        self._data[k] = v
        return Result()

    def end_block(self, height: int) -> list[Validator]:
        self._height = height
        return []

    def commit(self) -> Result:
        return Result(data=self._app_hash())

    def query(self, path: str, data: bytes, height: int = 0, prove: bool = False) -> ResultQuery:
        v = self._data.get(data)
        if v is None:
            return ResultQuery(log="does not exist", key=data)
        return ResultQuery(key=data, value=v, log="exists")

    # -- state sync ----------------------------------------------------------

    def snapshot_state(self) -> bytes:
        return json.dumps(
            {
                "height": self._height,
                "data": {k.hex(): v.hex() for k, v in sorted(self._data.items())},
            },
            sort_keys=True,
        ).encode()

    def restore_state(self, data: bytes) -> None:
        doc = json.loads(data.decode())
        self._height = doc["height"]
        self._data = {
            bytes.fromhex(k): bytes.fromhex(v) for k, v in doc["data"].items()
        }


class PersistentKVStoreApp(KVStoreApp):
    """KVStore persisted to a DB with validator-set changes via special
    txs `val:<pubkey_hex>/<power>` (reference persistent_dummy)."""

    VAL_PREFIX = b"val:"

    def __init__(self, db: DB | None = None) -> None:
        super().__init__()
        self._db = db if db is not None else MemDB()
        self._val_changes: list[Validator] = []
        self._load()

    def _load(self) -> None:
        raw = self._db.get(b"__state__")
        if raw is None:
            return
        doc = json.loads(raw.decode())
        self._height = doc["height"]
        self._data = {
            bytes.fromhex(k): bytes.fromhex(v) for k, v in doc["data"].items()
        }

    def deliver_tx(self, tx: bytes) -> Result:
        if tx.startswith(self.VAL_PREFIX):
            try:
                spec = tx[len(self.VAL_PREFIX) :].decode()
                pub_hex, power_s = spec.split("/")
                val = Validator(pub_key=bytes.fromhex(pub_hex), power=int(power_s))
            except ValueError as e:
                return Result(CodeType.ENCODING_ERROR, log=f"bad val tx: {e}")
            self._val_changes.append(val)
            return Result()
        return super().deliver_tx(tx)

    def end_block(self, height: int) -> list[Validator]:
        self._height = height
        changes, self._val_changes = self._val_changes, []
        return changes

    def commit(self) -> Result:
        doc = {
            "height": self._height,
            "data": {k.hex(): v.hex() for k, v in self._data.items()},
        }
        self._db.set_sync(b"__state__", json.dumps(doc, sort_keys=True).encode())
        return Result(data=self._app_hash())

    def restore_state(self, data: bytes) -> None:
        super().restore_state(data)
        self._db.set_sync(b"__state__", data)  # snapshot doc == persist doc


class CounterApp(Application):
    """The reference counter app: txs must be the next serial number."""

    def __init__(self, serial: bool = True) -> None:
        self.serial = serial
        self.hash_count = 0
        self.tx_count = 0

    def info(self) -> ResultInfo:
        return ResultInfo(data=f"{{\"hashes\":{self.hash_count},\"txs\":{self.tx_count}}}")

    def _tx_value(self, tx: bytes) -> int:
        return int.from_bytes(tx, "big") if tx else 0

    def check_tx(self, tx: bytes) -> Result:
        if self.serial:
            if len(tx) > 8:
                return Result(CodeType.ENCODING_ERROR, log=f"tx too big: {len(tx)}")
            if self._tx_value(tx) < self.tx_count:
                return Result(
                    CodeType.BAD_NONCE,
                    log=f"invalid nonce: got {self._tx_value(tx)}, expected >= {self.tx_count}",
                )
        return Result()

    def deliver_tx(self, tx: bytes) -> Result:
        if self.serial:
            if len(tx) > 8:
                return Result(CodeType.ENCODING_ERROR, log=f"tx too big: {len(tx)}")
            if self._tx_value(tx) != self.tx_count:
                return Result(
                    CodeType.BAD_NONCE,
                    log=f"invalid nonce: got {self._tx_value(tx)}, expected {self.tx_count}",
                )
        self.tx_count += 1
        return Result()

    def commit(self) -> Result:
        self.hash_count += 1
        if self.tx_count == 0:
            return Result()
        return Result(data=self.tx_count.to_bytes(8, "big"))

    def query(self, path: str, data: bytes, height: int = 0, prove: bool = False) -> ResultQuery:
        if path == "hash":
            return ResultQuery(value=str(self.hash_count).encode())
        if path == "tx":
            return ResultQuery(value=str(self.tx_count).encode())
        return ResultQuery(code=CodeType.UNAUTHORIZED, log=f"invalid query path {path}")


class NilApp(Application):
    """Accepts everything, stores nothing (reference nilapp)."""
