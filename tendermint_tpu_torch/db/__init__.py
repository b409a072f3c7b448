"""Key-value store backends (role of tmlibs/db in the reference).

The reference uses goleveldb for blockstore/state/txindex/addrbook
(`tmlibs/db`); here the persistent backend is SQLite (stdlib, ACID,
single-file) and MemDB backs tests/replay.

The port's copy of `tendermint_tpu.db`: the same keys, values and
iteration order, so a store written by one package reads the same in the
other. `node_provider`'s RPC reads are not here: they wait for the
port's `rpc`.
"""

from tendermint_tpu_torch.db.kv import DB, MemDB, SQLiteDB, db_provider

__all__ = ["DB", "MemDB", "SQLiteDB", "db_provider"]
