#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's ed25519 verify path and Merkle hash
plane once on the card.

    python3 chip_smoke.py            # one CUDA card, about 11-13 minutes

Phases (inputs made from --seed with numpy, signed with the port's
pure-Python RFC 8032 module, more than 512 signatures at once in a
pool of spawned worker processes, one a core but one; messages as long
as a canonical vote's sign bytes):

0. environment: card name and power limit, torch/CUDA/nvcc versions;
   builds the kernels from `tendermint_tpu_torch/csrc` (ptxas register
   and spill lines printed);
2. consensus commit: one commit of a 10,000-validator set through
   `verify_commits` of the table backend under `default_verifier()`
   (the bare `TableBatchVerifier`, as in every earlier run) — tables
   built on the card, the entries-chain kernel (`madd_chain_entries`,
   selecting its entries from the tables itself);
3. fast-sync window: 16 stacked commits of a 1000-validator set — the
   fused kernel (`madd_chain_fused`);
4. flat batch: `verify_batch` on 4096 triples with distinct keys — the
   `ladder` kernel (decompression, [h](-A) and [S]B in one kernel);
   every phase ends in the `finish_encode_compare` kernel (one batched
   inversion a block, encode, compare with R);
5. hash plane (bytes made from --seed): the data_hash of a block of
   65,536 txs of 250 bytes through `TreeHasher(device).root_from_items`
   for `sha256` and `ripemd160` (one leaf launch, 16 `merkle_level`
   launches a call), each root bit-equal to the host tree, 5 warm calls
   timed beside the host tree (Merkle leaves/s); `merkle_roots_forest`
   over 16 blocks of 1-4,096 txs of 1-1,024 bytes (a 1-tx block and a
   power of two among them); the state-sync gate, `leaf_hashes` over
   8,192 chunks of 64 KiB and `root_from_hashes` over the result, against
   hashlib and the host tree; `sha512_batch` over 4,096 messages of 305
   bytes (R || A || M) against hashlib, and 16,384 more (the fast-sync
   window's lane count) timed beside their bound; then the stages of one call
   (padding, copy in, leaf kernel, levels, copy back), the card's kernels
   in one data_hash call (torch.profiler) and the host-vs-card crossover
   at 256-65k leaves;
6. stack: the same work through the stack a node calls,
   `default_verifier()` = CoalescingVerifier -> ResilientVerifier ->
   TableBatchVerifier and `default_hasher()` = ResilientTreeHasher:
   first the warm-up a node calls at start (`warm_kernels()` returns in
   under 50 ms, the median of 3 calls, and its thread ends with the
   kernel library loaded) and
   one process that exits while a table prebuild of 1,000 keys runs on
   the card (it must exit with code 0), then the 10k commit 5 times on
   an empty verified-signature cache and 5 times with its good lanes
   from the cache (medians, and the cache filter's time alone, beside
   the bare phase's), the fast-sync window through
   `verify_commits_async`, four consumer threads of 1,024 flat triples
   each through `verify_batch_async` (coalesced), a fault drill on a
   512-validator set (the breaker tripped by injected faults, no launch
   while open, a probe that re-closes it; a table build degraded to the
   CPU for a 64-key set and to host crypto for a 512-key set), and the
   hash plane's data_hash (healthy and with one injected fault) and
   state-sync leaf hashes through the resilient hasher. Each step fails
   on an inexact mask, a missing launch, or a primary failure or host
   fallback it did not inject. Each step's launches stand on its own
   line; the kernels line keeps the bare phases' counts;
8. types, run after phase 6 on the same stack: the port's own domain
   types (`tendermint_tpu_torch.types`) as a node calls them, on the
   keys of phases 2-4 with precommits signed over the port's
   `Vote.sign_bytes`: `ValidatorSet.verify_commit` of a 10,000-validator
   commit (5 calls at first sight, each on an empty signature cache,
   and 5 from the stack's cache), `verify_commit_batched_async` of 16
   commits of a 1000-validator set, `verify_commit_any` of a
   4096-validator commit (the flat `ladder` route), each again with one
   forged precommit, which must raise its `ValidationError` naming the
   validator (and the window's entry and height); and
   `Block.make_block` / `validate_basic` of phase 5's 65,536 txs with
   `default_hasher()` (data_hash equal to the host tree, one leaf
   launch and 16 `merkle_level` launches a data_hash, a tampered tx
   refused). The lane collection (`_collect_commit_sigs` and
   `_commit_lanes`) is timed alone. Its sets leave the table cache as
   they found it; its launches stand on its own `types` line;
9. state, run after phase 8 on the same stack: block execution and the
   light client on the port's own `db`, `abci`, `state` and
   `certifiers`: a chain of phase 2's 10,000 validators (equal power,
   `PersistentKVStoreApp` on a `MemDB`, a `KVTxIndexer`) applies heights
   1-5 through `apply_block` (height 2 swaps 1,000 validators for new
   keys with `val:` txs, height 3 carries 65,536 txs of 250 bytes, the
   others 256), each height's seconds split into its steps, the new
   set's table prebuild clocked beside height 4 (the new set's first
   commit); a forged last commit and a wrong app hash must raise before
   the app runs and leave the state as it was; the app hash, the stored
   state, the validator sets and the tx index are checked against
   hashlib and fresh sets; a light client (`DynamicCertifier` certify
   and update across the change, then an `InquiringCertifier` over a
   `MemProvider` into a `FullCommitStore` on SQLite) follows the chain;
   `StaticCertifier.certify_batch` replays the 16 FullCommits of a
   chain of phase 3's 1,000 validators in one call (5 times, commits/s),
   and a batch with one forged commit must raise naming its entry and
   height. Each step's launches are checked and stand on the `state` and
   `certifiers` lines;
10. sync, run after phase 9 on the same stack: a fresh node catches up
   over the port's own network. A chain of phase 3's 1,000 keys (equal
   power, `KVStoreApp`, 256 txs of 250 bytes a block) is built to 49
   heights on the stack (each commit verified on the card as the chain
   applies it) and served from a `BlockStore` by a `Switch` with
   `BlockchainReactor(fast_sync=False)`; a node with the genesis state,
   an empty store and `BlockchainReactor(fast_sync=True)` at the default
   pipeline depth dials it over localhost TCP and syncs to height 48:
   run a through a SecretConnection (node keys from the seed, the port's
   pure-Python X25519, HKDF and ChaCha20-Poly1305) with `verifier=None`,
   which is `default_verifier()`, and the app in process; run b over
   plain TCP with the app behind the port's ABCI socket, on a fresh
   coalescer over the stack. Each run must end with every block's hash,
   the state JSON and the app hash equal to the chain's, and launch one
   finish a window, the fused chain for a window of 8 commits or more
   and the entries chain below (over the network the first window is
   often short). It times the dial (the handshake), dial to caught up
   (blocks/s), the windows, the fastsync queue's overlap and the bytes
   received, and the links alone at a block's size (SecretConnection
   and plain TCP, both ends in this process, and the cipher on one
   thread, MB/s). Then a fork of the chain with one precommit of height
   20's commit forged inside block 21 is synced from a reactor's pool:
   window 1 applies, window 2 launches, its verdict is false on the card
   with the forged validator's message, and it drains unapplied. Its
   `sync_link`, `sync_run` and `sync` lines carry the numbers and the
   launches. `--sync-only` runs phase 0 and this phase alone;
11. consensus, run after phase 10 on the same stack: the port's own
   mempool, evidence pool and consensus. `consensus_mempool`: a
   `Mempool` (signed txs on) on `KVStoreApp` takes 4,096 signed
   envelopes (phase 4's keys), one forged envelope and 256 plain txs
   from 4 threads through `check_tx_async`, as an RPC broadcast feeds
   it; every `Result` must equal a host mempool's, the forged one
   `UNAUTHORIZED`, every envelope of an ingress window of 512 or more a
   row of a flat call the card answered, `reap` in each thread's order,
   `update` emptying the pool. `consensus_storm` (BASELINE config 5): a `ConsensusState`
   is validator 0 of phase 2's 10,000 keys at equal power (the stack's
   verifier and hasher, `Mempool`, `EvidencePool`, `BlockStore`,
   `KVStoreApp`, a WAL in a temporary directory, `test_config()`,
   `MockTicker`); the smoke plays the other 9,999 for heights 1 and 2
   (the proposer's signed proposal where the node does not propose,
   then each height's prevotes and precommits as backlogs through
   `add_vote`); a forged prevote must be the one vote refused and a
   second, conflicting precommit must reach the evidence pool; both
   heights commit the proposed blocks, the app hash equals `kv_app_hash`
   of the committed txs, every lane of a drained vote run of 512 or more
   is a row of a flat call the card answered (`ladder`), and
   height 2's last commit of 10,000 launches the entries chain and the
   finish in `validate_block`; each height's seconds from proposal to
   commit are split by the height ledger's phases. `consensus_net`
   (BASELINE config 1): four validators with consensus, mempool and
   evidence reactors on `Switch`es linked in process run 10 heights at
   the default minimum device batch and 10 at 0, with 512 signed txs at
   node 1 and one `DuplicateVoteEvidence` at node 0: every tx committed
   once and the evidence within 5 heights on all four, equal stores and
   app hashes (heights/s a run). Every step fails unless the launch
   ledger's records account for each of its launches once its calls
   have joined (`StepLedger.settle`), and on a host fallback or a primary
   failure. Its `consensus_*` lines carry the numbers and the
   launches. `--consensus-only` runs phase 0 and this phase alone;
12. readpath, run after phase 11 on the same stack: the port's own
   `statesync/`, `lightclient/`, `rpc/` and `certifiers/node_provider.py`.
   `readpath_statesync`: a chain of phase 3's 1,000 keys (`KVStoreApp`)
   grows 9 blocks of the `data_hash` cell's 65,536 txs of 250 bytes, is
   snapshotted by the serving `StateSyncReactor.maybe_take_snapshot` on
   `default_hasher()` (more than 8,192 chunks of 64 KiB: the chunk gate's
   card threshold), and 8 more heights of 256 txs; two serving switches
   (the snapshot and `BlockchainReactor(fast_sync=False)`), one with two
   chunks flipped by `corrupt_chunk`, serve a fresh node
   (`testing.StateSyncingNode`: a trust anchor pinned to the chain's hash
   at height 4) over plain localhost TCP: the corrupt chunk is blamed on
   arrival and fetched again, the gate hashes every chunk in one
   `sha256_masked` launch and folds the root with `merkle_level`, the
   restore equals the server's state and app hash at the snapshot, and
   the fast-sync tail (one finish a window) ends with every block hash,
   the state and the app hash equal to the server's; take, transfer
   MB/s, gate, decode, restore and tail blocks/s are timed.
   `readpath_lightclient` (BASELINE config 2): 10,000 heights of 100
   validators of phase 2's keys, one replaced every 10 heights, commits
   signed at height 1 and every 25th and served by a `LightClientReactor`
   over localhost TCP; a `BisectingCertifier` over `PeerProvider` on
   `default_verifier()` walks to the head (one verify call a round, a
   round whose lanes less those the signature cache withholds reach 512
   on `ladder` and the finish), a second walk answers from the trusted
   cache with no launch, a walk against a server holding
   `testing.forge_fullcommit`'s forgery fails with the certifier's
   message, and its push to a subscribed client scores the server
   `forged_fullcommit` and becomes `DuplicateVoteEvidence`.
   `readpath_rpc`: `RPCServer(make_routes(...))` on the serving node
   (`testing.ReadNode`), each route checked against the node's objects and
   timed over `HTTPClient`, then `NodeProvider` feeding a
   `DynamicCertifier` the 8 tail commits, each on `madd_chain_entries`.
   Every step holds the launch ledger's records to the kernel wrappers'
   launches (`StepLedger.settle`) and fails on a host fallback or
   primary failure; its `readpath_*` lines carry the numbers.
   `--readpath-only` runs phase 0 and this phase alone;
13. node, run after phase 12: the port's own node and command line,
   each node a process of its own started through
   `python -m tendermint_tpu_torch testnet` / `init` / `node` on the
   card, read over its own RPC and from the `launches.jsonl` under its
   home. `node_net` (BASELINE config 1): `testnet --n 4` at the default
   `Config` (1 s `timeout_commit`, SecretConnections, PEX, 512,000 B/s
   links); 16 kvstore txs through `broadcast_tx_commit`, each read back
   with `abci_query` and `tx` from every node; run a SIGKILLs node 3 at
   height 5 or later and restarts it on its home, where it must rejoin;
   run b has TENDERMINT_TPU_MIN_DEVICE_BATCH=0 in the nodes'
   environment, so every vote drain launches `ladder` and every commit
   `madd_chain_entries`; both commit 10 heights (run a two past the
   rejoin) with every block, block hash, commit and app hash equal on
   every node (heights/s, seconds to rejoin, each node's `/health`).
   `node_sync` (BASELINE config 3 at full width): phase 10's chain of
   phase 3's 1,000 keys is written with `State.save` and `BlockStore`
   on `SQLiteDB` into a home from `init` that a `node` process serves;
   a fresh node from `init` with the same genesis fast-syncs it through
   a SecretConnection under the link cap, its windows on the entries
   chain (the fused chain at 8 commits or more), each with its finish,
   and ends with the server's blocks and the chain's state and app hash
   (dial to caught up, blocks/s, window sizes, the server's handshake
   replay). Each process's kernel launches, its wrappers' counts at exit
   (a `sitecustomize` counts hook on its path) less the warm-up's, must
   equal what its ledger's records account for kernel by kernel; a
   record with an error, a host fallback or primary failure in a node's
   breakers, a process that exits early or a hash that differs fails.
   `--node-only` runs phase 0 and this phase alone;
14. testing, run after phase 13 on the same stack: the port's own
   nemesis book (`tendermint_tpu_torch.testing`) at the minimum device
   batch 0, so every vote drain launches `ladder` and every commit
   `madd_chain_entries`. A `Nemesis` of 4 `NemesisNode`s with
   `device="cuda"` and no verifier factory, so each node verifies on the
   signature cache and coalescer of its own that the book gives it over
   `default_verifier()`'s resilient table backend, with the span log on:
   healthy heights, a minority partition and heal (the cut node catches
   up), a crash with a corrupted WAL tail and a restart (WAL replay), and
   an `Equivocator` whose `DuplicateVoteEvidence` every honest node
   commits within 5 heights; then the library's `slow_wan_validator`
   through the port's `ScenarioRunner(device="cuda")` (4 nodes on a WAN
   topology with one far validator, adaptive timeouts, 30 heights), graded
   by its own expectations (the timeouts learn the slow path, no round
   skip after warm-up). Each net must store the same block,
   block hash and app hash at every height on every node, and the
   process's launch ledger must account for the net's launches kernel by
   kernel (the nodes share the process and its ledger); a record with an
   error, a host fallback or primary failure, or a module of jax in the
   process fails. `--testing-only` runs phase 0 and this phase alone;
15. tools, run after phase 14 on the same stack: the port's operator
   tools (`tendermint_tpu_torch.tools`), each through its own `main`.
   (a) `loadgen` in this process on `default_verifier()` at the minimum
   device batch 0: 2,000 signed tx/s offered for 3 s from 16 threads over
   64 signers into its in-process mempool, every arrival resolved `ok`,
   `ladder` and the finish launched and the launch ledger settled against
   the wrappers' counts (offered and achieved tx/s, late arrivals,
   admission p50/p99); then `python -m tendermint_tpu_torch.tools.loadgen
   --device cuda` (signed, 500 tx/s for 2 s, minimum batch 0) and
   `statesync_demo --device cuda` at its defaults as child processes,
   each to exit 0 (the demo's restore at parity) having launched on the
   card (the loadgen) and imported no module of jax. (b) four `node` processes from `testnet --n
   4` on the card at the default `Config`, with
   TENDERMINT_TPU_MIN_DEVICE_BATCH=0 and TENDERMINT_TPU_PROFILE_HZ=29,
   once every node's kernel warm-up has ended:
   `loadgen --rpc` at node 0 (signed, 200 tx/s for 5 s; the heights/s
   under the load), then `loadgen --reads --rpc` over all four (walks
   verified on the card in this process); then every report:
   `device_report` over each home's `launches.jsonl` (its per-kind rollup
   the ledger's `summarize()`) and over each node's RPC (the same records'
   rollup) and the fleet's, `finality_report` over the four
   `heights.jsonl` (every height every node committed), `trace_timeline
   --trace` over the four `spans.jsonl` (a tx broadcast at node 0 from its
   admission to its commit, on more than one node), `gossip_report` over
   the four RPCs and `contention_report` over each (each names its top
   source). Every node's blocks, block hashes, commits and app hashes
   must be equal, and each process's launches (the counts hook)
   accounted for by its ledger, as in phase 13; a record with an error, a
   host fallback or primary failure, or a module of jax in any process
   fails. Then the stack is closed. `--tools-only` runs phase 0 and this
   phase alone;
7. mesh: the same work over four shards (`cuda:0..3` with four cards,
   else `cuda:0` four times: the times then measure the choreography,
   not a speed-up): the 10k commit through `ShardedTableBatchVerifier`
   (2,500 table columns and one `madd_chain_entries` and one finish
   launch a shard), the window (250 columns, one `madd_chain_fused` a
   shard), the flat batch through `ShardedBatchVerifier` (1,024 lanes a
   shard on `ladder`) and its power tally against the host sum, 64 zero
   rows (all false, tally 0), `data_hash` through `TreeHasher(mesh=)`
   (one leaf launch a shard, roots bit-equal to phase 5's); a fault
   drill (shard 2 out: the flat batch on 3 shards, the window and the
   10k commit on the one-card path; the full mesh back after the
   re-probe window; every shard out on 512 validators: the breaker's
   host answer) and the multi-host seam in one process. Each step times
   a cold call and the median of 3 beside the bare phase's, and fails on
   an inexact mask, root or tally, a kernel not launched once a shard,
   or a shard fault, re-mesh or fallback it did not inject;
   telemetry in phases 6 and 7: the launch ledger (`LAUNCHLOG`, written
   to chiprun_out/launches.jsonl) must account for every kernel launch
   of each step's backend calls, one record a dispatch unit, its kernel
   once a shard (a step fails on a difference and on a record with an
   error it did not inject), and each step prints one `launches` line,
   the ledger's `summarize()` of its records; the stack's window call
   runs under a minted trace context and its flat consumers under their
   own, and their `dispatch.launch` and `batcher.flush` spans must land
   in chiprun_out/spans.jsonl with the ledger record's trace id; the
   flat step times its locks' contention (`contention_snapshot`); the
   cached commit runs 5 times with the ledger on and 5 off, in turns
   (medians and ratio reported, not gated); both fault drills must
   leave their breaker transitions and the mesh's shard fault and
   restore in the flight recorder; a failing run dumps the flight
   recorder to chiprun_out/, and every run writes the metric registry
   to chiprun_out/metrics.prom (Prometheus text) and chip_smoke.json;
1. kernel vs plain: each kernel against its plain torch version on the
   card, on the inputs its phase gave it (the entries chain also at
   4096 lanes and at 3 commits of the fast-sync set), compared exactly
   on the canonical affine coordinates (x, y), T * Z == X * Y, the
   verdicts and, for the ladder, a_ok; the finish on all three chains'
   outputs, on hand-made lanes (sign bit set and cleared, y >= p,
   the identity) and on a batch of three blocks with a Z = 0 lane in
   one (false on every lane); the hash kernels at the data_hash block (the two
   leaf passes, the first level of both trees), every level of the
   forest (both trees) and the SHA-512 batch,
   word for word (everything is an integer: tolerance 0); then
   a per-stage breakdown of one call of each phase, the card's kernel
   time in one call of each phase (torch.profiler) and the flat
   prologue's kernel count, and each kernel and its plain version timed
   with CUDA events around a call (a hash kernel by torch.profiler, its
   device time a launch). Each kernel's bound is the larger of the limb
   products its function needs (100 a field multiply, 55 a squaring;
   FE_OPS_PER_LANE, and for the finish a batched inversion's count with
   one chain a call, not its kernel's one a block) and the bytes it must move
   (madd_chain_entries: the distinct 32-byte table sectors its lanes
   touch); a hash kernel's bound counts the compressions its rows need
   (INSTR_PER_COMPRESSION, `hash_ops`) and the blocks they read. Last,
   the finish at each path's shape by CUDA events and by the profiler's
   device time (`finish_device_ms`), and `sha512_masked` at 16,384
   messages against hashlib and one message alone (`sha512_wide`).

Every verify phase plants a forged signature, an absent vote, an S >= L, an
invalid pubkey encoding and a wrong-length signature, and its verdicts
must equal the expected mask exactly. Launch counts are zeroed just
before each main-path phase and read just after; a phase whose kernel
did not launch fails. The script prints one `kernels` JSON line, the
card's name and power limit, and as its last line
`{"ok": true, "device": {...}}`; any failure exits non-zero without that
line. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

# length of a canonical precommit's sign bytes (tendermint_tpu/types/vote.py
# `Vote.sign_bytes`: 17-character chain id, 20-byte block and parts
# hashes, height 123456, a nanosecond timestamp), measured once on a CPU
MSG_LEN = 241
INT32_LANES_PER_SM_CLOCK = 64  # Hopper white paper: 64 INT32 lanes per SM
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# One rule for every kernel's bound: a field multiply counts 100 limb
# products (10 x 10 in radix 2^26), a squaring 55 (10 squares and 45
# cross products).
PRODUCTS_PER_FE_MUL = 100
PRODUCTS_PER_FE_SQ = 55
SECTOR_BYTES = 32  # the card's unit of a read from device memory
# field (multiplies, squarings) a lane of the ladder kernel runs (csrc/ladder.cu)
LADDER_FE_OPS = {
    # d y^2, v^3, v^7, u v^3, u v^7, x, v x^2, x sqrt(-1), T and the 11
    # multiplies of the p58 chain; y^2, v^2, v^6, x^2 and its 251 squarings
    "decompress": (20, 255),
    "table": (1 + 15 * (8 + 1), 0),  # -A cached, 15 additions, each cached
    # 4 doublings a window of 4 squarings and 3 multiplies, T only before an addition
    "doublings": (63 * (3 * 3 + 4), 63 * 4 * 4),
    "window_adds": (64 * 8, 0),
    "comb": (64 * 7, 0),
    "join": (1 + 8, 0),
}
# field (multiplies, squarings) a lane of each function needs
FE_OPS_PER_LANE = {
    "madd_chain_entries": (96 * 7, 0),
    "madd_chain_fused": (128 * 7 + 9, 0),  # two 64-step halves and one addition
    "ladder": tuple(map(sum, zip(*LADDER_FE_OPS.values()))),
    # encode(x/z, y/z) needs a batched (Montgomery) inversion's 3
    # multiplies a lane, then x/z and y/z; the kernel runs one chain a
    # block of 32-256 lanes, more than the one a call counted below
    "finish_encode_compare": (3 + 2, 0),
}
# field (multiplies, squarings) once a call: the batched inversion's one
# shared z^(p-2)
FE_OPS_PER_CALL = {"finish_encode_compare": (11, 254)}
# kernels a flat call ran when torch decompressed A, built B - A and
# inverted before the ladder (PERF.md, run F)
EAGER_PROLOGUE_FLAT_CALL_KERNELS = 33818
# name -> (source, the JAX function it replaces)
KERNEL_INFO = {
    "madd_chain_entries": (
        "tendermint_tpu_torch/csrc/madd_chain.cu",
        "tendermint_tpu/ops/ed25519_tables.py:609",
    ),
    "madd_chain_fused": (
        "tendermint_tpu_torch/csrc/madd_chain.cu",
        "tendermint_tpu/ops/ed25519_tables.py:775",
    ),
    "ladder": (
        "tendermint_tpu_torch/csrc/ladder.cu",
        "tendermint_tpu/ops/ed25519_ladder_pallas.py:155",
    ),
    # XLA stages of the JAX package, not Pallas kernels
    "finish_encode_compare": (
        "tendermint_tpu_torch/csrc/finish.cu",
        "tendermint_tpu/ops/ed25519_tables.py:895",
    ),
    "sha256_masked": (
        "tendermint_tpu_torch/csrc/hash.cu",
        "tendermint_tpu/ops/sha256_kernel.py:91",
    ),
    "ripemd160_masked": (
        "tendermint_tpu_torch/csrc/hash.cu",
        "tendermint_tpu/ops/ripemd160_kernel.py:118",
    ),
    "sha512_masked": (
        "tendermint_tpu_torch/csrc/hash.cu",
        "tendermint_tpu/ops/sha512_kernel.py:129",
    ),
    "merkle_level": (
        "tendermint_tpu_torch/csrc/hash.cu",
        "tendermint_tpu/ops/merkle_kernel.py:106",
    ),
}
# 32-bit instructions of one compression, counted from the kernels' code
# (csrc/sha256.cuh, ripemd160.cuh, sha512.cuh) as the card can issue it,
# as (logic functions and shifts, all): a logic function of three words
# is one LOP3, a sum of three words one IADD3, a rotate or a shift across
# two words one funnel shift (SHF); a 64-bit operation is two. SHA-256:
# 48 schedule steps of 10 (8 LOP3/SHF), 64 rounds of 14 (10), 8
# additions; RIPEMD-160: 160 steps of 3 LOP3/SHF and 3 additions (2
# where K = 0), 5 sums; SHA-512: 64 schedule steps of 20 (16), 80 rounds
# of 28 (20), 8 additions of 2.
INSTR_PER_COMPRESSION = {
    "sha256": (48 * 8 + 64 * 10, 48 * 10 + 64 * 14 + 8),
    "ripemd160": (160 * 3, 128 * 6 + 32 * 5 + 5),
    "sha512": (64 * 16 + 80 * 20, 64 * 20 + 80 * 28 + 8 * 2),
}
LEAF_KERNEL = {"sha256": "sha256_masked", "ripemd160": "ripemd160_masked"}
# the hash kernels' symbols as the profiler reports them: their `ms` is
# the profiler's device time a launch, since a CUDA-event pair around one
# 10-60 us launch times mostly the launch; the verify kernels keep the
# event time of a call, as in their earlier rows, so trees stay comparable
PROFILED = {
    "sha256_masked": "sha256_masked_kernel",
    "ripemd160_masked": "ripemd160_masked_kernel",
    "sha512_masked": "sha512_masked_kernel",
    "merkle_level": "merkle_level_kernel",
}
# torch.profiler sessions a measurement may take (`profiled`), the pause
# after a session that recorded no device activity (such losses came three
# in a row on a slow host), and the sessions of this run that were redone
PROFILE_TRIES = 6
PROFILE_RETRY_PAUSE_S = 0.5
LOST_SESSIONS = [0]
# the hash phase's sizes: a block of TXS txs of TX_BYTES (tm-bench's
# default tx size; BASELINE config 4's 65k-tx block), a fast-sync window
# of FOREST_TREES blocks of 1 to FOREST_MAX_TXS txs, the state-sync gate
# over CHUNKS chunks of CHUNK_BYTES (statesync/snapshot.py), SHA512_MSGS
# messages of R || A || M (and SHA512_WIDE_MSGS, the fast-sync window's
# lanes, for one more timing), HASH_REPS warm calls
TXS = 65536
TX_BYTES = 250
FOREST_TREES = 16
FOREST_MAX_TXS = 4096
CHUNKS = 8192
CHUNK_BYTES = 65536
SHA512_MSGS = 4096
SHA512_WIDE_MSGS = 16384
HASH_REPS = 5
# Two floors for one SHA-512 message, whose compressions are sequential,
# so no width of batch runs one below them: the dependent chain of a
# round through e (csrc/sha512.cuh `rounds`: the rotates of S1 (SHF),
# their XOR (LOP3), then the 64-bit sums into e as a low IADD3 and a high
# IADD3.X, twice), each at an assumed 4 cycles of ALU latency; and the
# round warp's issue, 20 logic functions and shifts a round
# (INSTR_PER_COMPRESSION), each two clocks of a warp on its scheduler's
# 16-lane ALU pipe (INT32_LANES_PER_SM_CLOCK / 4).
SHA512_ROUND_DEPTH = 6
ALU_LATENCY_CYCLES = 4
SHA512_ROUND_ALU = 20


def sha256_folded(block: list) -> tuple[int, int]:
    """(logic functions and shifts, all) instructions of one SHA-256
    compression of a block whose words are ints where known when the
    kernel is compiled, None where known only at run time: the unrolled
    schedule folds a step whose terms are all constants, and a sigma of a
    constant or a zero term costs nothing; the 64 rounds and 8 additions
    are as in INSTR_PER_COMPRESSION (K is read from the constant bank, so
    W[t] + K[t] does not fold)."""
    rotr = lambda x, n: ((x >> n) | (x << (32 - n))) & 0xFFFFFFFF  # noqa: E731
    sigma = (
        lambda x: rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3),
        lambda x: rotr(x, 17) ^ rotr(x, 19) ^ (x >> 10),
    )
    w = list(block)
    alu, total = 64 * 10, 64 * 14 + 8
    for t in range(16, 64):
        terms = [w[t - 16], w[t - 7]]
        for f, x in zip(sigma, (w[t - 15], w[t - 2])):
            if x is None:  # two rotates, a shift, one LOP3
                alu, total = alu + 4, total + 4
            terms.append(None if x is None else f(x))
        known = sum(x for x in terms if x is not None) & 0xFFFFFFFF
        unknown = terms.count(None)
        k = unknown + (known != 0)
        total += k // 2  # one IADD3 adds three terms
        w.append(None if unknown else known)
    return alu, total


# an inner node of the SHA-256 tree: a block of 16 run-time words, then
# R's last byte, the pad byte, 14 zeros and the bit length 520; and the 18
# instructions that build its message words (one funnel shift each, two
# for the second block's first word)
INSTR_PER_SHA256_INNER_NODE = tuple(
    a + b + 18
    for a, b in zip(INSTR_PER_COMPRESSION["sha256"], sha256_folded([None] + [0] * 14 + [65 * 8]))
)


def sh(cmd: list[str]) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({type(e).__name__})"


def log(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


# signing: up to SIGN_INLINE_MAX signatures a call in this process, more
# in SIGNERS spawned worker processes (pure-Python signing holds a core)
SIGN_INLINE_MAX = 512
SIGNERS = max(1, min(8, os.cpu_count() or 1) - 1)
_SIGNER_POOL = None


def signer_pool():
    """The signers' pool, made at its first use; `close_signers` stops it."""
    global _SIGNER_POOL
    if _SIGNER_POOL is None:
        import multiprocessing

        _SIGNER_POOL = multiprocessing.get_context("spawn").Pool(SIGNERS)
    return _SIGNER_POOL


def close_signers() -> None:
    global _SIGNER_POOL
    if _SIGNER_POOL is not None:
        _SIGNER_POOL.close()
        _SIGNER_POOL.join()
        _SIGNER_POOL = None


class Inputs:
    """Keys, messages and signatures for every phase, from one seed."""

    def __init__(self, seed: int, n_keys: int):
        from tendermint_tpu_torch.crypto import ed25519_ref

        self.ref = ed25519_ref
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        t0 = time.perf_counter()
        raw = self.rng.integers(0, 256, size=(n_keys, 32), dtype=np.uint8)
        self.seeds = [bytes(row) for row in raw]
        self.pubs = [ed25519_ref.public_from_seed(s) for s in self.seeds]
        self.keygen_s = time.perf_counter() - t0

    def sign_many(self, pairs: list) -> list[bytes]:
        """The signatures of (seed, message) `pairs`, in order; the
        signers' pool signs a large call."""
        if len(pairs) <= SIGN_INLINE_MAX or SIGNERS < 2:
            return [self.ref.sign(seed, msg) for seed, msg in pairs]
        return signer_pool().starmap(self.ref.sign, pairs, chunksize=max(1, len(pairs) // (4 * SIGNERS)))

    def msgs(self, n: int) -> list[bytes]:
        raw = self.rng.integers(0, 256, size=(n, MSG_LEN), dtype=np.uint8)
        return [bytes(row) for row in raw]


def bad_pubkey() -> bytes:
    """A non-canonical encoding (y = 2^255 - 1 >= p): decodes to nothing."""
    return b"\xff" * 31 + b"\x7f"


def forge(sig: bytes) -> bytes:
    return bytes([sig[0] ^ 0x01]) + sig[1:]


def s_plus_l(sig: bytes) -> bytes:
    from tendermint_tpu_torch.ops.ed25519_kernel import L

    s = int.from_bytes(sig[32:], "little") + L
    return sig[:32] + s.to_bytes(32, "little")


def make_commit(inp: Inputs, keys: list[int], plant: dict):
    """(pubkeys, msgs, sigs, expected) for one commit over `keys`;
    `plant` maps a kind to the lane that gets it."""
    n = len(keys)
    pubs = [inp.pubs[i] for i in keys]
    msgs = inp.msgs(n)
    sigs = inp.sign_many([(inp.seeds[k], m) for k, m in zip(keys, msgs)])
    expected = np.ones(n, dtype=bool)
    for kind, lane in plant.items():
        expected[lane] = False
        if kind == "forged":
            sigs[lane] = forge(sigs[lane])
        elif kind == "absent":
            msgs[lane] = sigs[lane] = None
        elif kind == "s_ge_l":
            sigs[lane] = s_plus_l(sigs[lane])
        elif kind == "bad_key":
            pubs[lane] = bad_pubkey()
        elif kind == "short_sig":
            sigs[lane] = sigs[lane][:63]
    return pubs, msgs, sigs, expected


def check_mask(name: str, got: np.ndarray, expected: np.ndarray) -> None:
    if got.shape != expected.shape or not np.array_equal(got, expected):
        bad = np.argwhere(got != expected)[:10].tolist() if got.shape == expected.shape else "shape"
        raise AssertionError(f"{name}: verdicts differ from the expected mask at {bad}")


def timed(fn, sync) -> float:
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return time.perf_counter() - t0


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of `fn` over `reps` runs, CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# kernel name -> (module, wrapper): each wrapper counts its launches
WRAPPERS = {
    "madd_chain_entries": ("tendermint_tpu_torch.ops.ed25519_tables", "sum_entries"),
    "madd_chain_fused": ("tendermint_tpu_torch.ops.ed25519_tables", "fused_chain"),
    "ladder": ("tendermint_tpu_torch.ops.ed25519_ladder", "ladder"),
    "finish_encode_compare": ("tendermint_tpu_torch.ops.ed25519_tables", "finish_encode_compare"),
    "sha256_masked": ("tendermint_tpu_torch.ops.sha256_kernel", "sha256_masked"),
    "ripemd160_masked": ("tendermint_tpu_torch.ops.ripemd160_kernel", "ripemd160_masked"),
    "sha512_masked": ("tendermint_tpu_torch.ops.sha512_kernel", "sha512_masked"),
    "merkle_level": ("tendermint_tpu_torch.ops.merkle_kernel", "merkle_level"),
}


def wrappers() -> dict:
    import importlib

    return {name: getattr(importlib.import_module(mod), attr) for name, (mod, attr) in WRAPPERS.items()}


def counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def affine(point):
    """Canonical affine (x, y) = (X/Z, Y/Z) of every lane, stacked, and
    whether T * Z == X * Y holds on every lane."""
    import torch

    from tendermint_tpu_torch.ops.ed25519_kernel import fe_canon, fe_carry, fe_eq, fe_mul
    from tendermint_tpu_torch.ops.ed25519_tables import fe_batch_invert

    x, y, z, t = (c.contiguous() for c in point)
    zinv = fe_batch_invert(fe_carry(z))
    xy = torch.stack([fe_canon(fe_mul(x, zinv)), fe_canon(fe_mul(y, zinv))])
    return xy, bool(fe_eq(fe_mul(t, z), fe_mul(x, y)).all())


def compare(name, kernel_out, plain_out, r, a_ok=None) -> int:
    """Exact comparison of a kernel's output with its plain version:
    canonical affine x, y (the kernels add in another order, so their
    projective coordinates differ), T * Z == X * Y, the
    encode-and-compare verdicts and, for the ladder, a_ok (a pair:
    kernel's, plain version's). Returns the max absolute difference of
    the affine coordinates (0 when they agree)."""
    from tendermint_tpu_torch.ops.ed25519_tables import _finish_encode_compare

    (ak, tz_k), (ap, tz_p) = affine(kernel_out), affine(plain_out)
    err = int((ak - ap).abs().max().item())
    vk = _finish_encode_compare(*kernel_out[:3], r)
    vp = _finish_encode_compare(*plain_out[:3], r)
    same_ok = a_ok is None or bool((a_ok[0] == a_ok[1]).all())
    if err != 0 or not (tz_k and tz_p and same_ok) or not bool((vk == vp).all()):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version (max_abs_err={err}, "
            f"T*Z == X*Y: {tz_k}/{tz_p}, a_ok equal: {same_ok})"
        )
    return err


def compare_finish(name, point, r) -> int:
    """The finish kernel against its plain version on one chain's output,
    verdict for verdict; returns the number of lanes that differ (0)."""
    import torch

    from tendermint_tpu_torch.ops.ed25519_tables import _finish_encode_compare, finish_encode_compare

    x, y, z = point[:3]
    got = finish_encode_compare(x, y, z, r)
    want = _finish_encode_compare(x.contiguous(), y.contiguous(), z.contiguous(), r.to(torch.int32))
    diff = int((got != want).sum().item())
    if diff:
        raise AssertionError(f"finish_encode_compare on {name}: {diff} verdicts differ from the plain version")
    return diff


def check_finish_edges(dev) -> None:
    """The finish on the hand-made lanes of `finish_edge_lanes` (known
    verdicts, same as the plain version's), then on `finish_mixed_lanes`:
    70 lanes, three blocks of 32, a Z = 0 lane in the middle block with
    an all-zero R (true in the JAX tree, which inverts every lane to 0)
    and valid lanes in the others. The kernel must equal the plain
    version lane for lane: false everywhere with the zero, the known
    verdicts once that Z is 1."""
    import torch

    from tendermint_tpu_torch.ops.ed25519_tables import (
        _finish_encode_compare,
        finish_encode_compare,
        finish_lanes_per_block,
    )
    from tendermint_tpu_torch.testing import MIXED_ZERO_LANE, finish_edge_lanes, finish_mixed_lanes

    x, y, z, r, want = (torch.from_numpy(a).to(dev) for a in finish_edge_lanes())
    got = finish_encode_compare(x, y, z, r)
    plain = _finish_encode_compare(x, y, z, r.to(torch.int32))
    if not (torch.equal(got, want) and torch.equal(plain, want)):
        raise AssertionError(f"finish on hand-made lanes: {got.tolist()} / plain {plain.tolist()}, want {want.tolist()}")
    x, y, z, r, want = (torch.from_numpy(a).to(dev) for a in finish_mixed_lanes())
    if finish_lanes_per_block(x.shape[0], torch.cuda.get_device_properties(dev).multi_processor_count) != 32:
        raise AssertionError("finish: the mixed batch does not span three blocks")
    got = finish_encode_compare(x, y, z, r)
    plain = _finish_encode_compare(x, y, z, r.to(torch.int32))
    if bool(got.any()) or not torch.equal(got, plain):
        raise AssertionError(f"finish with a Z = 0 lane: {got.tolist()} / plain {plain.tolist()}, want all false")
    z[MIXED_ZERO_LANE, 0] = 1
    got = finish_encode_compare(x, y, z, r)
    plain = _finish_encode_compare(x, y, z, r.to(torch.int32))
    if not (torch.equal(got, want) and torch.equal(plain, want)):
        raise AssertionError(f"finish on the mixed batch: {got.tolist()} / plain {plain.tolist()}, want {want.tolist()}")


def entries_bytes(a_tables, s, h) -> tuple[int, int]:
    """Bytes `madd_chain_entries` must move for these digits, and the
    table sectors among them: the distinct 32-byte sectors of the table
    entries its lanes select (an entry's 60 int16 limbs lie N apart), the
    distinct comb entries (240 bytes each), S and h (int32) and the
    (4, 20, B) int32 output."""
    import torch

    from tendermint_tpu_torch.ops.ed25519_tables import _h_nibbles

    n = a_tables.shape[3]
    bsz = s.shape[0]
    dev = s.device
    w = torch.arange(64, device=dev)
    rows = (w * 16 + _h_nibbles(h).long()) * 60  # (B, 64): an entry's first row
    limbs = torch.arange(60, device=dev)
    v = torch.arange(bsz, device=dev) % n
    parts = []
    for lo in range(0, 64, 8):  # 8 windows at a time bounds the scratch
        addr = ((rows[:, lo:lo + 8, None] + limbs) * n + v[:, None, None]) * 2
        parts.append(torch.unique(addr // SECTOR_BYTES))
    sectors = torch.unique(torch.cat(parts)).numel()
    comb = torch.unique(torch.arange(32, device=dev) * 256 + s.long()).numel()
    nbytes = sectors * SECTOR_BYTES + comb * 240 + 2 * s.numel() * 4 + 4 * 20 * bsz * 4
    return nbytes, sectors


def products(fe_ops: tuple[int, int]) -> int:
    muls, squarings = fe_ops
    return muls * PRODUCTS_PER_FE_MUL + squarings * PRODUCTS_PER_FE_SQ


def hash_ops(instr: tuple[int, int], count: int) -> float:
    """`count` times `instr` (logic functions and shifts, all) as INT32
    operations of the 64-lane rate: a SM issues at most 128 lanes of
    instructions a clock (four schedulers of 32), LOP3 and SHF run only on
    the 64-lane ALU pipe, and an addition may also issue on the FMA pipe
    (as IMAD), so the least is the larger of the two."""
    alu, total = instr
    return count * max(alu, total / 2)


def fe_ops(name: str, lanes: int) -> int:
    """32-bit limb products an ed25519 kernel's function needs."""
    return lanes * products(FE_OPS_PER_LANE[name]) + products(FE_OPS_PER_CALL.get(name, (0, 0)))


def bound_ms(ops: float, nbytes: int, clock_hz: float, sms: int) -> tuple[float, str]:
    """The least time for `ops` 32-bit integer operations at the 64-lane
    INT32 rate and `nbytes` moved, the larger of the two, and which one
    sets it."""
    t_ops = ops / (INT32_LANES_PER_SM_CLOCK * sms * clock_hz)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def stage_times(dev, verifier, path: str, pubs, commits) -> dict:
    """Seconds of each stage of one call of a phase, the card
    synchronised after each: host prep, copy to the card, the torch
    prologue (the digit packing of the fused and ladder paths), the
    chain kernel, the finish kernel with the copy back."""
    import torch

    from tendermint_tpu_torch.ops import ed25519_ladder as lad
    from tendermint_tpu_torch.ops import ed25519_tables as tab
    from tendermint_tpu_torch.ops.ed25519_kernel import prepare_batch

    out = {}
    clock = [time.perf_counter()]

    def mark(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = now - clock[0]
        clock[0] = now

    if path == "ladder":
        msgs, sigs = commits
        pub, r, s, h, _pre = prepare_batch(pubs, msgs, sigs)
        mark("host_prep_s")
        pub, r, s, h = (torch.from_numpy(a).to(dev) for a in (pub, r, s, h))
        mark("to_device_s")
        dig = tab._digits_w4(s.to(torch.int32), h.to(torch.int32))
        mark("prologue_s")
        (x, y, z, _t), a_ok = lad.ladder(pub, dig)
        mark("kernel_s")
        (tab.finish_encode_compare(x, y, z, r) & a_ok).cpu()
        mark("finish_s")
        return out
    tables, _ok = verifier.tables_for(tuple(pubs))
    s, h, r, _pre = tab.prepare_commit_lanes(pubs, commits)
    mark("host_prep_s")
    s, h, r = (torch.from_numpy(a).to(dev) for a in (s, h, r))
    s, h = s.to(torch.int32), h.to(torch.int32)
    mark("to_device_s")
    if path == "entries":
        x, y, z, _t = tab.sum_entries(tables, s, h)
    else:
        dig = tab._digits_w4(s, h)
        mark("prologue_s")
        x, y, z, _t = tab.fused_chain(tables, dig)
    mark("kernel_s")
    tab.finish_encode_compare(x, y, z, r).cpu()
    mark("finish_s")
    return out


def profiled(fn):
    """`key_averages()` of a torch.profiler session around `fn` (the card
    synchronised before it and inside it). On the H100 a session now and
    then ends having recorded no device activity at all, every launch in
    it lost (`python3 -m tendermint_tpu_torch.profiler_drops` counts
    them); such a session is run again, up to PROFILE_TRIES in all, and
    counted in LOST_SESSIONS. Raises when every try was lost."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        if any(e.device_type == DeviceType.CUDA for e in events):
            return events
        LOST_SESSIONS[0] += 1
        time.sleep(PROFILE_RETRY_PAUSE_S)
    raise AssertionError(f"torch.profiler recorded no device activity in {PROFILE_TRIES} sessions")


def device_time(fn) -> dict:
    """One call of `fn` under torch.profiler (`profiled`): the summed time
    of every kernel the card ran, how many ran, and the eight that took
    longest."""
    from torch.autograd import DeviceType

    kernels = [
        e for e in profiled(fn)
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    ]
    total_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return {
        "device_s": total_us / 1e6,
        "device_kernels": sum(e.count for e in kernels),
        "top": [
            {"name": e.key[:90], "count": e.count, "ms": e.self_device_time_total / 1e3}
            for e in top
        ],
    }


def byte_items(rng, lens) -> list[bytes]:
    """Random byte strings of the given lengths, cut from one buffer."""
    ends = np.cumsum(lens)
    buf = rng.bytes(int(ends[-1]))
    return [buf[e - n : e] for n, e in zip(np.asarray(lens).tolist(), ends.tolist())]


def max_err(got, want) -> int:
    """Largest absolute difference of two int32 word tensors (0 when equal)."""
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"shapes differ: {tuple(got.shape)} / {tuple(want.shape)}")
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item()) if got.numel() else 0


def kernel_ms(fn, symbol: str, reps: int) -> tuple[float, int]:
    """Device milliseconds of one launch of the kernel named `symbol`,
    from torch.profiler over `reps` calls of `fn`, and the launches it
    recorded: the mean over those (it has dropped one of five
    back-to-back 30 us launches); raises when it recorded fewer than
    `reps` - 1 or more than `reps`."""
    from torch.autograd import DeviceType

    def calls():
        for _ in range(reps):
            fn()

    hits = [e for e in profiled(calls) if e.device_type == DeviceType.CUDA and symbol in e.key]
    seen = sum(e.count for e in hits)
    if not max(1, reps - 1) <= seen <= reps:
        raise AssertionError(f"the profiler saw {seen} launches of {symbol} in {reps} calls")
    return sum(e.self_device_time_total for e in hits) / 1e3 / seen, seen


def hash_stage_times(dev, items, algo, levels: bool = True) -> dict:
    """Seconds of each stage of one tree build (or, levels=False, one
    leaf-hash pass), the card synchronised after each: padding on the
    host, copy to the card, the leaf kernel, the levels, the copy back."""
    import torch

    from tendermint_tpu_torch.ops import merkle_kernel as mk
    from tendermint_tpu_torch.ops.sha256_kernel import to_u32, to_words

    out = {}
    clock = [time.perf_counter()]

    def mark(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = now - clock[0]
        clock[0] = now

    blocks, n_blocks = mk._pad_leaves(items, algo)
    mark("padding_s")
    b, n = to_words(blocks, dev), to_words(n_blocks, dev)
    mark("to_device_s")
    digs = mk._leaf_kernel(algo)(b, n)
    mark("leaf_kernel_s")
    if levels:
        digs = mk.merkle_root_from_leaf_words(digs, algo=algo, device=dev)[None]
        mark("levels_s")
    mk._to_bytes(algo)(to_u32(digs))
    mark("copy_back_s")
    return out


def run_hash(seed: int, dev, sync) -> tuple[dict, dict, tuple]:
    """The hash phase's main path, each step with the launch counts set
    to 0 just before it and read just after: a 65,536-tx block's
    data_hash for both tree variants, a forest, the state-sync gate and a
    SHA-512 batch, at the sizes of the module's constants. Returns the
    report, the summed launches and the inputs (txs, forest, chunks,
    SHA-512 messages)."""
    import hashlib

    from tendermint_tpu_torch.merkle import simple as host
    from tendermint_tpu_torch.ops import merkle_kernel as mk
    from tendermint_tpu_torch.ops.padding import digests_to_bytes_be, pad_sha512
    from tendermint_tpu_torch.ops.sha256_kernel import to_u32
    from tendermint_tpu_torch.ops.sha512_kernel import sha512_batch
    from tendermint_tpu_torch.services.hasher import TreeHasher

    rng = np.random.default_rng(seed + 5)
    rep: dict = {}
    launches = dict.fromkeys(("sha256_masked", "ripemd160_masked", "sha512_masked", "merkle_level"), 0)

    def add(c, expect: dict, what: str) -> dict:
        got = {k: c[k] for k in launches}
        for k, v in expect.items():
            if got[k] != v:
                raise AssertionError(f"{what}: {k} launched {got[k]} times, expected {v}")
        for k in launches:
            launches[k] += got[k]
        return got

    def host_median(fn) -> tuple[float, list]:
        times = []
        for _ in range(HASH_REPS):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times), times

    # block data_hash: TXS transactions of TX_BYTES
    t0 = time.perf_counter()
    txs = byte_items(rng, np.full(TXS, TX_BYTES))
    rep["tx_gen_s"] = time.perf_counter() - t0
    levels = mk._next_pow2(TXS).bit_length() - 1
    rep["data_hash"] = {}
    for algo in ("sha256", "ripemd160"):
        want = host.simple_hash_from_byte_slices(txs, algo)
        host_s, host_all = host_median(lambda: host.simple_hash_from_byte_slices(txs, algo))
        hasher = TreeHasher(algo=algo, device=dev)
        got = []
        reset_counts()
        cold = timed(lambda: got.append(hasher.root_from_items(txs)), sync)
        warm = [timed(lambda: got.append(hasher.root_from_items(txs)), sync) for _ in range(HASH_REPS)]
        calls = 1 + HASH_REPS
        c = add(counts(), {LEAF_KERNEL[algo]: calls, "merkle_level": calls * levels}, f"data_hash {algo}")
        if any(g != want for g in got):
            raise AssertionError(f"data_hash {algo}: the card's root differs from the host tree's")
        med = statistics.median(warm)
        d = {
            "txs": TXS,
            "tx_bytes": TX_BYTES,
            "root": want.hex(),
            "cold_s": cold,
            "warm_s_median": med,
            "warm_s": warm,
            "leaves_per_s": TXS / med,
            "host_s_median": host_s,
            "host_s": host_all,
            "host_leaves_per_s": TXS / host_s,
            "launches": c,
        }
        rep["data_hash"][algo] = d
        log({"phase": "hash", "part": "data_hash", "algo": algo, **{k: v for k, v in d.items() if k != "warm_s"}})

    # forest: a fast-sync window of blocks, 1..FOREST_MAX_TXS txs of 1..1024 bytes
    sizes = rng.integers(1, FOREST_MAX_TXS + 1, FOREST_TREES)
    sizes[0], sizes[-1] = 1, FOREST_MAX_TXS  # a 1-tx tree and a power of two
    trees = [byte_items(rng, rng.integers(1, 1025, k)) for k in sizes]
    rep["forest"] = {"trees": FOREST_TREES, "txs": int(sizes.sum())}
    for algo in ("sha256", "ripemd160"):
        t0 = time.perf_counter()
        want = [host.simple_hash_from_byte_slices(t, algo) for t in trees]
        host_s = time.perf_counter() - t0
        got = []
        reset_counts()
        dt = timed(lambda: got.append(mk.merkle_roots_forest(trees, algo, dev)), sync)
        c = add(counts(), {LEAF_KERNEL[algo]: 1}, f"forest {algo}")
        if got[0] != want:
            raise AssertionError(f"forest {algo}: roots differ from the host tree's")
        rep["forest"][algo] = {"s": dt, "host_s": host_s, "launches": c}
    log({"phase": "hash", "part": "forest", **rep["forest"]})

    # state-sync gate: CHUNKS chunks of CHUNK_BYTES, their leaf hashes and root
    t0 = time.perf_counter()
    chunks = byte_items(rng, np.full(CHUNKS, CHUNK_BYTES))
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want_leaves = [hashlib.sha256(b"\x00" + c).digest() for c in chunks]
    host_leaf_s = time.perf_counter() - t0
    want_root = host.simple_hash_from_hashes(want_leaves)
    hasher = TreeHasher(algo="sha256", device=dev)
    got = []
    reset_counts()
    cold = timed(lambda: got.append(hasher.leaf_hashes(chunks)), sync)
    warm = timed(lambda: got.append(hasher.leaf_hashes(chunks)), sync)
    roots = []
    root_s = timed(lambda: roots.append(hasher.root_from_hashes(got[-1])), sync)
    sync_levels = mk._next_pow2(CHUNKS).bit_length() - 1
    c = add(counts(), {"sha256_masked": 2, "merkle_level": sync_levels}, "state-sync gate")
    if any(g != want_leaves for g in got) or roots[0] != want_root:
        raise AssertionError("state-sync gate: leaf hashes or root differ from hashlib and the host tree")
    rep["state_sync"] = {
        "chunks": CHUNKS,
        "chunk_bytes": CHUNK_BYTES,
        "gen_s": gen_s,
        "cold_leaf_hashes_s": cold,
        "warm_leaf_hashes_s": warm,
        "host_leaf_hashes_s": host_leaf_s,
        "root_from_hashes_s": root_s,
        "launches": c,
    }
    log({"phase": "hash", "part": "state_sync", **rep["state_sync"]})

    # SHA-512 of R || A || M, as long as the flat phase's
    msgs = byte_items(rng, np.full(SHA512_MSGS, 64 + MSG_LEN))
    blocks, n_blocks = pad_sha512(msgs)
    reset_counts()
    out = []
    dt = timed(lambda: out.append(sha512_batch(blocks, n_blocks, dev)), sync)
    c = add(counts(), {"sha512_masked": 1}, "sha512")
    if digests_to_bytes_be(to_u32(out[0])) != [hashlib.sha512(m).digest() for m in msgs]:
        raise AssertionError("sha512_batch differs from hashlib")
    rep["sha512"] = {"msgs": SHA512_MSGS, "msg_bytes": 64 + MSG_LEN, "s": dt, "launches": c}
    log({"phase": "hash", "part": "sha512", **rep["sha512"]})
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the hash phase did not launch {name}")
    return rep, launches, (txs, trees, chunks, msgs)


def hash_kernels(dev, txs, trees, msgs) -> list:
    """The four hash kernels against their plain versions on the card, at
    the data_hash block (leaf passes and the first level, both variants),
    every level of the forest (mixed counts: unpaired nodes promoted) and
    the SHA-512 batch; entries for the kernels line."""
    import torch

    from tendermint_tpu_torch.ops import merkle_kernel as mk
    from tendermint_tpu_torch.ops import ripemd160_kernel as hr
    from tendermint_tpu_torch.ops import sha256_kernel as hs
    from tendermint_tpu_torch.ops import sha512_kernel as h5
    from tendermint_tpu_torch.ops.padding import pad_sha512
    from tendermint_tpu_torch.ops.sha256_kernel import to_words

    entries = []
    level_err = 0
    plains = {"sha256": hs._sha256_masked, "ripemd160": hr._ripemd160_masked}
    n = len(txs)
    p = mk._next_pow2(n)
    for algo in ("sha256", "ripemd160"):
        blocks, n_blocks = mk._pad_leaves(txs, algo)
        b, nb = to_words(blocks, dev), to_words(n_blocks, dev)
        kern, plain = mk._leaf_kernel(algo), plains[algo]
        digs = kern(b, nb)
        err = max_err(digs, plain(b, nb))
        if err:
            raise AssertionError(f"{LEAF_KERNEL[algo]}: kernel disagrees with its plain version ({err})")
        comps = int(n_blocks.sum())
        width = mk.WIDTHS[algo]
        entries.append((LEAF_KERNEL[algo], err, lambda k=kern, b=b, nb=nb: k(b, nb),
                        lambda f=plain, b=b, nb=nb: f(b, nb), n,
                        hash_ops(INSTR_PER_COMPRESSION[algo], comps), comps * 64 + 4 * n + 4 * width * n))
        nodes = torch.cat([digs, digs.new_zeros((p - n, width))]).view(1, p, width)
        counts_t = torch.tensor([n], dtype=torch.int32, device=dev)
        level_err = max(level_err, max_err(mk.merkle_level(nodes, counts_t, 0, algo),
                                           mk._merkle_level(nodes, counts_t, 0, algo)))
        f_nodes, f_counts = mk.forest_leaves(trees, algo, dev)
        for lv in range(f_nodes.shape[1].bit_length() - 1):
            got = mk.merkle_level(f_nodes, f_counts, lv, algo)
            level_err = max(level_err, max_err(got, mk._merkle_level(f_nodes, f_counts, lv, algo)))
            f_nodes = got
        if level_err:
            raise AssertionError(f"merkle_level ({algo}): kernel disagrees with its plain version ({level_err})")
        if algo == "sha256":
            level = (nodes, counts_t, hash_ops(INSTR_PER_SHA256_INNER_NODE, n // 2), nodes.numel() * 4 * 3 // 2 + 4)
    nodes, counts_t, ops, nbytes = level
    entries.append(("merkle_level", level_err, lambda: mk.merkle_level(nodes, counts_t, 0),
                    lambda: mk._merkle_level(nodes, counts_t, 0), p // 2, ops, nbytes))
    blocks, n_blocks = pad_sha512(msgs)
    b, nb = to_words(blocks, dev), to_words(n_blocks, dev)
    err = max_err(h5.sha512_masked(b, nb), h5._sha512_masked(b, nb))
    if err:
        raise AssertionError(f"sha512_masked: kernel disagrees with its plain version ({err})")
    comps = int(n_blocks.sum())
    entries.append(("sha512_masked", err, lambda: h5.sha512_masked(b, nb), lambda: h5._sha512_masked(b, nb),
                    len(msgs), hash_ops(INSTR_PER_COMPRESSION["sha512"], comps), comps * 128 + 4 * len(msgs) + 64 * len(msgs)))
    return entries


def sha512_wide(seed: int, dev, clock_hz: float, sms: int, reps: int) -> dict:
    """`sha512_masked` at SHA512_WIDE_MSGS messages of R || A || M: the
    digests against hashlib, the profiler's device time a launch and the
    bound, as for the kernels line; then one message alone, and the two
    floors of one message (SHA512_ROUND_DEPTH, SHA512_ROUND_ALU)."""
    import hashlib

    from tendermint_tpu_torch.ops.padding import digests_to_bytes_be, pad_sha512
    from tendermint_tpu_torch.ops.sha256_kernel import to_u32, to_words
    from tendermint_tpu_torch.ops.sha512_kernel import sha512_masked

    msgs = byte_items(np.random.default_rng(seed + 6), np.full(SHA512_WIDE_MSGS, 64 + MSG_LEN))
    blocks, n_blocks = pad_sha512(msgs)
    b, nb = to_words(blocks, dev), to_words(n_blocks, dev)
    if digests_to_bytes_be(to_u32(sha512_masked(b, nb))) != [hashlib.sha512(m).digest() for m in msgs]:
        raise AssertionError(f"sha512_masked at {SHA512_WIDE_MSGS} messages differs from hashlib")
    ms, seen = kernel_ms(lambda: sha512_masked(b, nb), PROFILED["sha512_masked"], reps)
    comps = int(n_blocks.sum())
    n = len(msgs)
    bms, by = bound_ms(hash_ops(INSTR_PER_COMPRESSION["sha512"], comps), comps * 128 + 4 * n + 64 * n, clock_hz, sms)
    # one message alone: its chain of compressions, the least any batch takes
    one_ms, _seen = kernel_ms(lambda: sha512_masked(b[:1], nb[:1]), PROFILED["sha512_masked"], reps)
    rounds = (comps // n) * 80
    warp_clocks = 32 / (INT32_LANES_PER_SM_CLOCK / 4)
    return {"msgs": n, "ms": ms, "profiled_launches": seen, "bound_ms": bms, "bound_by": by,
            "one_msg_ms": one_ms,
            "chain_floor_ms": 1e3 * rounds * SHA512_ROUND_DEPTH * ALU_LATENCY_CYCLES / clock_hz,
            "issue_floor_ms": 1e3 * rounds * SHA512_ROUND_ALU * warp_clocks / clock_hz}


def hash_profile(dev, sync, rep, txs, chunks) -> None:
    """After the main path: stage breakdowns, the card's kernels in one
    data_hash call (torch.profiler) and the host-vs-card crossover."""
    from tendermint_tpu_torch.merkle import simple as host
    from tendermint_tpu_torch.ops import merkle_kernel as mk
    from tendermint_tpu_torch.services.hasher import TreeHasher

    rep["stages"] = {algo: hash_stage_times(dev, txs, algo) for algo in ("sha256", "ripemd160")}
    rep["stages"]["state_sync_leaves"] = hash_stage_times(dev, chunks, "sha256", levels=False)
    log({"phase": "hash", "part": "stages", **rep["stages"]})
    rep["device"] = {}
    for algo in ("sha256", "ripemd160"):
        hasher = TreeHasher(algo=algo, device=dev)
        d = device_time(lambda: hasher.root_from_items(txs))
        wall = rep["data_hash"][algo]["warm_s_median"]
        d["wall_s"] = wall
        d["busy_share"] = d["device_s"] / wall
        rep["device"][algo] = d
        log({"phase": "hash", "part": "device", "algo": algo, **{k: v for k, v in d.items() if k != "top"}})
    cross = []
    for n in sorted({min(k, len(txs)) for k in (256, 1024, 4096, 8192, 16384, 65536)}):
        items = txs[:n]
        mk.merkle_root_device(items, "sha256", dev)  # warm
        dev_s = statistics.median(timed(lambda: mk.merkle_root_device(items, "sha256", dev), sync) for _ in range(3))
        host_s = statistics.median(timed(lambda: host.simple_hash_from_byte_slices(items), sync) for _ in range(3))
        cross.append({"leaves": n, "device_s": dev_s, "host_s": host_s})
    rep["crossover_sha256"] = cross
    log({"phase": "hash", "part": "crossover", "sha256": cross})


# the node calls `warm_kernels()` as it starts: the call must return at
# once, its thread doing the work
WARM_CALL_LIMIT_S = 0.05
WARM_CALLS = 3
# a process that exits while a table prebuild of this many keys runs on
# the card must exit with code 0
PREBUILD_EXIT_KEYS = 1000
PREBUILD_EXIT = """
import sys
import numpy as np
from tendermint_tpu_torch.services.verifier import default_verifier
rng = np.random.default_rng(int(sys.argv[1]))
default_verifier().prebuild([rng.bytes(32) for _ in range(int(sys.argv[2]))])
"""
# the stack phase's fault drill: a validator set of DEVICE_MIN_BATCH keys
# (the least commit the table backend sends to the card), a set of
# FAULT_SMALL_KEYS keys in stacks of FAULT_SMALL_K commits (a table build
# the breaker degrades to the CPU; K = 8 takes the fused chain) and
# STACK_CONSUMERS flat consumers
FAULT_SMALL_KEYS = 64
FAULT_SMALL_K = 8
STACK_CONSUMERS = 4
VERIFY_KERNELS = ("madd_chain_entries", "madd_chain_fused", "ladder", "finish_encode_compare")


def check_layers(stack) -> None:
    """`default_verifier()` must hand out the JAX node's layering on the
    card: CoalescingVerifier -> ResilientVerifier -> TableBatchVerifier."""
    from tendermint_tpu_torch.services.batcher import CoalescingVerifier
    from tendermint_tpu_torch.services.resilient import ResilientVerifier
    from tendermint_tpu_torch.services.verifier import TableBatchVerifier

    inner = getattr(stack, "inner", None)
    primary = getattr(inner, "primary", None)
    if not (
        isinstance(stack, CoalescingVerifier)
        and isinstance(inner, ResilientVerifier)
        and isinstance(primary, TableBatchVerifier)
        and primary.device.type == "cuda"
    ):
        raise AssertionError(f"default_verifier() is not the node's stack on the card: {stack!r}")


class StackHealth:
    """Resilient wrappers' host fallbacks and primary failures (each
    wrapper's own, by its kind), read before and after each step: a step
    fails when a failure or a fallback it did not inject shows up (a
    broken kernel must not hide behind the resilient layer's host
    answer). The registry's `tendermint_device_dispatch_failures_total`
    sums these over every wrapper of a kind."""

    def __init__(self, *wrappers):
        self.wrappers = wrappers
        self.base = self.read()

    def read(self) -> dict:
        snaps = [w.snapshot() for w in self.wrappers]
        return {s["kind"]: (s["fallback_calls"], s["total_failures"]) for s in snaps}

    def check(self, what: str, expect: dict | None = None) -> dict:
        """`expect` maps a kind to the (fallbacks, failures) the step
        injected; every other kind must not move."""
        now = self.read()
        moved = {k: (now[k][0] - self.base[k][0], now[k][1] - self.base[k][1]) for k in now}
        want = {k: (expect or {}).get(k, (0, 0)) for k in now}
        if moved != want:
            raise AssertionError(f"stack {what}: fallbacks and failures {moved}, expected {want}")
        self.base = now
        return moved


def _counter(name: str, **labels) -> float:
    from tendermint_tpu_torch.telemetry import REGISTRY

    return REGISTRY.counter_value(name, **labels)


def _hist(name: str, **labels) -> tuple[float, int]:
    from tendermint_tpu_torch.telemetry import REGISTRY

    fam = REGISTRY.get(name)
    snap = fam.labels(**labels).value if labels else fam.value
    return snap["sum"], snap["count"]


def _launched(c: dict, names, what: str, phase: str = "stack") -> None:
    for name in names:
        if c[name] == 0:
            raise AssertionError(f"{phase} {what}: {name} did not launch")


# -- telemetry: the launch ledger, spans, the flight recorder ----------------

REPO = pathlib.Path(__file__).resolve().parent
OUT = pathlib.Path("chiprun_out")
LEDGER_FILE = "launches.jsonl"
SPANS_FILE = "spans.jsonl"
METRICS_FILE = "metrics.prom"
# a ledger ring that holds the whole run: each step reads the records it
# committed by position
LEDGER_CAPACITY = 1 << 20
LEDGER_REPS = 5  # cached commits with the ledger on, then off, in turns


def attach_telemetry() -> None:
    """Point the process's launch ledger at chiprun_out/launches.jsonl and
    its tracer's span log at chiprun_out/spans.jsonl, both started empty,
    and the flight recorder's dumps at chiprun_out/."""
    from tendermint_tpu_torch.telemetry import TRACER
    from tendermint_tpu_torch.telemetry.flightrec import FLIGHT
    from tendermint_tpu_torch.telemetry.launchlog import LAUNCHLOG
    from tendermint_tpu_torch.telemetry.spanlog import persist_spans

    OUT.mkdir(exist_ok=True)
    for name in (LEDGER_FILE, SPANS_FILE):
        (OUT / name).unlink(missing_ok=True)
    LAUNCHLOG.capacity = LEDGER_CAPACITY
    LAUNCHLOG.attach(str(OUT / LEDGER_FILE), node_id="chip_smoke")
    persist_spans(TRACER, str(OUT / SPANS_FILE))
    FLIGHT.set_dump_dir(str(OUT))
    FLIGHT.set_node_id("chip_smoke")


def dump_metrics() -> dict:
    """The metric registry as Prometheus text (chiprun_out/metrics.prom)
    and as the structured dump (returned, for chip_smoke.json)."""
    from tendermint_tpu_torch.telemetry import REGISTRY

    (OUT / METRICS_FILE).write_text(REGISTRY.prometheus_text())
    return REGISTRY.to_dict()


def drop_stale_record() -> None:
    """A mesh step called directly (not through a backend) annotates the
    step cache's hit into an implicit launch record no backend commits:
    drop it, so that the next backend call's record starts clean."""
    from tendermint_tpu_torch.telemetry import launchlog

    launchlog.detach(launchlog.current())


def spans_of(name: str) -> dict:
    """Trace id -> the spans called `name` in chiprun_out/spans.jsonl."""
    out: dict = {}
    for line in (OUT / SPANS_FILE).read_text().splitlines():
        span = json.loads(line)
        if span["name"] == name:
            out.setdefault(span.get("attrs", {}).get("trace"), []).append(span)
    return out


class StepLedger:
    """One step's launch-ledger account. Each call the step makes through
    a backend runs in `call()`, which holds the records the call committed
    against the kernel wrappers' launches it made
    (`testing.ledger_launches` against `testing.kernel_launches`: one
    record a dispatch unit, its kernel once a shard, the finish after
    every verify); a step whose calls run on threads of their own (a
    consensus, the ingress, a net) calls `settle()` once they have
    joined instead; `close()` fails on a record with an error the step
    did not inject and prints the step's `launches` line, the ledger's
    `summarize()` of its records."""

    def __init__(self, phase: str, step: str):
        from tendermint_tpu_torch.telemetry.launchlog import LAUNCHLOG

        self.phase, self.step = phase, step
        self.mark = len(LAUNCHLOG)
        self.base = counts()
        self.kernels: dict = {}

    def call(self, fn):
        from tendermint_tpu_torch.telemetry.launchlog import LAUNCHLOG
        from tendermint_tpu_torch.testing import kernel_launches, ledger_launches

        mark, before = len(LAUNCHLOG), counts()
        out = fn()
        after = counts()
        got = ledger_launches(LAUNCHLOG.recent()[mark:])
        want = kernel_launches({k: after[k] - before[k] for k in after})
        if got != want:
            raise AssertionError(f"{self.phase} {self.step}: the ledger's records account for {got} launches, "
                                 f"the kernel wrappers counted {want}")
        for k, v in want.items():
            self.kernels[k] = self.kernels.get(k, 0) + v
        return out

    def records(self) -> list:
        from tendermint_tpu_torch.telemetry.launchlog import LAUNCHLOG

        return LAUNCHLOG.recent()[self.mark:]

    def settle(self, timeout: float = 30.0, roots: int = 0) -> dict:
        """The kernel launches since the step began, once its records
        account for every one of them (a dispatch unit commits its record
        at its join). `roots` is the step's `root_from_hashes` calls on the
        card, held out of the hash family: each commits a record that
        launches `merkle_level` alone."""
        from tendermint_tpu_torch.testing import kernel_launches, ledger_launches

        deadline = time.time() + timeout
        while True:
            now = counts()
            c = {k: now[k] - self.base[k] for k in now}
            got, want = ledger_launches(self.records()), kernel_launches(c)
            got["hash"] -= roots
            if got == want:
                return c
            if time.time() > deadline:
                raise AssertionError(f"{self.phase} {self.step}: the ledger's records account for {got} launches, "
                                     f"the kernel wrappers counted {want}")
            time.sleep(0.01)

    def close(self, errors: int = 0) -> dict:
        from tendermint_tpu_torch.telemetry.launchlog import summarize

        recs = self.records()
        failed = [r for r in recs if r.get("error")]
        if len(failed) != errors:
            raise AssertionError(f"{self.phase} {self.step}: ledger records with an error {failed}, "
                                 f"{errors} injected")
        line = {"launches": f"{self.phase} {self.step}", "records": len(recs), "kernel_launches": self.kernels,
                "kinds": summarize(recs)}
        log(line)
        return line


def run_stack(stack, inp, sync, commit, window, flat, hashed, reps: int) -> dict:
    """Phase 6: the main path's work through the stack a node calls.
    `commit`, `window`, `flat` are the earlier phases' inputs with their
    expected masks and bare warm medians; `hashed` is the hash phase's
    block, its sha256 root and the state-sync chunks. Each step's
    launches are zeroed just before it and read just after, and stand on
    its own line only: the kernels line keeps the bare phases' counts."""
    import hashlib
    import threading

    from tendermint_tpu_torch.merkle import simple as host
    from tendermint_tpu_torch.services.batcher import CoalescingVerifier
    from tendermint_tpu_torch.services.hasher import default_hasher
    from tendermint_tpu_torch.services.resilient import ResilientTreeHasher, ResilientVerifier
    from tendermint_tpu_torch.services.verifier import DEVICE_MIN_BATCH, TableBatchVerifier
    from tendermint_tpu_torch.telemetry import tracectx
    from tendermint_tpu_torch.telemetry.flightrec import FLIGHT
    from tendermint_tpu_torch.utils import fail, lockrank
    from tendermint_tpu_torch.utils.circuit import CLOSED, OPEN, CircuitBreaker

    rep: dict = {}
    hits = "tendermint_verify_cache_hits_total"

    # 0. the warm-up a node calls at start: it returns at once, and its
    # thread ends with the kernel library loaded; then a process that
    # exits while a table prebuild runs on the card exits with code 0
    import gc

    from tendermint_tpu_torch.ops import _build

    # the earlier phases left millions of objects: collect first, so that a
    # full collection (tens of ms) does not land inside a timed call; the
    # call is timed WARM_CALLS times (its thread joined each time) and its
    # median held to the limit, since one call on this busy host varied
    # from 4 to 45 ms where an idle process starts the thread in 1 ms
    call_s, thread_s = [], []
    for _ in range(WARM_CALLS):
        gc.collect()
        t0 = time.perf_counter()
        thread = stack.warm_kernels()
        call_s.append(time.perf_counter() - t0)
        if thread is None:
            raise AssertionError("stack warm: warm_kernels() started no thread on the card")
        thread.join(timeout=300)
        thread_s.append(time.perf_counter() - t0)
        if thread.is_alive() or _build._LIB is None:
            raise AssertionError(f"stack warm: the thread is alive: {thread.is_alive()}, "
                                 f"library loaded: {_build._LIB is not None}")
    if statistics.median(call_s) >= WARM_CALL_LIMIT_S:
        raise AssertionError(f"stack warm: warm_kernels() took {call_s} s to return")
    repo = pathlib.Path(__file__).resolve().parent
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", PREBUILD_EXIT, str(inp.seed), str(PREBUILD_EXIT_KEYS)], cwd=repo,
        env={**os.environ, "PYTHONPATH": str(repo)}, capture_output=True, text=True, timeout=300,
    )
    exit_s = time.perf_counter() - t0
    if out.returncode != 0 or "terminate called" in out.stderr:
        raise AssertionError(f"stack warm: a process exiting during a prebuild ended with code {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    rep["warm"] = {"call_s": call_s, "call_s_median": statistics.median(call_s), "thread_s": thread_s,
                   "library_loaded": True,
                   "prebuild_exit": {"keys": PREBUILD_EXIT_KEYS, "returncode": out.returncode, "process_s": exit_s}}
    log({"phase": "stack", "step": "warm", **rep["warm"]})

    hasher = default_hasher()
    if not (isinstance(hasher, ResilientTreeHasher) and hasher.primary.device == stack.inner.primary.device):
        raise AssertionError(f"default_hasher() is not a ResilientTreeHasher on the stack's card: {hasher!r}")
    health = StackHealth(stack.inner, hasher)
    failures = "tendermint_device_dispatch_failures_total"
    failures0 = {k: _counter(failures, kind=k) for k in ("verify", "hash")}

    # 1. the consensus commit: `reps` cold calls, each on an empty
    # verified-signature cache (the stack's own first call, then fresh
    # CoalescingVerifiers over the same resilient layer and table cache),
    # and `reps` calls from the stack's cache. Before each call its cache
    # filter is timed alone on the same cache.
    pubs, commits, expected, bare_s = commit
    good = int(expected.sum())
    runs: dict = {"cold": [], "cached": []}
    led = StepLedger("stack", "commit")

    def commit_call(v, kind):
        t0 = time.perf_counter()
        v._filter_lanes(pubs, commits)
        filter_s = time.perf_counter() - t0
        got = []
        h0 = _counter(hits)
        reset_counts()
        dt = timed(lambda: got.append(led.call(lambda: v.verify_commits(pubs, commits))), sync)
        c = counts()
        check_mask(f"stack commit ({kind})", got[0], expected[None, :])
        hit = int(_counter(hits) - h0)
        if hit != (good if kind == "cached" else 0):
            raise AssertionError(f"stack commit ({kind}): {hit} cache hits of {good} good lanes")
        _launched(c, ("madd_chain_entries", "finish_encode_compare"), f"commit ({kind})")
        runs[kind].append({"s": dt, "filter_s": filter_s, "cache_hits": hit, "launches": c})

    commit_call(stack, "cold")
    for _ in range(reps - 1):
        v = CoalescingVerifier(stack.inner)
        try:
            commit_call(v, "cold")
        finally:
            v.coalescer.close()  # the resilient layer and tables stay the stack's
    for _ in range(reps):
        commit_call(stack, "cached")
    # the ledger's cost: the cached commit with the ledger on and off, in
    # turns (reported, not gated: the host's noise is larger)
    on_s, off_s = [], []
    knob = os.environ.get("TENDERMINT_TPU_LAUNCHLOG")
    try:
        for _ in range(LEDGER_REPS):
            for flag, times in (("1", on_s), ("0", off_s)):
                os.environ["TENDERMINT_TPU_LAUNCHLOG"] = flag
                got = []
                times.append(timed(lambda: got.append(stack.verify_commits(pubs, commits)), sync))
                check_mask(f"stack commit (ledger {flag})", got[0], expected[None, :])
    finally:
        if knob is None:
            os.environ.pop("TENDERMINT_TPU_LAUNCHLOG", None)
        else:
            os.environ["TENDERMINT_TPU_LAUNCHLOG"] = knob
    rep["ledger_overhead"] = {"reps": LEDGER_REPS, "on_s": on_s, "off_s": off_s,
                              "on_s_median": statistics.median(on_s), "off_s_median": statistics.median(off_s),
                              "on_over_off": statistics.median(on_s) / statistics.median(off_s)}
    log({"phase": "stack", "step": "ledger_overhead", **rep["ledger_overhead"]})
    health.check("commit")
    med = {f"{kind}_{key}_median": statistics.median(r[key] for r in rs)
           for kind, rs in runs.items() for key in ("s", "filter_s")}
    rep["commit"] = {"validators": len(pubs), "reps": reps, **med, "bare_warm_s_median": bare_s,
                     "cold_s": [r["s"] for r in runs["cold"]], "cached_s": [r["s"] for r in runs["cached"]],
                     "cache_hits": [r["cache_hits"] for r in runs["cold"] + runs["cached"]],
                     "launches": {kind: rs[0]["launches"] for kind, rs in runs.items()}}
    log({"phase": "stack", "step": "commit", **rep["commit"]})
    rep["commit"]["ledger"] = led.close()
    rep["cache_filter"] = {"lanes": len(pubs), "reps": reps,
                           "cold_s": [r["filter_s"] for r in runs["cold"]],
                           "cached_s": [r["filter_s"] for r in runs["cached"]],
                           "cold_s_median": med["cold_filter_s_median"],
                           "cached_s_median": med["cached_filter_s_median"]}
    log({"phase": "stack", "step": "cache_filter", **rep["cache_filter"]})

    # 2. the fast-sync window through the async surface; the stack has not
    # seen phase 3's signatures, so its cache holds none of them
    pubs, commits, expected, bare_s = window
    h0 = _counter(hits)
    ov0 = _hist("tendermint_dispatch_overlap_ratio", queue="default")
    led = StepLedger("stack", "window")
    reset_counts()
    got = []
    # once, under a trace context minted with every trace sampled: its
    # `dispatch.launch` span carries the trace id its ledger record holds
    tracectx.force_all(True)
    ctx = tracectx.mint("chip_smoke")
    with tracectx.use(ctx):
        dt = timed(lambda: got.append(led.call(
            lambda: stack.verify_commits_async(pubs, commits, consumer="fastsync").result())), sync)
    tracectx.force_all(False)
    c = counts()
    check_mask("stack window", got[0], expected)
    if _counter(hits) != h0:
        raise AssertionError("stack window: the cache answered lanes it never saw")
    _launched(c, ("madd_chain_fused", "finish_encode_compare"), "window")
    health.check("window")
    ov1 = _hist("tendermint_dispatch_overlap_ratio", queue="default")
    traced = [r for r in led.records() if r.get("trace") == ctx.trace]
    spans = spans_of("dispatch.launch").get(ctx.trace, [])
    if len(traced) != 1 or len(spans) != 1:
        raise AssertionError(f"stack window: {len(traced)} ledger records and {len(spans)} dispatch.launch spans "
                             f"carry the window's trace id")
    rep["window"] = {"validators": len(pubs), "window": len(commits), "s": dt, "bare_warm_s_median": bare_s,
                     "overlap_ratio": (ov1[0] - ov0[0]) / max(1, ov1[1] - ov0[1]), "launches": c,
                     "trace": ctx.trace, "span": spans[0], "record": traced[0]}
    log({"phase": "stack", "step": "window", **rep["window"]})
    rep["window"]["ledger"] = led.close()

    # 3. flat triples from STACK_CONSUMERS threads at once, coalesced:
    # first through the stack, each consumer under a trace context of its
    # own, so that each merged launch's `batcher.flush` span carries the
    # trace id its ledger record holds; then the same work on a
    # CoalescingVerifier of its own over the stack's resilient layer,
    # whose locks time their contention (TENDERMINT_TPU_PROFILE_HZ makes
    # them instrumentable; the stack's own stay plain, since the 10k
    # commit's cache filter takes one a lane and the timing costs each)
    triples, expected, bare_s = flat
    led = StepLedger("stack", "flat")
    per = len(triples) // STACK_CONSUMERS
    parts = [(triples[i * per:(i + 1) * per], expected[i * per:(i + 1) * per]) for i in range(STACK_CONSUMERS)]

    def flat_round(v, what: str, traced: bool):
        """The consumers' calls on `v`, at once; (seconds, launches,
        merged launches)."""
        flushes0 = sum(_counter("tendermint_batcher_flush_total", reason=r) for r in ("window", "size", "barrier"))
        h0 = _counter(hits)
        outs = [None] * STACK_CONSUMERS
        errors = []
        start = threading.Barrier(STACK_CONSUMERS + 1)

        def consumer(i):
            try:
                start.wait()
                with tracectx.use(tracectx.mint(f"consumer{i}") if traced else None):
                    outs[i] = v.verify_batch_async(parts[i][0], consumer=f"consumer{i}").result(timeout=300)
            except Exception as e:  # reported below: the step fails
                errors.append(e)

        def run_consumers():
            start.wait()
            for t in threads:
                t.join(timeout=300)

        reset_counts()
        threads = [threading.Thread(target=consumer, args=(i,)) for i in range(STACK_CONSUMERS)]
        for t in threads:
            t.start()
        sync()
        t0 = time.perf_counter()
        led.call(run_consumers)
        sync()
        dt = time.perf_counter() - t0
        c = counts()
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"stack {what}: consumers failed: {errors}")
        for i, (out, (_t, exp)) in enumerate(zip(outs, parts)):
            check_mask(f"stack {what} consumer {i}", out, exp)
        if _counter(hits) != h0:
            raise AssertionError(f"stack {what}: the cache answered triples it never saw")
        if not 1 <= c["ladder"] <= STACK_CONSUMERS:
            raise AssertionError(f"stack {what}: {c['ladder']} ladder launches for {STACK_CONSUMERS} consumers")
        _launched(c, ("ladder", "finish_encode_compare"), what)
        merged = sum(_counter("tendermint_batcher_flush_total", reason=r) for r in ("window", "size", "barrier"))
        return dt, c, int(merged - flushes0)

    tracectx.force_all(True)
    dt, c, merged = flat_round(stack, "flat", traced=True)
    tracectx.force_all(False)
    health.check("flat")
    flushes = spans_of("batcher.flush")
    traced = [r for r in led.records() if r.get("trace")]
    if not traced or any(len(flushes.get(r["trace"], [])) != 1 for r in traced):
        raise AssertionError(f"stack flat: the merged launches' trace ids {[r.get('trace') for r in led.records()]} "
                             f"have no batcher.flush span each")
    rep["flat"] = {"consumers": STACK_CONSUMERS, "lanes_each": per, "s": dt, "bare_warm_s_median": bare_s,
                   "merged_launches": merged, "verifies_per_s": per * STACK_CONSUMERS / dt, "launches": c,
                   "traced_launches": len(traced)}
    log({"phase": "stack", "step": "flat", **rep["flat"]})
    os.environ["TENDERMINT_TPU_PROFILE_HZ"] = "0"
    try:
        cv = CoalescingVerifier(stack.inner)
        lockrank.reset_contention()
        lockrank.set_timing(True)
        dt, c, merged = flat_round(cv, "flat (timed locks)", traced=False)
        contention = {"s": dt, "merged_launches": merged, **lockrank.contention_snapshot(top=5)}
    finally:
        lockrank.set_timing(False)
        os.environ.pop("TENDERMINT_TPU_PROFILE_HZ")
    cv.coalescer.close()  # the resilient layer stays the stack's
    health.check("flat (timed locks)")
    rep["flat"]["contention"] = contention
    log({"phase": "stack", "step": "flat_contention", **contention})
    rep["flat"]["ledger"] = led.close()

    # 4. the fault drill, on a resilient verifier of its own. Its breaker
    # runs on a clock this step moves: a host-answered 512-lane call
    # outlasts the 0.5 s reset, and the drill needs a call while OPEN.
    clock = [0.0]
    faulty = ResilientVerifier(
        TableBatchVerifier(device=stack.inner.primary.device),
        breaker=CircuitBreaker(3, 0.5, clock=lambda: clock[0]),
    )
    drill = StackHealth(faulty)
    n = DEVICE_MIN_BATCH
    sets = {"main": list(range(n)),
            "small": list(range(n, n + FAULT_SMALL_KEYS)),
            "large": list(range(n + FAULT_SMALL_KEYS, 2 * n + FAULT_SMALL_KEYS))}

    def fresh(keys, k=1):
        """k commits over `keys` with fresh messages, one forged lane each."""
        rows, exp = [], []
        for _ in range(k):
            p, m, sg, e = make_commit(inp, keys, {"forged": 7})
            rows.append((m, sg))
            exp.append(e)
        return p, rows, np.stack(exp)

    drill_rep: dict = {"validators": n, "calls": []}
    host_s = [0.0]
    t_phase = time.perf_counter()
    led = StepLedger("stack", "faults")
    t_wall = time.time()

    def call(what, keys, k=1, host=False):
        p, rows, exp = fresh(keys, k)
        reset_counts()
        t0 = time.perf_counter()
        out = led.call(lambda: faulty.verify_commits(p, rows))
        sync()
        dt = time.perf_counter() - t0
        c = counts()
        check_mask(f"stack faults: {what}", out, exp)
        if host:
            host_s[0] += dt
        row = {"call": what, "s": dt, "state": faulty.breaker.state,
               "verify_launches": sum(c[x] for x in VERIFY_KERNELS)}
        drill_rep["calls"].append(row)
        log({"phase": "stack", "step": "faults", **row})
        return c

    fail.set_device_fault("verify", -1)
    trips = 0
    while faulty.breaker.snapshot()["times_opened"] == 0:
        trips += 1
        if trips > 5:
            raise AssertionError("stack faults: the breaker did not open")
        c = call("faulted", sets["main"], host=True)
        if sum(c[x] for x in VERIFY_KERNELS):
            raise AssertionError("stack faults: a verify kernel launched under an injected fault")
    fail.clear_device_faults()
    if faulty.breaker.state != OPEN:
        raise AssertionError(f"stack faults: breaker {faulty.breaker.state} after the trip")
    c = call("open", sets["main"], host=True)
    if sum(c[x] for x in VERIFY_KERNELS):
        raise AssertionError("stack faults: a verify kernel launched while the breaker was open")
    clock[0] += 0.5  # the reset window elapses
    c = call("probe", sets["main"])
    if faulty.breaker.state != CLOSED:
        raise AssertionError(f"stack faults: the probe left the breaker {faulty.breaker.state}")
    _launched(c, ("madd_chain_entries", "finish_encode_compare"), "faults probe")
    snap = faulty.snapshot()
    faults_seen = snap["total_failures"]
    drill.check("trip and probe", {"verify": (trips + 1, faults_seen)})
    hb0 = _counter("tendermint_verify_table_cache_total", event="host_build")
    fail.set_device_fault("tables", 1)
    c = call("tables_cpu_build", sets["small"], k=FAULT_SMALL_K)
    fail.clear_device_faults()
    if _counter("tendermint_verify_table_cache_total", event="host_build") != hb0 + 1:
        raise AssertionError("stack faults: the small set's tables were not built on the CPU")
    _launched(c, ("madd_chain_fused", "finish_encode_compare"), "faults CPU-built tables")
    fail.set_device_fault("tables", 1)
    c = call("tables_host_crypto", sets["large"], host=True)
    fail.clear_device_faults()
    if sum(c[x] for x in VERIFY_KERNELS):
        raise AssertionError("stack faults: a verify kernel launched without tables")
    if faulty.primary._build_breaker.snapshot()["total_failures"] != 2:
        raise AssertionError("stack faults: the table-build breaker did not count both faults")
    drill.check("table builds")  # the build degradations are the primary's own answers
    # the black box holds the breaker's transitions, in order
    moves = [(e["frm"], e["to"]) for e in FLIGHT.recent(kind="breaker") if e["t"] >= t_wall]
    if moves != [(CLOSED, OPEN), (OPEN, "half_open"), ("half_open", CLOSED)]:
        raise AssertionError(f"stack faults: the flight recorder holds the breaker transitions {moves}")
    drill_rep.update(trip_calls=trips, breaker=faulty.snapshot(),
                     table_breaker=faulty.primary._build_breaker.snapshot(),
                     host_s=host_s[0], phase_s=time.perf_counter() - t_phase, breaker_clock="moved by the step",
                     flight_breaker=moves)
    rep["faults"] = drill_rep
    log({"phase": "stack", "step": "faults", **{k: v for k, v in drill_rep.items() if k != "calls"}})
    rep["faults"]["ledger"] = led.close()

    # 5. the hash plane through the resilient hasher
    txs, want_root, chunks = hashed
    led = StepLedger("stack", "hash")
    reset_counts()
    t0 = time.perf_counter()
    root = led.call(lambda: hasher.root_from_items(txs))
    sync()
    healthy_s = time.perf_counter() - t0
    c_ok = counts()
    if root != want_root:
        raise AssertionError("stack hash: the resilient hasher's root differs from the host tree's")
    _launched(c_ok, ("sha256_masked", "merkle_level"), "data_hash")
    health.check("data_hash")
    f0 = hasher.breaker.snapshot()["total_failures"]
    fail.set_device_fault("hash", 1)
    reset_counts()
    root = led.call(lambda: hasher.root_from_items(txs))
    c_fault = counts()
    fail.clear_device_faults()
    if root != want_root or hasher.breaker.snapshot()["total_failures"] != f0 + 1:
        raise AssertionError("stack hash: the faulted data_hash's root or failure count is wrong")
    # the one in-call retry answers on the card
    _launched(c_fault, ("sha256_masked", "merkle_level"), "faulted data_hash")
    health.check("faulted data_hash", {"hash": (0, 1)})
    reset_counts()
    t0 = time.perf_counter()
    leaves = led.call(lambda: hasher.leaf_hashes_async(chunks).result())
    leaves_s = time.perf_counter() - t0
    c_leaves = counts()
    if leaves != [hashlib.sha256(b"\x00" + ch).digest() for ch in chunks]:
        raise AssertionError("stack hash: leaf_hashes_async differs from hashlib")
    if host.simple_hash_from_hashes(leaves) != hasher.root_from_hashes(leaves):
        raise AssertionError("stack hash: the chunk root differs from the host tree's")
    _launched(c_leaves, ("sha256_masked",), "leaf_hashes_async")
    health.check("leaf_hashes_async")
    rep["hash"] = {"txs": len(txs), "data_hash_s": healthy_s, "launches": c_ok, "faulted_launches": c_fault,
                   "breaker": hasher.snapshot(), "chunks": len(chunks), "leaf_hashes_async_s": leaves_s}
    log({"phase": "stack", "step": "hash", **rep["hash"]})
    rep["hash"]["ledger"] = led.close()
    # the registry's failure counters moved by exactly the injected faults
    injected = {"verify": faults_seen, "hash": 1}
    moved = {k: int(_counter(failures, kind=k) - failures0[k]) for k in injected}
    if moved != injected:
        raise AssertionError(f"stack: dispatch failures {moved}, injected {injected}")
    rep["dispatch_failures"] = moved
    return rep


# -- phase 8: the port's own domain types through the stack ------------------

# the chain id is 17 characters, as MSG_LEN assumes; a precommit's
# timestamp is TYPES_TIME_NS plus its validator index
TYPES_CHAIN = "chip-smoke-chain1"
TYPES_HEIGHT = 123456
TYPES_TIME_NS = 1_760_000_000_000_000_000
TYPES_POWER = 10


class TableCacheKept:
    """Leaves the table backend's cache as a phase found it: the types
    phase's validator sets (the same keys in address order) must not
    evict the sets that the later phases time."""

    def __init__(self, backend):
        self.backend = backend

    def __enter__(self):
        with self.backend._cache_lock:
            self.saved = list(self.backend._tables.items())
        return self

    def __exit__(self, *exc):
        with self.backend._cache_lock:
            self.backend._tables.clear()
            self.backend._tables.update(self.saved)


def types_valset(inp: Inputs, n: int):
    """The port's `ValidatorSet` over keys 0..n-1, each of power
    TYPES_POWER, and each validator's key index in the set's (address)
    order."""
    from tendermint_tpu_torch.crypto import PubKey
    from tendermint_tpu_torch.types import Validator, ValidatorSet

    vs = ValidatorSet([Validator(PubKey(pk).address, PubKey(pk), TYPES_POWER) for pk in inp.pubs[:n]])
    index = {pk: i for i, pk in enumerate(inp.pubs[:n])}
    return vs, [index[v.pub_key.data] for v in vs.validators]


def types_commit(inp: Inputs, vs, keys: list[int], height: int, tag: int):
    """(block id, commit): a precommit of every validator of `vs` for one
    block, each signed over the port's `Vote.sign_bytes`."""
    import hashlib

    from tendermint_tpu_torch.types import VOTE_TYPE_PRECOMMIT, BlockID, Commit, PartSetHeader, Vote

    digest = hashlib.sha256(b"%d/%d" % (height, tag)).digest()
    bid = BlockID(digest, PartSetHeader(total=1 + tag % 7, hash=digest[:20]))
    votes = [Vote(val.address, idx, height, 0, TYPES_TIME_NS + idx, VOTE_TYPE_PRECOMMIT, bid)
             for idx, val in enumerate(vs.validators)]
    sigs = inp.sign_many([(inp.seeds[key], v.sign_bytes(TYPES_CHAIN)) for v, key in zip(votes, keys)])
    return bid, Commit(block_id=bid, precommits=[v.with_signature(sig) for v, sig in zip(votes, sigs)])


def forged_at(commit, idx: int):
    """The commit with validator `idx`'s precommit signature forged."""
    from tendermint_tpu_torch.types import Commit

    pre = list(commit.precommits)
    pre[idx] = pre[idx].with_signature(forge(pre[idx].signature))
    return Commit(block_id=commit.block_id, precommits=pre)


def types_outcome(fn) -> str | None:
    """None, or the message of the `ValidationError` that `fn` raised
    (anything else raises on)."""
    from tendermint_tpu_torch.types import ValidationError

    try:
        fn()
    except ValidationError as e:
        return str(e)
    return None


def run_types(stack, inp, sync, sizes, hashed, reps: int) -> dict:
    """Phase 8: the port's own domain types (`tendermint_tpu_torch.types`)
    on the stack a node calls, `default_verifier()` and `default_hasher()`:
    the consensus commit through `ValidatorSet.verify_commit` (`reps`
    calls at first sight, each on an empty signature cache, and `reps`
    from the stack's cache), the fast-sync window through
    `verify_commit_batched_async`, the light client's first contact
    through `verify_commit_any`, and a block's `make_block` /
    `validate_basic`; each with a forged input that must raise its
    `ValidationError`. `sizes` = (commit validators, window validators,
    window commits, first-contact validators); `hashed` = the hash
    phase's txs and their host root. The keys are phases 2-4's; only the
    precommits are signed here. Each step's launches are zeroed just
    before it and read just after, and stand on this phase's line only."""
    from tendermint_tpu_torch.services.batcher import CoalescingVerifier
    from tendermint_tpu_torch.services.hasher import default_hasher
    from tendermint_tpu_torch.types import Block, Txs, ValidatorSet

    n, ns, k, nf = sizes
    txs, want_root = hashed
    hasher = default_hasher()
    health = StackHealth(stack.inner, hasher)
    backend = stack.inner.primary
    rep: dict = {}

    def expect(what: str, got, want) -> None:
        if got != want:
            raise AssertionError(f"types {what}: {got!r}, expected {want!r}")

    def fresh_call(fn):
        """`fn(verifier)` on a coalescer of its own (an empty signature
        cache) over the stack's resilient layer and tables."""
        v = CoalescingVerifier(stack.inner)
        try:
            return fn(v)
        finally:
            v.coalescer.close()

    def lanes_s(vs, entries) -> list:
        """The host plane's lane collection alone: each precommit's sign
        bytes and the validator-aligned lanes."""
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            collected = [vs._collect_commit_sigs(TYPES_CHAIN, bid, h, c) for bid, h, c in entries]
            vs._commit_lanes(collected, len(vs))
            out.append(time.perf_counter() - t0)
        return out

    with TableCacheKept(backend):
        # 1. the consensus commit
        t0 = time.perf_counter()
        vs, keys = types_valset(inp, n)
        bid, commit = types_commit(inp, vs, keys, TYPES_HEIGHT, 0)
        sign_s = time.perf_counter() - t0
        tables_s = timed(lambda: backend.tables_for(tuple(v.pub_key.data for v in vs.validators)), sync)
        collect = lanes_s(vs, [(bid, TYPES_HEIGHT, commit)])
        runs: dict = {"cold": [], "cached": []}

        def commit_call(v, kind):
            reset_counts()
            out = []
            runs[kind].append(timed(lambda: out.append(types_outcome(lambda: vs.verify_commit(
                TYPES_CHAIN, bid, TYPES_HEIGHT, commit, verifier=v, consumer="consensus"))), sync))
            expect(f"commit ({kind})", out[0], None)
            c = counts()
            if kind == "cold":
                _launched(c, ("madd_chain_entries", "finish_encode_compare"), "commit", phase="types")
            return c

        c_commit = commit_call(stack, "cold")
        for _ in range(reps - 1):
            fresh_call(lambda v: commit_call(v, "cold"))
        for _ in range(reps):
            commit_call(stack, "cached")
        bad = n // 7
        reset_counts()
        got = fresh_call(lambda v: types_outcome(lambda: vs.verify_commit(
            TYPES_CHAIN, bid, TYPES_HEIGHT, forged_at(commit, bad), verifier=v)))
        c_forged = counts()
        expect("forged commit", got, f"invalid commit signature from validator {bad}")
        _launched(c_forged, ("madd_chain_entries", "finish_encode_compare"), "forged commit", phase="types")
        health.check("types commit")
        rep["commit"] = {
            "validators": n, "sign_s": sign_s, "tables_s": tables_s,
            "cold_s_median": statistics.median(runs["cold"]), "cached_s_median": statistics.median(runs["cached"]),
            "lane_collection_s_median": statistics.median(collect),
            "cold_s": runs["cold"], "cached_s": runs["cached"], "lane_collection_s": collect,
            "forged": got, "launches": c_commit, "forged_launches": c_forged,
        }

        # 2. the fast-sync window: k commits of one set of ns validators
        t0 = time.perf_counter()
        vs_w, keys_w = types_valset(inp, ns)
        entries = []
        for e in range(k):
            bid_e, c_e = types_commit(inp, vs_w, keys_w, TYPES_HEIGHT + 1 + e, 1 + e)
            entries.append((bid_e, TYPES_HEIGHT + 1 + e, c_e))
        sign_w = time.perf_counter() - t0
        tables_w = timed(lambda: backend.tables_for(tuple(v.pub_key.data for v in vs_w.validators)), sync)
        collect_w = lanes_s(vs_w, entries)
        window_s, c_window = [], None

        def window_call(v):
            out = []
            window_s.append(timed(lambda: out.append(types_outcome(lambda: vs_w.verify_commit_batched_async(
                TYPES_CHAIN, entries, verifier=v, consumer="fastsync").result())), sync))
            return out[0]

        for _ in range(reps):
            reset_counts()
            expect("window", fresh_call(window_call), None)
            c_window = counts()
            _launched(c_window, ("madd_chain_fused", "finish_encode_compare"), "window", phase="types")
        e_bad, lane_bad = k // 3, ns // 5
        forged_entries = list(entries)
        bid_e, h_e, c_e = entries[e_bad]
        forged_entries[e_bad] = (bid_e, h_e, forged_at(c_e, lane_bad))
        reset_counts()
        got = fresh_call(lambda v: types_outcome(lambda: vs_w.verify_commit_batched_async(
            TYPES_CHAIN, forged_entries, verifier=v, consumer="fastsync").result()))
        c_wforged = counts()
        expect("forged window", got, f"invalid commit signature from validator {lane_bad} "
                                     f"(batch entry {e_bad}, height {h_e})")
        _launched(c_wforged, ("madd_chain_fused", "finish_encode_compare"), "forged window", phase="types")
        health.check("types window")
        med_w = statistics.median(window_s)
        rep["window"] = {
            "validators": ns, "window": k, "sign_s": sign_w, "tables_s": tables_w,
            "s_median": med_w, "commits_per_s": k / med_w, "lane_collection_s_median": statistics.median(collect_w),
            "s": window_s, "lane_collection_s": collect_w, "forged": got,
            "launches": c_window, "forged_launches": c_wforged,
        }

        # 3. the light client's first contact: the trusted set checks a
        # commit of a set with the same validators, as one flat batch
        t0 = time.perf_counter()
        vs_l, keys_l = types_valset(inp, nf)
        new_set = ValidatorSet(list(vs_l.validators))
        bid_l, commit_l = types_commit(inp, vs_l, keys_l, TYPES_HEIGHT + 100, 99)
        sign_l = time.perf_counter() - t0
        light_s, c_light = [], None

        def light_call(v):
            out = []
            light_s.append(timed(lambda: out.append(types_outcome(lambda: vs_l.verify_commit_any(
                new_set, TYPES_CHAIN, bid_l, TYPES_HEIGHT + 100, commit_l, verifier=v, consumer="light"))), sync))
            return out[0]

        for _ in range(reps):
            reset_counts()
            expect("first contact", fresh_call(light_call), None)
            c_light = counts()
            _launched(c_light, ("ladder", "finish_encode_compare"), "first contact", phase="types")
        reset_counts()
        got = fresh_call(lambda v: types_outcome(lambda: vs_l.verify_commit_any(
            new_set, TYPES_CHAIN, bid_l, TYPES_HEIGHT + 100, forged_at(commit_l, nf // 2), verifier=v,
            consumer="light")))
        c_lforged = counts()
        expect("forged first contact", got, "invalid commit signature (old set)")
        _launched(c_lforged, ("ladder", "finish_encode_compare"), "forged first contact", phase="types")
        health.check("types first contact")
        med_l = statistics.median(light_s)
        rep["light"] = {
            "validators": nf, "sign_s": sign_l, "s_median": med_l, "verifies_per_s": nf / med_l, "s": light_s,
            "forged": got, "launches": c_light, "forged_launches": c_lforged,
        }

        # 4. a block of the hash phase's txs on the last height's commit:
        # data_hash on the card twice, in make_block and in validate_basic
        levels = (len(txs) - 1).bit_length()
        per_hash = {"sha256_masked": 1, "merkle_level": levels}
        make_s, validate_s = [], []
        block = None
        for _ in range(reps):
            reset_counts()
            out = []
            make_s.append(timed(lambda: out.append(Block.make_block(
                height=TYPES_HEIGHT + 1, chain_id=TYPES_CHAIN, txs=Txs(txs), last_commit=commit, last_block_id=bid,
                time=TYPES_TIME_NS + n, validators_hash=vs.hash(), app_hash=b"\x01" * 32, hasher=hasher)), sync))
            block = out[0]
            expect("make_block launches", {name: counts()[name] for name in per_hash}, per_hash)
            expect("make_block data_hash", block.header.data_hash, want_root)
            reset_counts()
            validate_s.append(timed(lambda: block.validate_basic(hasher=hasher), sync))
            expect("validate_basic launches", {name: counts()[name] for name in per_hash}, per_hash)
        # the last commit's hash stays on the host (10k vote encodings and
        # their tree): timed alone, as make_block and validate_basic pay it
        commit_hash_s = []
        for _ in range(reps):
            t0 = time.perf_counter()
            expect("last commit hash", commit.hash(), block.header.last_commit_hash)
            commit_hash_s.append(time.perf_counter() - t0)
        block.data.txs[0] = bytes(len(txs[0]))
        got = types_outcome(lambda: block.validate_basic(hasher=hasher))
        expect("tampered block", got, "data_hash mismatch")
        block.data.txs[0] = txs[0]
        health.check("types block")
        rep["block"] = {
            "txs": len(txs), "make_block_s_median": statistics.median(make_s),
            "validate_basic_s_median": statistics.median(validate_s),
            "last_commit_hash_s_median": statistics.median(commit_hash_s), "make_block_s": make_s,
            "validate_basic_s": validate_s, "last_commit_hash_s": commit_hash_s, "data_hash": block.header.data_hash.hex(), "block_hash": block.hash().hex(),
            "tampered": got, "launches_per_call": per_hash,
        }
    log({"phase": "types", **rep})
    return rep


# -- phase 9: block execution and the light client on the port's own code ---

STATE_CHAIN = "chip-smoke-chain2"
REPLAY_CHAIN = "chip-smoke-replay"
STATE_TXS = 65536  # height 3: PERF.md's data_hash cell, each tx with its own key
STATE_SMALL_TXS = 256  # every other height
STATE_HEIGHTS = 5
STATE_CHANGE = 10  # height 2 swaps 1 in STATE_CHANGE validators (10% of the power)
REPLAY_HEIGHTS = 17  # 16 FullCommits after the first height, one certify_batch


def smoke_chain(inp, keys, app, verifier, hasher, chain_id, signed=None, db=None):
    """`tendermint_tpu_torch.testing.ChainSim` over the smoke's keys: the
    genesis set is `keys` of `inp` at power TYPES_POWER, and each commit's
    precommits are signed directly with the validators' seeds (`seeds`,
    by address), with no check of each vote as it is added: the chain's
    own verify of the commit is what the phase measures. Chains given one
    `signed` dict share their commits by block id (signing is
    deterministic, so a block two chains both made is signed once). The
    state lives in `db` (a `MemDB` by default)."""
    from tendermint_tpu_torch.crypto import PubKey
    from tendermint_tpu_torch.db.kv import MemDB
    from tendermint_tpu_torch.testing import ChainSim
    from tendermint_tpu_torch.types import (
        VOTE_TYPE_PRECOMMIT, BlockID, Commit, GenesisDoc, GenesisValidator, Vote,
    )

    class SmokeChain(ChainSim):
        def _commit_for(self, block, part_set):
            bid = BlockID(block.hash(), part_set.header)
            if signed is not None and bid in signed:
                return signed[bid]
            h = block.header.height
            votes = [Vote(val.address, idx, h, 0, TYPES_TIME_NS + idx, VOTE_TYPE_PRECOMMIT, bid)
                     for idx, val in enumerate(self.state.validators.validators)]
            sigs = inp.sign_many([(self.seeds[v.validator_address], v.sign_bytes(self.chain_id)) for v in votes])
            commit = Commit(block_id=bid, precommits=[v.with_signature(sig) for v, sig in zip(votes, sigs)])
            if signed is not None:
                signed[bid] = commit
            return commit

    gen = GenesisDoc(chain_id=chain_id, genesis_time=TYPES_TIME_NS,
                     validators=[GenesisValidator(pub_key=PubKey(inp.pubs[k]), power=TYPES_POWER) for k in keys])
    chain = SmokeChain(app=app, db=db if db is not None else MemDB(), chain_id=chain_id, hasher=hasher,
                       verifier=verifier, genesis=(gen, []))
    chain.seeds = {PubKey(inp.pubs[k]).address: inp.seeds[k] for k in keys}
    return chain


class Splits:
    """Seconds and calls of each step of `apply_block`, by timing
    wrappers around the functions it calls (module globals and class
    attributes of the port), put in place while the context is open."""

    def __init__(self):
        from tendermint_tpu_torch.abci.client import AppConnConsensus
        from tendermint_tpu_torch.state import execution, state
        from tendermint_tpu_torch.state.txindex import KVTxIndexer
        from tendermint_tpu_torch.types import Block, ValidatorSet

        self.targets = {
            "validate_block": (execution, "validate_block"),
            "verify_commit": (ValidatorSet, "verify_commit"),
            "validate_basic": (Block, "validate_basic"),
            "exec": (execution, "exec_block_on_proxy_app"),
            "save_responses": (state.State, "save_abci_responses"),
            "tx_index": (KVTxIndexer, "add_batch"),
            "set_validators": (state.State, "set_block_and_validators"),
            "app_commit": (AppConnConsensus, "commit_sync"),
            "state_save": (state.State, "save"),
        }
        self.reset()

    def reset(self) -> None:
        self.s = dict.fromkeys(self.targets, 0.0)
        self.calls = dict.fromkeys(self.targets, 0)

    def __enter__(self):
        self.saved = {}
        for name, (owner, attr) in self.targets.items():
            orig = owner.__dict__[attr]
            self.saved[name] = orig

            def timed_call(*a, _orig=orig, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _orig(*a, **kw)
                finally:
                    self.s[_name] += time.perf_counter() - t0
                    self.calls[_name] += 1

            setattr(owner, attr, timed_call)
        return self

    def __exit__(self, *exc):
        for name, (owner, attr) in self.targets.items():
            setattr(owner, attr, self.saved[name])


class PrebuildClock:
    """When each table prebuild of the backend ran: (start, end, keys)."""

    def __init__(self, backend):
        self.backend = backend
        self.runs: list = []

    def __enter__(self):
        orig = self.backend._prebuild

        def clocked(key, pubs):
            t0 = time.perf_counter()
            try:
                orig(key, pubs)
            finally:
                self.runs.append((t0, time.perf_counter(), len(pubs)))

        self.backend._prebuild = clocked
        return self

    def wait(self, timeout: float = 120.0) -> None:
        with self.backend._cache_lock:
            threads = list(self.backend._prebuilds.values())
        for t in threads:
            t.join(timeout=timeout)
            if t.is_alive():
                raise AssertionError("state: a table prebuild did not end")

    def __exit__(self, *exc):
        self.wait()
        del self.backend._prebuild


def state_txs(rng, height: int, leaving, joining) -> list[bytes]:
    """Height 2: the `leaving` keys' removals (power 0) and the `joining`
    keys at TYPES_POWER; height 3: STATE_TXS key=value txs of TX_BYTES with
    distinct keys; else STATE_SMALL_TXS small ones."""
    if height == 2:
        return ([b"val:%s/0" % pk.hex().encode() for pk in leaving]
                + [b"val:%s/%d" % (pk.hex().encode(), TYPES_POWER) for pk in joining])
    count, size = (STATE_TXS, TX_BYTES) if height == 3 else (STATE_SMALL_TXS, 40)
    body = rng.integers(0, 256, size=(count, size - 10), dtype=np.uint8)
    return [b"h%d-%06d=" % (height, i) + bytes(row) for i, row in enumerate(body)]


def kv_app_hash(txs_by_height) -> bytes:
    """The KV app's hash recomputed with hashlib from the txs applied:
    the last value of each key, a SHA-256 chained over the sorted keys."""
    import hashlib

    data = {}
    for txs in txs_by_height:
        for tx in txs:
            if tx.startswith(b"val:"):
                continue
            k, v = tx.split(b"=", 1) if b"=" in tx else (tx, tx)
            data[k] = v
    acc = b""
    for k in sorted(data):
        acc = hashlib.sha256(acc + k + b"\x00" + data[k] + b"\x01").digest()
    return acc


def run_state(stack, inp, sync, sizes, reps: int) -> tuple[dict, dict]:
    """Phase 9: block execution and the light client on the port's own
    `db`, `abci`, `state` and `certifiers`, through `default_verifier()`
    and `default_hasher()`. A chain of `n` validators (phase 2's keys,
    equal power) applies heights 1-STATE_HEIGHTS through `apply_block`
    with `PersistentKVStoreApp` on a `MemDB` and a `KVTxIndexer`; height
    2 swaps one validator in STATE_CHANGE for a new key, height 3 carries
    STATE_TXS txs. Each height's seconds are split by `Splits`; the new
    set's table prebuild is clocked beside height 4, whose commit is the
    first the new set signs. Then a forged last commit and a wrong app
    hash, which must raise before the app runs; a light client
    (`DynamicCertifier`, then an `InquiringCertifier` over a `MemProvider`
    into a `FullCommitStore` on SQLite) follows the chain across the
    change; and `StaticCertifier.certify_batch` replays the 16 FullCommits
    of a chain of `ns` validators (phase 3's keys) in one call, `reps`
    times. Returns the `state` and `certifiers` reports."""
    import tempfile

    from tendermint_tpu_torch.abci.apps import KVStoreApp, PersistentKVStoreApp
    from tendermint_tpu_torch.certifiers import DynamicCertifier, FullCommit, InquiringCertifier, MemProvider
    from tendermint_tpu_torch.certifiers import StaticCertifier
    from tendermint_tpu_torch.crypto import PubKey
    from tendermint_tpu_torch.db.fullcommit import FullCommitStore
    from tendermint_tpu_torch.db.kv import MemDB, SQLiteDB
    from tendermint_tpu_torch.merkle import simple as host
    from tendermint_tpu_torch.services.batcher import CoalescingVerifier
    from tendermint_tpu_torch.services.hasher import default_hasher
    from tendermint_tpu_torch.state import apply_block, load_state
    from tendermint_tpu_torch.state.txindex import KVTxIndexer
    from tendermint_tpu_torch.types import Commit, Validator, ValidatorSet
    from tendermint_tpu_torch.types.tx import tx_hash

    n, ns, k = sizes
    hasher = default_hasher()
    health = StackHealth(stack.inner, hasher)
    backend = stack.inner.primary
    rng = np.random.default_rng(inp.seed + 9)
    srep: dict = {"validators": n}
    crep: dict = {}

    def expect(what: str, got, want) -> None:
        if got != want:
            raise AssertionError(f"state {what}: {got!r}, expected {want!r}")

    def fresh(fn):
        """`fn(verifier)` on a coalescer of its own (an empty signature
        cache) over the stack's resilient layer and tables."""
        v = CoalescingVerifier(stack.inner)
        try:
            return fn(v)
        finally:
            v.coalescer.close()

    with TableCacheKept(backend), PrebuildClock(backend) as clock:
        # 1. the chain: heights 1..STATE_HEIGHTS across a set change
        t0 = time.perf_counter()
        n_swap = n // STATE_CHANGE
        joining_seeds = [rng.bytes(32) for _ in range(n_swap)]
        joining = [inp.ref.public_from_seed(s) for s in joining_seeds]
        leaving = inp.pubs[n - n_swap:n]
        app = PersistentKVStoreApp(MemDB())
        chain = smoke_chain(inp, range(n), app, stack, hasher, STATE_CHAIN)
        chain.seeds.update({PubKey(pk).address: s for pk, s in zip(joining, joining_seeds)})
        index = KVTxIndexer(MemDB())
        srep["setup_s"] = time.perf_counter() - t0
        heights, applied = [], []
        with Splits() as splits:
            for h in range(1, STATE_HEIGHTS + 1):
                txs = state_txs(rng, h, leaving, joining)
                row: dict = {"height": h, "txs": len(txs)}
                t0 = time.perf_counter()
                block, ps = chain.make_next_block(txs)
                row["make_block_s"] = time.perf_counter() - t0
                commit = None
                if h < STATE_HEIGHTS:  # the last height's commit is never verified
                    t0 = time.perf_counter()
                    commit = chain._commit_for(block, ps)
                    row["sign_s"] = time.perf_counter() - t0
                if h == STATE_HEIGHTS:
                    srep["forged"] = state_forged(chain, block, ps, fresh, splits, expect)
                    health.check("state forged inputs")
                if h == 4:
                    row["prebuild_running_at_start"] = bool(backend._prebuilds)
                    hits = _counter("tendermint_verify_table_cache_total", event="hit")
                splits.reset()
                reset_counts()
                t_start = time.perf_counter()
                row["apply_s"] = timed(lambda: apply_block(
                    chain.state, block, ps.header, chain.conns.consensus, verifier=stack, tx_indexer=index,
                    hasher=hasher), sync)
                c = counts()
                row["split_s"], row["launches"] = dict(splits.s), c
                if h >= 2:
                    _launched(c, ("madd_chain_entries", "finish_encode_compare"), f"height {h}", phase="state")
                if h == 3:
                    levels = (STATE_TXS - 1).bit_length()
                    expect("height 3 data_hash launches", (c["sha256_masked"], c["merkle_level"]), (1, levels))
                    expect("height 3 data_hash", block.header.data_hash, host.simple_hash_from_byte_slices(txs))
                if h == 4:
                    row["start_s"] = t_start
                    row["tables_from_cache"] = _counter("tendermint_verify_table_cache_total", event="hit") > hits
                if h == 2:
                    row["changed"] = chain.state.last_height_validators_changed
                chain.blocks.append(block)
                if commit is not None:
                    chain.commits.append(commit)
                applied.append(txs)
                expect(f"height {h}", chain.state.last_block_height, h)
                heights.append(row)
                health.check(f"state height {h}")
        # the outcome, against a plain reference
        expect("stored state", load_state(chain.db).to_json(), chain.state.to_json())
        expect("app hash", chain.state.app_hash, kv_app_hash(applied))
        expect("app height", app.info().last_block_height, STATE_HEIGHTS)
        want_set = [PubKey(pk) for pk in inp.pubs[:n - n_swap] + joining]
        want_hash = ValidatorSet([Validator(pk.address, pk, TYPES_POWER) for pk in want_set]).hash()
        expect("validators after the change", chain.state.validators.hash(), want_hash)
        expect("validators changed at", chain.state.last_height_validators_changed, 3)
        for h in (1, 2):
            expect(f"validators of height {h}", chain.state.load_validators(h).hash(), chain.blocks[0].header.validators_hash)
        for h in (3, 4, 5):
            expect(f"validators of height {h}", chain.state.load_validators(h).hash(), want_hash)
        sample = applied[2][STATE_TXS // 3]
        got = index.get(tx_hash(sample))
        expect("tx index", (got.height, got.index, got.tx), (3, STATE_TXS // 3, sample))
        key, value = sample.split(b"=", 1)
        expect("app query", app.query("/key", key).value, value)
        # the prebuild of the new set's tables, beside height 4
        clock.wait()
        if len(clock.runs) != 1:
            raise AssertionError(f"state: {len(clock.runs)} table prebuilds, expected 1")
        p_start, p_end, p_keys = clock.runs[0]
        h4 = heights[3]
        # the same build again with nothing else running: the new set's
        # tables dropped, rebuilt from the old set's (a gather and the new
        # keys' build)
        new_set = tuple(v.pub_key.data for v in chain.state.validators)
        with backend._cache_lock:
            backend._tables.pop(backend._cache_key(new_set), None)
        srep["prebuild"] = {
            "keys": p_keys, "s": p_end - p_start, "alone_s": timed(lambda: backend.tables_for(new_set), sync),
            "height4_started_s_after": h4.pop("start_s") - p_start,
            "height4_waited": h4["prebuild_running_at_start"] or not h4["tables_from_cache"],
        }
        srep["heights"] = heights

        # 2. the light client on that chain, with a signature cache of its own
        fcs = {h: FullCommit(chain.blocks[h - 1].header, chain.commits[h - 1], chain.state.load_validators(h))
               for h in range(1, STATE_HEIGHTS)}
        light = CoalescingVerifier(stack.inner)
        try:
            dyn = DynamicCertifier(STATE_CHAIN, fcs[1].validators, height=1, verifier=light)
            reset_counts()
            crep["certify_s"] = timed(lambda: dyn.certify(fcs[2]), sync)
            crep["certify_launches"] = c = counts()
            _launched(c, ("madd_chain_entries", "finish_encode_compare"), "certify", phase="certifiers")
            reset_counts()
            crep["update_s"] = timed(lambda: dyn.update(fcs[3]), sync)
            crep["update_launches"] = c = counts()
            _launched(c, ("ladder", "finish_encode_compare"), "update", phase="certifiers")
            expect("dynamic certifier height", dyn.last_height, 3)
            crep["update_lanes"] = sum(1 for v in fcs[3].validators.validators if fcs[1].validators.has_address(v.address))
        finally:
            light.coalescer.close()
        source = MemProvider()
        for fc in fcs.values():
            source.store_commit(fc)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trusted.db")
            store = FullCommitStore(SQLiteDB(path))
            walks = _hist("tendermint_lightclient_walk_seconds", mode="sequential")[1]
            reset_counts()

            def walk(v):
                inq = InquiringCertifier(STATE_CHAIN, fcs[1], store, source, verifier=v)
                inq.certify(fcs[STATE_HEIGHTS - 1])
                return inq

            crep["inquiring_s"] = timed(lambda: fresh(walk), sync)
            crep["inquiring_launches"] = c = counts()
            _launched(c, ("ladder", "finish_encode_compare"), "inquiring walk", phase="certifiers")
            expect("walks timed", _hist("tendermint_lightclient_walk_seconds", mode="sequential")[1], walks + 1)
            store._db.close()
            again = FullCommitStore(SQLiteDB(path))
            expect("trusted heights", again.heights(), [1, STATE_HEIGHTS - 1])
            expect("trusted commit", again.get_exact(STATE_HEIGHTS - 1).encode(), fcs[STATE_HEIGHTS - 1].encode())
            again._db.close()
        health.check("certifiers light client")

        # 3. light-client replay: certify_batch of a chain's 16 FullCommits
        t0 = time.perf_counter()
        chain2 = smoke_chain(inp, range(ns), KVStoreApp(), stack, hasher, REPLAY_CHAIN)
        replay_apply = []
        for h in range(1, REPLAY_HEIGHTS + 1):
            replay_apply.append(timed(lambda: chain2.advance(txs=[b"r%d=%d" % (h, h)]), sync))
        crep["replay_chain_s"] = time.perf_counter() - t0
        crep["replay_advance_s_median"] = statistics.median(replay_apply)
        batch = [FullCommit(chain2.blocks[h - 1].header, chain2.commits[h - 1], chain2.state.load_validators(h))
                 for h in range(2, REPLAY_HEIGHTS + 1)]
        static_set = batch[0].validators
        replay_s = []
        for _ in range(reps):
            reset_counts()
            replay_s.append(timed(lambda: fresh(lambda v: StaticCertifier(
                REPLAY_CHAIN, static_set, verifier=v).certify_batch(batch)), sync))
            c = counts()
            _launched(c, ("madd_chain_fused", "finish_encode_compare"), "replay", phase="certifiers")
        crep["replay_launches"] = c
        e_bad, lane_bad = 5, ns // 5
        forged_batch = list(batch)
        fc = batch[e_bad]
        pre = list(fc.commit.precommits)
        pre[lane_bad] = pre[lane_bad].with_signature(forge(pre[lane_bad].signature))
        forged_batch[e_bad] = FullCommit(fc.header, Commit(block_id=fc.commit.block_id, precommits=pre), fc.validators)
        got = fresh(lambda v: types_outcome(lambda: StaticCertifier(
            REPLAY_CHAIN, static_set, verifier=v).certify_batch(forged_batch)))
        expect("forged batch", got, f"invalid commit signature from validator {lane_bad} "
                                    f"(batch entry {e_bad}, height {fc.height()})")
        crep["replay_forged"] = got
        med = statistics.median(replay_s)
        crep["replay"] = {"validators": ns, "commits": len(batch), "s_median": med, "s": replay_s,
                          "commits_per_s": len(batch) / med}
        health.check("certifiers replay")
    log({"phase": "state", **srep})
    log({"phase": "certifiers", **crep})
    return srep, crep


def state_forged(chain, block, ps, fresh, splits, expect) -> dict:
    """The forged inputs at the chain's next height, each on a coalescer
    of its own: a last commit with one forged precommit, then a block
    with a wrong app hash. Both must raise before the app runs and leave
    the state as it was."""
    from tendermint_tpu_torch.state import apply_block
    from tendermint_tpu_torch.types import Commit

    out: dict = {}
    before = chain.state.to_json()
    idx = len(chain.commits[-1].precommits) // 7
    saved = chain.commits[-1]
    pre = list(saved.precommits)
    pre[idx] = pre[idx].with_signature(forge(pre[idx].signature))
    chain.commits[-1] = Commit(block_id=saved.block_id, precommits=pre)
    forged_block, forged_ps = chain.make_next_block([bytes(tx) for tx in block.data.txs])
    chain.commits[-1] = saved
    wrong = chain.make_next_block([bytes(tx) for tx in block.data.txs])[0]
    wrong.header.app_hash = b"\x01" * 32
    cases = (
        ("last_commit", forged_block, forged_ps, f"invalid commit signature from validator {idx}"),
        ("app_hash", wrong, ps, f"wrong app_hash: got {'01' * 32}, want {chain.state.app_hash.hex()}"),
    )
    for name, b, p, want in cases:
        splits.reset()
        reset_counts()
        got = fresh(lambda v: types_outcome(lambda: apply_block(
            chain.state, b, p.header, chain.conns.consensus, verifier=v, hasher=chain.hasher)))
        c = counts()
        expect(f"forged {name}", got, want)
        expect(f"forged {name}: the app ran", splits.calls["exec"] + splits.calls["app_commit"], 0)
        expect(f"forged {name}: state", chain.state.to_json(), before)
        if name == "last_commit":
            _launched(c, ("madd_chain_entries", "finish_encode_compare"), "forged last commit", phase="state")
        out[name] = {"raised": got, "launches": c}
    return out


# -- phase 7: the mesh ---------------------------------------------------------

SYNC_CHAIN = "chip-smoke-sync"
SYNC_HEIGHTS = 49  # a syncing node applies 48: three windows of VERIFY_WINDOW
SYNC_TXS = 256  # a block's txs, TX_BYTES each (tm-bench's default size)
SYNC_FORGED_HEIGHTS = 33  # two windows of 16
SYNC_FORGED_AT = 20  # the height whose commit carries the forged precommit
SYNC_FORGED_LANE = 137
SYNC_TIMEOUT_S = 300.0  # dial to caught up
NODE_LINK_CAP = 512_000  # bytes/s, the node's send_rate / recv_rate default
LINK_FRAMES = 24  # frames of a block's size timed over each link
LINK_SEED_KEYS = (b"\x5a" * 32, b"\xa5" * 32)


def sync_txs(rng, height: int) -> list[bytes]:
    """SYNC_TXS key=value txs of TX_BYTES bytes, each with its own key."""
    body = rng.integers(0, 256, size=(SYNC_TXS, TX_BYTES - 11), dtype=np.uint8)
    return [b"s%02d-%06d=" % (height, i) + bytes(row) for i, row in enumerate(body)]


def link_rates(frame_bytes: int, frames: int, rng) -> dict:
    """MB/s of `frames` frames of `frame_bytes` from one end of a
    localhost TCP link to the other, read as they arrive: over the plain
    `TcpEndpoint` and through a `SecretEndpoint` (the port's pure-Python
    X25519, HKDF and ChaCha20-Poly1305) on each end, both ends in this
    process under one interpreter lock; the secret handshake's seconds;
    and the cipher alone on one thread, sealing and opening the frames."""
    import socket
    import threading

    from tendermint_tpu_torch.crypto import PrivKey
    from tendermint_tpu_torch.crypto.chacha20poly1305 import ChaCha20Poly1305
    from tendermint_tpu_torch.p2p.secret import SecretEndpoint
    from tendermint_tpu_torch.p2p.tcp import TcpEndpoint

    payloads = [rng.bytes(frame_bytes) for _ in range(frames)]
    out: dict = {"frame_bytes": frame_bytes, "frames": frames}
    aead = ChaCha20Poly1305(rng.bytes(32))
    nonces = [i.to_bytes(12, "big") for i in range(frames)]
    t0 = time.perf_counter()
    sealed = [aead.encrypt(n, p, None) for n, p in zip(nonces, payloads)]
    out["seal_mb_s"] = frames * frame_bytes / (time.perf_counter() - t0) / 1e6
    t0 = time.perf_counter()
    opened = [aead.decrypt(n, c, None) for n, c in zip(nonces, sealed)]
    out["open_mb_s"] = frames * frame_bytes / (time.perf_counter() - t0) / 1e6
    if opened != payloads:
        raise AssertionError("sync link: the cipher did not open what it sealed")
    for name in ("plain", "secret"):
        srv = socket.create_server(("127.0.0.1", 0))
        got: dict = {}

        def accept():
            sock, _ = srv.accept()
            ep = TcpEndpoint(sock)
            got["ep"] = SecretEndpoint(ep, PrivKey(LINK_SEED_KEYS[1])) if name == "secret" else ep

        t = threading.Thread(target=accept, daemon=True)
        t.start()
        t0 = time.perf_counter()
        cli = TcpEndpoint(socket.create_connection(srv.getsockname()))
        if name == "secret":
            cli = SecretEndpoint(cli, PrivKey(LINK_SEED_KEYS[0]))
        t.join(timeout=30)
        if name == "secret":
            out["handshake_s"] = time.perf_counter() - t0
        rx = got["ep"]
        sender = threading.Thread(target=lambda: [cli.send(p, 60.0) for p in payloads], daemon=True)
        t0 = time.perf_counter()
        sender.start()
        for p in payloads:
            if rx.recv(timeout=60.0) != p:
                raise AssertionError(f"sync link {name}: a frame arrived changed")
        elapsed = time.perf_counter() - t0
        sender.join(timeout=30)
        out[f"{name}_mb_s"] = frames * frame_bytes / elapsed / 1e6
        cli.close()
        rx.close()
        srv.close()
    return out


class SyncWindows:
    """Each window a fast-sync reactor submits (its commits, from
    `_prep_window`), each window's verdict at its join (None, or the
    `ValidationError`'s message) and the seconds of its join and applies,
    and each redo height, by wrappers put on the reactor instance."""

    def __init__(self, reactor):
        self.sizes, self.verdicts, self.redone, self.join_s = [], [], [], []
        prep, join, redo = reactor._prep_window, reactor._join_and_apply, reactor._redo

        def prep_window(cursor):
            entry = prep(cursor)
            if isinstance(entry, dict):
                self.sizes.append(entry["apply_n"])
            return entry

        def join_and_apply(entry):
            t0 = time.perf_counter()
            self.verdicts.append((entry["start_height"], types_outcome(entry["handle"].result)))
            ok = join(entry)
            self.join_s.append(time.perf_counter() - t0)
            return ok

        def redo_at(height):
            self.redone.append(height)
            return redo(height)

        reactor._prep_window, reactor._join_and_apply, reactor._redo = prep_window, join_and_apply, redo_at

    def expect_launches(self, c: dict, what: str) -> None:
        """One finish a window, the fused chain for a window of
        FUSED_MIN_STACK commits or more, the entries chain below it."""
        from tendermint_tpu_torch.ops.ed25519_tables import FUSED_MIN_STACK

        fused = sum(1 for k in self.sizes if k >= FUSED_MIN_STACK)
        want = {"madd_chain_fused": fused, "madd_chain_entries": len(self.sizes) - fused,
                "finish_encode_compare": len(self.sizes), "ladder": 0}
        got = {name: c[name] for name in want}
        if got != want:
            raise AssertionError(f"sync {what}: launches {got} for windows of {self.sizes}, expected {want}")


def run_sync(stack, inp, sync, ns: int) -> dict:
    """Phase 10: a fresh node catches up over the port's own network onto
    the card. A chain of phase 3's `ns` keys (equal power, `KVStoreApp`,
    SYNC_TXS txs of TX_BYTES a block) is built on the card's stack to
    SYNC_HEIGHTS and saved into a `BlockStore`, which a `Switch` with
    `BlockchainReactor(fast_sync=False)` serves. A fresh node (the genesis
    state, an empty store, `KVStoreApp`, `BlockchainReactor(fast_sync=True)`
    at the default pipeline depth) dials it over localhost TCP: run a
    through a SecretConnection with node keys made from the seed, on
    `default_verifier()`, the app in process; run b over plain TCP with
    the app behind the port's ABCI socket, on a fresh coalescer over the
    same stack. Each run must end at the store height SYNC_HEIGHTS - 1
    with every block's hash, the state and the app hash equal to the
    chain's, and launch one finish a window. The links alone are timed
    (`link_rates`); then a chain with one forged precommit in height
    SYNC_FORGED_AT's commit is synced by a reactor with the chain in its
    pool: window 1 applies, window 2 launches, its verdict is false and
    it drains unapplied."""
    from tendermint_tpu_torch.abci.apps import KVStoreApp
    from tendermint_tpu_torch.abci.client import local_client_creator
    from tendermint_tpu_torch.abci.socket import ABCISocketServer, socket_client_creator
    from tendermint_tpu_torch.crypto import PrivKey
    from tendermint_tpu_torch.p2p import tcp
    from tendermint_tpu_torch.services.batcher import CoalescingVerifier
    from tendermint_tpu_torch.services.hasher import default_hasher
    from tendermint_tpu_torch.testing import (
        SyncingNode, chain_store, forge_newest_precommit, preloaded_reactor, serving_switch,
    )

    hasher = default_hasher()
    health = StackHealth(stack.inner, hasher)
    backend = stack.inner.primary
    rng = np.random.default_rng(inp.seed + 10)
    rep: dict = {"validators": ns, "heights": SYNC_HEIGHTS, "txs": SYNC_TXS, "tx_bytes": TX_BYTES}
    lane = SYNC_FORGED_LANE % ns

    def expect(what: str, got, want) -> None:
        if got != want:
            raise AssertionError(f"sync {what}: {got!r}, expected {want!r}")

    with TableCacheKept(backend):
        # 1. the chain, and a fork of it with one forged precommit, each
        # commit verified on the card as the chain applies it
        t0 = time.perf_counter()
        chain_verifier = CoalescingVerifier(stack.inner)  # apart from the syncing nodes' caches
        signed: dict = {}
        try:
            chain = smoke_chain(inp, range(ns), KVStoreApp(), chain_verifier, hasher, SYNC_CHAIN, signed)
            forked = smoke_chain(inp, range(ns), KVStoreApp(), chain_verifier, hasher, SYNC_CHAIN, signed)
            for h in range(1, SYNC_HEIGHTS + 1):
                txs = sync_txs(rng, h)
                chain.advance(txs=txs)
                if h == SYNC_HEIGHTS - 1:
                    want_state = chain.state.to_json()
                if h <= SYNC_FORGED_HEIGHTS:
                    forked.advance(txs=txs, commit_preverified=h == SYNC_FORGED_AT + 1)
                    if h == SYNC_FORGED_AT:
                        forge_newest_precommit(forked, lane)
        finally:
            chain_verifier.coalescer.close()
        rep["chain_s"] = time.perf_counter() - t0
        store = chain_store(chain)
        block_bytes = [len(b.encode()) for b in chain.blocks]
        rep["block_bytes_median"] = statistics.median(block_bytes)
        health.check("sync chain")
        # the Python one block costs on each side of the link, median of 5
        from tendermint_tpu_torch.blockchain import reactor as bc

        mid = SYNC_HEIGHTS // 2
        wire = bc._enc(bc._MSG_BLOCK_RESPONSE, store.load_block(mid).encode())
        steps = {
            "load": lambda: store.load_block(mid),
            "encode": lambda: chain.blocks[mid - 1].encode(),
            "decode": lambda: bc.decode_message(wire),
            "part_set": lambda: chain.blocks[mid - 1].make_part_set(hasher=hasher),
        }
        rep["block_ms"] = {k: statistics.median(timed(fn, sync) for _ in range(5)) * 1e3 for k, fn in steps.items()}

        # 2. the links alone, at a block's size
        rep["link"] = link_rates(int(rep["block_bytes_median"]), LINK_FRAMES, rng)
        log({"phase": "sync_link", **rep["link"]})

        # 3. runs a and b
        def run_one(name: str, verifier, secret: bool, socket_app: bool) -> dict:
            keys = [PrivKey(rng.bytes(32)) for _ in range(2)]
            server = serving_switch(store, keys[0].pub_key.address.hex(), SYNC_CHAIN)
            lis = tcp.TcpListener(server, "tcp://127.0.0.1:0", priv_key=keys[0] if secret else None)
            abci = ABCISocketServer(KVStoreApp(), "tcp://127.0.0.1:0") if socket_app else None
            creator = socket_client_creator(f"127.0.0.1:{abci.port}") if socket_app else local_client_creator(
                KVStoreApp())
            conns = creator()
            node = SyncingNode(chain.genesis, keys[1].pub_key.address.hex(), conns.consensus, verifier,
                               hasher=hasher)
            windows = SyncWindows(node.reactor)
            overlap0 = _hist("tendermint_dispatch_overlap_ratio", queue="fastsync")
            try:
                reset_counts()
                t0 = time.perf_counter()
                peer = tcp.dial(node.switch, f"127.0.0.1:{lis.port}", priv_key=keys[1] if secret else None)
                dial_s = time.perf_counter() - t0
                if not node.caught_up.wait(timeout=SYNC_TIMEOUT_S):
                    raise AssertionError(f"sync run {name}: not caught up in {SYNC_TIMEOUT_S} s, "
                                         f"store at {node.store.height}")
                sync()
                c = counts()
                caught_s = node.caught_up_at - t0
                recv_bytes, sent_bytes = peer.recv_monitor.total, peer.send_monitor.total
            finally:
                node.stop()
                lis.stop()
                server.stop()
                if abci is not None:
                    for conn in (conns.consensus, conns.mempool, conns.query):
                        conn.close()
                    abci.stop()
            applied = SYNC_HEIGHTS - 1
            expect(f"run {name} store height", node.store.height, applied)
            for h in range(1, applied + 1):
                expect(f"run {name} block {h}", node.store.load_block(h).hash(), chain.blocks[h - 1].hash())
            expect(f"run {name} state", node.state.to_json(), want_state)
            expect(f"run {name} app hash", node.state.app_hash, chain.blocks[applied].header.app_hash)
            expect(f"run {name} verdicts", [v for _, v in windows.verdicts], [None] * len(windows.sizes))
            expect(f"run {name} redone", windows.redone, [])
            windows.expect_launches(c, f"run {name}")
            ov = _hist("tendermint_dispatch_overlap_ratio", queue="fastsync")
            row = {
                "link": "secret" if secret else "plain", "app": "socket" if socket_app else "in-process",
                "pipeline_depth": node.reactor.pipeline_depth, "dial_s": dial_s, "caught_up_s": caught_s,
                "blocks_per_s": applied / caught_s, "windows": len(windows.sizes), "window_sizes": windows.sizes,
                "fastsync_overlap_mean": (ov[0] - overlap0[0]) / max(ov[1] - overlap0[1], 1),
                "join_apply_ms_per_block": sum(windows.join_s) / applied * 1e3,
                "recv_bytes": recv_bytes, "sent_bytes": sent_bytes,
                "cap_blocks_per_s": NODE_LINK_CAP / (recv_bytes / applied), "launches": c,
            }
            health.check(f"sync run {name}")
            return row

        # verifier=None: the port's default_verifier(), this stack
        from tendermint_tpu_torch.services.verifier import default_verifier

        expect("default_verifier()", default_verifier() is stack, True)
        rep["a"] = run_one("a", None, secret=True, socket_app=False)
        log({"phase": "sync_run", "run": "a", **rep["a"]})
        fresh = CoalescingVerifier(stack.inner)
        try:
            rep["b"] = run_one("b", fresh, secret=False, socket_app=True)
        finally:
            fresh.coalescer.close()
        log({"phase": "sync_run", "run": "b", **rep["b"]})

        # 4. the forged step: the fork in a reactor's pool, on a fresh cache
        fresh = CoalescingVerifier(stack.inner)
        try:
            reactor, _state, fstore = preloaded_reactor(forked, local_client_creator(KVStoreApp())().consensus, fresh)
            windows = SyncWindows(reactor)
            reset_counts()
            forged_s = timed(reactor._try_sync, sync)
            c = counts()
            reactor.on_stop()
        finally:
            fresh.coalescer.close()
        bad = forked.state.validators.validators[lane]
        expect("forged windows", windows.sizes, [16, 16])
        expect("forged verdicts", windows.verdicts, [
            (1, None), (17, f"invalid commit signature from validator {lane}"
                           f" (batch entry {SYNC_FORGED_AT - 17}, height {SYNC_FORGED_AT})")])
        expect("forged redo", windows.redone, [17])
        expect("forged store height", fstore.height, 16)
        expect("forged block 17", fstore.load_block(17), None)
        windows.expect_launches(c, "forged step")
        rep["forged"] = {"s": forged_s, "windows": windows.sizes, "verdicts": windows.verdicts,
                         "validator": bad.address.hex(), "launches": c}
        health.check("sync forged")
    log({"phase": "sync", **{k: v for k, v in rep.items() if k not in ("a", "b")}})
    return rep


CONS_CHAIN = "chip-smoke-consensus"
CONS_HEIGHTS = 2
CONS_FORGED = 137  # set index of the validator whose height-1 prevote is forged
CONS_CONFLICT = 271  # set index of the validator that precommits twice at height 1
CONS_TXS = 256  # txs of each block the smoke proposes, and in the node's own mempool
FLOOD_KEYS = 4096  # phase 4's keys: one signed envelope each
FLOOD_PLAIN = 256
FLOOD_THREADS = 4
# the probe's ingress window (the default is 2 ms): long enough that the
# flood's windows close at the ingress's 1,024 txs, not on the clock
FLOOD_WINDOW_S = 0.5
FLOOD_TIMEOUT_S = 300.0
NET_CHAIN = "chip-smoke-net"
NET_VALIDATORS = 4
NET_HEIGHTS = 10  # heights a run
NET_RUNS = (("default", None), ("min_batch_0", 0))  # each run's minimum device batch (None: the stack's)
NET_TXS = 512
NET_EVIDENCE_WITHIN = 5  # heights from the evidence's admission to its commit on every node
NET_TIMEOUT_S = 240.0


def flood_txs(inp, rng, keys: int) -> tuple[list[bytes], int]:
    """`keys` signed envelopes, one a key of phase 4's, one forged
    envelope and FLOOD_PLAIN plain txs, mixed in a seeded order; returns
    (txs, position of the forged envelope)."""
    from tendermint_tpu_torch.crypto import PrivKey
    from tendermint_tpu_torch.mempool import make_signed_tx

    body = rng.integers(0, 256, size=(keys + 1, 16), dtype=np.uint8)
    txs = [make_signed_tx(PrivKey(inp.seeds[k]), b"flood-%05d=" % k + bytes(body[k]).hex().encode())
           for k in range(keys)]
    forged = bytearray(make_signed_tx(PrivKey(inp.seeds[0]), b"forged=" + bytes(body[keys]).hex().encode()))
    forged[40] ^= 0x01  # a bit of the signature
    txs.append(bytes(forged))
    txs += [b"plain-%04d=%d" % (i, i) for i in range(FLOOD_PLAIN)]
    order = rng.permutation(len(txs))
    txs = [txs[i] for i in order]
    return txs, int(np.argwhere(order == keys)[0][0])


def admit_all(mp, txs, threads: int, timeout: float) -> tuple[list, float]:
    """`txs` into `mp` through `check_tx_async` (the RPC broadcast's
    path) from `threads` threads, thread t sending txs t, t + threads, ...
    in order; returns each tx's `Result` and the seconds until the last
    one resolved."""
    import threading

    results: list = [None] * len(txs)
    done = threading.Semaphore(0)

    def resolve(i, res):
        results[i] = res
        done.release()

    def submit(t):
        for i in range(t, len(txs), threads):
            mp.check_tx_async(txs[i], cb=lambda res, i=i: resolve(i, res))  # a duplicate calls back at once

    t0 = time.perf_counter()
    workers = [threading.Thread(target=submit, args=(t,)) for t in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    for _ in txs:
        if not done.acquire(timeout=timeout):
            raise AssertionError(f"mempool: {sum(r is None for r in results)} admissions never resolved")
    return results, time.perf_counter() - t0


def run_consensus_mempool(stack, inp, sync, keys: int) -> dict:
    """Phase 11, step 1: the mempool flood as an RPC broadcast feeds it.
    A port `Mempool` (signed txs on, batched ingress) on `KVStoreApp` with
    `verifier=` a coalescer over the stack's resilient backend (an empty
    signature cache each pass) takes `keys` signed envelopes, one forged
    envelope and FLOOD_PLAIN plain txs from FLOOD_THREADS threads through
    `check_tx_async`, once at the default ingress window (BASELINE
    config 4) and once at FLOOD_WINDOW_S (a probe of the ingress-to-`ladder`
    path). Every `Result` must equal a host mempool's (`verifier=None`:
    the host's `PubKey.verify` a signature), the forged one
    `UNAUTHORIZED`; every envelope of a window of the minimum batch or
    more must be a row of a flat call the card answered, and the probe
    must reach `ladder`; `reap` returns each thread's admitted txs in its
    order, and `update` with them empties the pool."""
    from tendermint_tpu_torch.abci.apps import KVStoreApp
    from tendermint_tpu_torch.abci.client import local_client_creator
    from tendermint_tpu_torch.abci.types import CodeType
    from tendermint_tpu_torch.mempool import Mempool
    from tendermint_tpu_torch.services.batcher import CoalescingVerifier
    from tendermint_tpu_torch.testing import device_flat_rows

    backend = stack.inner.primary
    health = StackHealth(stack.inner)
    rng = np.random.default_rng(inp.seed + 11)
    t0 = time.perf_counter()
    txs, forged_at = flood_txs(inp, rng, keys)
    rep: dict = {"envelopes": keys, "plain": FLOOD_PLAIN, "txs": len(txs), "threads": FLOOD_THREADS,
                 "sign_s": time.perf_counter() - t0, "passes": []}

    def flood(window_s):
        # each pass on an empty signature cache over the stack's backend
        verifier = CoalescingVerifier(stack.inner)
        mp = Mempool(local_client_creator(KVStoreApp())().mempool, verifier=verifier, ingress_window_s=window_s)
        windows: list[int] = []  # txs a window
        lanes: list[int] = []  # signed envelopes a window
        launch = mp._ingress._launch

        def counted(batch, reason):
            windows.append(len(batch))
            lanes.append(sum(1 for adm in batch if adm.parsed is not None))
            return launch(batch, reason)

        mp._ingress._launch = counted
        try:
            led = StepLedger("consensus_mempool", f"at window {mp._ingress._window_s} s")
            results, admit_s = admit_all(mp, txs, FLOOD_THREADS, FLOOD_TIMEOUT_S)
            sync()
            c = led.settle()
            backend_calls = device_flat_rows(led.records(), lanes, backend._min_batch, f"consensus_mempool {led.step}")
            reaped = [bytes(t) for t in mp.reap(-1)]
            size_before = mp.size()
            mp.lock()
            try:
                mp.update(1, mp.reap(-1))
            finally:
                mp.unlock()
            size_after = mp.size()
        finally:
            mp.close()
            verifier.coalescer.close()
        admitted = [tx for tx, res in zip(txs, results) if res.is_ok]
        if len(admitted) != len(txs) - 1 or sorted(reaped) != sorted(admitted) or size_before != len(admitted):
            raise AssertionError(f"consensus_mempool: {len(admitted)} admitted, {len(reaped)} reaped, "
                                 f"size {size_before}, of {len(txs)} txs")
        at = {tx: i for i, tx in enumerate(reaped)}
        for t in range(FLOOD_THREADS):
            mine = [at[tx] for tx, res in zip(txs[t::FLOOD_THREADS], results[t::FLOOD_THREADS]) if res.is_ok]
            if mine != sorted(mine):
                raise AssertionError(f"consensus_mempool: thread {t}'s txs reaped out of their arrival order")
        if size_after != 0:
            raise AssertionError(f"consensus_mempool: {size_after} txs left after update")
        health.check("consensus_mempool")
        row = {"window_s": mp._ingress._window_s, "admit_s": admit_s, "admission_txs_per_s": len(txs) / admit_s,
               "windows": len(windows), "window_max": max(windows),
               "windows_of_min_batch_or_more": sum(1 for n in lanes if n >= backend._min_batch), "backend": backend_calls,
               "launches": c}
        log({"phase": "consensus_mempool_pass", **row})
        return results, row

    # the default window first: its small windows verify on the host, whose
    # memo would answer a later pass's host verifies at once
    passes = [flood(None), flood(FLOOD_WINDOW_S)]
    host = Mempool(local_client_creator(KVStoreApp())().mempool, verifier=None)
    try:
        t0 = time.perf_counter()
        want, _ = admit_all(host, txs, 1, FLOOD_TIMEOUT_S)
        rep["host_s"] = time.perf_counter() - t0
    finally:
        host.close()

    def outcome(res):
        return (res.code, res.data, res.log)

    for results, row in passes:
        diff = [i for i, (a, b) in enumerate(zip(results, want)) if outcome(a) != outcome(b)]
        if diff:
            raise AssertionError(f"consensus_mempool: {len(diff)} results differ from the host's, first at tx "
                                 f"{diff[0]}: {outcome(results[diff[0]])} against {outcome(want[diff[0]])}")
        if results[forged_at].code != CodeType.UNAUTHORIZED:
            raise AssertionError(f"consensus_mempool: the forged envelope came back {results[forged_at]!r}")
        rep["passes"].append(row)
    if passes[1][1]["launches"]["ladder"] == 0:
        raise AssertionError("consensus_mempool: no ingress window reached the ladder")
    rep["forged_code"] = int(CodeType.UNAUTHORIZED)
    log({"phase": "consensus_mempool", **{k: v for k, v in rep.items() if k != "passes"}})
    return rep


def run_consensus_storm(stack, inp, sync, n: int, heights: int = CONS_HEIGHTS) -> dict:
    """Phase 11, step 2: BASELINE config 5 at full width. A port
    `ConsensusState` is validator 0 of `n` keys of phase 2's at equal
    power (`testing.StormValidator`: `verifier=` and `hasher=` the stack's,
    the port's `Mempool`, `EvidencePool`, `BlockStore(MemDB())`,
    `KVStoreApp`, a WAL in a temporary directory, `test_config()`). The
    smoke plays the other validators for `heights` heights: the
    proposer's proposal where the node does not propose, then each
    height's prevotes as one backlog and, once the node has precommitted,
    the precommits as one backlog. At height 1 one prevote is forged (it
    must be the one vote refused) and one validator precommits twice (its
    `DuplicateVoteEvidence` must reach the pool). Every height must
    commit the proposed block, the app hash must equal `kv_app_hash` of
    the committed txs, every flat call of the minimum batch or more must
    launch one `ladder`, and height 2's last commit (which carries the
    node's own precommit, a lane the signature cache has never seen)
    launches the entries chain and the finish in `validate_block`."""
    import shutil
    import tempfile

    import tendermint_tpu_torch.state as state_mod
    from tendermint_tpu_torch.crypto import PubKey
    from tendermint_tpu_torch.services.hasher import default_hasher
    from tendermint_tpu_torch.testing import StormValidator, device_flat_rows
    from tendermint_tpu_torch.types import (
        VOTE_TYPE_PRECOMMIT, VOTE_TYPE_PREVOTE, BlockID, GenesisDoc, GenesisValidator, PartSetHeader,
    )
    from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence

    hasher = default_hasher()
    backend = stack.inner.primary
    health = StackHealth(stack.inner, hasher)
    gen = GenesisDoc(chain_id=CONS_CHAIN, genesis_time=TYPES_TIME_NS,
                     validators=[GenesisValidator(pub_key=PubKey(inp.pubs[k]), power=TYPES_POWER) for k in range(n)])
    seeds = {PubKey(inp.pubs[k]).address: inp.seeds[k] for k in range(n)}
    node = PubKey(inp.pubs[0]).address
    wal_dir = tempfile.mkdtemp(prefix="chip-smoke-wal-")
    rep: dict = {"validators": n, "heights": []}
    entries_in_validate: list = []
    real_validate = state_mod.validate_block

    def validate(state, block, *a, **kw):
        before = counts()["madd_chain_entries"]
        try:
            return real_validate(state, block, *a, **kw)
        finally:
            entries_in_validate.append((block.header.height, counts()["madd_chain_entries"] - before))

    wal0 = _hist("tendermint_wal_fsync_seconds")
    with TableCacheKept(backend):
        sv = StormValidator(gen, seeds, node, inp.sign_many, stack, hasher, wal_path=os.path.join(wal_dir, "cs.wal"))
        order = [v.address for v in sv.cs.validators.validators]
        node_idx = order.index(node)
        forged_idx, conflict_idx = (i if i != node_idx else i + 1 for i in (CONS_FORGED % n, CONS_CONFLICT % n))
        for i in range(CONS_TXS):
            sv.mempool.check_tx_async(b"node-%04d=%d" % (i, i))
        state_mod.validate_block = validate
        led = StepLedger("consensus", "storm")
        sv.cs.start()
        try:
            hvs1 = None
            for h in range(1, heights + 1):
                smoke_txs = [b"h%d-%04d=%d" % (h, i, i) for i in range(CONS_TXS)]
                bid, block, prop, parts = sv.propose(h, smoke_txs)
                if h == 1:
                    hvs1 = sv.cs.votes
                t0 = time.perf_counter()
                ts = time.time_ns()
                prevotes = sv.votes(h, VOTE_TYPE_PREVOTE, bid, ts)
                precommits = sv.votes(h, VOTE_TYPE_PRECOMMIT, bid, ts)
                if h == 1:
                    pos = {v.validator_index: i for i, v in enumerate(prevotes)}
                    bad = prevotes[pos[forged_idx]]
                    prevotes[pos[forged_idx]] = bad.with_signature(forge(bad.signature))
                    twice = sv.votes(h, VOTE_TYPE_PRECOMMIT, BlockID(b"", PartSetHeader.zero()), ts + 1)
                    precommits.insert(pos[conflict_idx] + 1, twice[pos[conflict_idx]])
                sign_s = time.perf_counter() - t0
                drains0 = len(sv.drains)
                t_play = sv.play(prop, parts, prevotes, precommits)
                t_commit, committed = sv.wait_commit(h)
                rec = None
                deadline = time.time() + 10
                while rec is None and time.time() < deadline:
                    rec = next((r for r in sv.cs.height_ledger.recent() if r.get("height") == h), None)
                    time.sleep(0 if rec is not None else 0.01)
                if committed.hash() != bid.hash:
                    raise AssertionError(f"consensus_storm: height {h} committed {committed.hash().hex()}, "
                                         f"proposed {bid.hash.hex()}")
                rep["heights"].append({
                    "height": h, "proposer": "node" if prop is None else "smoke", "sign_s": sign_s,
                    "proposal_to_commit_s": t_commit - t_play,
                    "phases_s": {k: p["s"] for k, p in (rec or {}).get("phases", {}).items()},
                    "critical_path": (rec or {}).get("critical_path"), "drains": sv.drains[drains0:],
                    "drain_lanes": sv.drain_lanes[drains0:],
                })
                log({"phase": "consensus_storm_height", **rep["heights"][-1]})
        finally:
            state_mod.validate_block = real_validate
            sv.cs.stop()
            sv.mempool.close()
            sv.evidence.close()
    shutil.rmtree(wal_dir, ignore_errors=True)
    sync()
    c = led.settle()
    rep["backend"] = device_flat_rows(led.records(), sv.drain_lanes, backend._min_batch, "consensus_storm")
    blocks = [sv.store.load_block(h) for h in range(1, heights + 1)]
    want_app = kv_app_hash([[bytes(tx) for tx in b.data.txs] for b in blocks])
    if sv.cs.state.last_block_height != heights or sv.cs.state.app_hash != want_app:
        raise AssertionError(f"consensus_storm: state at {sv.cs.state.last_block_height}, app hash "
                             f"{sv.cs.state.app_hash.hex()}, expected {want_app.hex()}")
    pv1 = hvs1.prevotes(0)
    missing = [i for i in range(n) if pv1.get_by_index(i) is None]
    if missing != [forged_idx]:
        raise AssertionError(f"consensus_storm: height 1's prevotes lack {missing[:8]}, expected [{forged_idx}]")
    evs = [e for e in sv.evidence.pending_evidence() + [e for b in blocks for e in b.evidence.evidence]
           if isinstance(e, DuplicateVoteEvidence)]
    if [e.vote_a.validator_address for e in evs] != [order[conflict_idx]]:
        raise AssertionError(f"consensus_storm: duplicate-vote evidence {evs!r}, expected one of validator "
                             f"{conflict_idx}")
    if c["madd_chain_entries"] != 1 or sum(e for hh, e in entries_in_validate if hh == 2) != 1:
        raise AssertionError(f"consensus_storm: entries chain launches {c['madd_chain_entries']}, in validate_block "
                             f"{entries_in_validate}; height 2's last commit must launch it once there")
    if c["ladder"] == 0:
        raise AssertionError("consensus_storm: no vote drain reached the ladder")
    health.check("consensus_storm")
    wal = _hist("tendermint_wal_fsync_seconds")
    rep.update({
        "node_index": node_idx, "forged_index": forged_idx, "conflict_index": conflict_idx,
        "evidence_pending": len(sv.evidence.pending_evidence()), "app_hash": want_app.hex(),
        "entries_in_validate": entries_in_validate, "wal_records": wal[1] - wal0[1],
        "wal_fsync_s": wal[0] - wal0[0], "launches": c,
    })
    log({"phase": "consensus_storm", **{k: v for k, v in rep.items() if k != "heights"}})
    return rep


def run_consensus_net(stack, inp, sync) -> dict:
    """Phase 11, step 3: BASELINE config 1. NET_VALIDATORS port
    validators (`testing.NetValidator`: consensus, mempool and evidence
    reactors on a `Switch`, each its own `KVStoreApp`, `BlockStore` and a
    signature cache of its own over the stack's backend, as separate
    nodes would have) linked in process run NET_HEIGHTS heights at the
    default minimum device batch, then NET_HEIGHTS at minimum batch 0,
    where every vote and commit that reaches the backend launches.
    NET_TXS signed txs go in at node 1 and one `DuplicateVoteEvidence` at
    node 0's pool. Every tx must be committed once on every node, the
    evidence within NET_EVIDENCE_WITHIN heights on every node, and the
    stores must hold equal blocks, each node's app hash `kv_app_hash` of
    its txs; once the nodes stop, the launch ledger's records account
    for every launch of the step (`StepLedger.settle`)."""
    from collections import Counter

    from tendermint_tpu_torch.consensus.round_state import RoundStepType
    from tendermint_tpu_torch.crypto import PrivKey
    from tendermint_tpu_torch.mempool import make_signed_tx
    from tendermint_tpu_torch.services.batcher import CoalescingVerifier
    from tendermint_tpu_torch.services.hasher import default_hasher
    from tendermint_tpu_torch.testing import (
        NetValidator, byzantine_signed_vote, make_block_id, make_genesis, start_net,
    )
    from tendermint_tpu_torch.types import VOTE_TYPE_PREVOTE
    from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence

    hasher = default_hasher()
    backend = stack.inner.primary
    health = StackHealth(stack.inner, hasher)
    genesis, privs = make_genesis(NET_VALIDATORS, chain_id=NET_CHAIN)
    verifiers = [CoalescingVerifier(stack.inner) for _ in range(NET_VALIDATORS)]
    nodes = [NetValidator(i, genesis, privs, verifiers[i], hasher) for i in range(NET_VALIDATORS)]
    txs = [make_signed_tx(PrivKey(inp.seeds[k]), b"net-%04d=%d" % (k, k)) for k in range(NET_TXS)]
    rep: dict = {"validators": NET_VALIDATORS, "txs": NET_TXS, "runs": []}
    min_batch = backend._min_batch

    def wait_heights(top: int) -> None:
        deadline = time.time() + NET_TIMEOUT_S
        while min(nd.height for nd in nodes) < top:
            for nd in nodes:
                if nd.cs.fatal_error is not None:
                    raise AssertionError(f"consensus_net: node {nd.index} halted: {nd.cs.fatal_error!r}")
            if time.time() > deadline:
                at = [(rs.height, rs.round, RoundStepType.name(rs.step))
                      for rs in (nd.cs.get_round_state() for nd in nodes)]
                raise AssertionError(f"consensus_net: (height, round, step) {at}, waiting for height {top}")
            time.sleep(0.005)

    led = StepLedger("consensus", "net")
    try:
        start_net(nodes)
        ev_height = None
        for run, mb in NET_RUNS:
            mb = min_batch if mb is None else mb
            backend._min_batch = mb
            h0 = min(nd.height for nd in nodes)
            c0 = counts()
            t0 = time.perf_counter()
            if run == "default":
                admitted: list = []
                for tx in txs:
                    nodes[1].mempool.check_tx_async(tx, cb=admitted.append)
                h = nodes[0].height
                ev = DuplicateVoteEvidence.make(
                    byzantine_signed_vote(privs[3], 3, h, 0, VOTE_TYPE_PREVOTE, make_block_id(b"net-a"), NET_CHAIN),
                    byzantine_signed_vote(privs[3], 3, h, 0, VOTE_TYPE_PREVOTE, make_block_id(b"net-b"), NET_CHAIN),
                )
                if not nodes[0].evidence.add_evidence(ev):
                    raise AssertionError("consensus_net: node 0's pool refused the evidence")
                ev_height = h
            wait_heights(h0 + NET_HEIGHTS)
            secs = time.perf_counter() - t0
            deadline = time.time() + NET_TIMEOUT_S
            while run == "default" and len(admitted) < NET_TXS and time.time() < deadline:
                time.sleep(0.01)
            if run == "default" and [r.code for r in admitted] != [0] * NET_TXS:
                raise AssertionError(f"consensus_net: node 1 admitted {[r.code for r in admitted]}")
            c1 = counts()
            c = {k: c1[k] - c0[k] for k in c1}
            row = {"run": run, "min_device_batch": mb, "from_height": h0, "heights": NET_HEIGHTS, "s": secs,
                   "heights_per_s": NET_HEIGHTS / secs, "launches": c}
            backend._min_batch = min_batch
            if run == "min_batch_0" and (c["ladder"] == 0 or c["madd_chain_entries"] == 0):
                raise AssertionError(f"consensus_net: at minimum batch 0 the votes and commits launched {c}")
            rep["runs"].append(row)
            log({"phase": "consensus_net_run", **row})
    finally:
        backend._min_batch = min_batch
        for nd in nodes:
            nd.stop()
        for v in verifiers:
            v.coalescer.close()
    sync()
    rep["launches"] = led.settle()
    top = min(nd.store.height for nd in nodes)
    for h in range(1, top + 1):
        hashes = {nd.store.load_block(h).hash() for nd in nodes}
        if len(hashes) != 1:
            raise AssertionError(f"consensus_net: the stores differ at height {h}")
    for nd in nodes:
        mine = nd.block_txs(nd.store.height)
        seen = Counter(mine)
        if any(seen[tx] != 1 for tx in txs):
            raise AssertionError(f"consensus_net: node {nd.index} committed the txs {sorted(set(seen.values()))} "
                                 f"times, {sum(1 for tx in txs if seen[tx] == 0)} never")
        st = nd.cs.state
        want = kv_app_hash([[bytes(tx) for tx in nd.store.load_block(h).data.txs]
                            for h in range(1, st.last_block_height + 1)])
        if st.app_hash != want:
            raise AssertionError(f"consensus_net: node {nd.index}'s app hash differs from its txs' at "
                                 f"height {st.last_block_height}")
        at = [h for h in range(1, nd.store.height + 1)
              if any(e.hash() == ev.hash() for e in nd.store.load_block(h).evidence.evidence)]
        if len(at) != 1 or not ev_height <= at[0] <= ev_height + NET_EVIDENCE_WITHIN:
            raise AssertionError(f"consensus_net: node {nd.index} committed the evidence of height {ev_height} "
                                 f"at {at}")
        rep.setdefault("evidence_heights", []).append(at[0])
    health.check("consensus_net")
    rep.update({"top": top, "evidence_from": ev_height})
    log({"phase": "consensus_net", **{k: v for k, v in rep.items() if k != "runs"}})
    return rep


def run_consensus(stack, inp, sync, n: int) -> dict:
    """Phase 11: the mempool flood, the storm of `n` validators and the
    4-validator net on the port's own consensus, on the stack."""
    return {
        "mempool": run_consensus_mempool(stack, inp, sync, min(FLOOD_KEYS, len(inp.seeds))),
        "storm": run_consensus_storm(stack, inp, sync, n),
        "net": run_consensus_net(stack, inp, sync),
    }


READ_CHAIN = "chip-smoke-readpath"
READ_BIG_BLOCKS = 9  # blocks of TXS txs: the snapshot's payload passes READ_MIN_CHUNKS chunks
READ_MIN_CHUNKS = 8192  # the chunk gate's leaf count at which the hasher takes the card
# heights of READ_TAIL_TXS txs after the snapshot (the anchor and the
# tail); once 16, cut to 8 to keep the whole run within half its limit
READ_TAIL_HEIGHTS = 8
READ_TAIL_TXS = 256
READ_TRUST_HEIGHT = 4  # the fresh node's trust pin
READ_CORRUPT = (0, 1)  # chunks corrupted in server a's store: the pool asks a for one of them first
READ_INFLIGHT = 32  # chunk requests in flight a peer: the serving channel's send queue holds 32
READ_GIVEUP_S = 600.0
READ_TIMEOUT_S = 600.0  # dial to caught up
LC_CHAIN = "chip-smoke-light"
LC_VALIDATORS = 100
LC_HEIGHTS = 10000
LC_ROTATE = 10  # one validator replaced every LC_ROTATE heights
LC_HELD = 25  # the server holds height 1 and every LC_HELD-th height
LC_TIME_NS = 1_700_000_000_000_000_000
RPC_REPS = 5  # round trips timed a route, median


def read_txs(rng, height: int, n: int) -> list[bytes]:
    """`n` distinct txs of TX_BYTES random bytes with no b"=" in them, so
    `KVStoreApp` keeps each whole as both key and value (about 1 KB of
    its hex snapshot a tx)."""
    body = rng.integers(0, 256, size=(n, TX_BYTES - 9), dtype=np.uint8)
    body[body == ord("=")] = ord(">")
    return [b"r%02d%06d" % (height, i) + bytes(row) for i, row in enumerate(body)]


def merkle_levels(leaves: int) -> int:
    """`merkle_level` launches of one device tree over `leaves` leaves."""
    return (leaves - 1).bit_length()


class HashClock:
    """Times the calls a hasher's device backend makes while the `with`
    block runs: `leaf_hashes` and `root_from_hashes` of `hasher.primary`,
    each as (leaves, seconds, on the card); `roots` counts the card's
    root calls, whose launch records the ledger files under the hash
    family although they launch `merkle_level` alone."""

    def __init__(self, hasher):
        self.primary = hasher.primary
        self.leaves: list = []
        self.root_calls: list = []

    def _wrap(self, name, into):
        fn = getattr(self.primary, name)

        def timed_call(items):
            t0 = time.perf_counter()
            out = fn(items)
            into.append((len(items), time.perf_counter() - t0, self.primary._use_device(len(items))))
            return out

        setattr(self.primary, name, timed_call)

    def __enter__(self):
        self._wrap("leaf_hashes", self.leaves)
        self._wrap("root_from_hashes", self.root_calls)
        return self

    def __exit__(self, *exc):
        for name in ("leaf_hashes", "root_from_hashes"):
            self.primary.__dict__.pop(name, None)

    def roots(self) -> int:
        return sum(1 for _n, _s, dev in self.root_calls if dev)


def run_readpath_statesync(stack, inp, sync, ns: int) -> dict:
    """Phase 12, step 1: a fresh node state-syncs a snapshot of more than
    READ_MIN_CHUNKS chunks of 64 KiB over plain localhost TCP onto the
    card. A chain of phase 3's `ns` keys (equal power, `KVStoreApp`) is
    built on the stack: READ_BIG_BLOCKS blocks of TXS txs of TX_BYTES
    (the data_hash cell's block), the snapshot taken at that height
    through the serving `StateSyncReactor.maybe_take_snapshot` with
    `default_hasher()`, then READ_TAIL_HEIGHTS heights of READ_TAIL_TXS
    txs. Two serving switches (`testing.snapshot_server`: the state-sync
    reactor and `BlockchainReactor(fast_sync=False)` on the chain's
    store) hold the snapshot; server a's store has chunks READ_CORRUPT
    flipped by `corrupt_chunk`. A `testing.StateSyncingNode` (genesis
    state, empty store, `TrustAnchor` pinned to the chain's header hash
    at READ_TRUST_HEIGHT, `default_hasher()`, a fresh coalescer over the
    stack) dials both: the anchor's certify launches
    `madd_chain_entries`, the chunk that a serves first is corrupt and is
    blamed on arrival (host hash), a is dropped and b serves the rest,
    the gate hashes every chunk in one `sha256_masked` launch and folds
    the root with `merkle_level`, the restore must equal the server's
    state JSON and app hash at the snapshot height, and the fast-sync tail
    (one finish a window, fused or entries chain by size) must end with
    every block hash, the state JSON and the app hash equal to the
    server's. The launch ledger must account for every launch of the
    step (`StepLedger.settle`, the card's root calls held out)."""
    from tendermint_tpu_torch.abci.apps import KVStoreApp
    from tendermint_tpu_torch.blockchain.store import BlockStore
    from tendermint_tpu_torch.db.kv import MemDB
    from tendermint_tpu_torch.p2p import tcp
    from tendermint_tpu_torch.services.batcher import CoalescingVerifier
    from tendermint_tpu_torch.services.hasher import default_hasher
    from tendermint_tpu_torch.statesync import SnapshotStore, TrustOptions
    from tendermint_tpu_torch.statesync import reactor as ssr
    from tendermint_tpu_torch.testing import StateSyncingNode, snapshot_server

    hasher = default_hasher()
    health = StackHealth(stack.inner, hasher)
    rng = np.random.default_rng(inp.seed + 12)
    snap_h = READ_BIG_BLOCKS
    top = snap_h + READ_TAIL_HEIGHTS
    rep: dict = {"validators": ns, "big_blocks": READ_BIG_BLOCKS, "big_txs": TXS, "tail_heights": READ_TAIL_HEIGHTS,
                 "tail_txs": READ_TAIL_TXS, "tx_bytes": TX_BYTES, "inflight_per_peer": READ_INFLIGHT}

    def expect(what: str, got, want) -> None:
        if got != want:
            raise AssertionError(f"readpath_statesync {what}: {got!r}, expected {want!r}")

    def corrupt_chunks() -> float:
        return _counter("tendermint_statesync_chunks_total", result="corrupt")

    led = StepLedger("readpath", "statesync")
    clock = HashClock(hasher)
    with clock:
        # 1. the chain, served from its store as it grows; the snapshot at
        # snap_h through the serving reactor's cadence hook
        chain_verifier = CoalescingVerifier(stack.inner)
        store = BlockStore(MemDB())
        snaps = SnapshotStore(MemDB(), hasher=hasher, chunk_size=CHUNK_BYTES)
        t0 = time.perf_counter()
        try:
            chain = smoke_chain(inp, range(ns), KVStoreApp(), chain_verifier, hasher, READ_CHAIN)
            sw_a, ss_a = snapshot_server(store, chain.state, snaps, "readpath-a", READ_CHAIN, hasher=hasher,
                                         snapshot_interval=snap_h)
            app_snapshot = chain.app.snapshot_state

            def timed_app_snapshot():
                t1 = time.perf_counter()
                out = app_snapshot()
                rep["take_app_snapshot_s"] = time.perf_counter() - t1
                return out

            chain.app.snapshot_state = timed_app_snapshot
            for h in range(1, top + 1):
                txs = read_txs(rng, h, TXS if h <= snap_h else READ_TAIL_TXS)
                block = chain.advance(txs=txs)
                store.save_block(block, block.make_part_set(hasher=hasher), chain.commits[-1])
                if h == snap_h:
                    rep["chain_to_snapshot_s"] = time.perf_counter() - t0
                    want_snap_state, want_snap_app = chain.state.to_json(), chain.state.app_hash
                if h <= snap_h:
                    # the node's EVENT_NEW_BLOCK hook, wired until the snapshot lands
                    t1 = time.perf_counter()
                    leaves0 = len(clock.leaves)
                    manifest = ss_a.maybe_take_snapshot(chain.state, app=chain.app)
                    if manifest is not None:
                        rep["take_s"] = time.perf_counter() - t1
                        rep["take_leaf_s"] = sum(sec for _n, sec, _d in clock.leaves[leaves0:])
                if h == top - 1:
                    want_state = chain.state.to_json()
        finally:
            chain_verifier.coalescer.close()
        rep["chain_s"] = time.perf_counter() - t0
        expect("snapshots", [m.height for m in snaps.list_manifests()], [snap_h])
        manifest = snaps.get_manifest(snap_h)
        rep["chunks"] = manifest.chunks
        rep["payload_bytes"] = manifest.payload_len
        log({"phase": "readpath_snapshot", "height": snap_h, "chunks": manifest.chunks,
             "payload_bytes": manifest.payload_len, "take_s": rep["take_s"]})
        if manifest.chunks <= READ_MIN_CHUNKS:
            raise AssertionError(f"readpath_statesync: the snapshot has {manifest.chunks} chunks, not more than "
                                 f"{READ_MIN_CHUNKS}: the gate would not reach the card")
        take_leaves = [c for c in clock.leaves if c[0] == manifest.chunks]
        expect("take on the card", [dev for _n, _s, dev in take_leaves], [True])
        health.check("readpath chain")

        # 2. server b holds the same snapshot; a's copy of chunks READ_CORRUPT is flipped
        snaps_b = SnapshotStore(MemDB(), hasher=hasher, chunk_size=CHUNK_BYTES)
        snaps_b._db._data = dict(snaps._db._data)
        sw_b, ss_b = snapshot_server(store, chain.state, snaps_b, "readpath-b", READ_CHAIN, hasher=hasher)
        for i in READ_CORRUPT:
            expect(f"corrupt_chunk {i}", snaps.corrupt_chunk(snap_h, index=i), True)
        lis = [tcp.TcpListener(sw, "tcp://127.0.0.1:0") for sw in (sw_a, sw_b)]

        # 3. the fresh node
        fresh = CoalescingVerifier(stack.inner)
        trust = TrustOptions(height=READ_TRUST_HEIGHT, hash_=store.load_block(READ_TRUST_HEIGHT).hash())
        node = StateSyncingNode(chain.genesis, "readpath-fresh", fresh, hasher=hasher, trust=trust,
                                chunk_inflight_per_peer=READ_INFLIGHT, giveup_time_s=READ_GIVEUP_S)
        windows = SyncWindows(node.blockchain)
        arrivals: list = []
        on_chunk = node.statesync._on_chunk

        def chunk_arrived(peer, height, fmt, index, data):
            arrivals.append((time.perf_counter(), len(data)))
            return on_chunk(peer, height, fmt, index, data)

        node.statesync._on_chunk = chunk_arrived
        stages: dict = {}
        decode, restore = ssr.decode_payload, node.statesync._restore

        def timed_restore(m, decoded, anchor_fc):
            t1 = time.perf_counter()
            out = restore(m, decoded, anchor_fc)
            stages["restore_s"] = time.perf_counter() - t1
            stages["state"], stages["app_hash"] = out.to_json(), out.app_hash
            return out

        def clocked(name, fn):
            def call(*a):
                t1 = time.perf_counter()
                out = fn(*a)
                stages[name] = time.perf_counter() - t1
                return out
            return call

        # the restore's two largest parts: the app's restore and the tail's bootstrap
        node.statesync.app_restore_fn = clocked("app_restore_s", node.statesync.app_restore_fn)
        node.store.bootstrap = clocked("bootstrap_s", node.store.bootstrap)
        ssr.decode_payload, node.statesync._restore = clocked("decode_s", decode), timed_restore
        corrupt0 = corrupt_chunks()
        leaves0, roots0 = len(clock.leaves), len(clock.root_calls)
        try:
            c0 = counts()
            t0 = time.perf_counter()
            for li in lis:
                tcp.dial(node.switch, f"127.0.0.1:{li.port}")
            if not node.caught_up.wait(timeout=READ_TIMEOUT_S):
                raise AssertionError(f"readpath_statesync: not caught up in {READ_TIMEOUT_S} s, synced "
                                     f"{node.synced.is_set()}, store at {node.store.height}")
            sync()
            c1 = counts()
            c = {k: c1[k] - c0[k] for k in c1}
            peers_left = sorted(p.id for p in node.switch.peers())
        finally:
            ssr.decode_payload = decode
            node.stop()
            for li in lis:
                li.stop()
            sw_a.stop()
            sw_b.stop()
            fresh.coalescer.close()
        restored = node.statesync.restored_manifest
        expect("restored snapshot", (restored.height, restored.root), (snap_h, manifest.root))
        expect("corrupt chunks blamed", corrupt_chunks() - corrupt0, 1.0)
        expect("peers left", peers_left, ["readpath-b"])
        # the restore itself, before the tail moved the state on
        expect("restored state", stages.get("state"), want_snap_state)
        expect("restored app hash", stages.get("app_hash"), want_snap_app)
        applied = top - 1
        expect("store height", node.store.height, applied)
        for h in range(snap_h - 1, applied + 1):
            expect(f"block {h}", node.store.load_block(h).hash(), chain.blocks[h - 1].hash())
        expect("state", node.state.to_json(), want_state)
        expect("app hash", node.state.app_hash, chain.blocks[applied].header.app_hash)
        expect("verdicts", [v for _, v in windows.verdicts], [None] * len(windows.sizes))
        expect("redone", windows.redone, [])
        # launches from dial to caught up: the anchor's certify, the gate's
        # leaf pass and the two roots (the manifest's, the gate's), the tail
        from tendermint_tpu_torch.ops.ed25519_tables import FUSED_MIN_STACK

        # a window that holds the anchor's commit alone is answered by the
        # signature cache the anchor's certify filled, and launches nothing
        launched = [k for (start, _v), k in zip(windows.verdicts, windows.sizes)
                    if not (start == snap_h + 1 and k == 1)]
        fused = sum(1 for k in launched if k >= FUSED_MIN_STACK)
        want = {"madd_chain_entries": 1 + len(launched) - fused, "madd_chain_fused": fused, "ladder": 0,
                "finish_encode_compare": 1 + len(launched), "sha256_masked": 1,
                "merkle_level": 2 * merkle_levels(manifest.chunks), "ripemd160_masked": 0, "sha512_masked": 0}
        expect("launches from dial to caught up", {k: c[k] for k in want}, want)
        gate_leaves = clock.leaves[leaves0:]
        gate_roots = clock.root_calls[roots0:]
        expect("gate leaf pass", [(n, dev) for n, _s, dev in gate_leaves], [(manifest.chunks, True)])
        expect("roots", [(n, dev) for n, _s, dev in gate_roots], [(manifest.chunks, True)] * 2)
        launches = led.settle(roots=clock.roots())
        led.close()
        health.check("readpath statesync")
    t_first, t_last = arrivals[0][0], arrivals[-1][0]
    got_bytes = sum(n for _t, n in arrivals)
    rep.update({
        "dial_to_caught_up_s": node.caught_up_at - t0,
        "dial_to_synced_s": node.synced_at - t0,
        "transfer_s": t_last - t_first,
        "transfer_bytes": got_bytes,
        "transfer_mb_s": got_bytes / (t_last - t_first) / 1e6,
        "gate_leaf_ms": gate_leaves[0][1] * 1e3,
        "gate_root_ms": gate_roots[-1][1] * 1e3,
        "manifest_root_ms": gate_roots[0][1] * 1e3,
        "decode_s": stages.get("decode_s"),
        "restore_s": stages.get("restore_s"),
        "app_restore_s": stages.get("app_restore_s"),
        "bootstrap_s": stages.get("bootstrap_s"),
        "tail_blocks": applied - snap_h,
        "tail_s": node.caught_up_at - node.synced_at,
        "tail_blocks_per_s": (applied - snap_h) / (node.caught_up_at - node.synced_at),
        "tail_windows": windows.sizes,
        "launches": c,
        "step_launches": launches,
    })
    log({"phase": "readpath_statesync", **rep})
    return rep, {"chain": chain, "store": store, "hasher": hasher, "snap_h": snap_h, "top": top}


def light_chain(inp, n_vals: int, heights: int, rotate: int, held: int):
    """FullCommits of a light-client chain (BASELINE config 2's shape):
    the set at height h is keys r..r+n_vals-1 of `inp`, r = (h-1) //
    `rotate`, at power TYPES_POWER, so one validator leaves and one
    joins every `rotate` heights; a header at each held height (1 and
    every `held`-th) names its set, and its commit is signed by all of
    them (the signers' pool). Returns ({height: FullCommit}, seconds of
    signing)."""
    from tendermint_tpu_torch.certifiers.certifier import FullCommit
    from tendermint_tpu_torch.crypto import PubKey
    from tendermint_tpu_torch.types import VOTE_TYPE_PRECOMMIT, BlockID, Commit, Validator, ValidatorSet, Vote
    from tendermint_tpu_torch.types.block import Header
    from tendermint_tpu_torch.types.part_set import PartSetHeader

    seeds = {}
    plan = []
    for h in [1] + list(range(held, heights + 1, held)):
        r = (h - 1) // rotate
        vals = []
        for k in range(r, r + n_vals):
            pk = PubKey(inp.pubs[k])
            seeds[pk.address] = inp.seeds[k]
            vals.append(Validator(address=pk.address, pub_key=pk, voting_power=TYPES_POWER))
        vs = ValidatorSet(vals)
        header = Header(chain_id=LC_CHAIN, height=h, time=LC_TIME_NS + h * 1_000_000_000, num_txs=0,
                        last_block_id=BlockID.zero(), last_commit_hash=b"", data_hash=b"",
                        validators_hash=vs.hash(), app_hash=h.to_bytes(8, "big"))
        bid = BlockID(header.hash(), PartSetHeader(total=1, hash=header.hash()[:20]))
        votes = [Vote(v.address, i, h, 0, LC_TIME_NS + h * 1_000_000_000 + i, VOTE_TYPE_PRECOMMIT, bid)
                 for i, v in enumerate(vs.validators)]
        plan.append((header, vs, bid, votes))
    t0 = time.perf_counter()
    sigs = inp.sign_many([(seeds[v.validator_address], v.sign_bytes(LC_CHAIN))
                          for _h, _vs, _b, votes in plan for v in votes])
    sign_s = time.perf_counter() - t0
    fcs, at = {}, 0
    for header, vs, bid, votes in plan:
        pre = [v.with_signature(s) for v, s in zip(votes, sigs[at:at + len(votes)])]
        at += len(votes)
        fcs[header.height] = FullCommit(header=header, commit=Commit(block_id=bid, precommits=pre), validators=vs)
    return fcs, sign_s, seeds


def light_server(fcs: dict, node_id: str):
    """A started `Switch` whose `LightClientReactor` serves `fcs` from its
    certified cache (exact height, else the newest below: the provider
    floor contract) and a `TcpListener` for it. Returns (switch, reactor,
    listener)."""
    from tendermint_tpu_torch.lightclient import CertifiedCommitCache, LightClientReactor
    from tendermint_tpu_torch.p2p import NodeInfo, Switch, tcp

    cache = CertifiedCommitCache(capacity=len(fcs) + 1)
    for h in sorted(fcs):
        cache.put_certified(fcs[h])
    reactor = LightClientReactor(chain_id=LC_CHAIN, cache=cache)
    sw = Switch(NodeInfo(node_id=node_id, moniker="light-server", chain_id=LC_CHAIN))
    sw.add_reactor("lightclient", reactor)
    sw.start()
    return sw, reactor, tcp.TcpListener(sw, "tcp://127.0.0.1:0")


def light_client(node_id: str, listener, **reactor_kwargs):
    """A started `Switch` with a `LightClientReactor`, dialed to
    `listener` over localhost TCP. Returns (switch, reactor)."""
    from tendermint_tpu_torch.lightclient import CertifiedCommitCache, LightClientReactor
    from tendermint_tpu_torch.p2p import NodeInfo, Switch, tcp

    reactor_kwargs.setdefault("cache", CertifiedCommitCache())
    reactor = LightClientReactor(chain_id=LC_CHAIN, **reactor_kwargs)
    sw = Switch(NodeInfo(node_id=node_id, moniker="light-client", chain_id=LC_CHAIN))
    sw.add_reactor("lightclient", reactor)
    sw.start()
    tcp.dial(sw, f"127.0.0.1:{listener.port}")
    return sw, reactor


class WalkRounds:
    """Each verify call of a `BisectingCertifier`: its candidate heights,
    its lanes and, when it returned, its skip verdicts, by a wrapper on
    the instance."""

    def __init__(self, cert):
        self.calls: list = []
        verify = cert._verify_candidates

        def counted(fcs):
            call = {"heights": [fc.height() for fc in fcs], "verdicts": None, "lanes": sum(
                1 for fc in fcs for p in fc.commit.precommits
                if p is not None and p.block_id == fc.commit.block_id)}
            self.calls.append(call)
            call["verdicts"] = verify(fcs)
            return call["verdicts"]

        cert._verify_candidates = counted

    def lanes(self) -> list[int]:
        return [c["lanes"] for c in self.calls]

    def adopted(self, i: int) -> list[int]:
        """The heights round `i` certified."""
        c = self.calls[i]
        return [h for h, ok in zip(c["heights"], c["verdicts"]) if ok]


def run_readpath_lightclient(stack, inp, sync) -> dict:
    """Phase 12, step 2 (BASELINE config 2): a light client replays
    LC_HEIGHTS sequential heights at LC_VALIDATORS validators. The sets
    rotate one validator every LC_ROTATE heights (phase 2's keys), so the
    old set's overlap falls below 1/3 every few hundred heights; the
    server holds height 1 and every LC_HELD-th (`light_chain`, signed in
    the pool) in a `LightClientReactor` served over localhost TCP, and a
    port `BisectingCertifier(source=PeerProvider(client reactor),
    verifier=default_verifier(), trusted=CertifiedCommitCache())` walks
    from height 1 to the head. The walk must end trusted at the head
    with its set's hash, each round must be one verify call and one
    launch record holding its lanes, and each round whose lanes less
    those the signature cache withholds (candidates an earlier round
    verified) reach the minimum device batch one `ladder` launch and one
    finish, the others the host; a second walk over the same trusted
    cache answers with zero launches. Then a server whose commit at the
    walk's first adopted height is `testing.forge_fullcommit`'s forgery:
    a fresh walk against it fails hard with the certifier's message, and
    its push to a subscribed client that certified the honest commit
    scores the server `forged_fullcommit` (a ban) and turns the genuine
    double sign into `DuplicateVoteEvidence` in the client's pool."""
    from tendermint_tpu_torch.evidence import EvidencePool
    from tendermint_tpu_torch.lightclient import BisectingCertifier, CertifiedCommitCache, PeerProvider
    from tendermint_tpu_torch.services.verifier import default_verifier
    from tendermint_tpu_torch.testing import forge_fullcommit
    from tendermint_tpu_torch.types import PrivValidator, ValidationError
    from tendermint_tpu_torch.crypto import PrivKey

    min_batch = stack.inner.primary._min_batch
    health = StackHealth(stack.inner)
    rep: dict = {"validators": LC_VALIDATORS, "heights": LC_HEIGHTS, "rotate_every": LC_ROTATE,
                 "held_every": LC_HELD}

    def expect(what: str, got, want) -> None:
        if got != want:
            raise AssertionError(f"readpath_lightclient {what}: {got!r}, expected {want!r}")

    fcs, rep["sign_s"], seeds = light_chain(inp, LC_VALIDATORS, LC_HEIGHTS, LC_ROTATE, LC_HELD)
    rep["held_commits"] = len(fcs)
    log({"phase": "readpath_light_chain", "held_commits": len(fcs), "sign_s": rep["sign_s"]})
    head = fcs[LC_HEIGHTS]
    verifier = default_verifier()
    expect("default_verifier()", verifier is stack, True)
    led = StepLedger("readpath", "lightclient")
    sw_s, _srv, lis = light_server(fcs, "light-server")
    sw_c, client = light_client("light-client", lis)
    try:
        trusted = CertifiedCommitCache()
        cert = BisectingCertifier(LC_CHAIN, seed=fcs[1], trusted=trusted, source=PeerProvider(client),
                                  verifier=verifier)
        rounds = WalkRounds(cert)
        c0 = counts()
        t0 = time.perf_counter()
        cert.verify_to_height(LC_HEIGHTS)
        sync()
        walk_s = time.perf_counter() - t0
        c1 = counts()
        c = {k: c1[k] - c0[k] for k in c1}
        expect("trusted height", cert.last_height, LC_HEIGHTS)
        expect("trusted set", cert.validators.hash(), head.validators.hash())
        expect("head in the trusted cache", trusted.get_exact(LC_HEIGHTS).header.hash(), head.header.hash())
        expect("verify calls", len(rounds.calls), cert.last_walk_rounds)
        expect("lanes", sum(rounds.lanes()), cert.last_walk_verifies)
        # one flat call a round; a round re-probing a candidate an earlier
        # round verified has those lanes withheld by the signature cache,
        # and the rest goes to the card at the minimum batch or more
        recs = [r for r in led.records() if r.get("kind") == "verify" and not r.get("error")]
        expect("one flat call a round", len(recs), cert.last_walk_rounds)
        expect("each round's lanes", [int(r.get("rows", 0)) + int(r.get("rows_cached", 0)) for r in recs],
               rounds.lanes())
        expect("the card answers each round of the minimum batch or more after the cache",
               [r.get("backend", "host") != "host" for r in recs],
               [int(r.get("rows", 0)) >= min_batch for r in recs])
        flat = {"device_flat_sizes": [int(r["rows"]) for r in recs if r.get("backend", "host") != "host"],
                "host_flat_sizes": [int(r.get("rows", 0)) for r in recs if r.get("backend", "host") == "host"],
                "rows_cached": [int(r.get("rows_cached", 0)) for r in recs]}
        dev_rounds = len(flat["device_flat_sizes"])
        expect("walk launches", {k: c[k] for k in VERIFY_KERNELS},
               {"madd_chain_entries": 0, "madd_chain_fused": 0, "ladder": dev_rounds,
                "finish_encode_compare": dev_rounds})
        big = sum(1 for n in rounds.lanes() if n >= min_batch)
        walk = {"rounds": cert.last_walk_rounds, "lanes": rounds.lanes(), "verifies": cert.last_walk_verifies,
                "rows_to_card": flat["device_flat_sizes"], "rows_to_host": flat["host_flat_sizes"],
                "rows_cached": flat["rows_cached"],
                "candidates": [len(c["heights"]) for c in rounds.calls], "rounds_of_min_batch_or_more": big,
                "rounds_on_the_card": dev_rounds,
                "walk_s": walk_s, "commits_certified_per_s": sum(len(c["heights"]) for c in rounds.calls) / walk_s,
                "heights_per_s": (LC_HEIGHTS - 1) / walk_s, "verifies_per_s": cert.last_walk_verifies / walk_s,
                "launches": c, "flat": flat}
        rep["walk"] = walk
        log({"phase": "readpath_light_walk", **walk})
        # the second walk from height 1 answers from the trusted cache
        again = BisectingCertifier(LC_CHAIN, seed=fcs[1], trusted=trusted, source=PeerProvider(client),
                                   verifier=verifier)
        c0 = counts()
        t0 = time.perf_counter()
        again.verify_to_height(LC_HEIGHTS)
        rep["cached_walk_s"] = time.perf_counter() - t0
        c1 = counts()
        expect("cached walk height", again.last_height, LC_HEIGHTS)
        expect("cached walk launches", sum(c1[k] - c0[k] for k in c1), 0)
        expect("cached walk rounds", again.last_walk_rounds, 0)
    finally:
        sw_c.stop()
        sw_s.stop()
        lis.stop()

    # the forged server: its commit at the walk's first adopted height
    forged_at = max(rounds.adopted(0))
    honest = fcs[forged_at]
    compromised_addr = honest.validators.validators[0].address
    compromised = PrivValidator(PrivKey(seeds[compromised_addr]))
    forged = forge_fullcommit(honest, compromised, LC_CHAIN)
    bad = dict(fcs)
    bad[forged_at] = forged
    sw_f, srv_f, lis_f = light_server(bad, "light-forger")
    pool = EvidencePool(chain_id=LC_CHAIN)
    try:
        sw_c, client = light_client("light-client-2", lis_f)
        try:
            fresh = BisectingCertifier(LC_CHAIN, seed=fcs[1], trusted=CertifiedCommitCache(),
                                       source=PeerProvider(client), verifier=verifier)
            frounds = WalkRounds(fresh)
            want_msg = (f"candidate at height {forged_at} lacks its own +2/3 quorum "
                        f"({TYPES_POWER} of {TYPES_POWER * LC_VALIDATORS})")
            try:
                fresh.verify_to_height(LC_HEIGHTS)
                raise AssertionError("readpath_lightclient: the walk against the forger ended trusted")
            except ValidationError as e:
                expect("forged walk error", (type(e).__name__, str(e)), ("ValidationError", want_msg))
            expect("forged walk height", fresh.last_height, 1)
        finally:
            sw_c.stop()
        # the push: a subscribed client that certified the honest commit
        base = _counter("tendermint_p2p_peer_misbehavior_total", kind="forged_fullcommit")
        sw_c, client = light_client("light-client-3", lis_f, cache=trusted, certifier=cert, subscribe=True,
                                    evidence_pool=pool, verifier=verifier)
        try:
            deadline = time.time() + 30
            while not srv_f._subscribers and time.time() < deadline:
                time.sleep(0.01)
            srv_f.announce(forged)
            while pool.depth() == 0 and time.time() < deadline:
                time.sleep(0.01)
            expect("evidence", pool.depth(), 1)
            ev = pool.pending_evidence()[0]
            expect("evidence validator", ev.address, compromised_addr)
            expect("forged_fullcommit scored",
                   _counter("tendermint_p2p_peer_misbehavior_total", kind="forged_fullcommit") - base >= 1, True)
            expect("forger banned", sw_c.scorer.is_banned("light-forger"), True)
            expect("cache kept the honest commit", trusted.get_exact(forged_at).header.hash(), honest.header.hash())
        finally:
            sw_c.stop()
    finally:
        pool.close()
        sw_f.stop()
        lis_f.stop()
    rep["forged"] = {"height": forged_at, "message": want_msg, "rounds": fresh.last_walk_rounds,
                     "lanes": frounds.lanes(), "evidence_validator": compromised_addr.hex()}
    rep["step_launches"] = led.settle()
    led.close()
    health.check("readpath lightclient")
    log({"phase": "readpath_lightclient", **{k: v for k, v in rep.items() if k != "walk"}})
    return rep


def run_readpath_rpc(stack, inp, sync, served: dict) -> dict:
    """Phase 12, step 3: the port's `RPCServer` with `make_routes` on the
    serving node of step 1 (`testing.ReadNode` over its chain's store,
    state and app, a `LightClientReactor` on its store, the resilient
    hasher). Over `HTTPClient`, `status`, `block`, `commit`,
    `full_commit`, `validators`, `abci_info`, `health` and
    `dump_telemetry(launches=64)` must each answer what the node's objects
    hold (the `launches` view's records are the port's `LAUNCHLOG`'s
    newest), RPC_REPS round trips each timed; then a `NodeProvider` over
    the `HTTPClient` feeds a port `DynamicCertifier` (a fresh coalescer
    over the stack) that certifies the READ_TAIL_HEIGHTS heights after
    the snapshot, each a verify of the whole set on `madd_chain_entries`
    and the finish."""
    from tendermint_tpu_torch.certifiers.certifier import DynamicCertifier, FullCommit
    from tendermint_tpu_torch.certifiers.node_provider import NodeProvider
    from tendermint_tpu_torch.lightclient import LightClientReactor
    from tendermint_tpu_torch.rpc import RPCServer, make_routes
    from tendermint_tpu_torch.rpc.client import HTTPClient
    from tendermint_tpu_torch.services.batcher import CoalescingVerifier
    from tendermint_tpu_torch.telemetry.launchlog import LAUNCHLOG
    from tendermint_tpu_torch.testing import ReadNode

    chain, store, hasher = served["chain"], served["store"], served["hasher"]
    snap_h, top = served["snap_h"], served["top"]
    health = StackHealth(stack.inner, hasher)
    rep: dict = {"reps": RPC_REPS}

    def expect(what: str, got, want) -> None:
        if got != want:
            raise AssertionError(f"readpath_rpc {what}: {got!r}, expected {want!r}")

    led = StepLedger("readpath", "rpc")
    lc = LightClientReactor(chain_id=READ_CHAIN, block_store=store, state=chain.state)
    node = ReadNode(chain.genesis, chain.state, store, chain.app, "readpath-server", lightclient_reactor=lc,
                    hasher=hasher, moniker="readpath")
    server = RPCServer(make_routes(node), "tcp://127.0.0.1:0", event_switch=node.event_switch)
    server.start()
    cli = HTTPClient(f"127.0.0.1:{server.port}")
    h = top - 1
    try:
        calls = {
            "status": lambda: cli.status(),
            "block": lambda: cli.block(h),
            "commit": lambda: cli.commit(h),
            "full_commit": lambda: cli._call("full_commit", height=h),
            "validators": lambda: cli.validators(h),
            "abci_info": lambda: cli.abci_info(),
            "health": lambda: cli._call("health"),
            "dump_telemetry": lambda: cli._call("dump_telemetry", launches=64),
        }
        ms, out = {}, {}
        for name, fn in calls.items():
            times = []
            for _ in range(RPC_REPS):
                t0 = time.perf_counter()
                out[name] = fn()
                times.append((time.perf_counter() - t0) * 1e3)
            ms[name] = statistics.median(times)
        st = out["status"]
        expect("status", (st["node_info"]["id"], st["node_info"]["moniker"], st["node_info"]["chain_id"],
                          st["sync_info"]["latest_block_height"], st["sync_info"]["latest_block_hash"],
                          st["sync_info"]["latest_app_hash"]),
               ("readpath-server", "readpath", READ_CHAIN, top, chain.blocks[top - 1].hash().hex(),
                chain.state.app_hash.hex()))
        blk = out["block"]["block"]
        expect("block", (blk["header"]["hash"], len(blk["txs"]), blk["last_commit"]["precommits"]),
               (chain.blocks[h - 1].hash().hex(), READ_TAIL_TXS, len(chain.state.validators.validators)))
        cm = out["commit"]["commit"]
        want_commit = store.load_block_commit(h)
        expect("commit", (cm["block_id"]["hash"], cm["signatures"], out["commit"]["canonical"]),
               (want_commit.block_id.hash.hex(), len(want_commit.precommits), True))
        fc = FullCommit.decode(bytes.fromhex(out["full_commit"]["full_commit"]))
        expect("full_commit", fc.encode(), lc.serve_commit(h).encode())
        expect("validators", [v["address"] for v in out["validators"]["validators"]],
               [v.address.hex() for v in chain.state.load_validators(h)])
        info = out["abci_info"]
        expect("abci_info", (info["last_block_height"], info["last_block_app_hash"]),
               (top, chain.state.app_hash.hex()))
        hl = out["health"]
        expect("health", (hl["node_id"], hl["height"], hl["checks"]["breakers"]["states"]),
               ("readpath-server", top, {"hasher": "closed"}))
        recs = out["dump_telemetry"]["launches"]["records"]
        expect("launches view", json.loads(json.dumps(recs)), json.loads(json.dumps(LAUNCHLOG.recent(64))))
        rep["route_ms"] = ms
        log({"phase": "readpath_rpc_routes", **ms})

        # certifying over RPC: the tail heights, each a verify of the set
        fresh = CoalescingVerifier(stack.inner)
        try:
            provider = NodeProvider(cli)
            cert = DynamicCertifier(READ_CHAIN, chain.state.load_validators(snap_h + 1), snap_h, fresh)
            c0 = counts()
            t0 = time.perf_counter()
            fetch_s = 0.0
            for hh in range(snap_h + 1, top + 1):
                t1 = time.perf_counter()
                fc = provider.get_by_height(hh)
                fetch_s += time.perf_counter() - t1
                expect(f"provider height {hh}", fc.height(), hh)
                cert.certify(fc)
            sync()
            certify_s = time.perf_counter() - t0
            c1 = counts()
        finally:
            fresh.coalescer.close()
        c = {k: c1[k] - c0[k] for k in c1}
        n = top - snap_h
        expect("certify launches", {k: c[k] for k in VERIFY_KERNELS},
               {"madd_chain_entries": n, "madd_chain_fused": 0, "ladder": 0, "finish_encode_compare": n})
        rep["certify"] = {"commits": n, "validators": len(chain.state.validators.validators), "s": certify_s,
                          "fetch_s": fetch_s, "commits_per_s": n / certify_s, "launches": c}
        log({"phase": "readpath_rpc_certify", **rep["certify"]})
    finally:
        server.stop()
    rep["step_launches"] = led.settle()
    led.close()
    health.check("readpath rpc")
    return rep


def run_readpath(stack, inp, sync, ns: int) -> dict:
    """Phase 12: the read path (state sync, the light client, RPC) on the
    stack, which it leaves with the table cache it found."""
    c0 = counts()
    with TableCacheKept(stack.inner.primary):
        statesync, served = run_readpath_statesync(stack, inp, sync, ns)
        rep = {"statesync": statesync, "lightclient": run_readpath_lightclient(stack, inp, sync),
               "rpc": run_readpath_rpc(stack, inp, sync, served)}
    c1 = counts()
    rep["launches"] = {k: c1[k] - c0[k] for k in c1}
    log({"phase": "readpath", "launches": rep["launches"]})
    return rep


# -- phase 13: the port's own node and CLI, each node a process of its own --

NODE_NET_CHAIN = "chip-smoke-node-net"
NODE_NET_N = 4
NODE_NET_HEIGHTS = 10  # heights a run commits on every node
NODE_NET_TXS = 16
NODE_KILLED = 3  # run a: this node is SIGKILLed at NODE_KILL_AT or later, then restarted
NODE_KILL_AT = 5
# run b's minimum device batch (TENDERMINT_TPU_MIN_DEVICE_BATCH in the
# nodes' environment): every vote drain and commit reaches the card
NODE_NET_RUNS = (("a", None), ("b", 0))
NODE_UP_TIMEOUT_S = 120.0  # a node process's start to its "node ... up" line
NODE_NET_TIMEOUT_S = 180.0
NODE_SYNC_TIMEOUT_S = 300.0
NODE_STOP_TIMEOUT_S = 60.0
NODE_POLL_S = 0.02
NODE_LOGS = "nodes"  # OUT/nodes/: each node process's output
NODE_COUNTS_ENV = "CHIP_SMOKE_KERNEL_COUNTS"
# Put first on the node processes' path as `sitecustomize`: at the
# interpreter's exit it writes the port's kernel wrappers' launch counts
# (WRAPPERS, of the wrapper modules the process imported) and, for each
# call of TIMED, its seconds and the wall-clock time it ended at
# (`time.time()`) to the file the environment names, and when a call of
# a key in MARKS ends, it touches that file's name + "." + the key. It
# runs the interpreter's own sitecustomize first, which it shadows. The
# timers wrap the classes' methods as their modules are first imported.
TIMED = {
    "tendermint_tpu_torch.consensus.replay": (("Handshaker", "handshake", "handshake_s"),),
    "tendermint_tpu_torch.node.node": (("Node", "__init__", "node_init_s"), ("Node", "start", "node_start_s")),
    "tendermint_tpu_torch.consensus.state": (("ConsensusState", "_reconstruct_last_commit", "last_commit_s"),),
    # the warm-up thread's body: the kernels' first use on the card
    "tendermint_tpu_torch.services.verifier": (("TableBatchVerifier", "_first_use", "warm_first_use_s"),),
}
# a node is stopped only once its warm-up has ended, so that each life's
# launches hold exactly one warm-up (an exit cuts a running warm-up short)
MARKS = ("warm_first_use_s",)
COUNTS_HOOK = '''"""Written by chip_smoke.py for the node processes it starts."""
import atexit
import faulthandler
import importlib.util
import json
import os
import signal
import sys
import time

# SIGUSR1 writes every thread's stack to stderr (the process's log under
# chiprun_out/nodes/): send it to a node that stops answering
faulthandler.register(signal.SIGUSR1, all_threads=True)

_HERE = os.path.dirname(os.path.abspath(__file__))
for _dir in sys.path:
    _path = os.path.join(_dir or ".", "sitecustomize.py")
    if os.path.abspath(_dir or ".") != _HERE and os.path.isfile(_path):
        _spec = importlib.util.spec_from_file_location("_shadowed_sitecustomize", _path)
        _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
        break

WRAPPERS = %(wrappers)r
TIMED = %(timed)r
MARKS = %(marks)r
_SECONDS = {}


def _timer(cls, attr, key):
    fn = getattr(cls, attr)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            _SECONDS.setdefault(key, []).append((time.perf_counter() - t0, time.time()))
            if key in MARKS:
                open(os.environ[%(env)r] + "." + key, "w").close()

    setattr(cls, attr, timed)


class _TimerFinder:
    """Finds the modules of TIMED as the path would, and wraps their
    methods once each module has run."""

    def find_spec(self, name, path=None, target=None):
        if name not in TIMED:
            return None
        sys.meta_path.remove(self)
        try:
            spec = importlib.util.find_spec(name)
        finally:
            sys.meta_path.insert(0, self)
        if spec is None:
            return None
        run = spec.loader.exec_module

        def exec_module(module):
            run(module)
            for cls, attr, key in TIMED[name]:
                _timer(getattr(module, cls), attr, key)

        spec.loader.exec_module = exec_module
        return spec


def _dump():
    counts = {}
    for name, (mod, attr) in WRAPPERS.items():
        m = sys.modules.get(mod)
        counts[name] = int(getattr(m, attr).launches) if m is not None else 0
    # modules of jax or of the JAX package the process imported (none)
    foreign = sorted(m for m in sys.modules if m in ("jax", "tendermint_tpu")
                     or m.startswith(("jax.", "tendermint_tpu.")))
    with open(os.environ[%(env)r], "w") as f:
        json.dump({"counts": counts, "seconds": _SECONDS, "foreign": foreign}, f)


if os.environ.get(%(env)r):
    sys.meta_path.insert(0, _TimerFinder())
    atexit.register(_dump)
'''


def port_cli(*commands) -> None:
    """`python -m tendermint_tpu_torch <args>` for each argument tuple of
    `commands`, all at once (each process spends seconds importing torch),
    each to its end."""
    procs = [(args, subprocess.Popen([sys.executable, "-m", "tendermint_tpu_torch", *map(str, args)], cwd=REPO,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
             for args in commands]
    for args, proc in procs:
        _out, err = proc.communicate(timeout=120)
        if proc.returncode != 0:
            raise AssertionError(f"node: `tendermint_tpu_torch {' '.join(map(str, args))}` exited "
                                 f"{proc.returncode}: {err[-2000:]}")


# consecutive ports for the nodes are taken below the kernel's usual
# ephemeral range (32768 and up), where outbound links take theirs
NODE_PORTS = (10000, 32000)


def free_port_base(n: int, avoid=()) -> int:
    """The first of `n` consecutive free localhost ports, none within 64
    of a base in `avoid`."""
    import socket

    rng = np.random.default_rng()
    for _ in range(200):
        base = int(rng.integers(NODE_PORTS[0], NODE_PORTS[1] - n))
        if any(abs(base - other) < 64 for other in avoid):
            continue
        socks = []
        try:
            for port in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise AssertionError(f"node: no {n} consecutive free ports")


class NodeProcess:
    """One `python -m tendermint_tpu_torch node --home HOME` process. Its
    output goes to OUT/nodes/; the time of its "node ... up" line
    (printed once `Node.start()` returned: stores, handshake, listener,
    RPC and the seeds' dials done) is `up_at`; `terminate()` sends it
    SIGTERM, as an operator stops a node, and `stop()` waits for its exit
    and returns the kernel wrappers' launch counts the counts hook wrote
    then; `seconds` then holds the hook's timings of this life (TIMED:
    each call's seconds and wall-clock end)."""

    def __init__(self, name: str, home, hook_dir, args=(), env=None):
        self.name, self.home = name, str(home)
        self.counts_path = os.path.join(self.home, "kernel_counts.json")
        self.cmd = [sys.executable, "-m", "tendermint_tpu_torch", "node", "--home", self.home, *map(str, args)]
        self.env = dict(os.environ, **(env or {}))
        self.env["PYTHONPATH"] = os.pathsep.join([str(hook_dir), str(REPO)])
        self.env[NODE_COUNTS_ENV] = self.counts_path
        self.proc = None
        self.lives = 0

    def start(self) -> None:
        import threading

        self.warm_mark = self.counts_path + ".warm_first_use_s"
        for path in (self.counts_path, self.warm_mark):
            if os.path.exists(path):
                os.unlink(path)
        (OUT / NODE_LOGS).mkdir(parents=True, exist_ok=True)
        self.log_path = OUT / NODE_LOGS / f"{self.name}.{self.lives}.log"
        err = open(self.log_path, "wb")
        self.up_at = None
        self.started_at = time.perf_counter()
        self.proc = subprocess.Popen(self.cmd, cwd=REPO, env=self.env, stdout=subprocess.PIPE, stderr=err)
        err.close()
        self.lives += 1
        threading.Thread(target=self._read, args=(self.proc,), daemon=True).start()

    def _read(self, proc) -> None:
        with open(OUT / NODE_LOGS / f"{self.name}.{self.lives - 1}.out", "wb") as out:
            for line in proc.stdout:
                if self.up_at is None and b" up: p2p " in line:
                    self.up_at, self.up_wall = time.perf_counter(), time.time()
                out.write(line)
                out.flush()

    def tail(self) -> str:
        try:
            return self.log_path.read_text(errors="replace")[-3000:]
        except OSError:
            return ""

    def check(self) -> None:
        """Fails when the process has exited."""
        rc = self.proc.poll()
        if rc is not None:
            raise AssertionError(f"node: {self.name} exited early with {rc}:\n{self.tail()}")

    def wait_up(self) -> float:
        """Seconds from the process's start to its "up" line."""
        deadline = time.time() + NODE_UP_TIMEOUT_S
        while self.up_at is None:
            self.check()
            if time.time() > deadline:
                raise AssertionError(f"node: {self.name} not up in {NODE_UP_TIMEOUT_S} s:\n{self.tail()}")
            time.sleep(NODE_POLL_S)
        return self.up_at - self.started_at

    def kill(self) -> None:
        import signal

        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=NODE_STOP_TIMEOUT_S)

    def terminate(self, wait_warm: bool) -> None:
        """SIGTERM, once the warm-up has ended where `wait_warm` (a node on
        the card warms up; one on the CPU does not)."""
        import signal

        deadline = time.time() + NODE_UP_TIMEOUT_S
        while wait_warm and not os.path.exists(self.warm_mark):
            self.check()
            if time.time() > deadline:
                raise AssertionError(f"node: {self.name}'s kernel warm-up did not end in {NODE_UP_TIMEOUT_S} s")
            time.sleep(NODE_POLL_S)
        self.check()
        self.proc.send_signal(signal.SIGTERM)

    def stop(self) -> dict:
        try:
            rc = self.proc.wait(timeout=NODE_STOP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            self.kill()
            raise AssertionError(f"node: {self.name} did not stop in {NODE_STOP_TIMEOUT_S} s")
        if rc != 0:
            raise AssertionError(f"node: {self.name} stopped with {rc}:\n{self.tail()}")
        with open(self.counts_path) as f:
            out = json.load(f)
        self.seconds = out["seconds"]
        if out["foreign"]:
            raise AssertionError(f"node: {self.name} imported {out['foreign'][:5]}")
        return out["counts"]

    def warm_after_up(self) -> float | None:
        """Seconds from this life's "up" line to the end of its kernels'
        warm-up on the card (negative: it ended before), or None."""
        ends = [end for _s, end in self.seconds.get("warm_first_use_s", ())]
        return max(ends) - self.up_wall if ends else None

    def reap(self) -> None:
        """Ends the process if it still runs (a failed step's cleanup)."""
        if self.proc is not None and self.proc.poll() is None:
            self.kill()


def stop_all(nodes, warm: dict) -> dict:
    """Each node's launch counts, once SIGTERM has stopped them all (each
    after its warm-up of `warm`'s launches, if any, has ended)."""
    for nd in nodes:
        nd.terminate(wait_warm=any(warm.values()))
    return {nd.name: nd.stop() for nd in nodes}


def write_counts_hook(dirpath) -> None:
    pathlib.Path(dirpath, "sitecustomize.py").write_text(
        COUNTS_HOOK % {"wrappers": WRAPPERS, "timed": TIMED, "marks": MARKS, "env": NODE_COUNTS_ENV})


def warm_launches(dev) -> dict:
    """The launches of one `TableBatchVerifier.warm_kernels()` first use
    (each route once on dummy lanes), which every node on the card makes
    as it starts and which no launch-ledger record accounts for."""
    from tendermint_tpu_torch.services.verifier import TableBatchVerifier

    c0 = counts()
    TableBatchVerifier(device=dev)._first_use()
    c1 = counts()
    return {k: c1[k] - c0[k] for k in c1}


def node_ledger(home) -> list:
    """The launch-ledger records under a node's home."""
    path = pathlib.Path(home, "data", LEDGER_FILE)
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


def ledger_kernels(records, n_vals: int) -> dict:
    """Kernel launches by name that launch-ledger records account for: a
    `verify` record one `ladder`, a `tables` record of K commits of
    `n_vals` lanes one `madd_chain_fused` at K >= FUSED_MIN_STACK and one
    `madd_chain_entries` below it, each one finish; host records none."""
    from tendermint_tpu_torch.ops.ed25519_tables import FUSED_MIN_STACK

    out = dict.fromkeys(WRAPPERS, 0)
    for r in records:
        if r.get("error") or r.get("backend", "host") == "host":
            continue
        n = int(r.get("mesh_width", 1))
        if r["kind"] == "verify":
            out["ladder"] += n
        elif r["kind"] == "tables":
            k = int(r["rows"]) // n_vals
            out["madd_chain_fused" if k >= FUSED_MIN_STACK else "madd_chain_entries"] += n
        else:
            raise AssertionError(f"node: a {r['kind']} record on a node's verify path: {r}")
        out["finish_encode_compare"] += n
    return out


def node_account(name: str, got: dict, warm: dict, records, n_vals: int) -> dict:
    """A node process's kernel launches, its wrappers' counts at exit less
    the warm-up's, which its ledger's records must account for kernel by
    kernel; a record with an error fails."""
    failed = [r for r in records if r.get("error")]
    if failed:
        raise AssertionError(f"node: {name}'s ledger has records with an error: {failed[:3]}")
    launched = {k: got[k] - warm[k] for k in got}
    want = ledger_kernels(records, n_vals)
    if launched != want:
        raise AssertionError(f"node: {name}'s wrappers launched {launched} beyond the warm-up {warm}, "
                             f"its ledger's records account for {want}")
    return launched


def node_device_health(name: str, client) -> dict:
    """The node's `/health` status and its verifier's and hasher's
    resilient wrappers (`dump_telemetry`'s breakers): a host fallback or
    a primary failure fails."""
    health = client._call("health")
    breakers = client._call("dump_telemetry", spans=0)["breakers"]
    for kind in ("verifier", "hasher"):
        b = breakers.get(kind, {})
        if b.get("fallback_calls", 0) or b.get("total_failures", 0) or b.get("state", "closed") != "closed":
            raise AssertionError(f"node: {name}'s {kind}: {b}")
    return {"status": health["status"], "ready": health["ready"]}


def height_split(home, lo: int, hi: int) -> dict:
    """What the height ledger under a node's home says of heights lo..hi:
    the median seconds of a height and of each of its phases, the
    heights that needed a round past 0, and each critical path's
    count."""
    from collections import Counter

    recs = [json.loads(line) for line in pathlib.Path(home, "data", "heights.jsonl").read_text().splitlines()
            if line.strip()]
    recs = [r for r in recs if lo <= r["height"] <= hi]
    if not recs:
        return {"heights": 0}
    phases = sorted({ph for r in recs for ph in r.get("phases", {})})
    return {
        "heights": len(recs),
        "height_s_median": statistics.median(r["height_s"] for r in recs),
        "phase_s_median": {ph: statistics.median(r["phases"][ph]["s"] for r in recs if ph in r["phases"])
                           for ph in phases},
        "slowest": max(((r["height"], r["height_s"], r.get("critical_path")) for r in recs), key=lambda x: x[1]),
        "rounds_past_0": sum(1 for r in recs if r.get("round", 0) > 0),
        "critical_path": dict(Counter(r.get("critical_path") for r in recs)),
    }


def metric_total(client, name: str) -> float:
    """A counter's value over all its series, from a node's `dump_telemetry`."""
    fam = client._call("dump_telemetry", spans=0)["metrics"].get(name, {"series": []})
    return float(sum(ser["value"] for ser in fam["series"]))


def node_client(port: int):
    from tendermint_tpu_torch.rpc.client import HTTPClient

    return HTTPClient(f"127.0.0.1:{port}", timeout=60.0)


def node_heights(clients) -> list:
    return [c.status()["sync_info"]["latest_block_height"] for c in clients]


def wait_nodes(nodes, pred, what: str, timeout: float):
    """Polls `pred()` until it returns a true value, failing when a node
    process exits or the time runs out."""
    deadline = time.time() + timeout
    while True:
        for nd in nodes:
            nd.check()
        got = pred()
        if got:
            return got
        if time.time() > deadline:
            raise AssertionError(f"node: {what} not reached in {timeout} s")
        time.sleep(NODE_POLL_S)


def same_chain(what: str, clients, top: int) -> dict:
    """Every node's block hashes (`blockchain`), `block` at heights 1..top
    and `commit` at 1..top-1 (the canonical one, from the next block) are
    byte-equal across nodes; returns each height's txs."""
    for lo in range(1, top + 1, 20):
        hi = min(lo + 19, top)
        if len({json.dumps(c.blockchain(lo, hi)["block_metas"]) for c in clients}) != 1:
            raise AssertionError(f"node {what}: the nodes' block hashes differ at heights {lo}-{hi}")
    txs = {}
    for h in range(1, top + 1):
        blocks = {json.dumps(c.block(h), sort_keys=True) for c in clients}
        if len(blocks) != 1:
            raise AssertionError(f"node {what}: the nodes' blocks differ at height {h}")
        txs[h] = json.loads(blocks.pop())["block"]["txs"]
        if h < top:
            commits = [c.commit(h) for c in clients]
            if not all(cm["canonical"] for cm in commits) or len({json.dumps(cm, sort_keys=True)
                                                                    for cm in commits}) != 1:
                raise AssertionError(f"node {what}: the nodes' commits differ at height {h}")
    return txs


def same_app_hash(what: str, clients) -> dict:
    """Nodes at one height report one app hash, and it is the one the next
    block's header carries wherever a node has that block."""
    by_height: dict = {}
    for c in clients:
        si = c.status()["sync_info"]
        by_height.setdefault(si["latest_block_height"], set()).add(si["latest_app_hash"])
    for h, hashes in by_height.items():
        if len(hashes) != 1:
            raise AssertionError(f"node {what}: app hashes {hashes} at height {h}")
        for c in clients:
            try:
                header = c.block(h + 1)["block"]["header"]
            except Exception:
                continue  # this node has no block h + 1
            if header["app_hash"] not in hashes:
                raise AssertionError(f"node {what}: app hash {hashes} at {h}, block {h + 1} carries "
                                     f"{header['app_hash']}")
    return {h: next(iter(v)) for h, v in by_height.items()}


def run_node_net(out, base: int, hook_dir, inp, run: str, min_batch, warm: dict) -> dict:
    """Phase 13, `node_net` run `run` (BASELINE config 1) on the four homes
    that `testnet --n 4` wrote under `out` with ports from `base`, at the
    default `Config` (1 s `timeout_commit`,
    SecretConnections, PEX, 512,000 B/s links) and four `node` processes
    run on the card, with TENDERMINT_TPU_MIN_DEVICE_BATCH=`min_batch` when
    given. NODE_NET_TXS kvstore txs go in through `broadcast_tx_commit`
    (node i % 4 for tx i) and each is read back with `abci_query` and `tx`
    from every node. Run a SIGKILLs node NODE_KILLED at height
    NODE_KILL_AT or later and restarts it on its home: it must replay its
    WAL, catch up and commit with the others again. Every node commits
    NODE_NET_HEIGHTS heights (and, in run a, two past the restarted node's
    rejoin); the blocks and commits of every height and the app hashes
    are equal on every node; each process's launches are accounted for by
    its ledger; its wrappers and breakers saw no fallback or failure."""
    import threading

    env = {} if min_batch is None else {"TENDERMINT_TPU_MIN_DEVICE_BATCH": str(min_batch)}
    homes = [out / f"node{i}" for i in range(NODE_NET_N)]
    nodes = [NodeProcess(f"net_{run}_node{i}", homes[i], hook_dir, env=env) for i in range(NODE_NET_N)]
    clients = [node_client(base + 2 * i + 1) for i in range(NODE_NET_N)]
    rng = np.random.default_rng(inp.seed + 130 + len(run))
    txs = [b"node-%s-%02d=%s" % (run.encode(), i, rng.bytes(8).hex().encode()) for i in range(NODE_NET_TXS)]
    rep: dict = {"run": run, "nodes": NODE_NET_N, "min_device_batch": min_batch, "txs": NODE_NET_TXS}
    launches: dict = {}
    try:
        for nd in nodes:
            nd.start()
        rep["up_s"] = [nd.wait_up() for nd in nodes]
        h0 = wait_nodes(nodes, lambda: min(node_heights(clients)) >= 1 and min(node_heights(clients)),
                        "a first height on every node", NODE_NET_TIMEOUT_S)
        t0 = time.perf_counter()
        results: list = [None] * NODE_NET_TXS

        def send(i):
            try:
                results[i] = clients[i % NODE_NET_N].broadcast_tx_commit(txs[i])
            except Exception as e:  # reported below with the others
                results[i] = e

        senders = [threading.Thread(target=send, args=(i,), daemon=True) for i in range(NODE_NET_TXS)]
        for t in senders:
            t.start()
        for t in senders:
            t.join(timeout=NODE_NET_TIMEOUT_S)
        bad = [(i, r) for i, r in enumerate(results)
               if not isinstance(r, dict) or r["check_tx"]["code"] != 0 or r["deliver_tx"]["code"] != 0]
        if bad:
            raise AssertionError(f"node_net {run}: broadcast_tx_commit answered {bad[:3]}")
        rep["tx_commit_s"] = time.perf_counter() - t0
        rep["tx_heights"] = sorted({r["height"] for r in results})
        target = h0 + NODE_NET_HEIGHTS
        if run == "a":
            killed, others = nodes[NODE_KILLED], [c for i, c in enumerate(clients) if i != NODE_KILLED]
            wait_nodes(nodes, lambda: min(node_heights(clients)) >= NODE_KILL_AT, f"height {NODE_KILL_AT}",
                       NODE_NET_TIMEOUT_S)
            rep["killed_at"] = clients[NODE_KILLED].status()["sync_info"]["latest_block_height"]
            killed.kill()
            t_restart = time.perf_counter()
            killed.start()
            rep["restart_up_s"] = killed.wait_up()
            ahead = max(node_heights(others))

            def rejoined():
                st = clients[NODE_KILLED].status()["sync_info"]
                return not st["catching_up"] and st["latest_block_height"] >= ahead and st["latest_block_height"]

            rep["rejoin_height"] = wait_nodes(nodes, rejoined, f"{killed.name}'s rejoin", NODE_NET_TIMEOUT_S)
            rep["rejoin_s"] = time.perf_counter() - t_restart
            rep["others_at_restart"] = ahead
            target = max(target, rep["rejoin_height"] + 2)
        wait_nodes(nodes, lambda: min(node_heights(clients)) >= target, f"height {target} on every node",
                   NODE_NET_TIMEOUT_S)
        secs = time.perf_counter() - t0
        rep.update({"from_height": h0, "to_height": target, "s": secs, "heights_per_s": (target - h0) / secs})
        rep["height_split_node0"] = height_split(homes[0], h0 + 1, target)
        top = min(node_heights(clients))
        by_height = same_chain(f"net {run}", clients, top)
        # every tx on every node. A restarted validator's mempool replays
        # its WAL, committed txs included, and `KVStoreApp` admits them
        # again, so in run a a tx may be committed once more after the
        # restart (the JAX package's and the reference's behaviour)
        from tendermint_tpu_torch.types.tx import tx_hash

        def check_txs(by_height, top):
            """None once every tx checks out on every node; in run a, the
            height of a commit again past `top` that a node's `tx` route
            already names (the nodes keep committing while this runs)."""
            rep["recommitted"] = []
            for i, tx in enumerate(txs):
                key, _, value = tx.partition(b"=")
                heights = [h for h, hx in by_height.items() for t in hx if t == tx.hex()]
                later = [h for h in heights[1:] if run == "a" and h > rep["killed_at"]]
                if not heights or heights[0] != results[i]["height"] or heights[1:] != later:
                    raise AssertionError(f"node_net {run}: tx {i} committed at heights {heights}, "
                                         f"broadcast_tx_commit said {results[i]['height']}")
                if later:
                    rep["recommitted"].append((i, heights))
                answers = set()
                for n, c in enumerate(clients):
                    q = c.abci_query(data=key)
                    if bytes.fromhex(q["value"]) != value:
                        raise AssertionError(f"node_net {run}: node {n} answers {q} for tx {i}'s key")
                    got = c.tx(tx_hash(tx))
                    if run == "a" and got["height"] > top and got["height"] > rep["killed_at"]:
                        return got["height"]
                    if bytes.fromhex(got["tx"]) != tx or got["height"] != heights[-1]:
                        raise AssertionError(f"node_net {run}: node {n}'s tx {i} is {got}, committed at {heights}")
                    answers.add(json.dumps(got, sort_keys=True))
                if len(answers) != 1:
                    raise AssertionError(f"node_net {run}: the nodes' `tx` answers for tx {i} differ: {answers}")
            return None

        past = check_txs(by_height, top)
        if past is not None:  # check again over every height up to that commit
            wait_nodes(nodes, lambda: min(node_heights(clients)) >= past, f"height {past} on every node",
                       NODE_NET_TIMEOUT_S)
            top = min(node_heights(clients))
            by_height = same_chain(f"net {run}", clients, top)
            past = check_txs(by_height, top)
            if past is not None:
                raise AssertionError(f"node_net {run}: a tx was committed again at {past}, past height {top} "
                                     f"a second time")
        rep["app_hashes"] = same_app_hash(f"net {run}", clients)
        rep["checked_heights"] = top
        rep["health"] = [node_device_health(nd.name, c) for nd, c in zip(nodes, clients)]
        got = stop_all(nodes, warm)
    finally:
        for nd in nodes:
            nd.reap()
    for nd in nodes:
        launches[nd.name] = node_account(nd.name, got[nd.name], warm, node_ledger(nd.home), NODE_NET_N)
    rep["launches"] = launches
    # each process's last life: Node.__init__ (the handshake within it) and Node.start
    rep["node_seconds"] = {nd.name: nd.seconds for nd in nodes}
    rep["warm_after_up_s"] = {nd.name: nd.warm_after_up() for nd in nodes}
    total = {k: sum(c[k] for c in launches.values()) for k in WRAPPERS}
    rep["launches_total"] = total
    if min_batch == 0 and any(c["ladder"] == 0 or c["madd_chain_entries"] == 0 for c in launches.values()):
        raise AssertionError(f"node_net {run}: at minimum batch 0 every node launches `ladder` and the entries "
                             f"chain: {launches}")
    log({"phase": "node_net", **rep})
    return rep


def run_node_sync(stack, server_home, fresh_home, hook_dir, inp, ns: int, warm: dict) -> dict:
    """Phase 13, `node_sync` (BASELINE config 3 at full width): phase 10's
    chain (SYNC_HEIGHTS blocks of SYNC_TXS txs of TX_BYTES over phase 3's
    `ns` keys, `KVStoreApp`, each commit verified on the stack as it is
    applied) is written with the port's `State.save` and `BlockStore` on
    `SQLiteDB` into a home that `init` made, beside its `ns`-validator
    genesis; a `node` process serves it (`--fast-sync false`: its
    handshake replays the chain into its app). A second home from `init`
    with the same genesis runs a fresh `node` whose seeds name the server:
    at the default `Config` it fast-syncs to the head through a
    SecretConnection under the 512,000 B/s link cap. The fresh node's
    ledger must hold its windows (the fused chain at FUSED_MIN_STACK
    commits or more, the entries chain below, each with its finish) and
    account for every launch; its blocks must be byte-equal to the
    server's and its saved state and app hash equal to the chain's at its
    height."""
    from tendermint_tpu_torch.abci.apps import KVStoreApp
    from tendermint_tpu_torch.config import load_config
    from tendermint_tpu_torch.db.kv import SQLiteDB
    from tendermint_tpu_torch.ops.ed25519_tables import FUSED_MIN_STACK
    from tendermint_tpu_torch.services.batcher import CoalescingVerifier
    from tendermint_tpu_torch.services.hasher import default_hasher
    from tendermint_tpu_torch.state.state import load_state
    from tendermint_tpu_torch.testing import chain_store

    rep: dict = {"validators": ns, "heights": SYNC_HEIGHTS, "txs": SYNC_TXS, "tx_bytes": TX_BYTES}
    # 1. the chain, into the server's home
    cfg = load_config(str(server_home))
    rng = np.random.default_rng(inp.seed + 10)  # phase 10's txs
    state_db, store_db = SQLiteDB(cfg.db_path("state")), SQLiteDB(cfg.db_path("blockstore"))
    chain_verifier = CoalescingVerifier(stack.inner)
    states = {}
    t0 = time.perf_counter()
    try:
        chain = smoke_chain(inp, range(ns), KVStoreApp(), chain_verifier, default_hasher(stack.inner.primary.device),
                            SYNC_CHAIN, db=state_db)
        for h in range(1, SYNC_HEIGHTS + 1):
            chain.advance(txs=sync_txs(rng, h))
            states[h] = (chain.state.to_json(), chain.state.app_hash)
        chain_store(chain, db=store_db)
    finally:
        chain_verifier.coalescer.close()
        state_db.close()
        store_db.close()
    rep["chain_s"] = time.perf_counter() - t0
    for home in (server_home, fresh_home):
        chain.genesis.save_as(str(home / "genesis.json"))
    block_bytes = statistics.median(len(b.encode()) for b in chain.blocks)
    rep["block_bytes_median"] = block_bytes
    rep["cap_blocks_per_s"] = NODE_LINK_CAP / block_bytes
    # 2. the server, then the fresh node
    base = free_port_base(4)
    server = NodeProcess("sync_server", server_home, hook_dir,
                         args=("--p2p-laddr", f"tcp://127.0.0.1:{base}", "--rpc-laddr", f"tcp://127.0.0.1:{base + 1}",
                               "--fast-sync", "false"))
    fresh = NodeProcess("sync_fresh", fresh_home, hook_dir,
                        args=("--p2p-laddr", f"tcp://127.0.0.1:{base + 2}",
                              "--rpc-laddr", f"tcp://127.0.0.1:{base + 3}", "--seeds", f"127.0.0.1:{base}"))
    sc, fc = node_client(base + 1), node_client(base + 3)
    applied = SYNC_HEIGHTS - 1  # the last block's commit is in no block
    try:
        server.start()
        rep["server_up_s"] = server.wait_up()
        if sc.status()["sync_info"]["latest_block_height"] != SYNC_HEIGHTS:
            raise AssertionError(f"node_sync: the server serves {sc.status()['sync_info']}")
        fresh.start()
        rep["fresh_up_s"] = fresh.wait_up()

        reached: dict = {}  # height -> seconds from the dial it was first seen at

        def caught_up():
            st = fc.status()["sync_info"]
            reached.setdefault(st["latest_block_height"], time.perf_counter() - fresh.up_at)
            return not st["catching_up"] and st["latest_block_height"] >= applied

        wait_nodes((server, fresh), caught_up, "the fresh node's catch-up", NODE_SYNC_TIMEOUT_S)
        rep["dial_to_caught_up_s"] = time.perf_counter() - fresh.up_at
        rep["blocks_per_s"] = applied / rep["dial_to_caught_up_s"]
        # the catch-up's course: seconds from the dial to the first poll
        # that saw each twelfth of the chain, and the link's bytes
        rep["seconds_to_height"] = {q: min(t for h, t in reached.items() if h >= q)
                                    for q in range(12, applied + 1, 12)}
        rep["recv_bytes"] = metric_total(fc, "tendermint_p2p_recv_bytes_total")
        rep["recv_mb_s"] = rep["recv_bytes"] / rep["dial_to_caught_up_s"] / 1e6
        top = fc.status()["sync_info"]["latest_block_height"]
        for h in range(1, top + 1):
            got, want = fc.block(h), sc.block(h)
            if json.dumps(got, sort_keys=True) != json.dumps(want, sort_keys=True):
                raise AssertionError(f"node_sync: block {h} differs from the server's")
            if got["block"]["header"]["app_hash"] != chain.blocks[h - 1].header.app_hash.hex():
                raise AssertionError(f"node_sync: block {h}'s app hash differs from the chain's")
        rep["health"] = [node_device_health(nd.name, c) for nd, c in ((server, sc), (fresh, fc))]
        got = stop_all((fresh, server), warm)
    finally:
        for nd in (fresh, server):
            nd.reap()
    # 3. the fresh node's saved state and app hash, its windows, its launches
    db = SQLiteDB(load_config(str(fresh_home)).db_path("state"))
    try:
        st = load_state(db)
    finally:
        db.close()
    height = st.last_block_height
    if height < applied or (st.to_json(), st.app_hash) != states[height]:
        raise AssertionError(f"node_sync: the fresh node's state at height {height} differs from the chain's")
    rep["fresh_height"] = height
    rep["server_handshake_s"] = server.seconds["handshake_s"][0][0]  # its replay of the chain into its app
    rep["warm_after_up_s"] = {nd.name: nd.warm_after_up() for nd in (server, fresh)}
    rep["node_seconds"] = {nd.name: nd.seconds for nd in (server, fresh)}
    records = node_ledger(fresh_home)
    windows = [r for r in records if r.get("queue") == "fastsync" and r["kind"] == "tables"]
    sizes = [int(r["rows"]) // ns for r in windows]
    if sum(sizes) < applied or any(r.get("backend", "host") == "host" for r in windows):
        raise AssertionError(f"node_sync: the fresh node's windows {sizes} (backends "
                             f"{[r.get('backend') for r in windows]}) do not cover {applied} blocks on the card")
    rep["window_sizes"] = sizes
    rep["windows_fused"] = sum(1 for k in sizes if k >= FUSED_MIN_STACK)
    rep["launches"] = {
        nd.name: node_account(nd.name, got[nd.name], warm, node_ledger(nd.home), ns) for nd in (server, fresh)
    }
    fl = rep["launches"]["sync_fresh"]
    if fl["madd_chain_fused"] < rep["windows_fused"] or fl["madd_chain_entries"] < len(sizes) - rep["windows_fused"]:
        raise AssertionError(f"node_sync: windows {sizes} but launches {fl}")
    log({"phase": "node_sync", **rep})
    return rep


def run_node(stack, inp, ns: int) -> dict:
    """Phase 13: the port's own node and CLI, each node a process of its
    own started through `python -m tendermint_tpu_torch`: `node_net` runs
    a and b, then `node_sync`. The kernel library was built in phase 0, so
    every process loads it from `build/kernels/`. Launches: the node
    processes' own, each accounted for by its ledger."""
    import tempfile

    dev = stack.inner.primary.device
    warm = warm_launches(dev)
    log({"phase": "node_warm_launches", **warm})
    rep: dict = {"warm_launches": warm}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nodes_") as tmp:
        hook_dir = pathlib.Path(tmp, "hook")
        hook_dir.mkdir()
        write_counts_hook(hook_dir)
        # every home at once: `testnet` for each run of node_net, `init`
        # for node_sync's server and fresh node
        nets: dict = {}
        for run, _mb in NODE_NET_RUNS:
            nets[run] = (pathlib.Path(tmp, f"net_{run}"), free_port_base(2 * NODE_NET_N, [b for _, b in nets.values()]))
        sync_homes = (pathlib.Path(tmp, "sync_server"), pathlib.Path(tmp, "sync_fresh"))
        t0 = time.perf_counter()
        port_cli(*[("testnet", "--n", NODE_NET_N, "--output", out, "--starting-port", base, "--chain-id", NODE_NET_CHAIN)
                   for out, base in nets.values()],
                 *[("init", "--home", home, "--chain-id", SYNC_CHAIN) for home in sync_homes])
        rep["homes_s"] = time.perf_counter() - t0
        rep["net"] = [run_node_net(*nets[run], hook_dir, inp, run, mb, warm) for run, mb in NODE_NET_RUNS]
        rep["sync"] = run_node_sync(stack, *sync_homes, hook_dir, inp, ns, warm)
    steps = [r["launches_total"] for r in rep["net"]] + list(rep["sync"]["launches"].values())
    rep["launches"] = {k: sum(c[k] for c in steps) for k in WRAPPERS}
    log({"phase": "node", "launches": rep["launches"]})
    return rep


BOOK_NODES = 4
BOOK_MIN_BATCH = 0  # the table backend's minimum device batch during the phase
BOOK_EQUIVOCATOR = 3  # the validator that double-signs
BOOK_EVIDENCE_WITHIN = 5  # heights from an equivocation to its evidence's commit
BOOK_TIMEOUT_S = 90.0  # a step's wait for its heights
BOOK_SCENARIO = "slow_wan_validator"


def net_agrees(what: str, nodes) -> int:
    """Every node stores the same block, block hash and app hash at each
    height all of them have; returns that height."""
    top = min(n.store.height for n in nodes)
    for h in range(1, top + 1):
        blocks = [n.store.load_block(h) for n in nodes]
        if len({b.encode() for b in blocks}) != 1 or len({b.hash() for b in blocks}) != 1:
            raise AssertionError(f"testing {what}: the nodes' blocks differ at height {h}")
        if len({b.header.app_hash for b in blocks}) != 1:
            raise AssertionError(f"testing {what}: the nodes' app hashes differ at height {h}")
    return top


def run_testing(stack, sync) -> dict:
    """Phase 14: the port's own nemesis book and one library scenario on
    the card (see the module's docstring). Launches: the book's and the
    scenario's, each held against the launch ledger once its nodes stop."""
    import tempfile

    from tendermint_tpu_torch.testing import Equivocator, Nemesis, wait_evidence_committed
    from tendermint_tpu_torch.testing.byzantine import committed_evidence
    from tendermint_tpu_torch.testing.scenario import SCENARIO_LIBRARY, ScenarioRunner

    backend = stack.inner.primary
    dev = backend.device
    min_batch = backend._min_batch
    health = StackHealth(stack.inner)
    rep: dict = {"nodes": BOOK_NODES, "steps": {}}
    t_phase = time.perf_counter()
    backend._min_batch = BOOK_MIN_BATCH
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_book_") as tmp:
            led = StepLedger("testing", "book")
            with Nemesis(BOOK_NODES, home=os.path.join(tmp, "book"), device=dev) as net:
                if any(n.verifier.inner is not stack.inner for n in net.nodes):
                    raise AssertionError("testing book: a node is not on default_verifier()'s backend")

                def step(name, fn):
                    t0, h0 = time.perf_counter(), max(net.heights())
                    out = fn() or {}
                    rep["steps"][name] = {"s": time.perf_counter() - t0, "from_height": h0,
                                          "to_height": max(net.heights()), **out}
                    log({"phase": "testing_step", "step": name, **rep["steps"][name]})

                step("healthy", lambda: net.wait_height(2, timeout=BOOK_TIMEOUT_S))

                def partition():
                    net.partition({0, 1, 2}, {3})
                    net.wait_progress(delta=2, nodes=[0, 1, 2], timeout=BOOK_TIMEOUT_S)
                    cut = net.nodes[3].store.height
                    net.heal()
                    net.wait_height(max(net.heights()), nodes=[3], timeout=BOOK_TIMEOUT_S)
                    return {"cut_node_height": cut}

                step("partition_heal", partition)

                def crash():
                    net.crash(0)
                    net.corrupt_wal_tail(0, nbytes=32)
                    net.restart(0)
                    net.wait_height(max(net.heights()) + 1, timeout=BOOK_TIMEOUT_S)

                step("crash_wal_replay", crash)

                def equivocate():
                    eq = Equivocator(net, BOOK_EQUIVOCATOR).start()
                    honest = [i for i in range(BOOK_NODES) if i != BOOK_EQUIVOCATOR]
                    try:
                        found = wait_evidence_committed(net, eq.address, nodes=honest,
                                                        within_heights=BOOK_EVIDENCE_WITHIN, timeout=BOOK_TIMEOUT_S)
                    finally:
                        eq.stop()
                    for i, h in found.items():
                        if not any(e.address == eq.address for at, e in committed_evidence(net, i) if at == h):
                            raise AssertionError(f"testing book: node {i} holds no evidence at height {h}")
                    net.wait_progress(delta=1, timeout=BOOK_TIMEOUT_S)
                    return {"equivocations": eq.equivocations, "evidence_heights": sorted(set(found.values()))}

                step("equivocator", equivocate)
            rep["book_top"] = net_agrees("book", net.nodes)
            sync()
            rep["book_launches"] = led.settle()
            led.close()
            led = StepLedger("testing", "scenario")
            runner = ScenarioRunner(home=os.path.join(tmp, "scenario"), device=dev)
            nets: list = []  # the net the runner builds, kept to check its stores after
            build = runner._build_net
            runner._build_net = lambda spec: nets.append(build(spec)) or nets[-1]
            t0 = time.perf_counter()
            report = runner.run(SCENARIO_LIBRARY[BOOK_SCENARIO])
            if not report["ok"]:
                raise AssertionError(f"testing {BOOK_SCENARIO}: {report['failures']}")
            if any(n.verifier.inner is not stack.inner for n in nets[0].nodes):
                raise AssertionError(f"testing {BOOK_SCENARIO}: a node is not on default_verifier()'s backend")
            sync()
            rep["scenario"] = {
                "name": BOOK_SCENARIO, "s": time.perf_counter() - t0, "top": net_agrees(BOOK_SCENARIO, nets[0].nodes),
                "launches": led.settle(), **{k: report[k] for k in ("heights", "finality", "round_skips",
                                                                     "round_skips_post_warm", "propose_timeout_s",
                                                                     "max_one_way_delay_s") if k in report},
            }
            led.close()
            log({"phase": "testing_scenario", **rep["scenario"]})
    finally:
        backend._min_batch = min_batch
    health.check("testing")
    for name, c in (("book", rep["book_launches"]), (BOOK_SCENARIO, rep["scenario"]["launches"])):
        _launched(c, ("ladder", "madd_chain_entries", "finish_encode_compare"), name, phase="testing")
    jax = sorted(m for m in sys.modules if m in ("jax", "tendermint_tpu") or m.startswith(("jax.", "tendermint_tpu.")))
    if jax:
        raise AssertionError(f"testing: the process imported {jax[:5]}")
    rep["launches"] = {k: rep["book_launches"][k] + rep["scenario"]["launches"][k] for k in WRAPPERS}
    rep["s"] = time.perf_counter() - t_phase
    log({"phase": "testing", "s": rep["s"], "book_top": rep["book_top"], "launches": rep["launches"]})
    return rep


TOOLS_NODES = 4
TOOLS_CHAIN = "chip-smoke-tools"
TOOLS_MIN_BATCH = 0  # the table backend's minimum device batch, as in phase 14
# (a) the in-process load generator: signed envelopes at 2,000 tx/s
TOOLS_LOADGEN = ("--signed", "--signers", "64", "--threads", "16", "--duration", "3", "--rate", "2000")
# the same tool as a child process on the card, signed and at the minimum
# device batch 0 so that it launches
TOOLS_CHILD_LOADGEN = ("--device", "cuda", "--signed", "--rate", "500", "--duration", "2")
# (b) the testnet's load: signed writes at node 0, then reads over all four
TOOLS_WRITES = ("--signed", "--rate", "200", "--duration", "5")
TOOLS_READS = ("--reads", "--walk-prob", "0.1", "--rate", "50", "--duration", "3")
TOOLS_NET_ENV = {"TENDERMINT_TPU_MIN_DEVICE_BATCH": "0", "TENDERMINT_TPU_PROFILE_HZ": "29"}
TOOLS_COMMIT_HEIGHTS = 2  # heights every node commits past the load, so that its txs are in blocks
TOOLS_RPC_LAUNCHES = 1 << 20  # `--launches`: every record a node's ring holds (1,024)
# a report's fetch of a loaded node's `dump_telemetry` view: the phase calls
# the tools' fetch functions with this limit (theirs is 30 s) and records
# each fetch's seconds, so that a slow view shows as a number
TOOLS_RPC_TIMEOUT_S = 120.0
TOOLS_TIMEOUT_S = 180.0
TOOLS_LOGS = "tools"  # OUT/tools/: the child tools' output


def tool_main(main, argv) -> tuple[int, str]:
    """A tool's `main(argv)` in this process: its exit code and stdout."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    return rc, buf.getvalue()


def loadgen_summary(what: str, rc: int, text: str, reads: bool = False) -> dict:
    """The load generator's JSON line: every arrival resolved, every
    write admitted (`ok`), no read an error."""
    lines = [line for line in text.splitlines() if line.startswith("{")]
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"tools {what}: loadgen exited {rc} with {text[-2000:]}")
    out = json.loads(lines[0])
    bad = "error" in out["outcomes"] if reads else set(out["outcomes"]) != {"ok"}
    if out["resolved"] != out["submitted"] or bad:
        raise AssertionError(f"tools {what}: {out}")
    return out


def tool_child(name: str, args, hook_dir, env=None) -> tuple:
    """`python -m tendermint_tpu_torch.tools.<name> <args>` started on the
    counts hook's path (its kernel launches and any module of jax it
    imported are read at its exit), with `env` added to its environment."""
    # absolute: the child runs in the checkout, this process where it was started
    counts_path = str((OUT / TOOLS_LOGS / f"{name}.counts.json").resolve())
    env = dict(os.environ, **(env or {}), PYTHONPATH=os.pathsep.join([str(hook_dir), str(REPO)]))
    env[NODE_COUNTS_ENV] = counts_path
    (OUT / TOOLS_LOGS).mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen([sys.executable, "-m", f"tendermint_tpu_torch.tools.{name}", *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return name, proc, counts_path, time.perf_counter()


def join_child(child, timeout: float) -> tuple[str, dict]:
    """The child tool's stdout and launch counts, once it exited 0 having
    imported nothing of jax."""
    name, proc, counts_path, t0 = child
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate(timeout=NODE_STOP_TIMEOUT_S)
        raise AssertionError(f"tools: {name} did not end in {timeout} s")
    (OUT / TOOLS_LOGS / f"{name}.out").write_text(out)
    (OUT / TOOLS_LOGS / f"{name}.err").write_text(err)
    if proc.returncode != 0:
        raise AssertionError(f"tools: {name} exited {proc.returncode}: {err[-2000:]}")
    with open(counts_path) as f:
        hook = json.load(f)
    if hook["foreign"]:
        raise AssertionError(f"tools: {name} imported {hook['foreign'][:5]}")
    return out, {"s": time.perf_counter() - t0, "launches": hook["counts"]}


def record_key(r: dict) -> tuple:
    """`device_report`'s key of a launch record."""
    return (r.get("t"), r.get("kind"), r.get("rows"), r.get("queue"))


def tools_device_reports(homes, rpc_records: dict, tmp) -> dict:
    """`device_report` over each home's `launches.jsonl` and over what the
    node's RPC served: each file's per-kind rollup is the ledger's
    `summarize()`, the RPC's is the file's over the same records, and the
    fleet's totals are the nodes' sum."""
    from tendermint_tpu_torch.telemetry.launchlog import summarize
    from tendermint_tpu_torch.tools import device_report

    out: dict = {}
    paths = [str(pathlib.Path(home, "data", LEDGER_FILE)) for home in homes]
    for i, path in enumerate(paths):
        js = pathlib.Path(tmp, f"device_report{i}.json")
        rc, text = tool_main(device_report.main, ["--ledgers", path, "--json", str(js)])
        report = json.loads(js.read_text())
        recs = node_ledger(homes[i])
        if rc != 0 or report["kinds"] != json.loads(json.dumps(summarize(recs))) or report["launches"] != len(recs):
            raise AssertionError(f"tools device_report: node {i}'s report {report['kinds']} is not its ledger's "
                                 f"summarize() of {len(recs)} records")
        served = {record_key(r) for r in rpc_records[i]}
        same = [r for r in recs if record_key(r) in served]
        rpc = device_report.build_report(rpc_records[i])
        if len(same) != len(served) or rpc["kinds"] != device_report.build_report(same)["kinds"]:
            raise AssertionError(f"tools device_report: node {i}'s RPC served records its ledger file does not "
                                 f"hold, or they roll up differently")
        out[f"node{i}"] = {"launches": report["launches"], "rpc_launches": rpc["launches"],
                           "verdict": report["verdict"]["top_waste_source"] if report["verdict"] else None,
                           "kinds": {k: agg["launches"] for k, agg in report["kinds"].items()}}
    rc, text = tool_main(device_report.main, ["--ledgers", *paths])
    if rc != 0 or "verdict: top waste source is" not in text:
        raise AssertionError(f"tools device_report: the fleet's report names no waste source: {text[-2000:]}")
    (OUT / TOOLS_LOGS / "device_report.txt").write_text(text)
    out["fleet_text_lines"] = len(text.splitlines())
    return out


def tools_finality(homes, tops) -> dict:
    """`finality_report` over the four `heights.jsonl`: each node's record
    of every height it committed (`tops`: each node's height before it
    stopped), and every node's row at each height all of them reached."""
    from tendermint_tpu_torch.tools import finality_report

    paths = [str(pathlib.Path(home, "data", "heights.jsonl")) for home in homes]
    for i, path in enumerate(paths):
        hs = {r["height"] for r in finality_report.load_records([path])}
        if not hs or hs != set(range(1, max(hs) + 1)) or max(hs) < tops[i]:
            raise AssertionError(f"tools finality_report: node {i}'s ledger holds heights {sorted(hs)}, "
                                 f"it committed 1-{tops[i]}")
    rc, text = tool_main(finality_report.main, ["--ledgers", *paths, "--json"])
    report = json.loads(text)
    short = [h for h in range(1, min(tops) + 1) if len(report["heights"].get(str(h), ())) != len(homes)]
    if rc != 0 or short:
        raise AssertionError(f"tools finality_report: heights {short} lack a node's row")
    rc, text = tool_main(finality_report.main, ["--ledgers", *paths])
    (OUT / TOOLS_LOGS / "finality_report.txt").write_text(text)
    return {"heights": len(report["heights"]), **report["summary"]}


def tools_trace(homes) -> dict:
    """`trace_timeline --trace` over the nodes' `spans.jsonl`: a tx
    broadcast at node 0, from its admission there to its commit, on more
    than one node."""
    from tendermint_tpu_torch.tools import trace_timeline

    spans = [str(pathlib.Path(home, "data", SPANS_FILE)) for home in homes]
    loaded = trace_timeline.load_spans(spans)
    admitted = {s["attrs"]["trace"] for s in loaded if s["name"] == "mempool.admission" and "trace" in s["attrs"]}
    committed = {s["attrs"]["trace"] for s in loaded if s["name"] == "tx.e2e" and "trace" in s["attrs"]}
    for trace in sorted(admitted & committed):
        rc, text = tool_main(trace_timeline.main, ["--spans", *spans, "--trace", trace, "--json"])
        tl = json.loads(text)
        if rc == 0 and {"admission", "commit"} <= set(tl["stages"]) and len(tl["nodes"]) >= 2:
            rc, text = tool_main(trace_timeline.main, ["--spans", *spans, "--trace", trace])
            (OUT / TOOLS_LOGS / "trace_timeline.txt").write_text(text)
            entries = tl["entries"]
            return {"trace": trace, "traced_txs_committed": len(admitted & committed), "stages": tl["stages"],
                    "nodes": len(tl["nodes"]), "spans": tl["span_count"],
                    "ingress_to_commit_s": max(e["end"] for e in entries) - min(e["t"] for e in entries)}
    raise AssertionError(f"tools trace_timeline: no traced tx ({len(admitted)} admitted, {len(committed)} "
                         f"committed) runs from its admission to its commit across the nodes")


def run_tools_net(out_dir, base: int, hook_dir, warm: dict) -> dict:
    """Phase 15 (b): four `node` processes from `testnet --n 4` on the
    card, loaded by the port's load generator over RPC and read by every
    report (see the module's docstring)."""
    from tendermint_tpu_torch.tools import contention_report, device_report, gossip_report, loadgen

    homes = [out_dir / f"node{i}" for i in range(TOOLS_NODES)]
    nodes = [NodeProcess(f"tools_node{i}", homes[i], hook_dir, env=TOOLS_NET_ENV) for i in range(TOOLS_NODES)]
    ports = [base + 2 * i + 1 for i in range(TOOLS_NODES)]
    addrs = [f"127.0.0.1:{p}" for p in ports]
    clients = [node_client(p) for p in ports]
    rep: dict = {"nodes": TOOLS_NODES}
    tmp = out_dir / "reports"  # the reports' --json files
    tmp.mkdir()
    try:
        for nd in nodes:
            nd.start()
        rep["up_s"] = [nd.wait_up() for nd in nodes]
        # the load meets warm nodes: each node's kernels' warm-up has ended
        # (a node on the card warms up; one on the CPU does not)
        if any(warm.values()):
            wait_nodes(nodes, lambda: all(os.path.exists(nd.warm_mark) for nd in nodes), "every node's warm-up",
                       TOOLS_TIMEOUT_S)
        rep["warm_s"] = time.perf_counter() - min(nd.started_at for nd in nodes)
        wait_nodes(nodes, lambda: min(node_heights(clients)) >= 1, "a first height on every node", TOOLS_TIMEOUT_S)
        h0, t0 = node_heights(clients), time.perf_counter()
        rep["writes"] = loadgen_summary("writes", *tool_main(loadgen.main, ["--rpc", addrs[0], *TOOLS_WRITES]))
        secs = time.perf_counter() - t0
        h1 = node_heights(clients)
        rep["load_heights_per_s"] = (min(h1) - min(h0)) / secs
        rep["load_s"], rep["load_heights"] = secs, (h0, h1)
        led = StepLedger("tools", "reads")
        rep["reads"] = loadgen_summary("reads", *tool_main(loadgen.main, ["--rpc", ",".join(addrs), *TOOLS_READS]),
                                       reads=True)
        if not rep["reads"]["outcomes"].get("walk"):
            raise AssertionError(f"tools reads: no walk ran: {rep['reads']}")
        rep["reads_launches"] = led.settle()
        led.close()
        target = max(h1) + TOOLS_COMMIT_HEIGHTS
        wait_nodes(nodes, lambda: min(node_heights(clients)) >= target, f"height {target} on every node",
                   TOOLS_TIMEOUT_S)
        # the reports that read the nodes' RPC, through each tool's own
        # fetch, build and render functions (its `main --rpc`, with a
        # longer limit on the fetch)
        views, rep["rpc_fetch_s"] = [], {"gossip": [], "profile": [], "launches": []}
        for addr in addrs:
            t1 = time.perf_counter()
            views.append(gossip_report.fetch_gossip_rpc(addr, timeout=TOOLS_RPC_TIMEOUT_S))
            rep["rpc_fetch_s"]["gossip"].append(time.perf_counter() - t1)
        gossip = gossip_report.build_report(views)
        if gossip["nodes"] != TOOLS_NODES or not gossip["verdict"]:
            raise AssertionError(f"tools gossip_report: {gossip_report.render_text(gossip)}")
        (OUT / TOOLS_LOGS / "gossip_report.txt").write_text(gossip_report.render_text(gossip))
        rep["gossip"] = {"top_waste_source": gossip["verdict"]["top_waste_source"],
                         "cost_bytes": gossip["verdict"]["cost_bytes"], "total_bytes": gossip["total_bytes"]}
        rep["contention"] = []
        for i, addr in enumerate(addrs):
            t1 = time.perf_counter()
            profile = contention_report._profile_of(
                contention_report.fetch_profile_rpc(addr, timeout=TOOLS_RPC_TIMEOUT_S))
            rep["rpc_fetch_s"]["profile"].append(time.perf_counter() - t1)
            cont = contention_report.build_report(profile)
            text = contention_report.render_text(cont)
            # its top source: the verdict's subsystem where a thread was
            # sampled on the CPU, else the dominant blocked subsystem
            top = (cont["verdict"] or {}).get("move_out_first") or (cont["dominant_blocked_subsystem"] or {}).get(
                "subsystem")
            if not cont["samples"] or not top:
                raise AssertionError(f"tools contention_report: node {i}: {text[-2000:]}")
            (OUT / TOOLS_LOGS / f"contention_report{i}.txt").write_text(text)
            rep["contention"].append({
                "samples": cont["samples"], "on_cpu": sum(r["on_cpu"] for r in cont["waterfall"]),
                "move_out_first": (cont["verdict"] or {}).get("move_out_first"),
                "dominant_blocked": (cont["dominant_blocked_subsystem"] or {}).get("subsystem"),
                "most_contended_lock": (cont["most_contended_lock"] or {}).get("lock")})
        rpc_records = {}
        for i, addr in enumerate(addrs):
            t1 = time.perf_counter()
            rpc_records[i] = device_report.fetch_launches_rpc(addr, n=TOOLS_RPC_LAUNCHES, timeout=TOOLS_RPC_TIMEOUT_S)
            rep["rpc_fetch_s"]["launches"].append(time.perf_counter() - t1)
        top = min(node_heights(clients))
        same_chain("tools", clients, top)
        rep["app_hashes"] = same_app_hash("tools", clients)
        rep["health"] = [node_device_health(nd.name, c) for nd, c in zip(nodes, clients)]
        tops = node_heights(clients)
        got = stop_all(nodes, warm)
    finally:
        for nd in nodes:
            nd.reap()
    rep["committed"] = tops
    rep["launches_by_node"] = {nd.name: node_account(nd.name, got[nd.name], warm, node_ledger(nd.home), TOOLS_NODES)
                               for nd in nodes}
    rep["device_report"] = tools_device_reports(homes, rpc_records, tmp)
    rep["finality"] = tools_finality(homes, tops)
    rep["trace"] = tools_trace(homes)
    rep["launches_total"] = {k: sum(c[k] for c in rep["launches_by_node"].values()) for k in WRAPPERS}
    if any(c["ladder"] == 0 or c["madd_chain_entries"] == 0 for c in rep["launches_by_node"].values()):
        raise AssertionError(f"tools net: at minimum batch 0 every node launches `ladder` and the entries chain: "
                             f"{rep['launches_by_node']}")
    log({"phase": "tools_net", **{k: v for k, v in rep.items() if k not in ("app_hashes",)}})
    return rep


def run_tools(stack, sync) -> dict:
    """Phase 15: the port's operator tools on the card (see the module's
    docstring). Launches: the in-process load generator's and walks', the
    node processes' and the child tools'."""
    import tempfile

    from tendermint_tpu_torch.tools import loadgen

    backend = stack.inner.primary
    dev = backend.device
    min_batch = backend._min_batch
    health = StackHealth(stack.inner)
    rep: dict = {}
    t_phase = time.perf_counter()
    warm = warm_launches(dev)
    backend._min_batch = TOOLS_MIN_BATCH
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
            hook_dir = pathlib.Path(tmp, "hook")
            hook_dir.mkdir()
            write_counts_hook(hook_dir)
            # (a) the load generator in this process, on default_verifier()
            led = StepLedger("tools", "loadgen")
            t0 = time.perf_counter()
            lg = loadgen_summary("loadgen", *tool_main(loadgen.main, TOOLS_LOADGEN))
            sync()
            lg["s"] = time.perf_counter() - t0
            lg["launches"] = led.settle()
            led.close()
            _launched(lg["launches"], ("ladder", "finish_encode_compare"), "loadgen", phase="tools")
            rep["loadgen"] = lg
            log({"phase": "tools_loadgen", **lg})
            # the homes of (b), while the child tools start on the card
            out_dir, base = pathlib.Path(tmp, "net"), free_port_base(2 * TOOLS_NODES)
            children = [tool_child("loadgen", TOOLS_CHILD_LOADGEN, hook_dir,
                                   env={"TENDERMINT_TPU_MIN_DEVICE_BATCH": str(TOOLS_MIN_BATCH)}),
                        tool_child("statesync_demo", ("--device", "cuda"), hook_dir)]
            try:
                port_cli(("testnet", "--n", TOOLS_NODES, "--output", out_dir, "--starting-port", base,
                          "--chain-id", TOOLS_CHAIN))
                (lg_out, lg_child), (sd_out, sd_child) = (join_child(c, TOOLS_TIMEOUT_S) for c in children)
            finally:
                for _name, proc, _path, _t in children:
                    if proc.poll() is None:
                        proc.kill()
            lg_child.update(loadgen_summary("loadgen child", 0, lg_out))
            _launched(lg_child["launches"], ("ladder", "finish_encode_compare"), "loadgen child", phase="tools")
            sd = json.loads(sd_out[sd_out.index("{"):])
            if "RESTORE FAILED" in sd_out or sd["restores_ok"] < 1 or sd["synced_height"] <= sd["snapshot_height"]:
                raise AssertionError(f"tools statesync_demo: {sd_out[-2000:]}")
            sd_child.update(sd)
            rep["children"] = {"loadgen": lg_child, "statesync_demo": sd_child}
            log({"phase": "tools_children", **rep["children"]})
            # (b) a port testnet under the tools
            rep["net"] = run_tools_net(out_dir, base, hook_dir, warm)
    finally:
        backend._min_batch = min_batch
    health.check("tools")
    jax = sorted(m for m in sys.modules if m in ("jax", "tendermint_tpu") or m.startswith(("jax.", "tendermint_tpu.")))
    if jax:
        raise AssertionError(f"tools: the process imported {jax[:5]}")
    steps = [rep["loadgen"]["launches"], rep["net"]["reads_launches"], rep["net"]["launches_total"],
             *(c["launches"] for c in rep["children"].values())]
    rep["launches"] = {k: sum(c[k] for c in steps) for k in WRAPPERS}
    rep["s"] = time.perf_counter() - t_phase
    log({"phase": "tools", "s": rep["s"], "launches": rep["launches"]})
    return rep


MESH_SHARDS = 4
MESH_REPS = 3  # timed calls a step, median
MESH_REPROBE_S = 0.2
MESH_EXHAUST_KEYS = 512


def mesh_devices() -> tuple[list, str]:
    """Four shards: one a card when four cards are visible, else all four
    on the first card (the times then measure the choreography, not a
    speed-up)."""
    import torch

    if torch.cuda.device_count() >= MESH_SHARDS:
        return [torch.device("cuda", i) for i in range(MESH_SHARDS)], f"cuda:0..{MESH_SHARDS - 1}, one shard a card"
    return [torch.device("cuda", 0)] * MESH_SHARDS, (
        f"cuda:0 x {MESH_SHARDS}: {MESH_SHARDS} shards on one card; the times measure the choreography, "
        "not a speed-up"
    )


MESH_COUNTERS = {
    "shard_faults": ("tendermint_mesh_shard_faults_total", {}),
    "shrinks": ("tendermint_mesh_remesh_total", {"direction": "shrink"}),
    "restores": ("tendermint_mesh_remesh_total", {"direction": "restore"}),
    "verify_fallbacks": ("tendermint_device_fallback_calls_total", {"kind": "verify"}),
    "hash_fallbacks": ("tendermint_device_fallback_calls_total", {"kind": "hash"}),
}


class MeshHealth:
    """The mesh's shard faults and re-meshes and the resilient layers'
    host fallbacks, read before and after each step: a step fails on any
    it did not inject."""

    def __init__(self):
        self.base = self.read()

    @staticmethod
    def read() -> dict:
        return {k: _counter(name, **labels) for k, (name, labels) in MESH_COUNTERS.items()}

    def check(self, what: str, **expect) -> None:
        now = self.read()
        moved = {k: now[k] - self.base[k] for k in now if now[k] != self.base[k]}
        if moved != expect:
            raise AssertionError(f"mesh {what}: counters moved {moved}, expected {expect}")
        self.base = now


def device_state(devices) -> dict:
    """The per-device state the wrappers keep, after the mesh ran: a
    finish scratch word a (card, stream) and the constants a card, on
    every card of the mesh."""
    from tendermint_tpu_torch.ops.ed25519_kernel import _CONSTS
    from tendermint_tpu_torch.ops.ed25519_tables import _FINISH_SCRATCH

    cards = {d.index for d in devices}
    scratch = sorted(k for k in _FINISH_SCRATCH if k[0] in cards)
    consts = sorted({k[-1] for k in _CONSTS if isinstance(k[-1], str) and k[-1].startswith("cuda")})
    if {k[0] for k in scratch} != cards or any(str(d) not in consts for d in devices):
        raise AssertionError(f"mesh: finish scratch words {scratch}, constants on {consts}, cards {sorted(cards)}")
    return {"finish_scratch": [list(k) for k in scratch], "constants_on": consts}


def mesh_stage_times(verifier, pubs, commits, sync) -> dict:
    """Seconds of each stage of one call of the table path over the
    mesh, every card synchronised after each: host prep (the lanes and
    their mask), the shard-major reorder, the step (copies in, the
    kernels a shard, the tally), the copy back with the inverse
    reorder."""
    from tendermint_tpu_torch.ops.ed25519_tables import prepare_commit_lanes
    from tendermint_tpu_torch.parallel.mesh import (
        gather_verdicts,
        shard_lanes_validator_major,
        unshard_lanes_validator_major,
    )

    out = {}
    clock = [time.perf_counter()]

    def mark(name):
        sync()
        now = time.perf_counter()
        out[name] = now - clock[0]
        clock[0] = now

    n, k = len(pubs), len(commits)
    devices = verifier.mesh.active_devices()
    tables, key_ok = verifier._tables_for_mesh(tuple(pubs), devices)
    mark("placement_lookup_s")
    s, h, r, pre = prepare_commit_lanes(pubs, commits)
    lane_ok = pre & np.tile(key_ok, k)
    mark("host_prep_s")
    lanes = shard_lanes_validator_major([s, h, r, lane_ok, np.ones(k * n, dtype=np.int32)], n, len(devices))
    mark("reorder_s")
    ok, _total = verifier.mesh.tables_step()(tables, *lanes)
    mark("step_s")
    unshard_lanes_validator_major(gather_verdicts(ok), n, len(devices))
    mark("copy_back_s")
    return out


def run_mesh(inp, bare, commit, window, flat, hashed) -> dict:
    """Phase 7: the main path's work through the mesh classes over
    MESH_SHARDS shards (`mesh_devices`): the 10k commit through
    `ShardedTableBatchVerifier` (N/4 table columns and the entries chain
    a shard), the window (the fused chain a shard), the flat batch
    through `ShardedBatchVerifier` (1,024 lanes a shard on the ladder)
    and its tally, 64 zero rows, the data_hash through
    `TreeHasher(mesh=)`; a fault drill (shard 2 out and back, every shard
    out on a 512-validator set); the multi-host seam in one process.
    `bare` is the bare phases' table backend, whose calls are timed in
    turns with the mesh's; `commit`, `window`, `flat` are the earlier
    phases' inputs with their expected masks and bare medians, `hashed`
    the hash phase's block, roots and medians. Each step's launches are
    zeroed just before each of its mesh calls and read just after, and
    stand on its own line only: the kernels line keeps the bare phases'
    counts."""
    import hashlib

    import torch

    from tendermint_tpu_torch.ops.ed25519_kernel import bucket_size, prepare_batch
    from tendermint_tpu_torch.parallel import distributed as dist
    from tendermint_tpu_torch.parallel import mesh as mesh_mod
    from tendermint_tpu_torch.parallel.mesh import BATCH_AXIS, MeshManager, gather_verdicts
    from tendermint_tpu_torch.services.hasher import TreeHasher
    from tendermint_tpu_torch.services.resilient import ResilientVerifier
    from tendermint_tpu_torch.services.verifier import ShardedBatchVerifier, ShardedTableBatchVerifier
    from tendermint_tpu_torch.telemetry.flightrec import FLIGHT
    from tendermint_tpu_torch.utils import fail

    devices, layout = mesh_devices()
    rep: dict = {"devices": [str(d) for d in devices], "layout": layout}

    def sync():
        for d in dict.fromkeys(devices):
            torch.cuda.synchronize(d)
    mesh = MeshManager(devices=devices, reprobe_s=MESH_REPROBE_S)
    tv = ShardedTableBatchVerifier(mesh=mesh)
    fv = ShardedBatchVerifier(mesh=mesh)
    health = MeshHealth()
    placements = "tendermint_table_device_cache_total"
    fail.clear_device_faults()

    # 0. the warm-up over every card of the mesh, then the 10k table build
    t0 = time.perf_counter()
    thread = tv.warm_kernels()
    thread.join(timeout=300)
    cold = [d for d in dict.fromkeys(devices) if d.type == "cuda" and d not in mesh_mod._WARMED]
    if thread.is_alive() or cold:
        raise AssertionError(f"mesh warm: the thread is alive: {thread.is_alive()}, cards not warmed: {cold}")
    rep["warm_s"] = time.perf_counter() - t0
    pubs, commits, expected, bare_s = commit
    rep["table_build_s"] = timed(lambda: tv.tables_for(tuple(pubs)), sync)
    log({"phase": "mesh", "step": "setup", **rep})

    def sharded(what, fn, check, launches_each: dict, bare_fn, bare: float, led: StepLedger) -> dict:
        """One cold call, then MESH_REPS timed calls in turns with the
        bare backend's call on the same work, each checked; each mesh call
        launches `launches_each` (one a shard for a sharded kernel); every
        call is held to its ledger records (`led`)."""
        outs = []
        cold_s = timed(lambda: outs.append(led.call(fn)), sync)
        led.call(bare_fn)  # its cold call, untimed
        c = dict.fromkeys(counts(), 0)
        warm, here = [], []
        for _ in range(MESH_REPS):
            reset_counts()
            warm.append(timed(lambda: outs.append(led.call(fn)), sync))
            c = {name: c[name] + v for name, v in counts().items()}
            here.append(timed(lambda: led.call(bare_fn), sync))
        for out in outs:
            check(out)
        want = {name: each * MESH_REPS for name, each in launches_each.items()}
        if any(c[name] != v for name, v in want.items()):
            raise AssertionError(f"mesh {what}: launches {c} in {MESH_REPS} calls, expected {want}")
        row = {"cold_s": cold_s, "s_median": statistics.median(warm), "s": warm,
               "bare_s_median_in_turns": statistics.median(here), "bare_s_in_turns": here,
               "bare_s_median": bare, "launches": c}
        log({"phase": "mesh", "step": what, **row})
        return row

    def mask_of(what, expected_mask):
        return lambda got: check_mask(f"mesh {what}", got, expected_mask)

    # 1. the 10k commit: N/4 columns a shard, the entries chain a shard
    n = len(pubs)
    miss0, hit0 = _counter(placements, result="miss"), _counter(placements, result="hit")
    led = StepLedger("mesh", "commit")
    rep["commit"] = sharded("commit", lambda: tv.verify_commits(pubs, commits), mask_of("commit", expected[None, :]),
                            {"madd_chain_entries": MESH_SHARDS, "finish_encode_compare": MESH_SHARDS},
                            lambda: bare.verify_commits(pubs, commits), bare_s, led)
    # the placement-cache miss shipped the 10k set's table columns: its
    # bytes are on the cold call's ledger record
    shipped = max(r.get("transfer_bytes", 0) for r in led.records())
    placed = tv._sharded_tables[(tv._cache_key(tuple(pubs)), mesh.active_devices())]
    rep["commit"]["placed_bytes"] = [t.numel() * t.element_size() for t in placed]
    if [t.shape[3] for t in placed] != [n // MESH_SHARDS] * MESH_SHARDS or [t.device for t in placed] != devices:
        raise AssertionError(f"mesh commit: placed slices {[(tuple(t.shape), str(t.device)) for t in placed]}")
    moved = (_counter(placements, result="miss") - miss0, _counter(placements, result="hit") - hit0)
    if moved != (1, MESH_REPS):
        raise AssertionError(f"mesh commit: placement cache (misses, hits) {moved}, expected (1, {MESH_REPS})")
    if shipped < sum(rep["commit"]["placed_bytes"]):
        raise AssertionError(f"mesh commit: the ledger's largest transfer {shipped} B is under the placed tables'")
    health.check("commit")
    rep["commit"]["ledger"] = led.close()

    # 2. the fast-sync window: N/4 columns a shard, the fused chain a shard
    pubs3, commits3, expected3, bare3 = window
    led = StepLedger("mesh", "window")
    rep["window"] = sharded("window", lambda: tv.verify_commits(pubs3, commits3), mask_of("window", expected3),
                            {"madd_chain_fused": MESH_SHARDS, "finish_encode_compare": MESH_SHARDS},
                            lambda: bare.verify_commits(pubs3, commits3), bare3, led)
    rep["window"]["commits_per_s"] = len(commits3) / rep["window"]["s_median"]
    health.check("window")
    rep["window"]["ledger"] = led.close()

    # 3. the flat batch: 1,024 lanes a shard on the ladder, then its tally
    triples, expected4, bare4 = flat
    nf = len(triples)
    if bucket_size(-(-nf // MESH_SHARDS)) * MESH_SHARDS != nf:
        raise AssertionError(f"mesh flat: {nf} lanes do not fill {MESH_SHARDS} shard buckets")
    led = StepLedger("mesh", "flat")
    rep["flat"] = sharded("flat", lambda: fv.verify_batch(triples), mask_of("flat", expected4),
                          {"ladder": MESH_SHARDS, "finish_encode_compare": MESH_SHARDS},
                          lambda: bare.verify_batch(triples), bare4, led)
    rep["flat"]["verifies_per_s"] = nf / rep["flat"]["s_median"]
    powers = np.random.default_rng(inp.seed).integers(1, 1000, nf).astype(np.int32)
    mask, tally = led.call(lambda: fv.verify_batch_with_powers(triples, powers))
    check_mask("mesh flat tally", mask, expected4)
    want_tally = int(powers[expected4].sum())
    if tally != want_tally:
        raise AssertionError(f"mesh flat tally: {tally}, the host sum over the expected mask is {want_tally}")
    rep["flat"]["tally"] = tally
    health.check("flat")
    rep["flat"]["ledger"] = led.close()

    # 4. zero rows verify false and tally 0 (the padding relies on it)
    zeros = np.zeros((64, 32), dtype=np.uint8)
    reset_counts()
    ok, total = mesh.verify_step()(zeros, zeros, zeros, zeros, np.zeros(64, dtype=np.int32))
    zero_ok = gather_verdicts(ok)
    c = counts()
    if zero_ok.shape != (64,) or zero_ok.any() or int(total) != 0 or c["ladder"] != MESH_SHARDS:
        raise AssertionError(f"mesh zero rows: {int(zero_ok.sum())} true of {zero_ok.shape}, tally {int(total)}, "
                             f"{c['ladder']} ladder launches")
    rep["zero_rows"] = {"rows": 64, "true": 0, "tally": 0, "launches": c}
    log({"phase": "mesh", "step": "zero_rows", **rep["zero_rows"]})
    drop_stale_record()

    # 5. data_hash through TreeHasher(mesh=): the leaf pass a shard, the
    # levels on the first card; roots bit-equal to phase 5's
    txs, roots, bare_hash = hashed
    levels = len(txs).bit_length() - 1
    rep["data_hash"] = {}
    led = StepLedger("mesh", "data_hash")
    for algo in ("sha256", "ripemd160"):
        th = TreeHasher(algo=algo, mesh=mesh)
        one = TreeHasher(algo=algo, device=devices[0])

        def same_root(got, algo=algo):
            if got != roots[algo]:
                raise AssertionError(f"mesh data_hash {algo}: the root differs from phase 5's")

        rep["data_hash"][algo] = sharded(f"data_hash {algo}", lambda: th.root_from_items(txs), same_root,
                                         {LEAF_KERNEL[algo]: MESH_SHARDS, "merkle_level": levels},
                                         lambda: one.root_from_items(txs), bare_hash[algo], led)
    reset_counts()
    leaves = led.call(lambda: TreeHasher(mesh=mesh).leaf_hashes(txs))
    c = counts()
    if leaves != [hashlib.sha256(b"\x00" + tx).digest() for tx in txs] or c["sha256_masked"] != MESH_SHARDS:
        raise AssertionError(f"mesh leaf_hashes: differ from hashlib or launched {c['sha256_masked']} times")
    health.check("data_hash")
    rep["data_hash"]["ledger"] = led.close()
    rep["stages"] = {"commit": mesh_stage_times(tv, pubs, commits, sync),
                     "window": mesh_stage_times(tv, pubs3, commits3, sync)}
    drop_stale_record()
    log({"phase": "mesh", "step": "stages", **rep["stages"]})

    rep["per_device_state"] = device_state(devices)

    # 6. the fault drill: shard 2 out; the flat batch on the 3 survivors,
    # the window and the 10k commit on the one-card path (N % 3 != 0);
    # the full mesh back after the re-probe window
    drill: dict = {}
    led = StepLedger("mesh", "faults")
    t_wall = time.time()
    fail.set_device_fault("shard2")
    reset_counts()
    check_mask("mesh faulted flat", led.call(lambda: fv.verify_batch(triples)), expected4)
    c_flat = counts()
    if mesh.active_indices() != (0, 1, 3) or c_flat["ladder"] != MESH_SHARDS - 1:
        raise AssertionError(f"mesh faults: active {mesh.active_indices()}, {c_flat['ladder']} ladder launches")
    health.check("shard fault", shard_faults=1, shrinks=1)
    reset_counts()
    check_mask("mesh faulted window", led.call(lambda: tv.verify_commits(pubs3, commits3)), expected3)
    c_win = counts()
    reset_counts()
    check_mask("mesh faulted commit", led.call(lambda: tv.verify_commits(pubs, commits)), expected[None, :])
    c_commit = counts()
    if c_win["madd_chain_fused"] != 1 or c_commit["madd_chain_entries"] != 1:
        raise AssertionError(f"mesh faults: the one-card path launched {c_win}, {c_commit}")
    health.check("one-card path")
    fail.clear_device_faults()
    time.sleep(MESH_REPROBE_S * 1.5)
    reset_counts()
    check_mask("mesh restored flat", led.call(lambda: fv.verify_batch(triples)), expected4)
    c_back = counts()
    if mesh.n_active != MESH_SHARDS or c_back["ladder"] != MESH_SHARDS:
        raise AssertionError(f"mesh faults: {mesh.n_active} active after the re-probe, {c_back['ladder']} launches")
    health.check("restore", restores=1)
    drill["shard2"] = {"flat_launches": c_flat, "window_launches": c_win, "commit_launches": c_commit,
                       "restored_launches": c_back}

    # every shard out on a 512-validator set through the flat mesh lanes
    # (the table path would leave the mesh for one card at the first
    # fault, 512 % 3 != 0): MeshExhaustedError reaches the breaker, the
    # host answers exactly, no verify kernel launches
    p5, m5, s5, e5 = make_commit(inp, list(range(MESH_EXHAUST_KEYS)), {"forged": 7})  # all present: >= 512 lanes
    mesh5 = MeshManager(devices=devices, reprobe_s=60.0)
    rv = ResilientVerifier(ShardedBatchVerifier(mesh=mesh5), max_retries=0)
    for i in range(MESH_SHARDS):
        fail.set_device_fault(f"shard{i}")
    reset_counts()
    t0 = time.perf_counter()
    out = led.call(lambda: rv.verify_commits(p5, [(m5, s5)]))
    host_s = time.perf_counter() - t0
    c = counts()
    fail.clear_device_faults()
    check_mask("mesh exhausted", out, e5[None, :])
    snap = rv.snapshot()
    if (mesh5.n_active, snap["fallback_calls"], snap["total_failures"]) != (0, 1, 1) or sum(c[x] for x in VERIFY_KERNELS):
        raise AssertionError(f"mesh exhaustion: active {mesh5.n_active}, breaker {snap}, launches {c}")
    health.check("exhaustion", shard_faults=MESH_SHARDS, shrinks=MESH_SHARDS - 1, verify_fallbacks=1)
    drill["exhausted"] = {"validators": MESH_EXHAUST_KEYS, "host_s": host_s, "breaker": snap}
    # the black box holds the drill: shard 2 out and back, then every
    # shard of the exhaustion set out
    events = [(e["event"], e.get("shard"), e.get("recovered")) for e in FLIGHT.recent(kind="mesh") if e["t"] >= t_wall]
    want = [("shard_fault", 2, None), ("restore", None, [2])] + [("shard_fault", i, None) for i in range(MESH_SHARDS)]
    if events != want:
        raise AssertionError(f"mesh faults: the flight recorder holds the mesh events {events}, expected {want}")
    drill["flight_mesh"] = events
    rep["faults"] = drill
    log({"phase": "mesh", "step": "faults", **drill})
    rep["faults"]["ledger"] = led.close()

    # 7. the multi-host seam in one process, over every visible card
    dist.initialize()
    if dist.process_info() != (0, 1):
        raise AssertionError(f"mesh seam: process_info() {dist.process_info()}")
    gm = dist.global_batch_mesh(devices[0])
    pub, r, s, h, pre = prepare_batch(*zip(*triples))
    cut = nf - nf % gm.n_active
    placed = [dist.host_local_to_global(gm, BATCH_AXIS, a[:cut]) for a in (pub, r, s, h, powers * pre)]
    reset_counts()
    ok, total = gm.verify_step()(*placed)
    c = counts()
    check_mask("mesh seam", gather_verdicts(ok) & pre[:cut], expected4[:cut])
    want_tally = int(powers[:cut][expected4[:cut]].sum())
    if int(total) != want_tally or c["ladder"] != gm.n_active:
        raise AssertionError(f"mesh seam: tally {int(total)} (host {want_tally}), {c['ladder']} launches "
                             f"over {gm.n_active} cards")
    rep["seam"] = {"cards": gm.n_active, "lanes": cut, "tally": int(total), "launches": c}
    log({"phase": "mesh", "step": "seam", **rep["seam"]})
    drop_stale_record()
    tv.close()
    return rep


def environment() -> dict:
    """Phase 0: the card's name and power limit, the versions, and the
    kernels' build (ptxas register and spill lines)."""
    import torch

    from tendermint_tpu_torch.ops import _build

    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    clock_mhz = sh(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"])
    nvcc_v = sh([_build.nvcc_path(), "--version"]).splitlines()
    env = {
        "nvidia_smi": smi,
        "clocks_max_sm_mhz": clock_mhz,
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc_v[-1] if nvcc_v else "",
        "sms": torch.cuda.get_device_properties(0).multi_processor_count,
        "cards": torch.cuda.device_count(),
    }
    t0 = time.perf_counter()
    _build.kernel_lib(verbose=True)
    env["build_s"] = time.perf_counter() - t0
    env["ptxas"] = [
        ln.strip()
        for out in _build.BUILD_LOG
        for ln in out.splitlines()
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln
    ]
    log({"phase": 0, **env})
    return env


def commit_inputs(inp: Inputs, n: int):
    """Phase 2's commit: (pubs, msgs, sigs, expected) over keys 0..n-1."""
    plant = {"forged": 11, "absent": n // 4, "s_ge_l": n // 3, "bad_key": n // 2, "short_sig": n - 1}
    return make_commit(inp, list(range(n)), plant)


def window_inputs(inp: Inputs, ns: int, k: int):
    """Phase 3's window: (pubs, k commits, (k, ns) expected)."""
    commits, expected = [], []
    for ci in range(k):
        plant = {}
        if ci == 3:
            plant["forged"] = 5
        if ci == 5:
            plant["absent"] = 6
        if ci == 7:
            plant["s_ge_l"] = 7
        if ci == 9:
            plant["short_sig"] = 8
        plant["bad_key"] = 17  # the same validator in every commit
        pubs, m, s, e = make_commit(inp, list(range(ns)), plant)
        commits.append((m, s))
        expected.append(e)
    return pubs, commits, np.stack(expected)


def flat_inputs(inp: Inputs, nf: int):
    """Phase 4's flat batch: (pubs, msgs, sigs, expected) of distinct keys."""
    pubs, msgs, sigs, expected = make_commit(
        inp,
        list(range(nf)),
        {"forged": 1, "absent": 2, "s_ge_l": 3, "bad_key": 4, "short_sig": 5},
    )
    # a flat batch has no absent slot: the absent vote arrives as an
    # empty message and signature
    msgs[2], sigs[2] = b"", b""
    return pubs, msgs, sigs, expected


def run_mesh_only(args) -> dict:
    """`--mesh-only`: phase 0, then phase 7 alone on the inputs a full
    run makes from the same seed (the bare phases' medians are not
    measured; the bare backend's calls timed in turns are the
    comparison). For a call on several cards, which need run nothing
    else."""
    import torch

    from tendermint_tpu_torch.merkle import simple as host
    from tendermint_tpu_torch.services.verifier import TableBatchVerifier

    report: dict = {"args": vars(args), "env": environment()}
    inp = Inputs(args.seed, args.validators)
    pubs2, msgs2, sigs2, exp2 = commit_inputs(inp, args.validators)
    pubs3, commits3, exp3 = window_inputs(inp, args.sync_validators, args.window)
    pubs4, msgs4, sigs4, exp4 = flat_inputs(inp, args.flat)
    txs = byte_items(np.random.default_rng(args.seed + 5), np.full(TXS, TX_BYTES))
    roots = {algo: host.simple_hash_from_byte_slices(txs, algo) for algo in LEAF_KERNEL}
    bare = TableBatchVerifier(device=torch.device("cuda", 0))
    report["mesh"] = run_mesh(
        inp, bare,
        commit=(pubs2, [(msgs2, sigs2)], exp2, None),
        window=(pubs3, commits3, exp3, None),
        flat=(list(zip(pubs4, msgs4, sigs4)), exp4, None),
        hashed=(txs, roots, dict.fromkeys(roots)),
    )
    bare.close()
    return report


def run_sync_only(args) -> dict:
    """`--sync-only`: phase 0, then phase 10 alone on `default_verifier()`
    and the keys a full run makes from the same seed."""
    from tendermint_tpu_torch.services.dispatch import default_dispatch_queue
    from tendermint_tpu_torch.services.verifier import default_verifier

    import torch

    report: dict = {"args": vars(args), "env": environment()}
    inp = Inputs(args.seed, args.sync_validators)
    stack = default_verifier()
    check_layers(stack)
    try:
        report["sync"] = run_sync(stack, inp, torch.cuda.synchronize, args.sync_validators)
    finally:
        stack.close()
        default_dispatch_queue().close()
    return report


def run_consensus_only(args) -> dict:
    """`--consensus-only`: phase 0, then phase 11 alone on
    `default_verifier()` and the keys a full run makes from the same
    seed."""
    from tendermint_tpu_torch.services.dispatch import default_dispatch_queue
    from tendermint_tpu_torch.services.verifier import default_verifier

    import torch

    report: dict = {"args": vars(args), "env": environment()}
    inp = Inputs(args.seed, args.validators)
    stack = default_verifier()
    check_layers(stack)
    try:
        report["consensus_phase"] = run_consensus(stack, inp, torch.cuda.synchronize, args.validators)
    finally:
        stack.close()
        default_dispatch_queue().close()
    return report


def run_readpath_only(args) -> dict:
    """`--readpath-only`: phase 0, then phase 12 alone on
    `default_verifier()` and the keys a full run makes from the same
    seed."""
    from tendermint_tpu_torch.services.dispatch import default_dispatch_queue
    from tendermint_tpu_torch.services.verifier import default_verifier

    import torch

    report: dict = {"args": vars(args), "env": environment()}
    inp = Inputs(args.seed, args.validators)
    stack = default_verifier()
    check_layers(stack)
    try:
        report["readpath"] = run_readpath(stack, inp, torch.cuda.synchronize, args.sync_validators)
    finally:
        stack.close()
        default_dispatch_queue().close()
    return report


class PhaseClock:
    """Seconds of wall time from each phase's mark to the next."""

    def __init__(self):
        self.out: dict = {}
        self.name, self.t = None, time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        if self.name is not None:
            self.out[self.name] = self.out.get(self.name, 0.0) + now - self.t
        self.name, self.t = name, now

    def done(self) -> dict:
        self.mark(None)
        return self.out


def run_node_only(args) -> dict:
    """`--node-only`: phase 0, then phase 13 alone on `default_verifier()`
    and the keys a full run makes from the same seed."""
    from tendermint_tpu_torch.services.dispatch import default_dispatch_queue
    from tendermint_tpu_torch.services.verifier import default_verifier

    report: dict = {"args": vars(args), "env": environment()}
    inp = Inputs(args.seed, args.sync_validators)
    stack = default_verifier()
    check_layers(stack)
    try:
        report["node"] = run_node(stack, inp, args.sync_validators)
    finally:
        stack.close()
        default_dispatch_queue().close()
    return report


def run_testing_only(args) -> dict:
    """`--testing-only`: phase 0, then phase 14 alone on `default_verifier()`."""
    import torch

    from tendermint_tpu_torch.services.dispatch import default_dispatch_queue
    from tendermint_tpu_torch.services.verifier import default_verifier

    report: dict = {"args": vars(args), "env": environment()}
    stack = default_verifier()
    check_layers(stack)
    try:
        report["testing"] = run_testing(stack, torch.cuda.synchronize)
    finally:
        stack.close()
        default_dispatch_queue().close()
    return report


def run_tools_only(args) -> dict:
    """`--tools-only`: phase 0, then phase 15 alone on `default_verifier()`."""
    import torch

    from tendermint_tpu_torch.services.dispatch import default_dispatch_queue
    from tendermint_tpu_torch.services.verifier import default_verifier

    report: dict = {"args": vars(args), "env": environment()}
    stack = default_verifier()
    check_layers(stack)
    try:
        report["tools"] = run_tools(stack, torch.cuda.synchronize)
    finally:
        stack.close()
        default_dispatch_queue().close()
    return report


def run(args) -> dict:
    import torch

    from tendermint_tpu_torch.ops import ed25519_ladder as lad
    from tendermint_tpu_torch.ops import ed25519_tables as tab
    from tendermint_tpu_torch.ops.ed25519_kernel import prepare_batch
    from tendermint_tpu_torch.services.dispatch import default_dispatch_queue
    from tendermint_tpu_torch.services.verifier import default_verifier

    sync = torch.cuda.synchronize
    report: dict = {"args": vars(args)}
    phase_clock = PhaseClock()

    # -- phase 0: environment and build --------------------------------------
    phase_clock.mark("0")
    report["env"] = env = environment()
    clock_hz = float(env["clocks_max_sm_mhz"].split()[0]) * 1e6
    sms = env["sms"]

    inp = Inputs(args.seed, args.validators)
    log({"phase": "keys", "n": args.validators, "keygen_s": inp.keygen_s})
    stack = default_verifier()
    check_layers(stack)
    # phases 2-4 time the bare table backend, as in every earlier run;
    # the stack phase shares its table cache
    verifier = stack.inner.primary
    launches: dict = {}

    # -- phase 2: consensus commit, N validators, K = 1 -----------------------
    phase_clock.mark("2")
    n = args.validators
    t0 = time.perf_counter()
    pubs2, msgs2, sigs2, exp2 = commit_inputs(inp, n)
    sign2_s = time.perf_counter() - t0
    reset_counts()
    build_s = timed(lambda: verifier.tables_for(tuple(pubs2)), sync)
    commit = [(msgs2, sigs2)]
    got = []
    cold_s = timed(lambda: got.append(verifier.verify_commits(pubs2, commit)), sync)
    warm = []
    for _ in range(5):
        warm.append(timed(lambda: got.append(verifier.verify_commits(pubs2, commit)), sync))
    c2 = counts()
    for g in got:
        check_mask("consensus commit", g, exp2[None, :])
    for name in ("madd_chain_entries", "finish_encode_compare"):
        if c2[name] == 0:
            raise AssertionError(f"consensus commit did not launch {name}")
    launches["madd_chain_entries"] = c2["madd_chain_entries"]
    tables2, _ok2 = verifier.tables_for(tuple(pubs2))
    p2 = {
        "phase": 2,
        "validators": n,
        "sign_s": sign2_s,
        "table_build_s": build_s,
        "cold_commit_s": cold_s,
        "warm_commit_s_median": statistics.median(warm),
        "warm_commit_s": warm,
        "table_bytes": tables2.numel() * tables2.element_size(),
        "launches": c2,
    }
    log(p2)
    report["consensus"] = p2

    # -- phase 3: fast-sync window, N_sync validators, K = window ------------
    phase_clock.mark("3")
    ns, k = args.sync_validators, args.window
    t0 = time.perf_counter()
    pubs3, commits3, exp3 = window_inputs(inp, ns, k)
    sign3_s = time.perf_counter() - t0
    reset_counts()
    got = []
    cold3 = timed(lambda: got.append(verifier.verify_commits(pubs3, commits3)), sync)
    warm3 = []
    for _ in range(5):
        warm3.append(timed(lambda: got.append(verifier.verify_commits(pubs3, commits3)), sync))
    c3 = counts()
    for g in got:
        check_mask("fast-sync window", g, exp3)
    for name in ("madd_chain_fused", "finish_encode_compare"):
        if c3[name] == 0:
            raise AssertionError(f"fast-sync window did not launch {name}")
    launches["madd_chain_fused"] = c3["madd_chain_fused"]
    med3 = statistics.median(warm3)
    p3 = {
        "phase": 3,
        "validators": ns,
        "window": k,
        "sign_s": sign3_s,
        "cold_window_s": cold3,
        "warm_window_s_median": med3,
        "warm_window_s": warm3,
        "commits_per_s": k / med3,
        "verifies_per_s": k * ns / med3,
        "launches": c3,
    }
    log(p3)
    report["fast_sync"] = p3

    # -- phase 4: flat batch of distinct keys ---------------------------------
    phase_clock.mark("4")
    nf = args.flat
    t0 = time.perf_counter()
    pubs4, msgs4, sigs4, exp4 = flat_inputs(inp, nf)
    triples = list(zip(pubs4, msgs4, sigs4))
    sign4_s = time.perf_counter() - t0
    reset_counts()
    got = []
    cold4 = timed(lambda: got.append(verifier.verify_batch(triples)), sync)
    warm4 = []
    for _ in range(5):
        warm4.append(timed(lambda: got.append(verifier.verify_batch(triples)), sync))
    c4 = counts()
    for g in got:
        check_mask("flat batch", g, exp4)
    for name in ("ladder", "finish_encode_compare"):
        if c4[name] == 0:
            raise AssertionError(f"flat batch did not launch {name}")
    launches["ladder"] = c4["ladder"]
    # the finish ends every path: its launches over the three phases
    launches["finish_encode_compare"] = sum(c["finish_encode_compare"] for c in (c2, c3, c4))
    med4 = statistics.median(warm4)
    p4 = {
        "phase": 4,
        "lanes": nf,
        "sign_s": sign4_s,
        "cold_batch_s": cold4,
        "warm_batch_s_median": med4,
        "warm_batch_s": warm4,
        "verifies_per_s": nf / med4,
        "launches": c4,
    }
    log(p4)
    report["flat"] = p4

    dev = verifier.device

    # -- phase 5: the hash plane ----------------------------------------------
    phase_clock.mark("5")
    hrep, hlaunches, (txs, trees, chunks, sha512_msgs) = run_hash(args.seed, dev, sync)
    launches.update(hlaunches)
    report["hash"] = hrep

    # -- phase 6: the same work through the node's stack ---------------------
    phase_clock.mark("6")
    report["stack"] = run_stack(
        stack, inp, sync,
        commit=(pubs2, commit, exp2, p2["warm_commit_s_median"]),
        window=(pubs3, commits3, exp3, med3),
        flat=(triples, exp4, med4),
        hashed=(txs, bytes.fromhex(hrep["data_hash"]["sha256"]["root"]), chunks),
        reps=args.reps,
    )

    # -- phase 8: the port's own domain types through the same stack --------
    phase_clock.mark("8")
    report["types"] = run_types(
        stack, inp, sync,
        sizes=(n, ns, k, nf),
        hashed=(txs, bytes.fromhex(hrep["data_hash"]["sha256"]["root"])),
        reps=args.reps,
    )

    # -- phase 9: block execution and the light client on the port's code --
    phase_clock.mark("9")
    report["state"], report["certifiers"] = run_state(stack, inp, sync, sizes=(n, ns, k), reps=args.reps)

    # -- phase 10: a fresh node fast-syncs over the port's own network ------
    phase_clock.mark("10")
    report["sync"] = run_sync(stack, inp, sync, ns)

    # -- phase 11: the mempool, a 10k-validator storm and a 4-validator net --
    phase_clock.mark("11")
    report["consensus_phase"] = run_consensus(stack, inp, sync, n)

    # -- phase 12: the read path (state sync, the light client, RPC) --------
    phase_clock.mark("12")
    report["readpath"] = run_readpath(stack, inp, sync, ns)
    for name, v in report["readpath"]["launches"].items():
        launches[name] = launches.get(name, 0) + v

    # -- phase 13: the port's own node and CLI, node processes --------------
    phase_clock.mark("13")
    report["node"] = run_node(stack, inp, ns)
    for name, v in report["node"]["launches"].items():
        launches[name] = launches.get(name, 0) + v
    close_signers()  # the last phase that signs in bulk

    # -- phase 14: the port's own nemesis book and a library scenario -------
    phase_clock.mark("14")
    report["testing"] = run_testing(stack, sync)
    for name, v in report["testing"]["launches"].items():
        launches[name] = launches.get(name, 0) + v

    # -- phase 15: the port's operator tools, in process and on a testnet --
    phase_clock.mark("15")
    report["tools"] = run_tools(stack, sync)
    for name, v in report["tools"]["launches"].items():
        launches[name] = launches.get(name, 0) + v
    stack.close()
    default_dispatch_queue().close()

    # -- phase 7: the same work over a mesh of four shards --------------------
    phase_clock.mark("7")
    report["mesh"] = run_mesh(
        inp, verifier,
        commit=(pubs2, commit, exp2, p2["warm_commit_s_median"]),
        window=(pubs3, commits3, exp3, med3),
        flat=(triples, exp4, med4),
        hashed=(txs, {a: bytes.fromhex(d["root"]) for a, d in hrep["data_hash"].items()},
                {a: d["warm_s_median"] for a, d in hrep["data_hash"].items()}),
    )

    # -- phase 1: each kernel against its plain version, then timed ----------
    phase_clock.mark("1")

    def lanes_to_dev(pubs, commits):
        s, h, r, _pre = tab.prepare_commit_lanes(pubs, commits)
        return tuple(torch.from_numpy(a).to(dev).to(torch.int32) for a in (s, h, r))

    kernels = []
    # entries chain at the consensus commit's shape, at 4096 lanes (the
    # first 4096 validators) and at 3 commits of the fast-sync set
    s, h, r = lanes_to_dev(pubs2, commit)
    b2 = s.shape[0]
    e_pt = tab.sum_entries(tables2, s, h)
    err = compare("madd_chain_entries", e_pt, tab._sum_entries_plain(tab._select_entries(tables2, s, h)), r)
    r2u = r.to(torch.uint8)
    finish_err = compare_finish("consensus", e_pt, r2u)
    part = tables2[..., : args.flat].contiguous()
    sp, hp, rp = s[: args.flat], h[: args.flat], r[: args.flat]
    err = max(err, compare("madd_chain_entries", tab.sum_entries(part, sp, hp),
                           tab._sum_entries_plain(tab._select_entries(part, sp, hp)), rp))
    del part
    tables3, _ok3 = verifier.tables_for(tuple(pubs3))
    s3, h3, r3 = lanes_to_dev(pubs3, commits3[:3])
    err = max(err, compare("madd_chain_entries", tab.sum_entries(tables3, s3, h3),
                           tab._sum_entries_plain(tab._select_entries(tables3, s3, h3)), r3))
    nbytes, sectors = entries_bytes(tables2, s, h)
    report["entries_table_sectors"] = sectors
    kernels.append(("madd_chain_entries", err, lambda: tab.sum_entries(tables2, s, h),
                    lambda: tab._sum_entries_plain(tab._select_entries(tables2, s, h)), b2,
                    fe_ops("madd_chain_entries", b2), nbytes))
    # fused chain at the fast-sync window's shape
    s3, h3, r3 = lanes_to_dev(pubs3, commits3)
    dig = tab._digits_w4(s3, h3).contiguous()
    b3 = dig.shape[0]
    f_pt = tab.fused_chain(tables3, dig)
    err = compare("madd_chain_fused", f_pt, tab._fused_chain_plain(tables3, dig), r3)
    r3u = r3.to(torch.uint8)
    finish_err = max(finish_err, compare_finish("fast_sync", f_pt, r3u))
    nbytes = tables3.numel() * 2 + 64 * 16 * 60 * 4 + dig.numel() * 4 + 4 * 20 * b3 * 4
    kernels.append(("madd_chain_fused", err, lambda: tab.fused_chain(tables3, dig),
                    lambda: tab._fused_chain_plain(tables3, dig), b3, fe_ops("madd_chain_fused", b3), nbytes))
    # ladder at the flat batch's shape (the bucket of 4096 lanes)
    pub, rr, ss, hh, _pre = prepare_batch(pubs4, msgs4, sigs4)
    pub, rr, ss, hh = (torch.from_numpy(a).to(dev) for a in (pub, rr, ss, hh))
    ldig = tab._digits_w4(ss.to(torch.int32), hh.to(torch.int32))
    b4 = ldig.shape[0]
    k_pt, k_ok = lad.ladder(pub, ldig)
    p_pt, p_ok = lad._ladder_w4_plain(pub, ldig)
    err = compare("ladder", k_pt, p_pt, rr.to(torch.int32), a_ok=(k_ok, p_ok))
    finish_err = max(finish_err, compare_finish("flat", k_pt, rr))
    check_finish_edges(dev)
    nbytes = pub.numel() + ldig.numel() * 4 + 64 * 16 * 60 * 4 + (4 * 20 * 4 + 1) * b4
    kernels.append(("ladder", err, lambda: lad.ladder(pub, ldig),
                    lambda: lad._ladder_w4_plain(pub, ldig), b4, fe_ops("ladder", b4), nbytes))
    # the finish at the largest main-path shape (the window's 16k lanes),
    # on the buffer the fused kernel left, as the main path reads it
    fx, fy, fz = f_pt[:3]
    nbytes = (3 * 20 * 4 + 32 + 1) * b3
    kernels.append(("finish_encode_compare", finish_err,
                    lambda: tab.finish_encode_compare(fx, fy, fz, r3u),
                    lambda: tab._finish_encode_compare(fx.contiguous(), fy.contiguous(),
                                                       fz.contiguous(), r3), b3,
                    fe_ops("finish_encode_compare", b3), nbytes))

    kernels += hash_kernels(dev, txs, trees, sha512_msgs)

    report["stages"] = {
        "consensus": stage_times(dev, verifier, "entries", pubs2, commit),
        "fast_sync": stage_times(dev, verifier, "fused", pubs3, commits3),
        "flat": stage_times(dev, verifier, "ladder", pubs4, (msgs4, sigs4)),
    }
    log({"phase": "stages", **report["stages"]})
    # the card's busy share of one warm call of each phase: kernel time
    # from the profiler over the phase's unprofiled median wall time
    calls = {
        "consensus": (lambda: verifier.verify_commits(pubs2, commit), p2["warm_commit_s_median"]),
        "fast_sync": (lambda: verifier.verify_commits(pubs3, commits3), med3),
        "flat": (lambda: verifier.verify_batch(triples), med4),
    }
    report["device"] = {}
    for name, (fn, wall) in calls.items():
        d = device_time(fn)
        d["wall_s"] = wall
        d["busy_share"] = d["device_s"] / wall
        report["device"][name] = d
        log({"phase": "device", "call": name, **{k: v for k, v in d.items() if k != "top"}})
    # the flat call's torch prologue before the ladder kernel: the digit
    # packing only (decompression, B - A and inversion are in the kernel)
    pro = device_time(lambda: tab._digits_w4(ss.to(torch.int32), hh.to(torch.int32)))
    report["flat_launches"] = {
        "prologue_kernels": pro["device_kernels"],
        "prologue_device_s": pro["device_s"],
        "call_kernels": report["device"]["flat"]["device_kernels"],
        "eager_prologue_call_kernels": EAGER_PROLOGUE_FLAT_CALL_KERNELS,
    }
    log({"phase": "flat_launches", **report["flat_launches"]})
    hash_profile(dev, sync, hrep, txs, chunks)
    del chunks

    rows = []
    for name, err, kern, plain, lanes, ops, nbytes in kernels:
        kern()  # warm
        src, replaces = KERNEL_INFO[name]
        if name in PROFILED:
            ms, seen = kernel_ms(kern, PROFILED[name], args.reps)
            timing = {"ms_by": "profiler", "profiled_launches": seen}
        else:
            ms, timing = cuda_ms(kern, args.reps), {"ms_by": "events"}
        plain_ms = cuda_ms(plain, 1)
        bms, by = bound_ms(ops, nbytes, clock_hz, sms)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bms,
            "bound_by": by,
            "library_ms": None,
            **timing,
            "lanes": lanes,
        })
        log({"phase": 1, **rows[-1]})
    report["kernels"] = rows
    # the finish at each path's shape, on its chain's output as it lies:
    # CUDA events around a call (the wrapper's host work before the launch
    # included, as in the kernels line) and the kernel's device time alone
    finish_calls = {
        "consensus": lambda: tab.finish_encode_compare(*e_pt[:3], r2u),
        "fast_sync": lambda: tab.finish_encode_compare(fx, fy, fz, r3u),
        "flat": lambda: tab.finish_encode_compare(*k_pt[:3], rr),
    }
    report["finish_ms"] = {name: cuda_ms(fn, args.reps) for name, fn in finish_calls.items()}
    log({"phase": "finish_ms", **report["finish_ms"]})
    report["finish_device_ms"] = {
        name: kernel_ms(fn, "finish_kernel", args.reps)[0] for name, fn in finish_calls.items()
    }
    log({"phase": "finish_device_ms", **report["finish_device_ms"]})
    report["sha512_wide"] = sha512_wide(args.seed, dev, clock_hz, sms, args.reps)
    log({"phase": "sha512_wide", **report["sha512_wide"]})
    report["profiler_lost_sessions"] = LOST_SESSIONS[0]
    log({"phase": "profiler", "lost_sessions": LOST_SESSIONS[0]})
    report["phase_s"] = phase_clock.done()
    log({"phase": "phase_s", **report["phase_s"]})
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--validators", type=int, default=10000, help="consensus commit size")
    ap.add_argument("--sync-validators", type=int, default=1000, help="fast-sync set size")
    ap.add_argument("--window", type=int, default=16, help="fast-sync commits per call")
    ap.add_argument("--flat", type=int, default=4096, help="flat batch lanes")
    ap.add_argument("--reps", type=int, default=5, help="timed kernel runs")
    ap.add_argument("--mesh-only", action="store_true",
                    help="phase 0 and the mesh phase alone (for a call on several cards)")
    ap.add_argument("--sync-only", action="store_true", help="phase 0 and the sync phase alone")
    ap.add_argument("--consensus-only", action="store_true", help="phase 0 and the consensus phase alone")
    ap.add_argument("--readpath-only", action="store_true", help="phase 0 and the read-path phase alone")
    ap.add_argument("--node-only", action="store_true", help="phase 0 and the node phase alone")
    ap.add_argument("--testing-only", action="store_true", help="phase 0 and the testing phase alone")
    ap.add_argument("--tools-only", action="store_true", help="phase 0 and the tools phase alone")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import tendermint_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}", file=sys.stderr)
        return 2
    try:
        attach_telemetry()
        if args.mesh_only:
            report = run_mesh_only(args)
        elif args.sync_only:
            report = run_sync_only(args)
        elif args.consensus_only:
            report = run_consensus_only(args)
        elif args.readpath_only:
            report = run_readpath_only(args)
        elif args.node_only:
            report = run_node_only(args)
        elif args.testing_only:
            report = run_testing_only(args)
        elif args.tools_only:
            report = run_tools_only(args)
        else:
            report = run(args)
        report["metrics"] = dump_metrics()
    except Exception:
        traceback.print_exc()
        from tendermint_tpu_torch.telemetry.flightrec import FLIGHT

        print(f"chip_smoke: flight recorder dumped to {FLIGHT.dump('chip_smoke-failure', dir=str(OUT))}",
              file=sys.stderr)
        return 1
    finally:
        close_signers()
    try:
        (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    except OSError:
        pass
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(report["env"]["nvidia_smi"])
    if "kernels" in report:
        print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in report["kernels"]]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
