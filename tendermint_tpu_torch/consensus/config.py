"""Consensus timing/behavior config (reference `config/config.go:295-400`)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ConsensusConfig:
    # timeouts in milliseconds; *_delta grows per round
    timeout_propose: int = 3000
    timeout_propose_delta: int = 500
    timeout_prevote: int = 1000
    timeout_prevote_delta: int = 500
    timeout_precommit: int = 1000
    timeout_precommit_delta: int = 500
    timeout_commit: int = 1000
    # Round-skip deadline while parked at PREVOTE/PRECOMMIT without the
    # +2/3-any that would arm the *_wait timeouts (the CPU-starvation
    # liveness gap: gossip can idle for seconds and nothing else moves
    # the round forward). Generous by design — healthy networks never
    # hit it; 0 disables. Fires as later Tendermint's OnTimeoutPrevote/
    # OnTimeoutPrecommit: precommit nil, then next round.
    timeout_round_skip: int = 10_000
    timeout_round_skip_delta: int = 2_000
    skip_timeout_commit: bool = False
    # Cross-height pipeline (ROADMAP item 3): at finalize, height H's
    # ABCI apply + state advance run as a dispatch handle while H+1's
    # NewHeight/Propose proceed on a speculated (no-EndBlock-changes)
    # state; a hard join barrier guards every applied-state read. False
    # restores the strictly serial propose→...→commit→apply ladder
    # (also forced by TENDERMINT_TPU_PIPELINE=0).
    pipeline_commit: bool = True
    # Measured-latency timeouts: derive the propose/prevote/precommit
    # waits and the commit pacing from the live HeightLedger phase
    # percentiles + vote-arrival rollup, clamped to the fixed values
    # above as ceilings (consensus/ticker.py AdaptiveTimeouts). False
    # (or TENDERMINT_TPU_ADAPTIVE_TIMEOUTS=0) sleeps the fixed ladder.
    adaptive_timeouts: bool = True
    # floor any derived timeout so a burst of sub-ms measurements can
    # never spin the ticker (milliseconds)
    timeout_derived_floor: int = 2
    create_empty_blocks: bool = True
    create_empty_blocks_interval: int = 0  # seconds
    # proposer liveness ping cadence while waiting for txs in
    # no-empty-blocks mode (reference proposalHeartbeatIntervalSeconds)
    proposal_heartbeat_interval: float = 2.0
    max_block_size_txs: int = 10_000
    wal_light: bool = False

    def propose_timeout(self, round_: int) -> float:
        return (self.timeout_propose + self.timeout_propose_delta * round_) / 1000.0

    def prevote_timeout(self, round_: int) -> float:
        return (self.timeout_prevote + self.timeout_prevote_delta * round_) / 1000.0

    def precommit_timeout(self, round_: int) -> float:
        return (self.timeout_precommit + self.timeout_precommit_delta * round_) / 1000.0

    def commit_timeout(self) -> float:
        return self.timeout_commit / 1000.0

    def round_skip_timeout(self, round_: int) -> float:
        """Seconds before a starved PREVOTE/PRECOMMIT skips ahead; <= 0
        means disabled."""
        if self.timeout_round_skip <= 0:
            return 0.0
        return (
            self.timeout_round_skip + self.timeout_round_skip_delta * round_
        ) / 1000.0

    @classmethod
    def test_config(cls) -> "ConsensusConfig":
        """Shrunk timeouts (reference `TestConsensusConfig
        config/config.go:389-400`)."""
        return cls(
            timeout_propose=100,
            timeout_propose_delta=1,
            timeout_prevote=10,
            timeout_prevote_delta=1,
            timeout_precommit=10,
            timeout_precommit_delta=1,
            timeout_commit=10,
            # long enough that loaded CI never skips a healthy round,
            # short enough that starvation tests finish (nemesis tunes
            # it further down for its round-skip scenario)
            timeout_round_skip=2_000,
            timeout_round_skip_delta=100,
            skip_timeout_commit=True,
        )
