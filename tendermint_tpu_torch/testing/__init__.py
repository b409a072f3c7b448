"""In-process chaos testing harnesses (network nemesis + invariants,
Byzantine adversaries, WAN topologies, declarative scenarios),
and the fixtures the port's tests and `chip_smoke.py` share
(`testing/fixtures.py`, every name of its `__all__`)."""

from tendermint_tpu_torch.testing.fixtures import *  # noqa: F401,F403
from tendermint_tpu_torch.testing.fixtures import __all__ as _FIXTURES
from tendermint_tpu_torch.testing.nemesis import (
    InvariantViolation,
    Nemesis,
    NemesisNode,
)
from tendermint_tpu_torch.testing.byzantine import (
    ConflictingProposer,
    Equivocator,
    ForgedCommitPusher,
    FrameFuzzer,
    GarbageSigFlooder,
    LyingFastSyncPeer,
    forge_fullcommit,
    wait_evidence_committed,
)

__all__ = [
    "ConflictingProposer",
    "Equivocator",
    "ForgedCommitPusher",
    "FrameFuzzer",
    "GarbageSigFlooder",
    "InvariantViolation",
    "LyingFastSyncPeer",
    "Nemesis",
    "NemesisNode",
    "forge_fullcommit",
    "wait_evidence_committed",
    *_FIXTURES,
]
