"""The JAX package's host plane on the port's verifier stack:
`ValidatorSet.verify_commit_batched` and `verify_commit_batched_async`
(`tendermint_tpu/types/validator_set.py`) driven with
`tendermint_tpu_torch.services.verifier.default_verifier(device="cpu")`,
the coalescing -> resilient -> table stack. Outcomes, down to a forged
lane's `ValidationError`, must equal those of the JAX package's
`HostBatchVerifier`, and the stack must be reached through its async
surface (`verify_commits_async`), the branch the host plane takes for a
verifier that has one.

Two routes of the table backend: the default minimum batch sends these
small commits to its host loop; a minimum of 0 sends them through the
plain torch chains.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from tendermint_tpu.services.verifier import HostBatchVerifier as JaxHostVerifier
from tendermint_tpu.testing.nemesis import make_genesis
from tendermint_tpu.types import BlockID
from tendermint_tpu.types.errors import ValidationError
from tendermint_tpu.types.part_set import PartSetHeader
from tendermint_tpu.types.vote import VOTE_TYPE_PRECOMMIT, Vote
from tendermint_tpu.types.vote_set import VoteSet
from tendermint_tpu_torch.services import verifier as V
from tendermint_tpu_torch.testing import lockrank_report, time_limit_fixture

torch.set_num_threads(1)

CHAIN = "torch-vs"


@pytest.fixture(autouse=True)
def _port_lockrank_guard():
    """A violation the port's lock-rank sanitizer records fails the test
    that provoked it (the suite's own guard drains only the JAX
    package's sanitizer)."""
    yield
    report = lockrank_report()
    if report:
        pytest.fail("the port's lock-rank sanitizer recorded violation(s):\n" + report, pytrace=False)


# each test fails past this many seconds, with every thread's stack on
# stderr, where a wait that never ends would hold its worker for good
_time_limit = pytest.fixture(autouse=True)(time_limit_fixture(180))


@pytest.fixture(scope="module")
def chain():
    genesis, privs = make_genesis(4, chain_id=CHAIN)
    valset = genesis.validator_set()

    def commit(height, tag):
        block_id = BlockID(bytes([tag]) * 20, PartSetHeader(total=1, hash=bytes([tag + 1]) * 20))
        votes = VoteSet(CHAIN, height, 0, VOTE_TYPE_PRECOMMIT, valset)
        for i, priv in enumerate(privs):
            vote = Vote(
                validator_address=priv.address, validator_index=i, height=height, round=0,
                timestamp=1, type=VOTE_TYPE_PRECOMMIT, block_id=block_id,
            )
            votes.add_vote(priv.sign_vote(CHAIN, vote))
        return (block_id, height, votes.make_commit())

    good = [commit(7, 0x31), commit(8, 0x41)]
    block_id, height, c = commit(9, 0x51)
    precommits = list(c.precommits)
    precommits[2] = precommits[2].with_signature(b"\x07" * 64)
    forged = (block_id, height, dataclasses.replace(c, precommits=precommits))
    return valset, good, forged


@pytest.fixture(params=[None, 0], ids=["host-loop", "plain-chains"])
def stack(request, monkeypatch):
    """The port's default stack on the CPU, fresh for each test, with
    its async surface counted."""
    monkeypatch.setattr(V, "_DEFAULTS", {})
    v = V.default_verifier(device="cpu")
    if request.param is not None:
        v.inner.primary._min_batch = request.param
    calls = {"async": 0}
    real = v.verify_commits_async

    def counted(*args, **kwargs):
        calls["async"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(v, "verify_commits_async", counted)
    yield v, calls
    v.close()


def _outcome(fn):
    try:
        fn()
    except ValidationError as e:
        return str(e)
    return None


@pytest.mark.parametrize("which", ["good", "forged", "mixed"])
def test_verify_commit_batched_matches_the_jax_host(chain, stack, which):
    valset, good, forged = chain
    entries = {"good": good, "forged": [forged], "mixed": [good[0], forged]}[which]
    v, calls = stack
    want = _outcome(lambda: valset.verify_commit_batched(CHAIN, entries, verifier=JaxHostVerifier()))
    got = _outcome(lambda: valset.verify_commit_batched(CHAIN, entries, verifier=v, consumer="fastsync"))
    assert got == want
    assert (want is None) == (which == "good")
    assert calls["async"] == 1  # the tagged stack takes the async branch
    got_async = _outcome(
        lambda: valset.verify_commit_batched_async(CHAIN, entries, verifier=v, consumer="statesync").result(60)
    )
    assert got_async == want and calls["async"] == 2
    snap = v.snapshot()
    assert snap["fallback_calls"] == 0 and snap["state"] == "closed"
