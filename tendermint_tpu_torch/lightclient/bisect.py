"""BisectingCertifier: skipping verification with batched bisection.

The read path's hot loop. The seed-era `InquiringCertifier`
(certifiers/certifier.py) bridges validator-set changes by walking
provider commits one `update` at a time — O(heights) sequential commit
verifies, each paying its own device launch. Per PAPERS.md ("Practical
Light Clients for Committee-Based Blockchains", "A Tendermint Light
Client") the walk collapses to O(log n):

* **skip rule** — trust jumps straight from height T to target H when
  the commit at H carries (a) >2/3 of H's OWN validator power (every
  honestly committed block does) and (b) >1/3 of the power of the set
  trusted at T (the trust-period rule: a third of the old set would
  have to be byzantine — and slashable — to vouch for a fork while
  their unbonding period lasts);
* **bisect on failure** — when the old-set overlap has decayed below
  1/3, probe a geometric ladder of intermediate heights between T and
  H, ALL verified in one batch: every bisection round is exactly ONE
  coalesced device launch (`consumer="lightclient"` — the verify
  spine's sixth consumer, riding the same `VerifyCoalescer`
  drain-order discipline as the other five), not one launch per probed
  height;
* **hard vs soft failure** — insufficient old overlap is the soft,
  expected signal (bisect denser); an invalid signature or a commit
  that cannot certify its own header is a FORGED candidate and fails
  the walk immediately (the provider is lying — callers route that to
  the peer scorer, `lightclient/reactor.py`).

Trust persistence: every candidate that passes is certified and stored
into `trusted` (a `CertifiedCommitCache` / `FullCommitStore` /
`MemProvider`), so later walks restart from the closest proven height
— the positives-only cache is the walk's memoization.

Telemetry: tendermint_lightclient_bisections_total{result},
tendermint_lightclient_walk_seconds{mode="bisect"}, span
`lightclient.walk` (rounds/launch count attrs).

The port's copy of `tendermint_tpu/lightclient/bisect.py`. A certifier
given `verifier=None` verifies on the port's `default_verifier()`, the
card's stack, which raises without a card; a round of 512 lanes or more
is one `ladder` launch there.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from tendermint_tpu_torch.certifiers.certifier import FullCommit
from tendermint_tpu_torch.telemetry import TRACER
from tendermint_tpu_torch.telemetry import metrics as _metrics
from tendermint_tpu_torch.types.errors import (
    ErrNoSourceCommit,
    ErrTooMuchChange,
    ErrTrustExpired,
    ErrValidatorsChanged,
    ValidationError,
)
from tendermint_tpu_torch.types.validator_set import ValidatorSet, _verify_triples
from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT

# candidate heights probed per ladder round: lo + span/2^k for k=1..D.
# 6 gives 1/64 span resolution per round — a 256-height jump reaches
# span 4 in one failed ladder, and every round is one launch.
DEFAULT_LADDER_DEPTH = 6
# safety valve: a walk can only narrow so many times before the span
# hits 1; anything past this is a provider feeding us junk
_MAX_ROUNDS = 64


@dataclass
class _SkipPrep:
    """One candidate's host-side verification walk, pre-launch."""

    fc: FullCommit
    triples: list = field(default_factory=list)
    old_powers: list = field(default_factory=list)
    new_powers: list = field(default_factory=list)


class BisectingCertifier:
    """Self-updating light-client certifier with skipping verification.

    Subjective initialization: seed with either a trusted `FullCommit`
    (`seed=`) or a bare (validators, height) pair — the operator's
    social-consensus input, exactly like `TrustAnchor`'s pin.

    `trusted` stores PROVEN commits (certified here before any store);
    `source` supplies untrusted candidates (NodeProvider over RPC,
    PeerProvider over the 0x68 channel, MemProvider in tests) with the
    floor-lookup contract `get_by_height(h) -> newest commit <= h`.

    `trust_period_ns` bounds how stale the trusted state may be before
    the skip rule loses its slashing backstop (0 disables — in-process
    tests use deterministic far-past genesis times).
    """

    def __init__(
        self,
        chain_id: str,
        validators: ValidatorSet | None = None,
        height: int = 0,
        seed: FullCommit | None = None,
        trusted=None,
        source=None,
        verifier=None,
        consumer: str = "lightclient",
        trust_period_ns: int = 0,
        now_ns=None,
        ladder_depth: int = DEFAULT_LADDER_DEPTH,
    ) -> None:
        self.chain_id = chain_id
        self.trusted = trusted
        self.source = source
        self.verifier = verifier
        self.consumer = consumer
        self.trust_period_ns = trust_period_ns
        self._now_ns = now_ns or time.time_ns
        self.ladder_depth = max(1, ladder_depth)
        if seed is not None:
            seed.validate_basic(chain_id)
            self._valset = seed.validators
            self._height = seed.height()
            self._time_ns = seed.header.time
            if trusted is not None:
                trusted.store_commit(seed)
        elif validators is not None:
            self._valset = validators
            self._height = height
            self._time_ns = 0  # bare init: freshness starts on first jump
        else:
            raise ValidationError("BisectingCertifier needs a seed or a valset")
        # per-walk instrumentation (read by tests/bench): batched launch
        # rounds and total commit-signature verifies of the LAST walk
        self.last_walk_rounds = 0
        self.last_walk_verifies = 0
        # the last jump span that passed the skip rule — seeds the next
        # round's probe cluster (adaptive hop sizing)
        self._hop_hint = 0

    # -- public surface ------------------------------------------------------

    @property
    def validators(self) -> ValidatorSet:
        return self._valset

    @property
    def last_height(self) -> int:
        return self._height

    def certify(self, fc: FullCommit) -> None:
        """Certify one FullCommit, skipping/bisecting trust to its
        height first when the valset changed (the `InquiringCertifier.
        certify` contract, minus the sequential walk)."""
        fc.validate_basic(self.chain_id)
        # the trust-period rule gates EVERY extension of trust, the
        # direct same-valset path included: past the unbonding window
        # the pinned validators can sign anything without slashing risk
        self._check_trust_fresh()
        if fc.header.validators_hash != self._valset.hash():
            self.verify_to_height(fc.height())
            if fc.header.validators_hash != self._valset.hash():
                raise ErrValidatorsChanged(
                    f"cannot establish validators for height {fc.height()}"
                )
        # direct certification under the (now current) trusted set:
        # old == new, so the skip tally degenerates to the plain >2/3
        # quorum plus full-overlap check
        if not self._verify_candidates([fc])[0]:
            raise ErrTooMuchChange(
                f"trusted set cannot certify height {fc.height()}"
            )
        self._adopt(fc)

    def verify_to_height(self, target: int) -> None:
        """Move trust to the newest source commit at/below `target` —
        O(log n) batched rounds instead of the sequential walk."""
        t0 = time.perf_counter()
        self.last_walk_rounds = 0
        self.last_walk_verifies = 0
        try:
            with TRACER.span(
                "lightclient.walk", target=target, from_height=self._height
            ):
                self._walk(target)
        except ErrTooMuchChange:
            _metrics.LIGHTCLIENT_BISECTIONS.labels(result="too_much_change").inc()
            raise
        except ErrTrustExpired:
            _metrics.LIGHTCLIENT_BISECTIONS.labels(result="trust_expired").inc()
            raise
        except ErrNoSourceCommit:
            _metrics.LIGHTCLIENT_BISECTIONS.labels(result="no_source").inc()
            raise
        except ValidationError:
            # only genuine candidate defects (bad signature, impossible
            # quorum, malformed votes) land here — the forgery signal
            # operators alert on must not be polluted by client-side
            # staleness or fetch failures (the typed errors above)
            _metrics.LIGHTCLIENT_BISECTIONS.labels(result="forged").inc()
            raise
        _metrics.LIGHTCLIENT_BISECTIONS.labels(result="ok").inc()
        _metrics.LIGHTCLIENT_WALK_SECONDS.labels(mode="bisect").observe(
            time.perf_counter() - t0
        )

    # -- the walk ------------------------------------------------------------

    def _restart_from_trusted(self, target: int) -> None:
        """Resume from the closest PROVEN commit at/below the target
        (the cache memoization — same restart rule as the inquirer)."""
        if self.trusted is None:
            return
        tfc = self.trusted.get_by_height(target)
        if tfc is not None and tfc.height() > self._height:
            self._valset = tfc.validators
            self._height = tfc.height()
            self._time_ns = tfc.header.time

    def _check_trust_fresh(self) -> None:
        if self.trust_period_ns <= 0 or not self._time_ns:
            return
        age = self._now_ns() - self._time_ns
        if age > self.trust_period_ns:
            raise ErrTrustExpired(
                f"light-client trust expired: trusted header is "
                f"{age / 1e9:.0f}s old, trust period "
                f"{self.trust_period_ns / 1e9:.0f}s — re-initialize the pin"
            )

    def _walk(self, target: int) -> None:
        if self.source is None:
            raise ErrNoSourceCommit("no source provider to walk")
        self._restart_from_trusted(target)
        self._check_trust_fresh()
        if target <= self._height:
            return
        sfc = self.source.get_by_height(target)
        if sfc is None:
            raise ErrNoSourceCommit(
                f"no source commit at/below height {target}"
            )
        if sfc.height() <= self._height:
            return  # source lags our trust: nothing newer to learn
        target = sfc.height()
        hi = target
        include_hi = True
        rounds = 0
        while self._height < target:
            rounds += 1
            if rounds > _MAX_ROUNDS:
                raise ErrTooMuchChange(
                    f"bisection did not converge between "
                    f"{self._height} and {target}"
                )
            fcs = self._fetch(self._probe_heights(self._height, hi, include_hi))
            if not fcs:
                raise ErrTooMuchChange(
                    f"no intermediate commit between {self._height} and {hi}"
                )
            self.last_walk_rounds += 1
            verdicts = self._verify_candidates(fcs)  # ONE launch
            passing = [fc for fc, ok in zip(fcs, verdicts) if ok]
            if passing:
                # every passing candidate is certified — persist them
                # all (ascending, so the trusted store's floor lookups
                # can restart anywhere along the bridge), then retry
                # the remaining span from the highest
                prev = self._height
                for fc in sorted(passing, key=lambda f: f.height()):
                    self._adopt(fc)
                self._hop_hint = self._height - prev  # a span that WORKED
                hi = target
                include_hi = True
            else:
                lowest = min(fc.height() for fc in fcs)
                if lowest <= self._height + 1:
                    raise ErrTooMuchChange(
                        f"cannot bridge validator change between "
                        f"{self._height} and {lowest}"
                    )
                hi = lowest  # narrow; hi itself just failed, skip it
                include_hi = False

    def _probe_heights(self, lo: int, hi: int, include_hi: bool) -> list[int]:
        """One round's candidate heights, highest first — ALL verified
        in a single launch: the remaining span's endpoint, a cluster
        around the last jump size that worked (`_hop_hint` ratchets the
        hop toward the trust-rule limit on uniformly-rotating chains),
        and the geometric bisection ladder underneath as the fallback
        bridge."""
        span = hi - lo
        spans: set[int] = set()
        if include_hi:
            spans.add(span)
        if self._hop_hint:
            for m in (2.0, 1.5, 1.25, 1.0):
                s = int(self._hop_hint * m)
                if 0 < s < span:
                    spans.add(s)
        for k in range(1, self.ladder_depth + 1):
            s = span >> k
            if s > 0:
                spans.add(s)
        return sorted((lo + s for s in spans if 0 < s <= span), reverse=True)

    def _fetch(self, heights: list[int]) -> list[FullCommit]:
        """Source lookups for the probe heights; the floor contract may
        return lower heights — dedup, keep only ones above trust."""
        seen: set[int] = set()
        out: list[FullCommit] = []
        for h in heights:
            fc = self.source.get_by_height(h)
            if fc is None:
                continue
            fh = fc.height()
            if fh <= self._height or fh in seen:
                continue
            seen.add(fh)
            out.append(fc)
        return out

    # -- skip verification (the batched hot path) ----------------------------

    def _collect_skip(self, fc: FullCommit) -> _SkipPrep:
        """Host-side walk of one candidate commit: triples under the
        candidate's OWN valset (the signatures are the new set's), with
        per-lane old-set power credit for validators the trusted set
        also contains. Malformed votes fail hard — a legit provider
        never serves them.

        Trusted-set credit requires the trusted validator's KEY, not
        just its address: the lane signature is verified under
        `new_val.pub_key`, and the untrusted candidate valset binds
        addresses to whatever pubkeys its author chose. Crediting by
        address alone would let a forger reuse every trusted address
        with attacker keys and fake the >1/3 overlap (the same rule
        `verify_commit_any` enforces by verifying overlap signatures
        under `old_val.pub_key`). Each trusted validator is credited at
        most once per candidate, so a replayed signature in duplicate
        lanes cannot double-count old power."""
        old = self._valset
        new = fc.validators
        commit = fc.commit
        height = fc.height()
        if len(new.validators) != len(commit.precommits):
            raise ValidationError("commit size != valset size")
        round_ = commit.round()
        prep = _SkipPrep(fc=fc)
        seen_old: set[bytes] = set()
        for idx, precommit in enumerate(commit.precommits):
            if precommit is None:
                continue
            if precommit.height != height or precommit.round != round_:
                raise ValidationError("commit vote height/round mismatch")
            if precommit.type != VOTE_TYPE_PRECOMMIT:
                raise ValidationError("commit vote is not a precommit")
            if precommit.block_id != commit.block_id:
                continue  # nil/other votes carry no power
            new_val = new.validators[idx]
            _, old_val = old.get_by_address(new_val.address)
            prep.triples.append(
                (
                    new_val.pub_key.data,
                    precommit.sign_bytes(self.chain_id),
                    precommit.signature,
                )
            )
            prep.new_powers.append(new_val.voting_power)
            old_credit = 0
            if (
                old_val is not None
                and old_val.pub_key.data == new_val.pub_key.data
                and old_val.address not in seen_old
            ):
                seen_old.add(old_val.address)
                old_credit = old_val.voting_power
            prep.old_powers.append(old_credit)
        return prep

    def _verify_candidates(self, fcs: list[FullCommit]) -> list[bool]:
        """Verify a whole round of candidates as ONE flat signature
        batch (the coalescer merges it into a single launch; cache hits
        are withheld). Returns per-candidate skip verdicts: True iff
        >2/3 new-set quorum AND >1/3 trusted-set overlap."""
        preps = []
        all_triples = []
        for fc in fcs:
            fc.validate_basic(self.chain_id)
            prep = self._collect_skip(fc)
            preps.append(prep)
            all_triples.extend(prep.triples)
        self.last_walk_verifies += len(all_triples)
        mask = _verify_triples(all_triples, self.verifier, consumer=self.consumer)
        out: list[bool] = []
        at = 0
        old_total = self._valset.total_voting_power
        for prep in preps:
            k = len(prep.triples)
            sub = mask[at : at + k]
            at += k
            new_tallied = 0
            old_tallied = 0
            for ok, np_, op in zip(sub, prep.new_powers, prep.old_powers):
                if not ok:
                    # an invalid signature inside a served commit is a
                    # forgery, never a bisection trigger
                    raise ValidationError(
                        f"invalid commit signature at height "
                        f"{prep.fc.height()} (forged candidate)"
                    )
                new_tallied += np_
                old_tallied += op
            new_total = prep.fc.validators.total_voting_power
            if not new_tallied * 3 > new_total * 2:
                raise ValidationError(
                    f"candidate at height {prep.fc.height()} lacks its own "
                    f"+2/3 quorum ({new_tallied} of {new_total})"
                )
            # the skip rule: strictly more than 1/3 of TRUSTED power
            out.append(old_tallied * 3 > old_total)
        return out

    def _adopt(self, fc: FullCommit) -> None:
        if fc.height() <= self._height:
            return
        self._valset = fc.validators
        self._height = fc.height()
        self._time_ns = fc.header.time
        if self.trusted is not None:
            self.trusted.store_commit(fc)
