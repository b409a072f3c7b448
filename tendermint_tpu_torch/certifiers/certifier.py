"""Static / Dynamic / Inquiring certifiers.

Reference `certifiers/static.go:22,49-65` (fixed valset),
`dynamic.go:20-93` (follows valset changes via VerifyCommitAny), and
`inquirer.go:9,40-120` (auto-fetches missing valsets from providers,
bisecting over heights when one update changes more than 2/3).
"""

from __future__ import annotations

from dataclasses import dataclass

from tendermint_tpu_torch.codec.binary import Reader, Writer
from tendermint_tpu_torch.types.block import Commit, Header
from tendermint_tpu_torch.types.errors import (
    ErrTooMuchChange,
    ErrValidatorsChanged,
    ValidationError,
)
from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet


@dataclass
class FullCommit:
    """A header + the commit that sealed it + the validator set that
    signed (reference `certifiers/commit.go` FullCommit)."""

    header: Header
    commit: Commit
    validators: ValidatorSet

    def height(self) -> int:
        return self.header.height

    def validate_basic(self, chain_id: str) -> None:
        if self.header.chain_id != chain_id:
            raise ValidationError(
                f"wrong chain id: {self.header.chain_id} != {chain_id}"
            )
        if self.commit.height() != self.header.height:
            raise ValidationError("commit height != header height")
        if self.commit.block_id.hash != self.header.hash():
            raise ValidationError("commit is not for this header")
        if self.header.validators_hash != self.validators.hash():
            raise ValidationError("validator set does not match header")
        self.commit.validate_basic()

    def encode(self) -> bytes:
        w = Writer().bytes(self.header.encode()).bytes(self.commit.encode())
        w.uvarint(len(self.validators.validators))
        for v in self.validators.validators:
            w.bytes(v.address).bytes(v.pub_key.data)
            w.uvarint(v.voting_power).svarint(v.accum)
        return w.build()

    @classmethod
    def decode(cls, data: bytes) -> "FullCommit":
        from tendermint_tpu_torch.crypto import PubKey

        r = Reader(data)
        header = Header.decode_from(Reader(r.bytes()))
        commit = Commit.decode_from(Reader(r.bytes()))
        vals = []
        for _ in range(r.uvarint()):
            addr, pub = r.bytes(), r.bytes()
            power, accum = r.uvarint(), r.svarint()
            vals.append(
                Validator(
                    address=addr,
                    pub_key=PubKey(pub),
                    voting_power=power,
                    accum=accum,
                )
            )
        return cls(header=header, commit=commit, validators=ValidatorSet(vals))


class StaticCertifier:
    """Certify against one fixed validator set (reference
    `static.go:49-65`). Raises ErrValidatorsChanged when the header
    names a different set — the dynamic/inquiring layers react to that.

    `consumer` tags this walk's verify requests for the coalescer
    (`services/batcher.py`): light-client walks default to "rpc", the
    statesync trust anchor re-tags its certifiers "statesync" — so a
    certifier re-walk over overlapping valsets both hits the dedup
    cache and merges its novel signatures into whatever launch the
    consensus/fast-sync pipelines have in flight."""

    def __init__(
        self,
        chain_id: str,
        validators: ValidatorSet,
        verifier=None,
        consumer: str = "rpc",
    ):
        self.chain_id = chain_id
        self.validators = validators
        self.verifier = verifier
        self.consumer = consumer

    def certify(self, fc: FullCommit) -> None:
        self.certify_batch([fc])

    def certify_batch(self, fcs: list[FullCommit]) -> None:
        """Certify K commits of this one valset as a single device batch
        (BASELINE config 2's 10k-commit replay shape; the reference
        loops `certifiers/performance_test.go:10-80` one at a time)."""
        entries = []
        trusted_hash = self.validators.hash()
        for fc in fcs:
            fc.validate_basic(self.chain_id)
            if fc.header.validators_hash != trusted_hash:
                raise ErrValidatorsChanged(
                    f"validator hash changed at height {fc.height()}"
                )
            entries.append((fc.commit.block_id, fc.height(), fc.commit))
        self.validators.verify_commit_batched(
            self.chain_id, entries, verifier=self.verifier, consumer=self.consumer
        )


class DynamicCertifier:
    """Static + the ability to follow validator-set changes: `update`
    accepts a new FullCommit if >2/3 of the CURRENT trusted set signed
    it (reference `dynamic.go:49-93`)."""

    def __init__(
        self,
        chain_id: str,
        validators: ValidatorSet,
        height: int = 0,
        verifier=None,
        consumer: str = "rpc",
    ):
        self.cert = StaticCertifier(chain_id, validators, verifier, consumer=consumer)
        self.last_height = height

    @property
    def chain_id(self) -> str:
        return self.cert.chain_id

    @property
    def validators(self) -> ValidatorSet:
        return self.cert.validators

    def certify(self, fc: FullCommit) -> None:
        self.cert.certify(fc)

    def update(self, fc: FullCommit) -> None:
        """Reference `Update dynamic.go:60-93`: the new set is trusted
        only if the old one vouches for it with >2/3 of its power."""
        if fc.height() <= self.last_height:
            raise ValidationError(
                f"update height {fc.height()} <= trusted {self.last_height}"
            )
        fc.validate_basic(self.chain_id)
        # raises ErrTooMuchChange when old-set overlap is below 2/3
        self.cert.validators.verify_commit_any(
            fc.validators,
            self.chain_id,
            fc.commit.block_id,
            fc.height(),
            fc.commit,
            verifier=self.cert.verifier,
            consumer=self.cert.consumer,
        )
        self.cert = StaticCertifier(
            self.chain_id, fc.validators, self.cert.verifier,
            consumer=self.cert.consumer,
        )
        self.last_height = fc.height()


class InquiringCertifier:
    """Self-updating certifier: walks provider-stored FullCommits to
    bridge validator-set changes, bisecting when one jump exceeds the
    2/3 continuity rule (reference `inquirer.go:40-120`).

    `trusted` holds commits we have verified (seeded with one trusted
    FullCommit); `source` supplies untrusted candidates (e.g. fetched
    from a full node) which become trusted only after `update` succeeds.
    """

    def __init__(
        self,
        chain_id: str,
        seed: FullCommit,
        trusted,
        source,
        verifier=None,
        consumer: str = "rpc",
    ):
        self.chain_id = chain_id
        self.trusted = trusted
        self.source = source
        self.verifier = verifier
        self.consumer = consumer
        trusted.store_commit(seed)
        self.cert = DynamicCertifier(
            chain_id, seed.validators, seed.height(), verifier, consumer=consumer
        )

    @property
    def validators(self) -> ValidatorSet:
        return self.cert.validators

    def certify(self, fc: FullCommit) -> None:
        """Certify, auto-updating the trusted valset if it changed."""
        fc.validate_basic(self.chain_id)
        if fc.header.validators_hash != self.cert.validators.hash():
            self.update_to_height(fc.height())
            if fc.header.validators_hash != self.cert.validators.hash():
                raise ErrValidatorsChanged(
                    f"cannot establish validators for height {fc.height()}"
                )
        self.cert.certify(fc)
        self.trusted.store_commit(fc)

    def update_to_height(self, height: int) -> None:
        """Move the trusted valset to the one in force at `height`.

        This is the O(heights) SEQUENTIAL walk — kept as the reference
        baseline (and the `mode="sequential"` leg of
        `tendermint_lightclient_walk_seconds`); the JAX package's
        production read path, `lightclient/bisect.BisectingCertifier`
        (not yet in the port), replaces it with O(log n) batched
        skipping verification."""
        import time as _time

        from tendermint_tpu_torch.telemetry import metrics as _metrics

        t0 = _time.perf_counter()
        try:
            self._update_to_height(height)
        finally:
            _metrics.LIGHTCLIENT_WALK_SECONDS.labels(mode="sequential").observe(
                _time.perf_counter() - t0
            )

    def _update_to_height(self, height: int) -> None:
        # restart from the closest trusted commit at/below the target
        tfc = self.trusted.get_by_height(height)
        if tfc is not None and tfc.height() > self.cert.last_height:
            self.cert = DynamicCertifier(
                self.chain_id,
                tfc.validators,
                tfc.height(),
                self.verifier,
                consumer=self.consumer,
            )
        sfc = self.source.get_by_height(height)
        if sfc is None:
            raise ValidationError(f"no source commit at/below height {height}")
        if sfc.height() <= self.cert.last_height:
            # source lags our trust store: nothing newer to learn — the
            # caller's hash recheck reports ErrValidatorsChanged
            return
        self._update_via(sfc)

    def _update_via(self, sfc: FullCommit) -> None:
        """Try one update jump; on ErrTooMuchChange bisect through an
        intermediate height (reference `updateToHeight inquirer.go:100-120`)."""
        try:
            self.cert.update(sfc)
            self.trusted.store_commit(sfc)
            return
        except ErrTooMuchChange:
            pass
        lo, hi = self.cert.last_height, sfc.height()
        mid = (lo + hi) // 2
        if mid in (lo, hi):
            raise ErrTooMuchChange(
                f"cannot bridge validator change between {lo} and {hi}"
            )
        mfc = self.source.get_by_height(mid)
        if mfc is None or mfc.height() <= lo:
            raise ErrTooMuchChange(
                f"no intermediate commit between {lo} and {hi}"
            )
        self._update_via(mfc)  # first half (recursive bisection)
        self._update_via(sfc)  # then retry the target
