"""Trust anchoring: never restore a snapshot whose app_hash is unproven.

A snapshot of height H claims an app_hash. That hash is carried by the
header at H+1 (app_hash in header H+1 is the app state after block H),
so the syncing node fetches the FullCommit (header + commit + valset)
for H+1 from the serving peers and certifies it through
`certifiers/certifier.py` before touching a single chunk:

* the configured trust root — (height, header hash) from config, the
  operator's out-of-band social-consensus input, exactly the light
  client's subjective initialization — pins which chain we are on;
* from the trust root's validator set, `DynamicCertifier` walks to the
  snapshot height: unchanged valsets certify directly (batched device
  signature verification), changed ones must be vouched for by >2/3 of
  the trusted set (`verify_commit_any`);
* the certified header's app_hash must equal the manifest's, and its
  validators_hash must match the validator set the restored state will
  run consensus with.

A commit that fails any step rejects the snapshot — the node keeps
discovering rather than trusting an unverified app_hash.

The port's copy of `tendermint_tpu/statesync/trust.py`. `verifier=None`
is the port's `default_verifier()`, the card's stack.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from tendermint_tpu_torch.certifiers.certifier import DynamicCertifier, FullCommit
from tendermint_tpu_torch.types.errors import ValidationError
from tendermint_tpu_torch.types.validator_set import ValidatorSet


@dataclass
class TrustOptions:
    """Operator-configured trust root (reference light-client TrustOptions).

    `height`/`hash_` pin one known-good header; 0/empty falls back to
    trusting the genesis validator set (fine for young chains, weak once
    the valset has rotated). `trust_period_ns` bounds how stale the
    anchoring header may be (0 disables the freshness check — in-process
    tests use deterministic genesis times far in the past)."""

    height: int = 0
    hash_: bytes = b""
    trust_period_ns: int = 0

    @classmethod
    def from_config(cls, cfg) -> "TrustOptions":
        return cls(
            height=cfg.trust_height,
            hash_=bytes.fromhex(cfg.trust_hash) if cfg.trust_hash else b"",
            trust_period_ns=int(cfg.trust_period_s * 1e9),
        )


class TrustAnchor:
    """Verifies snapshot manifests against the light-client trust chain."""

    def __init__(
        self,
        chain_id: str,
        base_validators: ValidatorSet,
        options: TrustOptions | None = None,
        verifier=None,
        now_ns=None,
    ) -> None:
        self.chain_id = chain_id
        self.base_validators = base_validators
        self.options = options or TrustOptions()
        self.verifier = verifier
        self._now_ns = now_ns or (lambda: time.time_ns())

    def anchor_height(self, snapshot_height: int) -> int:
        """The header height that proves a snapshot's app_hash."""
        return snapshot_height + 1

    def verify_pin(self, fc: FullCommit) -> None:
        """Check a fetched FullCommit against the configured trust root.
        The pin is trusted by CONFIG (subjective initialization): its
        header hash must equal the operator's, and the carried valset
        must be the one the header names — no signature check can
        strengthen a root the operator already chose."""
        opts = self.options
        if fc.height() != opts.height:
            raise ValidationError(
                f"trust pin wants height {opts.height}, got {fc.height()}"
            )
        fc.validate_basic(self.chain_id)
        if fc.header.hash() != opts.hash_:
            raise ValidationError(
                f"header hash at trust height {opts.height} is "
                f"{fc.header.hash().hex()[:16]}, pinned {opts.hash_.hex()[:16]}"
            )

    def verify_snapshot(
        self,
        manifest,
        anchor_fc: FullCommit,
        pin_fc: FullCommit | None = None,
    ) -> None:
        """Certify `anchor_fc` (the FullCommit at manifest.height + 1)
        and bind the manifest to it. Raises ValidationError (or a
        certifier error subclass) on any failure."""
        if manifest.chain_id != self.chain_id:
            raise ValidationError(
                f"snapshot for chain {manifest.chain_id!r}, want {self.chain_id!r}"
            )
        if anchor_fc.height() != self.anchor_height(manifest.height):
            raise ValidationError(
                f"anchor commit at {anchor_fc.height()}, "
                f"want {self.anchor_height(manifest.height)}"
            )
        opts = self.options
        if opts.height > 0:
            if manifest.height < opts.height:
                raise ValidationError(
                    f"snapshot height {manifest.height} below trust root {opts.height}"
                )
            if pin_fc is None:
                raise ValidationError("trust root configured but no pin commit fetched")
            self.verify_pin(pin_fc)
            cert = DynamicCertifier(
                self.chain_id,
                pin_fc.validators,
                opts.height,
                self.verifier,
                consumer="statesync",
            )
        else:
            cert = DynamicCertifier(
                self.chain_id,
                self.base_validators,
                0,
                self.verifier,
                consumer="statesync",
            )
        if opts.trust_period_ns > 0:
            age = self._now_ns() - anchor_fc.header.time
            if age > opts.trust_period_ns:
                raise ValidationError(
                    f"anchoring header is {age / 1e9:.0f}s old, "
                    f"trust period {opts.trust_period_ns / 1e9:.0f}s"
                )
        # certify: same valset verifies directly (one batched device
        # call); a changed set must carry >2/3 of the trusted set's
        # signatures (DynamicCertifier.update / verify_commit_any)
        if anchor_fc.header.validators_hash == cert.validators.hash():
            cert.certify(anchor_fc)
        else:
            cert.update(anchor_fc)
        # the certified header vouches for the snapshot's app state ...
        if anchor_fc.header.app_hash != manifest.app_hash:
            raise ValidationError(
                f"certified app_hash {anchor_fc.header.app_hash.hex()[:16]} != "
                f"manifest app_hash {manifest.app_hash.hex()[:16]}"
            )

    def verify_restored_state(self, state, anchor_fc: FullCommit) -> None:
        """Post-restore check: the decoded state must be the one the
        certified header names — a chunk payload that verifies against
        the root but decodes to a different chain/valset/app_hash is a
        manifest-level forgery."""
        if state.chain_id != self.chain_id:
            raise ValidationError("restored state has wrong chain id")
        if state.app_hash != anchor_fc.header.app_hash:
            raise ValidationError("restored state app_hash not certified")
        # state.validators is the set for height H+1 — exactly the set
        # the anchoring header (at H+1) must name
        if state.validators.hash() != anchor_fc.header.validators_hash:
            raise ValidationError("restored validator set not certified")
