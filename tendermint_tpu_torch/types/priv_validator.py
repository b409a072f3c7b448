"""PrivValidator: the consensus signer with double-sign prevention.

Reference `types/priv_validator.go` — persists LastHeight/Round/Step (+ last
sign-bytes and signature) and refuses any regression; returns the cached
signature when asked to re-sign identical bytes (`signBytesHRS:225-275`).
The `Signer` seam (`:74-76`) keeps HSM/remote-signer integration open.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass

from tendermint_tpu_torch.crypto import PrivKey, PubKey, gen_priv_key
from tendermint_tpu_torch.types.errors import ErrDoubleSign
from tendermint_tpu_torch.types.heartbeat import Heartbeat
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT, VOTE_TYPE_PREVOTE, Vote

STEP_NONE = 0
STEP_PROPOSE = 1
STEP_PREVOTE = 2
STEP_PRECOMMIT = 3


def vote_to_step(vote: Vote) -> int:
    if vote.type == VOTE_TYPE_PREVOTE:
        return STEP_PREVOTE
    if vote.type == VOTE_TYPE_PRECOMMIT:
        return STEP_PRECOMMIT
    raise ValueError(f"unknown vote type {vote.type}")


class Signer:
    """Pluggable signing backend (reference `Signer` interface :74-76)."""

    def sign(self, msg: bytes) -> bytes:
        raise NotImplementedError

    def pub_key(self) -> PubKey:
        raise NotImplementedError


class DefaultSigner(Signer):
    def __init__(self, priv_key: PrivKey):
        self._priv_key = priv_key

    def sign(self, msg: bytes) -> bytes:
        return self._priv_key.sign(msg)

    def pub_key(self) -> PubKey:
        return self._priv_key.pub_key


@dataclass
class _LastSignState:
    height: int = 0
    round: int = 0
    step: int = STEP_NONE
    signature: bytes = b""
    sign_bytes: bytes = b""


class PrivValidator:
    """In-memory priv validator; see `PrivValidatorFS` for the file-backed one."""

    def __init__(self, priv_key: PrivKey, signer: Signer | None = None):
        self._signer = signer or DefaultSigner(priv_key)
        self.pub_key = self._signer.pub_key()
        self.address = self.pub_key.address
        self._last = _LastSignState()
        self._lock = threading.RLock()

    # -- persistence hook (overridden by PrivValidatorFS) --------------------

    def _save(self) -> None:
        pass

    # -- HRS guard -----------------------------------------------------------

    def _check_hrs(self, height: int, round_: int, step: int, sign_bytes: bytes) -> bytes | None:
        """Returns a cached signature to reuse, or None to proceed with a
        fresh signature. Raises ErrDoubleSign on any regression/conflict
        (reference `signBytesHRS:225-275`)."""
        last = self._last
        if (height, round_, step) < (last.height, last.round, last.step):
            raise ErrDoubleSign(
                f"sign regression: have {last.height}/{last.round}/{last.step}, "
                f"asked {height}/{round_}/{step}"
            )
        if (height, round_, step) == (last.height, last.round, last.step):
            if sign_bytes == last.sign_bytes:
                return last.signature  # idempotent re-sign
            raise ErrDoubleSign(
                f"conflicting sign-bytes at {height}/{round_}/{step}"
            )
        return None

    def _sign_and_record(self, height: int, round_: int, step: int, sign_bytes: bytes) -> bytes:
        with self._lock:
            cached = self._check_hrs(height, round_, step, sign_bytes)
            if cached is not None:
                return cached
            sig = self._signer.sign(sign_bytes)
            self._last = _LastSignState(
                height=height, round=round_, step=step, signature=sig, sign_bytes=sign_bytes
            )
            self._save()
            return sig

    # -- public signing API ---------------------------------------------------

    def _timestamp_tolerant_cached(
        self, kind: str, height: int, round_: int, step: int, sign_bytes: bytes
    ) -> tuple[int, bytes] | None:
        """If we already signed the SAME (h, r, s) payload differing only
        in its timestamp — the crash-replay case: a restarted node
        rebuilds the vote/proposal with a fresh clock — return the
        cached (timestamp, signature) so the caller re-emits the
        original artifact instead of double-signing or wedging
        (reference checkVotesOnlyDifferByTimestamp; without this a
        crashed solo validator can never re-vote at its in-progress
        height and halts forever)."""
        last = self._last
        if (height, round_, step) != (last.height, last.round, last.step):
            return None
        if not last.sign_bytes or sign_bytes == last.sign_bytes:
            return None
        try:
            now_doc = json.loads(sign_bytes)
            last_doc = json.loads(last.sign_bytes)
        except ValueError:
            return None
        last_ts = last_doc.get(kind, {}).get("timestamp")
        if last_ts is None:
            return None
        now_doc.get(kind, {}).pop("timestamp", None)
        last_doc.get(kind, {}).pop("timestamp", None)
        if now_doc != last_doc:
            return None
        return last_ts, last.signature

    def sign_vote(self, chain_id: str, vote: Vote) -> Vote:
        from dataclasses import replace as _replace

        with self._lock:
            step = vote_to_step(vote)
            cached = self._timestamp_tolerant_cached(
                "vote", vote.height, vote.round, step, vote.sign_bytes(chain_id)
            )
            if cached is not None:
                ts, sig = cached
                return _replace(vote, timestamp=ts, signature=sig)
            sig = self._sign_and_record(
                vote.height, vote.round, step, vote.sign_bytes(chain_id)
            )
        return vote.with_signature(sig)

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> Proposal:
        from dataclasses import replace as _replace

        with self._lock:
            cached = self._timestamp_tolerant_cached(
                "proposal",
                proposal.height,
                proposal.round,
                STEP_PROPOSE,
                proposal.sign_bytes(chain_id),
            )
            if cached is not None:
                ts, sig = cached
                return _replace(proposal, timestamp=ts, signature=sig)
            sig = self._sign_and_record(
                proposal.height, proposal.round, STEP_PROPOSE,
                proposal.sign_bytes(chain_id),
            )
        return proposal.with_signature(sig)

    def sign_heartbeat(self, chain_id: str, hb: Heartbeat) -> Heartbeat:
        # No HRS check for heartbeats (reference `SignHeartbeat`).
        return hb.with_signature(self._signer.sign(hb.sign_bytes(chain_id)))

    def __repr__(self) -> str:
        return f"PrivValidator({self.address.hex()[:12]})"


class PrivValidatorFS(PrivValidator):
    """File-backed priv validator with atomic persistence
    (reference `types/priv_validator.go:163-183`)."""

    def __init__(self, file_path: str, priv_key: PrivKey, last: _LastSignState | None = None):
        super().__init__(priv_key)
        self._priv_key = priv_key
        self.file_path = file_path
        if last is not None:
            self._last = last

    def _save(self) -> None:
        doc = {
            "address": self.address.hex(),
            "pub_key": self.pub_key.data.hex(),
            "priv_key_seed": self._priv_key.seed.hex(),
            "last_height": self._last.height,
            "last_round": self._last.round,
            "last_step": self._last.step,
            "last_signature": self._last.signature.hex(),
            "last_signbytes": self._last.sign_bytes.hex(),
        }
        tmp = self.file_path + ".tmp"
        # signing key material: owner-only from creation (reference
        # WriteFileAtomic 0600), never umask-dependent
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.file_path)  # atomic on POSIX

    def save(self) -> None:
        with self._lock:
            self._save()

    def reset(self) -> None:
        """Danger: forget sign state (test/ops only, reference `Reset`)."""
        with self._lock:
            self._last = _LastSignState()
            self._save()

    @classmethod
    def load(cls, file_path: str) -> "PrivValidatorFS":
        with open(file_path) as f:
            doc = json.load(f)
        last = _LastSignState(
            height=doc["last_height"],
            round=doc["last_round"],
            step=doc["last_step"],
            signature=bytes.fromhex(doc["last_signature"]),
            sign_bytes=bytes.fromhex(doc["last_signbytes"]),
        )
        return cls(file_path, PrivKey(bytes.fromhex(doc["priv_key_seed"])), last)

    @classmethod
    def load_or_gen(cls, file_path: str, seed: bytes | None = None) -> "PrivValidatorFS":
        """Reference `LoadOrGenPrivValidatorFS types/priv_validator.go:131-140`."""
        if os.path.exists(file_path):
            return cls.load(file_path)
        pv = cls(file_path, gen_priv_key(seed))
        pv.save()
        return pv
