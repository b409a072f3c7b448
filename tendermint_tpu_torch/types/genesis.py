"""GenesisDoc (reference `types/genesis.go`): the chain's initial conditions."""

from __future__ import annotations

import json
import time as _time
from dataclasses import dataclass, field

from tendermint_tpu_torch.crypto import PubKey
from tendermint_tpu_torch.types.errors import ValidationError
from tendermint_tpu_torch.types.params import ConsensusParams
from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet


@dataclass
class GenesisValidator:
    pub_key: PubKey
    power: int
    name: str = ""

    def to_validator(self) -> Validator:
        return Validator(
            address=self.pub_key.address, pub_key=self.pub_key, voting_power=self.power
        )


@dataclass
class GenesisDoc:
    chain_id: str
    genesis_time: int = 0  # ns since epoch
    consensus_params: ConsensusParams = field(default_factory=ConsensusParams)
    validators: list[GenesisValidator] = field(default_factory=list)
    app_hash: bytes = b""
    app_options: dict = field(default_factory=dict)

    def validate_and_complete(self) -> None:
        """Reference `GenesisDoc` validation (`types/genesis.go:56`)."""
        if not self.chain_id:
            raise ValidationError("genesis doc must include non-empty chain_id")
        self.consensus_params.validate()
        if not self.validators:
            raise ValidationError("genesis doc must include at least one validator")
        for v in self.validators:
            if v.power < 0:
                raise ValidationError("genesis validator with negative power")
        if self.genesis_time == 0:
            self.genesis_time = _time.time_ns()

    def validator_set(self) -> ValidatorSet:
        return ValidatorSet([v.to_validator() for v in self.validators])

    def validator_hash(self) -> bytes:
        return self.validator_set().hash()

    # -- JSON persistence -----------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(
            {
                "chain_id": self.chain_id,
                "genesis_time": self.genesis_time,
                "consensus_params": self.consensus_params.to_dict(),
                "validators": [
                    {"pub_key": v.pub_key.data.hex(), "power": v.power, "name": v.name}
                    for v in self.validators
                ],
                "app_hash": self.app_hash.hex(),
                "app_options": self.app_options,
            },
            indent=2,
            sort_keys=True,
        )

    @classmethod
    def from_json(cls, s: str) -> "GenesisDoc":
        d = json.loads(s)
        doc = cls(
            chain_id=d["chain_id"],
            genesis_time=d.get("genesis_time", 0),
            consensus_params=ConsensusParams.from_dict(d.get("consensus_params", {})),
            validators=[
                GenesisValidator(
                    pub_key=PubKey(bytes.fromhex(v["pub_key"])),
                    power=v["power"],
                    name=v.get("name", ""),
                )
                for v in d.get("validators", [])
            ],
            app_hash=bytes.fromhex(d.get("app_hash", "")),
            app_options=d.get("app_options", {}),
        )
        doc.validate_and_complete()
        return doc

    def save_as(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_file(cls, path: str) -> "GenesisDoc":
        with open(path) as f:
            return cls.from_json(f.read())
