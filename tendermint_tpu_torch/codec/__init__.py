"""Deterministic codecs.

The reference serializes every signed/persisted/wire structure with go-wire
(SURVEY.md §2b: `go-wire` deterministic binary/JSON codec). This package is a
clean-room equivalent: a compact varint-based deterministic binary codec
(`binary`) and canonical JSON for sign-bytes (`canonical_json`).

The port's copy of `tendermint_tpu.codec`: every encoding is byte-equal
to the JAX package's, so objects cross between the two packages only by
their wire form.
"""

from tendermint_tpu_torch.codec.binary import (
    Reader,
    Writer,
    decode_bytes,
    decode_string,
    decode_svarint,
    decode_uvarint,
    encode_bytes,
    encode_string,
    encode_svarint,
    encode_uvarint,
)
from tendermint_tpu_torch.codec.canonical_json import canonical_dumps

__all__ = [
    "Reader",
    "Writer",
    "encode_uvarint",
    "decode_uvarint",
    "encode_svarint",
    "decode_svarint",
    "encode_bytes",
    "decode_bytes",
    "encode_string",
    "decode_string",
    "canonical_dumps",
]
