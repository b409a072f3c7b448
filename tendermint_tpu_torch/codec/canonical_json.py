"""Canonical JSON for sign-bytes.

Signatures in the reference are over canonical JSON with alphabetically sorted
fields wrapped with the chain ID (`types/canonical_json.go:50-53`,
`types/signable.go`). Same contract here:

- keys sorted lexicographically at every level,
- compact separators (no whitespace),
- bytes values hex-encoded (uppercase, like the reference's go-wire JSON),
- integers as JSON numbers (all values fit int64 by type-layer validation),
- timestamps as integer nanoseconds since the Unix epoch (determinism —
  no float seconds, no timezone ambiguity).
"""

from __future__ import annotations

import json
from typing import Any


def _canonicalize(v: Any) -> Any:
    if isinstance(v, (bytes, bytearray, memoryview)):
        return bytes(v).hex().upper()
    if isinstance(v, dict):
        return {k: _canonicalize(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_canonicalize(x) for x in v]
    if isinstance(v, float):
        raise TypeError("floats are forbidden in canonical JSON (nondeterministic)")
    return v


def canonical_dumps(obj: Any) -> bytes:
    """Serialize to canonical JSON bytes (sorted keys, compact, hex bytes)."""
    return json.dumps(
        _canonicalize(obj), sort_keys=True, separators=(",", ":"), ensure_ascii=True
    ).encode("ascii")
