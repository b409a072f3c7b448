"""Version info (reference: version/version.go:3-10)."""

MAJOR = 0
MINOR = 1
PATCH = 0

__version__ = f"{MAJOR}.{MINOR}.{PATCH}"

# Wire-protocol compatibility versions, checked during the p2p handshake
# (reference: p2p/switch.go version/chainID compat check).
BLOCK_PROTOCOL = 1
P2P_PROTOCOL = 1
