"""PyTorch/CUDA port of `tendermint_tpu`'s ed25519 verify path.

The package imports torch, numpy and the standard library only; it keeps
its own copies of whatever it needs from the JAX package, which stays in
the repository as the reference the port is tested against.

Entry points (`services.verifier`, `ops.ed25519_kernel.batch_verify`,
`ops.ed25519_tables.build_key_tables`, ...) run on the CUDA card unless
the caller passes `device="cpu"`. Without a card and without an explicit
device they raise; they never drop to the CPU on their own.
"""

from tendermint_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
