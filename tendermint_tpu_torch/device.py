"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    current CUDA card. A CUDA device always comes back with its index
    (`"cuda"` names the current card, `cuda:<n>`), so one card has one
    name: per-device caches and a mesh's device list never hold it
    twice. Raises when no device is given and no card is present — the
    plain CPU path is only ever taken on request (`device="cpu"`)."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch path"
        )
    return torch.device("cuda", torch.cuda.current_device())
