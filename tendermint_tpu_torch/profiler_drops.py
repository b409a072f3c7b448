"""Count the torch.profiler sessions on the card that lose their launches.

    python3 -m tendermint_tpu_torch.profiler_drops [SESSIONS]

Each session wraps REPS launches of `sha256_masked` over 65,536
messages of 250 bytes (the size of chip_smoke.py's `data_hash` block),
the card synchronised before the launches and after them, as
chip_smoke.py's `kernel_ms` does. The script prints one JSON line: the
torch version, the sessions, how many recorded each number of launches,
and how many recorded no device activity at all (the sessions
chip_smoke.py's `profiled` runs again). It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter

import numpy as np

REPS = 5
TXS = 65536
TX_BYTES = 250
SYMBOL = "sha256_masked_kernel"


def session(fn) -> tuple[int, bool]:
    """Launches of SYMBOL one profiler session around REPS calls of `fn`
    recorded, and whether it recorded any device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sum(e.count for e in device if SYMBOL in e.key), bool(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sessions", type=int, nargs="?", default=300)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profiler_drops: no CUDA device is available", file=sys.stderr)
        return 2
    from tendermint_tpu_torch.ops.padding import pad_sha256
    from tendermint_tpu_torch.ops.sha256_kernel import sha256_masked, to_words

    dev = torch.device("cuda")
    buf = np.random.default_rng(args.seed).bytes(TXS * TX_BYTES)
    blocks, n_blocks = pad_sha256([buf[i : i + TX_BYTES] for i in range(0, len(buf), TX_BYTES)])
    b, nb = to_words(blocks, dev), to_words(n_blocks, dev)
    sha256_masked(b, nb)  # build and warm
    seen = Counter()
    lost = 0
    for _ in range(args.sessions):
        n, any_device = session(lambda: sha256_masked(b, nb))
        seen[n] += 1
        lost += not any_device
    print(json.dumps({
        "torch": torch.__version__,
        "sessions": args.sessions,
        "launches_recorded": {str(k): v for k, v in sorted(seen.items())},
        "no_device_activity": lost,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
