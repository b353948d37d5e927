"""Device selection for the port's entry points.

Entry points take ``device`` (default ``"cuda"``). A CUDA request with
no card present raises at once: nothing falls back to the CPU behind the
caller's back. Tests pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda."
                f"is_available() is False; pass device='cpu' to run the "
                f"plain PyTorch path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} "
                         f"(expected 'cuda' or 'cpu')")
    return dev


def resolve_devices(devices) -> list[torch.device]:
    """:func:`resolve_device` of each entry of a device list (one entry a
    shard or an LPT bin; entries may repeat), a CUDA entry without an index
    taking the current card's, so that equal cards compare equal."""
    out = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    if not out:
        raise ValueError("a device list needs at least one device")
    return out
