"""The operator tools' `--device` rule: the card unless the caller asks for
the CPU, and no silent CPU fallback."""

from __future__ import annotations


def require_device(device: str, tool: str) -> None:
    """Exit with an error when `device` is a CUDA device and torch sees
    none; `--device cpu` runs every kernel's plain PyTorch version."""
    import torch
    try:
        kind = torch.device(device).type
    except RuntimeError as e:
        raise SystemExit(f"{tool}: --device {device!r}: {e}") from e
    if kind == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{tool}: --device {device}: no CUDA device (pass "
                         "--device cpu to run on the CPU)")
