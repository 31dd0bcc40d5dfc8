"""Device selection for the port's entry points.

Entry points take an explicit ``device`` (default ``"cuda"``) and never
drop to the CPU on their own: asking for CUDA where there is none raises.
The CPU is used only when the caller names it, as the parity tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch.device; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "raw_ngp_torch: CUDA device requested but torch.cuda is not "
            "available; pass device='cpu' to run the plain versions")
    return dev


def ordered_index_add(out, idx, src):
    """``out.index_add_(0, idx, src)`` with each row's adds in a fixed
    order on every device: on the card ``index_add_`` adds with atomics,
    in an order that changes from run to run, so there the sorting
    ``index_put_(accumulate=True)`` sums each run of equal indices in
    order; on the CPU ``index_add_`` adds in source order (its
    ``index_put_`` with more than one thread does not). Returns ``out``."""
    if out.device.type == "cuda":
        return out.index_put_((idx,), src, accumulate=True)
    return out.index_add_(0, idx, src)
