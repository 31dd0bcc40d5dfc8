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
