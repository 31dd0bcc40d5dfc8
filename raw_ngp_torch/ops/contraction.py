"""MeRF-style L-infinity scene contraction (port of
``raw_ngp_tpu/ops/contraction.py``: ``contract`` ``:17``, ``uncontract``
``:31``).

Identity inside the unit cube; outside, the dominant axis maps to
sign * (2 - 1/m) and the others scale by 1/m, for m = |x|_inf. Every axis
that ties at the maximum takes the dominant axis's scale, as in the JAX
package, and the maximum's gradient is split evenly among the ties
(``torch.amax``, as JAX's ``max`` differentiates).
"""

from __future__ import annotations

import torch


def contract(x):
    """[-inf, inf]^C -> [-2, 2]^C, identity within the unit cube."""
    mag = torch.abs(x).amax(dim=-1, keepdim=True)
    # avoid div-by-zero at the origin; the result there is selected away
    safe_mag = torch.maximum(mag, mag.new_tensor(1e-12))
    is_max = torch.abs(x) == mag
    scale = torch.where(is_max, (2.0 - 1.0 / safe_mag) / safe_mag,
                        1.0 / safe_mag)
    return torch.where(mag <= 1.0, x, x * scale)


def uncontract(z):
    """Inverse of :func:`contract`."""
    mag = torch.abs(z).amax(dim=-1, keepdim=True)
    is_max = torch.abs(z) == mag
    denom_other = torch.maximum(2.0 - mag, mag.new_tensor(1e-8))
    denom_max = torch.maximum(2.0 * mag - mag * mag, mag.new_tensor(1e-8))
    scale = torch.where(is_max, 1.0 / denom_max, 1.0 / denom_other)
    return torch.where(mag <= 1.0, z, z * scale)
