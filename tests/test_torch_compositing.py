"""Parity of the port's compacted composite
(raw_ngp_torch.ops.compositing.composite_rays_compacted) with the JAX
package's, on the CPU, forward and backward.

The stream is built as tests/test_compositing.py builds it (JAX's
compact_positions and gather_flat_sorted of a seeded [N, K] grid, m_pad
small enough to truncate rays, an empty and a full ray), and the same
numpy stream goes into both functions. The colours are either in [0, 1]
(LDR) or the HDR head's clamped_exp colours, exp(c - 5) clamped at 5, so
that the composite sums values above 1 as it does on the light-stage
path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw_ngp_torch.ops.compositing import composite_rays_compacted as t_comp
from raw_ngp_tpu.ops.activation import color_activation
from raw_ngp_tpu.ops.compositing import composite_rays_compacted as j_comp
from raw_ngp_tpu.render.occupancy import compact_positions, gather_flat_sorted

N, K, M_PAD = 40, 24, 512


def _stream(colours, seed=7):
    """The compacted stream (numpy) of a seeded [N, K] grid, and seeded
    cotangents of image, depth and weights_sum."""
    rng = np.random.default_rng(seed)
    sigmas = rng.uniform(0, 30, (N, K)).astype(np.float32)
    sigmas[::5] *= 0.02                   # rays that stay translucent
    if colours == "unit":
        rgbs = rng.uniform(0, 1, (N, K, 3)).astype(np.float32)
    else:
        rgbs = np.asarray(color_activation(jnp.asarray(
            rng.uniform(2.0, 8.0, (N, K, 3)).astype(np.float32)),
            "clamped_exp"))
    ts = np.cumsum(rng.uniform(0.01, 0.1, (N, K)), axis=1).astype(
        np.float32)
    deltas = rng.uniform(0.01, 0.1, (N, K)).astype(np.float32)
    mask = rng.uniform(size=(N, K)) > 0.4
    mask[3] = False                       # an empty ray
    mask[7] = True                        # a full ray
    kept, _, pos = compact_positions(jnp.asarray(mask), M_PAD)
    filled = pos < N * K
    rid = jnp.where(filled, jnp.minimum(pos, N * K - 1) // K, N)

    def gather(a):
        return np.array(gather_flat_sorted(jnp.asarray(a).reshape(-1),
                                           pos))

    out = {"sig": gather(sigmas), "t": gather(ts), "dt": gather(deltas),
           "rgb": np.stack([gather(rgbs[..., c]) for c in range(3)], -1),
           "rid": np.array(rid, np.int32), "filled": np.array(filled),
           "counts": np.asarray(kept).sum(-1).astype(np.int32)}
    assert out["counts"].sum() == M_PAD       # truncated to the budget
    out["cot"] = (rng.standard_normal((N, 3)).astype(np.float32),
                  rng.standard_normal(N).astype(np.float32),
                  rng.standard_normal(N).astype(np.float32))
    return out


@pytest.mark.parametrize("t_thresh", [0.0, 1e-4])
@pytest.mark.parametrize("colours", ["unit", "hdr"])
def test_composite_rays_compacted_matches_jax(colours, t_thresh):
    """Forward: image, depth and weights_sum within 1e-6 of each output's
    largest entry: the port's scan makes JAX's additions in JAX's order
    (it skips only shifts past the longest ray, which add zeros), but
    PyTorch's CPU exp and XLA's round an ulp apart (measured at most
    6.0e-8 with colours in [0, 1], 2.5e-7 on HDR images up to 5).
    Backward, the gradients in sigmas and rgbs of a seeded linear
    function of the three outputs: autograd's transposed scans sum in
    another order than XLA's, so within 1e-6 of each gradient's largest
    entry (measured at most 1.4e-7)."""
    s = _stream(colours)
    assert (s["rgb"].max() > 1.0) == (colours == "hdr")
    cot_img, cot_d, cot_w = s["cot"]

    def j_loss(sig, rgb):
        o = j_comp(sig, rgb, jnp.asarray(s["t"]), jnp.asarray(s["dt"]),
                   jnp.asarray(s["rid"]), jnp.asarray(s["filled"]),
                   jnp.asarray(s["counts"]), N, t_thresh=t_thresh)
        loss = ((o["image"] * cot_img).sum() + (o["depth"] * cot_d).sum()
                + (o["weights_sum"] * cot_w).sum())
        return loss, o

    (_, out_j), (g_sig_j, g_rgb_j) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(s["sig"]),
                                              jnp.asarray(s["rgb"]))
    sig = torch.from_numpy(s["sig"]).requires_grad_()
    rgb = torch.from_numpy(s["rgb"]).requires_grad_()
    out_t = t_comp(sig, rgb, torch.from_numpy(s["t"]),
                   torch.from_numpy(s["dt"]), torch.from_numpy(s["rid"]),
                   torch.from_numpy(s["filled"]),
                   torch.from_numpy(s["counts"]), N, K, t_thresh=t_thresh)
    ((out_t["image"] * torch.from_numpy(cot_img)).sum()
     + (out_t["depth"] * torch.from_numpy(cot_d)).sum()
     + (out_t["weights_sum"] * torch.from_numpy(cot_w)).sum()).backward()
    assert float(np.asarray(out_j["weights_sum"]).max()) > 0.9
    assert float(np.asarray(out_j["weights_sum"]).min()) == 0.0  # empty ray
    for k in ("image", "depth", "weights_sum"):
        want = np.asarray(out_j[k])
        np.testing.assert_allclose(out_t[k].detach().numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=k)
    for name, got, want in (("sigmas", sig.grad, g_sig_j),
                            ("rgbs", rgb.grad, g_rgb_j)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=name)
