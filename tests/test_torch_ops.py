"""Parity of the port's plain ops (raw_ngp_torch.ops) with the JAX
package's, on the CPU: the same numpy inputs through both.

The hash encode is the plain version of the port's CUDA encode kernel; it
is held against both JAX encoders (the plain ``hash_encode_01`` and the
fused ``hash_encode_fused`` the field runs) in f32 at atol 1e-6. The CUDA
kernel itself is held against the plain version in
tests/test_torch_kernels.py, on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raw_ngp_torch.kernels import hash_encode as t_kernel
from raw_ngp_torch.ops import activation as tact
from raw_ngp_torch.ops import hashgrid as thg
from raw_ngp_torch.ops.grid import packbits as t_packbits
from raw_ngp_torch.ops.morton import morton3d as t_morton3d
from raw_ngp_torch.ops.rays import full_image_rays as t_full_image_rays
from raw_ngp_torch.ops.rays import near_far_from_aabb as t_near_far
from raw_ngp_torch.ops.sh import sh_encode as t_sh_encode
from raw_ngp_torch.render.occupancy import _floor_log2_p1 as t_floor_log2_p1
from raw_ngp_tpu.kernels.hash_fused import hash_encode_fused
from raw_ngp_tpu.ops import activation as jact
from raw_ngp_tpu.ops import hashgrid as jhg
from raw_ngp_tpu.ops.grid import packbits as j_packbits
from raw_ngp_tpu.ops.morton import morton3d as j_morton3d
from raw_ngp_tpu.ops.rays import full_image_rays as j_full_image_rays
from raw_ngp_tpu.ops.rays import near_far_from_aabb as j_near_far
from raw_ngp_tpu.ops.sh import sh_encode as j_sh_encode
from raw_ngp_tpu.render.occupancy import _floor_log2_p1 as j_floor_log2_p1


def _specs(**kw):
    """The same grid spec in both packages."""
    return jhg.HashGridSpec.create(**kw), thg.HashGridSpec.create(**kw)


def _points(rng, B, D=3):
    """Points in [0, 1]^D plus out-of-bounds rows, NaN rows and the exact
    faces 0 and 1."""
    x = rng.random((B, D)).astype(np.float32)
    x[:8] = x[:8] * 3.0 - 1.0
    x[8:12, 1] = np.nan
    x[12] = 0.0
    x[13] = 1.0
    return x


ENCODE_CASES = {
    "xor": dict(hash_variant="xor"),
    "additive": dict(hash_variant="additive"),
    "xor_align_smooth": dict(hash_variant="xor", align_corners=True,
                             interpolation="smoothstep"),
    "additive_align": dict(hash_variant="additive", align_corners=True),
    "tiled": dict(gridtype="tiled"),
}


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_hash_encode_01_matches_jax(case):
    # level 0 (res 16, 16^3 = 4096 rows) is dense; levels 1-3 are hashed
    js, ts = _specs(num_levels=4, level_dim=2, log2_hashmap_size=12,
                    desired_resolution=256, **ENCODE_CASES[case])
    assert ts.resolutions[0] ** 3 <= 4096 < ts.resolutions[1] ** 3
    assert ts.offsets == js.offsets
    rng = np.random.default_rng(0)
    table = rng.uniform(-1, 1, ts.n_params * 2).astype(np.float32)
    x = _points(rng, 512)
    out_j = np.asarray(jhg.hash_encode_01(jnp.asarray(table),
                                          jnp.asarray(x), js))
    out_t = thg.hash_encode_01(torch.from_numpy(table), torch.from_numpy(x),
                               ts).numpy()
    assert np.all(out_t[:12] == 0.0)          # out of bounds and NaN
    np.testing.assert_allclose(out_t, out_j, atol=1e-6, rtol=0)


@pytest.mark.parametrize("variant", ["additive", "xor"])
def test_hash_encode_matches_jax_fused(variant):
    """Against the fused encoder of the field, f32, at the flagship's grid
    shape cut down (2 levels x 16 channels; level 0 takes the fused
    encoder's matmul path, level 1 its window gathers)."""
    js, ts = _specs(num_levels=2, level_dim=16, log2_hashmap_size=12,
                    desired_resolution=128, hash_variant=variant)
    rng = np.random.default_rng(1)
    table = rng.uniform(-1, 1, ts.n_params * 16).astype(np.float32)
    x = _points(rng, 384)
    out_j = np.asarray(hash_encode_fused(jnp.asarray(table), jnp.asarray(x),
                                         js, False, None))
    out_t = thg.hash_encode_01(torch.from_numpy(table), torch.from_numpy(x),
                               ts).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=1e-6, rtol=0)


def test_hash_encode_world_and_max_level():
    js, ts = _specs(num_levels=3, level_dim=4, log2_hashmap_size=10,
                    desired_resolution=64)
    rng = np.random.default_rng(2)
    table = rng.uniform(-1, 1, ts.n_params * 4).astype(np.float32)
    x = rng.uniform(-2.2, 2.2, (256, 3)).astype(np.float32)
    out_j = np.asarray(jhg.hash_encode(jnp.asarray(table), jnp.asarray(x),
                                       js, bound=2.0, max_level=2))
    out_t = thg.hash_encode(torch.from_numpy(table), torch.from_numpy(x), ts,
                            bound=2.0, max_level=2).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=1e-6, rtol=0)
    assert np.all(out_t[:, 8:] == 0.0)


def test_hash_kernel_wrapper_uses_plain_version_on_cpu():
    """On a CPU tensor the wrapper returns the plain version's result and
    launches nothing; bf16 rounds values and weights, then sums in f32."""
    _, ts = _specs(num_levels=2, level_dim=16, log2_hashmap_size=12,
                   desired_resolution=128, hash_variant="additive")
    rng = np.random.default_rng(3)
    table = torch.from_numpy(
        rng.uniform(-1, 1, ts.n_params * 16).astype(np.float32))
    x = torch.from_numpy(_points(rng, 256))
    before = t_kernel.hash_encode.launches
    for dtype in (torch.float32, torch.bfloat16):
        out = t_kernel.hash_encode(table, x, ts, compute_dtype=dtype)
        ref = thg.hash_encode_01(table, x, ts, compute_dtype=dtype)
        assert out.dtype == dtype and torch.equal(out, ref)
    assert t_kernel.hash_encode.launches == before
    f32 = thg.hash_encode_01(table, x, ts)
    bf = thg.hash_encode_01(table, x, ts, compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(bf.float().numpy(), f32.numpy(), rtol=2e-2,
                               atol=2e-2)


def test_level_indices_match_jax():
    """Table rows of random corners, every level kind."""
    for kw in ENCODE_CASES.values():
        js, ts = _specs(num_levels=4, level_dim=2, log2_hashmap_size=12,
                        desired_resolution=256, **kw)
        rng = np.random.default_rng(4)
        for lv in range(4):
            c = rng.integers(0, ts.resolutions[lv], (200, 8, 3))
            rj = np.asarray(jhg._level_indices(js, lv, jnp.asarray(c)))
            rt = thg._level_indices(ts, lv, torch.from_numpy(c)).numpy()
            np.testing.assert_array_equal(rt, rj.astype(np.int64))


@pytest.mark.parametrize("degree", [1, 2, 4, 8])
def test_sh_encode_matches_jax(degree):
    rng = np.random.default_rng(5)
    d = rng.standard_normal((300, 3)).astype(np.float32)
    out_j = np.asarray(j_sh_encode(jnp.asarray(d), degree))
    out_t = t_sh_encode(torch.from_numpy(d), degree).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=1e-5, rtol=1e-5)


def test_morton3d_matches_jax():
    rng = np.random.default_rng(6)
    c = rng.integers(0, 1024, (4096, 3)).astype(np.int32)
    out_j = np.asarray(j_morton3d(jnp.asarray(c))).astype(np.int64)
    out_t = t_morton3d(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(out_t, out_j)


def test_rays_and_near_far_match_jax():
    rng = np.random.default_rng(7)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    pose[:3, 3] = rng.uniform(-3, 3, 3)
    intr = np.array([40.0, 42.0, 16.0, 12.0], np.float32)
    ro_j, rd_j = j_full_image_rays(jnp.asarray(pose), jnp.asarray(intr), 24,
                                   32)
    ro_t, rd_t = t_full_image_rays(torch.from_numpy(pose),
                                   torch.from_numpy(intr), 24, 32)
    np.testing.assert_allclose(ro_t.numpy(), np.asarray(ro_j), atol=1e-6)
    np.testing.assert_allclose(rd_t.numpy(), np.asarray(rd_j), atol=1e-6)
    aabb = np.array([-1.2, -1.0, -0.8, 1.2, 1.0, 0.8], np.float32)
    o = rng.uniform(-3, 3, (500, 3)).astype(np.float32)
    d = rng.standard_normal((500, 3)).astype(np.float32)
    nj, fj = j_near_far(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb))
    nt, ft = t_near_far(torch.from_numpy(o), torch.from_numpy(d),
                        torch.from_numpy(aabb))
    assert (np.asarray(fj) >= 1e8).any() and (np.asarray(fj) < 1e8).any()
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=1e-6)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-6)


@pytest.mark.parametrize("kind", ["density", "color", "internal"])
def test_activations_match_jax(kind):
    rng = np.random.default_rng(8)
    x = (rng.standard_normal(1000) * 8).astype(np.float32)
    fns = {"density": (["clamped_exp", "softplus"], jact.density_activation,
                       tact.density_activation),
           "color": (["exp", "sigmoid", "clamped_exp"],
                     jact.color_activation, tact.color_activation),
           "internal": (["relu", "softplus"], jact.internal_activation,
                        tact.internal_activation)}
    names, jf, tf = fns[kind]
    for name in names:
        out_j = np.asarray(jf(jnp.asarray(x), name))
        out_t = tf(torch.from_numpy(x), name).numpy()
        np.testing.assert_allclose(out_t, out_j, rtol=1e-6, atol=1e-6,
                                   err_msg=name)


def test_packbits_and_floor_log2_match_jax():
    rng = np.random.default_rng(9)
    dg = rng.uniform(0, 20, (2, 16 ** 3)).astype(np.float32)
    np.testing.assert_array_equal(
        t_packbits(torch.from_numpy(dg), 10.0).numpy(),
        np.asarray(j_packbits(jnp.asarray(dg), 10.0)))
    x = np.concatenate([rng.uniform(0, 5, 1000), [0.0, 1e-20, 0.5, 1.0, 2.0],
                        rng.uniform(0, 1e-3, 100)]).astype(np.float32)
    np.testing.assert_array_equal(
        t_floor_log2_p1(torch.from_numpy(x)).numpy(),
        np.asarray(j_floor_log2_p1(jnp.asarray(x))))

