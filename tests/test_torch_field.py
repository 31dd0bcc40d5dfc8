"""Parity of the port's radiance field (raw_ngp_torch.models.ngp) with the
JAX ``field_forward`` / ``field_density`` at converted parameters.

The field is the flagship's cut to the golden miniature (2 levels x 16
channels, additive hash, log2 12, MLP hidden 16). f32 is held at atol
1e-5. Under ``fp16`` both packages compute in bf16 but round at other
places: the JAX fused encoder rounds each corner product (and its dense
level's matmul partial sums) to bf16, the port rounds only the table
values, the weights and the f32 sum. Features then differ by a bf16 ulp
or two, which the bf16 MLPs carry on: measured on this input at most
3.0e-3 relative on sigma and 2.5e-3 on color, so the bf16 test allows
1e-2 relative.
"""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raw_ngp_torch.config as tcfg
import raw_ngp_tpu.config as jcfg
from raw_ngp_torch.convert import field_from_jax
from raw_ngp_torch.models.ngp import init_field as t_init_field
from raw_ngp_torch.models.ngp import make_field_spec as t_make_spec
from raw_ngp_tpu.models.ngp import field_density as j_field_density
from raw_ngp_tpu.models.ngp import field_forward as j_field_forward
from raw_ngp_tpu.models.ngp import init_field as j_init_field
from raw_ngp_tpu.models.ngp import make_field_spec as j_make_spec


def _cfg(mod, fp16):
    cfg = mod.Config().with_preset_O().with_tpu_profile()
    cfg = replace(cfg, model=replace(
        cfg.model, log2_hashmap_size=12, hashgrid_resolution=64,
        grid_mlp_hidden=16, view_mlp_hidden=16))
    return replace(cfg, train=replace(cfg.train, fp16=fp16)).validate()


def _pair(fp16, table_scale):
    jspec, tspec = j_make_spec(_cfg(jcfg, fp16)), t_make_spec(_cfg(tcfg, fp16))
    params = jax.tree_util.tree_map(
        np.asarray, j_init_field(jax.random.PRNGKey(1), jspec))
    # a table of trained-like magnitude, so the grid features matter
    rng = np.random.default_rng(0)
    params["grid"] = rng.uniform(-table_scale, table_scale,
                                 params["grid"].shape).astype(np.float32)
    return jspec, tspec, params, field_from_jax(params, tspec, device="cpu")


def _inputs(n=512):
    rng = np.random.default_rng(1)
    x = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return x, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("fp16", [False, True])
def test_field_forward_matches_jax(fp16):
    jspec, tspec, params, field = _pair(fp16, 1.0)
    assert tspec.compute_dtype == (torch.bfloat16 if fp16 else torch.float32)
    x, d = _inputs()
    sig_j, rgb_j = (np.asarray(a) for a in j_field_forward(
        params, jspec, jnp.asarray(x), jnp.asarray(d)))
    with torch.no_grad():
        sig_t, rgb_t = (a.numpy() for a in field(torch.from_numpy(x),
                                                 torch.from_numpy(d)))
        den_t = field.density(torch.from_numpy(x)).numpy()
    den_j = np.asarray(j_field_density(params, jspec, jnp.asarray(x)))
    assert sig_t.shape == (512,) and rgb_t.shape == (512, 3)
    if fp16:
        tol = dict(rtol=1e-2, atol=0)
    else:
        tol = dict(rtol=0, atol=1e-5)
    np.testing.assert_allclose(sig_t, sig_j, **tol)
    np.testing.assert_allclose(rgb_t, rgb_j, **tol)
    np.testing.assert_allclose(den_t, den_j, **tol)
    np.testing.assert_array_equal(den_t, sig_t)


def test_init_field_layout():
    """Seeded init: table U(+-1e-4) flat [n_params*C], bias-free MLP
    weights [in, out] in the Kaiming-uniform range; the same layout as
    the JAX pytree, so converted and native fields are interchangeable."""
    tspec = t_make_spec(_cfg(tcfg, True))
    f1 = t_init_field(tspec, seed=3, device="cpu")
    f2 = t_init_field(tspec, seed=3, device="cpu")
    jparams = j_init_field(jax.random.PRNGKey(0), j_make_spec(_cfg(jcfg,
                                                                   True)))
    assert f1.grid.shape == jparams["grid"].shape
    assert f1.grid.abs().max() <= 1e-4
    assert torch.equal(f1.grid, f2.grid)
    for name in ("grid_mlp", "view_mlp"):
        shapes_t = [tuple(w.shape) for w in getattr(f1, name)]
        shapes_j = [tuple(l["w"].shape) for l in jparams[name]]
        assert shapes_t == shapes_j
        for w in getattr(f1, name):
            assert w.abs().max() <= np.sqrt(3.0 / w.shape[0])


def test_entry_points_raise_without_cuda():
    """The default device is CUDA, and no entry point drops to the CPU on
    its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from raw_ngp_torch.convert import bitfield_from_jax
    from raw_ngp_torch.ops.grid import init_grid_state
    cfg = _cfg(tcfg, True)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_init_field(t_make_spec(cfg), seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_grid_state(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        bitfield_from_jax(np.zeros(8, np.uint8))
