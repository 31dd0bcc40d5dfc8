"""The port's mesh extraction (raw_ngp_torch.mesh.extract), metrics
(raw_ngp_torch.train.metrics) and Sobel normals
(raw_ngp_torch.postprocess.raw.depth_to_normal) against the JAX
package's, on the CPU, as tests/test_mesh_ckpt_metrics.py exercises them.

The numpy functions are copies, so their outputs are held identical
(array_equal; the PLY files byte for byte) on the same inputs, and SSIM
and RMSE within 1e-12. The density sweep runs each package's field at
the flagship's miniature (2 levels x 16 channels, a 2^12 table of
trained-like magnitude, f32) with the port's field converted from the JAX
parameters: sigma within the field tests' f32 tolerance (rtol 1e-5, atol
1e-5; measured below 1e-6 relative). ``depth_to_normal`` writes cv2's 3x3
Sobel in numpy: within 1e-6 of the JAX package's cv2 version, where cv2
imports.
"""

import os
from dataclasses import replace
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import raw_ngp_torch.config as tcfg
import raw_ngp_tpu.config as jcfg
from raw_ngp_torch.convert import field_from_jax
from raw_ngp_torch.mesh import extract as tme
from raw_ngp_torch.models.ngp import make_field_spec as t_make_spec
from raw_ngp_torch.postprocess.raw import depth_to_normal as t_normal
from raw_ngp_torch.train import metrics as tmet
from raw_ngp_tpu.data.synthetic import look_at_pose
from raw_ngp_tpu.mesh import extract as jme
from raw_ngp_tpu.models.ngp import init_field as j_init_field
from raw_ngp_tpu.models.ngp import make_field_spec as j_make_spec
from raw_ngp_tpu.train import metrics as jmet


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work, set back after
    it (under pytest-xdist torch's default of a thread a core
    oversubscribes the cores: tests/test_torch_proposal.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sphere_grid(R=48, radius=0.6, floater=False):
    ax = np.linspace(-1, 1, R)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    grid = (radius - np.sqrt(x ** 2 + y ** 2 + z ** 2)).astype(np.float32)
    if floater:
        grid[2, 2, 2] = 1.0
    return grid


def _noise_grid(R=24, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (R, R, R)).astype(np.float32)


GRIDS = {"sphere": lambda: (_sphere_grid(), 0.0),
         "sphere_floater": lambda: (_sphere_grid(floater=True), 0.0),
         "noise": lambda: (_noise_grid(), 0.3),
         "empty": lambda: (_sphere_grid(24), 5.0)}


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_marching_clean_decimate_match_jax(name):
    grid, thresh = GRIDS[name]()
    vt, ft = tme.marching_tetrahedra(grid, thresh)
    _same((vt, ft), jme.marching_tetrahedra(grid, thresh))
    if name == "empty":
        assert len(ft) == 0
        return
    assert len(ft) > 100
    _same(tme.clean_mesh(vt, ft, 100), jme.clean_mesh(vt, ft, 100))
    target = len(ft) // 4
    _same(tme.decimate_mesh(vt, ft, target),
          jme.decimate_mesh(vt, ft, target))


@pytest.mark.parametrize("eye", [(3.0, 0.0, 0.0), (0.5, 2.5, 1.0)])
def test_mark_unseen_triangles_matches_jax(eye):
    R = 32
    verts, faces = jme.marching_tetrahedra(_sphere_grid(R), 0.0)
    verts = verts / (R - 1) * 2 - 1
    pose = look_at_pose(np.array(eye), np.zeros(3))
    intr = np.array([50.0, 50.0, 32, 32])
    unseen = tme.mark_unseen_triangles(verts, faces, pose[None], intr, 64,
                                       64)
    np.testing.assert_array_equal(
        unseen, jme.mark_unseen_triangles(verts, faces, pose[None], intr,
                                          64, 64))
    assert 0 < unseen.sum() < len(faces)


def test_ply_files_match_jax(tmp_path):
    verts, faces = jme.marching_tetrahedra(_sphere_grid(24), 0.0)
    tme.export_ply(verts, faces, str(tmp_path / "t.ply"))
    jme.export_ply(verts, faces, str(tmp_path / "j.ply"))
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    _same(tme.load_ply(str(tmp_path / "j.ply")), (verts, faces))


def _field_cfg(mod, bound=2.0):
    """The flagship's miniature of tests/test_torch_field.py (f32), with
    32^3 meshes."""
    cfg = mod.Config().with_preset_O().with_tpu_profile()
    cfg = replace(cfg, model=replace(
        cfg.model, log2_hashmap_size=12, hashgrid_resolution=64,
        grid_mlp_hidden=16, view_mlp_hidden=16),
        render=replace(cfg.render, bound=bound),
        mesh=replace(cfg.mesh, mcubes_reso=32, env_reso=32))
    return replace(cfg, train=replace(cfg.train, fp16=False)).validate()


def _trainers(bound=2.0):
    """Stand-ins of both packages' Trainers holding the same field: what
    query_density_grid and export_meshes read."""
    jc, tc = _field_cfg(jcfg, bound), _field_cfg(tcfg, bound)
    jspec, tspec = j_make_spec(jc), t_make_spec(tc)
    params = jax.tree_util.tree_map(
        np.asarray, j_init_field(jax.random.PRNGKey(1), jspec))
    rng = np.random.default_rng(0)
    params["grid"] = rng.uniform(-1.0, 1.0, params["grid"].shape).astype(
        np.float32)
    jtr = SimpleNamespace(cfg=jc, spec=jspec,
                          state=SimpleNamespace(params=params,
                                                mean_density=None))
    ttr = SimpleNamespace(cfg=tc, device=torch.device("cpu"),
                          field=field_from_jax(params, tspec, device="cpu"),
                          state=SimpleNamespace(mean_density=None))
    return jtr, ttr


@pytest.mark.parametrize("bound", [1.0, 2.0])
def test_query_density_grid_matches_jax(bound):
    jtr, ttr = _trainers()
    sig_t = tme.query_density_grid(ttr, 32, bound=bound)
    sig_j = jme.query_density_grid(jtr, 32, bound=bound)
    assert sig_t.shape == sig_j.shape == (32, 32, 32)
    np.testing.assert_allclose(sig_t, sig_j, rtol=1e-5, atol=1e-5)
    assert sig_t.std() > 0


def test_export_meshes_writes_each_cascade(tmp_path):
    """bound 2: the inner mesh and the one outer cascade, each a PLY with
    faces, at the threshold set between the sweep's quartiles (as a
    trained grid's mean density sets it); bound 1: the inner one only."""
    for bound, names in ((2.0, ["mesh_0.ply", "mesh_1.ply"]),
                         (1.0, ["mesh_0.ply"])):
        _, ttr = _trainers(bound)
        sig = tme.query_density_grid(ttr, 32)
        ttr.state.mean_density = torch.tensor(float(np.median(sig)))
        d = tmp_path / str(bound)
        tme.export_meshes(ttr, str(d))
        assert sorted(os.listdir(d)) == names
        for n in names:
            assert len(tme.load_ply(str(d / n))[1]) > 0


def _image_pairs():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (32, 40, 3))
    noisy = np.clip(img + rng.normal(0, 0.2, img.shape), 0, 1)
    grey = rng.uniform(0, 1, (24, 24))
    return {"same": (img, img), "noisy": (img, noisy),
            "shifted": (img, np.clip(img + 0.05, 0, 1)),
            "grey": (grey, np.clip(grey * 0.9, 0, 1)),
            "f32": (img.astype(np.float32), noisy.astype(np.float32))}


@pytest.mark.parametrize("name", sorted(_image_pairs()))
def test_ssim_rmse_lpips_match_jax(name):
    a, b = _image_pairs()[name]
    assert abs(tmet.ssim(a, b) - jmet.ssim(a, b)) <= 1e-12
    assert abs(tmet.rmse(a, b) - jmet.rmse(a, b)) <= 1e-12
    if a.ndim == 3:
        meters = {}
        for pkg, mod in (("t", tmet), ("j", jmet)):
            ms = [mod.PSNRMeter(), mod.SSIMMeter(), mod.LPIPSMeter()]
            for m in ms:
                m.update(b, a)
            meters[pkg] = [m.measure() for m in ms]
        np.testing.assert_allclose(meters["t"][:2], meters["j"][:2],
                                   rtol=0, atol=1e-12)
        assert np.isnan(meters["t"][2]) and np.isnan(meters["j"][2])


@pytest.mark.parametrize("shape", [(37, 29), (64, 64), (5, 3)])
def test_depth_to_normal_matches_cv2(shape):
    pytest.importorskip("cv2")
    from raw_ngp_tpu.postprocess.raw import depth_to_normal as j_normal
    rng = np.random.default_rng(shape[0])
    ax = np.linspace(0, 1, shape[1])
    depth = (1.5 + np.sin(3 * ax)[None] + 0.1 * rng.standard_normal(shape))
    depth = depth.astype(np.float32)
    n_t, n_j = t_normal(depth), j_normal(depth)
    assert n_t.shape == n_j.shape == shape + (3,)
    np.testing.assert_allclose(n_t, n_j, rtol=0, atol=1e-6)
