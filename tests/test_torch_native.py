"""The port's native host library (raw_ngp_torch/native.py over
raw_ngp_torch/csrc/host_native.cpp) on the CPU: tests/test_native.py's
checks of the JAX package's library asked of the port's, the port's C++
route bit for bit the JAX package's C++ route (the same source built with
the same flags on this machine), and the port's numpy fallback bit for
bit the JAX package's fallback. The library must build here: a port
without it would load mosaics through numpy on the card too."""

import os

import numpy as np
import pytest

from raw_ngp_torch import native
from raw_ngp_torch.kernels._build import BUILD_DIR
from raw_ngp_torch.ops.morton import morton3d_invert
from raw_ngp_torch.postprocess.raw import bilinear_demosaic, linear_to_srgb
from raw_ngp_tpu import native as jnative


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.fixture
def numpy_routes(monkeypatch):
    """Both packages with the library switched off (a machine without
    g++)."""
    for mod in (native, jnative):
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "_TRIED", True)


def test_native_builds():
    """The library builds into build/raw_ngp_torch/ under a name keyed by
    the source's hash, and loads."""
    assert native.available()
    so = native.library_path()
    assert so.parent == BUILD_DIR and so.exists()
    assert so.name.startswith("libhost_native-")
    assert native._LIB.version() == 1


def test_demosaic_matches_numpy():
    rng = np.random.default_rng(0)
    bayer = rng.uniform(0, 1, (64, 96)).astype(np.float32)
    got = native.demosaic_rggb(bayer)
    want = bilinear_demosaic(bayer)
    np.testing.assert_allclose(got[2:-2, 2:-2], want[2:-2, 2:-2],
                               atol=1e-5)


def test_demosaic_constant():
    out = native.demosaic_rggb(np.full((32, 32), 0.25, np.float32))
    np.testing.assert_allclose(out, 0.25, atol=1e-6)


def test_normalize_levels():
    img = np.array([-0.5, 0.0, 0.5, 1.0, 2.0], np.float32)
    out = native.normalize_levels(img, black=0.1, white=0.9, clip=True)
    np.testing.assert_allclose(out, (np.clip(img, 0, 1) - 0.1) / 0.8,
                               atol=1e-6)


def test_morton_roundtrip_native():
    import torch

    rng = np.random.default_rng(1)
    coords = rng.integers(0, 1024, (1000, 3)).astype(np.int32)
    codes = native.morton3d_encode(coords)
    _same(native.morton3d_decode(codes), coords)
    np.testing.assert_array_equal(
        morton3d_invert(torch.from_numpy(codes.astype(np.int64))).numpy(),
        coords)


def test_packbits_native():
    rng = np.random.default_rng(2)
    grid = rng.uniform(0, 20, 4096).astype(np.float32)
    occ = (grid > 10.0).reshape(-1, 8)
    want = (occ.astype(np.uint8)
            * (2 ** np.arange(8)).astype(np.uint8)).sum(-1).astype(np.uint8)
    _same(native.packbits(grid, 10.0), want)


def test_srgb_native():
    x = np.linspace(0, 1, 256).astype(np.float32)
    np.testing.assert_allclose(native.linear_to_srgb(x), linear_to_srgb(x),
                               atol=1e-5)


def test_numpy_fallback_paths(numpy_routes):
    bayer = np.full((16, 16), 0.5, np.float32)
    assert native.demosaic_rggb(bayer).shape == (16, 16, 3)
    assert native.packbits(np.zeros(64, np.float32), 1.0).shape == (8,)
    coords = np.array([[1, 2, 3]], np.int32)
    _same(native.morton3d_decode(native.morton3d_encode(coords)), coords)


def _inputs():
    rng = np.random.default_rng(7)
    return {
        "bayer": rng.uniform(-0.2, 1.3, (48, 70)).astype(np.float32),
        "coords": np.concatenate([
            rng.integers(0, 1024, (3000, 3)),
            rng.integers(-2 ** 31, 2 ** 31, (500, 3))]).astype(np.int32),
        "codes": rng.integers(0, 2 ** 32, 4000, dtype=np.uint64)
                    .astype(np.uint32),
        "grid": rng.uniform(0, 20, 8192).astype(np.float32),
        "linear": np.concatenate([
            np.linspace(-0.1, 1.2, 3001),
            rng.uniform(0, 0.004, 1000)]).astype(np.float32),
    }


def _all_outputs(mod):
    x = _inputs()
    return {
        "demosaic": mod.demosaic_rggb(x["bayer"]),
        "levels_clip": mod.normalize_levels(x["bayer"], 0.00024420026, 1.0,
                                            True),
        "levels": mod.normalize_levels(x["bayer"], 0.1, 0.9, False),
        "encode": mod.morton3d_encode(x["coords"]),
        "decode": mod.morton3d_decode(x["codes"]),
        "packbits": mod.packbits(x["grid"], 10.0),
        "srgb": mod.linear_to_srgb(x["linear"]),
    }


def test_cpp_route_bitwise_jax_cpp_route():
    """Each of the six functions through the port's library bit for bit
    through the JAX package's (same source and flags, this machine)."""
    assert native.available() and jnative.available()
    got, want = _all_outputs(native), _all_outputs(jnative)
    for key in want:
        _same(got[key], want[key])


def test_numpy_route_bitwise_jax_fallback(numpy_routes):
    """With the library off in both packages: each function bit for bit
    the JAX package's numpy fallback (Morton codes through the port's
    ops/morton.py, also for coordinates past 10 bits)."""
    got, want = _all_outputs(native), _all_outputs(jnative)
    for key in want:
        _same(got[key], want[key])


def test_build_is_atomic(tmp_path, monkeypatch):
    """A build writes a temporary file and renames it: a fresh build
    directory ends with the library and no partial file."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "libhost_native-test.so")
    path = native._build()
    assert path == str(tmp_path / "libhost_native-test.so")
    assert os.listdir(tmp_path) == ["libhost_native-test.so"]
