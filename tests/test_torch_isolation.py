"""The port stands alone: raw_ngp_torch and chip_smoke.py import neither
JAX nor the JAX package raw_ngp_tpu (not even its jax-free modules).

Checked two ways: a fresh interpreter imports every module of the port
(its tools included) plus chip_smoke and must end with neither in
``sys.modules``; and the sources are scanned for import statements naming
either. The HDR merge, the colour checker, the native library and the
tools, the JPEG reader and writer and a JPEG COLMAP scene's load also run
in an interpreter where cv2, imageio, PIL and rawpy cannot be imported (the
card's machine has none of them), and so do the EXR and DNG readers, an
EXR and a DNG capture folder's loads and the EXR tools.
"""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import raw_ngp_torch
for m in pkgutil.walk_packages(raw_ngp_torch.__path__, "raw_ngp_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "raw_ngp_tpu"))
print("LEAKED:" + ",".join(bad))
"""


def test_import_leaves_jax_and_reference_unloaded():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    line = [l for l in out.stdout.splitlines() if l.startswith("LEAKED:")]
    assert line == ["LEAKED:"], out.stdout


_IMPORT = re.compile(
    r"^\s*(?:from\s+(jax|jaxlib|raw_ngp_tpu)\b|import\s+(?:[\w.]+\s*,\s*)*"
    r"(jax|jaxlib|raw_ngp_tpu)\b)", re.M)


def test_sources_name_no_jax_import():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "raw_ngp_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 10
    offenders = []
    for path in files:
        with open(path) as f:
            src = f.read()
        offenders += [f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}"
                      for m in _IMPORT.finditer(src)]
    assert not offenders, offenders


_NO_IMAGE_LIBS = r"""
import sys, tempfile, os
for name in ("cv2", "imageio", "imageio.v2", "PIL", "rawpy"):
    sys.modules[name] = None
import importlib, pkgutil
import numpy as np
import raw_ngp_torch
names = [m.name for m in pkgutil.walk_packages(raw_ngp_torch.__path__,
                                               "raw_ngp_torch.")]
assert "raw_ngp_torch.tools.offline_eval" in names, names
for name in names:
    importlib.import_module(name)
from raw_ngp_torch import native
from raw_ngp_torch.data.image_io import write_png
from raw_ngp_torch.postprocess import determine_wb, postprocess_raw_hdr
from raw_ngp_torch.tools import downscale, offline_eval
rng = np.random.default_rng(0)
lin = rng.lognormal(-2, 1, (48, 64, 3)).astype(np.float32)
for merge in ("robertson", "debevec"):
    for tonemap in ("reinhard", "mantiuk", "drago"):
        out = postprocess_raw_hdr(lin, np.eye(3), (70, 80, 90, 97, 99,
                                  99.9, 100), merge, tonemap)
        assert out.shape == lin.shape
assert determine_wb(rng.random((700, 950, 3))).shape == (3, 3)
assert native.available()
root = tempfile.mkdtemp()
os.makedirs(os.path.join(root, "images"))
write_png(os.path.join(root, "images", "a.png"),
          rng.integers(0, 256, (8, 12, 3)).astype(np.uint8))
downscale.main([root, "--factor", "2"])
from dataclasses import replace
import chip_smoke
from raw_ngp_torch import Config
from raw_ngp_torch.data import jpeg, load_scene, make_synthetic_scene
from raw_ngp_torch.tools import exr_tools
assert native.jpeg_library() is not None
train, val = make_synthetic_scene(n_train=5, n_val=1, H=24, W=24)
scene = os.path.join(root, "jpeg_scene")
chip_smoke.write_colmap_scene(scene, np.concatenate([train.images,
                                                     val.images]),
                              np.concatenate([train.poses, val.poses]),
                              train.intrinsics, image_format="jpg")
downscale.main([scene, "--factor", "2"])
for d, size in ((1, 24), (2, 12)):
    cfg = Config()
    cfg = replace(cfg, data=replace(cfg.data, path=scene, scale=1.0,
                                    data_format="colmap", downscale=d))
    np.random.seed(0)
    loaded = load_scene(cfg, "train")
    assert loaded.images.shape == (5, size, size, 3), loaded.images.shape
one = os.path.join(scene, "images", "img_000.jpg")
assert np.array_equal(jpeg.read_jpeg(one, route="native"),
                      jpeg.read_jpeg(one, route="python"))
exr_tools.main(["mask", one, one, os.path.join(root, "masked.png")])
ev = os.path.join(root, "eval")
os.makedirs(ev)
np.save(os.path.join(ev, "pred_000.npy"), lin)
np.save(os.path.join(ev, "gt_000.npy"), lin * 1.01)
r = offline_eval.main([ev, "--raw", "--hdr_merge", "robertson",
                       "--percentiles", "70", "80", "90", "97", "99",
                       "99.9", "100"])
assert np.isfinite(r["psnr"])
bad = sorted(m for m in sys.modules if sys.modules[m] is not None
             and m.split(".")[0] in ("cv2", "imageio", "PIL", "rawpy",
                                     "jax", "raw_ngp_tpu"))
print("LEAKED:" + ",".join(bad))
"""


def test_hdr_colorchecker_native_tools_without_image_libraries():
    """With cv2, imageio, PIL and rawpy unimportable: every module of the
    port (tools included) imports, postprocess_raw_hdr runs all six merge
    x tonemap pairs, determine_wb, the native library, downscale and
    offline_eval --raw --hdr_merge run, and a COLMAP scene of JPEGs
    written by chip_smoke.write_colmap_scene loads at downscale 1 and 2
    (downscale's JPEG output), both JPEG routes decode alike and
    exr_tools mask runs on a JPEG."""
    # one BLAS / OpenMP thread: under pytest-xdist a thread a core
    # oversubscribes the cores (the Debevec solves, the native library)
    env = dict(os.environ, PYTHONPATH=ROOT, OPENBLAS_NUM_THREADS="1",
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _NO_IMAGE_LIBS], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("LEAKED:")]
    assert line == ["LEAKED:"], out.stdout[-3000:]


_CAPTURES = r"""
import os, sys, tempfile
for name in ("cv2", "imageio", "imageio.v2", "PIL", "rawpy", "tifffile"):
    sys.modules[name] = None
import numpy as np
import chip_smoke
from raw_ngp_torch import native
from raw_ngp_torch.data import load_scene
from raw_ngp_torch.data.dng import read_dng_raw
from raw_ngp_torch.data.exr import read_exr
from raw_ngp_torch.tools import determine_wb, exr_tools
root = tempfile.mkdtemp()
captures = chip_smoke.capture_scene(n_views=3, n_leds=2, size=8)
for kind in ("exr", "dng"):
    folder = os.path.join(root, kind)
    written = chip_smoke.write_capture_folder(folder, kind, *captures)
    read = read_exr if kind == "exr" else read_dng_raw
    assert all(np.array_equal(read(p).astype(np.float32), w)
               for p, w in written.items())
    for split in ("train", "val"):
        np.random.seed(0)
        scene = load_scene(chip_smoke.capture_config(folder, kind), split)
        print("LOADED", kind, split, scene.images.shape,
              None if scene.ldirs is None else scene.ldirs.shape)
one = os.path.join(root, "exr", "raw", "img_000_l0.exr")
exr_tools.main(["convert", one, os.path.join(root, "c.png")])
exr_tools.main(["wb", one, "--crop=0,0,16,16", "--patch0", "0,0,2,2",
                "--delta", "2"])
determine_wb.main([one, "--first_patch", "0", "0", "2", "2", "--spacing",
                   "2", "-o", os.path.join(root, "wb.npy")])
print("DNG-ROUTE", "native" if native.jpeg_library() is not None
      else "python")
bad = sorted(m for m in sys.modules if sys.modules[m] is not None
             and m.split(".")[0] in ("cv2", "imageio", "PIL", "rawpy",
                                     "tifffile", "jax", "raw_ngp_tpu"))
print("LEAKED:" + ",".join(bad))
"""


def test_exr_and_dng_capture_folders_load_without_image_libraries():
    """With cv2, imageio, PIL, rawpy and tifffile unimportable: a capture
    folder of EXR files (HALF mosaics, ZIP) and one of DNG files (lossless
    JPEG and uncompressed, .json sidecars), written by chip_smoke's
    writers, decode bit for bit and load through load_scene with the
    light-stage preset (rfield on the EXR folder, clip off on the DNG
    one); exr_tools convert and wb and determine_wb run on an EXR."""
    env = dict(os.environ, PYTHONPATH=ROOT, OPENBLAS_NUM_THREADS="1",
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _CAPTURES], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    for kind, ldirs in (("exr", "(5, 3)"), ("dng", "None")):
        assert f"LOADED {kind} train (5, 8, 8, 3) {ldirs}" in lines, lines
    assert "DNG-ROUTE native" in lines, lines
    assert [l for l in lines if l.startswith("LEAKED:")] == ["LEAKED:"], \
        lines
