"""The port's offline tools (raw_ngp_torch/tools/) against the JAX
package's (tools/) on the same inputs, on the CPU.

- offline_eval: the result dict within 1e-6 (relative) plain, with
  ``--raw`` and with ``--raw --hdr_merge robertson``;
- colmap2nerf: the same transforms.json;
- downscale: the pixels of cv2's INTER_AREA (8 and 16 bits, grey, RGB and
  RGBA PNGs, factors 2 and 3), and of the JAX tool's files; on JPEG
  folders the JAX tool's files byte for byte;
- exr_tools mask: the pixels of the JAX tool's PNG; convert (with and
  without --wb) the pixels of the JAX tool's PNG, and wb its 3 x 3 within
  1e-10 relative, the port reading the EXR file where the JAX tool gets
  the file's array through its monkeypatched ``load_exr_image``;
- determine_wb: the same matrix from a ``.npy``, a PNG and an EXR
  capture;
- quality_run: the same configuration and scenes for each flag, the
  Trainer stubbed out on both sides (the flagship's Trainer takes ~30 s
  to build on the CPU);
- summarize_quality: the same table.
"""

import dataclasses
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tool(name):
    """The JAX package's tools/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_tools_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def smooth_linear(seed, H=96, W=128):
    """A rendered-looking linear image: smooth shading, a bright spot and
    a dark band."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:H, :W].astype(np.float32)
    base = 0.05 + 0.4 * (x / W) * (1 - 0.5 * y / H)
    spot = 2.0 * np.exp(-((x - W * 0.6) ** 2 + (y - H * 0.4) ** 2) / 30.0)
    img = (base + spot)[..., None] * np.array([0.9, 1.0, 0.7], np.float32)
    img[: H // 8] *= 0.02
    return (img * rng.uniform(0.95, 1.05, img.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def eval_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval")
    for i in range(2):
        gt = smooth_linear(i)
        pred = gt * np.random.default_rng(10 + i).uniform(
            0.9, 1.1, gt.shape).astype(np.float32)
        np.save(d / f"pred_{i:03d}.npy", pred)
        np.save(d / f"gt_{i:03d}.npy", gt)
    return str(d)


@pytest.mark.parametrize("flags", [[], ["--raw"],
                                   ["--raw", "--hdr_merge", "robertson"]],
                         ids=["plain", "raw", "raw_hdr_robertson"])
def test_offline_eval_matches_jax(eval_dir, flags):
    from raw_ngp_torch.tools import offline_eval

    got = offline_eval.main([eval_dir, *flags])
    want = jax_tool("offline_eval").main([eval_dir, *flags])
    assert set(got) == set(want) and got["n_images"] == want["n_images"] == 2
    for key in ("psnr", "ssim", "rmse", "mse"):
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   err_msg=key)


def test_colmap2nerf_matches_jax(tmp_path):
    from chip_smoke import write_colmap_scene
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.tools import colmap2nerf

    train, _ = make_synthetic_scene(n_train=5, n_val=1, H=16, W=16)
    write_colmap_scene(str(tmp_path), train.images, train.poses,
                       train.intrinsics, step=4)
    got = colmap2nerf.main([str(tmp_path), "--out",
                            str(tmp_path / "port.json")])
    want = jax_tool("colmap2nerf").main([str(tmp_path), "--out",
                                         str(tmp_path / "jax.json"),
                                         "--aabb_scale", "16"])
    with open(got) as f, open(want) as g:
        a, b = json.load(f), json.load(g)
    assert a == b and len(a["frames"]) == 5
    colmap2nerf.main([str(tmp_path)])
    with open(tmp_path / "transforms.json") as f:
        assert json.load(f) == b


def _png_folder(root):
    from raw_ngp_torch.data.image_io import write_png

    rng = np.random.default_rng(4)
    os.makedirs(os.path.join(root, "images"))
    shapes = {"rgb8": ((37, 50, 3), np.uint8), "rgba8": ((24, 31, 4),
                                                          np.uint8),
              "grey16": ((30, 45), np.uint16), "rgb16": ((18, 27, 3),
                                                         np.uint16)}
    for name, (shape, dtype) in shapes.items():
        top = np.iinfo(dtype).max
        write_png(os.path.join(root, "images", f"{name}.png"),
                  rng.integers(0, top + 1, shape).astype(dtype))
    with open(os.path.join(root, "images", "notes.txt"), "w") as f:
        f.write("not an image\n")


@pytest.mark.parametrize("factor", [2, 3])
def test_downscale_matches_cv2(tmp_path, factor):
    """Each PNG shrunk by the port's tool: cv2's INTER_AREA pixels of
    cv2's reading (BGR order flipped), and the JAX tool's files read by
    cv2; the text file is skipped by both."""
    cv2 = pytest.importorskip("cv2")
    from raw_ngp_torch.data.image_io import read_png
    from raw_ngp_torch.tools import downscale

    port, jax = tmp_path / "port", tmp_path / "jax"
    _png_folder(str(port))
    shutil.copytree(port, jax)
    downscale.main([str(port), "--factor", str(factor)])
    jax_tool("downscale").main([str(jax), "--factor", str(factor)])
    names = sorted(os.listdir(port / f"images_{factor}"))
    assert names == sorted(os.listdir(jax / f"images_{factor}")) == [
        "grey16.png", "rgb16.png", "rgb8.png", "rgba8.png"]
    for name in names:
        src = cv2.imread(str(port / "images" / name), cv2.IMREAD_UNCHANGED)
        H, W = src.shape[:2]
        want = cv2.resize(src, (W // factor, H // factor),
                          interpolation=cv2.INTER_AREA)
        got = cv2.imread(str(port / f"images_{factor}" / name),
                         cv2.IMREAD_UNCHANGED)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, cv2.imread(str(jax / f"images_{factor}" / name),
                            cv2.IMREAD_UNCHANGED))
        assert read_png(str(port / f"images_{factor}" / name)).shape \
            == want.shape


@pytest.mark.parametrize("name,head", [
    ("a.tif", b"II*\x00" + bytes(60)), ("a.exr", b"v/1\x01" + bytes(60)),
    ("a.jpg.tif", b"\xff\xd8\xff\xe0" + bytes(60))],
    ids=["tiff", "exr", "jpeg_written_as_tiff"])
def test_downscale_other_formats_raise(tmp_path, name, head):
    """A TIFF or EXR image, or a JPEG whose name asks for a TIFF, raises
    ImportError naming what the port reads and writes (PNG and JPEG)."""
    from raw_ngp_torch.tools import downscale

    os.makedirs(tmp_path / "images")
    (tmp_path / "images" / name).write_bytes(head)
    with pytest.raises(ImportError, match="PNG and JPEG"):
        downscale.main([str(tmp_path), "--factor", "2"])


def _jpeg_folder(root):
    """JPEGs as captures come: cv2's 4:2:0 at 95 and a progressive 4:2:2
    at 90, Pillow's 4:4:4, a grey one; odd sizes; a text file."""
    import io

    import cv2
    from PIL import Image

    rng = np.random.default_rng(5)

    def image(h, w, c=3):
        yy, xx = np.mgrid[:h, :w]
        base = np.stack([120 + 90 * np.sin(xx / 6.0 + k) * np.cos(yy / 4.0)
                         for k in range(c)], -1)
        return np.clip(base + rng.normal(0, 12, base.shape), 0,
                       255).astype(np.uint8)

    os.makedirs(os.path.join(root, "images"))
    out = os.path.join(root, "images")
    cv2.imwrite(os.path.join(out, "a.jpg"), image(61, 90))
    cv2.imwrite(os.path.join(out, "b.jpeg"), image(45, 33),
                [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x211111])
    f = io.BytesIO()
    Image.fromarray(image(40, 52)).save(f, "JPEG", quality=85, subsampling=0)
    with open(os.path.join(out, "c.jpg"), "wb") as g:
        g.write(f.getvalue())
    cv2.imwrite(os.path.join(out, "d.jpg"), image(29, 47, 1)[..., 0])
    with open(os.path.join(out, "notes.txt"), "w") as g:
        g.write("not an image\n")


@pytest.mark.parametrize("factor", [2, 3])
def test_downscale_jpeg_matches_jax(tmp_path, factor):
    """A folder of JPEGs shrunk by the port's tool and by the JAX tool
    (cv2.imread, INTER_AREA, cv2.imwrite): the same files byte for byte,
    whose pixels are cv2's INTER_AREA of cv2's reading re-encoded at
    quality 95; the text file skipped by both."""
    cv2 = pytest.importorskip("cv2")
    from raw_ngp_torch.data.jpeg import read_jpeg
    from raw_ngp_torch.tools import downscale

    port, jax = tmp_path / "port", tmp_path / "jax"
    _jpeg_folder(str(port))
    shutil.copytree(port, jax)
    downscale.main([str(port), "--factor", str(factor)])
    jax_tool("downscale").main([str(jax), "--factor", str(factor)])
    names = sorted(os.listdir(port / f"images_{factor}"))
    assert names == sorted(os.listdir(jax / f"images_{factor}")) == [
        "a.jpg", "b.jpeg", "c.jpg", "d.jpg"]
    for name in names:
        got = (port / f"images_{factor}" / name).read_bytes()
        assert got == (jax / f"images_{factor}" / name).read_bytes(), name
        src = cv2.imread(str(port / "images" / name), cv2.IMREAD_UNCHANGED)
        H, W = src.shape[:2]
        small = cv2.resize(src, (W // factor, H // factor),
                           interpolation=cv2.INTER_AREA)
        ok, want = cv2.imencode(".jpg", small)
        assert ok and got == want.tobytes(), name
        pixels = read_jpeg(str(port / f"images_{factor}" / name))
        ref = cv2.imread(str(port / f"images_{factor}" / name),
                         cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(
            pixels, ref if ref.ndim == 2 else ref[..., ::-1])


@pytest.mark.parametrize("bg", ["black", "white"])
@pytest.mark.parametrize("image_kind,mask_kind", [
    ("png", "png"), ("jpg", "png"), ("png", "jpg"), ("jpg", "jpg"),
    ("rgba_png", "grey_png")])
def test_exr_tools_mask_matches_jax(tmp_path, image_kind, mask_kind, bg):
    """The port's `exr_tools mask` against the JAX tool's (imageio reads,
    imageio writes the PNG): the written pixels bit for bit, for PNG and
    JPEG images and mattes."""
    pytest.importorskip("imageio")
    cv2 = pytest.importorskip("cv2")
    from raw_ngp_torch.data.image_io import read_png, write_png
    from raw_ngp_torch.tools import exr_tools

    rng = np.random.default_rng(6)
    yy, xx = np.mgrid[:33, :47]
    img = np.clip(np.stack([100 + 80 * np.sin(xx / 5.0 + k) for k in
                            range(4)], -1) + rng.normal(0, 10, (33, 47, 4)),
                  0, 255).astype(np.uint8)
    matte = (((xx - 20) ** 2 + (yy - 15) ** 2) < 150).astype(np.uint8) * 255

    def save(name, kind, pixels):
        path = str(tmp_path / f"{name}.{kind.split('_')[-1]}")
        if kind.endswith("jpg"):
            cv2.imwrite(path, pixels[..., 2::-1] if pixels.ndim == 3
                        else pixels)
        else:
            write_png(path, pixels)
        return path

    image = save("image", image_kind,
                 img if image_kind == "rgba_png" else img[..., :3])
    mask = save("mask", mask_kind, matte if mask_kind == "grey_png"
                else np.repeat(matte[..., None], 3, -1))
    got = exr_tools.main(["mask", image, mask, str(tmp_path / "port.png"),
                          "--bg", bg])
    jax_tool("exr_tools").main(["mask", image, mask,
                                str(tmp_path / "jax.png"), "--bg", bg])
    want = read_png(str(tmp_path / "jax.png"))
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(read_png(str(tmp_path / "port.png")), want)
    assert (want == (0 if bg == "black" else 255)).any()


def test_determine_wb_matches_jax(tmp_path, monkeypatch):
    """The tool on a .npy capture and on an 8-bit PNG of it: the port's
    matrix equals the JAX tool's (whose PNG goes through imageio)."""
    from test_torch_colorchecker import make_chart

    from raw_ngp_torch.data.image_io import write_png
    from raw_ngp_torch.tools import determine_wb

    mat = np.array([[1.3, -0.1, 0.0], [0.0, 1.2, -0.1], [0.1, 0.0, 1.4]])
    chart = make_chart(np.linalg.inv(mat) * 0.7)
    np.save(tmp_path / "chart.npy", chart)
    write_png(str(tmp_path / "chart.png"),
              np.round(np.clip(chart, 0, 1) * 255).astype(np.uint8))
    jtool = jax_tool("determine_wb")
    for name, extra in (("chart.npy", []), ("chart.png", ["--white",
                                                          "255"])):
        got = determine_wb.main([str(tmp_path / name), "-o",
                                 str(tmp_path / "port.npy"), *extra])
        monkeypatch.setattr(sys, "argv", [
            "determine_wb.py", str(tmp_path / name), "-o",
            str(tmp_path / "jax.npy"), *extra])
        jtool.main()
        np.testing.assert_array_equal(got, np.load(tmp_path / "jax.npy"))
        np.testing.assert_array_equal(np.load(tmp_path / "port.npy"), got)
    np.testing.assert_allclose(np.load(tmp_path / "port.npy"), mat / 0.7,
                               atol=0.02)


class _Stop(Exception):
    pass


def _stub(seen):
    def trainer(cfg, train_scene, val_scene=None, *args, **kwargs):
        seen.update(cfg=cfg, train=train_scene, val=val_scene,
                    kwargs=kwargs)
        raise _Stop
    return trainer


def _same_scene(t, j):
    """Every array and number of two SceneData equal bit for bit."""
    for f in dataclasses.fields(j):
        vt, vj = getattr(t, f.name), getattr(j, f.name)
        if f.name == "meta" or vj is None:
            assert (vt is None) == (vj is None), f.name
            continue
        np.testing.assert_array_equal(np.asarray(vt), np.asarray(vj),
                                      err_msg=f.name)


QUALITY_FLAGS = {
    "flagship": [],
    "hdr_rfield": ["--hdr", "--rfield"],
    "textured": ["--textured"],
    "rfield_grid": ["--rfield_grid", "3:4"],
    "contract_march": ["--contract", "--march", "128:32:cdf"],
    "probes": ["--probe_log", "--cdf_floor", "0.05"],
    "overrides": ["--eps", "1e-12", "--lr", "0.02", "--levels", "8",
                  "--level_dim", "4", "--hash", "xor"],
}


@pytest.mark.parametrize("name", sorted(QUALITY_FLAGS))
def test_quality_run_config_and_scene_match_jax(name, monkeypatch):
    """quality_run's configuration (field by field) and train / val
    scenes (bit for bit) equal the JAX tool's for the same flags (scenes
    at 16x16 through --res); the port's Trainer gets the card by default
    and the CPU when asked, and a fresh workspace."""
    import raw_ngp_torch.train.trainer as ttr
    import raw_ngp_tpu.train as jtrain
    from raw_ngp_torch.tools import quality_run

    argv = [*QUALITY_FLAGS[name], "--res", "16"]
    port, jax = {}, {}
    monkeypatch.setattr(ttr, "Trainer", _stub(port))
    monkeypatch.setattr(jtrain, "Trainer", _stub(jax))
    monkeypatch.setenv("RAW_NGP_COMPILE_CACHE", "unused")
    with pytest.raises(_Stop):
        quality_run.main(argv)
    monkeypatch.setattr(sys, "argv", ["quality_run.py", *argv])
    with pytest.raises(_Stop):
        jax_tool("quality_run").main()
    assert dataclasses.asdict(port["cfg"]) == dataclasses.asdict(jax["cfg"])
    _same_scene(port["train"], jax["train"])
    _same_scene(port["val"], jax["val"])
    assert port["kwargs"]["device"] == "cuda"
    assert os.path.isdir(port["kwargs"]["workspace"])
    os.rmdir(port["kwargs"]["workspace"])
    with pytest.raises(_Stop):
        quality_run.main([*argv, "--device", "cpu"])
    assert port["kwargs"]["device"] == "cpu"
    os.rmdir(port["kwargs"]["workspace"])


def test_summarize_quality_matches_jax(tmp_path, capsys, monkeypatch):
    from raw_ngp_torch.tools import summarize_quality

    curves = {"a": [(1000, 20.0, 19.0), (5000, 25.5, 22.25),
                    (10000, 27.0, 21.0)],
              "b": [(500, 15.0, 14.0), (1000, 18.0, 17.5)]}
    paths = []
    for name, curve in curves.items():
        paths.append(str(tmp_path / f"{name}.json"))
        with open(paths[-1], "w") as f:
            json.dump({"iters": curve[-1][0], "curve": [
                {"step": s, "psnr_train": t, "psnr_heldout": h}
                for s, t, h in curve]}, f)
    paths.append(str(tmp_path / "missing.json"))
    lines = summarize_quality.main(paths)
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["summarize_quality.py", *paths])
    jax_tool("summarize_quality").main()
    assert capsys.readouterr().out == got == "\n".join(lines) + "\n"
    assert "NO (final 21.0)" in lines[2] and "error" in lines[4]


def _capture(seed, shape):
    """A smooth positive linear capture with a hot spot: a mosaic [H, W]
    or RGB [H, W, 3]."""
    rng = np.random.default_rng(seed)
    H, W = shape[:2]
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    base = 0.1 + 0.5 * (1 + np.sin(xx / 9.0 + yy / 13.0))
    base += 3.0 * np.exp(-((xx - W * 0.3) ** 2 + (yy - H * 0.6) ** 2) / 40)
    img = base[..., None] * np.array([0.8, 1.0, 0.6]) if len(shape) == 3 \
        else base
    return (img * rng.uniform(0.9, 1.1, shape)).astype(np.float32)


@pytest.mark.parametrize("wb", [False, True], ids=["plain", "wb"])
@pytest.mark.parametrize("kind", ["mosaic_half", "rgb_float"])
def test_exr_tools_convert_matches_jax(tmp_path, monkeypatch, kind, wb):
    """The port's `exr_tools convert` reads the EXR file itself (a HALF
    mosaic, or FLOAT R, G, B, written by chip_smoke.write_exr); the JAX
    tool gets the file's array through its monkeypatched load_exr_image
    (tests/test_tools.py's device: no EXR backend here) and writes with
    imageio. The PNG pixels bit for bit, with and without --wb."""
    pytest.importorskip("imageio")
    import chip_smoke
    from raw_ngp_torch.data.exr import read_exr
    from raw_ngp_torch.data.image_io import read_png
    from raw_ngp_torch.tools import exr_tools

    shape = (36, 52) if kind == "mosaic_half" else (36, 52, 3)
    path = str(tmp_path / "cap.exr")
    chip_smoke.write_exr(path, _capture(3, shape), "ZIP",
                         "HALF" if kind == "mosaic_half" else "FLOAT")
    written = read_exr(path)
    extra = ["--wb", "1.2,-0.1,0.05,0.02,0.9,-0.03,0.0,-0.2,1.4"] if wb \
        else []
    got = exr_tools.main(["convert", path, str(tmp_path / "port.png"),
                          *extra])
    jtool = jax_tool("exr_tools")
    monkeypatch.setattr(jtool, "load_exr_image", lambda p: written.copy())
    jtool.main(["convert", path, str(tmp_path / "jax.png"), *extra])
    want = read_png(str(tmp_path / "jax.png"))
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(read_png(str(tmp_path / "port.png")), want)
    assert 0 < want.mean() < 255


@pytest.mark.parametrize("crop", ["3,2,103,138", "-4,9,100,151"],
                         ids=["inside", "over_the_edges"])
def test_exr_tools_wb_matches_jax(tmp_path, monkeypatch, crop):
    """The port's `exr_tools wb` (read_exr, a numpy crop and quarter
    turn) against the JAX tool's (PIL's crop, 0 outside the image, and
    rotate(-90, expand=True)) on a FLOAT mosaic EXR: the 3 x 3 within
    1e-10 relative."""
    pytest.importorskip("PIL")
    import chip_smoke
    from raw_ngp_torch.data.exr import read_exr
    from raw_ngp_torch.tools import exr_tools

    path = str(tmp_path / "checker.exr")
    chip_smoke.write_exr(path, _capture(4, (140, 110)), "ZIPS", "FLOAT")
    written = read_exr(path)
    argv = ["wb", path, f"--crop={crop}", "--patch0", "6,5,14,13",
            "--delta", "20"]
    got = exr_tools.main(argv)
    jtool = jax_tool("exr_tools")
    monkeypatch.setattr(jtool, "load_exr_image", lambda p: written.copy())
    want = jtool.main(argv)
    assert got.shape == want.shape == (3, 3)
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())


def test_determine_wb_reads_exr_like_jax(tmp_path, monkeypatch):
    """determine_wb on an EXR capture: the port reads the file with
    read_exr, the JAX tool gets the same array from its monkeypatched
    imageio reader; the same matrix."""
    import imageio.v2 as iio

    import chip_smoke
    from raw_ngp_torch.data.exr import read_exr
    from raw_ngp_torch.tools import determine_wb
    from test_torch_colorchecker import make_chart

    mat = np.array([[1.3, -0.1, 0.0], [0.0, 1.2, -0.1], [0.1, 0.0, 1.4]])
    chart = make_chart(np.linalg.inv(mat) * 0.7).astype(np.float32)
    path = str(tmp_path / "chart.exr")
    chip_smoke.write_exr(path, chart, "ZIP", "FLOAT")
    written = read_exr(path)
    got = determine_wb.main([path, "-o", str(tmp_path / "port.npy")])
    monkeypatch.setattr(iio, "imread", lambda p: written.copy())
    monkeypatch.setattr(sys, "argv", ["determine_wb.py", path, "-o",
                                      str(tmp_path / "jax.npy")])
    jax_tool("determine_wb").main()
    np.testing.assert_array_equal(got, np.load(tmp_path / "jax.npy"))
    np.testing.assert_allclose(got, mat / 0.7, atol=0.02)
