"""The port's command line (raw_ngp_torch.cli) against the JAX package's
(raw_ngp_tpu.cli), on the CPU.

``args_to_config`` must give the same Config, field by field, for the
same argv (those of tests/test_cli.py and the flagship's). A miniature of
the flagship (-O --tpu_profile with a 2^12 table, 16-wide MLPs, a 32^3
grid, 48 steps of 512 rays; by 48 steps the mean grid density passes the
field's floor of 1, so the inner mesh has faces) runs end to end with
``RAW_NGP_PLATFORM=cpu``: checkpoints, validation PNGs, result frames and
the meshes, then ``python -m raw_ngp_torch.cli --test`` resumes it from
the step it saved. Without that variable and without CUDA the CLI raises
before it writes anything: it does not fall back to the CPU, and a
``JAX_PLATFORMS=cpu`` meant for JAX does not move it there. The
Trainer's outputs that tests/test_trainer_features.py asks of the JAX
package's (normal-map artifacts, HDR exposure levels, pose logs) are
asked of the port's here, with the PNGs decoded by the port's reader and
compared with the renders bit for bit.
"""

import dataclasses
import os
import subprocess
import sys
import warnings
from dataclasses import replace

import numpy as np
import pytest
import torch

import raw_ngp_torch.config as tcfg
from raw_ngp_torch import cli as tcli
from raw_ngp_torch.data import make_synthetic_scene
from raw_ngp_torch.data.image_io import read_png
from raw_ngp_torch.mesh.extract import load_ply
from raw_ngp_torch.postprocess.raw import postprocess_raw, postprocess_raw_hdr
from raw_ngp_torch.train import metrics as tmet
from raw_ngp_torch.train import trainer as ttr
from raw_ngp_torch.utils.logging import RunLogger, profiler_trace
from raw_ngp_tpu import cli as jcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work, set back after
    it (under pytest-xdist torch's default of a thread a core
    oversubscribes the cores: tests/test_torch_proposal.py), and one BLAS
    thread where threadpoolctl is present (the HDR merge's least-squares
    solve: with a thread a core under -n 6 the HDR frames test took 95 s
    of a worker against 8 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
    else:
        with threadpool_limits(limits=1):
            yield
    torch.set_num_threads(n)


ARGVS = {
    "O": ["/data", "-O", "--iters", "100"],
    "O2": ["/data", "-O2"],
    "lightstage": ["/data", "--lightstage"],
    "bracketing": ["/d", "--bracketing"],
    "defaults": ["/d"],
    "flagship": ["unused", "--data_format", "synthetic", "-O",
                 "--tpu_profile", "--fp16", "--num_rays", "8192",
                 "--iters", "128", "--save_cnt", "2", "--eval_cnt", "2"],
    "sizes": ["/d", "-O", "--num_levels", "4", "--level_dim", "4",
              "--hash_variant", "xor", "--grid_mlp_hidden", "32",
              "--num_steps", "24", "12", "8", "--offset", "1", "2", "3"],
}


def _config(cli, argv):
    return dataclasses.asdict(cli.args_to_config(
        cli.build_parser().parse_args(argv)))


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_args_to_config_matches_jax(name):
    assert _config(tcli, ARGVS[name]) == _config(jcli, ARGVS[name])


def test_pose_opt_config_matches_jax(tmp_path):
    """--pose_opt counts the cameras in the data folder's images/ (as in
    tests/test_cli.py) and rewires the batching the same way."""
    os.makedirs(tmp_path / "images")
    for i in range(5):
        (tmp_path / "images" / f"{i}.png").touch()
    argv = [str(tmp_path), "--pose_opt", "barf"]
    port = _config(tcli, argv)
    assert port == _config(jcli, argv)
    assert port["pose_opt"]["num_cameras"] == 5


MINI = ["unused", "--data_format", "synthetic", "-O", "--tpu_profile",
        "--num_rays", "512", "--hashmap_size", "12",
        "--hashgrid_resolution", "64", "--grid_mlp_hidden", "16",
        "--view_mlp_hidden", "16", "--grid_size", "32",
        "--mcubes_reso", "32", "--env_reso", "32"]


def test_cli_trains_saves_and_resumes_on_cpu(tmp_path, monkeypatch):
    """Train (48 steps; saves and evaluations at 24 and 48), final eval
    with artifacts, test frames and meshes in process; then the module
    entry point in --test mode resumes step 48 and writes the frames and
    the meshes again."""
    ws = str(tmp_path / "ws")
    monkeypatch.setenv("RAW_NGP_PLATFORM", "cpu")
    assert tcli.main(MINI + ["--iters", "48", "--save_cnt", "2",
                             "--eval_cnt", "2", "--workspace", ws]) == 0
    ckpts = sorted(os.listdir(os.path.join(ws, "checkpoints")))
    assert ckpts == ["ngp_best.json", "ngp_best.npz", "ngp_step000024.json",
                     "ngp_step000024.npz", "ngp_step000048.json",
                     "ngp_step000048.npz"]
    val = os.listdir(os.path.join(ws, "validation"))
    for kind in ("rgb", "depth", "error"):
        assert sorted(p for p in val if p.startswith(kind + "_")) == [
            f"{kind}_48_{i:03d}.png" for i in range(4)]
    results = sorted(os.listdir(os.path.join(ws, "results")))
    assert results == [f"{k}_{i:03d}.png" for k in ("depth", "rgb")
                       for i in range(4)]
    verts, faces = load_ply(os.path.join(ws, "mesh", "mesh_0.ply"))
    assert len(faces) > 0 and len(verts) > 0
    with open(os.path.join(ws, "log_ngp.txt")) as f:
        log = f.read()
    assert "[cli] device cpu" in log and "[final eval] {'psnr'" in log

    for d in ("results", "mesh"):
        for p in os.listdir(os.path.join(ws, d)):
            os.remove(os.path.join(ws, d, p))
    env = dict(os.environ, RAW_NGP_PLATFORM="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", "raw_ngp_torch.cli"] + MINI
                       + ["--test", "--ckpt", "latest", "--workspace", ws],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ngp_step000048.npz at step 48" in r.stdout
    assert sorted(os.listdir(os.path.join(ws, "results"))) == results
    assert len(load_ply(os.path.join(ws, "mesh", "mesh_0.ply"))[1]) > 0


def test_cli_without_cuda_raises(tmp_path, monkeypatch):
    """No RAW_NGP_PLATFORM, no card: the CLI raises before it writes
    anything, also where JAX_PLATFORMS=cpu is set."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the CLI would run on it")
    monkeypatch.delenv("RAW_NGP_PLATFORM", raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    ws = str(tmp_path / "ws")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(MINI + ["--iters", "2", "--workspace", ws])
    assert not os.path.exists(ws)
    monkeypatch.setenv("RAW_NGP_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="RAW_NGP_PLATFORM"):
        tcli.main(MINI + ["--iters", "2", "--workspace", ws])


def tiny_cfg(**render_kw):
    """tests/test_trainer_features.py's miniature of -O, in the port's
    config."""
    cfg = tcfg.Config().with_preset_O()
    cfg = replace(cfg, model=replace(
        cfg.model, num_levels=4, log2_hashmap_size=12,
        hashgrid_resolution=32, grid_mlp_hidden=16, view_mlp_hidden=16))
    cfg = replace(cfg, render=replace(
        cfg.render, grid_size=16, samples_per_ray=8, march_candidates=32,
        mark_untrained=False, max_ray_batch=256, **render_kw))
    cfg = replace(cfg, train=replace(
        cfg.train, num_rays=128, iters=8, fp16=False, eval_cnt=1,
        save_cnt=1))
    return cfg.validate()


def test_evaluate_writes_artifacts_with_normals(tmp_path):
    """With compute_normals the validation PNGs include the normal map
    (as tests/test_trainer_features.py asks of JAX's), the PNGs decode to
    the rendered images' uint8 form, and export_npy writes the raw
    prediction and truth; the meters given are the ones reported."""
    cfg = tiny_cfg(compute_normals=True)
    ts, vs = make_synthetic_scene(n_train=4, n_val=2, H=16, W=16)
    tr = ttr.Trainer(cfg, ts, vs, device="cpu", workspace=str(tmp_path))
    tr.train(iters=4, log_every=4)
    out = tr.evaluate(save_artifacts=True, export_npy=True,
                      metrics=[tmet.PSNRMeter(), tmet.SSIMMeter()])
    assert sorted(out) == ["psnr", "ssim"] and np.isfinite(list(
        out.values())).all()
    arts = sorted(os.listdir(tmp_path / "validation"))
    assert arts == [f"{k}_4_{i:03d}.png" for k in
                    ("depth", "error", "normal", "rgb") for i in range(2)]
    rgb, _, nm = tr.render_image(vs.poses[1], vs.intrinsics, 16, 16,
                                 return_normals=True)
    for name, img in (("rgb", rgb), ("normal", nm)):
        np.testing.assert_array_equal(
            read_png(str(tmp_path / "validation" / f"{name}_4_001.png")),
            (np.clip(img, 0, 1) * 255).astype(np.uint8))
    np.testing.assert_array_equal(
        np.load(tmp_path / "eval" / "pred_001.npy"), rgb)
    assert sorted(os.listdir(tmp_path / "eval")) == [
        "gt_000.npy", "gt_001.npy", "pred_000.npy", "pred_001.npy"]


def test_hdr_artifacts_frames_and_merged_frames(tmp_path):
    """An HDR scene: evaluate estimates the exposure levels and writes the
    rgb and truth PNGs postprocessed at one level; test writes the rgb,
    depth frames at that level; a configuration that merges HDR frames
    (a wide exposure range: hdr_merge_algo robertson by default, then
    each merge x tonemap pair) also writes hdr_<i>.png, each bit for bit
    the uint8 form of postprocess_raw_hdr of the same render. The views
    are 32x32 after 24 steps: at 16x16 some channel of an exposure stack
    never takes level 128, Robertson's response is NaN there, and
    Mantiuk and Drago raise (as cv2 does on the same render)."""
    cfg = tiny_cfg()
    cfg = replace(cfg, data=replace(cfg.data, image_mode="HDR"))
    ts, vs = make_synthetic_scene(n_train=4, n_val=2, H=32, W=32, hdr=True)
    vs.exposures[0] = 1.0
    tr = ttr.Trainer(cfg, ts, vs, device="cpu", workspace=str(tmp_path))
    tr.train(iters=24, log_every=24)
    tr.evaluate(save_artifacts=True)
    assert set(tr.exposure_levels) == set(cfg.exposure_percentiles)
    rgb, _ = tr.render_image(vs.poses[1], vs.intrinsics, 32, 32)
    level = tr.exposure_levels[cfg.data.exposure_percentile]
    np.testing.assert_array_equal(
        read_png(str(tmp_path / "validation" / "rgb_24_001.png")),
        (np.clip(postprocess_raw(rgb, np.eye(3, dtype=np.float32), level),
                 0, 1) * 255).astype(np.uint8))
    frames = tr.test(vs)
    assert len(frames) == 2 and frames[0].dtype == np.uint8
    assert sorted(os.listdir(tmp_path / "results")) == [
        "depth_000.png", "depth_001.png", "rgb_000.png", "rgb_001.png"]
    renders = [tr.render_image(vs.poses[i], vs.intrinsics, 32, 32)[0]
               for i in range(2)]
    wide = replace(cfg, data=replace(cfg.data, exposure_range="wide"))
    assert wide.hdr_merge_algo == "robertson"
    pairs = [(None, None)] + [(m, t) for m in ("robertson", "debevec")
                              for t in ("reinhard", "mantiuk", "drago")]
    for merge, tonemap in pairs:
        tr.cfg = wide if merge is None else replace(wide, data=replace(
            wide.data, hdr_merge=merge, hdr_tonemap=tonemap))
        out = tmp_path / f"merged_{merge}_{tonemap}"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)   # NaN -> 0
            frames = tr.test(vs, save_dir=str(out))
            want = [ttr._to_u8(postprocess_raw_hdr(
                r, np.eye(3, dtype=np.float32), wide.exposure_percentiles,
                tr.cfg.hdr_merge_algo, tr.cfg.data.hdr_tonemap))
                for r in renders]
        assert sorted(os.listdir(out)) == [
            "depth_000.png", "depth_001.png", "hdr_000.png", "hdr_001.png",
            "rgb_000.png", "rgb_001.png"]
        for i in range(2):
            np.testing.assert_array_equal(
                read_png(str(out / f"hdr_{i:03d}.png")), want[i])
        np.testing.assert_array_equal(frames[1], read_png(
            str(tmp_path / "results" / "rgb_001.png")))
    tr.test(vs, save_dir=str(tmp_path / "one"), write_video=False)
    assert sorted(os.listdir(tmp_path / "one")) == ["rgb_000.png",
                                                    "rgb_001.png"]


def test_log_poses_dumps_and_errors(tmp_path):
    """fit with pose_opt.log_poses writes a pose snapshot after each chunk
    and logs the Procrustes errors (tests/test_trainer_features.py)."""
    cfg = tiny_cfg().with_pose_opt("barf", num_cameras=4)
    cfg = replace(cfg, pose_opt=replace(cfg.pose_opt, log_poses=True))
    ts, vs = make_synthetic_scene(n_train=4, n_val=1, H=16, W=16)
    tr = ttr.Trainer(cfg, ts, vs, device="cpu", workspace=str(tmp_path))
    tr.fit(4)
    dumps = sorted(os.listdir(tmp_path / "poses"))
    assert dumps == ["poses_step000004.npy"]
    assert np.load(tmp_path / "poses" / dumps[0]).shape == (4, 3, 4)
    errs = tr.log_optimized_poses()
    assert np.isfinite(errs["rotation_deg"])
    assert np.isfinite(errs["translation"])
    with open(tmp_path / "log_ngp.txt") as f:
        assert "[pose] step 4: rot" in f.read()


@pytest.mark.parametrize("tensorboard", ["tensorboardX", "absent"])
def test_run_logger_opens_its_writer_at_the_first_scalar(
        tmp_path, monkeypatch, tensorboard):
    """RunLogger writes every line to the console and log_ngp.txt; it opens
    the tensorboard writer (an event file under run/) at the first scalar
    and closes it with close(); where tensorboardX does not import it is
    inactive and its scalars and histograms go nowhere."""
    if tensorboard == "tensorboardX":
        pytest.importorskip("tensorboardX")
    else:
        monkeypatch.setitem(sys.modules, "tensorboardX", None)
    ws = tmp_path / "ws"
    log = RunLogger(str(ws))
    log.log("[test] a line", 1)
    assert (ws / "log_ngp.txt").read_text() == "[test] a line 1\n"
    assert log.writer is None and not (ws / "run").exists()
    assert log.active == (tensorboard == "tensorboardX")
    log.scalar("train/loss", 0.5, 1)
    log.histogram("train/density_grid", np.arange(8.0), 1)
    if tensorboard == "tensorboardX":
        assert log.writer is not None
        log.close()
        assert log.writer is None
        assert any(f.startswith("events.") for f in os.listdir(ws / "run"))
    else:
        assert log.writer is None and not (ws / "run").exists()
        log.close()


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    """utils.logging.profiler_trace wraps torch.profiler and leaves a
    Chrome trace in the directory; disabled it records nothing."""
    with profiler_trace(str(tmp_path / "on")):
        torch.ones(64).cumsum(0)
    with open(tmp_path / "on" / "trace.json") as f:
        assert "traceEvents" in f.read()
    with profiler_trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not os.path.exists(tmp_path / "off")
