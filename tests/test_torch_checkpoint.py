"""The port's checkpoints (raw_ngp_torch.train.checkpoint and the
Trainer's save / load / fit) on the CPU.

Held to the JAX package (raw_ngp_tpu.train.checkpoint) where the two
share behaviour: the files a sequence of saves leaves under rolling
retention, and what ``resolve_checkpoint`` answers in each of its five
modes. The rest is held bit for bit: a TrainState with pose and grid
fields round-trips exactly; a load keeps the initial value of a missing
or reshaped entry; a Trainer that saves mid-run and is resumed by a new
Trainer takes the steps of the unbroken run (params, EMA, moments, grid,
pose state and counters all bitwise equal), through grid refreshes and
adaptive batching; and ``fit``'s saves, evaluations and gradient
histograms leave training as an unbroken ``train`` leaves it.
"""

import glob
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raw_ngp_torch.config as tcfg
import raw_ngp_tpu.config as jcfg
from raw_ngp_torch.data import make_synthetic_scene
from raw_ngp_torch.models.ngp import make_field_spec
from raw_ngp_torch.train import checkpoint as tck
from raw_ngp_torch.train import trainer as ttr
from raw_ngp_torch.train.state import AdamState, TrainState
from raw_ngp_tpu.models.ngp import init_field as j_init_field
from raw_ngp_tpu.models.ngp import make_field_spec as j_make_spec
from raw_ngp_tpu.train import checkpoint as jck
from raw_ngp_tpu.train.state import TrainState as JState
from test_torch_train import mini_cfg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work, set back after
    it (under pytest-xdist torch's default of a thread a core
    oversubscribes the cores: tests/test_torch_proposal.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pose_cfg(n_cameras=4):
    cfg = mini_cfg(tcfg).with_pose_opt("barf", n_cameras)
    return replace(cfg, train=replace(cfg.train, iters=40, num_rays=256),
                   pose_opt=replace(cfg.pose_opt, noise=0.05))


def random_state(cfg, n_cameras, seed):
    """A TrainState of ``cfg`` whose every tensor and counter holds seeded
    random values (floats normal, integers uniform)."""
    _, st = ttr.init_train_state(cfg, make_field_spec(cfg), "cpu",
                                 n_cameras)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for t in tck.state_tensors(st).values():
            if t.dtype.is_floating_point:
                v = rng.standard_normal(tuple(t.shape))
            else:
                v = rng.integers(0, 100, tuple(t.shape))
            t.copy_(torch.from_numpy(np.asarray(v)).to(t.dtype))
    st.step, st.opt_state.count = int(rng.integers(1, 1000)), 7
    st.pose_opt_state.count = 3
    return st


def assert_same_state(a: TrainState, b: TrainState):
    ta, tb = tck.state_tensors(a), tck.state_tensors(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k
    assert (a.step, a.opt_state.count) == (b.step, b.opt_state.count)
    if a.pose_opt_state is not None:
        assert a.pose_opt_state.count == b.pose_opt_state.count


def test_state_round_trips_bitwise(tmp_path):
    """Every tensor of a state with pose (params, moments, noise) and grid
    fields, and the three counters, come back with the same bits, dtype
    and device, in place (the pose params stay a leaf that requires a
    gradient); the sidecar carries step and stats."""
    cfg = pose_cfg()
    st = random_state(cfg, 4, seed=0)
    path = tck.save_checkpoint(st, str(tmp_path), "ngp_step000011",
                               stats={"loss": [0.5]})
    fresh = random_state(cfg, 4, seed=1)
    pose = fresh.pose_params
    _, meta = tck.load_checkpoint(fresh, path)
    assert_same_state(st, fresh)
    assert fresh.pose_params is pose and pose.requires_grad
    assert meta["step"] == st.step and meta["stats"] == {"loss": [0.5]}
    assert meta["n_loaded"] == len(tck.state_tensors(st)) + 3
    keys = set(np.load(path).files)
    assert {"params.grid", "ema_params.grid_mlp.0", "opt_state.mu.grid",
            "opt_state.nu.view_mlp.2", "opt_state.count", "step",
            "density_grid", "density_bitfield", "mean_density",
            "iter_density", "pose_params", "pose_opt_state.mu.pose",
            "pose_opt_state.nu.pose", "pose_opt_state.count",
            "pose_noise"} <= keys


def test_load_is_tolerant(tmp_path):
    """A missing key and a key whose shape differs keep the initialised
    tensors; every other entry loads, and n_loaded counts them."""
    cfg = pose_cfg()
    st = random_state(cfg, 4, seed=0)
    path = tck.save_checkpoint(st, str(tmp_path), "ngp_step000001")
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    del arrays["params.grid_mlp.0"]
    arrays["ema_params.view_mlp.1"] = arrays["ema_params.view_mlp.1"][:-1]
    np.savez(path, **arrays)
    fresh = random_state(cfg, 4, seed=1)
    keep = {k: t.clone() for k, t in tck.state_tensors(fresh).items()}
    _, meta = tck.load_checkpoint(fresh, path)
    now, ref = tck.state_tensors(fresh), tck.state_tensors(st)
    for k in now:
        expect = keep[k] if k in ("params.grid_mlp.0",
                                  "ema_params.view_mlp.1") else ref[k]
        assert torch.equal(now[k], expect), k
    assert meta["n_loaded"] == len(now) + 3 - 2


def _jax_state(step):
    return JState(params={"w": jnp.ones(3)}, opt_state=(),
                  ema_params={"w": jnp.ones(3)}, key=jax.random.PRNGKey(0),
                  step=jnp.asarray(step, jnp.int32))


def _port_state(step):
    return TrainState(params={"w": torch.ones(3)},
                      opt_state=AdamState(0, {}, {}),
                      ema_params={"w": torch.ones(3)}, step=step)


SAVES = ["ngp_step000010", "ngp_step000020", "ngp_best", "ngp_step000005",
         "ngp_step000030", "ngp_step000100", "ngp_best", "ngp_other"]


@pytest.mark.parametrize("max_keep", [2, 1, 0])
def test_rolling_retention_matches_jax(tmp_path, max_keep):
    """The same sequence of names leaves the same files in both packages."""
    dirs = {}
    for pkg, save, state in (("jax", jck.save_checkpoint, _jax_state),
                             ("torch", tck.save_checkpoint, _port_state)):
        d = dirs[pkg] = str(tmp_path / pkg)
        for i, name in enumerate(SAVES):
            save(state(i), d, name, max_keep=max_keep)
    assert sorted(os.listdir(dirs["torch"])) == \
        sorted(os.listdir(dirs["jax"]))
    if max_keep == 2:
        assert len(glob.glob(os.path.join(dirs["torch"],
                                          "ngp_step*.npz"))) == 2


LAYOUTS = {"empty": [], "steps": ["ngp_step000010", "ngp_step000200",
                                  "ngp_step000030"],
           "steps_and_best": ["ngp_step000010", "ngp_step000020",
                              "ngp_best"]}
MODES = ["scratch", "latest", "latest_model", "best", "path", "missing"]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("mode", MODES)
def test_resolve_checkpoint_matches_jax(tmp_path, layout, mode):
    d = str(tmp_path)
    for name in LAYOUTS[layout]:
        for ext in (".npz", ".json"):
            (tmp_path / (name + ext)).touch()
    arg = {"path": os.path.join(d, (LAYOUTS[layout] or ["none"])[0]
                                + ".npz"),
           "missing": os.path.join(d, "absent.npz")}.get(mode, mode)
    got = tck.resolve_checkpoint(d, arg)
    assert got == jck.resolve_checkpoint(d, arg)
    if mode in ("latest", "best") and layout == "steps":
        assert got.endswith("ngp_step000200.npz")


def resume_cfg(kind):
    """The flagship's miniature with a grid refresh every 2 steps and
    adaptive batching on, so that 40 steps pass the 16 full sweeps and
    adapt; or the pose-refinement miniature (noise, BARF)."""
    if kind == "pose":
        return pose_cfg()
    cfg = mini_cfg(tcfg)
    return replace(cfg, render=replace(cfg.render, update_extra_interval=2),
                   train=replace(cfg.train, num_rays=256,
                                 adaptive_num_rays=True)).validate()


@pytest.mark.parametrize("kind", ["occupancy", "pose"])
def test_resume_continues_the_unbroken_run(tmp_path, kind):
    """35 steps, a save (mid refresh interval), a new Trainer resumed
    from it with ckpt "latest" and 5 more steps: bitwise the state of 40
    unbroken steps, with the same refresh count and adaptive-batch key."""
    cfg = resume_cfg(kind)
    scenes = make_synthetic_scene(n_train=4, n_val=1, H=16, W=16, seed=0)
    ref = ttr.Trainer(cfg, *scenes, device="cpu",
                      workspace=str(tmp_path / "ref"))
    for _ in range(40):
        ref.step()
    ws = str(tmp_path / "run")
    first = ttr.Trainer(cfg, *scenes, device="cpu", workspace=ws)
    for _ in range(35):
        first.step()
    first.save_checkpoint()
    resumed = ttr.Trainer(replace(cfg, ckpt="latest"), *scenes,
                          device="cpu", workspace=ws)
    assert resumed.host_step == 35
    for _ in range(5):
        resumed.step()
    assert_same_state(ref.state, resumed.state)
    for attr in ("host_step", "host_grid_updates", "num_rays",
                 "_point_budget", "_pts_ema"):
        assert getattr(resumed, attr) == getattr(ref, attr), attr
    if kind == "occupancy":
        assert ref.host_grid_updates > 17      # adaptation has run


@pytest.mark.parametrize("grid", ["restored", "dropped"])
def test_resume_marks_the_grid_only_where_it_is_missing(tmp_path,
                                                         monkeypatch, grid):
    """A Trainer resumed from a checkpoint that holds the density grid
    takes that grid and skips the untrained-cell marking; one resumed
    from a checkpoint without it marks its grid as a fresh Trainer does,
    and still restores everything else."""
    cfg = mini_cfg(tcfg)
    assert cfg.render.mark_untrained
    scenes = make_synthetic_scene(n_train=4, n_val=1, H=16, W=16, seed=0)
    fresh = ttr.Trainer(cfg, *scenes, device="cpu",
                        workspace=str(tmp_path / "fresh"))
    ws = str(tmp_path / "run")
    first = ttr.Trainer(cfg, *scenes, device="cpu", workspace=ws)
    for _ in range(17):                  # past a grid refresh
        first.step()
    path = first.save_checkpoint()
    if grid == "dropped":
        with np.load(path, allow_pickle=False) as data:
            arrays = {k: data[k] for k in data.files if k != "density_grid"}
        np.savez(path, **arrays)
    calls = []
    marking = ttr.mark_untrained_grid
    monkeypatch.setattr(ttr, "mark_untrained_grid",
                        lambda *a, **k: calls.append(1) or marking(*a, **k))
    resumed = ttr.Trainer(replace(cfg, ckpt="latest"), *scenes,
                          device="cpu", workspace=ws)
    assert resumed.host_step == 17
    assert not torch.equal(first.state.density_grid,
                           fresh.state.density_grid)
    want = first.state if grid == "restored" else fresh.state
    assert len(calls) == (grid == "dropped")
    assert torch.equal(resumed.state.density_grid, want.density_grid)
    for k, p in first.state.params.items():
        assert torch.equal(resumed.state.params[k], p), k


class _Writer:
    """Stands in for tensorboardX's SummaryWriter, recording the tags."""

    def __init__(self):
        self.scalars, self.histograms = set(), {}

    def add_scalar(self, tag, value, step):
        self.scalars.add(tag)

    def add_histogram(self, tag, values, step):
        assert np.isfinite(values).all(), tag
        self.histograms[tag] = values.shape

    def close(self):
        pass


def jax_histogram_tags(cfg):
    """The tags JAX's Trainer.log_histograms gives the gradient leaves of
    the same configuration's parameter tree (trainer.py:978-987)."""
    params = j_init_field(jax.random.PRNGKey(0), j_make_spec(cfg))
    tags = set()
    for top in ("grid", "grid_mlp", "view_mlp"):
        for path, _ in jax.tree_util.tree_leaves_with_path(params[top]):
            name = "".join(str(p.key) if hasattr(p, "key")
                           else f"[{p.idx}]" if hasattr(p, "idx")
                           else str(p) for p in path) or "w"
            tags.add(f"grad/{top}/{name}")
    return tags


def test_fit_is_train_with_pauses(tmp_path):
    """fit(16) with two saves and two evaluations (each with the gradient
    histograms, written to a recording writer) leaves the state of an
    unbroken train(16) bit for bit, the saves and the best checkpoint in
    place; the histogram tags are the JAX package's."""
    cfg = replace(resume_cfg("occupancy"),
                  train=replace(resume_cfg("occupancy").train, iters=16,
                                save_cnt=2, eval_cnt=2))
    scenes = make_synthetic_scene(n_train=4, n_val=1, H=16, W=16, seed=0)
    ref = ttr.Trainer(cfg, *scenes, device="cpu",
                      workspace=str(tmp_path / "ref"))
    ref.train(16)
    ws = str(tmp_path / "fit")
    tr = ttr.Trainer(cfg, *scenes, device="cpu", workspace=ws)
    tr.logger.writer = writer = _Writer()
    out = tr.fit()
    assert_same_state(ref.state, tr.state)
    for k, p in tr.state.params.items():     # the last step's, untouched
        assert torch.equal(p.grad, ref.state.params[k].grad), k
    assert np.isfinite(out["best_psnr"])
    assert sorted(os.listdir(os.path.join(ws, "checkpoints"))) == [
        "ngp_best.json", "ngp_best.npz", "ngp_step000008.json",
        "ngp_step000008.npz", "ngp_step000016.json", "ngp_step000016.npz"]
    grad_tags = {t for t in writer.histograms if t.startswith("grad/")}
    assert grad_tags == jax_histogram_tags(replace(
        mini_cfg(jcfg), train=replace(mini_cfg(jcfg).train, iters=16)))
    assert "train/density_grid" in writer.histograms
    assert {"train/loss", "train/num_points",
            "train/mean_density"} <= writer.scalars
