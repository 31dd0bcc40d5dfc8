"""The port's chained dispatch (raw_ngp_torch/train/dispatch.py and
Trainer.train) against the step-by-step run and against JAX's loop, on the
CPU, where a chain runs its steps eagerly through the same loop:

(a) Trainer.train in chains (steps_per_dispatch 1, 4 and 0 = auto) leaves
    the params, EMA, moments, grid and generator state of as many
    Trainer.step calls, bit for bit, with and without the occupancy grid
    (tests/test_scan_dispatch.py's check in JAX);
(b) the chain schedule (each dispatch's length and the refreshes before
    it) is JAX's: the JAX Trainer's loop is run with its executables
    stubbed on the instance (no JAX step runs) and its dispatches logged;
(c) every per-step scalar the step reads on the device equals JAX's at
    every step: the LR over the bias correction and the moments'
    corrections at the count, the proposal gate and the pose freeze its
    jitted step's, the annealing's ramp position and BAA-NGP's finest
    level its op-by-op values (within an ulp of its jit's); and the BARF
    / BAA-NGP weights from the device annealing are bit for bit the host
    versions;
(d) the grid refresh and the coarse cache write into the state's own
    buffers (a captured step reads those);
(e) the optimizers' per-count tables, built once, hold the eager host
    values at every count, and kernels.CUDA_KERNELS, by which replayed
    launches are counted from profiler events, names every __global__
    function of the CUDA sources.

On the card the graphed chains are held to the eager steps by
tests/test_torch_kernels.py (gpu) and chip_smoke.py.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raw_ngp_torch.config as tcfg
import raw_ngp_tpu.config as jcfg
from raw_ngp_torch.data import make_synthetic_scene
from raw_ngp_torch.models import ngp as tngp
from raw_ngp_torch.train import trainer as ttr
from raw_ngp_torch.train.scalars import AnnealingTables
from raw_ngp_tpu.data import make_synthetic_scene as j_make_scene
from raw_ngp_tpu.models import ngp as jngp
from raw_ngp_tpu.train import trainer as jtr

from test_torch_proposal import o2_cfg


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch and BLAS thread: six workers share the machine."""
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def scan_cfg(mod, **train_kw):
    """tests/test_scan_dispatch.py's configuration, from either package's
    config module."""
    cfg = mod.Config().with_preset_O()
    cfg = replace(cfg, model=replace(
        cfg.model, num_levels=4, log2_hashmap_size=12,
        hashgrid_resolution=64, grid_mlp_hidden=16, view_mlp_hidden=16,
        fused_encoder=False))
    cfg = replace(cfg, render=replace(
        cfg.render, occupancy=True, grid_size=16, bound=1.5,
        samples_per_ray=16, march_candidates=32, mark_untrained=False,
        update_extra_interval=4, max_ray_batch=1024))
    cfg = replace(cfg, train=replace(
        cfg.train, iters=64, num_rays=256, fp16=False,
        random_image_batch=True, **train_kw))
    return replace(cfg, ckpt="scratch").validate()


def run_cfg(kind, spd):
    if kind == "occupancy":
        return scan_cfg(tcfg, steps_per_dispatch=spd)
    cfg = o2_cfg(tcfg)
    cfg = replace(cfg, render=replace(cfg.render, num_steps=(16, 8, 8)),
                  train=replace(cfg.train, iters=64, num_rays=128,
                                steps_per_dispatch=spd))
    return cfg.validate()


@pytest.fixture(scope="module")
def scene():
    return make_synthetic_scene(n_train=8, n_val=1, H=24, W=24)


def leaves(tr):
    st = tr.state
    out = {f"param.{k}": p.detach().clone() for k, p in st.params.items()}
    out.update({f"ema.{k}": p.clone() for k, p in st.ema_params.items()})
    out.update({f"mu.{k}": p.clone() for k, p in st.opt_state.mu.items()})
    out.update({f"nu.{k}": p.clone() for k, p in st.opt_state.nu.items()})
    for k, v in st.grid_state().items():
        if v is not None:
            out[k] = v.clone()
    out["generator"] = tr.generator.get_state()
    return out


def same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("kind", ["occupancy", "proposal"])
def test_chained_run_equals_step_by_step(tmp_path, scene, kind):
    """13 steps (with the occupancy path's interval of 4: three full
    chains of 4 and a remainder of 1 after the refresh at 12) through
    Trainer.train at steps_per_dispatch 1, 4 and 0 (auto: the interval,
    or 16 on the proposal path) leave what 13 Trainer.step calls leave,
    bit for bit; the host counters and the device counters agree."""
    train, val = scene
    ref = ttr.Trainer(run_cfg(kind, 1), train, val, device="cpu",
                      workspace=str(tmp_path / "steps"))
    for _ in range(13):
        ref.step()
    want = leaves(ref)
    for spd in (1, 4, 0):
        tr = ttr.Trainer(run_cfg(kind, spd), train, val, device="cpu",
                         workspace=str(tmp_path / f"spd{spd}"))
        tr.train(13, log_every=10 ** 9)
        st = tr.state
        assert (tr.host_step, st.step, st.opt_state.count) == (13, 13, 13)
        assert int(st.step_t) == 13 and int(st.opt_state.count_t) == 13
        assert tr.host_grid_updates == ref.host_grid_updates
        got = leaves(tr)
        differ = sorted(k for k, v in want.items()
                        if not same_bits(got[k], v))
        assert not differ, (spd, differ)


# ---------------------------------------------------------------- (b)

def jax_schedule(iters, spd, occupancy=True):
    """JAX's Trainer.train at scan_cfg's size with every executable
    stubbed on the instance: [(grid refreshes so far, dispatch length)]
    per dispatch, as its loop issues them."""
    cfg = scan_cfg(jcfg, steps_per_dispatch=spd)
    if not occupancy:
        cfg = replace(cfg, render=replace(cfg.render, occupancy=False))
    train, val = j_make_scene(n_train=4, n_val=1, H=8, W=8)
    tr = jtr.Trainer(cfg, train, val, workspace=None)
    log = []
    fake = {"loss": jnp.float32(0.5), "num_points": jnp.int32(100)}

    def get_step(scan_steps=1):
        def run(state, scene, aabb):
            log.append((tr.host_grid_updates, scan_steps))
            return state, fake
        return run

    def grid_update(state, host_iter):
        return state

    tr._get_step = get_step
    tr._grid_update = grid_update
    tr._coarse_fn = None
    tr.train(iters=iters, log_every=10 ** 9)
    return log, tr.host_step


def port_schedule(tr, iters):
    """The port's loop with Trainer._dispatch logged on the instance."""
    log = []
    dispatch = tr._dispatch

    def logged(n, chained):
        log.append((tr.host_grid_updates, n))
        return dispatch(n, chained)

    tr._dispatch = logged
    tr.train(iters, log_every=10 ** 9)
    return log, tr.host_step


@pytest.mark.parametrize("spd,iters", [(4, 13), (0, 13), (3, 13), (1, 6),
                                       (8, 21)])
def test_chain_schedule_is_jax(tmp_path, scene, spd, iters):
    """Each dispatch's length and the refreshes before it, as JAX's loop
    issues them: full chains as one dispatch, a remainder step by step,
    every chain cut at the refresh interval (4 here); spd 3 and 8 give
    chains that do not divide the interval."""
    want = jax_schedule(iters, spd)
    train, val = scene
    tr = ttr.Trainer(scan_cfg(tcfg, steps_per_dispatch=spd), train, val,
                     device="cpu", workspace=str(tmp_path))
    got = port_schedule(tr, iters)
    assert got == want


def test_chain_schedule_is_jax_without_grid(tmp_path, scene):
    """The proposal path: no refresh, chains of 16 (auto), a remainder
    of 4 step by step."""
    want = jax_schedule(20, 0, occupancy=False)
    train, val = scene
    cfg = replace(scan_cfg(tcfg, steps_per_dispatch=0),
                  render=replace(scan_cfg(tcfg).render, occupancy=False))
    tr = ttr.Trainer(cfg.validate(), train, val, device="cpu",
                     workspace=str(tmp_path))
    tr._train_step = lambda *a: {"loss": torch.tensor(0.5),
                                 "num_points": torch.tensor(100)}
    got = port_schedule(tr, 20)
    assert got == want
    assert [n for _, n in got[0]] == [16, 1, 1, 1, 1]


# ---------------------------------------------------------------- (c)

def jax_scalars(jc):
    """(step, count) -> JAX's per-step scalars at a step and count, each
    on a 0-d array as its step computes them (trainer.py:357-423,
    fused_adam_ema :111-133; optax's scale_by_adam: 1 - decay **
    count_inc, int32; scale_by_learning_rate: -lr(count)), one jit."""
    lr_fn = jtr.network_lr_schedule(jc)
    pose_lr = jtr.pose_lr_schedule(jc)
    mode = jc.pose_opt.mode
    freeze_step = int(jc.pose_opt.end_annealing * jc.train.iters)

    @jax.jit
    def scalars(s, c):
        cf = (c + 1).astype(jnp.float32)
        out = {"net.lr_over_bias_correction": lr_fn(c) / (1.0 - 0.9 ** cf),
               "net.nu_correction": 1.0 - 0.999 ** cf,
               "proposal_gate": ((s <= 3000) | (s % 5 == 0)).astype(
                   jnp.float32)}
        if mode != "none":
            out["annealing_alpha_jit"] = alpha_of(s)
            out["pose_freeze"] = (s >= freeze_step).astype(jnp.float32)
            out["pose.mu_correction"] = 1 - 0.9 ** (c + 1)
            out["pose.nu_correction"] = 1 - 0.999 ** (c + 1)
            out["pose.minus_lr"] = -pose_lr(c)
        return out

    def alpha_of(s):
        ann = jnp.clip(s / jc.train.iters, 0.0, 1.0)
        return jngp._anneal_alpha(jc, ann, jc.model.num_levels
                                  - (mode == "baangp"))

    def at(step, count):
        s = jnp.asarray(step, jnp.int32)
        out = scalars(s, jnp.asarray(count, jnp.int32))
        if mode != "none":     # op by op
            alpha = alpha_of(s)
            out["annealing_alpha"] = alpha
            out["j_star"] = jnp.clip(jnp.ceil(alpha).astype(jnp.int32), 0,
                                     jc.model.num_levels - 1)
        return {k: np.asarray(v) for k, v in out.items()}
    return at


@pytest.mark.parametrize("mode", ["none", "barf", "baangp"])
def test_step_scalars_are_jax_at_every_step(mode):
    """The scalars the train step reads on the device, at the device
    counters set to every step 0..179 of a 64-step schedule (past iters
    and the pose freeze at step 21; the proposal gate from step 2990 to
    3010 too), equal JAX's bit for bit: the jitted step's, and for the
    annealing's ramp position and BAA-NGP's finest level JAX's op by op
    (its jit computes the ramp position an ulp apart at some steps, held
    within one ulp)."""
    tc = run_cfg("proposal", 1)
    jc = o2_cfg(jcfg)
    jc = replace(jc, train=replace(jc.train, iters=64))
    if mode != "none":
        tc = tc.with_pose_opt(mode, 4)
        jc = jc.with_pose_opt(mode, 4)
    spec = tngp.make_field_spec(tc)
    field, state = ttr.init_train_state(tc, spec, device="cpu",
                                        num_cameras=4)
    pose_tx = ttr.pose_adam(tc) if mode != "none" else None
    step = ttr.make_train_step(tc, spec, ttr.fused_adam_ema(tc), 64,
                               pose_tx=pose_tx)
    jax_at = jax_scalars(jc)
    steps = list(range(180)) + list(range(2990, 3011))
    for s in steps:
        state.step = state.opt_state.count = s
        if state.pose_opt_state is not None:
            state.pose_opt_state.count = s
        step.prepare(state)
        got = {k: v.numpy() for k, v in step.scalars(state).items()}
        want = jax_at(s, s)
        if "j_star" in got:
            got["j_star"] = got["j_star"].astype(np.int32)
        if mode != "none":
            # XLA's jit multiplies by the reciprocal of the ramp length
            # where the port divides (an ulp apart at some steps)
            jit = want.pop("annealing_alpha_jit")
            assert abs(np.int64(got["annealing_alpha"].view(np.int32))
                       - np.int64(jit.view(np.int32))) <= 1, (mode, s)
        assert set(got) == set(want) - (
            set() if mode == "baangp" else {"j_star"}), sorted(got)
        for k, v in got.items():
            v = want[k]
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), \
                (mode, s, k, got[k], v)


@pytest.mark.parametrize("mode", ["barf", "baangp"])
def test_device_annealing_is_the_host_annealing(mode):
    """barf_level_weights and baangp_blend under the device annealing of
    every step 0..70 (iters 64) are bit for bit the host versions at
    annealing_at(step), and so is BAA-NGP's gradient of the features."""
    cfg = run_cfg("occupancy", 1).with_pose_opt(mode, 4)
    tables = AnnealingTables(cfg, "cpu")
    rng = np.random.default_rng(0)
    L, C = cfg.model.num_levels, cfg.model.level_dim
    feats = torch.from_numpy(rng.standard_normal((37, L * C)).astype(
        np.float32))
    g = torch.from_numpy(rng.standard_normal((37, L * C)).astype(np.float32))
    for s in range(71):
        dev_ann = tables.at(torch.tensor(s))
        host_ann = ttr.annealing_at(cfg, s)
        if mode == "barf":
            assert same_bits(tngp.barf_level_weights(cfg, dev_ann),
                             tngp.barf_level_weights(cfg, host_ann)), s
            continue
        outs = []
        for ann in (dev_ann, host_ann):
            f = feats.clone().requires_grad_()
            out = tngp.baangp_blend(cfg, ann, f)
            (out * g).sum().backward()
            outs.append((out.detach(), f.grad))
        assert same_bits(outs[0][0], outs[1][0]), s
        assert same_bits(outs[0][1], outs[1][1]), s


# ---------------------------------------------------------------- (d)

def test_refresh_writes_in_place(tmp_path, scene):
    """data_ptr() of the four grid buffers and of the coarse cache stays
    the same across refreshes (full sweeps and partial ones), through
    Trainer.step and Trainer.train, while their values change."""
    train, val = scene
    cfg = scan_cfg(tcfg, steps_per_dispatch=4)
    cfg = replace(cfg, render=replace(cfg.render, coarse_probes=8))
    tr = ttr.Trainer(cfg.validate(), train, val, device="cpu",
                     workspace=str(tmp_path))
    st = tr.state
    names = ("density_grid", "density_bitfield", "mean_density",
             "iter_density")
    tr.step()
    ptrs = [getattr(st, k).data_ptr() for k in names]
    coarse = tr.scene_arrays["coarse_lin"].data_ptr()
    before = st.density_grid.clone()
    tr._refresh_coarse_cache()
    tr.train(71, log_every=10 ** 9)          # 18 refreshes: past the 16
    assert tr.host_grid_updates == 18
    assert [getattr(st, k).data_ptr() for k in names] == ptrs
    assert tr.scene_arrays["coarse_lin"].data_ptr() == coarse
    assert int(st.iter_density) == 18
    assert not torch.equal(st.density_grid, before)


# ---------------------------------------------------------------- (e)

@pytest.mark.parametrize("which", ["net", "net_anneal_lr", "pose"])
def test_count_tables_hold_every_count(which):
    """The optimizers' per-count tables, built once, give the eager host
    values at every count: each count up to past the last one a table
    holds (where the bias corrections reach 1.0, the network LR stops at
    train.iters or the cosine's 6000, the pose LR decays to 0.0), and
    counts far past it; divisors as the f32 values on the CPU."""
    cfg = run_cfg("occupancy", 1)
    if which == "net_anneal_lr":
        cfg = replace(cfg, train=replace(cfg.train, anneal_lr=True))
    corr = [ttr._bias_correction(b) for b in (0.9, 0.999)]
    params = {"w": torch.zeros(3)}
    if which == "pose":
        tx = ttr.pose_adam(cfg)
        state = tx.init(torch.zeros(4, 6))
        lr = ttr.pose_lr_schedule(cfg)

        def want(c):
            return {"mu_correction": corr[0](c), "nu_correction": corr[1](c),
                    "minus_lr": -lr(c)}
    else:
        tx = ttr.fused_adam_ema(cfg)
        state = tx.init(params)
        lr = ttr.network_lr_schedule(cfg)

        def want(c):
            return {"lr_over_bias_correction": lr(c) / corr[0](c),
                    "nu_correction": corr[1](c)}
    counts = sorted(set(range(0, 20000, 7)) | set(range(1530, 1560))
                    | set(range(17250, 17300)) | {cfg.train.iters - 1,
                    cfg.train.iters, 5999, 6000, 6001, 2 ** 20, 2 ** 31})
    if which == "pose":
        counts += list(range(1300, 1500))    # the LR's underflow at 64
    for c in counts:
        state.count = c
        tx.prepare(state)
        got = tx.scalars(state)
        for k, v in want(c).items():
            assert np.array_equal(got[k].numpy(), np.float32(v)), (c, k)


def test_cuda_kernels_name_every_global_function():
    """kernels.CUDA_KERNELS is the set of __global__ functions of the
    CUDA sources, and kernel_of finds each in a profiler event's name
    (a template's arguments, an anonymous namespace) and nothing else."""
    import pathlib
    import re

    from raw_ngp_torch.kernels import CUDA_KERNELS, kernel_of
    csrc = pathlib.Path(ttr.__file__).parents[1] / "csrc"
    found = set()
    for f in csrc.glob("*.cu*"):
        found |= set(re.findall(
            r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s*)?"
            r"(?:void\s+)?(\w+)\s*\(", f.read_text()))
    assert found == set(CUDA_KERNELS) and len(CUDA_KERNELS) == len(found)
    for name in CUDA_KERNELS:
        assert kernel_of(f"void (anonymous namespace)::{name}<2, true>"
                         f"(float const*, int)") == name
        assert kernel_of(f"void {name}(float*)") == name
    assert kernel_of("void at::native::vectorized_elementwise_kernel<4>"
                     "(int, hash_encode_kernel)") is None
    assert kernel_of("Memcpy HtoD (Pageable -> Device)") is None
