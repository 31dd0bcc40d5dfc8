"""The port's HDR merge and tonemaps (raw_ngp_torch/postprocess/hdr.py,
numpy copies of OpenCV's photo module) against cv2, and its
``postprocess_raw_hdr`` against the JAX package's (which calls cv2), on
the CPU.

Inputs: a 32 x 48 linear image made from a seed with numpy (log-normal
radiance, a left-to-right ramp, coloured channels, 6 black rows, 2% of
the pixels 50x brighter) re-exposed at JAX's 4 and 7 percentile sets as
``postprocess_raw_hdr`` does. With 4 exposures some channel never takes
level 128, so Robertson's response is NaN in that channel (cv2's 0 * inf)
and its merge NaN there; Mantiuk and Drago then fail cv2's assertions and
the port raises ``ValueError`` at the same inputs.

Tolerances reached (targets: responses and radiance rtol 1e-4, Reinhard
and Drago 1e-5 absolute, Mantiuk 5e-3, frames at most 1 level apart on at
most 0.5% of values):

- Robertson's response: NaN at the same levels, elsewhere rtol 2e-5
  (reached 3.3e-6: f32 sums in cv2's order); both merges, given the same
  response: rtol 1e-5 (reached 1.4e-6).
- Debevec's response does not reach rtol 1e-4. The port solves the
  least-squares system with LAPACK in float64 (in float32 it agrees to
  2e-7 in log); cv2 solves it in float32 through its own OpenBLAS, and
  its answer depends on that library's thread count: on this input at 1,
  2, 4 and 8 threads its residual in channel 0 is 5.2542, 5.3176, 5.4262
  and 5.2644 against the least-squares 5.2526, above it in every channel
  at every count, its log response moved by up to 7.5e-2
  (port_tools/debevec_solver_probe.py). So this module runs cv2 (and
  numpy) on one BLAS thread, which gives one answer on every run and
  core count. There, at the levels that a sample with a nonzero weight
  takes, the responses agree within rtol 2e-2 (reached 9.5e-3 with 4
  exposures, 9.2e-4 with 7); elsewhere, where only the smoothness rows
  fix the curve (the top levels), they differ by up to 4.1% here. Tested:
  the port's residual is at most cv2's, and the levels that samples fix
  agree.
- Tonemaps on the same radiance: all three within 1e-6 (reached 4.8e-7;
  cv2's own log, exp and pow round differently from numpy's in the last
  bit). NaN positions are identical, except at most one value a channel:
  the darkest value after a Debevec merge, which cv2's stretch puts at -1
  ulp or +0 by the last bit of the image's maximum, so that ``pow(x, 1 /
  2.2)`` is NaN on one side and below 1e-3 on the other (1 value in 2 of
  the 6 Debevec cases here).
- ``postprocess_raw_hdr``: with Robertson all 6 pairs give the same uint8
  frame bytes as JAX's (within 3e-7 before rounding; at 4 exposures a
  channel is NaN and Mantiuk and Drago raise on both sides); with Debevec
  the response above carries through: with 4 exposures frames at most 2
  levels apart (more than 1 on 0.02% of values), 1 apart on up to 11%;
  with 7 at most 1 apart, on up to 0.65%. The port's merge and tonemap
  fed cv2's Debevec response meet the targets (frames at most 1 level
  apart on at most 0.5%).
"""

import warnings

import numpy as np
import pytest

from raw_ngp_torch.postprocess import hdr
from raw_ngp_torch.postprocess.raw import postprocess_raw_hdr

P4 = (97.0, 99.0, 99.9, 100.0)
P7 = (70.0, 80.0, 90.0, 97.0, 99.0, 99.9, 100.0)
SETS = {"p4": P4, "p7": P7}
CAM2RGB = np.array([[1.1, -0.05, -0.05], [-0.1, 1.2, -0.1],
                    [0.0, -0.2, 1.2]])
MERGES = ("robertson", "debevec")
TONEMAPS = ("reinhard", "mantiuk", "drago")


@pytest.fixture(scope="module")
def cv2():
    mod = pytest.importorskip("cv2")
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread for this module (cv2's OpenBLAS and numpy's), where
    threadpoolctl is present: cv2's Debevec solve gives another answer at
    each thread count (module docstring), and under pytest-xdist (-n 6) a
    thread a core oversubscribes the cores (the Debevec cases took 162 s
    of a worker against 10 s alone)."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(limits=1):
        yield


def linear_image(seed=0, H=32, W=48):
    rng = np.random.default_rng(seed)
    img = rng.lognormal(-2.0, 1.2, (H, W, 3)).astype(np.float32)
    xx = np.arange(W, dtype=np.float32)[None, :, None]
    img *= (0.5 + xx / W) * np.array([1.0, 0.8, 1.3], np.float32)
    img[:6] = 0.0
    img[rng.random((H, W)) < 0.02] *= 50.0
    return img


def exposures(rgb_linear, percentiles):
    """postprocess_raw_hdr's exposure stack (raw_ngp_tpu/postprocess/
    raw.py:106-114)."""
    exposed, times = [], []
    for p in percentiles:
        exp = np.percentile(rgb_linear, p)
        if exp > 0:
            exposed.append((255.0 * np.clip(rgb_linear / exp, 0, 1))
                           .astype(np.uint8))
            times.append(exp)
    return exposed, np.array([1.0 / t for t in times], np.float32)


def stack(name):
    return exposures(linear_image() @ CAM2RGB.T, SETS[name])


def rel_err(got, want):
    ok = ~np.isnan(want)
    return float(np.max(np.abs(got[ok] - want[ok])
                        / np.maximum(np.abs(want[ok]), 1e-30)))


def to_u8(img):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def assert_nan_alike(got, want):
    """NaN at the same positions, but for at most one value a channel
    that is NaN on one side and below 1e-3 on the other (the darkest
    value's last-bit case, see the module docstring)."""
    differ = np.isnan(got) != np.isnan(want)
    other = np.where(np.isnan(got), want, got)[differ]
    assert (other < 1e-3).all(), other
    per_channel = differ.reshape(-1, 3).sum(0)
    assert (per_channel <= 1).all(), per_channel


def frames_close(got, want, max_diff, frac_over_1):
    d = np.abs(to_u8(got).astype(int) - to_u8(want))
    assert d.max() <= max_diff, d.max()
    assert (d > 1).mean() <= frac_over_1, (d > 1).mean()
    return d


@pytest.mark.parametrize("name", sorted(SETS))
def test_calibrate_robertson_against_cv2(cv2, name):
    """The response: NaN at the levels no pixel takes (every level of a
    channel where level 128 is never taken), the rest within rtol 2e-5."""
    ims, t = stack(name)
    want = cv2.createCalibrateRobertson().process(ims, times=t)
    got = hdr.calibrate_robertson(ims, t)
    assert got.shape == (256, 1, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if (~np.isnan(want)).any():
        assert rel_err(got, want) < 2e-5


@pytest.mark.parametrize("name", sorted(SETS))
def test_merge_robertson_against_cv2(cv2, name):
    """Given cv2's response (and the default linear one): rtol 1e-5; a
    pixel at 0 in every exposure merges to 0."""
    ims, t = stack(name)
    crf = cv2.createCalibrateRobertson().process(ims, times=t)
    for resp in (crf, None):
        want = cv2.createMergeRobertson().process(ims, times=t,
                                                  response=resp)
        got = hdr.merge_robertson(ims, t, resp)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert rel_err(got, want) < 1e-5
    assert (hdr.merge_robertson(ims, t, None)[:6] == 0).all()


def _debevec_residual(ims, t, g, ch):
    """The least-squares residual of log response g [256] in channel ch
    of the port's system, with each sample's optimal log radiance."""
    H, W = ims[0].shape[:2]
    pts = hdr._debevec_points(H, W, 70, False)
    w = hdr._triangle_weights().astype(np.float64)
    lt = np.log(t).astype(np.float64)
    res = []
    for x, y in pts:
        z = np.array([im[y, x, ch] for im in ims])
        wz = w[z]
        if wz.sum() == 0:
            continue
        e = (wz ** 2 @ (g[z] - lt)) / (wz ** 2).sum()
        res.append(wz * (g[z] - e - lt))
    res.append(np.array([g[128]]))
    res.append(10.0 * w[1:255] * (g[:-2] - 2 * g[1:-1] + g[2:]))
    return float(np.linalg.norm(np.concatenate(res)))


@pytest.mark.parametrize("name", sorted(SETS))
def test_calibrate_debevec_against_cv2(cv2, name):
    """Not within the target rtol 1e-4 (module docstring): the port's
    least-squares residual is at most cv2's in every channel, and at the
    levels that a sample with a nonzero weight takes the responses agree
    within rtol 2e-2."""
    ims, t = stack(name)
    want = cv2.createCalibrateDebevec().process(ims, times=t)
    got = hdr.calibrate_debevec(ims, t)
    assert got.shape == (256, 1, 3) and got.dtype == np.float32
    assert np.isfinite(got).all()
    H, W = ims[0].shape[:2]
    pts = hdr._debevec_points(H, W, 70, False)
    assert len(pts) == 10 * 7
    # x_points * y_points, which differs from `samples` on other shapes
    assert len(hdr._debevec_points(32, 60, 70, False)) == 11 * 6
    for ch in range(3):
        g_got = np.log(got[:, 0, ch].astype(np.float64))
        g_want = np.log(want[:, 0, ch].astype(np.float64))
        assert (_debevec_residual(ims, t, g_got, ch)
                <= _debevec_residual(ims, t, g_want, ch) * (1 + 1e-6))
        taken = sorted({int(im[y, x, ch]) for x, y in pts for im in ims}
                       - {0, 255})
        assert rel_err(got[taken, 0, ch], want[taken, 0, ch]) < 2e-2
    assert abs(float(got[128, 0, 0]) - 1.0) < 1e-2


@pytest.mark.parametrize("name", sorted(SETS))
def test_merge_debevec_against_cv2(cv2, name):
    """Given cv2's response (and the default linear one): rtol 1e-5; a
    pixel at 0 in every exposure gets the unweighted mean, not NaN."""
    ims, t = stack(name)
    crf = cv2.createCalibrateDebevec().process(ims, times=t)
    for resp in (crf, None):
        want = cv2.createMergeDebevec().process(ims, times=t, response=resp)
        got = hdr.merge_debevec(ims, t, resp)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert rel_err(got, want) < 1e-5
    assert np.isfinite(hdr.merge_debevec(ims, t, crf)[:6]).all()


def radiance_maps(cv2):
    """cv2's radiance maps of both merges at both exposure sets, and a
    coloured map (the gray conversion's channel order shows there)."""
    out = {}
    for name in sorted(SETS):
        ims, t = stack(name)
        crf = cv2.createCalibrateRobertson().process(ims, times=t)
        out[f"robertson_{name}"] = cv2.createMergeRobertson().process(
            ims, times=t, response=crf)
        crf = cv2.createCalibrateDebevec().process(ims, times=t)
        out[f"debevec_{name}"] = cv2.createMergeDebevec().process(
            ims, times=t, response=crf)
    rng = np.random.default_rng(3)
    out["colour"] = (rng.random((20, 31, 3))
                     * np.array([1.0, 0.2, 3.0])).astype(np.float32)
    return out


TONEMAP_TOL = 1e-6


@pytest.mark.parametrize("tonemap", TONEMAPS)
def test_tonemaps_against_cv2(cv2, tonemap):
    """Each tonemap on each radiance map: within 1e-6 of cv2's, NaN
    positions alike (assert_nan_alike),
    and where cv2 fails an assertion the port raises ValueError."""
    make = {"reinhard": lambda: cv2.createTonemapReinhard(
                gamma=2.2, intensity=-1, light_adapt=0, color_adapt=0),
            "mantiuk": lambda: cv2.createTonemapMantiuk(
                gamma=2.2, scale=0.7, saturation=1.0),
            "drago": lambda: cv2.createTonemapDrago(
                gamma=2.2, saturation=1.0, bias=0.85)}[tonemap]
    port = getattr(hdr, f"tonemap_{tonemap}")
    raised = 0
    for key, src in radiance_maps(cv2).items():
        try:
            want = make().process(src)
        except cv2.error:
            with pytest.raises(ValueError):
                port(src)
            raised += 1
            continue
        got = port(src)
        assert got.dtype == np.float32 and got.shape == src.shape, key
        assert_nan_alike(got, want)
        both = ~np.isnan(got) & ~np.isnan(want)
        if both.any():
            assert (np.abs(got[both] - want[both]).max()
                    <= TONEMAP_TOL)
        if key == "robertson_p7":
            # the black rows: luminance 0, so 0 / 0 in mapLuminance
            assert np.isnan(want[:6]).all() == (tonemap != "reinhard")
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert raised == (0 if tonemap == "reinhard" else 1)


def test_tonemap_linear_stretch_bits(cv2):
    """cv2.createTonemap's stretch and pow, bit for bit at gamma 1 on
    coloured maps with a minimum above 0 (one fma with f32(1/d) and
    f32(-min/d), d = f32(max - min)); a NaN first value means no
    stretch."""
    rng = np.random.default_rng(5)
    for k in range(8):
        src = (rng.random((20, 31, 3)) * np.array([1.0, 0.2, 3.0])
               + 0.1 * k).astype(np.float32)
        np.testing.assert_array_equal(hdr._stretch(src, 1.0),
                                      cv2.createTonemap(1.0).process(src))
    src = rng.random((8, 8, 3)).astype(np.float32)
    src[0, 0, 0] = np.nan
    np.testing.assert_array_equal(hdr._stretch(src, 1.0),
                                  cv2.createTonemap(1.0).process(src))
    src[0, 0, 0], src[3, 3, 1] = 0.5, np.nan
    np.testing.assert_array_equal(hdr._stretch(src, 1.0),
                                  cv2.createTonemap(1.0).process(src))


@pytest.mark.parametrize("merge", MERGES)
@pytest.mark.parametrize("tonemap", TONEMAPS)
@pytest.mark.parametrize("name", sorted(SETS))
def test_postprocess_raw_hdr_against_jax(cv2, merge, tonemap, name):
    """The port's postprocess_raw_hdr against JAX's (cv2) on the same
    render: both raise where cv2 fails an assertion; otherwise NaN alike,
    and the uint8 frames the Trainer writes the same bytes (Robertson) or
    (Debevec, module docstring) at most 2 levels apart (4 exposures) or 1
    (7), more than 1 on at most 0.5% of values, 1 apart on at most 15%
    (4) or 1% (7)."""
    from raw_ngp_tpu.postprocess.raw import postprocess_raw_hdr as jax_hdr

    lin = linear_image()
    try:
        want = jax_hdr(lin, CAM2RGB, SETS[name], merge, tonemap)
    except cv2.error:
        with pytest.raises(ValueError):
            postprocess_raw_hdr(lin, CAM2RGB, SETS[name], merge, tonemap)
        assert (merge, name) == ("robertson", "p4") and tonemap != "reinhard"
        return
    got = postprocess_raw_hdr(lin, CAM2RGB, SETS[name], merge, tonemap)
    assert got.dtype == np.float32 and got.shape == lin.shape
    assert_nan_alike(got, want)
    if merge == "robertson":
        np.testing.assert_array_equal(to_u8(got), to_u8(want))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        both = ~np.isnan(want)
        if both.any():
            assert np.abs(got[both] - want[both]).max() < 3e-7
    else:
        d = frames_close(got, want, max_diff={"p4": 2, "p7": 1}[name],
                         frac_over_1=0.005)
        assert (d > 0).mean() <= {"p4": 0.15, "p7": 0.01}[name]


@pytest.mark.parametrize("tonemap", TONEMAPS)
@pytest.mark.parametrize("name", sorted(SETS))
def test_debevec_pipeline_on_cv2_response(cv2, tonemap, name):
    """The port's Debevec merge and tonemap fed cv2's response (the only
    stage that misses its target): frames at most 1 level apart on at
    most 0.5% of values."""
    ims, t = stack(name)
    crf = cv2.createCalibrateDebevec().process(ims, times=t)
    want_hdr = cv2.createMergeDebevec().process(ims, times=t, response=crf)
    tm = {"reinhard": cv2.createTonemapReinhard(2.2, -1, 0, 0),
          "mantiuk": cv2.createTonemapMantiuk(2.2, 0.7, 1.0),
          "drago": cv2.createTonemapDrago(2.2, 1.0, 0.85)}[tonemap]
    want = tm.process(want_hdr)
    got = getattr(hdr, f"tonemap_{tonemap}")(hdr.merge_debevec(ims, t, crf))
    assert_nan_alike(got, want)
    d = frames_close(got, want, max_diff=1, frac_over_1=0.0)
    assert (d > 0).mean() <= 0.005


def test_errors():
    """The JAX function's ValueErrors, and bad inputs."""
    lin = linear_image()
    with pytest.raises(ValueError, match="3-channel"):
        postprocess_raw_hdr(lin[..., 0], CAM2RGB, P4)
    with pytest.raises(ValueError, match="merge algo"):
        postprocess_raw_hdr(lin, CAM2RGB, P4, "mertens")
    with pytest.raises(ValueError, match="tonemap"):
        postprocess_raw_hdr(lin, CAM2RGB, P7, "robertson", "linear")
    ims, t = stack("p7")
    with pytest.raises(ValueError):
        hdr.merge_robertson(ims, t[:3])
    with pytest.raises(ValueError):
        hdr.merge_debevec([im.astype(np.float32) for im in ims], t)
    with pytest.raises(ValueError):
        hdr.tonemap_reinhard(np.ones((4, 4, 3)))      # float64


def test_percentiles_at_zero_are_dropped():
    """Exposures whose percentile is 0 are left out, as in JAX's
    function: a mostly black image keeps the exposures above 0 only."""
    lin = linear_image()
    lin[:24] = 0.0
    ims, t = exposures(lin @ CAM2RGB.T, P7)
    assert 0 < len(ims) < len(P7) and len(t) == len(ims)
    out = postprocess_raw_hdr(lin, CAM2RGB, P7, "robertson", "reinhard")
    assert out.shape == lin.shape
