"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (marker ``gpu``) and skips
where torch.cuda is unavailable. The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels.py --noconftest -m gpu

(``--noconftest``: tests/conftest.py sets up JAX for the other tests.)
"""

import numpy as np
import pytest
import torch

from raw_ngp_torch.kernels import compact as tc
from raw_ngp_torch.kernels import hash_encode as th
from raw_ngp_torch.kernels import segsum as ts
from raw_ngp_torch.kernels import sort as tsort
from raw_ngp_torch.ops.hashgrid import HashGridSpec, hash_encode_01

from decimate_cases import DECIMATE_CASES, decimate_case
from sort_cases import SORT_BITS, SORT_CASES, SORT_SIZES, sort_case


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA only")
    return torch.device("cuda")


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(96, 64), (96, 40), (8191, 64),
                                   (32768, 64)])
@pytest.mark.parametrize("name", DECIMATE_CASES)
def test_decimate_kernels_bit_exact(cuda_device, name, shape):
    """The fold's three forward kernels and its backward against the plain
    chain (decimate_compact_plain and its autograd), bit for bit: every
    output, and the gradients in ts, in the broadcast deltas and in dt;
    two calls give the same bits."""
    N, K = shape
    mask, miss, ts, dt, m_pad = (
        torch.from_numpy(a).to(cuda_device) if isinstance(a, np.ndarray)
        else a for a in decimate_case(name, N, K))
    miss = miss[:, None].contiguous()
    g = torch.randn(2, m_pad, generator=torch.Generator(
        device=cuda_device).manual_seed(1), device=cuda_device)
    outs, grads = [], []
    before = (tc.decimate_compact.launches, tc.decimate_compact_bwd.launches)
    for plain in (False, False, True):
        ts_r = ts.clone().requires_grad_()
        dt_r = dt.clone().requires_grad_()
        deltas = dt_r.expand(N, K)
        deltas.retain_grad()
        out = tc.decimate_compact(mask, miss, ts_r, deltas, m_pad,
                                  plain=plain)
        (out[0] * g[0] + out[1] * g[1]).sum().backward()
        outs.append([o.detach() for o in out])
        grads.append((ts_r.grad, deltas.grad, dt_r.grad))
    assert tc.decimate_compact.launches == before[0] + 2
    assert tc.decimate_compact_bwd.launches == before[1] + 2
    torch.cuda.synchronize()
    for i in (1, 2):
        for a, b in zip(outs[0], outs[i]):
            assert _same_bits(a, b), (name, shape, i)
        for a, b in zip(grads[0], grads[i]):
            assert _same_bits(a, b), (name, shape, i)
    assert int(outs[0][6]) <= m_pad


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(96, 64), (96, 40), (8191, 64),
                                   (32768, 64)])
@pytest.mark.parametrize("name", DECIMATE_CASES)
def test_decimate_positions_bit_exact(cuda_device, name, shape):
    """The fold with ``positions=True`` (the place kernel's extra store of
    each slot's flat source index): pos bit for bit the plain version's
    (compact_positions_attrs'), and t_c, dt_c, rid, filled and the counts
    the same bits as the fold without it; one launch of three kernels
    either way."""
    N, K = shape
    mask, miss, ts, dt, m_pad = (
        torch.from_numpy(a).to(cuda_device) if isinstance(a, np.ndarray)
        else a for a in decimate_case(name, N, K))
    miss = miss[:, None].contiguous()
    deltas = dt.expand(N, K)
    before = tc.decimate_compact.launches
    with_pos = tc.decimate_compact(mask, miss, ts, deltas, m_pad,
                                   positions=True)
    without = tc.decimate_compact(mask, miss, ts, deltas, m_pad)
    plain = tc.decimate_compact(mask, miss, ts, deltas, m_pad, plain=True,
                                positions=True)
    assert tc.decimate_compact.launches == before + 2
    torch.cuda.synchronize()
    assert len(with_pos) == 8 and len(without) == 7
    for a, b in zip(with_pos, plain):
        assert _same_bits(a, b), (name, shape)
    for a, b in zip(with_pos[:7], without):
        assert _same_bits(a, b), (name, shape)


def _points(B):
    rng = np.random.default_rng(0)
    x = rng.random((B, 3)).astype(np.float32)
    x[:8] = x[:8] * 3.0 - 1.0          # out of bounds -> zeros
    x[8:12, 1] = np.nan                # NaN -> zeros
    x[12], x[13] = 0.0, 1.0
    return x


# the encode kernels' grid specs: four hash / interpolation variants at
# L = 4 (level 0 dense, on the matmul path from C = 8), and a spec that
# mixes the paths at L = 6: levels 0-2 dense (0-1 on the matmul path at
# C = 8, 0 at C = 16 and 32, none below C = 8; the rest dense window
# levels), levels 3-5 hashed
_ENCODE_SPECS = {
    "additive": dict(num_levels=4, log2_hashmap_size=14,
                     desired_resolution=512, hash_variant="additive"),
    "xor": dict(num_levels=4, log2_hashmap_size=14, desired_resolution=512,
                hash_variant="xor"),
    "xor_align_smoothstep": dict(num_levels=4, log2_hashmap_size=14,
                                 desired_resolution=512, hash_variant="xor",
                                 align_corners=True,
                                 interpolation="smoothstep"),
    "xor_tiled": dict(num_levels=4, log2_hashmap_size=14,
                      desired_resolution=512, hash_variant="xor",
                      gridtype="tiled"),
    "mixed": dict(num_levels=6, base_resolution=16, log2_hashmap_size=17,
                  desired_resolution=128),
}


def _encode_points(kind, B, spec, device, seed=0):
    """B points of one kind: uniform, ray-ordered (the train forward's
    input) or a Morton-ordered run of jittered cell centres (a grid
    refresh chunk), with the edge cases in the first 10 rows: 4 outside
    [0, 1]^3 and 2 with a NaN (all encode to 0), 0.0, 1.0, and the clip
    ties x * res - 0.5 == 0 and == res - 1 of the finest level."""
    from raw_ngp_torch.ops.grid import cascade_coords_to_world
    from raw_ngp_torch.ops.morton import morton3d_invert
    gen = torch.Generator(device=device).manual_seed(seed)
    if kind == "uniform":
        x = torch.rand(B, 3, generator=gen, device=device)
    elif kind == "ray":
        x = _ray_points(B + 31, gen, device)[:B].contiguous()
    else:                                   # "morton": 128^3 grid, bound 1
        n = 128
        codes = torch.arange(B, device=device) + 12345
        noise = torch.rand(B, 3, generator=gen, device=device)
        xyz = cascade_coords_to_world(morton3d_invert(codes), 1.0, 1.0 / n, n,
                                      noise)
        x = ((xyz + 1.0) / 2.0).clamp(0.0, 1.0).contiguous()
    res = spec.resolutions[-1]
    x[0] = torch.tensor([-0.5, 0.5, 0.5])
    x[1] = torch.tensor([0.5, 1.5, 0.5])
    x[2] = torch.tensor([0.5, 0.5, -1e-3])
    x[3] = 2.0
    x[4:6, 1] = float("nan")
    x[6], x[7] = 0.0, 1.0
    x[8, 0] = 0.5 / res
    x[9, 2] = (res - 0.5) / res
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["uniform", "ray", "morton"])
@pytest.mark.parametrize("spec_name", sorted(_ENCODE_SPECS))
@pytest.mark.parametrize("C", [1, 2, 4, 8, 16, 32])
def test_encode_kernel_matches_plain(cuda_device, spec_name, kind, C):
    """f32 against hash_encode_01 at atol 1e-6; bf16 against
    hash_encode_fused_plain bit for bit: both take the fused encoder's
    rounding chain with the same operations in the same order. At
    uniform, ray-ordered and Morton-ordered (grid refresh) points, with
    points outside [0, 1]^3, NaN and clip ties."""
    spec = HashGridSpec.create(level_dim=C, **_ENCODE_SPECS[spec_name])
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    table = torch.rand(spec.n_params * C, generator=gen,
                       device=cuda_device) * 2 - 1
    B = 8191
    x = _encode_points(kind, B, spec, cuda_device)
    L = spec.num_levels
    for dtype in (torch.float32, torch.bfloat16):
        before = th.hash_encode.launches
        out = th.hash_encode(table, x, spec, compute_dtype=dtype)
        assert th.hash_encode.launches == before + 1
        ref = th.hash_encode_fused_plain(table, x, spec, dtype)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == (B, L * C)
        assert (out[:6] == 0).all()
        if dtype == torch.float32:
            torch.testing.assert_close(out, hash_encode_01(table, x, spec),
                                       rtol=0, atol=1e-6)
        else:
            assert torch.equal(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3, 31, 8191])
@pytest.mark.parametrize("C", [4, 16, 32])
def test_encode_kernels_ragged_batch(cuda_device, B, C):
    """B not a multiple of the point group (ceil(C/4) threads) or of the
    warp: the forward (bf16 bit-exact, f32 at atol 1e-6) and the input
    gradient (rtol 1e-5 of the largest entry) on the mixed spec, every
    point written and none past B."""
    spec = HashGridSpec.create(level_dim=C, **_ENCODE_SPECS["mixed"])
    gen = torch.Generator(device=cuda_device).manual_seed(B)
    table = torch.rand(spec.n_params * C, generator=gen,
                       device=cuda_device) * 2 - 1
    x = torch.rand(B, 3, generator=gen, device=cuda_device)
    L = spec.num_levels
    out = th.hash_encode(table, x, spec, compute_dtype=torch.bfloat16)
    out32 = th.hash_encode(table, x, spec)
    g = torch.randn(B, L * C, generator=gen, device=cuda_device)
    grad = th.encode_input_grad(table, x, g, spec)
    ref_g = th.encode_input_grad_plain(table, x, g, spec)
    torch.cuda.synchronize()
    assert torch.equal(out, th.hash_encode_fused_plain(table, x, spec,
                                                       torch.bfloat16))
    torch.testing.assert_close(out32, hash_encode_01(table, x, spec), rtol=0,
                               atol=1e-6)
    scale = float(ref_g.abs().max())
    torch.testing.assert_close(grad, ref_g, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.gpu
def test_wrappers_refuse_bad_inputs(cuda_device):
    spec = HashGridSpec.create(num_levels=2, level_dim=16,
                               log2_hashmap_size=12, desired_resolution=64)
    table = torch.zeros(spec.n_params * 16, device=cuda_device)
    x = torch.rand(64, 3, device=cuda_device)
    with pytest.raises(TypeError):
        th.hash_encode(table.double(), x, spec)
    with pytest.raises(ValueError):
        th.hash_encode(table, x[:, :2].contiguous(), spec)
    with pytest.raises(ValueError):
        th.hash_encode(table, x.t().contiguous().t(), spec)
    mask = torch.ones(4, 64, dtype=torch.bool, device=cuda_device)
    miss = torch.zeros(4, 1, dtype=torch.bool, device=cuda_device)
    ts_ = torch.zeros(4, 64, device=cuda_device)
    with pytest.raises(TypeError):
        tc.decimate_compact(mask, miss, ts_.double(), ts_, 128)
    with pytest.raises(ValueError):      # miss is one flag a ray
        tc.decimate_compact(mask, miss[:2], ts_, ts_, 128)
    with pytest.raises(ValueError):
        tc.decimate_compact(mask, miss, ts_.t().contiguous().t(), ts_, 128)
    with pytest.raises(ValueError, match="2\\^31"):   # N * K >= 2^31
        big = (1 << 16, 1 << 15)
        tc.decimate_compact(mask[:1, :1].expand(*big), miss[:1].expand(
            big[0], 1), ts_[:1, :1].expand(*big), ts_[:1, :1].expand(*big),
            128)
    keys = torch.zeros(16, dtype=torch.int32, device=cuda_device)
    g = torch.zeros(4, 32, device=cuda_device)
    with pytest.raises(ValueError):      # out is [n_rows, 2C], not flat
        ts.segment_grad_outer(keys, keys, keys, g, 8, 16,
                              out=torch.empty(8, 32, device=cuda_device))
    with pytest.raises(TypeError):
        ts.segment_grad_outer(keys, keys.long(), keys, g, 8, 16)
    with pytest.raises(TypeError):       # B2 reads g in place, not words
        ts.segment_grad_outer(keys, keys, keys, g.int(), 8, 16)
    with pytest.raises(ValueError):      # a channel pair is one load
        ts.segment_totals_outer(keys, keys, keys, g, 8, 8, g_col=3)
    with pytest.raises(ValueError):      # the level's channels past g
        ts.segment_grad_outer(keys, keys, keys, g, 8, 16, g_col=24)


@pytest.mark.gpu
def test_render_kernel_path_matches_plain(cuda_device):
    """A miniature of the flagship render (f32) through both kernels
    against the same render on the plain path, on the card."""
    from dataclasses import replace

    from raw_ngp_torch import Config
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.models.ngp import init_field, make_field_spec
    from raw_ngp_torch.ops.grid import packbits
    from raw_ngp_torch.render.eval import render_image, scene_aabb

    cfg = Config().with_preset_O().with_tpu_profile()
    cfg = replace(cfg, model=replace(cfg.model, log2_hashmap_size=12,
                                     hashgrid_resolution=64))
    cfg = replace(cfg, render=replace(cfg.render, grid_size=32,
                                      max_ray_batch=1024),
                  train=replace(cfg.train, fp16=False, num_rays=512))
    field = init_field(make_field_spec(cfg), seed=0, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    bits = packbits(torch.rand(cfg.cascades, 32 ** 3, generator=gen,
                               device=cuda_device), 0.8)
    _, val = make_synthetic_scene(n_train=2, n_val=1, H=32, W=32)
    aabb = scene_aabb(cfg, val.pts_aabb, device=cuda_device)
    before = (tc.decimate_compact.launches, th.hash_encode.launches)
    rgb, depth = render_image(field, bits, val.poses[0], val.intrinsics, 48,
                              48, aabb, device=cuda_device)
    assert tc.decimate_compact.launches - before[0] == 3
    assert th.hash_encode.launches - before[1] == 3
    rgb_p, depth_p = render_image(field, bits, val.poses[0], val.intrinsics,
                                  48, 48, aabb, device=cuda_device,
                                  plain=True)
    torch.cuda.synchronize()
    assert torch.isfinite(rgb).all() and (depth > 0).any()
    torch.testing.assert_close(rgb, rgb_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(depth, depth_p, rtol=0, atol=1e-5)


def _flagship_grid():
    """The flagship's grid: 2 levels x 16 channels, additive hash, log2 19,
    resolutions 16 and 4096 (Config().with_preset_O().with_tpu_profile())."""
    from raw_ngp_torch import Config
    from raw_ngp_torch.models.ngp import make_field_spec
    return make_field_spec(Config().with_preset_O().with_tpu_profile()
                           ).grid_spec


def _outer_stream(device, M, B, n_rows, C, skew=False, seed=0,
                  dtype=torch.float32, width=None):
    """A sorted outer stream and the cotangent g [B, width] (default C
    columns) B2 reads in place: (keys, perm, w_word, g)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    keys = torch.randint(0, n_rows, (M,), generator=gen, device=device,
                         dtype=torch.int32)
    if skew:                          # most records funnel into one row
        keys = torch.where(torch.rand(M, generator=gen, device=device) < 0.9,
                           7, keys).to(torch.int32)
    keys_s, perm = torch.sort(keys, stable=True)
    w = torch.rand(2, M, generator=gen, device=device)
    w_word = ts.pack_bf16_pairs([w[0], w[1]])[0]
    g = torch.randn(B, width or C, generator=gen, device=device).to(dtype)
    return keys_s, perm.to(torch.int32), w_word, g


def _packed(args, g_col=0):
    """The plain version's arguments for a kernel call's: g's level
    channels as B2's payload words (g_words_plain), JAX's interface."""
    keys, perm, w_word, g, n_rows, C = args
    return keys, perm, w_word, ts.g_words_plain(g, g_col, C), n_rows, C


@pytest.mark.gpu
@pytest.mark.parametrize("skew", [False, True])
def test_segsum_kernel_matches_plain_at_flagship_shape(cuda_device, skew):
    """B2 at the flagship's level-1 shape (1,048,576 records of 262,144
    points into 524,288 rows, C = 16) against its plain version: the same
    bf16 products, summed in another f32 order. rtol 1e-5 on random keys;
    on the skew stream the ~940k-term row (over 7,000 chunks) sums in
    another order than index_add_'s and its signed terms cancel to a
    total some 1e5 times smaller than their absolute sum, so there the
    bound is the error of two f32 sums: rtol 1e-5 plus 2^-20 of the row's
    absolute sum (:func:`_within_sum_error`). Rows without records are
    exactly 0, and two calls give the same bits (the kernel's sum order is
    fixed: no float atomics)."""
    M, B, n_rows, C = 1 << 20, 1 << 18, 1 << 19, 16
    args = _outer_stream(cuda_device, M, B, n_rows, C, skew=skew) \
        + (n_rows, C)
    keys_s, perm, w_word, g_words = _packed(args)[:4]
    before = ts.segment_totals_outer.launches
    out = ts.segment_totals_outer(*args)
    assert ts.segment_totals_outer.launches == before + 1
    again = ts.segment_totals_outer(*args)
    ref = ts.segment_totals_outer_plain(keys_s, perm, w_word, g_words,
                                        n_rows, C)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    empty = torch.ones(n_rows, dtype=torch.bool, device=cuda_device)
    empty[keys_s.long()] = False
    assert empty.any() and (out[empty] == 0).all()
    if skew:
        mass = torch.zeros_like(ref).index_add_(
            0, keys_s.long(),
            ts._outer_products(perm, w_word, g_words, C).abs())
        assert _within_sum_error(out, ref, mass, 1e-5)
    else:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def _within_sum_error(out, ref, mass, rtol):
    """|out - ref| <= rtol |ref| + 1e-5 + 2^-20 mass: two f32 sums of the
    same terms in different orders differ by at most a few units of
    rounding of the partial sums, i.e. a small multiple of 2^-24 times the
    terms' absolute sum ``mass``; 2^-20 leaves a factor 16."""
    return bool(((out - ref).abs()
                 <= rtol * ref.abs() + 1e-5 + 2.0 ** -20 * mass).all())


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 2, 4, 8, 32])
def test_segsum_kernel_channel_widths(cuda_device, C):
    """Every channel width the kernel takes (two channels a lane at C=32,
    idle lanes below C=16), on a small stream."""
    args = _outer_stream(cuda_device, 50000, 9000, 4000, C, seed=C) \
        + (4000, C)
    out = ts.segment_totals_outer(*args)
    ref = ts.segment_totals_outer_plain(*_packed(args))
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def _record_points(B, seed):
    """B uniform points, the first 64 outside [0, 1]^3 and the next 8 with
    a NaN (as many as B holds)."""
    rng = np.random.default_rng(seed)
    x = rng.random((B, 3)).astype(np.float32)
    x[:64] = x[:64] * 3.0 - 1.0
    x[64:72, 1] = np.nan
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("variant,mm", [("additive", "auto"),
                                        ("additive", "0"), ("xor", "auto")])
def test_window_records_kernel_bit_exact(cuda_device, monkeypatch, variant,
                                         mm):
    """The backward's records (base, packed w0/w1), written by the encode
    forward's records mode (hash_encode_records, one counted launch),
    equal window_records_plain bit for bit, and its output equals the
    forward without records bit for bit: f32 and bf16, every channel
    width, 64 points outside [0, 1]^3 and 8 NaN points, ragged B (one
    point, a warp less one, a group less one) and B = 0, on grids with two
    or more window levels (additive: pairable levels on every pair axis;
    xor: hashed one-corner levels); two calls give the same bits."""
    monkeypatch.setenv("RAW_NGP_MM_LEVELS", mm)
    for C in (1, 2, 4, 8, 16, 32):
        spec = HashGridSpec.create(num_levels=4, level_dim=C,
                                   log2_hashmap_size=14,
                                   desired_resolution=512,
                                   hash_variant=variant)
        assert len(th.level_windows(spec, th.matmul_split(spec))) >= 2
        gen = torch.Generator(device=cuda_device).manual_seed(C)
        table = torch.rand(spec.n_params * C, generator=gen,
                           device=cuda_device) * 2 - 1
        for B in (65536, 8191, 31, 1, 0):
            x = torch.from_numpy(_record_points(B, B + C)).to(cuda_device)
            base_p, w_word_p = th.window_records_plain(x, spec)
            for dtype in (torch.float32, torch.bfloat16):
                counts = (th.hash_encode_records.launches,
                          th.hash_encode.launches)
                out, base, w_word = th.hash_encode_records(table, x, spec,
                                                           dtype)
                again = th.hash_encode_records(table, x, spec, dtype)
                assert (th.hash_encode_records.launches - counts[0],
                        th.hash_encode.launches - counts[1]) == (
                            (2, 0) if B else (0, 0))
                plain_out = th.hash_encode(table, x, spec, dtype)
                torch.cuda.synchronize()
                assert base.shape == base_p.shape == w_word.shape
                assert torch.equal(base, base_p), (C, B, dtype)
                assert torch.equal(w_word, w_word_p), (C, B, dtype)
                assert torch.equal(out.view(torch.uint8).reshape(-1),
                                   plain_out.view(torch.uint8).reshape(-1))
                for a, b in zip((out, base, w_word), again):
                    assert torch.equal(a.view(torch.uint8).reshape(-1),
                                       b.view(torch.uint8).reshape(-1))


def _dense_totals(x, g, spec, bf16, lv=0):
    """Dense level ``lv``'s unrounded f32 totals and the absolute sum of
    their terms (its ``mass``), from the plain version's operands: the
    exact products rnd(wyz) * rnd(g * rnd(wx)) (no rnd in f32)."""
    res, C = spec.resolutions[lv], spec.level_dim
    rnd = ts.round_bf16 if bf16 else (lambda t: t)
    wyz, wx_p = th.mm_axis_weights(x, spec, lv)
    gx = rnd(rnd(g[:, lv * C:(lv + 1) * C].float()).repeat(1, res)
             * rnd(wx_p))
    wyz = rnd(wyz).T
    n = (spec.offsets[lv + 1] - spec.offsets[lv] - res ** 3) * C
    pad = gx.new_zeros(n)
    return (torch.cat([(wyz @ gx).reshape(-1), pad]),
            torch.cat([(wyz @ gx.abs()).reshape(-1), pad]))


def _dense_rows_agree(out, x, g, spec, bf16, lv=0):
    """The dense-row rule for level ``lv``'s slice ``out``: the kernel's
    totals before rounding lie within rtol 1e-5 plus 2^-20 of the entry's
    absolute mass of the plain f32 totals (the f32 sum order: cells in
    sorted order, partials in chunk order, corners in order), so in f32
    |out - total| is within that bound and under bf16 out lies between
    the bf16 roundings of the bound's two ends (equal to the plain
    version's output or one bf16 ulp from it)."""
    tot, mass = _dense_totals(x, g, spec, bf16, lv)
    err = 1e-5 * tot.abs() + 2.0 ** -20 * mass
    if not bf16:
        return bool(((out - tot).abs() <= err).all())
    lo, hi = ts.round_bf16(tot - err), ts.round_bf16(tot + err)
    return bool(((out >= lo) & (out <= hi)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encode_backward_kernel_path_matches_plain(cuda_device, dtype):
    """The table gradient at B = 262,144 on the flagship grid, kernel path
    (dense-level kernels, record kernel, packing, torch.sort, B2's flat
    mode) against the plain path (transposed matmul, plain records,
    index_add_): the dense rows by :func:`_dense_rows_agree`; the window
    rows are the same records and products, f32 totals in another order:
    rtol 1e-5 and atol 1e-6 of the largest entry."""
    spec = _flagship_grid()
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    table = (torch.rand(spec.n_params * spec.level_dim, generator=gen,
                        device=cuda_device) * 2 - 1) * 1e-2
    x = torch.rand(262144, 3, generator=gen, device=cuda_device)
    cot = torch.randn(262144, spec.output_dim, generator=gen,
                      device=cuda_device)
    counters = (th.hash_encode_records, ts.segment_grad_outer,
                th.mm_grad_table, ts.segment_totals_outer, th.hash_encode)
    counts = [c.launches for c in counters]
    grads = []
    for fn in (th.hash_encode, th.hash_encode_plain):
        p = table.clone().requires_grad_()
        (fn(p, x, spec, compute_dtype=dtype).float() * cot).sum().backward()
        grads.append(p.grad)
    # the forward writes the records in its one launch; B2's flat mode
    # reads g in place and writes the window rows: no 2C totals
    assert [c.launches for c in counters] == [n + d for n, d in zip(
        counts, (1, 1, 1, 0, 0))]
    torch.cuda.synchronize()
    n_dense = spec.offsets[th.matmul_split(spec)] * spec.level_dim
    assert n_dense > 0
    assert _dense_rows_agree(grads[0][:n_dense], x, cot.to(dtype), spec,
                             dtype == torch.bfloat16)
    scale = float(grads[1].abs().max())
    assert scale > 0
    torch.testing.assert_close(grads[0][n_dense:], grads[1][n_dense:],
                               rtol=1e-5, atol=1e-6 * scale)


def _ray_points(B, gen, device, per_ray=32):
    """B points in ray order, as the compaction leaves them: B / per_ray
    rays from random points in [0.1, 0.9]^3 in random directions, samples
    0.004 apart (32 samples span 2-4 cells of the res-16 level)."""
    n = B // per_ray
    o = torch.rand(n, 3, generator=gen, device=device) * 0.8 + 0.1
    d = torch.randn(n, 3, generator=gen, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    t = torch.arange(per_ray, device=device) * 0.004
    return (o[:, None] + t[None, :, None] * d[:, None]).reshape(-1, 3) \
        .clamp(0.0, 1.0).contiguous()


def _dense_inputs(kind, B, gen, device):
    if kind == "uniform":
        return torch.rand(B, 3, generator=gen, device=device)
    if kind == "ray":
        return _ray_points(B, gen, device)
    if kind == "skew":                       # every point in one cell
        return (7.5 + torch.rand(B, 3, generator=gen, device=device)) / 16
    x = torch.rand(B, 3, generator=gen, device=device)   # "edges"
    x[: B // 4, 0] = 1.0 - torch.rand(B // 4, generator=gen,
                                      device=device) / 32   # clamped corner
    x[B // 4: B // 2] = torch.rand(B // 2 - B // 4, 3, generator=gen,
                                   device=device) / 32       # near 0
    x[B // 2: B // 2 + 64] = x[B // 2: B // 2 + 64] * 3.0 - 1.0
    x[B // 2 + 64: B // 2 + 72, 1] = float("nan")
    x[-2], x[-1] = 0.0, 1.0
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["uniform", "ray", "skew", "edges"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mm_grad_table_kernel_matches_plain(cuda_device, kind, dtype):
    """The dense level's table gradient at B = 262,144 on the flagship
    grid, kernel against mm_grad_table_plain, with uniform points,
    ray-ordered points, every point in one cell, and clamped corners,
    points near 0, outside [0, 1]^3 and NaN: the dense-row rule
    (:func:`_dense_rows_agree`); rows past res^3 are exactly 0 and the
    kernel launches once. Two calls give the same bits, and so does a
    third made after other work on the stream (the plain version, a B2
    call): the sum order is fixed, no float atomics."""
    spec = _flagship_grid()
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    B = 262144
    x = _dense_inputs(kind, B, gen, cuda_device)
    g = torch.randn(B, spec.output_dim, generator=gen,
                    device=cuda_device).to(dtype)
    before = th.mm_grad_table.launches
    out = th.mm_grad_table(x, g, spec, dtype)
    assert th.mm_grad_table.launches == before + 1
    again = th.mm_grad_table(x, g, spec, dtype)
    ref = th.mm_grad_table_plain(x, g, spec, dtype)
    ts.segment_totals_outer(*_outer_stream(cuda_device, 1 << 16, 4096, 1000,
                                           16, skew=True), 1000, 16)
    third = th.mm_grad_table(x, g, spec, dtype)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    assert torch.equal(out.view(torch.int32), third.view(torch.int32))
    res, C = spec.resolutions[0], spec.level_dim
    assert out.shape == ref.shape and (out[res ** 3 * C:] == 0).all()
    assert _dense_rows_agree(out, x, g, spec, dtype == torch.bfloat16)
    assert float((out - ref).abs().max()) <= 2.0 ** -7 * float(
        ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3, 127, 129, 8191])
@pytest.mark.parametrize("C", [1, 4, 16, 32])
def test_mm_grad_table_kernel_ragged_batch(cuda_device, B, C):
    """The dense-level kernels (mm_grad_level) at level 0 of a grid with C
    channels (res 15, dense, one row past res^3), B not a multiple of the
    128-point chunk or of the warp, f32 and bf16: the dense-row rule against
    mm_grad_level_plain, rows past res^3 exactly 0, two calls bitwise
    equal, one counted launch each."""
    spec = HashGridSpec.create(num_levels=2, level_dim=C, base_resolution=15,
                               log2_hashmap_size=13, desired_resolution=64)
    res, hmap = spec.resolutions[0], spec.offsets[1] - spec.offsets[0]
    assert res == 15 and hmap > res ** 3
    gen = torch.Generator(device=cuda_device).manual_seed(B * 64 + C)
    x = _dense_inputs("edges" if B >= 129 else "uniform", B, gen,
                      cuda_device)
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.randn(B, spec.output_dim, generator=gen,
                        device=cuda_device).to(dtype)
        before = th.mm_grad_table.launches
        out = th.mm_grad_level(x, g, spec, 0, dtype)
        again = th.mm_grad_level(x, g, spec, 0, dtype)
        assert th.mm_grad_table.launches == before + 2
        ref = th.mm_grad_level_plain(x, g, spec, 0, dtype)
        torch.cuda.synchronize()
        assert out.shape == ref.shape == (hmap * C,)
        assert torch.equal(out.view(torch.int32), again.view(torch.int32))
        assert (out[res ** 3 * C:] == 0).all()
        assert _dense_rows_agree(out, x, g, spec, dtype == torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mm_grad_table_kernel_two_dense_levels(cuda_device, dtype):
    """A grid with two dense matmul levels (the mixed spec at C = 8: res 16
    and 24): one counted launch a level, each level's slice by the
    dense-row rule against mm_grad_table_plain, two calls bitwise equal."""
    spec = HashGridSpec.create(level_dim=8, **_ENCODE_SPECS["mixed"])
    assert th.matmul_split(spec) == 2
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    B = 65536
    x = _dense_inputs("edges", B, gen, cuda_device)
    g = torch.randn(B, spec.output_dim, generator=gen,
                    device=cuda_device).to(dtype)
    before = th.mm_grad_table.launches
    out = th.mm_grad_table(x, g, spec, dtype)
    again = th.mm_grad_table(x, g, spec, dtype)
    assert th.mm_grad_table.launches == before + 4
    ref = th.mm_grad_table_plain(x, g, spec, dtype)
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    C = spec.level_dim
    for lv in range(2):
        part = out[spec.offsets[lv] * C:spec.offsets[lv + 1] * C]
        assert _dense_rows_agree(part, x, g, spec, dtype == torch.bfloat16,
                                 lv)


@pytest.mark.gpu
def test_segsum_kernels_row_over_three_chunk_edges(cuda_device):
    """A stream whose one long row holds 385 records (three full 128-record
    chunks and one more: its partials cross three chunk edges), behind a
    few short rows and before others, in both of B2's modes: within rtol
    1e-5 of the plain versions and two calls bitwise equal."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    keys = torch.cat([torch.arange(0, 5), torch.full((385,), 5),
                      torch.arange(6, 200)]).to(torch.int32).to(cuda_device)
    M, B, n_rows, C = keys.numel(), 300, 256, 16
    perm = torch.randperm(M, generator=gen, device=cuda_device)
    w = torch.rand(2, M, generator=gen, device=cuda_device)
    w_word = ts.pack_bf16_pairs([w[0], w[1]])[0]
    g = torch.randn(B, C, generator=gen, device=cuda_device)
    args = (keys, perm.to(torch.int32), w_word, g, n_rows, C)
    out, again = (ts.segment_totals_outer(*args) for _ in range(2))
    ref = ts.segment_totals_outer_plain(*_packed(args))
    vals = torch.randn(32, M, generator=gen, device=cuda_device)
    packed = torch.stack(ts.pack_bf16_pairs(list(vals))).contiguous()
    ch, ch2 = (ts.segment_totals(keys, packed, n_rows, 32) for _ in range(2))
    ch_ref = ts.segment_totals_plain(keys, packed, n_rows, 32)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    assert torch.equal(ch.view(torch.int32), ch2.view(torch.int32))
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ch, ch_ref, rtol=1e-5, atol=1e-5)


def _runs(*runs):
    """Sorted keys from (key, count) runs."""
    return torch.cat([torch.full((n,), k, dtype=torch.int32)
                      for k, n in runs])


# streams whose rows meet the 128-record chunk edges in every way the flat
# mode's pairs, slots and join must handle: (keys, n_rows)
_FLAT_STREAMS = {
    # one row over three chunk edges, short rows around it
    "three_edges": (torch.cat([torch.arange(0, 5), torch.full((385,), 5),
                               torch.arange(6, 200)]).to(torch.int32), 256),
    # rows 100 and 101 both cross edges, 101 starting where 100 ends
    "adjacent_crossing": (torch.cat([torch.arange(0, 100).to(torch.int32),
                                     _runs((100, 200), (101, 300)),
                                     torch.arange(102, 150).to(torch.int32)]),
                          160),
    # row 28 ends exactly on the edge at 256, row 29 fills chunk 2 alone
    # and crosses, row 31 ends on the edge at 640
    "row_ends_on_edge": (torch.cat([torch.arange(0, 28).to(torch.int32),
                                    _runs((28, 228), (29, 200), (31, 184),
                                          (33, 5))]), 64),
    # chunk 1 holds only the end of row 3 and the start of row 4; chunk 4
    # the end of row 9, row 10 and the start of row 12
    "ends_and_starts": (_runs((3, 200), (4, 200), (9, 200), (10, 3),
                              (12, 130), (13, 1)), 20),
    # gaps of three rows at every edge (64-record rows), then rows that
    # fill chunks exactly (128 records) with gaps of two
    "gaps_at_edges": (torch.cat([
        torch.arange(0, 96, 3).repeat_interleave(64),
        torch.arange(100, 140, 2).repeat_interleave(128)]).to(torch.int32),
        150),
    # rows 0 and n_rows - 1 cross chunks
    "first_and_last_rows": (_runs((0, 300), (1, 3), (5, 140), (63, 260)),
                            64),
    # keys below 0 and from n_rows up are dropped, as in the 2C mode
    "out_of_range": (_runs((-3, 150), (-1, 2), (0, 3), (2, 130), (9, 40),
                           (10, 200), (12, 7)), 10),
}


def _flat_case(device, keys, n_rows, C, B=300, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    M = keys.numel()
    perm = torch.randperm(M, generator=gen, device=device).to(torch.int32)
    w = torch.rand(2, M, generator=gen, device=device)
    g = torch.randn(B, C, generator=gen, device=device)
    return (keys.to(device), perm, ts.pack_bf16_pairs([w[0], w[1]])[0], g,
            n_rows, C)


def _assert_flat_bits(args, g_col=0):
    """segment_grad_outer (B2's flat mode) against the 2C totals then
    combine_totals_plain (the same f32 sums, then one f32 add a row), both
    reading g's channels from column g_col in place: the same bits, two
    calls the same bits, one counted launch a call."""
    n_rows, C = args[4], args[5]
    before = ts.segment_grad_outer.launches
    flat = ts.segment_grad_outer(*args, g_col=g_col)
    again = ts.segment_grad_outer(*args, g_col=g_col)
    assert ts.segment_grad_outer.launches == before + 2
    ref = ts.combine_totals_plain(ts.segment_totals_outer(*args, g_col=g_col),
                                  torch.empty(n_rows * C, device=flat.device))
    torch.cuda.synchronize()
    assert torch.equal(flat.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(flat.view(torch.int32), again.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("stream", sorted(_FLAT_STREAMS))
def test_segsum_flat_mode_bit_exact_at_chunk_edges(cuda_device, stream, C):
    """B2's flat mode on streams built around the chunk edges (crossing
    rows side by side, rows ending on an edge, chunks holding only a row's
    end and the next one's start, gaps at edges, the first and last rows,
    out-of-range keys), every channel width: bit for bit the 2C mode plus
    combine_totals_plain."""
    keys, n_rows = _FLAT_STREAMS[stream]
    _assert_flat_bits(_flat_case(cuda_device, keys, n_rows, C, seed=C))


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("M", [1, 127, 128, 129, 8191])
def test_segsum_flat_mode_bit_exact_ragged(cuda_device, M, C):
    """B2's flat mode on random keys at ragged stream lengths (one record,
    one chunk less one, one chunk, one more, 64 chunks less one) and every
    channel width: bit for bit the 2C mode plus combine_totals_plain;
    called into a slice of a larger tensor it writes that slice only."""
    gen = torch.Generator().manual_seed(M + C)
    n_rows = max(M // 3, 2)
    keys = torch.sort(torch.randint(0, n_rows, (M,), generator=gen,
                                    dtype=torch.int32)).values
    args = _flat_case(cuda_device, keys, n_rows, C, seed=M)
    _assert_flat_bits(args)
    big = torch.full((n_rows * C + 2 * C,), 7.0, device=cuda_device)
    ts.segment_grad_outer(*args, out=big[C:C + n_rows * C])
    torch.cuda.synchronize()
    assert (big[:C] == 7.0).all() and (big[-C:] == 7.0).all()
    assert torch.equal(big[C:C + n_rows * C],
                       ts.segment_grad_outer(*args))


def _walk_stream(case, C):
    """Keys that meet the layout of the flat mode's walk below 32 channels
    (csrc/segsum.cu segsum_flat_walk_kernel: a warp owns G = 32 / C
    consecutive 128-record chunks, a group of C lanes each) -> (keys,
    n_rows)."""
    K, G = 128, 32 // C
    if case == "group_to_group":
        # rows crossing from lane group 0's chunk into group 1's, and from
        # group 1's over group 2's whole chunk into group 3's (G >= 2)
        return _runs((0, K - 5), (1, 10), (2, K), (3, 3 * K // 2),
                     (4, 7)), 8
    if case == "warp_to_warp":
        # a row out of the warp's last chunk into the next warp's first
        return torch.cat([torch.arange(0, G * K - 9),
                          torch.full((20,), G * K),
                          torch.arange(G * K + 1, G * K + 40)]).to(
                              torch.int32), G * K + 64
    if case == "ragged_warp":
        # the last warp holds fewer chunks than lane groups, its last chunk
        # short: G + 3 chunks and 17 records in all
        gen = torch.Generator().manual_seed(C)
        return torch.sort(torch.randint(0, 500, ((G + 3) * K + 17,),
                                        generator=gen,
                                        dtype=torch.int32)).values, 500
    # a row over more than kGroup = 32 chunks, with the aligned group of
    # chunks 32-63 inside it (its group sum feeds the row's total)
    return _runs((0, 3), (2, 66 * K), (3, 2), (5, 2 * K)), 8


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["group_to_group", "warp_to_warp",
                                  "ragged_warp", "row_over_groups"])
def test_segsum_flat_walk_layout_bit_exact(cuda_device, case, C):
    """The flat mode's walk below 32 channels, several chunks a warp and
    lanes over chunks and channels, on streams built around that layout:
    rows that cross from one lane group's chunk into the next group's in
    the same warp, out of a warp's last chunk into the next warp, a warp
    with fewer chunks left than lane groups, a row over more than kGroup
    chunks; bf16 g read in place at an odd level's columns and f32 g: bit
    for bit the 2C mode (the one-chunk-a-warp walk) plus
    combine_totals_plain, two calls the same bits."""
    keys, n_rows = _walk_stream(case, C)
    if case == "row_over_groups":
        # group 1 (records 4096-8191) lies inside the row: its group sum
        # fires (segments.cuh group_sum)
        assert keys[32 * 128 - 1] == keys[64 * 128] == 2
    args = _flat_case(cuda_device, keys, n_rows, C, seed=C + len(case))
    _assert_flat_bits(args)
    g = torch.randn(300, 4 * C, generator=torch.Generator(
        device=cuda_device).manual_seed(C), device=cuda_device)
    _assert_flat_bits(args[:3] + (g.to(torch.bfloat16),) + args[4:],
                      g_col=2 * C if C > 1 else 3)
    _assert_flat_bits(args[:3] + (g,) + args[4:], g_col=C)


@pytest.mark.gpu
@pytest.mark.parametrize("skew", [False, True])
def test_segsum_flat_mode_bit_exact_at_flagship_shape(cuda_device, skew):
    """B2's flat mode at the flagship's level-1 shape (1,048,576 records
    of 262,144 points into 524,288 rows, C = 16), reading level 1's
    channels of a bf16 cotangent [B, 32] in place as the table gradient
    does, random keys and the skew stream (a ~940k-record row over some
    7,300 chunks): bit for bit the 2C mode plus combine_totals_plain, two
    calls the same bits, and within rtol 1e-5 of the plain version on the
    packed words (within the f32 sum bound on the skew stream); the
    zero-length stream leaves the zero fill only."""
    M, B, n_rows, C = 1 << 20, 1 << 18, 1 << 19, 16
    args = _outer_stream(cuda_device, M, B, n_rows, C, skew=skew,
                         dtype=torch.bfloat16, width=2 * C) + (n_rows, C)
    _assert_flat_bits(args, g_col=C)
    flat = ts.segment_grad_outer(*args, g_col=C)
    plain = _packed(args, g_col=C)
    ref = ts.segment_grad_outer_plain(*plain)
    prods = ts._outer_products(plain[1], plain[2], plain[3], C).abs()
    keys = plain[0].long()
    mass = torch.zeros(n_rows, 2 * C, device=cuda_device).index_add_(
        0, keys, prods)
    mass = mass[:, :C] + torch.cat([mass.new_zeros(1, C), mass[:-1, C:]])
    torch.cuda.synchronize()
    if skew:
        assert _within_sum_error(flat, ref, mass.reshape(-1), 1e-5)
    else:
        torch.testing.assert_close(flat, ref, rtol=1e-5, atol=1e-5)
    empty = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    _, _, w_word, g = _outer_stream(cuda_device, 64, 64, 64, C)
    out = ts.segment_grad_outer(empty, empty, w_word, g, 64, C)
    assert out.shape == (64 * C,) and not out.any()


def _unique_stream(device, M, seed):
    """M sorted keys whose rows hold one record each (3M rows), a random
    permutation and (w0, w1) words: every total is one bf16 product, exact
    in any sum order, so the kernel must give the plain version's bits ->
    (keys, perm, w_word, n_rows)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n_rows = 3 * M
    keys = torch.sort(torch.randperm(n_rows, generator=gen, device=device)[:M]
                      ).values.to(torch.int32)
    perm = torch.randperm(M, generator=gen, device=device).to(torch.int32)
    w = torch.rand(2, M, generator=gen, device=device)
    return keys, perm, ts.pack_bf16_pairs([w[0], w[1]])[0], n_rows


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_table_grad_glue_kernels_bit_exact(cuda_device, C, dtype):
    """The packing of g into B2's payload words, which B2 now forms as it
    reads g [B, L*C] in place, against pack_g_words_plain (the words JAX
    packs: the truncation of f32 g, the swapped halves of bf16 g, a zero
    low half at C = 1), in both of B2's forms, one counted launch a call.
    At every window level's column (the columns table_grad passes; odd
    ones at C = 1), on a stream whose rows hold one record each (every
    total one bf16 product, exact in any sum order): bit for bit the
    plain version on that level's packed words, two calls the same bits.
    On random keys at the last level's column: the flat form bit for bit
    the 2C totals plus combine_totals_plain, the totals within rtol 1e-5
    of the plain version."""
    spec = HashGridSpec.create(num_levels=4, level_dim=C,
                               log2_hashmap_size=14, desired_resolution=512)
    B = 5000
    gen = torch.Generator(device=cuda_device).manual_seed(C)
    g = torch.randn(B, spec.output_dim, generator=gen,
                    device=cuda_device).to(dtype)
    words = th.pack_g_words_plain(g, spec)
    windows = th.level_windows(spec, th.matmul_split(spec))
    assert len(windows) >= 2
    for i, (lv, _, _) in enumerate(windows):
        keys, perm, w_word, n_rows = _unique_stream(cuda_device, 4 * B,
                                                    seed=C + lv)
        args = (keys, perm, w_word, g, n_rows, C)
        for fn, ref in ((ts.segment_totals_outer,
                         ts.segment_totals_outer_plain),
                        (ts.segment_grad_outer, ts.segment_grad_outer_plain)):
            count = fn.launches
            out = fn(*args, g_col=lv * C)
            again = fn(*args, g_col=lv * C)
            assert fn.launches == count + 2
            want = ref(*args[:3], words[i], *args[4:])
            torch.cuda.synchronize()
            assert torch.equal(out.view(torch.int32), want.view(torch.int32))
            assert torch.equal(out.view(torch.int32),
                               again.view(torch.int32))
    keys, perm, w_word, _ = _outer_stream(cuda_device, 20000, B, 3000, C,
                                          seed=C)
    args = (keys, perm, w_word, g, 3000, C)
    _assert_flat_bits(args, g_col=lv * C)
    out = ts.segment_totals_outer(*args, g_col=lv * C)
    ref = ts.segment_totals_outer_plain(*args[:3], words[-1], 3000, C)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["uniform", "ray"])
@pytest.mark.parametrize("spec_name", sorted(_ENCODE_SPECS))
@pytest.mark.parametrize("C", [1, 2, 8, 16, 32])
def test_encode_input_grad_kernel_matches_plain(cuda_device, spec_name, kind,
                                                C):
    """The encode's input gradient, kernel against plain version, f32 and
    bf16, at uniform and ray-ordered points with points outside [0, 1]^3,
    NaN and clip ties: the same expressions in the same order on both
    sides (the cross-channel sums as a chain in channel order); rtol 1e-5
    of the largest entry (as the f32 sums of the table gradient), exactly
    0 outside [0, 1]^3 and on NaN, and two calls bitwise equal."""
    spec = HashGridSpec.create(level_dim=C, **_ENCODE_SPECS[spec_name])
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    table = torch.rand(spec.n_params * C, generator=gen,
                       device=cuda_device) * 2 - 1
    B, L = 8191, spec.num_levels
    x = _encode_points(kind, B, spec, cuda_device)
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.randn(B, L * C, generator=gen,
                        device=cuda_device).to(dtype)
        before = th.encode_input_grad.launches
        out = th.encode_input_grad(table, x, g, spec, dtype)
        again = th.encode_input_grad(table, x, g, spec, dtype)
        assert th.encode_input_grad.launches == before + 2
        ref = th.encode_input_grad_plain(table, x, g, spec, dtype)
        torch.cuda.synchronize()
        assert (out[:6] == 0).all()
        assert torch.equal(out.view(torch.int32), again.view(torch.int32))
        scale = float(ref.abs().max())
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encode_input_grad_kernel_at_flagship_shape(cuda_device, dtype):
    """B = 262,144 points on the flagship grid (the dense matmul level and
    the additive-hash level), through the encode's autograd: the kernel
    launches once and agrees with the plain version within rtol 1e-5 of
    the largest entry."""
    spec = _flagship_grid()
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    table = (torch.rand(spec.n_params * spec.level_dim, generator=gen,
                        device=cuda_device) * 2 - 1) * 1e-2
    x = torch.rand(262144, 3, generator=gen, device=cuda_device)
    cot = torch.randn(262144, spec.output_dim, generator=gen,
                      device=cuda_device)
    xs = x.clone().requires_grad_()
    before = th.encode_input_grad.launches
    (th.hash_encode(table, xs, spec, compute_dtype=dtype).float()
     * cot).sum().backward()
    assert th.encode_input_grad.launches == before + 1
    ref = th.encode_input_grad_plain(table, x, cot.to(dtype), spec, dtype)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    assert scale > 0
    torch.testing.assert_close(xs.grad, ref, rtol=1e-5, atol=1e-5 * scale)


def _jvp_points(kind, B, spec, device):
    """B points of one kind (uniform or ray-ordered) for the JVP: the edge
    cases of _encode_points (outside [0, 1]^3, NaN, 0.0 and 1.0, clip
    ties) where B allows (B = 1 takes one point inside)."""
    x = _encode_points(kind, max(B, 11), spec, device)
    return (x[10:11] if B == 1 else x[:B]).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["uniform", "ray"])
@pytest.mark.parametrize("B", [1, 7, 33, 1000, 262144])
@pytest.mark.parametrize("spec_name", sorted(_ENCODE_SPECS))
@pytest.mark.parametrize("C", [1, 2, 4, 8, 16, 32])
def test_encode_input_jvp_kernel_matches_plain(cuda_device, C, spec_name, B,
                                               kind):
    """The input gradient's JVP in g (encode_input_jvp) against its plain
    version, f32 and bf16, on every grid of _ENCODE_SPECS (the xor, the
    aligned smoothstep, tiled, additive and mixed; dense matmul levels at
    C >= 8) at every channel count, at 1, 7 (points outside [0, 1]^3 and
    NaN), 33 and 1000 (a block's tile left part full) and 262,144
    uniform or ray-ordered points: the same expressions in the same order
    (every product and sum an _rn intrinsic), so bit for bit; 0 outside
    [0, 1]^3 and on NaN; two calls bitwise equal."""
    spec = HashGridSpec.create(level_dim=C, **_ENCODE_SPECS[spec_name])
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    table = (torch.rand(spec.n_params * C, generator=gen,
                        device=cuda_device) * 2 - 1) * 0.1
    x = _jvp_points(kind, B, spec, cuda_device)
    ct = torch.randn(B, 3, generator=gen, device=cuda_device)
    outside = ~((x >= 0) & (x <= 1)).all(-1)
    for dtype in (torch.float32, torch.bfloat16):
        before = th.encode_input_jvp.launches
        out = th.encode_input_jvp(table, x, ct, spec, dtype)
        again = th.encode_input_jvp(table, x, ct, spec, dtype)
        assert th.encode_input_jvp.launches == before + 2
        ref = th.encode_input_jvp_plain(table, x, ct, spec, dtype)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == (B, spec.output_dim)
        assert (out[outside] == 0).all()
        assert _same_bits(out, ref) and _same_bits(out, again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_frozen_input_grad_launches_both_kernels(cuda_device, dtype):
    """frozen_input_grad at the -O grid's shape (16 levels x 2 channels xor
    log2 19, 262,144 points): its forward launches the input gradient
    once and its backward the JVP once, each bit for bit its plain
    version; the table and the points take no gradient."""
    from raw_ngp_torch import Config
    from raw_ngp_torch.models.ngp import make_field_spec
    spec = make_field_spec(Config().with_preset_O()).grid_spec
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    table = (torch.rand(spec.n_params * spec.level_dim, generator=gen,
                        device=cuda_device) * 2 - 1) * 0.1
    x = torch.rand(262144, 3, generator=gen, device=cuda_device)
    g = torch.randn(262144, spec.output_dim, generator=gen,
                    device=cuda_device).to(dtype).requires_grad_()
    ct = torch.randn(262144, 3, generator=gen, device=cuda_device)
    before = (th.encode_input_grad.launches, th.encode_input_jvp.launches)
    out = th.frozen_input_grad(table, x, g, spec, dtype)
    (gg,) = torch.autograd.grad(out, g, ct)
    assert (th.encode_input_grad.launches,
            th.encode_input_jvp.launches) == (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    assert _same_bits(out, th.encode_input_grad_plain(table, x, g.detach(),
                                                      spec, dtype))
    assert _same_bits(gg, th.encode_input_jvp_plain(table, x, ct, spec,
                                                    dtype))


def _channel_stream(device, M, n_rows, n_chan, skew=False, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    keys = torch.randint(0, n_rows, (M,), generator=gen, device=device,
                         dtype=torch.int32)
    if skew:
        keys = torch.where(torch.rand(M, generator=gen, device=device) < 0.9,
                           7, keys).to(torch.int32)
    keys_s, _ = torch.sort(keys)
    vals = torch.randn(n_chan, M, generator=gen, device=device)
    packed = torch.stack(ts.pack_bf16_pairs(list(vals))).contiguous()
    return keys_s.to(torch.int32).contiguous(), packed


@pytest.mark.gpu
@pytest.mark.parametrize("skew", [False, True])
def test_segsum_channel_kernel_at_level1_shape(cuda_device, skew):
    """B2's channel mode at the flagship's level-1 shape (1,048,576 records
    into 524,288 rows, 32 channels) against segment_totals_plain: the same
    bf16 values summed in another f32 order; rtol 1e-5, and on the skew
    stream's cancelling ~940k-term row the bound of the f32 sums
    (rtol 1e-5 plus 2^-20 of the row's absolute sum, as the outer mode).
    Empty rows exactly 0; two calls give the same bits."""
    M, n_rows, n_chan = 1 << 20, 1 << 19, 32
    keys_s, packed = _channel_stream(cuda_device, M, n_rows, n_chan, skew)
    before = ts.segment_totals.launches
    out = ts.segment_totals(keys_s, packed, n_rows, n_chan)
    assert ts.segment_totals.launches == before + 1
    again = ts.segment_totals(keys_s, packed, n_rows, n_chan)
    ref = ts.segment_totals_plain(keys_s, packed, n_rows, n_chan)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    empty = torch.ones(n_rows, dtype=torch.bool, device=cuda_device)
    empty[keys_s.long()] = False
    assert empty.any() and (out[empty] == 0).all()
    if skew:
        vals = torch.stack(ts.unpack_bf16_pairs(list(packed), n_chan), 1)
        mass = torch.zeros_like(ref).index_add_(0, keys_s.long(), vals.abs())
        assert _within_sum_error(out, ref, mass, 1e-5)
    else:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n_chan", [1, 3, 16, 33, 64])
def test_segsum_channel_mode_widths(cuda_device, n_chan):
    """Every channel count the kernel takes (odd counts pad the last word,
    two channels a lane above 32), on a small stream."""
    keys_s, packed = _channel_stream(cuda_device, 50000, 4000, n_chan,
                                     seed=n_chan)
    out = ts.segment_totals(keys_s, packed, 4000, n_chan)
    ref = ts.segment_totals_plain(keys_s, packed, 4000, n_chan)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("M", SORT_SIZES + (1 << 20,))
@pytest.mark.parametrize("bits", SORT_BITS)
@pytest.mark.parametrize("name", SORT_CASES)
def test_radix_sort_is_torch_sort(cuda_device, name, bits, M):
    """The radix sort (csrc/radix_sort.cu) bit for bit torch.sort(keys -
    offset, stable=True) with int32 indices and its plain version, on the
    edge cases (empty, one key, around the 4,096-key tile, all equal,
    descending, long runs, 1 and 31 bits: an odd pass count), two calls
    alike, no key outside the range, one counted launch a call."""
    keys_np, offset = sort_case(name, M, bits)
    keys = torch.from_numpy(keys_np).to(cuda_device)
    ref_k, ref_i = torch.sort(keys - offset, stable=True)
    plain = tsort.sort_keys_plain(keys, bits, offset)
    before = tsort.sort_keys.launches
    runs = [tsort.sort_keys(keys, bits, offset, out_of_range=True)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert tsort.sort_keys.launches == before + (2 if M else 0)
    for got_k, got_p, oor in runs:
        assert _same_bits(got_k, ref_k) and _same_bits(got_k, plain[0])
        assert _same_bits(got_p, ref_i.to(torch.int32))
        assert _same_bits(got_p, plain[1])
        assert int(oor) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("bits", (9, 13, 19))
def test_radix_sort_counts_keys_outside_the_range(cuda_device, bits):
    """Keys outside [0, 2^bits) are counted in the scratch and sorted by
    their low bits, as the plain version does."""
    gen = torch.Generator(device=cuda_device).manual_seed(bits)
    keys = torch.randint(-50, (1 << bits) + 50, (3 * tsort.TILE + 7,),
                         generator=gen, device=cuda_device,
                         dtype=torch.int32)
    got_k, got_p, oor = tsort.sort_keys(keys, bits, out_of_range=True)
    want_k, want_p = tsort.sort_keys_plain(keys, bits)
    assert _same_bits(got_k, want_k) and _same_bits(got_p, want_p)
    assert int(oor) == int(tsort.out_of_range_plain(keys, bits)) > 0


def _dispatch_cfg(kind):
    """A small occupancy (the flagship's miniature, interval 4) or -O2
    configuration, chains of 4 steps."""
    from dataclasses import replace
    import raw_ngp_torch.config as tcfg
    if kind == "occupancy":
        cfg = tcfg.Config().with_preset_O().with_tpu_profile()
        cfg = replace(cfg, render=replace(
            cfg.render, grid_size=32, samples_per_ray=24,
            march_candidates=24, max_ray_batch=4096,
            update_extra_interval=4))
        model = dict(log2_hashmap_size=12, hashgrid_resolution=64)
    else:
        cfg = tcfg.Config().with_preset_O2()
        cfg = replace(cfg, render=replace(cfg.render, num_steps=(32, 16, 8),
                                          max_ray_batch=1024))
        model = dict(num_levels=4, log2_hashmap_size=12,
                     hashgrid_resolution=64, prop_num_levels=3,
                     prop_log2_hashmap_size=10, prop_resolutions=(32, 64))
    cfg = replace(cfg, model=replace(cfg.model, grid_mlp_hidden=16,
                                     view_mlp_hidden=16, **model))
    cfg = replace(cfg, train=replace(cfg.train, iters=64, num_rays=512,
                                     seed=0, steps_per_dispatch=4,
                                     adaptive_num_rays=False))
    return replace(cfg, ckpt="scratch").validate()


def _device_launches(run):
    """{CUDA_KERNELS name: launches} of the hand-written kernels that
    ``run()`` launched on the card, from the profiler's device events
    (graph replays included)."""
    from torch.profiler import ProfilerActivity, profile
    from raw_ngp_torch.kernels import kernel_of
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = kernel_of(e.key)
        if (name is not None
                and e.device_type == torch.autograd.DeviceType.CUDA):
            out[name] = out.get(name, 0) + e.count
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["occupancy", "proposal"])
def test_graphed_chains_equal_eager_steps(cuda_device, tmp_path, kind):
    """Trainer.train(13) at steps_per_dispatch 4 (CUDA-graph replays: one
    capture, chains of 4 cut at the refreshes) leaves the params, EMA,
    moments, grid and generator state of 13 eager Trainer.step calls, bit
    for bit, and launches each hand-written kernel on the card as often
    (the profiler's device events)."""
    from raw_ngp_torch.data import make_synthetic_scene
    from raw_ngp_torch.train.trainer import Trainer
    train, val = make_synthetic_scene(n_train=8, n_val=1, H=32, W=32)
    runs, launches = {}, {}
    for mode in ("eager", "graphed"):
        tr = Trainer(_dispatch_cfg(kind), train, val, device=cuda_device,
                     workspace=str(tmp_path / mode))

        def run():
            if mode == "eager":
                for _ in range(13):
                    tr.step()
            else:
                tr.train(13, log_every=10 ** 9)
        launches[mode] = _device_launches(run)
        if mode == "graphed":
            assert len(tr._graphs.captures) == 1
        st = tr.state
        assert (st.step, st.opt_state.count, int(st.step_t)) == (13, 13, 13)
        out = {f"{name}.{k}": v.detach().clone()
               for name, tensors in (("param", st.params),
                                     ("ema", st.ema_params),
                                     ("mu", st.opt_state.mu),
                                     ("nu", st.opt_state.nu))
               for k, v in tensors.items()}
        out.update({k: v.clone() for k, v in st.grid_state().items()
                    if v is not None})
        out["generator"] = tr.generator.get_state()
        runs[mode] = out
    assert launches["graphed"] == launches["eager"]
    assert launches["eager"].get("hash_encode_kernel", 0) > 0
    differ = sorted(k for k, v in runs["eager"].items()
                    if not _same_bits(runs["graphed"][k], v))
    assert not differ, differ
