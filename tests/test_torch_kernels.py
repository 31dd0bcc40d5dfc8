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
from raw_ngp_torch.ops.hashgrid import HashGridSpec, hash_encode_01


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA only")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("keep_rate", [0.0, 0.03, 0.25, 0.9, 1.0])
def test_compact_kernel_matches_plain(cuda_device, keep_rate):
    """Bit-exact at the render's shape (M = 1,048,576, m_pad = 262,144)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    M, m_pad = 1 << 20, 262144
    mask = torch.rand(M, generator=gen, device=cuda_device) < keep_rate
    attrs = torch.randn(2, M, generator=gen, device=cuda_device)
    c = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
    keys = torch.where(mask & (c <= m_pad), c - 1,
                       tc.SENTINEL).to(torch.int32)
    before = tc.compact_attrs.launches
    pos, att = tc.compact_attrs(attrs, keys, c, m_pad)
    assert tc.compact_attrs.launches == before + 1
    _, _, pos_p = tc.compact_positions(keys < m_pad, m_pad)
    att_p = torch.stack([tc.gather_flat_sorted(a, pos_p) for a in attrs])
    torch.cuda.synchronize()
    assert torch.equal(pos, pos_p)
    assert torch.equal(att.view(torch.int32), att_p.view(torch.int32))


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
    keys = torch.zeros(16, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        tc.compact_attrs(torch.zeros(1, 16, device=cuda_device), keys,
                         keys.long(), 8)


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
    before = (tc.compact_attrs.launches, th.hash_encode.launches)
    rgb, depth = render_image(field, bits, val.poses[0], val.intrinsics, 48,
                              48, aabb, device=cuda_device)
    assert tc.compact_attrs.launches - before[0] == 3
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


def _outer_stream(device, M, B, n_rows, C, skew=False, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    keys = torch.randint(0, n_rows, (M,), generator=gen, device=device,
                         dtype=torch.int32)
    if skew:                          # most records funnel into one row
        keys = torch.where(torch.rand(M, generator=gen, device=device) < 0.9,
                           7, keys).to(torch.int32)
    keys_s, perm = torch.sort(keys, stable=True)
    w = torch.rand(2, M, generator=gen, device=device)
    w_word = ts.pack_bf16_pairs([w[0], w[1]])[0]
    g = torch.randn(B, C, generator=gen, device=device)
    g_words = torch.stack(ts.pack_bf16_pairs(list(g.T)), dim=1).contiguous()
    return keys_s, perm.to(torch.int32), w_word, g_words


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
    keys_s, perm, w_word, g_words = _outer_stream(cuda_device, M, B, n_rows,
                                                  C, skew=skew)
    before = ts.segment_totals_outer.launches
    out = ts.segment_totals_outer(keys_s, perm, w_word, g_words, n_rows, C)
    assert ts.segment_totals_outer.launches == before + 1
    again = ts.segment_totals_outer(keys_s, perm, w_word, g_words, n_rows, C)
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
    keys_s, perm, w_word, g_words = _outer_stream(cuda_device, 50000, 9000,
                                                  4000, C, seed=C)
    out = ts.segment_totals_outer(keys_s, perm, w_word, g_words, 4000, C)
    ref = ts.segment_totals_outer_plain(keys_s, perm, w_word, g_words, 4000,
                                        C)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("variant,mm", [("additive", "auto"),
                                        ("additive", "0"), ("xor", "auto")])
def test_window_records_kernel_bit_exact(cuda_device, monkeypatch, variant,
                                         mm):
    """The backward's records (base, packed w0/w1) from the kernel equal
    the plain version bit for bit, with out-of-bounds and NaN points."""
    monkeypatch.setenv("RAW_NGP_MM_LEVELS", mm)
    spec = HashGridSpec.create(num_levels=4, level_dim=8,
                               log2_hashmap_size=14, desired_resolution=512,
                               hash_variant=variant)
    x = torch.from_numpy(_points(65536)).to(cuda_device)
    before = th.window_records.launches
    base, w_word = th.window_records(x, spec)
    assert th.window_records.launches == before + 1
    base_p, w_word_p = th.window_records_plain(x, spec)
    torch.cuda.synchronize()
    assert torch.equal(base, base_p) and torch.equal(w_word, w_word_p)


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
    (dense-level scatter kernel, record kernel, packing, torch.sort, B2,
    combine) against the plain path (transposed matmul, plain records,
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
    counters = (th.window_records, ts.segment_totals_outer, th.mm_grad_table,
                th.pack_g_words, th.combine_totals)
    counts = [c.launches for c in counters]
    grads = []
    for fn in (th.hash_encode, th.hash_encode_plain):
        p = table.clone().requires_grad_()
        (fn(p, x, spec, compute_dtype=dtype).float() * cot).sum().backward()
        grads.append(p.grad)
    assert [c.launches for c in counters] == [n + 1 for n in counts]
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
    g_words = torch.stack(ts.pack_bf16_pairs(list(g.T)), dim=1).contiguous()
    args = (keys, perm.to(torch.int32), w_word, g_words, n_rows, C)
    out, again = (ts.segment_totals_outer(*args) for _ in range(2))
    ref = ts.segment_totals_outer_plain(*args)
    vals = torch.randn(32, M, generator=gen, device=cuda_device)
    packed = torch.stack(ts.pack_bf16_pairs(list(vals))).contiguous()
    ch, ch2 = (ts.segment_totals(keys, packed, n_rows, 32) for _ in range(2))
    ch_ref = ts.segment_totals_plain(keys, packed, n_rows, 32)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    assert torch.equal(ch.view(torch.int32), ch2.view(torch.int32))
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ch, ch_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 2, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_table_grad_glue_kernels_bit_exact(cuda_device, C, dtype):
    """The packing of g into B2's payload words and the G0 + G1 combine,
    kernel against plain version: bit for bit (truncations and one f32
    add each)."""
    spec = HashGridSpec.create(num_levels=4, level_dim=C,
                               log2_hashmap_size=14, desired_resolution=512)
    gen = torch.Generator(device=cuda_device).manual_seed(C)
    g = torch.randn(5000, spec.output_dim, generator=gen,
                    device=cuda_device).to(dtype)
    counts = (th.pack_g_words.launches, th.combine_totals.launches)
    words = th.pack_g_words(g, spec)
    assert torch.equal(words, th.pack_g_words_plain(g, spec))
    totals = torch.randn(3000, 2 * C, generator=gen, device=cuda_device)
    out = th.combine_totals(totals, torch.empty(3000 * C,
                                                device=cuda_device))
    ref = th.combine_totals_plain(totals, torch.empty_like(out))
    torch.cuda.synchronize()
    assert (th.pack_g_words.launches, th.combine_totals.launches) == (
        counts[0] + 1, counts[1] + 1)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("keep_rate", [0.0, 0.03, 0.25, 0.9, 1.0])
def test_compact_backward_kernel_bit_exact(cuda_device, keep_rate):
    """B1's backward at the train shape (M = 524,288, m_pad = 262,144; keep
    rates 0.9 and 1.0 overflow the budget) against the plain version
    (zeros + index_copy_ at the filled pos), through compact_attrs'
    autograd: bit-exact, a copy of bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    M, m_pad = 1 << 19, 262144
    mask = torch.rand(M, generator=gen, device=cuda_device) < keep_rate
    attrs = torch.randn(2, M, generator=gen, device=cuda_device)
    g = torch.randn(2, m_pad, generator=gen, device=cuda_device)
    c = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
    keys = torch.where(mask & (c <= m_pad), c - 1,
                       tc.SENTINEL).to(torch.int32)
    a = attrs.clone().requires_grad_()
    before = tc.compact_attrs_bwd.launches
    pos, att = tc.compact_attrs(a, keys, c, m_pad)
    att.backward(g)
    assert tc.compact_attrs_bwd.launches == before + 1
    ref = tc.compact_attrs_bwd_plain(g, pos, M)
    torch.cuda.synchronize()
    assert torch.equal(a.grad.view(torch.int32), ref.view(torch.int32))
    assert (a.grad[:, keys >= m_pad] == 0).all()


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
