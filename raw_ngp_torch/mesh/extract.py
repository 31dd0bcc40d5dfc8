"""Mesh extraction: density query -> iso-surface -> clean -> decimate -> PLY
(port of ``raw_ngp_tpu/mesh/extract.py``: the numpy functions
``marching_tetrahedra`` ``:99``, ``clean_mesh`` ``:159``,
``decimate_mesh`` ``:188``, ``_rasterize_faces`` ``:218``,
``mark_unseen_triangles`` ``:302``, ``export_ply`` / ``load_ply``
``:336-353`` copied; ``query_density_grid`` ``:375`` and
``export_meshes`` ``:397`` on the Trainer's device).

Equivalent of the reference's export_mesh pipeline (nerf/renderer.py:
219-372 + meshutils.py), rebuilt without its GPL-ish native deps
(mcubes/pymeshlab/nvdiffrast):

  * iso-surface via vectorized MARCHING TETRAHEDRA (each cube split into 6
    tets; no 256-case tables to transcribe, watertight on shared faces) —
    produces ~2x the triangles of marching cubes at equal resolution, which
    the decimator recovers;
  * cleaning = connected-component filtering (scipy.sparse), the analogue
    of meshutils.clean_mesh:146-188's isolated-piece removal;
  * decimation = uniform vertex clustering to a target triangle budget
    (meshutils.decimate_mesh:27-60 analogue);
  * visibility culling = triangle rasterization into a per-camera z-buffer
    (_rasterize_faces; the analogue of the reference's nvdiffrast pass,
    renderer.py:678-713);
  * PLY export written directly (trimesh-free).

The density sweep runs the field's density (on the card: the encode
kernel) over the grid in 65,536-point chunks; everything after it is host
numpy.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Optional, Tuple

import numpy as np

# 6 tetrahedra per cube around the 0-7 main diagonal, as indices into the
# cube's 8 corners (corner c = (x + (c&1), y + ((c>>1)&1), z + ((c>>2)&1))).
# This decomposition is translation-consistent: every cube face receives
# the same diagonal orientation from both adjacent cubes, so the extracted
# surface is crack-free across cube boundaries.
_CUBE_TETS = np.array([
    [0, 1, 5, 7],
    [0, 5, 4, 7],
    [0, 4, 6, 7],
    [0, 6, 2, 7],
    [0, 2, 3, 7],
    [0, 3, 1, 7],
], dtype=np.int32)


def _tet_triangles(p, v, thresh):
    """Triangles from one batch of tets.

    p: [N, 4, 3] corner positions; v: [N, 4] values.
    Returns [M, 3, 3] triangle vertices.
    """
    inside = v > thresh                                  # [N, 4]
    case = (inside[:, 0].astype(np.int32)
            | (inside[:, 1].astype(np.int32) << 1)
            | (inside[:, 2].astype(np.int32) << 2)
            | (inside[:, 3].astype(np.int32) << 3))

    def interp(a, b):
        """Surface crossing on edge a-b (indices into the 4 corners)."""
        va, vb = v[:, a], v[:, b]
        t = (thresh - va) / (vb - va + 1e-12)
        t = np.clip(t, 0.0, 1.0)[:, None]
        return p[:, a] * (1 - t) + p[:, b] * t

    tris = []
    # single-corner cases: one triangle; orientations kept consistent by
    # ordering edges from the inside corner
    single = {1: (0, (1, 2, 3)), 2: (1, (0, 3, 2)), 4: (2, (0, 1, 3)),
              8: (3, (0, 2, 1))}
    for c, (vi, (e0, e1, e2)) in single.items():
        for cc, flip in ((c, False), (15 ^ c, True)):
            m = case == cc
            if not m.any():
                continue
            pa = interp(vi, e0)[m]
            pb = interp(vi, e1)[m]
            pc = interp(vi, e2)[m]
            t = np.stack([pa, pc, pb] if flip else [pa, pb, pc], axis=1)
            tris.append(t)

    # two-corner cases: quad -> two triangles
    double = {3: ((0, 1), (2, 3)), 5: ((0, 2), (1, 3)), 9: ((0, 3), (1, 2)),
              6: ((1, 2), (0, 3)), 10: ((1, 3), (0, 2)),
              12: ((2, 3), (0, 1))}
    for c, ((i0, i1), (o0, o1)) in double.items():
        m = case == c
        if not m.any():
            continue
        a = interp(i0, o0)[m]
        b = interp(i0, o1)[m]
        cpt = interp(i1, o1)[m]
        d = interp(i1, o0)[m]
        tris.append(np.stack([a, b, cpt], axis=1))
        tris.append(np.stack([a, cpt, d], axis=1))

    if not tris:
        return np.zeros((0, 3, 3), np.float32)
    return np.concatenate(tris).astype(np.float32)


def marching_tetrahedra(grid: np.ndarray, thresh: float,
                        slab: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """Iso-surface of a [R, R, R] scalar grid at ``thresh``.

    Returns (vertices [V, 3] in index coordinates, triangles [F, 3]).
    Processes z-slabs to bound memory; vertices are deduplicated by
    quantized position so shared tet faces weld.
    """
    R = grid.shape[0]
    all_tris = []
    for z0 in range(0, R - 1, slab):
        z1 = min(z0 + slab + 1, R)
        sub = grid[:, :, z0:z1]
        nx, ny, nz = R - 1, R - 1, (z1 - z0) - 1
        if nz <= 0:
            continue
        ix, iy, iz = np.meshgrid(np.arange(nx), np.arange(ny),
                                 np.arange(nz), indexing="ij")
        base = np.stack([ix.ravel(), iy.ravel(), iz.ravel()], -1)  # [N, 3]
        # quick reject: cube spans the threshold?
        c000 = sub[base[:, 0], base[:, 1], base[:, 2]]
        cmax = np.full(len(base), -np.inf)
        cmin = np.full(len(base), np.inf)
        for c in range(8):
            off = np.array([c & 1, (c >> 1) & 1, (c >> 2) & 1])
            vals = sub[base[:, 0] + off[0], base[:, 1] + off[1],
                       base[:, 2] + off[2]]
            cmax = np.maximum(cmax, vals)
            cmin = np.minimum(cmin, vals)
        active = (cmin <= thresh) & (cmax > thresh)
        base = base[active]
        if len(base) == 0:
            continue
        corners = np.stack([base + np.array([c & 1, (c >> 1) & 1,
                                             (c >> 2) & 1])
                            for c in range(8)], axis=1)       # [N, 8, 3]
        values = sub[corners[..., 0], corners[..., 1], corners[..., 2]]
        pos = corners.astype(np.float32)
        pos[..., 2] += z0
        for tet in _CUBE_TETS:
            t = _tet_triangles(pos[:, tet], values[:, tet], thresh)
            if len(t):
                all_tris.append(t)
    if not all_tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    tris = np.concatenate(all_tris)                            # [F, 3, 3]

    # weld vertices
    flat = tris.reshape(-1, 3)
    quant = np.round(flat * 1024.0).astype(np.int64)
    _, idx, inv = np.unique(quant, axis=0, return_index=True,
                            return_inverse=True)
    verts = flat[idx]
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return verts.astype(np.float32), faces[ok]


def clean_mesh(verts: np.ndarray, faces: np.ndarray,
               min_faces: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Remove connected components with < min_faces faces
    (meshutils.clean_mesh:146-188 analogue)."""
    if len(faces) == 0:
        return verts, faces
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    n = len(verts)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]])
    adj = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])),
                        shape=(n, n))
    n_comp, labels = connected_components(adj, directed=False)
    face_label = labels[faces[:, 0]]
    counts = np.bincount(face_label, minlength=n_comp)
    keep = counts[face_label] >= min_faces
    faces = faces[keep]
    return _compact(verts, faces)


def _compact(verts, faces):
    used = np.unique(faces.ravel()) if len(faces) else np.array([], np.int64)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces].astype(np.int32)


def decimate_mesh(verts: np.ndarray, faces: np.ndarray,
                  target_faces: int) -> Tuple[np.ndarray, np.ndarray]:
    """Vertex-clustering decimation to approximately target_faces
    (meshutils.decimate_mesh:27-60 analogue)."""
    if len(faces) <= target_faces or len(faces) == 0:
        return verts, faces
    lo, hi = verts.min(0), verts.max(0)
    span = (hi - lo).max() + 1e-8
    # grid resolution ~ sqrt relationship between cells and faces
    res = max(int((target_faces / 2) ** (1 / 2)), 8)
    for _ in range(8):
        cell = np.floor((verts - lo) / span * res).astype(np.int64)
        key = (cell[:, 0] * (res + 1) + cell[:, 1]) * (res + 1) + cell[:, 2]
        uniq, inv = np.unique(key, return_inverse=True)
        new_verts = np.zeros((len(uniq), 3), np.float64)
        np.add.at(new_verts, inv, verts)
        counts = np.bincount(inv).astype(np.float64)
        new_verts /= counts[:, None]
        new_faces = inv[faces]
        ok = ((new_faces[:, 0] != new_faces[:, 1])
              & (new_faces[:, 1] != new_faces[:, 2])
              & (new_faces[:, 0] != new_faces[:, 2]))
        new_faces = new_faces[ok]
        if len(new_faces) <= target_faces:
            return (new_verts.astype(np.float32),
                    new_faces.astype(np.int32))
        res = max(int(res * 0.8), 4)
    return new_verts.astype(np.float32), new_faces.astype(np.int32)


def _rasterize_faces(u, v, z, faces, res_w: int, res_h: int):
    """Vectorized software triangle rasterizer for one view.

    u/v: screen coords per vertex (pixels), z: view-space depth (> 0 in
    front). Generates the fragment list (pixel, depth, face) for every
    screen-bbox pixel that passes the barycentric inside test, depth-
    interpolating 1/z linearly in screen space (perspective-correct),
    z-buffers with ``np.minimum.at`` and returns the boolean per-face
    "owns at least one front fragment" visibility — the same decision
    nvdiffrast's triangle-id rasterization makes in the reference
    (renderer.py:678-713)."""
    F = len(faces)
    tri_u, tri_v = u[faces], v[faces]                      # [F, 3]
    tri_z = z[faces]
    front = (tri_z > 1e-6).all(axis=1)
    x0 = np.clip(np.floor(tri_u.min(1)), 0, res_w - 1).astype(np.int64)
    x1 = np.clip(np.ceil(tri_u.max(1)), 0, res_w - 1).astype(np.int64)
    y0 = np.clip(np.floor(tri_v.min(1)), 0, res_h - 1).astype(np.int64)
    y1 = np.clip(np.ceil(tri_v.max(1)), 0, res_h - 1).astype(np.int64)
    on_screen = (tri_u.max(1) >= 0) & (tri_u.min(1) < res_w) \
        & (tri_v.max(1) >= 0) & (tri_v.min(1) < res_h)
    ok = front & on_screen
    widths = np.where(ok, x1 - x0 + 1, 0)
    heights = np.where(ok, y1 - y0 + 1, 0)
    areas = widths * heights                               # bbox pixels
    total = int(areas.sum())
    if total == 0:
        return np.zeros(F, bool), ~front

    fid = np.repeat(np.arange(F), areas)                   # [A]
    offs = np.concatenate([[0], np.cumsum(areas)[:-1]])
    local = np.arange(total) - np.repeat(offs, areas)
    w_f = widths[fid]
    px = x0[fid] + local % w_f
    py = y0[fid] + local // w_f
    # pixel centers
    fx_, fy_ = px + 0.5, py + 0.5

    # guaranteed centroid fragment per face: sub-pixel triangles whose
    # bbox pixel centers all fall outside would otherwise never cover a
    # fragment and be culled (GL rasterization has the same dropout; the
    # reference renders at full capture resolution where it is benign)
    c_u = tri_u.mean(1)
    c_v = tri_v.mean(1)
    c_inz = 3.0 / (1.0 / tri_z[:, 0] + 1.0 / tri_z[:, 1]
                   + 1.0 / tri_z[:, 2])
    c_ok = ok & (c_u >= 0) & (c_u < res_w) & (c_v >= 0) & (c_v < res_h)
    c_fid = np.arange(F)[c_ok]

    au, av = tri_u[fid, 0], tri_v[fid, 0]
    bu, bv = tri_u[fid, 1], tri_v[fid, 1]
    cu, cv = tri_u[fid, 2], tri_v[fid, 2]
    det = (bu - au) * (cv - av) - (bv - av) * (cu - au)
    l0 = ((bu - fx_) * (cv - fy_) - (bv - fy_) * (cu - fx_))
    l1 = ((cu - fx_) * (av - fy_) - (cv - fy_) * (au - fx_))
    l2 = ((au - fx_) * (bv - fy_) - (av - fy_) * (bu - fx_))
    s = np.sign(det)
    inside = (l0 * s >= 0) & (l1 * s >= 0) & (l2 * s >= 0) \
        & (np.abs(det) > 1e-12)

    fid = fid[inside]
    pix = py[inside] * res_w + px[inside]
    d = det[inside]
    b0, b1, b2 = l0[inside] / d, l1[inside] / d, l2[inside] / d
    inv_z = (b0 / tri_z[fid, 0] + b1 / tri_z[fid, 1]
             + b2 / tri_z[fid, 2])
    depth = 1.0 / np.maximum(inv_z, 1e-12)

    fid = np.concatenate([fid, c_fid])
    pix = np.concatenate([pix, (c_v[c_ok].astype(np.int64) * res_w
                                + c_u[c_ok].astype(np.int64))])
    depth = np.concatenate([depth, c_inz[c_ok]])

    zbuf = np.full(res_w * res_h, np.inf)
    np.minimum.at(zbuf, pix, depth)
    # 2% depth tolerance: at reduced resolution several near-coincident
    # faces share a pixel and strict per-pixel ownership (what nvdiffrast
    # reports at full capture resolution) would over-cull visible surface
    owns = depth <= zbuf[pix] * 1.02 + 1e-4
    seen = np.zeros(F, bool)
    seen[fid[owns]] = True
    return seen, ~front


def mark_unseen_triangles(verts: np.ndarray, faces: np.ndarray,
                          poses: np.ndarray, intrinsics: np.ndarray,
                          H: int, W: int,
                          max_res: int = 800) -> np.ndarray:
    """True for faces not visible from any training camera.

    Occlusion-accurate software rasterization replacing the reference's
    nvdiffrast GL pass (renderer.py:678-713, unavailable in this image):
    every face is scan-converted into a per-view z-buffer and counts as
    seen when it owns a front-most fragment in any view. Views render at
    up to ``max_res`` wide (the reference notes lower resolution
    suffices). Faces crossing the near plane are conservatively kept."""
    fx, fy, cx, cy = [float(x) for x in np.asarray(intrinsics)[:4]]
    scale = min(1.0, max_res / max(W, 1))
    res_w, res_h = max(int(W * scale), 8), max(int(H * scale), 8)
    seen = np.zeros(len(faces), bool)
    near_clipped_any = np.zeros(len(faces), bool)
    for pose in np.asarray(poses):
        R, t = pose[:3, :3], pose[:3, 3]
        cam = (verts - t) @ R                          # world -> cam
        z = -cam[:, 2]                                 # looking down -z
        zs = np.maximum(z, 1e-9)
        u = (fx * cam[:, 0] / zs + cx) * scale
        v = (-fy * cam[:, 1] / zs + cy) * scale
        s, not_front = _rasterize_faces(u, v, z, faces, res_w, res_h)
        seen |= s
        # a face straddling this camera's near plane (some vertices in
        # front, some behind) is conservatively kept: proper clipping
        # would rasterize its visible part
        near_clipped_any |= not_front & (z[faces] > 1e-6).any(axis=1)
    seen |= near_clipped_any
    return ~seen


def export_ply(verts: np.ndarray, faces: np.ndarray, path: str):
    """Binary little-endian PLY writer (replaces trimesh.export)."""
    with open(path, "wb") as f:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n")
        f.write(header.encode("ascii"))
        f.write(verts.astype("<f4").tobytes())
        fdata = np.empty((len(faces), 13), np.uint8)
        fdata[:, 0] = 3
        fdata[:, 1:] = faces.astype("<i4").view(np.uint8).reshape(-1, 12)
        f.write(fdata.tobytes())


def load_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Reader for the files export_ply writes (tests/round-trips)."""
    with open(path, "rb") as f:
        n_v = n_f = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith("element face"):
                n_f = int(line.split()[-1])
            elif line == "end_header":
                break
        verts = np.frombuffer(f.read(12 * n_v), "<f4").reshape(n_v, 3)
        raw = np.frombuffer(f.read(13 * n_f), np.uint8).reshape(n_f, 13)
        faces = raw[:, 1:].copy().view("<i4").reshape(n_f, 3)
    return verts.copy(), faces.copy()


# ---------------------------------------------------------------------------
# density-field -> meshes (renderer.py:219-372 flow)
# ---------------------------------------------------------------------------

def query_density_grid(trainer, resolution: int, bound: float = 1.0,
                       chunk: int = 2 ** 16, field=None) -> np.ndarray:
    """Chunked sigma sweep over [-bound, bound]^3 (renderer.py:237-248)
    with ``field`` (default the trainer's, its raw parameters) on the
    trainer's device; the last chunk is padded with the origin to the full
    chunk, so every call has one shape."""
    import torch

    field = trainer.field if field is None else field

    xs = np.linspace(-bound, bound, resolution, dtype=np.float32)
    out = np.zeros(resolution ** 3, np.float32)
    grid_pts = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"),
                        -1).reshape(-1, 3)
    with torch.inference_mode():
        for s in range(0, len(grid_pts), chunk):
            e = min(s + chunk, len(grid_pts))
            pts = grid_pts[s:e]
            if e - s < chunk:
                pts = np.pad(pts, ((0, chunk - (e - s)), (0, 0)))
            x = torch.from_numpy(pts).to(trainer.device)
            sig = field.density(x).float().cpu().numpy()
            out[s:e] = sig[: e - s]
    return np.nan_to_num(out.reshape(resolution, resolution, resolution))


def export_meshes(trainer, save_dir: str, dataset=None,
                  resolution: Optional[int] = None, field=None):
    """Inner mesh + per-cascade outer meshes (renderer.py:219-372) of
    ``field``'s density (default the trainer's field; a channel-sharded
    Trainer's :meth:`gathered_field` on one rank)."""
    import torch

    from raw_ngp_torch.ops.contraction import uncontract

    cfg = trainer.cfg
    os.makedirs(save_dir, exist_ok=True)
    resolution = resolution or min(cfg.mesh.mcubes_reso, 256)

    if cfg.render.occupancy and trainer.state.mean_density is not None:
        thresh = min(float(trainer.state.mean_density),
                     cfg.render.density_thresh)
    else:
        thresh = cfg.render.density_thresh

    t0 = time.perf_counter()
    sig = query_density_grid(trainer, resolution, bound=1.0, field=field)
    t1 = time.perf_counter()
    verts, faces = marching_tetrahedra(sig, thresh)
    print(f"[mesh] inner: density sweep {t1 - t0:.3f} s, marching "
          f"tetrahedra {time.perf_counter() - t1:.3f} s")
    if len(faces):
        verts = verts / (resolution - 1.0) * 2.0 - 1.0
        if dataset is not None:
            unseen = mark_unseen_triangles(
                verts, faces, np.asarray(dataset.poses),
                np.asarray(dataset.intrinsics), dataset.H, dataset.W)
            verts, faces = _compact(verts, faces[~unseen])
        verts, faces = clean_mesh(verts, faces, cfg.mesh.clean_min_f)
        if cfg.mesh.decimate_target > 0:
            verts, faces = decimate_mesh(verts, faces,
                                         cfg.mesh.decimate_target)
        export_ply(verts, faces, os.path.join(save_dir, "mesh_0.ply"))
        print(f"[mesh] inner: {len(verts)} verts, {len(faces)} faces")

    # outer cascades (renderer.py:284-372)
    if cfg.grid_bound > 1:
        target = cfg.mesh.env_reso
        for cas in range(1, cfg.cascades):
            bound = min(2 ** cas, cfg.grid_bound)
            t0 = time.perf_counter()
            sig = query_density_grid(trainer, target, bound=bound,
                                     field=field)
            t1 = time.perf_counter()
            v, f = marching_tetrahedra(sig, thresh)
            print(f"[mesh] cascade {cas}: density sweep {t1 - t0:.3f} s, "
                  f"marching tetrahedra {time.perf_counter() - t1:.3f} s")
            if not len(f):
                continue
            v = v / (target - 1.0) * 2.0 - 1.0
            # remove the center already covered by finer cascades
            r = 0.45
            keep_v = np.abs(v).max(axis=1) > r
            keep_f = keep_v[f].all(axis=1)
            v, f = _compact(v, f[keep_f])
            if not len(f):
                continue
            v = v * (bound - bound / target)
            if cfg.render.contract:
                v = uncontract(torch.from_numpy(v)).numpy()
            v2, f2 = clean_mesh(v, f, cfg.mesh.clean_min_f)
            if cfg.mesh.decimate_target > 0:
                v2, f2 = decimate_mesh(v2, f2,
                                       cfg.mesh.decimate_target // 2)
            if len(f2):
                export_ply(v2, f2,
                           os.path.join(save_dir, f"mesh_{cas}.ply"))
                print(f"[mesh] cascade {cas}: {len(v2)} verts, "
                      f"{len(f2)} faces")
