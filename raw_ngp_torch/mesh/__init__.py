"""Mesh extraction of the port (counterpart of raw_ngp_tpu/mesh)."""

from raw_ngp_torch.mesh.extract import (
    clean_mesh,
    decimate_mesh,
    export_meshes,
    export_ply,
    load_ply,
    marching_tetrahedra,
    mark_unseen_triangles,
)
