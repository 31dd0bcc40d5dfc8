"""Scenes: containers, the synthetic scenes, the loaders of scenes on disk
(COLMAP, NeRF transforms.json, DTU) and the per-step ray sampler; what
``raw_ngp_tpu/data/__init__.py`` exports."""

from raw_ngp_torch.data.colmap_io import (
    read_cameras_binary,
    read_images_binary,
    read_points3d_binary,
)
from raw_ngp_torch.data.providers import (
    load_colmap_scene,
    load_dtu_scene,
    load_nerf_scene,
    load_scene,
)
from raw_ngp_torch.data.reflectance import load_light_dirs
from raw_ngp_torch.data.sampler import bayer_lossmult, sample_ray_batch
from raw_ngp_torch.data.scene import SceneData, SceneMeta
from raw_ngp_torch.data.synthetic import (look_at_pose, make_rfield_grid_scene,
                                          make_synthetic_scene)
from raw_ngp_torch.data.trajectories import (
    circle_poses,
    create_dodecahedron_cameras,
    interp_poses,
    rand_poses,
)
