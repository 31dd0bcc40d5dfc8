"""Host utilities of the port (counterpart of raw_ngp_tpu/utils): camera
rigs. The run logger stays with ROADMAP item A13."""

from raw_ngp_torch.utils.cameras import create_dodecahedron_cameras, rand_poses
