"""Host utilities of the port (counterpart of raw_ngp_tpu/utils): camera
rigs, and the run logger in ``utils.logging``."""

from raw_ngp_torch.utils.cameras import create_dodecahedron_cameras, rand_poses
