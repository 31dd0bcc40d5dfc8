"""Scene containers and the synthetic scene (numpy only)."""

from raw_ngp_torch.data.scene import SceneData, SceneMeta
from raw_ngp_torch.data.synthetic import look_at_pose, make_synthetic_scene
