"""RAW image math of the port (counterpart of raw_ngp_tpu/postprocess):
the numpy functions of ``raw.py``. The cv2 ones (HDR merge, normals from
depth) and the colour checker stay with ROADMAP items A13 and A16."""

from raw_ngp_torch.postprocess.raw import (
    bilinear_demosaic,
    linear_to_srgb,
    pixels_to_bayer_mask,
    postprocess_raw,
    srgb_to_linear,
)
