"""RAW image math of the port (counterpart of raw_ngp_tpu/postprocess):
the numpy functions of ``raw.py`` and its cv2 Sobel normals in numpy. The
HDR merge and the colour checker stay with ROADMAP items A13b and A16."""

from raw_ngp_torch.postprocess.raw import (
    bilinear_demosaic,
    depth_to_normal,
    linear_to_srgb,
    pixels_to_bayer_mask,
    postprocess_raw,
    srgb_to_linear,
)
