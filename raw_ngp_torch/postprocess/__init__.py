"""RAW image math of the port (counterpart of raw_ngp_tpu/postprocess):
the numpy functions of ``raw.py`` (its cv2 Sobel normals and HDR merge and
tonemaps in numpy, ``hdr.py``) and the colour-checker solve."""

from raw_ngp_torch.postprocess.colorchecker import (
    CLASSIC_24,
    determine_wb,
    extract_patch_means,
    solve_color_matrix,
)
from raw_ngp_torch.postprocess.raw import (
    bilinear_demosaic,
    depth_to_normal,
    linear_to_srgb,
    pixels_to_bayer_mask,
    postprocess_raw,
    postprocess_raw_hdr,
    srgb_to_linear,
)
