"""I/O: images (PNG, EXR; JPG / TGA through PIL), OBJ and glTF loading,
image comparison, textures and pixel images.

Port of ``bifrost3d_tpu/io``; exports what its ``__init__`` exports.
"""

from bifrost3d_tpu_torch.io.image import (
    load_image,
    save_image,
    save_exr,
    load_exr,
    srgb_encode_u8,
)
from bifrost3d_tpu_torch.io.compare import rms, ssim, mssim
from bifrost3d_tpu_torch.io.obj import load_obj
from bifrost3d_tpu_torch.io.gltf import load_gltf
