"""Math foundation on tensors: vectors, quaternions, transforms, colors,
octahedral normals and the ray-origin offset.

Port of the slice's part of ``bifrost3d_tpu/math``.
"""
