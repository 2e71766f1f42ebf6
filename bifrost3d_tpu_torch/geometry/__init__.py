"""Geometry: meshes, procedural creation, the dense trace and its CUDA
kernel. Port of the slice's part of ``bifrost3d_tpu/geometry`` (the BVH
and its kernels are not on the slice yet).
"""
