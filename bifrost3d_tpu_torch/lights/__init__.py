"""Analytic lights (sphere, spot, directional). Port of the slice's part of
``bifrost3d_tpu/lights`` (the environment light is not on the slice yet).
"""
