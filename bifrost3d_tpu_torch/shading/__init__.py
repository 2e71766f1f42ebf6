"""Shading: the Default model and its rho lookup tables. Port of the
slice's part of ``bifrost3d_tpu/shading`` (the Diffuse and Transmissive
models are not on the slice yet).
"""
