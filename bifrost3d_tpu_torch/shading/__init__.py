"""Shading: the Default, Diffuse and Transmissive models, the thin-sheet
throughput and the rho lookup tables. Port of the slice's part of
``bifrost3d_tpu/shading``.
"""
