"""Camera post effects: exposure with eye adaptation, Gaussian and
dual-kawase bloom, vignette, tonemapping and film grain. Port of
``bifrost3d_tpu/post``.
"""
