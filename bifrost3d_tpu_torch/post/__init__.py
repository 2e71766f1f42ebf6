"""Camera post effects: exposure, Gaussian bloom, vignette, tonemapping and
film grain. Port of the slice's part of ``bifrost3d_tpu/post``.
"""
