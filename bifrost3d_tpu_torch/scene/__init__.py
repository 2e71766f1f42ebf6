"""Scene: materials, the pinhole camera and the RenderScene bundle. Port of
the slice's part of ``bifrost3d_tpu/scene``.
"""
