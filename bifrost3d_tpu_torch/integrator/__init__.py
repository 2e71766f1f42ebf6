"""Integrators: the wavefront path tracer (fixed-iteration and pooled),
the mesh and SmallPT megakernels, the AOV pass and the render backends.
Port of ``bifrost3d_tpu/integrator``.
"""
