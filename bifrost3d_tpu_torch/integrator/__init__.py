"""Integrators: the wavefront path tracer (fixed-iteration and pooled).
Port of the slice's part of ``bifrost3d_tpu/integrator``.
"""
