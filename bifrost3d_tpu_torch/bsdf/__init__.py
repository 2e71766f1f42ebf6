"""BSDFs: EON Oren-Nayar, Lambert, Burley and GGX reflection and
transmission, with Fresnel helpers. Port of the slice's part of
``bifrost3d_tpu/bsdf``.

Directions are in tangent space (+z = shading normal); ``wo`` points toward
the viewer and ``wi`` toward the light.
"""
