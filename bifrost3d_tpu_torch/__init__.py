"""bifrost3d_tpu_torch: the PyTorch and CUDA port of ``bifrost3d_tpu``.

A second package beside the JAX one, with the same subpackage and module
names so each module's counterpart is easy to find. It covers one slice of
the system so far: CornellBox through the pooled compacting wavefront
(``integrator.path_tracer.render_progressive``), with the dense
Möller–Trumbore trace as a hand-written CUDA kernel
(``csrc/dense_intersect.cu``, bound in ``geometry.pallas_intersect``).

Conventions:

- plain functions on tensors; small ``NamedTuple``s for scene data;
- every entry point that creates tensors takes an explicit ``device``;
- all randomness is the deterministic Owen-scrambled Sobol chain keyed by
  (accumulation, pixel hash, 8·bounce + dim), bit-exact with the JAX
  package;
- a feature outside the slice raises ``NotImplementedError`` naming it
  rather than rendering without it.

This package imports ``torch`` and ``numpy`` only — never ``jax`` and
never ``bifrost3d_tpu``.
"""
