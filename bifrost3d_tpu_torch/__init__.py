"""bifrost3d_tpu_torch: the PyTorch and CUDA port of ``bifrost3d_tpu``.

A second package beside the JAX one, with the same subpackage and module
names so each module's counterpart is easy to find. It renders every mode
of the JAX package's viewer: the nine built-in scenes and the user's OBJ
and glTF files through the path tracer (the mesh megakernel, or the
pooled compacting wavefront), with path regularization, trilinear mips,
the denoised backend, checkpoint/resume and the AOVs; the rasterizer-style
preview renderer; the live engine of the interactive viewer (``core``:
the engine loop, UIDs, change sets and the compositor, over the
``scene.datamodel`` managers, whose ``SceneSync`` keeps the device scene
in step incrementally); the SmallPT app; the EnvironmentConvolution app;
and gradients through the wavefront (``diff``). Its seven trace and
megakernels are hand-written CUDA (``csrc/``), each bound in the wrapper
module of the JAX kernel it replaces.

Conventions:

- plain functions on tensors; small ``NamedTuple``s for scene data;
- every entry point that creates tensors takes an explicit ``device``;
- all randomness is the deterministic Owen-scrambled Sobol chain keyed by
  (accumulation, pixel hash, 8·bounce + dim), bit-exact with the JAX
  package;
- a feature that is not ported raises ``NotImplementedError`` naming it
  rather than rendering without it.

This package imports ``torch`` and ``numpy`` only — never ``jax`` and
never ``bifrost3d_tpu``.
"""
