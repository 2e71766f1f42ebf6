"""Differentiable and inverse rendering.

Port of ``bifrost3d_tpu/diff``: gradients of rendered radiance with
respect to material, light and environment parameters through the
wavefront, whose hit queries are detached (differentiate the estimator,
not the sampler), Adam inverse rendering over material parameters, and
edge-sampled boundary terms for geometry (``edge_grad`` for analytic
spheres, ``mesh_edge_grad`` for triangle meshes).
"""

from bifrost3d_tpu_torch.diff.render_grad import (
    image_l2_loss,
    optimize_materials,
    render_loss_grad,
)
from bifrost3d_tpu_torch.diff.mesh_edge_grad import (
    MeshEdges,
    edge_translation_gradient,
)
