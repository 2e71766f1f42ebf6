"""Faults of the ``material_fit`` job: the fit's state returned unchanged,
half of the pixels left out of the loss, and the rendered image altered."""

from __future__ import annotations


def _fit_state_unchanged(real):
    def optimize(scene, *a, **kw):
        return real(scene, *a, **kw)._replace(scene=scene)
    return optimize


def _half_loss(real):
    def loss(image, target):
        half = image.shape[0] // 2
        return real(image[:half], target[:half])
    return loss


def _scaled_image(real):
    def render(*a, **kw):
        return real(*a, **kw) * 1.01
    return render


FAULTS = {
    "state_returned_unchanged": ("diff.render_grad", "optimize_materials",
                                 _fit_state_unchanged),
    "half_of_the_pixels_left_out": ("diff.render_grad", "image_l2_loss",
                                    _half_loss),
    "image_altered": ("diff.render_grad", "render_sample", _scaled_image),
}
