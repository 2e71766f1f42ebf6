"""Monte-Carlo sampling distributions on tensors.

Port of ``bifrost3d_tpu/sampling/distributions.py``:
``concentric_disk_sample``, ``cone_pdf``/``cone_sample``,
``uniform_sphere_sample``, ``uniform_hemisphere_sample``,
``cosine_hemisphere_pdf``/``_sample``, ``ggx_ndf``, ``ggx_ndf_pdf``/
``_sample`` (Walter 07), ``_ggx_lambda``, ``ggx_vndf_sample_halfway``,
``ggx_vndf_pdf``, ``ggx_vndf_sample`` (Dupuy & Benyoub 2023),
``ggx_bounded_vndf_sample``/``_pdf`` (Eto 2023), ``oren_nayar_cltc_sample``/``_pdf`` (EON CLTC) and
``henyey_greenstein_phase``/``_sample`` and
``exponential_distance_sample``. Directions are in
tangent space (+z = shading normal); samplers take ``u2 [..., 2]`` in
[0, 1)² and return ``(direction [..., 3], pdf [...])``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.frozen.math.clip import clip, maximum
from benchmark.reference.frozen.math.vec import gsafe, lerp, normalize, reflect

PI = float(np.float32(np.pi))
TWO_PI = float(np.float32(2.0 * np.pi))
INV_PI = float(np.float32(1.0 / np.pi))


def concentric_disk_sample(u2, radius=1.0):
    """Concentric disk mapping (Ray Tracing Gems 16.5.1.2) → (xy, pdf)."""
    a = 2.0 * u2[..., 0] - 1.0
    b = 2.0 * u2[..., 1] - 1.0
    b = torch.where(b == 0.0, 1.0, b)
    use_a = a * a > b * b
    r = torch.where(use_a, a, b) * radius
    safe_a = torch.where(a == 0.0, 1.0, a)
    phi = torch.where(use_a, (PI / 4) * (b / safe_a),
                      (PI / 2) - (PI / 4) * (a / b))
    xy = torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)
    pdf = torch.broadcast_to(
        torch.as_tensor(1.0 / (PI * radius * radius), dtype=r.dtype,
                        device=r.device), r.shape)
    return xy, pdf


def cone_pdf(cos_theta_max):
    return 1.0 / (TWO_PI * maximum(1.0 - cos_theta_max, 1e-10))


def cone_sample(cos_theta_max, u2):
    """Uniform direction in a cone about +z."""
    cos_theta = (1.0 - u2[..., 0]) + u2[..., 0] * cos_theta_max
    sin_theta = torch.sqrt(gsafe(1.0 - cos_theta * cos_theta))
    phi = TWO_PI * u2[..., 1]
    d = torch.stack([torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta,
                     cos_theta], dim=-1)
    return d, torch.broadcast_to(cone_pdf(cos_theta_max), cos_theta.shape)


def uniform_sphere_sample(u2):
    """Uniform sphere via the octahedral concentric map (RT Gems
    16.5.4.2)."""
    u = 2.0 * u2 - 1.0
    d = 1.0 - (torch.abs(u[..., 0]) + torch.abs(u[..., 1]))
    r = 1.0 - torch.abs(d)
    safe_r = torch.where(r == 0.0, 1.0, r)
    phi = torch.where(
        r == 0.0, 0.0,
        (PI / 4) * ((torch.abs(u[..., 0]) - torch.abs(u[..., 1])) / safe_r
                    + 1.0))
    f = r * torch.sqrt(gsafe(2.0 - r * r, 0.0))
    x = f * torch.sign(u[..., 0]) * torch.cos(phi)
    y = f * torch.sign(u[..., 1]) * torch.sin(phi)
    z = torch.sign(d) * (1.0 - r * r)
    pdf = torch.full_like(z, 0.25 * INV_PI)
    return torch.stack([x, y, z], dim=-1), pdf


def uniform_hemisphere_sample(u2):
    z = u2[..., 0]
    r = torch.sqrt(gsafe(1.0 - z * z))
    phi = TWO_PI * u2[..., 1]
    d = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    return d, torch.full_like(z, 0.5 * INV_PI)


def cosine_hemisphere_pdf(abs_cos_theta):
    return abs_cos_theta * INV_PI


def cosine_hemisphere_sample(u2):
    r2 = u2[..., 0]
    r = torch.sqrt(gsafe(1.0 - r2))
    z = torch.sqrt(r2)
    phi = TWO_PI * u2[..., 1]
    d = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    return d, z * INV_PI


# -- GGX ---------------------------------------------------------------------

def ggx_ndf(alpha, abs_cos_theta):
    """Isotropic GGX D in the division-free form a²/(π·(c²a² + s²)²)."""
    a2 = alpha * alpha
    c2 = abs_cos_theta * abs_cos_theta
    s2 = maximum(1.0 - c2, 0.0)
    q = maximum(c2 * a2 + s2, 1e-9)
    return a2 / (PI * q * q)


def ggx_ndf_pdf(alpha, abs_cos_theta):
    return ggx_ndf(alpha, abs_cos_theta) * abs_cos_theta


def ggx_ndf_sample(alpha, u2):
    """Sample a halfway vector from D(h)·cosθ (Walter 07)."""
    phi = TWO_PI * u2[..., 1]
    tan2 = alpha * alpha * u2[..., 0] / maximum(1.0 - u2[..., 0], 1e-10)
    cos_theta = 1.0 / torch.sqrt(1.0 + tan2)
    r = torch.sqrt(gsafe(1.0 - cos_theta * cos_theta, 0.0))
    h = torch.stack([r * torch.cos(phi), r * torch.sin(phi), cos_theta],
                    dim=-1)
    return h, ggx_ndf_pdf(alpha, cos_theta)


def ggx_lambda(alpha, w):
    """Smith lambda for isotropic GGX."""
    z2 = maximum(w[..., 2] * w[..., 2], 1e-12)
    ax = alpha * w[..., 0]
    ay = alpha * w[..., 1]
    return 0.5 * (-1.0 + torch.sqrt(1.0 + (ax * ax + ay * ay) / z2))


_ggx_lambda = ggx_lambda


def ggx_vndf_sample_halfway(alpha, wo, u2):
    """Spherical-caps VNDF halfway sample (Dupuy & Benyoub 2023, listing 1)."""
    alpha = torch.as_tensor(alpha, dtype=wo.dtype, device=wo.device)[..., None]
    wo_std = normalize(torch.cat([wo[..., :2] * alpha, wo[..., 2:3]], dim=-1))
    phi = TWO_PI * u2[..., 1]
    z = (1.0 - u2[..., 0]) * (1.0 + wo_std[..., 2]) - wo_std[..., 2]
    sin_theta = torch.sqrt(clip(1.0 - z * z, 1e-12, 1.0))
    c = torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), z],
                    dim=-1)
    wi_std = c + wo_std
    h = torch.cat([wi_std[..., :2] * alpha, maximum(wi_std[..., 2:3], 0.0)],
                  dim=-1)
    return normalize(h)


def ggx_vndf_pdf(alpha, wo, halfway):
    """PDF of the VNDF halfway sample (Heitz 2018, eq. 3)."""
    recip_g1 = 1.0 + ggx_lambda(alpha, wo)
    d = ggx_ndf(alpha, torch.abs(halfway[..., 2]))
    cos_oh = maximum(torch.sum(wo * halfway, dim=-1), 0.0)
    return cos_oh * d / (recip_g1 * maximum(torch.abs(wo[..., 2]), 1e-10))


def ggx_vndf_sample(alpha, wo, u2):
    h = ggx_vndf_sample_halfway(alpha, wo, u2)
    return h, ggx_vndf_pdf(alpha, wo, h)


def _bounded_k(alpha, wo):
    """Eto 2023 eq. 5-6 shrinking factor for the spherical cap."""
    a2 = alpha * alpha
    s = 1.0 + torch.sqrt(gsafe(wo[..., 0] ** 2 + wo[..., 1] ** 2))
    s2 = s * s
    return (1.0 - a2) * s2 / (s2 + a2 * wo[..., 2] * wo[..., 2])


def ggx_bounded_vndf_sample(alpha, wo, u2):
    """Sample a reflection direction from the bounded VNDF → (wi, pdf)."""
    alpha_c = alpha[..., None]
    wo_std = normalize(torch.cat([wo[..., :2] * alpha_c, wo[..., 2:3]], dim=-1))
    phi = TWO_PI * u2[..., 1]
    k = _bounded_k(alpha, wo)
    b = torch.where(wo[..., 2] >= 0.0, k * wo_std[..., 2], wo_std[..., 2])
    z = (1.0 - u2[..., 0]) * (1.0 + b) - b
    sin_theta = torch.sqrt(clip(1.0 - z * z, 1e-12, 1.0))
    o_std = torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                         z], dim=-1)
    h_std = wo_std + o_std
    h = normalize(torch.cat([h_std[..., :2] * alpha_c, h_std[..., 2:3]], dim=-1))
    wi = reflect(-wo, h)
    return wi, ggx_bounded_vndf_pdf(alpha, wo, wi)


def ggx_bounded_vndf_pdf(alpha, wo, wi):
    """PDF of the bounded-VNDF reflection sample (Eto 2023, listing 2)."""
    h = normalize(wo + wi)
    ndf = ggx_ndf(alpha, torch.abs(h[..., 2]))
    ax = alpha * wo[..., 0]
    ay = alpha * wo[..., 1]
    ao2 = ax * ax + ay * ay
    t = torch.sqrt(gsafe(ao2 + wo[..., 2] * wo[..., 2]))
    k = _bounded_k(alpha, wo)
    upper = ndf / (2.0 * (k * wo[..., 2] + t))
    neg = wo[..., 2] < 0.0
    safe_ao2 = torch.where(neg, maximum(2.0 * ao2, 1e-10), 1.0)
    lower = ndf * (t - wo[..., 2]) / safe_ao2
    return torch.where(neg, lower, upper)


# -- Oren-Nayar CLTC (EON paper, arXiv 2410.18026, listing 3) -----------------

def _cltc_coeffs(cos_theta, roughness):
    mu, r = cos_theta, roughness
    a = 1.0 + r * (0.303392 + (-0.518982 + 0.111709 * mu) * mu
                   + (-0.276266 + 0.335918 * mu) * r)
    b = r * (-1.16407 + 1.15859 * mu + (0.150815 - 0.150105 * mu) * r) / (
        mu * mu * mu - 1.43545)
    c = 1.0 + (0.20013 + (-0.506373 + 0.261777 * mu) * mu) * r
    d = ((0.540852 + (-1.01625 + 0.475392 * mu) * mu) * r) / (
        -1.0743 + mu * (0.0725628 + mu))
    return a, b, c, d


def _ltc_x_axis(wo):
    """Unit 2D axis of wo's azimuth (+x when wo is the normal)."""
    wh = wo[..., :2]
    len2 = torch.sum(wh * wh, dim=-1, keepdim=True)
    unit_x = torch.tensor([1.0, 0.0], dtype=wo.dtype, device=wo.device)
    return torch.where(len2 > 0.0, wh / torch.sqrt(gsafe(len2, 1e-20)), unit_x)


def oren_nayar_cltc_sample(roughness, wo, u2):
    """CLTC direction sample for EON Oren-Nayar → (wi, pdf)."""
    a, b, c, d = _cltc_coeffs(wo[..., 2], roughness)
    radius = torch.sqrt(u2[..., 0])
    phi = TWO_PI * u2[..., 1]
    x = radius * torch.cos(phi)
    y = radius * torch.sin(phi)
    vz = 1.0 / torch.sqrt(d * d + 1.0)
    s = 0.5 * (1.0 + vz)
    x = -lerp(torch.sqrt(gsafe(1.0 - y * y)), x, s)
    whz = torch.sqrt(gsafe(1.0 - (x * x + y * y)))
    pdf_wh = whz / (PI * s)
    wi = torch.stack([a * x + b * whz, c * y, d * x + whz], dim=-1)
    wi_mag2 = torch.sum(wi * wi, dim=-1)
    det_m = c * (a - b * d)
    pdf_wi = pdf_wh * wi_mag2 * torch.sqrt(wi_mag2) / maximum(det_m, 1e-10)
    xaxis = _ltc_x_axis(wo)
    cx, sx = xaxis[..., 0], xaxis[..., 1]
    wx = cx * wi[..., 0] - sx * wi[..., 1]
    wy = sx * wi[..., 0] + cx * wi[..., 1]
    wi = normalize(torch.stack([wx, wy, wi[..., 2]], dim=-1))
    return wi, pdf_wi


def oren_nayar_cltc_pdf(roughness, wo, wi):
    """PDF of the CLTC sample."""
    xaxis = _ltc_x_axis(wo)
    cx, sx = xaxis[..., 0], xaxis[..., 1]
    lx = cx * wi[..., 0] + sx * wi[..., 1]
    ly = -sx * wi[..., 0] + cx * wi[..., 1]
    lz = wi[..., 2]
    a, b, c, d = _cltc_coeffs(wo[..., 2], roughness)
    det_m = c * (a - b * d)
    whx = c * (lx - b * lz)
    why = (a - b * d) * ly
    whz = -c * (d * lx - a * lz)
    wh_mag2 = whx * whx + why * why + whz * whz
    vz = 1.0 / torch.sqrt(d * d + 1.0)
    s = 0.5 * (1.0 + vz)
    return (det_m * det_m / maximum(wh_mag2 * wh_mag2, 1e-10)
            * maximum(whz, 0.0) / (PI * s))


def henyey_greenstein_phase(g, cos_theta):
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return (1.0 - g * g) / (4.0 * PI * denom * torch.sqrt(gsafe(denom, 1e-20)))


def henyey_greenstein_sample(g: float, u2):
    """Sample the HG phase function about +z → (direction, pdf). ``g`` is
    rounded to ``u2``'s dtype first, as JAX's ``jnp.asarray(g,
    jnp.float32)``: every term then sees the same ``g``, which the
    cancelling ``1 + g² - sqr_term²`` needs."""
    small = abs(g) < 1e-3
    g = torch.tensor(g, dtype=u2.dtype, device=u2.device)
    if small:
        cos_theta = 1.0 - 2.0 * u2[..., 0]
    else:
        sqr_term = (1.0 - g * g) / (1.0 + g * (2.0 * u2[..., 0] - 1.0))
        cos_theta = (1.0 + g * g - sqr_term * sqr_term) / (2.0 * g)
    sin_theta = torch.sqrt(gsafe(1.0 - cos_theta * cos_theta, 0.0))
    phi = TWO_PI * u2[..., 1]
    d = torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                     cos_theta], dim=-1)
    return d, henyey_greenstein_phase(g, cos_theta)


def exponential_distance_sample(sigma_t, u):
    """Free-flight distance ~ sigma_t·exp(-sigma_t·x) → (t, pdf)."""
    t = -torch.log(maximum(1.0 - u, 1e-20)) / sigma_t
    return t, sigma_t * torch.exp(-sigma_t * t)
