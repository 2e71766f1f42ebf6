"""Small geometric primitives: Plane, Line, Rect, ray intersections, and
image sampling.

Port of ``bifrost3d_tpu/math/geometry2d3d.py``: counterparts of
``Math/Plane.h``, ``Math/Line.h`` (the least-squares fit the LTC fitting
tooling uses), ``Math/Rect.h``, ``Math/Intersect.h`` (ray-plane /
ray-sphere) and ``Math/ImageSampling.h`` (bilinear / trilinear fetch).
Every function broadcasts over leading batch axes and follows its
tensors' device; rays that miss return a negative t (the reference's
convention: callers test ``t >= 0``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bifrost3d_tpu_torch.math.clip import absolute, clip, maximum
from bifrost3d_tpu_torch.math.vec import dot, normalize


def _f32(x):
    """A float tensor as it is; anything else as float32."""
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x
    return torch.as_tensor(x, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Plane: ax + by + cz + d = 0 (Math/Plane.h:25-64)
# ---------------------------------------------------------------------------

class Plane(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor

    @property
    def normal(self):
        return torch.stack(torch.broadcast_tensors(self.a, self.b, self.c),
                           dim=-1)

    @staticmethod
    def from_point_normal(point, normal):
        point, normal = _f32(point), _f32(normal)
        d = -dot(point, normal)
        return Plane(normal[..., 0], normal[..., 1], normal[..., 2], d)

    @staticmethod
    def from_point_direction(point, direction):
        return Plane.from_point_normal(point, normalize(_f32(direction)))


def intersect_ray_plane(origin, direction, plane: Plane):
    """Distance t along the ray to the plane (Intersect.h:19-21); negative
    or non-finite when parallel or behind."""
    n = plane.normal
    denom = dot(direction, n)
    safe = torch.where(absolute(denom) < 1e-20,
                       torch.where(denom < 0, -1e-20, 1e-20), denom)
    return -(dot(origin, n) + plane.d) / safe


def intersect_ray_sphere(origin, direction, center, radius):
    """Nearest positive hit distance, or -1 on a miss (Intersect.h
    ray-sphere; ``direction`` normalized)."""
    oc = _f32(origin) - _f32(center)
    b = dot(oc, direction)
    c = dot(oc, oc) - torch.square(_f32(radius))
    disc = b * b - c
    sqrt_disc = torch.sqrt(maximum(disc, 0.0))
    t0 = -b - sqrt_disc
    t1 = -b + sqrt_disc
    t = torch.where(t0 > 0.0, t0, t1)
    return torch.where((disc < 0.0) | (t <= 0.0), -1.0, t)


# ---------------------------------------------------------------------------
# Line: y = slope·x + intercept (Math/Line.h)
# ---------------------------------------------------------------------------

class Line(NamedTuple):
    slope: torch.Tensor
    intercept: torch.Tensor

    def evaluate(self, x):
        return self.slope * x + self.intercept

    def signed_distance(self, x, y):
        return y - self.evaluate(x)

    @staticmethod
    def through(p0, p1):
        p0, p1 = _f32(p0), _f32(p1)
        slope = (p1[..., 1] - p0[..., 1]) / (p1[..., 0] - p0[..., 0])
        return Line(slope, p0[..., 1] - slope * p0[..., 0])

    @staticmethod
    def fit(xs, ys):
        """Least-squares fit (Line::fit) over the trailing axis."""
        xs, ys = _f32(xs), _f32(ys)
        mx = torch.mean(xs, dim=-1, keepdim=True)
        my = torch.mean(ys, dim=-1, keepdim=True)
        cov = torch.sum((xs - mx) * (ys - my), dim=-1)
        var = torch.sum(torch.square(xs - mx), dim=-1)
        slope = cov / maximum(var, 1e-20)
        return Line(slope, my[..., 0] - slope * mx[..., 0])


# ---------------------------------------------------------------------------
# Rect (Math/Rect.h): integer / float viewport rectangle
# ---------------------------------------------------------------------------

class Rect(NamedTuple):
    x: int
    y: int
    width: int
    height: int

    @property
    def offset(self):
        return (self.x, self.y)

    @property
    def size(self):
        return (self.width, self.height)


# ---------------------------------------------------------------------------
# ImageSampling (Math/ImageSampling.h): normalized-uv fetches
# ---------------------------------------------------------------------------

def _axis_coords(t, n: int):
    """Texel coordinate of normalized ``t`` with half-texel centres and edge
    clamp → (lower index, upper index, fraction)."""
    x = clip(_f32(t) * n - 0.5, 0.0, n - 1.0)
    i0 = torch.clamp(torch.floor(x).to(torch.int64), 0, n - 1)
    return i0, torch.clamp_max(i0 + 1, n - 1), x - i0.to(x.dtype)


def sample_bilinear(image, u, v):
    """Bilinear fetch at normalized (u, v) with half-texel centres and edge
    clamp, matching ImageSampling::bilinear. image [h, w, c]."""
    h, w = image.shape[0], image.shape[1]
    x0, x1, fx = _axis_coords(u, w)
    y0, y1, fy = _axis_coords(v, h)
    fx, fy = fx[..., None], fy[..., None]
    p00, p01 = image[y0, x0], image[y0, x1]
    p10, p11 = image[y1, x0], image[y1, x1]
    return (1 - fy) * ((1 - fx) * p00 + fx * p01) \
        + fy * ((1 - fx) * p10 + fx * p11)


def sample_trilinear(volume, u, v, w):
    """Trilinear fetch into a [d, h, w_, c] volume: the 8-corner gather of
    ImageSampling::trilinear, broadcast over batched (u, v, w)."""
    d, h, wd = volume.shape[0], volume.shape[1], volume.shape[2]
    x0, x1, fx = _axis_coords(u, wd)
    y0, y1, fy = _axis_coords(v, h)
    z0, z1, fz = _axis_coords(w, d)
    fx, fy, fz = fx[..., None], fy[..., None], fz[..., None]
    lower = (1 - fy) * ((1 - fx) * volume[z0, y0, x0]
                        + fx * volume[z0, y0, x1]) \
        + fy * ((1 - fx) * volume[z0, y1, x0] + fx * volume[z0, y1, x1])
    upper = (1 - fy) * ((1 - fx) * volume[z1, y0, x0]
                        + fx * volume[z1, y0, x1]) \
        + fy * ((1 - fx) * volume[z1, y1, x0] + fx * volume[z1, y1, x1])
    return (1 - fz) * lower + fz * upper
