"""Vectorized sampling helpers and pdfs (port of
``raytracer_tpu/math/sampling.py``).  Every mapping turns uniform [0,1)
samples into points or directions without branches."""

from __future__ import annotations

import math

import torch

from .vec import Vec3, cross, dot, sqrt_rn

PI = math.pi
INV_PI = 1.0 / math.pi
TWO_PI = 2.0 * math.pi


# --- pdfs --------------------------------------------------------------------
def uniform_hemisphere_pdf():
    return 1.0 / (2.0 * PI)


def uniform_sphere_pdf():
    return 1.0 / (4.0 * PI)


def uniform_circle_pdf(radius):
    return 1.0 / (PI * radius * radius)


def sphere_cap_pdf(cos_theta_max):
    return 1.0 / (TWO_PI * torch.clamp_min(1.0 - cos_theta_max, 1e-7))


def cos_hemisphere_pdf(cos_theta):
    # + 0.0 turns the -0.0 that clamp_min keeps into jnp.maximum's +0.0
    return (torch.clamp_min(cos_theta, 0.0) + 0.0) * INV_PI


def pdf_area_to_solid_angle(pdf_a, distance, cos_there):
    """Area-measure pdf to solid angle."""
    return pdf_a * distance * distance / torch.clamp_min(torch.abs(cos_there), 1e-4)


# --- mappings ----------------------------------------------------------------
def sample_circle(u1, u2):
    """Uniform point on the unit disc."""
    theta = TWO_PI * u1
    r = sqrt_rn(u2)
    return r * torch.sin(theta), r * torch.cos(theta)


_HEX_X = (-1.0, 0.5, 0.5, -1.0)
_HEX_Y = (0.0, 0.8660254, -0.8660254, 0.0)


def sample_hexagon(u1, u2, u3):
    """Uniform point on a regular hexagon: ``u3`` picks one of three
    rhombi, (``u1``, ``u2``) place the point in it."""
    table = lambda v: torch.tensor(v, dtype=torch.float32, device=u1.device)
    hx, hy = table(_HEX_X), table(_HEX_Y)
    i = torch.clamp((3.0 * u3).to(torch.int32), 0, 2).long()
    return u1 * hx[i] + u2 * hx[i + 1], u1 * hy[i] + u2 * hy[i + 1]


def sample_regular_polygon(n_blades: int, u1, u2, u3):
    """Uniform point on a regular n-gon (at least a triangle): ``u3`` picks
    a triangular sector, (``u1``, ``u2``) a point in it."""
    n = float(max(n_blades, 3))
    sector = torch.floor(u3 * n)
    a0 = TWO_PI * sector / n
    a1 = TWO_PI * (sector + 1.0) / n
    t = sqrt_rn(u1)
    b0, b1 = 1.0 - t, u2 * t
    return b0 * torch.cos(a0) + b1 * torch.cos(a1), b0 * torch.sin(a0) + b1 * torch.sin(a1)


def sample_square(u1, u2):
    return 2.0 * u1 - 1.0, 2.0 * u2 - 1.0


def sample_triangle_barycentric(u1, u2):
    """(u, v) barycentric coordinates, uniform over the triangle."""
    t = sqrt_rn(u1)
    return 1.0 - t, u2 * t


def sample_sphere(u1, u2) -> Vec3:
    """Uniform direction on the unit sphere."""
    z = 2.0 * u2 - 1.0
    t = sqrt_rn(torch.clamp_min(1.0 - z * z, 0.0))
    theta = PI * (2.0 * u1 - 1.0)
    return Vec3(t * torch.cos(theta), t * torch.sin(theta), z)


def sample_hemisphere(u1, u2) -> Vec3:
    """Uniform direction on the +Z hemisphere."""
    z = u2
    t = sqrt_rn(torch.clamp_min(1.0 - z * z, 0.0))
    theta = TWO_PI * u1
    return Vec3(t * torch.cos(theta), t * torch.sin(theta), z)


def sample_hemisphere_cos(u1, u2) -> Vec3:
    """Cosine-weighted direction on the +Z hemisphere."""
    theta = TWO_PI * u1
    r = sqrt_rn(u2)
    z = sqrt_rn(torch.clamp_min(1.0 - u2, 0.0))
    return Vec3(r * torch.cos(theta), r * torch.sin(theta), z)


def sample_gaussian2(u1, u2):
    """Box-Muller 2D normal — used for the per-pass AA jitter."""
    r = sqrt_rn(torch.clamp_min(-2.0 * torch.log(torch.clamp_min(u1, 1e-12)), 0.0))
    theta = TWO_PI * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def sample_cone(cos_theta_max, u1, u2) -> Vec3:
    """Uniform direction in a +Z cone of half-angle acos(cos_theta_max)."""
    return spherical_to_cartesian(TWO_PI * u2, 1.0 + u1 * (cos_theta_max - 1.0))


# --- orthonormal basis ---------------------------------------------------------
def build_onb(n: Vec3):
    """Tangent/bitangent for normal ``n`` (branchless Duff et al.)."""
    sign = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    t = Vec3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    bt = Vec3(b, sign + n.y * n.y * a, -n.y)
    return t, bt


def local_to_world(v_local: Vec3, t: Vec3, b: Vec3, n: Vec3) -> Vec3:
    return t * v_local.x + b * v_local.y + n * v_local.z


def world_to_local(v_world: Vec3, t: Vec3, b: Vec3, n: Vec3) -> Vec3:
    return Vec3(dot(v_world, t), dot(v_world, b), dot(v_world, n))


def spherical_to_cartesian(phi, cos_theta) -> Vec3:
    """Unit direction at azimuth ``phi`` and polar cosine ``cos_theta``;
    AD-safe at |cos_theta| = 1 (as ``sample_cone``): the square root never
    sees 0, so its gradient stays finite there."""
    s2 = 1.0 - cos_theta * cos_theta
    pos = s2 > 0.0
    sin_theta = torch.where(pos, sqrt_rn(torch.where(pos, s2, 1.0)), 0.0)
    return Vec3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta)


def cartesian_to_spherical_uv(d: Vec3):
    """Direction -> lat-long texture coords (y up: v = theta / pi from +Y,
    u = phi / 2 pi + 0.5)."""
    theta = torch.arccos(torch.clamp(d.y, -1.0, 1.0))
    phi = torch.atan2(d.z, d.x)
    return phi / TWO_PI + 0.5, theta * INV_PI


def spherical_quad_prepare(s: Vec3, ex: Vec3, ey: Vec3, ref: Vec3):
    """Urena spherical-rectangle frame for sampling a quad by solid angle.
    ``s``: corner, ``ex``/``ey``: full edges, ``ref``: shading point.
    Returns an opaque tuple whose last entry is the solid angle S."""
    exl = sqrt_rn(torch.clamp_min(dot(ex, ex), 1e-20))
    eyl = sqrt_rn(torch.clamp_min(dot(ey, ey), 1e-20))
    x = ex * (1.0 / exl)
    y = ey * (1.0 / eyl)
    z = cross(x, y)
    d = s - ref
    z0 = dot(d, z)
    sign = torch.where(z0 > 0.0, -1.0, 1.0)
    z = z * sign
    z0 = z0 * sign
    x0 = dot(d, x)
    y0 = dot(d, y)
    x1 = x0 + exl
    y1 = y0 + eyl

    def edge_normal(ax, ay, bx, by):
        nx = ay * z0 - z0 * by
        ny = z0 * bx - ax * z0
        nz = ax * by - ay * bx
        inv = 1.0 / sqrt_rn(torch.clamp_min(nx * nx + ny * ny + nz * nz, 1e-20))
        return nx * inv, ny * inv, nz * inv

    n0 = edge_normal(x0, y0, x1, y0)
    n1 = edge_normal(x1, y0, x1, y1)
    n2 = edge_normal(x1, y1, x0, y1)
    n3 = edge_normal(x0, y1, x0, y0)

    def acos_c(v):
        return torch.arccos(torch.clamp(v, -1.0 + 1e-7, 1.0 - 1e-7))

    g0 = acos_c(-(n0[0] * n1[0] + n0[1] * n1[1] + n0[2] * n1[2]))
    g1 = acos_c(-(n1[0] * n2[0] + n1[1] * n2[1] + n1[2] * n2[2]))
    g2 = acos_c(-(n2[0] * n3[0] + n2[1] * n3[1] + n2[2] * n3[2]))
    g3 = acos_c(-(n3[0] * n0[0] + n3[1] * n0[1] + n3[2] * n0[2]))
    b0 = n0[2]
    b1 = n2[2]
    k = 2.0 * PI - g2 - g3
    big_s = torch.clamp_min(g0 + g1 - k, 1e-7)
    return (x, y, z, z0, x0, y0, x1, y1, b0, b1, k, big_s)


def spherical_quad_sample(quad, ref: Vec3, u, v):
    """Sample the quad uniformly by solid angle: (world point, 1/S)."""
    x, y, z, z0, x0, y0, x1, y1, b0, b1, k, big_s = quad
    au = u * big_s + k
    sin_au = torch.sin(au)
    fu = (torch.cos(au) * b0 - b1) / torch.where(torch.abs(sin_au) > 1e-7, sin_au, 1e-7)
    cu = torch.sign(fu) / sqrt_rn(torch.clamp_min(fu * fu + b0 * b0, 1e-20))
    cu = torch.clamp(cu, -1.0 + 1e-7, 1.0 - 1e-7)
    xu = -(cu * z0) / sqrt_rn(1.0 - cu * cu)
    xu = torch.minimum(torch.maximum(xu, x0), x1)
    d2 = xu * xu + z0 * z0
    d = sqrt_rn(torch.clamp_min(d2, 1e-20))
    h0 = y0 / sqrt_rn(torch.clamp_min(d2 + y0 * y0, 1e-20))
    h1 = y1 / sqrt_rn(torch.clamp_min(d2 + y1 * y1, 1e-20))
    hv = h0 + v * (h1 - h0)
    hv2 = hv * hv
    yv = torch.where(
        hv2 < 1.0 - 1e-6,
        hv * d / sqrt_rn(torch.clamp_min(1.0 - hv2, 1e-12)),
        y1,
    )
    p = ref + x * xu + y * yv + z * z0
    return p, 1.0 / big_s
