"""Poincare-ball geometry on torch tensors.

Port of ``halo_tpu/ops/hyperbolic.py`` with the same clamps and the same
formulas, channel-last (the channel axis is ``dim=-1`` by default).
``c > 0`` is the ball curvature magnitude: the ball has radius 1/sqrt(c).
"""

from __future__ import annotations

import math

import torch

# Projection epsilon of the hyperbolic MLR head.
PROJ_EPS = 1e-3
# Ball-boundary epsilon of geoopt.project for float64 inputs.
BALL_EPS = 1e-5
_MIN_NORM = 1e-15


def _safe_norm(x, dim=-1, keepdim=True):
    """L2 norm, clamped away from zero at 1e-15."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp(sq, min=_MIN_NORM * _MIN_NORM))


def artanh(x, eps=None):
    """atanh with the input clamped inside (-1, 1)."""
    if eps is None:
        eps = 1e-7 if x.dtype == torch.float32 else 1e-15
    return torch.atanh(torch.clamp(x, -1 + eps, 1 - eps))


def project(x, c=1.0, dim=-1, eps=BALL_EPS):
    """Clip points to the open ball of radius (1-eps)/sqrt(c)."""
    norm = _safe_norm(x, dim=dim)
    maxnorm = (1.0 - eps) / math.sqrt(c)
    return torch.where(norm > maxnorm, x / norm * maxnorm, x)


def expmap0(u, c=1.0, dim=-1):
    """Exponential map at the origin: tanh(sqrt(c)|u|) u / (sqrt(c)|u|)."""
    sqrt_c = math.sqrt(c)
    norm = _safe_norm(u, dim=dim)
    return torch.tanh(sqrt_c * norm) / (sqrt_c * norm) * u


def expmap(u, c=1.0, dim=-1, eps=BALL_EPS):
    """expmap0 followed by ball projection."""
    return project(expmap0(u, c=c, dim=dim), c=c, dim=dim, eps=eps)


def logmap0(y, c=1.0, dim=-1):
    """Logarithm map at the origin: artanh(sqrt(c)|y|) y / (sqrt(c)|y|)."""
    sqrt_c = math.sqrt(c)
    norm = _safe_norm(y, dim=dim)
    return artanh(sqrt_c * norm) * y / (sqrt_c * norm)


def dist0(x, c=1.0, dim=-1, keepdim=False):
    """Poincare distance to the origin: 2/sqrt(c) artanh(sqrt(c)|x|)."""
    sqrt_c = math.sqrt(c)
    norm = _safe_norm(x, dim=dim, keepdim=keepdim)
    return 2.0 / sqrt_c * artanh(sqrt_c * norm)


def mobius_add(x, y, c=1.0, dim=-1):
    """Mobius addition x (+)_c y on the Poincare ball."""
    x2 = torch.sum(x * x, dim=dim, keepdim=True)
    y2 = torch.sum(y * y, dim=dim, keepdim=True)
    xy = torch.sum(x * y, dim=dim, keepdim=True)
    num = (1 + 2 * c * xy + c * y2) * x + (1 - c * x2) * y
    denom = 1 + 2 * c * xy + c * c * x2 * y2
    return num / torch.clamp(denom, min=_MIN_NORM)


def dist(x, y, c=1.0, dim=-1, keepdim=False):
    """Poincare distance: 2/sqrt(c) artanh(sqrt(c)|(-x) (+) y|)."""
    sqrt_c = math.sqrt(c)
    diff_norm = _safe_norm(mobius_add(-x, y, c=c, dim=dim), dim=dim,
                           keepdim=keepdim)
    return 2.0 / sqrt_c * artanh(sqrt_c * diff_norm)


def cosine_distance(x, y, dim=-1):
    """2 - 2 cos(x, y)."""
    xn = x / _safe_norm(x, dim=dim)
    yn = y / _safe_norm(y, dim=dim)
    return 2.0 - 2.0 * torch.sum(xn * yn, dim=dim)


def hyper_mlr_logits(x, p_mlr, a_mlr, c=1.0):
    """Poincare-ball MLR logits over channel-last maps.

    x: (..., C) on-ball embeddings; p_mlr, a_mlr: (O, C) class prototypes
    and directions. Returns (..., O). The two channel contractions are
    plain matmuls; everything else is elementwise, as in
    ``halo_tpu.ops.hyperbolic.hyper_mlr_logits``.
    """
    dtype = x.dtype
    cc = torch.tensor(c, dtype=dtype, device=x.device)
    sqrt_c = torch.sqrt(cc)
    eps = 1e-12

    xx = torch.sum(x * x, dim=-1, keepdim=True)            # (..., 1)
    pp = torch.sum(p_mlr * p_mlr, dim=-1)                  # (O,)
    px = -torch.matmul(x, p_mlr.t())                       # (..., O)

    sqsq = cc * xx * cc * pp
    alpha_num = 1 + 2 * cc * px + cc * xx
    beta_num = 1 - cc * pp
    denom = torch.clamp(1 + 2 * cc * px + sqsq, min=eps)
    alpha = alpha_num / denom
    beta = beta_num / denom

    mobaddnorm = alpha * alpha * pp + beta * beta * xx + 2 * alpha * beta * px
    maxnorm = (1.0 - PROJ_EPS) / sqrt_c
    sqrtmob = torch.sqrt(torch.clamp(mobaddnorm, min=1e-24))
    one = torch.ones((), dtype=dtype, device=x.device)
    project_normalized = torch.where(
        sqrtmob > maxnorm, maxnorm / torch.clamp(sqrtmob, min=eps), one)
    mobaddnormprojected = torch.where(
        sqrtmob < maxnorm, mobaddnorm, maxnorm * maxnorm)

    a_norm = torch.sqrt(torch.clamp(torch.sum(a_mlr * a_mlr, dim=-1), min=0.0))
    normed_a = a_mlr / torch.clamp(a_norm, min=1e-12)[:, None]

    xdota = beta * torch.matmul(x, normed_a.t())
    pdota = alpha * torch.sum(-p_mlr * normed_a, dim=-1)
    mobdota = (xdota + pdota) * project_normalized

    lamb_px = 2.0 / torch.clamp(1 - cc * mobaddnormprojected, min=eps)
    sineterm = sqrt_c * mobdota * lamb_px
    return (2.0 / sqrt_c) * a_norm * torch.asinh(sineterm)


def embedding_metrics(x, y, c=1.0, dim=-1):
    """Euclidean and hyperbolic comparison metrics of two embedding
    batches (an analysis utility, off the training path): 'mse',
    'cosine_dist', 'radius_x'/'radius_y' (ball norms after expmap),
    'ang_e' (degrees between the mapped embeddings) and 'poincare_dist'."""
    mse = torch.mean((x - y) ** 2)
    cos = cosine_distance(x, y, dim=dim)
    x_h = expmap(x, c=c, dim=dim)
    y_h = expmap(y, c=c, dim=dim)
    radius_x = _safe_norm(x_h, dim=dim, keepdim=False)
    radius_y = _safe_norm(y_h, dim=dim, keepdim=False)
    xn = x_h / radius_x.unsqueeze(dim)
    yn = y_h / radius_y.unsqueeze(dim)
    cosang = torch.clamp(torch.sum(xn * yn, dim=dim), -1.0, 1.0)
    ang_e = torch.arccos(cosang) * (180.0 / math.pi)
    return {"mse": mse, "cosine_dist": cos, "radius_x": radius_x,
            "radius_y": radius_y, "ang_e": ang_e,
            "poincare_dist": dist(x_h, y_h, c=c, dim=dim)}
