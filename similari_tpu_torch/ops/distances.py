"""Feature distances for ReID gallery matching (mirrors
`similari_tpu/ops/distances.py`).

The matrix forms take queries q[S?, D, F] and galleries g[S?, *G, F] (for
the tracker G = (T, K)), where the leading dims of q are the leading dims
of g, and give [S?, D, *G].  The product is one batched `torch.matmul` in
float32: bf16 inputs are upcast first (a product of two bf16 values is
exact in f32), so the gram form `qn + gn - 2 q.g` never sees a bf16-rounded
product, whose ~4e-3 relative error the cancellation would turn into
phantom tracks.  Norms are taken of the values as given, so for bf16 inputs
of the bf16-rounded values, as the JAX package does.  The f32 product must
run in full f32: `torch.backends.cuda.matmul.allow_tf32` must stay False
(PyTorch's default); TF32 keeps ~3 digits.
"""

from __future__ import annotations

import torch


def _flatten(q: torch.Tensor, g: torch.Tensor):
    """(q f32 [..., D, F], g f32 [..., G, F], the gallery dims *G)."""
    lead = q.dim() - 2
    gallery = g.shape[lead:-1]
    gf = g.reshape(*g.shape[:lead], -1, g.shape[-1]).float()
    return q.float(), gf, gallery


def euclidean_matrix(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """q[S?, D, F] x g[S?, *G, F] -> [S?, D, *G] euclidean distances
    (square root of the clamped gram form)."""
    qf, gf, gallery = _flatten(q, g)
    qn = (qf * qf).sum(dim=-1)
    gn = (gf * gf).sum(dim=-1)
    dot = torch.matmul(qf, gf.transpose(-1, -2))
    d2 = torch.clamp(qn[..., :, None] + gn[..., None, :] - 2.0 * dot,
                     min=0.0)
    return torch.sqrt(d2).reshape(*dot.shape[:-1], *gallery)


def cosine_matrix(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Cosine *similarity* (not 1 - cos), shapes as `euclidean_matrix`."""
    qf, gf, gallery = _flatten(q, g)
    dot = torch.matmul(qf, gf.transpose(-1, -2))
    qn = torch.sqrt((qf * qf).sum(dim=-1))
    gn = torch.sqrt((gf * gf).sum(dim=-1))
    denom = qn[..., :, None] * gn[..., None, :]
    sim = dot / torch.where(denom > 0, denom, 1.0)
    return sim.reshape(*dot.shape[:-1], *gallery)


def _pair(a, b):
    a = torch.as_tensor(a, dtype=torch.float32).reshape(-1)
    b = torch.as_tensor(b, dtype=torch.float32).reshape(-1)
    n = min(a.shape[0], b.shape[0])
    return a[:n], b[:n]


def euclidean(a, b) -> float:
    """Scalar pair distance; truncates to the shorter vector."""
    a, b = _pair(a, b)
    d = a - b
    return float(torch.sqrt((d * d).sum()))


def cosine(a, b) -> float:
    """Scalar pair cosine similarity; truncates to the shorter vector."""
    a, b = _pair(a, b)
    return float((a * b).sum() / torch.sqrt((a * a).sum() * (b * b).sum()))
