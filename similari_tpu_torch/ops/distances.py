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
    """(q f32 [..., D, F], g f32 [..., G, F])."""
    lead = q.dim() - 2
    return q.float(), g.reshape(*g.shape[:lead], -1, g.shape[-1]).float()


def gram(q: torch.Tensor, g: torch.Tensor, kind: str):
    """(dot [S?, D, G], query norms [S?, D], gallery norms [S?, G]) in f32,
    G the gallery dims flattened: squared norms for "euclidean", norms for
    "cosine".  `from_gram` turns them into the matrix."""
    qf, gf = _flatten(q, g)
    # the norms first: their [.., G, F] squares are freed before the
    # product is allocated, so the two never add up in the peak memory
    qn = (qf * qf).sum(dim=-1)
    gn = (gf * gf).sum(dim=-1)
    dot = torch.matmul(qf, gf.transpose(-1, -2))
    if kind == "cosine":
        qn, gn = torch.sqrt(qn), torch.sqrt(gn)
    return dot, qn, gn


def from_gram(dot: torch.Tensor, qn: torch.Tensor, gn: torch.Tensor,
              kind: str) -> torch.Tensor:
    """[S?, D, G] euclidean distances (square root of the clamped gram
    form) or cosine similarities from `gram`'s parts."""
    if kind == "euclidean":
        return torch.sqrt(torch.clamp(
            qn[..., :, None] + gn[..., None, :] - 2.0 * dot, min=0.0))
    denom = qn[..., :, None] * gn[..., None, :]
    return dot / torch.where(denom > 0, denom, 1.0)


def euclidean_matrix(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """q[S?, D, F] x g[S?, *G, F] -> [S?, D, *G] euclidean distances."""
    gallery = g.shape[q.dim() - 2:-1]
    dot, qn, gn = gram(q, g, "euclidean")
    return from_gram(dot, qn, gn, "euclidean").reshape(*dot.shape[:-1],
                                                       *gallery)


def cosine_matrix(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Cosine *similarity* (not 1 - cos), shapes as `euclidean_matrix`."""
    gallery = g.shape[q.dim() - 2:-1]
    dot, qn, gn = gram(q, g, "cosine")
    return from_gram(dot, qn, gn, "cosine").reshape(*dot.shape[:-1],
                                                    *gallery)


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
