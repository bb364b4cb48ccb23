"""Linear-algebra operators: the port of the JAX package's
``incubator_mxnet_tpu/ops/linalg.py`` (``nd.linalg.<name>`` is
``linalg_<name>``), on ``torch.linalg``: batched over leading axes,
triangular inputs lower by default, only the named triangle read.

``gesvd``, ``syevd`` and ``gelqf`` return factors whose signs are the
solver's choice (LAPACK on the CPU, cuSOLVER on the card): compare them
by reconstruction and orthogonality, not entry by entry.
"""

from __future__ import annotations

import torch

from .registry import register


def _maybe_t(x, t):
    return x.mT if t else x


def _solve_tri(A, B, lower, trans):
    """op(A) X = B for triangular A (op(A) = A^T when ``trans``)."""
    if trans:
        return torch.linalg.solve_triangular(A.mT, B, upper=lower)
    return torch.linalg.solve_triangular(A, B, upper=not lower)


@register("linalg_gemm")
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0, axis=-2):
    """alpha * op(A) @ op(B) + beta * C."""
    return alpha * (_maybe_t(A, transpose_a) @ _maybe_t(B, transpose_b)) \
        + beta * C


@register("linalg_gemm2")
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                 axis=-2):
    """alpha * op(A) @ op(B)."""
    return alpha * (_maybe_t(A, transpose_a) @ _maybe_t(B, transpose_b))


@register("linalg_potrf")
def linalg_potrf(A):
    """The Cholesky factor L, A = L L^T."""
    return torch.linalg.cholesky(A)


@register("linalg_potri")
def linalg_potri(L):
    """A^-1 from A's Cholesky factor L: (L L^T)^-1."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device) \
        .expand(L.shape)
    Linv = _solve_tri(L, eye, lower=True, trans=False)
    return Linv.mT @ Linv


@register("linalg_trsm")
def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """Solve op(A) X = alpha B, or X op(A) = alpha B (``rightside``), for
    triangular A."""
    if rightside:
        sol = _solve_tri(A, B.mT, lower=lower, trans=not transpose)
        return alpha * sol.mT
    return alpha * _solve_tri(A, B, lower=lower, trans=transpose)


@register("linalg_trmm")
def linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """alpha op(A) B (B op(A) with ``rightside``), A read as triangular."""
    tri = _maybe_t(torch.tril(A) if lower else torch.triu(A), transpose)
    return alpha * (B @ tri if rightside else tri @ B)


@register("linalg_syrk")
def linalg_syrk(A, transpose=False, alpha=1.0):
    """alpha A A^T (A^T A with ``transpose``)."""
    return alpha * (A.mT @ A if transpose else A @ A.mT)


@register("linalg_gelqf", num_outputs=2)
def linalg_gelqf(A):
    """LQ factorization A = L Q, Q with orthonormal rows: (L, Q)."""
    Qt, Rt = torch.linalg.qr(A.mT, mode="reduced")
    return Rt.mT, Qt.mT


@register("linalg_syevd", num_outputs=2)
def linalg_syevd(A):
    """Symmetric eigendecomposition: (U with eigenvectors as rows,
    eigenvalues ascending)."""
    w, v = torch.linalg.eigh(A)
    return v.mT, w


@register("linalg_gesvd", num_outputs=3)
def linalg_gesvd(A):
    """A = U diag(L) V, V's rows the right singular vectors: (U, L, V)."""
    u, s, vt = torch.linalg.svd(A, full_matrices=False)
    return u, s, vt


@register("linalg_sumlogdiag")
def linalg_sumlogdiag(A):
    return torch.sum(torch.log(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1)


@register("linalg_extractdiag")
def linalg_extractdiag(A, offset=0):
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


@register("linalg_makediag")
def linalg_makediag(a, offset=0):
    return torch.diag_embed(a, offset=offset)


def _trian_indices(n, offset, lower, device):
    """The triangle's (rows, cols), row-major: offset < 0 the lower
    triangle at that diagonal, offset > 0 the upper, offset == 0 as
    ``lower`` says."""
    if offset < 0 or (offset == 0 and lower):
        return torch.tril_indices(n, n, offset, device=device)
    return torch.triu_indices(n, n, offset, device=device)


@register("linalg_extracttrian")
def linalg_extracttrian(A, offset=0, lower=True):
    """A triangle packed into a vector."""
    r, c = _trian_indices(A.shape[-1], offset, lower, A.device)
    return A[..., r, c]


@register("linalg_maketrian")
def linalg_maketrian(a, offset=0, lower=True):
    """``extracttrian``'s vector back into an n x n matrix (m(m+1)/2
    entries, n = m + |offset|)."""
    m = int((-1 + (1 + 8 * a.shape[-1]) ** 0.5) / 2)
    n = m + abs(offset)
    r, c = _trian_indices(n, offset, lower, a.device)
    out = torch.zeros(a.shape[:-1] + (n, n), dtype=a.dtype, device=a.device)
    out[..., r, c] = a
    return out


@register("linalg_slogdet", num_outputs=2)
def linalg_slogdet(A):
    sign, ld = torch.linalg.slogdet(A)
    return sign, ld


@register("linalg_det")
def linalg_det(A):
    return torch.linalg.det(A)


@register("linalg_inverse")
def linalg_inverse(A):
    return torch.linalg.inv(A)
