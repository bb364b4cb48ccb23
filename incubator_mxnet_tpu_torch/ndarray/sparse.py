"""Sparse storage types, ``row_sparse`` and ``csr``: the port of the JAX
package's ``incubator_mxnet_tpu/ndarray/sparse.py`` (parity:
``mx.nd.sparse``).

A sparse array *is* an ``NDArray`` whose value (``_data``) is the dense
matrix, so every dense op sees that value; the compact parts ride beside
it (``indices`` / ``data``, and ``indptr`` for CSR). The dense mirror is
built eagerly, at construction, as the JAX classes build it. Indices are
sorted and unique (a row-sparse array's) and held as int32; the torch
index ops take them as int64.

``cast_storage(x, "row_sparse")`` keeps the rows where ``any(row != 0)``:
one ``torch.nonzero`` and one host sync, eager and never inside a
captured graph (the JAX package syncs there too). A looked-up embedding
row whose gradient is exactly zero is therefore not active, as in the
JAX package. ``retain`` returns explicit zero rows for requested rows
that are absent (the JAX package's documented contract). ``dot`` covers
csr @ dense, csr.T @ dense, rsp @ dense and dense @ dense as one dense
product over the mirror, as the JAX ``dot`` does.

What the storage type buys is the lazy optimizer update
(``optimizer.optimizer._rows_update``: only the active rows of the
weight and its state are read and written) and ``KVStore.row_sparse_pull``
(only the requested rows travel).
"""

from __future__ import annotations

import torch

from ..base import MXNetError
from ..context import Context, context_of, current_context
from .ndarray import NDArray, to_torch_dtype

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "csr_matrix", "cast_storage", "retain",
           "zeros", "array", "dot"]


def _device(ctx):
    if ctx is None:
        ctx = current_context()
    if not isinstance(ctx, Context):
        ctx = Context(ctx)
    return ctx.torch_device


def _tensor(x, dtype=None, device=None):
    """``x`` as a tensor: an NDArray's or a tensor's own (moved to
    ``device`` and cast to ``dtype`` when given), anything else through
    ``nd.array`` (its 32-bit defaults) on ``device`` or the current
    context."""
    if isinstance(x, NDArray):
        x = x._data
    if torch.is_tensor(x):
        t = x if device is None else x.to(device)
        return t if dtype is None else t.to(to_torch_dtype(dtype))
    from . import array as nd_array
    ctx = None if device is None else context_of(device)
    return nd_array(x, ctx=ctx, dtype=dtype)._data


class BaseSparseNDArray(NDArray):
    """The surface common to the sparse storage types."""

    __slots__ = ()

    @property
    def stype(self):
        raise NotImplementedError

    def tostype(self, stype):
        if stype == self.stype:
            return self
        if stype == "default":
            return NDArray(self._data)
        return cast_storage(NDArray(self._data), stype)

    def __repr__(self):
        return f"\n<{type(self).__name__} {self.shape} nnz={self.nnz}>"


class RowSparseNDArray(BaseSparseNDArray):
    """Rows at ``indices`` hold ``data``; every other row is zero
    (parity: ``mx.nd.sparse.RowSparseNDArray``)."""

    __slots__ = ("_sp_indices", "_sp_values")

    def __init__(self, data, indices, shape):
        values = _tensor(data)
        idx = _tensor(indices, device=values.device).to(torch.int32)
        shape = tuple(shape)
        if values.shape[0] != idx.shape[0]:
            raise MXNetError(f"row_sparse: {values.shape[0]} value rows vs "
                             f"{idx.shape[0]} indices")
        if values.dim() != len(shape) or tuple(values.shape[1:]) != \
                shape[1:]:
            raise MXNetError(
                f"row_sparse: value row shape {tuple(values.shape[1:])} "
                f"does not match array shape {shape}")
        order = torch.argsort(idx, stable=True)
        self._sp_indices = idx[order]
        self._sp_values = values[order]
        dense = torch.zeros(shape, dtype=values.dtype, device=values.device)
        dense[self._sp_indices.long()] = self._sp_values
        NDArray.__init__(self, dense)

    @classmethod
    def _from_sorted(cls, values, indices, shape, dense=None):
        """Indices already sorted and unique; ``dense`` (when given) is
        the mirror, shared, not copied (the trainer's gradient buffer)."""
        obj = object.__new__(cls)
        if dense is None:
            dense = torch.zeros(tuple(shape), dtype=values.dtype,
                                device=values.device)
            dense[indices.long()] = values
        NDArray.__init__(obj, dense)
        obj._sp_indices = indices
        obj._sp_values = values
        return obj

    @property
    def stype(self):
        return "row_sparse"

    @property
    def indices(self) -> NDArray:
        return NDArray(self._sp_indices)

    @property
    def data(self) -> NDArray:
        return NDArray(self._sp_values)

    @property
    def nnz(self):
        return int(self._sp_indices.shape[0])

    def retain(self, indices):
        return retain(self, indices)


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse row matrix (parity: ``mx.nd.sparse.CSRNDArray``)."""

    __slots__ = ("_sp_data", "_sp_indices", "_sp_indptr")

    def __init__(self, data, indices, indptr, shape, device=None):
        vals = _tensor(data, device=device)
        idx = _tensor(indices, device=vals.device).to(torch.int32)
        ptr = _tensor(indptr, device=vals.device).to(torch.int32)
        shape = tuple(shape)
        if len(shape) != 2:
            raise MXNetError("csr arrays must be 2-D")
        if ptr.shape[0] != shape[0] + 1:
            raise MXNetError(f"csr: indptr length {ptr.shape[0]} != "
                             f"rows+1 {shape[0] + 1}")
        self._sp_data = vals
        self._sp_indices = idx
        self._sp_indptr = ptr
        counts = (ptr[1:] - ptr[:-1]).long()
        rows = torch.repeat_interleave(
            torch.arange(shape[0], device=vals.device), counts)
        dense = torch.zeros(shape, dtype=vals.dtype, device=vals.device)
        dense.index_put_((rows, idx.long()), vals, accumulate=True)
        NDArray.__init__(self, dense)

    @property
    def stype(self):
        return "csr"

    @property
    def data(self) -> NDArray:
        return NDArray(self._sp_data)

    @property
    def indices(self) -> NDArray:
        return NDArray(self._sp_indices)

    @property
    def indptr(self) -> NDArray:
        return NDArray(self._sp_indptr)

    @property
    def nnz(self):
        return int(self._sp_data.shape[0])


# ------------------------------------------------------------------ #
# factories (parity: mx.nd.sparse.*)
# ------------------------------------------------------------------ #
def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from ``(data, indices)`` or a dense source."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        if shape is None:
            raise MXNetError("row_sparse_array((data, indices)) needs shape")
        return RowSparseNDArray(
            _tensor(data, dtype=dtype or "float32", device=_device(ctx)),
            indices, shape)
    dense = _tensor(arg1, dtype=dtype, device=_device(ctx))
    return cast_storage(NDArray(dense), "row_sparse")


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from ``(data, indices, indptr)`` or a dense source."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        if shape is None:
            raise MXNetError(
                "csr_matrix((data, indices, indptr)) needs shape")
        return CSRNDArray(
            _tensor(data, dtype=dtype or "float32", device=_device(ctx)),
            indices, indptr, shape)
    dense = _tensor(arg1, dtype=dtype, device=_device(ctx))
    return cast_storage(NDArray(dense), "csr")


def zeros(stype, shape, ctx=None, dtype="float32"):
    dt, dev = to_torch_dtype(dtype), _device(ctx)
    shape = tuple(shape)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + shape[1:], dtype=dt, device=dev),
            torch.zeros((0,), dtype=torch.int32, device=dev), shape)
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev),
                          torch.zeros((0,), dtype=torch.int32, device=dev),
                          torch.zeros((shape[0] + 1,), dtype=torch.int32,
                                      device=dev), shape)
    if stype == "default":
        return NDArray(torch.zeros(shape, dtype=dt, device=dev))
    raise MXNetError(f"unknown storage type {stype!r}")


def array(source, ctx=None, dtype=None):
    """``mx.nd.sparse.array``: a sparse source keeps its storage type, a
    scipy sparse matrix becomes CSR, anything else is cast to CSR."""
    if isinstance(source, BaseSparseNDArray):
        return source
    try:
        import scipy.sparse as sps
        if sps.issparse(source):
            csr = source.tocsr()
            return CSRNDArray(csr.data, csr.indices, csr.indptr, csr.shape,
                              device=_device(ctx))
    except ImportError:
        pass
    return cast_storage(
        NDArray(_tensor(source, dtype=dtype, device=_device(ctx))), "csr")


def _row_sparse_of(dense: torch.Tensor) -> RowSparseNDArray:
    """The rows of ``dense`` with any nonzero entry, sharing ``dense`` as
    the mirror (one nonzero scan and one host sync)."""
    mask = (dense.reshape(dense.shape[0], -1) != 0).any(dim=1)
    rows = torch.nonzero(mask).reshape(-1)
    return RowSparseNDArray._from_sorted(dense.index_select(0, rows),
                                         rows.to(torch.int32),
                                         dense.shape, dense=dense)


def cast_storage(arr, stype):
    """Convert between storage types (parity: the ``cast_storage`` op).
    Finding the nonzero structure of a dense array is data-dependent, so
    this synchronizes with the host."""
    src = arr._data if isinstance(arr, NDArray) else _tensor(arr)
    if stype == "default":
        return NDArray(src)
    if stype == "row_sparse":
        return _row_sparse_of(src.detach().clone())
    if stype == "csr":
        if src.dim() != 2:
            raise MXNetError("csr arrays must be 2-D")
        dense = src.detach()
        rows, cols = torch.nonzero(dense, as_tuple=True)
        indptr = torch.zeros(dense.shape[0] + 1, dtype=torch.int64,
                             device=dense.device)
        indptr[1:] = torch.cumsum(
            torch.bincount(rows, minlength=dense.shape[0]), 0)
        return CSRNDArray(dense[rows, cols], cols, indptr,
                          tuple(dense.shape))
    raise MXNetError(f"unknown storage type {stype!r}")


def retain(rsp: RowSparseNDArray, indices):
    """Keep only the requested rows (parity: the ``_retain`` op, the
    building block of ``row_sparse_pull``), on the device. Requested rows
    absent from ``rsp`` come back as explicit zero rows, so ``nnz``
    counts the requested rows (the JAX package's contract)."""
    if not isinstance(rsp, RowSparseNDArray):
        raise MXNetError("retain expects a RowSparseNDArray")
    dev = rsp._sp_values.device
    want = torch.sort(_tensor(indices, device=dev).to(torch.int32)).values
    if rsp.nnz == 0 or want.shape[0] == 0:
        return RowSparseNDArray(
            torch.zeros((int(want.shape[0]),) + tuple(rsp.shape[1:]),
                        dtype=rsp._sp_values.dtype, device=dev),
            want, rsp.shape)
    src = rsp._sp_indices
    pos = torch.searchsorted(src, want).clamp_(0, src.shape[0] - 1)
    hit = src[pos] == want
    vals = rsp._sp_values.index_select(0, pos)
    hit = hit.reshape((-1,) + (1,) * (vals.dim() - 1))
    return RowSparseNDArray(torch.where(hit, vals, torch.zeros_like(vals)),
                            want, rsp.shape)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse-aware dot: csr @ dense, csr.T @ dense, rsp @ dense and dense
    @ dense, one dense product over the mirrors (the JAX ``dot``)."""
    a = _tensor(lhs)
    b = _tensor(rhs, device=a.device)
    if transpose_a:
        a = a.t()
    if transpose_b:
        b = b.t()
    return NDArray(a @ b)
