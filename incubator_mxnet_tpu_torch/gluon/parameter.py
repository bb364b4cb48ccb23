"""Gluon ``Parameter`` / ``Constant`` / ``ParameterDict``: the port of the
JAX package's ``incubator_mxnet_tpu/gluon/parameter.py``.

A ``Parameter`` holds one ``torch.nn.Parameter`` (``_var``) for its whole
life. Until its shape is known it is torch's ``UninitializedParameter``;
``initialize`` (or the first forward, for a deferred shape) materializes
it in place on the context's device and fills it through the
initializer. Its ``NDArray`` (``data()``) wraps that tensor, and its
gradient buffer (``grad()``) is a persistent ``NDArray`` that ``backward``
writes in place (``autograd.mark_variables``). ``set_data``,
``zero_grad``, ``load_parameters`` and the Trainer's updates write in
place too: CUDA graphs hold the parameter and its gradient by address.
``cast`` and ``reset_ctx`` keep the ``torch.nn.Parameter`` object (they
swap its storage) and make a new gradient buffer; call them before a
trainer captures its graphs.

``grad_req='null'`` parameters (a BatchNorm's running statistics) do not
require grad and have no buffer. ``stype`` / ``grad_stype`` are stored
as the JAX package stores them; ``grad_stype='row_sparse'`` (an
``Embedding(sparse_grad=True)`` table) keeps a dense gradient buffer,
which gluon's Trainer reads as a row-sparse gradient for the lazy
update.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .. import autograd, initializer as _initializer
from ..base import DeferredInitializationError, MXNetError
from ..context import Context, current_context, resolve_device
from ..ndarray import NDArray
from ..ndarray.ndarray import from_host, to_torch_dtype

__all__ = ["Parameter", "Constant", "ParameterDict"]


def _norm_shape(shape):
    if shape is None:
        return None
    if isinstance(shape, int):
        shape = (shape,)
    return tuple(0 if s in (None, 0) else int(s) for s in shape)


def _dtype_name(dtype) -> str:
    t = to_torch_dtype(dtype)
    return str(t).replace("torch.", "")


class Parameter:
    """A trainable (or auxiliary) array with deferred initialization."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        for what, st in (("stype", stype), ("grad_stype", grad_stype)):
            if st not in ("default", "row_sparse", "csr"):
                raise MXNetError(f"parameter {name}: unknown {what} "
                                 f"{st!r}")
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        if self._grad_req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {grad_req!r}")
        self._shape = _norm_shape(shape)
        self.dtype = _dtype_name(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._var = torch.nn.UninitializedParameter(
            requires_grad=self._grad_req != "null")
        self._data: Optional[NDArray] = None
        self._grad: Optional[NDArray] = None
        self._deferred_init = None          # (initializer, ctx)
        self._stype = stype
        # 'row_sparse': gluon's Trainer applies the optimizer to the
        # gradient's active rows only (the lazy update)
        self._grad_stype = grad_stype

    # ------------------------------------------------------------------ #
    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = _norm_shape(new_shape)
        if self._shape is None:
            self._shape = new_shape
            return
        if len(self._shape) != len(new_shape) or any(
                s not in (0, n) for s, n in zip(self._shape, new_shape)):
            raise MXNetError(
                f"parameter {self.name}: inferred shape {new_shape} "
                f"incompatible with declared {self._shape}")
        self._shape = new_shape

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {req!r}")
        self._grad_req = req
        self._var.requires_grad_(req != "null")
        if self._data is not None:
            if req == "null":
                self._grad = None
                self._data._ag_grad = None
            else:
                self._init_grad()

    def _shape_known(self) -> bool:
        return self._shape is not None and all(s > 0 for s in self._shape)

    # ------------------------------------------------------------------ #
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Allocate and fill; deferred while the shape is unknown."""
        if self._data is not None and not force_reinit:
            return
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0] if ctx else None
        if ctx is None:
            ctx = current_context()
        eff_init = init or self.init or default_init or \
            _initializer.Uniform()
        if not self._shape_known():
            if self.allow_deferred_init:
                self._deferred_init = (eff_init, ctx)
                return
            raise MXNetError(
                f"cannot initialize parameter {self.name}: shape "
                f"{self._shape} unknown; set allow_deferred_init=True or "
                f"provide a full shape")
        self._finish_init(eff_init, ctx)

    def _materialize(self, ctx):
        """The tensor on ``ctx``'s device, materialized once."""
        dev = resolve_device(ctx)
        if isinstance(self._var, torch.nn.UninitializedParameter):
            self._var.materialize(self._shape, device=dev,
                                  dtype=to_torch_dtype(self.dtype))
        elif self._var.device != dev:
            self._var.data = self._var.data.to(dev)
        self._data = NDArray(self._var)

    def _finish_init(self, init, ctx):
        self._materialize(ctx)
        _initializer.create(init)(self.name, self._data)
        self._deferred_init = None
        if self._grad_req != "null":
            self._init_grad()

    def _init_grad(self):
        self._grad = NDArray(torch.zeros_like(self._var.detach()))
        # stale until a backward writes it (the Trainer's fresh-grad rule)
        self._grad._fresh = False
        autograd.mark_variables([self._data], [self._grad], self._grad_req)

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            return
        if not self._shape_known():
            raise DeferredInitializationError(
                f"parameter {self.name}: shape still unknown")
        init, ctx = self._deferred_init
        self._finish_init(init, ctx)

    # ------------------------------------------------------------------ #
    def data(self, ctx=None) -> NDArray:
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"parameter {self.name} pending deferred init; run a "
                    f"forward pass with real inputs first")
            raise MXNetError(
                f"parameter {self.name} not initialized; call .initialize()")
        return self._data

    def list_data(self) -> List[NDArray]:
        return [self.data()]

    def grad(self, ctx=None) -> NDArray:
        if self._grad is None:
            raise MXNetError(
                f"parameter {self.name} has no gradient buffer "
                f"(grad_req={self._grad_req!r})")
        return self._grad

    def list_grad(self) -> List[NDArray]:
        return [self.grad()]

    def list_ctx(self) -> List[Context]:
        return [self.data().context]

    def zero_grad(self):
        if self._grad is not None:
            with torch.no_grad():
                self._grad._data.zero_()

    def set_data(self, data):
        """Write ``data`` into the parameter in place (cast to its dtype);
        a parameter not yet allocated takes ``data``'s shape and device."""
        if isinstance(data, NDArray):
            src = data._data
        elif torch.is_tensor(data):
            src = data
        else:
            src = from_host(data)
        if self._data is None:
            self.shape = tuple(src.shape)
            self._materialize(src.device)
            self._deferred_init = None
            if self._grad_req != "null":
                self._init_grad()
        with torch.no_grad():
            self._var.copy_(src.detach())

    def reset_ctx(self, ctx):
        if self._data is not None:
            self._materialize(ctx)
            if self._grad is not None:
                self._init_grad()

    def cast(self, dtype):
        self.dtype = _dtype_name(dtype)
        if self._data is not None:
            self._var.data = self._var.data.to(to_torch_dtype(dtype))
            if self._grad is not None:
                self._init_grad()

    def var(self):
        """The parameter as a ``mx.sym.Variable`` of its name, shape and
        dtype; ``grad_req='null'`` (running statistics) makes it an
        auxiliary state."""
        from ..symbol import Variable
        attrs = {"__aux__": 1} if self.grad_req == "null" else {}
        return Variable(self.name,
                        shape=self._shape if self._shape_known() else None,
                        dtype=str(self.dtype), **attrs)

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self._shape}, "
                f"dtype={self.dtype})")


class Constant(Parameter):
    """A non-differentiable constant parameter (parity: gluon.Constant)."""

    def __init__(self, name, value):
        if not isinstance(value, np.ndarray):
            value = np.asarray(value, dtype=np.float32)
        self._value = value
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=str(value.dtype),
                         init=_initializer.Constant(0.0))

    def _finish_init(self, init, ctx):
        self._materialize(ctx)
        with torch.no_grad():
            self._var.copy_(torch.from_numpy(self._value))
        self._deferred_init = None


class ParameterDict:
    """Ordered name -> Parameter mapping with a prefix (parity:
    ``ParameterDict``)."""

    def __init__(self, prefix="", shared: Optional["ParameterDict"] = None):
        self._prefix = prefix
        self._params: Dict[str, Parameter] = {}
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __contains__(self, name):
        return name in self._params

    def __getitem__(self, name) -> Parameter:
        return self._params[name]

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def get(self, name, **kwargs) -> Parameter:
        """Get or create the parameter ``prefix + name``."""
        full = self._prefix + name
        if self._shared is not None and full in self._shared:
            param = self._shared[full]
        elif full in self._params:
            param = self._params[full]
        else:
            param = Parameter(full, **kwargs)
            self._params[full] = param
            return param
        if kwargs.get("shape") is not None:
            param.shape = _norm_shape(kwargs["shape"])
        self._params.setdefault(full, param)
        return param

    def get_constant(self, name, value=None) -> Constant:
        full = self._prefix + name
        if full not in self._params:
            self._params[full] = Constant(full, value)
        return self._params[full]

    def update(self, other: "ParameterDict"):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(f"duplicate parameter name {k}")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        for param in self._params.values():
            param.initialize(init=None, ctx=ctx, default_init=init,
                             force_reinit=force_reinit)

    def zero_grad(self):
        for p in self._params.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self._params.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        for p in self._params.values():
            setattr(p, name, value)

    def save(self, fname, strip_prefix=""):
        from ..ndarray import save as nd_save
        out = {}
        for name, p in self._params.items():
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            out[name] = p.data()
        nd_save(fname, out)

    def load(self, fname, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        from ..ndarray import load as nd_load
        loaded = nd_load(fname, ctx="cpu")
        if restore_prefix:
            loaded = {restore_prefix + k: v for k, v in loaded.items()}
        for name, p in self._params.items():
            if name in loaded:
                p.set_data(loaded[name])
            elif not allow_missing:
                raise MXNetError(f"parameter {name} missing in {fname}")
        if not ignore_extra:
            extra = set(loaded) - set(self._params)
            if extra:
                raise MXNetError(f"extra parameters in {fname}: "
                                 f"{sorted(extra)}")

    def __repr__(self):
        lines = [f"ParameterDict (prefix={self._prefix!r})"]
        lines += [f"  {p!r}" for p in self._params.values()]
        return "\n".join(lines)
