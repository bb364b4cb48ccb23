"""Gluon ``Block`` / ``HybridBlock`` / ``CachedOp``: the port of the JAX
package's ``incubator_mxnet_tpu/gluon/block.py``.

``Block`` subclasses ``torch.nn.Module``: a child block set as an
attribute is a registered submodule, and a gluon ``Parameter`` set as an
attribute registers its ``torch.nn.Parameter`` under the same name, so
``named_parameters()``, ``state_dict()`` (whose keys are gluon's
structural names, ``_collect_params_with_prefix``) and
``parallel.SPMDTrainer`` see the block as any module. Gluon's surface is
kept: ``name_scope`` and the per-class prefix counters (so
``collect_params()`` keys equal the JAX block's), ``initialize``,
``collect_params(select)``, ``cast``, hooks, ``summary`` and
``save_parameters`` / ``load_parameters``. ``__call__`` runs gluon's
hooks and ``forward`` (not ``nn.Module``'s hook machinery).

``HybridBlock.hybrid_forward(F, x, ...)`` receives ``F`` = ``mx.nd`` and
the block's parameters as keyword ``NDArray``s. ``hybridize()`` keeps the
JAX ``CachedOp``'s per-signature cache (input shapes and dtypes,
parameter shapes and dtypes, the positions and reprs of non-array
arguments, the training flag), so ``len(block._cached_op._cache)`` equals
the JAX block's on the same calls; an entry runs the block's eager body
(one CUDA graph per signature is later work). Nested hybridized blocks
inline into the outer one, as in the JAX package.

Called on ``mx.sym.Symbol`` inputs, a ``HybridBlock`` builds a graph:
``hybrid_forward`` receives ``F`` = ``mx.sym`` and each parameter as its
``Parameter.var()``. ``export`` writes that graph and the parameters
(``symbol.save_block_symbol``); ``SymbolBlock`` (``SymbolBlock.imports``)
runs a saved graph as a block through ``symbol.executor.evaluate``, so
``autograd.record()`` sees its ops. ``optimize_for`` hybridizes and warms
the cache.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional, Tuple

import torch

from .. import autograd
from ..base import DeferredInitializationError, MXNetError
from ..ndarray import NDArray
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock", "CachedOp", "nd"]

from .. import ndarray as nd  # noqa: E402  (the F of hybrid_forward)

_naming = threading.local()


class _BlockScope:
    """Name manager: automatic prefixes ``dense0_``, ``dense1_`` ... per
    class within the enclosing scope (process-wide counters at the top
    level, as in the JAX package)."""

    def __init__(self, block):
        self._block = block
        self._counter: Dict[str, int] = {}

    @staticmethod
    def create(prefix, params, hint) -> Tuple[str, ParameterDict]:
        current = getattr(_naming, "current", None)
        if current is None:
            if prefix is None:
                counter = getattr(_naming, "counter", {})
                count = counter.get(hint, 0)
                counter[hint] = count + 1
                _naming.counter = counter
                prefix = f"{hint}{count}_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, shared=params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = f"{hint}{count}_"
        if params is None:
            params = ParameterDict(current._block.params.prefix + prefix)
        else:
            params = ParameterDict(params.prefix, shared=params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        self._old = getattr(_naming, "current", None)
        _naming.current = self
        return self

    def __exit__(self, *exc):
        _naming.current = self._old


class Block(torch.nn.Module):
    """Base class of all layers and models (parity: gluon.Block)."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        hint = self._alias()
        self._prefix, self._params = _BlockScope.create(prefix, params, hint)
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children: Dict[str, "Block"] = {}
        self._reg_params: Dict[str, Parameter] = {}
        self._gluon_hooks: List = []
        self._gluon_pre_hooks: List = []

    def _alias(self) -> str:
        return type(self).__name__.lower()

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            children = self.__dict__.get("_children")
            if children is not None:
                children[name] = value
            super().__setattr__(name, value)
        elif isinstance(value, Parameter):
            reg = self.__dict__.get("_reg_params")
            if reg is not None:
                reg[name] = value
            # torch's view: the parameter's tensor under the same name
            self._parameters[name] = value._var
            object.__setattr__(self, name, value)
        else:
            super().__setattr__(name, value)

    @property
    def prefix(self) -> str:
        return self._prefix

    @property
    def name(self) -> str:
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self) -> ParameterDict:
        return self._params

    def collect_params(self, select: Optional[str] = None) -> ParameterDict:
        """Every parameter of the block and its descendants, optionally
        filtered by a regex (parity: Block.collect_params)."""
        ret = ParameterDict(self._params.prefix)
        pattern = re.compile(select) if select is not None else None
        for name, p in self.params.items():
            if pattern is None or pattern.match(name):
                ret._params[name] = p
        for child in self._children.values():
            for name, p in child.collect_params(select).items():
                if name not in ret._params:
                    ret._params[name] = p
        for p in self._reg_params.values():
            if p.name not in ret._params and (
                    pattern is None or pattern.match(p.name)):
                ret._params[p.name] = p
        return ret

    def _collect_params_with_prefix(self, prefix="") -> Dict[str, Parameter]:
        """Structural names ('0.weight', 'bert.layer0.ln1.gamma'): the
        names ``save_parameters`` writes and ``state_dict`` uses."""
        if prefix:
            prefix += "."
        ret = {prefix + name: p for name, p in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    # ------------------------------------------------------------------ #
    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        self.collect_params().initialize(init=init, ctx=ctx, verbose=verbose,
                                         force_reinit=force_reinit)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for p in self.params.values():
            p.cast(dtype)
        for p in self._reg_params.values():
            if p.name not in self.params:
                p.cast(dtype)

    def register_forward_hook(self, hook):
        """``hook(block, args, output)`` after each forward."""
        self._gluon_hooks.append(hook)

    def register_forward_pre_hook(self, hook):
        """``hook(block, args)`` before each forward."""
        self._gluon_pre_hooks.append(hook)

    def register_child(self, block, name=None):
        name = name or str(len(self._children))
        self._children[name] = block
        self.add_module(name, block)

    # ------------------------------------------------------------------ #
    def save_parameters(self, filename, deduplicate=False, format="mxtpu"):
        """Save by structural name (``format="mxnet"`` writes MXNet 1.x's
        ``.params`` layout)."""
        from ..ndarray import save as nd_save
        params = self._collect_params_with_prefix()
        nd_save(filename, {k: p.data() for k, p in params.items()},
                format=format)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False):
        """Load by structural name, writing each parameter in place (a
        parameter not yet allocated lands on ``ctx``, else the current
        context)."""
        from ..ndarray import load as nd_load
        loaded = nd_load(filename, ctx="cpu")
        if loaded and any(k.startswith(("arg:", "aux:")) for k in loaded):
            loaded = {k.split(":", 1)[1] if k.startswith(("arg:", "aux:"))
                      else k: v for k, v in loaded.items()}
        params = self._collect_params_with_prefix()
        for name, p in params.items():
            if name in loaded:
                if p._data is None:
                    p.shape = loaded[name].shape
                    p._materialize(ctx)
                    if p._grad_req != "null":
                        p._init_grad()
                    p._deferred_init = None
                p.set_data(loaded[name])
            elif not allow_missing:
                raise MXNetError(f"parameter {name} missing in {filename}")
        if not ignore_extra:
            extra = set(loaded) - set(params)
            if extra:
                raise MXNetError(
                    f"extra parameters in {filename}: {sorted(extra)}")

    # ------------------------------------------------------------------ #
    def __call__(self, *args, **kwargs):
        for hook in self._gluon_pre_hooks:
            hook(self, args)
        out = self.forward(*args, **kwargs)
        for hook in self._gluon_hooks:
            hook(self, args, out)
        return out

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def summary(self, *inputs):
        """Print each layer's output shape on ``inputs``."""
        lines = [f"{'Layer':<40}{'Output':<20}"]
        hooks = []

        def add_hook(block):
            if not isinstance(block, Block):
                return

            def hook(blk, ins, out):
                shape = out.shape if hasattr(out, "shape") else "?"
                lines.append(f"{blk.name:<40}{str(shape):<20}")
            block._gluon_hooks.append(hook)
            hooks.append((block, hook))

        self.apply(add_hook)
        try:
            self(*inputs)
        finally:
            for blk, hook in hooks:
                blk._gluon_hooks.remove(hook)
        print("\n".join(lines))

    def __repr__(self):
        lines = [type(self).__name__ + "("]
        for name, child in self._children.items():
            child_repr = repr(child).replace("\n", "\n  ")
            lines.append(f"  ({name}): {child_repr}")
        lines.append(")")
        return "\n".join(lines)


def _flatten(args, flat):
    """NDArrays and other leaves of nested lists / tuples / dicts, None
    dropped (a JAX pytree's leaves)."""
    if args is None:
        return flat
    if isinstance(args, (list, tuple)):
        for a in args:
            _flatten(a, flat)
    elif isinstance(args, dict):
        for k in sorted(args):
            _flatten(args[k], flat)
    else:
        flat.append(args)
    return flat


_trace_state = threading.local()


class _hybrid_scope:
    """Inside a cached op's call: nested hybridized blocks inline into the
    outer one instead of keeping caches of their own."""

    def __enter__(self):
        self._prev = getattr(_trace_state, "active", False)
        _trace_state.active = True
        return self

    def __exit__(self, *exc):
        _trace_state.active = self._prev


def in_hybrid_trace() -> bool:
    return getattr(_trace_state, "active", False)


class CachedOp:
    """A hybridized block's per-signature cache. An entry is made at a
    signature's first call; each call runs the block's eager body."""

    def __init__(self, block: "HybridBlock"):
        self.block = block
        self._cache = set()

    @staticmethod
    def signature(params, args, training):
        """The JAX ``CachedOp``'s cache key."""
        flat = _flatten(args, [])
        arrays = [x for x in flat if isinstance(x, NDArray)]
        return (
            tuple((a.shape, str(a.dtype)) for a in arrays),
            tuple((p.shape, str(p.dtype)) for p in params),
            tuple(i for i, x in enumerate(flat)
                  if not isinstance(x, NDArray)),
            tuple(repr(x) for x in flat if not isinstance(x, NDArray)),
            training)

    def __call__(self, *args):
        params = [p.data() for p in self.block.collect_params().values()]
        self._cache.add(self.signature(params, args, autograd.is_training()))
        with _hybrid_scope():
            return self.block.hybrid_call(*args)


class HybridBlock(Block):
    """A Block written as ``hybrid_forward(F, x, *args, **params)`` (parity:
    gluon.HybridBlock)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_op: Optional[CachedOp] = None
        self._flags = {}

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        self._active = active
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape, **kwargs)
        if not active:
            self._cached_op = None
        super().hybridize(active, **kwargs)

    def infer_shape(self, *args):
        """Complete deferred parameter shapes from the inputs; the layers
        that defer override it."""
        raise MXNetError(
            f"{type(self).__name__}: cannot infer parameter shapes; "
            f"provide explicit shapes (in_units/in_channels) or override "
            f"infer_shape()")

    def _ensure_params_ready(self, *args):
        if any(p._deferred_init is not None
               for p in self._reg_params.values()):
            self.infer_shape(*args)
            for p in self._reg_params.values():
                p._finish_deferred_init()

    def hybrid_call(self, *args):
        """The forward: deferred initialization, then ``hybrid_forward``
        with the parameters bound."""
        self._ensure_params_ready(*args)
        try:
            kwargs = {name: p.data() for name, p in self._reg_params.items()}
        except DeferredInitializationError:
            self._ensure_params_ready(*args)
            kwargs = {name: p.data() for name, p in self._reg_params.items()}
        return self.hybrid_forward(nd, *args, **kwargs)

    def forward(self, *args):
        from ..symbol.symbol import Symbol
        if any(isinstance(a, Symbol) for a in args):
            # symbolic composition: a graph node instead of a computation
            if type(self).hybrid_forward is not HybridBlock.hybrid_forward:
                from .. import symbol as sym_mod
                kwargs = {name: p.var()
                          for name, p in self._reg_params.items()}
                return self.hybrid_forward(sym_mod, *args, **kwargs)
            return self.hybrid_call(*args)     # containers: children do it
        if self._active and not in_hybrid_trace():
            for p in self.collect_params().values():
                if p._deferred_init is not None:
                    return self.hybrid_call(*args)
            if self._cached_op is None:
                self._cached_op = CachedOp(self)
            return self._cached_op(*args)
        return self.hybrid_call(*args)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def export(self, path, epoch=0):
        """``<path>-symbol.json`` and ``<path>-NNNN.params`` (parity:
        ``HybridBlock.export``)."""
        from ..symbol import save_block_symbol
        save_block_symbol(self, path, epoch)

    def optimize_for(self, x, backend=None, **kwargs):
        """Hybridize and run once on ``x`` (the port has no other
        backend)."""
        self.hybridize()
        self(x)


class SymbolBlock(HybridBlock):
    """A block that runs a symbolic graph (parity: ``gluon.SymbolBlock``):
    ``outputs`` a Symbol, ``inputs`` its input variables (or names), and
    ``params`` (optional) the arrays or Parameters of its other
    variables."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=None)
        from ..symbol import Variable
        self._sym_outputs = outputs
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        self._sym_inputs = [Variable(n) if isinstance(n, str) else n
                            for n in inputs]
        for name, p in (params.items() if params is not None else ()):
            data = p if isinstance(p, NDArray) else p.data()
            self._add_param(name, data, getattr(p, "grad_req", "write"))

    def _add_param(self, name, data: NDArray, grad_req):
        p = Parameter(name, shape=data.shape, dtype=str(data.dtype),
                      grad_req=grad_req)
        p.set_data(data)
        self._reg_params[name] = p
        self._params._params[name] = p
        self._parameters[name] = p._var

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A block from ``export``'s files (either package's, or MXNet
        1.x's): ``aux:`` arrays become ``grad_req='null'``
        parameters."""
        from ..ndarray import load as nd_load
        from ..symbol import load as sym_load
        block = SymbolBlock(sym_load(symbol_file), input_names)
        params = nd_load(param_file, ctx=ctx) if param_file else {}
        for name, data in params.items():
            block._add_param(name.split(":", 1)[-1], data,
                             "null" if name.startswith("aux:") else "write")
        return block

    def hybrid_call(self, *args):
        from ..symbol.executor import evaluate
        bindings = {v.name: a for v, a in zip(self._sym_inputs, args)}
        for name, p in self._reg_params.items():
            bindings[name] = p.data()
        return evaluate(self._sym_outputs, bindings)
