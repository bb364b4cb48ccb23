"""``mx.sym``: the symbolic front end, the port of the JAX package's
``incubator_mxnet_tpu/symbol/__init__.py``.

One function per name of the op registry ``mx.nd`` uses (aliases
included), generated as the JAX package generates them, builds a graph
node instead of running the op. A tensor parameter left out of the call
(``weight``, ``bias``, ``gamma``, the running statistics, ...) becomes
the implicit variable ``{node}_{param}`` under the JAX package's
whitelist and gating. ``trace_block`` traces a gluon ``HybridBlock`` on
``Variable`` inputs; ``save_block_symbol`` is ``HybridBlock.export``.
"""

from __future__ import annotations

import inspect
import sys as _sys
from typing import Optional

from ..base import MXNetError
from ..ops import registry as _registry
from .symbol import (Group, Symbol, Variable, _Node, _auto_name, fromjson,
                     load, load_json, var)
from . import executor
from .executor import Executor
from . import passes
from .passes import apply_pass, list_passes, register_pass, rewrite

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "fromjson", "Executor", "executor", "save_block_symbol",
           "trace_block", "passes", "apply_pass", "list_passes",
           "register_pass", "rewrite"]

# tensor parameters a call may leave out, made into variables named
# "{node}_{param}" (a whitelist: an attribute slot such as axis or shape
# never becomes a variable)
_IMPLICIT_PARAM_NAMES = frozenset({
    "weight", "bias", "gamma", "beta", "moving_mean", "moving_var",
    "parameters", "state", "state_cell",
})


def _implicit_wanted(p, params, values):
    """Whether the missing tensor parameter ``p`` becomes a variable: a
    required one always; an optional one under its op's gating attribute,
    read at the op's own default (Deconvolution's ``no_bias=True`` makes
    no bias)."""
    if p.default is inspect.Parameter.empty:
        return True
    defaults = {q.name: q.default for q in params
                if q.default is not inspect.Parameter.empty}
    if p.name == "bias":
        return not values.get("no_bias", defaults.get("no_bias", False))
    if p.name == "state_cell":
        return values.get("mode", defaults.get("mode")) == "lstm"
    if p.name == "gamma":              # LeakyReLU: a slope only for prelu
        return values.get("act_type",
                          defaults.get("act_type")) == "prelu"
    return False


def _invoke_symbol(op_name: str, *args, name: Optional[str] = None,
                   **kwargs) -> Symbol:
    """One graph node: the symbolic twin of ``imperative_invoke``."""
    spec = _registry.get(op_name)
    if spec.wrap_list and len(args) == 1 and isinstance(args[0],
                                                        (list, tuple)):
        args = tuple(args[0])
    params = list(inspect.signature(spec.fn).parameters.values())
    has_varargs = any(p.kind is p.VAR_POSITIONAL for p in params)

    from ..name import current as _current_name_mgr
    mgr = _current_name_mgr()
    final_name = mgr.get(name, op_name.lower()) if mgr is not None \
        else name or _auto_name(op_name)

    inputs = []            # (node, output index) in positional order
    attrs = {}
    if has_varargs:
        # concat / stack / add_n: every positional argument is a tensor
        for a in args:
            if not isinstance(a, Symbol):
                raise MXNetError(
                    f"{op_name}: variadic inputs must all be Symbols")
            inputs.append(a._heads[0])
        attrs.update({k: v for k, v in kwargs.items()
                      if not isinstance(v, Symbol)})
    else:
        # the leading run of Symbol-valued parameters are the inputs (ops
        # declare tensors first); everything after the first gap is an
        # attribute
        values = {}
        for i, a in enumerate(args):
            if i >= len(params):
                raise MXNetError(f"{op_name}: too many positional args")
            values[params[i].name] = a
        values.update(kwargs)
        collecting = True
        for p in params:
            if p.kind is inspect.Parameter.VAR_KEYWORD:
                continue
            if p.name not in values:
                if (collecting and p.name in _IMPLICIT_PARAM_NAMES
                        and _implicit_wanted(p, params, values)):
                    # the running statistics are auxiliary states
                    v_attrs = ({"__aux__": 1}
                               if p.name in ("moving_mean", "moving_var")
                               else {})
                    inputs.append(Variable(f"{final_name}_{p.name}",
                                           **v_attrs)._heads[0])
                    continue
                collecting = False
                continue
            v = values.pop(p.name)
            if isinstance(v, Symbol):
                if not collecting:
                    raise MXNetError(
                        f"{op_name}: tensor argument {p.name!r} follows a "
                        "non-tensor gap — pass earlier tensor args too")
                inputs.append(v._heads[0])
            elif v is None and collecting:
                collecting = False     # an optional tensor slot left empty
            else:
                attrs[p.name] = v
                collecting = False
        leftover = [k for k, v in values.items() if isinstance(v, Symbol)]
        if leftover:
            raise MXNetError(
                f"{op_name}: unexpected Symbol kwargs {leftover}")
        attrs.update(values)

    from ..attribute import current_attrs
    node = _Node(op_name, final_name, inputs, attrs,
                 annotations=current_attrs() or None)
    return Symbol([(node, i) for i in range(node.num_outputs())])


def _make_symbol_function(op_name: str, public_name: str):
    def sym_function(*args, **kwargs):
        return _invoke_symbol(op_name, *args, **kwargs)

    sym_function.__name__ = public_name
    sym_function.__qualname__ = public_name
    sym_function.__doc__ = _registry.describe_op(op_name)
    return sym_function


_THIS = _sys.modules[__name__]
for _name in _registry.list_all_names():
    if not hasattr(_THIS, _name):
        setattr(_THIS, _name,
                _make_symbol_function(_registry.get(_name).name, _name))


def trace_block(block, num_inputs: int = 1):
    """Trace an initialized ``HybridBlock`` on ``Variable`` inputs
    (``data``, or ``data0``, ``data1``, ...): ``(symbol, input names)``.
    Parameters become variables under their full names; those with
    ``grad_req='null'`` (running statistics) are auxiliary."""
    from .. import autograd
    input_names = ["data"] if num_inputs == 1 else \
        [f"data{i}" for i in range(num_inputs)]
    with autograd._ModeScope(recording=False, training=False):
        out = block(*[Variable(n) for n in input_names])
    if isinstance(out, (list, tuple)):
        out = Group(list(out))
    return out, input_names


def save_block_symbol(block, path: str, epoch: int = 0,
                      num_inputs: int = 1) -> None:
    """``HybridBlock.export``: ``<path>-symbol.json`` and
    ``<path>-NNNN.params``, the parameters under ``arg:`` / ``aux:``
    keys in MXNet 1.x's ``.params`` layout."""
    from ..ndarray import save as nd_save
    sym, _ = trace_block(block, num_inputs)
    sym.save(f"{path}-symbol.json")
    arg_names = set(sym.list_arguments())
    aux_names = set(sym.list_auxiliary_states())
    payload = {}
    for p in block._collect_params_with_prefix().values():
        if p.name in aux_names:
            payload["aux:" + p.name] = p.data()
        elif p.name in arg_names:
            payload["arg:" + p.name] = p.data()
    nd_save(f"{path}-{epoch:04d}.params", payload, format="mxnet")


from . import contrib  # noqa: E402,F401  (after _make_symbol_function)
