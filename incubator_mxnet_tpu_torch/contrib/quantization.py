"""Post-training int8 quantization: the port of the JAX package's
``incubator_mxnet_tpu/contrib/quantization.py`` (parity:
python/mxnet/contrib/quantization.py and the graph pass in
src/operator/quantization/quantize_graph_pass.cc).

The reference's flow: calibration batches run through the float net
while forward hooks collect each layer's input statistics; thresholds
are chosen (``naive`` min / max or ``entropy`` KL-optimal); Dense /
Conv2D layers are swapped for int8 twins over the registry's quantized
ops (``ops/quantization.py``: cuBLASLt's int8 product on the card). The
statistics, thresholds and int8 weights are computed in numpy, as the
JAX package computes them, so they are bitwise its own."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as _np

from .. import ndarray as _nd
from ..base import MXNetError
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..ndarray import NDArray

__all__ = ["quantize_net", "calib_thresholds_entropy", "QuantizedDense",
           "QuantizedConv2D"]


def calib_thresholds_entropy(hist, bin_edges, num_quantized_bins=255):
    """KL-divergence-optimal |threshold| from an activation histogram
    (the reference's LayerHistogramCollector + _get_optimal_threshold;
    TensorRT-style)."""
    hist = hist.astype(_np.float64)
    num_bins = len(hist)
    if num_bins < num_quantized_bins + 2:
        return float(bin_edges[-1])
    best_kl, best_t = _np.inf, bin_edges[-1]
    # candidate thresholds sweep the tail inward
    for i in range(num_quantized_bins, num_bins + 1,
                   max(1, (num_bins - num_quantized_bins) // 64)):
        ref = hist[:i].copy()
        ref[-1] += hist[i:].sum()  # clip outliers into the last bin
        if ref.sum() == 0:
            continue
        # quantize the i bins down to num_quantized_bins
        idx = _np.linspace(0, i, num_quantized_bins + 1).astype(_np.int64)
        q = _np.zeros(i)
        # NOTE: q is deliberately built from the UNCLIPPED slice (the
        # reference/TensorRT algorithm): the outlier mass lives only in
        # ref's last bin, so aggressive clipping shows up as P/Q mismatch
        # — folding it into q too would make the tightest threshold a
        # degenerate KL=0 minimum.
        for j in range(num_quantized_bins):
            lo, hi = idx[j], max(idx[j + 1], idx[j] + 1)
            chunk = hist[lo:hi]
            nz = (chunk > 0).sum()
            if nz:
                q[lo:hi] = _np.where(chunk > 0, chunk.sum() / nz, 0)
        p = ref / ref.sum()
        qs = q.sum()
        if qs == 0:
            continue
        q = q / qs
        mask = p > 0
        kl = float((p[mask] * _np.log(
            _np.maximum(p[mask], 1e-12) / _np.maximum(q[mask], 1e-12)))
            .sum())
        if kl < best_kl:
            # threshold = UPPER edge of the last kept bin (bins [0, i) are
            # kept, so edge index i — len(bin_edges) == num_bins + 1)
            best_kl, best_t = kl, float(bin_edges[i])
    return float(best_t)


def _rebin(hist, edges, new_edges):
    """Redistribute ``hist`` over ``new_edges`` by CDF interpolation so
    histograms accumulated over different activation ranges merge without
    capping the range at the first batch's max."""
    cdf = _np.concatenate([[0.0], _np.cumsum(hist, dtype=_np.float64)])
    new_cdf = _np.interp(new_edges, edges, cdf,
                         left=0.0, right=float(cdf[-1]))
    return _np.diff(new_cdf)


class _Collector:
    """Forward-hook input statistics collector (parity:
    _LayerOutputCollector / _LayerHistogramCollector)."""

    def __init__(self, mode="naive", num_bins=1024):
        self.mode = mode
        self.num_bins = num_bins
        self.stats: Dict[str, dict] = {}

    def hook(self, name):
        def _h(block, inputs, output):
            arr = inputs[0]
            if not isinstance(arr, NDArray):
                return
            a = _np.asarray(arr.asnumpy())
            st = self.stats.setdefault(name, {"min": _np.inf,
                                              "max": -_np.inf,
                                              "amax": 0.0, "hist": None})
            st["min"] = min(st["min"], float(a.min()))
            st["max"] = max(st["max"], float(a.max()))
            amax = float(_np.abs(a).max())
            st["amax"] = max(st["amax"], amax)
            if self.mode == "entropy":
                rng = (0, max(st["amax"], 1e-8))
                h, edges = _np.histogram(_np.abs(a), bins=self.num_bins,
                                         range=rng)
                if st["hist"] is None:
                    st["hist"], st["edges"] = h.astype(_np.float64), edges
                elif edges[-1] <= st["edges"][-1]:
                    # rebin the new batch into the existing (wider) edges
                    st["hist"] += _rebin(h, edges, st["edges"])
                else:
                    # range grew: rebin the ACCUMULATED hist into the new,
                    # wider edges (fixes first-batch-range capping)
                    st["hist"] = _rebin(st["hist"], st["edges"], edges) + h
                    st["edges"] = edges
        return _h

    def threshold(self, name):
        st = self.stats[name]
        if self.mode == "entropy" and st.get("hist") is not None:
            return calib_thresholds_entropy(st["hist"], st["edges"])
        return st["amax"]


def _codes(w, sw, ctx):
    """The int8 weight codes, rounded in numpy, on the layer's device."""
    return _nd.array(_np.clip(_np.round(w / sw), -127, 127)
                     .astype(_np.int8), ctx=ctx, dtype="int8")


class QuantizedDense(HybridBlock):
    """int8 twin of nn.Dense (reference: quantized_fully_connected);
    symbolic tracing is refused."""

    def __init__(self, float_dense: nn.Dense, input_threshold: float,
                 **kwargs):
        super().__init__(**kwargs)
        w = float_dense.weight.data().asnumpy()
        amax_w = float(_np.abs(w).max()) or 1.0
        self._min_w, self._max_w = -amax_w, amax_w
        sw = amax_w / 127.0
        self._wq = _codes(w, sw, float_dense.weight.data().context)
        self._bias = float_dense.bias.data() \
            if float_dense.bias is not None else None
        self._thresh = float(input_threshold) or 1.0
        self._flatten = float_dense._flatten
        self._act = float_dense.act

    def hybrid_call(self, x):
        if self._flatten and len(x.shape) > 2:
            x = _nd.flatten(x)
        q, mn, mx_ = _nd.quantize_v2(x, min_calib_range=-self._thresh,
                                     max_calib_range=self._thresh)
        out, _, _ = _nd.quantized_fully_connected(
            q, self._wq, self._bias, mn, mx_,
            self._min_w, self._max_w)
        if self._act is not None:
            out = self._act(out)
        return out

    def forward(self, *args):
        from ..symbol.symbol import Symbol as _Sym
        if any(isinstance(a, _Sym) for a in args):
            raise MXNetError(
                "quantized layers cannot be traced symbolically; export "
                "the float net, then quantize after loading")
        return self.hybrid_call(*args)


class QuantizedConv2D(HybridBlock):
    """int8 twin of nn.Conv2D (reference: quantized_conv); symbolic
    tracing is refused."""

    def __init__(self, float_conv, input_threshold: float, **kwargs):
        super().__init__(**kwargs)
        w = float_conv.weight.data().asnumpy()
        amax_w = float(_np.abs(w).max()) or 1.0
        self._min_w, self._max_w = -amax_w, amax_w
        sw = amax_w / 127.0
        self._wq = _codes(w, sw, float_conv.weight.data().context)
        self._bias = float_conv.bias.data() \
            if float_conv.bias is not None else None
        self._kwargs = dict(float_conv._kwargs)
        self._thresh = float(input_threshold) or 1.0
        self._act = float_conv.act

    def hybrid_call(self, x):
        q, mn, mx_ = _nd.quantize_v2(x, min_calib_range=-self._thresh,
                                     max_calib_range=self._thresh)
        out, _, _ = _nd.quantized_conv(
            q, self._wq, self._bias, mn, mx_,
            self._min_w, self._max_w,
            stride=self._kwargs["stride"], pad=self._kwargs["pad"],
            dilate=self._kwargs["dilate"],
            num_group=self._kwargs["num_group"])
        if self._act is not None:
            out = self._act(out)
        return out

    def forward(self, *args):
        from ..symbol.symbol import Symbol as _Sym
        if any(isinstance(a, _Sym) for a in args):
            raise MXNetError(
                "quantized layers cannot be traced symbolically; export "
                "the float net, then quantize after loading")
        return self.hybrid_call(*args)


def quantize_net(net: HybridBlock, calib_data=None, calib_mode="naive",
                 quantized_dtype="int8", num_calib_batches=None,
                 exclude_layers: Optional[List[str]] = None):
    """Post-training-quantize a Gluon net IN PLACE and return it
    (parity: contrib.quantization.quantize_net).

    calib_data: iterable of input batches (NDArray or tuple); required.
    calib_mode: 'naive' (min/max) or 'entropy' (KL thresholds).
    """
    if quantized_dtype != "int8":
        raise MXNetError("only int8 quantization is supported")
    if calib_mode not in ("naive", "entropy"):
        raise MXNetError(f"unknown calib_mode {calib_mode!r}")
    if calib_data is None:
        raise MXNetError("quantize_net requires calibration data")
    exclude = set(exclude_layers or [])

    # calibration must observe EAGER arrays (hooks read values), and the
    # layer swap invalidates any compiled graph: drop hybridization and
    # caches on the whole tree first
    was_active = getattr(net, "_active", False)
    net.hybridize(False)

    # 1. attach collectors to every quantizable leaf
    collector = _Collector(mode=calib_mode)
    targets = []

    def find(block, path=""):
        for name, child in block._children.items():
            p = f"{path}.{name}" if path else name
            if isinstance(child, (nn.Dense, nn.Conv2D)):
                if p not in exclude and child.weight._shape_known():
                    targets.append((block, name, p, child))
                    child.register_forward_hook(collector.hook(p))
            else:
                find(child, p)

    # hooks must fire on inputs; our forward hooks get (block, args, out)
    find(net)
    if not targets:
        raise MXNetError("no quantizable layers found (Dense/Conv2D)")

    # 2. run calibration batches
    for i, batch in enumerate(calib_data):
        if num_calib_batches is not None and i >= num_calib_batches:
            break
        xs = batch if isinstance(batch, (tuple, list)) else (batch,)
        net(*xs)

    # 3. swap in quantized twins
    for parent, name, path, child in targets:
        if path not in collector.stats:
            continue
        thresh = collector.threshold(path)
        if isinstance(child, nn.Dense):
            q = QuantizedDense(child, thresh)
        else:
            q = QuantizedConv2D(child, thresh)
        parent._children[name] = q
        setattr(parent, name, q)
    if was_active:
        net.hybridize(True)
    return net
