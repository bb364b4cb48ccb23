"""Transformer for NMT on gluon ``HybridBlock``s: the port of the JAX
package's ``incubator_mxnet_tpu/models/transformer.py`` (BASELINE.md
config #4, WMT14 En-De: attention and beam search).

The layers keep the JAX model's structure, names and numerics (post-norm
encoder and decoder layers, ReLU FFN, sinusoidal positions, f32 weights),
over ``scaled_dot_product_attention``. ``flash=True`` takes the flash
path: the source mask travels with its lengths (``src_valid_length``), so
encoder self-attention, the decoder's causal self-attention (square) and
cross-attention (Tq != Tk, not causal) reach the flash kernels on the
card with a key prefix (a departure: the JAX model's cross-attention is
never flash, and its flash path takes a boolean source mask to the
blockwise form); ``flash=False`` is the plain masked form, as the JAX
package computes it outside any Pallas call.

``beam_search_translate`` (the full-prefix recompute each step) and
``beam_search_translate_cached`` (per-layer self-attention caches
reordered with the surviving beams each step; cross-attention K/V
projected once at batch B, then repeated per beam) run their step loop
eagerly on the model's device, outside recording and training. Their
selection keeps the JAX order where scores tie (ties are real: a score
of -1e9 absorbs a log-probability in f32): ``lax.top_k``'s lower index
first is a stable descending sort, ``jnp.argsort``'s stability
``torch.argsort(stable=True)``.
"""

from __future__ import annotations

import math

import torch

from .. import autograd
from ..base import MXNetError
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..ndarray import NDArray
from ..ops.attention import scaled_dot_product_attention as _sdpa
from .gpt import _linear, _norm

__all__ = ["TransformerModel", "TransformerEncoder", "TransformerDecoder",
           "transformer_base", "transformer_big", "beam_search_translate",
           "beam_search_translate_cached"]

_NEG = -1e9


def _positional_encoding(max_len, units):
    """(max_len, units) f32 sinusoids (sin on even, cos on odd columns)."""
    pos = torch.arange(max_len, dtype=torch.float32)[:, None]
    dim = torch.arange(0, units, 2, dtype=torch.float32)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0), dim / units)
    pe = torch.zeros(max_len, units)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle[:, : units // 2])
    return pe


class MultiHeadAttention(HybridBlock):
    """Projections + scaled dot-product attention (cross-attention when
    ``kv`` differs from the query)."""

    def __init__(self, units, num_heads, dropout=0.1, causal=False,
                 flash=False, **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise MXNetError(f"units {units} % heads {num_heads} != 0")
        self._units = units
        self._heads = num_heads
        self._causal = causal
        self._flash = flash
        with self.name_scope():
            self.q_proj = nn.Dense(units, in_units=units, flatten=False)
            self.k_proj = nn.Dense(units, in_units=units, flatten=False)
            self.v_proj = nn.Dense(units, in_units=units, flatten=False)
            self.out_proj = nn.Dense(units, in_units=units, flatten=False)
            self.dropout = nn.Dropout(dropout)

    def hybrid_forward(self, F, query, kv=None, mask=None,
                       valid_length=None):
        if kv is None:
            kv = query
        B, Tq = query.shape[0], query.shape[1]
        Tk = kv.shape[1]
        H, D = self._heads, self._units // self._heads
        q = self.q_proj(query).reshape((B, Tq, H, D))
        k = self.k_proj(kv).reshape((B, Tk, H, D))
        v = self.v_proj(kv).reshape((B, Tk, H, D))
        out = F.scaled_dot_product_attention(
            q, k, v, mask=mask, causal=self._causal, flash=self._flash,
            valid_length=valid_length)
        return self.dropout(self.out_proj(out.reshape((B, Tq,
                                                       self._units))))


class _FFN(HybridBlock):
    def __init__(self, units, hidden_size, dropout=0.1, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.fc1 = nn.Dense(hidden_size, in_units=units, flatten=False,
                                activation="relu")
            self.fc2 = nn.Dense(units, in_units=hidden_size, flatten=False)
            self.dropout = nn.Dropout(dropout)

    def hybrid_forward(self, F, x):
        return self.dropout(self.fc2(self.fc1(x)))


class EncoderLayer(HybridBlock):
    def __init__(self, units, hidden_size, num_heads, dropout=0.1,
                 flash=False, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.attn = MultiHeadAttention(units, num_heads, dropout,
                                           flash=flash)
            self.ffn = _FFN(units, hidden_size, dropout)
            self.ln1 = nn.LayerNorm(in_channels=units)
            self.ln2 = nn.LayerNorm(in_channels=units)

    def hybrid_forward(self, F, x, mask=None, valid_length=None):
        x = self.ln1(x + self.attn(x, None, mask, valid_length))
        return self.ln2(x + self.ffn(x))


class DecoderLayer(HybridBlock):
    def __init__(self, units, hidden_size, num_heads, dropout=0.1,
                 flash=False, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.self_attn = MultiHeadAttention(units, num_heads, dropout,
                                                causal=True, flash=flash)
            self.cross_attn = MultiHeadAttention(units, num_heads, dropout,
                                                 flash=flash)
            self.ffn = _FFN(units, hidden_size, dropout)
            self.ln1 = nn.LayerNorm(in_channels=units)
            self.ln2 = nn.LayerNorm(in_channels=units)
            self.ln3 = nn.LayerNorm(in_channels=units)

    def hybrid_forward(self, F, x, memory, src_mask=None,
                       src_valid_length=None):
        x = self.ln1(x + self.self_attn(x))
        x = self.ln2(x + self.cross_attn(x, memory, src_mask,
                                         src_valid_length))
        return self.ln3(x + self.ffn(x))


class _Stack(HybridBlock):
    """Embedding * sqrt(units) + sinusoids, dropout, then the layers."""

    def __init__(self, layer_cls, vocab_size, units, hidden_size, num_heads,
                 num_layers, max_length=512, dropout=0.1, flash=False,
                 **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._max_length = max_length
        self._flash = flash
        self._pe = _positional_encoding(max_length, units)  # built once
        self._pe_dev = {}
        with self.name_scope():
            self.embed = nn.Embedding(vocab_size, units)
            self.dropout = nn.Dropout(dropout)
            self.layers = nn.HybridSequential(prefix="layers_")
            with self.layers.name_scope():
                for _ in range(num_layers):
                    self.layers.add(layer_cls(units, hidden_size,
                                              num_heads, dropout,
                                              flash=flash))

    def _pe_on(self, device) -> torch.Tensor:
        """The sinusoids on ``device``, copied there once (a graph
        capture then reads them in place)."""
        key = str(device)
        if key not in self._pe_dev:
            self._pe_dev[key] = self._pe.to(device)
        return self._pe_dev[key]

    def _embed(self, ids):
        T = ids.shape[1]
        if T > self._max_length:
            raise MXNetError(f"sequence length {T} exceeds max_length "
                             f"{self._max_length}")
        x = self.embed(ids) * math.sqrt(self._units)
        return self.dropout(x + NDArray(self._pe_on(x._data.device)[:T]))


class TransformerEncoder(_Stack):
    def __init__(self, vocab_size, units, hidden_size, num_heads,
                 num_layers, max_length=512, dropout=0.1, flash=False,
                 **kwargs):
        super().__init__(EncoderLayer, vocab_size, units, hidden_size,
                         num_heads, num_layers, max_length, dropout, flash,
                         **kwargs)

    def hybrid_forward(self, F, src, src_mask=None, src_valid_length=None):
        x = self._embed(src)
        for layer in self.layers:
            x = layer(x, src_mask, src_valid_length)
        return x


class TransformerDecoder(_Stack):
    def __init__(self, vocab_size, units, hidden_size, num_heads,
                 num_layers, max_length=512, dropout=0.1, flash=False,
                 **kwargs):
        super().__init__(DecoderLayer, vocab_size, units, hidden_size,
                         num_heads, num_layers, max_length, dropout, flash,
                         **kwargs)
        with self.name_scope():
            self.proj = nn.Dense(vocab_size, in_units=units, flatten=False)

    def hybrid_forward(self, F, tgt, memory, src_mask=None,
                       src_valid_length=None):
        x = self._embed(tgt)
        for layer in self.layers:
            x = layer(x, memory, src_mask, src_valid_length)
        return self.proj(x)


class TransformerModel(HybridBlock):
    """Encoder-decoder NMT transformer (Vaswani et al. 2017 layout).

    ``forward(src, tgt, src_valid_length=None)`` -> logits
    (B, Tt, tgt_vocab). Source padding is masked through
    ``src_valid_length``."""

    def __init__(self, src_vocab=36000, tgt_vocab=36000, units=512,
                 hidden_size=2048, num_heads=8, num_layers=6,
                 max_length=512, dropout=0.1, flash=False, **kwargs):
        super().__init__(**kwargs)
        self.units = units
        self.tgt_vocab = tgt_vocab
        with self.name_scope():
            self.encoder = TransformerEncoder(src_vocab, units, hidden_size,
                                              num_heads, num_layers,
                                              max_length, dropout,
                                              flash=flash)
            self.decoder = TransformerDecoder(tgt_vocab, units, hidden_size,
                                              num_heads, num_layers,
                                              max_length, dropout,
                                              flash=flash)

    @staticmethod
    def _src_mask(F, src, src_valid_length):
        """The (B, Ts) key mask ``pos < valid_length`` and the lengths as
        int32 (what the flash kernels read), or (None, None)."""
        if src_valid_length is None:
            return None, None
        T = src.shape[1]
        pos = F.arange(0, T, ctx=src.context).reshape((1, T))
        mask = F.broadcast_lesser(pos, src_valid_length.reshape((-1, 1)))
        return mask, src_valid_length.astype("int32")

    def hybrid_forward(self, F, src, tgt, src_valid_length=None):
        mask, vl = self._src_mask(F, src, src_valid_length)
        memory = self.encoder(src, mask, vl)
        return self.decoder(tgt, memory, mask, vl)

    def encode(self, src, src_valid_length=None):
        """(memory, mask): the encoder's output and the source mask."""
        from .. import ndarray as nd
        mask, vl = self._src_mask(nd, src, src_valid_length)
        return self.encoder(src, mask, vl), mask


def transformer_base(**kwargs):
    """The WMT14 'base' config (512/2048/8 heads/6 layers)."""
    return TransformerModel(units=512, hidden_size=2048, num_heads=8,
                            num_layers=6, **kwargs)


def transformer_big(**kwargs):
    """The WMT14 'big' config (1024/4096/16 heads/6 layers)."""
    return TransformerModel(units=1024, hidden_size=4096, num_heads=16,
                            num_layers=6, **kwargs)


# ------------------------------------------------------------------ #
# beam search (reference: GluonNLP BeamSearchTranslator semantics)
# ------------------------------------------------------------------ #

def _top_k(x, k):
    """``lax.top_k`` along the last axis: values descending, the lower
    index first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _beam_advance(tokens, scores, finished, logp, t, K, V, eos_id):
    """One selection step shared by both decoders: finished beams are
    frozen to EOS at zero cost, the global top-K continuations taken and
    the beam state reordered. Returns (tokens, scores, finished,
    beam_idx)."""
    B = tokens.shape[0]
    eos_only = torch.full((V,), _NEG, dtype=logp.dtype, device=logp.device)
    eos_only[eos_id] = 0.0
    logp = torch.where(finished[:, :, None], eos_only, logp)
    cand = scores[:, :, None] + logp                  # (B, K, V)
    top_scores, top_idx = _top_k(cand.reshape(B, K * V), K)
    beam_idx = top_idx // V
    tok_idx = top_idx % V
    tokens = torch.gather(tokens, 1, beam_idx[:, :, None].expand(
        B, K, tokens.shape[2])).clone()
    tokens[:, :, t + 1] = tok_idx.to(tokens.dtype)
    finished = torch.gather(finished, 1, beam_idx) | (tok_idx == eos_id)
    return tokens, top_scores, finished, beam_idx


def _beam_finalize(tokens, scores, eos_id, max_length, alpha):
    """Length-penalized re-ranking shared by both decoders (GNMT
    lp = ((5 + len) / 6) ^ alpha); best first, stable among ties."""
    hit = tokens[:, :, 1:] == eos_id
    lengths = torch.argmax(hit.to(torch.int32), dim=-1) + 1
    lengths = torch.where(hit.any(dim=-1), lengths,
                          torch.full_like(lengths, max_length))
    lp = torch.pow((5.0 + lengths.to(torch.float32)) / 6.0, alpha)
    final = scores / lp
    order = torch.argsort(-final, dim=1, stable=True)
    tokens = torch.gather(tokens, 1, order[:, :, None].expand(
        tokens.shape))
    final = torch.gather(final, 1, order)
    return NDArray(tokens[:, :, 1:].contiguous()), NDArray(final)


def _beam_init(B, K, Tmax, bos_id, eos_id, device):
    tokens = torch.full((B, K, Tmax), eos_id, dtype=torch.int32,
                        device=device)
    tokens[:, :, 0] = bos_id
    scores = torch.tensor([[0.0] + [_NEG] * (K - 1)], dtype=torch.float32,
                          device=device).repeat(B, 1)
    finished = torch.zeros((B, K), dtype=torch.bool, device=device)
    return tokens, scores, finished


def _src_tensor(model, src):
    dev = model.decoder.embed.weight.data()._data.device
    if isinstance(src, NDArray):
        src = src._data
    return torch.as_tensor(src, device=dev)


def _check_length(model, max_length):
    if max_length + 1 > model.decoder._max_length:
        raise MXNetError(
            f"beam search max_length {max_length} needs a decoder "
            f"max_length of at least {max_length + 1} "
            f"(model has {model.decoder._max_length})")


def _vl(src_valid_length, device):
    """The source lengths as an NDArray on ``device`` (or None)."""
    if src_valid_length is None:
        return None
    if isinstance(src_valid_length, NDArray):
        src_valid_length = src_valid_length._data
    return NDArray(torch.as_tensor(src_valid_length, device=device))


def beam_search_translate(model: TransformerModel, src, beam_size=4,
                          max_length=32, bos_id=1, eos_id=2, alpha=0.6,
                          src_valid_length=None):
    """Length-penalized beam search decode.

    src: (B, Ts) int tokens. Returns (tokens (B, K, max_length), scores
    (B, K)) sorted best-first; sequences end at ``eos_id``. Each step
    runs the decoder over the whole (B*K, max_length + 1) buffer (causal
    attention makes positions past the step inert) and picks the live
    position."""
    src = _src_tensor(model, src)
    B = src.shape[0]
    K, V = beam_size, model.tgt_vocab
    _check_length(model, max_length)
    vl = _vl(src_valid_length, src.device)
    with autograd._ModeScope(recording=False, training=False), \
            torch.no_grad():
        memory, mask = model.encode(NDArray(src), vl)
        mem = NDArray(memory._data.repeat_interleave(K, 0))
        m = None if mask is None else \
            NDArray(mask._data.repeat_interleave(K, 0))
        kvl = None if vl is None else \
            NDArray(vl._data.int().repeat_interleave(K, 0))
        tokens, scores, finished = _beam_init(B, K, max_length + 1,
                                              bos_id, eos_id, src.device)
        for t in range(max_length):
            logits = model.decoder(NDArray(tokens.reshape(B * K, -1)), mem,
                                   m, kvl)._data
            logp = torch.log_softmax(logits[:, t, :].float(), dim=-1)
            tokens, scores, finished, _ = _beam_advance(
                tokens, scores, finished, logp.reshape(B, K, V), t, K, V,
                eos_id)
    return _beam_finalize(tokens, scores, eos_id, max_length, alpha)


def beam_search_translate_cached(model: TransformerModel, src,
                                 beam_size=4, max_length=32, bos_id=1,
                                 eos_id=2, alpha=0.6,
                                 src_valid_length=None):
    """Same contract and output as ``beam_search_translate`` with
    KV-cached incremental decoding: O(T) decoder work per new token."""
    src = _src_tensor(model, src)
    B, Ts = src.shape
    K, V = beam_size, model.tgt_vocab
    dec = model.decoder
    H = dec.layers[0].self_attn._heads
    units = dec._units
    D = units // H
    Tmax = max_length + 1
    _check_length(model, max_length)
    dev = src.device
    with autograd._ModeScope(recording=False, training=False), \
            torch.no_grad():
        memory, mask = model.encode(NDArray(src),
                                    _vl(src_valid_length, dev))
        memory = memory._data
        cross_mask = None if mask is None else \
            (mask._data.repeat_interleave(K, 0) != 0)[:, None, None, :]
        # cross-attention K/V: projected at batch B once per layer, then
        # repeated per beam
        mem_kv = []
        for layer in dec.layers:
            km = _linear(layer.cross_attn.k_proj, memory).reshape(
                B, Ts, H, D)
            vm = _linear(layer.cross_attn.v_proj, memory).reshape(
                B, Ts, H, D)
            mem_kv.append((km.repeat_interleave(K, 0),
                           vm.repeat_interleave(K, 0)))
        pe = dec._pe_on(dev)
        scale = math.sqrt(units)
        pos_k = torch.arange(Tmax, device=dev)
        caches = [(torch.zeros(B * K, Tmax, H, D, device=dev),
                   torch.zeros(B * K, Tmax, H, D, device=dev))
                  for _ in dec.layers]
        tokens, scores, finished = _beam_init(B, K, Tmax, bos_id, eos_id,
                                              dev)
        rows = torch.arange(B, device=dev)[:, None]
        for t in range(max_length):
            tok = tokens.reshape(B * K, -1)[:, t]
            x = dec.embed(NDArray(tok[:, None]))._data * scale
            x = x + pe[t:t + 1][None]
            self_mask = (pos_k <= t)[None, None, None, :]
            for li, layer in enumerate(dec.layers):
                sa_blk, ca_blk = layer.self_attn, layer.cross_attn
                k_buf, v_buf = caches[li]
                q = _linear(sa_blk.q_proj, x).reshape(B * K, 1, H, D)
                k_buf[:, t] = _linear(sa_blk.k_proj, x).reshape(B * K, H, D)
                v_buf[:, t] = _linear(sa_blk.v_proj, x).reshape(B * K, H, D)
                sa = _sdpa(q, k_buf, v_buf, mask=self_mask)
                x = _norm(layer.ln1, x + _linear(
                    sa_blk.out_proj, sa.reshape(B * K, 1, units)))
                qc = _linear(ca_blk.q_proj, x).reshape(B * K, 1, H, D)
                km, vm = mem_kv[li]
                ca = _sdpa(qc, km, vm, mask=cross_mask)
                x = _norm(layer.ln2, x + _linear(
                    ca_blk.out_proj, ca.reshape(B * K, 1, units)))
                h = _linear(layer.ffn.fc2, torch.relu(
                    _linear(layer.ffn.fc1, x)))
                x = _norm(layer.ln3, x + h)
            logits = _linear(dec.proj, x)[:, 0]            # (B*K, V)
            logp = torch.log_softmax(logits.float(), dim=-1)
            tokens, scores, finished, beam_idx = _beam_advance(
                tokens, scores, finished, logp.reshape(B, K, V), t, K, V,
                eos_id)
            caches = [tuple(buf.reshape((B, K) + buf.shape[1:])[
                rows, beam_idx].reshape(buf.shape) for buf in pair)
                for pair in caches]
    return _beam_finalize(tokens, scores, eos_id, max_length, alpha)
