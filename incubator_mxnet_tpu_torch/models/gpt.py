"""Decoder-only causal language model (GPT-style) on gluon ``HybridBlock``s:
the port of the JAX package's ``incubator_mxnet_tpu/models/gpt.py``.

``CausalSelfAttention``, ``GPTBlock`` and ``GPTModel`` are built from
``gluon.nn`` under the JAX model's structural names (``word_embed``,
``position_embed``, ``block{i}.ln1`` / ``attn.qkv`` / ``attn.proj`` /
``ln2`` / ``ffn_in`` / ``ffn_out``, ``ln_f``), with its numerics:

  - pre-norm blocks: LN -> causal attention -> Dropout -> residual,
    LN -> MLP (exact GELU) -> Dropout -> residual;
  - LayerNorm statistics and affine in f32 with the output in the input
    dtype (eps 1e-5), gamma/beta kept in f32; the qkv, proj, ffn_in and
    ffn_out Dense layers in the model dtype;
  - f32 embeddings, embedding dropout, the stream cast to the model dtype
    after them, and an LM head tied to the word embedding, computed in
    the model dtype;
  - ``flash=True``: the packed (3, B, H, T, D) fast path at a head width
    the kernels take (``models/_attention.py``: the causal flash kernels
    on the card), else ``scaled_dot_product_attention(causal=True,
    flash=)``; ``remat=True | "dots"`` rematerializes each block
    (``models/_remat.py``).

``gpt_small(dtype=, flash=, dropout=)`` then ``initialize()`` is the
MXNet contract: parameters land on the context ``initialize`` is given
(the current one, ``gpu(0)``, by default), drawn by ``TruncNorm(0.02)``
(zero biases) from ``mx.random``'s generator. ``lm_loss`` is the
next-token loss for ``SPMDTrainer(forward_loss=)``, ``greedy_generate``
the full-recompute fixed-shape decode.

The serving functions (``_embed``, ``_norm``, ``_linear``, ``_qkv_heads``,
``_mlp``, ``_lm_head``, the dense KV-cache ``init_kv_cache`` /
``decode_forward`` / ``cached_generate``) work on the parameters' tensors
directly (each gluon ``Parameter`` keeps one ``torch.nn.Parameter`` for
life, which the engine's CUDA graphs hold by address), with no dropout
and no autograd recording. The decode paths' head casts to f32 BEFORE
``ln_f``.

``seq_parallel=True`` splits the sequence over the sp axis inside an
SPMD step whose mesh has one (``parallel.SPMDTrainer``): the embeddings
run on the whole sequence (so positions are global), the stream enters
the axis before the first block (``parallel.constrain``), attention is
the ring (``models/_attention.ring_attention``: the flash kernels' ring
with ``flash=True`` on the card, the plain ring otherwise) and the head
gives this rank's block of the logits, which ``lm_loss`` pairs with its
block of the labels. On a tp axis the Dense layers read the JAX sharding
hints (qkv and ffn_in column-parallel, proj and ffn_out row-parallel;
``parallel.spmd.tp_linear``), attention runs on the rank's heads, and the
tied head gives the rank's tile of the vocabulary (when tp divides it),
as the JAX logits are vocab-split over tp.

``lm_pipeline`` is the model's ``PipelineSpec`` for the pipelined SPMD
step (``SPMDTrainer(pipeline=lm_pipeline(model))``, over dp / fsdp).
Data, sequence and tensor parallelism run through
``parallel.SPMDTrainer``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import autograd
from .. import initializer as init
from .. import random as _random
from ..base import MXNetError
from ..gluon import nn
from ..gluon.block import HybridBlock
from .. import ndarray as _nd
from ..ndarray import NDArray
from ..ops.attention import scaled_dot_product_attention as _sdpa
from ._attention import (local_heads, packed_flash_self_attention,
                         position_rows, ring_attention, seq_mesh, tp_axis,
                         tp_dense, tp_hints, use_packed_fast_path)
from ._remat import remat_call, resolve_policy

__all__ = ["GPTModel", "gpt_mini", "gpt_small", "lm_loss", "lm_pipeline",
           "greedy_generate", "cached_generate", "init_kv_cache",
           "decode_forward"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise MXNetError(f"unsupported dtype {dtype!r} "
                         f"(one of {sorted(_DTYPES)})")
    return _DTYPES[dtype]


def _trunc():
    return init.TruncNorm(stdev=0.02)


class CausalSelfAttention(HybridBlock):
    """Fused-qkv causal self-attention; dropout on the projected output.
    ``seq_parallel=True``: the sp ring inside an SPMD step whose mesh has
    an sp axis (see the module's docstring)."""

    def __init__(self, units, num_heads, dropout=0.0, dtype="float32",
                 flash=False, seq_parallel=False, **kwargs):
        if units % num_heads:
            raise MXNetError(f"units {units} % heads {num_heads} != 0")
        super().__init__(**kwargs)
        self._units, self._heads, self._flash = units, num_heads, flash
        self._seq_parallel = seq_parallel
        with self.name_scope():
            self.qkv = nn.Dense(3 * units, in_units=units, flatten=False,
                                dtype=dtype, weight_initializer=_trunc())
            self.proj = nn.Dense(units, in_units=units, flatten=False,
                                 dtype=dtype, weight_initializer=_trunc())
            self.dropout = nn.Dropout(dropout)
        tp_hints(self.qkv, self.proj, parts=3)

    def hybrid_forward(self, F, x):
        B, T = x.shape[0], x.shape[1]
        D = self._units // self._heads
        H, tp = local_heads(self._heads, "CausalSelfAttention")
        units = H * D
        qkv = tp_dense(self.qkv, x, tp).reshape((B, T, 3, H, D))
        # the stream is this rank's block of the sequence (the model
        # checked the whole one divides)
        mesh = seq_mesh(self._seq_parallel, T, "CausalSelfAttention")
        if mesh is None and self._flash and use_packed_fast_path(D):
            out = packed_flash_self_attention(F, qkv, B, T, H, D, units,
                                              causal=True)
        else:
            q = qkv.slice_axis(axis=2, begin=0, end=1).reshape((B, T, H, D))
            k = qkv.slice_axis(axis=2, begin=1, end=2).reshape((B, T, H, D))
            v = qkv.slice_axis(axis=2, begin=2, end=3).reshape((B, T, H, D))
            if mesh is not None:
                out = ring_attention(q, k, v, mesh, causal=True,
                                     flash=self._flash)
            else:
                out = F.scaled_dot_product_attention(q, k, v, causal=True,
                                                     flash=self._flash)
            out = out.reshape((B, T, units))
        return self.dropout(tp_dense(self.proj, out, tp))


class GPTBlock(HybridBlock):
    """Pre-norm transformer decoder block (LN -> attn -> residual,
    LN -> MLP -> residual)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 layer_norm_eps=1e-5, dtype="float32", flash=False,
                 seq_parallel=False, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.ln1 = nn.LayerNorm(epsilon=layer_norm_eps,
                                    in_channels=units)
            self.attn = CausalSelfAttention(units, num_heads, dropout,
                                            dtype=dtype, flash=flash,
                                            seq_parallel=seq_parallel)
            self.ln2 = nn.LayerNorm(epsilon=layer_norm_eps,
                                    in_channels=units)
            self.ffn_in = nn.Dense(hidden_size, in_units=units,
                                   flatten=False, dtype=dtype,
                                   weight_initializer=_trunc())
            self.ffn_out = nn.Dense(units, in_units=hidden_size,
                                    flatten=False, dtype=dtype,
                                    weight_initializer=_trunc())
            self.dropout = nn.Dropout(dropout)
        tp_hints(self.ffn_in, self.ffn_out)

    def hybrid_forward(self, F, x):
        tp = tp_axis()
        x = x + self.attn(self.ln1(x))
        h = tp_dense(self.ffn_in, self.ln2(x), tp)
        return x + self.dropout(tp_dense(self.ffn_out, F.gelu(h), tp))


class GPTModel(HybridBlock):
    """forward(input_ids (B, T)) -> logits (B, T, vocab) in the model
    dtype; the LM head is tied to the word embedding. ``units``,
    ``num_heads``, ``dtype`` (a torch dtype), ``device`` (once
    initialized) and ``blocks`` are what the serving engine reads."""

    def __init__(self, vocab_size=50257, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=1024,
                 dropout=0.0, layer_norm_eps=1e-5, dtype="float32",
                 flash=False, remat=False, seq_parallel=False, **kwargs):
        _torch_dtype(dtype)
        resolve_policy(remat)
        super().__init__(**kwargs)
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self._units = units
        self.hidden_size = hidden_size
        self._dtype = dtype
        self._remat = remat
        self._seq_parallel = seq_parallel
        self.max_length = max_length
        with self.name_scope():
            self.word_embed = nn.Embedding(vocab_size, units, sharded=True,
                                           weight_initializer=_trunc())
            self.position_embed = nn.Embedding(max_length, units,
                                               weight_initializer=_trunc())
            self.embed_dropout = nn.Dropout(dropout)
            for i in range(num_layers):
                blk = GPTBlock(units, hidden_size, num_heads, dropout,
                               layer_norm_eps, dtype=dtype, flash=flash,
                               seq_parallel=seq_parallel)
                self.register_child(blk, f"block{i}")
                setattr(self, f"block{i}", blk)
            self.ln_f = nn.LayerNorm(epsilon=layer_norm_eps,
                                     in_channels=units)

    @property
    def units(self) -> int:
        return self._units

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self._dtype]

    @property
    def device(self) -> torch.device:
        return self.word_embed.weight.data()._data.device

    @property
    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.num_layers)]

    def embed(self, input_ids):
        """The stem: the word and position embeddings, the embedding
        dropout, then the compute dtype."""
        B, T = input_ids.shape
        x = self.word_embed(input_ids) + \
            position_rows(self.position_embed, B, T)
        x = self.embed_dropout(x)
        if self._dtype != "float32":
            x = x.astype(self._dtype)
        return x

    def logits(self, x):
        """The head: the final norm and the vocabulary projection tied to
        the word embedding (this rank's tile of the vocabulary when tp
        splits it)."""
        # ln_f returns the input dtype: the (B, T, vocab) head runs at the
        # compute dtype's rate, and the loss reduces with f32 accumulation
        x = self.ln_f(x)
        embed_w = self.word_embed.weight.data()
        from ..parallel.spmd import TPAxis, vocab_split
        tp = vocab_split(TPAxis.of(None), self.vocab_size)
        if tp is not None:
            # this rank's tile of the vocabulary (vocab-split logits)
            embed_w = NDArray(tp.rows(embed_w._data))
        return _nd.dot(x, embed_w.astype(x.dtype), transpose_b=True)

    def hybrid_forward(self, F, input_ids):
        x = self.embed(input_ids)
        if seq_mesh(self._seq_parallel, input_ids.shape[1],
                    "GPTModel") is not None:
            # the blocks and the head run on this rank's block of the
            # sequence
            from ..parallel.spmd import constrain
            x = constrain(x, ("dp", "fsdp"), "sp", None)
        policy = resolve_policy(self._remat)
        for blk in self.blocks:
            x = remat_call(blk, x, policy=policy) if policy else blk(x)
        return self.logits(x)


def lm_loss(model: GPTModel, input_ids, labels, weights=None):
    """Next-token cross entropy, shaped for ``SPMDTrainer.forward_loss``:
    pick - logsumexp with f32 accumulation (the (B, T, vocab) log-
    probabilities are never written).

    With the sequence split over sp (``seq_parallel``), the model gives
    this rank's block of the logits and the loss takes its block of the
    labels; with the vocabulary split over tp, its tile of the
    vocabulary, and the pick and the logsumexp run over tp
    (``spmd.vocab_ce``). Inside an SPMD step each rank's loss is its share of the
    global batch's scaled to the whole, as ``SPMDTrainer`` averages the
    ranks' losses: the mean of its block, or its weighted sum over the
    global weight sum (``spmd.split_sum``) times the ranks that split the
    batch, so the weighted form is the global batch's ratio as in
    JAX."""
    logits = model(input_ids)
    mesh = seq_mesh(getattr(model, "_seq_parallel", False),
                    input_ids.shape[1], "lm_loss")
    if mesh is not None:
        from ..parallel.spmd import constrain
        labels = constrain(labels, ("dp", "fsdp"), "sp")
        if weights is not None:
            weights = constrain(weights, ("dp", "fsdp"), "sp")
    ll = _token_log_likelihood(model, logits, labels)
    if weights is None:
        return -ll.mean()
    from ..parallel.spmd import neg_global_ratio
    return neg_global_ratio((ll * weights).sum(), weights.sum(),
                            seq=mesh is not None)


def _token_log_likelihood(model, logits, labels):
    """Each position's log-probability of its label, f32 (B, T): pick -
    logsumexp, over tp when the logits are the rank's vocabulary tile."""
    from ..parallel.spmd import TPAxis, vocab_ce
    if logits.shape[-1] != model.vocab_size:
        # vocab-split logits: the pick and the logsumexp over tp
        with torch.set_grad_enabled(autograd.is_recording()):
            score, lse = vocab_ce(logits._data, labels._data,
                                  TPAxis.of(None))
            return NDArray(score - lse)
    label_scores = logits.pick(labels, axis=-1)       # (B, T)
    lse = logits._op("logsumexp", axis=-1)
    return label_scores.astype("float32") - lse


def lm_pipeline(model: GPTModel, weighted: bool = False):
    """``PipelineSpec`` for ``lm_loss`` training under the pipelined SPMD
    step (``parallel/pipelined.py``): stem = the embeddings, one pipeline
    block a transformer layer, head = the final norm and the tied vocab
    projection with the next-token cross entropy as the rank's LOCAL
    partial sums, and ``finalize`` the rank's ``lm_loss`` from them.

    ``weighted`` selects ``lm_loss(..., weights)`` (batch = (input_ids,
    labels, weights)); the default the mean (batch = (input_ids,
    labels)). The stem and the head are ``GPTModel.embed`` and
    ``GPTModel.logits``, which ``hybrid_forward`` composes, and the loss
    shares ``lm_loss``'s code; only the split into partial sums and
    ``finalize`` is the pipeline's own, so the pipelined step's losses
    and gradients are the plain step's bitwise.
    A dp / fsdp mesh only (the pipelined step's rule): no tp or sp."""
    from ..parallel.pipelined import PipelineSpec, count_of, mean_of
    from ..parallel.spmd import neg_global_ratio

    def head(x, input_ids, labels, *rest):
        ll = _token_log_likelihood(model, model.logits(x), labels)
        if weighted:
            if not rest:
                raise MXNetError(
                    "lm_pipeline(weighted=True) expects batch = "
                    "(input_ids, labels, weights)")
            w = rest[0]
            return ((ll * w).sum(), w.sum())
        return (ll.sum(), count_of(ll))

    def finalize(num, den):
        return neg_global_ratio(num, den) if weighted \
            else -mean_of(num, den)

    return PipelineSpec(
        blocks=model.blocks, head=head, finalize=finalize,
        stem=lambda input_ids, *rest: model.embed(input_ids),
        stem_modules=[model.word_embed, model.position_embed],
        head_modules=[model.ln_f, model.word_embed], name="gpt_lm")


def _ids(ids, device) -> torch.Tensor:
    """Token ids (an NDArray, tensor or array-like) as int64 on
    ``device``."""
    if isinstance(ids, NDArray):
        ids = ids._data
    return torch.as_tensor(ids, device=device).long()


def _draw(last, temperature, generator):
    """The next token of each row: argmax at temperature 0, else a
    categorical draw over ``last / temperature`` from ``generator``."""
    if temperature > 0:
        probs = torch.softmax(last.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(last, dim=-1)


def greedy_generate(model: GPTModel, prompt_ids, max_new_tokens=32,
                    temperature: float = 0.0, generator=None):
    """Fixed-shape autoregressive decode over a pre-allocated
    (B, T0 + max_new_tokens) buffer: the full-prefix forward each step (no
    KV cache), outside recording and training. Greedy at temperature 0;
    otherwise the draw comes from ``generator`` (``mx.random``'s for the
    device by default). Returns the buffer as an int32 ``NDArray``."""
    dev = model.device
    ids = _ids(prompt_ids, dev)
    B, T0 = ids.shape
    total = T0 + int(max_new_tokens)
    if total > model.max_length:
        raise MXNetError(f"decode length {total} exceeds max_length "
                         f"{model.max_length}")
    gen = generator if generator is not None else _random.generator(dev)
    buf = torch.zeros(B, total, dtype=torch.int32, device=dev)
    buf[:, :T0] = ids
    with autograd._ModeScope(recording=False, training=False):
        for t in range(T0, total):
            logits = model(NDArray(buf))._data
            buf[:, t] = _draw(logits[:, t - 1], temperature, gen)
    return NDArray(buf)


def gpt_mini(vocab_size=512, max_length=128, **kwargs) -> GPTModel:
    """Tiny config for tests."""
    return GPTModel(vocab_size=vocab_size, units=128, hidden_size=512,
                    num_layers=2, num_heads=4, max_length=max_length,
                    **kwargs)


def gpt_small(**kwargs) -> GPTModel:
    """GPT-2 small's published widths: vocab 50257, 768 units, 3072 FFN,
    12 layers, 12 heads (D = 64), 1024 positions."""
    return GPTModel(vocab_size=50257, units=768, hidden_size=3072,
                    num_layers=12, num_heads=12, max_length=1024,
                    **kwargs)


# --------------------------------------------------------------------- #
# on the parameters' tensors: shared by the dense KV-cache decode below
# and the serving engine (serve/engine.py), so embedding, norm,
# projection, MLP and head numerics cannot drift between the two caches
# --------------------------------------------------------------------- #

def _linear(dense, x, tp=None):
    """A gluon ``Dense`` (flatten=False) on a tensor; on a tp axis
    (``parallel.spmd.TPAxis``) this rank's tile when its weight's hint
    names tp (``tp_linear``)."""
    bias = None if dense.bias is None else dense.bias._var
    if tp is not None:
        from ..parallel.spmd import tp_linear
        y = tp_linear(x, dense.weight._var, bias,
                      getattr(dense.weight, "_sharding", None), tp,
                      getattr(dense.weight, "_tp_groups", 1))
        if y is not None:
            return y
    return F.linear(x, dense.weight._var, bias)


def _norm(ln, x):
    """A gluon ``LayerNorm`` on a tensor: statistics and affine in f32,
    the output in x's dtype."""
    g = ln.gamma._var
    return F.layer_norm(x.float(), g.shape, g, ln.beta._var,
                        ln._epsilon).to(x.dtype)


def _embed(model: GPTModel, ids, pos):
    """Word + position embeddings in f32, cast to the model dtype."""
    x = F.embedding(ids, model.word_embed.weight._var) + \
        F.embedding(pos, model.position_embed.weight._var)
    return x.to(model.dtype)


def _qkv_heads(attn: CausalSelfAttention, x, tp=None):
    """x (B, T, units) -> q, k, v each (B, T, H, D) (views); on a tp axis
    this rank's H / tp heads."""
    B, T = x.shape[0], x.shape[1]
    H, D = attn._heads, attn._units // attn._heads
    if tp is not None:
        H //= tp.size
    qkv = _linear(attn.qkv, x, tp).reshape(B, T, 3, H, D)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _mlp(blk: GPTBlock, x, tp=None):
    """ln2 -> ffn_in -> exact GELU -> ffn_out (inference: no dropout); on
    a tp axis the hidden units are split and the output summed over
    it."""
    return _linear(blk.ffn_out, F.gelu(_linear(blk.ffn_in,
                                               _norm(blk.ln2, x), tp)), tp)


def _lm_head(model: GPTModel, x):
    """Final norm + tied vocab projection for the decode paths: cast to
    f32 BEFORE ``ln_f`` (norming in bf16 then casting would feed rounded
    activations to the vocab projection). (B, T, units) -> (B, T, V)
    f32."""
    return _norm(model.ln_f, x.float()) @ model.word_embed.weight._var.T


# --------------------------------------------------------------------- #
# dense KV-cache incremental decode
# --------------------------------------------------------------------- #

def init_kv_cache(model: GPTModel, batch_size: int, max_len=None,
                  dtype=None):
    """Fresh zeroed (k, v) buffers (B, Tmax, H, D) for every layer, on
    the model's device."""
    H = model.num_heads
    D = model.units // H
    Tmax = int(max_len or model.max_length)
    dt = model.dtype if dtype is None else _torch_dtype(dtype)
    return [(torch.zeros(batch_size, Tmax, H, D, dtype=dt,
                         device=model.device),
             torch.zeros(batch_size, Tmax, H, D, dtype=dt,
                         device=model.device))
            for _ in range(model.num_layers)]


@torch.no_grad()
def decode_forward(model: GPTModel, ids, caches, start_pos: int,
                   last_only: bool = False):
    """Forward positions [start_pos, start_pos + Tin) against the dense
    caches, which are updated IN PLACE. ids: (B, Tin) int (a tensor or an
    NDArray). Returns (logits, caches): logits (B, Tin, V) f32, or
    (B, 1, V) with ``last_only``."""
    dev = model.device
    ids = _ids(ids, dev)
    B, Tin = ids.shape
    pos = (start_pos + torch.arange(Tin, device=dev)).expand(B, Tin)
    x = _embed(model, ids, pos)
    for blk, (k_buf, v_buf) in zip(model.blocks, caches):
        attn = blk.attn
        q, k, v = _qkv_heads(attn, _norm(blk.ln1, x))
        k_buf[:, start_pos:start_pos + Tin] = k.to(k_buf.dtype)
        v_buf[:, start_pos:start_pos + Tin] = v.to(v_buf.dtype)
        Tmax = k_buf.shape[1]
        pos_q = start_pos + torch.arange(Tin, device=dev)[:, None]
        pos_k = torch.arange(Tmax, device=dev)[None, :]
        mask = (pos_k <= pos_q)[None, None]          # (1, 1, Tin, Tmax)
        out = _sdpa(q, k_buf.to(q.dtype), v_buf.to(q.dtype), mask=mask)
        x = x + _linear(attn.proj, out.reshape(B, Tin, attn._units))
        x = x + _mlp(blk, x)
    if last_only:
        x = x[:, -1:]
    return _lm_head(model, x), caches


@torch.no_grad()
def cached_generate(model: GPTModel, prompt_ids, max_new_tokens=32,
                    temperature: float = 0.0, generator=None):
    """KV-cached autoregressive decode: one prefill pass over the prompt,
    then one single-token forward per step. Greedy at temperature 0,
    categorical over logits / temperature otherwise (``generator`` draws
    the samples). Returns (B, T0 + max_new_tokens) int64 token ids."""
    ids = _ids(prompt_ids, model.device)
    B, T0 = ids.shape
    total = T0 + int(max_new_tokens)
    if total > model.max_length:
        raise MXNetError(f"decode length {total} exceeds max_length "
                         f"{model.max_length}")
    caches = init_kv_cache(model, B, max_len=total)
    logits, caches = decode_forward(model, ids, caches, 0, last_only=True)
    last = logits[:, 0]
    buf = torch.zeros(B, total, dtype=torch.long, device=model.device)
    buf[:, :T0] = ids
    for t in range(T0, total):
        nxt = _draw(last, temperature, generator)
        buf[:, t] = nxt
        if t + 1 < total:
            logits, caches = decode_forward(model, nxt[:, None], caches, t)
            last = logits[:, 0]
    return buf
