"""BERT for pretraining on gluon ``HybridBlock``s: the port of the JAX
package's ``incubator_mxnet_tpu/models/bert.py``.

``BERTSelfAttention``, ``BERTEncoderLayer``, ``BERTModel``,
``BERTForPretraining`` and ``BERTClassifier`` are built from ``gluon.nn``
and written as the JAX model's ``hybrid_forward``s, with the port's
numerics:

  - post-norm encoder layers: x = LN(x + Dropout(proj(attn(x)))), then
    x = LN(x + Dropout(ffn_out(GELU(ffn_in(x))))), exact (erf) GELU;
  - dropout on the attention OUTPUT, not on the probabilities (the flash
    kernels never materialize them); masks drawn from ``mx.random``'s
    generator for the device, in training mode only
    (``autograd.is_training()``);
  - per-parameter dtypes: the qkv, proj, ffn_in and ffn_out Dense layers
    take the model dtype (bf16 for training); the embeddings, LayerNorms,
    pooler, ``mlm_transform``, ``nsp`` and ``mlm_bias`` stay f32;
  - casts: the embedding sum enters the model dtype before ``embed_ln``;
    LayerNorm (eps 1e-12) keeps statistics in f32 and returns the input
    dtype; the [CLS] path is f32; the MLM head runs in f32 and its tied
    decoder matmul in the model dtype;
  - the MLM gather is ``batch_take`` (a gather; the JAX model's one-hot
    ``batch_dot`` is exact too, so the two agree);
  - ``pretraining_loss``: cross entropy as pick - logsumexp with f32
    accumulation (the (B, M, vocab) log-probabilities are never written).

With ``flash=True`` attention takes the flash path (the CUDA kernels on
the card) through the packed (3, B, H, T, D) layout
(``models/_attention.py``). ``bert_base(dtype=, max_length=, flash=,
dropout=)`` then ``initialize()`` is the MXNet contract: parameters land
on the context ``initialize`` is given (the current one by default),
drawn by ``TruncNorm(0.02)`` (zero biases). Parameter names follow the
JAX model's (``collect_params()``), and ``state_dict()`` keys are gluon's
structural names, through which ``models.convert.bert_params_from_jax``
carries the JAX model's weights. ``remat=True | "dots"``
rematerializes each encoder layer in the backward
(``models/_remat.py``: the dropout masks are saved, not redrawn).

``seq_parallel=True`` splits the sequence over the sp axis inside an SPMD
step whose mesh has one (``parallel.SPMDTrainer``): the embeddings run on
the whole sequence, the stream enters the axis before the first layer
(``parallel.constrain``), attention is the plain sp ring with the GLOBAL
valid lengths (``ring_self_attention``), and the sequence output leaves
the axis after the last layer (an all-gather), so the pooler and the
pretraining heads read whole sequences. On a tp axis the Dense layers
read the JAX sharding hints (``parallel.spmd.tp_linear``) and attention
runs on the rank's heads; ``word_embed`` carries the vocabulary hint
(``nn.Embedding(sharded=True)``). Not ported yet: ``pretraining_pipeline``
(the pipelined step, ROADMAP Queue 1 item 11's next slice).
"""

from __future__ import annotations

import torch

from .. import autograd
from ..base import MXNetError
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..gluon.parameter import Parameter
from ..ndarray import NDArray
from .. import initializer as init
from ._attention import (local_heads, packed_flash_self_attention,
                         ring_attention, seq_mesh, tp_axis, tp_dense,
                         tp_hints, use_packed_fast_path)
from ._remat import remat_call, resolve_policy

__all__ = ["BERTModel", "BERTForPretraining", "BERTClassifier",
           "pretraining_loss", "bert_tiny", "bert_base", "bert_large"]


def _trunc():
    return init.TruncNorm(stdev=0.02)


class BERTSelfAttention(HybridBlock):
    """Multi-head self-attention with a fused QKV projection;
    ``seq_parallel=True``: the sp ring with global valid lengths inside an
    SPMD step whose mesh has an sp axis."""

    def __init__(self, units, num_heads, dropout=0.1, dtype="float32",
                 flash=False, seq_parallel=False, **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        self._units = units
        self._heads = num_heads
        self._flash = flash
        self._seq_parallel = seq_parallel
        with self.name_scope():
            self.qkv = nn.Dense(3 * units, in_units=units, flatten=False,
                                dtype=dtype, weight_initializer=_trunc())
            self.proj = nn.Dense(units, in_units=units, flatten=False,
                                 dtype=dtype, weight_initializer=_trunc())
            self.dropout = nn.Dropout(dropout)
        tp_hints(self.qkv, self.proj, parts=3)

    def hybrid_forward(self, F, x, mask=None, valid_length=None):
        B, T = x.shape[0], x.shape[1]
        D = self._units // self._heads
        H, tp = local_heads(self._heads, "BERTSelfAttention")
        units = H * D
        qkv = tp_dense(self.qkv, x, tp).reshape((B, T, 3, H, D))
        vl = valid_length.astype("int32") \
            if valid_length is not None else None
        mesh = seq_mesh(self._seq_parallel, T, "BERTSelfAttention")
        if mesh is not None and mask is not None and vl is None:
            raise MXNetError("BERTSelfAttention(seq_parallel=True): the sp "
                             "ring takes the key mask as valid lengths")
        if mesh is None and self._flash and (
                mask is None or (len(mask.shape) == 2 and vl is not None)) \
                and use_packed_fast_path(D):
            out = packed_flash_self_attention(
                F, qkv, B, T, H, D, units, mask=mask, valid_length=vl)
        else:
            q = qkv.slice_axis(axis=2, begin=0, end=1).reshape((B, T, H, D))
            k = qkv.slice_axis(axis=2, begin=1, end=2).reshape((B, T, H, D))
            v = qkv.slice_axis(axis=2, begin=2, end=3).reshape((B, T, H, D))
            if mesh is not None:
                out = ring_attention(q, k, v, mesh, valid_length=vl)
            else:
                out = F.scaled_dot_product_attention(
                    q, k, v, mask=mask, flash=self._flash, valid_length=vl)
            out = out.reshape((B, T, units))
        return self.dropout(tp_dense(self.proj, out, tp))


class BERTEncoderLayer(HybridBlock):
    def __init__(self, units, hidden_size, num_heads, dropout=0.1,
                 layer_norm_eps=1e-12, dtype="float32", flash=False,
                 seq_parallel=False, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.attention = BERTSelfAttention(units, num_heads, dropout,
                                               dtype=dtype, flash=flash,
                                               seq_parallel=seq_parallel)
            self.ln1 = nn.LayerNorm(epsilon=layer_norm_eps,
                                    in_channels=units)
            self.ffn_in = nn.Dense(hidden_size, in_units=units,
                                   flatten=False, dtype=dtype,
                                   weight_initializer=_trunc())
            self.ffn_out = nn.Dense(units, in_units=hidden_size,
                                    flatten=False, dtype=dtype,
                                    weight_initializer=_trunc())
            self.ln2 = nn.LayerNorm(epsilon=layer_norm_eps,
                                    in_channels=units)
            self.dropout = nn.Dropout(dropout)
        tp_hints(self.ffn_in, self.ffn_out)

    def hybrid_forward(self, F, x, mask=None, valid_length=None):
        tp = tp_axis()
        x = self.ln1(x + self.attention(x, mask, valid_length))
        h = F.gelu(tp_dense(self.ffn_in, x, tp))
        h = self.dropout(tp_dense(self.ffn_out, h, tp))
        return self.ln2(x + h)


class BERTModel(HybridBlock):
    """BERT encoder: embeddings + N transformer layers + pooler.

    forward(input_ids, token_types, valid_length) ->
        (sequence_output (B, T, units) in the model dtype,
         pooled_output (B, units) f32)"""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 type_vocab_size=2, dropout=0.1, layer_norm_eps=1e-12,
                 dtype="float32", flash=False, remat=False,
                 seq_parallel=False, **kwargs):
        resolve_policy(remat)
        if dtype not in ("float32", "bfloat16"):
            raise MXNetError(f"unsupported dtype {dtype!r} (one of "
                             f"['bfloat16', 'float32'])")
        super().__init__(**kwargs)
        self._units = units
        self._dtype = dtype
        self._remat = remat
        self._seq_parallel = seq_parallel
        self.units = units
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.hidden_size = hidden_size
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.flash = flash
        with self.name_scope():
            self.word_embed = nn.Embedding(vocab_size, units, sharded=True,
                                           weight_initializer=_trunc())
            self.token_type_embed = nn.Embedding(
                type_vocab_size, units, weight_initializer=_trunc())
            self.position_embed = nn.Embedding(
                max_length, units, weight_initializer=_trunc())
            self.embed_ln = nn.LayerNorm(epsilon=layer_norm_eps,
                                         in_channels=units)
            self.embed_dropout = nn.Dropout(dropout)
            for i in range(num_layers):
                layer = BERTEncoderLayer(units, hidden_size, num_heads,
                                         dropout, layer_norm_eps,
                                         dtype=dtype, flash=flash,
                                         seq_parallel=seq_parallel)
                self.register_child(layer, f"layer{i}")
            self.pooler = nn.Dense(units, in_units=units, flatten=False,
                                   activation="tanh",
                                   weight_initializer=_trunc())

    def hybrid_forward(self, F, input_ids, token_types=None,
                       valid_length=None):
        B, T = input_ids.shape
        ctx = input_ids.context
        pos = F.arange(0, T, dtype="int32", ctx=ctx).reshape((1, T)) \
            .broadcast_to((B, T))
        emb = self.word_embed(input_ids) + self.position_embed(pos)
        if token_types is not None:
            emb = emb + self.token_type_embed(token_types)
        # enter the compute dtype BEFORE the embedding LN and dropout
        if self._dtype != "float32":
            emb = emb.astype(self._dtype)
        x = self.embed_dropout(self.embed_ln(emb))
        mask = None
        if valid_length is not None:
            ar = F.arange(0, T, dtype="float32", ctx=ctx).reshape((1, T))
            mask = ar < valid_length.astype("float32").reshape((-1, 1))
        seq = seq_mesh(self._seq_parallel, T, "BERTModel")
        if seq is not None:
            # the layers run on this rank's block of the sequence
            from ..parallel.spmd import constrain
            x = constrain(x, ("dp", "fsdp"), "sp", None)
        policy = resolve_policy(self._remat)
        for i in range(self.num_layers):
            layer = getattr(self, f"layer{i}")
            if policy:
                x = remat_call(layer, x, mask, valid_length, policy=policy)
            else:
                x = layer(x, mask, valid_length)
        if seq is not None:
            # the pooler and the heads read whole sequences
            x = constrain(x, ("dp", "fsdp"), None, None,
                          src=(("dp", "fsdp"), "sp", None))
        # the sequence output stays in the compute dtype; only the pooled
        # [CLS] path is promoted
        cls = x.slice_axis(axis=1, begin=0, end=1).reshape(
            (B, self._units)).astype("float32")
        return x, self.pooler(cls)


class BERTForPretraining(HybridBlock):
    """MLM + NSP pretraining heads.

    forward(input_ids, token_types, valid_length, masked_positions) ->
        (mlm_scores (B, M, vocab) in the model dtype, nsp_scores (B, 2))

    The MLM decoder is tied to ``bert.word_embed``."""

    def __init__(self, bert: BERTModel, layer_norm_eps=1e-12, **kwargs):
        super().__init__(**kwargs)
        units = bert._units
        with self.name_scope():
            self.bert = bert
            self.mlm_transform = nn.Dense(units, in_units=units,
                                          flatten=False,
                                          weight_initializer=_trunc())
            self.mlm_ln = nn.LayerNorm(epsilon=layer_norm_eps,
                                       in_channels=units)
            self.mlm_bias = Parameter("mlm_bias", shape=(bert.vocab_size,),
                                      init=init.Zero())
            self.nsp = nn.Dense(2, in_units=units,
                                weight_initializer=_trunc())

    def hybrid_forward(self, F, input_ids, token_types, valid_length,
                       masked_positions, mlm_bias=None):
        seq, pooled = self.bert(input_ids, token_types, valid_length)
        gathered = F.batch_take(seq, masked_positions)
        h = self.mlm_transform(gathered.astype("float32"))
        h = self.mlm_ln(F.gelu(h))
        embed_w = self.bert.word_embed.weight.data()
        from ..parallel.spmd import TPAxis, vocab_split
        tp = vocab_split(TPAxis.of(None), self.bert.vocab_size)
        if tp is not None:
            # this rank's tile of the vocabulary (vocab-split scores)
            embed_w = NDArray(tp.rows(embed_w._data))
            mlm_bias = NDArray(tp.rows(mlm_bias._data))
        dt = self.bert._dtype
        scores = F.dot(h.astype(dt), embed_w.astype(dt), transpose_b=True) \
            + mlm_bias.astype(dt)
        return scores, self.nsp(pooled)


def pretraining_loss(model: BERTForPretraining, input_ids, token_types,
                     valid_length, masked_positions, masked_labels,
                     masked_weights, nsp_labels):
    """Scalar pretraining loss (MLM + NSP) of ``NDArray`` inputs, shaped
    for ``parallel.SPMDTrainer``'s ``forward_loss`` hook."""
    mlm_scores, nsp_scores = model(input_ids, token_types, valid_length,
                                   masked_positions)
    from ..parallel.spmd import TPAxis, split_sum, vocab_ce
    if mlm_scores.shape[-1] != model.bert.vocab_size:
        # vocab-split scores: the pick and the logsumexp over tp
        with torch.set_grad_enabled(autograd.is_recording()):
            score, lse = vocab_ce(mlm_scores._data, masked_labels._data,
                                  TPAxis.of(None))
            mlm_ll = NDArray(score - lse)
    else:
        label_scores = mlm_scores.pick(masked_labels, axis=-1)  # (B, M)
        lse = mlm_scores._op("logsumexp", axis=-1)
        mlm_ll = label_scores.astype("float32") - lse
    weights = masked_weights.astype("float32")
    # inside an SPMD step the MLM ratio is the global batch's: the
    # weight sum over the ranks that split the batch (spmd.split_sum)
    n, total = split_sum(weights.sum()._data)
    if n == 1:
        mlm_loss = -(mlm_ll * weights).sum() / (weights.sum() + 1e-6)
    else:
        mlm_loss = -(mlm_ll * weights).sum() * n / (NDArray(total) + 1e-6)
    nsp_loss = -nsp_scores.log_softmax(axis=-1).pick(nsp_labels,
                                                     axis=-1).mean()
    return mlm_loss + nsp_loss


class BERTClassifier(HybridBlock):
    """Sentence(-pair) classification: dropout and a Dense head over the
    pooled [CLS] output.

    forward(input_ids, token_types, valid_length) -> (B, num_classes)"""

    def __init__(self, bert: BERTModel, num_classes=2, dropout=0.1,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.bert = bert
            self.dropout = nn.Dropout(dropout)
            self.classifier = nn.Dense(num_classes, in_units=bert._units,
                                       weight_initializer=_trunc())

    def hybrid_forward(self, F, input_ids, token_types=None,
                       valid_length=None):
        _, pooled = self.bert(input_ids, token_types, valid_length)
        return self.classifier(self.dropout(pooled))


def bert_tiny(vocab_size=1024, max_length=128, **kwargs) -> BERTModel:
    """Small config for tests."""
    return BERTModel(vocab_size=vocab_size, units=128, hidden_size=512,
                     num_layers=2, num_heads=2, max_length=max_length,
                     **kwargs)


def bert_base(**kwargs) -> BERTModel:
    return BERTModel(vocab_size=30522, units=768, hidden_size=3072,
                     num_layers=12, num_heads=12, **kwargs)


def bert_large(**kwargs) -> BERTModel:
    return BERTModel(vocab_size=30522, units=1024, hidden_size=4096,
                     num_layers=24, num_heads=16, **kwargs)
