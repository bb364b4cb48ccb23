"""BERT for pretraining: the port of the JAX package's
``incubator_mxnet_tpu/models/bert.py`` as ``nn.Module``s.

The same modules, widths and numerics:

  - post-norm encoder layers: x = LN(x + Dropout(proj(attn(x)))), then
    x = LN(x + Dropout(ffn_out(GELU(ffn_in(x))))), exact (erf) GELU;
  - dropout on the attention OUTPUT, not on the probabilities (the flash
    kernels never materialize them);
  - per-parameter dtypes: the qkv, proj, ffn_in and ffn_out Linears take
    the model dtype (bf16 for training); the embeddings, LayerNorms,
    pooler, ``mlm_transform``, ``nsp`` and ``mlm_bias`` stay f32;
  - casts: the embedding sum enters the model dtype before ``embed_ln``;
    LayerNorm (eps 1e-12) keeps statistics in f32 and returns the input
    dtype; the [CLS] path is f32; the MLM head runs in f32 and its tied
    decoder matmul in the model dtype;
  - ``pretraining_loss``: cross entropy as pick - logsumexp with f32
    accumulation (the (B, M, vocab) log-probabilities are never written).

With ``flash=True`` attention takes the flash path (the CUDA kernels on
the card) through the packed (3, B, H, T, D) layout. Weights are drawn
from a ``torch.Generator`` (truncated normal, std 0.02; zero biases);
``models.convert.bert_params_from_jax`` copies the JAX model's across.
Dropout masks come from the model's generator. Not ported: ``remat``,
``seq_parallel`` (both raise) and ``BERTClassifier``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..base import MXNetError
from ..context import resolve_device
from ..initializer import TruncNorm, Zero
from .. import random as _random
from ..ops.attention import scaled_dot_product_attention
from ..ops.flash_attention import valid_length_mask
from ._attention import packed_flash_self_attention, use_packed_fast_path
from .gpt import LayerNorm, _torch_dtype

__all__ = ["BERTModel", "BERTForPretraining", "pretraining_loss",
           "bert_tiny", "bert_base", "bert_large"]


class Dropout(nn.Module):
    """Inverted dropout, ``x * mask / keep`` with the mask in x's dtype,
    drawn from the owning model's generator; identity in eval mode."""

    def __init__(self, rate, generator):
        super().__init__()
        self.rate = float(rate)
        self.generator = generator

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.empty_like(x).bernoulli_(keep, generator=self.generator)
        return x * mask / keep


class BERTSelfAttention(nn.Module):
    """Multi-head self-attention with a fused QKV projection."""

    def __init__(self, units, num_heads, dropout, dtype, flash, device,
                 generator):
        super().__init__()
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        self.units, self.heads, self.flash = units, num_heads, flash
        self.qkv = nn.Linear(units, 3 * units, dtype=dtype, device=device)
        self.proj = nn.Linear(units, units, dtype=dtype, device=device)
        self.dropout = Dropout(dropout, generator)

    def forward(self, x, mask=None, valid_length=None):
        B, T = x.shape[0], x.shape[1]
        H, D = self.heads, self.units // self.heads
        qkv = self.qkv(x).reshape(B, T, 3, H, D)
        vl = valid_length.int() if valid_length is not None else None
        if self.flash and (mask is None or
                           (mask.dim() == 2 and vl is not None)) \
                and use_packed_fast_path(D):
            out = packed_flash_self_attention(qkv, B, T, H, D, self.units,
                                              mask=mask, valid_length=vl)
        else:
            out = scaled_dot_product_attention(
                qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mask=mask,
                flash=self.flash, valid_length=vl)
            out = out.reshape(B, T, self.units)
        return self.dropout(self.proj(out))


class BERTEncoderLayer(nn.Module):
    def __init__(self, units, hidden_size, num_heads, dropout,
                 layer_norm_eps, dtype, flash, device, generator):
        super().__init__()
        self.attention = BERTSelfAttention(units, num_heads, dropout, dtype,
                                           flash, device, generator)
        self.ln1 = LayerNorm(units, layer_norm_eps, device)
        self.ffn_in = nn.Linear(units, hidden_size, dtype=dtype,
                                device=device)
        self.ffn_out = nn.Linear(hidden_size, units, dtype=dtype,
                                 device=device)
        self.ln2 = LayerNorm(units, layer_norm_eps, device)
        self.dropout = Dropout(dropout, generator)

    def forward(self, x, mask=None, valid_length=None):
        x = self.ln1(x + self.attention(x, mask, valid_length))
        h = F.gelu(self.ffn_in(x))
        h = self.dropout(self.ffn_out(h))
        return self.ln2(x + h)


class BERTModel(nn.Module):
    """BERT encoder: embeddings + N transformer layers + pooler.

    forward(input_ids, token_types, valid_length) ->
        (sequence_output (B, T, units) in the model dtype,
         pooled_output (B, units) f32)

    ``device`` None means the GPU (raises ``MXNetError`` without one);
    ``generator`` (default: ``random.generator(device)``) draws the
    initial weights and, in training mode, the dropout masks."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 type_vocab_size=2, dropout=0.1, layer_norm_eps=1e-12,
                 dtype="float32", flash=False, remat=False,
                 seq_parallel=False, device=None, generator=None):
        super().__init__()
        if remat:
            raise MXNetError(f"BERTModel(remat={remat!r}): rematerialization "
                             f"is not ported")
        if seq_parallel:
            raise MXNetError("BERTModel(seq_parallel=True): sequence-parallel "
                             "ring attention is not ported")
        device = resolve_device(device)
        self.device = device
        self.dtype = _torch_dtype(dtype)
        self.units = units
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_length = max_length
        self.flash = flash
        self.generator = generator if generator is not None \
            else _random.generator(device)
        gen = self.generator
        self.word_embed = nn.Embedding(vocab_size, units, device=device)
        self.token_type_embed = nn.Embedding(type_vocab_size, units,
                                             device=device)
        self.position_embed = nn.Embedding(max_length, units, device=device)
        self.embed_ln = LayerNorm(units, layer_norm_eps, device)
        self.embed_dropout = Dropout(dropout, gen)
        self.layers = nn.ModuleList(
            BERTEncoderLayer(units, hidden_size, num_heads, dropout,
                             layer_norm_eps, self.dtype, flash, device, gen)
            for _ in range(num_layers))
        self.pooler = nn.Linear(units, units, device=device)
        _init_weights(self, gen)

    def forward(self, input_ids, token_types=None, valid_length=None):
        B, T = input_ids.shape
        ids = input_ids.long()
        pos = torch.arange(T, device=ids.device)
        emb = self.word_embed(ids) + self.position_embed(pos)[None]
        if token_types is not None:
            emb = emb + self.token_type_embed(token_types.long())
        # enter the compute dtype BEFORE the embedding LN and dropout
        x = self.embed_dropout(self.embed_ln(emb.to(self.dtype)))
        mask = None
        if valid_length is not None:
            mask = valid_length_mask(valid_length, T, ids.device)
        for layer in self.layers:
            x = layer(x, mask, valid_length)
        # the sequence output stays in the compute dtype; only the pooled
        # [CLS] path is promoted
        pooled = torch.tanh(self.pooler(x[:, 0].float()))
        return x, pooled


class BERTForPretraining(nn.Module):
    """MLM + NSP pretraining heads.

    forward(input_ids, token_types, valid_length, masked_positions) ->
        (mlm_scores (B, M, vocab) in the model dtype, nsp_scores (B, 2))

    The MLM decoder is tied to ``bert.word_embed``."""

    def __init__(self, bert: BERTModel, layer_norm_eps=1e-12):
        super().__init__()
        units, dev = bert.units, bert.device
        self.bert = bert
        self.mlm_transform = nn.Linear(units, units, device=dev)
        self.mlm_ln = LayerNorm(units, layer_norm_eps, dev)
        self.nsp = nn.Linear(units, 2, device=dev)
        self.mlm_bias = nn.Parameter(torch.zeros(bert.vocab_size,
                                                 device=dev))
        _init_weights(self, bert.generator, skip=(bert,))

    def forward(self, input_ids, token_types, valid_length,
                masked_positions):
        seq, pooled = self.bert(input_ids, token_types, valid_length)
        # gather the masked positions (exact, as the JAX package's one-hot
        # batch_dot is); the head runs in f32
        idx = masked_positions.long()[..., None].expand(
            -1, -1, seq.shape[-1])
        gathered = torch.gather(seq, 1, idx)
        h = self.mlm_ln(F.gelu(self.mlm_transform(gathered.float())))
        dt = self.bert.dtype
        scores = h.to(dt) @ self.bert.word_embed.weight.to(dt).T + \
            self.mlm_bias.to(dt)
        return scores, self.nsp(pooled)


def pretraining_loss(model: BERTForPretraining, input_ids, token_types,
                     valid_length, masked_positions, masked_labels,
                     masked_weights, nsp_labels):
    """Scalar pretraining loss (MLM + NSP), shaped for
    ``parallel.SPMDTrainer``'s ``forward_loss`` hook."""
    mlm_scores, nsp_scores = model(input_ids, token_types, valid_length,
                                   masked_positions)
    V = mlm_scores.shape[-1]
    labels = masked_labels.long().clamp(0, V - 1)
    label_scores = torch.gather(mlm_scores, -1, labels[..., None])[..., 0]
    # logsumexp with f32 accumulation; the max is a constant (no gradient)
    m = mlm_scores.detach().amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp((mlm_scores - m).float()).sum(dim=-1)) + \
        m[..., 0].float()
    mlm_ll = label_scores.float() - lse
    w = masked_weights.float()
    mlm_loss = -(mlm_ll * w).sum() / (w.sum() + 1e-6)
    nsp_logp = F.log_softmax(nsp_scores, dim=-1)
    nsp_loss = -torch.gather(nsp_logp, -1,
                             nsp_labels.long().clamp(0, 1)[:, None])[:, 0] \
        .mean()
    return mlm_loss + nsp_loss


@torch.no_grad()
def _init_weights(module, generator, skip=()):
    """Truncated-normal (std 0.02) Linear and Embedding weights, zero
    biases, in ``gluon_param_order``; LayerNorms keep ones / zeros."""
    from .convert import gluon_param_order
    trunc, zero = TruncNorm(stdev=0.02), Zero()
    skipped = {id(p) for m in skip for p in m.parameters()}
    for name, p in gluon_param_order(module):
        if id(p) in skipped or name.endswith(("gamma", "beta")):
            continue
        if name.endswith("bias"):
            zero(p)
        else:
            trunc(p, generator)


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
