"""Decoder-only causal language model (GPT-style), inference forward.

The port of ``incubator_mxnet_tpu/models/gpt.py``: the same modules,
widths and numerics as ``nn.Module``s —

  - pre-norm blocks: LN -> causal attention -> residual, LN -> MLP
    (exact GELU) -> residual;
  - LayerNorm statistics and affine in f32 with the output in the input
    dtype (eps 1e-5), gamma/beta kept in f32;
  - f32 embeddings, the activation stream cast to the model dtype after
    them, and an LM head tied to the word embedding;
  - the decode paths' head (``_lm_head``) casts to f32 BEFORE ``ln_f``.

Weights are made from a seed (truncated normal, std 0.02, cut at two
standard deviations; zero biases). ``models.convert.params_from_jax``
copies the JAX model's weights across. Entry points run on the GPU
unless ``device`` says otherwise (``context.resolve_device``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..base import MXNetError
from ..context import resolve_device
from ..initializer import TruncNorm
from ..ops.attention import scaled_dot_product_attention as _sdpa

__all__ = ["GPTModel", "gpt_mini", "gpt_small", "cached_generate",
           "init_kv_cache", "decode_forward"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise MXNetError(f"unsupported dtype {dtype!r} "
                         f"(one of {sorted(_DTYPES)})")
    return _DTYPES[dtype]


class LayerNorm(nn.Module):
    """MXNet LayerNorm: statistics and affine in f32, output cast back to
    the input dtype, so bf16 activations stay bf16."""

    def __init__(self, units, eps=1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(units, device=device))
        self.beta = nn.Parameter(torch.zeros(units, device=device))

    def forward(self, x):
        return F.layer_norm(x.float(), self.gamma.shape, self.gamma,
                            self.beta, self.eps).to(x.dtype)


class CausalSelfAttention(nn.Module):
    def __init__(self, units, num_heads, dtype=torch.float32, device=None):
        super().__init__()
        if units % num_heads:
            raise MXNetError(f"units {units} % heads {num_heads} != 0")
        self.units, self.heads = units, num_heads
        self.qkv = nn.Linear(units, 3 * units, dtype=dtype, device=device)
        self.proj = nn.Linear(units, units, dtype=dtype, device=device)

    def forward(self, x):
        B, T = x.shape[0], x.shape[1]
        q, k, v = _qkv_heads(self, x)
        out = _sdpa(q, k, v, causal=True)
        return self.proj(out.reshape(B, T, self.units))


class GPTBlock(nn.Module):
    """Pre-norm transformer decoder block."""

    def __init__(self, units, hidden_size, num_heads, layer_norm_eps=1e-5,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.ln1 = LayerNorm(units, layer_norm_eps, device)
        self.attn = CausalSelfAttention(units, num_heads, dtype, device)
        self.ln2 = LayerNorm(units, layer_norm_eps, device)
        self.ffn_in = nn.Linear(units, hidden_size, dtype=dtype,
                                device=device)
        self.ffn_out = nn.Linear(hidden_size, units, dtype=dtype,
                                 device=device)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + _mlp(self, x)


class GPTModel(nn.Module):
    """forward(input_ids (B, T)) -> logits (B, T, vocab); the LM head is
    tied to the word embedding. ``device`` None means the GPU (raises
    ``MXNetError`` without one); ``seed`` fixes the random weights."""

    def __init__(self, vocab_size=50257, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=1024,
                 layer_norm_eps=1e-5, dtype="float32", device=None,
                 seed=0):
        super().__init__()
        device = resolve_device(device)
        dt = _torch_dtype(dtype)
        self.vocab_size = vocab_size
        self.units = units
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_length = max_length
        self.dtype = dt
        self.device = device
        self.word_embed = nn.Embedding(vocab_size, units, device=device)
        self.position_embed = nn.Embedding(max_length, units, device=device)
        self.blocks = nn.ModuleList(
            GPTBlock(units, hidden_size, num_heads, layer_norm_eps, dt,
                     device) for _ in range(num_layers))
        self.ln_f = LayerNorm(units, layer_norm_eps, device)
        self.reset_parameters(seed)
        self.eval()
        self.requires_grad_(False)

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        """Truncated-normal weights (std 0.02, cut at +-2 std) from
        ``seed``, zero biases, unit LayerNorm gains."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name.endswith("gamma"):
                p.fill_(1.0)
            elif name.endswith("beta") or name.endswith("bias"):
                p.zero_()
            else:
                TruncNorm(stdev=0.02)(p, gen)

    def embed(self, ids, pos):
        """Word + position embeddings in f32, cast to the model dtype."""
        x = self.word_embed(ids) + self.position_embed(pos)
        return x.to(self.dtype)

    @torch.no_grad()
    def forward(self, input_ids):
        B, T = input_ids.shape
        pos = torch.arange(T, device=input_ids.device).expand(B, T)
        x = self.embed(input_ids, pos)
        for blk in self.blocks:
            x = blk(x)
        x = self.ln_f(x)
        return x @ self.word_embed.weight.to(x.dtype).T


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
# shared by the dense KV-cache decode below and the serving engine
# (serve/engine.py), so projection, MLP and head numerics cannot drift
# between the two caches
# --------------------------------------------------------------------- #

def _qkv_heads(attn: CausalSelfAttention, x):
    """x (B, T, units) -> q, k, v each (B, T, H, D) (views)."""
    B, T = x.shape[0], x.shape[1]
    H, D = attn.heads, attn.units // attn.heads
    qkv = attn.qkv(x).reshape(B, T, 3, H, D)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _mlp(blk: GPTBlock, x):
    """ln2 -> ffn_in -> exact GELU -> ffn_out (inference: no dropout)."""
    return blk.ffn_out(F.gelu(blk.ffn_in(blk.ln2(x))))


def _lm_head(model: GPTModel, x):
    """Final norm + tied vocab projection for the decode paths: cast to
    f32 BEFORE ``ln_f`` (norming in bf16 then casting would feed rounded
    activations to the vocab projection). (B, T, units) -> (B, T, V)
    f32."""
    return model.ln_f(x.float()) @ model.word_embed.weight.T


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
    caches, which are updated IN PLACE. ids: (B, Tin) int. Returns
    (logits, caches): logits (B, Tin, V) f32, or (B, 1, V) with
    ``last_only``."""
    B, Tin = ids.shape
    dev = model.device
    ids = ids.to(dev).long()
    pos = (start_pos + torch.arange(Tin, device=dev)).expand(B, Tin)
    x = model.embed(ids, pos)
    for blk, (k_buf, v_buf) in zip(model.blocks, caches):
        attn = blk.attn
        q, k, v = _qkv_heads(attn, blk.ln1(x))
        k_buf[:, start_pos:start_pos + Tin] = k.to(k_buf.dtype)
        v_buf[:, start_pos:start_pos + Tin] = v.to(v_buf.dtype)
        Tmax = k_buf.shape[1]
        pos_q = start_pos + torch.arange(Tin, device=dev)[:, None]
        pos_k = torch.arange(Tmax, device=dev)[None, :]
        mask = (pos_k <= pos_q)[None, None]          # (1, 1, Tin, Tmax)
        out = _sdpa(q, k_buf.to(q.dtype), v_buf.to(q.dtype), mask=mask)
        x = x + attn.proj(out.reshape(B, Tin, attn.units))
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
    ids = torch.as_tensor(prompt_ids, device=model.device).long()
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
        if temperature > 0:
            probs = torch.softmax(last / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(last, dim=-1)
        buf[:, t] = nxt
        if t + 1 < total:
            logits, caches = decode_forward(model, nxt[:, None], caches, t)
            last = logits[:, 0]
    return buf
