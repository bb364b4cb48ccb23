"""Analytic training FLOPs and the card's peak, for MFU: the port of the
JAX package's ``incubator_mxnet_tpu/utils/flops.py``
(``transformer_train_flops``) and of ``bench.py``'s BERT and GPT counts
(``_bert_flops_per_step``, which charges the MLM head only for the M
masked positions it runs on, and ``_gpt_flops_per_step``).

``peak_flops`` reads a table keyed by ``torch.cuda.get_device_name()``
(dense bf16 tensor-core rates from the vendor's data sheets). An unknown
card raises: an MFU against a guessed peak is not a measurement.
"""

from __future__ import annotations

from ..base import MXNetError

__all__ = ["transformer_train_flops", "bert_train_flops", "gpt_train_flops",
           "peak_flops", "PEAK_BF16_FLOPS"]

# dense bf16 FLOP/s (NVIDIA H100 SXM data sheet, at its 700 W limit)
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}


def transformer_train_flops(n_matmul_params: int, n_layers: int,
                            units: int, seq_len: int,
                            tokens: int) -> float:
    """Forward + backward FLOPs for ``tokens`` tokens of a transformer
    with ``n_matmul_params`` matmul-visible parameters: 6 P per token for
    the parameter matmuls plus 12 L T d per token for the attention score
    and value products (forward 2, backward 4 of each)."""
    return float(tokens) * (6.0 * n_matmul_params
                            + 12.0 * n_layers * seq_len * units)


def bert_train_flops(batch, seq_len, masked, num_layers, units, hidden,
                     vocab) -> float:
    """Forward + backward FLOPs of one BERT pretraining step (6x matmul
    rule): the encoder's matmuls, the O(T^2) attention, and the MLM
    (M positions: transform and tied decoder) and NSP heads. Embedding
    gathers are not matmul FLOPs and are left out. At full length: the
    attention term counts every key, masked or not."""
    B, T, M, L = batch, seq_len, masked, num_layers
    enc = 6.0 * B * T * L * (4 * units * units + 2 * units * hidden)
    attn = 12.0 * L * B * T * T * units
    heads = 6.0 * B * M * units * (vocab + units) + 6.0 * B * (
        units * units + 2 * units)
    return enc + attn + heads


def gpt_train_flops(batch, seq_len, num_layers, units, hidden,
                    vocab) -> float:
    """Forward + backward FLOPs of one causal-LM training step (6x matmul
    rule): the decoder's matmuls, the causal attention (half of the
    O(T^2) products) and the full-vocabulary LM head; embedding gathers
    left out."""
    B, T, L = batch, seq_len, num_layers
    dec = 6.0 * B * T * L * (4 * units * units + 2 * units * hidden)
    attn = 6.0 * L * B * T * T * units
    head = 6.0 * B * T * units * vocab
    return dec + attn + head


def peak_flops(device_name: str = None) -> float:
    """Dense bf16 peak FLOP/s of ``device_name`` (default: CUDA device 0);
    raises ``MXNetError`` for a card the table does not hold."""
    if device_name is None:
        import torch
        if not torch.cuda.is_available():
            raise MXNetError("peak_flops: no CUDA device")
        device_name = torch.cuda.get_device_name(0)
    if device_name not in PEAK_BF16_FLOPS:
        raise MXNetError(f"peak_flops: no peak known for {device_name!r} "
                         f"(known: {sorted(PEAK_BF16_FLOPS)})")
    return PEAK_BF16_FLOPS[device_name]
