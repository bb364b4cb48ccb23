#!/usr/bin/env python3
"""Does a row of logits draw the same token in every row of a batch?

    python3 tools/torch_row_alignment.py

On a CUDA card: one row of V = 50257 logits (gpt_small's vocabulary) is
placed in each of the 8 rows of an (8, W, V) batch, the other rows
random, for W = 1 and 5; prints how many of the 8 placements give the
row's softmax bitwise equal to the first placement's, unpadded and
padded with -inf to a multiple of 64 (``serve.sampling.row_aligned``),
and whether ``serve.sampling.sample_inverse_cdf`` draws the same tokens
for 64 uniforms in every placement. With V = 50257 each row of the
batch starts at another 16-byte offset. Needs a CUDA device.
"""

import sys

import torch


def main():
    if not torch.cuda.is_available():
        print("torch_row_alignment: needs a CUDA device", file=sys.stderr)
        return 1
    from incubator_mxnet_tpu_torch.serve.sampling import (
        row_aligned, sample_inverse_cdf)
    V, S = 50257, 8
    gen = torch.Generator(device="cuda").manual_seed(0)
    row = torch.randn(V, device="cuda", generator=gen) * 0.7
    u = torch.rand(64, device="cuda", generator=gen)
    for W in (1, 5):
        plain, padded, draws = [], [], []
        for s in range(S):
            x = torch.randn(S, W, V, device="cuda", generator=gen)
            x[s, 0] = row
            plain.append(torch.softmax(x, dim=-1)[s, 0])
            padded.append(torch.softmax(row_aligned(x), dim=-1)[s, 0])
            draws.append(torch.stack([sample_inverse_cdf(
                x, torch.full((S, W), float(v), device="cuda"))[s, 0]
                for v in u]))
        same = lambda xs: sum(torch.equal(xs[0], x) for x in xs)
        print(f"[rows] W={W}: softmax bitwise equal in {same(plain)}/{S} "
              f"rows unpadded, {same(padded)}/{S} padded; the draw equal "
              f"in {same(draws)}/{S}; {torch.cuda.get_device_name(0)}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
