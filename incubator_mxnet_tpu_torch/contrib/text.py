"""Text utilities: the port of the JAX package's
``incubator_mxnet_tpu/contrib/text.py`` (parity:
python/mxnet/contrib/text/{utils,vocab,embedding}.py).

Token counting, vocabulary indexing, and token embeddings. The vectors
live on the host (numpy) and a lookup returns an NDArray on the current
context (``gpu(0)`` unless a ``with mx.cpu():`` block says otherwise);
file-backed embeddings read local files of the whitespace ``token v1 v2
...`` layout (GloVe-style). Nothing is downloaded."""

from __future__ import annotations

import collections
import os
import re
from typing import Dict, List, Optional, Sequence, Union

import numpy as _np

from ..base import MXNetError
from ..ndarray import NDArray, array as nd_array

__all__ = ["count_tokens_from_str", "Vocabulary", "CustomEmbedding",
           "TokenEmbedding"]


def count_tokens_from_str(source_str: str, token_delim: str = " ",
                          seq_delim: str = "\n", to_lower: bool = False,
                          counter_to_update: Optional[
                              collections.Counter] = None):
    """Tokenize a string and count tokens (reference:
    contrib/text/utils.py count_tokens_from_str)."""
    source_str = re.sub(rf"{re.escape(token_delim)}+|"
                        rf"{re.escape(seq_delim)}+",
                        " ", source_str)
    if to_lower:
        source_str = source_str.lower()
    counter = counter_to_update if counter_to_update is not None \
        else collections.Counter()
    counter.update(t for t in source_str.split(" ") if t)
    return counter


class Vocabulary:
    """Indexed vocabulary (reference: contrib/text/vocab.py Vocabulary).

    Index 0 is the unknown token; ``reserved_tokens`` follow; the rest
    are counter keys sorted by frequency (ties broken alphabetically),
    capped by ``most_freq_count`` and filtered by ``min_freq``."""

    def __init__(self, counter: Optional[collections.Counter] = None,
                 most_freq_count: Optional[int] = None, min_freq: int = 1,
                 unknown_token: str = "<unk>",
                 reserved_tokens: Optional[List[str]] = None):
        if min_freq < 1:
            raise MXNetError("min_freq must be >= 1")
        reserved_tokens = list(reserved_tokens or [])
        if unknown_token in reserved_tokens:
            raise MXNetError("unknown_token must not be reserved")
        if len(set(reserved_tokens)) != len(reserved_tokens):
            raise MXNetError("reserved_tokens must be unique")
        self._unknown_token = unknown_token
        self._reserved_tokens = reserved_tokens
        self._idx_to_token = [unknown_token] + reserved_tokens
        if counter is not None:
            pairs = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
            if most_freq_count is not None:
                pairs = pairs[:most_freq_count]
            for tok, freq in pairs:
                if freq < min_freq or tok == unknown_token \
                        or tok in reserved_tokens:
                    continue
                self._idx_to_token.append(tok)
        self._token_to_idx = {t: i for i, t in
                              enumerate(self._idx_to_token)}

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def idx_to_token(self) -> List[str]:
        return self._idx_to_token

    @property
    def token_to_idx(self) -> Dict[str, int]:
        return self._token_to_idx

    @property
    def unknown_token(self) -> str:
        return self._unknown_token

    @property
    def reserved_tokens(self) -> List[str]:
        return self._reserved_tokens

    def to_indices(self, tokens: Union[str, Sequence[str]]):
        single = isinstance(tokens, str)
        toks = [tokens] if single else list(tokens)
        idx = [self._token_to_idx.get(t, 0) for t in toks]
        return idx[0] if single else idx

    def to_tokens(self, indices: Union[int, Sequence[int]]):
        single = isinstance(indices, int)
        idxs = [indices] if single else list(indices)
        for i in idxs:
            if not 0 <= i < len(self._idx_to_token):
                raise MXNetError(f"index {i} out of vocabulary range")
        toks = [self._idx_to_token[i] for i in idxs]
        return toks[0] if single else toks


class TokenEmbedding(Vocabulary):
    """Token → vector mapping (reference: contrib/text/embedding.py
    _TokenEmbedding). Unknown tokens get ``init_unknown_vec`` (zeros)."""

    def __init__(self, vec_len: int, **kwargs):
        super().__init__(**kwargs)
        self._vec_len = int(vec_len)
        self._idx_to_vec = _np.zeros(
            (len(self._idx_to_token), self._vec_len), _np.float32)

    @property
    def vec_len(self) -> int:
        return self._vec_len

    @property
    def idx_to_vec(self) -> NDArray:
        return nd_array(self._idx_to_vec)

    def get_vecs_by_tokens(self, tokens, lower_case_backup=False):
        single = isinstance(tokens, str)
        toks = [tokens] if single else list(tokens)
        if lower_case_backup:
            toks = [t if t in self._token_to_idx else t.lower()
                    for t in toks]
        idx = [self._token_to_idx.get(t, 0) for t in toks]
        vecs = self._idx_to_vec[_np.asarray(idx, _np.int64)]
        return nd_array(vecs[0] if single else vecs)

    def update_token_vectors(self, tokens, new_vectors):
        toks = [tokens] if isinstance(tokens, str) else list(tokens)
        vecs = new_vectors.asnumpy() if isinstance(new_vectors, NDArray) \
            else _np.asarray(new_vectors)
        vecs = vecs.reshape(len(toks), self._vec_len)
        for t, v in zip(toks, vecs):
            if t not in self._token_to_idx:
                raise MXNetError(f"token {t!r} not in the embedding")
            self._idx_to_vec[self._token_to_idx[t]] = v

    @classmethod
    def from_file(cls, file_path: str, elem_delim: str = " ",
                  **kwargs) -> "TokenEmbedding":
        """Load a GloVe-style text file: ``token v1 v2 ...`` per line."""
        tokens, rows = [], []
        with open(file_path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split(elem_delim)
                if len(parts) < 2:
                    continue
                tokens.append(parts[0])
                rows.append([float(x) for x in parts[1:]])
        if not rows:
            raise MXNetError(f"no embedding vectors in {file_path!r}")
        vec_len = len(rows[0])
        counter = collections.Counter(tokens)
        emb = cls(vec_len, counter=counter, **kwargs)
        for t, r in zip(tokens, rows):
            if len(r) != vec_len:
                raise MXNetError(
                    f"inconsistent vector length for token {t!r}")
            emb._idx_to_vec[emb._token_to_idx[t]] = _np.asarray(
                r, _np.float32)
        return emb


class CustomEmbedding(TokenEmbedding):
    """Embedding built from an in-memory token → vector mapping
    (reference: contrib/text/embedding.py CustomEmbedding)."""

    def __init__(self, token_to_vec: Dict[str, Sequence[float]], **kwargs):
        if not token_to_vec:
            raise MXNetError("empty token_to_vec")
        lens = {len(v) for v in token_to_vec.values()}
        if len(lens) != 1:
            raise MXNetError("all vectors must share one length")
        counter = collections.Counter(token_to_vec.keys())
        super().__init__(lens.pop(), counter=counter, **kwargs)
        for t, v in token_to_vec.items():
            self._idx_to_vec[self._token_to_idx[t]] = _np.asarray(
                v, _np.float32)


# ------------------------------------------------------------------ #
# reference submodule layout (python/mxnet/contrib/text/{embedding,
# vocab,utils}.py): real module objects registered in sys.modules so
# every import form works (`from ...text import embedding`,
# `import ...text.embedding`, `from ...text.embedding import ...`)
# ------------------------------------------------------------------ #
import sys as _sys
import types as _types


def _submodule(name, **names):
    mod = _types.ModuleType(__name__ + "." + name)
    for k, v in names.items():
        setattr(mod, k, v)
    _sys.modules[mod.__name__] = mod
    return mod


embedding = _submodule("embedding", TokenEmbedding=TokenEmbedding,
                       CustomEmbedding=CustomEmbedding)
vocab = _submodule("vocab", Vocabulary=Vocabulary)
utils = _submodule("utils",
                   count_tokens_from_str=count_tokens_from_str)
