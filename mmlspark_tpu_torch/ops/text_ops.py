"""Text featurization primitives: tokenize, stopwords, n-grams, hashing TF,
IDF — the port's copy of ``mmlspark_tpu/ops/text_ops.py``.

Reference: text-featurizer builds RegexTokenizer -> StopWordsRemover -> NGram
-> HashingTF -> IDF (TextFeaturizer.scala:274-325). Tokenization and hashing
are host-side string work, as in the JAX package; the numeric tail (TF
matrices, IDF weights, TF-IDF scaling) is scipy CSR on the host, so the same
input gives the same CSR bits in both packages.
"""

from __future__ import annotations

import re
import zlib
from typing import Iterable, Sequence

import numpy as np
import scipy.sparse as sp

# Spark ML's default english stop word list (abridged, stable subset)
ENGLISH_STOP_WORDS = frozenset("""
a about above after again against all am an and any are as at be because been
before being below between both but by could did do does doing down during
each few for from further had has have having he her here hers herself him
himself his how i if in into is it its itself me more most my myself no nor
not of off on once only or other our ours ourselves out over own same she
should so some such than that the their theirs them themselves then there
these they this those through to too under until up very was we were what
when where which while who whom why will with you your yours yourself
yourselves
""".split())


def tokenize(texts: Iterable[str], pattern: str = r"\s+",
             to_lowercase: bool = True, gaps: bool = True,
             min_token_length: int = 1) -> list[list[str]]:
    """Spark RegexTokenizer semantics: `gaps` means the pattern matches
    separators; otherwise it matches tokens."""
    rx = re.compile(pattern)
    out = []
    for t in texts:
        t = t if t is not None else ""
        if to_lowercase:
            t = t.lower()
        toks = rx.split(t) if gaps else rx.findall(t)
        out.append([tok for tok in toks if len(tok) >= min_token_length])
    return out


def remove_stopwords(docs: Sequence[list[str]],
                     stopwords: frozenset = ENGLISH_STOP_WORDS,
                     case_sensitive: bool = False) -> list[list[str]]:
    if case_sensitive:
        return [[t for t in doc if t not in stopwords] for doc in docs]
    low = {w.lower() for w in stopwords}
    return [[t for t in doc if t.lower() not in low] for doc in docs]


def ngrams(docs: Sequence[list[str]], n: int) -> list[list[str]]:
    """Spark NGram: join each n-token window with a space."""
    return [[" ".join(doc[i:i + n]) for i in range(len(doc) - n + 1)]
            for doc in docs]


def hash_token(token: str, num_features: int) -> int:
    """Deterministic, process-stable token hash (crc32 of utf-8 bytes)."""
    return zlib.crc32(token.encode("utf-8")) % num_features


def hashing_tf(docs: Sequence[list[str]], num_features: int = 1 << 18,
               binary: bool = False) -> sp.csr_matrix:
    """Token lists -> (n_docs, num_features) sparse CSR term-frequency matrix."""
    indptr, indices, data = [0], [], []
    for doc in docs:
        counts: dict[int, int] = {}
        for tok in doc:
            h = hash_token(tok, num_features)
            counts[h] = 1 if binary else counts.get(h, 0) + 1
        indices.extend(counts.keys())
        data.extend(counts.values())
        indptr.append(len(indices))
    return sp.csr_matrix(
        (np.asarray(data, dtype=np.float32),
         np.asarray(indices, dtype=np.int64),
         np.asarray(indptr, dtype=np.int64)),
        shape=(len(docs), num_features))


def idf_weights(tf: sp.csr_matrix, min_doc_freq: int = 0) -> np.ndarray:
    """Spark IDF formula: log((m + 1) / (df + 1)); features with
    df < minDocFreq get weight 0."""
    m = tf.shape[0]
    df = np.asarray((tf > 0).sum(axis=0)).ravel().astype(np.float64)
    w = np.log((m + 1.0) / (df + 1.0))
    if min_doc_freq > 0:
        w = np.where(df >= min_doc_freq, w, 0.0)
    return w.astype(np.float32)


def apply_idf(tf: sp.csr_matrix, weights: np.ndarray) -> sp.csr_matrix:
    out = tf.copy()
    out.data = out.data * weights[out.indices]
    return out


def csr_to_row_objects(mat: sp.csr_matrix) -> np.ndarray:
    """CSR matrix -> object column of 1-row CSR slices (sparse row vectors)."""
    from ..core.utils import object_column
    return object_column([mat.getrow(i) for i in range(mat.shape[0])])


def rows_to_matrix(col: np.ndarray):
    """Column of sparse row vectors / dense vectors -> single matrix
    (CSR if sparse, dense float32 otherwise)."""
    if len(col) and sp.issparse(col[0]):
        return sp.vstack(list(col), format="csr")
    from ..core.utils import to_float32_matrix
    return to_float32_matrix(np.asarray(col))
