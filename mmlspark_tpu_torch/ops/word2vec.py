"""Word2Vec estimator — the port of ``mmlspark_tpu/ops/word2vec.py``
(notebook-202 parity: the reference's `202 - Amazon Book Reviews - Word2Vec`
notebook uses Spark ML's Word2Vec; MMLSpark ships no re-implementation).

Skip-gram with **negative sampling** (Mikolov et al. 2013b), as in the JAX
package: each step is embedding gathers and one batched dot per
(center, context ± negatives) on ``device`` ("cuda" by default):

    gather E_in[center]  (B,D)
    gather E_out[pos | negs]  (B,1+K,D)
    loss = -logsigmoid(s_pos) - sum logsigmoid(-s_neg),  s = einsum bd,bkd->bk

then the Adam direction (optax's ``scale_by_adam``) with the decayed
learning rate applied outside it. The vocabulary, corpus ids, skip-gram
pairs and unigram table are the JAX package's host code, the same arrays
from the same seed; the embedding init is the same numpy draw.

Two deliberate differences (ROADMAP.md Queue 3):

* the negatives are drawn outside the step, from a ``torch.Generator`` on
  the stage's device seeded from ``seed`` (the JAX step draws them with
  ``jax.random`` inside, and torch cannot reproduce those bits);
* the gathers' gradients are summed per row id in a fixed order — a stable
  sort of the ids, then a segment sum — instead of a scatter-add, whose
  CUDA atomics add in no fixed order. A step repeated on the same inputs
  gives the same bits.

The last batch is not padded to one compiled shape: its loss is the mean
over its real pairs, which is what the JAX step's mask computes.

Model surface follows Spark ML (`Word2VecModel`): ``transform`` averages the
vectors of a document's in-vocab tokens (all-OOV rows get the zero vector),
``findSynonyms`` returns cosine top-k, ``getVectors`` the vocab table — host
numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import (ComplexParam, FloatParam, IntParam, StringParam)
from ..core.pipeline import Estimator, Model
from ..core.utils import object_column


def _tokenized(col) -> list[list[str]]:
    """Accept pre-tokenized rows (Spark requires array<string>) or raw
    strings (whitespace-split convenience)."""
    docs = []
    for row in col:
        if row is None:
            docs.append([])
        elif isinstance(row, str):
            docs.append(row.split())
        elif isinstance(row, (list, tuple, np.ndarray)):
            docs.append([str(t) for t in row])
        else:
            raise TypeError(
                f"Word2Vec input rows must be token lists or strings, "
                f"got {type(row).__name__}")
    return docs


def _build_vocab(docs, min_count):
    counts: dict[str, int] = {}
    for doc in docs:
        for tok in doc:
            counts[tok] = counts.get(tok, 0) + 1
    # frequency-descending, ties lexicographic: deterministic ids
    vocab = sorted((w for w, c in counts.items() if c >= min_count),
                   key=lambda w: (-counts[w], w))
    return vocab, np.array([counts[w] for w in vocab], dtype=np.int64)


def _corpus_ids(docs, word2id):
    """One-time docs -> (token id stream, document id per token); the
    per-epoch work below only resamples windows over these arrays."""
    ids_parts, doc_parts = [], []
    for di, doc in enumerate(docs):
        ids = [word2id[t] for t in doc if t in word2id]
        if len(ids) >= 2:
            ids_parts.append(np.asarray(ids, dtype=np.int32))
            doc_parts.append(np.full(len(ids), di, dtype=np.int64))
    if not ids_parts:
        return (np.empty(0, dtype=np.int32), np.empty(0, dtype=np.int64))
    return np.concatenate(ids_parts), np.concatenate(doc_parts)


def _skipgram_pairs(ids, docm, window, rng):
    """(center, context) int32 pairs with per-position random window
    reduction (word2vec's dynamic window ~ distance down-weighting),
    vectorized over the whole corpus: one numpy pass per distance d, pairing
    i with i±d where the center's sampled span covers d and both positions
    fall in the same document."""
    if len(ids) < 2:
        return (np.empty(0, dtype=np.int32), np.empty(0, dtype=np.int32))
    spans = rng.integers(1, window + 1, size=len(ids))
    centers, contexts = [], []
    for d in range(1, min(window, len(ids) - 1) + 1):
        same = docm[:-d] == docm[d:]
        right = same & (spans[:-d] >= d)   # center i, context i+d
        left = same & (spans[d:] >= d)     # center i+d, context i
        centers.append(ids[:-d][right])
        contexts.append(ids[d:][right])
        centers.append(ids[d:][left])
        contexts.append(ids[:-d][left])
    return (np.concatenate(centers), np.concatenate(contexts))


def _unigram_table(counts, size=1 << 18):
    p = counts.astype(np.float64) ** 0.75
    p /= p.sum()
    # deterministic proportional fill (largest-remainder), then exact top-up
    slots = np.floor(p * size).astype(np.int64)
    rem = size - slots.sum()
    if rem > 0:
        order = np.argsort(-(p * size - slots))
        slots[order[:rem]] += 1
    return np.repeat(np.arange(len(counts), dtype=np.int32), slots)


def _row_sums(ids, rows, n_rows: int):
    """(n_rows, D) sums of ``rows`` by id, added in a fixed order: the rows
    of one id in their original order (a stable sort, then a segment
    sum), so the result does not depend on the device's scheduling."""
    import torch
    order = torch.argsort(ids, stable=True)
    uniq, counts = torch.unique_consecutive(ids[order], return_counts=True)
    out = rows.new_zeros((n_rows, rows.shape[1]))
    out[uniq] = torch.segment_reduce(rows[order], "sum", lengths=counts)
    return out


def _sgns_step(emb_in, emb_out, opt_state, centers, contexts, negs, lr):
    """One SGNS step: ``(emb_in, emb_out, opt_state, loss)`` after the
    update ``emb - lr * scale_by_adam(grad)``. ``centers``/``contexts`` (B,)
    and ``negs`` (B, K) are int64 ids on the tables' device; the loss is the
    mean over the B pairs. The gradient is written out (the loss's
    derivative in each score, then the two gathers' transposes) rather than
    taken by autograd, so the table gradients go through ``_row_sums``."""
    import torch
    import torch.nn.functional as F

    from ..models.trainer import _adam_direction
    n = centers.shape[0]
    v, d = emb_in.shape
    tgt = torch.cat([contexts[:, None], negs], dim=1)             # (B, 1+K)
    v_c = emb_in[centers]                                         # (B, D)
    v_t = emb_out[tgt]                                            # (B, 1+K, D)
    scores = torch.einsum("bd,bkd->bk", v_c, v_t)
    sign = torch.ones_like(scores)
    sign[:, 1:] = -1.0
    denom = float(max(n, 1))
    loss = -F.logsigmoid(sign * scores).sum() / denom
    # d loss / d score = -sign * sigmoid(-sign * score) / B
    dscores = -sign * torch.sigmoid(-sign * scores) / denom
    g_in = _row_sums(centers, torch.einsum("bk,bkd->bd", dscores, v_t), v)
    g_out = _row_sums(tgt.reshape(-1),
                      (dscores[:, :, None] * v_c[:, None, :]).reshape(-1, d),
                      v)
    updates, opt_state = _adam_direction({"in": g_in, "out": g_out},
                                         opt_state)
    return (emb_in - lr * updates["in"], emb_out - lr * updates["out"],
            opt_state, loss)


class _W2VParams:
    inputCol = StringParam("input token-list column", default="text")
    outputCol = StringParam("output document-vector column", default="features")
    vectorSize = IntParam("embedding dimension", default=100, min=1)
    windowSize = IntParam("max skip-gram window", default=5, min=1)
    minCount = IntParam("minimum token frequency", default=5, min=1)
    maxIter = IntParam("training epochs", default=1, min=1)
    stepSize = FloatParam("Adam learning rate (batched SGNS, not Spark's "
                          "per-pair SGD)", default=0.025, min=0.0)
    negativeSamples = IntParam(
        "negatives per positive (this build trains SGNS, not Spark's "
        "hierarchical softmax)", default=5, min=1)
    batchSize = IntParam("pairs per step", default=1 << 14, min=1)
    seed = IntParam("rng seed", default=0)


class Word2VecModel(Model, _W2VParams):
    """Fitted word embeddings: transform averages a document's in-vocab
    word vectors (Spark Word2VecModel semantics); findSynonyms/getVectors
    expose the vocabulary geometry."""

    vocabulary = ComplexParam("vocab words, id order", default=None)
    wordVectors = ComplexParam("(V, D) float32 embeddings", default=None)

    def _word2id(self):
        return {w: i for i, w in enumerate(self.getVocabulary() or [])}

    def getVectors(self) -> DataFrame:
        vecs = np.asarray(self.getWordVectors())
        return DataFrame({
            "word": np.array(list(self.getVocabulary()), dtype=object),
            "vector": object_column([vecs[i] for i in range(len(vecs))])})

    def findSynonyms(self, word: str, num: int) -> DataFrame:
        w2i = self._word2id()
        if word not in w2i:
            raise KeyError(f"'{word}' not in vocabulary")
        vecs = np.asarray(self.getWordVectors(), dtype=np.float64)
        norms = np.linalg.norm(vecs, axis=1) + 1e-12
        q = vecs[w2i[word]] / norms[w2i[word]]
        sims = (vecs / norms[:, None]) @ q
        order = np.argsort(-sims)
        top = order[order != w2i[word]][:num]  # Spark never returns the query
        vocab = list(self.getVocabulary())
        return DataFrame({
            "word": np.array([vocab[i] for i in top], dtype=object),
            "similarity": sims[top].astype(np.float64)})

    def transform(self, df: DataFrame) -> DataFrame:
        docs = _tokenized(df.col(self.getInputCol()))
        w2i = self._word2id()
        vecs = np.asarray(self.getWordVectors(), dtype=np.float32)
        d = vecs.shape[1]
        out = []
        for doc in docs:
            ids = [w2i[t] for t in doc if t in w2i]
            out.append(vecs[ids].mean(axis=0) if ids
                       else np.zeros(d, dtype=np.float32))
        return df.withColumn(self.getOutputCol(), object_column(out))


class Word2Vec(Estimator, _W2VParams):
    """Learn word embeddings by skip-gram negative sampling in batched steps
    on ``device`` (Spark ML Word2Vec surface; notebook-202 workflow)."""
    _uncapturable = True

    device = StringParam(
        "torch device the SGNS steps run on: 'cuda' (default), 'cuda:N' or "
        "'cpu'. Asking for CUDA where there is none raises", default="cuda")

    def _make_model(self, vocab, vectors) -> Word2VecModel:
        model = Word2VecModel()
        model.set(**{k: self.getOrDefault(k) for k in self._params
                     if k in _W2VParams.__dict__})
        model.setVocabulary(list(vocab))
        model.setWordVectors(np.asarray(vectors, dtype=np.float32))
        return model

    def fit(self, df: DataFrame) -> Word2VecModel:
        import torch

        from ..core.env import resolve_device
        from ..models.trainer import _adam_init
        dev = resolve_device(self.getDevice(), "Word2Vec")
        docs = _tokenized(df.col(self.getInputCol()))
        vocab, counts = _build_vocab(docs, self.getMinCount())
        d = self.getVectorSize()
        rng = np.random.default_rng(self.getSeed())
        if not vocab:
            return self._make_model([], np.zeros((0, d), dtype=np.float32))

        word2id = {w: i for i, w in enumerate(vocab)}
        v = len(vocab)
        emb_in = torch.from_numpy(
            (rng.random((v, d), dtype=np.float32) - 0.5) / d).to(dev)
        emb_out = torch.zeros((v, d), dtype=torch.float32, device=dev)
        table = torch.from_numpy(_unigram_table(counts)).to(dev)
        gen = torch.Generator(device=dev).manual_seed(self.getSeed())
        opt_state = _adam_init({"in": emb_in, "out": emb_out})
        bs, k = self.getBatchSize(), self.getNegativeSamples()

        ids, docm = _corpus_ids(docs, word2id)
        for epoch in range(self.getMaxIter()):
            centers, contexts = _skipgram_pairs(
                ids, docm, self.getWindowSize(), rng)
            n = len(centers)
            if n == 0:
                break
            perm = rng.permutation(n)
            # the epoch's pairs cross to the device once
            c_all = torch.from_numpy(centers[perm]).to(dev)
            t_all = torch.from_numpy(contexts[perm]).to(dev)
            # linear lr decay across the whole run, floored like word2vec.c
            for start in range(0, n, bs):
                done = (epoch * n + start) / (self.getMaxIter() * n)
                lr = max(self.getStepSize() * (1.0 - done),
                         self.getStepSize() * 1e-4)
                c = c_all[start:start + bs].long()
                t = t_all[start:start + bs].long()
                negs = table[torch.randint(0, table.shape[0], (len(c), k),
                                           generator=gen, device=dev)].long()
                emb_in, emb_out, opt_state, _ = _sgns_step(
                    emb_in, emb_out, opt_state, c, t, negs, lr)

        return self._make_model(vocab, emb_in.cpu().numpy())
