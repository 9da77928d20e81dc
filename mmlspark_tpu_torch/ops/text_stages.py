"""TextFeaturizer estimator — the port of ``mmlspark_tpu/ops/text_stages.py``
(reference: text-featurizer/.../TextFeaturizer.scala:179,274-325): a
toggleable tokenize -> stopwords -> ngram -> hashingTF -> IDF chain fit as
one stage. Host work on scipy CSR, as in the JAX package.

A ``parallel.dataplane.ShardedDataFrame`` in a world of more than one rank
fits the fleet-wide IDF: the document frequencies and the corpus size sum
over every rank's shard in one collective, so every rank holds the same
weights.
"""

from __future__ import annotations

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import (BooleanParam, ComplexParam, IntParam, StringParam)
from ..core.pipeline import Estimator, Model
from . import text_ops


class _TextChainParams:
    """Shared param block between estimator and model."""
    useTokenizer = BooleanParam("tokenize the input text", default=True)
    tokenizerPattern = StringParam("regex for the tokenizer", default=r"\s+")
    tokenizerGaps = BooleanParam("pattern matches gaps (else tokens)", default=True)
    toLowercase = BooleanParam("lowercase before tokenizing", default=True)
    minTokenLength = IntParam("minimum token length", default=1, min=0)
    useStopWordsRemover = BooleanParam("remove stop words", default=False)
    caseSensitiveStopWords = BooleanParam("case sensitive stop words", default=False)
    useNGram = BooleanParam("emit n-grams", default=False)
    nGramLength = IntParam("n-gram length", default=2, min=1)
    binary = BooleanParam("binary term frequencies", default=False)
    numFeatures = IntParam("hash feature dimension", default=1 << 18, min=1)
    useIDF = BooleanParam("scale by inverse document frequency", default=True)
    minDocFreq = IntParam("minimum doc frequency for IDF", default=1, min=0)


def _featurize_tokens(params, texts):
    if params.getOrDefault("useTokenizer"):
        docs = text_ops.tokenize(
            ["" if t is None or t != t else str(t) for t in texts],
            pattern=params.getOrDefault("tokenizerPattern"),
            to_lowercase=params.getOrDefault("toLowercase"),
            gaps=params.getOrDefault("tokenizerGaps"),
            min_token_length=params.getOrDefault("minTokenLength"))
    else:
        docs = []
        for t in texts:
            if t is None:
                docs.append([])
            elif isinstance(t, (list, tuple, np.ndarray)):
                docs.append([str(x) for x in t])
            else:
                raise TypeError(
                    "useTokenizer=False requires pre-tokenized rows "
                    f"(list/tuple/array of tokens), got {type(t).__name__}")
    if params.getOrDefault("useStopWordsRemover"):
        docs = text_ops.remove_stopwords(
            docs, case_sensitive=params.getOrDefault("caseSensitiveStopWords"))
    if params.getOrDefault("useNGram"):
        docs = text_ops.ngrams(docs, params.getOrDefault("nGramLength"))
    return text_ops.hashing_tf(docs, params.getOrDefault("numFeatures"),
                               binary=params.getOrDefault("binary"))


class TextFeaturizerModel(Model, _TextChainParams):
    inputCol = StringParam("input text column", default="text")
    outputCol = StringParam("output feature column", default="features")
    idfWeights = ComplexParam("fitted IDF weights", default=None)

    def transform(self, df: DataFrame) -> DataFrame:
        tf = _featurize_tokens(self, df.col(self.getInputCol()))
        w = self.getIdfWeights()
        if self.getUseIDF() and w is not None:
            tf = text_ops.apply_idf(tf, np.asarray(w))
        return df.withColumn(self.getOutputCol(),
                             text_ops.csr_to_row_objects(tf))


class TextFeaturizer(Estimator, _TextChainParams):
    inputCol = StringParam("input text column", default="text")
    outputCol = StringParam("output feature column", default="features")

    def fit(self, df: DataFrame) -> TextFeaturizerModel:
        model = TextFeaturizerModel()
        model.set(**{k: self.getOrDefault(k) for k in self._params
                     if k not in ("idfWeights",)})
        if self.getUseIDF():
            tf = _featurize_tokens(self, df.col(self.getInputCol()))
            from ..parallel import dataplane
            if dataplane.is_sharded(df):
                # fleet-wide IDF: document frequencies and the corpus size
                # sum across shards in one collective (Spark's IDF
                # aggregates over the whole cluster the same way)
                df_local = np.asarray((tf > 0).sum(axis=0)).ravel() \
                    .astype(np.float64)
                tot = dataplane.allreduce_sum(
                    np.concatenate([[float(tf.shape[0])], df_local]))
                m, dfreq = tot[0], tot[1:]
                w = np.log((m + 1.0) / (dfreq + 1.0))
                if self.getMinDocFreq() > 0:
                    w = np.where(dfreq >= self.getMinDocFreq(), w, 0.0)
                model.setIdfWeights(w.astype(np.float32))
            else:
                model.setIdfWeights(
                    text_ops.idf_weights(tf, self.getMinDocFreq()))
        return model
