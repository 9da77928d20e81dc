"""The port's text primitives and TextFeaturizer against the JAX package's.

The same seeded corpora (numpy, with None and NaN rows, upper case, tabs
and stop words) go through ``mmlspark_tpu.ops.text_ops``/``text_stages``
and the port's copies. Tolerance: none — token lists are equal and every
CSR matrix has the same shape, indptr, indices and data bits; IDF weights
are equal bit for bit.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from mmlspark_tpu.core.dataframe import DataFrame as JaxDataFrame
from mmlspark_tpu.ops import text_ops as jax_text
from mmlspark_tpu.ops import text_stages as jax_stages
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.core.serialize import load_stage
from mmlspark_tpu_torch.ops import text_ops, text_stages

WORDS = ("The", "a", "quick", "brown", "FOX", "jumps", "over", "lazy", "dog",
         "and", "is", "not", "very", "good", "Bad", "x", "of", "it")


def _corpus(n=40, seed=0, gaps=True):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(0, 12))
        toks = list(rng.choice(WORDS, size=k))
        sep = "\t" if i % 7 == 3 else " "
        out.append(sep.join(toks) + ("  ," if i % 5 == 0 else ""))
    out[2] = None
    out[9] = ""
    return out


def _docs(n=40, seed=0):
    return jax_text.tokenize(["" if t is None else t for t in _corpus(n, seed)])


def _same_csr(a, b):
    a, b = a.tocsr(), b.tocsr()
    assert a.shape == b.shape
    for f in ("indptr", "indices", "data"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("pattern,gaps,lower,min_len", [
    (r"\s+", True, True, 1), (r"\s+", True, False, 1), (r"\s+", True, True, 3),
    (r"\w+", False, True, 1), (r"[a-z]+", False, False, 2)])
def test_tokenize(pattern, gaps, lower, min_len):
    texts = ["" if t is None else t for t in _corpus(seed=1)]
    kw = dict(pattern=pattern, gaps=gaps, to_lowercase=lower,
              min_token_length=min_len)
    assert text_ops.tokenize(texts, **kw) == jax_text.tokenize(texts, **kw)


@pytest.mark.parametrize("case_sensitive", [False, True])
def test_remove_stopwords(case_sensitive):
    docs = jax_text.tokenize(["" if t is None else t for t in _corpus()],
                             to_lowercase=False)
    assert text_ops.ENGLISH_STOP_WORDS == jax_text.ENGLISH_STOP_WORDS
    assert (text_ops.remove_stopwords(docs, case_sensitive=case_sensitive)
            == jax_text.remove_stopwords(docs,
                                         case_sensitive=case_sensitive))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_ngrams(n):
    assert text_ops.ngrams(_docs(), n) == jax_text.ngrams(_docs(), n)


@pytest.mark.parametrize("num_features,binary", [
    (1 << 18, False), (1 << 18, True), (16, False), (7, True)])
def test_hashing_tf_same_csr(num_features, binary):
    docs = _docs(seed=2)
    _same_csr(text_ops.hashing_tf(docs, num_features, binary=binary),
              jax_text.hashing_tf(docs, num_features, binary=binary))
    assert all(text_ops.hash_token(t, num_features)
               == jax_text.hash_token(t, num_features) for t in WORDS)


@pytest.mark.parametrize("min_doc_freq", [0, 1, 3])
def test_idf_weights_and_apply(min_doc_freq):
    tf = jax_text.hashing_tf(_docs(seed=3), 64)
    w = text_ops.idf_weights(tf, min_doc_freq)
    jw = jax_text.idf_weights(tf, min_doc_freq)
    assert w.dtype == jw.dtype and np.array_equal(w, jw)
    _same_csr(text_ops.apply_idf(tf, w), jax_text.apply_idf(tf, jw))


def test_csr_row_objects_and_rows_to_matrix():
    tf = jax_text.hashing_tf(_docs(seed=4), 32)
    rows = text_ops.csr_to_row_objects(tf)
    jrows = jax_text.csr_to_row_objects(tf)
    assert len(rows) == len(jrows) == tf.shape[0]
    for a, b in zip(rows, jrows):
        _same_csr(a, b)
    _same_csr(text_ops.rows_to_matrix(rows), jax_text.rows_to_matrix(jrows))


CHAINS = {
    "defaults": {},
    "stopwords_ngrams": {"useStopWordsRemover": True, "useNGram": True,
                         "nGramLength": 2},
    "binary_no_idf": {"binary": True, "useIDF": False, "numFeatures": 128},
    "tokens_pattern": {"tokenizerPattern": r"[a-z]+", "tokenizerGaps": False,
                       "toLowercase": False, "minTokenLength": 2,
                       "numFeatures": 50},
    "min_doc_freq": {"minDocFreq": 4, "numFeatures": 1 << 10,
                     "caseSensitiveStopWords": True,
                     "useStopWordsRemover": True},
}


def _text_frames(texts):
    col = np.array(texts, dtype=object)
    return DataFrame({"text": col}), JaxDataFrame({"text": col.copy()})


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_text_featurizer_same_bits(name):
    texts = _corpus(60, seed=5)
    texts[4] = float("nan")
    df, jdf = _text_frames(texts)
    model = text_stages.TextFeaturizer(**CHAINS[name]).fit(df)
    jmodel = jax_stages.TextFeaturizer(**CHAINS[name]).fit(jdf)
    w, jw = model.getIdfWeights(), jmodel.getIdfWeights()
    assert (w is None) == (jw is None)
    if w is not None:
        assert np.array_equal(w, jw)
    out = text_ops.rows_to_matrix(model.transform(df).col("features"))
    jout = jax_text.rows_to_matrix(jmodel.transform(jdf).col("features"))
    _same_csr(out, jout)


def test_text_featurizer_pre_tokenized_rows():
    docs = _docs(30, seed=6)
    rows = [None if i % 8 == 0 else (tuple(d) if i % 2 else np.array(d))
            for i, d in enumerate(docs)]
    col = np.empty(len(rows), dtype=object)
    col[:] = rows
    kw = {"useTokenizer": False, "numFeatures": 256}
    df, jdf = DataFrame({"text": col}), JaxDataFrame({"text": col.copy()})
    out = text_stages.TextFeaturizer(**kw).fit(df).transform(df)
    jout = jax_stages.TextFeaturizer(**kw).fit(jdf).transform(jdf)
    _same_csr(text_ops.rows_to_matrix(out.col("features")),
              jax_text.rows_to_matrix(jout.col("features")))


def test_text_featurizer_pre_tokenized_rejects_strings():
    df, jdf = _text_frames(["a b", "c"])
    for stage, frame in ((text_stages.TextFeaturizer, df),
                         (jax_stages.TextFeaturizer, jdf)):
        with pytest.raises(TypeError, match="pre-tokenized"):
            stage(useTokenizer=False).fit(frame)


def test_text_featurizer_model_round_trip(tmp_path):
    df, _ = _text_frames(_corpus(20, seed=7))
    model = text_stages.TextFeaturizer(numFeatures=64).fit(df)
    model.save(str(tmp_path / "tf"))
    loaded = load_stage(str(tmp_path / "tf"))
    assert isinstance(loaded, text_stages.TextFeaturizerModel)
    assert np.array_equal(loaded.getIdfWeights(), model.getIdfWeights())
    _same_csr(sp.vstack(list(loaded.transform(df).col("features"))),
              sp.vstack(list(model.transform(df).col("features"))))
