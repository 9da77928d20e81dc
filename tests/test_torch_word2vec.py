"""The port's Word2Vec against the JAX package's.

Host code (tokenizing, vocabulary, corpus ids, skip-gram pairs, unigram
table) gives the same arrays from the same seed: exact. One SGNS step
from the same embeddings, mid-run Adam state and negatives — drawn with
``jax.random`` as the JAX step draws them inside, then passed to the port's
step — matches within 1e-6 relative L2 per array (loss, both tables, both
Adam moments; float32 rounding of the gradients, which Adam's
normalisation scales). The fitted model's transform, findSynonyms and
getVectors give the same results from the same vectors (1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JaxDataFrame
from mmlspark_tpu.ops import word2vec as J
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.core.serialize import load_stage
from mmlspark_tpu_torch.models.trainer import _adam_init
from mmlspark_tpu_torch.ops import word2vec as P

TOL = 1e-6


def _corpus(n=120, seed=0, vocab=40):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]
    p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    p /= p.sum()
    return [" ".join(rng.choice(words, size=int(rng.integers(0, 15)), p=p))
            for _ in range(n)]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_tokenized_rows():
    rows = ["a b  c", None, ("x", "y"), np.array(["p", "q"]), ""]
    col = np.empty(len(rows), dtype=object)
    col[:] = rows
    assert P._tokenized(col) == J._tokenized(col)
    with pytest.raises(TypeError):
        P._tokenized(np.array([1.5], dtype=object))


@pytest.mark.parametrize("min_count", [1, 3, 8])
def test_vocab_and_corpus_ids(min_count):
    docs = P._tokenized(_corpus())
    vocab, counts = P._build_vocab(docs, min_count)
    jvocab, jcounts = J._build_vocab(docs, min_count)
    assert vocab == jvocab and np.array_equal(counts, jcounts)
    w2i = {w: i for i, w in enumerate(vocab)}
    for a, b in zip(P._corpus_ids(docs, w2i), J._corpus_ids(docs, w2i)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("window", [1, 2, 5])
def test_skipgram_pairs(window):
    docs = P._tokenized(_corpus(seed=1))
    vocab, _ = P._build_vocab(docs, 1)
    ids, docm = P._corpus_ids(docs, {w: i for i, w in enumerate(vocab)})
    got = P._skipgram_pairs(ids, docm, window, np.random.default_rng(4))
    want = J._skipgram_pairs(ids, docm, window, np.random.default_rng(4))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("size", [1 << 18, 1000])
def test_unigram_table(size):
    counts = np.random.default_rng(2).integers(1, 500, 77)
    a, b = P._unigram_table(counts, size), J._unigram_table(counts, size)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_row_sums_is_a_fixed_order_scatter_add():
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, 9, 200))
    rows = torch.from_numpy(rng.normal(size=(200, 5)).astype(np.float32))
    got = P._row_sums(ids, rows, 12)
    want = torch.zeros(12, 5).index_add_(0, ids, rows)
    assert torch.equal(got, want)   # the CPU adds in the same order
    assert torch.equal(P._row_sums(ids, rows, 12), got)


@pytest.mark.parametrize("V,D,B,K,seed", [(50, 8, 64, 5, 0),
                                          (300, 16, 512, 5, 1),
                                          (40, 4, 7, 2, 2)])
def test_sgns_step_matches_jax(V, D, B, K, seed):
    """One step from a mid-run state: random tables and Adam moments after
    3 steps, then the same centers, contexts and negatives on both sides."""
    rng = np.random.default_rng(seed)
    ei = (rng.random((V, D), dtype=np.float32) - 0.5) / D
    eo = (rng.normal(size=(V, D)) * 0.1).astype(np.float32)
    mu = [(rng.normal(size=(V, D)) * 1e-3).astype(np.float32)
          for _ in range(2)]
    nu = [(rng.random((V, D)) * 1e-5).astype(np.float32) for _ in range(2)]
    table = J._unigram_table(rng.integers(1, 100, V), size=1 << 10)
    c = rng.integers(0, V, B).astype(np.int32)
    t = rng.integers(0, V, B).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    jstate = J._ADAM.init((jnp.asarray(ei), jnp.asarray(eo)))._replace(
        count=jnp.asarray(3, jnp.int32),
        mu=tuple(map(jnp.asarray, mu)), nu=tuple(map(jnp.asarray, nu)))
    ji, jo, jstate, jl = J._sgns_step(
        jnp.asarray(ei), jnp.asarray(eo), jstate, jnp.asarray(c),
        jnp.asarray(t), jnp.ones(B), key, K, jnp.asarray(table),
        jnp.float32(0.025))
    negs = np.array(jnp.asarray(table)[
        jax.random.randint(key, (B, K), 0, table.shape[0])])
    state = {"count": torch.tensor(3, dtype=torch.int32),
             "mu": {"in": torch.from_numpy(mu[0]),
                    "out": torch.from_numpy(mu[1])},
             "nu": {"in": torch.from_numpy(nu[0]),
                    "out": torch.from_numpy(nu[1])}}
    pi, po, state, pl = P._sgns_step(
        torch.from_numpy(ei), torch.from_numpy(eo), state,
        torch.from_numpy(c).long(), torch.from_numpy(t).long(),
        torch.from_numpy(negs).long(), 0.025)
    assert abs(float(pl) - float(jl)) <= TOL * abs(float(jl))
    assert int(state["count"]) == int(jstate.count) == 4
    for got, want in ((pi, ji), (po, jo),
                      (state["mu"]["in"], jstate.mu[0]),
                      (state["mu"]["out"], jstate.mu[1]),
                      (state["nu"]["in"], jstate.nu[0]),
                      (state["nu"]["out"], jstate.nu[1])):
        assert _rel(got, want) <= TOL


def test_sgns_step_last_batch_loss_is_the_masked_mean():
    """The JAX step pads its last batch and masks it with ``valid``; the
    port runs the real pairs alone and gives the same loss."""
    rng = np.random.default_rng(5)
    V, D, B, K, real = 30, 6, 16, 3, 11
    ei = (rng.random((V, D), dtype=np.float32) - 0.5) / D
    eo = (rng.normal(size=(V, D)) * 0.1).astype(np.float32)
    table = J._unigram_table(rng.integers(1, 50, V), size=512)
    c = np.zeros(B, np.int32)
    t = np.zeros(B, np.int32)
    c[:real], t[:real] = rng.integers(0, V, real), rng.integers(0, V, real)
    valid = (np.arange(B) < real).astype(np.float32)
    key = jax.random.PRNGKey(9)
    _, _, _, jl = J._sgns_step(
        jnp.asarray(ei), jnp.asarray(eo),
        J._ADAM.init((jnp.asarray(ei), jnp.asarray(eo))), jnp.asarray(c),
        jnp.asarray(t), jnp.asarray(valid), key, K, jnp.asarray(table),
        jnp.float32(0.01))
    negs = np.array(jnp.asarray(table)[
        jax.random.randint(key, (B, K), 0, table.shape[0])])[:real]
    st = _adam_init({"in": torch.from_numpy(ei), "out": torch.from_numpy(eo)})
    _, _, _, pl = P._sgns_step(
        torch.from_numpy(ei), torch.from_numpy(eo), st,
        torch.from_numpy(c[:real]).long(), torch.from_numpy(t[:real]).long(),
        torch.from_numpy(negs).long(), 0.01)
    assert abs(float(pl) - float(jl)) <= TOL * abs(float(jl))


@pytest.fixture(scope="module")
def fitted():
    """The JAX package's fitted model, and the port's model on its
    vocabulary and vectors."""
    texts = np.array(_corpus(200, seed=6), dtype=object)
    jmodel = (J.Word2Vec(vectorSize=12, minCount=2, batchSize=256, seed=3)
              .fit(JaxDataFrame({"text": texts})))
    model = (P.Word2VecModel(inputCol="text", outputCol="features")
             .setVocabulary(list(jmodel.getVocabulary()))
             .setWordVectors(np.asarray(jmodel.getWordVectors())))
    return texts, jmodel, model


def test_model_transform_same_vectors(fitted):
    texts, jmodel, model = fitted
    texts = texts.copy()
    texts[0] = "nothing here is known"
    got = np.stack(model.transform(DataFrame({"text": texts})).col("features"))
    want = np.stack(jmodel.transform(
        JaxDataFrame({"text": texts})).col("features"))
    assert np.abs(got - want).max() <= TOL
    assert not got[0].any()


@pytest.mark.parametrize("num", [1, 5])
def test_find_synonyms_and_get_vectors(fitted, num):
    _, jmodel, model = fitted
    word = model.getVocabulary()[3]
    got, want = model.findSynonyms(word, num), jmodel.findSynonyms(word, num)
    assert list(got.col("word")) == list(want.col("word"))
    assert np.abs(got.col("similarity") - want.col("similarity")).max() <= TOL
    assert word not in list(got.col("word"))
    assert list(model.getVectors().col("word")) == list(
        jmodel.getVectors().col("word"))
    with pytest.raises(KeyError):
        model.findSynonyms("not-a-word", num)


def test_fit_on_cpu_vocab_repeat_and_round_trip(tmp_path):
    """The port's fit on the CPU: the JAX package's vocabulary, finite
    vectors, the same bits on a repeat (fixed-order gradient sums, seeded
    negatives), and a save/load round trip."""
    texts = np.array(_corpus(150, seed=7), dtype=object)
    est = P.Word2Vec(vectorSize=8, minCount=2, batchSize=128, seed=1,
                     device="cpu")
    df = DataFrame({"text": texts})
    a, b = est.fit(df), est.fit(df)
    jvocab, _ = J._build_vocab(J._tokenized(texts), 2)
    assert a.getVocabulary() == jvocab
    vecs = a.getWordVectors()
    assert vecs.shape == (len(jvocab), 8) and np.isfinite(vecs).all()
    assert np.array_equal(vecs, b.getWordVectors())
    a.save(str(tmp_path / "w2v"))
    loaded = load_stage(str(tmp_path / "w2v"))
    assert isinstance(loaded, P.Word2VecModel)
    assert np.array_equal(loaded.getWordVectors(), vecs)
    assert loaded.getVocabulary() == a.getVocabulary()


@pytest.mark.parametrize("epochs", [1, 2])
def test_chip_smoke_counts_the_fits_pairs_and_steps(monkeypatch, epochs):
    """chip_smoke.py reports Word2Vec's pairs and steps by running the
    fit's host code again with the seed drawn as the fit draws it: its
    counts are the steps the fit takes and the batches of those pairs."""
    import chip_smoke
    texts = np.array(_corpus(150, seed=5), dtype=object)
    est = P.Word2Vec(vectorSize=8, minCount=2, batchSize=100, seed=3,
                     maxIter=epochs, device="cpu")
    batches = []
    step = P._sgns_step

    def counted(emb_in, emb_out, opt_state, c, t, negs, lr):
        batches.append(len(c))
        return step(emb_in, emb_out, opt_state, c, t, negs, lr)
    monkeypatch.setattr(P, "_sgns_step", counted)
    df = DataFrame({"text": texts})
    model = est.fit(df)
    got = chip_smoke.w2v_pairs_and_steps(model, df)
    assert got["vocabulary"] == len(model.getVocabulary())
    assert len(got["pairs_per_epoch"]) == epochs
    assert got["steps"] == len(batches)
    assert sum(got["pairs_per_epoch"]) == sum(batches)


def test_fit_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert P.Word2Vec().getDevice() == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        P.Word2Vec(minCount=1).fit(DataFrame(
            {"text": np.array(["a b c", "a b"], dtype=object)}))
