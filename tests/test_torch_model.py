"""The port's TransformerEncoder and TorchModel against the JAX package's.

A flax ``TransformerEncoder`` is initialised from a seed, its params carried
across with ``from_flax_params``, and the same numpy token ids go through
both packages. The JAX side runs ``attn_impl="flash"`` (the Pallas kernel in
interpret mode); the port runs both its flash path (the kernel's plain
version on CPU tensors) and its blockwise path.

Tolerances: float32 at 1e-4 (the same function, summed in another order);
bfloat16 at 3e-2 on activations and logits — both packages round every
Dense output, the embeddings and P to bf16, but at slightly different
places (fused bias adds, per-block vs global softmax max).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JaxDataFrame
from mmlspark_tpu.models.modules import build_model as jax_build_model
from mmlspark_tpu.models.tpu_model import (TpuModel, _coerce_wire_dtype as
                                           jax_coerce, _next_pow2 as jax_pow2)
from mmlspark_tpu_torch import DataFrame, TorchModel
from mmlspark_tpu_torch.core.serialize import load_stage
from mmlspark_tpu_torch.models.modules import build_model
from mmlspark_tpu_torch.models.torch_model import _coerce_wire_dtype, _next_pow2
from mmlspark_tpu_torch.models.weights import from_flax_params
from mmlspark_tpu_torch.ops.flash_attention import flash_attention_fwd

CFG = {"type": "transformer", "vocab_size": 100, "d_model": 64, "heads": 2,
       "layers": 2, "num_classes": 8, "causal": True, "max_len": 128}
T = 64
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


@pytest.fixture(scope="module")
def flax_params():
    """flax init (blockwise: the param tree is the same for every
    attn_impl) as numpy arrays."""
    toks = jnp.zeros((2, T), jnp.int32)
    variables = jax_build_model(dict(CFG, attn_impl="blockwise")).init(
        jax.random.PRNGKey(0), toks)
    return jax.tree_util.tree_map(np.asarray, variables)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, CFG["vocab_size"],
                                             size=(3, T)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_outputs(flax_params, tokens):
    """JAX flash-path outputs, computed once per (dtype, layer)."""
    cache = {}

    def get(dtype, layer):
        if (dtype, layer) not in cache:
            module = jax_build_model(dict(CFG, dtype=dtype, attn_impl="flash"))
            cache[dtype, layer] = np.asarray(module.apply(
                flax_params, jnp.asarray(tokens), output_layer=layer))
        return cache[dtype, layer]
    return get


@pytest.mark.parametrize("impl", ["flash", "blockwise"])
@pytest.mark.parametrize("layer", ["embed", "block0", "logits"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(flax_params, tokens, jax_outputs, dtype, layer,
                             impl):
    cfg = dict(CFG, dtype=dtype, attn_impl=impl)
    model = build_model(cfg)
    model.load_state_dict(from_flax_params(flax_params, cfg))
    with torch.inference_mode():
        out = model(torch.from_numpy(tokens).long(), output_layer=layer)
    ref = jax_outputs(dtype, layer)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_parameters_are_float32_masters(flax_params, tokens, dtype):
    """Every parameter is float32 whatever the compute dtype (flax's
    param_dtype); the compute dtype shows in the activations."""
    cfg = dict(CFG, dtype=dtype, remat=True)
    model = build_model(cfg)
    model.load_state_dict(from_flax_params(flax_params, cfg))
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    with torch.inference_mode():
        emb = model(torch.from_numpy(tokens).long(), output_layer="embed")
    # the tap returns float32; the rows it came from were rounded to dtype
    rounded = emb.to(getattr(torch, dtype)).float()
    assert torch.equal(emb, rounded)


def test_layer_names_match_jax():
    assert (build_model(CFG).layer_names()
            == jax_build_model(CFG).layer_names())


def _score_frames(rows=13, seed=5):
    """13 rows of token ids: with miniBatchSize 8 one full chunk and a
    partial one padded to the next power-of-two bucket."""
    toks = np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], size=(rows, T)).astype(np.int64)
    rows_list = [r for r in toks]
    return (DataFrame({"tokens": rows_list, "id": np.arange(rows)}),
            JaxDataFrame({"tokens": rows_list, "id": np.arange(rows)}))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_model_transform_matches_tpu_model(flax_params, dtype):
    cfg = dict(CFG, dtype=dtype, attn_impl="flash")
    df, jdf = _score_frames()
    common = dict(inputCol="tokens", outputCol="scores", modelConfig=cfg,
                  miniBatchSize=8)
    ref = np.stack(TpuModel(modelParams=flax_params, **common)
                   .transform(jdf).col("scores"))
    model = TorchModel(modelParams=flax_params, device="cpu", **common)
    out_df = model.transform(df)
    out = np.stack(out_df.col("scores"))
    assert out.shape == ref.shape == (13, CFG["num_classes"])
    assert out.dtype == np.float32
    assert out_df.columns == ["tokens", "id", "scores"]
    np.testing.assert_allclose(out, ref, atol=TOL[dtype], rtol=TOL[dtype])


def test_save_load_round_trip_gives_identical_scores(flax_params, tmp_path):
    df, _ = _score_frames(rows=5, seed=6)
    model = TorchModel(inputCol="tokens", modelConfig=CFG, device="cpu",
                       modelParams=flax_params, miniBatchSize=4)
    before = np.stack(model.transform(df).col("scores"))
    model.save(str(tmp_path / "stage"))
    loaded = load_stage(str(tmp_path / "stage"))
    assert isinstance(loaded, TorchModel) and loaded.uid == model.uid
    after = np.stack(loaded.transform(df).col("scores"))
    np.testing.assert_array_equal(before, after)

    # the directory form: {config.json, params.npz}
    model.saveModel(str(tmp_path / "dir"))
    assert sorted(os.listdir(tmp_path / "dir")) == ["config.json",
                                                    "params.npz"]
    fresh = TorchModel(inputCol="tokens", device="cpu", miniBatchSize=4)
    fresh.setModelLocation(str(tmp_path / "dir"))
    np.testing.assert_array_equal(
        np.stack(fresh.transform(df).col("scores")), before)


def test_weights_upload_once_per_params_object(flax_params):
    df, _ = _score_frames(rows=3)
    model = TorchModel(inputCol="tokens", modelConfig=CFG, device="cpu",
                       modelParams=flax_params)
    model.transform(df)
    first = model._dev_module
    model.transform(df)
    assert model._dev_module is first
    model.setModelParams(dict(flax_params))
    model.transform(df)
    assert model._dev_module is not first


def test_warmup_and_output_layer(flax_params):
    df, _ = _score_frames(rows=3)
    model = TorchModel(inputCol="tokens", modelConfig=CFG, device="cpu",
                       modelParams=flax_params, miniBatchSize=16,
                       outputLayer="block1")
    assert model.warmup(df) is model
    emb = np.stack(model.transform(df).col("scores"))
    assert emb.shape == (3, T, CFG["d_model"])
    assert model.layerNames() == ["embed", "block0", "block1", "logits"]


def test_cuda_device_without_a_card_raises(flax_params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    df, _ = _score_frames(rows=3)
    model = TorchModel(inputCol="tokens", modelConfig=CFG,
                       modelParams=flax_params)
    assert model.getDevice() == "cuda"
    before = flash_attention_fwd.launches
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.transform(df)
    assert flash_attention_fwd.launches == before
    assert not hasattr(model, "_dev_module")     # nothing ran on the CPU


def test_unported_paths_raise(flax_params, tmp_path):
    """tensorParallel and MoE are ported (tests/test_torch_parallel.py and
    tests/test_torch_moe.py hold them against the JAX package): with no
    process group the world is one rank, and tensorParallel=2 raises the
    JAX package's mesh error instead of serving unsharded; a MoE config
    builds. The HTTP repository and the export artifact, refused until the
    serving slice, work too (held in tests/test_torch_zoo.py and below):
    an unset model refuses to export, and a server_url makes a
    RemoteRepo."""
    df, _ = _score_frames(rows=3)
    model = TorchModel(inputCol="tokens", modelConfig=CFG, device="cpu",
                       modelParams=flax_params, tensorParallel=2)
    with pytest.raises(ValueError, match=r"model axis \(2\) must divide the "
                       r"device count \(1\)"):
        model.transform(df)
    with torch.device("meta"):
        moe = build_model(dict(CFG, num_experts=4))
    assert moe.blocks[1].moe.num_experts == 4
    from mmlspark_tpu_torch.models.downloader import (ModelDownloader,
                                                      RemoteRepo)
    dl = ModelDownloader(str(tmp_path / "repo"), server_url="http://zoo")
    assert isinstance(dl.remote, RemoteRepo)
    assert dl.remote.base_url == "http://zoo"
    with pytest.raises(ValueError, match="no params"):
        TorchModel().exportStableHLO(str(tmp_path / "x.pt2"))


def test_shape_and_token_range_errors(flax_params):
    with pytest.raises(ValueError, match="divisible"):
        build_model(dict(CFG, heads=3))
    with pytest.raises(ValueError, match="max_len"):
        build_model(CFG)(torch.zeros((1, CFG["max_len"] + 1),
                                     dtype=torch.long))
    bad = DataFrame({"tokens": [np.array([1, 2, CFG["vocab_size"]])]})
    model = TorchModel(inputCol="tokens", modelConfig=CFG, device="cpu",
                       modelParams=flax_params)
    with pytest.raises(ValueError, match="token ids"):
        model.transform(bad)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 100, 4096, 5000])
def test_next_pow2_matches_jax(n):
    assert _next_pow2(n) == jax_pow2(n)


@pytest.mark.parametrize("values", [
    np.array([[1, 2], [3, 4]], np.int64),
    np.array([[0.5, 2.0]], np.float64),
    np.array([[2 ** 40]], np.int64),
])
def test_coerce_wire_dtype_matches_jax(values):
    try:
        ref = jax_coerce(values)
    except ValueError:
        with pytest.raises(ValueError, match="int32 transfer range"):
            _coerce_wire_dtype(values)
        return
    out = _coerce_wire_dtype(values)
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("rows", [0, 1, 7, 8, 29])
def test_windowed_dispatch_matches_tpu_model(flax_params, rows):
    """transform runs every chunk through ``_dispatch_windowed``: 0, 1,
    bs - 1, bs and 3 bs + 5 rows (bs = 8) give the JAX package's scores
    within TOL, and the windowed loop gives the bits of one chunk at a
    time."""
    df, jdf = _score_frames(rows=max(rows, 1), seed=7)
    if rows == 0:
        df = DataFrame({"tokens": np.zeros((0, T), np.int32)})
    common = dict(inputCol="tokens", outputCol="scores", modelConfig=dict(
        CFG, dtype="float32", attn_impl="flash"), miniBatchSize=8)
    model = TorchModel(modelParams=flax_params, device="cpu", **common)
    calls = []
    run_windowed = model._dispatch_windowed

    def spy(chunks, run, dev, window=2):
        chunks = list(chunks)
        calls.append([len(c) for c, _ in chunks])
        return run_windowed(iter(chunks), run, dev, window)

    model._dispatch_windowed = spy
    out = model.transform(df).col("scores")
    if rows == 0:
        assert len(out) == 0 and calls == []
        return
    got = np.stack(out)
    assert got.shape == (rows, CFG["num_classes"])
    assert calls == [[8] * (rows // 8) + ([_next_pow2(rows % 8)]
                                          if rows % 8 else [])]
    ref = np.stack(TpuModel(modelParams=flax_params, **common)
                   .transform(jdf).col("scores"))
    np.testing.assert_allclose(got, ref, atol=TOL["float32"],
                               rtol=TOL["float32"])
    toks = np.stack(df.col("tokens"))
    one = np.concatenate([np.stack(model.transform(DataFrame(
        {"tokens": list(toks[lo:lo + 8])})).col("scores"))
        for lo in range(0, rows, 8)])
    np.testing.assert_array_equal(got, one)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_artifact_scores_like_transform(flax_params, dtype, tmp_path):
    """exportStableHLO -> torch.export.load -> the same scores as
    transform, through the registered flash operator on the CPU. The
    exported sequence length is the config's ``seq_len``, as the JAX
    package's export reads it."""
    cfg = dict(CFG, dtype=dtype, attn_impl="flash", seq_len=T)
    model = TorchModel(inputCol="tokens", modelConfig=cfg, device="cpu",
                       modelParams=flax_params, miniBatchSize=8)
    path = model.exportStableHLO(str(tmp_path / "model.pt2"), batch=8)
    program = torch.export.load(path)
    assert any("mmlspark_torch.flash_attention_fwd" in str(n.target)
               for n in program.graph.nodes)
    df, _ = _score_frames(rows=8, seed=9)
    toks = torch.from_numpy(np.stack(df.col("tokens")).astype(np.int32))
    with torch.inference_mode():
        got = program.module()(toks).numpy()
    want = np.stack(model.transform(df).col("scores"))
    np.testing.assert_allclose(got, want, atol=TOL["float32"], rtol=0)
    (spec,) = [n for n in program.graph.nodes if n.op == "placeholder"
               and n.name.startswith("xb")] or [None]
    assert spec is None or spec.meta["val"].dtype == torch.int32
