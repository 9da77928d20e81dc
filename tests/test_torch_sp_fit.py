"""Sequence-parallel ``TorchLearner`` fits against the JAX package's.

2-rank gloo groups (``tests/torch_dist_workers.py``), the JAX tests'
block-cyclic row split, ``sequenceParallel=2`` with ``spMode`` ring and
ulysses: the ranks' rows gather into one data slice, replicated over the
``seq`` group, and the attention of every block runs as
``make_sp_attention`` (each rank its sequence chunk). Each fit is held
against ``TpuLearner`` with the same knobs on the conftest's 8-device CPU
mesh (data 4 x seq 2), from the same flax init, on the feed path, float32
(causal, so the ring's global positions matter): params within 2e-4,
losses within 1e-5, and the fitted tree the same bits on both ranks.
"""

import numpy as np
import pytest

from torch_dist_workers import run_ranks_async
from test_torch_parallel_fit import _data, _flax_init, _with_init

from mmlspark_tpu.core.dataframe import DataFrame as JaxDataFrame
from mmlspark_tpu.core.utils import object_column as jax_object_column
from mmlspark_tpu.models import TpuLearner
from mmlspark_tpu_torch.models.weights import from_flax_params

CFG = {"type": "transformer", "vocab_size": 17, "d_model": 8, "heads": 2,
       "layers": 1, "num_classes": 2, "max_len": 8, "dtype": "float32",
       "causal": True}
B = 8
MODES = ("ring", "ulysses")


def _jax_fit(tree, mode):
    toks, y = _data()
    df = JaxDataFrame({"features": jax_object_column(
        [r.astype(np.float32) for r in toks]), "label": y})
    lr = (TpuLearner().setModelConfig(CFG).setEpochs(2).setBatchSize(B)
          .setLearningRate(0.05).setShuffle(False).setDeviceDataCap(1)
          .setSequenceParallel(2).setSpMode(mode))
    m = _with_init(tree, lambda: lr.fit(df))
    return from_flax_params(m.getModelParams(), CFG), m._final_loss


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tree = _flax_init(CFG)
    toks, y = _data()
    fits = {mode: dict(cfg=CFG, toks=toks, labels=y, batch=B,
                       knobs={"sequenceParallel": 2, "spMode": mode})
            for mode in MODES}
    ranks = run_ranks_async(2, "fits", tmp_path_factory.mktemp("sp"),
                            flax_params=tree, fits=fits)
    refs = {mode: _jax_fit(tree, mode) for mode in MODES}
    return ranks.result(), refs


@pytest.mark.parametrize("mode", MODES)
def test_sequence_parallel_fit_matches_jax(results, mode):
    (r0, r1), refs = results
    want, loss = refs[mode]
    for k, v in want.items():
        np.testing.assert_allclose(r0[mode]["params"][k], v.numpy(),
                                   atol=2e-4, rtol=0, err_msg=k)
    assert abs(r0[mode]["loss"] - loss) < 1e-5
    for k in r0[mode]["params"]:
        np.testing.assert_array_equal(r0[mode]["params"][k],
                                      r1[mode]["params"][k])
    assert len(r0[mode]["scores"]) == r0[mode]["rows"]
