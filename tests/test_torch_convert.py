"""umhs_torch.convert: umhs_tpu state -> umhs_torch -> umhs_tpu is bitwise."""

import jax
import numpy as np
import pytest
import torch

from umhs_tpu.models.model import ModelConfig, UMHSModel
from umhs_tpu.ops.occupancy import init_occ_state, mark_all_occupied
from umhs_torch import convert


def _model(method="rgb+spectral"):
    cfg = ModelConfig(method=method, pred_specular=True, grid_resolution=16, grid_levels=2,
                      hash_num_levels=4, log2_hashmap_size=10, max_res=64, march_pool=4)
    return UMHSModel(cfg, list(450.0 + 10.0 * np.arange(8)), num_classes=3, num_images=2)


def _assert_tree_equal(a, b):
    fa, ta = jax.tree_util.tree_flatten(a)
    fb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(fa, fb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("method", ["rgb+spectral", "rgb"])
def test_params_round_trip_is_bitwise(method):
    model = _model(method)
    params, _ = model.init(jax.random.PRNGKey(0), None)
    tparams = convert.params_to_torch(params)
    # layouts kept: (in, out) weights, flat hash table
    w0 = tparams["mlp_base"]["layers"][0]["w"]
    assert tuple(w0.shape) == (model.field_config.hash.output_dim, 64)
    assert tparams["hash_table"].dim() == 1 and tparams["hash_table"].dtype == torch.float32
    _assert_tree_equal(convert.params_to_numpy(tparams), jax.device_get(params))


def test_appearance_embedding_round_trip():
    params = {"appearance_embedding": np.random.default_rng(0).normal(size=(4, 8)).astype(
        np.float32), "endmembers": np.eye(3, 5, dtype=np.float32)}
    _assert_tree_equal(convert.params_to_numpy(convert.params_to_torch(params)), params)


def test_occ_state_round_trip_is_bitwise():
    model = _model()
    params, occ = model.init(jax.random.PRNGKey(1), None)
    occ = jax.jit(lambda o, p, k: model.update_occupancy(o, p, k, full=True))(
        occ, params, jax.random.PRNGKey(2))
    tocc = convert.occ_state_to_torch(occ)
    assert "occ_rows" not in tocc and "pooled_rows" not in tocc
    assert tocc["packed_words"].dtype == torch.int64
    assert int(tocc["packed_words"].max()) < 2**32
    _assert_tree_equal(convert.occ_state_to_numpy(tocc), jax.device_get(occ))


def test_full_occupancy_words_round_trip():
    # all-ones words (0xFFFFFFFF) must survive the int64 trip unchanged
    state = mark_all_occupied(init_occ_state(_model().occ_config))
    back = convert.occ_state_to_numpy(convert.occ_state_to_torch(state))
    assert back["packed_words"].dtype == np.uint32
    assert (back["packed_words"] == np.uint32(0xFFFFFFFF)).all()
    _assert_tree_equal(back, jax.device_get(state))
