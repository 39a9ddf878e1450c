"""Weights carried from the JAX package into the PyTorch port:
`state_dict_from_variables` is the exact inverse of the JAX package's
`port_torch_state_dict`, and produces exactly the keys and shapes of the
port's `LaneNet` module; `variables_from_state_dict` carries parameters,
statistics or gradients back into the flax tree."""

import jax
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.config import train_sh_config as jax_config
from lanedetection_end2end_tpu.models import LaneNet as JaxLaneNet
from lanedetection_end2end_tpu.models.port import port_torch_state_dict
from lanedetection_end2end_tpu_torch.config import train_sh_config
from lanedetection_end2end_tpu_torch.models.lanenet import LaneNet
from lanedetection_end2end_tpu_torch.models.port import (
    state_dict_from_variables, variables_from_state_dict)


@pytest.fixture(scope="module", params=[32, 64])
def case(request):
    resize = request.param
    v = jax.device_get(JaxLaneNet(jax_config(resize=resize)).init(
        jax.random.PRNGKey(resize)))
    # distinct values everywhere, so a swapped or transposed leaf shows
    rng = np.random.default_rng(resize)
    v = jax.tree_util.tree_map(
        lambda a: rng.normal(size=np.shape(a)).astype(np.float32), v)
    return resize, v, state_dict_from_variables(v)


def test_carrier_inverts_port_torch_state_dict(case):
    resize, v, sd = case
    back = port_torch_state_dict({k: t.numpy() for k, t in sd.items()},
                                 profile="bp", resize=resize)
    want = jax.tree_util.tree_leaves_with_path(v)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_carrier_keys_and_shapes_match_the_module(case):
    resize, _, sd = case
    model = LaneNet(train_sh_config(resize=resize), device="cpu")
    want = model.state_dict()
    assert set(sd) == set(want)
    for k, t in want.items():
        assert sd[k].shape == t.shape and sd[k].dtype == t.dtype, k
    model.load_state_dict(sd)  # strict


def test_conv_transpose_flip_and_flatten_permutation(case):
    """Spot-check the two layout traps against the JAX leaves directly."""
    resize, v, sd = case
    k = np.asarray(v["params"]["erfnet"]["decoder"]["up1"]["conv"]["kernel"])
    w = sd["net.decoder.layers.0.conv.weight"].numpy()  # (I, O, kH, kW)
    np.testing.assert_array_equal(w[:, :, 0, 2], k[2, 0])  # flipped
    rows = resize // 8
    fc = np.asarray(v["params"]["horizon_estimation"]["fc_horizon"]["kernel"])
    wt = sd["horizon_estimation.fully_connected_horizon.weight"].numpy()
    # flax input index r*64 + c  <->  torch input index c*rows + r
    np.testing.assert_array_equal(wt[:, 5 * rows + 1], fc[1 * 64 + 5])
    assert isinstance(sd["net.encoder.layers.0.bn.num_batches_tracked"],
                      torch.Tensor)


def test_variables_from_state_dict_round_trips(case):
    resize, v, sd = case
    back = variables_from_state_dict(sd, resize)
    want = jax.tree_util.tree_leaves_with_path(v)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_variables_from_state_dict_takes_a_subset(case):
    """Gradients: parameters only, and only those that have one."""
    resize, v, sd = case
    named = {k: t for k, t in sd.items()
             if k.startswith("net.decoder.") and k.endswith(".weight")}
    back = variables_from_state_dict(named, resize)
    assert set(back["params"]) == {"erfnet"}
    assert set(back["params"]["erfnet"]) == {"decoder"}
    assert "var" not in str(jax.tree_util.tree_structure(back["batch_stats"]))
    np.testing.assert_array_equal(
        back["params"]["erfnet"]["decoder"]["output_conv"]["kernel"],
        v["params"]["erfnet"]["decoder"]["output_conv"]["kernel"])
