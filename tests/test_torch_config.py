"""The port's own copies of the configuration and the homography geometry
equal the JAX package's."""

import dataclasses

import numpy as np
import pytest

import lanedetection_end2end_tpu.config as jax_config
import lanedetection_end2end_tpu.geometry.homography as jax_geo
import lanedetection_end2end_tpu_torch.config as config
import lanedetection_end2end_tpu_torch.geometry.homography as geo
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("preset", ["LaneConfig", "bp_defaults",
                                    "train_sh_config"])
def test_config_fields_and_defaults_match_jax(preset):
    got = getattr(config, preset)()
    want = getattr(jax_config, preset)()
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    for prop in ("image_height", "image_width", "seg_out_channels"):
        assert getattr(got, prop) == getattr(want, prop), prop


def test_config_validation_matches_jax():
    for kw in ({"clas": True, "nclasses": 2}, {"order": 4},
               {"profile": "bev", "order": 3}, {"nclasses": 3}):
        with pytest.raises(ValueError):
            jax_config.LaneConfig(**kw)
        with pytest.raises(ValueError):
            config.LaneConfig(**kw)


@pytest.mark.parametrize("resize,no_mapping", [(64, False), (256, False),
                                               (256, True)])
def test_homographies_match_jax(resize, no_mapping):
    for a, b in zip(geo.bev_matrices_pixel(resize, no_mapping),
                    jax_geo.bev_matrices_pixel(resize, no_mapping)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(geo.bev_matrices_normalized(),
                    jax_geo.bev_matrices_normalized()):
        np.testing.assert_array_equal(a, b)
    M, _ = geo.bev_matrices_pixel(resize, no_mapping)
    for normalized in (False, True):
        np.testing.assert_array_equal(
            geo.projective_grid(M, resize, 2 * resize, normalized),
            jax_geo.projective_grid(M, resize, 2 * resize, normalized))
