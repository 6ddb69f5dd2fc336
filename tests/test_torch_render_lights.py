"""Port parity of render_frame's light features, each alone over the bench
scene against the JAX package on the CPU: spot and point shadow maps
(beside the directional light's CSM), light shafts, the skybox and the sky
gradient. The helpers, bars and inputs are test_torch_render_features.py's
(chip_smoke.features_scene, generic orientations, 2 worlds, 32 x 32)."""
import numpy as np
import pytest

from test_torch_render_features import feature_frame


@pytest.mark.parametrize("feature", ["spot", "point", "shafts", "skybox",
                                     "gradient"])
def test_feature_frame_matches_jax(feature):
    color, dem, caps, tt, rt = feature_frame(feature)
    if feature in ("spot", "point"):
        # the map's own pass binned and found casters in every world
        assert (dem.numpy()[:, 4:] > 0).any(1).all()
    if feature in ("skybox", "gradient"):
        sky = color.numpy()[:, 0, 0]                 # the top-left corner
        assert (sky > 0.05).all()
