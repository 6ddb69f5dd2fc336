"""Port parity of the whole features frame against the JAX package on the
CPU: every feature of chip_smoke.FEATURES_FRAME in one frame (2 worlds, 32
x 32). The helpers, bars and inputs are test_torch_render_features.py's;
the JAX package's frame alone compiles for ~50 s here, hence a file of its
own."""
import numpy as np

import chip_smoke
from fyrox_tpu import render as jrender
from fyrox_tpu_torch import convert
from fyrox_tpu_torch.render import render_frame_demand

from test_torch_render_features import assert_frame_close, configs, scene


def test_all_features_match_jax():
    """The features frame (every feature but the gradient and the clipped
    mode) at small size: 2 worlds, 32 x 32, the occlusion prepass, CSM,
    spot and point maps, against the JAX package's render_frame (its
    batched cascades and faces) at the whole-frame bar; the port's audit
    lists the 12 passes, none at its cap (each pass's demand is held to
    the JAX package's in the single-feature frames)."""
    feats = chip_smoke.FEATURES_FRAME
    jt, st, tt, tst = scene(feats)
    jcfg, cfg = configs(feats)
    jrt = jrender.build_render_template(jt)
    jcolor = np.asarray(jrender.render_frame(st, jt, jrt, jcfg)[0])
    color, dem, caps = render_frame_demand(
        tst, tt, convert.render_template(jrt), cfg)
    assert_frame_close(color.numpy(), jcolor)
    assert not np.array_equal(jcolor[0], jcolor[1])
    # prepass, camera, 3 cascades, 1 spot map, 6 point faces
    assert len(caps) == 12 and (dem.numpy() > 0).all()
    assert all(int(d) < k for d, k in zip(dem.numpy().max(0), caps))
