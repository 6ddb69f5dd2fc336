"""Port parity: the UI renderer and per-world HUD of fyrox_tpu_torch
against fyrox_tpu's on the CPU.

Mirrors tests/test_hud.py: bars at seeded fractions, counters at seeded
values, a shared static layer, compose_over, and missing bindings; and
render_ui on a draw list with rects, borders and text in the 5x7 font and
in chip_smoke.write_ttf's TrueType font.
The same inputs go through both packages; the images are held equal to
1e-6 (the blends are the same float32 expressions).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import chip_smoke
from fyrox_tpu.ui.core import DrawCommand as JDrawCommand
from fyrox_tpu.ui.core import Rect as JRect
from fyrox_tpu.ui.hud import Hud as JHud
from fyrox_tpu.ui.renderer import compose_over as jcompose_over
from fyrox_tpu.ui.renderer import render_ui as jrender_ui
from fyrox_tpu_torch.ui import DrawCommand, Hud, Rect, compose_over, render_ui

torch.set_num_threads(2)

TOL = 1e-6


def _commands(cmd_cls, rect_cls):
    return [cmd_cls(kind="rect", bounds=rect_cls(0, 0, 40, 10),
                    color=(0.0, 0.5, 0.0, 0.8)),
            cmd_cls(kind="border", bounds=rect_cls(2, 12, 30, 14),
                    color=(1.0, 1.0, 0.0, 1.0), thickness=2),
            cmd_cls(kind="text", bounds=rect_cls(1, 28, 60, 20),
                    text="HP: 42/100 ok", color=(1, 1, 1, 0.9)),
            cmd_cls(kind="rect", bounds=rect_cls(50, -4, 30, 30),
                    color=(0.2, 0.3, 0.9, 0.5))]


def test_render_ui_equals_jax():
    got = render_ui(_commands(DrawCommand, Rect), 48, 72)
    want = jrender_ui(_commands(JDrawCommand, JRect), 48, 72)
    np.testing.assert_array_equal(got, want)
    assert (got[..., 3] > 0).mean() > 0.2
    # the TrueType path: the same list through a font in both packages
    font = chip_smoke.write_ttf()
    ttf = render_ui(_commands(DrawCommand, Rect), 48, 72, font=font)
    np.testing.assert_array_equal(
        ttf, jrender_ui(_commands(JDrawCommand, JRect), 48, 72, font=font))
    assert not np.array_equal(ttf, got)


def _huds(cls):
    return (cls(48, 96)
            .add_bar("health", x=8, y=6, w=80, h=6,
                     color=(0.9, 0.2, 0.2, 1.0))
            .add_bar("energy", x=8, y=14, w=60, h=4)
            .add_counter("score", x=4, y=22, digits=4, scale=2)
            .add_counter("step", x=60, y=30, digits=3, scale=1,
                         color=(0.2, 1.0, 0.2, 0.8)))


def test_bars_and_counters_equal_jax():
    rng = np.random.default_rng(5)
    w = 6
    vals = {"health": rng.uniform(-0.2, 1.2, w).astype(np.float32),
            "energy": np.asarray([0.0, 0.25, 0.5, 1.0, 0.999, 0.013],
                                 np.float32),
            "score": rng.integers(0, 10_000, w).astype(np.int32),
            "step": rng.uniform(0, 1200, w).astype(np.float32)}
    static = [DrawCommand(kind="rect", bounds=Rect(0, 40, 96, 8),
                          color=(0.0, 0.5, 0.0, 1.0))]
    jstatic = [JDrawCommand(kind="rect", bounds=JRect(0, 40, 96, 8),
                            color=(0.0, 0.5, 0.0, 1.0))]
    hud, jhud = _huds(Hud).add_static(static), _huds(JHud).add_static(
        jstatic)
    got = hud.render({k: torch.as_tensor(v) for k, v in vals.items()})
    want = np.asarray(jhud.render({k: jnp.asarray(v)
                                   for k, v in vals.items()}))
    assert got.shape == (w, 48, 96, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # per-world: different values, different overlays; a second render
    # gives the same and leaves the shared static layer as it was
    assert len({got[i].numpy().tobytes() for i in range(w)}) == w
    again = hud.render({k: torch.as_tensor(v) for k, v in vals.items()})
    assert torch.equal(got, again)
    frames = torch.as_tensor(np.random.default_rng(6).uniform(
        0, 1, (w, 48, 96, 3)).astype(np.float32))
    np.testing.assert_allclose(
        compose_over(frames, got).numpy(),
        np.asarray(jcompose_over(jnp.asarray(frames.numpy()), want)),
        rtol=0, atol=TOL)
    # one shared image composes over every frame
    one = render_ui(static, 48, 96)
    np.testing.assert_allclose(
        compose_over(frames, one).numpy(),
        np.asarray(jcompose_over(jnp.asarray(frames.numpy()), one)),
        rtol=0, atol=TOL)


def test_missing_binding_raises():
    hud, jhud = _huds(Hud), _huds(JHud)
    part = {"health": torch.ones(2), "score": torch.ones(2)}
    for h, v in ((hud, part), (jhud, {k: jnp.asarray(x.numpy())
                                      for k, x in part.items()})):
        with pytest.raises(KeyError, match="energy"):
            h.render(v)
