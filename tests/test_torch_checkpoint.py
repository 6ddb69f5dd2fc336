"""Port parity: checkpoints of fyrox_tpu_torch against fyrox_tpu's on the
CPU.

A checkpoint is the state's leaves in ``jax.tree.flatten`` order as
``leaf_{i}`` of an .npz (fyrox_tpu/io/checkpoint.py). The port's states
flatten to the same leaves as the JAX package's (the slab flagship, the
same at temporal-reuse period 4 with its candidate cache, the dense
flagship with audio), so a checkpoint that either package writes loads in
the other with equal arrays. A save, load and resume equals the
uninterrupted run bit for bit; a file whose leaves differ is refused; and
state_to_visitor gives the JAX function's bytes for the same state.
"""
import os

import numpy as np
import pytest
import torch
import jax

from fyrox_tpu.io import checkpoint as jckpt
from fyrox_tpu.io.visitor import read_rgs as jread_rgs
from fyrox_tpu.models import build_flagship as jax_build_flagship
from fyrox_tpu_torch import convert
from fyrox_tpu_torch.engine import _leaves, _map
from fyrox_tpu_torch.io import (load_state, read_rgs, save_state,
                                state_to_visitor, write_rgs)
from fyrox_tpu_torch.models import build_flagship
from fyrox_tpu_torch.script import Executor, Script

torch.set_num_threads(2)

SCENES = {"slab": dict(n_bones=4, n_verts=16, n_bodies=192),
          "reuse": dict(n_bones=4, n_verts=16, n_bodies=192,
                        broadphase_period=4),
          "dense-audio": dict(n_bones=4, n_verts=16, n_bodies=8,
                              with_audio=True)}


def _pair(name, monkeypatch):
    kw = dict(SCENES[name])
    if kw.get("broadphase_period", 1) > 1:
        monkeypatch.setenv("FYROX_SLAB_BP_PERIOD", "4")
    jkw = {k: v for k, v in kw.items() if k != "broadphase_period"}
    je, _ = jax_build_flagship(**jkw)
    te, _ = build_flagship(**kw)
    return je, te


def _noisy(tree, seed):
    """Every float leaf moved by seeded noise, every int leaf by a seeded
    permutation of small values: a state whose leaves all differ."""
    rng = np.random.default_rng(seed)

    def f(x):
        x = np.asarray(x)
        if x.dtype.kind == "f":
            return (x + rng.normal(size=x.shape)).astype(x.dtype)
        if x.dtype.kind in "iu":
            return rng.integers(0, 7, x.shape).astype(x.dtype)
        return rng.integers(0, 2, x.shape).astype(x.dtype)
    return jax.tree_util.tree_map(f, tree)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_checkpoints_load_across_packages(name, tmp_path, monkeypatch):
    je, te = _pair(name, monkeypatch)
    js = je.init_state(num_worlds=2)
    ts = te.init_state(2, device="cpu")
    assert [tuple(x.shape) for x in jax.tree_util.tree_leaves(js)] == \
        [tuple(x.shape) for x in _leaves(ts)]
    # the JAX package writes, the port reads
    src = _noisy(js, 1)
    jckpt.save_state(src, str(tmp_path / "j.npz"))
    got = load_state(ts, str(tmp_path / "j.npz"))
    for a, b in zip(_leaves(got), jax.tree_util.tree_leaves(src)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.device == ts.scene.position.device
    # the port writes, the JAX package reads
    tsrc = convert.engine_state(_noisy(js, 2), device="cpu")
    save_state(tsrc, str(tmp_path / "t.npz"))
    back = jckpt.load_state(js, str(tmp_path / "t.npz"))
    for a, b in zip(_leaves(tsrc), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_load_refuses_a_checkpoint_of_other_leaves(tmp_path):
    te, _ = build_flagship(n_bones=4, n_verts=16, n_bodies=8)
    st = te.init_state(2, device="cpu")
    save_state(st.physics, str(tmp_path / "p.npz"))
    with pytest.raises(ValueError, match="checkpoint shape mismatch"):
        load_state(st, str(tmp_path / "p.npz"))
    save_state(te.init_state(3, device="cpu"), str(tmp_path / "w3.npz"))
    with pytest.raises(ValueError, match="checkpoint shape mismatch"):
        load_state(st, str(tmp_path / "w3.npz"))


class Drift(Script):
    """Adds a per-world push to one body each tick; its own state (the
    push) rides in the checkpoint beside the engine state."""

    def __init__(self, w):
        self.push = torch.linspace(0.0, 0.3, w)

    def on_update(self, ctx):
        ph = ctx.state.physics
        lv = ph.linvel.clone()
        lv[:, 1, 0] += self.push
        self.push = self.push * 0.9
        ctx.state = ctx.state._replace(physics=ph._replace(linvel=lv))


def test_save_load_resume_equals_the_uninterrupted_run(tmp_path):
    engine, _ = build_flagship(n_bones=4, n_verts=16, n_bodies=8)
    state = engine.init_state(2, device="cpu")
    whole = Executor(engine, state)
    whole.scripts.add(Drift(2))
    want = whole.run(0.2)                       # 12 ticks
    first = Executor(engine, state)
    drift = first.scripts.add(Drift(2))
    mid = first.run(0.1)
    path = str(tmp_path / "game.npz")
    save_state((mid, (drift.push,)), path)
    fresh = engine.init_state(2, device="cpu")
    loaded, (push,) = load_state((fresh, (torch.zeros(2),)), path)
    second = Executor(engine, loaded)
    resumed = second.scripts.add(Drift(2))
    resumed.push = push
    second.scripts._initialized = True
    got = second.run(0.1)
    for a, b in zip(_leaves(got), _leaves(want)):
        assert torch.equal(a, b)


def test_state_to_visitor_bytes_equal_jax(monkeypatch):
    je, te = _pair("dense-audio", monkeypatch)
    js = _noisy(je.init_state(num_worlds=2), 3)
    ts = convert.engine_state(js, device="cpu")
    for world in (0, 1):
        got = state_to_visitor(ts, te.template, world)
        assert got == jckpt.state_to_visitor(js, je.template, world)
    root, version = read_rgs(got)
    assert version == jread_rgs(got)[1] and write_rgs(root) == got
    assert root.child("Scene").child("Graph").child("Pool").child(
        "Records").field_value("Length") == te.template.num_nodes
