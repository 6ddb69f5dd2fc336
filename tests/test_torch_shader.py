"""Port parity: the `.shader` resource contract (``render.shader``) against
the JAX package's ``render.shader``: the same inline shader text parses to
the same definition, and every property group's defaults are the same
values, dtypes and shapes (tensors here, jnp arrays there), exactly.
"""
import numpy as np
import pytest
import torch

from fyrox_tpu.render import shader as jshader
from fyrox_tpu_torch.render import shader

SHADER = r'''(
    name: "Standard2",
    // a pass list as the reference's standard.shader writes it
    passes: [
        (
            name: "GBuffer",
            draw_parameters: DrawParameters(
                cull_face: Some(Back), color_write: ColorMask(red: true,
                green: true, blue: true, alpha: true), depth_write: true,
                stencil_test: None, depth_test: Some(Less), blend: None,
            ),
            vertex_shader: r#"
                layout(location = 0) in vec3 vertexPosition;
                void main() { gl_Position = vec4(vertexPosition, 1.0); }
            "#,
            fragment_shader: "void main() { }",
        ),
        (name: "Forward", vertex_shader: "", fragment_shader: "",
         shade_fn: "forward"),
    ],
    resources: [
        (name: "diffuseTexture",
         kind: Texture(kind: Sampler2D, fallback: White), binding: 0),
        (name: "normalTexture",
         kind: Texture(kind: Sampler2D, fallback: Normal), binding: 1),
        /* the property group: every kind the contract types */
        (
            name: "properties",
            kind: PropertyGroup([
                (name: "texCoordScale", kind: Vector2(value: (1.0, 1.0))),
                (name: "layerIndex", kind: UInt(value: 3)),
                (name: "bias", kind: Int(value: -2)),
                (name: "emissionStrength", kind: Vector3(value: (2.0, 2.0,
                 2.0))),
                (name: "diffuseColor", kind: Color(value: (r: 255, g: 128,
                 b: 0, a: 255))),
                (name: "parallaxScale", kind: Float(value: 0.08)),
                (name: "lit", kind: Bool(value: true)),
                (name: "world", kind: Matrix4()),
                (name: "uvRot", kind: Matrix2(value: [1.0, 0.0, 0.0, 1.0])),
                (name: "weights", kind: FloatArray(value: [0.5, 0.25],
                 max_len: 4)),
                (name: "tints", kind: Vector3Array(value: [(1.0, 0.0, 0.0)],
                 max_len: 2)),
                (name: "plain", kind: Vector4),
            ]),
            binding: 2,
        ),
    ],
    disabled_passes: ["Forward"],
)'''


def same_groups(port, ref):
    assert port.keys() == ref.keys()
    for g in ref:
        assert port[g].keys() == ref[g].keys(), g
        for k, want in ref[g].items():
            got = port[g][k]
            want = np.asarray(want)
            assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
            assert got.numpy().dtype == want.dtype, (g, k)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=k)


def test_parse_ron_matches_jax():
    for text in (SHADER, '(name: "x", n: 3, f: 1.5e-2, on: true, kind: '
                 'White, t: (1, -2.0))', '[(a: 1), (a: 2), B(c: "d")]'):
        assert shader.parse_ron(text) == jshader.parse_ron(text)
    with pytest.raises(ValueError, match="line 2"):
        shader.parse_ron('(a: 1,\n b: ?)')


def test_definition_and_defaults_match_jax():
    got = shader.ShaderDefinition.from_string(SHADER)
    want = jshader.ShaderDefinition.from_string(SHADER)
    assert got.name == want.name == "Standard2"
    assert got.disabled_passes == want.disabled_passes == ["Forward"]
    assert [(p.name, p.draw_parameters, p.vertex_shader, p.fragment_shader,
             p.shade_fn) for p in got.passes] == [
        (p.name, p.draw_parameters, p.vertex_shader, p.fragment_shader,
         p.shade_fn) for p in want.passes]
    assert [(r.name, r.kind, r.binding, r.texture_kind, r.fallback)
            for r in got.resources] == [
        (r.name, r.kind, r.binding, r.texture_kind, r.fallback)
        for r in want.resources]
    assert got.has_texture_resource("normalTexture")
    assert got.find_texture_resource("normalTexture").fallback == "Normal"
    assert not got.has_property_group_resource("diffuseTexture")
    same_groups(got.default_properties(device="cpu"),
                want.default_properties())
    same_groups({"p": got.find_property_group_resource(
        "properties").default_group(device="cpu")},
        {"p": want.find_property_group_resource(
            "properties").default_group()})
    with pytest.raises(ValueError):
        got.resources[0].default_group(device="cpu")


def test_standard_shader_and_registry_match_jax():
    got, want = shader.standard_shader(), jshader.standard_shader()
    assert [p.name for p in got.passes] == [p.name for p in want.passes]
    assert [p.shade_fn for p in got.passes] == ["deferred", "forward"]
    assert [(r.name, r.binding) for r in got.resources] == [
        (r.name, r.binding) for r in want.resources]
    same_groups(got.default_properties(device="cpu"),
                want.default_properties())

    @shader.register_shade_fn("test_pass")
    def doubled(x):
        return x * 2

    assert shader.get_shade_fn("test_pass") is doubled
    assert shader.register_shade_fn("other", torch.neg) is torch.neg
    assert float(shader.get_shade_fn("other")(torch.tensor(2.0))) == -2.0
    assert shader.get_shade_fn("missing") is None
