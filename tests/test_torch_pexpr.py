"""The port's PExpr engine (`texture/pexpr.py`) against the JAX package's.

Parse trees must be equal.  Every entry of the JAX package's function table
has a case of its own (parametrised over the table's keys, so that a builtin
the port lacks fails), on lane inputs made with numpy from a seed.
Tolerances: rtol 1e-5 and atol 1e-5 (transcendental functions round
differently in torch and XLA, and some builtins subtract nearly equal
values), NaN at the same places, the same result kind; integer `/` and `%`
and the cast of a float to int equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignis_tpu.texture import pexpr as jp
from ignis_tpu_torch.texture import pexpr as tp

N = 96
TOL = dict(rtol=1e-5, atol=1e-5)


def _tree(node):
    return (node.op, node.value, tuple(_tree(a) for a in node.args))


EXPRS = [
    "1 + 2 * 3 ^ 2 - -4 % 3",
    "a || b && !c == (d != e) < f <= g > h >= i",
    "vec3(uv.x, uv.y * 2.5e-1, .5).zyx + color(1, 0, 0).rgb",
    "mix(tex(uv * 2).rgb, hsvtorgb(color(lookup('linear', false, "
    "noise(uv * 8), vec2(0, 0.05), vec2(1, 0.6)), 0.6, 0.8)).rgb, 0.5)",
    "ensure_valid_reflection(Ng, V, bump(N, Nx, Ny, 0.2, noise(uv) - 0.5,"
    " 1e3))",
    'select(check_ray_flag("camera"), 1, 2) + +3 - f()',
]


@pytest.mark.parametrize("src", EXPRS)
def test_parse_trees_equal(src):
    assert jp.tokenize(src) == tp.tokenize(src)
    assert _tree(jp.parse_pexpr(src)) == _tree(tp.parse_pexpr(src))


@pytest.mark.parametrize("src", ["1 +", "(1", "1 2", "$", "a.(b)"])
def test_parse_errors_match(src):
    with pytest.raises(jp.PExprError):
        jp.parse_pexpr(src)
    with pytest.raises(tp.PExprError):
        tp.parse_pexpr(src)


def test_parse_once_then_cached():
    src = "vec2(uv.y, uv.x) * 3"
    assert tp.parse_cached(src) is tp.parse_cached(src)


# ----------------------------------------------------------- the builtins
def _gen(seed):
    rng = np.random.default_rng(seed)

    def num(lo=-3.0, hi=3.0):
        return ("num", rng.uniform(lo, hi, N).astype(np.float32))

    def vec(n, lo=-3.0, hi=3.0, unit=False):
        v = rng.uniform(lo, hi, (N, n)).astype(np.float32)
        if unit:
            v /= np.linalg.norm(v, axis=-1, keepdims=True)
        return (f"vec{n}", v)

    def integer(lo=-5, hi=6):
        return ("int", rng.integers(lo, hi, N).astype(np.int32))

    def boolean():
        return ("bool", rng.uniform(size=N) < 0.5)
    return num, vec, integer, boolean


def _args(name, seed):
    num, vec, integer, boolean = _gen(seed)
    unary = ("sin", "cos", "tan", "asin", "acos", "atan", "exp", "exp2",
             "log", "log2", "log10", "floor", "ceil", "round", "fract",
             "trunc", "sqrt", "cbrt", "abs", "sign", "rad", "deg")
    binary = ("atan2", "min", "max", "fmod", "pow", "snap", "pingpong")
    noise = ("noise", "snoise", "pnoise", "cellnoise", "perlin", "sperlin",
             "voronoi", "fbm", "cnoise", "cpnoise", "ccellnoise", "cperlin",
             "cvoronoi", "cfbm", "checkerboard")
    conv = ("rgbtoxyz", "xyztorgb", "rgbtohsv", "hsvtorgb", "rgbtohsl",
            "hsltorgb")
    if name in unary:
        return [vec(3)]
    if name in binary:
        return [vec(3), num(0.2, 2.0)]
    if name in noise:
        return [vec(2, -40.0, 40.0)]
    if name in conv:
        return [vec(4, 0.0, 1.0)]
    if name.startswith("mix_"):
        return [vec(4, 0.0, 1.0), vec(4, 0.0, 1.0), num(0.0, 1.0)]
    if name in ("vec2", "vec3", "vec4", "color"):
        k = {"vec2": 2, "vec3": 3, "vec4": 4, "color": 3}[name]
        return [num(), integer()] + [num() for _ in range(k - 2)]
    if name in ("mix", "lerp"):
        return [vec(3), vec(3), num(0.0, 1.0)]
    if name == "select":
        return [boolean(), vec(3), vec(3)]
    if name == "clamp":
        return [num(), num(-2.0, 0.0), num(0.0, 2.0)]
    if name in ("dot", "cross", "angle", "dist", "reflect", "rotate_euler",
                "rotate_euler_inverse"):
        return [vec(3), vec(3)]
    if name in ("norm", "length", "luminance"):
        return [vec(3)]
    if name in ("sum", "avg"):
        return [vec(4)]
    if name == "fresnel_dielectric":
        return [num(1.0, 2.0), num(0.0, 1.0)]
    if name == "fresnel_conductor":
        return [num(0.1, 3.0), num(0.5, 5.0), num(0.0, 1.0)]
    if name == "blackbody":
        return [num(500.0, 25000.0)]
    if name == "rotate_axis":
        return [vec(3), num(), vec(3, unit=True)]
    if name in ("hash", "signbit", "smoothstep", "smootherstep"):
        return [num(-1.5, 1.5)]
    if name == "lookup":
        pts = [("vec2", np.float32(p)) for p in
               ([0.0, 0.1], [0.3, 0.8], [0.5, 0.2], [1.0, 0.6])]
        return [("str", "linear"), ("bool", np.bool_(True)),
                num(-0.5, 1.5)] + pts
    if name == "ensure_valid_reflection":
        return [vec(3, unit=True), vec(3, unit=True), vec(3, unit=True)]
    if name == "bump":
        return [vec(3, unit=True), vec(3, unit=True), vec(3, unit=True),
                num(0.0, 1.0), num(-1.0, 1.0), num(-1.0, 1.0)]
    if name in ("smin", "smax"):
        return [num(), num(), num(0.1, 1.0)]
    if name == "wrap":
        return [num(-5.0, 5.0), num(-1.0, 0.0), num(0.5, 2.0)]
    raise KeyError(name)


def _call_both(name, args):
    jargs = [(k, v if k == "str" else jnp.asarray(v)) for k, v in args]
    targs = [(k, v if k == "str" else torch.from_numpy(np.asarray(v)))
             for k, v in args]
    return jp._FUNCTIONS[name](jargs), tp.FUNCTIONS[name](targs)


def _same(ref, got, name):
    assert got[0] == ref[0], (name, got[0], ref[0])
    r = np.asarray(ref[1])
    g = got[1].numpy()
    assert g.shape == r.shape, (name, g.shape, r.shape)
    if r.dtype == bool or np.issubdtype(r.dtype, np.integer):
        np.testing.assert_array_equal(g, r, err_msg=name)
    else:
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=name)
        np.testing.assert_allclose(g, r, err_msg=name, equal_nan=True, **TOL)


@pytest.mark.parametrize("name", sorted(jp._FUNCTIONS))
def test_builtin_matches_jax(name):
    args = _args(name, seed=sum(map(ord, name)))
    ref, got = _call_both(name, args)
    _same(ref, got, name)


def test_function_tables_hold_the_same_names():
    assert set(tp.FUNCTIONS) == set(jp._FUNCTIONS)
    assert len(tp.FUNCTIONS) == 94


# ---------------------------------------------------- the evaluator itself
class _Scene:
    textures = []
    param_registry = {"gain": ("num", 0, 1), "tint": ("vec4", 1, 4),
                      "level": ("int", 5, 1)}
    parameter_values = {"fallback": ("num", 0.25)}


def _ctx(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(-1, 1, (N,) + s).astype(np.float32)
    ix = rng.integers(-4, 5, N).astype(np.int32)
    ix[:3] = [0, 7, -2147483648]
    iy = rng.integers(-3, 4, N).astype(np.int32)
    iy[:3] = [0, 0, -1]
    return dict(uv=f(2), P=f(3), N=f(3), Ng=f(3), V=f(3), Nx=f(3), Ny=f(3),
                t=f(), Ix=ix, Iy=iy, frontside=f() > 0,
                ray_flags=rng.integers(0, 16, N).astype(np.int32))


def _eval_both(src, seed=0, tables=None):
    ctx = _ctx(seed)
    tables = tables or {"params": np.float32([1.5, 0.2, 0.4, 0.6, 1.0, 3.7])}
    ref = jp.eval_pexpr(_Scene(), {k: jnp.asarray(v) for k, v in
                                   tables.items()}, src,
                        {k: jnp.asarray(v) for k, v in ctx.items()})
    got = tp.eval_pexpr(_Scene(), {k: torch.from_numpy(v) for k, v in
                                   tables.items()}, src,
                        {k: torch.from_numpy(v) for k, v in ctx.items()})
    return ref, got


@pytest.mark.parametrize("src", [
    "Ix / Iy", "Ix % Iy", "-Ix / 0", "0 / 0 + 7 % 0", "Iy / -1",
    "Ix * 3 - Iy + 2", "(Ix / Iy) % 3",
])
def test_integer_division_by_zero_gives_jax_values(src):
    ref, got = _eval_both(src)
    _same(ref, got, src)


@pytest.mark.parametrize("src", [
    "t % 0.7", "-t % 0.3", "(t * 100) % -2.5", "P % 0.25", "t % 0",
    "uv.x ^ 2", "2 ^ uv.y", "floor(t * 4) % 2",
])
def test_float_remainder_and_power_match_jax(src):
    ref, got = _eval_both(src)
    _same(ref, got, src)


@pytest.mark.parametrize("src", [
    "gain * vec3(1, 2, 3)", "tint.rgb * gain", "level + 1", "fallback * 2",
    "Pi * E + Eps - NumMin + NumMax * 0", "uv.yxy", "t.xx", "N.zyx - Ng",
    "select(frontside, P, V)", "!frontside || t > 0 && t < 0.5",
    "vec3(1, 0, 0) == vec3(1, 0, 0)", "P != N", "Ix <= Iy",
    'check_ray_flag("bounce")', "check_ray_flag('camera')",
    "color(t, 0.5, 1)", "vec4(0.25)", "length(P - N) / dot(V, V)",
    "1 + true", "uvw", "Ro", "Np", "prim_coords", "entity_id + frame",
])
def test_expressions_match_jax(src):
    try:
        ref = _eval_both(src)[0]
    except Exception as e:  # the JAX package refuses it: so does the port
        with pytest.raises(type(e)):
            _eval_both(src)
        return
    ref, got = _eval_both(src)
    _same(ref, got, src)


def test_unknown_names_raise():
    ctx = {k: torch.from_numpy(v) for k, v in _ctx().items()}
    for src, what in (("nothing_here + 1", "variable"),
                      ("nothing(1)", "function")):
        with pytest.raises(jp.PExprError, match=what):
            jp.eval_pexpr(_Scene(), {}, src,
                          {k: jnp.asarray(v) for k, v in _ctx().items()})
        with pytest.raises(tp.PExprError, match=what):
            tp.eval_pexpr(_Scene(), {}, src, ctx)


@pytest.mark.parametrize("src", ["0.5", "3", "vec2(uv.x, 2)",
                                 "vec3(0.1, 0.2, 0.3)", "color(uv.x, 0, 1)",
                                 "uv.x > 0"])
def test_eval_pexpr_color_matches_jax(src):
    uv = np.random.default_rng(3).uniform(0, 1, (N, 2)).astype(np.float32)
    try:
        ref = np.asarray(jp.eval_pexpr_color(_Scene(), {}, src,
                                             jnp.asarray(uv)))
    except jp.PExprError:
        with pytest.raises(tp.PExprError):
            tp.eval_pexpr_color(_Scene(), {}, src, torch.from_numpy(uv))
        return
    got = tp.eval_pexpr_color(_Scene(), {}, src, torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(np.broadcast_to(got, (N, 3)),
                               np.broadcast_to(ref, (N, 3)), **TOL)


@pytest.mark.parametrize("src", ["1.2 + 0.3", "2 * p_num", "p_num / 3 - 1",
                                 "checker", "vec3(1, 2, 3)", "'text'",
                                 "p_col.g", "1 / 0"])
def test_number_properties_fold_as_in_jax(src):
    """`scene.compile._number`: a PExpr string folded with the scene's
    parameters; whatever does not fold keeps its reference."""
    import ignis_tpu.scene.compile as jc
    import ignis_tpu_torch.scene.compile as tc
    vals = {"p_num": ("num", 0.7), "p_col": ("vec3", [0.1, 0.2, 0.3])}
    jold, told = jc._PARAM_VALUES, tc._PARAM_VALUES
    try:
        jc._PARAM_VALUES, tc._PARAM_VALUES = dict(vals), dict(vals)
        ref, got = jc._number(src, 0.5), tc._number(src, 0.5)
    finally:
        jc._PARAM_VALUES, tc._PARAM_VALUES = jold, told
    assert got == ref
    assert np.float32(got[0]).tobytes() == np.float32(ref[0]).tobytes()


def _degenerate(name):
    """Inputs that reach sqrt(0) or a zero length inside `name`."""
    rng = np.random.default_rng(17)

    def unit(v):
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
            np.float32)
    a = unit(rng.normal(size=(N, 3)))
    b = unit(rng.normal(size=(N, 3)))
    c = unit(rng.normal(size=(N, 3)))
    if name == "ensure_valid_reflection":
        c[:8] = a[:8]                      # N parallel to Ng
        return [a, b, c]
    a[:8] = 0.0                            # zero vectors
    b[:8] = a[:8] if name == "dist" else b[:8]
    return {"norm": [a], "length": [a], "angle": [a, b], "dist": [a, a]}[name]


@pytest.mark.parametrize("name", ["ensure_valid_reflection", "norm", "length",
                                  "angle", "dist"])
def test_builtin_gradient_finite_where_jax_is_nan(name):
    """Where these builtins take sqrt(max(x, 0)) or a zero length, the JAX
    package's slope is NaN; the port's is 0 there, its values the same and
    its gradient equal to the JAX one on every finite entry (rtol 1e-3, atol
    1e-4: near the clamp the slope amplifies the last-ulp differences)."""
    import jax
    vals = _degenerate(name)
    kinds = ["vec3"] * len(vals)

    def jloss(x):
        args = [(k, jnp.asarray(v)) for k, v in zip(kinds, vals)]
        args[-1] = (kinds[-1], x)
        return jnp.sum(jnp.asarray(jp._FUNCTIONS[name](args)[1]))
    jg = np.asarray(jax.grad(jloss)(jnp.asarray(vals[-1])))
    leaf = torch.from_numpy(vals[-1].copy()).requires_grad_(True)
    targs = [(k, torch.from_numpy(v)) for k, v in zip(kinds, vals)]
    targs[-1] = (kinds[-1], leaf)
    out = tp.FUNCTIONS[name](targs)[1]
    ref = jp._FUNCTIONS[name]([(k, jnp.asarray(v))
                               for k, v in zip(kinds, vals)])[1]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    out.sum().backward()
    tg = leaf.grad.numpy()
    assert np.isfinite(tg).all()
    fin = np.isfinite(jg)
    assert not fin.all()
    np.testing.assert_allclose(tg[fin], jg[fin], rtol=1e-3, atol=1e-4)
