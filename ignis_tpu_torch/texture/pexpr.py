"""PExpr shading-expression engine over tensors.

Counterpart of ignis_tpu/texture/pexpr.py.  The tokenizer and Pratt parser
are copied as they are (the trees must be equal); the evaluator runs eagerly
over the lanes of a shading context.  Each expression string is parsed once
and its tree cached, since evaluation runs every bounce.

Types: bool/int/num/vec2/vec3/vec4/str; only int->num implicit casts.
Values are (kind, tensor) with a trailing component axis for vectors;
literals are cached 0-d tensors on the context's device.

Where torch and XLA differ the JAX package's values are kept: a float -> int
cast saturates (`core.vec.to_int32`), and integer `/` and `%` by zero give
XLA's values (x / 0 -> -1, then the floor adjustment; x % 0 -> 0) instead of
raising.  Where a builtin takes sqrt(max(x, 0)) or the length of a vector
that may be zero (`ensure_valid_reflection`, `norm`, `length`, `angle`,
`dist`), the port's slope there is 0 (`core.vec.safe_sqrt`, `length`), the
JAX package's NaN; the values are the same.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

from ignis_tpu_torch.core import rng
from ignis_tpu_torch.core.vec import (
    clip, cross, device_const, device_scalar, ipow, length, maximum, minimum,
    safe_sqrt, to_int32,
)

_TOKEN_RE = re.compile(r"""
    (?P<float>\d+\.\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|\d+[eE][+-]?\d+)
  | (?P<int>\d+)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<str>"[^"]*"|'[^']*')
  | (?P<op>\|\||&&|==|!=|<=|>=|[-+*/%^<>!(),.])
  | (?P<ws>\s+)
""", re.X)

_VEC_SIZE = {"num": 1, "vec2": 2, "vec3": 3, "vec4": 4}


class PExprError(ValueError):
    pass


def tokenize(src: str):
    toks = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise PExprError(f"Bad token at {src[pos:pos+10]!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        toks.append((m.lastgroup, m.group()))
    toks.append(("eof", ""))
    return toks


# ------------------------------------------------------------------- parser

class Node:
    __slots__ = ("op", "args", "value")

    def __init__(self, op, args=(), value=None):
        self.op = op
        self.args = args
        self.value = value


_BINARY_PREC = {
    "||": 1, "&&": 2,
    "==": 3, "!=": 3, "<": 4, "<=": 4, ">": 4, ">=": 4,
    "+": 5, "-": 5, "*": 6, "/": 6, "%": 6, "^": 7,
}


class Parser:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, val):
        t = self.next()
        if t[1] != val:
            raise PExprError(f"Expected {val!r}, got {t[1]!r}")

    def parse(self):
        e = self.expr(0)
        if self.peek()[0] != "eof":
            raise PExprError(f"Trailing tokens: {self.peek()[1]!r}")
        return e

    def expr(self, min_prec):
        lhs = self.unary()
        while True:
            kind, val = self.peek()
            prec = _BINARY_PREC.get(val)
            if kind != "op" or prec is None or prec < min_prec:
                return lhs
            self.next()
            rhs = self.expr(prec + 1)
            lhs = Node("bin", (lhs, rhs), val)

    def unary(self):
        kind, val = self.peek()
        if kind == "op" and val in ("-", "+", "!"):
            self.next()
            inner = self.unary()
            if val == "+":
                return inner
            return Node("neg" if val == "-" else "not", (inner,))
        return self.postfix()

    def postfix(self):
        node = self.primary()
        while True:
            kind, val = self.peek()
            if kind == "op" and val == ".":
                self.next()
                member = self.next()
                if member[0] != "name":
                    raise PExprError("Expected member name after '.'")
                node = Node("swizzle", (node,), member[1])
            elif kind == "op" and val == "(" and node.op == "var":
                # call on a name (texture-as-function or builtin handled later)
                self.next()
                args = self.arglist()
                node = Node("call", tuple(args), node.value)
            else:
                return node

    def arglist(self):
        args = []
        if self.peek()[1] == ")":
            self.next()
            return args
        while True:
            args.append(self.expr(0))
            t = self.next()
            if t[1] == ")":
                return args
            if t[1] != ",":
                raise PExprError(f"Expected ',' or ')', got {t[1]!r}")

    def primary(self):
        kind, val = self.next()
        if kind == "float":
            return Node("num", (), float(val))
        if kind == "int":
            return Node("int", (), int(val))
        if kind == "str":
            return Node("str", (), val[1:-1])
        if kind == "name":
            if val == "true":
                return Node("bool", (), True)
            if val == "false":
                return Node("bool", (), False)
            return Node("var", (), val)
        if kind == "op" and val == "(":
            e = self.expr(0)
            self.expect(")")
            return e
        raise PExprError(f"Unexpected token {val!r}")


def parse_pexpr(src: str) -> Node:
    return Parser(tokenize(src)).parse()


# ---------------------------------------------------------------- evaluator

_VECS = ("vec2", "vec3", "vec4")


def _f32(x):
    return x.to(torch.float32)


def _as_num(v):
    k, a = v
    if k == "int":
        return ("num", _f32(a))
    if k == "num":
        return v
    raise PExprError(f"Cannot convert {k} to num")


def _broadcast_pair(a, b):
    """Implicit conversions for binary ops: int->num; num op vecN broadcasts."""
    ka, va = a
    kb, vb = b
    if ka == "int" and kb != "int":
        a = _as_num(a)
    elif kb == "int" and ka != "int":
        b = _as_num(b)
    ka, va = a
    kb, vb = b
    if ka == kb:
        return a, b, ka
    if ka == "num" and kb in _VECS:
        return ("x", va[..., None]), b, kb
    if kb == "num" and ka in _VECS:
        return a, ("x", vb[..., None]), ka
    raise PExprError(f"Type mismatch: {ka} vs {kb}")


_SWIZ = {"x": 0, "y": 1, "z": 2, "w": 3, "r": 0, "g": 1, "b": 2, "a": 3}


def _elemwise(fn):
    def wrap(args):
        v = args[0]
        k, a = _as_num(v) if v[0] == "int" else v
        return (k, fn(a))
    return wrap


def _elemwise2(fn):
    def wrap(args):
        a, b, k = _broadcast_pair(args[0], args[1])
        return (k, fn(a[1], b[1]))
    return wrap


def _where(c, a, b):
    """torch.where with Python numbers as cached 0-d device constants."""
    like = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))
    if not isinstance(a, torch.Tensor):
        a = device_scalar(float(a), like.device)
    if not isinstance(b, torch.Tensor):
        b = device_scalar(float(b), like.device)
    return torch.where(c, a, b)


def int_floordiv(a, b):
    """int32 `a // b` with XLA's values where torch raises or overflows:
    a // 0 is -1 for a == 0 and -2 otherwise (XLA's x / 0 = -1 and x % 0 =
    x, then `jnp.floor_divide`'s adjustment), -2^31 // -1 is -2^31."""
    a, b = torch.broadcast_tensors(a, b)
    one = torch.ones_like(b)
    bad = (b == 0) | ((a == -2147483648) & (b == -1))
    q = torch.div(a, torch.where(bad, one, b), rounding_mode="floor")
    by_zero = torch.where(a == 0, -one, -2 * one)
    return torch.where(b == 0, by_zero, q).to(torch.int32)


def int_mod(a, b):
    """int32 `a % b` (`jnp.remainder`): 0 where b == 0."""
    a, b = torch.broadcast_tensors(a, b)
    one = torch.ones_like(b)
    safe = torch.where((b == 0) | (b == -1), one, b)
    r = torch.remainder(a, safe)
    return torch.where(b == 0, torch.zeros_like(r), r).to(torch.int32)


class Evaluator:
    def __init__(self, scene, tables, ctx):
        self.scene = scene
        self.tables = tables
        self.ctx = ctx  # dict of lane tensors
        self.device = ctx["uv"].device

    # ---- variables
    _SIMPLE = {
        "uv": ("vec2", "uv"), "uvw": ("vec3", "uvw"),
        "prim_coords": ("vec2", "prim_coords"),
        "P": ("vec3", "P"), "Np": ("vec3", "Np"),
        "V": ("vec3", "V"), "Rd": ("vec3", "V"), "Ro": ("vec3", "Ro"),
        "N": ("vec3", "N"), "Ng": ("vec3", "Ng"),
        "Nx": ("vec3", "Nx"), "Ny": ("vec3", "Ny"),
        "frontside": ("bool", "frontside"),
        "entity_id": ("int", "entity_id"),
        "Ix": ("int", "Ix"), "Iy": ("int", "Iy"),
        "t": ("num", "t"),
        "frame": ("int", "frame"),
    }
    _CONSTS = {"Pi": math.pi, "E": math.e,
               "Eps": 1.1920928955078125e-07,
               "NumMax": 3.4028234663852886e38,
               "NumMin": 1.1754943508222875e-38,
               "Inf": float("inf")}

    def var(self, name):
        ctx = self.ctx
        dev = self.device
        if name in self._SIMPLE:
            kind, key = self._SIMPLE[name]
            if key in ctx:
                return (kind, ctx[key])
            n = ctx["uv"].shape[0]
            if kind in _VECS:
                return (kind, torch.zeros((n, int(kind[-1])),
                                          dtype=torch.float32, device=dev))
            if kind == "bool":
                return ("bool", torch.ones((n,), dtype=torch.bool,
                                           device=dev))
            if kind == "int":
                return ("int", torch.zeros((n,), dtype=torch.int32,
                                           device=dev))
            return ("num", torch.zeros((n,), dtype=torch.float32, device=dev))
        if name in self._CONSTS:
            return ("num", device_scalar(float(np.float32(self._CONSTS[name])),
                                         dev))
        # scene parameters: with the registry table at hand, a slice of it
        # (registry values change without rebuilding anything); else the
        # compile-time constant
        reg = getattr(self.scene, "param_registry", None)
        tbl = self.tables if isinstance(self.tables, dict) else None
        if reg and name in reg and tbl is not None and "params" in tbl:
            kind, off, size = reg[name]
            vec = tbl["params"][off:off + size]
            if kind == "num":
                return ("num", vec[0])
            if kind == "int":
                return ("int", to_int32(vec[0]))
            return (kind, vec)
        params = getattr(self.scene, "parameter_values", {}) or {}
        if name in params:
            kind, val = params[name]
            return (kind, torch.as_tensor(np.asarray(val, np.float32),
                                          device=dev))
        # textures as variables: sampled at the implicit uv
        tex_id = self._tex_id(name)
        if tex_id is not None:
            return self._sample_tex(tex_id, ("vec2", self.ctx["uv"]))
        raise PExprError(f"Unknown PExpr variable '{name}'")

    def _tex_id(self, name):
        for i, t in enumerate(self.scene.textures):
            if t["name"] == name:
                return i
        return None

    def _sample_tex(self, tex_id, uv):
        from ignis_tpu_torch.texture.eval import eval_one
        rgb = eval_one(self.scene, self.tables, self.scene.textures[tex_id],
                       uv[1], self.ctx)
        alpha = torch.ones(rgb.shape[:-1] + (1,), dtype=torch.float32,
                           device=rgb.device)
        return ("vec4", torch.cat([rgb, alpha], dim=-1))

    # ---- dispatch
    def eval(self, node):
        op = node.op
        if op == "num":
            return ("num", device_const(float(np.float32(node.value)), torch.float32,
                                self.device))
        if op == "int":
            return ("int", device_const(int(np.int32(node.value)), torch.int32,
                                self.device))
        if op == "bool":
            return ("bool", device_const(bool(node.value), torch.bool, self.device))
        if op == "str":
            return ("str", node.value)
        if op == "var":
            return self.var(node.value)
        if op == "neg":
            k, a = self.eval(node.args[0])
            return (k, -a)
        if op == "not":
            k, a = self.eval(node.args[0])
            return ("bool", ~a)
        if op == "swizzle":
            return self.swizzle(self.eval(node.args[0]), node.value)
        if op == "bin":
            return self.binary(node.value, self.eval(node.args[0]),
                               self.eval(node.args[1]))
        if op == "call":
            return self.call(node.value, [self.eval(a) for a in node.args])
        raise PExprError(f"Bad node {op}")

    def swizzle(self, v, members):
        k, a = v
        if k == "num":
            a = a[..., None]
            idx = [0 for _ in members]
        elif k in _VECS:
            idx = []
            for ch in members:
                if ch not in _SWIZ:
                    raise PExprError(f"Bad swizzle '{members}'")
                idx.append(_SWIZ[ch])
        else:
            raise PExprError(f"Cannot swizzle {k}")
        n = len(idx)
        if n == 1:
            return ("num", a[..., idx[0]])
        return (f"vec{n}", a[..., idx])

    def binary(self, op, a, b):
        if op in ("&&", "||"):
            fa, fb = a[1], b[1]
            return ("bool", fa & fb if op == "&&" else fa | fb)
        if op in ("==", "!=", "<", "<=", ">", ">="):
            aa, bb, k = _broadcast_pair(a, b)
            va, vb = aa[1], bb[1]
            r = {"==": torch.eq, "!=": torch.ne, "<": torch.lt,
                 "<=": torch.le, ">": torch.gt, ">=": torch.ge}[op](va, vb)
            if r.ndim and k in _VECS:
                r = torch.all(r, dim=-1)
            return ("bool", r)
        aa, bb, k = _broadcast_pair(a, b)
        va, vb = aa[1], bb[1]
        if op == "+":
            return (k, va + vb)
        if op == "-":
            return (k, va - vb)
        if op == "*":
            return (k, va * vb)
        if op == "/":
            if k == "int":
                return (k, int_floordiv(va, vb))
            return (k, va / vb)
        if op == "%":
            if k == "int":
                return (k, int_mod(va, vb))
            return (k, torch.remainder(va, vb))
        if op == "^":
            return (k if k != "int" else "num", torch.pow(_f32(va), _f32(vb)))
        raise PExprError(f"Bad operator {op}")

    # ---- functions
    def call(self, name, args):
        tex_id = self._tex_id(name)
        if tex_id is not None and len(args) == 1 and args[0][0] == "vec2":
            return self._sample_tex(tex_id, args[0])
        if name == "check_ray_flag":
            # lane ray flags ride in ctx["ray_flags"]; contexts that never
            # set them are primary-shading contexts (camera rays)
            bit = {"camera": 1, "light": 2, "bounce": 4, "shadow": 8}.get(
                str(args[0][1]).lower() if args[0][0] == "str" else "", 0)
            rf = self.ctx.get("ray_flags")
            if rf is None:
                n = self.ctx["uv"].shape[0]
                rf = torch.full((n,), 1, dtype=torch.int32,
                                device=self.device)
            return ("bool", (rf & bit) != 0)
        f = FUNCTIONS.get(name)
        if f is None:
            raise PExprError(f"Unknown PExpr function '{name}'")
        return f(args)


# ---------------------------------------------------------------- builtins

def _vecn(args, n):
    vals = [_as_num(a)[1] if a[0] == "int" else a[1] for a in args]
    if len(vals) == 1:
        v = vals[0]
        return (f"vec{n}", torch.broadcast_to(v[..., None], v.shape + (n,)))
    vb = torch.broadcast_tensors(*[_f32(v) for v in vals])
    return (f"vec{n}", torch.stack(vb, dim=-1))


def _ones_like_last(x):
    return torch.ones(x.shape[:-1] + (1,), dtype=torch.float32,
                      device=x.device)


def _color_fn(args):
    if len(args) == 3:
        r = _vecn(args, 3)[1]
        return ("vec4", torch.cat([r, _ones_like_last(r)], dim=-1))
    return _vecn(args, 4)


def _reduce_fn(fn):
    def wrap(args):
        return ("num", fn(args[0][1]))
    return wrap


def _mix(args):
    a, b, t = args
    k = a[0]
    tv = _as_num(t)[1]
    if k in _VECS:
        tv = tv[..., None]
    return (k, a[1] * (1 - tv) + b[1] * tv)


def _select(args):
    c, a, b = args
    cv = c[1]
    if a[0] in _VECS and cv.ndim:
        cv = cv[..., None]
    return (a[0], torch.where(cv, a[1], b[1]))


def _clamp(args):
    v, lo, hi = args
    return (v[0], clip(v[1], lo[1], hi[1]))


def _noise_fn(args):
    from ignis_tpu_torch.texture.eval import noise2
    v = args[0]
    if v[0] in ("num", "int"):
        x = _as_num(v)[1]
        p = torch.stack([x, torch.zeros_like(x)], dim=-1)
    elif v[0] == "vec2":
        p = v[1]
    else:
        p = v[1][..., :2]
    return ("num", noise2(p, 0))


def _checkerboard_fn(args):
    v = args[0][1]
    px = torch.remainder(to_int32(torch.floor(torch.remainder(v[..., 0], 2.0))),
                         2)
    py = torch.remainder(to_int32(torch.floor(torch.remainder(v[..., 1], 2.0))),
                         2)
    return ("int", (px == py).to(torch.int32))


def _dot_fn(args):
    return ("num", torch.sum(args[0][1] * args[1][1], dim=-1))


def _cross_fn(args):
    return ("vec3", cross(args[0][1], args[1][1]))


def _norm_fn(args):
    k, a = args[0]
    return (k, a / maximum(length(a)[..., None], 1e-20))


def _length_fn(args):
    return ("num", length(args[0][1]))


def _fresnel_dielectric_fn(args):
    from ignis_tpu_torch.bsdf.union import _fresnel_dielectric
    return ("num", _fresnel_dielectric(_as_num(args[0])[1],
                                       _as_num(args[1])[1]))


def _smoothstep(args):
    x = clip(_as_num(args[0])[1], 0.0, 1.0)
    return ("num", x * x * (3.0 - 2.0 * x))


def _luminance(args):
    a = args[0][1]
    return ("num", a[..., 0] * 0.2126 + a[..., 1] * 0.7152 + a[..., 2] * 0.0722)


def _blackbody(args):
    """sRGB/D65 fit of a black body, valid on [1000, 20000] K."""
    t2 = clip(_as_num(args[0])[1], 1000.0, 20000.0)
    # low segment [1000, 6500]
    tl = (t2 - 1000.0) / 5500.0
    r_l = torch.exp(-6.43983699 * tl + 0.75651596) + (
        (0.79760204 * tl - 2.04782763) * tl + 2.33744911)
    b_l = maximum(0.0, torch.exp(0.24888616 * tl + 1.39095510) - 4.17216437)
    g_l = (1.0 - r_l * 0.2126 - b_l * 0.0722) / 0.7152
    # high segment [6500, 20000]
    th = (t2 - 6500.0) / 13500.0
    r_h = torch.exp(-5.08603402 * th - 1.68935495) + (
        (0.07954146 * th - 0.23566459) * th + 0.85280697)
    b_h = ((th - 2.25659290) * th + 2.11298599) * th + 1.02683036
    g_h = (1.0 - r_h * 0.2126 - b_h * 0.0722) / 0.7152
    lo = t2 <= 6500.0
    rgb = torch.stack([torch.where(lo, r_l, r_h), torch.where(lo, g_l, g_h),
                       torch.where(lo, b_l, b_h)], dim=-1)
    return ("vec4", torch.cat([maximum(rgb, 0.0), _ones_like_last(rgb)],
                              dim=-1))


def _rgb_to_hsv(c):
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    mx = maximum(maximum(r, g), b)
    mn = minimum(minimum(r, g), b)
    d = mx - mn
    e = 1e-10
    h = torch.where(
        mx == r, torch.remainder((g - b) / (d + e), 6.0),
        torch.where(mx == g, (b - r) / (d + e) + 2.0, (r - g) / (d + e) + 4.0))
    h = torch.remainder(h / 6.0, 1.0)
    s = d / (mx + e)
    return h, s, mx


def _hsv_to_rgb(h, s, v):
    """hsv -> sRGB in the palette formulation."""
    k = torch.stack([torch.remainder(h + 1.0, 1.0) * 6.0,
                     torch.remainder(h + 2.0 / 3.0, 1.0) * 6.0,
                     torch.remainder(h + 1.0 / 3.0, 1.0) * 6.0], dim=-1)
    p = torch.abs(k - 3.0)
    core = clip(p - 1.0, 0.0, 1.0)
    return v[..., None] * (1.0 + s[..., None] * (core - 1.0))


def _color_conv(fn):
    def wrap(args):
        c = args[0][1]
        rgb = fn(c[..., :3])
        return ("vec4", torch.cat([rgb, c[..., 3:4]], dim=-1))
    return wrap


def _conv_hsv(c):
    h, s, v = _rgb_to_hsv(c)
    return torch.stack([h, s, v], dim=-1)


def _conv_from_hsv(c):
    return _hsv_to_rgb(c[..., 0], c[..., 1], c[..., 2])


def _conv_hsl(c):
    h, s, v = _rgb_to_hsv(c)
    l = v * (1.0 - s / 2.0)
    denom = minimum(l, 1.0 - l)
    sl = _where(denom <= 1e-10, 0.0, (v - l) / maximum(denom, 1e-10))
    return torch.stack([h, sl, l], dim=-1)


def _conv_from_hsl(c):
    h, s, l = c[..., 0], c[..., 1], c[..., 2]
    v = l + s * minimum(l, 1.0 - l)
    sv = _where(v <= 1e-10, 0.0, 2.0 * (1.0 - l / maximum(v, 1e-10)))
    return _hsv_to_rgb(h, sv, v)


# sRGB (linear) <-> XYZ, D65
_RGB2XYZ = np.float32([[0.4124564, 0.3575761, 0.1804375],
                       [0.2126729, 0.7151522, 0.0721750],
                       [0.0193339, 0.1191920, 0.9503041]])
_XYZ2RGB = np.linalg.inv(_RGB2XYZ).astype(np.float32)


def _mat3_apply(m, c):
    """einsum("ij,...j->...i", m, c) for a constant 3x3 numpy matrix."""
    mt = device_const(tuple(map(tuple, m.T.tolist())), torch.float32,
                      c.device)
    return c @ mt


def _lerp_c(a, b, t):
    return a * (1.0 - t) + b * t


def _mix_mode(fn):
    """Blend-mode mixes: rgb blended, alpha from a."""
    def wrap(args):
        a = args[0][1]
        b = args[1][1]
        t = _as_num(args[2])[1][..., None]
        rgb = fn(a[..., :3], b[..., :3], t)
        return ("vec4", torch.cat([rgb, a[..., 3:4]], dim=-1))
    return wrap


def _mix_screen_rgb(a, b, t):
    return 1.0 - (_lerp_c(torch.ones_like(b), 1.0 - b, t)) * (1.0 - a)


def _mix_overlay_rgb(a, b, t):
    return torch.where(a < 0.5, a * _lerp_c(1.0, 2.0 * b, t),
                       1.0 - (1.0 - a) * _lerp_c(1.0, 2.0 * (1.0 - b), t))


def _mix_dodge_rgb(a, b, t):
    den = 1.0 - t * b
    d = minimum(1.0, _where(den == 0.0, 0.0, a / _where(den == 0.0, 1.0, den)))
    return torch.where(a == 0.0, a, _where(d < 0.0, 1.0, d))


def _mix_burn_rgb(a, b, t):
    d = _lerp_c(torch.ones_like(b), b, t)
    return _where(d <= 1.1920929e-07, 0.0,
                  clip(1.0 - (1.0 - a) / _where(d == 0.0, 1.0, d), 0.0, 1.0))


def _mix_soft_rgb(a, b, t):
    scr = 1.0 - (1.0 - a) * (1.0 - b)
    return _lerp_c(a, (1.0 - a) * a * b + a * scr, t)


def _mix_linear_rgb(a, b, t):
    return a + torch.where(b > 0.5, 2.0 * (b - 0.5), 2.0 * b - 1.0) * t


def _mix_hue_rgb(a, b, t):
    return _lerp_c(a, _conv_from_hsv(torch.cat(
        [_conv_hsv(b)[..., 0:1], _conv_hsv(a)[..., 1:3]], dim=-1)), t)


def _mix_saturation_rgb(a, b, t):
    return _conv_from_hsv(torch.cat(
        [_conv_hsv(a)[..., 0:1],
         _lerp_c(_conv_hsv(a)[..., 1:2], _conv_hsv(b)[..., 1:2], t),
         _conv_hsv(a)[..., 2:3]], dim=-1))


def _mix_value_rgb(a, b, t):
    return _conv_from_hsv(torch.cat(
        [_conv_hsv(a)[..., 0:2],
         _lerp_c(_conv_hsv(a)[..., 2:3], _conv_hsv(b)[..., 2:3], t)], dim=-1))


def _mix_color_rgb(a, b, t):
    return _lerp_c(a, _conv_from_hsv(torch.cat(
        [_conv_hsv(b)[..., 0:2], _conv_hsv(a)[..., 2:3]], dim=-1)), t)


def _fresnel_conductor_fn(args):
    from ignis_tpu_torch.bsdf.union import _conductor_factor
    n = _as_num(args[0])[1]
    k = _as_num(args[1])[1]
    ci = _as_num(args[2])[1]
    return ("num", _conductor_factor(n, k, ci))


def _angle_fn(args):
    a, b = args[0][1], args[1][1]
    la, lb = length(a), length(b)
    cosv = torch.sum(a * b, dim=-1) / maximum(la * lb, 1e-20)
    return ("num", torch.acos(clip(cosv, -1.0, 1.0)))


def _euler_mat(e):
    cx, cy, cz = torch.cos(e[..., 0]), torch.cos(e[..., 1]), torch.cos(e[..., 2])
    sx, sy, sz = torch.sin(e[..., 0]), torch.sin(e[..., 1]), torch.sin(e[..., 2])
    # rows of the euler-angle rotation (column-major in the reference)
    r0 = torch.stack([cy * cz, sy * sx * cz - cx * sz, sy * cx * cz + sx * sz], -1)
    r1 = torch.stack([cy * sz, sy * sx * sz + cx * cz, sy * cx * sz - sx * cz], -1)
    r2 = torch.stack([-sy, cy * sx, cy * cx], -1)
    return torch.stack([r0, r1, r2], dim=-2)


def _rotate_euler(args, inverse=False):
    p, e = args[0][1], args[1][1]
    m = _euler_mat(e)
    if inverse:
        out = torch.einsum("...ji,...j->...i", m, p)
    else:
        out = torch.einsum("...ij,...j->...i", m, p)
    return ("vec3", out)


def _rotate_axis_fn(args):
    p = args[0][1]
    ang = _as_num(args[1])[1]
    ax = args[2][1]
    c = torch.cos(ang)[..., None]
    s = torch.sin(ang)[..., None]
    d = torch.sum(ax * p, dim=-1, keepdim=True)
    return ("vec3", p * c + cross(ax, p) * s + ax * d * (1.0 - c))


def _hash_fn(args):
    """A [0, 1) draw from the float32 bits (FNV seed, TEA draw)."""
    return ("num", rng.hash_rndf(_as_num(args[0])[1]))


def _colored_noise(scalar_fn):
    """Colored noise: three scalar evaluations at offset inputs."""
    def wrap(args):
        r = scalar_fn([args[0]])[1]
        g = scalar_fn([(args[0][0], args[0][1] + 17.31)])[1]
        b = scalar_fn([(args[0][0], args[0][1] + 41.97)])[1]
        rgb = torch.stack([r, g, b], dim=-1)
        return ("vec4", torch.cat([rgb, _ones_like_last(rgb)], dim=-1))
    return wrap


def _take(x, i):
    """x[..., i] for a per-lane (or 0-d) index tensor i."""
    return torch.gather(x, -1, i.long()[..., None])[..., 0]


def _lookup_fn(args):
    """Curve lookup: lookup(interp: str, extrapolate: bool, t: num,
    p0: vec2, ...)."""
    interp = str(args[0][1]).lower() if args[0][0] == "str" else "linear"
    linear = interp != "constant"
    extrap = args[1][1]
    t = _as_num(args[2])[1]
    xs = [a[1][..., 0] for a in args[3:]]
    ys = [a[1][..., 1] for a in args[3:]]
    count = len(xs)
    if count == 0:
        return ("num", torch.zeros_like(t))
    x = torch.stack([torch.broadcast_to(v, t.shape) for v in xs], dim=-1)
    y = torch.stack([torch.broadcast_to(v, t.shape) for v in ys], dim=-1)
    i = torch.clamp(torch.sum((x <= t[..., None]).to(torch.int32), dim=-1) - 1,
                    0, count - 1)
    ii = torch.clamp_max(i + 1, count - 1)
    x0, x1, y0, y1 = _take(x, i), _take(x, ii), _take(y, i), _take(y, ii)
    if linear:
        t0 = clip((t - x0) / maximum(x1 - x0, 1e-10), 0.0, 1.0)
        inside = y0 + (y1 - y0) * t0
    else:
        inside = y0
    # out-of-range handling
    yl0 = y[..., 0]
    yl1 = y[..., 1 % count]
    ye0 = y[..., count - 1]
    ye1 = y[..., max(count - 2, 0)]
    lo_ex = yl0 + (yl0 - yl1) * (-t) * (count - 1)
    hi_ex = ye0 + (ye0 - ye1) * (t - 1.0) * (count - 1)
    lo = torch.where(extrap, lo_ex, yl0)
    hi = torch.where(extrap, hi_ex, ye0)
    out = torch.where(t < 0.0, lo, torch.where(t > 1.0, hi, inside))
    return ("num", out)


def _bump_fn(args):
    """Bump from a height gradient (Mikkelsen, 'Bump Mapping Unparameterized
    Surfaces on the GPU', 2010): bump(input, Nx, Ny, distance, sample_dx,
    sample_dy)."""
    inp, nx, ny = args[0][1], args[1][1], args[2][1]
    distance = _as_num(args[3])[1]
    sdx = _as_num(args[4])[1]
    sdy = _as_num(args[5])[1]
    rx = cross(ny, inp)
    ry = cross(inp, nx)
    det = torch.sum(nx * rx, dim=-1)
    grad = rx * sdx[..., None] + ry * sdy[..., None]
    out = (inp * torch.abs(det)[..., None]
           - grad * (torch.sign(det) * distance)[..., None])
    norm = torch.sqrt(maximum(torch.sum(out * out, dim=-1, keepdim=True),
                              1e-20))
    return ("vec3", out / norm)


def _ensure_valid_reflection(args):
    """Cycles' shading-normal clamp."""
    ng, i, n = args[0][1], args[1][1], args[2][1]
    r = 2.0 * torch.sum(i * n, dim=-1, keepdim=True) * n - i
    thr = minimum(0.9 * torch.sum(ng * i, dim=-1), 0.01)
    ok = torch.sum(ng * r, dim=-1) >= thr
    ndotng = torch.sum(n * ng, dim=-1, keepdim=True)
    xraw = n - ng * ndotng
    x = xraw / maximum(length(xraw)[..., None], 1e-20)
    ix = torch.sum(i * x, dim=-1)
    iz = torch.sum(i * ng, dim=-1)
    ix2, iz2 = ix * ix, iz * iz
    a = ix2 + iz2
    b = safe_sqrt(ix2 * (a - thr * thr))
    c = iz * thr + a
    fac = 0.5 / maximum(a, 1e-20)
    n1z2 = fac * (b + c)
    n2z2 = fac * (-b + c)
    v1 = (n1z2 > 1e-5) & (n1z2 <= 1.0 + 1e-5)
    v2 = (n2z2 > 1e-5) & (n2z2 <= 1.0 + 1e-5)
    # both valid -> the one closer to N (larger z); else the valid one
    z2 = torch.where(v1 & v2, maximum(n1z2, n2z2),
                     torch.where(v1, n1z2, n2z2))
    nx = safe_sqrt(1.0 - z2)
    nz = safe_sqrt(z2)
    n_new = x * nx[..., None] + ng * nz[..., None]
    use_new = (~ok) & (v1 | v2)
    out = torch.where(use_new[..., None], n_new,
                      torch.where(ok[..., None], n, ng))
    return ("vec3", out)


def _cbrt(x):
    # no torch.cbrt: the cube root in float64, rounded to float32
    return torch.copysign(torch.abs(x).double().pow(1.0 / 3.0), x).to(x.dtype)


def _snap(a, b):
    return torch.floor(_where(b == 0, 0.0, a / _where(b == 0, 1.0, b))) * b


def _pingpong(x, y):
    # the guard is |y| <= eps, as in the JAX package
    q = (x - y) / _where(y == 0, 1.0, y * 2)
    return _where(torch.abs(y) <= 1.1920929e-07, 0.0,
                  torch.abs((q - torch.floor(q)) * y * 2 - y))


def _smin(x, y, k):
    h = maximum(k - torch.abs(x - y), 0.0) / maximum(k, 1e-20)
    return minimum(x, y) - h * h * h * k / 6.0


def _wrap_fn(v, lo, hi):
    return _where(hi - lo <= 1.1920929e-07, lo,
                  v - (hi - lo) * torch.floor((v - lo) / _where(
                      hi == lo, 1.0, hi - lo)))


def _smootherstep(x):
    x = clip(x, 0, 1)
    return ipow(x, 3) * (x * (6 * x - 15) + 10)


_DEG2RAD = float(np.float32(np.pi / 180))
_RAD2DEG = float(np.float32(180 / np.pi))


def _num3(fn):
    return lambda args: ("num", fn(*[_as_num(a)[1] for a in args[:3]]))


FUNCTIONS = {
    # elementwise math family
    **{name: _elemwise(fn) for name, fn in {
        "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
        "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
        "exp": torch.exp, "exp2": torch.exp2, "log": torch.log,
        "log2": torch.log2, "log10": torch.log10, "floor": torch.floor,
        "ceil": torch.ceil, "round": torch.round,
        "fract": lambda x: x - torch.floor(x),
        "trunc": torch.trunc, "sqrt": torch.sqrt, "cbrt": _cbrt,
        "abs": torch.abs, "sign": torch.sign,
        "rad": lambda x: x * _DEG2RAD, "deg": lambda x: x * _RAD2DEG,
    }.items()},
    **{name: _elemwise2(fn) for name, fn in {
        "atan2": torch.atan2, "min": minimum, "max": maximum,
        "fmod": torch.fmod, "pow": torch.pow, "snap": _snap,
        "pingpong": _pingpong,
    }.items()},
    "vec2": lambda args: _vecn(args, 2),
    "vec3": lambda args: _vecn(args, 3),
    "vec4": lambda args: _vecn(args, 4),
    "color": _color_fn,
    "mix": _mix, "select": _select, "clamp": _clamp,
    "dot": _dot_fn, "cross": _cross_fn, "norm": _norm_fn,
    "length": _length_fn,
    "sum": _reduce_fn(lambda a: torch.sum(a, dim=-1)),
    "avg": _reduce_fn(lambda a: torch.mean(a, dim=-1)),
    "luminance": _luminance,
    "noise": _noise_fn, "snoise": _noise_fn, "pnoise": _noise_fn,
    "cellnoise": _noise_fn, "perlin": _noise_fn, "sperlin": _noise_fn,
    "voronoi": _noise_fn, "fbm": _noise_fn,
    "checkerboard": _checkerboard_fn,
    "fresnel_dielectric": _fresnel_dielectric_fn,
    "fresnel_conductor": _fresnel_conductor_fn,
    "blackbody": _blackbody,
    "rgbtoxyz": _color_conv(lambda c: _mat3_apply(_RGB2XYZ, c)),
    "xyztorgb": _color_conv(lambda c: _mat3_apply(_XYZ2RGB, c)),
    "rgbtohsv": _color_conv(_conv_hsv),
    "hsvtorgb": _color_conv(_conv_from_hsv),
    "rgbtohsl": _color_conv(_conv_hsl),
    "hsltorgb": _color_conv(_conv_from_hsl),
    "mix_screen": _mix_mode(_mix_screen_rgb),
    "mix_overlay": _mix_mode(_mix_overlay_rgb),
    "mix_dodge": _mix_mode(_mix_dodge_rgb),
    "mix_burn": _mix_mode(_mix_burn_rgb),
    "mix_soft": _mix_mode(_mix_soft_rgb),
    "mix_linear": _mix_mode(_mix_linear_rgb),
    "mix_hue": _mix_mode(_mix_hue_rgb),
    "mix_saturation": _mix_mode(_mix_saturation_rgb),
    "mix_value": _mix_mode(_mix_value_rgb),
    "mix_color": _mix_mode(_mix_color_rgb),
    "angle": _angle_fn,
    "rotate_euler": lambda args: _rotate_euler(args),
    "rotate_euler_inverse": lambda args: _rotate_euler(args, inverse=True),
    "rotate_axis": _rotate_axis_fn,
    "hash": _hash_fn,
    "signbit": lambda args: ("bool", _as_num(args[0])[1] < 0),
    "lookup": _lookup_fn,
    "ensure_valid_reflection": _ensure_valid_reflection,
    "bump": _bump_fn,
    "lerp": _mix,
    "smin": _num3(_smin),
    "smax": _num3(lambda x, y, k: -_smin(-x, -y, k)),
    "wrap": _num3(_wrap_fn),
    "smoothstep": _smoothstep,
    "smootherstep": lambda args: ("num", _smootherstep(_as_num(args[0])[1])),
    "dist": lambda args: ("num", length(args[0][1] - args[1][1])),
    "reflect": lambda args: ("vec3", 2.0 * torch.sum(
        args[1][1] * args[0][1], dim=-1, keepdim=True) * args[1][1]
        - args[0][1]),
}


# the colored noise family: three offset scalar draws
for _cname, _sname in (("cnoise", "noise"), ("cpnoise", "pnoise"),
                       ("ccellnoise", "cellnoise"), ("cperlin", "perlin"),
                       ("cvoronoi", "voronoi"), ("cfbm", "fbm")):
    FUNCTIONS[_cname] = _colored_noise(FUNCTIONS[_sname])


_PARSE_CACHE: dict[str, Node] = {}


def parse_cached(src: str) -> Node:
    node = _PARSE_CACHE.get(src)
    if node is None:
        node = parse_pexpr(src)
        _PARSE_CACHE[src] = node
    return node


def eval_pexpr(scene, tables, src: str, ctx):
    """Evaluate a PExpr string over the lane context; returns (kind, tensor)."""
    return Evaluator(scene, tables, ctx).eval(parse_cached(src))


def eval_pexpr_color(scene, tables, src: str, uv, ctx=None):
    """Evaluate to an RGB color (N, 3): vec4 drops alpha, num broadcasts."""
    full_ctx = dict(ctx or {})
    full_ctx.setdefault("uv", uv)
    kind, val = eval_pexpr(scene, tables, src, full_ctx)
    if kind in ("num", "int"):
        v = _f32(val)
        if v.ndim:
            return torch.broadcast_to(v[..., None], v.shape + (3,))
        return torch.broadcast_to(v, uv.shape[:-1] + (3,))
    if kind == "vec4":
        return val[..., :3]
    if kind == "vec3":
        return val
    if kind == "vec2":
        return torch.cat([val, torch.zeros(val.shape[:-1] + (1,),
                                           dtype=torch.float32,
                                           device=val.device)], dim=-1)
    raise PExprError(f"Cannot interpret PExpr result of type {kind} as color")
