"""User pair functions lowered for the pair kernels (counterpart of
atomsmm_tpu/ops/pallas_pair.py::_hoist_consts and the ``jax.jvp`` inside
its kernels).

The JAX package traces a CustomNonbondedForce's pair function into its
Pallas kernels: ``_hoist_consts`` closes it into a jaxpr, lifts its scalar
captures into SMEM, and the kernel takes u and du/dr² from one ``jax.jvp``
in r². A CUDA kernel cannot take a Python function, so the port traces the
function once per (force, dtype) into a fixed list of whitelisted
operations, the lowered form (``LoweredPair``), and

  * emits it as a ``__host__ __device__`` C++ struct (``cuda_source``)
    whose ``eval`` computes u and du/dr² by forward-mode dual arithmetic,
    each operation with its own JVP rule, and whose ``eval_dconst`` seeds
    the tangent on one runtime constant instead of r² (dU/dλ, as the
    softcore form's dlambda flag gives it). K1 and K2 (csrc/half_pair.cu,
    csrc/cell_pair.cu) compile it where a built-in form calls pair_form
    (_build.build_user);
  * evaluates the same list by torch operations with the same dual rules
    (``LoweredPair.evaluate``): the plain twin, which
    pair_kernel.half_pair_plain and full_pair_plain run on the CPU.

Tracing: ``make_fx`` in fake mode of
f(s, pi, pj, g) = fn(make_rv(s) if takes_rv else make_rv(s).r, pi, pj, g),
built as ops/rv.py::pair_eval builds it (float32 takes rsqrt, float64
1/sqrt, so a trace belongs to one dtype). Its inputs are r², the
per-particle columns of i and of j (at most MAX_COLUMNS names, as the JAX
kernels take) and the force's numeric globals as 0-d tensors. The globals
the function reads and the 0-d tensors it captures are runtime constants:
the kernels read them from a device array (``UserForm.consts``), so a new
global value neither retraces nor rebuilds. Python float literals are
baked into the source in the working type, as exact hex literals. A
capture of more than one value, an operation outside WHITELIST, more than
MAX_COLUMNS columns and control flow that reads a tensor's value (a fake
tensor has none) raise InputError, which names the cause.

>>> import torch
>>> def buck(r, pi, pj, g):
...     return pi["a"] * pj["a"] * torch.exp(-r / 0.03) - 1e-3 / r ** 6
>>> low = lower_pair_function(buck, ["a"], torch.float64)
>>> r2 = torch.tensor([0.09, 0.16], dtype=torch.float64)
>>> a = torch.tensor([2.0, 3.0], dtype=torch.float64)
>>> u, du = low.evaluate(r2, [a], [a], low.consts_of({}))
>>> ref = torch.func.jvp(lambda s: buck(torch.sqrt(s), {"a": a}, {"a": a},
...                                     {}), (r2,), (torch.ones_like(r2),))
>>> bool(torch.allclose(u, ref[0], rtol=1e-13)
...      and torch.allclose(du, ref[1], rtol=1e-12))
True
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import InputError
from .rv import make_rv

#: per-particle columns a lowered form takes, as the JAX kernels do
MAX_COLUMNS = 5

TWO_OVER_SQRT_PI = 2.0 / math.sqrt(math.pi)

# the lowered operations: arithmetic (float), comparisons and logic (bool)
_UNARY = ("neg", "recip", "exp", "log", "sqrt", "rsqrt", "erfc", "erf",
          "tanh", "sin", "cos", "abs", "atan", "asin", "acos", "sinh",
          "cosh", "expm1", "log1p")
# the special functions of the generated text: csrc/user_form.cuh's
# helpers, each a call of CUDA's math library in both types
_SPECIAL_FNS = ("exp", "log", "sqrt", "rsqrt", "erfc", "erf", "tanh", "sin",
                "cos", "pow", "atan", "asin", "acos", "sinh", "cosh", "expm1",
                "log1p")
_COMPARE = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==",
            "ne": "!="}
_LOGIC = {"and": "&&", "or": "||"}
# the generated text's operations (LoweredPair.counts): a literal T(...),
# a binary arithmetic operator, a comparison, logic and a special function
_LITERAL = re.compile(r"T\([^()]*\)")
_ARITH = re.compile(r" [-+*/] ")
_CMP = re.compile(r"\b\w+ (?:<=|>=|==|!=|<|>) \w+\b")
_LOGIC_OPS = re.compile(r" && | \|\| |!(?!=)")
_SPECIAL = re.compile(rf"\bu_(?:{'|'.join(_SPECIAL_FNS)})\(")
@dataclasses.dataclass(frozen=True)
class _Val:
    """One value of the lowered list. op: an operation of the list, or a
    leaf: 'r2', 'pi' / 'pj' (param = column), 'const' (param = index of
    the runtime constant), 'lit' (param = the value, already rounded to
    the working type), 'blit' (a bool literal). args: indices of earlier
    values."""

    op: str
    args: Tuple[int, ...] = ()
    param: object = None
    boolean: bool = False


# ---------------------------------------------------------------------------
# aten -> the lowered operations
# ---------------------------------------------------------------------------


class _Lowering:
    def __init__(self, dtype):
        self.dtype = dtype
        self.vals: List[_Val] = []
        self._memo: Dict[_Val, int] = {}

    def add(self, v: _Val) -> int:
        if v in self._memo:
            return self._memo[v]
        self.vals.append(v)
        self._memo[v] = len(self.vals) - 1
        return self._memo[v]

    def lit(self, x) -> int:
        if isinstance(x, bool):
            return self.add(_Val("blit", param=bool(x), boolean=True))
        x = float(x)
        if self.dtype == torch.float32:
            x = float(np.float32(x))
        return self.add(_Val("lit", param=x))

    def op(self, name, *args) -> int:
        boolean = name in _COMPARE or name in _LOGIC or name == "not"
        return self.add(_Val(name, tuple(args), boolean=boolean))

    def is_bool(self, i) -> bool:
        return self.vals[i].boolean

    def powi(self, x: int, n: int) -> int:
        """x ** n for an integer n, unrolled into products (square and
        multiply); a negative n takes the reciprocal."""
        if n == 0:
            return self.lit(1.0)
        result, base, k = None, x, abs(n)
        while k:
            if k & 1:
                result = base if result is None else self.op("mul", result,
                                                             base)
            k >>= 1
            if k:
                base = self.op("mul", base, base)
        return self.op("recip", result) if n < 0 else result


def _refuse(what: str):
    raise InputError(
        f"the pair function cannot be lowered for the pair kernels: {what}. "
        f"The lowered operations are: {', '.join(WHITELIST)}")


def _lower_node(b: _Lowering, node, arg):
    """The value index of call_function node `node`; `arg` maps an fx
    argument (a node or a Python number) to a value index."""
    name = str(node.target)
    a, kw = node.args, node.kwargs
    base = name.split(".")[1] if name.startswith("aten.") else name
    if name not in WHITELIST:
        _refuse(f"operation {name}")
    if base in ("alias", "lift_fresh_copy", "clone", "detach", "expand"):
        return arg(a[0])
    if base == "_to_copy":
        x, to = arg(a[0]), kw.get("dtype")
        if to is None or to == (torch.bool if b.is_bool(x) else b.dtype):
            return x
        if b.is_bool(x) and to.is_floating_point:
            return b.op("b2f", x)
        _refuse(f"a cast to {to} inside a {b.dtype} function")
    if base == "scalar_tensor":
        to = kw.get("dtype")
        return b.lit(bool(a[0]) if to == torch.bool else a[0])
    if base in ("zeros_like", "ones_like", "full_like"):
        value = {"zeros_like": 0.0, "ones_like": 1.0}.get(base)
        value = a[1] if value is None else value
        boolean = node.meta["val"].dtype == torch.bool
        return b.lit(bool(value) if boolean else value)
    if base in ("add", "sub", "rsub"):
        alpha = kw.get("alpha", a[2] if len(a) > 2 else 1)
        x, y = arg(a[0]), arg(a[1])
        if base == "rsub":
            x, y = y, x
            if alpha != 1:
                y = b.op("mul", y, b.lit(alpha))
            return b.op("sub", x, y)
        if alpha != 1:
            y = b.op("mul", y, b.lit(alpha))
        return b.op(base, x, y)
    if base in ("mul", "minimum", "maximum"):
        return b.op(base, arg(a[0]), arg(a[1]))
    if base == "div":
        return b.op("div", arg(a[0]), arg(a[1]))
    if base == "reciprocal":
        return b.op("recip", arg(a[0]))
    if base == "pow":
        e = a[1]
        if isinstance(a[0], torch.fx.Node) and isinstance(e, (int, float)) \
                and not isinstance(e, bool) and float(e).is_integer() \
                and abs(e) <= 64:
            return b.powi(arg(a[0]), int(e))
        return b.op("pow", arg(a[0]), arg(e))
    if base in _UNARY:
        return b.op(base, arg(a[0]))
    if base in _COMPARE:
        return b.op(base, arg(a[0]), arg(a[1]))
    if base in ("logical_and", "bitwise_and", "logical_or", "bitwise_or"):
        x, y = arg(a[0]), arg(a[1])
        if not (b.is_bool(x) and b.is_bool(y)):
            _refuse(f"{name} of non-boolean tensors")
        return b.op("and" if base.endswith("and") else "or", x, y)
    if base in ("logical_not", "bitwise_not"):
        x = arg(a[0])
        if not b.is_bool(x):
            _refuse(f"{name} of a non-boolean tensor")
        return b.op("not", x)
    if base == "where":
        return b.op("where", arg(a[0]), arg(a[1]), arg(a[2]))
    if base in ("clamp", "clamp_min", "clamp_max"):
        lo = a[1] if len(a) > 1 else kw.get("min")
        hi = a[2] if len(a) > 2 else kw.get("max")
        if base == "clamp_max":
            lo, hi = None, lo
        x = arg(a[0])
        if lo is not None:
            x = b.op("clamp_min", x, arg(lo))
        if hi is not None:
            x = b.op("clamp_max", x, arg(hi))
        return x
    _refuse(f"operation {name}")  # pragma: no cover - WHITELIST is matched


#: the aten operations a pair function may reach, by overload
WHITELIST = tuple(sorted(
    [f"aten.{op}.{ov}" for op in ("add", "sub", "mul", "div")
     for ov in ("Tensor", "Scalar")]
    + ["aten.rsub.Scalar", "aten.rsub.Tensor", "aten.neg.default",
       "aten.reciprocal.default", "aten.pow.Tensor_Scalar",
       "aten.pow.Tensor_Tensor", "aten.pow.Scalar"]
    + [f"aten.{op}.default" for op in _UNARY[2:]]
    + [f"aten.{op}.{ov}" for op in _COMPARE for ov in ("Tensor", "Scalar")]
    + ["aten.logical_and.default", "aten.logical_or.default",
       "aten.logical_not.default", "aten.bitwise_and.Tensor",
       "aten.bitwise_or.Tensor", "aten.bitwise_not.default"]
    + [f"aten.where.{ov}" for ov in ("self", "ScalarOther", "ScalarSelf",
                                     "Scalar")]
    + ["aten.clamp.default", "aten.clamp.Tensor", "aten.clamp_min.default",
       "aten.clamp_min.Tensor", "aten.clamp_max.default",
       "aten.clamp_max.Tensor", "aten.minimum.default",
       "aten.maximum.default"]
    + [f"aten.{op}.default" for op in ("alias", "lift_fresh_copy", "clone",
                                       "detach", "expand", "scalar_tensor",
                                       "zeros_like", "ones_like",
                                       "full_like", "_to_copy")]))


# ---------------------------------------------------------------------------
# the lowered form
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class LoweredPair:
    """A pair function as a fixed list of lowered operations (module
    docstring). `names`: its per-particle columns, in the order the kernels
    stage them; `globals`: the globals it reads, the first runtime
    constants; `captures`: its captured 0-d tensors, the constants after
    them."""

    dtype: torch.dtype
    names: Tuple[str, ...]
    globals: Tuple[str, ...]
    captures: Tuple[torch.Tensor, ...]
    vals: Tuple[_Val, ...]
    out: int
    label: str = ""
    _source: Optional[str] = dataclasses.field(default=None, repr=False)

    @property
    def n_consts(self) -> int:
        return len(self.globals) + len(self.captures)

    def consts_of(self, globals, device=None) -> torch.Tensor:
        """The runtime constants (n_consts,) in the working dtype on
        `device`: the globals' current values, then the captures."""
        g = globals or {}
        items = [g[k] for k in self.globals] + list(self.captures)
        if not items:
            return torch.zeros((0,), dtype=self.dtype, device=device)
        return torch.stack([
            v.detach().to(device=device, dtype=self.dtype).reshape(())
            if isinstance(v, torch.Tensor)
            else torch.tensor(float(v), dtype=self.dtype, device=device)
            for v in items])

    def consts_rows(self, globals, k: int, device=None) -> torch.Tensor:
        """The runtime constants of a stack of k rows, (k, n_consts) in the
        working dtype on `device`: a global given as a (k,) tensor (a
        lambda per row) fills its column row by row, any other value and
        the captures are the rows' shared constants."""
        g = globals or {}
        cols = []
        for v in [g[name] for name in self.globals] + list(self.captures):
            t = torch.as_tensor(v).detach().to(device=device,
                                               dtype=self.dtype)
            if t.ndim == 1 and t.shape[0] != k:
                raise ValueError(f"a global of {t.shape[0]} rows for a "
                                 f"stack of {k}")
            cols.append(t.reshape(-1).expand(k))
        if not cols:
            return torch.zeros((k, 0), dtype=self.dtype, device=device)
        return torch.stack(cols, dim=1)

    def constant_index(self, name: str) -> Optional[int]:
        """The constant index of global `name`, None where the function
        does not read it."""
        return self.globals.index(name) if name in self.globals else None

    def counts(self) -> Dict[str, int]:
        """Operations of one evaluation of (u, du/dr²), counted from the
        text of the generated eval (_c_values), value and tangent of each
        lowered value as emitted: 'flops', the additions, subtractions,
        products, divisions, selections, logic and each distinct
        comparison of a value once (the tangent's repeat of the value's
        comparison is one instruction on the card); and 'special', the
        results of the special functions (_SPECIAL_FNS: exp, log, sqrt,
        rsqrt, erfc, erf, tanh, sin, cos, pow, atan, asin, acos, sinh,
        cosh, expm1, log1p). Not counted, so that the count is at most what the card
        executes: a negation (an operand modifier on the card), a product
        by the literal 1 or by r²'s unit tangent (folded by the compiler)
        and a special function's own arithmetic. chip_smoke.py's bound
        counts these per pair."""
        flops = special = 0
        ones = []
        for i, v, y, d in self._c_values(seed_r2=True):
            if y == "T(0x1.0000000000000p+0)":
                ones.append(f"v{i}")
            if d == "T(1)":
                ones.append(f"d{i}")
            text = y if d is None else f"{y} ; {d}"
            for name in ones:
                text = re.sub(rf"\b{name} \* | \* {name}\b", " ", text)
            text = _LITERAL.sub("L", text)
            flops += (len(_ARITH.findall(text)) + text.count("?")
                      + len(set(_CMP.findall(text)))
                      + len(_LOGIC_OPS.findall(text))
                      + text.count("u_abs(") + 4 * text.count("u_sign("))
            special += len(_SPECIAL.findall(text))
        return {"flops": flops, "special": special}

    # -- dependence on the seed ------------------------------------------

    def _deps(self, seed_r2: bool) -> List[bool]:
        """Whether each value's tangent can be nonzero: seeded on r² or on
        the runtime constants (eval_dconst)."""
        dep = []
        for v in self.vals:
            if v.op == "r2":
                dep.append(seed_r2)
            elif v.op == "const":
                dep.append(not seed_r2)
            elif v.boolean or v.op in ("pi", "pj", "lit", "b2f"):
                dep.append(False)
            elif v.op == "where":
                dep.append(dep[v.args[1]] or dep[v.args[2]])
            else:
                dep.append(any(dep[a] for a in v.args))
        return dep

    # -- the plain twin -------------------------------------------------

    def evaluate(self, r2, pi: Sequence[torch.Tensor],
                 pj: Sequence[torch.Tensor], consts: torch.Tensor,
                 dconst: Optional[int] = None):
        """(u, du/dr²) by torch operations with the kernels' dual rules, on
        broadcastable r², columns pi / pj (in `names` order) and the
        runtime constants, on their last axis (leading axes broadcast with
        r²: the rows of a stack); with `dconst` the tangent is seeded on
        constant `dconst` instead, and the second result is du/d(that
        constant)."""
        seed_r2 = dconst is None
        dep = self._deps(seed_r2)
        dt, dev = r2.dtype, r2.device
        zero = torch.zeros((), dtype=dt, device=dev)
        one = torch.ones((), dtype=dt, device=dev)
        val: List[torch.Tensor] = []
        tan: List[Optional[torch.Tensor]] = []
        for i, v in enumerate(self.vals):
            x = [val[a] for a in v.args]
            dx = [tan[a] for a in v.args]
            d = None
            if v.op == "r2":
                y = r2
                d = one if seed_r2 else None
            elif v.op == "pi":
                y = pi[v.param]
            elif v.op == "pj":
                y = pj[v.param]
            elif v.op == "const":
                y = consts[..., v.param]
                d = (one if v.param == dconst else zero) if not seed_r2 \
                    else None
            elif v.op in ("lit", "blit"):
                y = torch.tensor(v.param, dtype=torch.bool if v.boolean
                                 else dt, device=dev)
            else:
                y, d = _torch_rule(v.op, x, dx if dep[i] else None, zero)
            val.append(y)
            tan.append(d if dep[i] else None)
        u = val[self.out]
        du = tan[self.out]
        shape = torch.broadcast_shapes(r2.shape, u.shape)
        u = u.expand(shape) if u.shape != shape else u
        du = torch.zeros(shape, dtype=dt, device=dev) if du is None \
            else du.expand(shape) if du.shape != shape else du
        return u, du

    # -- the CUDA C++ text ----------------------------------------------

    def cuda_source(self) -> str:
        """The generated header: struct UserPair with eval and eval_dconst,
        ``__host__ __device__``, over csrc/user_form.cuh's math. NCOLS is
        at least 1: a function of r alone is staged one zero column."""
        if self._source is None:
            self._source = self._emit()
        return self._source

    def _emit(self) -> str:
        ctype = "float" if self.dtype == torch.float32 else "double"
        lines = [
            "// Generated by atomsmm_tpu_torch/ops/pairtrace.py from the pair",
            f"// function {self.label or '<anonymous>'}: columns "
            f"{', '.join(self.names) or '(none)'}; constants "
            f"{', '.join(self.globals) or '(no globals)'}"
            f" + {len(self.captures)} captured.",
            "#pragma once",
            '#include "user_form.cuh"',
            "",
            "struct UserPair {",
            f"  using T = {ctype};",
            "  static constexpr bool USER = true;",
            f"  static constexpr int NCOLS = {max(1, len(self.names))};",
            f"  static constexpr int NCONSTS = {self.n_consts};",
            "",
            "  // u and du/dr^2 at squared distance r2",
            "  __host__ __device__ static void eval(T r2, const T* pi, "
            "const T* pj, const T* c, T& u, T& dudr2) {",
            "    using namespace userform;",
        ]
        lines += self._c_body(seed_r2=True)
        lines += ["  }", "",
                  "  // u and du/dc[which]: the tangent seeded on one "
                  "runtime constant",
                  "  __host__ __device__ static void eval_dconst(T r2, "
                  "const T* pi, const T* pj, const T* c, int which, T& u, "
                  "T& du) {",
                  "    using namespace userform;"]
        lines += self._c_body(seed_r2=False)
        lines += ["  }", "};", ""]
        return "\n".join(lines)

    def _c_values(self, seed_r2: bool):
        """(index, value, value expression, tangent expression or None
        where its tangent is zero) of each lowered value in C++."""
        dep = self._deps(seed_r2)
        for i, v in enumerate(self.vals):
            x = [f"v{a}" for a in v.args]
            dx = [f"d{a}" if dep[a] else None for a in v.args]
            d = None
            if v.op == "r2":
                y, d = "r2", "T(1)"
            elif v.op in ("pi", "pj"):
                y = f"{v.op}[{v.param}]"
            elif v.op == "const":
                y = f"c[{v.param}]"
                d = f"(which == {v.param} ? T(1) : T(0))"
            elif v.op == "lit":
                y = _c_literal(v.param)
            elif v.op == "blit":
                y = "true" if v.param else "false"
            else:
                y, d = _c_rule(v.op, x, dx, f"v{i}")
            yield i, v, y, d if dep[i] else None

    def _c_body(self, seed_r2: bool) -> List[str]:
        out = []
        for i, v, y, d in self._c_values(seed_r2):
            kind = "bool" if v.boolean else "T"
            out.append(f"    const {kind} v{i} = {y};")
            if d is not None:
                out.append(f"    const T d{i} = {d};")
        o = self.out
        d_out = self._deps(seed_r2)[o]
        out.append(f"    u = v{o};")
        out.append(f"    {'dudr2' if seed_r2 else 'du'} = "
                   f"{f'd{o}' if d_out else 'T(0)'};")
        return out


def _c_literal(x: float) -> str:
    if math.isnan(x):
        return "T(NAN)"
    if math.isinf(x):
        return "T(INFINITY)" if x > 0 else "T(-INFINITY)"
    return f"T({float.hex(x)})"


def _torch_rule(op, x, dx, zero):
    """(value, tangent) of one lowered operation in torch; dx None: the
    tangent is not needed, an entry None: that operand's is zero."""
    need = dx is not None
    dx = dx if need else [None] * len(x)

    def z(t):
        return zero if t is None else t

    if op == "add":
        y = x[0] + x[1]
        d = _tsum(dx[0], dx[1])
    elif op == "sub":
        y = x[0] - x[1]
        d = dx[0] if dx[1] is None else (-dx[1] if dx[0] is None
                                         else dx[0] - dx[1])
    elif op == "mul":
        y = x[0] * x[1]
        d = _tsum(None if dx[0] is None else dx[0] * x[1],
                  None if dx[1] is None else x[0] * dx[1])
    elif op == "div":
        y = x[0] / x[1]
        if dx[1] is None:
            d = None if dx[0] is None else dx[0] / x[1]
        else:
            d = (z(dx[0]) - y * dx[1]) / x[1]
    elif op == "neg":
        y = -x[0]
        d = None if dx[0] is None else -dx[0]
    elif op == "recip":
        y = torch.reciprocal(x[0])
        d = None if dx[0] is None else -(y * y) * dx[0]
    elif op == "pow":
        y = torch.pow(x[0], x[1])
        d = _tsum(None if dx[0] is None
                  else x[1] * torch.pow(x[0], x[1] - 1.0) * dx[0],
                  None if dx[1] is None else y * torch.log(x[0]) * dx[1])
    elif op == "exp":
        y = torch.exp(x[0])
        d = None if dx[0] is None else y * dx[0]
    elif op == "log":
        y = torch.log(x[0])
        d = None if dx[0] is None else dx[0] / x[0]
    elif op == "sqrt":
        y = torch.sqrt(x[0])
        d = None if dx[0] is None else dx[0] / (2.0 * y)
    elif op == "rsqrt":
        y = torch.rsqrt(x[0])
        d = None if dx[0] is None else -0.5 * y * y * y * dx[0]
    elif op in ("erfc", "erf"):
        y = torch.erfc(x[0]) if op == "erfc" else torch.erf(x[0])
        k = -TWO_OVER_SQRT_PI if op == "erfc" else TWO_OVER_SQRT_PI
        d = None if dx[0] is None else k * torch.exp(-(x[0] * x[0])) * dx[0]
    elif op == "tanh":
        y = torch.tanh(x[0])
        d = None if dx[0] is None else (1.0 - y * y) * dx[0]
    elif op == "sin":
        y = torch.sin(x[0])
        d = None if dx[0] is None else torch.cos(x[0]) * dx[0]
    elif op == "cos":
        y = torch.cos(x[0])
        d = None if dx[0] is None else -torch.sin(x[0]) * dx[0]
    elif op == "abs":
        y = torch.abs(x[0])
        d = None if dx[0] is None else torch.sign(x[0]) * dx[0]
    elif op == "atan":
        y = torch.atan(x[0])
        d = None if dx[0] is None else dx[0] / (1.0 + x[0] * x[0])
    elif op in ("asin", "acos"):
        y = torch.asin(x[0]) if op == "asin" else torch.acos(x[0])
        d = None if dx[0] is None else dx[0] / torch.sqrt(1.0 - x[0] * x[0])
        d = -d if op == "acos" and d is not None else d
    elif op == "sinh":
        y = torch.sinh(x[0])
        d = None if dx[0] is None else torch.cosh(x[0]) * dx[0]
    elif op == "cosh":
        y = torch.cosh(x[0])
        d = None if dx[0] is None else torch.sinh(x[0]) * dx[0]
    elif op == "expm1":
        y = torch.expm1(x[0])
        d = None if dx[0] is None else (y + 1.0) * dx[0]
    elif op == "log1p":
        y = torch.log1p(x[0])
        d = None if dx[0] is None else dx[0] / (1.0 + x[0])
    elif op in ("minimum", "maximum"):
        a, b = x
        y = torch.minimum(a, b) if op == "minimum" else torch.maximum(a, b)
        first = a < b if op == "minimum" else a > b
        second = a > b if op == "minimum" else a < b
        d = None if dx[0] is None and dx[1] is None else torch.where(
            first, z(dx[0]), torch.where(second, z(dx[1]),
                                         (z(dx[0]) + z(dx[1])) * 0.5))
    elif op == "clamp_min":
        y = torch.where(x[0] < x[1], x[1], x[0])
        d = None if dx[0] is None and dx[1] is None else torch.where(
            x[0] >= x[1], z(dx[0]), z(dx[1]))
    elif op == "clamp_max":
        y = torch.where(x[0] > x[1], x[1], x[0])
        d = None if dx[0] is None and dx[1] is None else torch.where(
            x[0] <= x[1], z(dx[0]), z(dx[1]))
    elif op == "where":
        y = torch.where(x[0], x[1], x[2])
        d = None if dx[1] is None and dx[2] is None else torch.where(
            x[0], z(dx[1]), z(dx[2]))
    elif op in _COMPARE:
        y = getattr(torch, op)(x[0], x[1])
        d = None
    elif op == "and":
        y, d = torch.logical_and(x[0], x[1]), None
    elif op == "or":
        y, d = torch.logical_or(x[0], x[1]), None
    elif op == "not":
        y, d = torch.logical_not(x[0]), None
    elif op == "b2f":
        y, d = x[0].to(zero.dtype), None
    else:  # pragma: no cover - the list holds lowered operations only
        raise AssertionError(op)
    return y, d


def _tsum(a, b):
    if a is None:
        return b
    return a if b is None else a + b


def _c_rule(op, x, dx, name):
    """(value, tangent) expressions of one lowered operation in C++; `name`
    is the value's variable, an entry of `dx` None where that operand's
    tangent is zero. The tangents are the torch twin's, term for term."""
    a = x[0]
    b = x[1] if len(x) > 1 else None
    da = dx[0] if dx else None
    db = dx[1] if len(dx) > 1 else None

    def z(t):
        return "T(0)" if t is None else t

    def tsum(p, q):
        if p is None:
            return q
        return p if q is None else f"{p} + {q}"

    if op == "add":
        return f"{a} + {b}", tsum(da, db)
    if op == "sub":
        d = da if db is None else (f"-{db}" if da is None else f"{da} - {db}")
        return f"{a} - {b}", d
    if op == "mul":
        return f"{a} * {b}", tsum(None if da is None else f"{da} * {b}",
                                  None if db is None else f"{a} * {db}")
    if op == "div":
        if db is None:
            d = None if da is None else f"{da} / {b}"
        else:
            d = f"({z(da)} - {name} * {db}) / {b}"
        return f"{a} / {b}", d
    if op == "neg":
        return f"-{a}", None if da is None else f"-{da}"
    if op == "recip":
        return f"T(1) / {a}", None if da is None else \
            f"-({name} * {name}) * {da}"
    if op == "pow":
        return f"u_pow({a}, {b})", tsum(
            None if da is None else f"{b} * u_pow({a}, {b} - T(1)) * {da}",
            None if db is None else f"{name} * u_log({a}) * {db}")
    if op == "exp":
        return f"u_exp({a})", None if da is None else f"{name} * {da}"
    if op == "log":
        return f"u_log({a})", None if da is None else f"{da} / {a}"
    if op == "sqrt":
        return f"u_sqrt({a})", None if da is None else \
            f"{da} / (T(2) * {name})"
    if op == "rsqrt":
        return f"u_rsqrt({a})", None if da is None else \
            f"T(-0.5) * {name} * {name} * {name} * {da}"
    if op in ("erfc", "erf"):
        k = _c_literal(-TWO_OVER_SQRT_PI if op == "erfc"
                       else TWO_OVER_SQRT_PI)
        return f"u_{op}({a})", None if da is None else \
            f"{k} * u_exp(-({a} * {a})) * {da}"
    if op == "tanh":
        return f"u_tanh({a})", None if da is None else \
            f"(T(1) - {name} * {name}) * {da}"
    if op == "sin":
        return f"u_sin({a})", None if da is None else f"u_cos({a}) * {da}"
    if op == "cos":
        return f"u_cos({a})", None if da is None else f"-u_sin({a}) * {da}"
    if op == "abs":
        return f"u_abs({a})", None if da is None else f"u_sign({a}) * {da}"
    if op == "atan":
        return f"u_atan({a})", None if da is None else \
            f"{da} / (T(1) + {a} * {a})"
    if op in ("asin", "acos"):
        d = None if da is None else f"{da} / u_sqrt(T(1) - {a} * {a})"
        return f"u_{op}({a})", d if d is None or op == "asin" else f"-({d})"
    if op == "sinh":
        return f"u_sinh({a})", None if da is None else f"u_cosh({a}) * {da}"
    if op == "cosh":
        return f"u_cosh({a})", None if da is None else f"u_sinh({a}) * {da}"
    if op == "expm1":
        return f"u_expm1({a})", None if da is None else \
            f"({name} + T(1)) * {da}"
    if op == "log1p":
        return f"u_log1p({a})", None if da is None else \
            f"{da} / (T(1) + {a})"
    if op in ("minimum", "maximum"):
        lt, gt = ("<", ">") if op == "minimum" else (">", "<")
        d = None if da is None and db is None else (
            f"({a} {lt} {b} ? {z(da)} : ({a} {gt} {b} ? {z(db)} : "
            f"({z(da)} + {z(db)}) * T(0.5)))")
        return f"({a} {lt} {b} ? {a} : ({a} {gt} {b} ? {b} : {a}))", d
    if op == "clamp_min":
        return f"({a} < {b} ? {b} : {a})", None if da is None and \
            db is None else f"({a} >= {b} ? {z(da)} : {z(db)})"
    if op == "clamp_max":
        return f"({a} > {b} ? {b} : {a})", None if da is None and \
            db is None else f"({a} <= {b} ? {z(da)} : {z(db)})"
    if op == "where":
        c, p, q = x
        dp, dq = dx[1], dx[2]
        return f"({c} ? {p} : {q})", None if dp is None and dq is None \
            else f"({c} ? {z(dp)} : {z(dq)})"
    if op in _COMPARE:
        return f"({a} {_COMPARE[op]} {b})", None
    if op in _LOGIC:
        return f"({a} {_LOGIC[op]} {b})", None
    if op == "not":
        return f"!{a}", None
    if op == "b2f":
        return f"({a} ? T(1) : T(0))", None
    raise AssertionError(op)  # pragma: no cover


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------


def numeric_globals(globals) -> List[str]:
    """The globals a trace takes as runtime constants: numbers and 0-d
    tensors (Context passes 0-d tensors)."""
    out = []
    for k, v in (globals or {}).items():
        if isinstance(v, torch.Tensor):
            if v.ndim == 0 and v.dtype != torch.bool \
                    and not v.dtype.is_complex:
                out.append(k)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out.append(k)
    return sorted(out)


def lower_pair_function(fn, names: Sequence[str], dtype, globals=None,
                        device="cpu") -> LoweredPair:
    """Trace `fn(r, pi, pj, g)` (an energy_function of
    CustomNonbondedForce; r the distance, or the Rv carrier where
    fn.takes_rv) over the per-particle columns
    `names` in `dtype`, with the numeric entries of `globals` as runtime
    constants, and lower it (module docstring). Raises InputError where
    it cannot be lowered."""
    from torch.fx.experimental.proxy_tensor import make_fx

    names = tuple(names)
    if len(names) > MAX_COLUMNS:
        raise InputError(
            f"the pair function takes {len(names)} per-particle columns "
            f"({', '.join(names)}); the pair kernels stage at most "
            f"{MAX_COLUMNS}, as the JAX package's kernels do")
    if dtype not in (torch.float32, torch.float64):
        raise InputError(f"the pair kernels take float32 or float64, not "
                         f"{dtype}")
    takes_rv = getattr(fn, "takes_rv", False)
    gnames = numeric_globals(globals)
    rest = {k: v for k, v in (globals or {}).items() if k not in gnames}
    p = len(names)

    def f(s, *flat):
        pi = dict(zip(names, flat[:p]))
        pj = dict(zip(names, flat[p:2 * p]))
        g = dict(rest)
        g.update(zip(gnames, flat[2 * p:]))
        rv = make_rv(s)
        return fn(rv if takes_rv else rv.r, pi, pj, g)

    ex = [torch.full((4,), 1.0 + 0.25 * k, dtype=dtype, device=device)
          for k in range(1 + 2 * p)]
    ex += [torch.ones((), dtype=dtype, device=device) for _ in gnames]
    try:
        gm = make_fx(f, tracing_mode="fake", _allow_non_fake_inputs=True)(
            *ex)
    except InputError:
        raise
    except Exception as e:  # noqa: BLE001 - any failure of the trace
        raise InputError(
            "the pair function cannot be traced for the pair kernels "
            f"({type(e).__name__}: {str(e).splitlines()[0][:200]}); it must "
            "be torch operations on its arguments, without control flow on "
            "their values") from e

    b = _Lowering(dtype)
    env = {}
    used_globals, captures = [], []
    place = 0

    def arg(a):
        """The value index of an fx argument; a global's or a capture's
        marker becomes a constant leaf, its index fixed below."""
        if isinstance(a, torch.fx.Node):
            v = env[a]
            return b.add(_Val("const", param=v)) if isinstance(v, tuple) \
                else v
        if isinstance(a, (bool, int, float)):
            return b.lit(a)
        _refuse(f"an argument {a!r}")

    for node in gm.graph.nodes:
        if node.op == "placeholder":
            k = place
            place += 1
            if k == 0:
                env[node] = b.add(_Val("r2"))
            elif k <= 2 * p:
                side = "pi" if k <= p else "pj"
                env[node] = b.add(_Val(side, param=(k - 1) % p))
            elif node.users:
                used_globals.append(gnames[k - 1 - 2 * p])
                env[node] = ("global", len(used_globals) - 1)
        elif node.op == "get_attr":
            t = getattr(gm, node.target)
            if not isinstance(t, torch.Tensor) or t.ndim != 0:
                raise InputError(
                    "the pair function captures a tensor of shape "
                    f"{tuple(getattr(t, 'shape', ()))}; the pair kernels "
                    "take captured scalars only (0-d tensors), as the JAX "
                    "package's kernels do: pass per-atom data as a "
                    "per-particle column, or a scalar as a global")
            captures.append(t.detach())
            env[node] = ("capture", len(captures) - 1)
        elif node.op == "call_function":
            env[node] = _lower_node(b, node, arg)
        elif node.op == "output":
            res = node.args[0]
            if isinstance(res, (tuple, list)):
                if len(res) != 1:
                    _refuse("a function with more than one result")
                res = res[0]
            out = arg(res)
            if b.is_bool(out):
                _refuse("a boolean result")
    # constants: the globals first, then the captures
    n_g = len(used_globals)
    vals = []
    for v in b.vals:
        if v.op == "const" and isinstance(v.param, tuple):
            kind, k = v.param
            v = _Val("const", param=k if kind == "global" else n_g + k)
        vals.append(v)
    label = getattr(fn, "__qualname__", getattr(fn, "__name__", ""))
    return LoweredPair(dtype, names, tuple(used_globals), tuple(captures),
                       tuple(vals), out, label)


# ---------------------------------------------------------------------------
# the form the kernels take
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class UserForm:
    """A lowered pair function as the pair kernels (and their plain twins)
    take it, in place of a built-in PairForm: the lowered list, its runtime
    constants (n_consts,) on the device (or a stack's (K, n_consts), row k
    the constants of row k), and the flags. `virial`: each
    pair's -2 r² du/dr² in place of u, the force unchanged; `dconst` >= 0:
    du/d(constant dconst) in place of u and no force (dU/dλ of a global)."""

    lowered: LoweredPair
    consts: torch.Tensor  # (n_consts,), or (K, n_consts): a stack's rows
    r_cut: float
    virial: bool = False
    dconst: int = -1

    def __post_init__(self):
        if self.virial and self.dconst >= 0:
            raise ValueError("a user form takes the virial or the dconst "
                             "seed, not both")

    def scalars(self):
        """The kernels' scalar block (pair_forms.cuh::make_params): a user
        form reads only the cutoff, which pair_kernel._form_block puts
        around it."""
        return [0.0] * 12 + [1.0]

    def flags(self):
        """The flag block: dlambda (the seed on a constant) and virial."""
        return [0, 0, 0, 0, 0, int(self.dconst >= 0), 0, 0,
                int(self.virial)]

    def u_dudr2(self, r2, pi, pj):
        """(u, du/dr²) of the pairs at r2 (masked slots pre-set to 1) with
        the columns pi / pj; under the flags as the kernels apply them."""
        if self.dconst >= 0:
            _, du = self.lowered.evaluate(r2, pi, pj, self.consts,
                                          dconst=self.dconst)
            return du, torch.zeros_like(du)
        u, dudr2 = self.lowered.evaluate(r2, pi, pj, self.consts)
        if self.virial:
            u = -2.0 * r2 * dudr2
        return u, dudr2


def user_form(lowered: LoweredPair, globals, r_cut, device=None) -> UserForm:
    """The UserForm of `lowered` at the current `globals` (for dU/d a
    global, replace its dconst by lowered.constant_index(name))."""
    return UserForm(lowered, lowered.consts_of(globals, device), float(r_cut))
