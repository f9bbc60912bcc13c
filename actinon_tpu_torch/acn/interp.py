"""`.acn` evaluator.

Faithful re-implementation of the reference's metacode evaluator
(meval_s_eval / meval_s_execute, reference src/interpreter.c:1412-1850)
including its operator model:

  * `*` `/` `%`, comparisons and `:` chain immediately (higher precedence,
    left-associative),
  * `+` `-` and the logic/CSG operators `&` `|` `^` first evaluate the entire
    right-hand expression (lower precedence, right-associative),
  * unary `+ - ! (&) (|) (:) (@)` bind to the immediately following atom,
  * postfix call `()`, indexing `[]` and member access `.` bind tightest.

Value semantics mirror the reference's typed-ref model: `def`, `=`, container
pushes and member stores CLONE; function arguments, member reads and for-in
loop variables alias (reference src/interpreter.c:1659, src/container.c:271,
src/interpreter.c:1828).
"""

from __future__ import annotations

import math
import os
import time
from typing import List, Optional

import numpy as np

from actinon_tpu_torch.acn import lexer as lx
from actinon_tpu_torch.acn.format import format_fa
from actinon_tpu_torch.acn.lexer import Code, MType
from actinon_tpu_torch.scene.objects import (
    ArrS, Compound, DistanceObj, DistanceSphere, DistanceTorus, Envelope,
    MapS, Neg, Obj, PairInside, PairOutside, Plane, ScaleWrap, Scene, Sphere,
    Squaroid, TxmChess, TxmPlain, apply_material, make_torus, rot_x, rot_y,
    rot_z, v3,
)

INF = float("inf")


class AcnError(Exception):
    pass


# ---------------------------------------------------------------------------
# runtime value helpers


def is_num(v):
    return isinstance(v, (bool, int, float))


def is_v3(v):
    return isinstance(v, np.ndarray) and v.shape == (3,)


def is_m3(v):
    return isinstance(v, np.ndarray) and v.shape == (3, 3)


def clone_value(v):
    """`sr_clone` analog: deep for mutable scene values, identity for
    immutables and closures (mclosure clone shares code + lexical frame,
    reference src/interpreter.c:1871-1876)."""
    if v is None or isinstance(v, (bool, int, float, str, Closure, Builtin,
                                   Signature, MType)):
        return v
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, (Obj, Compound, ArrS, MapS, Envelope, TxmPlain, TxmChess,
                      Scene)):
        return v.clone()
    raise AcnError(f"cannot clone {type(v).__name__}")


def type_name(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, int):
        return "int"
    if isinstance(v, float):
        return "float"
    if isinstance(v, str):
        return "string"
    if is_v3(v):
        return "v3d"
    if is_m3(v):
        return "m3d"
    return type(v).__name__


def matches_sig_type(v, t: Optional[str]) -> bool:
    """Signature type check (reference src/interpreter.c:1389-1399)."""
    if t is None:
        return True
    if t == "num":
        return is_num(v)
    if t == "bool":
        return isinstance(v, bool)
    if t == "int":
        return isinstance(v, int) and not isinstance(v, bool)
    if t == "float":
        return isinstance(v, float)
    if t == "string":
        return isinstance(v, str)
    if t == "map":
        return isinstance(v, MapS)
    if t == "list":
        return isinstance(v, ArrS)
    if t == "object":
        return isinstance(v, Obj)
    if t == "v3d":
        return is_v3(v)
    if t == "func":
        return isinstance(v, (Closure, Builtin))
    return False


def fmt_num(v) -> str:
    """Number rendering for string concatenation (beth `#<s3_t>`/`#<f3_t>`)."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    return f"{v:g}"


# ---------------------------------------------------------------------------


class Frame:
    """Lexically chained variable frame (bclos_frame_s analog)."""

    __slots__ = ("vars", "external")

    def __init__(self, external: Optional["Frame"] = None):
        self.vars = {}
        self.external = external

    def lookup_frame(self, key) -> Optional["Frame"]:
        f = self
        while f is not None:
            if key in f.vars:
                return f
            f = f.external
        return None

    def get(self, key):
        f = self.lookup_frame(key)
        return (f.vars[key], f) if f else (None, None)

    def set_local(self, key, v):
        self.vars[key] = v


class Signature:
    """Value of a `<-(...)` expression (bclos_signature_s analog)."""

    __slots__ = ("args",)

    def __init__(self, args):
        self.args = args  # list of (type_name_or_None, name)


class Closure:
    """User function: code + signature + lexical frame (mclosure_s analog)."""

    __slots__ = ("code", "sig", "lexical_frame")

    def __init__(self, code: Code, sig: Optional[Signature], lexical_frame: Frame):
        self.code = code
        self.sig = sig
        self.lexical_frame = lexical_frame


class Builtin:
    """Built-in closure (reference src/closures.c)."""

    __slots__ = ("name", "fn", "arity", "types")

    def __init__(self, name, fn, arity, types=None):
        self.name = name
        self.fn = fn
        self.arity = arity
        self.types = types  # list of sig type names or None


# --- lvalues ---------------------------------------------------------------


class FrameRef:
    __slots__ = ("frame", "key")

    def __init__(self, frame, key):
        self.frame = frame
        self.key = key

    def set(self, v):
        self.frame.vars[self.key] = v


class MapRef:
    __slots__ = ("m", "key")

    def __init__(self, m, key):
        self.m = m
        self.key = key

    def set(self, v):
        self.m.data[self.key] = v


class ArrRef:
    __slots__ = ("arr", "idx")

    def __init__(self, arr, idx):
        self.arr = arr
        self.idx = idx

    def set(self, v):
        self.arr.data[self.idx] = v


class FieldRef:
    __slots__ = ("obj", "key")

    def __init__(self, obj, key):
        self.obj = obj
        self.key = key

    def set(self, v):
        via_set(self.obj, self.key, v)


# --- reflective field access (bcore_via analog) ----------------------------

_V3_FIELDS = {"x": 0, "y": 1, "z": 2}


def via_has(obj, key) -> bool:
    if isinstance(obj, Scene):
        return key in obj.cfg.field_names()
    if is_v3(obj):
        return key in _V3_FIELDS
    if isinstance(obj, Envelope):
        return key in ("pos", "radius")
    if isinstance(obj, Sphere):
        return key == "radius"
    if isinstance(obj, Squaroid):
        return key in ("a", "b", "c", "r")
    if isinstance(obj, DistanceObj):
        return key in ("cycles", "inv_scale")
    return False


def via_get(obj, key):
    if isinstance(obj, Scene):
        return obj.cfg.get_field(key)
    if is_v3(obj):
        return float(obj[_V3_FIELDS[key]])
    return getattr(obj, key)


def via_set(obj, key, v):
    if isinstance(obj, Scene):
        obj.cfg.set_field(key, clone_value(v))
    elif is_v3(obj):
        obj[_V3_FIELDS[key]] = float(v)
    elif isinstance(obj, Envelope) and key == "pos":
        obj.pos = np.asarray(v, np.float64).copy()
    else:
        setattr(obj, key, type(getattr(obj, key))(v) if is_num(v) else clone_value(v))


# ---------------------------------------------------------------------------


MISSING = object()  # "no front object" marker (sr_null analog for eval entry)


class Meval:
    """Evaluation cursor over one Code object (meval_s analog)."""

    def __init__(self, interp: "Interp", code: Code, frame: Frame):
        self.interp = interp
        self.code = code
        self.frame = frame
        self.index = 0

    # --- cursor primitives ---

    def err(self, msg):
        f, l = self.code.where(self.index)
        raise AcnError(f"{f}:{l}: {msg}")

    def peek(self):
        c = self.code.code
        return c[self.index] if self.index < len(c) else lx.CL_NULL

    def get(self):
        c = self.code.code
        if self.index < len(c):
            v = c[self.index]
            self.index += 1
            return v
        return lx.CL_NULL

    def try_code(self, code):
        if self.peek() == code:
            self.get()
            return True
        return False

    def expect(self, code):
        if not self.try_code(code):
            self.err(f"'{lx.SYMBOL.get(code, code)}' expected")

    def end(self):
        return self.index >= len(self.code.code)

    def get_data(self):
        self.expect(lx.CL_DATA)
        return self.code.data[self.get()]

    def get_name(self):
        self.expect(lx.CL_NAME)
        return self.get()

    # --- typed expression helpers ---

    def eval_v3d(self):
        v = self.eval()
        if not is_v3(v):
            self.err("vector expected")
        return v

    def eval_f3(self):
        v = self.eval()
        if not is_num(v):
            self.err("scalar expected")
        return float(v)

    def eval_bool(self):
        v = self.eval()
        if not isinstance(v, bool):
            self.err("boolean expected")
        return v

    def eval_rot(self):
        v = self.eval()
        if not is_m3(v):
            self.err("rotation expected")
        return v

    def eval_string(self):
        v = self.eval()
        if not isinstance(v, str):
            self.err("string expected")
        return v

    # --- calls ---

    def eval_call(self, closure):
        """reference src/interpreter.c:1374-1407 (args pass by reference)."""
        self.expect(lx.CL_RB_OPEN)
        if isinstance(closure, Builtin):
            args = []
            for i in range(closure.arity):
                if i > 0:
                    self.expect(lx.CL_COMMA)
                a = self.eval()
                t = closure.types[i] if closure.types else None
                if not matches_sig_type(a, t):
                    self.err(f"function '{closure.name}': argument {i+1} is "
                             f"'{type_name(a)}' and not of '{t}'")
                args.append(a)
            self.expect(lx.CL_RB_CLOSE)
            return closure.fn(self.interp, *args)
        if isinstance(closure, Closure):
            sig = closure.sig.args if closure.sig else []
            frame = Frame(external=closure.lexical_frame)
            for i, (t, name) in enumerate(sig):
                if i > 0:
                    self.expect(lx.CL_COMMA)
                a = self.eval()
                if not matches_sig_type(a, t):
                    self.err(f"function argument {i+1} ('{name}') is "
                             f"'{type_name(a)}' and not of '{t}'")
                frame.set_local(name, a)
            self.expect(lx.CL_RB_CLOSE)
            sub = Meval(self.interp, closure.code, frame)
            return sub.execute()
        self.err(f"'{type_name(closure)}' is no function")

    # --- the expression evaluator ---

    def eval(self, front=MISSING, front_lv=None):
        v, _lv = self._eval(front, front_lv)
        return v

    def _eval(self, front=MISSING, front_lv=None):
        opr = None

        if front is not MISSING:
            code = self.peek()
            if lx.OP_BEGIN < code < lx.OP_END:
                opr = self.get()
            elif code == lx.CL_RB_OPEN:
                return self.eval_call(front), None
            elif code == lx.CL_SB_OPEN:
                return self._eval_index(front)
            else:
                return front, front_lv

            if lx.ASSIGN_OPS_BEGIN < opr < lx.ASSIGN_OPS_END:
                rhs = self.eval()
                if rhs is None:
                    self.err("assignment from empty object")
                if opr == lx.OP_ASSIGN:
                    newval = clone_value(rhs)
                elif opr == lx.OP_ADD_ASSIGN:
                    newval = self.op_add(front, rhs)
                elif opr == lx.OP_SUB_ASSIGN:
                    newval = self.op_add(front, self.op_mul(-1, rhs))
                elif opr == lx.OP_MUL_ASSIGN:
                    newval = self.op_mul(front, rhs)
                elif opr == lx.OP_DIV_ASSIGN:
                    newval = self.op_mul(front, self.op_inverse(rhs))
                else:  # OP_MOD_ASSIGN
                    newval = self.op_mod(front, rhs)
                if front_lv is None:
                    self.err("attempt to assign to a non-lvalue")
                front_lv.set(newval)
                return newval, front_lv

            if opr == lx.OP_DOT:
                return self._eval_member(front, front_lv)

        else:
            code = self.peek()
            if code == lx.OP_QUERY:
                self.get()
                self.interp.emit(_structure_dump(self.eval()))
                return None, None
            if code == lx.OP_DOUBLE_QUERY:
                self.get()
                v = self.eval()
                if v is not None:
                    self.interp.emit(fmt_num(v) if is_num(v) else str(v))
                return None, None

        # unary operators bind to the next atom
        # (reference src/interpreter.c:1550-1566)
        unary = None
        if self.peek() in (lx.OP_ADD, lx.OP_SUB, lx.OP_NOT, lx.OP_INSIDE_CPS,
                           lx.OP_OUTSIDE_CPS, lx.OP_COMPOUND, lx.OP_ENVELOPE):
            unary = self.get()

        obj, obj_lv = self._eval_atom()

        # postfix: call / index / member bind tightest
        # (reference src/interpreter.c:1669-1677)
        if obj is not None:
            while self.peek() in (lx.CL_RB_OPEN, lx.CL_SB_OPEN, lx.OP_DOT):
                obj, obj_lv = self._eval(obj, obj_lv)
                if obj is None:
                    break

        if obj is not None:
            if unary == lx.OP_SUB:
                obj = self.op_mul(-1, obj)
            elif unary == lx.OP_NOT:
                obj = self.op_not(obj)
            elif unary == lx.OP_INSIDE_CPS:
                obj = self._composite(obj, "inside")
            elif unary == lx.OP_OUTSIDE_CPS:
                obj = self._composite(obj, "outside")
            elif unary == lx.OP_COMPOUND:
                obj = self._composite(obj, "compound")
            elif unary == lx.OP_ENVELOPE:
                obj = self._auto_envelope(obj)
            if unary is not None:
                obj_lv = None

            if opr is not None:
                # operator dispatch (reference src/interpreter.c:1692-1717)
                if opr == lx.OP_MUL:
                    return self._eval(self.op_mul(front, obj))
                if opr == lx.OP_DIV:
                    return self._eval(self.op_mul(front, self.op_inverse(obj)))
                if opr == lx.OP_MOD:
                    return self._eval(self.op_mod(front, obj))
                if opr == lx.OP_EQUAL:
                    return self._eval(self.op_cmp(front, obj) == 0)
                if opr == lx.OP_UNEQUAL:
                    return self._eval(self.op_cmp(front, obj) != 0)
                if opr == lx.OP_SMALLER:
                    return self._eval(self.op_cmp(front, obj) < 0)
                if opr == lx.OP_SMALLER_EQUAL:
                    return self._eval(self.op_cmp(front, obj) <= 0)
                if opr == lx.OP_LARGER:
                    return self._eval(self.op_cmp(front, obj) > 0)
                if opr == lx.OP_LARGER_EQUAL:
                    return self._eval(self.op_cmp(front, obj) >= 0)
                if opr == lx.OP_ADD:
                    return self.op_add(front, self.eval(obj, obj_lv)), None
                if opr == lx.OP_SUB:
                    return self.op_add(front, self.eval(
                        self.op_mul(-1, obj))), None
                if opr == lx.OP_AND:
                    return self.op_and(front, self.eval(obj, obj_lv)), None
                if opr == lx.OP_OR:
                    return self.op_or(front, self.eval(obj, obj_lv)), None
                if opr == lx.OP_XOR:
                    return self.op_xor(front, self.eval(obj, obj_lv)), None
                if opr == lx.OP_CAT:
                    return self._eval(self.op_cat(front, obj))
                self.err(f"invalid operator '{lx.SYMBOL.get(opr, opr)}'")
            else:
                return self._eval(obj, obj_lv)
        else:
            if opr is not None:
                self.err("expression does not yield an operand")
        return obj, obj_lv

    def _eval_atom(self):
        """Atomic operand (reference src/interpreter.c:1568-1666)."""
        code = self.peek()

        if code == lx.CL_DATA:
            v = self.get_data()
            if isinstance(v, Code):
                return Closure(v, None, self.frame), None
            return v, None

        if code == lx.CL_NAME:
            self.get()
            key = self.get()
            fr = self.frame.lookup_frame(key)
            peek = self.peek()
            if lx.ASSIGN_OPS_BEGIN < peek < lx.ASSIGN_OPS_END:
                if fr is None:
                    self.err(f"'{key}' was not defined. Use 'def {key}'.")
                val = fr.vars[key]
                if val is None:
                    self.expect(lx.OP_ASSIGN)
                    newval = clone_value(self.eval())
                    fr.vars[key] = newval
                    return newval, FrameRef(fr, key)
                return self._eval(val, FrameRef(fr, key))
            if fr is None:
                self.err(f"unknown name '{key}'")
            return fr.vars[key], FrameRef(fr, key)

        if code == lx.CL_DYN_ARRAY:
            self.get()
            return ArrS(), None

        if code == lx.CL_FSIGNATURE:
            self.get()
            return self._parse_signature(), None

        if code == lx.CL_RB_OPEN:
            self.get()
            v, lv = self._eval()
            self.expect(lx.CL_RB_CLOSE)
            return v, lv

        if code == lx.CL_DEF:
            self.get()
            key = self.get_name()
            if key in self.frame.vars:
                self.err(f"'{key}' is already defined")
            if self.try_code(lx.OP_ASSIGN):
                v = clone_value(self.eval())
                self.frame.set_local(key, v)
                return v, FrameRef(self.frame, key)
            self.frame.set_local(key, None)
            return None, FrameRef(self.frame, key)

        return None, None

    def _parse_signature(self):
        """reference src/interpreter.c:1619-1646."""
        self.expect(lx.CL_RB_OPEN)
        args = []
        while not self.try_code(lx.CL_RB_CLOSE):
            t = None
            if self.peek() == lx.CL_DATA:
                d = self.get_data()
                if not isinstance(d, MType):
                    self.err(f"unhandled data element in argument list")
                t = d.name
            name = self.get_name()
            args.append((t, name))
            if self.peek() != lx.CL_RB_CLOSE:
                self.expect(lx.CL_COMMA)
        return Signature(args)

    def _eval_index(self, front):
        """Array indexing with auto-grow (reference src/interpreter.c:1430-1456)."""
        self.get()  # [
        if not isinstance(front, ArrS):
            self.err(f"cannot index '{type_name(front)}'")
        idx = self.eval()
        self.expect(lx.CL_SB_CLOSE)
        if not is_num(idx):
            self.err("numeric index expected")
        idx = int(idx)
        if idx < 0:
            self.err("index is negative")
        if idx >= len(front.data):
            if idx > 1e9:
                self.err(f"allocating {idx} elements seems unintended")
            front.data.extend([None] * (idx + 1 - len(front.data)))
        if front.data[idx] is None and self.peek() == lx.OP_ASSIGN:
            self.get()
            front.data[idx] = clone_value(self.eval())
        return front.data[idx], ArrRef(front, idx)

    def _eval_member(self, front, front_lv):
        """`.` access: reflective field first, then per-type methods
        (reference src/interpreter.c:1481-1523)."""
        key = self.get_name()
        if via_has(front, key):
            if self.try_code(lx.OP_ASSIGN):
                via_set(front, key, clone_value(self.eval()))
                return front, front_lv
            return via_get(front, key), FieldRef(front, key)
        return self._meval_key(front, key)

    # --- per-type method dispatch (the *_meval_key functions) ---

    def _meval_key(self, front, key):
        if isinstance(front, Scene):
            return self._scene_key(front, key)
        if isinstance(front, MapS):
            return self._map_key(front, key)
        if isinstance(front, ArrS):
            return self._arr_key(front, key)
        if isinstance(front, Compound):
            return self._compound_key(front, key)
        if isinstance(front, Obj):
            return self._obj_key(front, key)
        self.err(f"object '{type_name(front)}' has no element named '{key}'")

    def _args_open(self):
        self.expect(lx.CL_RB_OPEN)

    def _args_close(self):
        self.expect(lx.CL_RB_CLOSE)

    def _scene_key(self, scene: Scene, key):
        """reference src/scene.c:293-331."""
        if key == "clear":
            self._args_open(); self._args_close()
            scene.clear()
        elif key == "push":
            self._args_open()
            obj = self.eval()
            scene.push(obj)
            self._args_close()
        elif key == "create_image":
            self._args_open()
            fname = self.eval_string()
            self._args_close()
            self.interp.render(scene, fname)
        else:
            self.err(f"scene_s has no member '{key}'")
        return None, None

    def _map_key(self, m: MapS, key):
        """reference src/container.c:156-231."""
        if key in m.data:
            return m.data[key], MapRef(m, key)
        if self.try_code(lx.OP_ASSIGN):
            m.data[key] = clone_value(self.eval())
            return m.data[key], MapRef(m, key)
        if key == "move":
            self._args_open(); m.move(self.eval_v3d()); self._args_close()
        elif key == "rotate":
            self._args_open(); m.rotate(self.eval_rot()); self._args_close()
        elif key == "scale":
            self._args_open(); m.scale(self.eval_f3()); self._args_close()
        elif key == "has":
            self._args_open()
            name = self.get_name()
            self._args_close()
            return name in m.data, None
        elif key == "write_to_file":
            self._args_open()
            self.interp.write_container(m, self.eval_string())
            self._args_close()
        elif key == "read_from_file":
            self._args_open()
            loaded = self.interp.read_container(self.eval_string(), MapS)
            m.data = loaded.data
            self._args_close()
        else:
            self.err(f"map has no element of name '{key}'")
        return None, None

    def _arr_key(self, a: ArrS, key):
        """reference src/container.c:423-518."""
        if key == "push":
            self._args_open()
            v = self.eval()
            a.push(v)
            self._args_close()
            return v, None
        if key == "move":
            self._args_open(); a.move(self.eval_v3d()); self._args_close()
        elif key == "rotate":
            self._args_open(); a.rotate(self.eval_rot()); self._args_close()
        elif key == "scale":
            self._args_open(); a.scale(self.eval_f3()); self._args_close()
        elif key == "size":
            self._args_open(); self._args_close()
            return len(a.data), None
        elif key == "clear":
            self._args_open(); self._args_close()
            a.data.clear()
        elif key == "create_inside_composite":
            self._args_open(); self._args_close()
            return a.create_inside_composite(), None
        elif key == "create_outside_composite":
            self._args_open(); self._args_close()
            return a.create_outside_composite(), None
        elif key == "create_compound":
            self._args_open(); self._args_close()
            return a.create_compound(), None
        elif key == "write_to_file":
            self._args_open()
            self.interp.write_container(a, self.eval_string())
            self._args_close()
        elif key == "read_from_file":
            self._args_open()
            loaded = self.interp.read_container(self.eval_string(), ArrS)
            a.data = loaded.data
            self._args_close()
        else:
            self.err(f"arr_s has no element of name '{key}'")
        return None, None

    def _compound_key(self, c: Compound, key):
        """reference src/compound.c:380-455."""
        if key == "push":
            self._args_open()
            v = self.eval()
            if not isinstance(v, (Obj, Compound)):
                self.err(f"cannot push '{type_name(v)}' to compound_s")
            c.push(v)
            self._args_close()
        elif key == "move":
            self._args_open(); c.move(self.eval_v3d()); self._args_close()
        elif key == "rotate":
            self._args_open(); c.rotate(self.eval_rot()); self._args_close()
        elif key == "scale":
            self._args_open(); c.scale(self.eval_f3()); self._args_close()
        elif key == "set_envelope":
            self._args_open()
            c.set_envelope(self._as_envelope(self.eval()))
            self._args_close()
        elif key == "set_auto_envelope":
            self._args_open(); self._args_close()
            c.set_auto_envelope()
        else:
            self.err(f"compound has no element of name '{key}'")
        return None, None

    def _as_envelope(self, v) -> Envelope:
        if isinstance(v, Envelope):
            return v
        if isinstance(v, Sphere):
            return Envelope(v.prp.pos, v.radius)
        if isinstance(v, ScaleWrap) and isinstance(v.o1, Sphere):
            # `sphere * vec(...)` would be anisotropic; not a valid envelope
            self.err("object cannot be used as envelope (use a sphere)")
        self.err(f"object '{type_name(v)}' cannot be used as envelope "
                 "(use a sphere)")

    def _obj_key(self, o: Obj, key):
        """reference src/objects.c:1463-1716."""
        p = o.prp
        if key == "move":
            self._args_open(); o.move(self.eval_v3d()); self._args_close()
        elif key == "rotate":
            self._args_open(); o.rotate(self.eval_rot()); self._args_close()
        elif key == "scale":
            self._args_open(); o.scale(self.eval_f3()); self._args_close()
        elif key == "set_color":
            self._args_open(); p.color = self.eval_v3d().copy(); self._args_close()
        elif key == "set_transparency":
            self._args_open(); p.transparency = self.eval_v3d().copy(); self._args_close()
        elif key == "set_refractive_index":
            self._args_open(); o.set_refractive_index(self.eval_f3()); self._args_close()
        elif key == "set_radiance":
            self._args_open(); p.radiance = self.eval_f3(); self._args_close()
        elif key == "set_texture_field":
            self._args_open()
            t = self.eval()
            if not isinstance(t, (TxmPlain, TxmChess)):
                self.err("texture map expected")
            p.texture = t.clone()
            self._args_close()
        elif key == "set_envelope":
            self._args_open()
            o.set_envelope(self._as_envelope(self.eval()))
            self._args_close()
        elif key == "set_auto_envelope":
            self._args_open(); self._args_close()
            o.set_auto_envelope()
        elif key == "set_fresnel_reflectivity":
            self._args_open(); p.fresnel_reflectivity = self.eval_f3(); self._args_close()
        elif key == "set_chromatic_reflectivity":
            self._args_open(); p.chromatic_reflectivity = self.eval_f3(); self._args_close()
        elif key == "set_diffuse_reflectivity":
            self._args_open(); p.diffuse_reflectivity = self.eval_f3(); self._args_close()
        elif key == "set_sigma":
            self._args_open(); p.sigma = self.eval_f3(); self._args_close()
        elif key == "set_surface_roughness":
            self._args_open(); p.surface_roughness = self.eval_f3(); self._args_close()
        elif key == "set_material":
            self._args_open()
            name = self.eval_string()
            try:
                apply_material(o, name)
            except KeyError:
                self.err(f"set_material: unknown material specification '{name}'")
            self._args_close()
        elif key == "set_distance_function":
            self._args_open()
            if not isinstance(o, DistanceObj):
                self.err("object must be 'obj_distance_s'")
            d = self.eval()
            if not isinstance(d, (DistanceSphere, DistanceTorus)):
                self.err(f"'{type_name(d)}' cannot be used as distance function")
            o.distance = d.clone()
            self._args_close()
        else:
            self.err(f"object has no member or function '{key}'")
        return None, None

    # --- operators (reference src/interpreter.c:651-1231) ---

    def op_mul(self, v1, v2):
        if is_num(v1):
            if is_num(v2):
                if isinstance(v1, bool) and isinstance(v2, bool):
                    return v1 and v2
                r = v1 * v2
                return float(r) if isinstance(v1, float) or isinstance(v2, float) else int(r)
            if is_v3(v2):
                return v2 * float(v1)
        elif is_v3(v1):
            if is_num(v2):
                return v1 * float(v2)
            if is_v3(v2):
                return float(v1 @ v2)
        elif is_m3(v1):
            if is_num(v2):
                return v1 * float(v2)
            if is_v3(v2):
                return v1 @ v2
            if is_m3(v2):
                # m3d_s_mlm: row i of result = v1 @ (row i of v2)
                return v2 @ v1.T
        elif isinstance(v1, (ArrS, MapS, Compound)):
            if is_num(v2):
                r = v1.clone(); r.scale(float(v2)); return r
            if is_m3(v2):
                r = v1.clone(); r.rotate(v2); return r
        elif isinstance(v1, Signature):
            if isinstance(v2, Closure):
                return Closure(v2.code, v1, v2.lexical_frame)
        elif isinstance(v1, Obj):
            if is_num(v2):
                r = v1.clone(); r.scale(float(v2)); return r
            if is_m3(v2):
                r = v1.clone(); r.rotate(v2); return r
            if is_v3(v2):
                return ScaleWrap(v1, v2)
        self.err(f"cannot evaluate '{type_name(v1)}' * '{type_name(v2)}'")

    def op_mod(self, v1, v2):
        if isinstance(v1, int) and isinstance(v2, int) \
                and not isinstance(v1, bool) and not isinstance(v2, bool):
            return int(math.fmod(v1, v2))  # C % semantics
        self.err(f"cannot evaluate '{type_name(v1)}' % '{type_name(v2)}'")

    def op_add(self, v1, v2):
        if is_num(v1):
            if is_num(v2):
                if isinstance(v1, bool) and isinstance(v2, bool):
                    return int(v1) + int(v2)
                r = v1 + v2
                return float(r) if isinstance(v1, float) or isinstance(v2, float) else int(r)
            if isinstance(v2, str):
                return fmt_num(v1) + v2
        elif is_v3(v1):
            if is_v3(v2):
                return v1 + v2
        elif isinstance(v1, str):
            if isinstance(v2, str):
                return v1 + v2
            if is_num(v2):
                return v1 + fmt_num(v2)
        elif isinstance(v1, (ArrS, MapS, Compound)):
            if is_v3(v2):
                r = v1.clone(); r.move(v2); return r
        elif isinstance(v1, Obj):
            if is_v3(v2):
                r = v1.clone(); r.move(v2); return r
        self.err(f"cannot evaluate '{type_name(v1)}' + '{type_name(v2)}'")

    def op_cmp(self, v1, v2):
        if is_num(v1) and is_num(v2):
            return (v1 > v2) - (v1 < v2)
        self.err(f"cannot compare '{type_name(v1)}' with '{type_name(v2)}'")

    def op_inverse(self, v):
        if is_num(v):
            return 1.0 / v if v != 0 else INF
        self.err(f"cannot invert '{type_name(v)}'")

    def op_and(self, v1, v2):
        if isinstance(v1, bool) and isinstance(v2, bool):
            return v1 and v2
        if isinstance(v1, Obj) and isinstance(v2, Obj):
            return PairInside(v1, v2)
        self.err(f"cannot evaluate '{type_name(v1)}' AND '{type_name(v2)}'")

    def op_or(self, v1, v2):
        if isinstance(v1, bool) and isinstance(v2, bool):
            return v1 or v2
        if isinstance(v1, Obj) and isinstance(v2, Obj):
            return PairOutside(v1, v2)
        self.err(f"cannot evaluate '{type_name(v1)}' OR '{type_name(v2)}'")

    def op_xor(self, v1, v2):
        if isinstance(v1, bool) and isinstance(v2, bool):
            return v1 != v2
        self.err(f"cannot evaluate '{type_name(v1)}' XOR '{type_name(v2)}'")

    def op_not(self, v):
        if isinstance(v, bool):
            return not v
        if isinstance(v, Obj):
            return Neg(v)
        self.err(f"cannot evaluate NOT '{type_name(v)}'")

    def op_cat(self, v1, v2):
        """reference src/interpreter.c:1204-1231."""
        if isinstance(v1, ArrS):
            r = v1.clone()
            if isinstance(v2, ArrS):
                r.cat(v2)
            else:
                r.push(v2)
            return r
        r = ArrS()
        r.push(v1)
        r.push(v2)
        return r

    def _composite(self, v, kind):
        """Prefix `(&)` `(|)` `(:)` (reference src/interpreter.c:1109-1168)."""
        if not isinstance(v, ArrS):
            self.err(f"cannot create composite of '{type_name(v)}'")
        if kind == "inside":
            return v.create_inside_composite()
        if kind == "outside":
            return v.create_outside_composite()
        return v.create_compound()

    def _auto_envelope(self, v):
        """Prefix `(@)` (reference src/interpreter.c:1172-1200)."""
        if isinstance(v, ArrS):
            c = v.create_compound()
            c.set_auto_envelope()
            return c
        if isinstance(v, Compound):
            c = v.clone()
            c.set_auto_envelope()
            return c
        if isinstance(v, Obj):
            o = v.clone()
            o.set_auto_envelope()
            return o
        self.err(f"cannot compute envelope for '{type_name(v)}'")

    # --- statement execution (reference src/interpreter.c:1734-1850) ---

    def execute(self):
        ret = None
        while not self.end():
            obj = None
            code = self.peek()
            if lx.FL_BEGIN < code < lx.FL_END:
                self.get()
                if code == lx.FL_IF:
                    target = self.get()
                    self.expect(lx.CL_RB_OPEN)
                    cond = self.eval_bool()
                    self.expect(lx.CL_RB_CLOSE)
                    if cond:
                        obj = self.eval()
                    else:
                        self.index = target
                    if self.peek() == lx.FL_ELSE:
                        self.get()
                        target2 = self.get()
                        if cond:
                            self.index = target2
                        else:
                            obj = self.eval()
                elif code == lx.FL_WHILE:
                    end_while = self.get()
                    begin = self.index
                    while True:
                        self.expect(lx.CL_RB_OPEN)
                        cond = self.eval_bool()
                        self.expect(lx.CL_RB_CLOSE)
                        if cond:
                            obj = self.eval()
                            self.index = begin
                        else:
                            self.index = end_while
                            break
                elif code == lx.FL_FOR:
                    end_for = self.get()
                    for_frame = Frame(external=self.frame)
                    self.frame = for_frame
                    key = self.get_name()
                    for_frame.set_local(key, None)
                    self.expect(lx.CL_RB_OPEN)
                    if not self.try_code(lx.FL_IN):
                        self.err(f"expected: for '{key}' in 'list-expression'")
                    arr = self.eval()
                    if not isinstance(arr, ArrS):
                        self.err(f"expected: for '{key}' in 'list-expression'")
                    self.expect(lx.CL_RB_CLOSE)
                    begin = self.index
                    for element in arr.data:
                        if element is not None:
                            for_frame.vars[key] = element  # by reference
                            self.eval()
                            self.index = begin
                    self.index = end_for
                    self.frame = for_frame.external
                else:
                    self.err("unexpected flow control")
            else:
                obj = self.eval()
            self.expect(lx.CL_SEMICOLON)
            ret = obj
        return ret


def _structure_dump(v):
    if isinstance(v, np.ndarray):
        return f"{type_name(v)}: {v.tolist()}"
    return f"{type_name(v)}: {v!r}"


# ---------------------------------------------------------------------------
# interpreter shell + builtins


class Interp:
    """Program shell: root frame with builtins and constants
    (mclosure_s_interpret, reference src/interpreter.c:1934-2020)."""

    def __init__(self, render_fn=None, args=None, out=None):
        self.render_fn = render_fn
        self.program_args = list(args or [])
        self.start_time = time.perf_counter()
        self.out = out
        self.rendered = []  # (scene_snapshot, filename) log

    def emit(self, msg):
        if self.out is not None:
            self.out.append(msg)
        else:
            print(msg)

    def render(self, scene: Scene, filename: str):
        self.rendered.append(filename)
        if self.render_fn is not None:
            self.render_fn(scene, filename)

    def write_container(self, container, filename):
        """Container persistence (reference src/container.c:201-224,488-511
        uses beth binary-ml; we use pickle)."""
        import pickle
        with open(filename, "wb") as f:
            pickle.dump(container, f)

    def read_container(self, filename, expected_type):
        import pickle
        with open(filename, "rb") as f:
            v = pickle.load(f)
        if not isinstance(v, expected_type):
            raise AcnError(f"file {filename} did not contain "
                           f"{expected_type.__name__}")
        return v

    # --- root frame ---

    def root_frame(self) -> Frame:
        f = Frame()
        B = lambda name, fn, arity, types=None: f.set_local(
            name, Builtin(name, fn, arity, types))

        deg = math.pi / 180.0

        # vectors / colors / rotations (reference src/closures.c:29-139)
        B("vec", lambda I, x, y, z: v3(x, y, z), 3, ["num"] * 3)
        B("vecx", lambda I, v: v3(v, 0, 0), 1, ["num"])
        B("vecy", lambda I, v: v3(0, v, 0), 1, ["num"])
        B("vecz", lambda I, v: v3(0, 0, v), 1, ["num"])
        B("color", lambda I, x, y, z: v3(x, y, z), 3, ["num"] * 3)
        B("colr", lambda I, v: v3(v, 0, 0), 1, ["num"])
        B("colg", lambda I, v: v3(0, v, 0), 1, ["num"])
        B("colb", lambda I, v: v3(0, 0, v), 1, ["num"])
        B("rotx", lambda I, v: rot_x(deg * v), 1, ["num"])
        B("roty", lambda I, v: rot_y(deg * v), 1, ["num"])
        B("rotz", lambda I, v: rot_z(deg * v), 1, ["num"])

        # strings (reference src/closures.c:145-186)
        B("string_fa", lambda I, fmt, arg: format_fa(fmt, arg), 2,
          ["string", None])
        B("string_to_num", lambda I, s: _string_to_num(s), 1, ["string"])

        # math (reference src/closures.c:191-384)
        B("sqrt", lambda I, x: math.sqrt(x), 1, ["num"])
        B("sqr", lambda I, x: float(x) * float(x), 1, ["num"])
        B("exp", lambda I, x: math.exp(x), 1, ["num"])
        B("log", lambda I, x: math.log(x), 1, ["num"])
        B("to_deg", lambda I, x: x * 180.0 / math.pi, 1, ["num"])
        B("to_rad", lambda I, x: x * math.pi / 180.0, 1, ["num"])
        B("sin", lambda I, x: math.sin(x), 1, ["num"])
        B("cos", lambda I, x: math.cos(x), 1, ["num"])
        B("tan", lambda I, x: math.tan(x), 1, ["num"])
        B("sin_d", lambda I, x: math.sin(deg * x), 1, ["num"])
        B("cos_d", lambda I, x: math.cos(deg * x), 1, ["num"])
        B("tan_d", lambda I, x: math.tan(deg * x), 1, ["num"])
        B("asin", lambda I, x: math.asin(x), 1, ["num"])
        B("acos", lambda I, x: math.acos(x), 1, ["num"])
        B("atan", lambda I, x: math.atan(x), 1, ["num"])
        B("pow", lambda I, b, e: math.pow(b, e), 2, ["num", "num"])
        B("floor", lambda I, x: float(math.floor(x)), 1, ["num"])
        B("ceiling", lambda I, x: float(math.ceil(x)), 1, ["num"])

        # files (reference src/closures.c:389-442) — the distributed
        # work-claiming primitives
        B("file_exists", lambda I, s: os.path.exists(s), 1, ["string"])
        B("file_touch", lambda I, s: _file_touch(s), 1, ["string"])
        B("file_delete", lambda I, s: _file_delete(s), 1, ["string"])
        B("file_rename", lambda I, a, b: _file_rename(a, b), 2,
          ["string", "string"])

        # generic factory (reference src/closures.c:447-456)
        B("beth_object", lambda I, s: _beth_object(s), 1, ["string"])

        # object factories (reference src/closures.c:460-593)
        B("create_plane", lambda I: Plane(), 0)
        B("create_sphere", lambda I, r: Sphere(float(r)), 1, ["num"])
        B("create_squaroid",
          lambda I, a, b, c, r: Squaroid(a, b, c, r), 4, ["num"] * 4)
        B("create_cylinder",
          lambda I, rx, ry: Squaroid.cylinder(rx, ry), 2, ["num"] * 2)
        B("create_torus", lambda I, r1, r2: make_torus(r1, r2), 2, ["num"] * 2)
        B("create_hyperboloid1",
          lambda I, rx, ry, rz: Squaroid.hyperboloid1(rx, ry, rz), 3, ["num"] * 3)
        B("create_hyperboloid2",
          lambda I, rx, ry, rz: Squaroid.hyperboloid2(rx, ry, rz), 3, ["num"] * 3)
        B("create_ellipsoid",
          lambda I, rx, ry, rz: Squaroid.ellipsoid(rx, ry, rz), 3, ["num"] * 3)
        B("create_cone",
          lambda I, rx, ry, rz: Squaroid.cone(rx, ry, rz), 3, ["num"] * 3)

        B("get_time",
          lambda I: time.perf_counter() - self.start_time, 0)

        # constants: default instances (reference src/interpreter.c:2001-2005)
        f.set_local("scene_s", Scene())
        f.set_local("obj_sphere_s", Sphere(1.0))
        f.set_local("obj_plane_s", Plane())
        f.set_local("arr_s", ArrS())
        f.set_local("map_s", MapS())

        f.set_local("program_args", ArrS(list(self.program_args)))
        return f

    def run_code(self, code: Code):
        frame = Frame(external=self.root_frame())
        ev = Meval(self, code, frame)
        return ev.execute()


_BETH_OBJECTS = {
    "distance_sphere_s": DistanceSphere,
    "distance_torus_s": DistanceTorus,
    "obj_distance_s": DistanceObj,
    "obj_sphere_s": Sphere,
    "obj_plane_s": Plane,
    "obj_squaroid_s": Squaroid,
    "envelope_s": Envelope,
    "txm_plain_s": TxmPlain,
    "txm_chess_s": TxmChess,
    "compound_s": Compound,
    "arr_s": ArrS,
    "map_s": MapS,
    "scene_s": Scene,
}


def _beth_object(name):
    if name not in _BETH_OBJECTS:
        raise AcnError(f"beth_object: unknown type '{name}'")
    return _BETH_OBJECTS[name]()


def _string_to_num(s: str):
    """reference src/closures.c:159-186."""
    s = s.strip()
    i = 0
    while i < len(s) and s[i] in "+-0123456789eE.":
        i += 1
    tok = s[:i]
    if any(c in tok for c in ".eE"):
        return float(tok)
    return int(tok) if tok else 0


def _file_touch(path):
    try:
        open(path, "a").close()
        return True
    except OSError:
        return False


def _file_delete(path):
    try:
        os.remove(path)
        return True
    except OSError:
        return False


def _file_rename(src, dst):
    try:
        os.rename(src, dst)
        return True
    except OSError:
        return False


def run_source(text, filename="<string>", render_fn=None, args=None, out=None):
    interp = Interp(render_fn=render_fn, args=args, out=out)
    code = lx.compile_source(text, filename)
    return interp.run_code(code), interp


def run_file(path, render_fn=None, args=None, out=None):
    interp = Interp(render_fn=render_fn, args=args, out=out)
    code = lx.compile_file(path)
    return interp.run_code(code), interp
