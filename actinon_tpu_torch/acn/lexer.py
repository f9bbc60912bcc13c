"""`.acn` lexer/metacode compiler.

Produces the same linear metacode shape as the reference's single-pass parser
(mcode_s_parse, reference src/interpreter.c:207-511): a flat code list of
opcodes with inline payloads, a constants pool, jump back-patching for
if/while/for at statement boundaries, `{...}` blocks recursively compiled into
nested Code objects, `#parse "file"` inlined path-relative, and
`#source_file_name` as a string constant.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List

# opcodes (mirrors code_s, reference src/interpreter.h:34-109)
CL_NULL = 0
CL_DATA = 1           # followed by data-pool index
CL_NAME = 2           # followed by name string
CL_COMMA = 3
CL_SEMICOLON = 4
CL_RB_OPEN = 5        # (
CL_RB_CLOSE = 6       # )
CL_SB_OPEN = 7        # [
CL_SB_CLOSE = 8       # ]
CL_DEF = 9
CL_FSIGNATURE = 10    # <-
CL_DYN_ARRAY = 11     # []

OP_BEGIN = 20
OP_DOT = 21
OP_QUERY = 22
OP_DOUBLE_QUERY = 23
OP_MUL = 24
OP_DIV = 25
OP_MOD = 26
OP_ADD = 27
OP_SUB = 28

ASSIGN_OPS_BEGIN = 30
OP_ASSIGN = 31
OP_MUL_ASSIGN = 32
OP_ADD_ASSIGN = 33
OP_SUB_ASSIGN = 34
OP_DIV_ASSIGN = 35
OP_MOD_ASSIGN = 36
ASSIGN_OPS_END = 37

OP_EQUAL = 40
OP_SMALLER = 41
OP_UNEQUAL = 42
OP_SMALLER_EQUAL = 43
OP_LARGER = 44
OP_LARGER_EQUAL = 45
OP_NOT = 46
OP_AND = 47
OP_OR = 48
OP_XOR = 49
OP_CAT = 50
OP_INSIDE_CPS = 51    # (&)
OP_OUTSIDE_CPS = 52   # (|)
OP_COMPOUND = 53      # (:)
OP_ENVELOPE = 54      # (@)
OP_END = 55

FL_BEGIN = 60
FL_IF = 61
FL_WHILE = 62
FL_ELSE = 63
FL_FOR = 64
FL_IN = 65
FL_END = 66

SYMBOL = {
    CL_COMMA: ",", CL_SEMICOLON: ";", CL_RB_OPEN: "(", CL_RB_CLOSE: ")",
    CL_SB_OPEN: "[", CL_SB_CLOSE: "]", CL_DEF: "def", CL_FSIGNATURE: "<-",
    CL_DYN_ARRAY: "[]", OP_DOT: ".", OP_QUERY: "?", OP_DOUBLE_QUERY: "??",
    OP_MUL: "*", OP_DIV: "/", OP_MOD: "%", OP_ADD: "+", OP_SUB: "-",
    OP_ASSIGN: "=", OP_MUL_ASSIGN: "*=", OP_ADD_ASSIGN: "+=",
    OP_SUB_ASSIGN: "-=", OP_DIV_ASSIGN: "/=", OP_MOD_ASSIGN: "%=",
    OP_EQUAL: "==", OP_SMALLER: "<", OP_UNEQUAL: "<>",
    OP_SMALLER_EQUAL: "<=", OP_LARGER: ">", OP_LARGER_EQUAL: ">=",
    OP_NOT: "!", OP_AND: "&", OP_OR: "|", OP_XOR: "^", OP_CAT: ":",
    OP_INSIDE_CPS: "(&)", OP_OUTSIDE_CPS: "(|)", OP_COMPOUND: "(:)",
    OP_ENVELOPE: "(@)", FL_IF: "if", FL_WHILE: "while", FL_ELSE: "else",
    FL_FOR: "for", FL_IN: "in",
}

# language type names mapped to framework type tags
# (reference src/interpreter.c:221-235)
TYPE_NAMES = {
    "bool": "bool", "int": "int", "float": "float", "num": "num",
    "string": "string", "map": "map", "list": "list", "object": "object",
    "v3d": "v3d", "func": "func",
}

KEYWORDS = {"def", "if", "while", "for", "in", "else",
            "true", "false", "AND", "OR", "XOR", "NOT", "CAT"}


class MType:
    """Type constant appearing as data (mtype_s, reference
    src/interpreter.c:100-110)."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __repr__(self):
        return f"<type {self.name}>"


@dataclass
class Code:
    """Compiled metacode unit (mcode_s analog)."""

    code: List = field(default_factory=list)      # ints + inline payloads
    data: List = field(default_factory=list)      # constants pool
    src_map: List = field(default_factory=list)   # (code idx, file, line)

    def push_code(self, c):
        self.code.append(c)

    def push_data(self, v):
        self.code.append(CL_DATA)
        self.code.append(len(self.data))
        self.data.append(v)

    def push_name(self, name):
        self.code.append(CL_NAME)
        self.code.append(name)

    def where(self, index):
        """file:line for error messages at code index."""
        best = ("?", 0)
        for ci, f, l in self.src_map:
            if ci > index:
                break
            best = (f, l)
        return best


class AcnSyntaxError(Exception):
    pass


class _Scanner:
    def __init__(self, text, filename):
        self.text = text
        self.n = len(text)
        self.i = 0
        self.filename = filename

    def line(self):
        return self.text.count("\n", 0, self.i) + 1

    def err(self, msg):
        raise AcnSyntaxError(f"{self.filename}:{self.line()}: {msg}")

    def eos(self):
        return self.i >= self.n

    def peek(self, k=0):
        j = self.i + k
        return self.text[j] if j < self.n else ""

    def get(self):
        c = self.text[self.i]
        self.i += 1
        return c

    def try_str(self, s):
        if self.text.startswith(s, self.i):
            self.i += len(s)
            return True
        return False

    def skip_ws(self):
        """Whitespace + // and /* */ comments (beth's ' ' format skip)."""
        while self.i < self.n:
            c = self.text[self.i]
            if c in " \t\r\n":
                self.i += 1
            elif self.text.startswith("//", self.i):
                j = self.text.find("\n", self.i)
                self.i = self.n if j < 0 else j + 1
            elif self.text.startswith("/*", self.i):
                j = self.text.find("*/", self.i + 2)
                if j < 0:
                    self.err("unterminated block comment")
                self.i = j + 2
            else:
                break


def _lex_into(code: Code, sc: _Scanner, depth=0):
    """Compile one block scope (mcode_s_parse analog, reference
    src/interpreter.c:207-511)."""
    jmp_stack: List[int] = []
    sc.skip_ws()
    while not sc.eos():
        code.src_map.append((len(code.code), sc.filename, sc.line()))
        c = sc.peek()

        if c.isdigit():
            _lex_number(code, sc)
        elif c == '"':
            sc.get()
            code.push_data(_lex_string(sc))
        elif c.isalpha() or c == "_":
            _lex_name(code, sc, jmp_stack)
        elif c in "!?.=+-*/%><&|^:":
            _lex_operator(code, sc)
        elif c in ";,()[]":
            _lex_control(code, sc, jmp_stack)
        elif c == "{":
            sc.get()
            sub = Code()
            _lex_into(sub, sc, depth + 1)
            sc.skip_ws()
            if not sc.try_str("}"):
                sc.err("'}' expected")
            code.push_data(sub)
        elif c == "}":
            break  # end of block, not consumed
        elif sc.try_str("#parse"):
            sc.skip_ws()
            if not sc.try_str('"'):
                sc.err("file name string expected after #parse")
            fname = _lex_string(sc)
            if not fname:
                sc.err("file name expected")
            if not fname.startswith("/"):
                fname = os.path.join(os.path.dirname(sc.filename), fname)
            with open(fname, "r") as f:
                text = f.read()
            text = _strip_header(text)
            sub_sc = _Scanner(text, fname)
            _lex_into(code, sub_sc, depth)  # inlined into the same scope
        elif sc.try_str("#source_file_name"):
            code.push_data(sc.filename)
        else:
            sc.err(f"syntax error at {sc.text[sc.i:sc.i+20]!r}")
        sc.skip_ws()

    if jmp_stack:
        sc.err("unterminated flow control (missing ';')")


def _lex_number(code: Code, sc: _Scanner):
    """Integer/float literal (reference src/interpreter.c:247-281)."""
    start = sc.i
    while sc.peek().isdigit():
        sc.get()
    is_int = True
    if sc.peek() == ".":
        is_int = False
        sc.get()
        while sc.peek().isdigit():
            sc.get()
    if sc.peek() in "eE":
        is_int = False
        sc.get()
        if sc.peek() in "+-":
            sc.get()
        while sc.peek().isdigit():
            sc.get()
    tok = sc.text[start:sc.i]
    code.push_data(int(tok) if is_int else float(tok))


def _lex_string(sc: _Scanner) -> str:
    """String literal body after opening quote
    (reference src/interpreter.c:282-305)."""
    out = []
    while True:
        if sc.eos():
            sc.err("stream ends in string literal")
        ch = sc.get()
        if ch == '"':
            break
        if ch == "\\":
            nxt = sc.get() if not sc.eos() else ""
            out.append({"n": "\n", "r": "\r", "t": "\t", "0": "\0",
                        "\\": "\\", '"': '"'}.get(nxt, "\\" + nxt))
        else:
            out.append(ch)
    return "".join(out)


def _lex_name(code: Code, sc: _Scanner, jmp_stack):
    start = sc.i
    while sc.peek().isalnum() or sc.peek() == "_":
        sc.get()
    name = sc.text[start:sc.i]

    if name == "true":
        code.push_data(True)
    elif name == "false":
        code.push_data(False)
    elif name == "AND":
        code.push_code(OP_AND)
    elif name == "OR":
        code.push_code(OP_OR)
    elif name == "XOR":
        code.push_code(OP_XOR)
    elif name == "NOT":
        code.push_code(OP_NOT)
    elif name == "CAT":
        code.push_code(OP_CAT)
    elif name == "def":
        code.push_code(CL_DEF)
    elif name in ("if", "while", "for"):
        code.push_code({"if": FL_IF, "while": FL_WHILE, "for": FL_FOR}[name])
        jmp_stack.append(len(code.code))
        code.push_code(0)  # jump target patched at ';' / 'else'
    elif name == "in":
        code.push_code(FL_IN)
    elif name == "else":
        if not jmp_stack:
            sc.err("'else' without 'if'")
        idx = jmp_stack.pop()
        code.code[idx] = len(code.code)
        code.push_code(FL_ELSE)
        jmp_stack.append(len(code.code))
        code.push_code(0)
    elif name in TYPE_NAMES:
        code.push_data(MType(TYPE_NAMES[name]))
    else:
        code.push_name(name)


def _lex_operator(code: Code, sc: _Scanner):
    """reference src/interpreter.c:386-420."""
    c = sc.get()
    if c == "!":
        code.push_code(OP_NOT)
    elif c == "?":
        code.push_code(OP_DOUBLE_QUERY if sc.try_str("?") else OP_QUERY)
    elif c == ".":
        code.push_code(OP_DOT)
    elif c == "=":
        code.push_code(OP_EQUAL if sc.try_str("=") else OP_ASSIGN)
    elif c == "+":
        code.push_code(OP_ADD_ASSIGN if sc.try_str("=") else OP_ADD)
    elif c == "-":
        code.push_code(OP_SUB_ASSIGN if sc.try_str("=") else OP_SUB)
    elif c == "*":
        code.push_code(OP_MUL_ASSIGN if sc.try_str("=") else OP_MUL)
    elif c == "/":
        code.push_code(OP_DIV_ASSIGN if sc.try_str("=") else OP_DIV)
    elif c == "%":
        code.push_code(OP_MOD_ASSIGN if sc.try_str("=") else OP_MOD)
    elif c == "<":
        if sc.try_str("="):
            code.push_code(OP_SMALLER_EQUAL)
        elif sc.try_str(">"):
            code.push_code(OP_UNEQUAL)
        elif sc.try_str("-"):
            code.push_code(CL_FSIGNATURE)
        else:
            code.push_code(OP_SMALLER)
    elif c == ">":
        code.push_code(OP_LARGER_EQUAL if sc.try_str("=") else OP_LARGER)
    elif c == "&":
        code.push_code(OP_AND)
    elif c == "|":
        code.push_code(OP_OR)
    elif c == "^":
        code.push_code(OP_XOR)
    elif c == ":":
        code.push_code(OP_CAT)


def _lex_control(code: Code, sc: _Scanner, jmp_stack):
    """reference src/interpreter.c:422-461."""
    c = sc.get()
    if c == ";":
        if jmp_stack:
            idx = jmp_stack.pop()
            code.code[idx] = len(code.code)
        if jmp_stack:
            sc.err("trailing jump address at end of statement")
        code.push_code(CL_SEMICOLON)
    elif c == ",":
        code.push_code(CL_COMMA)
    elif c == "(":
        if sc.try_str("&)"):
            code.push_code(OP_INSIDE_CPS)
        elif sc.try_str("|)"):
            code.push_code(OP_OUTSIDE_CPS)
        elif sc.try_str(":)"):
            code.push_code(OP_COMPOUND)
        elif sc.try_str("@)"):
            code.push_code(OP_ENVELOPE)
        else:
            code.push_code(CL_RB_OPEN)
    elif c == ")":
        code.push_code(CL_RB_CLOSE)
    elif c == "[":
        if sc.try_str("]"):
            code.push_code(CL_DYN_ARRAY)
        else:
            code.push_code(CL_SB_OPEN)
    elif c == "]":
        code.push_code(CL_SB_CLOSE)


def _strip_header(text: str) -> str:
    """Remove a leading `#!` shebang and the `<mclosure_s></>`
    language-specifier line (the bcore_interpret_auto_file dispatch marker)."""
    if text.startswith("#!"):
        nl = text.find("\n")
        if nl >= 0:
            text = " " * nl + text[nl:]
    idx = text.find("<mclosure_s></>")
    if idx >= 0:
        text = text[:idx] + " " * len("<mclosure_s></>") + text[idx + len("<mclosure_s></>"):]
    return text


def compile_source(text: str, filename: str = "<string>") -> Code:
    text = _strip_header(text)
    sc = _Scanner(text, filename)
    code = Code()
    _lex_into(code, sc)
    sc.skip_ws()
    if not sc.eos():
        sc.err("unexpected '}'")
    return code


def compile_file(path: str) -> Code:
    with open(path, "r") as f:
        return compile_source(f.read(), path)
