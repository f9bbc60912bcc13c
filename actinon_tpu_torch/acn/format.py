"""Subset of the beth format-string language used by `string_fa`
(reference src/closures.c:145-156; format syntax from beth's
bcore_source_r_parse_fa family).

Supported directives (everything the scene corpus uses, plus the obvious
relatives):
  #<s3_t*> #<u3_t*> #<f3_t*> #<sc_t> #<st_s*>   — render the argument
  #pl<n>'<c>'{...}                              — pad-left to width n with c
  #pr<n>'<c>'{...}                              — pad-right
"""

from __future__ import annotations


def _render_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return f"{v:g}"
    return str(v)


def format_fa(fmt: str, arg) -> str:
    out = []
    i, n = 0, len(fmt)
    while i < n:
        c = fmt[i]
        if c != "#":
            out.append(c)
            i += 1
            continue
        i += 1
        if fmt.startswith("<", i):
            j = fmt.index(">", i)
            out.append(_render_value(arg))
            i = j + 1
        elif fmt.startswith("pl", i) or fmt.startswith("pr", i):
            left = fmt.startswith("pl", i)
            i += 2
            j = i
            while j < n and fmt[j].isdigit():
                j += 1
            width = int(fmt[i:j])
            i = j
            pad = " "
            if fmt.startswith("'", i):
                k = fmt.index("'", i + 1)
                pad = fmt[i + 1:k]
                i = k + 1
            if not fmt.startswith("{", i):
                raise ValueError(f"expected '{{' in format {fmt!r}")
            k = fmt.index("}", i)
            inner = format_fa(fmt[i + 1:k], arg)
            i = k + 1
            if len(inner) < width:
                fill = pad * (width - len(inner))
                inner = fill + inner if left else inner + fill
            out.append(inner)
        else:
            out.append("#")
    return "".join(out)
