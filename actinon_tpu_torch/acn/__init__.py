"""The Actinon scene-scripting language (`.acn`) front-end.

A pure-Python interpreter for the language defined by the reference's
metacode compiler/evaluator (reference src/interpreter.c, src/closures.c):
C-like syntax, first-class closures with optional typed signatures,
vector/matrix arithmetic, and object-composition operators
(`&` `|` `!` `:` `(&)` `(|)` `(:)` `(@)`).  Scripts build `Scene` objects;
`scene.create_image(file)` hands off to the renderer callback.
"""

from actinon_tpu_torch.acn.interp import run_file, run_source, Interp
