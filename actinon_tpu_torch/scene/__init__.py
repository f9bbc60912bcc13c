"""Scene model: host-side object algebra + compile-to-arrays IR.

`objects.py` is the build-time object model manipulated by `.acn` scripts
(the analog of reference src/objects.c / compound.c / container.c), pure
numpy/f64.  `ir.py` compiles a finished scene into the flat array tables the
device kernels trace.
"""

from actinon_tpu_torch.scene.objects import (
    Envelope, Properties, Plane, Sphere, Squaroid, DistanceObj,
    DistanceSphere, DistanceTorus, PairInside, PairOutside, Neg, ScaleWrap,
    Compound, ArrS, MapS, Scene, TxmPlain, TxmChess,
    make_torus, MATERIALS, apply_material,
)
