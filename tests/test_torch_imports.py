"""The port stands alone: importing every module of actinon_tpu_torch,
and chip_smoke.py, loads neither jax nor anything of the JAX package."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
import actinon_tpu_torch
names = [m.name for m in pkgutil.walk_packages(actinon_tpu_torch.__path__,
                                               "actinon_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "actinon_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    import json
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert "actinon_tpu_torch.render.kernels" in out["modules"]
    assert "actinon_tpu_torch.render.driver" in out["modules"]
    assert "actinon_tpu_torch.params" in out["modules"]
    assert "actinon_tpu_torch.render.scene_kernels" in out["modules"]
    assert "actinon_tpu_torch.render.tracer" in out["modules"]
    assert "actinon_tpu_torch.render.bigscene" in out["modules"]
    assert "actinon_tpu_torch.diag_ops" in out["modules"]
    assert "actinon_tpu_torch.render.diff" in out["modules"]
    assert "actinon_tpu_torch.parallel.mesh" in out["modules"]
    assert "actinon_tpu_torch.render.reference_oracle" in out["modules"]
    assert "actinon_tpu_torch.render.graphs" in out["modules"]
    assert out["bad"] == []
