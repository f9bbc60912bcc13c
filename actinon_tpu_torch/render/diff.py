"""Differentiable rendering: per-sample radiance as a differentiable
function of the scene's parameters.

PyTorch counterpart of the JAX package's `render/diff.py`.  The forward
renderer reproduces the reference (scene_s_lum, reference
src/scene.c:420-667); this module adds the backward pass over it, with
respect to

  * every material and light table (`Integrator.mat_params`: albedo and
    texture colours, radiance, refractive index, fresnel / chromatic /
    diffuse weights, sigma, transparency, light position / radiance /
    radius / colour, background), and
  * every analytic leaf (`Tracer.geom_params`: sphere centres and radii,
    plane normals and offsets, quadric frames and coefficients, alone or
    inside CSG composites), whose hit distances are closed-form, and the
    frame and parameter of each standalone SDF object, whose converged
    march is reattached through its implicit function.

How it is built:

  * The wavefront drain compacts its queue, so it is no function of the
    parameters that autograd could follow.  `radiance` instead replays
    paths: at each bounce exactly ONE child branch (fresnel, chromatic,
    refraction or a path sample) is followed, chosen with probability
    proportional to its detached weight and reweighted by 1/p, an
    unbiased single-sample estimate of the full branching recursion.  The
    replay is a loop of fixed-size ray batches over bounces, and the
    tracer's plain torch queries run inside it (the hand-written kernels
    have no backward; the tracer and integrator leave them out under
    `ovr` and `diff`, as the JAX package leaves out its Pallas kernels).
  * RNG streams come from (sample_id, depth) counters
    (seed_mode="counter"), so the randomness does not move with the
    parameters and central differences of the same estimator match its
    gradient.
  * Device residency, as the JAX package's `jit(value_and_grad(...))`:
    where the host may not read the device (`tracer.host_reads_ok`: a
    CUDA-graph capture) the replay runs every bounce with no read, each
    bounce's NEE and its backward gated on the device as the JAX step's
    `lax.cond` (`Integrator._nee_gated`), and it uploads nothing (device
    constants from `Tracer._const`), so on a card `value_and_grad` is the
    replay of one CUDA graph of the forward replay and its backward
    (`diff_graphs`, render/graphs.py `DiffGraphs`), bit-equal to the
    eager call.
  * Discrete events (the nearest object, a CSG boundary's identity) are
    locally constant: gradients are the interior derivatives.  With
    `edge_aware=True` the NEE visibility discontinuity adds its
    silhouette boundary term (Integrator._nee_edge_terms).

    dr = DiffRenderer(integ)
    loss, grads = dr.value_and_grad(dr.primary(pos))  # grads like params()
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from actinon_tpu_torch import rng as argn
from actinon_tpu_torch.render.integrator import Integrator
from actinon_tpu_torch.render.tracer import _dot, as_table, host_reads_ok
from actinon_tpu_torch.scene import ir as sir

_SEL_SALT = 0xB5297A4D
_LANE_FIELDS = ("p", "d", "intensity", "tint", "depth", "sample_id")


class EdgeCoverageWarning(UserWarning):
    """A scene holds occluder classes whose silhouette motion the
    edge-aware NEE boundary term does not cover."""


def edge_coverage_gaps(tracer):
    """The occluder classes of the tracer's scene that _nee_edge_terms
    treats as interior-only, as a set of names (empty: full coverage)."""
    tab = tracer.tab
    gaps = set()

    def quad_covered(c2s, rrs):
        c2s = np.asarray(c2s, float)
        if (c2s > 0).all() and rrs < 0:
            return True                        # ellipsoid
        z = np.isclose(c2s, 0.0)
        return bool(z.sum() == 1 and (c2s[~z] > 0).all() and rrs < 0)

    keys = {row for row, _k, fam in tab.comp_keys if fam == sir.QUADRIC}
    for row in np.asarray(tab.qua_rows):
        if tab.is_light[row] or not (tab.single[row] or row in keys):
            continue
        if not quad_covered(tab.c2[row], tab.rr[row]):
            gaps.add("cone/hyperboloid quadric")
    if any(not light for *_, light in tracer.sdf_singles):
        gaps.add("SDF object")
    for comp in tracer.comp_solo:
        if not comp.is_light and comp.has_sdf:
            gaps.add("SDF CSG leaf")
    return gaps


class DiffRenderer:
    """Differentiable radiance estimator over an Integrator's scene.

    n_steps: bounces replayed (default: the scene's trace depth; each
    bounce spends at least one depth unit).  sel_mode: "balanced" picks a
    branch with probability proportional to its detached weight (lowest
    variance); "uniform" picks each of the K branches with probability
    1/K, independent of the parameters, so the realized estimate is
    differentiable by finite differences.  edge_aware: add the NEE
    silhouette boundary term."""

    def __init__(self, integ: Integrator, n_steps: Optional[int] = None,
                 sel_mode: str = "balanced", edge_aware: bool = False):
        self.integ = integ
        self.tr = integ.tr
        self.dtype = integ.dtype
        self.edge_aware = edge_aware
        if edge_aware:
            gaps = edge_coverage_gaps(self.tr)
            if gaps:
                warnings.warn(
                    "edge-aware NEE gradients do not cover these occluder "
                    f"classes in this scene: {sorted(gaps)}; their "
                    "silhouette motion contributes no gradient (interior "
                    "terms only, see Integrator._nee_edge_terms)",
                    EdgeCoverageWarning, stacklevel=2)
        self.n_steps = int(integ.cfg.trace_depth) if n_steps is None \
            else int(n_steps)
        if sel_mode not in ("balanced", "uniform"):
            raise ValueError(f"sel_mode {sel_mode!r}")
        self.sel_mode = sel_mode
        self.steps_run = 0
        # True (on a CUDA device): value_and_grad replays a CUDA graph of
        # the whole replay and its backward (render/graphs.py); False
        # runs the same code eagerly
        self.diff_graphs = self.integ.device.type == "cuda"
        self._graphs = None
        self._own = (None, None)     # (tables' generations, params())

    # ------------------------------------------------------------------

    def params(self) -> Dict:
        """Every differentiable scene parameter: {"geom": geom_params,
        "mat": mat_params} as tensors on the integrator's device."""
        integ = self.integ
        t = lambda v: torch.as_tensor(np.asarray(v), dtype=integ.tdtype,
                                      device=integ.device)
        return {"geom": {k: t(v) for k, v in self.tr.geom_params().items()},
                "mat": {k: t(v) for k, v in integ.mat_params().items()}}

    def _at(self, params: Optional[Dict]) -> Dict:
        """The parameter values of a call on the device, keys as
        params(): the scene's own (uploaded once per set_geom/set_mat),
        with the entries of `params` (arrays or tensors, any subset of
        the keys) in their place."""
        integ = self.integ
        gen = (self.tr._generation, integ._generation)
        if self._own[0] != gen:
            self._own = (gen, self.params())
        own = self._own[1]
        if not params:
            return own
        out = {g: dict(grp) for g, grp in own.items()}
        for g, grp in params.items():
            for k, v in grp.items():
                if k not in out[g]:
                    raise KeyError(f"{g}.{k}")
                out[g][k] = as_table(v, integ.tdtype, integ.device)
        return out

    def primary(self, pos2d) -> Dict:
        """Primary ray batch for subpixel positions [N,2] (x, y)."""
        from actinon_tpu_torch.render.driver import camera_rays
        integ = self.integ
        p, d = camera_rays(self.tr.ir, np.asarray(pos2d, np.float64),
                           self.dtype)
        n = len(p)
        dev, dt = integ.device, integ.tdtype
        return {
            "p": torch.as_tensor(p, device=dev),
            "d": torch.as_tensor(d, device=dev),
            "intensity": torch.ones((n,), dtype=dt, device=dev),
            "tint": torch.ones((n, 3), dtype=dt, device=dev),
            "depth": torch.full((n,), int(integ.cfg.trace_depth),
                                dtype=torch.int64, device=dev),
            "sample_id": torch.arange(n, dtype=torch.int64, device=dev),
            "is_path": torch.zeros((n,), dtype=torch.bool, device=dev),
        }

    def _lanes(self, q0: Dict) -> Dict:
        """A ray batch (tensors or arrays) on the integrator's device:
        floats in its dtype, integers as int64."""
        integ = self.integ
        out = {}
        for k, v in q0.items():
            v = torch.as_tensor(v, device=integ.device)
            if v.is_floating_point():
                v = v.to(integ.tdtype)
            elif v.dtype != torch.bool:
                v = v.to(torch.int64)
            out[k] = v
        return out

    # ------------------------------------------------------------------

    def _path_child(self, pp: Dict):
        """ONE hemisphere path sample from the path-spawn descriptors: the
        single-sample form of the path spawn (reference
        src/scene.c:584-621 averages ns samples with tint * 2 / ns; one
        sample scaled by ns gives tint * 2)."""
        integ = self.integ
        dt = integ.tdtype
        frame = integ._conz_t(pp["surf_d"])
        c0 = 4 * integ.direct_cap * max(integ.n_lights, 1)
        u1 = argn.uniform(pp["rv"], c0, dt)
        u2 = argn.uniform(pp["rv"], c0 + 1, dt)
        phi = 2.0 * math.pi * u1
        z = 1.0 - u2
        sc = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        local = torch.stack([torch.sin(phi) * sc, torch.cos(phi) * sc, z],
                            -1)
        out_d = torch.einsum("rij,rj->ri", frame, local)
        w = _dot(out_d, pp["surf_d"])
        won = torch.where(
            pp["on_b"] > 0,
            integ._oren_nayar(w, pp["theta_i"], pp["on_a"], pp["on_b"],
                              out_d, pp["surf_d"], pp["ray_prj"]), w)
        return dict(
            mask=pp["mask"] & (w > 0), p=pp["pos"], d=out_d,
            intensity=won * pp["di"], tint=pp["tint"] * 2.0,
            depth=pp["depth"], sample_id=pp["sample_id"])

    def _diff_step(self, q: Dict, step_i: int):
        """One bounce: shade, then follow ONE child branch at random.
        Returns (contrib [B,3], the next ray batch)."""
        integ = self.integ
        dt, dev = integ.tdtype, integ.device
        B = q["p"].shape[0]
        is_path = q["is_path"]
        lane = {k: q[k] for k in _LANE_FIELDS}

        sid, contrib, children, pp = integ._step(lane, path_ray=False)
        if integ.path_cap > 0:
            # path rays trace matter only and end at max_path_length
            # (reference src/scene.c:596-617): both classifications, one
            # chosen per lane
            _, contrib_p, children_p, pp_p = integ._step(lane,
                                                         path_ray=True)

            def per_lane(a, b):
                m = is_path.reshape((B,) + (1,) * (a.dim() - 1))
                return torch.where(m, b, a)

            contrib = per_lane(contrib, contrib_p)
            children = {k: {f: per_lane(children[k][f], children_p[k][f])
                            for f in children[k]} for k in children}
            if pp is not None:
                pp = {f: per_lane(pp[f], pp_p[f]) for f in pp}

        cand = [children["fresnel"], children["chromatic"],
                children["refract"]]
        path_sel = None
        if integ.path_cap > 0 and pp is not None:
            path_sel = self._path_child(pp)
            cand.append(path_sel)
        K = len(cand)

        w = torch.stack([torch.where(c["mask"], c["intensity"], 0.0)
                         for c in cand], dim=-1)                 # [B,K]
        w_det = w.detach()
        W_det = torch.sum(w_det, dim=-1)
        alive = W_det > 0
        W_safe = torch.where(alive, W_det, 1.0)
        if self.sel_mode == "uniform":
            probs = torch.full_like(w_det, 1.0 / K)
        else:
            probs = w_det / W_safe[:, None]
        cum = torch.cumsum(probs, dim=-1)

        sel_seed = argn.mix(q["sample_id"], _SEL_SALT)
        u = argn.uniform(sel_seed, step_i, dt)
        k_sel = torch.sum((u[:, None] >= cum).to(torch.int64), dim=-1)
        k_sel = torch.clamp(k_sel, max=K - 1)

        def pick(field, default):
            out = default
            for k in range(K):
                v = cand[k][field]
                m = (k_sel == k).reshape((B,) + (1,) * (v.dim() - 1))
                out = torch.where(m, v, out)
            return out

        # 1/p reweighting: the chosen branch's weight w_k times
        # W_det / w_k_det keeps the estimate unbiased and the gradient of
        # w_k intact.  Written (w_k * W_det) / w_k_det, the rounding of
        # the JAX package's compiled replay: behind glass W_det = R +
        # (1 - R) sits on an integer step of the NEE sample count
        # floor(direct_samples * di), where one ulp changes the count
        w_sel = torch.gather(w, 1, k_sel[:, None])[:, 0]
        w_sel_det = torch.gather(w_det, 1, k_sel[:, None])[:, 0]
        if self.sel_mode == "uniform":
            new_int = w_sel * float(K)
        else:
            new_int = w_sel * W_det / torch.where(w_sel_det > 0, w_sel_det,
                                                  1.0)
        nq = {
            "p": pick("p", q["p"]),
            "d": pick("d", q["d"]),
            "intensity": torch.where(alive, new_int, 0.0),
            "tint": pick("tint", q["tint"]),
            "depth": pick("depth", torch.zeros((B,), dtype=torch.int64,
                                               device=dev)),
            "sample_id": q["sample_id"],
            "is_path": ((k_sel == 3) & alive) if path_sel is not None
            else torch.zeros((B,), dtype=torch.bool, device=dev),
        }
        return contrib, nq

    # ------------------------------------------------------------------

    def radiance(self, params: Dict, q0: Dict,
                 n_steps: Optional[int] = None):
        """Per-sample radiance [B,3], differentiable with respect to the
        tensors of `params` (keys as params()).  The tracer's and the
        integrator's overrides, flags and seed mode are restored on
        return.  Where the host may read the device (the CPU, a card
        outside a CUDA-graph capture: `tracer.host_reads_ok`) the replay
        stops early once every lane is dead (its remaining bounces would
        add exactly zero); elsewhere it runs all `n_steps` bounces, as the
        JAX package's scan does.  `steps_run` keeps the number of bounces
        it ran.  A direct call runs eagerly and its caller owns the
        autograd graph (central differences, custom losses, fits);
        `value_and_grad` replays a captured graph on a card."""
        integ, tr = self.integ, self.tr
        n = self.n_steps if n_steps is None else int(n_steps)
        saved = (integ.ovr, tr.ovr, tr.diff, integ.seed_mode,
                 integ.edge_aware)
        integ.ovr = dict(params.get("mat", {}))
        tr.ovr = dict(params.get("geom", {}))
        tr.diff = True
        integ.seed_mode = "counter"
        integ.edge_aware = self.edge_aware
        try:
            q = self._lanes(q0)
            acc = torch.zeros((q["p"].shape[0], 3), dtype=integ.tdtype,
                              device=integ.device)
            self.steps_run = 0
            stop = host_reads_ok(integ.device)
            for i in range(n):
                if stop and not bool((q["intensity"] > 0).any()):
                    break
                contrib, q = self._diff_step(q, i)
                acc = acc + contrib
                self.steps_run = i + 1
            return acc
        finally:
            (integ.ovr, tr.ovr, tr.diff, integ.seed_mode,
             integ.edge_aware) = saved
            tr._ovr_tabs = None
            integ._ovr_mats = None

    def render_loss(self, params: Dict, q0: Dict, weight=None):
        """Scalar mean (weighted) radiance: a convenience loss head."""
        rad = self.radiance(params, q0)
        if weight is not None:
            rad = rad * torch.as_tensor(weight, dtype=rad.dtype,
                                        device=rad.device)
        return torch.mean(rad)

    def value_and_grad(self, q0: Dict, weight=None,
                       params: Optional[Dict] = None):
        """(loss, grads) at the scene's own parameters, or at `params`
        (values for any of the keys of params(); the rest are the
        scene's own), as the JAX package's jitted value_and_grad takes
        them; grads has the keys of params() (zeros where the loss does
        not depend on a parameter).  With `diff_graphs` (a card) the
        call is the replay of a CUDA graph of the whole replay and its
        backward (render/graphs.py `DiffGraphs`), bit-equal to the eager
        call; new values, passed here or set by set_geom/set_mat, replay
        the same graph."""
        return self.share_value_and_grad(self._lanes(q0), weight,
                                         params=params)

    def share_value_and_grad(self, q: Dict, weight=None,
                             total: Optional[int] = None,
                             params: Optional[Dict] = None):
        """(loss, grads) of the lanes `q` (on the device, as `_lanes`
        gives them) at the parameters of value_and_grad.  total=None:
        the loss is render_loss, the mean over q; else q is a share of a
        batch of `total` rows and the loss its part of that batch's mean,
        sum / (3 total) (ShardedDiffRenderer sums the shares).  A CUDA
        graph replay with `diff_graphs`, else the eager call."""
        at = self._at(params)
        if self.diff_graphs:
            if self._graphs is None:
                from actinon_tpu_torch.render.graphs import DiffGraphs
                self._graphs = DiffGraphs(self)
            return self._graphs.value_and_grad(q, at, weight, total)
        leaves = {g: {k: v.detach().requires_grad_(True)
                      for k, v in grp.items()}
                  for g, grp in at.items()}
        return self._share(leaves, q, weight, total)

    def _share(self, leaves: Dict, q: Dict, weight=None,
               total: Optional[int] = None):
        """The loss of the lanes `q` at the leaf tensors `leaves` (keys as
        params()) and its gradients by torch.autograd.grad (zeros for the
        leaves it does not reach): what DiffGraphs captures."""
        if total is None:
            loss = self.render_loss(leaves, q, weight)
        else:
            rad = self.radiance(leaves, q)
            if weight is not None:
                rad = rad * weight
            loss = torch.sum(rad) / (3 * total)
        flat = [(g, k, v) for g, grp in leaves.items()
                for k, v in grp.items()]
        got = torch.autograd.grad(loss, [v for *_, v in flat],
                                  allow_unused=True)
        grads = {g: {} for g in leaves}
        for (g, k, v), gv in zip(flat, got):
            grads[g][k] = torch.zeros_like(v) if gv is None else gv
        return loss.detach(), grads
