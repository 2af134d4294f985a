"""Inverse MCRT: recover optical properties from detector targets (port of
``rsmcrt_tpu/inverse.py``; reference: ``inverse_MCRT``,
src/kernelsMod.f90:1462-1787).

- :func:`inverse_random_search`: the reference's random exploration of
  (mus, mua, g, n) within its bounds, scored by ``-mean |total/N -
  target|`` (:1753-1787), keeping the best parameters.
- :func:`inverse_gradient_descent`: Adam on the same objective, with
  gradients from the perturbation-MC statistics of one forward run a step
  (``TransportConfig.inverse_prim``)::

      dT/dmus = Sum w (s/mus - L),  dT/dmua = Sum w (-L),
      dT/dg = Sum w Sum_i d log p_HG(cos_i; g) / dg,

  the Fresnel-choice score for n and the boundary-extinction score for a
  radius, or common-random-number central differences (two more runs of
  one seeded ``torch.Generator`` each) where the score does not apply.
- :func:`detector_gradients`: per-detector totals and gradients at the
  config's parameters; :func:`inverse_MCRT` writes
  ``inverse_results.dat``.

The forward runs go to the scene's device; the optimiser is NumPy on the
host.
"""

from __future__ import annotations

from dataclasses import replace as dc_replace
from pathlib import Path

import numpy as np
import torch

from .detectors.detectors import totals as detector_totals, zero_detectors
from .kernels import default_lanes, setup
from .sdfs.scene import Scene
from .transport.engine import TransportConfig, simulate

# reference bounds (kernelsMod.f90:1609-1616)
BOUNDS = {
    "mus": (0.0, 100.0),
    "mua": (0.0, 100.0),
    "g": (-1.0, 1.0),
    "n": (1.0, 20.0),
}


def _prim_location(scene: Scene, layer_id: int) -> int:
    """The index of the prim whose layer ID matches (reference:
    kernelsMod.f90:1583-1600)."""
    try:
        return scene.layer_ids.index(layer_id)
    except ValueError:
        raise ValueError(
            "Selected layer not found in SDF array please choose a layer "
            "inside the SDF array") from None


def _set_row(t: torch.Tensor, i: int, value) -> torch.Tensor:
    """A copy of a layer table with layer ``i`` set to ``value``."""
    out = t.clone()
    out[..., i] = value
    return out


def _set_prim_optics(scene: Scene, prim_index: int, mus, mua, hgg, n):
    """A scene with one prim's optical properties replaced (reference
    updateOptProp, sdf_base.f90:250-259): table row ``prim_index + 1``."""
    i = prim_index + 1
    t = scene.tables
    tables = dc_replace(t, mus=_set_row(t.mus, i, mus),
                        mua=_set_row(t.mua, i, mua),
                        hgg=_set_row(t.hgg, i, hgg), n=_set_row(t.n, i, n))
    return dc_replace(scene, tables=tables)


def _prim_group_slot(scene: Scene, prim_index: int):
    """(group, member) slot of a prim in the stacked group parameters."""
    col = scene.perm[prim_index]
    acc = 0
    for g, size in enumerate(scene.group_sizes):
        if col < acc + size:
            return g, col - acc
        acc += size
    raise IndexError(prim_index)


def _set_prim_shape(scene: Scene, prim_index: int, name: str, value):
    """A scene with one prim's shape parameter (e.g. a sphere's
    ``radius``) replaced; the basis of SDF-shape recovery."""
    g, m = _prim_group_slot(scene, prim_index)
    params = scene.group_params[g]
    if name not in params:
        raise KeyError(f"prim {prim_index} has shape parameters "
                       f"{sorted(params)}, not {name!r}")
    stacked = params[name].clone()  # [members, ...]
    stacked[m] = value
    new_params = list(scene.group_params)
    new_params[g] = {**params, name: stacked}
    return dc_replace(scene, group_params=new_params)


def inverse_evaluate(totals, nphotons, target_values):
    """Error = -(1/M) Sum |total/N - target| over detectors with a target
    (reference: inverse_evaluate, kernelsMod.f90:1753-1787)."""
    totals = np.asarray(totals, np.float64)
    targets = np.asarray(target_values, np.float64)
    mask = targets != -1.0
    if not mask.any():
        return 0.0
    return -float(np.abs(totals[mask] / nphotons - targets[mask]).mean())


def pmc_config(parsed, scene, prim_index, nphotons=None, n_lanes=None,
               chain=False) -> TransportConfig:
    """The transport config of a run that scores prim ``prim_index``:
    detector totals and pMC statistics only, on the plain walk unless
    ``chain``, at the config's photon count unless ``nphotons``."""
    nph = int(nphotons if nphotons is not None else parsed.settings.nphotons)
    return TransportConfig(
        nphotons=nph,
        n_lanes=int(n_lanes or default_lanes(nph, scene.device)),
        inverse_prim=prim_index + 1, record_fluence=False,
        chain_scatter=chain)


def _forward(parsed, scene, cfg, seed, inverse_prim=0):
    """One forward run with a fresh generator seeded ``seed``: detector
    totals, pMC statistics (or None) and photons launched, on the host."""
    gen = torch.Generator(device=scene.device)
    gen.manual_seed(int(seed))
    tallies, bank_out, launched, _ = simulate(
        scene, parsed.source, parsed.settings.grid, gen, cfg,
        bank=zero_detectors(parsed.detectors))
    tot = detector_totals(bank_out).cpu().numpy()
    stats = tallies.pmc_stats.cpu().numpy() if inverse_prim else None
    return tot, stats, int(launched)


def _optics(scene, prim_index):
    i = prim_index + 1
    t = scene.tables
    return {"mus": float(t.mus[i]), "mua": float(t.mua[i]),
            "g": float(t.hgg[i]), "n": float(t.n[i])}


def _targets(parsed):
    return parsed.detectors.target_values.cpu().numpy().astype(np.float64)


def inverse_random_search(input_file, nsteps=None, nphotons=None,
                          n_lanes=None, res_dir=None, verbose=True,
                          device=None):
    """Random-exploration recovery (the reference's explore loop,
    kernelsMod.f90:1663-1738, keeping the best parameters)."""
    parsed, scene = setup(input_file, kernel="inverse", res_dir=res_dir,
                          device=device)
    st = parsed.settings
    inv = st.inverse
    prim_index = _prim_location(scene, inv["layer"])
    find = [k for k, fk in (("mus", "Findmus"), ("mua", "Findmua"),
                            ("g", "Findg"), ("n", "Findn")) if inv[fk]]
    if not find:
        raise ValueError("Please select at least one of mus, mua, hgg, n "
                         "to find with inverse MCRT")
    current = _optics(scene, prim_index)
    nsteps = int(nsteps if nsteps is not None else inv["maxNumSteps"])
    nph = int(nphotons if nphotons is not None else st.nphotons)
    cfg = TransportConfig(
        nphotons=nph, n_lanes=int(n_lanes or default_lanes(nph,
                                                           scene.device)),
        record_fluence=False)  # the search scores detector totals only
    rng = np.random.default_rng(st.iseed)
    history = []
    best = None
    for it in range(nsteps):
        trial = dict(current)
        for k in find:
            lo, hi = BOUNDS[k]
            trial[k] = float(rng.uniform(lo, hi))
        sc = _set_prim_optics(scene, prim_index, trial["mus"],
                              trial["mua"], trial["g"], trial["n"])
        tot, _, launched = _forward(parsed, sc, cfg, st.iseed + it)
        err = inverse_evaluate(tot, launched, _targets(parsed))
        history.append({**trial, "error": err})
        if best is None or err > best["error"]:
            best = history[-1]
        if verbose:
            print(f"step {it}: error={err:.6f} best={best['error']:.6f}")
    return best, history


def _crn_fd_totals(parsed, scene_lo, scene_hi, cfg, seed, h):
    """Common-random-number central difference of the detector totals per
    photon: both runs draw from a generator seeded alike, so the paths
    stay correlated and the difference isolates the parameter's effect
    (for n and shape parameters, which move photons deterministically)."""
    t_hi, _, n_hi = _forward(parsed, scene_hi, cfg, seed)
    t_lo, _, n_lo = _forward(parsed, scene_lo, cfg, seed)
    return (t_hi.astype(np.float64) / n_hi
            - t_lo.astype(np.float64) / n_lo) / (2.0 * h)


def _score_grads(stats, mus):
    """``{mus, mua, g}`` derivatives of the detector totals from the pMC
    rows ``[Sum w, Sum w cnt, Sum w len, Sum w hg, Sum w fn, Sum w bn]``,
    and the n and radius scores."""
    sw, swc, swl, swh, swn, swr = (stats[:, j].astype(np.float64)
                                   for j in range(6))
    return ({"mus": swc / max(mus, 1e-9) - swl, "mua": -swl, "g": swh},
            swn, swr)


def inverse_gradient_descent(input_file, nsteps=50, nphotons=None,
                             chain=False, n_lanes=None, lr=0.1,
                             res_dir=None, verbose=True, seed=None,
                             shape_params=None, h_n=2e-2, h_shape=2e-2,
                             find=None, lr_decay=10.0, n_method="score",
                             shape_method=None, device=None):
    """Gradient recovery of (mus, mua, g, n) and optional SDF shape
    parameters: Adam ascent on the error with a 1/(1 + t/T) step decay.
    (mus, mua, g) take their likelihood-ratio scores; n takes the
    Fresnel-choice score with its angular term (``n_method="fd"``: CRN
    central differences, for n at a matched index); a ``radius`` takes
    the boundary-extinction score, other shape parameters CRN differences
    (``shape_method``).  ``chain`` selects the chained walk."""
    parsed, scene = setup(input_file, kernel="inverse", res_dir=res_dir,
                          device=device)
    st = parsed.settings
    inv = st.inverse
    prim_index = _prim_location(scene, inv["layer"])
    targets = _targets(parsed)
    if find is None:
        find = [k for k, fk in (("mus", "Findmus"), ("mua", "Findmua"),
                                ("g", "Findg")) if inv[fk]]
        find_n = bool(inv["Findn"])
    else:
        find_n = "n" in find
        find = [k for k in find if k in ("mus", "mua", "g")]
    shape_params = list(shape_params or [])

    theta = _optics(scene, prim_index)
    g_slot, m_slot = _prim_group_slot(scene, prim_index)
    for sp in shape_params:
        theta[sp] = float(scene.group_params[g_slot][sp][m_slot])
    cfg = pmc_config(parsed, scene, prim_index, nphotons, n_lanes, chain)

    def build_scene_at(th):
        sc = _set_prim_optics(scene, prim_index, th["mus"], th["mua"],
                              th["g"], th["n"])
        for sp in shape_params:
            sc = _set_prim_shape(sc, prim_index, sp, th[sp])
        return sc

    def crn(key, h, it):
        lo, hi = ({**theta, key: theta[key] - h}, {**theta, key: theta[key] + h})
        return _crn_fd_totals(parsed, build_scene_at(lo), build_scene_at(hi),
                              cfg, base_seed + it, h)

    all_params = find + (["n"] if find_n else []) + shape_params
    m = {k: 0.0 for k in all_params}  # Adam state
    v = {k: 0.0 for k in all_params}
    history = []
    base_seed = seed if seed is not None else st.iseed
    for it in range(nsteps):
        tot, stats, launched = _forward(parsed, build_scene_at(theta), cfg,
                                        base_seed + it,
                                        inverse_prim=prim_index + 1)
        dT, swn, swr = _score_grads(stats, theta["mus"])
        err = inverse_evaluate(tot, launched, targets)
        mask = targets != -1.0
        sgn = np.sign(tot / launched - targets) * mask
        mcount = max(mask.sum(), 1)
        grads = {k: -float((sgn * dT[k]).sum() / launched / mcount)
                 for k in find}
        if find_n:
            if n_method == "score":
                grads["n"] = -float((sgn * swn).sum() / launched / mcount)
            else:
                grads["n"] = -float((sgn * crn("n", h_n, it)).sum()
                                    / mcount)
        for sp in shape_params:
            sm = shape_method or ("score" if sp == "radius" else "fd")
            if sm == "score":
                grads[sp] = -float((sgn * swr).sum() / launched / mcount)
            else:
                grads[sp] = -float((sgn * crn(sp, h_shape, it)).sum()
                                   / mcount)
        history.append({**theta, "error": err, "grads": dict(grads)})
        if verbose:
            print(f"step {it}: err={err:.6f} "
                  + " ".join(f"{k}={theta[k]:.4f}" for k in all_params))
        b1, b2, eps = 0.9, 0.999, 1e-8
        lr_t = lr / (1.0 + it / lr_decay)
        for k in all_params:
            gk = grads[k]
            m[k] = b1 * m[k] + (1 - b1) * gk
            v[k] = b2 * v[k] + (1 - b2) * gk * gk
            mh = m[k] / (1 - b1 ** (it + 1))
            vh = v[k] / (1 - b2 ** (it + 1))
            theta[k] = theta[k] + lr_t * mh / (np.sqrt(vh) + eps)
            if k in BOUNDS:
                lo, hi = BOUNDS[k]
                theta[k] = float(np.clip(theta[k], lo, hi))
            else:
                theta[k] = float(max(theta[k], 1e-3))  # shape > 0
    best = max(history, key=lambda h: h["error"])
    return {k: best[k] for k in theta}, history


def detector_gradients(input_file, nphotons=None, n_lanes=None,
                       res_dir=None, seed=None, h_n=2e-2, h_shape=2e-2,
                       shape_param=None, want_n=False, chain=False,
                       n_method="score", shape_method=None, device=None):
    """Per-detector totals and their gradients at the config's parameters,
    from the pMC scores of one forward run (``n_method="fd"`` /
    ``shape_method="fd"``: CRN central differences)."""
    parsed, scene = setup(input_file, kernel="inverse", res_dir=res_dir,
                          device=device)
    st = parsed.settings
    prim_index = _prim_location(scene, st.inverse["layer"])
    cfg = pmc_config(parsed, scene, prim_index, nphotons, n_lanes, chain)
    base_seed = seed if seed is not None else st.iseed
    tot, stats, launched = _forward(parsed, scene, cfg, base_seed,
                                    inverse_prim=prim_index + 1)
    th = _optics(scene, prim_index)
    dT, swn, swr = _score_grads(stats, th["mus"])
    out = dict(totals=tot, launched=launched, dT_dmus=dT["mus"],
               dT_dmua=dT["mua"], dT_dg=dT["g"], parsed=parsed, scene=scene,
               prim_index=prim_index, cfg=cfg)
    if want_n:
        if n_method == "score":
            out["dT_dn"] = swn
        else:
            args = (th["mus"], th["mua"], th["g"])
            out["dT_dn"] = _crn_fd_totals(
                parsed, _set_prim_optics(scene, prim_index, *args,
                                         th["n"] - h_n),
                _set_prim_optics(scene, prim_index, *args, th["n"] + h_n),
                cfg, base_seed, h_n) * launched
    if shape_param is not None:
        sm = shape_method or ("score" if shape_param == "radius" else "fd")
        if sm == "score":
            out[f"dT_d{shape_param}"] = swr
        else:
            g_slot, m_slot = _prim_group_slot(scene, prim_index)
            s0 = float(scene.group_params[g_slot][shape_param][m_slot])
            out[f"dT_d{shape_param}"] = _crn_fd_totals(
                parsed,
                _set_prim_shape(scene, prim_index, shape_param,
                                s0 - h_shape),
                _set_prim_shape(scene, prim_index, shape_param,
                                s0 + h_shape),
                cfg, base_seed, h_shape) * launched
    return out


def inverse_MCRT(input_file, data_dir="data", n_lanes=None, res_dir=None,
                 method="gradient", verbose=True, device=None):
    """Top-level inverse kernel (reference: kernelsMod.f90:1462-1751);
    unlike the reference (its TODO at :1741), the results are written, to
    ``data_dir/inverse_results.dat``."""
    search = (inverse_gradient_descent if method == "gradient"
              else inverse_random_search)
    best, history = search(input_file, n_lanes=n_lanes, res_dir=res_dir,
                           verbose=verbose, device=device)
    out = Path(data_dir)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "inverse_results.dat", "w") as fh:
        fh.write("# step mus mua g n error\n")
        for it, h in enumerate(history):
            fh.write(f"{it} {h['mus']} {h['mua']} {h['g']} {h['n']} "
                     f"{h['error']}\n")
    return best, history
