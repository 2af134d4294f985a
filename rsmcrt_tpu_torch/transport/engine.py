"""Wavefront photon transport engine (port of
``rsmcrt_tpu/transport/engine.py``: the forward path with its transport
options, detector banks, escape-function attribution and the
perturbation-MC statistics of the inverse kernel).

A batch of photon lanes advances in lockstep, one *megastep* per
:func:`transport_step` call:

1. **Analysis**: dead lanes respawn from the source while the photon
   budget lasts; lanes with no segment left resolve boundary events
   (eps-nudge probe, Fresnel reflect / refract / cross) and pick their
   next segment from the analytic raycast bound, the march over the
   non-analytic prims and the remaining optical depth (reference
   inttau2.f90:73-146, 155-192, 209-337).  Detector banks test it.
2. **Walk**, one of two, chosen as the reference chooses
   (:meth:`TransportConfig.chains`):

   - the *chained* walk (:func:`_chained_walk`): every lane walks up to
     ``dda_substeps`` voxel-wall intervals, consuming scatter,
     absorption, surface and in-chain respawn events in place (reference
     update_grids, inttau2.f90:408-445, and kernelsMod.f90:1958-2066);
     without the fluence estimator every round jumps a whole segment
     (inttau2.f90:446-462).  On a card, on a float32 scene of spheres
     and boxes with one optical table, the K rounds are one launch of a
     hand-written kernel, one thread a lane (:func:`_fused_walk`,
     :mod:`~rsmcrt_tpu_torch.transport.walk_kernel`); every other walk runs
     them in PyTorch (:func:`_torch_rounds`), on a card without pMC or
     autograd replayed from a CUDA graph (:func:`_chained_walk`);
   - the *plain* walk: one segment a megastep, its first ``dda_substeps``
     voxel intervals from a closed-form merge of the three axes' wall
     crossings (:func:`_closed_form_dda`), or one jump without the
     fluence estimator.  Path history, the phasor tally, a scene with
     non-analytic prims and no in-chain march budget, and
     ``chain_scatter=False`` take it.
3. **Interaction** at completed segment ends: analog scatter / absorb or
   survival bias with roulette, the path history ring and the phasor.

The voxel tallies change only through
:func:`~rsmcrt_tpu_torch.transport.deposit.deposit_add_` (the CUDA deposit
kernel on the card), once per tally per megastep; the phasor's signed
rows use its ``signed`` option.  Detector bins change once per megastep
in the analysis phase (:func:`record_hits`) and once after the chain
(:func:`flush_bins`).

Escape functions (``escape_shape = (M, ndect)``): lane photons are given
source voxels ``sid`` in launch order, ``nphotons // M`` each, and their
detector hit weights are added into ``tallies.escape_tot [M, ndect]`` at
``sid * ndect + d`` through ``deposit_add_``: once a megastep for the
analysis phase's hits and once for the chained walk's per-lane hit
accumulator.  ``M * ndect`` stays far below 2^31 at any symmetry grid a
config can ask for (a 256^3 grid with 64 detectors is 2^30), so the int32
index of the deposit kernel holds it.  Escape runs turn in-chain respawn
off, as the reference does: a lane's ``sid`` is then constant through its
chained walk.

Perturbation MC (``inverse_prim = p``): each photon carries its scatter
count, path length and Henyey-Greenstein score inside layer ``p``, the
Fresnel-choice score for ``p``'s index and the boundary-extinction score
for its surface (``pmc_*``), and the direction tangent ``pmc_dd = d dir /
d n_p`` carried through scatter, reflection and refraction by
``torch.func.jvp`` of four closed-form functions; every detector hit adds
``w * [1, cnt, len, hg, fn, bn]`` to ``tallies.pmc_stats [ndect, 6]``
(a sum over lanes, a torch reduction).

Random numbers: each megastep consumes up to three uniform blocks in
(0, 1) (:class:`StepDraws`), drawn in the carry's type from the run's
``torch.Generator`` unless the caller injects them -- the parity tests
hand both packages the blocks ``jax.random`` draws for the reference.
With ``qmc_source`` the source block is a scrambled Halton block keyed by
the global photon index, rotated by shifts drawn once a run
(``SimCarry.qmc_shifts``).

Types: a run is float32 unless its scene is float64 (``build_scene(...,
dtype=torch.float64)`` with a float64 grid and source): ``simulate``
takes the carry's type from ``scene.tables.mus``, and every constant
(``eps``, the segment cap, the roulette threshold) is formed in that
type, as the reference forms it.

Gradients: the megastep is differentiable in the scene's parameters (a
``mua`` that requires a gradient, say) through ``torch.autograd``, as the
reference's is through ``jax.grad``: every deposit of a value that
requires a gradient goes through the deposit kernel's autograd Function,
and the surface normals and raycast slopes keep their graph.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from dataclasses import dataclass, replace
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import obs
from ..constants import CHANCE, THRESHOLD, TWOPI
from ..detectors.detectors import (check_bins, flush_bins, ordered_cols,
                                   record_hits)
from ..grid import (CartGrid, as_dtype, f32, get_voxel, np_dtype,
                    voxel_flat_index)
from ..maths.qmc import halton_block, halton_shifts
from ..sdfs import raycast
from ..sdfs.scene import Scene, eval_scene, scene_layer
from ..sources.sources import Source, n_source_uniforms
from ..sources.sources import sample as sample_source
from ..tally import Tallies, zero_tallies
from . import walk_kernel
from .deposit import deposit_add_
from .fresnel import fresnel_coeff, reflect, refract
from .scatter import hg_logpdf_dg, sample_hg_cost, scatter_direction

# uniform columns per megastep: a source-kind-dependent block followed by
# seven fixed transport columns (offsets relative to the source block end)
_N_TRANSPORT_U = 7
_U_TAU0 = 0
_U_FRESNEL = 1
_U_ALBEDO = 2
_U_HG_COST = 3
_U_HG_PHI = 4
_U_TAU = 5
_U_ROULETTE = 6

_BIG = f32(3.4e38)
_TET = ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0),
        (1.0, 1.0, 1.0))


@dataclass(frozen=True)
class TransportConfig:
    """Static transport options; fields and defaults are the reference's
    (``rsmcrt_tpu.transport.engine.TransportConfig``)."""

    nphotons: int
    n_lanes: int = 65536
    survival_bias: bool = False
    record_fluence: bool = True
    record_emission: bool = False
    record_moments: bool = False
    max_bounces: int = 1000
    roulette_bounces: int = 0
    roulette_chance: float = 0.1
    max_steps: int = 2_000_000
    dda_substeps: int = 8
    chain_scatter: bool = False
    chain_respawn: bool = True
    march_iters: int = 6
    chain_march_iters: int = 4
    eps: float = 1e-5
    wall_delta_frac: float = 1e-3
    max_scatter_order: int = 0
    escape_shape: tuple = (0, 0)
    history_len: int = 0
    max_tracks: int = 0
    record_phasor: bool = False
    qmc_source: bool = False
    inverse_prim: int = 0
    chain_respawns: int = 1

    def check_ported(self):
        """Raise for option values no path accepts."""
        if self.chain_respawns < 1:
            raise ValueError("chain_respawns must be >= 1")

    def chains(self, scene) -> bool:
        """Whether a megastep on ``scene`` takes the chained walk, as the
        reference decides (engine.py:1353-1355): ``chain_scatter``, no
        path history, no phasor, and an all-analytic scene or an in-chain
        march budget.  Otherwise the plain walk."""
        return (self.chain_scatter and self.history_len == 0
                and not self.record_phasor
                and (self.chain_march_iters > 0
                     or all(raycast.analytic_column_mask(scene))))

    def respawns_in_chain(self, scene=None) -> bool:
        """In-chain respawn runs on the chained walk (assumed without a
        ``scene``) unless the source is quasi-random (its photon index is
        the analysis phase's) or the run is an escape function (a lane's
        source voxel must stay put through its walk), as the reference
        decides (engine.py:1585-1587)."""
        return ((scene is None or self.chains(scene)) and self.chain_respawn
                and not self.qmc_source and self.escape_shape[0] == 0)


@dataclass
class LaneState:
    pos: torch.Tensor  # [B, 3]
    dir: torch.Tensor  # [B, 3]
    weight: torch.Tensor  # [B]
    layer: torch.Tensor  # [B] int32, 0 = outside
    tau: torch.Tensor  # [B] remaining optical depth
    seg_rem: torch.Tensor  # [B] geometric length left in current segment
    seg_interact: torch.Tensor  # [B] bool: interaction at segment end
    seg_srf: torch.Tensor  # [B] bool: segment ends at a known surface
    seg_cont: torch.Tensor  # [B] bool: ends at a march-budget continuation
    seg_prim: torch.Tensor  # [B] int32 concat-order prim of that surface
    alive: torch.Tensor  # [B] bool
    bounces: torch.Tensor  # [B] int32
    steps: torch.Tensor  # [B] int32 scatter order
    phase: torch.Tensor  # [B] accumulated path length
    wavelength: torch.Tensor  # [B]
    sid: torch.Tensor  # [B] int32 source-voxel id (escape-function mode)
    history: torch.Tensor  # [B, H, 4]
    hist_n: torch.Tensor  # [B] int32
    pmc_cnt: torch.Tensor  # [B] (inverse-mode statistics, carried as is)
    pmc_len: torch.Tensor
    pmc_hg: torch.Tensor
    pmc_fn: torch.Tensor
    pmc_bn: torch.Tensor
    pmc_dd: torch.Tensor  # [B, 3]


@dataclass
class SimCarry:
    state: LaneState
    tallies: Tallies
    bank: object  # DetectorBank | None
    launched: torch.Tensor  # 0-d int32
    step: torch.Tensor  # 0-d int32
    #: the run's Cranley-Patterson rotation for ``qmc_source`` (drawn at
    #: the first megastep that needs it)
    qmc_shifts: Optional[torch.Tensor] = None


class StepDraws(NamedTuple):
    """The uniform blocks one megastep consumes, each in (0, 1):
    ``u_all [B, n_src_u + 7]``, ``uc [B, K, 4]`` (chain rounds; None on
    the plain walk) and ``u_rsp [C*B, n_src_u + 1]`` (in-chain respawn
    candidates, or None when in-chain respawn is off)."""

    u_all: torch.Tensor
    uc: Optional[torch.Tensor]
    u_rsp: Optional[torch.Tensor]


def _uniform(shape, generator, device, dtype):
    # the reference draws with minval=1e-12: keep -log(u) finite
    return torch.rand(shape, generator=generator, device=device,
                      dtype=dtype).clamp_(min=1e-12)


def draw_step(generator: torch.Generator, B: int, cfg: TransportConfig,
              source: Source, device, scene=None,
              dtype=torch.float32) -> StepDraws:
    """The blocks a megastep of ``cfg`` on ``scene`` consumes (without a
    scene: those of the chained walk), in ``dtype`` (the carry's)."""
    n_src_u = n_source_uniforms(source)
    u_all = _uniform((B, n_src_u + _N_TRANSPORT_U), generator, device,
                     dtype)
    uc = u_rsp = None
    if scene is None or cfg.chains(scene):
        uc = _uniform((B, cfg.dda_substeps, 4), generator, device, dtype)
    if cfg.respawns_in_chain(scene):
        u_rsp = _uniform((cfg.chain_respawns * B, n_src_u + 1), generator,
                         device, dtype)
    return StepDraws(u_all, uc, u_rsp)


def _init_lanes(B: int, device, history_len: int = 0,
                dtype=torch.float32) -> LaneState:
    def z():
        return torch.zeros((B,), dtype=dtype, device=device)

    def zi():
        return torch.zeros((B,), dtype=torch.int32, device=device)

    def zb():
        return torch.zeros((B,), dtype=torch.bool, device=device)

    d = torch.zeros((B, 3), dtype=dtype, device=device)
    d[:, 2] = 1.0
    return LaneState(
        pos=torch.zeros((B, 3), dtype=dtype, device=device), dir=d,
        weight=z(), layer=zi(), tau=z(), seg_rem=z(), seg_interact=zb(),
        seg_srf=zb(), seg_cont=zb(), seg_prim=zi(), alive=zb(),
        bounces=zi(), steps=zi(), phase=z(), wavelength=z(), sid=zi(),
        history=torch.zeros((B, max(history_len, 1), 4), dtype=dtype,
                            device=device),
        hist_n=zi(), pmc_cnt=z(), pmc_len=z(), pmc_hg=z(), pmc_fn=z(),
        pmc_bn=z(),
        pmc_dd=torch.zeros((B, 3), dtype=dtype, device=device),
    )


def init_carry(grid: CartGrid, cfg: TransportConfig, bank=None,
               dtype=torch.float32) -> SimCarry:
    """A fresh carry on the grid's device: every lane dead, tallies 0.
    The detector bank is copied there, so the caller's stays as it is."""
    dev = grid.device
    n_dect = bank.n_detectors if bank is not None else 0
    return SimCarry(
        state=_init_lanes(cfg.n_lanes, dev, cfg.history_len, dtype),
        tallies=zero_tallies(grid, dtype, escape_shape=cfg.escape_shape,
                             history_shape=(cfg.max_tracks,
                                            max(cfg.history_len, 1)),
                             phasor=cfg.record_phasor,
                             pmc_shape=(n_dect if cfg.inverse_prim > 0
                                        else 0, 6)),
        bank=None if bank is None else bank.to(dev),
        launched=torch.zeros((), dtype=torch.int32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _scalars(cfg: TransportConfig, dtype=torch.float32):
    """eps, land_eps, delta_cross in the run's arithmetic (``dtype``), as
    the reference forms them from ``jnp.asarray(cfg.eps, dtype)``: a
    float64 run at eps = 1e-8 keeps it as it is."""
    ft = np_dtype(dtype)
    e = ft(cfg.eps)
    land = ft(0.5) * e
    return float(e), float(land), float(land + ft(2.0) * e)


def _seg_cap(grid: CartGrid) -> float:
    """Segment cap: photons that outlive it never re-enter the grid (in
    the grid's type, as the reference forms it from the grid's extents)."""
    ft = np_dtype(grid.dtype)
    x, y, z = (ft(v) for v in (grid.xmax, grid.ymax, grid.zmax))
    return float(ft(8.0) * np.sqrt(x * x + y * y + z * z) + ft(1.0))


def _opt_lookup(tables, arr, layer, wavelength):
    """Per-lane optical property ``arr`` at ``layer``: ``arr[N+1, ...]``
    for a monochromatic scene; for a spectral one ``arr[W, N+1, ...]``
    interpolated linearly between the two wavelength rows around each
    photon's wavelength (reference package: engine.py:316-335)."""
    if tables.wavelengths is None:
        return arr[layer.long()]
    wl = tables.wavelengths
    W = wl.shape[0]
    wbin = torch.clamp(torch.searchsorted(wl, wavelength) - 1, 0, W - 2)
    lo, hi = wl[wbin], wl[wbin + 1]
    frac = torch.clamp((wavelength - lo) / torch.clamp(hi - lo, min=1e-30),
                       0.0, 1.0)
    a0 = arr[wbin, layer.long()]
    a1 = arr[wbin + 1, layer.long()]
    frac = frac.reshape(frac.shape + (1,) * (a0.ndim - frac.ndim))
    return a0 + (a1 - a0) * frac


def _take_col(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a [B, N], idx [B] -> a[b, idx[b]] with idx clipped."""
    i = torch.clamp(idx, 0, a.shape[-1] - 1).long()
    return a.gather(-1, i[:, None])[:, 0]


def _first_axis(sel: torch.Tensor) -> torch.Tensor:
    """``sel [B, 3]`` with only each row's first True kept: the axis a
    wall-crossing tie advances (the reference's ``cumsum(sel) == 1``;
    torch's scan over a last axis of 3 took 0.2 ms a call at 32,768 rows
    on the card, an ``argmax`` takes a reduction's time)."""
    first = torch.argmax(sel.to(torch.uint8), dim=-1, keepdim=True)
    return sel & (torch.arange(3, device=sel.device) == first)


def _wall_streams(pos, direction, cellf, grid):
    """Distance to the next wall along each axis and the per-axis wall
    spacing, for a lane at ``pos`` in cell ``cellf``."""
    dv = grid.voxel_size
    pc = pos + grid.half_extent
    safe = torch.where(direction == 0.0, 1.0, direction)
    t_up = ((cellf + 1.0) * dv - pc) / safe
    t_dn = (cellf * dv - pc) / safe
    t0 = torch.where(direction > 0.0, t_up,
                     torch.where(direction < 0.0, t_dn, _BIG))
    t0 = torch.clamp(t0, min=0.0)  # on-wall round-off
    dt = torch.where(direction == 0.0, _BIG, dv / torch.abs(safe))
    return t0, dt


def _finite(t: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(t), t, 0.0)


def _fresnel_score(dirn, nvec, n1, n2, i1, i2, dd, ri, refl):
    """d log P(reflect | transmit) / d n_p at a Fresnel branch: the
    coefficient's forward-mode derivative along the direction tangent
    ``dd`` and the indicators ``i1``, ``i2`` of which side is layer ``p``
    (the total derivative, its angular term included)."""
    dri = torch.func.jvp(lambda dv, a, b: fresnel_coeff(dv, nvec, a, b),
                         (dirn, n1, n2), (dd, i1, i2))[1]
    return torch.where(refl, dri / torch.clamp(ri, min=1e-9),
                       -dri / torch.clamp(1.0 - ri, min=1e-9))


def _extinction_score(inside, kappa, kappa_new, dirn, nvec, cross, refl):
    """d log p / dR of moving layer ``p``'s surface outward by dR: a
    crossing re-assigns dR / |cos| of path across the interface, a
    reflection 2 dR / |cos| (``inside``: the photon is in layer ``p``)."""
    costh = torch.clamp(torch.abs(torch.sum(dirn * nvec, dim=-1)), min=1e-3)
    k_in = torch.where(inside, kappa, kappa_new)
    k_out = torch.where(inside, kappa_new, kappa)
    s_refl = torch.where(inside, -2.0, 2.0) * kappa / costh
    return (torch.where(cross, (k_out - k_in) / costh, 0.0)
            + torch.where(refl, s_refl, 0.0))


def _refract_tangent(dirn, nvec, n1, n2, i1, i2, dd):
    """The direction tangent through a refraction: Snell's rotation of
    ``dd`` plus the bend from d eta / d n_p, eta = n1 / n2."""
    n2s = torch.where(n2 > 0.0, n2, 1.0)
    eta = n1 / n2s
    eta_dot = (i1 * n2s - n1 * i2) / (n2s * n2s)
    return _finite(torch.func.jvp(lambda dv, e: refract(dv, nvec, e),
                                  (dirn, eta), (dd, eta_dot))[1])


def _scatter_tangent(dirn, cost, phi, dd):
    """The direction tangent through an HG scatter: a frame rotation at
    fixed uniforms."""
    return _finite(torch.func.jvp(
        lambda dv: scatter_direction(dv, cost, phi), (dirn,), (dd,))[1])


def _pmc_rows(hitw, hitt, cnt, length, hg, fn, bn, in_new):
    """``[ndect, 6]`` sums over lanes of ``w * [1, cnt, len, hg, fn, bn]``
    for hit weights ``hitw [B, ndect]``; the path length counts the new
    segment up to the hit (``hitt``) where it runs in layer ``p``."""
    len_at_hit = length[:, None] + torch.where(in_new[:, None], hitt, 0.0)
    return torch.stack([hitw, hitw * cnt[:, None], hitw * len_at_hit,
                        hitw * hg[:, None], hitw * fn[:, None],
                        hitw * bn[:, None]], dim=-1).sum(dim=0)


def _flush_escape(tl, sid, hitw):
    """Add per-lane hit weights ``hitw [B, ndect]`` into
    ``escape_tot[sid, d]`` with one deposit."""
    ndect = hitw.shape[1]
    flat = (sid[:, None] * ndect + torch.arange(
        ndect, dtype=torch.int32, device=sid.device)).to(torch.int32)
    deposit_add_(tl.escape_tot.view(-1), flat.reshape(-1),
                 hitw.reshape(-1))


def _layer_of_concat(scene, device) -> torch.Tensor:
    """Layer id of each prim in concatenated-group order (the order of the
    surface index ``seg_prim``)."""
    user_of_concat = [0] * scene.n_prims
    for u, c in enumerate(scene.perm):
        user_of_concat[c] = u
    return torch.as_tensor([scene.layer_ids[user_of_concat[c]]
                            for c in range(scene.n_prims)],
                           dtype=torch.int32, device=device)


def _device_const(value, dtype, dev) -> torch.Tensor:
    """``value`` (a tuple of numbers) as a ``dtype`` tensor on ``dev``,
    made once: a copy from the host waits for the card."""
    key = (value, dtype, dev)
    t = _consts.get(key)
    if t is None:
        t = _consts[key] = torch.as_tensor(value, dtype=dtype, device=dev)
    return t


_consts: dict = {}


def _segment_probe(scene, pos, dirn, tau_dist, avail_cap, land_eps, eps,
                   ana_mask, march_iters):
    """Bound of the next straight flight segment from ``pos`` along
    ``dirn``: the analytic raycast over the closed-form prims merged with
    a capped sphere-trace march over the rest (the reference's inner loop,
    inttau2.f90:155-192, vectorised and budgeted).

    Returns ``(rem, interact, srf, cont, hidx)``: the segment length
    (>= 0, capped at ``avail_cap``); whether it ends at the optical-depth
    distance ``tau_dist``; whether it ends ~eps before a surface whose
    concat-order prim index is ``hidx`` (analytic hit or marched landing);
    whether the march budget ran out mid-flight (a continuation: the
    caller re-anchors and probes again, no physics event).  All-analytic
    scenes take the closed-form path."""
    B = pos.shape[0]
    dev = pos.device
    zerosb = torch.zeros((B,), dtype=torch.bool, device=dev)
    if all(ana_mask):
        t_ana, hidx = raycast.ray_bound_idx(scene, pos, dirn)
        fin = torch.isfinite(t_ana)
        avail = torch.where(fin, t_ana - land_eps, torch.inf)
        rem = torch.clamp(torch.minimum(tau_dist, avail), max=avail_cap)
        rem = torch.clamp(rem, min=0.0)
        interact = (tau_dist <= avail) & torch.isfinite(tau_dist)
        srf = ~interact & (avail <= avail_cap) & fin
        return rem, interact, srf, zerosb, hidx

    if any(ana_mask):
        t_ana, hidx_ana = raycast.ray_bound_idx(scene, pos, dirn)
        avail_ana = torch.where(torch.isfinite(t_ana), t_ana - land_eps,
                                torch.inf)
    else:
        avail_ana = torch.full((B,), torch.inf, dtype=pos.dtype, device=dev)
        hidx_ana = torch.zeros((B,), dtype=torch.int32, device=dev)
    na_cols, na_concat = scene.march_cols
    bound = torch.clamp(avail_ana, max=avail_cap)

    s = torch.zeros((B,), dtype=pos.dtype, device=dev)
    hit_tau = zerosb
    moving = ~zerosb
    d_cur = torch.zeros_like(s)
    na_min = torch.full_like(s, torch.inf)
    na_arg = torch.zeros((B,), dtype=torch.long, device=dev)
    # each iteration evaluates THEN advances, so every advance is
    # certified by an evaluation at its start point (an uncertified extra
    # step overshoots surfaces); a lane still moving after the budget is a
    # continuation
    for _ in range(max(march_iters, 1)):
        ds = eval_scene(scene, pos + s[:, None] * dirn)
        dmin, darg = torch.min(torch.abs(ds.index_select(-1, na_cols)),
                               dim=-1)
        na_min = torch.where(moving, dmin, na_min)
        na_arg = torch.where(moving, darg, na_arg)
        d_step = torch.where(moving, torch.minimum(dmin, bound - s), d_cur)
        d_cur = d_step
        ht = moving & (s + d_step >= tau_dist)
        s = torch.where(ht, tau_dist, torch.where(moving, s + d_step, s))
        hit_tau = hit_tau | ht
        moving = moving & ~ht & (d_step >= eps)
    cont = moving
    # stopped: landed near a non-analytic surface, reached the analytic
    # bound, or reached the cap
    stopped = ~hit_tau & ~cont
    land_na = stopped & (na_min < 2.0 * eps)
    srf_ana = (stopped & ~land_na & torch.isfinite(avail_ana)
               & (avail_ana - s <= 2.0 * eps))
    hidx = torch.where(land_na, na_concat[na_arg], hidx_ana)
    rem = torch.clamp(torch.clamp(s, max=avail_cap), min=0.0)
    return rem, hit_tau, land_na | srf_ana, cont, hidx


def _autograd_input(scene, tables, live: list) -> bool:
    """Whether, under grad mode, an input in ``live`` or a parameter of
    ``scene`` or ``tables`` requires a gradient."""
    if not torch.is_grad_enabled():
        return False
    params = []
    _tensors((tables, scene.tables, scene.group_params), params)
    return any(t.requires_grad for t in live + params)


def _fused_engages(scene, cfg: TransportConfig, tables, live: list) -> bool:
    """Whether the chained walk runs as the hand-written kernel, from what
    its input shows (``live``: the walk's input tensors): on a card, in
    float32, on a scene of spheres and boxes alone with one optical table
    (no wavelengths), with no pMC (``inverse_prim``), escape function or
    scatter moments, and no autograd input.  The kernel implements that
    closed set of prim kinds and options; everything else walks in
    PyTorch (:func:`_torch_rounds`).  Nothing else makes this choice."""
    if live[0].device.type != "cuda":
        return False
    if (cfg.inverse_prim > 0 or cfg.escape_shape[0] > 0
            or cfg.record_moments):
        return False
    if tables.wavelengths is not None or not walk_kernel.closed_form(scene):
        return False
    if tables.kappa.dtype != torch.float32 or any(
            t.dtype == torch.float64 for t in live):
        return False
    return not _autograd_input(scene, tables, live)


def _fused_walk(scene, grid, cfg: TransportConfig, uc, pos, direction,
                weight, tau, seg_rem, seg_interact, seg_srf, seg_cont,
                seg_prim, layer, alive, steps, bounces, wavelength, phase,
                tables, land_eps, seg_cap, mom_pos, mom_pos2, bank=None,
                respawn=None, pmc=None):
    """:func:`_torch_rounds` as one launch of the walk kernel
    (:mod:`~rsmcrt_tpu_torch.transport.walk_kernel`; on CPU tensors its CPU
    twin, which only tests call).  A detector bank tests the rounds' new
    segments once, all ``B * K`` rows in one :func:`check_bins`, and adds
    them with one :func:`flush_bins`: the same rows as the per-round tests,
    summed in another order.  Returns :func:`_torch_rounds`' dict."""
    dtype = pos.dtype
    _, _, delta_cross = _scalars(cfg, dtype)
    lanes = dict(pos=pos, direction=direction, weight=weight, tau=tau,
                 seg_rem=seg_rem, seg_interact=seg_interact, seg_srf=seg_srf,
                 seg_cont=seg_cont, seg_prim=seg_prim, layer=layer,
                 alive=alive, steps=steps, bounces=bounces,
                 wavelength=wavelength, phase=phase)
    out = walk_kernel.walk(
        scene, grid, cfg, land_eps, seg_cap, delta_cross,
        as_dtype(THRESHOLD, dtype), as_dtype(CHANCE, dtype), uc, lanes,
        respawn, rows=bank is not None)
    rows = out.pop("rows")
    if bank is not None:
        r_pos, r_dir, r_len, r_w = rows
        fams = check_bins(bank, r_pos.reshape(-1, 3), r_dir.reshape(-1, 3),
                          r_len.reshape(-1), r_w.reshape(-1))
        if fams:
            bank = flush_bins(bank, {fam: row[:2]
                                     for fam, row in fams.items()})
    out.update(mom_pos=mom_pos, mom_pos2=mom_pos2, bank=bank, hit_acc=None,
               pmc=None)
    return out


def _torch_rounds(scene, grid, cfg: TransportConfig, uc, pos, direction,
                  weight, tau, seg_rem, seg_interact, seg_srf, seg_cont,
                  seg_prim, layer, alive, steps, bounces, wavelength, phase,
                  tables, land_eps, seg_cap, mom_pos, mom_pos2,
                  bank=None, respawn=None, pmc=None):
    """The chained walk's K rounds in PyTorch: every scene, option and
    device (the kernel's closed set on a card goes to :func:`_fused_walk`).

    With the fluence estimator on, each of the K rounds deposits the
    interval up to the lane's next voxel wall or segment end; without it
    (the reference without -Dpathlength, inttau2.f90:446-462) every round
    jumps a whole segment, and a lane dies where the segment's end leaves
    the grid.  A lane whose segment ends consumes the event in place (HG
    scatter + fresh tau, absorption, or the surface normal, eps-nudge
    probe and stochastic Fresnel branch) and re-anchors its wall-crossing
    streams via the analytic raycast.  A lane whose photon dies relaunches
    its precomputed source candidate (``respawn``) while its absorption
    record slots and the photon budget allow.  Voxels are tracked
    incrementally (the crossing axis steps the integer cell).  A detector
    ``bank`` tests each new segment (``check_bins``); its bins are added
    once after the loop (``flush_bins``).  With survival bias every
    interaction deposits ``w (1 - albedo)`` (one ``[B, K]`` list) and
    plays roulette below ``THRESHOLD`` (kernelsMod.f90:2036-2066);
    otherwise an absorption ends the photon and fills one of its lane's
    absorption record slots.  An escape run adds each lane's hit weights
    into ``hit_acc [B, ndect]``; with ``inverse_prim`` the six ``pmc``
    lane fields update per event and each new segment's hits add their
    statistics rows into ``pmc_stats``.
    """
    dtype = pos.dtype
    dev = pos.device
    B = pos.shape[0]
    K = cfg.dda_substeps
    half = grid.half_extent
    dv = grid.voxel_size
    counts = grid.n_counts
    eps, _, delta_cross = _scalars(cfg, dtype)
    fluence = cfg.record_fluence
    ana_mask = raycast.analytic_column_mask(scene)

    walking = alive & (seg_rem > 0.0)
    p0 = pos
    dirc = direction
    rem = torch.where(walking, seg_rem, 0.0)
    seg_int, srf_f, cont_f, prim_l = seg_interact, seg_srf, seg_cont, seg_prim
    layer_l, w_l, bounces_l = layer, weight, bounces
    wavelength_l, phase_l = wavelength, phase
    if fluence:
        cellf = torch.floor((p0 + half) / dv)
        cell = cellf.to(torch.int32)  # [B, 3]
        t_next, dt_ax = _wall_streams(p0, dirc, cellf, grid)
    else:
        # no voxel intervals: the next "wall" is never reached
        t_next = torch.full((B, 3), _BIG, dtype=dtype, device=dev)
    s_prev = torch.zeros((B,), dtype=dtype, device=dev)

    died = torch.zeros((B,), dtype=torch.bool, device=dev)
    # analog absorption record slots: a lane hosts at most
    # chain_respawns + 1 photons per megastep and each absorbs at most
    # once; respawn is blocked once every slot is used
    n_slots = cfg.chain_respawns + 1
    survival = cfg.survival_bias
    thr, ch = as_dtype(THRESHOLD, dtype), as_dtype(CHANCE, dtype)
    ab_flats, ab_vals = [], []  # survival bias: one pair a round
    absorb_ws = [torch.zeros((B,), dtype=dtype, device=dev)
                 for _ in range(n_slots)]
    absorb_fls = [torch.zeros((B,), dtype=torch.int32, device=dev)
                  for _ in range(n_slots)]
    n_ab = torch.zeros((B,), dtype=torch.int32, device=dev)
    n_scat = torch.zeros((), dtype=torch.int32, device=dev)
    n_inter = torch.zeros((), dtype=torch.int32, device=dev)
    n_resp = torch.zeros((), dtype=torch.int32, device=dev)
    cand_k = torch.zeros((B,), dtype=torch.int32, device=dev)
    steps_l, tau_l = steps, tau
    flats, vals = [], []
    # per-round detector (bin, weight) candidates, flushed after the loop
    # (one test per straight segment, inttau2.f90:195-200; the analysis
    # phase's segments were tested by record_hits)
    dect_acc = {}
    # current-layer optical properties, one lookup of [B, 4] per round
    opt_pack = torch.stack(
        [tables.kappa, tables.albedo, tables.hgg, tables.n], dim=-1)
    lanes = torch.arange(B, device=dev)
    inv = cfg.inverse_prim
    if inv > 0:
        pm_cnt, pm_len, pm_hg, pm_fn, pm_bn, pm_dd = pmc
        pmc_stats = torch.zeros((len(bank.order), 6), dtype=dtype,
                                device=dev)
        layer_of_concat = _layer_of_concat(scene, dev)
    # escape functions: per-lane hit weights over the rounds (sid is
    # constant through the walk: no in-chain respawn)
    hit_acc = (torch.zeros((B, len(bank.order)), dtype=dtype, device=dev)
               if cfg.escape_shape[0] > 0 else None)

    for r in range(K):
        c = torch.amin(t_next, dim=-1)  # [B] next wall along the segment
        ends = rem <= c
        hi = torch.where(ends, rem, c)
        length = torch.clamp(hi - s_prev, min=0.0)
        if fluence:
            valid = torch.all((cell >= 0) & (cell < counts), dim=-1)
            safe = torch.minimum(torch.clamp(cell, min=0), counts - 1)
            flat = ((safe[:, 0] * grid.nyg + safe[:, 1]) * grid.nzg
                    + safe[:, 2])
            # interval outside the grid: the photon dies at the grid wall
            # (reference update_grids tflag, inttau2.f90:437-440)
            exit_now = walking & ~valid & (length > 0.0)
        else:
            # endpoint validity, like the plain fluenceless jump
            flat, valid = voxel_flat_index(
                grid, get_voxel(grid, p0 + rem[:, None] * dirc))
            exit_now = walking & ~valid
        died = died | exit_now
        base = walking & ~exit_now

        ends_b = base & ends
        inter = ends_b & seg_int
        not_int = ends_b & ~seg_int
        srf = not_int & srf_f
        cont_ev = not_int & cont_f & ~srf_f
        plainx = not_int & ~srf_f & ~cont_f
        u_r = uc[:, r, :]
        p_end = p0 + rem[:, None] * dirc
        w_dep = w_l  # weight before any roulette reweight this round

        o_cur = _opt_lookup(tables, opt_pack, layer_l, wavelength_l)
        kappa_l, albedo_l, g_l, n1 = (o_cur[:, 0], o_cur[:, 1], o_cur[:, 2],
                                      o_cur[:, 3])

        # --- interaction events --------------------------------------------
        if not survival:
            # analog scatter-or-die; at most one absorption per hosted
            # photon, so one record slot each
            do_sc = inter & (u_r[:, 0] < albedo_l)
            do_ab = inter & ~do_sc
            ab_ok = do_ab & valid
            for s in range(n_slots):
                m = ab_ok & (n_ab == s)
                absorb_ws[s] = torch.where(m, w_l, absorb_ws[s])
                absorb_fls[s] = torch.where(m, flat, absorb_fls[s])
            n_ab = n_ab + ab_ok.to(torch.int32)
        else:
            w_abs = torch.where(inter, w_l * (1.0 - albedo_l), 0.0)
            w_l = w_l - w_abs
            ab_flats.append(flat)
            ab_vals.append(torch.where(valid, w_abs, 0.0))
            roul = inter & (w_l < thr)
            surv = roul & (u_r[:, 0] < ch)
            w_l = torch.where(surv, w_l / ch, w_l)
            do_ab = roul & ~surv
            do_sc = inter & ~do_ab
        died = died | do_ab

        # --- surface events: nudge-across probe + Fresnel branch ----------
        nvec = raycast.surface_normal(scene, p_end, prim_l)
        probe = p_end + delta_cross * dirc
        new_layer = scene_layer(eval_scene(scene, probe))
        outside = srf & (new_layer == 0)
        samel = srf & (new_layer == layer_l)
        crossing = srf & (new_layer != layer_l) & (new_layer != 0)
        n2 = _opt_lookup(tables, tables.n, new_layer, wavelength_l)
        needf = crossing & (n1 != n2)
        ri = fresnel_coeff(dirc, nvec, n1, n2)
        refl = needf & (u_r[:, 0] <= ri)
        trans = (crossing & ~refl) | samel

        bounces2 = bounces_l + refl.to(torch.int32)
        overb = refl & (bounces2 > cfg.max_bounces)
        srf_die = outside | overb
        if cfg.roulette_bounces > 0:
            chance = as_dtype(cfg.roulette_chance, dtype)
            trapped = refl & (bounces2 > cfg.roulette_bounces)
            survive = trapped & (u_r[:, 1] < chance)
            w_l = torch.where(survive, w_l / chance, w_l)
            srf_die = srf_die | (trapped & ~survive)
        srf_cont = srf & ~srf_die
        died = died | srf_die
        bounces_l = torch.where(refl, bounces2, bounces_l)

        if inv > 0:
            # the Fresnel-choice and boundary-extinction scores of this
            # round's surface events (reference engine.py:705-753)
            i1 = (layer_l == inv).to(dtype)
            i2 = (new_layer == inv).to(dtype)
            # (every Fresnel branch reflects or transmits)
            s_ch = _fresnel_score(dirc, nvec, n1, n2, i1, i2, pm_dd, ri, refl)
            pm_fn = pm_fn + torch.where(needf, s_ch, 0.0)
            inv_srf = srf & (layer_of_concat[prim_l.long()] == inv)
            kappa_new = _opt_lookup(tables, tables.kappa, new_layer,
                                    wavelength_l)
            pm_bn = pm_bn + _extinction_score(
                layer_l == inv, kappa_l, kappa_new, dirc, nvec,
                inv_srf & crossing & ~refl, inv_srf & refl)

        # --- deposits: the interval plus, for transmitting lanes, the
        # crossing nudge (inttau2.f90:75-146) ------------------------------
        dep_len = length + torch.where(trans, delta_cross, 0.0)
        if fluence:
            flats.append(flat)
            vals.append(torch.where(walking & valid, dep_len * w_dep, 0.0))
        phase_l = phase_l + torch.where(walking, dep_len, 0.0)

        # --- continuation: scatter + surviving surface lanes --------------
        cost = sample_hg_cost(u_r[:, 1], g_l)
        phi = TWOPI * u_r[:, 2]
        ndir_sc = scatter_direction(dirc, cost, phi)
        dir_refl = reflect(dirc, nvec)
        eta = n1 / torch.where(n2 > 0.0, n2, 1.0)
        dir_refr = refract(dirc, nvec, eta)
        do_refr = crossing & ~refl & needf
        np_dir = torch.where(
            do_sc[:, None], ndir_sc,
            torch.where(refl[:, None], dir_refl,
                        torch.where(do_refr[:, None], dir_refr, dirc)))
        if inv > 0:
            # the direction tangent through this round's event
            dd_new = torch.where(
                do_sc[:, None], _scatter_tangent(dirc, cost, phi, pm_dd),
                torch.where(refl[:, None], reflect(pm_dd, nvec),
                            torch.where(do_refr[:, None], _refract_tangent(
                                dirc, nvec, n1, n2, i1, i2, pm_dd), pm_dd)))
        np_pos = torch.where(trans[:, None], probe, p_end)
        nlayer = torch.where(crossing & ~refl, new_layer, layer_l)

        # --- in-chain respawn: a lane that died this megastep relaunches
        # its next source candidate in place ------------------------------
        resp = torch.zeros((B,), dtype=torch.bool, device=dev)
        if respawn is not None:
            (rc_pos, rc_dir, rc_tau, rc_layer, rc_phase, rc_wl, rc_good,
             rc_allow) = respawn
            C = rc_good.shape[0]
            k = torch.clamp(cand_k, max=C - 1).long()
            resp_try = died & rc_allow[k, lanes] & (cand_k < C)
            if not survival:
                resp_try = resp_try & (n_ab < n_slots)
            resp = resp_try & rc_good[k, lanes]
            cand_k = cand_k + resp_try.to(torch.int32)
            died = died & ~resp
            n_resp = n_resp + torch.sum(resp_try, dtype=torch.int32)
            rm = resp[:, None]
            np_dir = torch.where(rm, rc_dir[k, lanes], np_dir)
            np_pos = torch.where(rm, rc_pos[k, lanes], np_pos)
            nlayer = torch.where(resp, rc_layer[k, lanes], nlayer)
            w_l = torch.where(resp, 1.0, w_l)
            bounces_l = torch.where(resp, 0, bounces_l)
            steps_l = torch.where(resp, 0, steps_l)
            wavelength_l = torch.where(resp, rc_wl[k, lanes], wavelength_l)
            phase_l = torch.where(resp, rc_phase[k, lanes], phase_l)
            if inv > 0:
                pm_cnt, pm_len, pm_hg, pm_fn, pm_bn = (
                    torch.where(resp, 0.0, x)
                    for x in (pm_cnt, pm_len, pm_hg, pm_fn, pm_bn))
                dd_new = torch.where(rm, 0.0, dd_new)

        newtau = -torch.log(u_r[:, 3])
        # the crossing nudge is charged at the NEW medium's kappa
        kappa2 = _opt_lookup(tables, tables.kappa, nlayer, wavelength_l)
        tau_ev = torch.where(
            do_sc, newtau,
            torch.where(trans,
                        torch.clamp(tau_l - delta_cross * kappa2, min=0.0),
                        tau_l))
        if respawn is not None:
            tau_ev = torch.where(resp, rc_tau[k, lanes], tau_ev)
        tau_dist2 = torch.where(
            kappa2 > 0.0, tau_ev / torch.clamp(kappa2, min=1e-12),
            torch.inf)
        rem2, int2, srf2, cont2, hidx = _segment_probe(
            scene, np_pos, np_dir, tau_dist2, seg_cap, land_eps, eps,
            ana_mask, cfg.chain_march_iters)
        tau2 = torch.clamp(tau_ev - rem2 * kappa2, min=0.0)
        steps2 = steps_l + do_sc.to(torch.int32)

        if cfg.record_moments:
            order = torch.where(do_sc, steps2, 0)  # 1..4 of interest
            oh = (order[:, None] - 1 == torch.arange(4, device=dev)).to(
                dtype)
            mom_pos = mom_pos + oh.T @ p_end
            mom_pos2 = mom_pos2 + oh.T @ (p_end * p_end)

        n_scat = n_scat + torch.sum(do_sc, dtype=torch.int32)
        n_inter = n_inter + torch.sum(inter, dtype=torch.int32)

        over = torch.zeros_like(do_sc)
        if cfg.max_scatter_order > 0:
            # the scatter is recorded but the lane stops
            # (reference test_kernel end_early, kernelsMod.f90:2161-2163)
            over = do_sc & (steps2 > cfg.max_scatter_order)
            died = died | over

        ev = ((do_sc | srf_cont | cont_ev) & ~over) | resp
        evm = ev[:, None]
        if inv > 0:
            # a scatter counts BEFORE the new segment's hit test, as in
            # the analysis phase
            sc_in = do_sc & (layer_l == inv)
            pm_cnt = pm_cnt + sc_in.to(dtype)
            pm_hg = pm_hg + torch.where(sc_in, hg_logpdf_dg(cost, g_l), 0.0)
        if bank is not None:
            # test each NEW segment against every detector at creation
            fams = check_bins(bank, np_pos, np_dir,
                              torch.where(ev, rem2, 0.0),
                              torch.where(ev, w_l, 0.0), want_t=inv > 0)
            for fam, row in fams.items():
                acc = dect_acc.setdefault(fam, ([], []))
                acc[0].append(row[0])
                acc[1].append(row[1])
            if hit_acc is not None:
                hit_acc = hit_acc + ordered_cols(bank, fams, 1)
            if inv > 0:
                pmc_stats = pmc_stats + _pmc_rows(
                    ordered_cols(bank, fams, 1), ordered_cols(bank, fams, 2),
                    pm_cnt, pm_len, pm_hg, pm_fn, pm_bn, nlayer == inv)
        if inv > 0:
            # the new segment's length counts AFTER its hit test
            pm_len = pm_len + torch.where(ev & (nlayer == inv), rem2, 0.0)
            pm_dd = torch.where(evm, dd_new, pm_dd)
        dirc = torch.where(evm, np_dir, dirc)
        p0 = torch.where(evm, np_pos, p0)
        if fluence:
            # re-anchor the wall-crossing streams at the event point (the
            # tracked cell stays authoritative; a respawned lane
            # teleports, so its cell is recomputed from the candidate
            # position)
            cellf2 = cell.to(dtype)
            if respawn is not None:
                cellf2 = torch.where(rm, torch.floor((np_pos + half) / dv),
                                     cellf2)
                cell = torch.where(rm, cellf2.to(torch.int32), cell)
            t02, dt2 = _wall_streams(np_pos, np_dir, cellf2, grid)
            t_next = torch.where(evm, t02, t_next)
            dt_ax = torch.where(evm, dt2, dt_ax)
        rem = torch.where(ev, rem2, rem)
        seg_int = torch.where(ev, int2, seg_int)
        srf_f = torch.where(ev, srf2, srf_f)
        cont_f = torch.where(ev, cont2, cont_f)
        prim_l = torch.where(ev, hidx, prim_l)
        layer_l = torch.where(ev, nlayer, layer_l)
        tau_l = torch.where(ev, tau2, tau_l)
        steps_l = torch.where(do_sc, steps2, steps_l)
        s_prev = torch.where(ev, 0.0, s_prev)

        fin = (plainx | do_ab | over | srf_die) & ~resp
        s_prev = torch.where(fin, rem, s_prev)
        walking = (base & (~ends | ev)) | resp

        if fluence:
            # wall crossing for lanes whose segment continues past it
            # (respawned lanes start their new stream next round)
            adv = walking & ~ends & ~resp
            selm = (t_next == c[:, None]) & adv[:, None]
            am = _first_axis(selm)
            stepdir = torch.where(dirc > 0.0, 1, -1).to(torch.int32)
            cell = cell + torch.where(am, stepdir, 0)
            t_next = torch.clamp(t_next + torch.where(am, dt_ax, 0.0),
                                 max=_BIG)
            s_prev = torch.where(adv, c, s_prev)

    if dect_acc:
        bank = flush_bins(bank, {fam: (torch.cat(ix), torch.cat(w))
                                 for fam, (ix, w) in dect_acc.items()})
    pos_new = p0 + s_prev[:, None] * dirc
    seg_rem_new = torch.clamp(rem - s_prev, min=0.0)
    alive_new = alive & ~died
    return dict(
        pos=pos_new, dir=dirc, weight=w_l, tau=tau_l, seg_rem=seg_rem_new,
        seg_interact=seg_int, seg_srf=srf_f, seg_cont=cont_f,
        seg_prim=prim_l, layer=layer_l, alive=alive_new, steps=steps_l,
        bounces=bounces_l, wavelength=wavelength_l, phase=phase_l,
        n_resp=n_resp,
        flat_k=torch.stack(flats, dim=-1) if fluence else None,
        deps_k=torch.stack(vals, dim=-1) if fluence else None,
        # survival bias: [B, K] per-round deposits; analog: [B, slots]
        absorb_w=torch.stack(ab_vals if survival else absorb_ws, dim=-1),
        absorb_flat=torch.stack(ab_flats if survival else absorb_fls,
                                dim=-1), n_scat=n_scat,
        n_inter=n_inter, mom_pos=mom_pos, mom_pos2=mom_pos2, cand_k=cand_k,
        bank=bank, hit_acc=hit_acc,
        pmc=((pm_cnt, pm_len, pm_hg, pm_fn, pm_bn, pm_dd, pmc_stats)
             if inv > 0 else None))


# ---------------------------------------------------------------------------
# The chained walk's paths: the kernel, the rounds replayed from a CUDA
# graph, the rounds run eagerly
# ---------------------------------------------------------------------------

#: the chained walk's rounds in PyTorch, run eagerly, as
#: :func:`_chained_walk` and a walk graph's capture call them (through this
#: name, so that a wrapper on it sees every such walk)
_chained_dda = _torch_rounds

#: the most walk graphs kept, least recently used dropped first.  A run
#: replays one a width of its shrink ladder (two or three); a process that
#: builds many scenes, as the tests and ``chip_smoke.py`` do, keeps the
#: graphs of the last few.  At 32,768 lanes the rounds' pool measured
#: 72 MiB on omg and 156-158 MiB on the benchmark's sphere and slab with the
#: kernel turned off (H100), so 16 pools hold about 3% of an 80-GB card
WALK_GRAPHS_KEPT = 16
#: the captured walks, by :func:`_walk_key`
walk_graphs: collections.OrderedDict = collections.OrderedDict()
# set by :func:`warmup`: what it walks is set-up, not counted
_warming = False


def _tensors(tree, out: list):
    """Append the tensors of ``tree`` (nested tuples, lists, dicts and
    dataclasses) to ``out`` in a fixed order; returns the tree's structure,
    each tensor's shape, dtype and device in its place (hashable)."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_tensors(x, out) for x in tree))
    if isinstance(tree, dict):
        return (dict, tuple((k, _tensors(v, out)) for k, v in tree.items()))
    if dataclasses.is_dataclass(tree):
        return (type(tree), tuple((f.name, _tensors(getattr(tree, f.name),
                                                    out))
                                  for f in dataclasses.fields(tree) if f.init))
    return tree


def _rebuild(tree, tensors):
    """``tree`` with its tensors replaced, in :func:`_tensors`' order, by
    those the iterator ``tensors`` gives."""
    if isinstance(tree, torch.Tensor):
        return next(tensors)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(x, tensors) for x in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(v, tensors) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), tensors)
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _walk_key(scene, grid, cfg: TransportConfig, tables, land_eps, seg_cap,
              structure):
    """What a captured walk depends on: the scene, grid and tables (read by
    address), every transport option but the photon budget and the
    megastep cap (constants of the recorded kernels), and the
    ``structure`` of the walk's inputs (:func:`_tensors`: the lane width,
    the types, the device, the detector bank's families and bins, respawn
    candidates and pMC fields present or not).  Neither the photons of a
    job nor its seed is in it, so one capture serves every job of a run's
    scene and width."""
    return (id(scene), id(grid), id(tables),
            replace(cfg, nphotons=0, max_steps=0), land_eps, seg_cap,
            structure)


def _walk_path(scene, cfg: TransportConfig, tables, live: list) -> str:
    """Which path the chained walk takes, given its input tensors
    ``live``: ``"kernel"`` where :func:`_fused_engages`; ``"graph"``, the
    rounds in PyTorch replayed from a CUDA graph, elsewhere on a card with
    no pMC tangents (``inverse_prim``: ``torch.func`` through the walk) and
    no input or scene parameter in an autograd graph; ``"eager"``
    otherwise."""
    if _fused_engages(scene, cfg, tables, live):
        return "kernel"
    if (live[0].device.type == "cuda" and cfg.inverse_prim == 0
            and not _autograd_input(scene, scene.tables, live)):
        return "graph"
    return "eager"


class _WalkGraph:
    """One capture of :func:`_chained_dda`: the rounds recorded once on
    static copies of its inputs, then replayed.  A call copies the live
    inputs into the static ones, replays on the current stream and copies
    the outputs out into fresh tensors, so nothing it returns aliases a
    buffer the next replay overwrites; an output that is one of the inputs
    (a tally the walk leaves, a detector's geometry) is the live input."""

    def __init__(self, scene, grid, cfg, tables, land_eps, seg_cap,
                 walk_in, live):
        self.owners = (scene, grid, tables)
        dev = live[0].device
        self.static_in = [t.clone() for t in live]
        static = _rebuild(walk_in, iter(self.static_in))
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        reserved = torch.cuda.memory_reserved(dev)
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter_ns()
        with torch.cuda.stream(side):
            self.graph.capture_begin()
            try:
                out = _chained_dda(scene, grid, cfg, tables=tables,
                                   land_eps=land_eps, seg_cap=seg_cap,
                                   **static)
            except BaseException:
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass  # the walk's own error is the one to raise
                raise
            t1 = time.perf_counter_ns()
            self.graph.capture_end()
        t2 = time.perf_counter_ns()
        cur.wait_stream(side)
        self.out, self.static_out = out, []
        _tensors(out, self.static_out)
        index = {id(t): i for i, t in enumerate(self.static_in)}
        self.passed = [index.get(id(t)) for t in self.static_out]
        lanes = cfg.n_lanes
        obs.count_by("megastep.walk_record_ns", lanes, t1 - t0)
        obs.count_by("megastep.walk_instantiate_ns", lanes, t2 - t1)
        obs.count_by("megastep.walk_pool_bytes", lanes,
                     torch.cuda.memory_reserved(dev) - reserved)

    def owned_by(self, scene, grid, tables) -> bool:
        return all(a is b for a, b in zip(self.owners, (scene, grid, tables)))

    def __call__(self, live):
        for dst, src in zip(self.static_in, live):
            dst.copy_(src)
        self.graph.replay()
        return _rebuild(self.out, iter(
            t.clone() if i is None else live[i]
            for t, i in zip(self.static_out, self.passed)))


def _chained_walk(scene, grid, cfg: TransportConfig, tables, land_eps,
                  seg_cap, **walk_in):
    """The chained walk of one megastep (:func:`_torch_rounds`' arguments
    by name), by the path :func:`_walk_path` picks: ``kernel``, one launch
    of the hand-written kernel (:func:`_fused_walk`), counted in
    ``megastep.walk_fused``; ``graph``, the rounds replayed from the CUDA
    graph of its key (:func:`_walk_key`; captured at its first use), a
    capture counted in ``megastep.walk_captures`` and a replay in
    ``megastep.walk_replays``; ``eager``, :func:`_chained_dda`.  None
    counts inside :func:`warmup`, but every capture adds its recording and
    instantiation nanoseconds and the bytes its graph's pool reserved to
    ``megastep.walk_record_ns``, ``megastep.walk_instantiate_ns`` and
    ``megastep.walk_pool_bytes``, by lane width."""
    live = []
    structure = _tensors(walk_in, live)
    path = _walk_path(scene, cfg, tables, live)
    if path == "kernel":
        if not _warming:
            obs.count("megastep.walk_fused")
        return _fused_walk(scene, grid, cfg, tables=tables,
                           land_eps=land_eps, seg_cap=seg_cap, **walk_in)
    if path == "eager":
        return _chained_dda(scene, grid, cfg, tables=tables,
                            land_eps=land_eps, seg_cap=seg_cap, **walk_in)
    key = _walk_key(scene, grid, cfg, tables, land_eps, seg_cap, structure)
    g = walk_graphs.get(key)
    if g is not None and g.owned_by(scene, grid, tables):
        walk_graphs.move_to_end(key)
    else:
        g = walk_graphs[key] = _WalkGraph(scene, grid, cfg, tables, land_eps,
                                          seg_cap, walk_in, live)
        while len(walk_graphs) > WALK_GRAPHS_KEPT:
            walk_graphs.popitem(last=False)
        if not _warming:
            obs.count("megastep.walk_captures")
    out = g(live)
    if not _warming:
        obs.count("megastep.walk_replays")
    return out


def _plain_march(scene, pos, direction, ds, tau_dist, avail, interior, eps,
                 march_iters, seg_cap):
    """The plain walk's capped sphere-trace march over the non-analytic
    prims (reference package: engine.py:1391-1424): ``march_iters`` scene
    evaluations, each after an advance by the last certified distance,
    then a final advance that needs no evaluation (the next megastep's
    analysis evaluates there anyway).  Returns the segment length and
    whether it ends at the optical-depth distance."""
    na_cols = scene.march_cols[0]

    def d_na(ds_all):
        return torch.amin(torch.abs(ds_all.index_select(-1, na_cols)),
                          dim=-1)

    s = torch.zeros_like(tau_dist)
    d_cur = torch.minimum(d_na(ds), avail)
    moving = interior
    hit = torch.zeros_like(interior)
    for _ in range(march_iters):
        hit_tau = moving & (s + d_cur >= tau_dist)
        s = torch.where(hit_tau, tau_dist, torch.where(moving, s + d_cur, s))
        hit = hit | hit_tau
        moving = moving & ~hit_tau
        dm = torch.minimum(d_na(eval_scene(scene, pos + s[:, None]
                                           * direction)), avail - s)
        d_cur = torch.where(moving, dm, d_cur)
        moving = moving & (d_cur >= eps)
    hit_tau = moving & (s + d_cur >= tau_dist)
    s = torch.where(hit_tau, tau_dist, torch.where(moving, s + d_cur, s))
    return torch.clamp(s, max=seg_cap), hit | hit_tau


def _closed_form_dda(grid, K, pos, direction, walk, weight):
    """The plain walk's first ``K`` voxel intervals of the straight
    segment ``[0, walk]`` from ``pos`` (reference package:
    engine.py:1695-1755).  The walls each axis crosses form an arithmetic
    stream; ``K`` rounds of a three-way merge take the leading crossing
    and advance the first axis that holds it (a tie advances one axis a
    round, leaving a zero-length interval).  Each interval is attributed
    to the voxel of its midpoint.  Returns ``(flat_k, deps_k, lengths,
    valid_k, end)``: ``[B, K]`` voxel indices, deposits ``length *
    weight`` (0 outside the grid), interval lengths, their validity, and
    the distance walked."""
    B = pos.shape[0]
    cellf = torch.floor((pos + grid.half_extent) / grid.voxel_size)
    t_next, dt_ax = _wall_streams(pos, direction, cellf, grid)
    cuts = []
    for _ in range(K):
        c = torch.amin(t_next, dim=-1)
        sel = t_next == c[:, None]
        adv = _first_axis(sel)
        t_next = torch.clamp(t_next + torch.where(adv, dt_ax, 0.0), max=_BIG)
        cuts.append(c)
    cuts = torch.stack(cuts, dim=-1)  # [B, K] ascending
    cuts = torch.where(cuts < walk[:, None], cuts, _BIG)
    end = torch.minimum(torch.where(cuts[:, K - 1] < _BIG, cuts[:, K - 1],
                                    walk), walk)
    lo = torch.cat([torch.zeros((B, 1), dtype=pos.dtype, device=pos.device),
                    cuts[:, :K - 1]], dim=1)
    hi = torch.minimum(torch.where(cuts < _BIG, cuts, walk[:, None]),
                       walk[:, None])
    hi[:, K - 1] = end
    lengths = torch.clamp(hi - lo, min=0.0)
    mids = pos[:, None, :] + direction[:, None, :] * (0.5 * (lo + hi))[
        ..., None]
    flat_k, valid_k = voxel_flat_index(grid, get_voxel(grid, mids))
    deps_k = torch.where(valid_k, lengths * weight[:, None], 0.0)
    return flat_k, deps_k, lengths, valid_k, end


def _flush_tracks(tl, cfg, hitw, history, hist_n):
    """Copy the paths of lanes whose segment hit a detector into the next
    free track slots (reference: history%write on hit,
    detector_base.f90:158-160), in place; returns the new track count and
    loss counters.  Lanes past ``max_tracks`` are counted as overflow; a
    path longer than the ring counts its truncated events."""
    M, H = cfg.max_tracks, cfg.history_len
    hits_any = torch.any(hitw > 0.0, dim=-1)
    slot = tl.track_count + torch.cumsum(hits_any.to(torch.int32), dim=0,
                                         dtype=torch.int32) - 1
    ok = hits_any & (slot < M)
    # lanes with nothing to keep rewrite the last slot with the value it
    # ends up with, so that no write races a kept lane's
    last = ok & (slot == M - 1)
    last_val = torch.where(
        torch.any(last),
        torch.sum(torch.where(last[:, None, None], history, 0.0), dim=0),
        tl.tracks[M - 1])
    tl.tracks.index_put_(
        (torch.where(ok, slot, M - 1).long(),),
        torch.where(ok[:, None, None], history, last_val))
    raw = tl.track_count + torch.sum(hits_any, dtype=torch.int32)
    count = torch.clamp(raw, max=M)
    trunc = torch.sum(torch.where(hits_any, torch.clamp(hist_n - H, min=0),
                                  0), dtype=torch.int32)
    return count, tl.track_dropped + torch.stack([trunc, raw - count])


def transport_step(carry: SimCarry, scene: Scene, source: Source,
                   grid: CartGrid, generator: Optional[torch.Generator],
                   cfg: TransportConfig, nphotons=None,
                   draws: Optional[StepDraws] = None) -> SimCarry:
    """One megastep of the wavefront.  The voxel tallies (and the track
    slots) of ``carry`` are updated in place; the returned carry holds the
    new lane state.  ``draws`` injects the megastep's uniforms; otherwise
    they are drawn from ``generator``.  Its four phases are spans of
    :mod:`~rsmcrt_tpu_torch.obs`: ``megastep.analysis``,
    ``megastep.detectors``, ``megastep.walk``, ``megastep.interactions``."""
    obs_tok = obs.begin("megastep.analysis")
    cfg.check_ported()
    if nphotons is None:
        nphotons = cfg.nphotons
    st = carry.state
    tl = carry.tallies
    dtype = st.pos.dtype
    dev = st.pos.device
    B = st.pos.shape[0]
    tables = scene.tables
    eps, land_eps, _ = _scalars(cfg, dtype)
    seg_cap = _seg_cap(grid)
    chaining = cfg.chains(scene)
    n_src_u = n_source_uniforms(source)
    if draws is None:
        draws = draw_step(generator, B, cfg, source, dev, scene, dtype)
    u_src = draws.u_all[:, :n_src_u]
    u = draws.u_all[:, n_src_u:]

    # =================================================================
    # Phase 1: segment analysis (only lanes with no segment left)
    # =================================================================
    dead = ~st.alive
    budget = nphotons - carry.launched
    rank = torch.cumsum(dead.to(torch.int32), dim=0, dtype=torch.int32) - 1
    respawn = dead & (rank < budget)
    n_respawn = torch.minimum(torch.sum(dead, dtype=torch.int32), budget)

    qmc_shifts = carry.qmc_shifts
    if cfg.qmc_source and n_src_u > 0:
        # scrambled Halton keyed by the global photon index, one rotation
        # for the whole run
        if qmc_shifts is None:
            qmc_shifts = halton_shifts(n_src_u, generator, dev)
        u_src = halton_block(torch.clamp(carry.launched + rank, min=0),
                             n_src_u, qmc_shifts)

    sid = st.sid
    n_src = cfg.escape_shape[0]
    if n_src > 0:
        # photon index -> source voxel, an equal budget per voxel; the
        # source samples at the voxel of the photon each lane launches
        per_voxel = max(int(nphotons) // n_src, 1)
        sid_new = torch.clamp(torch.div(carry.launched + rank, per_voxel,
                                        rounding_mode="floor"),
                              0, n_src - 1).to(torch.int32)
        sid = torch.where(respawn, sid_new, sid)
        src_pos, src_dir, src_phase, src_wl = sample_source(
            source, grid, u_src, sid=sid_new)
    else:
        src_pos, src_dir, src_phase, src_wl = sample_source(source, grid,
                                                            u_src)
    r = respawn[:, None]
    pos = torch.where(r, src_pos, st.pos)
    direction = torch.where(r, src_dir, st.dir)
    weight = torch.where(respawn, 1.0, st.weight)
    tau = torch.where(respawn, -torch.log(u[:, _U_TAU0]), st.tau)
    bounces = torch.where(respawn, 0, st.bounces)
    steps = torch.where(respawn, 0, st.steps)
    phase = torch.where(respawn, src_phase, st.phase)
    wavelength = torch.where(respawn, src_wl, st.wavelength)
    seg_rem = torch.where(respawn, 0.0, st.seg_rem)
    seg_interact = st.seg_interact & ~respawn
    seg_srf = st.seg_srf & ~respawn
    seg_cont = st.seg_cont & ~respawn
    seg_prim = torch.where(respawn, 0, st.seg_prim)
    alive = st.alive | respawn
    launched = carry.launched + n_respawn
    inv = cfg.inverse_prim
    if inv > 0:
        pmc_cnt, pmc_len, pmc_hg, pmc_fn, pmc_bn = (
            torch.where(respawn, 0.0, x)
            for x in (st.pmc_cnt, st.pmc_len, st.pmc_hg, st.pmc_fn,
                      st.pmc_bn))
        pmc_dd = torch.where(r, 0.0, st.pmc_dd)
    else:
        pmc_cnt, pmc_len, pmc_hg, pmc_fn, pmc_bn, pmc_dd = (
            st.pmc_cnt, st.pmc_len, st.pmc_hg, st.pmc_fn, st.pmc_bn,
            st.pmc_dd)

    history, hist_n = st.history, st.hist_n
    if cfg.history_len > 0:
        # the ring starts with the launch position (reference pushes at
        # emission, kernelsMod.f90:1954); written in place on a copy
        history = history.clone()
        entry = torch.cat([pos, torch.zeros((B, 1), dtype=dtype,
                                            device=dev)], dim=-1)
        history[:, 0] = torch.where(r, entry, history[:, 0])
        hist_n = torch.where(respawn, 1, hist_n)

    # photons emitted outside the grid die immediately
    vox, vox_valid = voxel_flat_index(grid, get_voxel(grid, pos))
    alive = alive & (~respawn | vox_valid)
    if cfg.record_emission:
        deposit_add_(tl.emission, vox,
                     (respawn & vox_valid).to(dtype))

    need_seg = alive & (seg_rem <= 0.0)

    # --- evaluate the scene ------------------------------------------
    ds = eval_scene(scene, pos)  # [B, N]
    d_sdf = torch.amin(torch.abs(ds), dim=-1)
    min_ds = torch.amin(ds, dim=-1)
    layer = torch.where(respawn, scene_layer(ds), st.layer)
    # emitted outside every SDF -> dead (inttau2:143-145)
    alive = alive & (~respawn | (layer > 0))
    need_seg = need_seg & alive

    kappa = _opt_lookup(tables, tables.kappa, layer, wavelength)
    tau_dist = torch.where(kappa > 0.0, tau / torch.clamp(kappa, min=1e-12),
                           torch.inf)

    on_boundary = need_seg & (d_sdf < eps)
    interior = need_seg & (d_sdf >= eps)
    # lane outside everything: die without moving (inttau2:188-191)
    escaped = interior & (min_ds > 0.0)
    interior = interior & ~escaped

    # --- boundary analysis (inttau2.f90:73-146, 209-337): one stacked
    # 5-point eval (nudge probe + 4 tetrahedron normal taps) ----------
    smallstep = d_sdf + 2.0 * eps
    p2 = pos + smallstep[:, None] * direction
    tet = _device_const(_TET, dtype, dev)
    pts5 = torch.cat([p2[:, None, :], pos[:, None, :] + tet * (10.0 * eps)],
                     dim=1)  # [B, 5, 3]
    ev5 = eval_scene(scene, pts5)  # [B, 5, N]
    ds2 = ev5[:, 0, :]
    new_layer = scene_layer(ds2)
    outside_after = on_boundary & (new_layer == 0)
    same = on_boundary & (new_layer == layer)
    crossing = on_boundary & (new_layer != layer) & (new_layer != 0)

    n1 = _opt_lookup(tables, tables.n, layer, wavelength)
    n2 = _opt_lookup(tables, tables.n, new_layer, wavelength)
    need_fresnel = crossing & (n1 != n2)

    # which prim's surface was crossed (inttau2.f90:251-277)
    ds_new = _take_col(ds, new_layer - 1)
    ds2_new = _take_col(ds2, new_layer - 1)
    ds_old = _take_col(ds, layer - 1)
    ds2_old = _take_col(ds2, layer - 1)
    entered = (ds2_new < 0.0) & (ds_new >= 0.0)
    left = (ds2_old >= 0.0) & (ds_old < 0.0)
    fp_new = (ds2_new < 0.0) & (ds2_old < 0.0)
    bprim = torch.where(
        entered, new_layer,
        torch.where(left, layer, torch.where(fp_new, new_layer, layer)))

    # tetrahedron FD normal of the crossed prim only
    nidx = torch.clamp(bprim - 1, 0, scene.n_prims - 1).long()
    taps = torch.gather(ev5[:, 1:5, :], 2,
                        nidx[:, None, None].expand(B, 4, 1))[..., 0]
    nvec = sum(taps[:, k:k + 1] * tet[k] for k in range(4))  # [B, 3]
    nvec = nvec / torch.sqrt(
        torch.sum(nvec * nvec, dim=-1, keepdim=True) + 1e-30)

    ri = fresnel_coeff(direction, nvec, n1, n2)
    reflecting = need_fresnel & (u[:, _U_FRESNEL] <= ri)
    transmitting = crossing & ~reflecting

    dir_reflected = reflect(direction, nvec)
    dir_refracted = refract(direction, nvec, n1 / n2)

    bounces = bounces + reflecting.to(torch.int32)
    # reference caps reflections at 1000 (inttau2.f90:313-315)
    overbounced = reflecting & (bounces > cfg.max_bounces)
    if cfg.roulette_bounces > 0:
        chance = as_dtype(cfg.roulette_chance, dtype)
        trapped = reflecting & (bounces > cfg.roulette_bounces)
        survive_rr = trapped & (u[:, _U_ROULETTE] < chance)
        weight = torch.where(survive_rr, weight / chance, weight)
        overbounced = overbounced | (trapped & ~survive_rr)

    if inv > 0:
        # the n and shape scores of boundary events resolved here (the
        # chained walk scores its own; reference engine.py:1297-1335)
        i1s = (layer == inv).to(dtype)
        i2s = (new_layer == inv).to(dtype)
        s_ch = _fresnel_score(direction, nvec, n1, n2, i1s, i2s, pmc_dd, ri,
                              reflecting)
        pmc_fn = pmc_fn + torch.where(need_fresnel, s_ch, 0.0)
        inv_srf = on_boundary & (bprim == inv)
        pmc_bn = pmc_bn + _extinction_score(
            layer == inv, kappa,
            _opt_lookup(tables, tables.kappa, new_layer, wavelength),
            direction, nvec, inv_srf & crossing & ~reflecting,
            inv_srf & reflecting)

    # --- segment selection: min(optical-depth distance, next surface
    # along the ray, cap), the surface from the analytic raycast where the
    # prims have closed forms and from a bounded march for the rest ------
    ana_mask = raycast.analytic_column_mask(scene)
    zeros_b = torch.zeros_like(interior)
    hit_prim = torch.zeros((B,), dtype=torch.int32, device=dev)
    cont_new = zeros_b
    interior_srf = zeros_b
    if all(ana_mask):
        # the reference's closed-form branch (engine.py:1380-1390), which
        # unlike the probe does not clamp the length at 0
        t_ana, hit_prim = raycast.ray_bound_idx(scene, pos, direction)
        fin = torch.isfinite(t_ana)
        avail = torch.where(fin, t_ana - land_eps, torch.inf)
        interior_len = torch.clamp(torch.minimum(tau_dist, avail),
                                   max=seg_cap)
        interior_interact = (tau_dist <= avail) & torch.isfinite(tau_dist)
        interior_srf = ~interior_interact & (avail <= seg_cap) & fin
    elif chaining:
        # classified like the in-chain probe (surface / continuation), so
        # spawn segments enter the chained walk with usable flags
        interior_len, interior_interact, interior_srf, cont_p, hit_prim = \
            _segment_probe(scene, pos, direction, tau_dist, seg_cap,
                           land_eps, eps, ana_mask, cfg.march_iters)
        cont_new = interior & cont_p
    else:
        # the plain walk: the analytic bound (no prim index) and a march
        # over the rest; the segment ends at no known surface
        if any(ana_mask):
            t_ana = raycast.ray_bound(scene, pos, direction)
            avail = torch.where(torch.isfinite(t_ana), t_ana - land_eps,
                                torch.inf)
        else:
            avail = torch.full((B,), torch.inf, dtype=dtype, device=dev)
        if cfg.march_iters > 0:
            interior_len, interior_interact = _plain_march(
                scene, pos, direction, ds, tau_dist, avail, interior, eps,
                cfg.march_iters, seg_cap)
        else:
            bound = torch.minimum(d_sdf, avail)
            interior_len = torch.minimum(bound, tau_dist)
            interior_interact = tau_dist <= bound
    same_len = torch.minimum(smallstep, tau_dist)
    seg_new = torch.where(
        interior, interior_len,
        torch.where(same, same_len,
                    torch.where(transmitting, smallstep, 0.0)))
    interact_new = (interior & interior_interact) | \
        (same & (tau_dist <= smallstep))
    srf_new = interior & interior_srf

    layer = torch.where(transmitting, new_layer, layer)
    kappa_seg = _opt_lookup(tables, tables.kappa, layer, wavelength)
    tau = torch.where(need_seg,
                      torch.clamp(tau - seg_new * kappa_seg, min=0.0), tau)
    if inv > 0:
        # the direction tangent through the boundary event (i1s / i2s are
        # the pre-crossing indicators)
        pmc_dd = torch.where(
            reflecting[:, None], reflect(pmc_dd, nvec),
            torch.where((transmitting & need_fresnel)[:, None],
                        _refract_tangent(direction, nvec, n1, n2, i1s, i2s,
                                         pmc_dd), pmc_dd))
    direction = torch.where(
        reflecting[:, None], dir_reflected,
        torch.where((transmitting & need_fresnel)[:, None], dir_refracted,
                    direction))

    seg_rem = torch.where(need_seg, seg_new, seg_rem)
    seg_interact = torch.where(need_seg, interact_new, seg_interact)
    seg_srf = torch.where(need_seg, srf_new, seg_srf)
    seg_cont = torch.where(need_seg, cont_new, seg_cont)
    seg_prim = torch.where(need_seg, hit_prim, seg_prim)

    alive = alive & ~(escaped | outside_after | overbounced)

    # --- detectors: one test per whole segment (reference hit protocol,
    # inttau2.f90:195-200); with path history, the paths of lanes that
    # hit are kept ------------------------------------------------------
    obs.end(obs_tok)
    obs_tok = obs.begin("megastep.detectors")
    bank = carry.bank
    track_count, track_dropped = tl.track_count, tl.track_dropped
    pmc_stats = tl.pmc_stats
    in_inverse = layer == inv
    if bank is not None:
        seg_len = torch.where(alive & need_seg, seg_rem, 0.0)
        w_hit = torch.where(alive, weight, 0.0)
        history_on = cfg.history_len > 0 and cfg.max_tracks > 0
        if n_src > 0 or inv > 0 or history_on:
            # the per-lane hit matrix: escape attribution by source voxel,
            # pMC statistics rows, kept paths
            bank, hitw, hitt = record_hits(bank, pos, direction, seg_len,
                                           w_hit, want_hit_matrix=True)
            if n_src > 0:
                _flush_escape(tl, sid, hitw)
            if inv > 0:
                pmc_stats = pmc_stats + _pmc_rows(
                    hitw, hitt, pmc_cnt, pmc_len, pmc_hg, pmc_fn, pmc_bn,
                    in_inverse)
            if history_on:
                track_count, track_dropped = _flush_tracks(
                    tl, cfg, hitw, history, hist_n)
        else:
            bank = record_hits(bank, pos, direction, seg_len, w_hit)
    if inv > 0:
        # the new segment's length counts AFTER its hit test
        pmc_len = pmc_len + torch.where(alive & need_seg & in_inverse,
                                        seg_rem, 0.0)

    obs.end(obs_tok)

    # =================================================================
    # Phase 2: the walk
    # =================================================================
    obs_tok = obs.begin("megastep.walk")
    K = cfg.dda_substeps
    deps_k = None
    if chaining:
        respawn_cand = None
        if cfg.respawns_in_chain(scene):
            # per-megastep source candidates [C, B, ...] for in-chain
            # respawn; candidate k is allowed only when even all-B
            # consumption of candidates 0..k stays within the budget
            C = cfg.chain_respawns
            u_rsp = draws.u_rsp
            r_pos, r_dir, r_phase, r_wl = sample_source(source, grid,
                                                        u_rsp[:, :n_src_u])
            r_tau = -torch.log(u_rsp[:, n_src_u])
            # layer with the analysis phase's eps-nudge: a candidate
            # sampled ON a surface takes the layer a forward probe lands in
            r_ds = eval_scene(scene, r_pos)
            r_d_sdf = torch.amin(torch.abs(r_ds), dim=-1)
            r_probe = r_pos + (r_d_sdf + 2.0 * eps)[:, None] * r_dir
            r_layer = torch.where(r_d_sdf < eps,
                                  scene_layer(eval_scene(scene, r_probe)),
                                  scene_layer(r_ds))
            r_flat, r_vok = voxel_flat_index(grid, get_voxel(grid, r_pos))
            r_good = (r_layer > 0) & r_vok
            ks = torch.arange(1, C + 1, device=dev, dtype=torch.int32)
            allow = ((launched + ks * B) <= nphotons)[:, None].expand(C, B)

            def cb(a):
                return a.reshape((C, B) + a.shape[1:])

            respawn_cand = (cb(r_pos), cb(r_dir), cb(r_tau), cb(r_layer),
                            cb(r_phase), cb(r_wl), cb(r_good), allow)

        out = _chained_walk(
            scene, grid, cfg, tables, land_eps, seg_cap, uc=draws.uc,
            pos=pos, direction=direction, weight=weight, tau=tau,
            seg_rem=seg_rem, seg_interact=seg_interact, seg_srf=seg_srf,
            seg_cont=seg_cont, seg_prim=seg_prim, layer=layer, alive=alive,
            steps=steps, bounces=bounces, wavelength=wavelength, phase=phase,
            mom_pos=tl.mom_pos, mom_pos2=tl.mom_pos2, bank=bank,
            respawn=respawn_cand,
            pmc=((pmc_cnt, pmc_len, pmc_hg, pmc_fn, pmc_bn, pmc_dd)
                 if inv > 0 else None))
        pos, direction, weight, tau = (out["pos"], out["dir"],
                                       out["weight"], out["tau"])
        seg_rem, seg_interact, seg_srf = (out["seg_rem"],
                                          out["seg_interact"],
                                          out["seg_srf"])
        seg_cont, seg_prim, layer, alive = (out["seg_cont"],
                                            out["seg_prim"], out["layer"],
                                            out["alive"])
        steps, bounces = out["steps"], out["bounces"]
        wavelength, phase = out["wavelength"], out["phase"]
        launched = launched + out["n_resp"]
        if cfg.record_emission and respawn_cand is not None:
            # launch voxels of consumed in-chain candidates (voxel-valid
            # only); candidate k was consumed iff the lane's final cand_k
            # exceeds k
            consumed = out["cand_k"][None, :] > torch.arange(
                cfg.chain_respawns, device=dev)[:, None]  # [C, B]
            deposit_add_(tl.emission, r_flat,
                         (consumed.reshape(-1) & r_vok).to(dtype))
        bank = out["bank"]
        if out["hit_acc"] is not None:
            _flush_escape(tl, sid, out["hit_acc"])
        if inv > 0:
            (pmc_cnt, pmc_len, pmc_hg, pmc_fn, pmc_bn, pmc_dd,
             pmc_add) = out["pmc"]
            pmc_stats = pmc_stats + pmc_add
        deps_k = out["deps_k"]
        if cfg.record_fluence:
            deposit_add_(tl.jmean, out["flat_k"].reshape(-1),
                         deps_k.reshape(-1))
        mom_pos, mom_pos2 = out["mom_pos"], out["mom_pos2"]
    else:
        mom_pos, mom_pos2 = tl.mom_pos, tl.mom_pos2
        walk = torch.where(alive & (seg_rem > 0.0), seg_rem, 0.0)
        if cfg.record_fluence:
            flat_k, deps_k, lengths, valid_k, end = _closed_form_dda(
                grid, K, pos, direction, walk, weight)
            deposit_add_(tl.jmean, flat_k.reshape(-1), deps_k.reshape(-1))
            # the photon leaves the grid mid-segment: it dies at the wall
            # (reference update_grids tflag, inttau2.f90:437-440)
            alive = alive & ~torch.any(~valid_k & (lengths > 0.0), dim=-1)
        else:
            # no fluence deposits: jump the whole segment (inttau2.f90:
            # 446-462); a segment ending outside the grid kills the photon
            end = walk
            _, valid_end = voxel_flat_index(
                grid, get_voxel(grid, pos + end[:, None] * direction))
            alive = alive & ((walk <= 0.0) | valid_end)
        pos = pos + end[:, None] * direction
        phase = phase + end
        seg_rem = (torch.clamp(seg_rem - end, min=0.0) if cfg.record_fluence
                   else torch.where(walk > 0.0, 0.0, seg_rem))

    # =================================================================
    # Phase 3: interactions at completed segment ends (on the chained
    # walk, the rare lane that leaves the chain with an exhausted segment
    # flagged to interact)
    # =================================================================
    obs.end(obs_tok)
    obs_tok = obs.begin("megastep.interactions")
    nscatt = tl.nscatt
    if chaining:
        nscatt = nscatt + out["n_scat"].to(dtype)
    seg_done = seg_rem <= 0.0
    interact = alive & seg_done & seg_interact
    seg_interact = seg_interact & ~seg_done

    g = _opt_lookup(tables, tables.hgg, layer, wavelength)
    albedo = _opt_lookup(tables, tables.albedo, layer, wavelength)
    cost = sample_hg_cost(u[:, _U_HG_COST], g)
    phi = TWOPI * u[:, _U_HG_PHI]
    dir_scattered = scatter_direction(direction, cost, phi)
    vox_now, vox_now_valid = voxel_flat_index(grid, get_voxel(grid, pos))

    if not cfg.survival_bias:
        # reference noBiasPropagation (kernelsMod.f90:1958-1974)
        do_scatter = interact & (u[:, _U_ALBEDO] < albedo)
        do_absorb = interact & ~do_scatter
        ab_w = torch.where(do_absorb & vox_now_valid, weight, 0.0)
        ab_idx = vox_now
        if chaining:
            # the chain's LAST absorb slot and this leftover are mutually
            # exclusive per lane (a lane with every slot used died on its
            # last hosted photon and cannot be alive here), so they share
            # a column
            ab_w_c, ab_flat_c = out["absorb_w"], out["absorb_flat"]
            S = ab_w_c.shape[1]
            flat_last = torch.where(ab_w_c[:, S - 1] > 0.0,
                                    ab_flat_c[:, S - 1], vox_now)
            ab_idx = torch.cat([ab_flat_c[:, :S - 1], flat_last[:, None]],
                               dim=-1)
            ab_w = torch.cat([ab_w_c[:, :S - 1],
                              (ab_w_c[:, S - 1] + ab_w)[:, None]], dim=-1)
        deposit_add_(tl.absorb, ab_idx.reshape(-1), ab_w.reshape(-1))
        died = do_absorb
    else:
        # reference survivalBiasPropagation (kernelsMod.f90:2036-2066):
        # deposit w (1 - albedo), roulette below THRESHOLD; the chain's
        # per-round deposits go in the same call
        w_absorbed = torch.where(interact, weight * (1.0 - albedo), 0.0)
        weight = weight - w_absorbed
        ab_w = torch.where(vox_now_valid, w_absorbed, 0.0)
        ab_idx = vox_now
        if chaining:
            ab_idx = torch.cat([out["absorb_flat"], vox_now[:, None]],
                               dim=-1)
            ab_w = torch.cat([out["absorb_w"], ab_w[:, None]], dim=-1)
        deposit_add_(tl.absorb, ab_idx.reshape(-1), ab_w.reshape(-1))
        ch = as_dtype(CHANCE, dtype)
        roulette = interact & (weight < as_dtype(THRESHOLD, dtype))
        survive = roulette & (u[:, _U_ROULETTE] < ch)
        weight = torch.where(survive, weight / ch, weight)
        died = roulette & ~survive
        do_scatter = interact & ~died

    if inv > 0:
        # the HG scatter rotates the direction tangent with its frame
        pmc_dd = torch.where(do_scatter[:, None],
                             _scatter_tangent(direction, cost, phi, pmc_dd),
                             pmc_dd)
    direction = torch.where(do_scatter[:, None], dir_scattered, direction)
    tau = torch.where(do_scatter, -torch.log(u[:, _U_TAU]), tau)
    steps = steps + do_scatter.to(torch.int32)
    nscatt = nscatt + torch.sum(do_scatter.to(dtype))
    n_interactions = torch.sum(interact, dtype=torch.int32)
    if chaining:
        n_interactions = n_interactions + out["n_inter"]
    if inv > 0:
        sc_in = do_scatter & (layer == inv)
        pmc_cnt = pmc_cnt + sc_in.to(dtype)
        pmc_hg = pmc_hg + torch.where(sc_in, hg_logpdf_dg(cost, g), 0.0)

    if cfg.history_len > 0:
        # the interaction position and scatter order into the ring
        # (reference pushes per propagation step, kernelsMod.f90:1959)
        lanes = torch.arange(B, device=dev)
        slot = torch.remainder(hist_n, cfg.history_len).long()
        entry = torch.cat([pos, steps[:, None].to(dtype)], dim=-1)
        history[lanes, slot] = torch.where(interact[:, None], entry,
                                           history[lanes, slot])
        hist_n = torch.where(interact, hist_n + 1, hist_n)

    if cfg.record_phasor:
        # exp(i k (phase + path)) at interaction sites, k = 2 pi / lambda
        # (reference packet%fact, photon.f90:35-36): signed rows
        # a true division: a Python number over a tensor is a reciprocal
        # times the number in torch, one rounding more than the reference
        k = torch.tensor(TWOPI, dtype=dtype, device=dev) / torch.clamp(
            wavelength, min=1e-12)
        arg = k * phase
        w_ph = torch.where(interact, weight, 0.0)
        deposit_add_(tl.phasor_re, vox_now, w_ph * torch.cos(arg),
                     signed=True)
        deposit_add_(tl.phasor_im, vox_now, w_ph * torch.sin(arg),
                     signed=True)

    if cfg.record_moments:
        # scatter-order moments (kernelsMod.f90:2149-2161); chained
        # scatters were recorded in the chain
        order = torch.where(do_scatter, steps, 0)
        oh = (order[:, None] - 1 == torch.arange(4, device=dev)).to(dtype)
        mom_pos = mom_pos + oh.T @ pos
        mom_pos2 = mom_pos2 + oh.T @ (pos * pos)

    if cfg.max_scatter_order > 0:
        died = died | (steps > cfg.max_scatter_order)
    alive = alive & ~died

    n_dep = (torch.sum(deps_k > 0.0, dtype=torch.int32)
             if cfg.record_fluence
             else torch.zeros((), dtype=torch.int32, device=dev))
    perf = tl.perf + torch.stack([
        n_dep,
        torch.sum(alive, dtype=torch.int32),
        torch.sum(need_seg, dtype=torch.int32),
        n_interactions,
    ])

    new_state = replace(
        st, pos=pos, dir=direction, weight=weight, layer=layer, tau=tau,
        seg_rem=seg_rem, seg_interact=seg_interact, seg_srf=seg_srf,
        seg_cont=seg_cont, seg_prim=seg_prim, alive=alive, bounces=bounces,
        steps=steps, phase=phase, wavelength=wavelength, sid=sid,
        history=history, hist_n=hist_n, pmc_cnt=pmc_cnt, pmc_len=pmc_len,
        pmc_hg=pmc_hg, pmc_fn=pmc_fn, pmc_bn=pmc_bn, pmc_dd=pmc_dd)
    new_tallies = replace(tl, nscatt=nscatt, mom_pos=mom_pos,
                          mom_pos2=mom_pos2, perf=perf, pmc_stats=pmc_stats,
                          track_count=track_count,
                          track_dropped=track_dropped)
    obs.end(obs_tok)
    return SimCarry(state=new_state, tallies=new_tallies, bank=bank,
                    launched=launched, step=carry.step + 1,
                    qmc_shifts=qmc_shifts)


#: megasteps a card may hold that the host has not seen end: before it
#: dispatches megastep ``i``, the host waits for megastep ``i - IN_FLIGHT``
#: to end and reads whether megastep ``i - IN_FLIGHT + 1`` was needed
IN_FLIGHT = 2


class _EndFlags:
    """The end test of each megastep queued on a card, read without a
    synchronisation: :meth:`record` copies it to pinned host memory behind
    an event (``event``, ``torch.cuda.Event`` unless a test stubs it), and
    :meth:`finished` reads the tests whose events have completed, oldest
    first, waiting for an event that would leave the card more than
    :data:`IN_FLIGHT` megasteps ahead of what the host has seen end."""

    def __init__(self, n: int, event=None, pin_memory: bool = True):
        self.flags = torch.empty(n, dtype=torch.bool, pin_memory=pin_memory)
        self.event = torch.cuda.Event if event is None else event
        self.pending = collections.deque()

    def record(self, i: int, more: torch.Tensor):
        """Megastep ``i`` is needed iff ``more`` (read before it)."""
        self.flags[i].copy_(more, non_blocking=True)
        done = self.event()
        # on the stream of the run's card, which need not be the current
        # device's (``parallel.mesh``'s shards)
        done.record(torch.cuda.current_stream(more.device)
                    if more.is_cuda else None)
        self.pending.append((i, done))

    def held(self, i: int) -> bool:
        """Whether :meth:`finished` would wait before megastep ``i``."""
        for j, done in self.pending:
            if j > i - IN_FLIGHT + 1:
                return False
            if not done.query():
                return True
        return False

    def finished(self, i: int) -> bool:
        """Before megastep ``i`` is dispatched: whether a test read says
        the run was finished."""
        while self.pending:
            j, done = self.pending[0]
            if j > i - IN_FLIGHT + 1 and not done.query():
                return False
            done.synchronize()
            self.pending.popleft()
            if not self.flags[j]:
                return True
        return False


def _end_flags(n_steps: int, device):
    """The end tests of a chunk on a card (:class:`_EndFlags`); None on
    the CPU, where the test is read before every megastep."""
    return _EndFlags(n_steps) if device.type == "cuda" else None


class _Chunk:
    """Up to ``n_steps`` megasteps of a run, dispatched by :meth:`queue`
    and stopping once the run is finished (budget spent, no lane alive),
    where the reference's ``while_loop`` stops (reference
    engine.py:1957).  ``carry`` is the carry after the last megastep
    dispatched; ``over`` says whether the chunk is all dispatched.

    On the CPU the end test is read before every megastep, so exactly the
    counted megasteps run.  On a card the host never synchronises on it:
    each megastep's test is copied to pinned host memory behind an event
    (:class:`_EndFlags`), dispatch stops at the first completed event that
    reads "finished", and the host waits on an event only to keep at most
    :data:`IN_FLIGHT` megasteps on the card that it has not seen end.  The
    megasteps queued past the end (one, where the card sets the pace) change
    no tally and are not counted in ``step``.

    Each dispatch is a ``megastep`` span and counts in the
    ``host_loop.megasteps_dispatched`` and ``host_loop.megasteps_by_width``
    counters; a chunk left because the run finished counts in
    ``host_loop.early_exits``."""

    def __init__(self, scene, source, grid, generator, carry, cfg, n_steps,
                 nphotons):
        self.args = (scene, source, grid, generator)
        self.carry, self.cfg, self.nphotons = carry, cfg, nphotons
        self.n, self.i, self.over = n_steps, 0, n_steps <= 0
        self.flags = _end_flags(n_steps, carry.state.alive.device)

    def queue(self, wait: bool = True):
        """Dispatch the chunk's megasteps.  With ``wait`` false, wait for
        the card only before the first of them: return instead where the
        host would wait again, and leave the rest to the next call."""
        scene, source, grid, generator = self.args
        flags, first = self.flags, self.i
        while not self.over:
            if flags is not None:
                if not wait and self.i > first and flags.held(self.i):
                    return
                if flags.finished(self.i):
                    break
            carry = self.carry
            more = (carry.launched < self.nphotons) | torch.any(
                carry.state.alive)
            if flags is None and not more:
                break
            obs_tok = obs.begin("megastep")
            if flags is not None:
                flags.record(self.i, more)
            self.carry = transport_step(carry, scene, source, grid,
                                        generator, self.cfg, self.nphotons)
            self.carry.step = carry.step + more.to(torch.int32)
            obs.end(obs_tok)
            obs.count("host_loop.megasteps_dispatched")
            obs.count_by("host_loop.megasteps_by_width", self.cfg.n_lanes)
            self.i += 1
            self.over = self.i >= self.n
        else:
            return
        obs.count("host_loop.early_exits")
        self.over = True


def _run_steps(scene, source, grid, generator, carry, cfg, n_steps,
               nphotons):
    """Advance up to ``n_steps`` megasteps, stopping once the run is
    finished: one :class:`_Chunk`, all of it dispatched."""
    chunk = _Chunk(scene, source, grid, generator, carry, cfg, n_steps,
                   nphotons)
    chunk.queue()
    return chunk.carry


def _compact_lanes(carry: SimCarry, new_B: int) -> SimCarry:
    """Gather the surviving lanes into a smaller wavefront (once the photon
    budget is exhausted), alive lanes first in a stable order."""
    order = torch.argsort((~carry.state.alive).to(torch.int8),
                          stable=True)[:new_B]
    st = carry.state
    new_state = LaneState(**{f.name: getattr(st, f.name)[order]
                             for f in dataclasses.fields(LaneState)})
    return replace(carry, state=new_state)


def shrink_ladder(n_lanes: int, min_lanes: int) -> list:
    """The sequence of wavefront widths ``simulate`` visits when
    tail-shrinking (one /8 level per chunk)."""
    ladder = [n_lanes]
    while ladder[-1] > min_lanes:
        ladder.append(max(min_lanes, ladder[-1] // 8))
    return ladder


def warmup(scene: Scene, source: Source, grid: CartGrid,
           generator: torch.Generator, cfg: TransportConfig, bank=None,
           min_lanes: int = 4096):
    """Build the CUDA kernels (on a CUDA scene) and run one megastep at
    every wavefront width of the shrink ladder, so a timed run pays no
    build, no first-use allocation and no capture.  Each width's walk
    takes its path (:func:`_chained_walk`): the kernel's first launch
    makes the scene's table (:func:`walk_kernel.table`); the graph path
    captures its width's graph and replays it; neither counts a walk, a
    capture or a replay.  Leaves no tally behind and the caller's bank as
    it was.  A ``setup.warmup`` span."""
    global _warming
    cfg.check_ported()
    on_card = scene.device.type == "cuda"
    with obs.span("setup.warmup"):
        if on_card:
            from .. import _build

            _build.load()
        _warming = True
        try:
            for lanes in shrink_ladder(cfg.n_lanes, min_lanes):
                cfg_l = replace(cfg, n_lanes=lanes)
                carry = init_carry(grid, cfg_l, bank=bank,
                                   dtype=scene.tables.mus.dtype)
                _run_steps(scene, source, grid, generator, carry, cfg_l, 1,
                           max(lanes // 8, 1))
        finally:
            _warming = False
        if on_card:
            torch.cuda.synchronize(scene.device)


class SimRun:
    """One forward run driven a chunk at a time, the loop of
    :func:`simulate`: :meth:`launch` queues a chunk of megasteps with no
    synchronisation but the run-ahead bound's, :meth:`settle` synchronises
    once on its results (the
    host drain of path history, the end test, the tail shrink) and says
    whether the run is done, :meth:`result` gives what :func:`simulate`
    returns.  Several runs, each on its own generator and device, can be
    interleaved: every run's chunk is queued before any is settled
    (``parallel.mesh``).

    ``job`` is the run's :mod:`~rsmcrt_tpu_torch.obs` job id: the open
    ``job`` span's, else a new one, so interleaved runs' spans stay apart.
    :meth:`launch` and :meth:`settle` are ``host_loop.launch`` and
    ``host_loop.settle`` spans; megasteps dispatched below the run's first
    width count in ``host_loop.tail_megasteps``, compactions in
    ``host_loop.tail_shrinks``."""

    def __init__(self, scene: Scene, source: Source, grid: CartGrid,
                 generator: torch.Generator, cfg: TransportConfig,
                 bank=None, chunk_steps: int = 16, nphotons=None,
                 tail_shrink: bool = True, min_lanes: int = 4096):
        cfg.check_ported()
        self.scene, self.source, self.grid = scene, source, grid
        self.generator, self.cfg = generator, cfg
        self.chunk_steps, self.tail_shrink = chunk_steps, tail_shrink
        self.min_lanes = min_lanes
        self.n_target = int(cfg.nphotons if nphotons is None else nphotons)
        self.cur_cfg = cfg
        # the run's type is the scene's (reference engine.py:2051)
        self.carry = init_carry(grid, cfg, bank=bank,
                                dtype=scene.tables.mus.dtype)
        self.drained = []
        self.step = 0
        self.launched = 0
        self.done = False
        self.chunk = None  # the chunk being queued (:class:`_Chunk`)
        self.job = obs.job() or obs.new_job()

    def launch(self, wait: bool = True) -> bool:
        """Queue the chunk of megasteps, a new one after each
        :meth:`settle`, and return whether it is all queued.  The host
        synchronises on nothing but, on a card, the end of the megastep
        that keeps the card at most :data:`IN_FLIGHT` megasteps ahead
        (:class:`_Chunk`).  With ``wait`` false it waits there at most
        once, before its first megastep, and returns False where it would
        wait again: the next call goes on with the chunk, so a loop over
        several cards (``parallel.mesh``) queues on the others meanwhile."""
        with obs.span("host_loop.launch", self.job):
            cur = self.cur_cfg
            if self.chunk is None:
                # at tail widths use longer chunks: host round trips
                # dominate there
                n = (self.chunk_steps if cur.n_lanes > 1024
                     else 8 * self.chunk_steps)
                n = min(n, self.cfg.max_steps - self.step)
                self.chunk = _Chunk(self.scene, self.source, self.grid,
                                    self.generator, self.carry, cur, n,
                                    self.n_target)
            before = obs.counters.get("host_loop.megasteps_dispatched", 0)
            self.chunk.queue(wait)
            self.carry = self.chunk.carry
            if cur.n_lanes < self.cfg.n_lanes:
                obs.count("host_loop.tail_megasteps", obs.counters.get(
                    "host_loop.megasteps_dispatched", 0) - before)
            if not self.chunk.over:
                return False
            self.chunk = None
            return True

    def settle(self, progress=None) -> bool:
        """Synchronise on the chunk just launched: drain the kept tracks,
        call ``progress(launched, nphotons, step, carry)``, and either end
        the run (budget spent and no lane alive, or ``max_steps``
        reached) or compact the survivors into a wavefront 1/8 as wide.
        Returns whether the run is done."""
        with obs.span("host_loop.settle", self.job):
            carry, cfg = self.carry, self.cfg
            self.launched = int(carry.launched)
            self.step = int(carry.step)
            tc = int(carry.tallies.track_count) if cfg.max_tracks > 0 else 0
            if tc > 0:
                self.drained.append(carry.tallies.tracks[:tc].cpu().clone())
                carry.tallies.track_count = torch.zeros_like(
                    carry.tallies.track_count)
            if progress is not None:
                progress(self.launched, self.n_target, self.step, carry)
            if self.step >= cfg.max_steps:
                self.done = True
                return True
            n_alive = int(torch.sum(carry.state.alive))
            spent = self.launched >= self.n_target
            if spent and n_alive == 0:
                self.done = True
                return True
            cur = self.cur_cfg
            if (self.tail_shrink and spent and cur.n_lanes > self.min_lanes
                    and n_alive <= cur.n_lanes // 8):
                new_B = max(self.min_lanes, cur.n_lanes // 8)
                self.carry = _compact_lanes(carry, new_B)
                self.cur_cfg = replace(cur, n_lanes=new_B)
                obs.count("host_loop.tail_shrinks")
            return False

    def result(self):
        """``(tallies, bank, launched, steps)`` as :func:`simulate` returns
        them, the drained tracks spliced back in."""
        carry = self.carry
        tallies = carry.tallies
        if self.drained:
            dev = self.grid.device
            full = torch.cat(self.drained).to(dev)
            tallies = replace(tallies, tracks=full,
                              track_count=torch.tensor(full.shape[0],
                                                       dtype=torch.int32,
                                                       device=dev))
        return tallies, carry.bank, carry.launched, carry.step


def simulate(scene: Scene, source: Source, grid: CartGrid,
             generator: torch.Generator, cfg: TransportConfig, bank=None,
             chunk_steps: int = 16, progress=None, nphotons=None,
             tail_shrink: bool = True, min_lanes: int = 4096):
    """Run a full forward simulation; returns (tallies, detector bank
    (a copy of ``bank`` with the run's hits, or None), photons launched,
    megasteps executed) -- the last two as 0-d int32 tensors.

    Work is dispatched in chunks of ``chunk_steps`` megasteps with one
    host synchronisation per chunk (on ``launched`` and the alive count);
    ``progress(launched, nphotons, step, carry)`` is called per chunk.
    Once the photon budget is spent and at most 1/8 of the lanes live,
    the survivors are compacted into a wavefront 1/8 as wide
    (``tail_shrink``).  With path history the kept tracks are drained to
    the host every chunk, so the device's ``max_tracks`` slots hold one
    chunk's worth and the run's count is unbounded; the returned
    ``tallies.tracks`` holds them all, ``track_count`` their number.  The
    run is a ``job`` span of its own when no job span is open."""
    job = None if obs.job() else obs.begin("job")
    try:
        run = SimRun(scene, source, grid, generator, cfg, bank=bank,
                     chunk_steps=chunk_steps, nphotons=nphotons,
                     tail_shrink=tail_shrink, min_lanes=min_lanes)
        while True:
            run.launch()
            if run.settle(progress):
                return run.result()
    finally:
        obs.end(job)
