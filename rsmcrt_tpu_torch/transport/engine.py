"""Wavefront photon transport engine (port of
``rsmcrt_tpu/transport/engine.py``: the chained forward fluence path).

A batch of photon lanes advances in lockstep, one *megastep* per
:func:`transport_step` call:

1. **Analysis**: dead lanes respawn from the source while the photon
   budget lasts; lanes with no segment left resolve boundary events
   (eps-nudge probe, Fresnel reflect / refract / cross) and pick their
   next segment from the analytic raycast bound and the remaining optical
   depth (reference inttau2.f90:73-146, 209-337).
2. **Chained DDA walk** (:func:`_chained_dda`): every lane walks up to
   ``dda_substeps`` voxel-wall intervals, consuming scatter, absorption,
   surface and in-chain respawn events in place (reference update_grids,
   inttau2.f90:408-445, and kernelsMod.f90:1958-1974).
3. **Interaction** leftovers at completed segment ends.

The three voxel tallies change only through
:func:`~rsmcrt_tpu_torch.transport.deposit.deposit_add_` (the CUDA deposit
kernel on the card), once per tally per megastep on the ``[B, K]`` lists.

Ported: analog absorption, fluence and emission on, all-analytic scenes,
in-chain respawn, bounce roulette, scatter-order moments and
``max_scatter_order``.  Options of :class:`TransportConfig` that select
anything else raise ``NotImplementedError`` naming their ROADMAP item.

Random numbers: each megastep consumes three uniform blocks in (0, 1)
(:class:`StepDraws`), drawn from the run's ``torch.Generator`` unless the
caller injects them -- the parity tests hand both packages the blocks
``jax.random`` draws for the reference.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..constants import TWOPI
from ..grid import CartGrid, f32, get_voxel, voxel_flat_index
from ..sdfs import raycast
from ..sdfs.scene import Scene, eval_scene, scene_layer
from ..sources.sources import Source, n_source_uniforms
from ..sources.sources import sample as sample_source
from ..tally import Tallies, zero_tallies
from .deposit import deposit_add_
from .fresnel import fresnel_coeff, reflect, refract
from .scatter import sample_hg_cost, scatter_direction

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
        """Raise for options that select a path this package lacks."""
        todo = [
            (self.survival_bias, "survival_bias",
             "item 10: transport options"),
            (self.record_phasor, "record_phasor",
             "item 10: transport options"),
            (self.history_len > 0, "history_len > 0",
             "item 10: transport options"),
            (self.qmc_source, "qmc_source", "item 10: transport options"),
            (tuple(self.escape_shape) != (0, 0), "escape_shape",
             "item 12: workloads"),
            (self.inverse_prim > 0, "inverse_prim", "item 12: workloads"),
            (not self.record_fluence, "record_fluence=False",
             "item 7: fluenceless path and detectors"),
            (not self.chain_scatter, "chain_scatter=False",
             "item 10: plain walk"),
        ]
        for bad, name, item in todo:
            if bad:
                raise NotImplementedError(
                    f"TransportConfig {name} is not ported "
                    f"(ROADMAP queue 1, {item})")
        if self.chain_respawns < 1:
            raise ValueError("chain_respawns must be >= 1")


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
    bank: object  # detector banks are not ported: always None
    launched: torch.Tensor  # 0-d int32
    step: torch.Tensor  # 0-d int32


class StepDraws(NamedTuple):
    """The uniform blocks one megastep consumes, each in (0, 1):
    ``u_all [B, n_src_u + 7]``, ``uc [B, K, 4]`` (chain rounds) and
    ``u_rsp [C*B, n_src_u + 1]`` (in-chain respawn candidates, or None
    when in-chain respawn is off)."""

    u_all: torch.Tensor
    uc: torch.Tensor
    u_rsp: Optional[torch.Tensor]


def _uniform(shape, generator, device):
    # the reference draws with minval=1e-12: keep -log(u) finite
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32).clamp_(min=1e-12)


def draw_step(generator: torch.Generator, B: int, cfg: TransportConfig,
              source: Source, device) -> StepDraws:
    n_src_u = n_source_uniforms(source)
    u_all = _uniform((B, n_src_u + _N_TRANSPORT_U), generator, device)
    uc = _uniform((B, cfg.dda_substeps, 4), generator, device)
    u_rsp = None
    if cfg.chain_respawn:
        u_rsp = _uniform((cfg.chain_respawns * B, n_src_u + 1), generator,
                         device)
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
    """A fresh carry on the grid's device: every lane dead, tallies 0."""
    if bank is not None:
        raise NotImplementedError(
            "detector banks are not ported (ROADMAP queue 1, item 7)")
    dev = grid.device
    return SimCarry(
        state=_init_lanes(cfg.n_lanes, dev, cfg.history_len, dtype),
        tallies=zero_tallies(grid, dtype, escape_shape=cfg.escape_shape,
                             history_shape=(cfg.max_tracks,
                                            max(cfg.history_len, 1)),
                             phasor=cfg.record_phasor, pmc_shape=(0, 6)),
        bank=None,
        launched=torch.zeros((), dtype=torch.int32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _scalars(cfg: TransportConfig):
    """eps, land_eps, delta_cross in float32 arithmetic, as the reference
    forms them from its float32 ``eps``."""
    e = np.float32(cfg.eps)
    land = np.float32(0.5) * e
    return float(e), float(land), float(land + np.float32(2.0) * e)


def _seg_cap(grid: CartGrid) -> float:
    """Segment cap: photons that outlive it never re-enter the grid."""
    x, y, z = (np.float32(v) for v in (grid.xmax, grid.ymax, grid.zmax))
    return float(np.float32(8.0) * np.sqrt(x * x + y * y + z * z)
                 + np.float32(1.0))


def _take_col(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a [B, N], idx [B] -> a[b, idx[b]] with idx clipped."""
    i = torch.clamp(idx, 0, a.shape[-1] - 1).long()
    return a.gather(-1, i[:, None])[:, 0]


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


def _segment_probe(scene, pos, dirn, tau_dist, avail_cap, land_eps):
    """Bound of the next straight segment from ``pos`` along ``dirn`` for
    an all-analytic scene: ``(rem, interact, srf, hidx)``."""
    t_ana, hidx = raycast.ray_bound_idx(scene, pos, dirn)
    fin = torch.isfinite(t_ana)
    avail = torch.where(fin, t_ana - land_eps, torch.inf)
    rem = torch.clamp(torch.minimum(tau_dist, avail), max=avail_cap)
    rem = torch.clamp(rem, min=0.0)
    interact = (tau_dist <= avail) & torch.isfinite(tau_dist)
    srf = ~interact & (avail <= avail_cap) & fin
    return rem, interact, srf, hidx


def _chained_dda(scene, grid, cfg: TransportConfig, uc, pos, direction,
                 weight, tau, seg_rem, seg_interact, seg_srf, seg_cont,
                 seg_prim, layer, alive, steps, bounces, wavelength, phase,
                 tables, land_eps, seg_cap, mom_pos, mom_pos2,
                 respawn=None):
    """DDA walk with in-line scatter, absorption, Fresnel-boundary and
    respawn chaining (analog absorption, fluence on).

    Each of the K rounds deposits the interval up to the lane's next voxel
    wall or segment end; a lane whose segment ends consumes the event in
    place (HG scatter + fresh tau, absorption, or the surface normal,
    eps-nudge probe and stochastic Fresnel branch) and re-anchors its
    wall-crossing streams via the analytic raycast.  A lane whose photon
    dies relaunches its precomputed source candidate (``respawn``) while
    its absorption record slots and the photon budget allow.  Voxels are
    tracked incrementally (the crossing axis steps the integer cell).
    """
    dtype = pos.dtype
    dev = pos.device
    B = pos.shape[0]
    K = cfg.dda_substeps
    half = grid.half_extent
    dv = grid.voxel_size
    counts = grid.n_counts
    eps, _, delta_cross = _scalars(cfg)

    walking = alive & (seg_rem > 0.0)
    p0 = pos
    dirc = direction
    rem = torch.where(walking, seg_rem, 0.0)
    seg_int, srf_f, cont_f, prim_l = seg_interact, seg_srf, seg_cont, seg_prim
    layer_l, w_l, bounces_l = layer, weight, bounces
    wavelength_l, phase_l = wavelength, phase
    cellf = torch.floor((p0 + half) / dv)
    cell = cellf.to(torch.int32)  # [B, 3]
    t_next, dt_ax = _wall_streams(p0, dirc, cellf, grid)
    s_prev = torch.zeros((B,), dtype=dtype, device=dev)

    died = torch.zeros((B,), dtype=torch.bool, device=dev)
    # analog absorption record slots: a lane hosts at most
    # chain_respawns + 1 photons per megastep and each absorbs at most
    # once; respawn is blocked once every slot is used
    n_slots = cfg.chain_respawns + 1
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
    # current-layer optical properties, one gather of [B, 4] per round
    opt_pack = torch.stack(
        [tables.kappa, tables.albedo, tables.hgg, tables.n], dim=-1)
    lanes = torch.arange(B, device=dev)

    for r in range(K):
        c = torch.amin(t_next, dim=-1)  # [B] next wall along the segment
        ends = rem <= c
        hi = torch.where(ends, rem, c)
        length = torch.clamp(hi - s_prev, min=0.0)
        valid = torch.all((cell >= 0) & (cell < counts), dim=-1)
        safe = torch.minimum(torch.clamp(cell, min=0), counts - 1)
        flat = (safe[:, 0] * grid.nyg + safe[:, 1]) * grid.nzg + safe[:, 2]
        # interval outside the grid: the photon dies at the grid wall
        # (reference update_grids tflag, inttau2.f90:437-440)
        exit_now = walking & ~valid & (length > 0.0)
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

        o_cur = opt_pack[layer_l.long()]
        albedo_l, g_l, n1 = o_cur[:, 1], o_cur[:, 2], o_cur[:, 3]

        # --- interaction events: analog scatter-or-die ---------------------
        do_sc = inter & (u_r[:, 0] < albedo_l)
        do_ab = inter & ~do_sc
        ab_ok = do_ab & valid
        for s in range(n_slots):
            m = ab_ok & (n_ab == s)
            absorb_ws[s] = torch.where(m, w_l, absorb_ws[s])
            absorb_fls[s] = torch.where(m, flat, absorb_fls[s])
        n_ab = n_ab + ab_ok.to(torch.int32)
        died = died | do_ab

        # --- surface events: nudge-across probe + Fresnel branch ----------
        nvec = raycast.surface_normal(scene, p_end, prim_l)
        probe = p_end + delta_cross * dirc
        new_layer = scene_layer(eval_scene(scene, probe))
        outside = srf & (new_layer == 0)
        samel = srf & (new_layer == layer_l)
        crossing = srf & (new_layer != layer_l) & (new_layer != 0)
        n2 = tables.n[new_layer.long()]
        needf = crossing & (n1 != n2)
        ri = fresnel_coeff(dirc, nvec, n1, n2)
        refl = needf & (u_r[:, 0] <= ri)
        trans = (crossing & ~refl) | samel

        bounces2 = bounces_l + refl.to(torch.int32)
        overb = refl & (bounces2 > cfg.max_bounces)
        srf_die = outside | overb
        if cfg.roulette_bounces > 0:
            chance = f32(cfg.roulette_chance)
            trapped = refl & (bounces2 > cfg.roulette_bounces)
            survive = trapped & (u_r[:, 1] < chance)
            w_l = torch.where(survive, w_l / chance, w_l)
            srf_die = srf_die | (trapped & ~survive)
        srf_cont = srf & ~srf_die
        died = died | srf_die
        bounces_l = torch.where(refl, bounces2, bounces_l)

        # --- deposits: the interval plus, for transmitting lanes, the
        # crossing nudge (inttau2.f90:75-146) ------------------------------
        dep_len = length + torch.where(trans, delta_cross, 0.0)
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
            resp_try = died & rc_allow[k, lanes] & (cand_k < C) & \
                (n_ab < n_slots)
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

        newtau = -torch.log(u_r[:, 3])
        # the crossing nudge is charged at the NEW medium's kappa
        kappa2 = tables.kappa[nlayer.long()]
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
        rem2, int2, srf2, hidx = _segment_probe(
            scene, np_pos, np_dir, tau_dist2, seg_cap, land_eps)
        cont2 = torch.zeros_like(int2)
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
        dirc = torch.where(evm, np_dir, dirc)
        p0 = torch.where(evm, np_pos, p0)
        # re-anchor the wall-crossing streams at the event point (the
        # tracked cell stays authoritative; a respawned lane teleports,
        # so its cell is recomputed from the candidate position)
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

        # wall crossing for lanes whose segment continues past it
        # (respawned lanes start their new stream next round)
        adv = walking & ~ends & ~resp
        selm = (t_next == c[:, None]) & adv[:, None]
        am = selm & (torch.cumsum(selm.to(torch.int32), dim=-1) == 1)
        stepdir = torch.where(dirc > 0.0, 1, -1).to(torch.int32)
        cell = cell + torch.where(am, stepdir, 0)
        t_next = torch.clamp(t_next + torch.where(am, dt_ax, 0.0), max=_BIG)
        s_prev = torch.where(adv, c, s_prev)

    pos_new = p0 + s_prev[:, None] * dirc
    seg_rem_new = torch.clamp(rem - s_prev, min=0.0)
    alive_new = alive & ~died
    return dict(
        pos=pos_new, dir=dirc, weight=w_l, tau=tau_l, seg_rem=seg_rem_new,
        seg_interact=seg_int, seg_srf=srf_f, seg_cont=cont_f,
        seg_prim=prim_l, layer=layer_l, alive=alive_new, steps=steps_l,
        bounces=bounces_l, wavelength=wavelength_l, phase=phase_l,
        n_resp=n_resp, flat_k=torch.stack(flats, dim=-1),
        deps_k=torch.stack(vals, dim=-1),
        absorb_w=torch.stack(absorb_ws, dim=-1),
        absorb_flat=torch.stack(absorb_fls, dim=-1), n_scat=n_scat,
        n_inter=n_inter, mom_pos=mom_pos, mom_pos2=mom_pos2, cand_k=cand_k)


def transport_step(carry: SimCarry, scene: Scene, source: Source,
                   grid: CartGrid, generator: Optional[torch.Generator],
                   cfg: TransportConfig, nphotons=None,
                   draws: Optional[StepDraws] = None) -> SimCarry:
    """One megastep of the wavefront.  The voxel tallies of ``carry`` are
    updated in place; the returned carry holds the new lane state.
    ``draws`` injects the megastep's uniforms; otherwise they are drawn
    from ``generator``."""
    cfg.check_ported()
    if nphotons is None:
        nphotons = cfg.nphotons
    st = carry.state
    tl = carry.tallies
    dtype = st.pos.dtype
    dev = st.pos.device
    B = st.pos.shape[0]
    tables = scene.tables
    eps, land_eps, _ = _scalars(cfg)
    seg_cap = _seg_cap(grid)
    n_src_u = n_source_uniforms(source)
    if draws is None:
        draws = draw_step(generator, B, cfg, source, dev)
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

    src_pos, src_dir, src_phase, src_wl = sample_source(source, grid, u_src)
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

    kappa = tables.kappa[layer.long()]
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
    tet = torch.as_tensor(_TET, dtype=dtype, device=dev)
    pts5 = torch.cat([p2[:, None, :], pos[:, None, :] + tet * (10.0 * eps)],
                     dim=1)  # [B, 5, 3]
    ev5 = eval_scene(scene, pts5)  # [B, 5, N]
    ds2 = ev5[:, 0, :]
    new_layer = scene_layer(ds2)
    outside_after = on_boundary & (new_layer == 0)
    same = on_boundary & (new_layer == layer)
    crossing = on_boundary & (new_layer != layer) & (new_layer != 0)

    n1 = tables.n[layer.long()]
    n2 = tables.n[new_layer.long()]
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
        chance = f32(cfg.roulette_chance)
        trapped = reflecting & (bounces > cfg.roulette_bounces)
        survive_rr = trapped & (u[:, _U_ROULETTE] < chance)
        weight = torch.where(survive_rr, weight / chance, weight)
        overbounced = overbounced | (trapped & ~survive_rr)

    # --- segment selection: min(optical-depth distance, next analytic
    # surface along the ray, cap) ------------------------------------
    t_ana, hit_prim = raycast.ray_bound_idx(scene, pos, direction)
    fin = torch.isfinite(t_ana)
    avail = torch.where(fin, t_ana - land_eps, torch.inf)
    interior_len = torch.clamp(torch.minimum(tau_dist, avail), max=seg_cap)
    interior_interact = (tau_dist <= avail) & torch.isfinite(tau_dist)
    interior_srf = ~interior_interact & (avail <= seg_cap) & fin
    same_len = torch.minimum(smallstep, tau_dist)
    seg_new = torch.where(
        interior, interior_len,
        torch.where(same, same_len,
                    torch.where(transmitting, smallstep, 0.0)))
    interact_new = (interior & interior_interact) | \
        (same & (tau_dist <= smallstep))
    srf_new = interior & interior_srf

    layer = torch.where(transmitting, new_layer, layer)
    kappa_seg = tables.kappa[layer.long()]
    tau = torch.where(need_seg,
                      torch.clamp(tau - seg_new * kappa_seg, min=0.0), tau)
    direction = torch.where(
        reflecting[:, None], dir_reflected,
        torch.where((transmitting & need_fresnel)[:, None], dir_refracted,
                    direction))

    seg_rem = torch.where(need_seg, seg_new, seg_rem)
    seg_interact = torch.where(need_seg, interact_new, seg_interact)
    seg_srf = torch.where(need_seg, srf_new, seg_srf)
    seg_cont = seg_cont & ~need_seg
    seg_prim = torch.where(need_seg, hit_prim, seg_prim)

    alive = alive & ~(escaped | outside_after | overbounced)

    # =================================================================
    # Phase 2: chained DDA walk
    # =================================================================
    respawn_cand = None
    if cfg.chain_respawn:
        # per-megastep source candidates [C, B, ...] for in-chain respawn;
        # candidate k is allowed only when even all-B consumption of
        # candidates 0..k stays within the photon budget
        C = cfg.chain_respawns
        u_rsp = draws.u_rsp
        r_pos, r_dir, r_phase, r_wl = sample_source(source, grid,
                                                    u_rsp[:, :n_src_u])
        r_tau = -torch.log(u_rsp[:, n_src_u])
        # layer with the analysis phase's eps-nudge: a candidate sampled ON
        # a surface takes the layer a forward probe lands in
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

    out = _chained_dda(
        scene, grid, cfg, draws.uc, pos, direction, weight, tau, seg_rem,
        seg_interact, seg_srf, seg_cont, seg_prim, layer, alive, steps,
        bounces, wavelength, phase, tables, land_eps, seg_cap, tl.mom_pos,
        tl.mom_pos2, respawn=respawn_cand)
    pos, direction, weight, tau = (out["pos"], out["dir"], out["weight"],
                                   out["tau"])
    seg_rem, seg_interact, seg_srf = (out["seg_rem"], out["seg_interact"],
                                      out["seg_srf"])
    seg_cont, seg_prim, layer, alive = (out["seg_cont"], out["seg_prim"],
                                        out["layer"], out["alive"])
    steps, bounces = out["steps"], out["bounces"]
    wavelength, phase = out["wavelength"], out["phase"]
    launched = launched + out["n_resp"]
    if cfg.record_emission and respawn_cand is not None:
        # launch voxels of consumed in-chain candidates (voxel-valid only);
        # candidate k was consumed iff the lane's final cand_k exceeds k
        consumed = out["cand_k"][None, :] > torch.arange(
            cfg.chain_respawns, device=dev)[:, None]  # [C, B]
        deposit_add_(tl.emission, r_flat,
                     (consumed.reshape(-1) & r_vok).to(dtype))
    flat_k, deps_k = out["flat_k"], out["deps_k"]
    deposit_add_(tl.jmean, flat_k.reshape(-1), deps_k.reshape(-1))

    # =================================================================
    # Phase 3: interactions at completed segment ends (the rare lane that
    # leaves the chain with an exhausted segment flagged to interact)
    # =================================================================
    nscatt = tl.nscatt + out["n_scat"].to(dtype)
    seg_done = seg_rem <= 0.0
    interact = alive & seg_done & seg_interact
    seg_interact = seg_interact & ~seg_done

    g = tables.hgg[layer.long()]
    albedo = tables.albedo[layer.long()]
    cost = sample_hg_cost(u[:, _U_HG_COST], g)
    phi = TWOPI * u[:, _U_HG_PHI]
    dir_scattered = scatter_direction(direction, cost, phi)
    vox_now, vox_now_valid = voxel_flat_index(grid, get_voxel(grid, pos))

    # reference noBiasPropagation (kernelsMod.f90:1958-1974)
    do_scatter = interact & (u[:, _U_ALBEDO] < albedo)
    do_absorb = interact & ~do_scatter
    ab_w_ph3 = torch.where(do_absorb & vox_now_valid, weight, 0.0)
    # the chain's LAST absorb slot and the phase-3 leftover are mutually
    # exclusive per lane (a lane with every slot used died on its last
    # hosted photon and cannot be alive here), so they share a column
    ab_w_c, ab_flat_c = out["absorb_w"], out["absorb_flat"]
    S = ab_w_c.shape[1]
    flat_last = torch.where(ab_w_c[:, S - 1] > 0.0, ab_flat_c[:, S - 1],
                            vox_now)
    ab_idx = torch.cat([ab_flat_c[:, :S - 1], flat_last[:, None]], dim=-1)
    ab_val = torch.cat([ab_w_c[:, :S - 1],
                        (ab_w_c[:, S - 1] + ab_w_ph3)[:, None]], dim=-1)
    deposit_add_(tl.absorb, ab_idx.reshape(-1), ab_val.reshape(-1))

    direction = torch.where(do_scatter[:, None], dir_scattered, direction)
    tau = torch.where(do_scatter, -torch.log(u[:, _U_TAU]), tau)
    steps = steps + do_scatter.to(torch.int32)
    nscatt = nscatt + torch.sum(do_scatter.to(dtype))
    n_interactions = torch.sum(interact, dtype=torch.int32) + out["n_inter"]

    mom_pos, mom_pos2 = out["mom_pos"], out["mom_pos2"]
    if cfg.record_moments:
        order = torch.where(do_scatter, steps, 0)
        oh = (order[:, None] - 1 == torch.arange(4, device=dev)).to(dtype)
        mom_pos = mom_pos + oh.T @ pos
        mom_pos2 = mom_pos2 + oh.T @ (pos * pos)

    died = do_absorb
    if cfg.max_scatter_order > 0:
        died = died | (steps > cfg.max_scatter_order)
    alive = alive & ~died

    perf = tl.perf + torch.stack([
        torch.sum(deps_k > 0.0, dtype=torch.int32),
        torch.sum(alive, dtype=torch.int32),
        torch.sum(need_seg, dtype=torch.int32),
        n_interactions,
    ])

    new_state = replace(
        st, pos=pos, dir=direction, weight=weight, layer=layer, tau=tau,
        seg_rem=seg_rem, seg_interact=seg_interact, seg_srf=seg_srf,
        seg_cont=seg_cont, seg_prim=seg_prim, alive=alive, bounces=bounces,
        steps=steps, phase=phase, wavelength=wavelength)
    new_tallies = replace(tl, nscatt=nscatt, mom_pos=mom_pos,
                          mom_pos2=mom_pos2, perf=perf)
    return SimCarry(state=new_state, tallies=new_tallies, bank=None,
                    launched=launched, step=carry.step + 1)


def _run_steps(scene, source, grid, generator, carry, cfg, n_steps,
               nphotons):
    """Advance up to ``n_steps`` megasteps with no host synchronisation.
    A megastep taken once the run is finished (budget spent, no lane
    alive) changes no tally and is not counted in ``step``."""
    for _ in range(n_steps):
        more = (carry.launched < nphotons) | torch.any(carry.state.alive)
        step = carry.step
        carry = transport_step(carry, scene, source, grid, generator, cfg,
                               nphotons)
        carry.step = step + more.to(torch.int32)
    return carry


def _compact_lanes(carry: SimCarry, new_B: int) -> SimCarry:
    """Gather the surviving lanes into a smaller wavefront (once the photon
    budget is exhausted), alive lanes first in a stable order."""
    order = torch.argsort((~carry.state.alive).to(torch.int8),
                          stable=True)[:new_B]
    st = carry.state
    new_state = LaneState(**{f.name: getattr(st, f.name)[order]
                             for f in dataclasses.fields(LaneState)})
    return SimCarry(state=new_state, tallies=carry.tallies, bank=None,
                    launched=carry.launched, step=carry.step)


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
    build and no first-use allocation.  Leaves no tally behind."""
    cfg.check_ported()
    if bank is not None:
        raise NotImplementedError(
            "detector banks are not ported (ROADMAP queue 1, item 7)")
    if scene.device.type == "cuda":
        from .. import _build

        _build.load()
    for lanes in shrink_ladder(cfg.n_lanes, min_lanes):
        cfg_l = replace(cfg, n_lanes=lanes)
        carry = init_carry(grid, cfg_l)
        _run_steps(scene, source, grid, generator, carry, cfg_l, 1,
                   max(lanes // 8, 1))
    if scene.device.type == "cuda":
        torch.cuda.synchronize(scene.device)


def simulate(scene: Scene, source: Source, grid: CartGrid,
             generator: torch.Generator, cfg: TransportConfig, bank=None,
             chunk_steps: int = 16, progress=None, nphotons=None,
             tail_shrink: bool = True, min_lanes: int = 4096):
    """Run a full forward simulation; returns (tallies, detector bank
    (None), photons launched, megasteps executed) -- the last two as 0-d
    int32 tensors.

    Work is dispatched in chunks of ``chunk_steps`` megasteps with one
    host synchronisation per chunk (on ``launched`` and the alive count);
    ``progress(launched, nphotons, step, carry)`` is called per chunk.
    Once the photon budget is spent and at most 1/8 of the lanes live,
    the survivors are compacted into a wavefront 1/8 as wide
    (``tail_shrink``)."""
    cfg.check_ported()
    if bank is not None:
        raise NotImplementedError(
            "detector banks are not ported (ROADMAP queue 1, item 7)")
    n_target = int(cfg.nphotons if nphotons is None else nphotons)
    cur_cfg = cfg
    carry = init_carry(grid, cfg)
    step = 0
    while True:
        # at tail widths use longer chunks: host round trips dominate there
        cur_chunk = (chunk_steps if cur_cfg.n_lanes > 1024
                     else 8 * chunk_steps)
        cur_chunk = min(cur_chunk, cfg.max_steps - step)
        carry = _run_steps(scene, source, grid, generator, carry, cur_cfg,
                           cur_chunk, n_target)
        launched = int(carry.launched)
        step = int(carry.step)
        if progress is not None:
            progress(launched, n_target, step, carry)
        if step >= cfg.max_steps:
            break
        n_alive = int(torch.sum(carry.state.alive))
        if launched >= n_target and n_alive == 0:
            break
        if (tail_shrink and launched >= n_target
                and cur_cfg.n_lanes > min_lanes
                and n_alive <= cur_cfg.n_lanes // 8):
            new_B = max(min_lanes, cur_cfg.n_lanes // 8)
            carry = _compact_lanes(carry, new_B)
            cur_cfg = replace(cur_cfg, n_lanes=new_B)
    return carry.tallies, None, carry.launched, carry.step
