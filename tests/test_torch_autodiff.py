"""``torch.autograd`` through the port's megastep against ``jax.grad``
through the reference's.

The reference (tests/test_autodiff.py) takes ``jax.grad`` of the total
fluence with respect to ``mua`` through ``transport_step``.  Here the
same scenes, carried over with ``interop``, run in the port on the
uniforms ``jax.random`` draws for each megastep (injected as
``StepDraws``), so both packages walk the same photons:

- the pure absorber box (512 lanes, 32^3, 48 megasteps, the plain walk):
  the port's gradient equals ``jax.grad`` to rel 1e-4, and the port's
  common-random-number central difference (h = 5e-3, the same draws in
  both runs) agrees within the reference test's ``max(1e-3, 2%)``;
- the autograd normal of a marched two-sphere smooth union, kept in the
  graph with ``create_graph``: its derivative in the positions and in
  the union's blend ``k`` against ``jax.grad`` of the reference's normal
  (rel 1e-4);
- the chained Fresnel sphere at 128 lanes on 16^3 for 24 megasteps: the
  gradient is finite and non-zero (the reference's slow test);
- the deposit's backward: the plain twin of ``deposit_gather`` equals
  ``jax.vjp`` of a scatter-add of the kept rows, and the autograd
  Function (its kernel stood in by the plain twin) gives ``index_add_``'s
  gradient, on a view of a tally too.

``-m slow``: that union (n = 1.38) inside a box on the chained walk (4^3,
K = 1, 10 megasteps), the fluence's gradient in ``mua`` against
``jax.grad`` (rel 1e-4; with the normals taken as constants it misses by
7%): ~20 s of JAX compile on a CPU alone, ~45 s among six test
workers; and the
chained Fresnel sphere for 4 megasteps (K = 8) against
``jax.grad`` of the path length of the lanes whose end state agrees in
both packages (a last-bit difference can send a lane another way, and
its path then differs entirely; XLA's fused gradient program rounds
differently from a megastep compiled alone, so the lanes are matched
against the gradient program's own forward): rel 1e-4.  Its JAX gradient
compiles for ~2-3 minutes on a CPU, too long for tier 1.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsmcrt_tpu.grid import cart_grid
from rsmcrt_tpu.optics.properties import mono
from rsmcrt_tpu.sdfs import scene as S
from rsmcrt_tpu.sources.sources import build_source, n_source_uniforms
from rsmcrt_tpu.transport import engine as je
from rsmcrt_tpu_torch import interop
from rsmcrt_tpu_torch.sdfs import raycast as traycast
from rsmcrt_tpu_torch.transport import deposit as tdep
from rsmcrt_tpu_torch.transport import engine as te

torch.set_num_threads(1)


def _to_np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _port(scene, grid, src, cfg):
    return (interop.scene_from_numpy(_to_np(scene)),
            interop.grid_from_numpy(_to_np(grid)),
            interop.source_from_numpy(_to_np(src)),
            te.TransportConfig(**dataclasses.asdict(cfg)))


def _jax_draws(key, n_steps, cfg, src):
    """The blocks ``jax.random`` draws for megasteps 0 .. n_steps - 1."""
    B, nsu = cfg.n_lanes, n_source_uniforms(src)

    def uni(k, shape):
        return torch.as_tensor(np.array(jax.random.uniform(
            k, shape, minval=1e-12, maxval=1.0)))

    out = []
    for i in range(n_steps):
        skey = jax.random.fold_in(key, i)
        chained = cfg.chain_scatter
        out.append(te.StepDraws(
            uni(skey, (B, nsu + 7)),
            uni(jax.random.fold_in(skey, 0x5EED),
                (B, cfg.dda_substeps, 4)) if chained else None,
            uni(jax.random.fold_in(skey, 0xC4AD),
                (cfg.chain_respawns * B, nsu + 1)) if chained else None))
    return out


def _with_mua(scene, layer, mua, stack):
    """``scene`` with ``tables.mua[layer]`` replaced by ``mua`` (JAX or
    torch, per ``stack``)."""
    m = scene.tables.mua
    tables = dataclasses.replace(
        scene.tables, mua=stack([m[:layer], mua[None], m[layer + 1:]]))
    return dataclasses.replace(scene, tables=tables)


def _jax_value_and_grad(scene, grid, src, cfg, key, n_steps, mua0, layer,
                        reduce):
    def loss(mua):
        sc = _with_mua(scene, layer, mua, jnp.concatenate)
        out = jax.lax.fori_loop(
            0, n_steps,
            lambda _, c: je.transport_step(c, sc, src, grid, key, cfg),
            je.init_carry(grid, cfg))
        return reduce(out)

    v, g = jax.jit(jax.value_and_grad(loss))(jnp.asarray(mua0, jnp.float32))
    return float(v), float(g)


def _port_loss(ts, tg, tsrc, tcfg, draws, mua, layer, reduce):
    sc = _with_mua(ts, layer, mua, torch.cat)
    c = te.init_carry(tg, tcfg)
    for d in draws:
        c = te.transport_step(c, sc, tsrc, tg, None, tcfg, draws=d)
    return reduce(c)


def _port_value_and_grad(port, draws, mua0, layer, reduce):
    m = torch.tensor(mua0, requires_grad=True)
    v = _port_loss(*port, draws, m, layer, reduce)
    (g,) = torch.autograd.grad(v, m)
    return float(v.detach()), float(g)


def test_absorber_grad_matches_jax_and_crn_difference():
    N = 48
    grid = cart_grid(32, 32, 32, 1.0, 1.0, 1.0)
    src = build_source("pencil", position=[0.0, 0.0, -0.99],
                       direction=[0.0, 0.0, 1.0])
    cfg = je.TransportConfig(nphotons=512, n_lanes=512, dda_substeps=8,
                             max_steps=N)
    key = jax.random.key(7)
    scene = S.build_scene([S.box([2.0, 2.0, 2.0], mono(0.0, 0.5, 0.0, 1.0),
                                 1)])
    jv, jg = _jax_value_and_grad(
        scene, grid, src, cfg, key, N, 0.5, 1,
        lambda out: jnp.sum(out.tallies.jmean) / cfg.nphotons)
    port = _port(scene, grid, src, cfg)
    draws = _jax_draws(key, N, cfg, src)

    def reduce(c):
        return c.tallies.jmean.sum() / cfg.nphotons

    tv, tg = _port_value_and_grad(port, draws, 0.5, 1, reduce)
    assert abs(tv - jv) <= 1e-5 * abs(jv), (tv, jv)
    assert tg < 0.0
    assert abs(tg - jg) <= 1e-4 * abs(jg), (tg, jg)
    h = 5e-3
    with torch.no_grad():
        lp, lm = (float(_port_loss(*port, draws, torch.tensor(m), 1, reduce))
                  for m in (0.5 + h, 0.5 - h))
    fd = (lp - lm) / (2 * h)
    assert abs(tg - fd) <= max(1e-3, 0.02 * abs(fd)), (tg, fd)


def _union_scene():
    opt = mono(2.0, 0.5, 0.9, 1.38)
    left, right = np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)
    left[3, 0], right[3, 0] = -0.25, 0.25  # inverse world transforms
    union = S.model([S.sphere(0.45, opt, 1, transform=left),
                     S.sphere(0.45, opt, 1, transform=right)],
                    "smooth_union", k=0.2)
    return S.build_scene([union, S.box([2.0, 2.0, 2.0],
                                       mono(0.0, 0.0, 0.0, 1.0), 2)])


def test_union_normal_derivative_matches_jax():
    """The autograd normal of the marched smooth union under
    ``create_graph``: the gradient, in the positions and in the union's
    blend ``k``, of a weighted sum of ``surface_normal`` at points near
    its surface equals ``jax.grad`` of the reference's (a second
    derivative of the SDF: rel 1e-4 of the largest entry, float32)."""
    from rsmcrt_tpu.sdfs import raycast as jraycast

    scene = _union_scene()
    ts = interop.scene_from_numpy(_to_np(scene))
    rng = np.random.default_rng(11)
    d = rng.normal(size=(64, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pos = (np.array([0.25, 0.0, 0.0]) * np.sign(d[:, :1])
           + 0.45 * d + 0.02 * rng.normal(size=(64, 3))).astype(np.float32)
    w = rng.normal(size=(64, 3)).astype(np.float32)
    idx = np.zeros(64, np.int32)  # the union, prim 0 in concat order

    def jloss(p, k):
        gp = [dict(g) for g in scene.group_params]
        gp[0]["k"] = jnp.broadcast_to(k, gp[0]["k"].shape)
        sc = dataclasses.replace(scene, group_params=gp)
        return jnp.sum(w * jraycast.surface_normal(sc, p, jnp.asarray(idx)))

    k0 = float(np.asarray(scene.group_params[0]["k"]).reshape(-1)[0])
    jp, jk = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(pos),
                                             jnp.asarray(k0, jnp.float32))
    tp = torch.tensor(pos, requires_grad=True)
    tk = torch.tensor(k0, requires_grad=True)
    gp = [dict(g) for g in ts.group_params]
    gp[0]["k"] = tk.expand(gp[0]["k"].shape)
    tsc = dataclasses.replace(ts, group_params=gp)
    n = traycast.surface_normal(tsc, tp, torch.as_tensor(idx))
    gpos, gk = torch.autograd.grad((torch.as_tensor(w) * n).sum(), (tp, tk))
    jp = np.asarray(jp)
    np.testing.assert_allclose(gpos.numpy(), jp, rtol=1e-4,
                               atol=1e-4 * np.abs(jp).max())
    assert abs(float(gk) - float(jk)) <= 1e-4 * abs(float(jk)), (gk, jk)
    assert float(gk) != 0.0


@pytest.mark.slow
def test_marched_union_grad_matches_jax(monkeypatch):
    N = 10
    grid = cart_grid(4, 4, 4, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.0])
    cfg = je.TransportConfig(nphotons=128, n_lanes=128, dda_substeps=1,
                             chain_scatter=True, max_steps=N)
    key = jax.random.key(5)
    scene = _union_scene()
    jv, jg = _jax_value_and_grad(
        scene, grid, src, cfg, key, N, 0.5, 1,
        lambda out: jnp.sum(out.tallies.jmean) / cfg.nphotons)
    port = _port(scene, grid, src, cfg)
    assert not any(traycast.analytic_column_mask(port[0])[:1])  # marched
    draws = _jax_draws(key, N, cfg, src)

    def reduce(c):
        return c.tallies.jmean.sum() / cfg.nphotons

    tv, tg = _port_value_and_grad(port, draws, 0.5, 1, reduce)
    assert abs(tv - jv) <= 1e-5 * abs(jv), (tv, jv)
    assert abs(tg - jg) <= 1e-4 * abs(jg), (tg, jg)
    # the run crossed surfaces whose normals carry the gradient: with the
    # normals taken as constants the gradient misses the reference's (by
    # 7% on this run)
    monkeypatch.setattr(traycast, "_needs_graph", lambda *a: False)
    _, tg_const = _port_value_and_grad(port, draws, 0.5, 1, reduce)
    assert abs(tg_const - jg) > 1e-2 * abs(jg), (tg_const, jg)


def test_chained_fresnel_grad_is_finite_over_24_megasteps():
    """The reference's slow test on the port: the gradient of the total
    fluence through 24 chained megasteps of the refractive sphere (inline
    scatter, Fresnel branches, raycast normals) is finite and non-zero."""
    grid = cart_grid(16, 16, 16, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.0])
    cfg = je.TransportConfig(nphotons=128, n_lanes=128, dda_substeps=8,
                             chain_scatter=True, max_steps=24)
    scene = S.build_scene([
        S.sphere(1.0, mono(10.0, 0.1, 0.9, 1.38), 1),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2),
    ])
    ts, tg, tsrc, tcfg = _port(scene, grid, src, cfg)
    gen = torch.Generator().manual_seed(3)
    draws = [te.draw_step(gen, 128, tcfg, tsrc, "cpu", ts)
             for _ in range(24)]
    _, g = _port_value_and_grad(
        (ts, tg, tsrc, tcfg), draws, 0.1, 1,
        lambda c: c.tallies.jmean.sum() / cfg.nphotons)
    assert np.isfinite(g) and g != 0.0, g


def test_builder_parameters_stay_in_the_graph():
    """A tensor that requires a gradient, handed to ``mono`` or to a prim
    builder, stays in the graph through ``build_scene``: ``mua`` given to
    ``mono`` has the gradient ``mua`` replaced in the tables has, and the
    box's edge length gets one too (finite, non-zero)."""
    from rsmcrt_tpu_torch.grid import cart_grid as tgrid
    from rsmcrt_tpu_torch.optics.properties import mono as tmono
    from rsmcrt_tpu_torch.sdfs import scene as TS
    from rsmcrt_tpu_torch.sources.sources import build_source as tsource

    grid = tgrid(32, 32, 32, 1.0, 1.0, 1.0)
    src = tsource("pencil", position=[0.0, 0.0, -0.99],
                  direction=[0.0, 0.0, 1.0])
    cfg = te.TransportConfig(nphotons=512, n_lanes=512, dda_substeps=8)
    gen = torch.Generator().manual_seed(2)
    base = TS.build_scene([TS.box([2.0, 2.0, 2.0],
                                  tmono(0.0, 0.5, 0.0, 1.0), 1)])
    draws = [te.draw_step(gen, 512, cfg, src, "cpu", base)
             for _ in range(24)]

    def run(scene):
        c = te.init_carry(grid, cfg)
        for d in draws:
            c = te.transport_step(c, scene, src, grid, None, cfg, draws=d)
        return c.tallies.jmean.sum() / 512

    # mua given to mono: the same gradient as mua replaced in the tables
    mua = torch.tensor(0.5, requires_grad=True)
    (g_mua,) = torch.autograd.grad(run(TS.build_scene([TS.box(
        [2.0, 2.0, 2.0], tmono(0.0, mua, 0.0, 1.0), 1)])), mua)
    _, g_ref = _port_value_and_grad((base, grid, src, cfg), draws, 0.5, 1,
                                    lambda c: c.tallies.jmean.sum() / 512)
    assert float(g_mua) == g_ref, (float(g_mua), g_ref)
    # a box edge (1.99: the source at z = -0.99 stays inside)
    edge = torch.tensor(1.99, requires_grad=True)
    (g_edge,) = torch.autograd.grad(run(TS.build_scene([TS.box(
        torch.stack([edge, edge, edge]), tmono(0.0, 0.5, 0.0, 1.0), 1)])),
        edge)
    assert np.isfinite(float(g_edge)) and float(g_edge) != 0.0


@pytest.mark.parametrize("signed", [False, True])
def test_gather_plain_matches_jax_vjp(signed):
    """``deposit_gather_plain`` is the transpose of the deposit: ``jax.vjp``
    of a scatter-add of the kept rows (``val > 0``, or finite ``val != 0``
    with ``signed``; out-of-range rows dropped) at a random cotangent."""
    rng = np.random.default_rng(17)
    n_cells, n = 500, 4000
    idx = rng.integers(0, n_cells, n).astype(np.int32)
    idx[::97] = n_cells + 3  # out of range (JAX drops it)
    val = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    val[::13] = 0.0
    val[5::89] = np.nan
    val[7::89] = np.inf
    cot = rng.normal(size=n_cells).astype(np.float32)

    def deposit(v):
        keep = (jnp.isfinite(v) & (v != 0.0)) if signed else v > 0.0
        return jnp.zeros(n_cells, jnp.float32).at[idx].add(
            jnp.where(keep, v, 0.0), mode="drop")

    _, vjp = jax.vjp(deposit, jnp.asarray(val))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    before = tdep.gather_plain_calls
    got = tdep.deposit_gather(torch.as_tensor(cot), torch.as_tensor(idx),
                              torch.as_tensor(val), signed=signed)
    assert tdep.gather_plain_calls == before + 1
    np.testing.assert_array_equal(got.numpy(), want)
    # a negative index is out of range too (JAX would wrap it around)
    neg = torch.as_tensor(idx).clone()
    neg[1::97] = -2
    g_neg = tdep.deposit_gather(torch.as_tensor(cot), neg,
                                torch.as_tensor(val), signed=signed)
    assert not bool(g_neg[1::97].any())
    # float64: the same rows, exactly
    g64 = tdep.deposit_gather(torch.as_tensor(cot, dtype=torch.float64),
                              torch.as_tensor(idx),
                              torch.as_tensor(val, dtype=torch.float64),
                              signed=signed)
    np.testing.assert_array_equal(g64.numpy(), want.astype(np.float64))


@pytest.mark.parametrize("signed", [False, True])
def test_autograd_function_matches_index_add(monkeypatch, signed):
    """The card's autograd Function, its kernel stood in by the plain
    twin: the same tally and the same gradients as ``index_add_``'s own
    autograd, through two deposits into one tally and one into a view of
    a 2-D tally (the escape flush deposits into ``escape_tot.view(-1)``)."""
    monkeypatch.setattr(
        tdep, "_launch_add",
        lambda t, i, v, rb, s: tdep.deposit_add_plain(t, i, v, signed=s))
    rng = np.random.default_rng(3)
    idx = torch.as_tensor(rng.integers(0, 12, 50).astype(np.int32))
    v0 = torch.as_tensor(rng.uniform(-1, 1, 50).astype(np.float32))
    w = torch.as_tensor(rng.normal(size=12).astype(np.float32))

    def run(fn):
        a = v0.clone().requires_grad_(True)
        flat = torch.zeros(12)
        fn(flat, idx, a)
        fn(flat, idx, 2.0 * a)
        base = torch.zeros(3, 4)
        fn(base.view(-1), idx, a * a)
        loss = (flat * w).sum() + (base.reshape(-1) * w).sum()
        (g,) = torch.autograd.grad(loss, a)
        return flat.detach(), base.detach(), g

    def function(t, i, v):
        assert t.device.type == "cpu"
        return tdep._DepositAdd.apply(t, i, v, signed)

    want = run(lambda t, i, v: tdep.deposit_add_plain(t, i, v, signed=signed))
    before = tdep.gather_plain_calls
    got = run(function)
    assert tdep.gather_plain_calls == before + 3
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_bfloat16_deposit_refuses_grad_mode():
    t = torch.zeros(8)
    idx = torch.tensor([1, 2], dtype=torch.int32)
    v = torch.ones(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        tdep.deposit_add_(t, idx, v, torch.bfloat16)
    with torch.no_grad():
        tdep.deposit_add_(t, idx, v, torch.bfloat16)
    assert float(t.sum()) == 2.0


def _sphere_setup():
    grid = cart_grid(16, 16, 16, 1.0, 1.0, 1.0)
    src = build_source("point", position=[0.0, 0.0, 0.0])
    cfg = je.TransportConfig(nphotons=128, n_lanes=128, dda_substeps=8,
                             chain_scatter=True, max_steps=4)
    scene = S.build_scene([
        S.sphere(1.0, mono(10.0, 0.1, 0.9, 1.38), 1),
        S.box([2.0, 2.0, 2.0], mono(0.0, 0.0, 0.0, 1.0), 2),
    ])
    return scene, grid, src, cfg


@pytest.mark.slow
def test_chained_fresnel_grad_matches_jax_on_agreeing_lanes():
    N = 4
    scene, grid, src, cfg = _sphere_setup()
    key = jax.random.key(3)
    port = _port(scene, grid, src, cfg)
    draws = _jax_draws(key, N, cfg, src)
    fields = ("phase", "pos", "tau", "steps", "bounces", "alive", "layer")

    # one compiled JAX program gives the lanes' end states and the
    # gradient of a weighted sum of their path lengths: XLA's fused
    # program rounds differently from a megastep compiled alone, so the
    # lanes are matched against the program whose gradient is compared
    def loss(mua, w):
        sc = _with_mua(scene, 1, mua, jnp.concatenate)
        out = jax.lax.fori_loop(
            0, N, lambda _, c: je.transport_step(c, sc, src, grid, key, cfg),
            je.init_carry(grid, cfg))
        st = out.state
        return jnp.sum(w * st.phase), tuple(getattr(st, f) for f in fields)

    vg = jax.jit(jax.value_and_grad(loss, has_aux=True))
    m0 = jnp.asarray(0.1, jnp.float32)
    (_, want), _ = vg(m0, jnp.ones(cfg.n_lanes, jnp.float32))
    m = torch.tensor(0.1, requires_grad=True)
    c = _port_loss(*port, draws, m, 1, lambda c: c)
    agree = np.ones(cfg.n_lanes, bool)
    for f, w in zip(fields, want):
        got, w = getattr(c.state, f).detach().numpy(), np.asarray(w)
        if got.dtype.kind == "f":
            err = np.abs(got - w)
            agree &= (err.max(-1) if err.ndim > 1 else err) < 1e-4
        else:
            agree &= got == w
    assert agree.mean() >= 0.9, agree.mean()
    (_, _), jg = vg(m0, jnp.asarray(agree, jnp.float32))
    (g,) = torch.autograd.grad(
        torch.where(torch.as_tensor(agree), c.state.phase, 0.0).sum(), m)
    g, jg = float(g), float(jg)
    assert np.isfinite(g) and g != 0.0
    assert abs(g - jg) <= 1e-4 * abs(jg), (g, jg)
