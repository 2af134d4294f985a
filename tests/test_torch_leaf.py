"""Leaf physics of the PyTorch port against the JAX reference on identical
inputs: voxel lookup, HG scattering, Fresnel, transforms.

Integer outputs must be equal.  Floats: rtol 1e-5, atol 1e-6 -- the two
libraries' float32 transcendentals (sqrt, sin, cos, log) differ in the
last bits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsmcrt_tpu import grid as jgrid
from rsmcrt_tpu.maths import transforms as jtr
from rsmcrt_tpu.transport import fresnel as jfr
from rsmcrt_tpu.transport import scatter as jsc
from rsmcrt_tpu_torch import grid as tgrid
from rsmcrt_tpu_torch.maths import transforms as ttr
from rsmcrt_tpu_torch.transport import fresnel as tfr
from rsmcrt_tpu_torch.transport import scatter as tsc

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("shape,half", [((16, 16, 16), (1.0, 1.0, 1.0)),
                                        ((32, 24, 20), (1.5, 0.7, 2.0))])
def test_voxel_lookup_and_walls(shape, half):
    rng = np.random.default_rng(0)
    jg = jgrid.cart_grid(*shape, *half)
    tg = tgrid.cart_grid(*shape, *half)
    # points inside and just outside the grid
    pos = (rng.uniform(-1.2, 1.2, (4096, 3)) * np.asarray(half)
           ).astype(np.float32)
    d = _unit(rng, 4096)
    d[:64, 0] = 0.0  # axis-parallel directions hit the d == 0 branch
    jv = np.asarray(jgrid.get_voxel(jg, jnp.asarray(pos)))
    tv = tgrid.get_voxel(tg, torch.as_tensor(pos)).numpy()
    np.testing.assert_array_equal(tv, jv)
    jf, jok = jgrid.voxel_flat_index(jg, jnp.asarray(jv))
    tf, tok = tgrid.voxel_flat_index(tg, torch.as_tensor(tv))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tf.dtype == torch.int32
    _close(tgrid.wall_distance(tg, torch.as_tensor(pos), torch.as_tensor(d)),
           jgrid.wall_distance(jg, jnp.asarray(pos), jnp.asarray(d)))


@pytest.mark.parametrize("g", [0.0, 0.5, 0.9, -0.3])
def test_hg_cost_and_direction(g):
    rng = np.random.default_rng(1)
    u = rng.uniform(1e-6, 1.0, (4096,)).astype(np.float32)
    phi = rng.uniform(0.0, 2 * np.pi, (4096,)).astype(np.float32)
    d = _unit(rng, 4096)
    d[:8] = [0.0, 0.0, 1.0]  # the |nz| ~ 1 special cases
    d[8:16] = [0.0, 0.0, -1.0]
    jc = jsc.sample_hg_cost(jnp.asarray(u), g)
    tc = tsc.sample_hg_cost(torch.as_tensor(u), g)
    _close(tc, jc)
    # feed both the same cosines: near |cost| = 1 sqrt(1 - cost^2) turns a
    # last-bit difference of cost into a large one of the direction
    cost = np.array(jc)
    _close(tsc.scatter_direction(torch.as_tensor(d), torch.as_tensor(cost),
                                 torch.as_tensor(phi)),
           jsc.scatter_direction(jnp.asarray(d), jnp.asarray(cost),
                                 jnp.asarray(phi)))


@pytest.mark.parametrize("n1,n2", [(1.0, 1.38), (1.38, 1.0), (1.5, 1.5)])
def test_fresnel_reflect_refract(n1, n2):
    rng = np.random.default_rng(2)
    inc = _unit(rng, 4096)
    nrm = _unit(rng, 4096)
    nrm[:4] = inc[:4]  # normal incidence transmits
    ji, jn = jnp.asarray(inc), jnp.asarray(nrm)
    ti, tn = torch.as_tensor(inc), torch.as_tensor(nrm)
    _close(tfr.fresnel_coeff(ti, tn, n1, n2),
           jfr.fresnel_coeff(ji, jn, n1, n2))
    _close(tfr.reflect(ti, tn), jfr.reflect(ji, jn))
    # refraction only where the reference's caller allows it (no TIR)
    cos1 = np.abs(np.sum(inc * nrm, -1))
    ok = (n1 / n2) ** 2 * (1.0 - cos1 ** 2) <= 1.0
    eta = np.full((4096,), n1 / n2, np.float32)
    _close(tfr.refract(ti, tn, torch.as_tensor(eta)).numpy()[ok],
           np.asarray(jfr.refract(ji, jn, jnp.asarray(eta)))[ok])


def test_transforms():
    rng = np.random.default_rng(3)
    o = rng.uniform(-1, 1, (3,)).astype(np.float32)
    p = rng.uniform(-2, 2, (512, 3)).astype(np.float32)
    jm = jtr.invert(jtr.translate(jnp.asarray(o)))
    tm = ttr.invert(ttr.translate(o))
    _close(tm, jm)
    _close(ttr.identity(), jtr.identity())
    rot = np.array(jtr.rotate_y(30.0) @ jtr.translate(jnp.asarray(o)))
    _close(ttr.apply_transform(torch.as_tensor(rot), torch.as_tensor(p)),
           jtr.apply_transform(jnp.asarray(rot), jnp.asarray(p)))
    _close(ttr.apply_rotation(torch.as_tensor(rot), torch.as_tensor(p)),
           jtr.apply_rotation(jnp.asarray(rot), jnp.asarray(p)))
