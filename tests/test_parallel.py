"""Device-mesh sharded rendering tests (virtual 8-device CPU mesh)."""

import math

import jax
import numpy as np
import pytest

from envutil.core.conventions import Projection
from envutil.core.facet import Facet
from envutil.core.metrics import get_extent, get_step
from envutil.models import environment as E
from envutil.parallel.mesh import (make_mesh, replicate_sources,
                                   sharded_render)
from envutil.runtime.args import Args
from envutil.runtime.render import build_plan, render_frame

RNG = np.random.default_rng(9)


def _make(projection, w, h, hfov):
    f = Facet(facet_no=0, nchannels=3)
    f.set_geometry(projection, w, h, hfov)
    f.step = get_step(projection, w, h, hfov)
    f.process_geometry()
    return f


def test_sharded_render_matches_single_device(devices8):
    img = RNG.uniform(0, 1, (64, 128, 3)).astype(np.float32)
    fct = _make(Projection.SPHERICAL, 128, 64, 2 * math.pi)
    src = E.make_mount_source(fct, img, 1, 1)

    args = Args()
    args.projection = Projection.RECTILINEAR
    args.width, args.height = 64, 64
    args.hfov = math.radians(80)
    args.extent = get_extent(args.projection, 64, 64, args.hfov)
    args.step = (args.extent.x1 - args.extent.x0) / 64
    args.yaw = math.radians(30)
    args.spline_degree = args.prefilter_degree = 1
    args.twine = 0
    args.synopsis = "panorama"
    args.nchannels = 3
    args.facets = [fct]
    args.solo = 0
    plan = build_plan(args, [fct])

    single = render_frame(plan, [src])

    mesh = make_mesh(devices8)
    srcs = replicate_sources([src], mesh)
    fn = sharded_render(plan, srcs, mesh)
    out = jax.block_until_ready(fn(srcs))
    assert len(out.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(out), single, atol=1e-6)


def test_render_frame_mesh_option(devices8):
    """render_frame(mesh_n=N) - the --mesh CLI path - matches the
    single-device frame and falls back cleanly when it can't shard."""
    img = RNG.uniform(0, 1, (64, 128, 3)).astype(np.float32)
    fct = _make(Projection.SPHERICAL, 128, 64, 2 * math.pi)
    src = E.make_mount_source(fct, img, 1, 1)

    args = Args()
    args.projection = Projection.RECTILINEAR
    args.width, args.height = 64, 64
    args.hfov = math.radians(80)
    args.extent = get_extent(args.projection, 64, 64, args.hfov)
    args.step = (args.extent.x1 - args.extent.x0) / 64
    args.yaw = math.radians(-20)
    args.spline_degree = args.prefilter_degree = 1
    args.twine = 0
    args.synopsis = "panorama"
    args.nchannels = 3
    args.facets = [fct]
    args.solo = 0
    plan = build_plan(args, [fct])

    single = render_frame(plan, [src])
    meshed = render_frame(plan, [src], mesh_n=8)
    np.testing.assert_allclose(meshed, single, atol=1e-6)

    # 64 rows don't divide over 7 devices: must fall back, not crash
    fallback = render_frame(plan, [src], mesh_n=7)
    np.testing.assert_allclose(fallback, single, atol=1e-6)


def test_render_frame_mesh_too_few_devices():
    """--mesh N with fewer than N devices is an error, not a silent
    single-device render."""
    img = RNG.uniform(0, 1, (32, 64, 3)).astype(np.float32)
    fct = _make(Projection.SPHERICAL, 64, 32, 2 * math.pi)
    src = E.make_mount_source(fct, img, 1, 1)
    plan = _plan_for([fct], wh=(16, 16), degree=1)
    n = len(jax.devices()) + 1
    with pytest.raises(ValueError, match=f"--mesh {n}: only"):
        render_frame(plan, [src], mesh_n=n)


@pytest.mark.parametrize("degree", [1, 3])
def test_ring_spline_eval_exact(devices8, degree):
    """Facet-sharded evaluation: coefficient row bands ring-rotated
    over the mesh (ppermute) reproduce eval_spline exactly."""
    import jax.numpy as jnp
    from envutil.ops import spline as S
    from envutil.parallel.mesh import (ring_spline_eval,
                                       shard_spline_rows)

    img = jnp.asarray(RNG.uniform(0, 1, (94, 130, 3)), np.float32)
    spl = S.make_spline(img, degree, bcs=(S.MIRROR, S.PERIODIC))
    H, W = 64, 128
    ii, jj = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    # coords wander over the whole table, including out-of-range
    # values for the gates
    x = jnp.asarray((-20 + 1.3 * jj + 9 * np.sin(ii / 9))
                    .astype(np.float32))
    y = jnp.asarray((-5 + 1.6 * ii + 7 * np.cos(jj / 13))
                    .astype(np.float32))
    ref = S.eval_spline(spl, x, y)

    mesh = make_mesh(devices8)
    sharded = shard_spline_rows(spl, mesh)
    out = ring_spline_eval(sharded, x, y, mesh)
    assert len(out.sharding.device_set) == 8
    # per-tap carry slots reduced in ascending-j order: same taps,
    # same weights, same summation order as eval_spline - equal to
    # within XLA's per-program FMA contraction (<= 2 ulp)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=4e-7, atol=4e-7)


def _plan_for(fcts, projection=Projection.RECTILINEAR, wh=(64, 64),
              hfov_deg=80.0, yaw_deg=30.0, degree=3, nch=3,
              synopsis="panorama"):
    args = Args()
    args.projection = projection
    args.width, args.height = wh
    args.hfov = math.radians(hfov_deg)
    args.extent = get_extent(projection, wh[0], wh[1], args.hfov)
    args.step = (args.extent.x1 - args.extent.x0) / wh[0]
    args.yaw = math.radians(yaw_deg)
    args.spline_degree = args.prefilter_degree = degree
    args.twine = 0
    args.synopsis = synopsis
    args.nchannels = nch
    args.facets = fcts
    args.solo = 0 if len(fcts) == 1 else -1
    return build_plan(args, fcts)


def test_ring_sharded_render_solo_bit_equal(devices8):
    """--shard_table end-to-end: a job rendering from a row-band-
    sharded coefficient table equals the replicated render to within
    FMA-contraction ulps (tiles.h:354-1337 wired as get_t/put_t)."""
    from envutil.parallel.mesh import (ring_sharded_render,
                                       shard_sources)
    from envutil.runtime.render import _render_window

    img = RNG.uniform(0, 1, (96, 192, 3)).astype(np.float32)
    fct = _make(Projection.SPHERICAL, 192, 96, 2 * math.pi)
    src = E.make_mount_source(fct, img, 3, 3)
    plan = _plan_for([fct])

    # jitted reference (the production path always jits; eager
    # execution differs from any compiled program by ~1e-5 through
    # XLA transcendental fusion)
    ref = np.asarray(jax.jit(
        lambda s: _render_window(plan, s, None))([src]), np.float32)

    mesh = make_mesh(devices8)
    srcs = shard_sources([src], mesh)
    assert len(srcs[0].spl.coeff.sharding.device_set) == 8
    out = jax.block_until_ready(ring_sharded_render(plan, srcs,
                                                    mesh)(srcs))
    assert len(out.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(out, np.float32), ref,
                               rtol=4e-7, atol=4e-7)


def test_ring_sharded_render_multi_facet(devices8):
    """Voronoi stitch from two ring-sharded facets matches the
    replicated synopsis (same arithmetic; <= 2 ulp FMA residual)."""
    from envutil.parallel.mesh import (ring_sharded_render,
                                       shard_sources)
    from envutil.runtime.render import _render_window

    fcts, srcs0 = [], []
    for i, yaw in enumerate((-15.0, 15.0)):
        img = RNG.uniform(0, 1, (80, 112, 3)).astype(np.float32)
        f = Facet(facet_no=i, nchannels=3)
        f.set_geometry(Projection.RECTILINEAR, 112, 80,
                       math.radians(70))
        f.step = get_step(Projection.RECTILINEAR, 112, 80,
                          math.radians(70))
        f.yaw = math.radians(yaw)
        f.process_geometry()
        fcts.append(f)
        srcs0.append(E.make_mount_source(f, img, 3, 3))
    plan = _plan_for(fcts, hfov_deg=60.0, yaw_deg=0.0)

    ref = np.asarray(jax.jit(
        lambda s: _render_window(plan, s, None))(srcs0), np.float32)

    mesh = make_mesh(devices8)
    srcs = shard_sources(srcs0, mesh)
    out = jax.block_until_ready(ring_sharded_render(plan, srcs,
                                                    mesh)(srcs))
    np.testing.assert_allclose(np.asarray(out, np.float32), ref,
                               rtol=4e-7, atol=4e-7)


def test_render_frame_shard_table_option(devices8):
    """render_frame(mesh_n=8, shard_table=True) - the --shard_table
    CLI path - matches the single-device frame (<= 2 ulp)."""
    img = RNG.uniform(0, 1, (64, 128, 3)).astype(np.float32)
    fct = _make(Projection.SPHERICAL, 128, 64, 2 * math.pi)
    src = E.make_mount_source(fct, img, 3, 3)
    plan = _plan_for([fct])

    single = render_frame(plan, [src])
    ringed = render_frame(plan, [src], mesh_n=8, shard_table=True)
    np.testing.assert_allclose(ringed, single, rtol=4e-7, atol=4e-7)
