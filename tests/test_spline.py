"""B-spline stack tests: poles/basis sanity, interpolation criterion
(prefilter then evaluate at knots reproduces the input - the
reference's core correctness property, README.md:141-144), agreement
with scipy, boundary conditions, spherical prefilter pole continuity."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi

from envutil.ops import basis as B
from envutil.ops import spline as S

RNG = np.random.default_rng(7)


def test_basis_values():
    assert np.isclose(B.bspline_basis(1, 0.0), 1.0)
    assert np.isclose(B.bspline_basis(3, 0.0), 4.0 / 6.0)
    assert np.isclose(B.bspline_basis(3, 1.0), 1.0 / 6.0)
    assert np.isclose(B.bspline_basis(2, 0.0), 6.0 / 8.0)
    # partition of unity over the evaluation window, t in the split range
    for n in range(8):
        ts = RNG.uniform(0.0, 1.0, 100) if n % 2 else \
            RNG.uniform(-0.5, 0.5, 100)
        total = sum(B.bspline_basis(n, ts + n // 2 - j) for j in range(n + 1))
        np.testing.assert_allclose(total, 1.0, atol=1e-12)


def test_poles_match_published_values():
    # classic Unser pole values (same constants as zimt/poles.h)
    np.testing.assert_allclose(B.poles(2), [2.0 * math.sqrt(2.0) - 3.0],
                               atol=1e-12)
    np.testing.assert_allclose(B.poles(3), [math.sqrt(3.0) - 2.0],
                               atol=1e-12)
    p5 = B.poles(5)
    assert len(p5) == 2
    np.testing.assert_allclose(p5, [-0.43057534709997114,
                                    -0.04309628820326465], atol=1e-10)


def test_inverse_kernel_inverts_basis():
    for n in range(2, 8):
        h = B.inverse_kernel(n)
        b = B.integer_basis_values(n)
        conv = np.convolve(h, b)
        center = conv.size // 2
        delta = np.zeros_like(conv)
        delta[center] = 1.0
        np.testing.assert_allclose(conv, delta, atol=1e-9)


def test_weight_matrix_partition_of_unity():
    for n in range(8):
        m = B.weight_matrix(n)
        colsum = m.sum(axis=0)
        expect = np.zeros(n + 1)
        expect[0] = 1.0
        np.testing.assert_allclose(colsum, expect, atol=1e-9)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 5, 7])
@pytest.mark.parametrize("bc", [S.MIRROR, S.REFLECT, S.PERIODIC, S.NATURAL])
def test_interpolation_criterion(degree, bc):
    img = jnp.asarray(RNG.uniform(0, 1, (23, 31, 3)))
    spl = S.make_spline(img, degree, bcs=(bc, bc))
    ys, xs = jnp.meshgrid(jnp.arange(23.0), jnp.arange(31.0), indexing="ij")
    out = S.eval_spline(spl, xs, ys)
    got, want = np.asarray(out), np.asarray(img)
    if bc == S.NATURAL and degree > 3:
        # the NATURAL point-mirror extension (x[-i] = 2x[0] - x[i],
        # zimt's brace semantics) only zeroes the second derivative, so
        # interpolation at boundary knots is approximate for degree > 3
        # (the reference uses NATURAL only for cubic splines: cubemap
        # sections and lens LUTs). Interior knots must still be exact.
        got, want = got[4:-4, 4:-4], want[4:-4, 4:-4]
    np.testing.assert_allclose(got, want, atol=1e-9)


@pytest.mark.parametrize("degree", [2, 3, 4, 5])
def test_matches_scipy_map_coordinates(degree):
    img = RNG.uniform(0, 1, (40, 50, 1))
    spl = S.make_spline(jnp.asarray(img), degree, bcs=(S.MIRROR, S.MIRROR))
    # interior sample points (away from boundary handling differences)
    xs = RNG.uniform(5, 44, 500)
    ys = RNG.uniform(5, 34, 500)
    ours = np.asarray(S.eval_spline(spl, jnp.asarray(xs), jnp.asarray(ys)))[:, 0]
    theirs = ndi.map_coordinates(img[..., 0], np.stack([ys, xs]),
                                 order=degree, mode="mirror")
    np.testing.assert_allclose(ours, theirs, atol=1e-9)


def test_periodic_wraparound():
    img = jnp.asarray(RNG.uniform(0, 1, (8, 16, 1)))
    spl = S.make_spline(img, 3, bcs=(S.MIRROR, S.PERIODIC))
    a = S.eval_spline(spl, jnp.asarray([0.3]), jnp.asarray([4.0]))
    b = S.eval_spline(spl, jnp.asarray([16.3]), jnp.asarray([4.0]))
    c = S.eval_spline(spl, jnp.asarray([-15.7]), jnp.asarray([4.0]))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-9)
    np.testing.assert_allclose(np.asarray(a), np.asarray(c), atol=1e-9)


def test_spherical_prefilter_interpolates():
    img = jnp.asarray(RNG.uniform(0, 1, (16, 32, 3)))
    spl = S.make_spline(img, 3, spherical=True)
    ys, xs = jnp.meshgrid(jnp.arange(16.0), jnp.arange(32.0), indexing="ij")
    out = S.eval_spline(spl, xs, ys)
    np.testing.assert_allclose(np.asarray(out), np.asarray(img), atol=1e-8)


def test_spherical_pole_continuity():
    # crossing the pole: f(x, -0.5 - d) must equal f(x + W/2, -0.5 + d)
    img = jnp.asarray(RNG.uniform(0, 1, (16, 32, 1)))
    spl = S.make_spline(img, 3, spherical=True)
    xs = jnp.asarray(RNG.uniform(0, 32, 64))
    d = 0.3
    above = S.eval_spline(spl, xs, jnp.full_like(xs, -0.5 - d),
                          apply_gate=False)
    across = S.eval_spline(spl, jnp.mod(xs + 16.0, 32.0),
                           jnp.full_like(xs, -0.5 + d))
    np.testing.assert_allclose(np.asarray(above), np.asarray(across),
                               atol=1e-8)


def test_tiny_spherical():
    # the reference brags about handling a 2-pixel spherical correctly
    # (environment.h:341); at least it must not blow up and must
    # interpolate
    img = jnp.asarray([[[0.25], [0.75]]])  # (1, 2, 1)
    spl = S.make_spline(img, 3, spherical=True)
    out = S.eval_spline(spl, jnp.asarray([0.0, 1.0]), jnp.asarray([0.0, 0.0]))
    np.testing.assert_allclose(np.asarray(out)[:, 0], [0.25, 0.75],
                               atol=1e-8)


def test_prefilter_degree_override():
    # prefilter degree 0 + eval degree 3 = b-spline smoothing: values at
    # knots are *not* the originals, but a smoothed version
    img = jnp.asarray(RNG.uniform(0, 1, (11, 13, 1)))
    spl = S.make_spline(img, 3, prefilter_degree=0,
                        bcs=(S.MIRROR, S.MIRROR))
    out = S.eval_spline(spl, jnp.asarray([6.0]), jnp.asarray([5.0]))
    img_np = np.asarray(img[..., 0])
    expect = 0.0
    w = [1 / 6, 4 / 6, 1 / 6]
    for j in range(3):
        for k in range(3):
            expect += w[j] * w[k] * img_np[4 + j, 5 + k]
    np.testing.assert_allclose(np.asarray(out)[0, 0], expect, atol=1e-9)


@pytest.mark.parametrize("bc", [S.MIRROR, S.PERIODIC])
@pytest.mark.parametrize("degree", [2, 3, 4, 5, 6, 7])
def test_prefilter_axis_matches_oracle(degree, bc):
    """The device prefilter (truncated inverse FIR over a braced
    signal) against the oracle's exact collocation solve, on float32
    data in [0, 1]: float32 rounding of the FIR sum is the only
    residual."""
    import oracle as O
    sig = RNG.uniform(0, 1, (57, 3)).astype(np.float32)
    got = np.asarray(S.prefilter_axis(jnp.asarray(sig), 0, degree, bc))
    np.testing.assert_allclose(got, O.prefilter_1d(sig, degree, bc),
                               rtol=0, atol=2e-5)


def test_prefilter_convolution_precision_is_highest():
    """The prefilter's convolution asks for HIGHEST precision, so the
    GPU cannot run it in TF32."""
    import jax
    jaxpr = jax.make_jaxpr(
        lambda a: S.prefilter_axis(a, 0, 3, S.MIRROR))(
            jnp.zeros((16, 4), jnp.float32))
    convs = [e for e in jaxpr.jaxpr.eqns
             if e.primitive.name == "conv_general_dilated"]
    assert convs
    for e in convs:
        prec = e.params["precision"]
        assert prec in (jax.lax.Precision.HIGHEST,
                        (jax.lax.Precision.HIGHEST,) * 2), prec


@pytest.mark.parametrize("degree", [2, 3, 7])
def test_oracle_periodic_fft_solve_matches_dense(degree):
    """The oracle's Fourier-space solve for periodic signals (used for
    long sources) gives the dense collocation solve's answer."""
    import oracle as O
    sig = RNG.uniform(0, 1, (96, 2))
    np.testing.assert_allclose(O.prefilter_periodic_fft(sig, degree),
                               O.prefilter_1d(sig, degree, "periodic"),
                               rtol=0, atol=1e-12)
