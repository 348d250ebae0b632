"""umhs_torch.ops.proposal_sampling against umhs_tpu.ops.proposal_sampling on
the CPU, with seeded numpy inputs: the s -> t warp, the stratified bins, PDF
resampling (ties of the quantiles with the CDF, rows of zero weight, the
jitter drawn from the JAX keys), the row-wise binary search, the outer
measure, and the interlevel and distortion losses with their gradients.

XLA's and torch's cumsum add in different orders (the CDFs differ in the
last bits), and a resampled edge moves by that difference over the CDF step
of its bin; so edges are held to atol 2e-5 on [0, 1], sums and losses to
rtol 1e-5, gradients to rtol 1e-4 in norm."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umhs_tpu.ops import proposal_sampling as J
from umhs_torch.ops import proposal_sampling as T


def _np(t):
    return t.detach().cpu().numpy()


# jitted: the JAX functions' Python loops cost seconds dispatched op by op
_j_resample = jax.jit(J.pdf_resample, static_argnames=("num_samples", "padding"))


def _weights(rng, r, n, zero_rows=()):
    """(r, n) weights, each row sparse (about half its bins empty), with the
    rows in `zero_rows` all zero."""
    w = rng.random((r, n)).astype(np.float32) * (rng.random((r, n)) < 0.5)
    w[list(zero_rows)] = 0.0
    return w


def _bins(rng, r, n):
    """(r, n + 1) sorted edges in [0, 1] with 0 and 1 at the ends."""
    inner = np.sort(rng.random((r, n - 1)).astype(np.float32), axis=1)
    return np.concatenate([np.zeros((r, 1), np.float32), inner, np.ones((r, 1), np.float32)], 1)


def _jitter(key, r):
    """The JAX package's stratification draw uniform(key, (R, 1)), for the port."""
    return np.array(jax.random.uniform(key, (r, 1)))


def test_sdist_to_t_matches():
    s = np.random.default_rng(0).random(1000).astype(np.float32)
    s[:2] = [0.0, 1.0]
    for near, far in ((0.05, 1000.0), (0.5, 6.0)):
        np.testing.assert_allclose(_np(T.sdist_to_t(torch.from_numpy(s), near, far)),
                                   np.asarray(J.sdist_to_t(jnp.asarray(s), near, far)),
                                   rtol=1e-6)


@pytest.mark.parametrize("jittered", [False, True], ids=["plain", "jittered"])
def test_uniform_bins_match(jittered):
    key = jax.random.PRNGKey(7)
    jit = torch.from_numpy(_jitter(key, 33)) if jittered else None
    got = _np(T.uniform_bins(33, 64, jit))
    ref = np.asarray(J.uniform_bins(33, 64, rng=key if jittered else None))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)
    assert (np.diff(got, axis=1) >= 0).all() and (got[:, 0] == 0).all() and (got[:, -1] == 1).all()


def _near_cdf_ties(w, m, jitter, padding=0.01, eps=1e-6):
    """(R, m + 1, N) bool: bin i of the row where a quantile u lies within
    eps of cdf[i + 1], the CDF computed in f64 (u = 1 always does). There
    the bin each package picks (i or a later one whose CDF step rounds to
    the same value) depends on the last bits of its cumsum."""
    n = w.shape[1]
    p = w.astype(np.float64) + padding / n
    cdf = np.concatenate([np.zeros((len(w), 1)), np.cumsum(p / p.sum(1, keepdims=True), 1)], 1)
    u = np.broadcast_to(np.linspace(0, 1, m + 1), (len(w), m + 1))
    if jitter is not None:
        u = np.clip(u + (jitter.astype(np.float64) - 0.5) / m, 0, 1)
    return np.abs(u[:, :, None] - cdf[:, None, 1:]) <= eps


@pytest.mark.parametrize("jittered", [False, True], ids=["midpoints", "jittered"])
@pytest.mark.parametrize("n,m", [(64, 32), (256, 96), (96, 48)])
def test_pdf_resample_matches(n, m, jittered):
    """Random sparse histograms with two zero-weight rows (padding alone
    spreads their quantiles evenly). Every edge within atol 2e-5 but those
    of quantiles within 1e-6 of a CDF value (_near_cdf_ties): there a last
    bit of the cumsum decides the bin, and over a run of empty bins (each
    holding padding / N) the edge can land a bin or more apart. Those are
    held, in both packages, to the span of the tied bins and the next one."""
    rng = np.random.default_rng(n + m)
    r = 40
    bins, w = _bins(rng, r, n), _weights(rng, r, n, zero_rows=(3, 17))
    key = jax.random.PRNGKey(n)
    jit_np = _jitter(key, r) if jittered else None
    jit = torch.from_numpy(jit_np) if jittered else None
    got = _np(T.pdf_resample(torch.from_numpy(bins), torch.from_numpy(w), m, jit))
    ref = np.asarray(_j_resample(jnp.asarray(bins), jnp.asarray(w), num_samples=m,
                                 rng=key if jittered else None))
    assert got.shape == ref.shape == (r, m + 1)
    tied_bins = _near_cdf_ties(w, m, jit_np)
    ties = tied_bins.any(-1)
    assert ties.mean() < 0.1  # u = 1, and the zero rows' even quantiles
    np.testing.assert_allclose(got[~ties], ref[~ties], rtol=0, atol=2e-5)
    for row, col in zip(*np.nonzero(ties)):
        i = np.flatnonzero(tied_bins[row, col])
        lo, hi = bins[row, i.min()], bins[row, min(i.max() + 2, n)]
        for edges in (got, ref):
            assert lo - 2e-5 <= edges[row, col] <= hi + 2e-5
    assert (np.diff(got, axis=1) >= 0).all()
    uniform = np.interp(np.linspace(0, 1, m + 1), np.linspace(0, 1, n + 1), bins[3])
    if not jittered:  # a zero row's quantiles are the even quantiles of its bins
        np.testing.assert_allclose(got[3], uniform, atol=1e-5)


def test_pdf_resample_ties_take_the_jax_bin():
    """Quantiles equal to CDF values (equal weights, no padding): each u
    falls in the first bin i with cdf[i + 1] >= u, so every output edge is
    an input edge (within two ulps of 1: the CDFs differ in their last bit);
    the row with one empty bin keeps its flat step."""
    bins = np.tile(np.linspace(0, 1, 9, dtype=np.float32) ** 2, (3, 1))
    w = np.ones((3, 8), np.float32)
    w[1, 2] = 0.0
    w[2] = [0, 0, 1, 1, 1, 1, 0, 0]
    for m in (8, 4, 16):
        got = _np(T.pdf_resample(torch.from_numpy(bins), torch.from_numpy(w), m, padding=0.0))
        ref = np.asarray(_j_resample(jnp.asarray(bins), jnp.asarray(w), num_samples=m,
                                     padding=0.0))
        np.testing.assert_allclose(got, ref, rtol=0, atol=2.5e-7)
    got = _np(T.pdf_resample(torch.from_numpy(bins[:1]), torch.from_numpy(w[:1]), 8,
                             padding=0.0))
    np.testing.assert_array_equal(got[0], bins[0])


def test_pdf_resample_gradient_matches():
    """d(sum(c * edges)) / d(bins, weights): the port's autograd through the
    gathers, the clamp and cummax against jax.grad."""
    rng = np.random.default_rng(3)
    r, n, m = 24, 32, 16
    bins, w = _bins(rng, r, n), _weights(rng, r, n) + 0.05
    c = rng.normal(size=(r, m + 1)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jg = jax.jit(jax.grad(lambda b, x: jnp.sum(c * J.pdf_resample(b, x, m, rng=key)),
                          argnums=(0, 1)))(jnp.asarray(bins), jnp.asarray(w))
    tb, tw = torch.from_numpy(bins).requires_grad_(), torch.from_numpy(w).requires_grad_()
    (torch.from_numpy(c) * T.pdf_resample(tb, tw, m, torch.from_numpy(_jitter(key, r)))
     ).sum().backward()
    for got, ref in ((tb.grad, jg[0]), (tw.grad, jg[1])):
        ref = np.asarray(ref)
        assert np.linalg.norm(ref) > 0
        assert np.linalg.norm(_np(got) - ref) <= 1e-4 * np.linalg.norm(ref)


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_rows_matches_with_ties(side):
    """Edges with repeated values and queries on them, below and above."""
    rng = np.random.default_rng(11)
    edges = np.sort(rng.integers(0, 12, (16, 17)).astype(np.float32) / 11.0, axis=1)
    x = rng.integers(-1, 13, (16, 40)).astype(np.float32) / 11.0
    got = _np(T._searchsorted_rows(torch.from_numpy(edges), torch.from_numpy(x), side))
    ref = np.asarray(jax.jit(J._searchsorted_rows, static_argnums=2)(
        jnp.asarray(edges), jnp.asarray(x), side))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, [np.searchsorted(e, q, side) for e, q in zip(edges, x)])


def test_outer_measure_matches():
    rng = np.random.default_rng(12)
    src, query = _bins(rng, 20, 48), _bins(rng, 20, 24)
    query[:4] = src[:4, ::2]  # query edges on source edges
    w = _weights(rng, 20, 48, zero_rows=(5,))
    got = _np(T._outer_measure(torch.from_numpy(query), torch.from_numpy(src),
                               torch.from_numpy(w)))
    ref = np.asarray(jax.jit(J._outer_measure)(jnp.asarray(query), jnp.asarray(src),
                                               jnp.asarray(w)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert (got[5] == 0).all()


def _loss_inputs(seed):
    rng = np.random.default_rng(seed)
    r = 32
    return (_bins(rng, r, 64), _weights(rng, r, 64, zero_rows=(2,)), _bins(rng, r, 16),
            _weights(rng, r, 16, zero_rows=(9,)))


def test_interlevel_loss_and_gradient_match():
    """Value and the gradient to the proposal's weights; the final bins and
    weights are detached (no gradient reaches them) and the proposal's
    edges get none either (they only pick the bins)."""
    pb, pw, fb, fw = _loss_inputs(21)
    jv, jg = jax.jit(jax.value_and_grad(J.interlevel_loss, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, (pb, pw, fb, fw)))
    t = [torch.from_numpy(a).requires_grad_() for a in (pb, pw, fb, fw)]
    tv = T.interlevel_loss(*t)
    tv.backward()
    tv = tv.detach()
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    ref = np.asarray(jg[1])
    assert np.linalg.norm(ref) > 0
    assert np.linalg.norm(_np(t[1].grad) - ref) <= 1e-4 * np.linalg.norm(ref)
    for i in (0, 2, 3):
        assert not np.asarray(jg[i]).any()
        assert t[i].grad is None or not t[i].grad.any()


def test_distortion_loss_and_gradient_match():
    _, _, bins, w = _loss_inputs(22)
    jv, jg = jax.value_and_grad(J.distortion_loss, argnums=(0, 1))(jnp.asarray(bins),
                                                                  jnp.asarray(w))
    tb, tw = torch.from_numpy(bins).requires_grad_(), torch.from_numpy(w).requires_grad_()
    tv = T.distortion_loss(tb, tw)
    tv.backward()
    tv = tv.detach()
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    for got, ref in ((tb.grad, jg[0]), (tw.grad, jg[1])):
        ref = np.asarray(ref)
        assert np.linalg.norm(ref) > 0
        assert np.linalg.norm(_np(got) - ref) <= 1e-4 * np.linalg.norm(ref)
