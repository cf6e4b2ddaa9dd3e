"""The port's kernel layer against the JAX package's.

On the CPU each ``repro_torch.kernels`` wrapper runs its plain PyTorch
version, so these tests hold those plain versions against the JAX
package's jnp references and its Pallas kernels in interpret mode, on
numpy-seeded inputs at the shapes of ``tests/test_kernels.py``,
``tests/test_rotation.py`` and ``tests/test_perf_incremental.py``, to the
reference's own tolerance (atol 1e-4).  The CUDA kernels themselves are
held against these plain versions on the card by
``tests/test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro.core import geometry as ref_geometry
from repro.core import scoring as ref_scoring
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.metronome_fill import metronome_fill

TOL = 1e-4


def _t(x, dtype=torch.float32, device="cpu"):
    return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)


def _fill_problem(seed, b, f, l):
    rng = np.random.default_rng(seed)
    demands = rng.uniform(0.0, 20.0, (b, f))
    routes = (rng.uniform(size=(b, f, l)) > 0.5).astype(np.float64)
    caps = rng.uniform(5.0, 30.0, (b, l))
    return demands, routes, caps


def _score_problem(seed, c, l, ra=24, rb=36):
    """tests/test_perf_incremental.py's candidate-batched problem."""
    rng = np.random.default_rng(seed)
    pats = ref_geometry.pattern_matrix([1, 1, 2], [0.3, 0.25, 0.2], 72)
    banks = ref_scoring.rolled_bank(pats, [1, ra, rb])
    bw = rng.uniform(5.0, 20.0, size=(c, l, 3))
    caps = rng.uniform(18.0, 30.0, size=(c, l))
    base = bw[:, :, 0:1] * pats[0][None, None, :]
    bank_a = bw[:, :, 1, None, None] * banks[1][None, None]
    bank_b = bw[:, :, 2, None, None] * banks[2][None, None]
    return base, bank_a, bank_b, caps


# ---------------------------------------------------------------------------
# progressive fill
# ---------------------------------------------------------------------------

class TestFillPlain:
    @pytest.mark.parametrize("b,f,l", [(1, 3, 2), (2, 9, 5), (1, 17, 130),
                                       (4, 40, 9)])
    def test_matches_jnp_ref_and_interpret(self, b, f, l):
        demands, routes, caps = _fill_problem(b * 100 + f, b, f, l)
        got = ops.progressive_fill(demands, routes, caps, device="cpu")
        want = np.asarray(jref.progressive_fill_ref(demands, routes, caps))
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
        pallas = jops.progressive_fill(demands, routes, caps, interpret=True)
        np.testing.assert_allclose(got, pallas, atol=TOL, rtol=TOL)

    def test_torch_backend_is_the_plain_version(self):
        demands, routes, caps = _fill_problem(5, 3, 11, 4)
        a = ops.progressive_fill_ref(demands, routes, caps, device="cpu")
        b = ops.progressive_fill(demands, routes, caps, device="cpu")
        np.testing.assert_array_equal(a, b)

    def test_padding_is_neutral(self):
        """Zero-demand flows never activate; zero-route unit-capacity links
        never saturate (the reference's padded-neutrality case)."""
        demands = np.array([[0.0, 10.0, 0.0, 4.0]])
        routes = np.ones((1, 4, 1))
        caps = np.array([[8.0]])
        got = ops.progressive_fill(demands, routes, caps, device="cpu")
        want = np.asarray(jref.progressive_fill_ref(demands, routes, caps))
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert got[0, 0] == 0.0 and got[0, 2] == 0.0
        d_pad = np.zeros((1, 8))
        d_pad[:, :4] = demands
        r_pad = np.zeros((1, 8, 128))
        r_pad[:, :4, :1] = routes
        c_pad = np.ones((1, 128))
        c_pad[:, :1] = caps
        padded = ops.progressive_fill(d_pad, r_pad, c_pad, device="cpu")
        np.testing.assert_array_equal(padded[:, :4], got)
        assert np.all(padded[:, 4:] == 0.0)

    def test_rounds_stop_when_the_batch_drains(self):
        demands, routes, caps = _fill_problem(9, 3, 12, 3)
        rates, rounds = ref._fill_rounds(_t(demands), _t(routes, torch.uint8),
                                         _t(caps))
        assert rates.dtype == torch.float32
        assert int(rounds.max()) <= 13
        assert torch.equal(rates, ref.progressive_fill_ref(demands, routes,
                                                           caps))

    def test_wrapper_dispatches_on_the_tensor_device(self):
        demands, routes, caps = _fill_problem(11, 2, 6, 3)
        before = metronome_fill.launches
        out = metronome_fill(_t(demands), _t(routes, torch.uint8), _t(caps))
        assert metronome_fill.launches == before  # CPU: no kernel launch
        assert torch.equal(out, ref.progressive_fill_ref(demands, routes,
                                                         caps))


# ---------------------------------------------------------------------------
# joint rotation score
# ---------------------------------------------------------------------------

class TestScorePlain:
    @pytest.mark.parametrize("ra,rb,s", [(36, 72, 72), (9, 24, 72),
                                         (5, 7, 64)])
    def test_pairwise_matches_ref_and_interpret(self, ra, rb, s):
        rng = np.random.default_rng(1)
        base = rng.uniform(0, 12, s)
        a = rng.uniform(0, 15, (ra, s))
        b = rng.uniform(0, 15, (rb, s))
        got = ops.score_pairwise(base, a, b, 25.0, device="cpu")
        np.testing.assert_allclose(
            got, jref.metronome_score_ref(base, a, b, 25.0), atol=TOL)
        np.testing.assert_allclose(
            got, jops.score_pairwise(base, a, b, 25.0, interpret=True),
            atol=TOL)

    @pytest.mark.parametrize("cap", [5.0, 12.5, 25.0, 40.0])
    def test_pairwise_scores_in_bounds(self, cap):
        rng = np.random.default_rng(2)
        base = rng.uniform(0, 10, 72)
        a = rng.uniform(0, 10, (12, 72))
        b = rng.uniform(0, 10, (12, 72))
        got = ops.score_pairwise(base, a, b, cap, device="cpu")
        assert np.all(got >= 0.0) and np.all(got <= 100.0)

    @pytest.mark.parametrize("l", [1, 3])
    def test_multilink_matches_ref_and_interpret(self, l):
        base, bank_a, bank_b, caps = _score_problem(l, 1, l)
        got = ops.score_multilink(base[0], bank_a[0], bank_b[0], caps[0],
                                  device="cpu")
        assert got.shape == (24, 36)
        want = np.asarray(jref.metronome_score_multilink_ref(
            base[0], bank_a[0], bank_b[0], caps[0]))
        np.testing.assert_allclose(got, want, atol=TOL)
        pallas = jops.score_multilink(base[0], bank_a[0], bank_b[0], caps[0],
                                      interpret=True)
        np.testing.assert_allclose(got, pallas, atol=TOL)

    def test_batch_matches_ref_and_interpret(self):
        base, bank_a, bank_b, caps = _score_problem(1, 3, 3)
        got = ops.score_multilink_batch(base, bank_a, bank_b, caps,
                                        device="cpu")
        assert got.shape == (3, 24, 36)
        want = np.asarray(jref.metronome_score_multilink_batch_ref(
            base, bank_a, bank_b, caps))
        np.testing.assert_allclose(got, want, atol=TOL)
        pallas = jops.score_multilink_batch(base, bank_a, bank_b, caps,
                                            interpret=True)
        np.testing.assert_allclose(got, pallas, atol=TOL)
        for ci in range(3):
            per = ops.score_multilink(base[ci], bank_a[ci], bank_b[ci],
                                      caps[ci], device="cpu")
            np.testing.assert_allclose(got[ci], per, atol=1e-5)

    def test_zero_demand_padding_links_score_100(self):
        base, bank_a, bank_b, caps = _score_problem(2, 3, 2)
        pad = lambda x: np.concatenate(  # noqa: E731
            [x, np.zeros_like(x[:, :1])], axis=1)
        caps_pad = np.concatenate([caps, np.ones_like(caps[:, :1])], axis=1)
        want = ops.score_multilink_batch(base, bank_a, bank_b, caps,
                                         device="cpu")
        got = ops.score_multilink_batch(pad(base), pad(bank_a), pad(bank_b),
                                        caps_pad, device="cpu")
        np.testing.assert_allclose(got, want, atol=1e-6)
        zero = np.zeros_like
        only_pad = ops.score_multilink_batch(
            zero(base), zero(bank_a), zero(bank_b), np.ones_like(caps),
            device="cpu")
        assert np.all(only_pad == 100.0)


def _nan_problem(c, l, ra=6, rb=8, s=72):
    """A link of zero capacity (link 1) whose demand is zero for the even
    rotations of A and of B: its excess fraction is 0 / 0 = NaN exactly at
    (even a, even b), +inf elsewhere (score 0)."""
    base, bank_a, bank_b, caps = _score_problem(7, c, l, ra, rb)
    base[:, 1] = 0.0
    bank_a[:, 1, 0::2] = 0.0
    bank_b[:, 1, 0::2] = 0.0
    caps[:, 1] = 0.0
    return base, bank_a, bank_b, caps


class TestScoreNaN:
    """The reference's ``jnp.max`` / ``jnp.maximum`` keep a NaN excess
    fraction, and so do the port's plain versions (``amax``,
    ``clamp_min``): NaN for NaN, at the same (c, a, b)."""

    @staticmethod
    def _same(got, *wants):
        got = np.asarray(got)
        assert np.isnan(got).any() and not np.isnan(got).all()
        for want in wants:
            want = np.asarray(want)
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            np.testing.assert_allclose(got, want, atol=TOL)

    def test_batch(self):
        base, bank_a, bank_b, caps = _nan_problem(3, 3)
        got = ops.score_multilink_batch(base, bank_a, bank_b, caps,
                                        device="cpu")
        self._same(got,
                   jref.metronome_score_multilink_batch_ref(
                       base, bank_a, bank_b, caps),
                   jops.score_multilink_batch(base, bank_a, bank_b, caps,
                                              interpret=True))
        assert np.isnan(got[:, 0::2, 0::2]).all()

    def test_multilink(self):
        base, bank_a, bank_b, caps = _nan_problem(1, 2)
        got = ops.score_multilink(base[0], bank_a[0], bank_b[0], caps[0],
                                  device="cpu")
        self._same(got,
                   jref.metronome_score_multilink_ref(
                       base[0], bank_a[0], bank_b[0], caps[0]),
                   jops.score_multilink(base[0], bank_a[0], bank_b[0],
                                        caps[0], interpret=True))

    def test_pairwise(self):
        base, bank_a, bank_b, _ = _nan_problem(1, 2)
        args = (base[0, 1], bank_a[0, 1], bank_b[0, 1], 0.0)
        got = ops.score_pairwise(*args, device="cpu")
        self._same(got, jref.metronome_score_ref(*args),
                   jops.score_pairwise(*args, interpret=True))


class TestDispatch:
    def test_cuda_request_without_a_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        demands, routes, caps = _fill_problem(0, 1, 3, 2)
        with pytest.raises(RuntimeError, match="is_available"):
            ops.progressive_fill(demands, routes, caps, device="cuda")
        base, bank_a, bank_b, caps = _score_problem(0, 1, 2)
        with pytest.raises(RuntimeError, match="is_available"):
            ops.score_multilink(base[0], bank_a[0], bank_b[0], caps[0])

    def test_results_are_numpy_float32(self):
        demands, routes, caps = _fill_problem(3, 2, 5, 2)
        out = ops.progressive_fill(demands, routes, caps, device="cpu")
        assert isinstance(out, np.ndarray) and out.dtype == np.float32
