"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips (with its reason) where no CUDA
device is present: a CUDA kernel has no CPU build.  The file imports only
numpy, torch and the port, so it also runs on a GPU machine that has no
JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

The fill kernel is held to its plain version bit for bit
(``torch.equal``): its counts are integers, its reductions are mins and
its float operations are the plain version's, in its order.  The score
kernel is held at atol 1e-4, the reference's own for its kernels
(``tests/test_kernels.py``): it sums its slots in another order than
PyTorch does and adds ``B - cap`` to ``base + A``.  Where the plain score
is NaN (a zero-capacity link with zero excess), the kernel's is NaN too.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.metronome_fill import metronome_fill
from repro_torch.kernels.metronome_score import (
    metronome_score_multilink, metronome_score_multilink_batch,
    metronome_score_pairwise)

TOL = 1e-4

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    return torch.device("cuda")


def _fill_problem(seed, b, f, l, device, density=0.5):
    rng = np.random.default_rng(seed)
    demands = rng.uniform(0.0, 20.0, (b, f))
    routes = rng.uniform(size=(b, f, l)) < density
    caps = rng.uniform(5.0, 30.0, (b, l))
    return (torch.tensor(demands, dtype=torch.float32, device=device),
            torch.tensor(routes, dtype=torch.uint8, device=device),
            torch.tensor(caps, dtype=torch.float32, device=device))


def _score_problem(seed, c, l, ra, rb, s, device):
    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(0.0, 8.0, (c, l, s)),
              rng.uniform(0.0, 12.0, (c, l, ra, s)),
              rng.uniform(0.0, 12.0, (c, l, rb, s)),
              rng.uniform(18.0, 30.0, (c, l)))
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in arrays]


@pytest.mark.parametrize("b,f,l", [(1, 3, 2), (2, 9, 5), (1, 17, 130),
                                   (64, 4, 4), (64, 1272, 9),
                                   (64, 2048, 16), (2, 4096, 64)])
def test_fill_kernel_matches_plain(cuda, b, f, l):
    args = _fill_problem(b + f + l, b, f, l, cuda)
    before = metronome_fill.launches
    got = metronome_fill(*args)
    torch.cuda.synchronize()
    assert metronome_fill.launches == before + 1
    want = ref.progressive_fill_ref(*args)
    assert torch.equal(got, want)


def _fill_equal(d, r, c):
    got = metronome_fill(d, r, c)
    want, rounds = ref._fill_rounds(d, r, c)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    return got, rounds


@pytest.mark.parametrize("f,l", [(32, 9), (33, 9), (20, 32), (20, 33),
                                 (32, 32), (33, 33), (1, 1)])
def test_fill_kernel_path_edges_bit_for_bit(cuda, f, l):
    """F = 32/33 is the edge of the one-warp path, L = 32/33 the edge of
    one route-mask word."""
    _fill_equal(*_fill_problem(7 * f + l, 8, f, l, cuda))


def test_fill_kernel_many_rounds_bit_for_bit(cuda):
    """Distinct demands on sparse routes: hundreds of rounds."""
    d, r, c = _fill_problem(21, 4, 1000, 9, cuda, density=0.2)
    _, rounds = _fill_equal(d, r, c)
    assert int(rounds.max()) > 100


def test_fill_kernel_zero_capacity_link_bit_for_bit(cuda):
    for f, l in ((12, 5), (300, 9), (40, 64)):
        d, r, c = _fill_problem(f + l, 3, f, l, cuda)
        c[:, l // 2] = 0.0
        got, _ = _fill_equal(d, r, c)
        crossing = r[:, :, l // 2].bool()
        assert bool((got[crossing] == 0.0).all())


def test_fill_kernel_all_flows_inactive(cuda):
    for f, l in ((4, 4), (100, 9), (40, 40)):
        d, r, c = _fill_problem(f, 2, f, l, cuda)
        d.fill_(ref.FILL_EPS / 2)
        got, rounds = _fill_equal(d, r, c)
        assert bool((got == 0.0).all()) and int(rounds.max()) == 0


def test_fill_kernel_event_loop_bucket_of_dummies(cuda):
    """The event loop's (64, 4, 4) bucket: one real problem and 63 neutral
    dummies (one zero-demand flow, zero routes, unit capacities)."""
    d = torch.zeros((64, 4), device=cuda)
    r = torch.zeros((64, 4, 4), dtype=torch.uint8, device=cuda)
    c = torch.ones((64, 4), device=cuda)
    d[0, :3] = torch.tensor([3.0, 9.0, 0.5])
    r[0, :3, 0] = 1
    r[0, 1, 1] = 1
    c[0, :2] = torch.tensor([10.0, 4.0])
    got, _ = _fill_equal(d, r, c)
    assert bool((got[1:] == 0.0).all()) and float(got[0, 2]) == 0.5


def test_fill_padding_is_neutral(cuda):
    d = torch.zeros((1, 8), device=cuda)
    d[0, 1], d[0, 3] = 10.0, 4.0
    r = torch.zeros((1, 8, 128), dtype=torch.uint8, device=cuda)
    r[0, :4, 0] = 1
    c = torch.ones((1, 128), device=cuda)
    c[0, 0] = 8.0
    got = metronome_fill(d, r, c).cpu()
    assert got[0, 0] == 0 and got[0, 2] == 0 and bool((got[0, 4:] == 0).all())
    torch.testing.assert_close(got[0, [1, 3]], torch.tensor([4.0, 4.0]),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("c,l,ra,rb", [(1, 1, 36, 72), (1, 4, 72, 72),
                                       (8, 4, 72, 72), (64, 4, 72, 72),
                                       (3, 2, 5, 7)])
def test_score_kernel_matches_plain(cuda, c, l, ra, rb):
    base, bank_a, bank_b, caps = _score_problem(c + l, c, l, ra, rb, 72, cuda)
    got = metronome_score_multilink_batch(base, bank_a, bank_b, caps)
    want = ref.metronome_score_multilink_batch_ref(base, bank_a, bank_b, caps)
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)
    assert bool(((got >= 0) & (got <= 100)).all())
    one = metronome_score_multilink(base[0], bank_a[0], bank_b[0], caps[0])
    torch.testing.assert_close(one, want[0], atol=TOL, rtol=0)
    pair = metronome_score_pairwise(base[0, 0], bank_a[0, 0], bank_b[0, 0],
                                    float(caps[0, 0]))
    torch.testing.assert_close(
        pair, ref.metronome_score_ref(base[0, 0], bank_a[0, 0], bank_b[0, 0],
                                      float(caps[0, 0])), atol=TOL, rtol=0)


@pytest.mark.parametrize("c,l,ra,rb,s", [(1, 4, 72, 72, 71),
                                         (2, 3, 30, 50, 73),
                                         (1, 4, 25, 47, 72),
                                         (3, 1, 1, 97, 72),
                                         (2, 2, 49, 23, 8)])
def test_score_kernel_runtime_slots_and_ragged_tiles(cuda, c, l, ra, rb, s):
    """Odd S takes the runtime-S instance; Ra, Rb off the 24-row tile."""
    args = _score_problem(c * l + s, c, l, ra, rb, s, cuda)
    got = metronome_score_multilink_batch(*args)
    want = ref.metronome_score_multilink_batch_ref(*args)
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)


def test_score_kernel_operands_off_16_bytes(cuda):
    """S = 72 operands that start 4 bytes into their storage take the
    runtime-S instance and give the same scores."""
    args = _score_problem(5, 2, 4, 72, 72, 72, cuda)
    shifted = []
    for a in args:
        buf = torch.empty(a.numel() + 1, device=cuda)
        view = buf[1:].view(a.shape)
        view.copy_(a)
        shifted.append(view)
    assert shifted[0].data_ptr() % 16 != 0
    torch.testing.assert_close(metronome_score_multilink_batch(*shifted),
                               metronome_score_multilink_batch(*args),
                               atol=TOL, rtol=0)


def _nan_case(cuda, c, l, ra, rb, s=72):
    """Link 1 of zero capacity, with zero demand for even rotations: 0 / 0
    = NaN at (even a, even b), +inf (score 0) elsewhere."""
    base, bank_a, bank_b, caps = _score_problem(c + l, c, l, ra, rb, s, cuda)
    base[:, 1] = 0.0
    bank_a[:, 1, 0::2] = 0.0
    bank_b[:, 1, 0::2] = 0.0
    caps[:, 1] = 0.0
    return base, bank_a, bank_b, caps


def _same_nan(got, want):
    torch.cuda.synchronize()
    assert bool(got.isnan().any()) and not bool(got.isnan().all())
    assert torch.equal(got.isnan(), want.isnan())
    torch.testing.assert_close(got, want, atol=TOL, rtol=0, equal_nan=True)


@pytest.mark.parametrize("c,l,ra,rb,s", [(8, 4, 72, 72, 72),
                                         (1, 2, 30, 50, 73)])
def test_score_kernel_keeps_nan(cuda, c, l, ra, rb, s):
    base, bank_a, bank_b, caps = _nan_case(cuda, c, l, ra, rb, s)
    _same_nan(metronome_score_multilink_batch(base, bank_a, bank_b, caps),
              ref.metronome_score_multilink_batch_ref(base, bank_a, bank_b,
                                                      caps))
    _same_nan(metronome_score_multilink(base[0], bank_a[0], bank_b[0],
                                        caps[0]),
              ref.metronome_score_multilink_ref(base[0], bank_a[0],
                                                bank_b[0], caps[0]))
    args = (base[0, 1], bank_a[0, 1], bank_b[0, 1], 0.0)
    _same_nan(metronome_score_pairwise(*args), ref.metronome_score_ref(*args))


def test_score_padding_links_score_100(cuda):
    base, bank_a, bank_b, caps = _score_problem(9, 2, 3, 24, 36, 72, cuda)
    got = metronome_score_multilink_batch(
        torch.zeros_like(base), torch.zeros_like(bank_a),
        torch.zeros_like(bank_b), torch.ones_like(caps))
    assert bool((got == 100.0).all())


def test_ops_entry_points_launch_on_the_card(cuda):
    rng = np.random.default_rng(0)
    d = rng.uniform(0.0, 20.0, (3, 10))
    r = (rng.uniform(size=(3, 10, 4)) > 0.5).astype(float)
    c = rng.uniform(5.0, 30.0, (3, 4))
    before = metronome_fill.launches
    got = ops.progressive_fill(d, r, c, device="cuda")
    assert metronome_fill.launches == before + 1
    np.testing.assert_allclose(
        got, ops.progressive_fill(d, r, c, device="cpu"), atol=TOL, rtol=TOL)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    d = torch.zeros((1, 4), device=cuda)
    with pytest.raises(ValueError, match="uint8"):
        metronome_fill(d, torch.zeros((1, 4, 2), device=cuda),
                       torch.ones((1, 2), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        metronome_fill(d, torch.zeros((1, 2, 4), dtype=torch.uint8,
                                      device=cuda).transpose(1, 2),
                       torch.ones((1, 2), device=cuda))
    base, bank_a, bank_b, caps = _score_problem(1, 1, 1, 4, 4, 72, cuda)
    with pytest.raises(ValueError, match="float32"):
        metronome_score_multilink_batch(base.double(), bank_a, bank_b, caps)
