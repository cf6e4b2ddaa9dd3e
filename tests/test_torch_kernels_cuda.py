"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips (with its reason) where no CUDA
device is present: a CUDA kernel has no CPU build.  The file imports only
numpy, torch and the port, so it also runs on a GPU machine that has no
JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerance: atol 1e-4, the reference's own for its kernels
(``tests/test_kernels.py``).  The fill kernel's counts are integers and
its reductions are mins, so it matches the plain version to the last bit
in practice; the score kernel sums its 72 slots in another order than
PyTorch does.
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


def _fill_problem(seed, b, f, l, device):
    rng = np.random.default_rng(seed)
    demands = rng.uniform(0.0, 20.0, (b, f))
    routes = rng.uniform(size=(b, f, l)) > 0.5
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
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


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
