"""The fill kernel's round loop, modelled in float32 numpy, against the plain
PyTorch fill (``ref.progressive_fill_ref``), bit for bit.

``csrc/metronome_fill.cu`` does not keep a rate per flow.  It rests on two
facts about the plain version's rounds:

  * every active flow has held the same rate since round 0, namely
    ``0 + inc_1 + inc_2 + ...`` added in the same order, so all active
    flows hold one bit-identical value: the problem's water ``level``;
  * rounding is monotone, so ``min_f fl(d_f - level)`` over active flows is
    ``fl(min_f d_f - level)``.

So the kernel keeps one level per problem, the remaining capacity and the
active-flow count of each link (decremented when a flow freezes, never
recounted), the saturated links as a bitmask, and each flow's route as a
bitmask of 32-bit words; a freezing flow takes the level as its rate.
:func:`fill_level` is that loop step for step in numpy float32; these
tests hold it to the plain version with ``array_equal`` on random problems
with ties, zero capacities, L = 130 (five mask words) and F >= 1,000.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

F32 = np.float32
EPS = F32(ref.FILL_EPS)
INF = F32(1e30)


def pack_routes(routes: np.ndarray) -> np.ndarray:
    """(F, L) 0/1 -> (F, ceil(L/32)) uint32 link bitmasks, link l in bit
    l % 32 of word l // 32 (the kernel's prologue)."""
    f, l = routes.shape
    words = np.zeros((f, (l + 31) // 32), dtype=np.uint32)
    for k in range(l):
        words[routes[:, k] != 0, k // 32] |= np.uint32(1 << (k % 32))
    return words


def fill_level(demands: np.ndarray, routes: np.ndarray,
               caps: np.ndarray) -> np.ndarray:
    """One problem, (F,) f32 demands, (F, L) uint8 routes, (L,) f32 caps."""
    f, n_links = routes.shape
    mask = pack_routes(routes)
    link_bits = [(k // 32, np.uint32(1 << (k % 32))) for k in range(n_links)]
    act = demands > EPS
    rate = np.zeros(f, dtype=F32)
    rem = caps.astype(F32).copy()
    cnt = np.array([int(np.count_nonzero(act & ((mask[:, w] & b) != 0)))
                    for w, b in link_bits], dtype=np.int64)
    level = F32(0.0)
    for _ in range(f + 1):
        if not act.any():
            break
        m = INF
        for k in range(n_links):
            if cnt[k] > 0:
                m = min(m, F32(rem[k] / F32(cnt[k])))
        m = min(m, F32(demands[act].min() - level))
        inc = max(m, F32(0.0))
        level = F32(level + inc)
        rem = (rem - (inc * cnt.astype(F32)).astype(F32)).astype(F32)
        sat = np.zeros(mask.shape[1], dtype=np.uint32)
        for k in range(n_links):
            if rem[k] <= EPS:
                sat[link_bits[k][0]] |= link_bits[k][1]
        blocked = ((mask & sat[None, :]) != 0).any(axis=1)
        freeze = act & (blocked | (level >= demands - EPS))
        rate[freeze] = level
        act &= ~freeze
        for k, (w, b) in enumerate(link_bits):
            cnt[k] -= int(np.count_nonzero(freeze & ((mask[:, w] & b) != 0)))
    rate[act] = level  # the F + 1 round cap, as the plain version
    return rate


def _problem(seed, b, f, l, *, ties=False, zero_cap=False, density=0.5):
    rng = np.random.default_rng(seed)
    demands = rng.uniform(0.0, 20.0, (b, f))
    if ties:  # a few distinct demands shared by many flows
        demands = rng.choice(np.array([0.0, 2.5, 4.0, 4.0, 7.5, 12.0]),
                             (b, f))
    routes = (rng.uniform(size=(b, f, l)) < density).astype(np.uint8)
    caps = rng.uniform(5.0, 30.0, (b, l))
    if zero_cap:
        caps[:, l // 2] = 0.0
    return (demands.astype(F32), routes, caps.astype(F32))


def _plain(demands, routes, caps):
    return ref.progressive_fill_ref(torch.from_numpy(demands),
                                    torch.from_numpy(routes),
                                    torch.from_numpy(caps)).numpy()


@pytest.mark.parametrize("seed,b,f,l,kw", [
    (0, 4, 9, 5, {}),
    (1, 3, 40, 9, {}),
    (2, 3, 33, 32, {}),
    (3, 2, 32, 33, {}),
    (4, 3, 60, 9, {"ties": True}),
    (5, 3, 50, 12, {"zero_cap": True}),
    (6, 2, 17, 130, {}),
    (7, 1, 1000, 9, {"density": 0.2}),
    (8, 1, 1272, 16, {"ties": True, "density": 0.3}),
    (9, 2, 200, 64, {"zero_cap": True, "density": 0.1}),
])
def test_level_model_is_the_plain_fill_bit_for_bit(seed, b, f, l, kw):
    demands, routes, caps = _problem(seed, b, f, l, **kw)
    want = _plain(demands, routes, caps)
    got = np.stack([fill_level(demands[i], routes[i], caps[i])
                    for i in range(b)])
    np.testing.assert_array_equal(got, want)


def test_level_model_on_padded_and_inactive_problems():
    """Dummy problems (one zero-demand flow), all flows inactive, and a
    bucket padded with zero-demand flows and zero-route unit-capacity
    links, as ``fluid.fill_corpus`` builds them."""
    demands = np.zeros((3, 8), dtype=F32)
    demands[0, [1, 3]] = (10.0, 4.0)
    routes = np.zeros((3, 8, 40), dtype=np.uint8)
    routes[0, :4, 0] = 1
    caps = np.ones((3, 40), dtype=F32)
    caps[0, 0] = 8.0
    want = _plain(demands, routes, caps)
    got = np.stack([fill_level(demands[i], routes[i], caps[i])
                    for i in range(3)])
    np.testing.assert_array_equal(got, want)
    assert np.all(got[1:] == 0.0) and got[0, 1] == got[0, 3] == F32(4.0)


def test_packed_routes_keep_every_link():
    rng = np.random.default_rng(3)
    routes = (rng.uniform(size=(7, 70)) < 0.5).astype(np.uint8)
    words = pack_routes(routes)
    assert words.shape == (7, 3)
    back = np.array([[(words[i, k // 32] >> np.uint32(k % 32)) & 1
                      for k in range(70)] for i in range(7)])
    np.testing.assert_array_equal(back, routes)
