"""The launch plan of K1 (``ops/cuda_step.plan``) and the b0 row plan of
its runner (``ops/fused_step.rhs_plan``): pure Python, no kernel and no
JAX, so they run here; the kernel that follows them runs on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from circuitsimulator_tpu_torch.ops import cuda_step
from circuitsimulator_tpu_torch.ops.fused_step import rhs_plan

torch.set_num_threads(1)

EDGES = [(N, k) for N in (1, 8, 9, 16, 17, 32, 33, 64)
         for k in (0, 2, 8, 9, 16, 17, 32)]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("N,k", EDGES)
def test_plan_team_rows_and_layout(N, k, itemsize):
    p = cuda_step.plan(N, k, 3, 12, 7, 2, itemsize)
    # the smallest team that holds the k solve rows and N rows of x at
    # most ROW_TARGET a thread
    assert p.team in cuda_step.TEAMS and p.team >= k
    assert p.rows == -(-N // p.team) <= cuda_step.ROW_TARGET
    assert not any(s >= k and -(-N // s) <= cuda_step.ROW_TARGET
                   for s in cuda_step.TEAMS if s < p.team)
    # whole warps, within the launch bounds and the shared memory
    assert p.threads % 32 == 0 and p.threads <= cuda_step.MAX_BLOCK_THREADS
    assert p.smem == p.lanes_per_block * p.team_words * itemsize
    assert p.smem <= cuda_step.SMEM_PER_BLOCK
    assert p.team_bytes % 16 == 0
    # the regions in LAYOUT order, 16-byte aligned, each as large as its
    # content; odd row strides, the solve's an odd number of 16-byte units
    # that holds its k + 1 columns
    W, align = 3, 16 // itemsize
    offs, (sG, sY, sYc, sA) = p.layout[:13], p.layout[13:]
    assert (sG, sY, sYc) == (N | 1, k | 1, (W * k) | 1)
    assert sA >= k + 1 and sA % align == 0 and (sA // align) % 2 == 1
    assert sA < k + 1 + 2 * align
    shared = p.route == "shared"
    sizes = [N * sG if shared else 0, N * sY if k else 0, k * sYc, k * sA,
             N + 1, N + 1, N, k, W * k, k, 12, 7, 2]
    assert offs[0] == 0 and all(o % align == 0 for o in offs)
    for o, size, nxt in zip(offs, sizes, list(offs[1:]) + [p.team_words]):
        assert o + size <= nxt < o + size + align
    assert p.blocks(300) * p.lanes_per_block >= 300


@pytest.mark.parametrize("N,itemsize,team,route", [
    (31, 4, 32, "registers"), (31, 8, 32, "shared"), (31, 4, 8, "shared"),
    (32, 4, 32, "registers"), (33, 4, 32, "shared"), (7, 4, 8, "registers"),
    (7, 4, 4, "shared")])
def test_plan_default_route(N, itemsize, team, route):
    """G0^-1 rows in registers where a thread owns one row of at most 32
    float32 words; shared memory otherwise."""
    assert cuda_step.default_route(N, itemsize, team) == route
    assert cuda_step.plan(N, 2, 3, 4, 1, 0, itemsize,
                          team=team).route == route


def test_plan_overrides_and_refusals():
    p = cuda_step.plan(31, 6, 3, 35, 25, 3, 4, route="shared", team=8)
    assert (p.team, p.rows, p.route) == (8, 4, "shared")   # MAX_ROWS
    assert cuda_step.plan(31, 6, 3, 35, 25, 3, 4).team == 16
    assert cuda_step.plan(7, 2, 3, 4, 1, 0, 4).team == 4
    assert cuda_step.plan(28, 22, 3, 4, 92, 0, 4).route == "registers"
    for kw in ({"route": "registers", "team": 16},   # two rows a thread
               {"team": 4},                          # team < k
               {"team": 2}):                         # not a team size
        with pytest.raises(ValueError):
            cuda_step.plan(31, 6, 3, 35, 25, 3, 4, **kw)
    with pytest.raises(ValueError):
        cuda_step.plan(31, 6, 3, 35, 25, 3, 8, route="registers")  # f64
    for N, k, W in ((65, 2, 3), (0, 2, 3), (8, 33, 3), (8, 2, 9)):
        with pytest.raises(ValueError):
            cuda_step.plan(N, k, W, 4, 1, 0, 4)


def test_plan_keeps_the_most_lanes_resident():
    """lanes per block: the most resident lanes per SM among the block
    sizes that fit (whole warps, 256 threads, 227 KB), the fewest lanes
    per block among equals."""
    for N, k, itemsize, regs in ((31, 6, 4, 96), (28, 22, 8, 128),
                                 (7, 2, 4, 64), (64, 16, 8, 128)):
        p = cuda_step.plan(N, k, 3, 40, 30, 2, itemsize, regs=regs)

        def resident(lpb):
            threads = lpb * p.team
            return lpb * min(
                cuda_step.SMEM_PER_SM
                // (lpb * p.team_bytes + cuda_step.BLOCK_RESERVE),
                cuda_step.MAX_BLOCKS_PER_SM,
                cuda_step.MAX_THREADS_PER_SM // threads,
                cuda_step.REGS_PER_SM // (threads * regs))
        fits = [s for s in range(32 // p.team, 256 // p.team + 1,
                                 32 // p.team)
                if s * p.team_bytes <= cuda_step.SMEM_PER_BLOCK]
        best = max(resident(s) for s in fits)
        assert resident(p.lanes_per_block) == best
        assert p.lanes_per_block == min(s for s in fits
                                        if resident(s) == best)


def test_rhs_plan_sums_each_row_in_scatter_order():
    """Row n of b0 summed through rhs_ptr/rhs_idx equals, bit for bit, the
    sequential scatter of the plain version (sources at pos then neg,
    inductors, capacitors at a then b, E1 at k1, E2 at k2), ground rows
    dropped."""
    rng = np.random.default_rng(0)
    N, nS, nL, nC, nT = 9, 5, 2, 6, 2
    pos, neg = rng.integers(0, N + 1, nS), rng.integers(0, N + 1, nS)
    ind = rng.integers(0, N, nL)
    ca, cb = rng.integers(0, N + 1, nC), rng.integers(0, N + 1, nC)
    k1, k2 = rng.integers(0, N, nT), rng.integers(0, N, nT)
    terms = rng.standard_normal(nS + nL + nC + 2 * nT) * 10.0 ** \
        rng.integers(-6, 6, nS + nL + nC + 2 * nT)
    sv, hl = terms[:nS], terms[nS:nS + nL]
    hc, em = terms[nS + nL:nS + nL + nC], terms[nS + nL + nC:]
    rows = np.concatenate([pos, neg, ind, ca, cb, k1, k2])
    vals = np.concatenate([sv, -sv, hl, hc, -hc, em[0::2], em[1::2]])
    want = np.zeros(N + 1)
    for r, v in zip(rows, vals):            # the sequential scatter
        want[r] += v
    ptr, idx = rhs_plan(N, pos, neg, ind, ca, cb, (k1, k2))
    assert ptr.dtype == idx.dtype == np.int32 and len(ptr) == N + 1
    got = np.zeros(N)
    for n in range(N):
        acc = 0.0
        for c in idx[ptr[n]:ptr[n + 1]]:
            acc = acc - terms[c >> 1] if c & 1 else acc + terms[c >> 1]
        got[n] = acc
    np.testing.assert_array_equal(got, want[:N])
    # no lines: no EMF terms; an empty plan still holds one index word
    ptr0, idx0 = rhs_plan(3, [3], [3], [], [], [])
    assert list(ptr0) == [0, 0, 0, 0] and len(idx0) == 1
