"""The Hopper design of the window solves (csrc/trsv_win.cu), emulated on
the CPU.

`_emulate` runs the kernels' schedule on dinvT and the card operands
`win_solve_operands` builds (P = lwT @ dinvT, and for a grouped solve the
products F of P's tails):

- pass A: C_k = B_k^T dinvT[k] over dinvT's upper triangle only, row r
  summing q = 0..r in increasing q (the stored zero half, and the B rows
  behind it, never meet row r);
- pass B: the chain over the blocks' last R = min(WL, nb) rows, in the
  tiles of tt window rows and the tg slices that `chain_plan` gives the
  launch: a slice takes a contiguous share of each tile's window rows and
  sums them in increasing order, the slices' sums meet in slice order, and
  C minus their sum is the new row, which the window takes;
- grouped (WL <= nb and enough blocks, `chain_group`): pass L, each
  group's chain from a zero window; G, the chain over the full groups'
  last blocks through F; the fix-up of the other blocks from F;
- pass C: the other rows of every block after the first, from the chain
  rows that end at the block.

It must match `trsv_win_plain` and `trsm_win_plain` (the contract) and the
JAX package's `pallas_trsv_win_inv`, `pallas_trsv_win_inv8` and
`pallas_trsm_win_inv` in interpret mode, on operands made from a numpy
seed: WL < nb, WL = nb and WL > nb (a window over several blocks, and one
of 8192 rows that the chain streams in tiles), nb off a multiple of 32, a
single block, K in {1, 3, 16, 17} for the 2-D form, f32 and f64, and a small
ILU0 factor's reversed U form. The column chunks of the multi-RHS launch
split independent columns, so the emulation takes all K at once.

The deliberate divergence: a non-finite b value in row q of a block leaves
the block's rows r < q as a triangular solve gives them (pass A never
multiplies b[q] by the zero half), where the plain version and the JAX
kernels give NaN (0 * Inf).

Operands whose tails T_k = P_k[:, nb - WL:] have a spectral norm of 0.95
(`_strong_operands`) keep the far part of a group in view: v F_j weighs in
every block of a group, so a planted fault there (F zeroed, another group's
F, no group chain, a fix-up that stops after two blocks) fails the
comparison, in the emulation and, on the card, in the kernels.

Also here: the form's card operands (built once per values and only for a
solve on the card, P equal to lwT @ dinvT, rebuilt after `refresh` and on
the forms that `update_values` and an ILU0 refactorization lead to), the
chain's launch shape against one block's shared memory, and the launch
count of a solve.

Tolerance: utils/tolerances.py's model, expected_precision(dtype) on
max |a - b| / max(|b|, 1): the same solve summed in another order,
b dinvT - w P against (b - w lwT) dinvT. `_operands` keeps every block's
map small beside the identity; `_strong_operands` makes the tails' norm
0.95, where rounding carried along a chain adds up over about 1/(1 - 0.95)
steps and stays far inside the tolerance.

The kernels themselves run in the `cuda`-marked tests here and in
tests/test_torch_trsv_win.py and tests/test_torch_spmm_kernels.py (skipped
without a card).
"""

import dataclasses


import numpy as np
import pytest
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.kernels.build import MAX_SMEM
from aoclsparse_tpu_torch.kernels.trsv_win import (
    MAX_NB,
    WinSolveOps,
    _row_stride,
    chain_group,
    chain_plan,
    solve_launches,
    trsm_chunk,
    trsm_win,
    trsm_win_plain,
    trsv_win,
    trsv_win_plain,
    win_solve_operands,
)
from aoclsparse_tpu_torch.planner import triangular as ttri
from aoclsparse_tpu_torch.solvers.ilu import ilu0_factorize
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error


@pytest.fixture(scope="module")
def pallas_trsv():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    from aoclsparse_tpu.kernels.pallas import trsv

    return trsv


def _operands(seed, nblk, nb, WL, K=None, dtype=np.float32):
    """dinvT = I + small lower-triangular noise (transposed), lwT small; b of
    nblk*nb values, or (nblk*nb, K)."""
    rng = np.random.default_rng(seed)
    dinv = np.eye(nb) + np.tril(rng.standard_normal((nblk, nb, nb))) * (0.3 / nb)
    dinvT = np.ascontiguousarray(np.swapaxes(dinv, 1, 2)).astype(dtype)
    lwT = (rng.standard_normal((nblk, WL, nb)) * (0.3 / WL)).astype(dtype)
    b = rng.standard_normal(nblk * nb if K is None else (nblk * nb, K)).astype(dtype)
    return dinvT, lwT, b


def _strong_operands(seed, nblk, nb, WL, K=None, dtype=np.float32, rho=0.95):
    """As `_operands`, with lwT made so that P = lwT @ dinvT has tails
    T_k = P_k[:, nb - WL:] = rho Q_k (WL <= nb), Q_k random orthogonal:
    ||T_k||_2 = rho, and a group's products keep ||F_j|| = rho^(j-a+1)
    (0.19 after 32 blocks at 0.95)."""
    assert WL <= nb
    rng = np.random.default_rng(seed)
    dinv = np.eye(nb) + np.tril(rng.standard_normal((nblk, nb, nb))) * (0.3 / nb)
    P = rng.standard_normal((nblk, WL, nb)) * (0.3 / WL)
    P[:, :, nb - WL :] = rho * np.linalg.qr(rng.standard_normal((nblk, WL, WL)))[0]
    # lwT dinvT = P: dinv lwT^T = P^T
    lwT = np.swapaxes(np.linalg.solve(dinv, np.swapaxes(P, 1, 2)), 1, 2)
    b = rng.standard_normal(nblk * nb if K is None else (nblk * nb, K))
    return (np.ascontiguousarray(np.swapaxes(dinv, 1, 2)).astype(dtype), np.ascontiguousarray(lwT).astype(dtype),
            b.astype(dtype))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _chain(Xf, steps, WL, R, tg, tt_, rb=False):
    """One chain launch: steps of (T, rows), T the (WL, R) operand and rows
    the step's R chain rows of Xf (C on entry, x on exit); the window is the
    last WL rows the earlier steps wrote, zero before the first. Each tile
    of tt window rows splits into tg contiguous slices, a slice sums its
    rows in increasing order, the slices meet in slice order. rb: the bf16
    instance, which rounds each chain row to bf16 as it enters the window."""
    K = Xf.shape[1]
    hist = torch.zeros(WL, K, dtype=Xf.dtype)
    for T, rows in steps:
        acc = torch.zeros(tg, R, K, dtype=Xf.dtype)
        for t0 in range(0, WL, tt_):
            tn = min(tt_, WL - t0)
            ts = -(-tn // tg)
            for g in range(tg):
                for t in range(t0 + min(g * ts, tn), t0 + min(g * ts + ts, tn)):
                    acc[g] += T[t, :, None] * hist[t][None, :]
        s = acc[0]
        for g in range(1, tg):
            s = s + acc[g]
        Xf[rows] = _round(Xf[rows] - s, rb)
        hist = torch.cat([hist, Xf[rows]])[-WL:]


def _round(x, rb):
    """x rounded to bf16 (held in f32) where rb, else x."""
    return x.to(torch.bfloat16).float() if rb else x


#: planted faults of a grouped solve, each of which a check must see: F
#: zeroed, the next group's F read, no group chain, a fix-up that stops
#: after a group's first two blocks
FAULTS = ("F zeroed", "F of the next group", "no group chain", "fix-up of two blocks")


def _emulate(dinvT, ops, b, nb, WL, fault=None, rb=False):
    """The passes in the kernels' order (module docstring); b of nblk*nb
    values or (nblk*nb, K); `fault` one of FAULTS, or None. rb: the bf16
    instance (csrc/trsv_win.cu), on bf16 operands widened to f32 and f32 P
    and F: the chain rows round to bf16 as they enter the window (pass L
    and G in the chain, pass F in the fix-up), and x rounds to bf16 at the
    end."""
    nblk = dinvT.shape[0]
    P, F, s = ops.P, ops.F, ops.group
    B = b.reshape(nblk, nb, -1)
    K = B.shape[2]
    kc = 1 if b.dim() == 1 else trsm_chunk(K, nb, WL, b.element_size())
    plan = chain_plan(nb, WL, kc, b.element_size())
    R, tg, tt_ = plan.R, plan.tg, plan.tt
    r0 = nb - R
    # A: row r takes dinvT[k, q, r] * B[k, q] for q <= r, in increasing q
    X = torch.zeros_like(B)
    for q in range(nb):
        X[:, q:, :] += dinvT[:, q, q:, None] * B[:, q, None, :]
    Xf = X.reshape(nblk * nb, K)

    def rows(k):
        return slice(k * nb + r0, (k + 1) * nb)

    if not s:  # the plain chain
        _chain(Xf, [(P[k, :, r0:], rows(k)) for k in range(nblk)], WL, R, tg, tt_, rb)
    else:
        if fault == "F zeroed":
            F = torch.zeros_like(F)
        elif fault == "F of the next group":
            F = torch.roll(F, -s, dims=0)
        # L: each group's chain from a zero window
        for a in range(0, nblk, s):
            _chain(Xf, [(P[k, :, r0:], rows(k)) for k in range(a, min(a + s, nblk))], WL, R, tg, tt_, rb)
        # G: the full groups' last blocks through their products
        full = nblk // s
        if full >= 2 and fault != "no group chain":
            _chain(Xf, [(F[g * s + s - 1], rows(g * s + s - 1)) for g in range(full)], WL, R, tg, tt_, rb)
        # F: the other blocks of the groups after the first, from the chain
        # rows before their group
        for j in range(s, nblk):
            if j % s == s - 1 and (j // s + 1) * s <= nblk:
                continue
            a = j // s * s
            if fault == "fix-up of two blocks" and j - a >= 2:
                continue
            w = Xf[a * nb - WL : a * nb].clone()
            acc = torch.zeros(R, K, dtype=b.dtype)
            for t in range(WL):
                acc += F[j, t, :, None] * w[t][None, :]
            Xf[rows(j)] = _round(Xf[rows(j)] - acc, rb)
    # C: rows r < r0 of blocks k >= 1 from the chain rows X[blk0 - WL, blk0)
    for k in range(1, nblk if r0 > 0 else 0):
        w = Xf[k * nb - WL : k * nb]
        acc = torch.zeros(r0, K, dtype=b.dtype)
        for t in range(WL):
            acc += P[k, t, :r0, None] * w[t][None, :]
        X[k, :r0] = X[k, :r0] - acc
    return X.reshape(b.shape).to(torch.bfloat16) if rb else X.reshape(b.shape)


def _far_weight(ops, x, nb, WL):
    """max |v_(a-1) F_j| over the blocks j >= a + 2 of the groups after the
    first (v_(a-1) the chain rows before block j's group, from the solve
    x), over max(max |x|, 1): what the far part of a group adds."""
    s = ops.group
    X = x.reshape(x.shape[0], -1).double()
    far = 0.0
    for j in range(s, ops.P.shape[0]):
        a = j // s * s
        if j - a >= 2:
            far = max(far, float((ops.F[j].double().T @ X[a * nb - WL : a * nb]).abs().max()))
    return far / max(float(X.abs().max()), 1.0)


def _tol(dtype):
    return expected_precision(torch.float64 if dtype == np.float64 else torch.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest tests/test_torch_*.py there")
    return torch.device("cuda", 0)


# WL < nb (grouped: 2 full groups of 4), WL = nb (a full group and a
# partial one), WL > nb (over several blocks: the plain chain), nb off a
# multiple of 32 (grouped), one block, 5 full groups, each with a 1-D b and
# K in {1, 3, 16, 17}; and an 8192-row window, which the chain streams in
# tiles, with a 1-D b and K = 3
SHAPES = [(8, 128, 64), (6, 64, 64), (5, 64, 200), (7, 100, 8), (1, 128, 64), (20, 32, 16)]
CASES = [s + (K,) for s in SHAPES for K in (None, 1, 3, 16, 17)] + [(3, 40, 8192, None), (3, 40, 8192, 3)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nblk,nb,WL,K", CASES)
def test_emulated_passes_match_plain(nblk, nb, WL, K, dtype):
    dinvT, lwT, b = _t(*_operands(nblk * 7 + WL + (K or 0), nblk, nb, WL, K, dtype))
    got = _emulate(dinvT, win_solve_operands(dinvT, lwT, nb, WL), b, nb, WL)
    want = (trsv_win_plain if K is None else trsm_win_plain)(dinvT, lwT, b, nb, WL)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert near_error(got.numpy(), want.numpy()) <= _tol(dtype)


# grouped shapes: 8 groups of 8 blocks, groups of 4 with a partial one,
# WL = nb, nb off a multiple of 32, 36 blocks in groups of 8
STRONG_SHAPES = [(64, 32, 16), (22, 64, 64), (16, 48, 48), (36, 100, 8)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("K", [None, 1, 3, 16])
@pytest.mark.parametrize("nblk,nb,WL", STRONG_SHAPES)
def test_emulated_passes_match_plain_on_strong_tails(nblk, nb, WL, K, dtype):
    """Tails of spectral norm 0.95: the far part of every group (v F_j, j >=
    a + 2) weighs in the result, and the grouped passes still hold to the
    plain version."""
    dinvT, lwT, b = _t(*_strong_operands(nblk + WL + (K or 0), nblk, nb, WL, K, dtype))
    ops = win_solve_operands(dinvT, lwT, nb, WL)
    T = ops.P[:, :, nb - WL :].double()
    assert ops.group and float(torch.linalg.matrix_norm(T, ord=2).min()) >= 0.9
    got = _emulate(dinvT, ops, b, nb, WL)
    want = (trsv_win_plain if K is None else trsm_win_plain)(dinvT, lwT, b, nb, WL)
    assert near_error(got.numpy(), want.numpy()) <= _tol(dtype)
    assert _far_weight(ops, want, nb, WL) >= 100 * _tol(np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("K", [None, 3])
@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail_the_comparison(fault, K, dtype):
    """Each planted fault of the grouped passes (FAULTS) fails the
    comparison with the plain version on strong tails, far outside the
    tolerance; the same passes without the fault hold to it."""
    nblk, nb, WL = 64, 32, 16
    dinvT, lwT, b = _t(*_strong_operands(3 + (K or 0), nblk, nb, WL, K, dtype))
    ops = win_solve_operands(dinvT, lwT, nb, WL)
    want = (trsv_win_plain if K is None else trsm_win_plain)(dinvT, lwT, b, nb, WL)
    assert near_error(_emulate(dinvT, ops, b, nb, WL).numpy(), want.numpy()) <= _tol(dtype)
    assert near_error(_emulate(dinvT, ops, b, nb, WL, fault).numpy(), want.numpy()) > 10 * _tol(np.float32)


@pytest.mark.parametrize("WL", [8, 64, 128])
@pytest.mark.parametrize("kernel", ["pallas_trsv_win_inv8", "pallas_trsv_win_inv"])
def test_emulated_passes_match_pallas_trsv(pallas_trsv, kernel, WL):
    import jax.numpy as jnp

    nblk, nb = 8, 128
    dinvT, lwT, b = _operands(WL + 5, nblk, nb, WL)
    want = np.asarray(getattr(pallas_trsv, kernel)(jnp.asarray(dinvT), jnp.asarray(lwT), jnp.asarray(b), nb, WL,
                                                   interpret=True))
    dT, lT, bt = _t(dinvT, lwT, b)
    got = _emulate(dT, win_solve_operands(dT, lT, nb, WL), bt, nb, WL)
    assert near_error(got.numpy(), want) <= _tol(np.float32)


@pytest.mark.parametrize("WL,K", [(8, 8), (64, 16), (128, 24)])
def test_emulated_passes_match_pallas_trsm(pallas_trsv, WL, K):
    import jax.numpy as jnp

    nblk, nb = 5, 128
    dinvT, lwT, B = _operands(WL + K, nblk, nb, WL, K)
    Bt = np.ascontiguousarray(B.reshape(nblk, nb, K).swapaxes(1, 2))
    Xt = pallas_trsv.pallas_trsm_win_inv(jnp.asarray(dinvT), jnp.asarray(lwT), jnp.asarray(Bt), nb, WL,
                                         interpret=True)
    want = np.asarray(Xt).swapaxes(1, 2).reshape(nblk * nb, K)
    dT, lT, Bd = _t(dinvT, lwT, B)
    got = _emulate(dT, win_solve_operands(dT, lT, nb, WL), Bd, nb, WL)
    assert near_error(got.numpy(), want) <= _tol(np.float32)


@pytest.mark.parametrize("WL,nblk", [(8, 8), (64, 16), (128, 8), (256, 8)])
def test_emulated_bf16_passes_match_pallas_trsv(pallas_trsv, WL, nblk):
    """The bf16 instance's passes (f32 sums over bf16 operands, f32 P and
    F, the window in bf16; grouped where WL <= nb, the plain chain at WL =
    256 > nb) against pallas_trsv_win_inv8 on the same bf16 operands, which
    also rounds s = w lwT and b - s to bf16 each block: within two bf16
    units in the last place (2^-6; they differ by one rounding here), far
    inside the bf16 model tolerance, and the plain version (which rounds as
    the Pallas kernel does) within the f32 one."""
    import jax.numpy as jnp

    nb = 128
    dinvT, lwT, b = (torch.from_numpy(a).to(torch.bfloat16) for a in _operands(WL + 3, nblk, nb, WL))
    want = np.asarray(pallas_trsv.pallas_trsv_win_inv8(*(jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
                                                          for t in (dinvT, lwT, b)), nb, WL, interpret=True))
    want = want.astype(np.float32)
    ops = win_solve_operands(dinvT, lwT, nb, WL)
    assert ops.P.dtype == torch.float32 and (WL > nb or ops.group > 0)
    got = _emulate(dinvT.float(), ops, b.float(), nb, WL, rb=True)
    assert got.dtype == torch.bfloat16
    assert near_error(got.float().numpy(), want) <= 2 * 2.0**-7 <= expected_precision(torch.bfloat16)
    assert near_error(trsv_win_plain(dinvT, lwT, b, nb, WL).float().numpy(), want) <= _tol(np.float32)


@pytest.mark.parametrize("K", [None, 16])
@pytest.mark.parametrize("WL", [16, 64])
def test_emulated_passes_match_pallas_on_strong_tails(pallas_trsv, WL, K):
    """The three Pallas solves in interpret mode on strong tails, 16 blocks
    of 128 rows (groups of 4: the group chain takes 4 steps)."""
    import jax.numpy as jnp

    nblk, nb = 16, 128
    dinvT, lwT, b = _strong_operands(WL + 11, nblk, nb, WL, K)
    dT, lT, bt = _t(dinvT, lwT, b)
    ops = win_solve_operands(dT, lT, nb, WL)
    got = _emulate(dT, ops, bt, nb, WL)
    assert chain_group(nblk, nb, WL) == 4 and _far_weight(ops, got, nb, WL) >= 100 * _tol(np.float32)
    if K is None:
        for kernel in ("pallas_trsv_win_inv8", "pallas_trsv_win_inv"):
            want = np.asarray(getattr(pallas_trsv, kernel)(jnp.asarray(dinvT), jnp.asarray(lwT), jnp.asarray(b), nb,
                                                           WL, interpret=True))
            assert near_error(got.numpy(), want) <= _tol(np.float32)
    else:
        Bt = np.ascontiguousarray(b.reshape(nblk, nb, K).swapaxes(1, 2))
        Xt = pallas_trsv.pallas_trsm_win_inv(jnp.asarray(dinvT), jnp.asarray(lwT), jnp.asarray(Bt), nb, WL,
                                             interpret=True)
        assert near_error(got.numpy(), np.asarray(Xt).swapaxes(1, 2).reshape(nblk * nb, K)) <= _tol(np.float32)


def _spd_band(m, halfw, seed, dtype):
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(m), 2 * halfw + 1)
    c = r + np.tile(np.arange(-halfw, halfw + 1), m)
    keep = (c >= 0) & (c < m) & ((rng.random(r.size) < 0.5) | (r == c))
    r, c = r[keep], c[keep]
    v = rng.standard_normal(r.size) * 0.2
    v[r == c] = 2.0 * halfw
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    ptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=m))]).astype(np.int32)
    return ptr, c.astype(np.int32), v.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_emulated_passes_on_ilu0_factor_forms(dtype):
    """A small ILU0 factor's unit L form and reversed U form (WL < nb)."""
    m = 1100
    ptr, ind, val = _spd_band(m, 9, 4, dtype)
    A = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    st = ilu0_factorize(A)
    assert st.u_form.reversed_ and st.u_form.WL < st.u_form.nb
    rng = np.random.default_rng(6)
    for form in (st.l_form, st.u_form):
        dT, lT = form.operands()
        for shape in ((form.m_pad,), (form.m_pad, 3)):
            b = torch.from_numpy(rng.standard_normal(shape).astype(dtype))
            got = _emulate(dT, form.solve_ops(), b, form.nb, form.WL)
            want = (trsv_win_plain if b.dim() == 1 else trsm_win_plain)(dT, lT, b, form.nb, form.WL)
            assert near_error(got.numpy(), want.numpy()) <= _tol(dtype)


def _laplacian_ilu0(nx, dtype, device="cpu"):
    """ILU0 of the 5-point 2-D Laplacian on an nx x nx grid: at nx = 90 a
    grouped win form (nb 128, WL 96, 64 blocks, groups of 8) whose tails
    are far from zero (the far part of a group weighs about 1e-2 of max |x|),
    a real factor on which the group chain and its fix-up matter."""
    m = nx * nx
    i = np.arange(m)
    r = np.concatenate([i, i[i % nx > 0], i[i % nx < nx - 1], i[i >= nx], i[i < m - nx]])
    c = np.concatenate([i, i[i % nx > 0] - 1, i[i % nx < nx - 1] + 1, i[i >= nx] - nx, i[i < m - nx] + nx])
    v = np.where(r == c, 4.0, -1.0).astype(dtype)
    order = np.lexsort((c, r))
    ptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=m))]).astype(np.int32)
    A = tt.create_csr(m, m, ptr, c[order].astype(np.int32), v[order], device=device)
    return ilu0_factorize(A)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_emulated_passes_on_grouped_laplacian_factor(dtype):
    """The 90^2 Laplacian's ILU0 L and U forms: grouped, with a far part
    that weighs; the emulated passes hold to the plain version."""
    st = _laplacian_ilu0(90, dtype)
    rng = np.random.default_rng(8)
    for form in (st.l_form, st.u_form):
        dT, lT = form.operands()
        ops = form.solve_ops()
        assert (form.nb, form.WL, dT.shape[0], ops.group) == (128, 96, 64, 8)
        b = torch.from_numpy(rng.standard_normal(form.m_pad).astype(dtype))
        got = _emulate(dT, ops, b, form.nb, form.WL)
        assert near_error(got.numpy(), trsv_win_plain(dT, lT, b, form.nb, form.WL).numpy()) <= _tol(dtype)
        assert _far_weight(ops, got, form.nb, form.WL) >= 5e-3


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_nonfinite_b_divergence(dtype):
    """Inf in b at row q of block k: the emulated passes keep rows before q
    as a finite b' (b with that row zeroed, which rows before q do not
    depend on) gives them; the plain version gives NaN in block k's rows
    r < q; row q is not finite in either."""
    nblk, nb, WL, k, q = 6, 64, 16, 3, 40
    dinvT, lwT, b = _t(*_operands(9, nblk, nb, WL, dtype=dtype))
    ops = win_solve_operands(dinvT, lwT, nb, WL)
    gq = k * nb + q
    bad, zero = b.clone(), b.clone()
    bad[gq], zero[gq] = float("inf"), 0.0
    got = _emulate(dinvT, ops, bad, nb, WL)
    ref = _emulate(dinvT, ops, zero, nb, WL)
    plain = trsv_win_plain(dinvT, lwT, bad, nb, WL)
    assert torch.isfinite(got[:gq]).all()
    assert torch.equal(got[:gq], ref[:gq])
    assert near_error(got[:gq].numpy(), trsv_win_plain(dinvT, lwT, zero, nb, WL)[:gq].numpy()) <= _tol(dtype)
    assert torch.isnan(plain[k * nb : gq]).all()
    assert not torch.isfinite(got[gq]) and not torch.isfinite(plain[gq])


def _check_ops(ops, dT, lT, nb, WL):
    """ops of (dT, lT): P = lT @ dT; for a grouped solve F_j = (-1)^(j-a)
    T_a ... T_j over the group that starts at block a, T_k = P[k][:, nb -
    WL:]; F None for a plain one."""
    P, F = ops.P, ops.F
    nblk = P.shape[0]
    s = chain_group(nblk, nb, WL)
    assert P.shape == lT.shape and P.dtype == lT.dtype and P.is_contiguous()
    np.testing.assert_allclose(P.numpy(), (lT @ dT).numpy(), rtol=1e-13, atol=1e-13)
    assert ops.group == s and (F is None) == (s == 0)
    if F is None:
        return
    assert F.shape == (nblk, WL, WL) and F.dtype == P.dtype and F.is_contiguous()
    T = P[:, :, nb - WL :]
    for j in (0, 1, s - 1, s, min(s + 2, nblk - 1), nblk - 1):
        a = j // s * s
        want = T[a].clone()
        for i in range(a + 1, j + 1):
            want = -(want @ T[i])
        np.testing.assert_allclose(F[j].numpy(), want.numpy(), rtol=1e-12, atol=1e-14)


def test_form_builds_P_once_and_after_refresh():
    """The card operands: P equals lwT @ dinvT, built once per form, only
    for a solve on the card (a CPU solve builds none), and dropped and
    rebuilt with dinvT by refresh."""
    m = 700
    ptr, ind, val = _spd_band(m, 6, 2, np.float64)
    A = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    d = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.lower)
    form = ttri.trsv_form_for(tt.optimize(A), d, tt.Operation.none)
    form.solve(torch.ones(form.m_pad, dtype=torch.float64))
    assert form._ops is not None and form._solve_ops is None  # the CPU solve needs no P
    ops = form.solve_ops()
    assert form.solve_ops() is ops  # once per form
    dT, lT = form.operands()
    _check_ops(ops, dT, lT, form.nb, form.WL)
    rng = np.random.default_rng(5)
    form.refresh(A.plan.clean.host_val() * (1.0 + 0.1 * rng.standard_normal(val.size)))
    assert form._ops is None and form._solve_ops is None
    ops2 = form.solve_ops()
    _check_ops(ops2, *form.operands(), form.nb, form.WL)
    assert not np.allclose(ops2.P.numpy(), ops.P.numpy())


def test_update_values_and_refactorization_rebuild_P():
    """After update_values the solve forms and the ILU0 factors are new, and
    so is their P: no solve runs with a stale one."""
    m = 700
    ptr, ind, val = _spd_band(m, 6, 3, np.float64)
    A = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    d = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.upper)
    old_form = ttri.trsv_form_for(tt.optimize(A), d, tt.Operation.none)
    old_P = old_form.solve_ops().P
    old_ilu = ilu0_factorize(A)
    old_uP = old_ilu.u_form.solve_ops().P
    val2 = val * (1.0 + 0.1 * np.random.default_rng(4).standard_normal(val.size))
    tt.update_values(A, val2)
    form = ttri.trsv_form_for(tt.optimize(A), d, tt.Operation.none)
    st = ilu0_factorize(A)
    assert form is not old_form and st is not old_ilu
    for f, stale in ((form, old_P), (st.l_form, None), (st.u_form, old_uP)):
        ops = f.solve_ops()
        _check_ops(ops, *f.operands(), f.nb, f.WL)
        if stale is not None:
            assert not np.allclose(ops.P.numpy(), stale.numpy())
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(m))
    x = tt.trsv(1.0, A, d, tt.Operation.none, b)
    dense = np.zeros((m, m))
    dense[np.repeat(np.arange(m), np.diff(ptr)), ind] = val2
    assert near_error(np.triu(dense) @ x.numpy(), b.numpy()) <= 1e-12


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("kc", [1, 2, 4, 16])
@pytest.mark.parametrize("nb,WL", [(256, 64), (128, 128), (64, 200), (100, 8), (128, 8192), (1024, 1024)])
def test_chain_plan_fits_one_block(nb, WL, kc, itemsize):
    """The chain's launch shape: tg slices of whole warps of rows, at most
    1024 threads (512 for several columns), at most 2 columns a CTA, the
    stages, the window and the slices' sums in one block's shared memory,
    one tile a step where two whole tails fit."""
    plan = chain_plan(nb, WL, kc, itemsize)
    kb = min(kc, 2)
    if plan is None:  # more rows than a chunk's threads, or a window over half the block
        assert (kc > 1 and min(nb, WL) > 512) or WL * _row_stride(kb, itemsize) * itemsize > MAX_SMEM // 2
        return
    rp = -(-plan.R // 32) * 32
    assert plan.R == min(nb, WL) and plan.kb == kb and plan.threads == rp * plan.tg
    assert plan.threads <= (MAX_NB if kc == 1 else 512)
    assert plan.smem <= MAX_SMEM and 2 <= plan.stages <= 8 and 1 <= plan.tt <= WL
    if WL * min(nb, WL) * itemsize * 2 < MAX_SMEM // 2:
        assert plan.tt == WL


def test_solve_launch_counts():
    # the bench ILU0 factors: A, pass L over 32 groups of 32 blocks, the
    # chain over the groups, the fix-up, C
    assert chain_group(1024, 256, 64) == 32 and solve_launches(1024, 256, 64) == 5
    assert chain_group(9, 128, 128) == 4 and solve_launches(9, 128, 128) == 4  # WL = nb: no pass C
    assert chain_group(6, 128, 64) == 4 and solve_launches(6, 128, 64) == 4  # one full group: no group chain
    assert chain_group(11, 64, 200) == 0 and solve_launches(11, 64, 200) == 2  # WL > nb: the plain chain
    assert chain_group(4, 128, 64) == 0 and solve_launches(4, 128, 64) == 3  # one group: plain
    assert solve_launches(1, 128, 64) == 2  # one block: nothing for pass C
    assert solve_launches(0, 128, 64) == 0


def test_cpu_wrapper_takes_the_plain_version_with_or_without_P():
    dinvT, lwT, b = _t(*_operands(1, 8, 32, 16, dtype=np.float64))
    ops = win_solve_operands(dinvT, lwT, 32, 16)
    assert ops.group == 4 and ops.F is not None
    want = trsv_win_plain(dinvT, lwT, b, 32, 16)
    assert torch.equal(trsv_win(dinvT, lwT, b, 32, 16, ops), want)
    assert torch.equal(trsv_win(dinvT, lwT, b, 32, 16), want)
    for bad, status in ((dataclasses.replace(ops, P=ops.P[:, :8]), tt.Status.invalid_size),
                        (dataclasses.replace(ops, F=None), tt.Status.invalid_size),
                        (dataclasses.replace(ops, group=0), tt.Status.invalid_size),
                        (dataclasses.replace(ops, P=ops.P.float()), tt.Status.wrong_type)):
        with pytest.raises(tt.AoclSparseError) as e:
            trsv_win(dinvT, lwT, b, 32, 16, bad)
        assert e.value.status == status


def _card_check(dinvT, lwT, b, nb, WL, ops, dtype):
    """The kernels on the card against the plain version: within the
    tolerance, the same bits on a second call, the launches the schedule
    has (counted by the C entry)."""
    solve, plain, counts = ((trsv_win, trsv_win_plain, trsv_win.launches) if b.dim() == 1
                            else (trsm_win, trsm_win_plain, trsm_win.launches))
    name = "f64" if dtype == np.float64 else "f32"
    before = counts[name]
    got = solve(dinvT, lwT, b, nb, WL, ops)
    torch.cuda.synchronize()
    assert counts[name] == before + solve_launches(dinvT.shape[0], nb, WL)
    assert torch.equal(solve(dinvT, lwT, b, nb, WL, ops), got)
    want = plain(dinvT, lwT, b, nb, WL)
    return got, near_error(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("K", [None, 16])
@pytest.mark.parametrize("nblk,nb,WL", STRONG_SHAPES + [(1024, 256, 64)])
def test_cuda_kernels_match_plain_on_strong_tails(cuda, nblk, nb, WL, K, dtype):
    """The kernels on strong tails (the bench ILU0 shape included, groups
    of 32 blocks): the far part of each group weighs, and the result holds
    to the plain version."""
    dinvT, lwT, b = (t.to(cuda) for t in _t(*_strong_operands(nblk + WL, nblk, nb, WL, K, dtype)))
    ops = win_solve_operands(dinvT, lwT, nb, WL)
    got, err = _card_check(dinvT, lwT, b, nb, WL, ops, dtype)
    assert err <= _tol(dtype)
    cpu_ops = WinSolveOps(ops.P.cpu(), ops.F.cpu(), ops.group)
    assert _far_weight(cpu_ops, got.cpu(), nb, WL) >= 100 * _tol(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [None, 16])
@pytest.mark.parametrize("fault", ["F zeroed", "F of the next group"])
def test_cuda_planted_faults_fail_the_comparison(cuda, fault, K):
    """The kernels given a faulty F (zeroed, or the next group's) on strong
    tails at the bench ILU0 shape: the comparison with the plain version
    fails far outside the tolerance."""
    nblk, nb, WL = 1024, 256, 64
    dinvT, lwT, b = (t.to(cuda) for t in _t(*_strong_operands(5, nblk, nb, WL, K)))
    ops = win_solve_operands(dinvT, lwT, nb, WL)
    F = torch.zeros_like(ops.F) if fault == "F zeroed" else torch.roll(ops.F, -ops.group, dims=0).contiguous()
    _got, err = _card_check(dinvT, lwT, b, nb, WL, dataclasses.replace(ops, F=F), np.float32)
    assert err > 10 * _tol(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("K", [None, 16])
def test_cuda_kernels_match_plain_on_grouped_laplacian_factor(cuda, K, dtype):
    """The 90^2 Laplacian's ILU0 L and U forms on the card (a real factor
    whose group chain and fix-up weigh): within the tolerance of the plain
    version, the same bits twice, the scheduled launches."""
    st = _laplacian_ilu0(90, dtype, device=cuda)
    rng = np.random.default_rng(10)
    for form in (st.l_form, st.u_form):
        dT, lT = form.operands()
        shape = (form.m_pad,) if K is None else (form.m_pad, K)
        b = torch.from_numpy(rng.standard_normal(shape).astype(dtype)).to(dT.device)
        ops = win_solve_operands(dT, lT, form.nb, form.WL)
        assert ops.group == 8
        _got, err = _card_check(dT, lT, b, form.nb, form.WL, ops, dtype)
        assert err <= _tol(dtype)
