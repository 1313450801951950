"""bf16 and complex triangular solves of the PyTorch port, and the `diag`
branch of its mv rule, against the JAX package on the same seeded numpy
inputs (small sizes).

- bf16 window solves: the plain versions of kernels/trsv_win.py against
  the Pallas kernels (`pallas_trsv_win_inv8`, `pallas_trsm_win_inv`) in
  interpret mode, which round each product and the window to bf16;
- the bf16 band SpMM (mm KID 4): the plain version against
  `pallas_spmm_band_t(..., interpret=True)`, and `mm` on a bf16 handle
  (its `bandtm` form, a bf16 result as in the JAX package);
- complex `trsv`, `trsm` and `ilu_smoother` for every fill, diagonal and
  op (conjugate transpose included), complex `symgs` and `sorv` (complex
  omega and alpha), and bf16 `trsv` and `ilu_smoother`; bf16 `dwin` and
  `gather` forms (no chain-kernel instance) solve by the plain loops on
  the CPU and raise on the card;
- the `mv` rule: a 27-point stencil's default form is `diag` (the JAX
  rule's branch, plan.py:838-851 there) and its value is the JAX package's
  on its explicitly requested `diag` form; a full band stays on `bandt`.

Tolerances (utils/tolerances.py): the dtype's model tolerance,
expected_precision(dtype), on max |a - b| / max(|b|, 1): complex64 and
complex128 as their real parts' f32 and f64; bf16 4 sqrt(2^-6) = 0.5,
which bounds two bf16 computations that round at other places (the JAX
package factors and solves its bf16 host copy in bf16 arithmetic, the port
in f32 rounded once; its window kernel sums in f32 where the Pallas kernel
rounds each product). Where both sides round the same way the test states a
tighter bound.
"""

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse.linalg import spsolve_triangular
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.kernels.spmm_band import spmm_band, spmm_band_plain
from aoclsparse_tpu_torch.kernels.trsv_win import (
    solve_launches,
    trsm_win,
    trsm_win_plain,
    trsv_win,
    trsv_win_plain,
    win_solve_operands,
)
from aoclsparse_tpu_torch.planner import triangular as ttri
from aoclsparse_tpu_torch.planner.plan import choose_mv_format
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

GEN = tt.MatrixDescriptor()
NONE = tt.Operation.none
BF16 = expected_precision(torch.bfloat16)
C64 = expected_precision(torch.complex64)
C128 = expected_precision(torch.complex128)
F32 = expected_precision(torch.float32)
#: the bf16 window-solve kernel against its plain version: four bf16 units
#: in the last place (2^-5), as chip_smoke.py's KERNEL_TOL holds it
WIN_BF16 = 4 * 2.0**-7


@pytest.fixture(scope="module")
def ast():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu

    return aoclsparse_tpu


@pytest.fixture(scope="module")
def jnp(ast):
    import jax.numpy as jnp

    return jnp


def stencil27(nx):
    """HPCG's 27-point stencil on an nx^3 grid: (ptr, ind, val f64)."""
    g = np.arange(nx)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    rows, cols = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ok = (0 <= z + dz) & (z + dz < nx) & (0 <= y + dy) & (y + dy < nx) & (0 <= x + dx) & (x + dx < nx)
                rows.append(((z * nx + y) * nx + x)[ok])
                cols.append((((z + dz) * nx + (y + dy)) * nx + (x + dx))[ok])
    r, c = np.concatenate(rows), np.concatenate(cols)
    S = sp.csr_matrix((np.where(r == c, 26.0, -1.0), (r, c)), shape=(nx**3, nx**3))
    S.sort_indices()
    return S.indptr.astype(np.int64), S.indices.astype(np.int32), S.data


def complex_stencil(nx, sigma=1.0, dtype=np.complex128):
    """The stencil shifted by i sigma I: a complex-symmetric operand."""
    ptr, ind, val = stencil27(nx)
    rows = np.repeat(np.arange(nx**3), np.diff(ptr))
    return ptr, ind, (val + 1j * sigma * (rows == ind)).astype(dtype)


def complex_band(m, seed, dtype=np.complex128):
    """A nonsymmetric complex band (half-width 5) with a dominant diagonal."""
    rng = np.random.default_rng(seed)
    S = sp.random(m, m, density=1.0, random_state=seed, format="csr")
    S = sp.csr_matrix(sp.tril(sp.triu(S, -5), 5))
    S.data = rng.standard_normal(S.nnz) + 1j * rng.standard_normal(S.nnz)
    S = (S + sp.diags(np.full(m, 12.0 + 2.0j))).tocsr()
    S.sort_indices()
    return S.indptr.astype(np.int64), S.indices.astype(np.int32), S.data.astype(dtype)


def pair(ast, jnp, ptr, ind, val, jdtype=None, tdtype=None):
    m = len(ptr) - 1
    J = ast.create_csr(m, m, ptr, ind, jnp.asarray(val, dtype=jdtype) if jdtype is not None else val)
    tv = torch.from_numpy(np.asarray(val))
    T = tt.create_csr(m, m, ptr, ind, tv if tdtype is None else tv.to(tdtype), device="cpu")
    return J, T


def rhs(m, seed, k=None, complex_=True):
    rng = np.random.default_rng(seed)
    shape = (m,) if k is None else (m, k)
    b = rng.standard_normal(shape)
    return b + 1j * rng.standard_normal(shape) if complex_ else b


def tri(lib, fill, diag):
    return lib.MatrixDescriptor(type=lib.MatrixType.triangular, fill_mode=getattr(lib.FillMode, fill),
                                diag_type=getattr(lib.DiagType, diag))


def err(got, want):
    return near_error(got.to(torch.complex128).numpy(), np.asarray(want, dtype=np.complex128))


# ------------------------------------------------------------------ bf16 window solves


def _win_operands(seed, nblk, nb, WL, K=None):
    """dinvT = I + small lower-triangular noise (transposed), lwT small; b
    (the operands of tests/test_torch_win_solve_passes.py), in bf16."""
    rng = np.random.default_rng(seed)
    dinv = np.eye(nb) + np.tril(rng.standard_normal((nblk, nb, nb))) * (0.3 / nb)
    dinvT = np.ascontiguousarray(np.swapaxes(dinv, 1, 2)).astype(np.float32)
    lwT = (rng.standard_normal((nblk, WL, nb)) * (0.3 / WL)).astype(np.float32)
    b = rng.standard_normal(nblk * nb if K is None else (nblk * nb, K)).astype(np.float32)
    return [torch.from_numpy(a).to(torch.bfloat16) for a in (dinvT, lwT, b)]


def _jbf(jnp, t):
    return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


@pytest.mark.parametrize("WL", [8, 64, 128])
def test_bf16_trsv_win_plain_matches_pallas(ast, jnp, WL):
    """The plain version rounds where pallas_trsv_win_inv8 rounds (each
    jnp.dot summed in f32 and rounded to bf16, the bf16 window): the same
    bf16 values up to the f32 sums' order, within the f32 model tolerance."""
    from aoclsparse_tpu.kernels.pallas.trsv import pallas_trsv_win_inv8

    nblk, nb = 8, 128
    dT, lT, b = _win_operands(WL, nblk, nb, WL)
    want = np.asarray(pallas_trsv_win_inv8(_jbf(jnp, dT), _jbf(jnp, lT), _jbf(jnp, b), nb, WL, interpret=True))
    got = trsv_win_plain(dT, lT, b, nb, WL)
    assert got.dtype == torch.bfloat16
    assert near_error(got.float().numpy(), want.astype(np.float32)) <= F32
    # the CPU wrapper takes the plain version; the card's operands are f32
    assert torch.equal(trsv_win(dT, lT, b, nb, WL), got)
    ops = win_solve_operands(dT, lT, nb, WL)
    assert ops.P.dtype == torch.float32 and (ops.F is None or ops.F.dtype == torch.float32)
    assert solve_launches(nblk, nb, WL, torch.bfloat16) == solve_launches(nblk, nb, WL) + 1


@pytest.mark.parametrize("WL,K", [(8, 8), (64, 16)])
def test_bf16_trsm_win_plain_matches_pallas(ast, jnp, WL, K):
    """pallas_trsm_win_inv on bf16 operands (B transposed per block): the
    same roundings, within the f32 model tolerance."""
    from aoclsparse_tpu.kernels.pallas.trsv import pallas_trsm_win_inv

    nblk, nb = 5, 128
    dT, lT, B = _win_operands(WL + K, nblk, nb, WL, K)
    Bt = B.reshape(nblk, nb, K).transpose(1, 2).contiguous()
    Xt = pallas_trsm_win_inv(_jbf(jnp, dT), _jbf(jnp, lT), _jbf(jnp, Bt), nb, WL, interpret=True)
    want = np.asarray(Xt).astype(np.float32).swapaxes(1, 2).reshape(nblk * nb, K)
    got = trsm_win_plain(dT, lT, B, nb, WL)
    assert got.dtype == torch.bfloat16
    assert near_error(got.float().numpy(), want) <= F32


# ------------------------------------------------------------------ bf16 band SpMM


@pytest.mark.parametrize("m,n,W,start,padL", [(300, 300, 16, 0, 8), (257, 250, 40, 3, 11)])
def test_bf16_spmm_band_plain_matches_pallas(ast, jnp, m, n, W, start, padL):
    """A bf16 band, B and C f32 (pallas_spmm_band_t casts the band column
    and B to its f32 output): the same products summed in another order."""
    from aoclsparse_tpu.kernels.pallas.spmv import pallas_spmm_band_t

    rng = np.random.default_rng(m + W)
    v = torch.from_numpy(rng.standard_normal((m, W)).astype(np.float32)).to(torch.bfloat16)
    B = rng.standard_normal((n, 128)).astype(np.float32)
    Be = jnp.asarray(np.pad(B, ((padL, 0), (0, 0))))
    want = np.asarray(pallas_spmm_band_t(_jbf(jnp, v), Be, W, start, TM=64, interpret=True))
    assert want.dtype == np.float32
    got = spmm_band(v, torch.from_numpy(B), start, padL)
    assert got.dtype == torch.float32
    assert near_error(got.numpy(), want) <= F32
    with pytest.raises(tt.AoclSparseError) as e:  # the kernel moves the bf16 band in column pairs
        spmm_band(v[:, :-1].contiguous(), torch.from_numpy(B), start, padL)
    assert e.value.status == tt.Status.invalid_size


def test_bf16_mm_takes_bandtm(ast, jnp):
    """mm on a bf16 handle: the bandtm form (choose_mm_format), the band
    product in f32 (the JAX package's kernel output) and a bf16 result, as
    the JAX package's mm returns; against float64 scipy on the bf16 values
    within the bf16 model tolerance, and against the f32 band product."""
    m, K = 512, 64
    rng = np.random.default_rng(3)
    S = sp.random(m, m, density=1.0, random_state=3, format="csr")
    S = sp.csr_matrix(sp.tril(sp.triu(S, -8), 8))
    S.data = rng.standard_normal(S.nnz)
    S.sort_indices()
    T = tt.create_csr(m, m, S.indptr, S.indices, torch.from_numpy(S.data).to(torch.bfloat16), device="cpu")
    B = torch.from_numpy(rng.standard_normal((m, K))).to(torch.bfloat16)
    C = tt.mm(1.0, T, GEN, NONE, B, 0.0)
    assert C.dtype == torch.bfloat16
    assert [k[-1] for k in T.plan.exec_forms] == ["bandtm"]
    Sv = sp.csr_matrix((torch.from_numpy(S.data).to(torch.bfloat16).double().numpy(), S.indices, S.indptr),
                       shape=(m, m))
    assert near_error(C.double().numpy(), Sv @ B.double().numpy()) <= BF16
    form = T.plan.exec_form_for(GEN, NONE, kind="bandtm")
    full = spmm_band_plain(form.bwd_val, B.float(), form.bandt_start, form.bwd_padL)
    assert torch.equal(C, full.to(torch.bfloat16))
    # the JAX package's mm on the same bf16 handle and B
    J = ast.create_csr(m, m, S.indptr, S.indices, jnp.asarray(S.data, dtype=jnp.bfloat16))
    want = np.asarray(ast.mm(1.0, J, ast.MatrixDescriptor(), ast.Operation.none, _jbf(jnp, B), 0.0))
    assert near_error(C.float().numpy(), want.astype(np.float32)) <= BF16


# ------------------------------------------------------------------ complex solves

OPS = ["none", "transpose", "conjugate_transpose"]


@pytest.fixture(scope="module")
def cpair(ast, jnp):
    """A complex 5^3 stencil (win forms) and a complex band of 1100 rows
    (m >= 1024: the base nb of complex), both complex128."""
    return {"stencil": pair(ast, jnp, *complex_stencil(5)), "band": pair(ast, jnp, *complex_band(1100, 4))}


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("diag", ["non_unit", "unit"])
@pytest.mark.parametrize("fill", ["lower", "upper"])
def test_complex_trsv_matches_jax(ast, jnp, cpair, fill, diag, op):
    """complex128 trsv (blocked forms, plain route by dtype; the host engine
    kid=2; the level engine kid=1) against the JAX package's default solve,
    within the f64 model tolerance; conjugate transpose conjugates."""
    J, T = cpair["stencil"]
    m = T.shape[0]
    b = rhs(m, 5)
    want = ast.trsv(1.0, J, tri(ast, fill, diag), getattr(ast.Operation, op), jnp.asarray(b))
    for kid in (None, 1, 2):
        got = tt.trsv(1.0, T, tri(tt, fill, diag), getattr(tt.Operation, op), torch.from_numpy(b), kid=kid)
        assert got.dtype == torch.complex128
        assert err(got, want) <= C128


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("fill", ["lower", "upper"])
def test_complex_trsm_matches_jax(ast, jnp, cpair, fill, op):
    """complex128 trsm on the band operand (K = 3), non-unit, every op."""
    J, T = cpair["band"]
    m = T.shape[0]
    B = rhs(m, 6, k=3)
    want = ast.trsm(1.0, J, tri(ast, fill, "non_unit"), getattr(ast.Operation, op), jnp.asarray(B))
    got = tt.trsm(1.0, T, tri(tt, fill, "non_unit"), getattr(tt.Operation, op), torch.from_numpy(B))
    assert err(got, want) <= C128


def test_complex64_trsv_and_ilu_smoother_match_jax(ast, jnp):
    """complex64: the blocked form (the plain route: no window or chain
    kernel instance) and the level form, within the f32 model tolerance."""
    J, T = pair(ast, jnp, *complex_stencil(5, dtype=np.complex64))
    b = rhs(T.shape[0], 7).astype(np.complex64)
    for kid in (None, 1):
        got = tt.trsv(1.0, T, tri(tt, "lower", "non_unit"), NONE, torch.from_numpy(b), kid=kid)
        assert got.dtype == torch.complex64
        assert err(got, ast.trsv(1.0, J, tri(ast, "lower", "non_unit"), ast.Operation.none, jnp.asarray(b))) <= C64
    got = tt.ilu_smoother(T, GEN, torch.from_numpy(b))
    assert err(got, ast.ilu_smoother(J, ast.MatrixDescriptor(), jnp.asarray(b))) <= C64


@pytest.mark.parametrize("operand", ["stencil", "band"])
def test_complex_ilu_smoother_matches_jax(ast, jnp, cpair, operand):
    """ILU0 of a complex handle (the host IKJ sweep's complex instance) and
    its apply by every kid, 1-D and 2-D b, against the JAX package's."""
    J, T = cpair[operand]
    m = T.shape[0]
    for b in (rhs(m, 8), rhs(m, 9, k=2)):
        want = ast.ilu_smoother(J, ast.MatrixDescriptor(), jnp.asarray(b))
        for kid in (None, 0, 1, 2):
            got = tt.ilu_smoother(T, GEN, torch.from_numpy(b), kid=kid)
            assert got.dtype == torch.complex128
            assert err(got, want) <= C128


def test_complex_symgs_and_sorv_match_jax(ast, jnp, cpair):
    """symgs and symgs_mv (general and symmetric descriptors) and sorv with
    complex omega and alpha, against the JAX package's."""
    J, T = cpair["band"]
    m = T.shape[0]
    b, x0 = rhs(m, 10), rhs(m, 11)
    for mtype in ("general", "symmetric"):
        dj, dt = ast.MatrixDescriptor(type=getattr(ast.MatrixType, mtype)), tt.MatrixDescriptor(
            type=getattr(tt.MatrixType, mtype))
        want = ast.symgs(ast.Operation.none, J, dj, 0.5 + 0.5j, jnp.asarray(b), jnp.asarray(x0))
        got = tt.symgs(NONE, T, dt, 0.5 + 0.5j, torch.from_numpy(b), torch.from_numpy(x0))
        assert err(got, want) <= C128
        wx, wy = ast.symgs_mv(ast.Operation.none, J, dj, 1.0, jnp.asarray(b))
        gx, gy = tt.symgs_mv(NONE, T, dt, 1.0, torch.from_numpy(b))
        assert err(gx, wx) <= C128 and err(gy, wy) <= C128
    omega, alpha = 1.1 + 0.2j, 0.7 - 0.1j
    want = ast.sorv(ast.SorType.forward, ast.MatrixDescriptor(), J, omega, alpha, jnp.asarray(x0), jnp.asarray(b))
    got = tt.sorv(tt.SorType.forward, GEN, T, omega, alpha, torch.from_numpy(x0), torch.from_numpy(b))
    assert got.dtype == torch.complex128
    assert err(got, want) <= C128


def test_bf16_trsv_ilu_smoother_and_sorv_match_jax(ast, jnp):
    """bf16 handles: trsv (the win form's plain version on the CPU, the host
    engine kid=2 in f32 rounded once), ilu_smoother (f32 factor rounded to
    bf16) and sorv, within the bf16 model tolerance of the JAX package's bf16
    arithmetic; every result bf16."""
    ptr, ind, val = stencil27(6)
    J, T = pair(ast, jnp, ptr, ind, val.astype(np.float32), jdtype=jnp.bfloat16, tdtype=torch.bfloat16)
    m = T.shape[0]
    b = rhs(m, 12, complex_=False).astype(np.float32)
    bj, bt = jnp.asarray(b, dtype=jnp.bfloat16), torch.from_numpy(b).to(torch.bfloat16)
    for fill in ("lower", "upper"):
        want = ast.trsv(1.0, J, tri(ast, fill, "non_unit"), ast.Operation.none, bj)
        for kid in (None, 1, 2):
            got = tt.trsv(1.0, T, tri(tt, fill, "non_unit"), NONE, bt, kid=kid)
            assert got.dtype == torch.bfloat16
            assert err(got, want) <= BF16
    assert ttri.trsv_form_for(T.plan, tri(tt, "lower", "non_unit"), NONE).D.dtype == torch.bfloat16
    got = tt.ilu_smoother(T, GEN, bt)
    assert got.dtype == torch.bfloat16 and T.ilu_state.lu.dtype == torch.bfloat16
    assert err(got, ast.ilu_smoother(J, ast.MatrixDescriptor(), bj)) <= BF16
    want = ast.sorv(ast.SorType.forward, ast.MatrixDescriptor(), J, 1.1, 0.5, bj, bj)
    assert err(tt.sorv(tt.SorType.forward, GEN, T, 1.1, 0.5, bt, bt), want) <= BF16


def deep_triangle(m, seed):
    """A lower triangle with a full subdiagonal and two random entries left
    of it a row, a DAG m levels deep: (ptr, ind, val f64)."""
    rng = np.random.default_rng(seed)
    i = np.arange(1, m)
    far = np.concatenate([rng.integers(0, np.maximum(i - 1, 1)) for _ in range(2)])
    rows = np.r_[np.arange(m), i, np.tile(i, 2)]
    cols = np.r_[np.arange(m), i - 1, far]
    vals = np.r_[np.full(m, 4.0), np.full(m - 1, -0.5), 0.3 * rng.standard_normal(2 * (m - 1))]
    S = sp.csr_matrix((vals, (rows, cols)), shape=(m, m))
    S.sum_duplicates()
    S.sort_indices()
    return S.indptr.astype(np.int64), S.indices.astype(np.int32), S.data


#: bf16 lower triangles whose blocked form is a chain-kernel kind
BF16_CHAIN = {"stencil16": (lambda: stencil27(16), "dwin"), "deep": (lambda: deep_triangle(3000, 19), "gather")}


@pytest.mark.parametrize("name", sorted(BF16_CHAIN))
def test_bf16_chain_forms_take_the_plain_route_on_the_cpu(ast, jnp, name):
    """A bf16 triangle whose blocked form is ``dwin`` or ``gather`` (the
    chain kernel has no bf16 instance): on a CPU tensor its solve is the
    plain block loop, within the bf16 model tolerance of the JAX package's
    bf16 trsv (its XLA scan) and of float64 scipy on the bf16 values."""
    build, kind = BF16_CHAIN[name]
    ptr, ind, val = build()
    J, T = pair(ast, jnp, ptr, ind, val.astype(np.float32), jdtype=jnp.bfloat16, tdtype=torch.bfloat16)
    m = T.shape[0]
    b = rhs(m, 21, complex_=False).astype(np.float32)
    bt = torch.from_numpy(b).to(torch.bfloat16)
    got = tt.trsv(1.0, T, tri(tt, "lower", "non_unit"), NONE, bt)
    assert ttri.trsv_form_for(T.plan, tri(tt, "lower", "non_unit"), NONE).kind == kind
    assert got.dtype == torch.bfloat16
    want = ast.trsv(1.0, J, tri(ast, "lower", "non_unit"), ast.Operation.none, jnp.asarray(b, dtype=jnp.bfloat16))
    assert err(got, want) <= BF16
    L = sp.tril(sp.csr_matrix((torch.from_numpy(val).to(torch.bfloat16).double().numpy(), ind, ptr), shape=(m, m)))
    exact = spsolve_triangular(L.tocsr(), bt.double().numpy(), lower=True)
    assert near_error(got.double().numpy(), exact) <= BF16


def test_sv_engine_rule_by_dtype():
    """pick_sv_engine on a device of SV_LEVEL_DEVICES: a complex form (no
    window or chain kernel instance) takes the level kernel within
    LEVEL_MAX_NLEV levels whatever its kind; a bf16 one (no level-kernel
    instance) stays blocked; f32 follows the chain gate."""
    ptr, ind, val = complex_stencil(5)
    m = len(ptr) - 1
    dev = torch.device("cuda")
    for dtype, want in ((torch.complex64, "level"), (torch.complex128, "level"), (torch.bfloat16, "blocked"),
                        (torch.float32, "blocked")):
        v = torch.from_numpy(val if dtype.is_complex else val.real.copy()).to(dtype)
        T = tt.create_csr(m, m, ptr, ind, v, device="cpu")
        form = ttri.trsv_form_for(T.plan if T.plan is not None else tt.optimize(T), tri(tt, "lower", "non_unit"), NONE)
        assert form.kind == "win"
        assert ttri.pick_sv_engine(form, lambda: 10, dev) == want
        assert ttri.pick_sv_engine(form, lambda: ttri.LEVEL_MAX_NLEV + 1, dev) == "blocked"
        assert ttri.has_solve_kernel(form.kind, dtype) == (not dtype.is_complex)
    assert ttri.adaptive_nb(262144, torch.bfloat16) == 256 and ttri.adaptive_nb(262144, torch.complex64) == 512


# ------------------------------------------------------------------ the mv rule


def test_stencil_mv_takes_diag_and_band_stays_bandt(ast, jnp):
    """choose_mv_format: HPCG's 27-point stencil (27 diagonals, a window
    far wider than 2 x 27) takes `diag`, as the JAX rule does; a full band
    (every diagonal of its window) stays on `bandt`. The stencil's mv
    value is the JAX package's on its explicitly requested diag form (mv
    KID 6; the JAX CPU rule never picks it), within the f64 model
    tolerance, and so is its strict lower triangle's (the SGS sweep's)."""
    ptr, ind, val = stencil27(12)
    m = len(ptr) - 1
    J, T = pair(ast, jnp, ptr, ind, val)
    x = np.random.default_rng(13).standard_normal(m)
    got = tt.mv(1.0, T, GEN, NONE, torch.from_numpy(x), 0.0)
    assert [k[-1] for k in T.plan.exec_forms] == [None]
    assert T.plan.exec_form_for(GEN, NONE).kind == "diag"
    want = ast.mv(1.0, J, ast.MatrixDescriptor(), ast.Operation.none, jnp.asarray(x), 0.0, kid=6)
    assert J.plan.exec_form_for(ast.MatrixDescriptor(), ast.Operation.none, kind="diag").kind == "diag"
    assert near_error(got.numpy(), np.asarray(want)) <= C128
    strict = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.lower,
                                 diag_type=tt.DiagType.zero)
    assert T.plan.exec_form_for(strict, NONE).kind == "diag"
    H = tt.create_csr(m, m, ptr, ind, torch.from_numpy(val).float(), device="cpu")
    tt.mv(1.0, H, GEN, NONE, torch.ones(m), 0.0)
    assert choose_mv_format(H.plan.effective_for(GEN, NONE)) == "diag"
    # a full band of half-width 8 in W = 24 (17 rounded up to 8s): 17
    # diagonals, 2 * 17 > 24
    S = sp.diags([np.ones(600)] * 17, list(range(-8, 9)), shape=(600, 600), format="csr")
    B = tt.create_csr(600, 600, S.indptr, S.indices, S.data, device="cpu")
    tt.mv(1.0, B, GEN, NONE, torch.ones(600, dtype=torch.float64), 0.0)
    assert B.plan.exec_form_for(GEN, NONE).kind == "bandt"


# ------------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest tests/test_torch_*.py there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [None, 16])
@pytest.mark.parametrize("nblk,nb,WL", [(64, 128, 64), (9, 128, 128), (11, 64, 200)])
def test_cuda_bf16_window_solves_match_plain(cuda, nblk, nb, WL, K):
    """The bf16 instance of the window solves (grouped, WL = nb, the plain
    chain) against its plain version on the card, within WIN_BF16 (both
    sides round x and the window to bf16 at the same places, so they
    differ by about one bf16 rounding); the same bits twice; its launches
    (the rounding one added)."""
    dT, lT, b = (t.to(cuda) for t in _win_operands(nblk + WL, nblk, nb, WL, K))
    ops = win_solve_operands(dT, lT, nb, WL)
    solve, plain = (trsv_win, trsv_win_plain) if K is None else (trsm_win, trsm_win_plain)
    before = solve.launches["bf16"]
    got = solve(dT, lT, b, nb, WL, ops)
    torch.cuda.synchronize()
    assert solve.launches["bf16"] == before + solve_launches(nblk, nb, WL, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(solve(dT, lT, b, nb, WL, ops), got)
    assert near_error(got.float().cpu().numpy(), plain(dT, lT, b, nb, WL).float().cpu().numpy()) <= WIN_BF16


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,W,start,padL,K", [(4099, 4110, 128, 3, 64, 64), (90, 100, 2, 0, 1, 300),
                                                 (300, 330, 400, 5, 200, 9)])
def test_cuda_bf16_spmm_band_matches_plain(cuda, m, n, W, start, padL, K):
    """The bf16 band instance (column-pair chunks of 32) against its plain
    version: the same bf16 values, f32 sums in another order."""
    rng = np.random.default_rng(m + W)
    v = torch.from_numpy(rng.standard_normal((m, W)).astype(np.float32)).to(cuda, torch.bfloat16)
    B = torch.from_numpy(rng.standard_normal((n, K)).astype(np.float32)).to(cuda)
    before = spmm_band.launches["bf16"]
    got = spmm_band(v, B, start, padL)
    torch.cuda.synchronize()
    assert spmm_band.launches["bf16"] == before + 1 and got.dtype == torch.float32
    assert near_error(got.cpu().numpy(), spmm_band_plain(v, B, start, padL).cpu().numpy()) <= F32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("K", [1, 3, 20])
def test_cuda_complex_level_kernel_matches_plain(cuda, dtype, K):
    """The complex instances of the level kernel on a complex 10^3
    stencil's ILU0 factors against their plain version, the same bits
    twice, one launch a solve."""
    from aoclsparse_tpu_torch.kernels.trsv_level import trsv_level, trsv_level_plain
    from aoclsparse_tpu_torch.solvers.ilu import _level_forms

    ptr, ind, val = complex_stencil(10)
    T = tt.create_csr(1000, 1000, ptr, ind, torch.from_numpy(val).to(dtype), device=cuda)
    name = "c64" if dtype == torch.complex64 else "c128"
    for form in _level_forms(tt.ilu0_factorize(T)):
        b = torch.from_numpy(rhs(1000, K, k=None if K == 1 else K)).to(cuda, dtype)
        before = trsv_level.launches[name]
        got = trsv_level(form, b)
        torch.cuda.synchronize()
        assert trsv_level.launches[name] == before + 1
        assert torch.equal(trsv_level(form, b), got)
        want = trsv_level_plain(form, b)
        assert err(got.cpu(), want.cpu().numpy()) <= expected_precision(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BF16_CHAIN))
def test_cuda_bf16_chain_forms_raise(cuda, name):
    """On the card a bf16 ``dwin`` or ``gather`` form has no chain-kernel
    instance: trsv raises not_implemented, naming ROADMAP item 29, by
    default and with kid=0, rather than run the plain block loops there."""
    build, kind = BF16_CHAIN[name]
    ptr, ind, val = build()
    m = len(ptr) - 1
    T = tt.create_csr(m, m, ptr, ind, torch.from_numpy(val).to(torch.bfloat16), device=cuda)
    b = torch.ones(m, dtype=torch.bfloat16, device=cuda)
    for kid in (None, 0):
        with pytest.raises(tt.AoclSparseError) as e:
            tt.trsv(1.0, T, tri(tt, "lower", "non_unit"), NONE, b, kid=kid)
        assert e.value.status == tt.Status.not_implemented and "item 29" in str(e.value)
    assert ttri.trsv_form_for(T.plan, tri(tt, "lower", "non_unit"), NONE).kind == kind
