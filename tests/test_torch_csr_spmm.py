"""mm KID 0 of the PyTorch port: the CSR SpMM kernel's plain version and
dispatch against the JAX package's ``spmm_segsum``, and the card's mm rule
for general structure.

- Parity: the port's wrapper (kernels/spmm_csr.py `spmm_csr`, on the CPU
  its plain version) against the JAX package's ``spmm_segsum``
  (kernels/xla/spmm.py:21), and the port's ``mm(kid=0)`` against the JAX
  package's ``mm(kid=0)``, in float32, float64, complex64, complex128 and
  bf16 (the port's bf16 kernel takes B widened to f32 and sums in f32: the
  wrapper is held to the JAX formulation on that pair, the bf16 mm to the
  JAX package's bf16 mm and to float64 scipy on the bf16 values), at K =
  1, 7, 64 and 130, on an operand with empty rows
  and rows past LONG_ROW; int32 and int64 indices, ``order=column``, op
  transpose and conjugate transpose with alpha and beta; a non-finite B row
  meeting a stored zero gives NaN in both packages.
- The rule (planner/plan.py `choose_mm_format(eff, device)`,
  `gen_beats_csr_mm`, `mm_gather_kind`): on ``cuda`` general structure
  takes ``segsum`` (a scattered circuit's sparse gen band past the
  crossover, a rectangular web graph's gather forms, complex values); a recovered
  dense band keeps ``gen``; bands and stencils keep ``bandtm`` and
  ``diag``; the CPU keeps the JAX forms. With the card's rule opened to
  the CPU (`MM_CSR_DEVICES`) mm runs it on the plain versions; pins (kid=6,
  kid=1 / 2, an autotune pin) still reach every form.
- On the card (marked cuda, skipped elsewhere): the kernel against its
  plain version in every instance and both index widths, K past one
  column tile and odd K, an unaligned B, the same bits twice, one launch a
  call, the default mm on general structure, and dtypes it has no
  instance for raising.

All inputs are made with numpy from a seed. Tolerance: utils/tolerances.py
`expected_precision` of the dtype on max |a - b| / max(|b|, 1) (the
kernel, the plain version and the JAX package sum the same products in
three orders); bf16 mm against the JAX package's: the bf16 model tolerance
(the JAX package rounds each product and sum to bf16, the port sums the
bf16 values in f32 and rounds once, within 2^-8 of float64 scipy); the
bf16 kernel against its plain version or the JAX formulation on its pair:
the f32 model (the same bf16 values and f32 B, f32 sums in another order).

"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.kernels import spmm_band as band_mod
from aoclsparse_tpu_torch.kernels.registry import registry
from aoclsparse_tpu_torch.kernels.spmm_csr import MAX_K, spmm_csr, spmm_csr_any, spmm_csr_plain
from aoclsparse_tpu_torch.kernels.spmm_plain import spmm_segsum
from aoclsparse_tpu_torch.kernels.spmv_csr import LONG_ROW, csr_blocks, tile_of
from aoclsparse_tpu_torch.planner import plan as tplan
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

GEN = tt.MatrixDescriptor()
NONE = tt.Operation.none
KEY = (GEN.type, GEN.fill_mode, GEN.diag_type, NONE)
DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128, torch.bfloat16)
INSTANCE = {torch.float32: "f32", torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
            torch.bfloat16: "bf16"}
NP = {torch.float32: np.float32, torch.float64: np.float64, torch.complex64: np.complex64,
      torch.complex128: np.complex128, torch.bfloat16: np.float32}


def tol(dtype):
    return expected_precision(dtype)


def kernel_tol(dtype):
    """Kernel against plain: the sum dtype's model (bf16 sums in f32)."""
    return expected_precision(torch.float32 if dtype == torch.bfloat16 else dtype)


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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest tests/test_torch_csr_spmm.py there")
    return torch.device("cuda", 0)


# -- operands -----------------------------------------------------------------


def _draw(rng, shape, dtype):
    """Seeded standard normals in the numpy dtype of `dtype` (complex: a
    second draw as the imaginary part)."""
    v = rng.standard_normal(shape)
    if dtype.is_complex:
        v = v + 1j * rng.standard_normal(shape)
    return v.astype(NP[dtype])


def web(seed, m=600, dtype=torch.float32, n=None):
    """A web graph in small (m x n, square by default): a few local links
    a row, a fifth of the rows empty, and two hub rows of 300 and 420
    entries, past LONG_ROW."""
    n = m if n is None else n
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 6, m) * (rng.random(m) > 0.2)
    r = np.repeat(np.arange(m), lens)
    c = np.clip(r + rng.integers(-20, 21, r.size), 0, n - 1)
    hubs = (7, 301)
    rh = np.repeat(hubs, (300, 420))
    ch = np.concatenate([rng.choice(n, 300, replace=False), rng.choice(n, 420, replace=False)])
    S = sp.csr_matrix((np.ones(r.size + rh.size), (np.r_[r, rh], np.r_[c, ch])), shape=(m, n))
    S.sum_duplicates()
    S.sort_indices()
    S.data = _draw(np.random.default_rng(seed + 1), S.nnz, dtype)
    assert np.diff(S.indptr).max() > LONG_ROW and (np.diff(S.indptr) == 0).any()
    return S


def circuit(seed, m=1024, spread=60, local=2):
    """tests/test_torch_gen_mm.py's circuit class (`local` couplings a row
    within +-`spread`, dense hub columns, random scatter); by default
    sparse and wide, a gen band of about 33 slots a nonzero (scircuit's has
    10), far past the card's crossover."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((m, m))
    for i in range(m):
        js = np.unique(np.clip(i + rng.integers(-spread, spread + 1, local), 0, m - 1))
        dense[i, js] = rng.standard_normal(js.size)
    for h in rng.choice(m, 5, replace=False):
        rs = rng.choice(m, m // 3, replace=False)
        dense[rs, h] = rng.standard_normal(rs.size)
    dense[rng.integers(0, m, 200), rng.integers(0, m, 200)] = rng.standard_normal(200)
    return sp.csr_matrix(dense)


def permuted_band(seed, m=2048, half_bw=16):
    """A full band whose 128-row blocks (the gen form's granularity,
    GEN_B) are shuffled, symmetrically: the gen form's block RCM recovers a
    band of about 1.2 slots a nonzero."""
    rng = np.random.default_rng(seed)
    S = sp.diags([rng.standard_normal(m - abs(d)) for d in range(-half_bw, half_bw + 1)],
                 list(range(-half_bw, half_bw + 1)), format="csr")
    nb = m // tplan.GEN_B
    p = (rng.permutation(nb)[:, None] * tplan.GEN_B + np.arange(tplan.GEN_B)).ravel()
    S = S[p][:, p].tocsr()
    S.sort_indices()
    return S


def band(seed, m=2000, half_bw=8):
    rng = np.random.default_rng(seed)
    S = sp.diags([rng.standard_normal(m - abs(d)) for d in range(-half_bw, half_bw + 1)],
                 list(range(-half_bw, half_bw + 1)), format="csr")
    S.sort_indices()
    return S


def stencil27(nx=16):
    m = nx**3
    idx = np.arange(m).reshape(nx, nx, nx)
    rows, cols = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                src = idx[max(0, -dz):nx - max(0, dz), max(0, -dy):nx - max(0, dy), max(0, -dx):nx - max(0, dx)]
                rows.append(src.ravel())
                cols.append((src + dz * nx * nx + dy * nx + dx).ravel())
    S = sp.csr_matrix((np.full(sum(r.size for r in rows), -1.0), (np.concatenate(rows), np.concatenate(cols))),
                      shape=(m, m))
    S.setdiag(26.0)
    S.sort_indices()
    return S


def _torch_vals(S, dtype):
    return torch.from_numpy(np.ascontiguousarray(S.data)).to(dtype)


def _handle(S, dtype=torch.float32, device="cpu", ptr_dtype=np.int32):
    return tt.create_csr(S.shape[0], S.shape[1], S.indptr.astype(ptr_dtype), S.indices, _torch_vals(S, dtype),
                         device=device)


def _B(seed, n, k, dtype):
    return torch.from_numpy(_draw(np.random.default_rng(seed), (n, k), dtype)).to(dtype)


def _wrapper_args(S, dtype, idx=torch.int32, device="cpu"):
    """(ptr, ind, val, blocks) of S for the wrapper, on `device`."""
    ptr = torch.from_numpy(S.indptr).to(device, idx)
    ind = torch.from_numpy(S.indices).to(device, idx)
    val = _torch_vals(S, dtype).to(device)
    blocks = torch.from_numpy(csr_blocks(S.indptr, *tile_of(dtype))).to(device)
    return ptr, ind, val, blocks


def _jax_vals(jnp, t):
    """A torch tensor as a JAX array of its dtype (bf16 through f32)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _host(t):
    """A tensor (or JAX array) on the host in f64 / complex128."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().to(torch.complex128 if t.is_complex() else torch.float64).numpy()
    a = np.asarray(t)
    return a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)


# -- parity with the JAX package ------------------------------------------------


@pytest.mark.parametrize("k", [1, 7, 64, 130])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: INSTANCE[d])
def test_wrapper_matches_jax_spmm_segsum(ast, jnp, dtype, k):
    """The wrapper on the CPU (the kernel's plain version) against the JAX
    package's spmm_segsum on the same CSR and B; bf16: the kernel's pair
    (bf16 values, B widened to f32) against the JAX bf16 formulation."""
    from aoclsparse_tpu.kernels.xla.spmm import spmm_segsum as jax_spmm_segsum

    S = web(3, dtype=dtype)
    m = S.shape[0]
    ptr, ind, val, blocks = _wrapper_args(S, dtype)
    B = _B(4, m, k, dtype)
    if dtype == torch.bfloat16:  # the instance's pair: bf16 values, f32 B
        B = B.float()
    got = spmm_csr(ptr, ind, val, B, blocks)
    assert got.shape == (m, k) and got.dtype == (torch.float32 if dtype == torch.bfloat16 else dtype)
    rows = np.repeat(np.arange(m, dtype=np.int32), np.diff(S.indptr))
    jval = jnp.asarray(val.float().numpy()) if dtype == torch.bfloat16 else _jax_vals(jnp, val)
    want = jax_spmm_segsum(jnp.asarray(S.indices), jval, jnp.asarray(rows), _jax_vals(jnp, B), m)
    assert near_error(_host(got), _host(want)) <= kernel_tol(dtype)
    # empty rows give zero rows
    empty = np.diff(S.indptr) == 0
    assert not got[torch.from_numpy(empty)].any()


@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
def test_wrapper_index_widths_and_empty_operands(idx):
    S = web(5, dtype=torch.float64)
    ptr, ind, val, blocks = _wrapper_args(S, torch.float64, idx)
    B = _B(6, S.shape[1], 9, torch.float64)
    got = spmm_csr(ptr, ind, val, B, blocks)
    assert near_error(got.numpy(), S @ B.numpy()) <= tol(torch.float64)
    rows = torch.repeat_interleave(torch.arange(S.shape[0]), torch.from_numpy(np.diff(S.indptr)))
    assert torch.equal(got, spmm_segsum(ind, val, rows, B, S.shape[0]))
    assert torch.equal(spmm_csr_any(ind, val, None, B, S.shape[0], ptr, blocks), got)
    # K = 0, m = 0, nnz = 0
    assert spmm_csr(ptr, ind, val, B[:, :0], blocks).shape == (S.shape[0], 0)
    p0 = torch.zeros(1, dtype=idx)
    e_ind, e_val = torch.zeros(0, dtype=idx), torch.zeros(0, dtype=torch.float64)
    b0 = torch.from_numpy(csr_blocks(np.zeros(1, np.int64), *tile_of(torch.float64)))
    assert spmm_csr(p0, e_ind, e_val, B, b0).shape == (0, 9)
    p5 = torch.zeros(6, dtype=idx)
    b5 = torch.from_numpy(csr_blocks(np.zeros(6, np.int64), *tile_of(torch.float64)))
    assert torch.equal(spmm_csr(p5, e_ind, e_val, B, b5), torch.zeros(5, 9, dtype=torch.float64))


OPS = {
    "none_row_ptr64": (NONE, tt.Order.row, np.int64, 1.0, 0.0),
    "transpose_column": (tt.Operation.transpose, tt.Order.column, np.int32, 1.0, 0.0),
    "conjtrans_alpha_beta": (tt.Operation.conjugate_transpose, tt.Order.row, np.int32, 1.5, -0.5),
}


@pytest.mark.parametrize("case", sorted(OPS))
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: INSTANCE[d])
def test_kid0_matches_jax_mm(ast, jnp, dtype, case):
    """mm(kid=0) of both packages on the same handle: op resolved in the
    effective CSR (conjugated for conjugate_transpose), row- or
    column-major B and C, alpha and beta."""
    op, order, ptr_dtype, alpha, beta = OPS[case]
    S = web(7, dtype=dtype)
    m, k = S.shape[0], 24
    T = _handle(S, dtype, ptr_dtype=ptr_dtype)
    vals = _torch_vals(S, dtype)
    J = ast.create_csr(m, m, S.indptr.astype(ptr_dtype), S.indices, _jax_vals(jnp, vals))
    B = _B(8, m, k, dtype)
    C0 = _B(9, m, k, dtype)
    if order == tt.Order.column:
        B, C0 = B.T.contiguous(), C0.T.contiguous()
    got = tt.mm(alpha, T, GEN, op, B, beta, C0, order=order, kid=0)
    want = ast.mm(alpha, J, ast.MatrixDescriptor(), ast.Operation(int(op)), _jax_vals(jnp, B), beta,
                  _jax_vals(jnp, C0), order=ast.Order(int(order)), kid=0)
    assert got.dtype == dtype and tuple(got.shape) == tuple(np.asarray(want).shape)
    assert near_error(_host(got), _host(want)) <= tol(dtype)
    # against scipy in f64 / complex128 on the operands' values (bf16: the
    # port's f32 sums rounded once, within 2^-8, where no epilogue rounds
    # again)
    Sd = sp.csr_matrix((_host(vals), S.indices, S.indptr), shape=S.shape)
    opS = Sd if op == NONE else (Sd.T if op == tt.Operation.transpose else Sd.conj().T)
    Bm, Cm = (B.T, C0.T) if order == tt.Order.column else (B, C0)
    ref = alpha * (opS @ _host(Bm)) + beta * _host(Cm)
    bound = 2.0**-8 if dtype == torch.bfloat16 and (alpha, beta) == (1.0, 0.0) else tol(dtype)
    assert near_error(_host(got.T if order == tt.Order.column else got), ref) <= bound


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=lambda d: INSTANCE[d])
def test_nonfinite_b_meets_stored_zero(ast, jnp, dtype):
    """A stored zero meeting an Inf of B gives NaN in both packages (every
    stored entry is multiplied), in the wrapper and through mm(kid=0)."""
    from aoclsparse_tpu.kernels.xla.spmm import spmm_segsum as jax_spmm_segsum

    S = web(11, dtype=dtype)
    m = S.shape[0]
    r = int(np.argmax(np.diff(S.indptr) == 3))  # a row of three entries
    p = S.indptr[r] + 1
    c = int(S.indices[p])
    S.data[p] = 0.0
    B = _B(12, m, 5, dtype)
    B[c, 2] = float("inf")
    ptr, ind, val, blocks = _wrapper_args(S, dtype)
    got = spmm_csr(ptr, ind, val, B, blocks)
    rows = np.repeat(np.arange(m, dtype=np.int32), np.diff(S.indptr))
    want = np.asarray(jax_spmm_segsum(jnp.asarray(S.indices), jnp.asarray(val.numpy()), jnp.asarray(rows),
                                      jnp.asarray(B.numpy()), m))
    assert torch.isnan(got[r, 2]) and np.isnan(want[r, 2])
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(want)) and np.array_equal(np.isinf(got.numpy()),
                                                                                     np.isinf(want))
    fin = np.isfinite(want)
    assert near_error(got.numpy()[fin], want[fin]) <= tol(dtype)
    T = _handle(S, dtype)
    J = ast.create_csr(m, m, S.indptr, S.indices, jnp.asarray(S.data))
    Cp = tt.mm(1.0, T, GEN, NONE, B, 0.0, kid=0).numpy()
    Cj = np.asarray(ast.mm(1.0, J, ast.MatrixDescriptor(), ast.Operation.none, jnp.asarray(B.numpy()), 0.0, kid=0))
    assert np.isnan(Cp[r, 2]) and np.isnan(Cj[r, 2])
    assert np.array_equal(np.isnan(Cp), np.isnan(Cj))


def test_registry_kid0_is_the_kernel_row():
    e = registry.select("mm", fmt="segsum", device="cpu")
    assert (e.kid, e.name, e.fn) == (0, "cuda_segsum", spmm_csr_any)
    assert registry.select("mm", fmt="segsum", kid=0, device="cuda").fn is spmm_csr_any
    assert tt.debug_dispatcher("mm", fmt="segsum", device="cpu")["name"] == "cuda_segsum"
    assert set(spmm_csr.launches) == {"f32", "f64", "c64", "c128", "bf16"}


def test_wrapper_validates():
    S = web(13)
    ptr, ind, val, blocks = _wrapper_args(S, torch.float32)
    B = torch.ones(S.shape[1], 4)
    for args, status in (
        ((ptr, ind, val.half(), B.half(), blocks), tt.Status.wrong_type),
        ((ptr, ind, val.double(), B, blocks), tt.Status.wrong_type),
        ((ptr, ind, val.bfloat16(), B.bfloat16(), blocks), tt.Status.wrong_type),
        ((ptr.to(torch.int16), ind, val, B, blocks), tt.Status.wrong_type),
        ((ptr, ind, val, B, blocks.int()), tt.Status.wrong_type),
        ((ptr, ind[:-1], val, B, blocks), tt.Status.invalid_size),
        ((ptr, ind, val, B[:, 0], blocks), tt.Status.invalid_size),
        ((ptr, ind, val, B, blocks.reshape(-1)), tt.Status.invalid_size),
        ((ptr, ind, val, torch.ones(1, 1).expand(S.shape[1], MAX_K + 1), blocks), tt.Status.invalid_size),
        ((ptr, ind, val, B, blocks.t().contiguous().t()), tt.Status.invalid_value),
    ):
        with pytest.raises(tt.AoclSparseError) as e:
            spmm_csr(*args)
        assert e.value.status == status
    # a non-contiguous B is made contiguous once: the same product
    Bt = torch.from_numpy(np.random.default_rng(14).standard_normal((4, S.shape[1])).astype(np.float32)).T
    assert not Bt.is_contiguous()
    assert torch.equal(spmm_csr(ptr, ind, val, Bt, blocks), spmm_csr(ptr, ind, val, Bt.contiguous(), blocks))
    # no kernel on a device other than the card and the CPU
    with pytest.raises(tt.AoclSparseError):
        spmm_csr_any(ind.to("meta"), val.to("meta"), None, B.to("meta"), S.shape[0], ptr.to("meta"),
                     blocks.to("meta"))


# -- the rule ---------------------------------------------------------------------


def _eff(S, dtype=torch.float32):
    return tplan.get_plan(_handle(S, dtype)).effective_for(GEN, NONE)


def test_card_rule_is_a_function_of_structure_and_device():
    """choose_mm_format(eff, device): general structure takes segsum on
    cuda for the kernel's dtypes where the CPU keeps the JAX forms; the
    gen candidate stays `gen` for the built form's crossover; bands and
    stencils keep bandtm and diag on both."""
    cases = {"web_rect": (web(15, n=650), torch.float32), "circuit": (circuit(16), torch.float32),
             "circuit_c64": (circuit(16), torch.complex64), "circuit_bf16": (circuit(16), torch.bfloat16),
             "band": (band(17), torch.float32), "stencil": (stencil27(), torch.float32)}
    want = {"web_rect": ("gather", "segsum"), "circuit": ("gen", "gen"), "circuit_c64": ("gather", "segsum"),
            "circuit_bf16": ("gen", "gen"), "band": ("bandtm", "bandtm"), "stencil": ("diag", "diag")}
    for name, (S, dt) in cases.items():
        eff = _eff(S, dt)
        cpu_kind, cuda_kind = want[name]
        got_cpu = tplan.choose_mm_format(eff)
        assert got_cpu == tplan.choose_mm_format(eff, device="cpu")
        if cpu_kind == "gather":
            assert got_cpu == tplan.gather_fallback_kind(eff) and got_cpu in ("ell", "ellhyb"), name
        else:
            assert got_cpu == cpu_kind, name
        assert tplan.choose_mm_format(eff, device="cuda") == cuda_kind, name
        assert tplan.choose_mm_format(eff, device=torch.device("cuda", 0)) == cuda_kind, name
        assert tplan.mm_gather_kind(eff, device="cuda") == "segsum"
        assert tplan.mm_gather_kind(eff) == tplan.gather_fallback_kind(eff)
    # float16 has no kernel instance: the JAX gather forms on every device
    eff16 = _eff(circuit(16), torch.float16)
    assert tplan.choose_mm_format(eff16, device="cuda") == tplan.gather_fallback_kind(eff16)


def test_gen_crossover_keeps_a_recovered_band():
    """gen_beats_csr_mm: off the card always; on the card only a band of at
    most GEN_CSR_SLOTS slots a nonzero. The sparse circuit's gen band is
    past it; a permuted full band, recovered by block RCM, is within it."""
    for S, keep in ((circuit(18), False), (permuted_band(19), True)):
        T = _handle(S)
        plan = tplan.get_plan(T)
        form, eff = plan.gen_form_for(GEN, NONE), plan.effective_for(GEN, NONE)
        assert tplan.gen_mm_ok(form)
        slots = form.gen_m_pad * form.bwd_W / eff.nnz
        assert (slots <= tplan.GEN_CSR_SLOTS[torch.float32]) == keep, slots
        assert tplan.gen_beats_csr_mm(form, eff, device="cpu")
        assert tplan.gen_beats_csr_mm(form, eff, device="cuda") == keep


@pytest.fixture
def card_rule(monkeypatch):
    """The card's mm rule on CPU handles (their plain versions run)."""
    monkeypatch.setattr(tplan, "MM_CSR_DEVICES", ("cuda", "cpu"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex64, torch.bfloat16],
                         ids=lambda d: INSTANCE[d])
def test_card_rule_drives_mm_to_segsum(ast, jnp, card_rule, dtype):
    """With the card's rule, mm on the sparse circuit (every kernel dtype)
    and on the rectangular web graph takes segsum, equal to the JAX
    package's default mm within the dtype's tolerance; the permuted band
    keeps gen."""
    for S in (circuit(20), web(21, n=650)):
        T = _handle(S, dtype)
        k = 16
        B = _B(22, S.shape[1], k, dtype)
        got = tt.mm(1.0, T, GEN, NONE, B, 0.0)
        assert T.plan.mm_kinds[KEY] == "segsum"
        J = ast.create_csr(S.shape[0], S.shape[1], S.indptr, S.indices, _jax_vals(jnp, _torch_vals(S, dtype)))
        want = ast.mm(1.0, J, ast.MatrixDescriptor(), ast.Operation.none, _jax_vals(jnp, B), 0.0)
        assert near_error(_host(got), _host(want)) <= tol(dtype)
    if dtype in (torch.float32, torch.float64):
        T = _handle(permuted_band(23), dtype)
        tt.mm(1.0, T, GEN, NONE, _B(24, 2048, 8, dtype), 0.0)
        assert T.plan.mm_kinds[KEY] == "gen"


def test_pins_reach_every_form_under_the_card_rule(card_rule, monkeypatch):
    """kid=6, kid=1, kid=2 and an autotune pin of gen still run their forms
    where the card's default takes segsum; an explicit kid=0 runs segsum."""
    import aoclsparse_tpu_torch.ops.level3.csrmm as mmmod

    S = circuit(25)
    T = _handle(S)
    B = _B(26, S.shape[1], 8, torch.float32)
    ref = S.astype(np.float64) @ B.double().numpy()
    seen = []
    run = mmmod._run_mm_form
    monkeypatch.setattr(mmmod, "_run_mm_form", lambda form, B, kid, mixed=False: seen.append((form.kind, kid)) or
                        run(form, B, kid, mixed))
    for kid, kind in ((None, "segsum"), (6, "gen"), (1, "ell"), (2, "ellhyb"), (0, "segsum")):
        got = tt.mm(1.0, T, GEN, NONE, B, 0.0, kid=kid)
        assert seen[-1] == (kind, kid)
        assert near_error(got.numpy(), ref) <= tol(torch.float32)
    res = tt.autotune_mm(T, k=8, B=B, kinds=("gen", "segsum", "ell"), iters=1, chunks=1)
    assert {"gen", "segsum", "ell"} <= set(res)
    T.plan._mm_tuned[KEY + (8,)] = "gen"
    tt.mm(1.0, T, GEN, NONE, B, 0.0)
    assert seen[-1] == ("gen", None)


def test_cpu_default_keeps_the_jax_rule():
    """Without the card: the circuit's default mm takes gen, the
    rectangular web graph's a gather form, kid=0 the segsum form's plain
    gather."""
    T = _handle(circuit(27))
    B = _B(28, 1024, 8, torch.float32)
    tt.mm(1.0, T, GEN, NONE, B, 0.0)
    assert T.plan.mm_kinds[KEY] == "gen"
    W = _handle(web(29, n=650))
    tt.mm(1.0, W, GEN, NONE, _B(30, 650, 8, torch.float32), 0.0)
    assert W.plan.mm_kinds[KEY] in ("ell", "ellhyb")
    form = W.plan.exec_form_for(GEN, NONE, kind="segsum")
    assert form.row_ids is not None  # the CPU's plain gather reads them


# -- on the card ------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: INSTANCE[d])
@pytest.mark.parametrize("k", [1, 7, 64, 130, 300])
@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
def test_cuda_kernel_matches_plain(cuda, dtype, k, idx):
    """Every instance against its plain version: hub rows past LONG_ROW,
    empty rows, K = 1 and odd (one value a lane), 64 (one tile), past one
    tile; the same bits twice; one launch a call."""
    S = web(31, dtype=dtype)
    ptr, ind, val, blocks = _wrapper_args(S, dtype, idx, cuda)
    B = _B(32, S.shape[1], k, dtype).to(cuda)
    if dtype == torch.bfloat16:
        B = B.float()
    inst = INSTANCE[dtype]
    before = spmm_csr.launches[inst]
    got = spmm_csr(ptr, ind, val, B, blocks)
    torch.cuda.synchronize()
    assert spmm_csr.launches[inst] - before == 1
    want = spmm_csr_plain(ptr, ind, val, B)
    assert near_error(_host(got), _host(want)) <= kernel_tol(dtype)
    assert torch.equal(spmm_csr(ptr, ind, val, B, blocks), got)
    assert not got[torch.from_numpy(np.diff(S.indptr) == 0).to(cuda)].any()


@pytest.mark.cuda
def test_cuda_unaligned_b_and_nonfinite(cuda):
    """B as a view one float into its storage (no 8-byte loads: one value a
    lane) gives the aligned result; a stored zero meeting an Inf of B gives
    NaN on the card too."""
    S = web(33)
    ptr, ind, val, blocks = _wrapper_args(S, torch.float32, device=cuda)
    B = _B(34, S.shape[1], 64, torch.float32).to(cuda)
    flat = torch.cat([B.new_zeros(1), B.reshape(-1)])
    Bu = flat[1:].view(S.shape[1], 64)
    assert Bu.data_ptr() % 8 and Bu.is_contiguous()
    assert torch.equal(spmm_csr(ptr, ind, val, Bu, blocks), spmm_csr(ptr, ind, val, B, blocks))
    r = int(np.argmax(np.diff(S.indptr) == 3))
    p = S.indptr[r] + 1
    val[p] = 0.0
    B[int(S.indices[p]), 5] = float("inf")
    got = spmm_csr(ptr, ind, val, B, blocks)
    assert torch.isnan(got[r, 5])
    want = spmm_csr_plain(ptr, ind, val, B)
    assert torch.equal(torch.isnan(got), torch.isnan(want))


@pytest.mark.cuda
def test_cuda_default_mm_on_general_structure_launches_the_kernel(cuda):
    """The card's default mm on general structure launches the CSR SpMM
    kernel once a call (f32, complex64, a bf16 handle; order=column), no
    band SpMM; a kid=6 pin still runs the gen composite's band leg."""
    S = circuit(35)
    for dtype in (torch.float32, torch.complex64, torch.bfloat16):
        T = _handle(S, dtype, device=cuda)
        B = _B(36, S.shape[1], 40, dtype).to(cuda)
        inst = INSTANCE[dtype]
        c0, b0 = spmm_csr.launches[inst], dict(band_mod.spmm_band.launches)
        got = tt.mm(1.0, T, GEN, NONE, B, 0.0)
        torch.cuda.synchronize()
        assert T.plan.mm_kinds[KEY] == "segsum"
        assert spmm_csr.launches[inst] - c0 == 1 and band_mod.spmm_band.launches == b0
        assert T.plan.exec_form_for(GEN, NONE, kind="segsum").row_ids is None
        ref = S.astype(np.complex128 if dtype.is_complex else np.float64) @ _host(B)
        assert got.dtype == dtype and near_error(_host(got), ref) <= tol(dtype)
        gotT = tt.mm(1.0, T, GEN, NONE, B.T.contiguous(), 0.0, order=tt.Order.column)
        assert near_error(_host(gotT.T), ref) <= tol(dtype)
    T = _handle(S, device=cuda)
    B = _B(37, S.shape[1], 40, torch.float32).to(cuda)
    c0, b0 = spmm_csr.launches["f32"], band_mod.spmm_band.launches["f32"]
    got6 = tt.mm(1.0, T, GEN, NONE, B, 0.0, kid=6)
    torch.cuda.synchronize()
    assert band_mod.spmm_band.launches["f32"] - b0 == 1 and spmm_csr.launches["f32"] == c0
    assert near_error(_host(got6), S.astype(np.float64) @ _host(B)) <= tol(torch.float32)


@pytest.mark.cuda
def test_cuda_other_dtypes_raise(cuda):
    """No CUDA tensor takes the plain version: (val, B) pairs the kernel has
    no instance for raise in the registry's KID 0 function, and a float16
    handle's mm by kid=0 raises (a deliberate divergence: the JAX package
    computes it)."""
    S = web(38)
    for dt, bdt in ((torch.float16, torch.float16), (torch.float64, torch.float32), (torch.bfloat16, torch.bfloat16)):
        ptr, ind, val, blocks = _wrapper_args(S, dt, device=cuda)
        with pytest.raises(tt.AoclSparseError):
            spmm_csr_any(ind, val, None, torch.ones(S.shape[1], 4, dtype=bdt, device=cuda), S.shape[0], ptr, blocks)
    T = _handle(S, torch.float16, device=cuda)
    with pytest.raises(tt.AoclSparseError):
        tt.mm(1.0, T, GEN, NONE, torch.ones(S.shape[1], 4, dtype=torch.float16, device=cuda), 0.0, kid=0)
