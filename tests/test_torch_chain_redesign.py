"""The redesigned blocked-solve chain kernel (csrc/trsv_blocked.cu) on the
CPU: its schedule emulated in torch, its count operand, its divergence on
padding, and the sv gate for its bf16 and complex instances.

The kernel runs one thread-block cluster a chunk of KC = chunk_cols(K)
columns. Helper CTAs sum each row's far left terms (source block at least
D blocks back) in entry order, over solved x, and deliver b - far and the
row's near entries; the chain CTA sums the near entries in entry order over
its ring of the last D blocks' x, then x_k = Dinv_k rhs over dinvT's upper
triangle: batches of 8 / KC rows dealt to S slices of the row's threads
(`chain_slices`), each over NACC = 4 / KC accumulators (q mod NACC) added
in a fixed tree, the slices' partials added in slice order; and rounds x to
the operand dtype as each block is solved (bf16: f32 sums).
`emulate_chain` is that schedule in torch, block by block; a gather row is
read over its left count only (the padding is skipped).

Tolerances (utils/tolerances.py, max |a - b| / max(|b|, 1)): the emulation
against the plain versions and the JAX package's scans, which sum the same
products in another order (the JAX gather scan substitutes with D where the
port multiplies by the inverted blocks), within the dtype's model tolerance
(f32 / f64 / complex: expected_precision of the dtype); bf16 against the
JAX scans run in f32 on the same bf16-rounded operands, and against the
plain bf16 loop, within four bf16 units in the last place (2^-5, BF16_CHAIN,
as the window solve's bf16 instance is held: each block's x is rounded to
bf16 on both sides, at other places). The operands have a
dominant diagonal (4 I against 0.1-scaled noise), so the inverted blocks
add no growth beyond that model.

The cuda-marked tests hold every instance of the kernel to its plain
version and to this emulation on the card.
"""

import numpy as np
import pytest
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch import interop
from aoclsparse_tpu_torch.kernels.trsv_blocked import (
    KERNEL_MAX_NB,
    chain_slices,
    chunk_cols,
    gather_counts,
    trsv_dwin,
    trsv_dwin_plain,
    trsv_gather,
    trsv_gather_plain,
)
from aoclsparse_tpu_torch.planner import triangular as ttri
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

DTYPES = [torch.float32, torch.float64, torch.bfloat16, torch.complex64, torch.complex128]
NAME = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16", torch.complex64: "c64",
        torch.complex128: "c128"}
NONE = tt.Operation.none
LOWER = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.lower)
#: the near entries a row of a delivery slot holds (csrc/trsv_blocked.cu kNearRow)
NEAR_ROW = 4


#: bf16 chain solves against one another: four bf16 units in the last place
#: (2^-5), as the window solve's bf16 instance is held; both sides round x to
#: bf16 a block, and differ by about one rounding of x (0.0039 here)
BF16_CHAIN = 4 * 2.0**-7


def tol(dtype):
    return BF16_CHAIN if dtype == torch.bfloat16 else expected_precision(dtype)


def err(got, want):
    """near_error of two results, a tensor against a tensor or an array."""
    a = got.detach().cpu().to(torch.complex128).numpy()
    w = want.detach().cpu().to(torch.complex128).numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    return near_error(a, w.astype(np.complex128))


# ---------------------------------------------------------------- the schedule


def entries(kind, left, aux, counts, nb):
    """(src, val, valid), each (nblk, nb, E), a row's left entries in the
    kernel's entry order: a dwin row's offsets ascending (those left of
    the block at rows >= 0), a gather row's slots below its count."""
    nblk = left.shape[0]
    r = torch.arange(nb)
    blk0 = (torch.arange(nblk) * nb)[:, None, None]
    if kind == "dwin":
        offs = aux.long()
        src = blk0 - offs[None, None, :] + r[None, :, None]
        valid = (r[None, :, None] < offs[None, None, :]) & (src >= 0)
        return src, left.transpose(1, 2), valid
    W = left.shape[2]
    valid = torch.arange(W)[None, None, :] < counts.long()[:, :, None]
    return aux.long(), left, valid


def emulate_chain(kind, dinvT, left, aux, b, nb, D, counts=None, near_row=NEAR_ROW, stats=None):
    """The kernel's arithmetic in torch (csrc/trsv_blocked.cu): for each
    block k, far = the sum in entry order of a row's terms whose source
    row is below (k - D + 1) nb, over solved x; near = the sum in entry
    order of the others; rhs = (b - far) - near; x_r = sum over q <= r of
    dinvT[k][q][r] rhs[q], the q in batches of QB = 8 / KC, batch b in
    slice b mod S (chain_slices), each slice over NACC accumulators (q mod
    NACC) added as (a0 + a1) + (a2 + a3), the slices' partials added in
    slice order; x rounded to the operand dtype. stats (a dict) gets the near
    and far entry counts and the rows whose near entries overflow a slot
    (the chain scans them itself: the same sum)."""
    T = dinvT.dtype
    A = torch.float32 if T == torch.bfloat16 else T
    B = b[:, None] if b.dim() == 1 else b
    K = B.shape[1]
    nacc, qb, S = 4 // chunk_cols(K), 8 // chunk_cols(K), chain_slices(nb)
    nblk = dinvT.shape[0]
    src, val, valid = entries(kind, left, aux, counts, nb)
    X = torch.zeros(nblk * nb, K, dtype=T)
    rows = torch.arange(nb)
    n_near = n_far = n_over = 0
    for k in range(nblk):
        near_lo = (k - D + 1) * nb
        s_k, v_k, ok = src[k], val[k].to(A), valid[k]
        far_m, near_m = ok & (s_k < near_lo), ok & (s_k >= near_lo)
        n_near += int(near_m.sum())
        n_far += int(far_m.sum())
        n_over += int((near_m.sum(1) > near_row).sum())
        far = torch.zeros(nb, K, dtype=A)
        near = torch.zeros(nb, K, dtype=A)
        for e in range(int(ok.sum(1).max()) if kind == "gather" else s_k.shape[1]):
            xs = X[s_k[:, e].clamp(0, nblk * nb - 1)].to(A)
            term = v_k[:, e, None] * xs
            far = torch.where(far_m[:, e, None], far + term, far)
            near = torch.where(near_m[:, e, None], near + term, near)
        rhs = (B[k * nb:(k + 1) * nb].to(A) - far) - near
        dk = dinvT[k].to(A)
        acc = torch.zeros(S, nacc, nb, K, dtype=A)
        for q in range(nb):
            sl, u = (q // qb) % S, q % nacc
            upd = acc[sl, u] + dk[q][:, None] * rhs[q][None, :]
            acc[sl, u] = torch.where((rows >= q)[:, None], upd, acc[sl, u])
        part = acc[:, 0] if nacc == 1 else (acc[:, 0] + acc[:, 1] if nacc == 2 else
                                            (acc[:, 0] + acc[:, 1]) + (acc[:, 2] + acc[:, 3]))
        x = part[0]
        for sl in range(1, S):
            x = x + part[sl]
        X[k * nb:(k + 1) * nb] = x.to(T)
    if stats is not None:
        stats.update(near=n_near, far=n_far, overflow_rows=n_over)
    return X[:, 0] if b.dim() == 1 else X


# ---------------------------------------------------------------- operands


def synthetic(kind, nblk, nb, m, seed, offs=None, W=None, hub=None, dtype=torch.float64):
    """A dwin or gather form as the JAX package's arrays would carry it
    (interop.trsv_form_from_jax): diagonal blocks 4 I plus 0.1-scaled
    strictly lower noise (identity rows past m); the left part 0.1-scaled
    noise on entries left of each block (dwin: offs[d] > r; gather: `W`
    distinct random columns below the block a row, sorted, the last slots
    of random rows left as padding), zero elsewhere; `hub` a gather row
    with an entry on every column left of its block. Complex: an imaginary
    part of the same scale. Returns (form, D numpy)."""
    rng = np.random.default_rng(seed)
    cplx = dtype.is_complex

    def noise(*shape):
        z = rng.standard_normal(shape)
        return z + 1j * rng.standard_normal(shape) if cplx else z

    m_pad = nblk * nb
    rows = np.arange(m_pad).reshape(nblk, nb)
    D = np.tril(0.1 * noise(nblk, nb, nb), -1) + 4.0 * np.eye(nb)
    D[rows >= m] = 0.0
    D[:, np.arange(nb), np.arange(nb)] = np.where(rows >= m, 1.0, D[:, np.arange(nb), np.arange(nb)])
    arrays = dict(D=D, nb=nb, nblk=nblk, m=m, reversed_=False, unit_diag=False, kind=kind)
    if kind == "dwin":
        offs = np.asarray(offs)
        Dv = 0.1 * noise(nblk, len(offs), nb)
        Dv[:, np.arange(nb)[None, :] >= offs[:, None]] = 0.0
        src = (rows[:, None, :] - offs[None, :, None])
        Dv[src < 0] = 0.0
        Dv[(rows >= m)[:, None, :].repeat(len(offs), 1)] = 0.0
        arrays.update(Lval=Dv, dwin_offs=offs, WL=max(8, -(-int(offs.max()) // 8) * 8))
    else:
        Wf = W if hub is None else max(W, (nblk - 1) * nb)
        Lind = np.zeros((nblk, nb, Wf), dtype=np.int32)
        Lval = np.zeros((nblk, nb, Wf), dtype=np.complex128 if cplx else np.float64)
        for k in range(1, nblk):
            for r in range(nb):
                if k * nb + r >= m:
                    continue
                if hub is not None and k * nb + r == hub:
                    cols = np.arange(k * nb)
                else:
                    n = int(rng.integers(0, W + 1))
                    cols = np.sort(rng.choice(k * nb, size=min(n, k * nb), replace=False))
                Lind[k, r, :cols.size] = cols
                Lval[k, r, :cols.size] = 0.1 * noise(cols.size)
        arrays.update(Lval=Lval, Lind=Lind, WL=0)
    form = interop.trsv_form_from_jax(arrays, device="cpu")
    form.D = torch.from_numpy(D).to(dtype)
    form.Lval = torch.from_numpy(arrays["Lval"]).to(dtype)
    form.dtype = dtype
    return form, D


CASES = {
    # nb 16, 40 blocks: near offsets (1, 9, 17) and far ones (40, 100, 300) at D = 2
    "dwin": lambda dt: synthetic("dwin", 40, 16, 630, 3, offs=(1, 9, 17, 40, 100, 300), dtype=dt),
    # nb 8, 48 blocks, up to 5 random left columns a row, a hub row 300
    "gather": lambda dt: synthetic("gather", 48, 8, 380, 5, W=5, hub=300, dtype=dt),
}


def rhs(m_pad, K, dtype, seed=7):
    rng = np.random.default_rng(seed)
    shape = (m_pad,) if K == 1 else (m_pad, K)
    z = rng.standard_normal(shape)
    if dtype.is_complex:
        z = z + 1j * rng.standard_normal(shape)
    return torch.from_numpy(z).to(dtype)


def plain(form, b):
    dT, left = form.operands()
    if form.kind == "dwin":
        return trsv_dwin_plain(dT.transpose(1, 2), left, b, form.nb, form.WL, form.dwin_offs)
    return trsv_gather_plain(dT.transpose(1, 2), form.Lind, left, b, form.nb)


def emulate(form, b, D=8, **kw):
    dT, left = form.operands()
    aux = form.offsets() if form.kind == "dwin" else form.Lind
    return emulate_chain(form.kind, dT, left, aux, b, form.nb, D, counts=form.counts() if form.kind == "gather"
                         else None, **kw)


# ---------------------------------------------------------------- the tests


@pytest.mark.parametrize("kind", sorted(CASES))
@pytest.mark.parametrize("dtype", DTYPES, ids=[NAME[d] for d in DTYPES])
@pytest.mark.parametrize("K", [1, 3])
def test_emulated_schedule_matches_plain_and_jax(kind, dtype, K):
    """The emulated kernel (D = 2: near and far entries both present)
    against the plain version and the JAX package's scan on the same
    operands, within the dtype's model tolerance (bf16: BF16_CHAIN, the
    JAX scan run in f32 on the bf16-rounded operands)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from aoclsparse_tpu.kernels.xla.trsv import trsv_blocked, trsv_blocked_dwin

    form, D = CASES[kind](dtype)
    b = rhs(form.m_pad, K, dtype)
    stats = {}
    got = emulate(form, b, D=2, stats=stats)
    assert stats["near"] > 0 and stats["far"] > 0
    assert got.dtype == dtype
    assert err(got, plain(form, b)) <= tol(dtype)
    jdt = {torch.float32: jnp.float32, torch.float64: jnp.float64, torch.bfloat16: jnp.float32,
           torch.complex64: jnp.complex64, torch.complex128: jnp.complex128}[dtype]
    wide = torch.complex128 if dtype.is_complex else torch.float64

    def j(t):
        return jnp.asarray(t.to(wide).numpy(), dtype=jdt)

    Dr = form.D  # the operand dtype's diagonal blocks (bf16: rounded)
    if kind == "dwin":
        Dinv = torch.from_numpy(np.linalg.inv(Dr.to(wide).numpy()))
        want = trsv_blocked_dwin(j(Dinv), j(form.Lval), j(b), form.nb, form.m_pad, form.WL,
                                 tuple(form.dwin_offs), True)
    else:
        want = trsv_blocked(j(Dr), jnp.asarray(form.Lind.numpy()), j(form.Lval), j(b), form.nb, form.m_pad)
    assert err(got, np.asarray(want)) <= tol(dtype)


@pytest.mark.parametrize("kind", sorted(CASES))
@pytest.mark.parametrize("D", [1, 2, 3, 8, 64])
def test_near_far_split_at_ring_depth(kind, D):
    """The split at distance D: every left entry is near or far (counted
    against the structure), D = 1 leaves no near entry, a D past the
    deepest source leaves no far one; a slot's near capacity (NR) only
    moves rows to the chain's own scan, the same sum; every split solves
    within the f64 model tolerance of the plain version."""
    form, _ = CASES[kind](torch.float64)
    b = rhs(form.m_pad, 1, torch.float64)
    src, _val, valid = entries(form.kind, form.operands()[1], form.offsets() if kind == "dwin" else form.Lind,
                               form.counts() if kind == "gather" else None, form.nb)
    blk = (torch.arange(form.nblk) * form.nb)[:, None, None]
    dist = blk // form.nb - src // form.nb
    want_near = int((valid & (dist < D)).sum())
    stats, stats0 = {}, {}
    got = emulate(form, b, D=D, stats=stats)
    assert stats["near"] == want_near and stats["near"] + stats["far"] == int(valid.sum())
    if D == 1:
        assert stats["near"] == 0
    if D == 64:
        assert stats["far"] == 0
    assert torch.equal(emulate(form, b, D=D, near_row=0, stats=stats0), got)
    assert err(got, plain(form, b)) <= tol(torch.float64)


def test_hub_row_overflows_its_slot():
    """The gather operand's hub row has more near entries than a slot's
    NEAR_ROW at D = 8: the chain scans that row itself."""
    form, _ = CASES["gather"](torch.float64)
    stats = {}
    emulate(form, rhs(form.m_pad, 1, torch.float64), D=8, stats=stats)
    assert stats["overflow_rows"] >= 1
    assert int(form.counts()[300 // 8, 300 % 8]) == 300 // 8 * 8


def _deep(m, seed):
    """A lower triangle with a full subdiagonal and up to three random
    entries left of it a row, a hub row (m // 2) with an entry on every
    earlier column: (ptr, ind, val f64)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    i = np.arange(1, m)
    far = np.concatenate([rng.integers(0, np.maximum(i - 1, 1)) for _ in range(3)])
    h = m // 2
    rows = np.r_[np.arange(m), i, np.tile(i, 3), np.full(h, h)]
    cols = np.r_[np.arange(m), i - 1, far, np.arange(h)]
    vals = np.r_[np.full(m, 4.0), np.full(m - 1, -0.5), 0.3 * rng.standard_normal(3 * (m - 1)), np.full(h, 1e-3)]
    S = sp.csr_matrix((vals, (rows, cols)), shape=(m, m))
    S.sum_duplicates()
    S.sort_indices()
    return S.indptr.astype(np.int64), S.indices.astype(np.int32), S.data


def test_count_operand_is_the_left_count_and_survives_refresh():
    """A planner-built gather form keeps each row's count of stored left
    slots as an int32 (nblk, nb) operand (rows past m: 0); a value
    refresh keeps it; gather_counts derives the same counts from Lind and
    Lval here (no stored entry is zero), as it does for a form carried
    across without them."""
    ptr, ind, val = _deep(600, 11)
    m = 600
    A = tt.create_csr(m, m, ptr, ind, val, device="cpu")
    form = ttri.trsv_form_for(tt.optimize(A), LOWER, NONE, nb=16)
    assert form.kind == "gather"
    rows = np.repeat(np.arange(m), np.diff(ptr))
    left = np.bincount(rows[ind < rows // 16 * 16], minlength=form.m_pad)
    assert form.Lcnt.dtype == torch.int32 and tuple(form.Lcnt.shape) == (form.nblk, form.nb)
    assert np.array_equal(form.Lcnt.numpy().ravel(), left)
    assert torch.equal(gather_counts(form.Lind, form.Lval), form.Lcnt)
    cnt = form.Lcnt
    from aoclsparse_tpu_torch.planner.plan import build_effective_csr

    eff = build_effective_csr(A.plan.clean, ttri._tri_descr(LOWER), NONE)
    form.refresh(2.0 * eff.val)
    assert form.Lcnt is cnt and torch.equal(form.counts(), cnt)
    assert int(form.counts().max()) == form.Lval.shape[2]
    carried = interop.trsv_form_from_jax(dict(D=form.D.numpy(), Lval=form.Lval.numpy(), Lind=form.Lind.numpy(),
                                              nb=16, nblk=form.nblk, m=m, WL=0, reversed_=False, unit_diag=False,
                                              kind="gather"), device="cpu")
    assert carried.Lcnt is None and torch.equal(carried.counts(), cnt)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(form.m_pad))
    assert err(emulate(form, b), plain(form, b)) <= tol(torch.float64)


def divergence_form(dtype):
    """The gather operand with no stored entry on block 0's columns (block
    1's rows keep no left entries, later ones move theirs to row nb): an
    Inf in b[0] reaches no later block but through the padding."""
    form, _ = CASES["gather"](dtype)
    nb = form.nb
    form.Lind[1], form.Lval[1] = 0, 0
    stored = torch.arange(form.Lind.shape[2])[None, None, :] < form.counts()[:, :, None]
    form.Lind[stored & (form.Lind < nb)] = nb
    form.Lcnt, form._ops = None, None
    return form


def test_padding_skip_diverges_only_on_nonfinite_x0():
    """A deliberate divergence (ROADMAP.md queue 3): the kernel reads a
    gather row's stored slots only, the plain version (as the JAX scan)
    multiplies its padding too, 0 * x[0]. With x[0] finite the two agree;
    with x[0] = Inf (and no stored entry on block 0's columns) every row
    past block 0 is finite in the kernel's schedule, and NaN in the plain
    version wherever it has padding. (Block 0 itself is NaN past row 0 on
    both: its dense triangle product reads 0 * Inf, csrc/trsv_blocked.cu.)"""
    form = divergence_form(torch.float64)
    b = rhs(form.m_pad, 1, torch.float64)
    assert err(emulate(form, b), plain(form, b)) <= tol(torch.float64)
    b[0] = float("inf")
    got, want = emulate(form, b), plain(form, b)
    assert torch.isinf(got[0]) and torch.isfinite(got[form.nb:]).all()
    padded = form.counts().reshape(-1) < form.Lind.shape[2]
    padded[:form.nb] = False
    assert padded.sum() > 100 and torch.isnan(want[padded]).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=[NAME[d] for d in DTYPES])
@pytest.mark.parametrize("kind", ["dwin", "gather"])
def test_gate_sends_chain_forms_of_every_dtype_to_the_kernel(monkeypatch, dtype, kind):
    """Every solve dtype has a chain-kernel instance: `has_solve_kernel`
    for dwin and gather; on a device of SV_LEVEL_DEVICES a bf16 form (no
    level instance) stays blocked, the chain kernel's; a complex one past
    LEVEL_MAX_NLEV stays blocked too, now the kernel and no longer the plain
    loop, and within it follows `level_wins` as the real dtypes do; a
    complex win form still takes the plain route past that depth; on the
    CPU the solve is the plain version (the JAX package's scan's contract)."""
    form, _ = CASES[kind](dtype)
    assert ttri.has_solve_kernel(kind, dtype)
    assert ttri.has_solve_kernel("win", dtype) == (not dtype.is_complex)
    dev = torch.device("cuda")
    monkeypatch.setattr(ttri, "SV_LEVEL_DEVICES", ("cuda", "cpu"))
    deep = ttri.LEVEL_MAX_NLEV + 1
    assert ttri.pick_sv_engine(form, lambda: deep, dev) == "blocked"
    shallow = ttri.pick_sv_engine(form, lambda: 1, dev)
    assert shallow == ("blocked" if dtype == torch.bfloat16 else "level")
    called = []
    for name in ("trsv_dwin", "trsv_gather"):
        real = getattr(ttri, name)
        monkeypatch.setattr(ttri, name, lambda *a, _r=real, _n=name, **k: called.append(_n) or _r(*a, **k))
    b = rhs(form.m_pad, 1, dtype)
    x = form.solve(b)
    assert called == [f"trsv_{kind}"] and x.dtype == dtype
    assert err(x, plain(form, b)) <= tol(dtype)


def test_kernel_block_limit_and_column_chunks():
    """The kernel takes blocks of up to KERNEL_MAX_NB rows (the plain
    contract up to MAX_NB: the CPU path solves a wider form, reading no
    counts), and columns in chunks of 1, 2 or 4 (NACC = 4, 2, 1)."""
    assert KERNEL_MAX_NB == 256
    form, _ = CASES["gather"](torch.float64)
    dT, left = form.operands()
    b = rhs(form.m_pad, 1, torch.float64)
    got = trsv_gather(dT, form.Lind, left, b, form.nb, counts=torch.zeros(3, dtype=torch.int64))
    assert torch.equal(got, plain(form, b))
    assert [chunk_cols(k) for k in (1, 2, 3, 4, 16)] == [1, 2, 2, 4, 4]


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest tests/test_torch_*.py there")
    return torch.device("cuda", 0)


def _to(form, dev):
    form.D, form.Lval = form.D.to(dev), form.Lval.to(dev)
    if form.Lind is not None:
        form.Lind = form.Lind.to(dev)
    form.device, form._ops, form._offs_t, form.Lcnt = torch.device(dev), None, None, None
    return form


def _kernel(form, b):
    dT, left = form.operands()
    if form.kind == "dwin":
        return trsv_dwin(dT, left, form.offsets(), b, form.nb, form.WL)
    return trsv_gather(dT, form.Lind, left, b, form.nb, form.counts())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(CASES))
@pytest.mark.parametrize("dtype", DTYPES, ids=[NAME[d] for d in DTYPES])
def test_cuda_instances_match_plain_and_emulation(cuda, kind, dtype):
    """Each instance against its plain version (the dtype's model
    tolerance; bf16 BF16_CHAIN) and against the emulated schedule (the same sums in the
    same order: within a few units of the dtype, bf16 one rounding of x),
    K in {1, 3, 16} (column chunks of 1, 2 and 4), the same bits on a
    second call, one launch a call."""
    from aoclsparse_tpu_torch.kernels import trsv_blocked as tb

    form = _to(CASES[kind](dtype)[0], cuda)
    counter = tb.trsv_dwin.launches if kind == "dwin" else tb.trsv_gather.launches
    for K in (1, 3, 16):
        b = rhs(form.m_pad, K, dtype).to(cuda)
        c0 = counter[NAME[dtype]]
        got = _kernel(form, b)
        again = _kernel(form, b)
        torch.cuda.synchronize()
        assert counter[NAME[dtype]] - c0 == 2 and torch.equal(got, again) and got.dtype == dtype
        assert err(got, plain(form, b)) <= tol(dtype)
        cpu = _to(CASES[kind](dtype)[0], "cpu")
        assert err(got, emulate(cpu, b.cpu())) <= (BF16_CHAIN if dtype == torch.bfloat16 else 0.05 * tol(dtype))


@pytest.mark.cuda
def test_cuda_padding_skip_divergence(cuda):
    """On the card: with x[0] = Inf the kernel leaves every row past block
    0 finite where the plain version gives NaN on the rows with padding."""
    form = _to(divergence_form(torch.float32), cuda)
    b = rhs(form.m_pad, 1, torch.float32).to(cuda)
    b[0] = float("inf")
    got, want = _kernel(form, b).cpu(), plain(form, b).cpu()
    assert torch.isinf(got[0]) and torch.isfinite(got[form.nb:]).all()
    assert torch.isnan(want[form.nb:]).sum() > 100
