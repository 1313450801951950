"""The port's tuners (kernels/autotune.py) and the pins they set.

No test here asserts which form or engine wins: that is a measurement. Each
holds what does not depend on one: the pin is the arg-min of the returned
times, the next call without a kid dispatches the pinned form (a spy on the
dispatch, or the pin's own route), its value equals the unpinned call's
within the dtype's model tolerance (utils/tolerances.py, max |a - b| /
max(|b|, 1)), the candidate lists hold the JAX package's kinds plus the
form the port's default takes for the operand, and a pin overrides the
triangular solve's gate (planner/triangular.py `sv_engine_for`), a card
handle is never timed on a host engine unasked, and a candidate is skipped
for a cap or a layout that does not fit but never for a failing kernel
(RuntimeError). Operands
are made from a seed with numpy at small sizes; the tuners run with one
chunk of two calls a candidate.
"""

import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.kernels import autotune as at
from aoclsparse_tpu_torch.kernels import spmm_band as band_mod
from aoclsparse_tpu_torch.planner import plan as tplan
from aoclsparse_tpu_torch.planner import triangular as ttri
from aoclsparse_tpu_torch.planner.plan import get_plan
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

GEN = tt.MatrixDescriptor()
NONE = tt.Operation.none
LOWER = tt.MatrixDescriptor(type=tt.MatrixType.triangular, fill_mode=tt.FillMode.lower)
KEY4 = (GEN.type, GEN.fill_mode, GEN.diag_type, NONE)
SKEY = (LOWER.fill_mode, LOWER.diag_type, NONE)
FAST = dict(iters=2, chunks=1)
TOL64 = expected_precision(torch.float64)
mvmod = importlib.import_module("aoclsparse_tpu_torch.ops.level2.mv")
mmmod = importlib.import_module("aoclsparse_tpu_torch.ops.level3.csrmm")


def circuit(seed, m=512):
    """Local coupling, two hub columns, random scatter and a dominant
    diagonal (the gen class of tests/test_gen_form.py, factorable)."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((m, m))
    for i in range(m):
        js = np.unique(np.clip(i + rng.integers(-10, 11, 6), 0, m - 1))
        dense[i, js] = rng.standard_normal(js.size)
    for h in rng.choice(m, 2, replace=False):
        rs = rng.choice(m, m // 3, replace=False)
        dense[rs, h] = rng.standard_normal(rs.size)
    dense[rng.integers(0, m, 100), rng.integers(0, m, 100)] = rng.standard_normal(100)
    np.fill_diagonal(dense, 40.0)
    return sp.csr_matrix(dense)


def band(seed, m=600, halfw=6):
    rng = np.random.default_rng(seed)
    S = sp.diags([rng.standard_normal(m) for _ in range(2 * halfw + 1)], list(range(-halfw, halfw + 1)),
                 shape=(m, m), format="csr")
    S.setdiag(4.0 * halfw)
    return S


def stencil27(nx):
    """HPCG's 27-point stencil on an nx^3 grid: 26 on the diagonal, -1 off."""
    g = np.arange(nx)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    rows, cols = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ok = (0 <= z + dz) & (z + dz < nx) & (0 <= y + dy) & (y + dy < nx) & (0 <= x + dx) & (x + dx < nx)
                i = (z * nx + y) * nx + x
                rows.append(i[ok])
                cols.append(i[ok] + (dz * nx + dy) * nx + dx)
    r, c = np.concatenate(rows), np.concatenate(cols)
    S = sp.csr_matrix((np.where(r == c, 26.0, -1.0), (r, c)), shape=(nx**3, nx**3))
    S.sort_indices()
    return S


def uniform(seed, m=2048, per_row=3):
    """Uniform random columns: the gen planner rejects it."""
    rng = np.random.default_rng(seed)
    S = sp.csr_matrix((rng.standard_normal(m * per_row), (np.repeat(np.arange(m), per_row),
                                                          rng.integers(0, m, m * per_row))), shape=(m, m))
    S.sum_duplicates()
    S.sort_indices()
    return S


def handle(S, dtype=np.float64):
    return tt.create_csr(S.shape[0], S.shape[1], S.indptr, S.indices, S.data.astype(dtype), device="cpu")


def spy(monkeypatch, module, name, seen, pick):
    """Wrap module.name so each call appends pick(args) to `seen`."""
    fn = getattr(module, name)

    def wrapped(*a, **k):
        seen.append(pick(*a, **k))
        return fn(*a, **k)

    monkeypatch.setattr(module, name, wrapped)


def argmin(results):
    return min(results, key=results.get)


# ------------------------------------------------------------------------ mv


@pytest.mark.parametrize("name", ["circuit", "band"])
def test_mv_pin_is_argmin_and_next_call_follows(monkeypatch, name):
    S = circuit(1) if name == "circuit" else band(2)
    A = handle(S)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(S.shape[1]))
    y0 = tt.mv(1.0, A, GEN, NONE, x, 0.0)
    default = get_plan(A).exec_form_for(GEN, NONE).kind
    res = tt.autotune_mv(A, **FAST)
    assert default in res and set(res) <= set(at._MV_KINDS) | {default}
    win = argmin(res)
    plan = get_plan(A)
    if win == "host":
        assert plan._mv_engine[KEY4] == "host" and plan.exec_forms[KEY4 + ("host",)].kind == "host"
        assert plan.exec_forms[KEY4 + (None,)].kind == argmin({k: v for k, v in res.items() if k != "host"})
    else:
        assert KEY4 not in plan._mv_engine and plan.exec_forms[KEY4 + (None,)].kind == win
    seen = []
    spy(monkeypatch, mvmod, "_run_exec_form", seen, lambda form, *a: form.kind)
    spy(monkeypatch, mvmod, "_mv_host", seen, lambda *a: "host")
    y1 = tt.mv(1.0, A, GEN, NONE, x, 0.0)
    assert seen == [win]
    assert near_error(y1.numpy(), y0.numpy()) <= TOL64


def test_mv_host_pin_runs_the_host_engine_and_an_explicit_kid_overrides(monkeypatch):
    """The host pin as autotune_mv plants it: mv without a kid runs the
    whole call on the host engine (a CPU tensor), kid=8 still runs its form."""
    S = band(4)
    A = handle(S)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(S.shape[1]))
    y0 = tt.mv(1.0, A, GEN, NONE, x, 0.0)
    plan = get_plan(A)
    plan._mv_engine[KEY4] = "host"
    seen = []
    spy(monkeypatch, mvmod, "_mv_host", seen, lambda *a: "host")
    y1 = tt.mv(1.0, A, GEN, NONE, x, 0.0)
    tt.mv(1.0, A, GEN, NONE, x, 0.0, kid=8)
    assert seen == ["host"] and near_error(y1.numpy(), y0.numpy()) <= TOL64


def test_mv_candidates_include_the_defaults_route(monkeypatch):
    """On a structure the gen planner rejects, the default is the
    whole-matrix route (its nnz gate lowered to this size): it is timed,
    though the JAX package's list lacks it."""
    monkeypatch.setattr(tplan, "ROUTE_MIN_NNZ", 0)
    A = handle(uniform(6), np.float32)
    assert get_plan(A).exec_form_for(GEN, NONE).kind == "route"
    res = tt.autotune_mv(A, kinds=("segsum", "gen"), **FAST)
    assert set(res) == {"segsum", "route"}
    assert get_plan(A).exec_forms[KEY4 + (None,)].kind == argmin(res)


# ------------------------------------------------------------------------ mm


@pytest.mark.parametrize("name", ["circuit", "band", "stencil"])
def test_mm_pin_is_argmin_and_next_call_follows(monkeypatch, name):
    S = {"circuit": lambda: circuit(7), "band": lambda: band(8), "stencil": lambda: stencil27(8)}[name]()
    A = handle(S, np.float32)
    k = 8
    B = torch.from_numpy(np.random.default_rng(9).standard_normal((S.shape[1], k)).astype(np.float32))
    C0 = tt.mm(1.0, A, GEN, NONE, B, 0.0)
    default = get_plan(A).mm_kinds[KEY4]
    res = tt.autotune_mm(A, k=k, B=B, **FAST)
    assert default in res  # the stencil's diag is not in the JAX package's list
    assert set(res) <= set(at._MM_KINDS) | {default}
    win = argmin(res)
    assert get_plan(A)._mm_tuned[KEY4 + (k,)] == win
    seen = []
    spy(monkeypatch, mmmod, "_run_mm_form", seen, lambda form, B, kid, mixed=False: (form.kind, kid))
    C1 = tt.mm(1.0, A, GEN, NONE, B, 0.0)
    assert seen == [("bandtm", 5) if win == "bandmxu" else (win, None)]
    assert near_error(C1.numpy(), C0.numpy()) <= expected_precision(torch.float32)
    # the pin is per K: another width keeps the default
    seen.clear()
    tt.mm(1.0, A, GEN, NONE, B[:, :3], 0.0)
    assert seen == [(default, None)]


def test_mm_bandmxu_label_dispatches_kid5(monkeypatch):
    A = handle(band(10), np.float32)
    B = torch.ones(600, 4)
    get_plan(A)._mm_tuned[KEY4 + (4,)] = "bandmxu"
    calls = []
    spy(monkeypatch, band_mod, "spmm_band_mxu_plain", calls, lambda *a: 1)
    C = tt.mm(1.0, A, GEN, NONE, B, 0.0)
    assert calls == [1]
    assert near_error(C.numpy(), tt.mm(1.0, A, GEN, NONE, B, 0.0, kid=4).numpy()) <= expected_precision(torch.float32)


# ---------------------------------------------------------------------- trsv


@pytest.mark.parametrize("k", [1, 3])
def test_trsv_pin_is_argmin_and_next_call_follows(k):
    S = circuit(11)
    A = handle(S)
    rng = np.random.default_rng(12)
    b = torch.from_numpy(rng.standard_normal(S.shape[0]) if k == 1 else rng.standard_normal((S.shape[0], k)))
    solve = (lambda: tt.trsv(1.0, A, LOWER, NONE, b)) if k == 1 else (lambda: tt.trsm(1.0, A, LOWER, NONE, b))
    x0 = solve()
    res = tt.autotune_trsv(A, LOWER, nb_candidates=(64, 128), k=k, **FAST)
    assert ("host" in res) == (k == 1)  # the host engine tunes the single right-hand side only
    win = argmin(res)
    plan = get_plan(A)
    if win in ("level", "host"):
        assert plan._trsv_engine[SKEY] == win
    else:
        assert SKEY not in plan._trsv_engine and plan._trsv_tuned[SKEY] == win
        assert ttri.trsv_form_for(plan, LOWER, NONE).nb == win
    assert near_error(solve().numpy(), x0.numpy()) <= TOL64


@pytest.fixture
def gate_open(monkeypatch):
    """The sv gate opened to the CPU; counts of the level, chain and host
    solves the CPU takes."""
    from aoclsparse_tpu_torch.kernels import trsv_blocked as tb
    from aoclsparse_tpu_torch.kernels import trsv_level as tl

    monkeypatch.setattr(ttri, "SV_LEVEL_DEVICES", ("cuda", "cpu"))
    calls = {"level": 0, "chain": 0, "host": 0}

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)

        return wrapped

    monkeypatch.setattr(tl, "trsv_level_plain", count("level", tl.trsv_level_plain))
    monkeypatch.setattr(tb, "trsv_dwin_plain", count("chain", tb.trsv_dwin_plain))
    monkeypatch.setattr(ttri.TrsvHostForm, "solve", count("host", ttri.TrsvHostForm.solve))
    return calls


def test_pins_override_the_sv_gate(gate_open, monkeypatch):
    """On a chain-kernel triangle (the 16^3 stencil's dwin form): with no
    pin the gate decides; a block-size pin takes the blocked form past a
    gate that says level; a level pin takes the level engine past a gate
    that says blocked; a host pin serves trsv's single right-hand side and
    leaves trsm and the smoothers to the gate. Every route gives the
    same solution."""
    S = stencil27(16)
    A = handle(S)
    plan = get_plan(A)
    m = S.shape[0]
    b = torch.from_numpy(np.random.default_rng(13).standard_normal(m))
    B2 = torch.stack([b, 2 * b], 1)
    want = tt.trsv(1.0, A, LOWER, NONE, b, kid=2)
    assert ttri.trsv_form_for(plan, LOWER, NONE).kind == "dwin"

    def route(fn):
        c0 = dict(gate_open)
        x = fn()
        assert near_error(x[:, 0].numpy() if x.dim() == 2 else x.numpy(), want.numpy()) <= TOL64
        return {k: gate_open[k] - c0[k] for k in gate_open}

    trsv = lambda: tt.trsv(1.0, A, LOWER, NONE, b)  # noqa: E731
    trsm = lambda: tt.trsm(1.0, A, LOWER, NONE, B2)  # noqa: E731
    sgs = lambda: tt.symgs(NONE, A, GEN, 1.0, b)  # noqa: E731
    monkeypatch.setattr(ttri, "T_LEVEL_US", 0.1)  # the gate says level
    assert ttri.sv_engine_for(plan, LOWER, NONE, "cpu") == "level"
    assert route(trsv) == {"level": 1, "chain": 0, "host": 0}
    plan._trsv_tuned[SKEY] = 64
    assert ttri.sv_engine_for(plan, LOWER, NONE, "cpu") == "blocked"
    assert route(trsv) == {"level": 0, "chain": 1, "host": 0}
    assert route(trsm) == {"level": 0, "chain": 1, "host": 0}
    del plan._trsv_tuned[SKEY]
    monkeypatch.setattr(ttri, "T_LEVEL_US", 1e6)  # the gate says blocked
    assert route(trsv) == {"level": 0, "chain": 1, "host": 0}
    plan._trsv_engine[SKEY] = "level"
    assert ttri.sv_engine_for(plan, LOWER, NONE, "cpu") == "level"
    assert route(trsv) == {"level": 1, "chain": 0, "host": 0}
    assert route(trsm) == {"level": 1, "chain": 0, "host": 0}
    plan._trsv_engine[SKEY] = "host"
    assert route(trsv) == {"level": 0, "chain": 0, "host": 1}
    assert route(trsm) == {"level": 0, "chain": 1, "host": 0}
    x = tt.symgs(NONE, A, GEN, 1.0, b)
    assert torch.isfinite(x).all() and sgs().shape == (m,)


# -------------------------------------------------------------------- SpGEMM


def test_spgemm_pins_the_fastest_engine(monkeypatch):
    """With the band engine attached (forced on the CPU), every engine is
    timed; the pin follows the arg-min, the extraction route the rule, and
    the finalize on the pinned plan gives the product."""
    monkeypatch.setenv("AOCLSPARSE_TPU_FORCE_BANDGEMM", "1")
    S = band(14, m=512, halfw=4)
    A = handle(S)
    C, res = tt.autotune_spgemm(A, A, **FAST)
    engines = {k: v for k, v in res.items() if k in ("expand", "band", "host")}
    assert {"expand", "band"} <= set(engines)
    win = argmin(engines)
    plan = C._spgemm_plan
    assert plan._host_engine == (win == "host") and (plan.band is not None) == (win == "band")
    want_route = "host" if res.get("host", np.inf) < res["extract_gather"] else "gather"
    assert plan._extract_route == want_route
    C = tt.sp2m(NONE, GEN, A, NONE, GEN, A, request=tt.Request.finalize, C=C)
    ptr, ind, val = tt.export_csr(C)[3:6]
    got = sp.csr_matrix((val, ind, ptr), shape=S.shape).toarray()
    assert near_error(got, (S @ S).toarray()) <= TOL64


# ------------------------------------------------------- optimize and errors


def test_optimize_tunes_heavily_hinted_mv(monkeypatch):
    calls = []
    spy(monkeypatch, at, "autotune_mv", calls, lambda A, descr, op: op)
    A = handle(band(15))
    tt.set_mv_hint(A, NONE, GEN, 10)
    tt.optimize(A)
    assert calls == []  # the variable unset
    monkeypatch.setenv("AOCLSPARSE_TPU_AUTOTUNE", "1")
    B = handle(band(15))
    tt.set_mv_hint(B, NONE, GEN, 999)
    tt.optimize(B)
    assert calls == []  # below AOCLSPARSE_TPU_AUTOTUNE_NOP (1000)
    tt.set_mv_hint(B, NONE, GEN, 1000)
    tt.optimize(B)
    assert calls == [NONE] and KEY4 + (None,) in get_plan(B).exec_forms
    monkeypatch.setenv("AOCLSPARSE_TPU_AUTOTUNE_NOP", "5")
    monkeypatch.setattr(at, "autotune_mv", lambda *a, **k: 1 / 0)
    Cm = handle(band(16))
    tt.set_mv_hint(Cm, NONE, GEN, 10)
    with pytest.warns(RuntimeWarning, match="ZeroDivisionError"):
        tt.optimize(Cm)
    assert get_plan(Cm).exec_forms[KEY4 + (None,)].kind == "bandt"  # the cost model's form


def test_null_handles_are_invalid_pointer():
    A = handle(band(17))
    for call in (lambda: tt.autotune_mv(None), lambda: tt.autotune_mm(None), lambda: tt.autotune_trsv(None),
                 lambda: tt.autotune_spgemm(None, A), lambda: tt.autotune_spgemm(A, None)):
        with pytest.raises(tt.AoclSparseError) as e:
            call()
        assert e.value.status == tt.Status.invalid_pointer


def test_host_engines_are_timed_unasked_only_on_a_cpu_handle():
    """A card handle is never pinned to a host engine it did not ask for:
    autotune_mv drops "host" from its default list there (a caller's
    `kinds` may still name it), autotune_trsv and autotune_spgemm time the
    host engines on CPU operands only."""
    assert at._times_host(torch.device("cpu"), at.HOST_MAX_NNZ)
    assert not at._times_host(torch.device("cpu"), at.HOST_MAX_NNZ + 1)
    assert not at._times_host(torch.device("cuda", 0))
    assert not at._times_host(torch.device("cuda", 0), 10)


@pytest.mark.parametrize("tuner", ["mv", "mm", "trsv", "spgemm"])
def test_a_failing_kernel_is_not_skipped(monkeypatch, tuner):
    """A candidate that raises RuntimeError (a kernel that does not build
    or launch) stops the tuner: only caps, missing instances and out of
    memory are skipped, so no plain form is pinned in a kernel's place."""
    spgemm_mod = importlib.import_module("aoclsparse_tpu_torch.ops.level3.spgemm")
    trsv_mod = importlib.import_module("aoclsparse_tpu_torch.ops.level2.trsv")
    target = {"mv": (mvmod, "_run_exec_form"), "mm": (mmmod, "_run_mm_form"),
              "trsv": (trsv_mod, "pad_solve"), "spgemm": (spgemm_mod, "_numeric_auto")}[tuner]

    def fail(*a, **k):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(*target, fail)
    monkeypatch.setenv("AOCLSPARSE_TPU_FORCE_BANDGEMM", "1")  # the band engine on the CPU
    S = band(30, m=256)
    A = handle(S)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        if tuner == "mv":
            tt.autotune_mv(A, **FAST)
        elif tuner == "mm":
            tt.autotune_mm(A, k=4, **FAST)
        elif tuner == "trsv":
            tt.autotune_trsv(A, LOWER, nb_candidates=(32,), **FAST)
        else:
            tt.autotune_spgemm(A, A, iters=2, chunks=1)


@pytest.mark.parametrize("exc", [MemoryError(), RuntimeError("DefaultCPUAllocator: can't allocate memory")])
def test_an_unallocatable_form_is_memory_error_and_skipped(monkeypatch, exc):
    """A layout the host cannot allocate (a padded window of a structure
    far from the form's class) is memory_error, which the tuner skips; any
    other RuntimeError from a builder stays what it is."""
    A = handle(band(32, m=256))
    eff = get_plan(A).effective_for(GEN, NONE)

    def refuse(*a, **k):
        raise exc

    monkeypatch.setattr(tplan, "_build_bwd", refuse)
    with pytest.raises(tt.AoclSparseError) as e:
        tplan.build_exec_form(eff, "bwd")
    assert e.value.status == tt.Status.memory_error
    assert "bwd" not in tt.autotune_mv(A, kinds=("bwd", "segsum"), **FAST)

    def fault(*a, **k):
        raise RuntimeError("index out of range")

    monkeypatch.setattr(tplan, "_build_bwd", fault)
    with pytest.raises(RuntimeError, match="index out of range"):
        tplan.build_exec_form(eff, "bwd")


def test_signatures_match_the_jax_package():
    jat = pytest.importorskip("aoclsparse_tpu.kernels.autotune")
    import inspect

    for name in at.__all__:
        want = inspect.signature(getattr(jat, name))
        got = inspect.signature(getattr(at, name))
        assert list(got.parameters) == list(want.parameters)
        assert [p.default for p in got.parameters.values()] == [p.default for p in want.parameters.values()]


# ------------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest tests/test_torch_*.py there")
    return torch.device("cuda", 0)


def _launches(counters):
    return {k: sum(c.values()) for k, c in counters.items()}


@pytest.mark.cuda
def test_cuda_mv_and_mm_pins_dispatch_their_kernels(cuda):
    """On the card: each tuner's pin is the arg-min; the next call launches
    the pinned form's kernel (band SpMV for bandt/gen, group windows for
    bwd, band SpMM for bandtm/gen, block windows for bandmxu, diagonals for
    diag; none for a plain form) and equals the unpinned call."""
    from aoclsparse_tpu_torch.kernels.band_spmv import band_spmv
    from aoclsparse_tpu_torch.kernels.spmm_diag import spmm_diag
    from aoclsparse_tpu_torch.kernels.spmv_bwd import spmv_bwd

    mv_k = {"bandt": band_spmv.launches, "gen": band_spmv.launches, "bwd": spmv_bwd.launches}
    mm_k = {"bandtm": band_mod.spmm_band.launches, "gen": band_mod.spmm_band.launches,
            "bandmxu": band_mod.spmm_band_mxu.launches, "diag": spmm_diag.launches}
    for S in (circuit(18, m=4096), band(19, m=4096), stencil27(16)):
        A = tt.create_csr(S.shape[0], S.shape[1], S.indptr, S.indices, S.data.astype(np.float32), device=cuda)
        x = torch.linspace(-1, 1, S.shape[1], device=cuda)
        y0 = tt.mv(1.0, A, GEN, NONE, x, 0.0)
        win = argmin(tt.autotune_mv(A, **FAST))
        before = _launches({"k": mv_k.get(win, band_spmv.launches)})
        y1 = tt.mv(1.0, A, GEN, NONE, x, 0.0)
        torch.cuda.synchronize()
        assert _launches({"k": mv_k.get(win, band_spmv.launches)})["k"] - before["k"] == (1 if win in mv_k else 0)
        assert near_error(y1.cpu().double().numpy(), y0.cpu().double().numpy()) <= expected_precision(torch.float32)
        B = torch.linspace(-1, 1, S.shape[1] * 16, device=cuda).reshape(-1, 16)
        C0 = tt.mm(1.0, A, GEN, NONE, B, 0.0)
        win = argmin(tt.autotune_mm(A, k=16, B=B, **FAST))
        counter = mm_k.get(win, band_mod.spmm_band.launches)
        before = sum(counter.values())
        C1 = tt.mm(1.0, A, GEN, NONE, B, 0.0)
        torch.cuda.synchronize()
        assert sum(counter.values()) - before == (1 if win in mm_k else 0)
        assert near_error(C1.cpu().double().numpy(), C0.cpu().double().numpy()) <= expected_precision(torch.float32)


@pytest.mark.cuda
def test_cuda_tuned_calls_stay_on_the_card(cuda):
    """On a card handle the tuners time no host engine, so mv and trsv
    after tuning return tensors on A's device and the SpGEMM pin is a
    device engine."""
    S = band(31, m=2048)
    A = tt.create_csr(S.shape[0], S.shape[1], S.indptr, S.indices, S.data.astype(np.float32), device=cuda)
    assert "host" not in tt.autotune_mv(A, **FAST)
    assert tt.mv(1.0, A, GEN, NONE, torch.ones(S.shape[1], device=cuda), 0.0).device == A.device
    assert "host" not in tt.autotune_trsv(A, LOWER, **FAST)
    assert tt.trsv(1.0, A, LOWER, NONE, torch.ones(S.shape[0], device=cuda)).device == A.device
    C, res = tt.autotune_spgemm(A, A, iters=2, chunks=1)
    assert "host" not in res and not C._spgemm_plan._host_engine
