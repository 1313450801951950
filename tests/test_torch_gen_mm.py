"""mm KID 6 of the PyTorch port, the general-structure SpMM composite
(kernels/spmm_gen.py), against the JAX package's mm(kid=6).

The operand is tests/test_gen_form.py's circuit class (local coupling, a
few dense hub columns, random scatter) at m = 1024, made from a seed with
numpy. The JAX package runs its KID 6 under AOCLSPARSE_TPU_FORCE_PALLAS=1
(its Pallas band SpMM in interpret mode, as tests/test_gen_form.py:323-400
runs it); the port runs the band SpMM kernel's plain version on the CPU.
Both build the same gen form (tests/test_torch_gen.py holds the layouts),
so they sum the same products in another order: the tolerance is
utils/tolerances.py's expected_precision(dtype) on max |a - b| / max(|b|, 1).
bf16 and f64 (which the JAX gate sends away from KID 6) are held to the
port's numpy oracle `utils.reference.ref_mm`, bf16 within its model
tolerance over the bf16-rounded operand.

The gate (planner/plan.py `gen_mm_ok`): where it fails, both packages
rebuild a gather form, which has no KID 6 row (invalid_kid for an explicit
kid=6), and the default runs the gather form.
"""

import numpy as np
import pytest
import torch

import aoclsparse_tpu_torch as tt
from aoclsparse_tpu_torch.kernels import spmm_band as band_mod
from aoclsparse_tpu_torch.planner.plan import get_plan
from aoclsparse_tpu_torch.utils.reference import ref_mm
from aoclsparse_tpu_torch.utils.tolerances import expected_precision, near_error

GEN = tt.MatrixDescriptor()
NONE = tt.Operation.none
M = 1024


@pytest.fixture(scope="module")
def ast():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    import aoclsparse_tpu

    return aoclsparse_tpu


@pytest.fixture
def jax_pallas(ast, monkeypatch):
    """The JAX package with its Pallas forms selectable on the CPU."""
    from aoclsparse_tpu.core.context import reset_context

    monkeypatch.setenv("AOCLSPARSE_TPU_FORCE_PALLAS", "1")
    reset_context()
    yield ast
    monkeypatch.delenv("AOCLSPARSE_TPU_FORCE_PALLAS")
    reset_context()


def circuit(seed, m=M, hubs=5, scatter=200):
    """tests/test_gen_form.py `_circuit_like`, as a dense float64 array."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((m, m))
    for i in range(m):
        js = np.unique(np.clip(i + rng.integers(-10, 11, 6), 0, m - 1))
        dense[i, js] = rng.standard_normal(js.size)
    for h in rng.choice(m, hubs, replace=False):
        rs = rng.choice(m, m // 3, replace=False)
        dense[rs, h] = rng.standard_normal(rs.size)
    dense[rng.integers(0, m, scatter), rng.integers(0, m, scatter)] = rng.standard_normal(scatter)
    return dense


def _csr(dense):
    ptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))]).astype(np.int64)
    return ptr, np.nonzero(dense)[1].astype(np.int32), dense[dense != 0]


def _pair(ast, dense, dtype):
    ptr, ind, val = _csr(dense)
    return ast.create_csr(M, M, ptr, ind, val.astype(dtype)), tt.create_csr(M, M, ptr, ind, val.astype(dtype),
                                                                             device="cpu")


def _B(seed, k, dtype, m=M):
    return np.random.default_rng(seed).standard_normal((m, k)).astype(dtype)


@pytest.mark.parametrize("k", [40, 128])
def test_kid6_matches_jax(jax_pallas, k):
    dense = circuit(1)
    J, T = _pair(jax_pallas, dense, np.float32)
    form = get_plan(T).gen_form_for(GEN, NONE)
    assert form is not None and form.gen_bandt
    B = _B(2, k, np.float32)
    want = np.asarray(jax_pallas.mm(1.0, J, jax_pallas.MatrixDescriptor(), jax_pallas.Operation.none, B, 0.0, kid=6))
    got = tt.mm(1.0, T, GEN, NONE, torch.from_numpy(B), 0.0, kid=6)
    assert got.shape == (M, k) and got.dtype == torch.float32
    assert near_error(got.numpy(), want) <= expected_precision(torch.float32)


def test_kid6_alpha_beta_and_update_values_match_jax(jax_pallas):
    dense = circuit(3)
    J, T = _pair(jax_pallas, dense, np.float32)
    jdescr, jnone = jax_pallas.MatrixDescriptor(), jax_pallas.Operation.none
    B, C0 = _B(4, 64, np.float32), _B(5, 64, np.float32)
    want = np.asarray(jax_pallas.mm(1.5, J, jdescr, jnone, B, -0.5, C0, kid=6))
    got = tt.mm(1.5, T, GEN, NONE, torch.from_numpy(B), -0.5, torch.from_numpy(C0), kid=6)
    assert near_error(got.numpy(), want) <= expected_precision(torch.float32)
    form = get_plan(T).gen_form_for(GEN, NONE)
    assert "rows" in form._derived  # the row-aligned band, built once
    newval = (-2.0 * dense[dense != 0]).astype(np.float32)
    jax_pallas.update_values(J, newval)
    tt.update_values(T, newval)
    assert form._derived is None  # refresh() dropped the derived band
    want2 = np.asarray(jax_pallas.mm(1.0, J, jdescr, jnone, B, 0.0, kid=6))
    got2 = tt.mm(1.0, T, GEN, NONE, torch.from_numpy(B), 0.0, kid=6)
    assert near_error(got2.numpy(), want2) <= expected_precision(torch.float32)


def test_kid6_f64_and_bf16_against_the_oracle():
    """The port's gate takes f64 (#8's f64 instance) and bf16 (its bf16-band
    instance, B and C f32); the JAX gate takes neither, so the oracle
    holds them. bf16: the oracle over the bf16-rounded values and B."""
    dense = circuit(5)
    ptr, ind, val = _csr(dense)
    T = tt.create_csr(M, M, ptr, ind, val, device="cpu")
    B = _B(6, 33, np.float64)
    got = tt.mm(1.0, T, GEN, NONE, torch.from_numpy(B), 0.0, kid=6)
    want = ref_mm(1.0, M, M, ptr, ind, val, GEN, NONE, B, 0.0, np.zeros_like(B))
    assert near_error(got.numpy(), want) <= expected_precision(torch.float64)
    vb = torch.from_numpy(val).to(torch.bfloat16)
    Tb = tt.create_csr(M, M, ptr, ind, vb, device="cpu")
    Bb = torch.from_numpy(B).to(torch.bfloat16)
    assert get_plan(Tb).gen_form_for(GEN, NONE).bwd_val.dtype == torch.bfloat16
    gotb = tt.mm(1.0, Tb, GEN, NONE, Bb, 0.0, kid=6)
    assert gotb.dtype == torch.bfloat16
    wantb = ref_mm(1.0, M, M, ptr, ind, vb.double().numpy(), GEN, NONE, Bb.double().numpy(), 0.0, np.zeros_like(B))
    assert near_error(gotb.double().numpy(), wantb) <= expected_precision(torch.bfloat16)


def test_mixed_mode_streams_the_bf16_band():
    dense = circuit(7)
    ptr, ind, val = _csr(dense)
    T = tt.create_csr(M, M, ptr, ind, val.astype(np.float32), device="cpu")
    B = torch.from_numpy(_B(8, 16, np.float32))
    full = tt.mm(1.0, T, GEN, NONE, B, 0.0, kid=6)
    tt.set_precision_mode(T, "mixed")
    mixed = tt.mm(1.0, T, GEN, NONE, B, 0.0, kid=6)
    assert get_plan(T).gen_form_for(GEN, NONE)._derived["rows_bf16"].dtype == torch.bfloat16
    ref = dense @ B.double().numpy()
    assert 0 < near_error(mixed.numpy(), ref) <= expected_precision(torch.bfloat16)
    assert near_error(full.numpy(), ref) < near_error(mixed.numpy(), ref)


def test_default_takes_gen_on_circuit_structure(ast):
    """choose_mm_format sends general square structure to gen where the mv
    rule takes gen and the band passes the gate; the JAX package's TPU
    default does the same (its kind=None slot). The value is the kid=6
    value, and the JAX package's default within the f32 tolerance."""
    dense = circuit(9)
    J, T = _pair(ast, dense, np.float32)
    B = _B(10, 24, np.float32)
    got = tt.mm(1.0, T, GEN, NONE, torch.from_numpy(B), 0.0)
    key = (GEN.type, GEN.fill_mode, GEN.diag_type, NONE)
    assert get_plan(T).mm_kinds[key] == "gen"
    assert torch.equal(got, tt.mm(1.0, T, GEN, NONE, torch.from_numpy(B), 0.0, kid=6))
    want = np.asarray(ast.mm(1.0, J, ast.MatrixDescriptor(), ast.Operation.none, B, 0.0))
    assert near_error(got.numpy(), want) <= expected_precision(torch.float32)
    # mv's default and mm share the one gen form
    tt.mv(1.0, T, GEN, NONE, torch.from_numpy(B[:, 0]), 0.0)
    assert len({id(f) for f in get_plan(T).exec_forms.values()}) == 1


def _gate_fails_like_jax(ast, J, T, B, dtype):
    """An explicit kid=6 raises invalid_kid in both packages (the gather
    rebuild has no KID 6 row), and the default runs a gather form equal to
    the JAX package's default within the dtype's tolerance."""
    with pytest.raises(tt.AoclSparseError) as e:
        tt.mm(1.0, T, GEN, NONE, torch.from_numpy(B), 0.0, kid=6)
    assert e.value.status == tt.Status.invalid_kid
    with pytest.raises(ast.AoclSparseError) as ej:
        ast.mm(1.0, J, ast.MatrixDescriptor(), ast.Operation.none, B, 0.0, kid=6)
    assert ej.value.status == ast.Status.invalid_kid
    got = tt.mm(1.0, T, GEN, NONE, torch.from_numpy(B), 0.0)
    assert get_plan(T).mm_kinds[(GEN.type, GEN.fill_mode, GEN.diag_type, NONE)] in ("ell", "ellhyb", "segsum")
    want = np.asarray(ast.mm(1.0, J, ast.MatrixDescriptor(), ast.Operation.none, B, 0.0))
    assert near_error(got.numpy(), want) <= expected_precision(dtype)


def test_gate_fails_on_complex_values(ast):
    dense = circuit(11)
    J, T = _pair(ast, dense, np.complex128)
    B = _B(12, 8, np.float64).astype(np.complex128)
    _gate_fails_like_jax(ast, J, T, B, torch.complex128)


def test_gate_fails_on_a_band_past_the_kernel_plan(ast, monkeypatch):
    """A gen band wider than band_max_w (here: the plan shrunk below this
    operand's band) takes the gather rebuild, as the JAX package does where
    its gate fails (here: no Pallas leg on its CPU default)."""
    dense = circuit(13)
    J, T = _pair(ast, dense, np.float32)
    W = get_plan(T).gen_form_for(GEN, NONE).bwd_W
    monkeypatch.setitem(band_mod._BAND_MAX_W, 4, W - 8)
    _gate_fails_like_jax(ast, J, T, _B(14, 8, np.float32), torch.float32)


def test_chip_smoke_scircuit_copy_equals_realmat():
    """chip_smoke.py's copy of the scircuit stand-in (phase 5h's KID 6
    operand) builds the same CSR as benchmarks/realmat.py for seed 7."""
    import importlib.util
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    specs = {}
    for name, path in (("chip_smoke", repo / "chip_smoke.py"), ("realmat", repo / "benchmarks" / "realmat.py")):
        spec = importlib.util.spec_from_file_location(f"_copy5h_{name}", path)
        specs[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(specs[name])
    got = specs["chip_smoke"].scircuit(np.random.default_rng(7))
    want = specs["realmat"].generate("scircuit", seed=7)
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest tests/test_torch_*.py there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 40, 128])
def test_cuda_kid6_matches_plain_composite(cuda, dtype, k):
    """mm(kid=6) on the card launches the band SpMM kernel once and agrees
    with the same composite on the CPU (the kernel's plain version)."""
    dense = circuit(15)
    ptr, ind, val = _csr(dense)
    vt = torch.from_numpy(val).to(dtype)
    T = tt.create_csr(M, M, ptr, ind, vt, device=cuda)
    Tc = tt.create_csr(M, M, ptr, ind, vt, device="cpu")
    B = torch.from_numpy(_B(16, k, np.float64)).to(dtype)
    inst = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}[dtype]
    before = band_mod.spmm_band.launches[inst]
    got = tt.mm(1.0, T, GEN, NONE, B.to(cuda), 0.0, kid=6)
    torch.cuda.synchronize()
    assert band_mod.spmm_band.launches[inst] == before + 1
    want = tt.mm(1.0, Tc, GEN, NONE, B, 0.0, kid=6)
    tol = expected_precision(torch.float64 if dtype == torch.float64 else torch.float32)
    if dtype == torch.bfloat16:  # both round the f32 result to bf16 once
        tol = expected_precision(torch.bfloat16)
    assert near_error(got.cpu().double().numpy(), want.double().numpy()) <= tol
